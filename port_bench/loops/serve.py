"""serve: requests of block centres walked in raster order over the
seed's block grid, one client, each answered with its mean and variance
by the dense server (`serve.Predictor`, its L^-1 precomputed), the
request sent as one batch.

Traffic parameters: `request_points` (block centres a request),
`spacing_m` (the block grid's spacing), `first_predict_reps` (fresh
servers timed for `first_predict_s`).

Compared: `std_abs`; `mean_z`, the largest |mean - reference| over the
sampled requests' points in units of the reference's predictive std;
`var_rel`, the largest |variance - reference| / reference there.
"""

from __future__ import annotations

import time

import numpy as np

from port_bench import data
from port_bench.loop import Loop, worst
from port_bench.window import Item, Record


class Serve(Loop):
    def setup(self):
        t = self.traffic
        self.grid = data.block_grid(self.seed, t["spacing_m"])
        self.m = t["request_points"]
        self.server = self._server()

    def _server(self):
        from gp_ss_ak_torch.serve import Predictor

        return Predictor(self.model(), self.Xs, self.ys)

    def request(self, k: int):
        """The k-th request's block centres (raw metres) and their
        indices in the grid, walking it in raster order and wrapping."""
        idx = (k * self.m + np.arange(self.m)) % len(self.grid)
        return idx, self.grid[idx]

    def _ask(self, server, Xq):
        from gp_ss_ak_torch.data.standardize import apply

        mu, var = server(apply(self.stats, Xq), batch_size=self.m)
        return np.asarray(mu), np.asarray(var)

    def warm(self):
        self._ask(self.server, self.request(0)[1])
        self.sync()

    def first_predict(self):
        """(server set-up s, first answer s) of fresh servers, from the
        model and the training data in host memory."""
        out = []
        for _ in range(self.traffic["first_predict_reps"]):
            t0 = time.perf_counter()
            fresh = self._server()
            self.sync()
            t1 = time.perf_counter()
            self._ask(fresh, self.request(0)[1])
            out.append((t1 - t0, time.perf_counter() - t0))
            del fresh
        return out

    def window(self, seconds: float) -> Record:
        t_start = time.perf_counter()
        rec = Record(t_start, t_start + seconds)
        k = 0
        while time.perf_counter() < rec.t_close:
            idx, Xq = self.request(k)
            t0 = time.perf_counter()
            mu, var = self._ask(self.server, Xq)
            t1 = time.perf_counter()
            bad = not (np.all(np.isfinite(mu)) and np.all(np.isfinite(var)))
            rec.items.append(Item(t0, t1, self.m, bad,
                                  {"idx": idx, "mu": mu, "var": var}))
            k += 1
        return rec

    def answers(self, rec, k: int):
        done = rec.completed()
        pick = data.draw(self.seed, k, len(done), 2)
        return [{"idx": done[i].info["idx"], "mu": done[i].info["mu"],
                 "var": done[i].info["var"]} for i in pick]

    def release(self):
        self.server = None

    def _predictions(self, answers, prec):
        """The reference's (mean, variance) at each answer's centres."""
        import torch

        Xs, ys, x_off, x_scale = self.reference_inputs(prec)
        fac = self.factor(Xs, self.theta0, prec)
        _, alpha = self.ref.nlml(fac, ys)
        out = []
        for a in answers:
            # the reference's own standardization of the raw centres
            Xq = torch.as_tensor((self.grid[a["idx"]] - x_off) / x_scale,
                                 dtype=prec.dtype, device=self.device)
            mu, var = self.ref.predict(Xs, self.theta0, fac, alpha, Xq)
            out.append((mu.double().cpu().numpy(),
                        var.double().cpu().numpy()))
        return out

    def produce(self, answers, prec):
        return [dict(a, mu=mu, var=var) for a, (mu, var)
                in zip(answers, self._predictions(answers, prec))]

    def numbers(self, answers) -> dict:
        mz, vr = [], []
        for a, (mu, var) in zip(answers,
                                self._predictions(answers, self.ref.F64)):
            mz.append(np.max(np.abs(a["mu"] - mu) / np.sqrt(var)))
            vr.append(np.max(np.abs(a["var"] - var) / var))
        return {"std_abs": self.std_abs(), "mean_z": worst(mz),
                "var_rel": worst(vr)}


LOOP = Serve

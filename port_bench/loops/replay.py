"""replay: a fixed list of hyperparameter points, evaluated in order and
cycled through the segmented matrix-free evaluator's closure with its
warm start, as `fit` calls it.

Traffic parameters: `factors` (one list per point, multiplying the
first entries of the configuration's hyperparameters), `probes` (the
gradient's Hutchinson probes), `slq_probes` (the log-determinant's),
`probe_seed`: the seed the probes are drawn from, or null for the
run's own. A fixed one gives every run the same probes, as the CLI's
evaluator has (its `seed` = 0), and so the same CG work: the probes
set how many iterations each solve takes.

Compared: `std_abs`; `nlml_rel`, the largest |NLML - reference| /
|reference| over the sampled evaluations (the reference's NLML exact);
`grad_rel`, the worst gradient entry over them, |g - g_ref| over the
larger of |g_ref| at that entry and the median |g_ref|. The reference
gradient is the program's estimator, the same Hutchinson probes, with
every solve exact.
"""

from __future__ import annotations

import math
import time

import numpy as np

from port_bench import data
from port_bench.loop import Loop, worst
from port_bench.window import Item, Record


class Replay(Loop):
    def setup(self):
        from gp_ss_ak_torch.optim.segmented import (
            make_segmented_value_and_grad,
        )

        t = self.traffic
        n, dev = self.config["n"], self.device
        key = self.seed if t["probe_seed"] is None else t["probe_seed"]
        self.Z_logdet = data.rademacher(key, (n, t["slq_probes"]), 3, dev)
        self.Z_trace = data.rademacher(key, (n, t["probes"]), 4, dev)
        self.points = []
        for f in t["factors"]:
            p = self.theta0.copy()
            p[:len(f)] *= np.asarray(f)
            self.points.append(p)
        self.vg = make_segmented_value_and_grad(
            self.model(), self.Xs, self.ys, probes=t["probes"],
            slq_probes=t["slq_probes"], Z_logdet=self.Z_logdet,
            Z_trace=self.Z_trace)

    def warm(self):
        # the cycle's last point, so the window's first evaluation starts
        # warm from it, as every later cycle does
        self.vg(self.points[-1])
        self.sync()

    def window(self, seconds: float) -> Record:
        t_start = time.perf_counter()
        rec = Record(t_start, t_start + seconds)
        i = 0
        while time.perf_counter() < rec.t_close:
            k = i % len(self.points)
            t0 = time.perf_counter()
            f, g = self.vg(self.points[k])
            t1 = time.perf_counter()
            rel = self.vg.last_rel_residual
            bad = not (math.isfinite(f) and np.all(np.isfinite(g))
                       and rel <= self.vg.cg_tol)
            rec.items.append(Item(t0, t1, 1, bad, {
                "point": k, "f": float(f), "g": np.array(g),
                "cg_iters": self.vg.last_cg_iters}))
            i += 1
        return rec

    def summary(self, rec) -> str:
        return "evaluations (point, ms, CG iterations): " + " ".join(
            f"{it.info['point']}:{(it.t_done - it.t_send) * 1e3:.1f}:"
            f"{it.info['cg_iters']}" for it in rec.items)

    def answers(self, rec, k: int):
        done = rec.completed()
        pick = data.draw(self.seed, k, len(done), 2)
        return [{"theta": self.points[done[i].info["point"]],
                 "f": done[i].info["f"], "g": done[i].info["g"]}
                for i in pick]

    def release(self):
        self.vg = None

    def _evaluation(self, inputs, theta, prec):
        """The reference's (NLML, gradient) at theta."""
        import torch

        Xs, ys = inputs[:2]
        fac = self.factor(Xs, theta, prec)
        f, alpha = self.ref.nlml(fac, ys)
        Z = torch.as_tensor(self.Z_trace, dtype=prec.dtype,
                            device=self.device)
        Ws = fac.solve(Z)
        del fac                         # the factor's tiles: 40 GB at 100k
        return f, self.ref.grad_hutchinson(
            Xs, theta, alpha, Ws, Z, prec, self.config["reference"]["chunk"])

    def produce(self, answers, prec):
        inputs = self.reference_inputs(prec)
        out = []
        for a in answers:
            f, g = self._evaluation(inputs, a["theta"], prec)
            out.append(dict(a, f=f, g=g))
        return out

    def numbers(self, answers) -> dict:
        inputs = self.reference_inputs(self.ref.F64)
        nr, gr = [], []
        for a in answers:
            f, g = self._evaluation(inputs, a["theta"], self.ref.F64)
            nr.append(abs(a["f"] - f) / abs(f))
            scale = np.maximum(np.abs(g), np.median(np.abs(g)))
            gr.append(np.max(np.abs(np.asarray(a["g"]) - g) / scale))
        return {"std_abs": self.std_abs(), "nlml_rel": worst(nr),
                "grad_rel": worst(gr)}


LOOP = Replay

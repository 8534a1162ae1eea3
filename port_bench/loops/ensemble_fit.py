"""ensemble_fit: `fit_ensemble` of every deposit of the configuration,
all from the configuration's hyperparameters, restarted from them each
time it returns: one client, a closed loop.

Deposit b is data.ore_body(seed * 100003 + b + 1, n), standardized on
its own by the port (MODE_SYMMETRIC), as chip_smoke.py's `deposits`
seeds them, without held-out queries. Each batched evaluation is one
answer of the window, ending where the fit's per-evaluation hook runs
(after the optimizer's flag read, so the card has finished it); the
hook ends the running fit at the window's close. It keeps each
evaluation's tensors on the card as the optimizer hands them over;
they are read back in one copy after the window. An evaluation fails
where a member whose result the optimizer used has a non-finite value
or gradient.

Traffic parameters: `maxiter` (each fit's), `warm_maxiter` (the
warm-up fit's), `fit_answers` (deposits of the checked fit sampled for
its returned best). The checked fit is the window's last whole fit, the
last that the hook did not cut, or, where the first fit outlasts the
window, the one that the hook cut.

Compared, each against reference/gp_ensemble.py in float64 at the
program's own flat hyperparameters: `std_abs`, the sampled deposits'
standardized data against the reference's; `nlml_rel`, the worst
|f - f_ref| / |f_ref| over the sampled (evaluation, used deposit)
pairs and the values that the checked fit returned for the sampled
deposits at their returned points; `grad_rel`, the worst gradient entry
over the pairs, |g - g_ref| over the larger of |g_ref| at that entry
and the median |g_ref| (as loops/replay.py computes it, here against
the exact gradient); `fit_gap`, which holds the optimizer: the mean
over the sampled deposits of the checked fit of (f_ref(returned point)
- f_end) / (f_start - f_end), where the reference's own fit of that
deposit (reference `fit`: L-BFGS-B in float64 from the same start, in
the configuration's box, for as many iterations as the deposit took in
the program, at least one) goes from f_start to f_end: 0 where the
program ends where the reference does, below 0 where it ends lower, 1
where it never left the start. The mean, not the worst: a deposit's
share varies more between deposits than the ensemble's mean does
between seeds.
"""

from __future__ import annotations

import time

import numpy as np

from port_bench import data, manifest
from port_bench.loop import Loop, worst
from port_bench.window import Item, Record


def deposit(seed: int, b: int, n: int):
    """Deposit b's raw composites (X (n, 3), y (n,))."""
    return data.ore_body(seed * 100003 + b + 1, n)


class EnsembleFit(Loop):
    def __init__(self, traffic, config, seed, device):
        import torch

        self.traffic, self.config, self.seed = traffic, config, seed
        self.device = device
        self.dtype = getattr(torch, config["dtype"])
        self.theta0 = np.asarray(config["hyper"], np.float64)
        self.ref = manifest.reference(config["reference"]["module"])
        self.B, self.n = config["deposits"], config["n"]

    def setup(self):
        import torch

        from gp_ss_ak_torch.data import MODE_SYMMETRIC, prepare
        from gp_ss_ak_torch.ensemble import fit_ensemble

        Xs, ys = [], []
        for b in range(self.B):
            X, y = deposit(self.seed, b, self.n)
            if X.shape[1] != self.config["d"]:
                raise ValueError(f"the data has {X.shape[1]} coordinates, "
                                 f"the configuration {self.config['d']}")
            Xb, yb, _ = prepare(X, y, MODE_SYMMETRIC)
            Xs.append(Xb)
            ys.append(yb)
        # the port's standardized data, kept on the host for std_abs;
        # on the card in float64, as read, which the objective runs in
        self.Xs, self.ys = np.stack(Xs), np.stack(ys)
        self.Xd = torch.as_tensor(self.Xs, device=self.device)
        self.yd = torch.as_tensor(self.ys, device=self.device)
        self.gp = self.model()
        self.fit = fit_ensemble

    def warm(self):
        # with a hook, so that a program without one fails here, at once
        self.fit(self.gp, self.Xd, self.yd,
                 maxiter=self.traffic["warm_maxiter"],
                 hook=lambda *_: False)
        self.sync()

    def window(self, seconds: float) -> Record:
        t_start = time.perf_counter()
        rec = Record(t_start, t_start + seconds)
        kept, fits, last, cut = [], [], [t_start], [False]

        def hook(points, values, grads, mask):
            t = time.perf_counter()
            rec.items.append(Item(last[0], t, 1, False,
                                  {"fit": len(fits)}))
            kept.append((points, values, grads, mask))
            last[0], cut[0] = t, t >= rec.t_close
            return cut[0]

        while time.perf_counter() < rec.t_close:
            last[0] = time.perf_counter()
            fits.append(self.fit(self.gp, self.Xd, self.yd,
                                 maxiter=self.traffic["maxiter"],
                                 hook=hook))
        whole = fits[:-1] if cut[0] else fits
        rec.extra["checked"] = "whole" if whole else "cut at the close"
        self._read_back(rec, kept, (whole or fits)[-1])
        return rec

    def _read_back(self, rec, kept, fit):
        """The hook's tensors and the last fit's result to the host, in
        one copy each: every item's failed flag and used share."""
        import torch

        stacked = [torch.stack([k[j] for k in kept]).double()
                   for j in range(4)]
        self.points, self.values, self.grads, used = (
            a.cpu().numpy() for a in stacked)
        self.used = used.astype(bool)
        ok = np.isfinite(self.values) & np.all(np.isfinite(self.grads), -1)
        for it, u, good in zip(rec.items, self.used, ok):
            it.failed = bool(np.any(u & ~good))
            it.info["used_pct"] = 100.0 * float(np.mean(u))
        self.checked = (fit.flat.double().cpu().numpy(),
                        fit.fun.double().cpu().numpy(),
                        fit.n_iters.cpu().numpy())
        rec.extra["fits"] = len({it.info["fit"] for it in rec.items})

    def summary(self, rec) -> str:
        done = rec.completed()
        return (f"{len(done)} evaluations by the close over "
                f"{rec.extra['fits']} fits; members used per evaluation "
                f"{np.mean([it.info['used_pct'] for it in done]):.2f}% "
                f"on average; the checked fit {rec.extra['checked']}")

    def answers(self, rec, k: int):
        used = self.used[:len(rec.completed())]
        pairs = np.argwhere(used)
        out = [{"deposit": int(b), "theta": self.points[i, b],
                "f": float(self.values[i, b]), "g": self.grads[i, b]}
               for i, b in pairs[data.draw(self.seed, k, len(pairs), 2)]]
        flat, fun, iters = self.checked
        for b in data.draw(self.seed, self.traffic["fit_answers"], self.B,
                           3):
            out.append({"deposit": int(b), "theta": flat[b],
                        "f": float(fun[b]), "g": None,
                        "iters": int(iters[b])})
        return out

    def release(self):
        self.gp = self.Xd = self.yd = None

    def _evaluate(self, a, prec):
        return self.ref.evaluate(*deposit(self.seed, a["deposit"], self.n),
                                 a["theta"], prec, self.device)

    def produce(self, answers, prec):
        out = []
        for a in answers:
            f, g = self._evaluate(a, prec)
            out.append(dict(a, f=f, g=None if a["g"] is None else g))
        return out

    def _gap(self, a, f) -> float:
        """The fit's remaining gap to the reference's own fit of deposit
        a from the same start, as a share of the reference's decrease;
        f is the exact NLML at the program's returned point."""
        lo, hi = self.config["box"]
        f0, f1 = self.ref.fit(*deposit(self.seed, a["deposit"], self.n),
                              self.theta0, lo, hi, max(a["iters"], 1),
                              self.device)
        return (f - f1) / (f0 - f1)

    def numbers(self, answers) -> dict:
        std, nr, gr, gap = [], [], [], []
        for b in sorted({a["deposit"] for a in answers}):
            Xs, ys, _, _ = self.ref.standardize(*deposit(self.seed, b,
                                                         self.n))
            std += [np.max(np.abs(self.Xs[b] - Xs)),
                    np.max(np.abs(self.ys[b] - ys))]
        for a in answers:
            f, g = self._evaluate(a, self.ref.F64)
            nr.append(abs(a["f"] - f) / abs(f))
            if a["g"] is not None:
                scale = np.maximum(np.abs(g), np.median(np.abs(g)))
                gr.append(np.max(np.abs(np.asarray(a["g"]) - g) / scale))
            if "iters" in a:
                gap.append(self._gap(a, f))
        return {"std_abs": worst(std), "nlml_rel": worst(nr),
                "grad_rel": worst(gr),
                "fit_gap": float(np.mean(gap))}


LOOP = EnsembleFit

"""fit: the CLI's default `train`, `optim.api.fit(model, Xs, ys,
optimizer="LBFGS", iters=..., engine="dense")` on the port's own
standardized data from the configuration's hyperparameters, in the
default box, restarted from them each time it returns: one client, a
closed loop.

Each NLML + gradient evaluation of the host L-BFGS-B is one answer,
with the span, point, value and gradient that `fit(timing=)` records as
the fit runs; it completes in the window when it ends by the close. At
the close the fit's `callback`, which the optimizer calls at the end of
each iteration, ends the running fit: it raises `Closed`, which the
loop catches. A fit so cut returns the last iterate the callback saw,
its best (the optimizer accepts only steps that lower the value). A
program whose fit keeps no record of its evaluations cannot run the
cell: the warm-up says so and the run exits 1.

Traffic parameters: `iters` (each fit's), `warm_iters` (the warm-up
fit's), `late_answers` (of the sampled evaluations, how many come after
their fit's first accepted step, where the fit has left the start),
`box` (the program's default box, [lower, upper] on every
hyperparameter, which the reference's fit takes). The checked fit is
the window's last whole fit, or, where the first fit outlasts the
window, the one that the callback cut.

Compared, each against reference/gp_dense.py in float64 (exact: A^-1
from the factor) at the program's own points: `std_abs`, the port's
standardized data against the reference's; `nlml_rel`, the worst
|f - f_ref| / |f_ref| over the sampled evaluations and the value the
checked fit returned at its returned point; `grad_rel`, the worst
gradient entry over the sampled evaluations, |g - g_ref| over the
larger of |g_ref| at that entry and the median |g_ref| (as ens256-fit
and iter100k-fit compute it); `fit_gap`, which holds the optimizer:
(f_ref(returned point) - f_end) / (f_start - f_end), where the
reference's own fit (reference `fit`: L-BFGS-B in float64 from the
same start, in the same box) goes from f_start to f_end: 0 where the
program ends where the reference does, below 0 where it ends lower, 1
where it never left the start. The reference's fit has the checked
fit's budget of iterations: `iters` where the fit stopped by its own
rule (so a fit that stops too soon is held to a whole fit), the
iterations it had taken where the callback cut it.

The configuration names reference/gp_dense.py, which takes reference/
gp.py's NLML and adds the exact gradient and the fit.
"""

from __future__ import annotations

import time

import numpy as np

from port_bench import data
from port_bench.loop import Loop, worst
from port_bench.window import Item, Record


class Closed(Exception):
    """Raised by the fit's callback at the window's close."""


class Fit(Loop):
    def setup(self):
        from gp_ss_ak_torch.optim import fit

        self.gp = self.model()
        # the start as the model holds it, which the reference's fit
        # starts from too
        self.start = self.gp.pack().double().cpu().numpy()
        self.fit = fit

    def _fit(self, iters: int, callback=None):
        """One fit from the start: (timing, result or None where the
        callback ended it)."""
        timing = {}
        try:
            _, res = self.fit(self.gp, self.Xs, self.ys,
                              optimizer=self.traffic["optimizer"],
                              iters=iters, engine="dense",
                              callback=callback, timing=timing)
        except Closed:
            res = None
        return timing, res

    def warm(self):
        timing, _ = self._fit(self.traffic["warm_iters"])
        self.sync()
        if "evals" not in timing:
            raise RuntimeError("the program's fit keeps no record of its "
                               "evaluations (fit(timing=)['evals']): the "
                               "cell cannot compare its answers")

    def window(self, seconds: float) -> Record:
        t_start = time.perf_counter()
        rec = Record(t_start, t_start + seconds)
        fits = []
        while time.perf_counter() < rec.t_close:
            seen = []

            def callback(it, x, f):
                seen.append((it, np.array(x, np.float64), float(f)))
                if time.perf_counter() >= rec.t_close:
                    raise Closed

            timing, res = self._fit(self.traffic["iters"], callback)
            if res is None:
                it, x, f = seen[-1]
            else:
                it, x, f = res.n_iters, np.asarray(res.x, np.float64), \
                    float(res.fun)
            fits.append({"whole": res is not None, "iters": it, "x": x,
                         "f": f, "timing": timing,
                         "budget": self.traffic["iters"] if res else it,
                         "stop": res.stop_reason if res else "cut"})
        self._record(rec, fits)
        return rec

    def _record(self, rec, fits):
        """Every evaluation of every fit as an item, in order; the
        evaluations kept for `answers`; the checked fit."""
        self.evals = []
        for k, fr in enumerate(fits):
            t = fr["timing"]
            first = (t["evals_per_iter"] or [len(t["evals"])])[0]
            for i, ((t0, t1), (x, f, g)) in enumerate(
                    zip(t["eval_spans"], t["evals"])):
                bad = not (np.isfinite(f) and np.all(np.isfinite(g)))
                rec.items.append(Item(t0, t1, 1, bad, {
                    "fit": k, "late": i >= first}))
                self.evals.append((x, float(f), np.asarray(g)))
        whole = [fr for fr in fits if fr["whole"]]
        self.checked = (whole or fits)[-1]
        rec.extra["fits"] = len(fits)
        rec.extra["checked"] = "whole" if whole else "cut at the close"
        rec.extra["evals_per_iter"] = [n for fr in fits
                                       for n in fr["timing"]["evals_per_iter"]]

    def summary(self, rec) -> str:
        done = rec.completed()
        per_iter = rec.extra["evals_per_iter"]
        return (f"{len(done)} evaluations by the close over "
                f"{rec.extra['fits']} fits, "
                f"{np.mean(per_iter) if per_iter else float('nan'):.3f} "
                f"an iteration, {sum(it.failed for it in done)} failed; "
                f"the checked fit {rec.extra['checked']}, "
                f"{self.checked['iters']} iterations "
                f"({self.checked['stop']}), NLML {self.checked['f']!r}")

    def answers(self, rec, k: int):
        done = rec.completed()
        late = [i for i, it in enumerate(done) if it.info["late"]]
        pick = [late[j] for j in data.draw(
            self.seed, self.traffic["late_answers"], len(late), 2)]
        rest = [i for i in range(len(done)) if i not in set(pick)]
        pick += [rest[j] for j in data.draw(self.seed, k - len(pick),
                                            len(rest), 3)]
        out = [{"theta": self.evals[i][0], "f": self.evals[i][1],
                "g": self.evals[i][2]} for i in sorted(pick)]
        c = self.checked
        out.append({"theta": c["x"], "f": c["f"], "g": None,
                    "iters": c["budget"]})
        return out

    def release(self):
        self.gp = None

    def _evaluate(self, inputs, theta, prec):
        c = self.config["reference"]
        return self.ref.evaluate(inputs[0], inputs[1], theta, prec,
                                 c["tile"], c["chunk"])

    def produce(self, answers, prec):
        inputs = self.reference_inputs(prec)
        out = []
        for a in answers:
            f, g = self._evaluate(inputs, a["theta"], prec)
            out.append(dict(a, f=f, g=None if a["g"] is None else g))
        return out

    def numbers(self, answers) -> dict:
        inputs = self.reference_inputs(self.ref.F64)
        nr, gr, gap = [], [], []
        for a in answers:
            f, g = self._evaluate(inputs, a["theta"], self.ref.F64)
            nr.append(abs(a["f"] - f) / abs(f))
            if a["g"] is not None:
                scale = np.maximum(np.abs(g), np.median(np.abs(g)))
                gr.append(np.max(np.abs(np.asarray(a["g"]) - g) / scale))
            if "iters" in a:
                lo, hi = self.traffic["box"]
                c = self.config["reference"]
                f0, f1 = self.ref.fit(inputs[0], inputs[1], self.start, lo,
                                      hi, max(a["iters"], 1), c["tile"],
                                      c["chunk"])
                gap.append((f - f1) / (f0 - f1))
        return {"std_abs": self.std_abs(), "nlml_rel": worst(nr),
                "grad_rel": worst(gr), "fit_gap": worst(gap)}


LOOP = Fit

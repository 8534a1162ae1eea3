"""Each cell driven end to end on the CPU at a small size, the look for
a card skipped: the program's answers pass, and the control (the
reference in TF32 in the program's place) and the timed path broken
underneath each come out not correct.

The limits here are this size's own: the cells' limits were set from
readings at their full sizes, where the matrix-free NLML's estimator
noise is smaller than at a few hundred points."""

import time

import numpy as np
import pytest

from port_bench import harness

N = 300
LIMITS = {
    "iter100k-fit": {"std_abs": 0.0, "nlml_rel": 0.05, "grad_rel": 5e-3},
    "dense16k-predict": {"std_abs": 0.0, "mean_z": 1e-3, "var_rel": 1e-3},
}
CELLS = list(LIMITS)


def small(workload):
    over = {"config": {"n": N, "reference": {"module": "gp", "tile": 128,
                                             "chunk": 100}},
            "spec": {"answers": 2, "limits": LIMITS[workload]}}
    if workload == "dense16k-predict":
        over["traffic"] = {"request_points": 64, "first_predict_reps": 1}
    return over


def run(workload, control=False, seed=987654321012):
    result, _ = harness.run(workload, seed, 0.5, False,
                            time.perf_counter(), device="cpu",
                            control=control, overrides=small(workload))
    return result


@pytest.mark.parametrize("workload", CELLS)
def test_the_program_passes(workload):
    r = run(workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2


@pytest.mark.parametrize("workload", CELLS)
def test_the_tf32_control_fails(workload):
    assert not run(workload, control=True)["correct"]


# -- the timed path broken underneath --------------------------------------

def _replay_wrap(monkeypatch, broken):
    from gp_ss_ak_torch.optim import segmented

    orig = segmented.make_segmented_value_and_grad

    def make(*a, **k):
        vg = orig(*a, **k)

        class Bad:
            def __init__(self):
                self.last = None

            def __getattr__(self, name):
                return getattr(vg, name)

            def __call__(self, x):
                return broken(self, vg, x)
        return Bad()
    monkeypatch.setattr(segmented, "make_segmented_value_and_grad", make)


def _replay_altered(monkeypatch):
    def broken(self, vg, x):
        f, g = vg(x)
        g = np.array(g)
        g[6] = -g[6]
        return f, g
    _replay_wrap(monkeypatch, broken)


def _replay_unchanged(monkeypatch):
    """Every evaluation returns the one before it."""
    def broken(self, vg, x):
        out, self.last = self.last, vg(x)
        return self.last if out is None else out
    _replay_wrap(monkeypatch, broken)


def _replay_half(monkeypatch):
    """The evaluator over half of the data (and of the probes' rows),
    its value and gradient scaled back up to all of it."""
    from gp_ss_ak_torch.optim import segmented

    orig = segmented.make_segmented_value_and_grad

    def make(model, X, y, **k):
        h = len(y) // 2
        vg = orig(model, X[:h], y[:h], **dict(
            k, Z_logdet=k["Z_logdet"][:h], Z_trace=k["Z_trace"][:h]))

        class Half:
            def __getattr__(self, name):
                return getattr(vg, name)

            def __call__(self, x):
                f, g = vg(x)
                return 2.0 * f, 2.0 * np.asarray(g)
        return Half()
    monkeypatch.setattr(segmented, "make_segmented_value_and_grad", make)


def _serve_wrap(monkeypatch, broken):
    from gp_ss_ak_torch import serve

    orig = serve.Predictor.__call__

    def call(self, Xq, *a, **k):
        return broken(lambda X: orig(self, X, *a, **k), Xq)
    monkeypatch.setattr(serve.Predictor, "__call__", call)


def _serve_altered(monkeypatch):
    def broken(ask, Xq):
        mu, var = ask(Xq)
        mu = np.array(mu)
        mu[0] += 0.05
        return mu, var
    _serve_wrap(monkeypatch, broken)


def _serve_half(monkeypatch):
    def broken(ask, Xq):
        h = len(Xq) // 2
        mu, var = ask(Xq[:h])
        return np.concatenate([mu, mu]), np.concatenate([var, var])
    _serve_wrap(monkeypatch, broken)


FAULTS = [("iter100k-fit", _replay_altered),
          ("iter100k-fit", _replay_unchanged),
          ("iter100k-fit", _replay_half),
          ("dense16k-predict", _serve_altered),
          ("dense16k-predict", _serve_half)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert not run(workload)["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["iter100k-fit", "dense16k-predict"])
def test_the_control_fails_at_the_cells_size_on_the_card(workload, card):
    """The control at the cell's own size (a short window), on the card."""
    result, _ = harness.run(workload, 2147499001, 3.0, False,
                            time.perf_counter(), control=True)
    assert result["attempted"] >= 1 and not result["correct"]

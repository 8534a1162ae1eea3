"""The cell ens256-fit driven end to end on the CPU at 4 deposits x 64
composites, the look for a card skipped: the program's answers pass, and
the control (the reference in TF32 in the program's place), the timed
path broken underneath and the optimizer broken each come out not
correct.

The limits here are this size's own: at 64 composites the NLML is tens
in size and can pass near zero, and the batched L-BFGS ends further from
the reference's fit (`fit_gap` 0.22-0.25 here; the frozen iterate
0.65-0.68, half the batch 0.59-0.68). A 3 s window holds two whole fits
at this size, so that `fit_gap` has one to read."""

import inspect
import time

import pytest
import torch

from port_bench import harness

CELL = "ens256-fit"
LIMITS = {"std_abs": 0.0, "nlml_rel": 1e-4, "grad_rel": 2e-3,
          "fit_gap": 0.45}
SMALL = {"config": {"deposits": 4, "n": 64},
         "spec": {"answers": 16, "limits": LIMITS}}


def run(control=False, seed=987654321012, seconds=3.0, overrides=SMALL,
        log=None):
    result, _ = harness.run(CELL, seed, seconds, False, time.perf_counter(),
                            device="cpu", control=control,
                            overrides=overrides, log=log)
    return result


@pytest.mark.parametrize("checked", ["whole", "cut at the close"])
def test_the_program_passes(checked):
    """On the last whole fit, and on the fit that the hook cut where the
    first outlasts the window (here by 200 iterations in 1 s)."""
    lines = []
    if checked == "whole":
        r = run(log=lines.append)
    else:
        r = run(seconds=1.0, log=lines.append,
                overrides=dict(SMALL, traffic={"maxiter": 200}))
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 16 and r["failed"] == 0
    assert set(r["metrics"]) == {"setup_s", "train_eval_ms"}
    assert any(line.endswith(f"the checked fit {checked}") for line in lines)


def test_the_tf32_control_fails():
    assert not run(control=True)["correct"]


# -- the timed path broken underneath --------------------------------------

def _ens_neighbour(monkeypatch):
    """Each deposit b evaluated on deposit b + 1's data (the last on the
    first's)."""
    from gp_ss_ak_torch.ensemble import batched

    orig = batched.minimize_batched

    def shifted(model, X, y, *a, **k):
        return orig(model, torch.roll(torch.as_tensor(X), -1, 0),
                    torch.roll(torch.as_tensor(y), -1, 0), *a, **k)
    monkeypatch.setattr(batched, "minimize_batched", shifted)


def _ens_unchanged(monkeypatch):
    """Every batched evaluation answered with the one before it (the
    first of a fit with its own)."""
    from gp_ss_ak_torch.optim import api

    orig = api.batched_value_and_grad

    def make(*a, **k):
        vg = orig(*a, **k)
        last = []

        def stale(flats):
            now = vg(flats)
            out = last[0] if last else now
            last[:] = [now]
            return out
        return stale
    monkeypatch.setattr(api, "batched_value_and_grad", make)


def _planted_minimize(monkeypatch, old: str, new: str):
    """batched_lbfgs.minimize with `old`, found once in its module's
    source, replaced by `new`."""
    from gp_ss_ak_torch.optim import batched_lbfgs

    src = inspect.getsource(batched_lbfgs)
    assert src.count(old) == 1, old
    ns = {"__name__": batched_lbfgs.__name__}
    exec(compile(src.replace(old, new), batched_lbfgs.__file__, "exec"), ns)
    monkeypatch.setattr(batched_lbfgs, "minimize", ns["minimize"])


def _ens_frozen(monkeypatch):
    """The optimizer's iterate never moves: every iteration searches from
    the start again, and the best candidate it accepts is returned."""
    _planted_minimize(monkeypatch,
                      "            x = torch.where(active[:, None], x_new, x)\n"
                      "            f = torch.where(active, f_new, f)\n"
                      "            g = torch.where(active[:, None], g_new, g)\n",
                      "")


def _ens_half(monkeypatch):
    """Half the members marked done at the start: never evaluated past
    it, they return the start."""
    _planted_minimize(monkeypatch,
                      "done = torch.zeros(B, dtype=torch.bool, "
                      "device=x.device)",
                      "done = torch.arange(B, device=x.device) >= B // 2")


FAULTS = [_ens_neighbour, _ens_unchanged, _ens_frozen, _ens_half]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[5:] for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not run()["correct"]


@pytest.mark.gpu
def test_the_control_fails_at_the_cells_size_on_the_card(card):
    """The control at the cell's own size (a short window), on the card."""
    result, _ = harness.run(CELL, 2147499001, 3.0, False,
                            time.perf_counter(), control=True)
    assert result["attempted"] >= 1 and not result["correct"]

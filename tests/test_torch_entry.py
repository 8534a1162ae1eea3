"""Port parity: gp_ss_ak_torch.entry.dryrun_multichip, the mesh dry run,
against the JAX package's (__graft_entry__.dryrun_multichip).

The port's dry run runs in place on 2 and on 3 torch ranks over gloo on
the CPU (tests/torch_mesh_worker.py), and again from this process, where
it starts its own 2 ranks. The JAX dry run runs here on 2 and 3 of the
CPU devices tests/conftest.py forces, and prints its numbers to 4
decimals. At 3 ranks the two-level batch runs on ranks 0-1 and rank 2
skips it, as JAX puts it on its first 2 devices.

Tolerances: the dist NLML, float32 in both packages on 16 points, within
1e-4 relative of the JAX line's (measured 1.7e-5 at 2 ranks); the ring's
value draws other probes in each package, so it is held to be finite with
its CG converged, as the JAX dry run holds its own; the 3-iteration fit
only to improve on the start, since two float32 line searches need not
take the same steps. The launched ranks against the in-place ones:
rtol 1e-6 (the same computations in other processes).
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from torch_mesh_worker import collect, start

torch.set_num_threads(1)

LINE = (r"dryrun_multichip\((\d+)\): nlml=(\S+) fit3=(\S+) ring=(\S+) "
        r"predict\+2level ok")


@pytest.fixture(scope="module")
def dry_runs(tmp_path_factory):
    """{n: (the JAX dry run's printed line at n devices, the n ranks'
    results)} for n = 2 and 3."""
    import __graft_entry__ as graft

    worlds = (2, 3)
    handle = start({n: {"suite": "dryrun"} for n in worlds},
                   str(tmp_path_factory.mktemp("dryrun")))
    texts = {}
    try:
        for n in worlds:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                graft.dryrun_multichip(n)
            texts[n] = out.getvalue()
    finally:
        ranks = collect(handle)
    return {n: (texts[n], ranks[n]) for n in worlds}


@pytest.fixture(scope="module")
def two_ranks(dry_runs):
    """(the JAX dry run's printed line, the 2 ranks' results)."""
    return dry_runs[2]


def test_dryrun_in_place_matches_jax(two_ranks):
    _matches_jax(*two_ranks, 2)


def test_dryrun_on_three_ranks_matches_jax(dry_runs):
    _matches_jax(*dry_runs[3], 3)


def _matches_jax(jax_text, ranks, world):
    n, nlml, fit3, ring = re.search(LINE, jax_text).groups()
    assert n == str(world)
    for r in ranks:
        line = str(r["line"])
        assert re.fullmatch(LINE, line).group(1) == str(world)
        assert float(r["nlml"]) == pytest.approx(float(nlml), rel=1e-4)
        assert float(r["fit3"]) <= float(r["nlml"]) + 1e-6
        assert np.isfinite(float(r["ring"])) and float(r["ring_rel"]) < 1e-4
        assert int(r["ring_iters"]) > 0
        # every rank returns the same numbers
        for key in ("nlml", "fit3", "ring"):
            assert float(r[key]) == float(ranks[0][key])


def test_dryrun_runs_two_level_on_a_prefix_of_an_odd_world(dry_runs):
    """At 3 ranks the two-level batch (2 chains x 1 row) runs on ranks
    0-1, and rank 2, which helped build its groups, skips it; at 2 ranks
    every rank runs it."""
    assert [bool(r["two_level"]) for r in dry_runs[3][1]] == [True, True,
                                                              False]
    assert all(bool(r["two_level"]) for r in dry_runs[2][1])


def test_dryrun_starts_its_own_ranks(two_ranks, capsys):
    from gp_ss_ak_torch.entry import dryrun_multichip

    _, ranks = two_ranks
    res = dryrun_multichip(2, device="cpu")
    assert capsys.readouterr().out.strip().endswith(res["line"])
    for key in ("nlml", "fit3", "ring"):
        assert res[key] == pytest.approx(float(ranks[0][key]), rel=1e-6)


def test_dryrun_on_one_rank_runs_in_place(capsys):
    from gp_ss_ak_torch.entry import dryrun_multichip

    res = dryrun_multichip(1, device="cpu")
    assert re.fullmatch(LINE, capsys.readouterr().out.strip()).group(1) \
        == "1"
    assert res["fit3"] <= res["nlml"] + 1e-6 and res["ring_rel"] < 1e-4


def test_launch_local_stops_every_rank_at_the_first_failure(tmp_path):
    """parallel.launch_local, the one launcher of local ranks (the dry
    run's and chip_smoke.py's): each rank sees torchrun's variables; a
    failing rank stops the others long before the time limit, and the
    error carries every rank's log. The failing rank exits only once
    rank 0 has logged its line (or after ~20 s), since under load rank 0
    may not have started when it is stopped."""
    import sys
    import time

    from gp_ss_ak_torch.parallel import launch_local

    code = ("import os, sys, time\n"
            "r = os.environ['RANK']\n"
            "print('rank', r, 'of', os.environ['WORLD_SIZE'],\n"
            "      os.environ['MASTER_ADDR'], os.environ['LOCAL_RANK'])\n"
            "sys.stdout.flush()\n"
            "if r == sys.argv[2]:\n"
            "    end = time.monotonic() + 20\n"
            "    while time.monotonic() < end:\n"
            "        with open(sys.argv[3]) as f:\n"
            "            if 'rank 0 of' in f.read():\n"
            "                break\n"
            "        time.sleep(0.05)\n"
            "    sys.exit(3)\n"
            "time.sleep(float(sys.argv[1]))\n")
    wall = launch_local([sys.executable, "-c", code, "0", "none",
                         str(tmp_path / "ok" / "rank0.log")], 2,
                        str(tmp_path / "ok"), timeout=60)
    assert wall < 60
    assert (tmp_path / "ok" / "rank0.log").read_text() \
        == "rank 0 of 2 127.0.0.1 0\n"
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        launch_local([sys.executable, "-c", code, "120", "1",
                      str(tmp_path / "bad" / "rank0.log")], 2,
                     str(tmp_path / "bad"), timeout=60)
    assert time.perf_counter() - t0 < 30
    assert "rank 0 of 2" in str(err.value) and "rank 1 of 2" in str(err.value)


def test_launch_local_starts_again_when_its_port_was_taken(tmp_path,
                                                           monkeypatch):
    """A port that another process takes between launch_local's choice
    and rank 0's bind (here one held by a listening socket) fails rank
    0's store with EADDRINUSE: the launch starts again on another port,
    and gives up after LAUNCH_ATTEMPTS launches on taken ports."""
    import socket
    import sys

    from gp_ss_ak_torch.parallel import multihost

    code = ("import datetime, os, torch.distributed as dist\n"
            "r = int(os.environ['RANK'])\n"
            "store = dist.TCPStore(os.environ['MASTER_ADDR'],\n"
            "                      int(os.environ['MASTER_PORT']), 2, r == 0,\n"
            "                      timeout=datetime.timedelta(seconds=60))\n"
            "store.set(f'rank{r}', 'up')\n"
            "store.wait(['rank0', 'rank1'])\n"
            "print('port', os.environ['MASTER_PORT'])\n")
    free = multihost._free_port
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen()
        taken = busy.getsockname()[1]
        chosen = []

        def first_taken():
            chosen.append(taken if not chosen else free())
            return chosen[-1]

        monkeypatch.setattr(multihost, "_free_port", first_taken)
        multihost.launch_local([sys.executable, "-c", code], 2,
                               str(tmp_path / "retry"), timeout=120)
        # on a busy machine a free port too may be taken before the bind
        assert 2 <= len(chosen) <= multihost.LAUNCH_ATTEMPTS
        log = (tmp_path / "retry" / "rank0.log").read_text()
        assert log.endswith(f"port {chosen[-1]}\n") and chosen[-1] != taken

        chosen.clear()
        monkeypatch.setattr(multihost, "_free_port",
                            lambda: chosen.append(taken) or taken)
        with pytest.raises(RuntimeError, match="EADDRINUSE"):
            multihost.launch_local([sys.executable, "-c", code], 2,
                                   str(tmp_path / "taken"), timeout=120)
        assert len(chosen) == multihost.LAUNCH_ATTEMPTS

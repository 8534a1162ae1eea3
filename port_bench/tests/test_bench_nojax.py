"""The no-JAX check, passing and failing."""

import subprocess
import sys

from port_bench import nojax


def test_whole_top_level_names():
    assert nojax.loaded_forbidden(["gp_ss_ak_torch", "gp_ss_ak_torch.ops",
                                   "torch", "jaxtyping"]) == []
    assert nojax.loaded_forbidden(["gp_ss_ak_tpu.ops", "jax.numpy",
                                   "flax"]) == ["flax", "gp_ss_ak_tpu",
                                                "jax"]


def test_the_reference_imports_nothing_of_the_program():
    assert nojax.reference_forbidden() == []


def test_a_reference_that_imports_the_program_is_caught(tmp_path):
    (tmp_path / "bad.py").write_text(
        "import numpy\nfrom gp_ss_ak_torch.ops import pairwise\n")
    assert nojax.reference_forbidden(tmp_path) == [("bad.py",
                                                    "gp_ss_ak_torch")]
    assert nojax.violations(["torch"], tmp_path) == [
        "reference bad.py imports 'gp_ss_ak_torch'"]


def test_a_run_process_loads_no_jax():
    code = ("import sys; import port_bench.harness, "
            "port_bench.loops.replay, port_bench.loops.serve, "
            "port_bench.reference.gp, gp_ss_ak_torch.serve, "
            "gp_ss_ak_torch.optim.segmented; from port_bench import nojax; "
            "print(nojax.violations())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_no_card_means_no_result():
    # without a card the run exits 2 and prints nothing
    import torch

    if torch.cuda.is_available():
        return
    p = subprocess.run([sys.executable, "-m", "port_bench", "--workload",
                        "dense16k-predict", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True)
    assert p.returncode == 2 and p.stdout == ""

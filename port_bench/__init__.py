"""The benchmark of gp_ss_ak_torch on one NVIDIA H100 (see harness.py,
and PERF.md at the root of the repository)."""

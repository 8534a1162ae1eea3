"""The check that a run measured the PyTorch port alone.

Module names are compared by their top-level name (the part before the
first dot) as a whole, so `gp_ss_ak_torch` never matches
`gp_ss_ak_tpu`.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

#: what no process that prints a result may have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "gp_ss_ak_tpu")
#: what the reference may not import besides those
PROGRAM = "gp_ss_ak_torch"
REFERENCE_DIR = Path(__file__).resolve().parent / "reference"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None):
    """The forbidden top-level names among `modules` (sys.modules)."""
    names = {top(m) for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def imports_of(source: str):
    """The top-level names a Python source imports (absolute imports)."""
    found = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(top(node.module))
    return found


def reference_forbidden(ref_dir: Path = REFERENCE_DIR):
    """(file, name) for each import of the program, of the JAX package
    or of JAX in the reference's sources."""
    bad = set(FORBIDDEN) | {PROGRAM}
    return sorted((p.name, n) for p in ref_dir.glob("*.py")
                  for n in imports_of(p.read_text()) & bad)


def violations(modules=None, ref_dir: Path = REFERENCE_DIR):
    """Lines naming every breach; empty when the run is clean."""
    out = [f"loaded module {n!r}" for n in loaded_forbidden(modules)]
    out += [f"reference {f} imports {n!r}"
            for f, n in reference_forbidden(ref_dir)]
    return out

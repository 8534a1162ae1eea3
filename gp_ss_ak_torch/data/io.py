"""Data-file reader/writers.

Input format (readDataSize/readDataFile, Control.cpp:27-141): text
rows, comma- or tab-delimited, lines starting with '#' skipped; the
widest row determines the column count; the LAST column is the target
y, all prior columns are inputs X.

Prediction output (gp_ss_ak.cpp:471-481): header
"# SampleNo, Y,  Yh, StdYh, Inputs", rows sorted by observed y
ascending, tab-separated.

A copy of gp_ss_ak_tpu/data/io.py: `read_data` takes the native C++
parser (gp_ss_ak_torch/native) when its library builds, and the
pure-NumPy parser otherwise; both give the same table.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _parse_lines(text: str) -> np.ndarray:
    rows = []
    width = 0
    for line in text.splitlines():
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        toks = [t for t in line.replace(",", " ").replace("\t", " ").split()
                if t]
        if not toks:
            continue
        vals = [float(t) for t in toks]
        width = max(width, len(vals))
        rows.append(vals)
    out = np.zeros((len(rows), width), np.float64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def read_data(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X, y): last column is y (Control.cpp:61-77)."""
    from gp_ss_ak_torch.native import loader

    table = loader.parse_file(path)
    if table is not None:
        return table[:, :-1].copy(), table[:, -1].copy()
    with open(path, "r") as f:
        table = _parse_lines(f.read())
    if table.shape[1] < 2:
        raise ValueError(f"{path}: need at least 2 columns (X..., y)")
    return table[:, :-1].copy(), table[:, -1].copy()


def write_data(path: str, X: np.ndarray, y: np.ndarray,
               delimiter: str = "\t") -> None:
    table = np.concatenate([np.asarray(X, np.float64),
                            np.asarray(y, np.float64).reshape(-1, 1)], axis=1)
    np.savetxt(path, table, delimiter=delimiter, fmt="%.10g")


def write_predictions(path: str, y: np.ndarray, yh: np.ndarray,
                      std_yh: np.ndarray, X: np.ndarray) -> np.ndarray:
    """Reference prediction file: sorted by observed y ascending, columns
    [SampleNo(1-based), Y, Yh, StdYh, X...] (gp_ss_ak.cpp:434-481).
    Returns the sort order used."""
    y = np.asarray(y, np.float64).reshape(-1)
    order = np.argsort(y, kind="stable")
    sample_no = np.arange(1, y.shape[0] + 1, dtype=np.float64)
    cols = [
        sample_no,
        y[order],
        np.asarray(yh, np.float64).reshape(-1)[order],
        np.asarray(std_yh, np.float64).reshape(-1)[order],
    ]
    Xs = np.asarray(X, np.float64)[order]
    table = np.column_stack(cols + [Xs])
    with open(path, "w") as f:
        f.write("# SampleNo, Y,  Yh, StdYh, Inputs\n")
        for row in table:
            f.write("\t".join(f"{v:.10g}" for v in row) + "\t\n")
    return order

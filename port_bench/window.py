"""The arithmetic of the end-to-end metrics over one measured window.

Every rate is all the work completed in the window over all of its
time, from the window's start to the end of the last piece of work that
completed in it: ending there, and not at the planned close, removes
the rounding error of a few long steps. A piece of work completes in
the window when it ends by the planned close.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class Item:
    """One answer of the window: an evaluation or a request."""

    t_send: float
    t_done: float
    points: int = 1
    failed: bool = False
    info: dict = field(default_factory=dict)


@dataclass
class Record:
    """What a window did: its start, its planned close, and its answers
    in the order they completed."""

    t_start: float
    t_close: float
    items: List[Item] = field(default_factory=list)
    extra: dict = field(default_factory=dict)

    def completed(self) -> List[Item]:
        return [it for it in self.items if it.t_done <= self.t_close]


def span_s(rec: Record) -> float:
    """From the window's start to the end of its last completed answer."""
    done = rec.completed()
    if not done:
        raise ValueError("no answer completed in the window")
    return done[-1].t_done - rec.t_start


def per_item_ms(rec: Record) -> float:
    """Window time per completed answer (an evaluation's share of the
    window, the optimizer's time between evaluations included)."""
    return span_s(rec) / len(rec.completed()) * 1e3


def points_per_s(rec: Record) -> float:
    """Query points answered per second of the window."""
    return sum(it.points for it in rec.completed()) / span_s(rec)


def p95_ms(rec: Record) -> float:
    """95th percentile of the completed requests' latencies, each from
    its send (numpy's linear interpolation between order statistics)."""
    lat = [it.t_done - it.t_send for it in rec.completed()]
    if not lat:
        raise ValueError("no answer completed in the window")
    return float(np.percentile(lat, 95)) * 1e3


"""Where a run's set-up goes: named marks on the host clock, which run.py
prints on standard error part by part."""
from __future__ import annotations

import time

MARKS: list = []


def mark(label: str) -> None:
    """The part of set-up called ``label`` ends now."""
    MARKS.append((label, time.perf_counter()))


def parts(t_start: float) -> list:
    """[(label, seconds)] of each part since the previous mark."""
    out, last = [], t_start
    for label, t in MARKS:
        out.append((label, t - last))
        last = t
    return out

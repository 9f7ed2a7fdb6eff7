"""The verdict ``correct``: each number that a kind's ``numbers(program,
ref)`` compares (``harness/<kind>.py`` says what they are) against its
limit in ``limits/<cell>.json``.

A number that is not finite reads 1e308 (JSON has no infinity), and
fails any limit.
"""
from __future__ import annotations

import math

NOT_FINITE = 1e308


def finite(x: float) -> float:
    return x if math.isfinite(x) else NOT_FINITE


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}); every limit must be met."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(row["value"] <= row["limit"] for row in table.values()), table

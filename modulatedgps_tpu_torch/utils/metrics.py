"""Structured step metrics: JSONL and the console.

Mirrors modulatedgps_tpu/utils/metrics.py: the reference logs the ELBO to
stdout every few iterations (utils/training_utils.py:19-23); this logger
keeps that console contract and optionally appends one JSON object per
logged step.  Under torch.distributed only rank 0 prints and writes (the
JAX package's jax.process_index() == 0).
"""
from __future__ import annotations

import json
import time

import torch

__all__ = ["MetricsLogger"]


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class MetricsLogger:
    def __init__(self, path: str | None = None, verbose: bool = True):
        self.path = path
        self.verbose = verbose and _rank() == 0
        self._fh = None
        if path is not None and _rank() == 0:
            self._fh = open(path, "a")
        self._t0 = time.perf_counter()
        self._last_step = 0
        self._last_t = self._t0

    def log(self, step: int, **metrics) -> None:
        now = time.perf_counter()
        if step > self._last_step:
            metrics.setdefault(
                "steps_per_sec", (step - self._last_step) / max(now - self._last_t, 1e-9))
        self._last_step, self._last_t = step, now
        if self.verbose and "elbo" in metrics:
            print(f"{step:>5d}{metrics['elbo']:>24.6f}")
        if self._fh is not None:
            rec = {"step": step, "t": now - self._t0, **metrics}
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

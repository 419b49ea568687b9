"""Structured logging and masked-quantile debug dumps (JAX ``utils/logging.py``).

``RunLogger`` writes stdout, ``debug_log.txt`` and an optional JSON-lines
event stream in the JAX package's format, so debug logs of the two packages
diff cleanly.  ``array_stats`` is the host quantile dump (numpy);
``array_stats_device`` the same summary as a device tensor, over the port's
masked percentile and mean.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch


class RunLogger:
    """stdout + optional debug_log.txt + optional JSONL event stream."""

    def __init__(self, output_dir: Optional[str] = None, debug: bool = True,
                 to_file: bool = True, jsonl: bool = False):
        self.debug = debug
        self._fh = None
        self._jh = None
        if output_dir and debug and to_file:
            os.makedirs(output_dir, exist_ok=True)
            self._fh = open(os.path.join(output_dir, "debug_log.txt"), "w", encoding="utf-8")
            if jsonl:
                self._jh = open(os.path.join(output_dir, "events.jsonl"), "w", encoding="utf-8")

    def log(self, msg: str) -> None:
        if not self.debug:
            return
        print(msg)
        if self._fh:
            self._fh.write(str(msg) + "\n")
            self._fh.flush()

    def event(self, kind: str, **fields) -> None:
        if self._jh:
            self._jh.write(json.dumps({"t": time.time(), "kind": kind, **fields}) + "\n")
            self._jh.flush()

    def close(self) -> None:
        for h in (self._fh, self._jh):
            if h:
                h.close()
        self._fh = self._jh = None


def array_stats(name: str, arr, mask=None, logger: Optional[RunLogger] = None) -> str:
    """Masked quantile dump in the reference's format (host arrays)."""
    arr = np.asarray(arr)
    if mask is not None:
        vals = arr[np.asarray(mask)]
        where = " (masked)"
    else:
        vals = arr.ravel()
        where = ""
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        msg = f"[STATS] {name}{where}: EMPTY / no finite values"
    else:
        q = np.quantile(vals, [0.0, 0.01, 0.05, 0.5, 0.95, 0.99, 1.0])
        msg = (f"[STATS] {name}{where}: shape={arr.shape}, dtype={arr.dtype}, "
               f"min={q[0]:.6g}, p1={q[1]:.6g}, p5={q[2]:.6g}, "
               f"median={q[3]:.6g}, p95={q[4]:.6g}, p99={q[5]:.6g}, max={q[6]:.6g}, "
               f"mean={vals.mean():.6g}, std={vals.std():.6g}")
    if logger:
        logger.log(msg)
    else:
        print(msg)
    return msg


def array_stats_device(arr: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(9,) float32 tensor on ``arr``'s device, [min, p1, p5, median, p95,
    p99, max, mean, std] over the finite ``mask`` pixels, with no host
    copy."""
    from vistaf_torch.ops.percentile import masked_mean, masked_percentile

    x = arr.to(torch.float32)
    m = torch.ones_like(x, dtype=torch.bool) if mask is None else mask
    qs = masked_percentile(x, m, (0.0, 1.0, 5.0, 50.0, 95.0, 99.0, 100.0))
    mean = masked_mean(x, m)
    var = masked_mean((x - mean) ** 2, m)
    return torch.cat([qs, torch.stack([mean, torch.sqrt(var)])]).to(torch.float32)

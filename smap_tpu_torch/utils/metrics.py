"""Scalar metric logging (counterpart of ``smap_tpu/utils/metrics.py``):
one JSON line per record in ``metrics.jsonl``, mirrored to TensorBoard
when ``tensorboardX`` or ``torch.utils.tensorboard`` imports."""

from __future__ import annotations

import importlib
import json
import os
import time
from typing import Dict


class MetricWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        for mod in ("tensorboardX", "torch.utils.tensorboard"):
            try:
                self._tb = importlib.import_module(mod).SummaryWriter(log_dir)
                break
            except ImportError:
                continue

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), global_step=int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

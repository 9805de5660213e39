"""Devices of single-process data-parallel serving (counterpart of
``smap_tpu/parallel/mesh.py``).

A "mesh" here is a tuple of ``torch.device``s, one replica of the engine
on each (``SMAPInference(devices=...)``); a batch is split along its first
dimension into one contiguous shard a device. A device may appear more
than once: two replicas then share it.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from smap_tpu_torch.runtime import get_device

Device = Union[str, torch.device]


def make_mesh(devices: Optional[Sequence[Device]] = None
              ) -> Tuple[torch.device, ...]:
    """``devices`` as ``torch.device``s; every card of this host by
    default (raises on a host without one)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() takes every card, and torch.cuda "
                               "is not available")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(get_device(d) for d in devices)
    if not mesh:
        raise ValueError("an empty mesh")
    return mesh


def local_mesh(device: Device = "cuda") -> Tuple[torch.device, ...]:
    """The devices of ``--data-parallel``: every card of this host when
    ``device`` is a card, else ``device`` alone."""
    dev = get_device(device)
    return make_mesh() if dev.type == "cuda" else (dev,)


def _place(x: Any, device: torch.device) -> Any:
    """A tensor or array on ``device``: host arrays through pinned memory
    with a non-blocking copy when the device is a card."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.device == device:
        return x
    if device.type == "cuda" and x.device.type == "cpu":
        x = x.pin_memory()
    return x.to(device, non_blocking=True)


def shard_batch(x: Any, devices: Sequence[torch.device]) -> List[Any]:
    """``x`` split along its first dimension into ``len(devices)``
    contiguous equal shards, each placed on its device.

    ``x``: a tensor or a numpy array (each shard becomes a tensor on its
    device), a list (each shard a list, its items left where they are) or
    a tuple of these (a NamedTuple keeps its type). Raises when the batch
    does not divide by the device count."""
    n = len(devices)
    if isinstance(x, tuple):
        parts = [shard_batch(v, devices) for v in x]
        make = type(x)._make if hasattr(type(x), "_make") else tuple
        return [make(p[i] for p in parts) for i in range(n)]
    b = len(x)
    if b % n:
        raise ValueError(f"batch {b} not divisible by the {n}-device mesh")
    per = b // n
    shards = [x[i * per:(i + 1) * per] for i in range(n)]
    if isinstance(x, list):
        return shards
    return [_place(s, d) for s, d in zip(shards, devices)]

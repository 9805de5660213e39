"""Optimizer and learning-rate schedule (counterpart of
``smap_tpu/train/solver.py``): Adam with the L2 weight decay folded into the
gradient (``torch.optim.Adam(weight_decay=)``, as optax's
``add_decayed_weights`` then ``adam``), the learning rate scaled by the
device count, a linear warmup, then a linear decay to zero.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR

from smap_tpu_torch.config import TrainConfig


def make_schedule(cfg: TrainConfig, num_devices: int
                  ) -> Callable[[int], float]:
    """Learning rate of optimizer step ``step`` (counted from 0):
    ``warmup_factor`` -> 1 over ``warmup_iters``, then linear decay to 0 at
    ``max_iter`` (rescaled by the nominal 8-device schedule), times
    ``base_lr * num_devices``."""
    scale = cfg.nominal_devices / num_devices
    max_iter = int(cfg.max_iter * scale)
    warmup = cfg.warmup_iters
    base = cfg.base_lr * num_devices

    def schedule(step: int) -> float:
        if step < warmup:
            return base * (cfg.warmup_factor
                           + (1 - cfg.warmup_factor) * step / warmup)
        return base * (1 - (step - warmup) / (max_iter - warmup))

    return schedule


def make_optimizer(params: Iterable[torch.Tensor], cfg: TrainConfig,
                   num_devices: int) -> Tuple[torch.optim.Adam, LambdaLR]:
    """Adam (0.9, 0.999, 1e-8) with ``cfg.weight_decay`` folded into the
    gradient, and the scheduler that sets its learning rate.

    Call ``scheduler.step()`` after each ``optimizer.step()``: step ``k``
    then runs at ``schedule(k)``, as optax reads its schedule at the count
    before the update."""
    schedule = make_schedule(cfg, num_devices)
    base = cfg.base_lr * num_devices
    opt = torch.optim.Adam(params, lr=base, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=cfg.weight_decay)
    return opt, LambdaLR(opt, lambda step: schedule(step) / base)

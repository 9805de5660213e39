"""One training step: labels rendered on the device, forward, backward and
Adam (counterpart of ``smap_tpu/train/step.py``).

The model computes in ``ModelConfig.compute_dtype`` on float32 parameters,
BatchNorm normalising by the batch and moving its statistics as Flax's
does (``models.layers``). With ``accum_steps = A`` one step takes A
microbatches of the batch: each normalises by its own statistics, which
chain through the microbatches; the gradients are summed, divided by A and
applied in one optimizer step, and the losses are averaged.

In a process group (``parallel.distributed``, one rank a card) each rank
takes its share of the global batch: BatchNorm normalises by the global
batch's statistics and the root-depth loss divides by its global count
(``models.layers``, ``losses``), the gradients are averaged over the ranks
(one all-reduce of a flat bucket) before the optimizer step, and the
reported losses are the global batch's. Every rank starts from rank 0's
weights, so the ranks hold the same weights after every step, as the JAX
package's replicated parameters under SPMD. (DistributedDataParallel is
not used: its hooks all-reduce in every microbatch's backward unless each
but the last runs under ``no_sync``, remat's re-entrant checkpoints need
its ``static_graph``, and one all-reduce after the last microbatch is
all the step needs.)

Not ported, being TPU-runtime workarounds with no effect on the math: the
packed state (``PackedTrainState``), sharding and donation annotations and
scanned multi-step programs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple, Union

import numpy as np
import torch
from torch.optim.lr_scheduler import LambdaLR

from smap_tpu_torch.config import Config
from smap_tpu_torch.data.labels import synthesize_labels
from smap_tpu_torch.losses import smap_loss
from smap_tpu_torch.models.smap import SMAP
from smap_tpu_torch.parallel.distributed import (all_reduce_mean,
                                                 average_gradients,
                                                 broadcast_module,
                                                 process_count)
from smap_tpu_torch.runtime import compute_dtype
from smap_tpu_torch.train.solver import make_optimizer

Array = Union[np.ndarray, torch.Tensor]


class TrainBatch(NamedTuple):
    """One training batch, batch-leading, float32 (numpy or torch).

    images: ``[B, H, W, 3]`` normalized.
    bodys: ``[B, P, J, 11]`` unified joint rows (post-augmentation).
    valids: ``[B, 57]`` channel validity.
    scales: ``[B]`` letterbox resize scale.
    """

    images: Array
    bodys: Array
    valids: Array
    scales: Array


def batch_to(batch: TrainBatch, device: torch.device) -> TrainBatch:
    """``batch`` as float32 tensors on ``device``."""
    return TrainBatch(*(torch.as_tensor(x).to(device, torch.float32,
                                              non_blocking=True)
                        for x in batch))


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), the optimizer's
    moments, the schedule's position and the count of steps taken."""

    model: SMAP
    optimizer: torch.optim.Adam
    scheduler: LambdaLR
    step: int = 0


def training_model(model: SMAP, device: torch.device) -> SMAP:
    """``model`` on ``device`` in channels_last memory, in train mode,
    with float32 parameters and statistics, computing in its config's
    ``compute_dtype``."""
    model.compute_dtype = compute_dtype(model.cfg.compute_dtype)
    model.to(device=device, dtype=torch.float32,
             memory_format=torch.channels_last)
    return model.train()


def create_train_state(model: SMAP, cfg: Config,
                       num_devices: int = 1) -> TrainState:
    """The optimizer and schedule for ``num_devices`` devices on
    ``model``; in a process group, rank 0's weights and statistics copied
    into every rank's model first."""
    broadcast_module(model)
    optimizer, scheduler = make_optimizer(model.parameters(), cfg.train,
                                          num_devices)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler)


def render_labels(batch: TrainBatch, *, cfg: Config
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Labels ``[B, 5, H, W, 57]`` and root-depth rows
    ``[B, max_people, 3]`` of a batch, on the batch's device."""
    t = cfg.train
    return synthesize_labels(
        batch.bodys, batch.scales, cfg.output_shape, cfg.stride,
        [k[0] for k in t.gaussian_kernels], t.paf_line_width, t.with_mds,
        t.max_people)


def train_step_with_labels(state: TrainState, batch: TrainBatch,
                           labels: torch.Tensor, rdepth: torch.Tensor, *,
                           cfg: Config, accum_steps: int = 1
                           ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Forward, backward and Adam on a batch with rendered labels, over
    ``accum_steps`` microbatches of it. Updates ``state`` in place and
    returns it with the losses (0-dim tensors on the device, detached)."""
    bs = batch.images.shape[0]
    if bs % accum_steps:
        raise ValueError(f"batch {bs} not divisible by "
                         f"accum_steps={accum_steps}")
    model = state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    micro = bs // accum_steps
    sums: Dict[str, torch.Tensor] = {}
    for a in range(accum_steps):
        part = slice(a * micro, (a + 1) * micro)
        outputs = model(batch.images[part])
        losses = smap_loss(outputs, batch.valids[part], labels[part],
                           rdepth[part], cfg.train)
        losses["total_loss"].backward()     # sums into .grad
        for k, v in losses.items():
            sums[k] = sums[k] + v.detach() if k in sums else v.detach()
    if accum_steps > 1:
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(accum_steps)
        sums = {k: v / accum_steps for k, v in sums.items()}
    average_gradients(model.parameters())
    if process_count() > 1:
        names = list(sums)
        means = all_reduce_mean(torch.stack([sums[k] for k in names]))
        sums = dict(zip(names, means.unbind()))
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return state, sums


def train_step(state: TrainState, batch: TrainBatch, *, cfg: Config,
               accum_steps: int = 1
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step on one batch (moved to the model's device),
    over ``accum_steps`` microbatches of it."""
    batch = batch_to(batch, next(state.model.parameters()).device)
    labels, rdepth = render_labels(batch, cfg=cfg)
    return train_step_with_labels(state, batch, labels, rdepth, cfg=cfg,
                                  accum_steps=accum_steps)

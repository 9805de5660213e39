"""RefineNet training and model selection (counterpart of
``smap_tpu/train/refine.py``): Adam at ``base_lr`` halved every
``lr_step`` epochs (the epoch computed from the step), batches of
``batch_size`` pairs in an order drawn from ``np.random.RandomState(seed)``
each epoch, MSE on the 45-dim root-relative pose; the epoch kept is the one
with the least mean per-joint L2 error.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch.optim.lr_scheduler import LambdaLR

from smap_tpu_torch.config import RefineNetConfig
from smap_tpu_torch.data.datasets import P2PDataset
from smap_tpu_torch.models.refinenet import RefineNet
from smap_tpu_torch.runtime import get_device


@dataclasses.dataclass
class RefineState:
    model: RefineNet
    optimizer: torch.optim.Adam
    scheduler: LambdaLR
    step: int = 0


def make_refine_optimizer(params: Iterable[torch.Tensor],
                          cfg: RefineNetConfig, steps_per_epoch: int
                          ) -> Tuple[torch.optim.Adam, LambdaLR]:
    """Adam, and a scheduler multiplying its rate by ``lr_gamma`` every
    ``lr_step`` epochs of ``steps_per_epoch`` steps (call
    ``scheduler.step()`` after each ``optimizer.step()``)."""
    per_epoch = max(steps_per_epoch, 1)
    opt = torch.optim.Adam(params, lr=cfg.base_lr, betas=(0.9, 0.999),
                           eps=1e-8)
    return opt, LambdaLR(opt, lambda step: cfg.lr_gamma ** (
        step // per_epoch // cfg.lr_step))


def create_refine_state(cfg: RefineNetConfig, steps_per_epoch: int,
                        model: RefineNet) -> RefineState:
    optimizer, scheduler = make_refine_optimizer(model.parameters(), cfg,
                                                 steps_per_epoch)
    return RefineState(model=model.train(), optimizer=optimizer,
                       scheduler=scheduler)


def refine_train_step(state: RefineState, inputs: torch.Tensor,
                      targets: torch.Tensor
                      ) -> Tuple[RefineState, torch.Tensor]:
    """One Adam step on the MSE of a batch; updates ``state`` in place and
    returns it with the loss (a 0-dim device tensor)."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss = torch.mean((state.model(inputs) - targets) ** 2)
    loss.backward()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return state, loss.detach()


def pair_arrays(dataset: P2PDataset) -> Tuple[np.ndarray, np.ndarray]:
    """(inputs [N, 75], targets [N, 45]) of every pair."""
    samples = [dataset.get_sample(i) for i in range(len(dataset))]
    return (np.stack([s[0] for s in samples]),
            np.stack([s[1] for s in samples]))


def train_refinenet(dataset: P2PDataset, cfg: RefineNetConfig,
                    num_epochs: Optional[int] = None, seed: int = 0,
                    log_fn: Callable[[str], None] = print, device="cuda",
                    model: Optional[RefineNet] = None
                    ) -> Dict[int, RefineNet]:
    """The epoch loop on ``device`` (``"cuda"`` unless the caller asks for
    the CPU). Starts from ``model``, or from a RefineNet initialised from
    ``seed``; returns ``{epoch: a copy of the model after it}`` in eval
    mode, for :func:`select_best_epoch`."""
    dev = get_device(device)
    inputs, targets = pair_arrays(dataset)
    n = len(inputs)
    inputs = torch.from_numpy(inputs).to(dev)
    targets = torch.from_numpy(targets).to(dev)
    steps_per_epoch = max(n // cfg.batch_size, 1)
    if model is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = RefineNet(cfg)
    state = create_refine_state(cfg, steps_per_epoch, model.to(dev))

    rng = np.random.RandomState(seed)
    snapshots = {}
    for epoch in range(num_epochs or cfg.num_epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        losses = []
        for s in range(steps_per_epoch):
            idx = order[s * cfg.batch_size:(s + 1) * cfg.batch_size]
            state, loss = refine_train_step(state, inputs[idx], targets[idx])
            losses.append(loss)
        mse = torch.stack(losses).double().mean().item()
        log_fn(f"refine epoch {epoch}: mse {mse:.5f}")
        state.optimizer.zero_grad(set_to_none=True)   # not in the copy
        snapshots[epoch] = copy.deepcopy(state.model).eval()
    return snapshots


def evaluate_refinenet(model: RefineNet, dataset: P2PDataset
                       ) -> Tuple[np.ndarray, float]:
    """Per-joint mean L2 error (cm) over the dataset, and its mean."""
    inputs, targets = pair_arrays(dataset)
    n = len(inputs)
    dev = next(model.parameters()).device
    with torch.no_grad():
        preds = model.eval()(torch.from_numpy(inputs).to(dev))
    preds = preds.cpu().numpy().reshape(n, 15, 3)
    per_joint = np.linalg.norm(preds - targets.reshape(n, 15, 3),
                               axis=-1).mean(axis=0)
    return per_joint, float(per_joint.mean())


def select_best_epoch(snapshots: Dict[int, RefineNet], dataset: P2PDataset
                      ) -> Tuple[int, float]:
    """``(best_epoch, best_error)`` over the snapshots."""
    best_epoch, best_err = -1, float("inf")
    for epoch, model in snapshots.items():
        _, err = evaluate_refinenet(model, dataset)
        if err < best_err:
            best_epoch, best_err = epoch, err
    return best_epoch, best_err

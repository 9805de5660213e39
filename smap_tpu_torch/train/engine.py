"""Training loop, checkpoints and metrics (counterpart of
``smap_tpu/train/engine.py``).

``Trainer.fit`` runs one optimizer step per batch of an iterator of
``(iteration, TrainBatch)`` pairs, logs the losses every ``log_every``
steps (a log line and a ``metrics.jsonl`` record; the only host read of
the losses) and checkpoints every ``checkpoint_period`` steps (rescaled
as the schedule is) and at ``max_iter``; ``profile_dir`` traces a window
of steps (``utils.profiling.StepWindowProfiler``). A checkpoint holds the
model's state_dict, the optimizer's state, the schedule's position and
the step, written with ``torch.save``; a restored state continues at the
exact iteration.

In a process group (``parallel.distributed``) each rank trains on its
share of the global batch (``train.step``): the device count that scales
the learning rate and the schedule is the world size, every rank
restores, and rank 0 alone writes checkpoints, ``metrics.jsonl`` and
``log.txt`` (the other ranks log warnings only, to the console).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from smap_tpu_torch.config import Config
from smap_tpu_torch.models.smap import init_smap
from smap_tpu_torch.parallel.distributed import (is_main_process,
                                                 process_count,
                                                 process_index)
from smap_tpu_torch.runtime import get_device
from smap_tpu_torch.train.step import (TrainBatch, TrainState,
                                       create_train_state, train_step,
                                       training_model)
from smap_tpu_torch.utils.metrics import MetricWriter
from smap_tpu_torch.utils.profiling import StepWindowProfiler

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "smap_tpu_torch",
               log_file: Optional[str] = None,
               rank: int = 0) -> logging.Logger:
    """A logger printing INFO and above, and writing them to ``log_file``
    too (its directory is made); handlers are added once per name. A rank
    other than 0 prints warnings and above only, and writes no file."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
        logger.propagate = False
        handlers: List[logging.Handler] = [logging.StreamHandler()]
        if log_file and rank == 0:
            os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
            handlers.append(logging.FileHandler(log_file))
        for h in handlers:
            h.setFormatter(logging.Formatter(_FORMAT))
            logger.addHandler(h)
    return logger


class CheckpointManager:
    """``<directory>/<step>.pt`` files, the newest ``max_to_keep`` kept."""

    def __init__(self, directory: str, max_to_keep: int = 10):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(f[:-3]) for f in os.listdir(self.directory)
                      if f.endswith(".pt") and f[:-3].isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        """Writes ``state`` as step ``step`` (through a temporary file, so a
        crash leaves no partial checkpoint) and drops the oldest beyond
        ``max_to_keep``."""
        tmp = self._path(step) + ".tmp"
        torch.save({"step": state.step,
                    "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "scheduler": state.scheduler.state_dict()}, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def model_state_dict(self, step: Optional[int] = None
                         ) -> Dict[str, torch.Tensor]:
        """The model's state_dict of checkpoint ``step`` (the latest by
        default), on the CPU; raises FileNotFoundError with none."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)["model"]

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> TrainState:
        """Loads checkpoint ``step`` (the latest by default) into ``state``
        in place and returns it; with no checkpoint, ``state`` as it is."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state
        device = next(state.model.parameters()).device
        ckpt = torch.load(self._path(step), map_location=device,
                          weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.scheduler.load_state_dict(ckpt["scheduler"])
        state.step = int(ckpt["step"])
        return state


@dataclasses.dataclass
class TrainerConfig:
    output_dir: str = "model_logs/smap_tpu_torch"
    log_every: int = 20
    seed: int = 0
    # > 1: each batch is split into this many microbatches whose
    # gradients are averaged into one optimizer step (train.step.train_step).
    grad_accum_steps: int = 1
    # When set, trace the steps profile_first_step + 1 .. profile_first_step
    # + profile_num_steps into this directory (utils.profiling).
    profile_dir: str = ""
    profile_first_step: int = 10
    profile_num_steps: int = 5


class Trainer:
    """SMAP trainer on one device (``"cuda"`` unless the caller asks for
    the CPU; no card raises), one rank of the process group when there is
    one."""

    def __init__(self, cfg: Config, trainer_cfg: TrainerConfig = TrainerConfig(),
                 device="cuda"):
        self.cfg = cfg
        self.tc = trainer_cfg
        self.device = get_device(device)
        self.num_devices = process_count()
        self.is_main = is_main_process()
        out = trainer_cfg.output_dir
        self.logger = get_logger(f"smap_tpu_torch.train:{os.path.abspath(out)}",
                                 log_file=os.path.join(out, "log.txt"),
                                 rank=process_index())
        self.ckpt = CheckpointManager(os.path.join(out, "checkpoints"))
        self.metrics = (MetricWriter(os.path.join(out, "tb_dir"))
                        if self.is_main else None)

    def init_state(self, rng_seed: int = 0) -> TrainState:
        """A fresh state: ``init_smap(seed)`` in train mode on the device."""
        model = training_model(init_smap(self.cfg.model, rng_seed),
                               self.device)
        return create_train_state(model, self.cfg, self.num_devices)

    def scaled_max_iter(self) -> int:
        t = self.cfg.train
        return int(t.max_iter * t.nominal_devices / self.num_devices)

    def scaled_checkpoint_period(self) -> int:
        t = self.cfg.train
        return int(t.checkpoint_period * t.nominal_devices / self.num_devices)

    def fit(self, batch_iter: Iterator[Tuple[int, TrainBatch]],
            state: Optional[TrainState] = None, resume: bool = False,
            max_steps: Optional[int] = None) -> TrainState:
        """Trains on ``(iteration, batch)`` pairs until ``max_iter``
        (``max_steps`` when given) or the iterator's end. An iterator that
        ends before ``max_iter`` leaves no checkpoint beyond the last
        periodic one."""
        if state is None:
            state = self.init_state(self.tc.seed)
        if resume:
            state = self.ckpt.restore(state)
            self.logger.info("resumed at iteration %d", state.step)
        max_iter = max_steps or self.scaled_max_iter()
        ckpt_period = self.scaled_checkpoint_period()
        profiler = StepWindowProfiler(self.tc.profile_dir,
                                      self.tc.profile_first_step,
                                      self.tc.profile_num_steps)
        t0 = time.time()
        last_logged = None
        try:
            for iteration, batch in batch_iter:
                it = iteration + 1
                state, losses = train_step(
                    state, batch, cfg=self.cfg,
                    accum_steps=self.tc.grad_accum_steps)
                profiler.step(it)
                if self.is_main and (it % self.tc.log_every == 0
                                     or it == max_iter):
                    values = {k: float(v) for k, v in losses.items()}
                    self.metrics.write_scalars(it, values)
                    dt = time.time() - t0
                    t0 = time.time()
                    done = it - last_logged if last_logged else it
                    last_logged = it
                    eta_s = int(dt / max(done, 1) * (max_iter - it))
                    self.logger.info(
                        "Iter:%d, %s, ETA %dh%02dm", it,
                        ", ".join(f"{k}: {v:.3f}" for k, v in values.items()),
                        eta_s // 3600, eta_s % 3600 // 60)
                if self.is_main and (it % ckpt_period == 0 or it == max_iter):
                    self.ckpt.save(it, state)
                    self.logger.info("checkpoint saved at iteration %d", it)
                if it >= max_iter:
                    break
        finally:
            profiler.close()
        return state

    def close(self) -> None:
        """Closes the metrics file and the log file."""
        if self.metrics is not None:
            self.metrics.close()
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)

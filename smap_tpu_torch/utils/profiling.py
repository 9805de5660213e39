"""Traces of a region or of a training step window on ``torch.profiler``
(counterpart of ``smap_tpu/utils/profiling.py``).

``trace(log_dir)`` records the host's activity, and the card's when there
is one (CUPTI: every kernel by its own symbol, the port's CUDA kernels
A-E included), and writes a Chrome trace, ``*.pt.trace.json``, under
``log_dir`` when the region ends: open it in Perfetto
(ui.perfetto.dev), ``chrome://tracing`` or TensorBoard's PyTorch profiler
plugin. In a process group each rank writes its own file
(``<host>_<pid>_rank<r>.<ns>.pt.trace.json``).

``annotate(name)`` is a named span on that timeline
(``torch.profiler.record_function``), taken only while a profiler runs.
Under ``nsys``, run the region inside
``torch.autograd.profiler.emit_nvtx()``: the spans become NVTX ranges.
The wrappers of kernels A-E in ``ops/kernels.py`` launch inside a span
named after their kernel.

``StepWindowProfiler`` bounds a training trace to a window of steps:
``Trainer.fit`` (``TrainerConfig.profile_dir``) and ``train_smap
--profile-dir``. ``test_smap --profile-dir`` traces its whole inference.

    from smap_tpu_torch.utils.profiling import trace
    with trace("/tmp/prof"):
        state, losses = train_step(state, batch, cfg=cfg)
"""

from __future__ import annotations

import contextlib
import functools
import os
import socket
from typing import Iterator, Optional

import torch


@functools.lru_cache(maxsize=None)
def _cuda() -> bool:
    return torch.cuda.is_available()


def _worker_name() -> str:
    name = f"{socket.gethostname()}_{os.getpid()}"
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        name += f"_rank{torch.distributed.get_rank()}"
    return name


def _profiler(log_dir: str) -> torch.profiler.profile:
    """A profiler of the host, and of the card when there is one, that
    writes its Chrome trace under ``log_dir`` when it stops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if _cuda():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(
            log_dir, worker_name=_worker_name()))


def _stop(prof: torch.profiler.profile) -> None:
    """Stops ``prof`` once the card has run what was queued under it, so
    that the trace holds the region's kernels."""
    if _cuda():
        torch.cuda.synchronize()
    prof.stop()


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Traces the block into ``log_dir`` (no-op when falsy)."""
    if not log_dir:
        yield
        return
    prof = _profiler(log_dir)
    prof.start()
    try:
        yield
    finally:
        _stop(prof)


class annotate:
    """A named span while a profiler runs (``trace``, or ``emit_nvtx``,
    where it is an NVTX range); skipped otherwise: ``record_function``
    alone costs microseconds a call, and kernel E's wrapper runs 206 times
    a forward."""

    __slots__ = ("name", "_span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self._span = (torch.profiler.record_function(self.name)
                      if torch.autograd._profiler_enabled() else None)
        if self._span is not None:
            self._span.__enter__()

    def __exit__(self, *exc) -> None:
        if self._span is not None:
            self._span.__exit__(*exc)


class StepWindowProfiler:
    """Traces the steps ``first_step + 1`` .. ``first_step + num_steps``
    of a training loop: starts after the step that reaches ``first_step``
    and stops after the one that reaches ``first_step + num_steps``, as
    the JAX package's class does. Inert when ``log_dir`` is falsy or the
    window is empty."""

    def __init__(self, log_dir: Optional[str], first_step: int = 10,
                 num_steps: int = 5):
        # A zero-width window is inert (else the start at it == first_step
        # would trace one step anyway).
        self.log_dir = log_dir if num_steps > 0 else None
        self.first = first_step
        self.last = first_step + num_steps
        self._prof: Optional[torch.profiler.profile] = None

    def step(self, it: int, window: int = 1) -> None:
        """Advances to iteration ``it``, the end of a window of ``window``
        steps: the trace starts when ``first_step`` falls anywhere in
        ``(it - window, it]``."""
        if not self.log_dir:
            return
        if it - window < self.first <= it and self._prof is None:
            self._prof = _profiler(self.log_dir)
            self._prof.start()
        elif it >= self.last and self._prof is not None:
            self.close()

    def close(self) -> None:
        """Stops a running trace and writes it."""
        if self._prof is not None:
            prof, self._prof = self._prof, None
            _stop(prof)

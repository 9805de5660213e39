"""Device, dtype and TF32 settings of the port.

Every entry point takes its device explicitly. Asking for CUDA on a host
without a card raises: no path of the port falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Dict, Iterator, Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def get_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and
    there is no card. A CUDA device without an index gets the current one
    (``"cuda"`` -> ``cuda:0``), so that it compares equal to the device of
    the tensors placed on it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but torch.cuda is "
                               f"not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def compute_dtype(name: str) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` (``ModelConfig.compute_dtype``)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown compute dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


def set_tf32(enabled: bool) -> Dict[str, bool]:
    """Set TF32 for cuDNN convolutions and CUDA matmuls, and return the
    settings now in force.

    PyTorch runs float32 convolutions through cuDNN in TF32 by default
    (about three decimal digits); parity runs turn it off so that a float32
    forward is float32.
    """
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block,
    restored after it: the plain versions of the kernels compute their
    float32 sums in float32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    set_tf32(False)
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True) -> Iterator[None]:
    """PyTorch's deterministic algorithms, and cuDNN's, inside the block
    when ``on`` (an op with none warns), restored after it: a training run
    then repeats bit for bit, where the card's default backward sums some
    gradients with atomics in a run-dependent order."""
    if not on:
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A small constant tensor, copied to ``device`` once per process and
    shared by every caller, so that a serving loop makes no host-to-device
    copy for it. Callers must not write to it."""
    return torch.tensor(values, dtype=dtype, device=device)


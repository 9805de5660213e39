"""Device, dtype and TF32 settings of the port.

Every entry point takes its device explicitly. Asking for CUDA on a host
without a card raises: no path of the port falls back to the CPU.
"""

from __future__ import annotations

import functools
from typing import Dict, Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def get_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and
    there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda is not "
                           f"available")
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


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A small constant tensor, copied to ``device`` once per process and
    shared by every caller, so that a serving loop makes no host-to-device
    copy for it. Callers must not write to it."""
    return torch.tensor(values, dtype=dtype, device=device)


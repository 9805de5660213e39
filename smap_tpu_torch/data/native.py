"""The native host preprocessing library (counterpart of
``smap_tpu/data/native.py``): one-pass normalize, and letterbox +
normalize, in C++ through ``ctypes``.

``smap_tpu_torch/csrc/preprocess.cc`` is compiled with ``g++ -O3
-march=native -shared -fPIC`` (the JAX package's flags) at first use into
the git-ignored ``smap_tpu_torch/_build/``. The file name carries a hash
of the source, the flags and the host's CPU: an edit rebuilds, and a
checkout shared by two hosts builds one library each (``-march=native``
may use instructions the other lacks). The JAX package's own
``native/libsmap_preprocess.so`` is never touched. On a host with no
compiler each function falls back to its numpy version
(``data.preprocess``), with a warning logged once: this is host code, not
a kernel of the card.

The train sample (``JointDataset.get_train_sample``) normalizes through
``normalize_native``, as the JAX package's does; built from the same
source with the same flags on the same host, the two libraries give the
same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from smap_tpu_torch.camera import default_scale_dict
from smap_tpu_torch.config import INPUT_SHAPE, PIXEL_MEANS_BGR, PIXEL_STDS_BGR
from smap_tpu_torch.data.preprocess import letterbox_image, normalize_image

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "preprocess.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_log = logging.getLogger(__name__)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _host_cpu() -> str:
    """The CPU that ``-march=native`` targets: its architecture, and its
    model and feature flags where ``/proc/cpuinfo`` gives them."""
    lines = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.partition(":")[0].strip()
                if key in ("model name", "flags", "Features") \
                        and line not in lines:
                    lines.append(line)
                if not line.strip() and lines:
                    break       # the first processor's block is enough
    except OSError:
        pass
    return "".join([platform.machine(), platform.processor(), *lines])


def library_path() -> Path:
    """Where the library for the current source, flags and host CPU is
    built."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"libsmap_preprocess-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles the library unless already built; returns its path. Raises
    OSError without ``g++``, CalledProcessError when it fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, out)    # atomic: workers may build at once
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.CalledProcessError) as e:
            _failed = True
            stderr = getattr(e, "stderr", None)
            _log.warning("native preprocessing library unavailable, using "
                         "the numpy path: %s%s", e,
                         f"\n{stderr.decode(errors='replace')}"
                         if stderr else "")
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        fp = ctypes.POINTER(ctypes.c_float)
        i = ctypes.c_int
        lib.letterbox_normalize.argtypes = [u8p, i, i, fp, i, i, fp, fp]
        lib.letterbox_normalize.restype = None
        lib.normalize_u8.argtypes = [u8p, i, i, fp, fp, fp]
        lib.normalize_u8.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the library built (or was built before) and loaded."""
    return _load() is not None


def _bgr_u8(img: np.ndarray) -> np.ndarray:
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"expected a [H, W, 3] uint8 image, got "
                         f"{img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


_MEAN = np.asarray(PIXEL_MEANS_BGR, np.float32)
_STD = np.asarray(PIXEL_STDS_BGR, np.float32)


def normalize_native(img_bgr_u8: np.ndarray) -> np.ndarray:
    """uint8 BGR ``[H, W, 3]`` -> normalized float32, in one pass
    (``data.preprocess.normalize_image`` without the library)."""
    lib = _load()
    if lib is None:
        return normalize_image(img_bgr_u8)
    src = _bgr_u8(img_bgr_u8)
    h, w = src.shape[:2]
    out = np.empty((h, w, 3), np.float32)
    lib.normalize_u8(_u8ptr(src), h, w, _fptr(out), _fptr(_MEAN),
                     _fptr(_STD))
    return out


def letterbox_normalize_native(img_bgr: np.ndarray,
                               net_hw: Tuple[int, int] = INPUT_SHAPE
                               ) -> Tuple[np.ndarray, Dict[str, float]]:
    """Letterbox + normalize in one pass: ``data.preprocess.
    letterbox_image`` then ``normalize_image`` (the library samples in
    float where OpenCV's resize rounds in fixed point: a few grey levels
    apart on a few pixels). Returns (float32 ``[net_h, net_w, 3]``, the
    scale dict)."""
    lib = _load()
    net_h, net_w = net_hw
    img_h, img_w = img_bgr.shape[:2]
    if lib is None:
        boxed, scale = letterbox_image(img_bgr, net_hw)
        return normalize_image(boxed), scale
    src = _bgr_u8(img_bgr)
    out = np.empty((net_h, net_w, 3), np.float32)
    lib.letterbox_normalize(_u8ptr(src), img_h, img_w, _fptr(out), net_h,
                            net_w, _fptr(_MEAN), _fptr(_STD))
    return out, default_scale_dict(img_w, img_h, net_w, net_h)

"""The port's native host libraries, in C++ through ``ctypes``, each built
from one source of ``smap_tpu_torch/csrc/`` with its own flags:

* ``preprocess`` (``preprocess.cc``, counterpart of
  ``smap_tpu/data/native.py``): one-pass normalize, and letterbox +
  normalize. Built with the JAX package's flags, ``g++ -O3 -march=native
  -shared -fPIC``: from the same source with the same flags on the same
  host, the two libraries give the same bits.
* ``image`` (``image.cc``): ``resize_linear``, ``warp_affine`` and PNG
  unfiltering, each bit-equal to its numpy version in ``data.image``;
  ``-ffp-contract=off`` keeps every float32 product and sum rounded on its
  own, as numpy rounds them.
* ``jpeg`` (``jpeg.cc``): the JPEG decoder behind ``data.image.imread``.

Each library is compiled at first use into the git-ignored
``smap_tpu_torch/_build/``; its file name carries a hash of the source,
the flags and the host's CPU: an edit rebuilds, and a checkout shared by
two hosts builds one library each (``-march=native`` may use instructions
the other lacks). The JAX package's own ``native/libsmap_preprocess.so``
is never touched. On a host with no compiler, ``preprocess`` and ``image``
fall back to their numpy versions with one warning each: this is host
code, not a kernel of the card. JPEG has no numpy version: there
``data.image.imread`` of a JPEG raises with the build's error.

The train sample (``JointDataset.get_train_sample``) normalizes through
``normalize_native``, as the JAX package's does.
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

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
# name -> (source, g++ flags).
LIBRARIES = {
    "preprocess": (_PKG / "csrc" / "preprocess.cc", CXX_FLAGS),
    "image": (_PKG / "csrc" / "image.cc", CXX_FLAGS + ("-ffp-contract=off",)),
    "jpeg": (_PKG / "csrc" / "jpeg.cc", CXX_FLAGS),
}

_log = logging.getLogger(__name__)
_locks = {name: threading.Lock() for name in LIBRARIES}
_libs: Dict[str, ctypes.CDLL] = {}
_errors: Dict[str, str] = {}


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


def library_path(name: str = "preprocess") -> Path:
    """Where library ``name`` is built for its current source, flags and
    the host CPU."""
    source, flags = LIBRARIES[name]
    h = hashlib.sha1(" ".join(flags).encode())
    h.update(source.read_bytes())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"libsmap_{name}-{h.hexdigest()[:16]}.so"


def build(name: str = "preprocess") -> Path:
    """Compiles library ``name`` unless already built; returns its path.
    Raises OSError without ``g++``, CalledProcessError when it fails."""
    out = library_path(name)
    if out.exists():
        return out
    source, flags = LIBRARIES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        f".tmp")
    try:
        subprocess.run(["g++", *flags, "-o", str(tmp), str(source)],
                       check=True, capture_output=True)
        os.replace(tmp, out)    # atomic: workers may build at once
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _declare(name: str, lib: ctypes.CDLL) -> None:
    """The C signatures of library ``name``."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    i, d, sz = ctypes.c_int, ctypes.c_double, ctypes.c_size_t
    if name == "preprocess":
        lib.letterbox_normalize.argtypes = [u8p, i, i, fp, i, i, fp, fp]
        lib.letterbox_normalize.restype = None
        lib.normalize_u8.argtypes = [u8p, i, i, fp, fp, fp]
        lib.normalize_u8.restype = None
    elif name == "image":
        lib.resize_linear_u8.argtypes = [u8p, i, i, i, u8p, i, i, d, d]
        lib.resize_linear_u8.restype = None
        lib.half_by_area_u8.argtypes = [u8p, i, i, i, u8p, i, i]
        lib.half_by_area_u8.restype = None
        lib.warp_affine_u8.argtypes = [u8p, i, i, i, u8p, i, i, fp, i, i]
        lib.warp_affine_u8.restype = None
        lib.png_unfilter.argtypes = [u8p, i, i, i, u8p]
        lib.png_unfilter.restype = ctypes.c_int
    else:
        lib.jpeg_decode.argtypes = [ctypes.c_char_p, sz, u8p, sz, ip, ip,
                                    ip, ctypes.c_char_p, sz]
        lib.jpeg_decode.restype = ctypes.c_int


def load(name: str = "preprocess") -> Optional[ctypes.CDLL]:
    """Library ``name``, built and loaded at the first call; None where it
    cannot be built (one warning, the error kept for ``build_error``)."""
    with _locks[name]:
        if name in _libs or name in _errors:
            return _libs.get(name)
        try:
            lib = ctypes.CDLL(str(build(name)))
        except (OSError, subprocess.CalledProcessError) as e:
            stderr = getattr(e, "stderr", None)
            _errors[name] = f"{e}" + (f"\n{stderr.decode(errors='replace')}"
                                      if stderr else "")
            _log.warning("native %s library unavailable, %s: %s", name,
                         "reading JPEG raises" if name == "jpeg"
                         else "using the numpy path", _errors[name])
            return None
        _declare(name, lib)
        _libs[name] = lib
        return lib


def build_error(name: str) -> Optional[str]:
    """Why library ``name`` did not build, once ``load`` has failed."""
    return _errors.get(name)


def native_available(name: str = "preprocess") -> bool:
    """True when library ``name`` built (or was built before) and
    loaded."""
    return load(name) is not None


def _bgr_u8(img: np.ndarray) -> np.ndarray:
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"expected a [H, W, 3] uint8 image, got "
                         f"{img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def u8ptr(a: np.ndarray):
    """``a``'s data as a ``uint8_t *``."""
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


_MEAN = np.asarray(PIXEL_MEANS_BGR, np.float32)
_STD = np.asarray(PIXEL_STDS_BGR, np.float32)


def normalize_native(img_bgr_u8: np.ndarray) -> np.ndarray:
    """uint8 BGR ``[H, W, 3]`` -> normalized float32, in one pass
    (``data.preprocess.normalize_image`` without the library)."""
    lib = load()
    if lib is None:
        from smap_tpu_torch.data.preprocess import normalize_image
        return normalize_image(img_bgr_u8)
    src = _bgr_u8(img_bgr_u8)
    h, w = src.shape[:2]
    out = np.empty((h, w, 3), np.float32)
    lib.normalize_u8(u8ptr(src), h, w, _fptr(out), _fptr(_MEAN),
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
    lib = load()
    net_h, net_w = net_hw
    img_h, img_w = img_bgr.shape[:2]
    if lib is None:
        from smap_tpu_torch.data.preprocess import (letterbox_image,
                                                    normalize_image)
        boxed, scale = letterbox_image(img_bgr, net_hw)
        return normalize_image(boxed), scale
    src = _bgr_u8(img_bgr)
    out = np.empty((net_h, net_w, 3), np.float32)
    lib.letterbox_normalize(u8ptr(src), img_h, img_w, _fptr(out), net_h,
                            net_w, _fptr(_MEAN), _fptr(_STD))
    return out, default_scale_dict(img_w, img_h, net_w, net_h)

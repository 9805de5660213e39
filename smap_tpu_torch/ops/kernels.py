"""The port's hand-written CUDA kernels: build, bindings and launch counts.

``smap_tpu_torch/csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, at first use, into
``smap_tpu_torch/_build/`` (git-ignored; the file name carries a hash of the
sources and flags, so an edit rebuilds). The library is loaded with
``ctypes``. Each C entry point launches on PyTorch's current stream and
returns ``cudaGetLastError()``; the wrappers here raise if it is not 0.

The wrappers take CUDA tensors only and raise on anything else: the plain
PyTorch versions live beside their callers (``ops/paf.py``,
``ops/association.py``, ``ops/fused_stem.py``, ``ops/fused_block.py``),
which choose by device. ``LAUNCHES`` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("paf_score.cu", "associate_limb.cu", "fused_stem.cu",
           "fused_bottleneck.cu")
# -fmad=false: the PAF kernel must round each product and sum as the plain
# version does (a contracted FMA moves sample points across .5 boundaries
# and samples across the threshold). No fast math: sqrtf and / stay IEEE.
# The stem kernel's multiply-adds are explicit __fmaf_rn calls, which the
# flag leaves alone; the bottleneck kernel multiplies on the tensor cores.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false")

# Largest peak capacity the association kernel takes: one thread per dst
# peak in a 128-thread block.
MAX_ASSOC_PEAKS = 128

# The stem kernel's output channels (a compile-time constant of the kernel).
STEM_COUT = 64

LAUNCHES: Dict[str, int] = {"paf_score": 0, "associate_limb": 0,
                            "fused_stem": 0, "fused_bottleneck": 0}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
                  shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path() -> Path:
    """Where the library for the current sources and flags is built."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libsmap_kernels-{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile the kernels unless already built; returns (library path,
    the compiler's ``-Xptxas -v`` report, or "" when it was built
    before)."""
    out = _library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    # One nvcc per source, all at once, then one link.
    objs = [out.with_name(f"{out.stem}.{Path(s).stem}.{os.getpid()}.o")
            for s in SOURCES]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-Xptxas", "-v", "-o", str(o),
             str(CSRC_DIR / s)] for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    report = ""
    failed = []
    for cmd, proc in zip(cmds, procs):
        text = proc.communicate()[0]
        report += text
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text}")
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)   # atomic: no process loads a half-written file
    return out, report


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.paf_score_launch.argtypes = [P, P, P, P, P, I, I, I, I, I, I,
                                             I, F, F, F, F, P]
            lib.paf_score_launch.restype = I
            lib.associate_limb_launch.argtypes = [P, P, P, I, I, P]
            lib.associate_limb_launch.restype = I
            lib.fused_stem_launch.argtypes = [P, P, P, P, I, I, I, I, P]
            lib.fused_stem_launch.restype = I
            lib.fused_bottleneck_launch.argtypes = [P] * 10 + [I] * 6 + [P]
            lib.fused_bottleneck_launch.restype = I
            _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device,
           align: int = 1) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: expected a {align}-byte aligned tensor")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def paf_score(pafs: torch.Tensor, xy: torch.Tensor, count: torch.Tensor,
              limb_pairs: torch.Tensor, *, inter_threshold: float,
              inter_min_above: float, default_threshold: float,
              num_samples: int) -> torch.Tensor:
    """``paf_score_kernel``: the [B, L, K, K] score table in one launch.

    pafs [B, 2L, H, W] f32; xy [B, J, K, 2] f32; count [B, J] int32;
    limb_pairs [L, 2] int32; all contiguous on one CUDA device.
    """
    if pafs.ndim != 4 or xy.ndim != 4:
        raise ValueError("pafs must be [B, 2L, H, W] and xy [B, J, K, 2]")
    B, C, H, W = pafs.shape
    J, K = xy.shape[1], xy.shape[2]
    L = limb_pairs.shape[0]
    dev = pafs.device
    _check(pafs, "pafs", torch.float32, (B, 2 * L, H, W), dev)
    _check(xy, "xy", torch.float32, (B, J, K, 2), dev)
    _check(count, "count", torch.int32, (B, J), dev)
    _check(limb_pairs, "limb_pairs", torch.int32, (L, 2), dev)
    lib = _load()
    out = torch.empty((B, L, K, K), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    close_threshold = (float(H) * float(W)) ** 0.5 / 150.0
    with torch.cuda.device(dev):
        err = lib.paf_score_launch(
            pafs.data_ptr(), xy.data_ptr(), count.data_ptr(),
            limb_pairs.data_ptr(), out.data_ptr(), B, J, K, L, H, W,
            num_samples, inter_threshold, inter_min_above,
            default_threshold + 1e-6, close_threshold,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "paf_score_kernel")
    LAUNCHES["paf_score"] += 1
    return out


def associate_limb(scores_all: torch.Tensor,
                   dst_slot_valid: torch.Tensor) -> torch.Tensor:
    """``associate_limb_kernel``: one limb's greedy for every image.

    scores_all [B, K, K] f32 (rows are persons in greedy order);
    dst_slot_valid [B, K] bool; K <= 128. Returns [B, K] int32, -1 = none.
    """
    if scores_all.ndim != 3:
        raise ValueError("scores_all must be [B, K, K]")
    B, K = scores_all.shape[0], scores_all.shape[1]
    if K > MAX_ASSOC_PEAKS:
        raise ValueError(f"associate_limb_kernel takes K <= "
                         f"{MAX_ASSOC_PEAKS}, got {K}")
    dev = scores_all.device
    _check(scores_all, "scores_all", torch.float32, (B, K, K), dev)
    _check(dst_slot_valid, "dst_slot_valid", torch.bool, (B, K), dev)
    lib = _load()
    assign = torch.empty((B, K), dtype=torch.int32, device=dev)
    if assign.numel() == 0:
        return assign
    with torch.cuda.device(dev):
        err = lib.associate_limb_launch(
            scores_all.data_ptr(), dst_slot_valid.data_ptr(),
            assign.data_ptr(), B, K,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "associate_limb_kernel")
    LAUNCHES["associate_limb"] += 1
    return assign


def fused_stem(x: torch.Tensor, kernel: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """``fused_stem_kernel``: maxpool3x3/2(relu(conv7x7/2(x) + bias)).

    x [B, H, W, Cin] bf16 NHWC (Cin 3 or 4); kernel [64, Cin, 7, 7] bf16;
    bias [64] f32; all contiguous on one CUDA device. Returns
    [B, Hp, Wp, 64] bf16 NHWC, Hp = ceil(ceil(H / 2) / 2).
    """
    if x.ndim != 4:
        raise ValueError("x must be [B, H, W, Cin]")
    B, H, W, cin = x.shape
    if cin not in (3, 4):
        raise ValueError(f"fused_stem_kernel takes Cin 3 or 4, got {cin}")
    dev = x.device
    _check(x, "x", torch.bfloat16, (B, H, W, cin), dev)
    _check(kernel, "kernel", torch.bfloat16, (STEM_COUT, cin, 7, 7), dev)
    _check(bias, "bias", torch.float32, (STEM_COUT,), dev)
    lib = _load()
    hp, wp = (H + 3) // 4, (W + 3) // 4
    out = torch.empty((B, hp, wp, STEM_COUT), dtype=torch.bfloat16,
                      device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.fused_stem_launch(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, H, W, cin, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "fused_stem_kernel")
    LAUNCHES["fused_stem"] += 1
    return out


def fused_bottleneck(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                     b3: torch.Tensor, wd: Optional[torch.Tensor] = None,
                     bd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fused_bottleneck_kernel``: one BN-folded stride-1 bottleneck.

    x [B, H, W, Cin] bf16 NHWC; w1 [Cin, Cm], w2 [3, 3, Cm, Cm], w3
    [Cm, Cout], wd [Cin, Cout] or None, bf16; biases f32; all contiguous on
    one CUDA device; Cin, Cm, Cout multiples of 16. Returns
    [B, H, W, Cout] bf16 NHWC.
    """
    if x.ndim != 4 or w1.ndim != 2 or w3.ndim != 2:
        raise ValueError("x must be [B, H, W, Cin], w1 [Cin, Cm], "
                         "w3 [Cm, Cout]")
    B, H, W, cin = x.shape
    cm, cout = w1.shape[1], w3.shape[1]
    if cin % 16 or cm % 16 or cout % 16:
        raise ValueError(f"fused_bottleneck_kernel takes channels in "
                         f"multiples of 16, got {cin}, {cm}, {cout}")
    if (wd is None) != (bd is None):
        raise ValueError("wd and bd go together")
    if wd is None and cin != cout:
        raise ValueError("an identity residual needs Cin == Cout")
    dev = x.device
    # x is read 16 bytes at a time; the weights are wmma tiles, which
    # need 32-byte aligned rows.
    _check(x, "x", torch.bfloat16, (B, H, W, cin), dev, align=16)
    _check(w1, "w1", torch.bfloat16, (cin, cm), dev, align=32)
    _check(b1, "b1", torch.float32, (cm,), dev)
    _check(w2, "w2", torch.bfloat16, (3, 3, cm, cm), dev, align=32)
    _check(b2, "b2", torch.float32, (cm,), dev)
    _check(w3, "w3", torch.bfloat16, (cm, cout), dev, align=32)
    _check(b3, "b3", torch.float32, (cout,), dev)
    if wd is not None:
        _check(wd, "wd", torch.bfloat16, (cin, cout), dev, align=32)
        _check(bd, "bd", torch.float32, (cout,), dev)
    lib = _load()
    out = torch.empty((B, H, W, cout), dtype=torch.bfloat16, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.fused_bottleneck_launch(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
            None if wd is None else wd.data_ptr(),
            None if bd is None else bd.data_ptr(), out.data_ptr(),
            B, H, W, cin, cm, cout,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "fused_bottleneck_kernel")
    LAUNCHES["fused_bottleneck"] += 1
    return out

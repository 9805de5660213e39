"""The port's hand-written CUDA kernels: build, bindings and launch counts.

``smap_tpu_torch/csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, at first use, into
``smap_tpu_torch/_build/`` (git-ignored; the file name carries a hash of the
sources and flags, so an edit rebuilds). The library is loaded with
``ctypes``. Each C entry point launches on PyTorch's current stream and
returns ``cudaGetLastError()``; the wrappers here raise if it is not 0.

The wrappers take CUDA tensors only and raise on anything else: the plain
PyTorch versions live beside their callers (``ops/paf.py``,
``ops/association.py``, ``ops/fused_stem.py``, ``ops/fused_block.py``,
``ops/int8_conv.py``), which choose by device. ``LAUNCHES`` counts the
launches of each kernel.
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
SOURCES = ("paf_score.cu", "associate.cu", "fused_stem.cu",
           "fused_bottleneck.cu", "int8_conv.cu")
# -fmad=false: the PAF kernel must round each product and sum as the plain
# version does (a contracted FMA moves sample points across .5 boundaries
# and samples across the threshold). No fast math: sqrtf and / stay IEEE.
# The stem, bottleneck and int8 kernels multiply on the tensor cores, which
# the flag leaves alone.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false")

# Largest peak capacity the association kernel takes (a warp's lanes own 4
# dst slots each), and the most limbs in one of its waves.
MAX_ASSOC_PEAKS = 128
MAX_WAVE_LIMBS = 8
# Most samples per segment the PAF kernel takes (its unrolled bound).
MAX_PAF_SAMPLES = 32

# The activation types kernel E takes: quantized int8, or bf16 / float32
# that it quantizes; its K step (int8 values) and tile widths (output
# channels a tile: the narrowest that holds Cout, else 256).
_INT8_CONV_INPUTS = (torch.int8, torch.bfloat16, torch.float32)
INT8_K_STEP = 32
INT8_TILE_N = (8, 16, 48, 64, 128, 256)

# The stem kernel's output channels (a compile-time constant of the kernel)
# and the length of its weight rows (ops/fused_stem.py, STEM_ROW).
STEM_COUT, STEM_ROW = 64, 232

LAUNCHES: Dict[str, int] = {"paf_score": 0, "associate": 0,
                            "fused_stem": 0, "fused_bottleneck": 0,
                            "int8_conv": 0}

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
            L64 = ctypes.c_longlong
            lib.associate_launch.argtypes = ([P, L64, L64, L64] * 2
                                             + [P] * 8 + [I] * 9 + [F, P])
            lib.associate_launch.restype = I
            lib.fused_stem_launch.argtypes = [P, P, P, P, I, I, I, I, P]
            lib.fused_stem_launch.restype = I
            lib.fused_bottleneck_launch.argtypes = [P] * 4 + [I] * 6 + [P]
            lib.fused_bottleneck_launch.restype = I
            lib.int8_conv_launch.argtypes = [P] * 6 + [I] * 14 + [P]
            lib.int8_conv_launch.restype = I
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

    pafs [B, 2L, H, W] f32 in channels-last memory (strides (2L H W, 1,
    2L W, 2L), as the network's NHWC maps give it), 8-byte aligned; xy
    [B, J, K, 2] f32; count [B, J] int32; limb_pairs [L, 2] int32; all on
    one CUDA device, the last three contiguous. num_samples <= 32.
    """
    if pafs.ndim != 4 or xy.ndim != 4:
        raise ValueError("pafs must be [B, 2L, H, W] and xy [B, J, K, 2]")
    B, C, H, W = pafs.shape
    J, K = xy.shape[1], xy.shape[2]
    L = limb_pairs.shape[0]
    dev = pafs.device
    if not 0 < num_samples <= MAX_PAF_SAMPLES:
        raise ValueError(f"paf_score_kernel takes 1 to {MAX_PAF_SAMPLES} "
                         f"samples, got {num_samples}")
    _check(pafs.permute(0, 2, 3, 1), "pafs (as [B, H, W, 2L])",
           torch.float32, (B, H, W, 2 * L), dev, align=8)
    _check(xy, "xy", torch.float32, (B, J, K, 2), dev, align=8)
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


def associate(xy: torch.Tensor, score: torch.Tensor, count: torch.Tensor,
              table: torch.Tensor, root_depth_map: torch.Tensor,
              steps: torch.Tensor, wave_starts: torch.Tensor,
              bone: torch.Tensor, *, root_idx: int, max_wave: int,
              inv_ds_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``associate_kernel``: the whole association of a batch, one launch.

    xy [B, J, K, 2] f32 (coordinate stride 1) and score [B, J, K] f32, any
    other strides; count [B, J] int32; table [B, L, K, K] f32;
    root_depth_map [B, H, W] f32; steps [L, 4] int32 (limb, src, dst, flip)
    in wave order, wave_starts [n_waves + 1] int32 and bone [L] f32, with
    max_wave the most limbs in a wave (``ops.association.kernel_plan``);
    all on one CUDA device, count, table, the depth map and the plan
    contiguous. K <= 128, max_wave <= 8. Returns (bodies [B, K, J, 4],
    root_depth [B, K]), both f32.
    """
    if xy.ndim != 4 or table.ndim != 4 or root_depth_map.ndim != 3:
        raise ValueError("xy must be [B, J, K, 2], table [B, L, K, K] and "
                         "root_depth_map [B, H, W]")
    B, J, K = xy.shape[0], xy.shape[1], xy.shape[2]
    L = table.shape[1]
    H, W = root_depth_map.shape[1], root_depth_map.shape[2]
    if K > MAX_ASSOC_PEAKS:
        raise ValueError(f"associate_kernel takes K <= {MAX_ASSOC_PEAKS}, "
                         f"got {K}")
    if not 0 <= root_idx < J:
        raise ValueError(f"root_idx {root_idx} out of [0, {J})")
    if not 0 < max_wave <= MAX_WAVE_LIMBS:
        raise ValueError(f"associate_kernel takes waves of 1 to "
                         f"{MAX_WAVE_LIMBS} limbs, got {max_wave}")
    dev = xy.device
    if xy.device.type != "cuda" or score.device != dev:
        raise ValueError(f"xy and score: expected CUDA tensors on one "
                         f"device, got {xy.device} and {score.device}")
    for name, t, shape in (("xy", xy, (B, J, K, 2)),
                           ("score", score, (B, J, K))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if xy.stride(3) != 1:
        raise ValueError("xy: the coordinate axis must have stride 1")
    _check(count, "count", torch.int32, (B, J), dev)
    _check(table, "table", torch.float32, (B, L, K, K), dev)
    _check(root_depth_map, "root_depth_map", torch.float32, (B, H, W), dev)
    _check(steps, "steps", torch.int32, (L, 4), dev)
    _check(wave_starts, "wave_starts", torch.int32,
           (wave_starts.shape[0],), dev)
    _check(bone, "bone", torch.float32, (L,), dev)
    lib = _load()
    bodies = torch.empty((B, K, J, 4), dtype=torch.float32, device=dev)
    root_depth = torch.empty((B, K), dtype=torch.float32, device=dev)
    if bodies.numel() == 0:
        return bodies, root_depth
    with torch.cuda.device(dev):
        err = lib.associate_launch(
            xy.data_ptr(), *xy.stride()[:3], score.data_ptr(),
            *score.stride(), count.data_ptr(), table.data_ptr(),
            root_depth_map.data_ptr(), steps.data_ptr(),
            wave_starts.data_ptr(), bone.data_ptr(), bodies.data_ptr(),
            root_depth.data_ptr(), B, J, K, L, H, W, root_idx,
            wave_starts.shape[0] - 1, max_wave, inv_ds_scale,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "associate_kernel")
    LAUNCHES["associate"] += 1
    return bodies, root_depth


def fused_stem(x: torch.Tensor, packed: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """``fused_stem_kernel``: maxpool3x3/2(relu(conv7x7/2(x) + bias)).

    x [B, H, W, Cin] bf16 NHWC (Cin 3 or 4); packed [64, 232] bf16, the
    kernel's weight rows (``ops.fused_stem.pack_stem_for_kernel``); bias
    [64] f32; all contiguous on one CUDA device. Returns [B, Hp, Wp, 64]
    bf16 NHWC, Hp = ceil(ceil(H / 2) / 2).
    """
    if x.ndim != 4:
        raise ValueError("x must be [B, H, W, Cin]")
    B, H, W, cin = x.shape
    if cin not in (3, 4):
        raise ValueError(f"fused_stem_kernel takes Cin 3 or 4, got {cin}")
    dev = x.device
    _check(x, "x", torch.bfloat16, (B, H, W, cin), dev, align=8)
    _check(packed, "packed", torch.bfloat16, (STEM_COUT, STEM_ROW), dev,
           align=16)
    _check(bias, "bias", torch.float32, (STEM_COUT,), dev)
    lib = _load()
    hp, wp = (H + 3) // 4, (W + 3) // 4
    out = torch.empty((B, hp, wp, STEM_COUT), dtype=torch.bfloat16,
                      device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.fused_stem_launch(
            x.data_ptr(), packed.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, H, W, cin, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "fused_stem_kernel")
    LAUNCHES["fused_stem"] += 1
    return out


def fused_bottleneck(x: torch.Tensor, packed) -> torch.Tensor:
    """``fused_bottleneck_kernel``: one BN-folded stride-1 bottleneck.

    x [B, H, W, Cin] bf16 NHWC, contiguous on a CUDA device; ``packed`` the
    kernel's weights on the same device (``ops.fused_block.
    pack_bottleneck_for_kernel``). Cin and Cout multiples of 16, Cin <= 256
    (<= 64 with a projection), Cm <= 64, Cout <= 256. Returns
    [B, H, W, Cout] bf16 NHWC.
    """
    if x.ndim != 4:
        raise ValueError("x must be [B, H, W, Cin]")
    B, H, W, cin = x.shape
    cout = packed.cout
    if cin != packed.cin:
        raise ValueError(f"x has {cin} channels, the weights {packed.cin}")
    if cin % 16 or cout % 16:
        raise ValueError(f"fused_bottleneck_kernel takes channels in "
                         f"multiples of 16, got {cin}, {cout}")
    if cin > 256 or cout > 256 or packed.cm > 64 or (packed.proj
                                                      and cin > 64):
        raise ValueError(f"fused_bottleneck_kernel takes Cin <= 256 (<= 64 "
                         f"with a projection), Cm <= 64, Cout <= 256; got "
                         f"{cin}, {packed.cm}, {cout}")
    dev = x.device
    nk = -(-cin // 64)
    wbytes = (nk + 9 + 4 + 4 * packed.proj) * 8192
    # x is read by TMA and 16 bytes at a time; the weights 16 at a time.
    _check(x, "x", torch.bfloat16, (B, H, W, cin), dev, align=16)
    _check(packed.weights, "packed weights", torch.bfloat16, (wbytes // 2,),
           dev, align=16)
    _check(packed.bias, "packed bias", torch.float32, (640,), dev)
    lib = _load()
    out = torch.empty((B, H, W, cout), dtype=torch.bfloat16, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.fused_bottleneck_launch(
            x.data_ptr(), packed.weights.data_ptr(), packed.bias.data_ptr(),
            out.data_ptr(), B, H, W, cin, cout, int(packed.proj),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "fused_bottleneck_kernel")
    LAUNCHES["fused_bottleneck"] += 1
    return out


def int8_tile_n(cout: int) -> int:
    """Kernel E's tile width for ``cout`` output channels."""
    return next((n for n in INT8_TILE_N if cout <= n), INT8_TILE_N[-1])


def int8_conv(x: torch.Tensor, packed: torch.Tensor,
              kernel_scale: torch.Tensor, s_x: torch.Tensor,
              bias: torch.Tensor, *, kh: int, kw: int, stride: int,
              padding: int, relu: bool,
              out_dtype: torch.dtype) -> torch.Tensor:
    """``int8_conv_kernel``: one int8 convolution with the quantize of its
    input, its dequantization, bias, cast and ReLU.

    x [B, H, W, Cin] NHWC, bfloat16 or float32 (quantized by the kernel
    with ``s_x``) or int8 (already quantized), Cin a multiple of 4, 16-byte
    aligned; packed the flat int8 weight image of
    ``ops.int8_conv.pack_int8_weights`` for Cout = ``kernel_scale``'s
    length and K = kh * kw * Cin, 16-byte aligned; kernel_scale and bias
    [Cout] float32; s_x a 0-dim float32 tensor; all contiguous on one CUDA
    device. Returns [B, Ho, Wo, Cout] NHWC in ``out_dtype`` (bfloat16 or
    float32).
    """
    if x.ndim != 4 or packed.ndim != 1:
        raise ValueError("x must be [B, H, W, Cin] and packed flat")
    B, H, W, cin = x.shape
    cout = kernel_scale.shape[0] if kernel_scale.ndim == 1 else 0
    dev = x.device
    if x.dtype not in _INT8_CONV_INPUTS:
        raise ValueError(f"int8_conv_kernel takes int8, bfloat16 or float32 "
                         f"activations, not {x.dtype}")
    if cin % 4:
        raise ValueError(f"int8_conv_kernel takes Cin a multiple of 4, got "
                         f"{cin}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_conv_kernel writes bfloat16 or float32, "
                         f"not {out_dtype}")
    if stride < 1 or padding < 0:
        raise ValueError(f"stride {stride}, padding {padding}")
    bn = int8_tile_n(cout)
    kpad = -(-kh * kw * cin // INT8_K_STEP) * INT8_K_STEP
    _check(x, "x", x.dtype, (B, H, W, cin), dev, align=16)
    _check(packed, "packed", torch.int8, (-(-cout // bn) * bn * kpad,), dev,
           align=16)
    _check(kernel_scale, "kernel_scale", torch.float32, (cout,), dev)
    _check(bias, "bias", torch.float32, (cout,), dev)
    _check(s_x, "s_x", torch.float32, (), dev)
    ho = (H + 2 * padding - kh) // stride + 1
    wo = (W + 2 * padding - kw) // stride + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"a {kh}x{kw} kernel does not fit a {H}x{W} input "
                         f"with padding {padding}")
    lib = _load()
    out = torch.empty((B, ho, wo, cout), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.int8_conv_launch(
            x.data_ptr(), packed.data_ptr(), kernel_scale.data_ptr(),
            s_x.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W, cin,
            x.element_size(), cout, kh, kw, stride, padding, kpad, bn,
            int(relu), int(out_dtype == torch.float32),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "int8_conv_kernel")
    LAUNCHES["int8_conv"] += 1
    return out

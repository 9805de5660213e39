#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on a CUDA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases (each prints what it measured; any failure raises and the script
exits non-zero with no result line):

1. build: compile ``smap_tpu_torch/csrc/*.cu`` with nvcc for sm_90a.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the serving shapes (batch 16, K = 40 and 127) and on the golden scenes'
   peaks; times of both.
3. golden: the rendered scenes of ``tests/golden/decode_corpus.json``
   (base, rung8, flip_tta) decoded on the card through the kernels.
4. serving: ``SMAPInference`` at full width (ModelConfig() defaults,
   512x832, seeded random weights, bf16 compute) on batches of 16
   letterboxed uint8 frames: ``run_batch`` calls and one ``run_stream``
   over 4 batches, with the kernels' launch counts, forward / post ms,
   img/s and peak memory; one batch decoded again with the plain versions.
5. fused kernels: kernel C (stem) and kernel D (bottleneck) against their
   plain versions on the card in bf16, at the serving shapes (the stem on
   [16, 512, 832, 3], the bottleneck on [16, 128, 208] with 64 -> 64 -> 256
   plus projection and 256 -> 64 -> 256 identity), on a stem whose outputs
   all pool to 0, and on ragged bottleneck shapes; max abs error, share of
   bit-equal outputs, times of both.
6. folded serving: ``SMAPInference(quantized="folded", fuse_stem=True,
   fuse_bottleneck=True)`` at full width on the frames of phase 4, with
   seeded BatchNorm statistics: 1 stem and 9 bottleneck launches per
   forward; forward ms of the folded-fused, folded-unfused (cuDNN) and
   unfolded engines; the folded-fused maps' distance to a float32 forward
   within 2x the unfolded bf16 engine's + 1e-4; one batch decoded end to
   end.

The last lines are the kernels' JSON summary, the card's name and power
limit (nvidia-smi), and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the ``smap_tpu_torch`` package beside this file, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Kernel vs plain tolerances. Kernel A sums the passing samples in another
# order than torch.sum; a mean of <= 25 products of magnitude <= ~1.5 then
# moves by a few ulps of the sum, far below 1e-5. Sample points and
# pass/fail decisions are computed in the same order with the same IEEE
# roundings (-fmad=false), so which entries are -1, the default or a mean
# must be equal. Kernel B must be exactly equal.
PAF_SCORE_ATOL = 1e-5
# Decode of one batch through the kernels vs through the plain versions:
# the same tables up to kernel A's summation order.
DECODE_ATOL = 1e-4
# Kernel C vs its plain version: the conv's 147 exact products summed in
# another order; a pooled value near a bf16 rounding point can round the
# other way, one bf16 ulp (tests/test_fused_stem.py's own bound).
STEM_ATOL, STEM_RTOL = 2e-2, 1e-2
# Kernel D vs its plain version: the sums run in another order, which can
# flip the bf16 rounding of an intermediate y or z and so move an output
# by up to two bf16 ulps.
BLOCK_ATOL, BLOCK_RTOL = 1e-2, 1.6e-2
BATCH = 16
TIMED_BATCHES = 5
STREAM_BATCHES = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around
    ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_peaks(gen: torch.Generator, B: int, J: int, K: int, h: int,
                 w: int, dev):
    """A Peaks table as extract_peaks leaves it: random sub-pixel xy and
    scores in the first ``count`` slots, zeros after."""
    from smap_tpu_torch.ops.nms import Peaks

    count = torch.randint(0, K + 1, (B, J), generator=gen, dtype=torch.int32)
    count[:, :3] = K            # some full tables
    xy = torch.rand((B, J, K, 2), generator=gen)
    xy[..., 0] *= w
    xy[..., 1] *= h
    score = torch.rand((B, J, K), generator=gen)
    valid = torch.arange(K)[None, None, :] < count[..., None]
    xy = torch.where(valid[..., None], xy, 0.0)
    score = torch.where(valid, score, 0.0)
    return Peaks(xy.to(dev), score.to(dev), count.to(dev))


def check_paf(table_k: torch.Tensor, table_p: torch.Tensor,
              default_score: float, label: str) -> float:
    for name, fn in (("-1", lambda t: t == -1.0),
                     ("default", lambda t: t == default_score)):
        if not torch.equal(fn(table_k), fn(table_p)):
            n = int((fn(table_k) != fn(table_p)).sum())
            raise AssertionError(f"paf_score {label}: {n} entries differ "
                                 f"in being {name}")
    err = float((table_k - table_p).abs().max()) if table_k.numel() else 0.0
    if not err <= PAF_SCORE_ATOL:
        raise AssertionError(f"paf_score {label}: max abs err {err} > "
                             f"{PAF_SCORE_ATOL}")
    return err


def phase_kernels(dev, card: str):
    """Kernel A and B against their plain versions; returns the summary
    rows (without launches)."""
    from smap_tpu_torch import golden
    from smap_tpu_torch.config import PAF_VECTOR, PostProcessConfig
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.association import (associate_limb,
                                                associate_limb_plain)
    from smap_tpu_torch.ops.nms import Peaks, extract_peaks
    from smap_tpu_torch.ops.paf import paf_scores

    post = PostProcessConfig()
    default_score = torch.tensor(post.default_nms_threshold + 1e-6,
                                 dtype=torch.float32).item()
    limb_pairs = torch.tensor(PAF_VECTOR, dtype=torch.int32, device=dev)
    gen = torch.Generator().manual_seed(0)
    H, W, L, J = 128, 208, 14, 15
    rows = {}

    # Kernel A on the golden scenes' peaks (full capacity 127).
    err_a = 0.0
    for seed, _, _, out2d, _, _ in golden.scene_inputs():
        maps = torch.from_numpy(out2d).to(dev).permute(2, 0, 1)[None]
        peaks = extract_peaks(maps[:, :J] / 255.0, max_peaks=127)
        pafs = (maps[:, J:] / 127.0).contiguous()
        tk = paf_scores(pafs, peaks, limb_pairs)
        tp = paf_scores(pafs, peaks, limb_pairs, plain=True)
        torch.cuda.synchronize()
        err_a = max(err_a, check_paf(tk, tp, default_score,
                                     f"scene {seed}"))
    log(f"kernels: paf_score == plain on the 5 golden scenes (K=127), "
        f"max abs err {err_a:.3g}")

    # Kernel A at the serving shapes, random maps and peak tables.
    pafs = (torch.rand((BATCH, 2 * L, H, W), generator=gen) * 2 - 1).to(dev)
    times_a = {}
    for K in (40, 127):
        peaks = random_peaks(gen, BATCH, J, K, H, W, dev)
        tk = paf_scores(pafs, peaks, limb_pairs)
        tp = paf_scores(pafs, peaks, limb_pairs, plain=True)
        torch.cuda.synchronize()
        err_a = max(err_a, check_paf(tk, tp, default_score,
                                     f"B={BATCH} K={K}"))
        ms = cuda_ms(lambda: paf_scores(pafs, peaks, limb_pairs), 20)
        plain_ms = cuda_ms(lambda: paf_scores(pafs, peaks, limb_pairs,
                                              plain=True), 5)
        times_a[K] = (ms, plain_ms)
        log(f"kernels: paf_score B={BATCH} K={K} L={L} {H}x{W}: "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, max abs err "
            f"{err_a:.3g} [{card}]")
    rows["paf_score"] = dict(
        name="paf_score_kernel", route="cuda",
        source="smap_tpu_torch/csrc/paf_score.cu",
        replaces="smap_tpu/ops/pallas_kernels.py:62",
        max_abs_err=err_a, ms=times_a[40][0], plain_ms=times_a[40][1],
        ms_k127=times_a[127][0], plain_ms_k127=times_a[127][1])

    # Kernel B: random tables with ties, -inf rows and all -inf tables.
    times_b = {}
    for K in (8, 40, 127):
        scores = torch.round((torch.rand((BATCH, K, K), generator=gen)
                              * 2 - 1) * 10) / 10          # many ties
        scores[torch.rand((BATCH, K), generator=gen) < 0.3] = float("-inf")
        scores[0] = float("-inf")                          # nothing valid
        scores[1, :, :] = 0.5                              # all tied
        n_valid = torch.randint(0, K + 1, (BATCH, 1), generator=gen)
        valid = torch.arange(K)[None, :] < n_valid
        scores, valid = scores.to(dev), valid.to(dev)
        got = associate_limb(scores, valid)
        want = associate_limb_plain(scores, valid)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"associate_limb K={K}: "
                                 f"{int((got != want).sum())} entries "
                                 f"differ from the plain greedy")
        ms = cuda_ms(lambda: associate_limb(scores, valid), 50)
        plain_ms = cuda_ms(lambda: associate_limb_plain(scores, valid), 3)
        times_b[K] = (ms, plain_ms)
        log(f"kernels: associate_limb B={BATCH} K={K}: equal; {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms [{card}]")
    rows["associate_limb"] = dict(
        name="associate_limb_kernel", route="cuda",
        source="smap_tpu_torch/csrc/associate_limb.cu",
        replaces="smap_tpu/ops/pallas_kernels.py:208",
        max_abs_err=0.0, ms=times_b[40][0], plain_ms=times_b[40][1],
        ms_k127=times_b[127][0], plain_ms_k127=times_b[127][1])
    kernels.reset_launch_counts()
    return rows


def phase_golden(dev) -> None:
    from smap_tpu_torch import golden
    from smap_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    variants = ("scenes", "rung8", "flip_tta")
    got = golden.decode_golden(dev, variants=variants)
    want = golden.load_corpus()
    for name in variants:
        golden.compare(got[name], want[name], label=name)
    n = len(golden.SCENES) * len(variants)
    if (kernels.LAUNCHES["paf_score"] != n
            or kernels.LAUNCHES["associate_limb"] != 14 * n):
        raise AssertionError(f"golden decode launches {kernels.LAUNCHES}, "
                             f"want {n} / {14 * n}")
    counts = {v: [r["count"] for r in got[v]] for v in variants}
    log(f"golden: base, rung8, flip_tta match the corpus through the "
        f"kernels (rtol {golden.RTOL}, atol {golden.ATOL}); counts {counts}")


def letterboxed_frames(rng: np.random.RandomState, n: int, h: int, w: int):
    """1920x1080 frames letterboxed into h x w: gray bars, smooth random
    content in the band."""
    from smap_tpu_torch.camera import default_scale_dict

    scale = min(w / 1920, h / 1080)
    band = int(round(1080 * scale))
    top = (h - band) // 2
    frames = np.full((n, h, w, 3), 128, np.uint8)
    coarse = rng.randint(0, 256, (n, band // 8 + 1, w // 8 + 1, 3))
    content = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)
    frames[:, top:top + band] = content[:, :band, :w].astype(np.uint8)
    return frames, [default_scale_dict(1920, 1080, w, h)] * n


def serving_batches(cfg):
    """The serving phases' frames: TIMED_BATCHES batches of BATCH
    letterboxed uint8 frames with their scale dicts, from seed 0."""
    net_h, net_w = cfg.input_shape
    rng = np.random.RandomState(0)
    return [letterboxed_frames(rng, BATCH, net_h, net_w)
            for _ in range(TIMED_BATCHES)]


def phase_serving(dev, card: str, batches):
    from smap_tpu_torch.config import Config
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.smap import init_smap
    from smap_tpu_torch.ops import kernels

    cfg = Config()
    t0 = time.perf_counter()
    engine = SMAPInference(init_smap(cfg.model, seed=0).state_dict(), cfg,
                           device=dev)
    net_h, net_w = cfg.input_shape
    log(f"serving: engine up in {time.perf_counter() - t0:.2f} s "
        f"(ModelConfig() {net_h}x{net_w}, {cfg.model.compute_dtype}, "
        f"assoc_peaks {cfg.post.assoc_peaks}, batch {BATCH})")

    for frames, scales in batches[:2]:                      # warm-up
        engine.results_to_pairs(engine.run_batch(frames, scales),
                                [""] * BATCH)
    torch.cuda.synchronize()

    # Stage times, each stage synchronized.
    fwd_ms, post_ms = [], []
    for frames, scales in batches:
        t0 = time.perf_counter()
        images, info = engine.place(frames, scales)
        maps = engine.forward(images)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.postprocess(maps, info)
        torch.cuda.synchronize()
        fwd_ms.append((t1 - t0) * 1e3)
        post_ms.append((time.perf_counter() - t1) * 1e3)
    for m in maps:
        if not bool(torch.isfinite(m).all()):
            raise AssertionError("serving: non-finite network maps")
    expect = ((BATCH, *cfg.output_shape, cfg.model.kpt_paf_channels),
              (BATCH, *cfg.output_shape, cfg.model.num_limbs),
              (BATCH, *cfg.output_shape, 1))
    if tuple(tuple(m.shape) for m in maps) != expect:
        raise AssertionError(f"serving: map shapes "
                             f"{[tuple(m.shape) for m in maps]}")

    # The main path: run_batch calls, then one run_stream, counted.
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    people = 0
    for frames, scales in batches:
        pairs = engine.results_to_pairs(engine.run_batch(frames, scales),
                                        [""] * BATCH)
        people += sum(len(p["pred_3d"]) for p in pairs)
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_stream = 0
    for res in engine.run_stream(batches[:STREAM_BATCHES]):
        engine.results_to_pairs(res, [""] * BATCH)
        n_stream += 1
    t_stream = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    n_batches = TIMED_BATCHES + n_stream
    if n_stream != STREAM_BATCHES or launches != {
            "paf_score": n_batches, "associate_limb": 14 * n_batches,
            "fused_stem": 0, "fused_bottleneck": 0}:
        raise AssertionError(f"serving: launches {launches} over "
                             f"{n_batches} batches, want 1 and 14 per batch")

    log(f"serving: forward {np.mean(fwd_ms):.2f} ms, post "
        f"{np.mean(post_ms):.2f} ms per batch of {BATCH} (mean of "
        f"{TIMED_BATCHES}, synchronized) [{card}]")
    log(f"serving: run_batch e2e {TIMED_BATCHES * BATCH / t_batch:.1f} "
        f"img/s, run_stream e2e {STREAM_BATCHES * BATCH / t_stream:.1f} img/s"
        f", {people} people decoded in {TIMED_BATCHES} batches, peak memory "
        f"{peak_mb:.0f} MiB [{card}]")
    log(f"serving: launches {launches} over {n_batches} batches")

    # One batch decoded with the plain versions on the card.
    images, info = engine.place(*batches[0])
    maps = engine.forward(images)
    res_k = engine.postprocess(maps, info)
    res_p = engine.postprocess(maps, info, plain=True)
    torch.cuda.synchronize()
    if not torch.equal(res_k.count, res_p.count):
        raise AssertionError(f"serving: plain decode counts "
                             f"{res_p.count.tolist()} != kernel decode "
                             f"{res_k.count.tolist()}")
    err = max(float((a - b).abs().max()) for a, b in
              zip(res_k[:3], res_p[:3]))
    if not err <= DECODE_ATOL:
        raise AssertionError(f"serving: plain vs kernel decode max abs err "
                             f"{err} > {DECODE_ATOL}")
    log(f"serving: plain decode of one batch on the card: counts "
        f"{res_k.count.tolist()} equal, tables max abs err {err:.3g}")
    return launches


def check_close(got: torch.Tensor, want: torch.Tensor, atol: float,
                rtol: float, label: str):
    """(max abs err, share of bit-equal outputs) of a kernel's bf16 result
    against its plain version's; raises past atol + rtol * |want|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: {tuple(got.shape)} {got.dtype} vs "
                             f"plain {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{label}: non-finite outputs")
    err = (g - w).abs()
    bad = int((err > atol + rtol * w.abs()).sum())
    if bad:
        raise AssertionError(f"{label}: {bad} outputs past atol {atol} / "
                             f"rtol {rtol}, max abs err {float(err.max())}")
    return float(err.max()), float((got == want).float().mean())


def stem_inputs(gen, B, H, W, dev, bias_value=None):
    x = torch.randn((B, H, W, 3), generator=gen).to(dev, torch.bfloat16)
    k = (torch.randn((64, 3, 7, 7), generator=gen)
         * (2.0 / 147) ** 0.5).to(dev, torch.bfloat16)
    b = (torch.randn((64,), generator=gen) * 0.1 if bias_value is None
         else torch.full((64,), bias_value))
    return x, k, b.to(dev)


def block_inputs(gen, B, H, W, cin, cm, cout, proj, dev):
    """Post-ReLU activations and kaiming-scale folded weights in the
    kernel's layout."""
    def w(*shape, fan_in):
        return (torch.randn(shape, generator=gen)
                * (2.0 / fan_in) ** 0.5).to(dev, torch.bfloat16)

    def bias(n):
        return (torch.randn((n,), generator=gen) * 0.1).to(dev)

    x = torch.relu(torch.randn((B, H, W, cin), generator=gen)).to(
        dev, torch.bfloat16)
    args = [x, w(cin, cm, fan_in=cin), bias(cm),
            w(3, 3, cm, cm, fan_in=9 * cm), bias(cm),
            w(cm, cout, fan_in=cm), bias(cout)]
    if proj:
        args += [w(cin, cout, fan_in=cin), bias(cout)]
    return args


def phase_fused_kernels(dev, card: str):
    """Kernels C and D against their plain versions; returns the summary
    rows (without launches)."""
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.fused_block import fused_bottleneck
    from smap_tpu_torch.ops.fused_stem import fused_stem

    gen = torch.Generator().manual_seed(1)
    rows = {}

    # Kernel C at the serving shape, then a stem whose outputs all relu
    # to 0 (the pool's padding must not win) at two sizes.
    x, k, b = stem_inputs(gen, BATCH, 512, 832, dev)
    err, equal = check_close(fused_stem(x, k, b),
                             fused_stem(x, k, b, plain=True), STEM_ATOL,
                             STEM_RTOL, "fused_stem serving shape")
    ms = cuda_ms(lambda: fused_stem(x, k, b), 20)
    plain_ms = cuda_ms(lambda: fused_stem(x, k, b, plain=True), 5)
    log(f"kernels: fused_stem [{BATCH}, 512, 832, 3] -> 64: max abs err "
        f"{err:.3g}, {equal:.4f} bit-equal; {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms [{card}]")
    for B, H, W in ((BATCH, 512, 832), (2, 30, 50)):
        xn, kn, bn = stem_inputs(gen, B, H, W, dev, bias_value=-10.0)
        got = fused_stem(xn, kn, bn)
        if not torch.equal(got, fused_stem(xn, kn, bn, plain=True)) or bool(
                got.float().abs().max() != 0):
            raise AssertionError(f"fused_stem negative bias [{B}, {H}, {W}]"
                                 f": outputs are not all exactly 0")
    log("kernels: fused_stem with bias -10: every output exactly 0, equal "
        "to plain")
    rows["fused_stem"] = dict(
        name="fused_stem_kernel", route="cuda",
        source="smap_tpu_torch/csrc/fused_stem.cu",
        replaces="smap_tpu/ops/fused_stem.py:216", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bit_equal=equal)
    del x, k, b

    # Kernel D: the serving shapes (timed), then ragged ones.
    errs, times, equals = [], {}, {}
    for label, shape, timed in (
            ("layer1_1 256->64->256 identity", (BATCH, 128, 208, 256, 64,
                                                256, False), True),
            ("layer1_0 64->64->256 projection", (BATCH, 128, 208, 64, 64,
                                                 256, True), True),
            ("ragged W=13, H=20", (2, 20, 13, 64, 64, 256, True), False),
            ("H=36 (4 past a tile), W=100", (3, 36, 100, 256, 64, 256,
                                             False), False)):
        args = block_inputs(gen, *shape, dev)
        err, equal = check_close(fused_bottleneck(*args),
                                 fused_bottleneck(*args, plain=True),
                                 BLOCK_ATOL, BLOCK_RTOL,
                                 f"fused_bottleneck {label}")
        errs.append(err)
        msg = (f"kernels: fused_bottleneck {label} {list(shape[:3])}: max "
               f"abs err {err:.3g}, {equal:.4f} bit-equal")
        if timed:
            ms = cuda_ms(lambda: fused_bottleneck(*args), 20)
            plain_ms = cuda_ms(lambda: fused_bottleneck(*args, plain=True), 5)
            times[shape[6]], equals[shape[6]] = (ms, plain_ms), equal
            msg += f"; {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]"
        log(msg)
    rows["fused_bottleneck"] = dict(
        name="fused_bottleneck_kernel", route="cuda",
        source="smap_tpu_torch/csrc/fused_bottleneck.cu",
        replaces="smap_tpu/ops/fused_block.py:117", max_abs_err=max(errs),
        ms=times[False][0], plain_ms=times[False][1],
        ms_proj=times[True][0], plain_ms_proj=times[True][1],
        bit_equal=equals[False])
    kernels.reset_launch_counts()
    return rows


def perturbed_state_dict(cfg, seed: int):
    """``init_smap`` weights with seeded non-identity BatchNorm statistics
    and conv biases (as tests/test_fused_block.py perturbs them), so that
    folding moves every weight."""
    from smap_tpu_torch.models.smap import init_smap

    sd = init_smap(cfg, seed=seed).state_dict()
    gen = torch.Generator().manual_seed(seed + 1)
    for key, v in sd.items():
        if key.endswith("bn.weight"):
            sd[key] = torch.rand(v.shape, generator=gen) * 0.6 + 0.7
        elif key.endswith(("bn.bias", "bn.running_mean")):
            sd[key] = torch.randn(v.shape, generator=gen) * 0.1
        elif key.endswith("bn.running_var"):
            sd[key] = torch.rand(v.shape, generator=gen) * 1.5 + 0.5
        elif key.endswith("conv.bias"):
            sd[key] = torch.randn(v.shape, generator=gen) * 0.05
    return sd


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """RMS of a - b over the RMS of b."""
    return float((a - b).pow(2).mean().sqrt() / (b.pow(2).mean().sqrt()
                                                 + 1e-9))


def phase_folded_serving(dev, card: str, batches):
    """The BN-folded engine with both fused kernels: launch counts, forward
    ms beside the folded-unfused and unfolded engines, distance to a
    float32 forward, one batch decoded end to end."""
    import dataclasses

    from smap_tpu_torch.config import Config
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.ops import kernels

    cfg = Config()
    sd = perturbed_state_dict(cfg.model, seed=0)
    t0 = time.perf_counter()
    engines = {
        "folded-fused": SMAPInference(sd, cfg, device=dev, quantized="folded",
                                      fuse_stem=True, fuse_bottleneck=True),
        "folded-unfused": SMAPInference(sd, cfg, device=dev,
                                        quantized="folded"),
        "unfolded": SMAPInference(sd, cfg, device=dev)}
    truth_engine = SMAPInference(sd, dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32")),
        device=dev)
    log(f"folded: 4 engines up in {time.perf_counter() - t0:.2f} s")
    fused = engines["folded-fused"]

    # The main path: folded-fused run_batch calls, counted.
    for frames, scales in batches[:2]:                      # warm-up
        fused.results_to_pairs(fused.run_batch(frames, scales), [""] * BATCH)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    people = 0
    for frames, scales in batches:
        pairs = fused.results_to_pairs(fused.run_batch(frames, scales),
                                       [""] * BATCH)
        people += sum(len(p["pred_3d"]) for p in pairs)
    t_batch = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n = len(batches)
    want = {"paf_score": n, "associate_limb": 14 * n, "fused_stem": n,
            "fused_bottleneck": 9 * n}
    if launches != want:
        raise AssertionError(f"folded: launches {launches} over {n} "
                             f"batches, want {want}")
    log(f"folded: launches {launches} over {n} batches (1 stem, 9 "
        f"bottleneck, 1 paf_score, 14 associate_limb per batch)")
    log(f"folded: folded-fused run_batch e2e {n * BATCH / t_batch:.1f} "
        f"img/s, {people} people decoded in {n} batches [{card}]")

    # Forward ms of the three bf16 engines, in turns on the same frames.
    fwd = {name: [] for name in engines}
    for e in engines.values():
        e.forward(e.place(*batches[0])[0])
    torch.cuda.synchronize()
    for frames, scales in batches:
        for name, e in engines.items():
            t0 = time.perf_counter()
            e.forward(e.place(frames, scales)[0])
            torch.cuda.synchronize()
            fwd[name].append((time.perf_counter() - t0) * 1e3)
    log(f"folded: forward ms per batch of {BATCH} (mean of "
        f"{len(batches)}, synchronized): " + ", ".join(
            f"{name} {np.mean(v):.2f}" for name, v in fwd.items())
        + f" [{card}]")

    # Distance to the float32 unfolded forward (TF32 off).
    images = truth_engine.place(*batches[0])[0]
    truth = truth_engine.forward(images)
    maps = {name: e.forward(images) for name, e in engines.items()}
    for i, name in enumerate(("2d", "rel-depth", "root-depth")):
        noise = rel_err(maps["unfolded"][i], truth[i])
        errs = {k: rel_err(m[i], truth[i]) for k, m in maps.items()}
        if not (bool(torch.isfinite(maps["folded-fused"][i]).all())
                and noise > 0
                and errs["folded-fused"] <= 2.0 * noise + 1e-4):
            raise AssertionError(f"folded: {name} map distances to float32 "
                                 f"{errs}, bound 2 x {noise} + 1e-4")
        log(f"folded: {name} map, relative distance to float32: "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (bound {2.0 * noise + 1e-4:.3g})")

    # One batch decoded end to end.
    res = fused.run_batch(*batches[0])
    counts = res.count.tolist()
    if len(counts) != BATCH or not all(
            bool(torch.isfinite(t).all()) for t in res[:3]):
        raise AssertionError(f"folded: decode counts {counts}, or "
                             f"non-finite tables")
    log(f"folded: one batch decoded end to end, counts {counts}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs "
              "a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from smap_tpu_torch.config import Config
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.runtime import get_device, set_tf32

    dev = get_device("cuda:0")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, tf32 {set_tf32(False)}")

    t0 = time.perf_counter()
    path, report = kernels.build()
    log(f"build: {time.perf_counter() - t0:.2f} s, nvcc "
        f"{' '.join(kernels.NVCC_FLAGS)} -> {os.path.relpath(path, ROOT)}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"build: {line.strip()}")

    rows = phase_kernels(dev, card)
    phase_golden(dev)
    batches = serving_batches(Config())
    launches = phase_serving(dev, card, batches)
    for key in ("paf_score", "associate_limb"):
        rows[key]["launches"] = launches[key]
    fused_rows = phase_fused_kernels(dev, card)
    launches = phase_folded_serving(dev, card, batches)
    for key, row in fused_rows.items():
        row["launches"] = launches[key]
    rows.update(fused_rows)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms")
    summary = [{**{k: row[k] for k in keys},
                **{k: v for k, v in row.items() if k not in keys}}
               for row in rows.values()]
    log(json.dumps({"kernels": summary}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

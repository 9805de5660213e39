#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on a CUDA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases (each prints what it measured; any failure raises and the script
exits non-zero with no result line):

1. build: compile ``smap_tpu_torch/csrc/*.cu`` with nvcc for sm_90a.
2. kernels: kernel A (PAF scoring, on channels-last maps as the decode
   gives them) within 1e-5 of its plain version, and kernel B (the whole
   association, one launch) bit-equal to its plain version, on the golden
   scenes (K = 127) and at the serving shapes (batch 16; A at K = 40 and
   127; B at K = 8, 40, 127 and 128, on tables with ties, NaN entries, -1
   rows, empty joints, an image with no root, tied, NaN and signed-zero
   root depths); times of both at K = 40 and 127, B's also per step of
   its 4 x K chain.
3. golden: the rendered scenes of ``tests/golden/decode_corpus.json``
   (base, rung8, flip_tta) decoded on the card through the kernels.
4. serving: ``SMAPInference`` at full width (ModelConfig() defaults,
   512x832, seeded random weights, bf16 compute) on batches of 16
   letterboxed uint8 frames: ``run_batch`` calls and one ``run_stream``
   over 4 batches, with the kernels' launch counts (one A and one B per
   batch), forward / post ms, img/s and peak memory; one batch decoded
   again with the plain versions.
5. fused kernels: kernel C (stem) and kernel D (bottleneck) against their
   plain versions on the card in bf16, at the serving shapes (the stem on
   [16, 512, 832, 3], the bottleneck on [16, 128, 208] with 64 -> 64 -> 256
   plus projection and 256 -> 64 -> 256 identity), on a stem whose outputs
   all pool to 0, and on ragged bottleneck shapes (W 13 and 100, H 8,
   batch 1, a tile count that is not a multiple of the SM count); max abs
   error, share of bit-equal outputs, times of both, and each kernel in
   turns with the cuDNN bf16 chain the folded-unfused engine runs for the
   same function (``library_ms``).
6. folded serving: ``SMAPInference(quantized="folded", fuse_stem=True,
   fuse_bottleneck=True)`` at full width on the frames of phase 4, with
   seeded BatchNorm statistics: 1 stem and 9 bottleneck launches per
   forward, 1 A and 1 B per decode; forward ms of the folded-fused,
   folded-unfused (cuDNN) and unfolded engines; the folded-fused maps' distance to a float32 forward
   within 2x the unfolded bf16 engine's + 1e-4; one batch decoded end to
   end.
7. int8 serving: ``SMAPInference(quantized="static")`` calibrated on the
   first batch of phase 4, at full width on its frames: every conv of the
   forward in kernel E, which quantizes its bf16 input itself (206 launches
   a forward, 1 A and 1 B per decode); E bit-equal to its plain version on
   the forward's own conv inputs at all its conv shapes and at ragged ones
   (int8 and bf16 inputs, ties of x / s_x, a clipping scale), each shape
   timed in turns with the plain quantize + E's int8 instance, cuBLASLt's
   int8 product after an im2col (``library_ms``) and the cuDNN bf16 conv +
   bias; the int8-static, int8-dynamic, folded-fused and unfolded forwards
   in turns; the int8 maps' distance to a float32 forward within the JAX
   package's int8 gates; the capacity ladder against the full-capacity
   decode.

The last lines are the kernels' JSON summary (per kernel: times, launches
in the main path and per forward or batch, the least time the card could
take at its published peaks, ``bound_ms``, with what bounds it and the share
of it reached), the card's name and power limit (nvidia-smi), and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
``smap_tpu_torch`` package beside this file, it exits non-zero and prints
no result.
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
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense): the
# bounds are the larger of the bytes over the memory rate and the
# operations over the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12
# The int8 forwards' distance to a float32 forward: tests/test_quantize.py's
# gates (rms_rel, per map) and correlation floor.
INT8_REL = (0.08, 0.08, 0.25)
INT8_CORR = 0.98
LADDER = (8, 16, 40)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2, ahead: bool = False) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around
    ``iters`` back-to-back calls. ``ahead``: queue the calls behind a
    ~10 ms spin on the card first, so that a kernel shorter than its
    wrapper's host time is timed on the device alone; the median of 5
    such runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(5 if ahead else 1):
        if ahead:
            torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return float(np.median(runs))


def in_turns(fns, iters: int, ahead: bool = False):
    """Mean device ms of each of ``fns`` (name -> callable), timed in turns
    A B .. B A on the same card (``ahead``: as ``cuda_ms``)."""
    names = list(fns)
    got = {name: [] for name in names}
    for name in names + names[::-1]:
        got[name].append(cuda_ms(fns[name], iters, ahead=ahead))
    return {name: float(np.mean(v)) for name, v in got.items()}


def bound(ms: float, nbytes: float, ops: float, peak: float) -> dict:
    """The roofline keys of a summary row for a kernel that took ``ms``:
    ``nbytes`` moved (each input read once, each output written once) and
    ``ops`` operations on a unit of rate ``peak``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    memory = t_bytes >= t_ops
    b = max(t_bytes, t_ops)
    return dict(bound_ms=b, bound_by="bytes" if memory else "operations",
                bound_kind="memory" if memory else "compute", share=b / ms)


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


def paf_work(peaks, limb_pairs: torch.Tensor, num_samples: int = 25):
    """(scored pairs, samples) of one table: each pair of valid peaks is
    sampled at its own n_pts points (the kernel's and the plain version's
    formula)."""
    src, dst = limb_pairs[:, 0].long(), limb_pairs[:, 1].long()
    K = peaks.xy.shape[2]
    vec = peaks.xy[:, dst][:, :, None] - peaks.xy[:, src][:, :, :, None]
    vmax = torch.maximum(vec[..., 0].abs(), vec[..., 1].abs())
    n_pts = torch.clamp(torch.floor(torch.sqrt(5.0 * vmax) + 0.5), 5,
                        num_samples)
    ia = torch.arange(K, device=vec.device)
    cnt = peaks.count.long()
    valid = ((ia[:, None] < cnt[:, src][:, :, None, None])
             & (ia[None, :] < cnt[:, dst][:, :, None, None]))
    return float(valid.sum()), float(torch.where(valid, n_pts, 0.0).sum())


def association_inputs(gen: torch.Generator, B: int, K: int, dev,
                       h: int = 128, w: int = 208):
    """Peaks, a score table and a root-depth map with what kernel B must
    get right: tables quantized to 0.1 (ties), NaN entries, -1 rows,
    joints with no peaks, an image with no root, tied and NaN root depths,
    -0 and +0 depths, dst peaks on their src (limb distance 0)."""
    peaks = random_peaks(gen, B, 15, K, h, w, torch.device("cpu"))
    xy, score, count = (t.clone() for t in peaks)
    count[1, 2] = 0                                    # no root
    count[2, 9] = 0                                    # an empty joint
    count[3, 0] = 0                                    # flipped limb's dst
    xy[0, 0, :3] = xy[0, 2, :3]                        # dst on its src
    score[0, 3, :2] = 0.0                              # missing src joint
    valid = torch.arange(K)[None, None, :] < count[..., None]
    xy = torch.where(valid[..., None], xy, 0.0)
    score = torch.where(valid, score, 0.0)
    table = torch.round((torch.rand((B, 14, K, K), generator=gen) * 2 - 1)
                        * 10) / 10
    table[torch.rand((B, 14, K, K), generator=gen) < 0.02] = float("nan")
    table[torch.rand((B, 14, K), generator=gen) < 0.1] = -1.0
    rdm = torch.round(torch.rand((B, h, w), generator=gen) * 3) / 2
    rdm[0][torch.rand((h, w), generator=gen) < 0.05] = float("nan")
    rdm[4, : h // 2] = -0.0
    rdm[4, h // 2:] = 0.0
    from smap_tpu_torch.ops.nms import Peaks

    return (Peaks(xy.to(dev), score.to(dev), count.to(dev)), table.to(dev),
            rdm.to(dev))


def check_bodies(got, want, label: str) -> None:
    """Kernel B against the plain association: every output to the bit
    (NaN depths included)."""
    for name in ("joints", "count", "root_depth"):
        a, b = getattr(got, name), getattr(want, name)
        if (a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                a.contiguous().view(torch.int32),
                b.contiguous().view(torch.int32))):
            raise AssertionError(f"associate {label}: {name} differs from "
                                 f"the plain association")


def association_work(peaks) -> tuple:
    """(bytes, operations) of one association: the table rows the persons
    read (n_person x dst count per limb), the peaks, the root depths read,
    the bodies and depths written; ~12 float32 operations per adjusted
    score."""
    from smap_tpu_torch.ops.association import kernel_plan

    B, J, K = peaks.xy.shape[:3]
    steps = kernel_plan(2, 1.2, 4.0, torch.device("cpu")).steps.long()
    cnt = peaks.count.cpu().long().clamp(0, K)
    entries = float((cnt[:, 2:3] * cnt[:, steps[:, 2]]).sum())
    nbytes = (entries * 4 + peaks.xy.numel() * 4 + peaks.score.numel() * 4
              + cnt.numel() * 4 + B * K * 4 + B * K * J * 16 + B * K * 4)
    return nbytes, 12.0 * entries


def phase_kernels(dev, card: str):
    """Kernel A and B against their plain versions; returns the summary
    rows (without launches)."""
    from smap_tpu_torch import golden
    from smap_tpu_torch.config import PAF_VECTOR, PostProcessConfig
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.association import associate
    from smap_tpu_torch.ops.nms import extract_peaks
    from smap_tpu_torch.ops.paf import paf_scores

    post = PostProcessConfig()
    default_score = torch.tensor(post.default_nms_threshold + 1e-6,
                                 dtype=torch.float32).item()
    limb_pairs = torch.tensor(PAF_VECTOR, dtype=torch.int32, device=dev)
    gen = torch.Generator().manual_seed(0)
    H, W, L, J = 128, 208, 14, 15
    rows = {}

    # Kernels A and B on the golden scenes (full capacity 127), from the
    # NHWC maps as the decode slices them: channels-last PAFs.
    err_a = 0.0
    for seed, _, _, out2d, _, rd in golden.scene_inputs():
        maps = torch.from_numpy(out2d).to(dev).permute(2, 0, 1)[None]
        peaks = extract_peaks(maps[:, :J] / 255.0, max_peaks=127)
        pafs = maps[:, J:] / 127.0
        tk = paf_scores(pafs, peaks, limb_pairs)
        tp = paf_scores(pafs, peaks, limb_pairs, plain=True)
        torch.cuda.synchronize()
        err_a = max(err_a, check_paf(tk, tp, default_score,
                                     f"scene {seed}"))
        rdm = torch.from_numpy(rd).to(dev)[None, ..., 0]
        check_bodies(associate(peaks, tp, rdm),
                     associate(peaks, tp, rdm, plain=True), f"scene {seed}")
    log(f"kernels: paf_score == plain and associate bit-equal to plain on "
        f"the 5 golden scenes (K=127), paf max abs err {err_a:.3g}")

    # Kernel A at the serving shapes: random maps, channels-last as the
    # decode gives them, and random peak tables.
    pafs = (torch.rand((BATCH, 2 * L, H, W), generator=gen) * 2 - 1).to(
        dev).contiguous(memory_format=torch.channels_last)
    times_a, bounds_a = {}, {}
    for K in (40, 127):
        peaks = random_peaks(gen, BATCH, J, K, H, W, dev)
        kernels.reset_launch_counts()
        tk = paf_scores(pafs, peaks, limb_pairs)
        if kernels.LAUNCHES["paf_score"] != 1:
            raise AssertionError("paf_score: channels-last maps did not "
                                 "reach the kernel in one launch")
        tp = paf_scores(pafs, peaks, limb_pairs, plain=True)
        torch.cuda.synchronize()
        err_a = max(err_a, check_paf(tk, tp, default_score,
                                     f"B={BATCH} K={K}"))
        ms = cuda_ms(lambda: paf_scores(pafs, peaks, limb_pairs), 20,
                     ahead=True)
        plain_ms = cuda_ms(lambda: paf_scores(pafs, peaks, limb_pairs,
                                              plain=True), 5)
        times_a[K] = (ms, plain_ms)
        # What this run's peaks need: each scored pair's own n_pts samples
        # of 2 floats (at most the whole maps), the peak tables and the
        # output; 8 operations a sample. PR 3's yardstick counted 25
        # samples for every scored pair.
        pairs, samples = paf_work(peaks, limb_pairs)
        rest = (peaks.xy.numel() * 4 + peaks.count.numel() * 4
                + BATCH * L * K * K * 4)
        bounds_a[K] = bound(ms, min(samples * 8, pafs.numel() * 4) + rest,
                            samples * 8, F32_FLOPS)
        bounds_a[K]["bound_ms_25"] = bound(
            ms, min(pairs * 25 * 8, pafs.numel() * 4) + rest,
            pairs * 25 * 8, F32_FLOPS)["bound_ms"]
        log(f"kernels: paf_score B={BATCH} K={K} L={L} {H}x{W} channels-"
            f"last: {ms:.4f} ms, plain {plain_ms:.4f} ms, max abs err "
            f"{err_a:.3g}; {pairs:.0f} pairs, {samples / pairs:.2f} samples "
            f"a pair; bound {bounds_a[K]['bound_ms']:.4f} ms (25-sample "
            f"yardstick {bounds_a[K]['bound_ms_25']:.4f}) [{card}]")
    rows["paf_score"] = dict(
        name="paf_score_kernel", route="cuda",
        source="smap_tpu_torch/csrc/paf_score.cu",
        replaces="smap_tpu/ops/pallas_kernels.py:62",
        max_abs_err=err_a, ms=times_a[40][0], plain_ms=times_a[40][1],
        **bounds_a[40], library_ms=None, ms_k127=times_a[127][0],
        plain_ms_k127=times_a[127][1],
        bound_ms_k127=bounds_a[127]["bound_ms"],
        bound_ms_25_k127=bounds_a[127]["bound_ms_25"])

    # Kernel B: the whole association, bit-equal to the plain loop.
    times_b = {}
    for K in (8, 40, 127, 128):
        peaks, table, rdm = association_inputs(gen, BATCH, K, dev)
        kernels.reset_launch_counts()
        got = associate(peaks, table, rdm)
        if kernels.LAUNCHES["associate"] != 1:
            raise AssertionError(f"associate K={K}: "
                                 f"{kernels.LAUNCHES['associate']} launches")
        check_bodies(got, associate(peaks, table, rdm, plain=True),
                     f"B={BATCH} K={K}")
        msg = f"kernels: associate B={BATCH} K={K}: bit-equal to plain"
        if K in (40, 127):
            ms = cuda_ms(lambda: associate(peaks, table, rdm), 50,
                         ahead=True)
            plain_ms = cuda_ms(lambda: associate(peaks, table, rdm,
                                                 plain=True), 2)
            nbytes, ops = association_work(peaks)
            times_b[K] = dict(ms=ms, plain_ms=plain_ms,
                              step_us=ms * 1e3 / (4 * K),
                              **bound(ms, nbytes, ops, F32_FLOPS))
            msg += (f"; {ms:.4f} ms ({times_b[K]['step_us']:.3f} us a step "
                    f"of the 4 x K chain), plain {plain_ms:.4f} ms, bound "
                    f"{times_b[K]['bound_ms']:.5f} ms "
                    f"({times_b[K]['bound_kind']}) [{card}]")
        log(msg)
    rows["associate"] = dict(
        name="associate_kernel", route="cuda",
        source="smap_tpu_torch/csrc/associate.cu",
        replaces="smap_tpu/ops/pallas_kernels.py:208", max_abs_err=0.0,
        **times_b[40], library_ms=None,
        **{f"{k}_k127": v for k, v in times_b[127].items()
           if k not in ("bound_by", "bound_kind")})
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
            or kernels.LAUNCHES["associate"] != n):
        raise AssertionError(f"golden decode launches {kernels.LAUNCHES}, "
                             f"want {n} of each of A and B")
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
            "paf_score": n_batches, "associate": n_batches,
            "fused_stem": 0, "fused_bottleneck": 0, "int8_conv": 0}:
        raise AssertionError(f"serving: launches {launches} over "
                             f"{n_batches} batches, want 1 of A and 1 of B "
                             f"per batch")

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


def cudnn_bottleneck(args, dev):
    """The folded-unfused engine's chain for one bottleneck (cuDNN bf16
    convs in channels_last, bias adds, ReLUs, residual add: ``Bottleneck``
    with ``fuse=False``) on the weights of ``block_inputs``; returns a
    callable on the same x."""
    from smap_tpu_torch.models.layers import Bottleneck, to_compute_dtype

    x, w1, b1, w2, b2, w3, b3, *proj = args

    def oihw(w):                       # [in, out] -> [out, in, 1, 1]
        return w.t()[:, :, None, None]

    block = Bottleneck(w1.shape[0], w1.shape[1], 1, bool(proj), quant="folded")
    convs = [(block.conv_bn_relu1, oihw(w1), b1),
             (block.conv_bn_relu2, w2.permute(3, 2, 0, 1), b2),
             (block.conv_bn_relu3, oihw(w3), b3)]
    if proj:
        convs.append((block.downsample, oihw(proj[0]), proj[1]))
    with torch.no_grad():
        for c, w, b in convs:
            c.conv.weight.copy_(w.float())
            c.conv.bias.copy_(b)
    to_compute_dtype(block, dev, torch.bfloat16).eval()
    xc = x.permute(0, 3, 1, 2)         # NHWC memory: channels_last NCHW

    def run():
        with torch.no_grad():
            return block(xc)
    return run


def cudnn_stem(x, k, b, dev):
    """The folded-unfused engine's stem (cuDNN bf16 conv in channels_last,
    bias add, ReLU, ``max_pool_3x3_s2``: ``ResNetTop`` with ``fuse=False``)
    on the same weights; returns a callable on the same x."""
    from smap_tpu_torch.models.layers import to_compute_dtype
    from smap_tpu_torch.models.smap import ResNetTop

    top = ResNetTop(64, quant="folded")
    with torch.no_grad():
        top.conv.conv.weight.copy_(k.float())
        top.conv.conv.bias.copy_(b)
    to_compute_dtype(top, dev, torch.bfloat16).eval()
    xc = x.permute(0, 3, 1, 2)

    def run():
        with torch.no_grad():
            return top(xc)
    return run


def block_work(args):
    """(bytes, bf16 FLOPs) of one bottleneck call: x and the weights in,
    out out; the three (four) products."""
    x, w1, _, w2, _, w3, _, *proj = args
    B, H, W, cin = x.shape
    cm, cout = w1.shape[1], w3.shape[1]
    wbytes = sum(t.numel() * t.element_size() for t in args[1:])
    macs = cin * cm + 9 * cm * cm + cm * cout + (cin * cout if proj else 0)
    return B * H * W * (cin + cout) * 2 + wbytes, 2.0 * B * H * W * macs


def phase_fused_kernels(dev, card: str):
    """Kernels C and D against their plain versions, and in turns with the
    cuDNN bf16 chains; returns the summary rows (without launches)."""
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.fused_block import (fused_bottleneck,
                                                pack_bottleneck_for_kernel)
    from smap_tpu_torch.ops.fused_stem import fused_stem, pack_stem_for_kernel

    gen = torch.Generator().manual_seed(1)
    rows = {}

    # Kernel C at the serving shape and at (2, 30, 50), then a stem whose
    # outputs all relu to 0 (the pool's padding must not win) at both.
    errs = []
    for B, H, W in ((2, 30, 50), (BATCH, 512, 832)):
        x, k, b = stem_inputs(gen, B, H, W, dev)
        err, equal = check_close(fused_stem(x, k, b),
                                 fused_stem(x, k, b, plain=True), STEM_ATOL,
                                 STEM_RTOL, f"fused_stem [{B}, {H}, {W}]")
        errs.append(err)
    packed = pack_stem_for_kernel(k)
    t = in_turns({"ms": lambda: fused_stem(x, k, b, packed=packed),
                  "library_ms": cudnn_stem(x, k, b, dev)}, 20)
    plain_ms = cuda_ms(lambda: fused_stem(x, k, b, plain=True), 5)
    Hc, Wc = (512 + 1) // 2, (832 + 1) // 2
    nbytes = x.numel() * 2 + k.numel() * 2 + 64 * 4 + BATCH * 128 * 208 * 128
    c_bound = bound(t["ms"], nbytes, 2.0 * BATCH * Hc * Wc * 64 * 147,
                    BF16_FLOPS)
    log(f"kernels: fused_stem [{BATCH}, 512, 832, 3] -> 64: max abs err "
        f"{err:.3g}, {equal:.4f} bit-equal; {t['ms']:.4f} ms, cuDNN chain "
        f"{t['library_ms']:.4f} ms (in turns), plain {plain_ms:.4f} ms; "
        f"bound {c_bound['bound_ms']:.4f} ms ({c_bound['bound_kind']}), "
        f"share {c_bound['share']:.3f} [{card}]")
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
        replaces="smap_tpu/ops/fused_stem.py:216", max_abs_err=max(errs),
        ms=t["ms"], plain_ms=plain_ms, **c_bound,
        library_ms=t["library_ms"], bit_equal=equal)
    del x, k, b, xn, kn, bn, got

    # Kernel D: the serving shapes (timed), then ragged ones.
    errs, d = [], {}
    for label, shape, timed in (
            ("layer1_1 256->64->256 identity", (BATCH, 128, 208, 256, 64,
                                                256, False), True),
            ("layer1_0 64->64->256 projection", (BATCH, 128, 208, 64, 64,
                                                 256, True), True),
            ("ragged W=13, H=20", (2, 20, 13, 64, 64, 256, True), False),
            ("H=36 (4 past a tile), W=100", (3, 36, 100, 256, 64, 256,
                                             False), False),
            ("H=8 (one tile row), W=100, batch 1", (1, 8, 100, 256, 64, 256,
                                                    False), False),
            ("280 tiles (not a multiple of 132)", (5, 64, 100, 256, 64, 256,
                                                   False), False),
            ("batch 1 projection", (1, 128, 208, 64, 64, 256, True), False)):
        args = block_inputs(gen, *shape, dev)
        err, equal = check_close(fused_bottleneck(*args),
                                 fused_bottleneck(*args, plain=True),
                                 BLOCK_ATOL, BLOCK_RTOL,
                                 f"fused_bottleneck {label}")
        errs.append(err)
        msg = (f"kernels: fused_bottleneck {label} {list(shape[:3])}: max "
               f"abs err {err:.3g}, {equal:.4f} bit-equal")
        if timed:
            packed = pack_bottleneck_for_kernel(*args[1:])
            t = in_turns({"ms": lambda: fused_bottleneck(*args,
                                                         packed=packed),
                          "library_ms": cudnn_bottleneck(args, dev)}, 20)
            t["plain_ms"] = cuda_ms(lambda: fused_bottleneck(*args,
                                                             plain=True), 5)
            nbytes, flops = block_work(args)
            t.update(bound(t["ms"], nbytes, flops, BF16_FLOPS),
                     bit_equal=equal)
            d[shape[6]] = t
            msg += (f"; {t['ms']:.4f} ms, cuDNN chain {t['library_ms']:.4f} "
                    f"ms (in turns), plain {t['plain_ms']:.4f} ms; bound "
                    f"{t['bound_ms']:.4f} ms ({t['bound_kind']}), share "
                    f"{t['share']:.3f} [{card}]")
        log(msg)
        del args
    rows["fused_bottleneck"] = dict(
        name="fused_bottleneck_kernel", route="cuda",
        source="smap_tpu_torch/csrc/fused_bottleneck.cu",
        replaces="smap_tpu/ops/fused_block.py:117", max_abs_err=max(errs),
        **d[False], **{f"{k}_proj": v for k, v in d[True].items()
                       if k not in ("bound_by", "bound_kind")})
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
    want = {"paf_score": n, "associate": n, "fused_stem": n,
            "fused_bottleneck": 9 * n, "int8_conv": 0}
    if launches != want:
        raise AssertionError(f"folded: launches {launches} over {n} "
                             f"batches, want {want}")
    log(f"folded: launches {launches} over {n} batches (1 stem, 9 "
        f"bottleneck, 1 paf_score, 1 associate per batch)")
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
        f"{len(batches)}, synchronized, in turns): " + ", ".join(
            f"{name} {np.mean(v):.2f}" for name, v in fwd.items())
        + f" [{card}]")
    log(f"folded: folded-fused faster than folded-unfused: "
        f"{np.mean(fwd['folded-fused']) < np.mean(fwd['folded-unfused'])}")

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


def int8_conv_cases(engine, images):
    """One forward of an int8 engine with every conv's input recorded:
    ([(module, input, convs of the forward with this shape)] for each
    distinct conv shape, E launches the forward made)."""
    from smap_tpu_torch.models.layers import Int8Conv
    from smap_tpu_torch.ops import kernels

    cases, seen = {}, []

    def hook(m, args):
        x = args[0]
        key = (tuple(x.shape), tuple(m.kernel_q.shape), m.stride, m.padding,
               m.relu)
        seen.append(key)
        if key not in cases:
            cases[key] = (m, x)

    handles = [m.register_forward_pre_hook(hook)
               for m in engine.model.modules() if isinstance(m, Int8Conv)]
    kernels.reset_launch_counts()
    try:
        engine.forward(images)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    launches = kernels.LAUNCHES["int8_conv"]
    kernels.reset_launch_counts()
    return [(m, x, seen.count(key)) for key, (m, x) in cases.items()], \
        launches


def im2col_int8(x, kh, kw, stride, pad, k):
    """The [M, k] int8 matrix of an NHWC int8 image whose product with
    kernel E's weight rows is the convolution (columns past kh kw Cin
    zero): the library yardstick's input."""
    import torch.nn.functional as F

    B, H, W, C = x.shape
    ho = (H + 2 * pad - kh) // stride + 1
    wo = (W + 2 * pad - kw) // stride + 1
    xp = F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x
    sb, sh, sw, _ = xp.stride()
    a = xp.as_strided((B, ho, wo, kh, kw, C),
                      (sb, stride * sh, stride * sw, sh, sw, 1))
    a = a.reshape(B * ho * wo, kh * kw * C)
    return F.pad(a, (0, k - a.shape[1])) if k > a.shape[1] else a


def check_int8_case(m, x, label):
    """Kernel E on one conv's own input x (bf16, quantized by E) and
    weights (the act_scale of a static engine) against its plain version,
    bit for bit; and the library yardstick's integer product against the
    exact one. Returns the timing closures (E; the earlier chain: the plain
    quantize, then E's int8 instance; cuBLASLt's int8 product on the
    quantized input; the cuDNN bf16 conv + bias), the plain version and the
    bound's (bytes, operations)."""
    import torch.nn.functional as F

    from smap_tpu_torch.ops.int8_conv import (CIN_ALIGN, int8_conv2d,
                                              int8_conv2d_plain,
                                              int8_weight_rows,
                                              pack_int8_weights,
                                              quantize_activation)

    s_x = m.act_scale
    packed = pack_int8_weights(m.kernel_q)
    args = (m.kernel_q, m.kernel_scale, s_x, m.bias, m.stride, m.padding,
            m.relu, m.out_dtype)
    got = int8_conv2d(x, *args, packed=packed)
    xq = quantize_activation(x, s_x)
    want = int8_conv2d_plain(xq, *args)
    cout, cin, kh, kw = m.kernel_q.shape
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    if not (got.shape == want.shape and torch.equal(
            got.contiguous().view(view), want.contiguous().view(view))):
        raise AssertionError(f"int8_conv {label}: kernel E differs from its "
                             f"plain version")
    if not torch.equal(int8_conv2d(xq, *args, packed=packed), got):
        raise AssertionError(f"int8_conv {label}: E's int8 instance differs "
                             f"from E on the bf16 input")
    x_nhwc = xq.permute(0, 2, 3, 1)
    if cin % CIN_ALIGN:
        x_nhwc = F.pad(x_nhwc, (0, CIN_ALIGN - cin % CIN_ALIGN))
    x_nhwc = x_nhwc.contiguous()
    rows = int8_weight_rows(m.kernel_q)
    n8 = -(-cout // 8) * 8                          # cuBLASLt: N % 8 == 0
    b = F.pad(rows, (0, 0, 0, n8 - cout)).t()       # [K, N], column-major
    kpad = rows.shape[1]

    def library():
        return torch._int_mm(im2col_int8(x_nhwc, kh, kw, m.stride, m.padding,
                                         kpad), b)

    exact = F.conv2d(xq.double(), m.kernel_q.double(), None, m.stride,
                     m.padding).round().to(torch.int32)
    lib = library()[:, :cout].reshape(exact.shape[0], exact.shape[2],
                                      exact.shape[3], cout)
    if not torch.equal(lib, exact.permute(0, 2, 3, 1)):
        raise AssertionError(f"int8_conv {label}: the library yardstick "
                             f"computes another product")
    w16 = (m.kernel_q.float() * m.kernel_scale[:, None, None, None]).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b16 = m.bias.to(torch.bfloat16)[:, None, None]
    x16 = x.to(torch.bfloat16)
    fns = {
        "ms": lambda: int8_conv2d(x, *args, packed=packed),
        "chain_ms": lambda: int8_conv2d(quantize_activation(x, s_x), *args,
                                        packed=packed),
        "library_ms": library,
        "cudnn_bf16_ms": lambda: F.conv2d(x16, w16, None, m.stride,
                                          m.padding).add_(b16)}
    n_out = got.numel()
    nbytes = (x.numel() * x.element_size() + cout * kh * kw * cin
              + n_out * got.element_size() + 2 * cout * 4)
    ops = 2.0 * n_out * kh * kw * cin
    plain = (lambda: int8_conv2d_plain(quantize_activation(x, s_x), *args))
    return fns, plain, nbytes, ops


def int8_ragged_cases(gen, dev):
    """Kernel E bit-equal to its plain version off the forward's shapes:
    odd H and W, Cin 3 and 8, Cout 1, 14, 43 and 300, stride 2, float32
    out; int8 inputs (E's int8 instance) and bf16 inputs quantized by E
    with a scale that clips and makes ties of x / s_x."""
    from smap_tpu_torch.ops.int8_conv import (int8_conv2d, int8_conv2d_plain,
                                              quantize_activation)

    shapes = [(3, 15, 11, 3, 14, 7, 2, 3, True, torch.float32),
              (1, 13, 17, 8, 43, 3, 1, 1, False, torch.float32),
              (2, 9, 7, 64, 1, 1, 2, 0, False, torch.bfloat16),
              (2, 31, 45, 256, 1, 3, 2, 1, True, torch.bfloat16),
              (1, 5, 5, 2048, 43, 3, 1, 1, False, torch.bfloat16),
              (2, 16, 26, 256, 300, 1, 2, 0, False, torch.bfloat16)]
    n = 0
    for in_dtype in (torch.int8, torch.bfloat16):
        for B, H, W, cin, cout, k, stride, pad, relu, dtype in shapes:
            if in_dtype == torch.int8:
                s_x = torch.tensor(0.0371, device=dev)
                x = torch.randint(-127, 128, (B, cin, H, W), generator=gen,
                                  dtype=torch.int8)
            else:
                # (j + 1/2) 15/512 are ties of x / s_x (exact in bf16 for
                # |j| <= 8); randn * 2 past 127 s_x clips.
                s_x = torch.tensor(15.0 / 512.0, device=dev)
                x = torch.randn((B, cin, H, W), generator=gen) * 2.0
                ties = (torch.randint(-9, 9, x.shape, generator=gen)
                        + 0.5) * (15.0 / 512.0)
                x = torch.where(torch.rand(x.shape, generator=gen) < 0.25,
                                ties, x).to(in_dtype)
            x = x.to(dev).contiguous(memory_format=torch.channels_last)
            wq = torch.randint(-127, 128, (cout, cin, k, k), generator=gen,
                               dtype=torch.int8).to(dev)
            args = (wq, (torch.rand(cout, generator=gen) * 1e-3).to(dev),
                    s_x, torch.randn(cout, generator=gen).to(dev), stride,
                    pad, relu, dtype)
            xq = x if in_dtype == torch.int8 else quantize_activation(x, s_x)
            got, want = int8_conv2d(x, *args), int8_conv2d_plain(xq, *args)
            view = torch.int16 if dtype == torch.bfloat16 else torch.int32
            if not torch.equal(got.contiguous().view(view),
                               want.contiguous().view(view)):
                raise AssertionError(
                    f"int8_conv ragged {in_dtype} [{B}, {H}, {W}, {cin}] -> "
                    f"{cout} k{k}/{stride}: differs")
            n += 1
    return n


def corr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.corrcoef(torch.stack([a.flatten().double(),
                                             b.flatten().double()]))[0, 1])


def phase_int8_serving(dev, card: str, batches):
    """int8 serving: the int8-static engine calibrated on the first serving
    batch (the main path: run_batch over the frames, counted), kernel E
    against its plain version on the forward's own bf16 input at every
    conv shape of its forward and at ragged ones, each shape timed in turns
    with the plain quantize + E's int8 instance (``chain_ms``), cuBLASLt's
    int8 product on the quantized input (``library_ms``) and the cuDNN bf16
    conv + bias; the forwards in turns
    with the int8-dynamic, folded-fused and unfolded engines; the maps'
    distance to a float32 forward; the capacity ladder against the
    full-capacity decode. Returns (E's summary row, launches)."""
    import dataclasses

    from smap_tpu_torch import golden
    from smap_tpu_torch.config import Config
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.runtime import no_tf32

    cfg = Config()
    sd = perturbed_state_dict(cfg.model, seed=0)
    t0 = time.perf_counter()
    static = SMAPInference(sd, cfg, device=dev, quantized="static",
                           calibration_batches=batches[0][0])
    log(f"int8: static engine up, calibrated on one batch of {BATCH}, in "
        f"{time.perf_counter() - t0:.2f} s")

    # The main path: int8-static run_batch calls, counted.
    for frames, scales in batches[:2]:                      # warm-up
        static.results_to_pairs(static.run_batch(frames, scales),
                                [""] * BATCH)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    people = 0
    for frames, scales in batches:
        pairs = static.results_to_pairs(static.run_batch(frames, scales),
                                        [""] * BATCH)
        people += sum(len(p["pred_3d"]) for p in pairs)
    t_batch = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n = len(batches)
    per_forward = sum(k.endswith("act_scale")
                      for k in static.model.state_dict())
    want = {"paf_score": n, "associate": n, "fused_stem": 0,
            "fused_bottleneck": 0, "int8_conv": per_forward * n}
    if launches != want:
        raise AssertionError(f"int8: launches {launches} over {n} batches, "
                             f"want {want}")
    log(f"int8: launches {launches} over {n} batches ({per_forward} E, 1 "
        f"paf_score, 1 associate per batch)")
    log(f"int8: int8-static run_batch e2e {n * BATCH / t_batch:.1f} img/s, "
        f"{people} people decoded in {n} batches [{card}]")
    stage = [static.run_batch_timed(*b)[1] for b in batches]
    log("int8: int8-static run_batch_timed per batch (mean of "
        f"{len(stage)}): " + ", ".join(
            f"{k} {np.mean([t[k] for t in stage]):.2f}" for k in stage[0])
        + f" [{card}]")

    # Kernel E at every conv shape of the forward, on the forward's own
    # inputs and weights, then ragged shapes.
    images = static.to_device(batches[0][0])
    cases, e_forward = int8_conv_cases(static, images)
    if e_forward != per_forward:
        raise AssertionError(f"int8: {e_forward} E launches in a forward, "
                             f"{per_forward} convs with a scale")
    n_ragged = int8_ragged_cases(torch.Generator().manual_seed(7), dev)
    log(f"int8: kernel E bit-equal to its plain version on the forward's "
        f"own bf16 conv inputs at its {len(cases)} conv shapes "
        f"({e_forward} convs), its int8 instance equal to it, and at "
        f"{n_ragged} ragged cases (int8 and bf16 inputs); the library "
        f"yardstick's int32 product equal to the exact one")
    keys = ("ms", "chain_ms", "library_ms", "cudnn_bf16_ms", "plain_ms",
            "bound_ms")
    total = dict.fromkeys(keys, 0.0)
    shapes = []
    for m, x, count in cases:
        label = (f"{list(x.shape)} -> {m.kernel_q.shape[0]} "
                 f"k{m.kernel_q.shape[2]}/{m.stride}")
        fns, plain, nbytes, ops = check_int8_case(m, x, label)
        t = in_turns(fns, 10, ahead=True)
        t["plain_ms"] = cuda_ms(plain, 2)
        t.update(bound(t["ms"], nbytes, ops, INT8_OPS))
        for k in keys:
            total[k] += count * t[k]
        shapes.append(dict(shape=label, convs=count, **{
            k: t[k] for k in keys + ("bound_by", "share")}))
        log(f"int8: E {label} x{count}: {t['ms']:.4f} ms, quantize + E "
            f"int8 {t['chain_ms']:.4f}, cuBLASLt int8 "
            f"{t['library_ms']:.4f}, cuDNN bf16 {t['cudnn_bf16_ms']:.4f}, "
            f"plain {t['plain_ms']:.4f}; bound {t['bound_ms']:.4f} "
            f"({t['bound_kind']}), share {t['share']:.3f} [{card}]")
        del fns, plain
    log(f"int8: E over one forward ({e_forward} convs): {total['ms']:.3f} "
        f"ms, quantize + E int8 {total['chain_ms']:.3f}, cuBLASLt int8 "
        f"{total['library_ms']:.3f}, cuDNN bf16 "
        f"{total['cudnn_bf16_ms']:.3f}, bound {total['bound_ms']:.3f}, "
        f"share {total['bound_ms'] / total['ms']:.3f} [{card}]")
    row = dict(
        name="int8_conv_kernel", route="cuda",
        source="smap_tpu_torch/csrc/int8_conv.cu",
        replaces="none: the JAX package's int8 conv is XLA's, "
                 "smap_tpu/models/layers.py:195",
        max_abs_err=0.0, ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"],
        bound_by=("bytes" if sum(s["bound_by"] == "bytes" for s in shapes)
                  * 2 > len(shapes) else "operations"),
        bound_kind="per shape", share=total["bound_ms"] / total["ms"],
        library_ms=total["library_ms"], chain_ms=total["chain_ms"],
        cudnn_bf16_ms=total["cudnn_bf16_ms"], per="forward of 16 images",
        shapes=shapes)
    del cases

    # Forwards in turns, and the distance to a float32 forward.
    engines = {
        "int8-static": static,
        "int8-dynamic": SMAPInference(sd, cfg, device=dev, quantized=True),
        "folded-fused": SMAPInference(sd, cfg, device=dev,
                                      quantized="folded", fuse_stem=True,
                                      fuse_bottleneck=True),
        "unfolded": SMAPInference(sd, cfg, device=dev)}
    for e in engines.values():
        e.forward(images)
    torch.cuda.synchronize()
    fwd = {name: [] for name in engines}
    for frames, _ in batches:
        for name, e in engines.items():
            t0 = time.perf_counter()
            e.forward(e.to_device(frames))
            torch.cuda.synchronize()
            fwd[name].append((time.perf_counter() - t0) * 1e3)
    log(f"int8: forward ms per batch of {BATCH} (mean of {len(batches)}, "
        f"synchronized, in turns): " + ", ".join(
            f"{name} {np.mean(v):.2f}" for name, v in fwd.items())
        + f" [{card}]")
    truth_engine = SMAPInference(sd, dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32")),
        device=dev)
    with no_tf32():
        truth = truth_engine.forward(images)
    del truth_engine
    maps = {name: e.forward(images) for name, e in engines.items()}
    for i, name in enumerate(("2d", "rel-depth", "root-depth")):
        errs = {k: rel_err(v[i], truth[i]) for k, v in maps.items()}
        c = {k: corr(v[i], truth[i]) for k, v in maps.items()
             if k.startswith("int8")}
        for k in c:
            if not (bool(torch.isfinite(maps[k][i]).all())
                    and errs[k] < INT8_REL[i] and c[k] > INT8_CORR):
                raise AssertionError(
                    f"int8: {k} {name} map: rms_rel {errs[k]} (gate "
                    f"{INT8_REL[i]}), corr {c[k]} (gate {INT8_CORR})")
        log(f"int8: {name} map vs float32: rms_rel " + ", ".join(
            f"{k} {v:.4g}" for k, v in errs.items()) + "; corr " + ", ".join(
            f"{k} {v:.6f}" for k, v in c.items())
            + f" (gates {INT8_REL[i]}, {INT8_CORR})")
    del maps, engines

    # The capacity ladder against the full-capacity decode: the serving
    # frames (a crowd: every batch past the top rung), then the golden
    # scenes' maps (a few people: the lowest rung).
    ladder = SMAPInference(static.model.state_dict(), static.cfg,
                           device=dev, adaptive_capacities=LADDER)
    full = static.cfg.post.max_peaks

    def same(got, want, label):
        for i, k in enumerate(want.count.tolist()):
            if int(got.count[i]) != k or not all(
                    torch.equal(a[i, :k], b[i, :k])
                    for a, b in zip(got[:3], want[:3])):
                raise AssertionError(f"int8: ladder {label} image {i} "
                                     f"differs from the full-capacity "
                                     f"decode")

    refs = []
    for j, (frames, scales) in enumerate(batches):
        images, info = ladder.place(frames, scales)
        refs.append(ladder.postprocess(ladder.forward(images), info,
                                       capacity=full))
        same(ladder.run_batch(frames, scales), refs[-1], f"batch {j}")
    for j, res in enumerate(ladder.run_stream(batches)):
        same(res, refs[j], f"stream batch {j}")
    scene = list(golden.scene_inputs())
    info = ladder.scale_info([{"scale": min(832 / 1920, 512 / 1080),
                               "img_width": 1920.0, "img_height": 1080.0,
                               "f_x": K[0, 0], "f_y": K[1, 1], "cx": K[0, 2],
                               "cy": K[1, 2]} for _, _, K, _, _, _ in scene])
    scene_maps = tuple(torch.from_numpy(np.stack(m)).to(dev) for m in zip(
        *[(o, z, r) for _, _, _, o, z, r in scene]))
    for j in range(3):
        item = ladder._ladder_dispatch(scene_maps, info)
        same(ladder._ladder_resolve(*item),
             ladder.postprocess(scene_maps, info, capacity=full),
             f"scenes {j}")
    if ladder._spec_cap != LADDER[0]:
        raise AssertionError(f"int8: ladder rung {ladder._spec_cap} on the "
                             f"golden scenes, want {LADDER[0]}")
    log(f"int8: ladder {LADDER} equal to the full-capacity ({full}) decode "
        f"on {len(batches)} crowd batches (run_batch and run_stream) and on "
        f"the golden scenes at rung {ladder._spec_cap}; counts "
        f"{[int(c) for c in refs[0].count[:4]]}... / scenes "
        f"{ladder.postprocess(scene_maps, info).count.tolist()}")
    return row, launches


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
    for key in ("paf_score", "associate"):
        rows[key]["launches"] = launches[key]
        rows[key]["launches_per_forward"] = launches[key] / (
            TIMED_BATCHES + STREAM_BATCHES)
    fused_rows = phase_fused_kernels(dev, card)
    launches = phase_folded_serving(dev, card, batches)
    for key, row in fused_rows.items():
        row["launches"] = launches[key]
        row["launches_per_forward"] = launches[key] / len(batches)
    rows.update(fused_rows)
    int8_row, launches = phase_int8_serving(dev, card, batches)
    int8_row["launches"] = launches["int8_conv"]
    int8_row["launches_per_forward"] = launches["int8_conv"] / len(batches)
    rows["int8_conv"] = int8_row
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_per_forward", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "bound_kind", "share", "library_ms")
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

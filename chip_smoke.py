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


def phase_serving(dev, card: str):
    from smap_tpu_torch.config import Config
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.smap import init_smap
    from smap_tpu_torch.ops import kernels

    cfg = Config()
    t0 = time.perf_counter()
    engine = SMAPInference(init_smap(cfg.model, seed=0).state_dict(), cfg,
                           device=dev)
    net_h, net_w = cfg.input_shape
    rng = np.random.RandomState(0)
    batches = [letterboxed_frames(rng, BATCH, net_h, net_w)
               for _ in range(TIMED_BATCHES)]
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
            "paf_score": n_batches, "associate_limb": 14 * n_batches}:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs "
              "a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
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
    launches = phase_serving(dev, card)
    for key, row in rows.items():
        row["launches"] = launches[key]
    summary = [{k: row[k] for k in ("name", "route", "source", "replaces",
                                    "launches", "max_abs_err", "ms",
                                    "plain_ms", "ms_k127", "plain_ms_k127")}
               for row in rows.values()]
    log(json.dumps({"kernels": summary}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

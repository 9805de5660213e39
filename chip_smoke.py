#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, data-parallel and
evaluation paths, its traces, its tools and its JPEG path once on a CUDA
card.

    python3 chip_smoke.py          # from the repository root, one card
    python3 chip_smoke.py --data-parallel-only   # build and phase 10 alone

Phases (each prints what it measured; any failure raises and the script
exits non-zero with no result line):

1. build: compile ``smap_tpu_torch/csrc/*.cu`` with nvcc for sm_90a and,
   beside it, the native host libraries (``csrc/*.cc``) with g++.
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
   batch, 206 of kernel F, the conv epilogue, per forward), forward / post
   ms, img/s and peak memory; one batch decoded
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
   seeded BatchNorm statistics: 1 stem, 9 bottleneck and 175 F launches
   per forward, 1 A and 1 B per decode; forward ms of the folded-fused,
   folded-unfused (cuDNN) and unfolded engines; the folded-fused maps' distance to a float32 forward
   within 2x the unfolded bf16 engine's + 1e-4; one batch decoded end to
   end.
7. int8 serving: ``SMAPInference(quantized="static")`` calibrated on the
   first batch of phase 4, at full width on its frames: every conv of the
   forward in kernel E, which quantizes its bf16 input itself (206 launches
   a forward, 60 of F for the residual adds and ReLUs, 1 A and 1 B per
   decode); E bit-equal to its plain version on
   the forward's own conv inputs at all its conv shapes and at ragged ones
   (int8 and bf16 inputs, ties of x / s_x, a clipping scale), each shape
   timed in turns with the plain quantize + E's int8 instance, cuBLASLt's
   int8 product after an im2col (``library_ms``) and the cuDNN bf16 conv +
   bias; the int8-static, int8-dynamic, folded-fused and unfolded forwards
   in turns; the int8 maps' distance to a float32 forward within the JAX
   package's int8 gates; the capacity ladder against the full-capacity
   decode.
8. training (no kernel of A-F on its path; the phase checks that none
   launched): ``Trainer.fit`` at full width (``Config()``: 512x832,
   3 stages, bf16 compute on float32 parameters, ``TrainConfig()``) on
   seeded batches of ``TRAIN_BATCH`` (normalized images, 1-6 people a
   sample), ``TRAIN_WARMUP`` steps then ``TRAIN_STEPS`` timed: each
   step's four losses (finite, total > 0) from ``metrics.jsonl``, ms a
   step, img/s, the label render's ms and peak memory; from one state,
   bf16 steps with and without ``remat`` under PyTorch's deterministic
   algorithms (the same losses, statistics and gradients, lower peak,
   statistics moved once), two bf16 steps without them (their spread) and
   a float32 step (the bf16 gradient's distance to it); one with
   ``grad_accum_steps=2``; a fresh
   ``Trainer`` restored from the checkpoint at step ``TRAIN_WARMUP``
   continuing to the logged loss of the next step; one step of a small
   config (1 stage, 64x96, float32, TF32 off) on the card against the same
   step on the CPU and a float64 CPU step (labels, losses, gradients,
   statistics); ``DESCENT_STEPS`` steps on one batch at 32x48, in float32
   and in bf16 compute (loss first / last > 2 each); ``train_refinenet`` at batch 1024 (the MSE falls,
   ``select_best_epoch`` picks an epoch).
9. entry points, each run as ``python -m smap_tpu_torch.<cli>`` on PNG
   frames of 1080x1920 that this script writes with its own encoder (no
   OpenCV): ``data.image.imread`` reads them back equal (ms a frame, and
   the decode rate of rows filtered Sub, Average and Paeth, unfiltered by
   the native library), letterbox
   and I420 ms a frame; ``serve`` over 32 frames at ``Config()``, batch
   16, with perturbed weights from a ``.pth``, in the default (A, B),
   ``--folded --fuse-stem --fuse-bottleneck`` (C, D) and ``--int8-static``
   (E) modes: its JSON lines equal ``run_batch`` on the same I420 frames,
   its frames/s beside run_batch's, its own launch counts; ``test_smap -t
   generate_result`` / ``generate_train`` equal ``run_labeled_inference``;
   ``train_refinenet`` for one epoch and ``test_refinenet`` on its
   snapshot; ``train_smap --deterministic`` at full width, batch 8, two
   steps and then ``--resume`` for a third with 4 worker processes, the
   losses of ``Trainer.fit`` on the same ``train_iterator`` in this
   process under the same deterministic algorithms;
   ``train_iterator``'s samples/s at 0 and 4 workers.
10. data parallel and evaluation (the backend printed): (a) 2 ranks
   (``spawn``, each with a timeout) train 3 steps at full width, global
   batch 8 (4 a rank), under deterministic algorithms: NCCL with a card a
   rank, or on a host with one card 2 gloo ranks sharing it plus a
   one-rank NCCL group taking the same steps on one rank's share; after
   every step the ranks' losses and parameters are equal; ms a step,
   img/s, peak memory a rank, the gradient bucket's all-reduce ms (and
   ``average_gradients``' with its flatten); a float64 step of the small
   config in 2 ranks against 1 process on the same global batch; (b)
   ``test_smap -t generate_result --distributed`` in 2 processes on phase
   9's labeled frames: A and B launched in each rank, the gathered JSON
   equal to ``run_labeled_inference`` in this process; (c)
   ``SMAPInference(devices=...)`` over every card (two replicas of cuda:0
   on one card) at batch 16, unfolded (A, B), folded-fused (C, D) and
   int8-static (E), equal to one device's ``run_batch`` on the same
   shards, img/s beside one device's; (d) ``eval_mupots`` (relative, ``--absolute``) and
   ``eval_panoptic`` as processes on a MuPoTS-shaped sequence this script
   writes: exact predictions score PCK 100.00, MPJPE 0.0 and ordinal
   1.0000, perturbed ones ``MUPOTS_PINNED`` (tests/test_torch_eval.py
   pins them to the JAX package's scripts).
11. tools and tracing, on what phase 9 left: (a) ``test_smap -t
   run_inference --profile-dir`` as a process on phase 9's frames: one
   Chrome trace whose device kernels count A and B once a batch, as the
   process's ``LAUNCHES`` and the ``annotate`` spans, and F 206 times a
   batch, and the JSON of the run without the flag (process seconds of
   both); (b) one folded-fused ``run_batch`` inside
   ``utils.profiling.trace``: 1 C, 9 D, 175 F, 1 A and 1 B (run_batch ms
   with and without the trace, in turns); (c)
   ``Trainer.fit`` at ``Config()``, batch 8, phase 8's seeded batches,
   deterministic algorithms, 5 steps with a trace of steps 3-4, against
   the untraced run from the same state (twice): losses, weights,
   statistics and Adam bit-equal, checkpoints at 4 and 5, logs at 2, 4 and
   5; ms a step of each run; (d) the native preprocessing
   library built on this machine, its letterbox and normalize on a
   1080x1920 frame within tests/test_native.py's tolerances of the numpy
   path, ms a frame of each; (e) ``convert_checkpoint`` both ways as
   processes: phase 9's ``.pth`` -> a training checkpoint -> a ``.pth``
   with the same tensors bit for bit.
12. JPEG and the native image path (no OpenCV on the card's machine): (a)
   the host libraries of phase 1 loaded (a numpy fallback fails); (b)
   every fixture of ``tests/torch_jpeg/`` decoded by ``data.image.imread``
   to the shape and sha256 that cv2 gave where the fixtures were written
   (``manifest.json``; None where cv2 gave None), ms a 1080x1920 frame;
   (c) on a 1080x1920 frame, the native ``resize_linear`` (letterbox scale,
   0.5), ``warp_affine`` (linear and cubic, on the rotation's canvas and a
   crop) and PNG unfiltering (Average, Paeth) bit-equal to their numpy
   versions, ms of each beside numpy's; (d) ``serve`` over 32 copies of
   the 1080x1920 fixtures at ``Config()``, batch 16, default (A, B) and
   ``--folded --fuse-stem --fuse-bottleneck`` (C, D): its JSON lines equal
   ``run_batch`` on the same decoded frames, its frames/s beside phase 9's
   on PNG, its own launches; (e) ``test_smap -t generate_result`` on 8
   labeled JPEG frames equal to ``run_labeled_inference``; (f)
   ``train_smap --deterministic`` at full width, batch 8, 2 steps on JPEG
   frames, the losses of ``Trainer.fit``; ``train_iterator``'s samples/s
   at 0 and 4 workers beside phase 9's.
13. the conv epilogue (kernel F; run after phase 7, its frames being
   phase 4's): one unfolded, folded-fused and int8-static forward each
   (seeded BatchNorm statistics and biases) with every epilogue recorded
   (206, 175 and 60 launches), each distinct shape and form held to the
   plain chain of ops (bit for bit without BatchNorm; with it one bf16
   ulp apart, more only where its terms cancel, on at most 1e-3 of the
   elements: ``check_epilogue_case``); the unfolded forward's
   shapes (batch 16, 256x416 to 16x26) each timed in turns with the chain,
   beside its bytes bound at 3.35 TB/s, and summed over a forward.

The last lines are the kernels' JSON summary (per kernel: times, launches
in the main path and per forward or batch, launches in the serve CLI's
runs of phases 9 and 12 (``cli_launches``), in phase 10's (b) and (c)
(``dp_launches``) and in phase 11's traces of (a) and (b)
(``trace_launches``: the trace's device kernels; F has no ``cli_launches``
or ``dp_launches``, the CLIs reporting A-E only), the least time the card
could take at its published peaks, ``bound_ms``, with what bounds it and
the share of it reached), the card's name and power limit (nvidia-smi), and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
``smap_tpu_torch`` package beside this file, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

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
# Kernel F (the conv epilogue) against its plain chain: forms without
# BatchNorm round at the same points, so bit for bit; with it the kernel
# runs Flax's arithmetic in float32, PyTorch's BatchNorm its own, which
# lies up to ~250 x 2^-24 of its terms (|(y - mean) * factor| + |shift|)
# from the exact value on an H100: the bf16 results one ulp apart where
# the float32 value lies near a rounding point (1e-6 to 5e-5 of a layer's
# elements), one more of the BatchNorm's value after a residual add, and
# where the terms cancel up to that float32 error (EPILOGUE_BN_TERMS, twice
# it) on a small output (tests/test_torch_conv_epilogue.py).
EPILOGUE_BN_SHARE, EPILOGUE_BN_TERMS = 1e-3, 2.0 ** -15
EPILOGUE_ITERS = 10
# F's launches a forward: every conv of the deployment readout (206);
# folded-fused, less the stem (C) and the 30 convs of D's 9 bottlenecks;
# int8, the 48 bottlenecks' and 9 upsample units' residual adds and the 3
# first units' ReLU after kernel E.
EPILOGUES = {"unfolded": 206, "folded-fused": 175, "int8-static": 60}
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
# Phase 8 (training). Full width: TrainConfig() defaults at batch
# TRAIN_BATCH (four times the reference's 2 a GPU), TRAIN_WARMUP steps
# then TRAIN_STEPS timed.
TRAIN_BATCH = 8
TRAIN_WARMUP = 2
TRAIN_STEPS = 5
# remat against no remat, one bf16 step from the same state with PyTorch's
# deterministic algorithms on, so that every sum has one order: the same
# losses and running statistics (rtol 1e-4) and gradients (1e-6 relative
# in the 2-norm) (training_options).
REMAT_RTOL, REMAT_GRAD = 1e-4, 1e-6
# The bf16 step's gradient against a float32 step from the same state with
# every bottleneck's last BatchNorm scale times 0.1 (where float32 is well
# conditioned): it must point along it; an unrelated gradient of the same
# norm lies ~1.4 away (tests/test_torch_train_bf16.py holds bf16 to the
# JAX package's bf16 on the CPU).
BF16_DAMPED_GRAD = 1.0
# The resumed run's next loss: the same state and batch, the same kernels.
RESUME_RTOL = 1e-4
# Card against CPU (small config, float32, TF32 off). Labels: sums of the
# same terms in the same order, but the PAF means over persons reduce in
# another order (<= 1 ulp at 127). Losses as tests/test_torch_train_step.py
# holds the port to JAX. Gradients and statistics: BatchNorm by the batch
# amplifies float32 rounding ~1e4-fold at these shapes, so both runs are
# held to a float64 CPU step; the card's distance to it may be CARD_NOISE
# times the CPU float32 step's (the JAX package's float32 CPU steps sit
# 2-4x farther than the port's, tests/test_torch_train_step.py).
LABEL_ATOL = 1e-5
CARD_LOSS_RTOL = {"total_loss": 1e-4, "loss_2d": 1e-4, "loss_bone": 1e-4,
                  "loss_root": 1e-2}
CARD_NOISE = 4.0
DESCENT_STEPS = 220
REFINE_PAIRS, REFINE_EPOCHS = 16384, 5
# Phase 9 (entry points), on PNG frames of FRAME_HW: CLI_FRAMES for the
# serve CLI (two batches of BATCH), the first LABELED_FRAMES for test_smap,
# the first TRAIN_FRAMES for train_smap's TRAIN_CLI_STEPS steps.
FRAME_HW = (1080, 1920)
CLI_FRAMES, LABELED_FRAMES, TRAIN_FRAMES = 32, 8, 24
TRAIN_CLI_STEPS = 3
# train_smap --deterministic against Trainer.fit in this process under
# the same deterministic algorithms: the same weights, batches and sums,
# so the same losses (without them the card's backward sums in a
# run-dependent order, and the fresh network moved loss_root of step 2 by
# 12% on an H100; PERF.md section 6).
TRAIN_CLI_RTOL = 1e-6
ITER_BATCHES = 1       # batches timed in train_iterator's rates
CLI_TIMEOUT = 600


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
    epilogues = kernels.EPILOGUE_LAUNCHES
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    n_batches = TIMED_BATCHES + n_stream
    if n_stream != STREAM_BATCHES or launches != {
            "paf_score": n_batches, "associate": n_batches,
            "fused_stem": 0, "fused_bottleneck": 0, "int8_conv": 0}:
        raise AssertionError(f"serving: launches {launches} over "
                             f"{n_batches} batches, want 1 of A and 1 of B "
                             f"per batch")
    check_epilogues(epilogues, "unfolded", n_batches, "serving")

    log(f"serving: forward {np.mean(fwd_ms):.2f} ms, post "
        f"{np.mean(post_ms):.2f} ms per batch of {BATCH} (mean of "
        f"{TIMED_BATCHES}, synchronized) [{card}]")
    log(f"serving: run_batch e2e {TIMED_BATCHES * BATCH / t_batch:.1f} "
        f"img/s, run_stream e2e {STREAM_BATCHES * BATCH / t_stream:.1f} img/s"
        f", {people} people decoded in {TIMED_BATCHES} batches, peak memory "
        f"{peak_mb:.0f} MiB [{card}]")
    log(f"serving: launches {launches} over {n_batches} batches; conv "
        f"epilogue (F) {epilogues}, {EPILOGUES['unfolded']} a forward")

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
    return dict(launches, conv_epilogue=epilogues)


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
    epilogues = kernels.EPILOGUE_LAUNCHES
    n = len(batches)
    want = {"paf_score": n, "associate": n, "fused_stem": n,
            "fused_bottleneck": 9 * n, "int8_conv": 0}
    if launches != want:
        raise AssertionError(f"folded: launches {launches} over {n} "
                             f"batches, want {want}")
    check_epilogues(epilogues, "folded-fused", n, "folded")
    log(f"folded: launches {launches} over {n} batches (1 stem, 9 "
        f"bottleneck, 1 paf_score, 1 associate per batch); conv epilogue "
        f"(F) {epilogues}, {EPILOGUES['folded-fused']} a forward")
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
    return dict(launches, conv_epilogue=epilogues)


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
    epilogues = kernels.EPILOGUE_LAUNCHES
    n = len(batches)
    per_forward = sum(k.endswith("act_scale")
                      for k in static.model.state_dict())
    want = {"paf_score": n, "associate": n, "fused_stem": 0,
            "fused_bottleneck": 0, "int8_conv": per_forward * n}
    if launches != want:
        raise AssertionError(f"int8: launches {launches} over {n} batches, "
                             f"want {want}")
    check_epilogues(epilogues, "int8-static", n, "int8")
    log(f"int8: launches {launches} over {n} batches ({per_forward} E, 1 "
        f"paf_score, 1 associate per batch); conv epilogue (F) "
        f"{epilogues}, {EPILOGUES['int8-static']} a forward")
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
        item = ladder._decode_dispatch([scene_maps], [info])
        same(ladder._resolve(item),
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
    return row, dict(launches, conv_epilogue=epilogues)


def check_epilogues(count: int, mode: str, forwards: int, label: str):
    """Kernel F launched EPILOGUES[mode] times a forward on the main path."""
    if count != EPILOGUES[mode] * forwards:
        raise AssertionError(f"{label}: {count} conv epilogue launches over "
                             f"{forwards} forwards, want "
                             f"{EPILOGUES[mode]} a forward")


def epilogue_cases(engine, images) -> dict:
    """One forward of ``engine`` with every conv epilogue recorded:
    {(shape, bias, bn, residual, relu): [launches of the forward with this
    key, the block, its conv output before the kernel, the residual, the
    per-channel values]}, the first launch of each key kept."""
    from smap_tpu_torch.models.layers import ConvBnRelu
    from smap_tpu_torch.ops import kernels

    cases, block = {}, [None]
    launch = kernels.conv_epilogue

    def record(y, params=None, residual=None, *, bias, bn, relu):
        key = (tuple(y.shape), bias, bn, residual is not None, relu)
        if key not in cases:
            cases[key] = [0, block[0], y.clone(),
                          None if residual is None else residual.clone(),
                          params]
        cases[key][0] += 1
        return launch(y, params, residual, bias=bias, bn=bn, relu=relu)

    handles = [m.register_forward_pre_hook(
        lambda m, args: block.__setitem__(0, m))
        for m in engine.model.modules() if isinstance(m, ConvBnRelu)]
    kernels.conv_epilogue = record
    try:
        engine.forward(images)
        torch.cuda.synchronize()
    finally:
        kernels.conv_epilogue = launch
        for h in handles:
            h.remove()
    return cases


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def check_epilogue_case(key, case, label: str) -> tuple:
    """Kernel F against its plain chain on a recorded case: bit for bit
    without BatchNorm; with it at most one bf16 ulp of the output apart
    (plus one of the BatchNorm's value where a residual is added after it,
    and EPILOGUE_BN_TERMS of its terms where they cancel), on at most
    EPILOGUE_BN_SHARE of the elements. Returns (max abs err, share of
    elements apart, the chain's arguments)."""
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.conv_epilogue import conv_epilogue_plain

    _, bias, bn, _, relu = key
    _, m, y, r, params = case
    plain_args = (m.conv.bias.to(y.dtype) if bias else None,
                  m.bn if bn else None, r, relu)
    with torch.no_grad():
        got = kernels.conv_epilogue(y.clone(), params, r, bias=bias, bn=bn,
                                    relu=relu)
        want = conv_epilogue_plain(y.clone(), *plain_args)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    share = float((diff > 0).float().mean())
    if not bn:
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: kernel F differs from its plain "
                                 f"chain at {key} on {share:.2e} of the "
                                 f"elements")
        return 0.0, 0.0, plain_args
    with torch.no_grad():
        yb = kernels.conv_epilogue(y.clone(), params, bias=True, bn=False,
                                   relu=False).float()
        value = kernels.conv_epilogue(y.clone(), params, bias=True, bn=True,
                                      relu=False)
    p = params[:, :, None, None]
    terms = ((yb - p[1]) * p[2]).abs() + p[3].abs()
    bound = (bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
             + EPILOGUE_BN_TERMS * terms)
    if r is not None:
        bound += bf16_ulp(value)
    if not (bool((diff <= bound).all()) and share <= EPILOGUE_BN_SHARE):
        raise AssertionError(f"{label}: kernel F vs its plain chain at {key}"
                             f": max abs err {float(diff.max())}, "
                             f"{float((diff / bound).max()):.3f} of the "
                             f"bound, {share:.2e} of the elements apart")
    return float(diff.max()), share, plain_args


def phase_epilogue(dev, card: str, batches) -> dict:
    """Phase 13: kernel F (the conv epilogue) at the forward's own shapes:
    every epilogue of one unfolded, folded-fused and int8-static forward
    (seeded BatchNorm statistics and biases) recorded, each distinct shape
    and form held to the plain chain; the unfolded ones timed in turns
    with the chain, beside the bytes bound. Returns F's summary row."""
    from smap_tpu_torch.config import Config
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.conv_epilogue import conv_epilogue_plain

    t0 = time.perf_counter()
    cfg = Config()
    sd = perturbed_state_dict(cfg.model, seed=0)
    frames = batches[0][0]
    modes = {"unfolded": {}, "folded-fused": dict(
        quantized="folded", fuse_stem=True, fuse_bottleneck=True),
        "int8-static": dict(quantized="static", calibration_batches=frames)}
    errs, shares, rows = [], [], []
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for mode, kw in modes.items():
        engine = SMAPInference(sd, cfg, device=dev, **kw)
        images = engine.to_device(frames)
        cases = epilogue_cases(engine, images)
        n = sum(c[0] for c in cases.values())
        if n != EPILOGUES[mode]:
            raise AssertionError(f"epilogue: {n} launches in a {mode} "
                                 f"forward, want {EPILOGUES[mode]}")
        for key, case in cases.items():
            err, share, plain_args = check_epilogue_case(key, case,
                                                         f"epilogue {mode}")
            errs.append(err)
            shares.append(share)
            if mode != "unfolded":
                continue
            count, _, y, r, params = case
            _, bias, bn, _, relu = key
            ys, yp = y.clone(), y.clone()
            with torch.no_grad():
                t = in_turns({
                    "kernel": lambda: kernels.conv_epilogue(
                        ys, params, r, bias=bias, bn=bn, relu=relu),
                    "plain": lambda: conv_epilogue_plain(yp, *plain_args)},
                    EPILOGUE_ITERS, ahead=True)
            nbytes = ((2 + (r is not None)) * y.numel() * y.element_size()
                      + (params.numel() * 4 if params is not None else 0))
            b = bound(t["kernel"], nbytes, 0.0, BF16_FLOPS)
            rows.append(dict(shape=list(key[0]), form="+".join(
                name for name, on in zip(("bias", "bn", "residual", "relu"),
                                         key[1:]) if on),
                count=count, ms=t["kernel"], plain_ms=t["plain"],
                bound_ms=b["bound_ms"], share=b["share"],
                apart=share))
            total["ms"] += count * t["kernel"]
            total["plain_ms"] += count * t["plain"]
            total["bound_ms"] += count * b["bound_ms"]
            log(f"epilogue: {key[0]} {rows[-1]['form']} x{count}: kernel "
                f"{t['kernel']:.4f} ms, plain chain {t['plain']:.4f}, bound "
                f"{b['bound_ms']:.4f} (bytes at 3.35 TB/s), share "
                f"{b['share']:.3f}; {share:.2e} of the elements apart from "
                f"the chain [{card}]")
        log(f"epilogue: {mode}: {n} launches a forward, {len(cases)} "
            f"shapes and forms, each held to the plain chain (bit for bit "
            f"without BatchNorm)")
        del engine, cases
    log(f"epilogue: over one unfolded forward ({EPILOGUES['unfolded']} "
        f"launches): kernel {total['ms']:.3f} ms, plain chain "
        f"{total['plain_ms']:.3f}, bound {total['bound_ms']:.3f}, share "
        f"{total['bound_ms'] / total['ms']:.3f}; largest share of elements "
        f"apart with BatchNorm {max(shares):.2e}; phase 13 took "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    return dict(
        name="conv_epilogue_kernel", route="cuda",
        source="smap_tpu_torch/csrc/conv_epilogue.cu",
        replaces="none: XLA fuses the bias, BatchNorm, residual and ReLU "
                 "into each conv, smap_tpu/models/layers.py:219, :253",
        max_abs_err=max(errs), ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"], bound_by="bytes", bound_kind="memory",
        share=total["bound_ms"] / total["ms"],
        library_ms=total["plain_ms"], per="forward of 16 images",
        epilogues_per_forward=dict(EPILOGUES), shapes=rows)


def train_batch(rng: np.random.RandomState, gen: torch.Generator, cfg,
                batch: int, dev):
    """A training batch from seeds, as tests/test_train_step.py's _batch
    builds one: normalized images (made on the card), 1-6 people a sample
    with skeletons on the map (the rest of the ``max_people`` rows
    unlabeled), every channel valid, scale 0.5."""
    from smap_tpu_torch.train.step import TrainBatch

    h, w = cfg.input_shape
    p = cfg.train.max_people
    bodys = np.zeros((batch, p, 15, 11), np.float32)
    bodys[..., 0] = rng.uniform(0, w - 1, bodys.shape[:3])
    bodys[..., 1] = rng.uniform(0, h - 1, bodys.shape[:3])
    bodys[..., 2] = rng.uniform(100, 400, bodys.shape[:3])
    bodys[..., 3] = rng.randint(0, 3, bodys.shape[:3])
    bodys[..., 7] = 1100.0
    people = rng.randint(1, 7, batch)
    bodys[np.arange(p)[None, :] >= people[:, None], :, 3] = 0
    images = torch.randn((batch, h, w, 3), generator=gen, device=dev)
    return TrainBatch(images=images, bodys=torch.from_numpy(bodys).to(dev),
                      valids=torch.ones((batch, 57), device=dev),
                      scales=torch.full((batch,), 0.5, device=dev))


def losses_ok(losses: dict, label: str) -> dict:
    values = {k: float(v) for k, v in losses.items()}
    if not all(np.isfinite(v) for v in values.values()) or not (
            values["total_loss"] > 0):
        raise AssertionError(f"{label}: losses {values}")
    return values


def fmt(values: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in values.items())


def grad_vector(model) -> torch.Tensor:
    return torch.cat([p.grad.double().flatten() for p in model.parameters()])


def stats_vector(model) -> torch.Tensor:
    return torch.cat([v.double().flatten() for k, v in
                      model.state_dict().items() if "running_" in k])


def dist(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in the 2-norm, on the host in float64."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / (b.norm() + 1e-30))


@contextlib.contextmanager
def resize_in_float32(on: bool):
    """The model's bilinear resizes in float32 (forward and backward),
    cast back to the input's dtype, inside the block when ``on``."""
    if not on:
        yield
        return
    import smap_tpu_torch.models.smap as msmap

    plain = msmap.resize_bilinear
    msmap.resize_bilinear = lambda x, hw: plain(x.float(), hw).to(x.dtype)
    try:
        yield
    finally:
        msmap.resize_bilinear = plain


def cuda_peak(fn):
    """(fn()'s result, peak device memory in GB during it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 1e9


def training_full_width(dev, card: str):
    """Trainer.fit at full width: TRAIN_WARMUP steps, then TRAIN_STEPS
    timed; each step's losses from metrics.jsonl. Returns what the option
    checks reuse."""
    import tempfile

    from smap_tpu_torch.config import Config
    from smap_tpu_torch.train.engine import Trainer, TrainerConfig
    from smap_tpu_torch.train.step import render_labels

    cfg = Config()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    rng, gen = np.random.RandomState(0), torch.Generator(dev).manual_seed(0)
    n = TRAIN_WARMUP + TRAIN_STEPS
    batches = [train_batch(rng, gen, cfg, TRAIN_BATCH, dev) for _ in range(n)]
    t0 = time.perf_counter()
    trainer = Trainer(cfg, TrainerConfig(output_dir=out_dir, log_every=1,
                                         seed=0), device=dev)
    state = trainer.init_state(0)
    log(f"training: Trainer up in {time.perf_counter() - t0:.2f} s "
        f"(ModelConfig() {cfg.input_shape[0]}x{cfg.input_shape[1]}, "
        f"{cfg.model.compute_dtype} compute on float32 parameters, "
        f"TrainConfig(), batch {TRAIN_BATCH}, "
        f"{sum(p.numel() for p in state.model.parameters())} parameters)")
    state = trainer.fit(enumerate(batches[:TRAIN_WARMUP]), state=state,
                        max_steps=TRAIN_WARMUP)      # checkpoints at its end
    # The timed steps end with the iterator, before max_steps: no
    # checkpoint inside them. The checkpoint is timed apart.
    t0 = time.perf_counter()
    state, peak = cuda_peak(lambda: trainer.fit(
        ((i, batches[i]) for i in range(TRAIN_WARMUP, n)), state=state,
        max_steps=n + 1))
    ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    t0 = time.perf_counter()
    trainer.ckpt.save(n, state)
    save_ms = (time.perf_counter() - t0) * 1e3
    with open(os.path.join(out_dir, "tb_dir", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if [r["step"] for r in records] != list(range(1, n + 1)):
        raise AssertionError(f"metrics.jsonl steps "
                             f"{[r['step'] for r in records]}")
    for r in records:
        values = losses_ok({k: r[k] for k in ("total_loss", "loss_2d",
                                              "loss_bone", "loss_root")},
                           f"training step {r['step']}")
        log(f"training: step {r['step']}: {fmt(values)}")
    if trainer.ckpt.all_steps() != [TRAIN_WARMUP, n]:
        raise AssertionError(f"checkpoints {trainer.ckpt.all_steps()}")
    trainer.close()
    render_ms = cuda_ms(lambda: render_labels(batches[0], cfg=cfg), 5)
    log(f"training: {ms:.2f} ms a step over {TRAIN_STEPS} steps of "
        f"Trainer.fit (host clock, each step's losses read back), "
        f"{TRAIN_BATCH * 1e3 / ms:.1f} img/s; label render "
        f"{render_ms:.3f} ms a step (CUDA events); checkpoint save "
        f"{save_ms:.0f} ms (torch.save of model, Adam and schedule); peak "
        f"memory {peak:.2f} GB (torch.cuda.max_memory_allocated) [{card}]")
    return cfg, out_dir, batches, state, records


def training_options(dev, card: str, cfg, out_dir, batches, state,
                     records) -> None:
    """remat, accumulation and checkpoint resume at full width."""
    import copy
    import dataclasses

    from smap_tpu_torch.runtime import deterministic_algorithms
    from smap_tpu_torch.train.engine import Trainer, TrainerConfig
    from smap_tpu_torch.train.step import train_step

    # From one state: bf16 steps without and with remat under PyTorch's
    # deterministic algorithms; two bf16 steps with its default kernels
    # (some backward passes sum with atomics, in another order each run,
    # and the freshly initialised network amplifies that) and a float32
    # step (TF32 off). Then bf16 and float32 steps from that state with
    # every bottleneck's last BatchNorm scale times 0.1, where float32 is
    # well conditioned, and the bf16 one once more with the bilinear
    # resizes in float32.
    sd = copy.deepcopy(state.model.state_dict())
    del state
    damped = {k: v * 0.1 if k.endswith("conv_bn_relu3.bn.weight") else v
              for k, v in sd.items()}
    runs = {}
    for key, weights, dtype, remat, det, resize32 in (
            ("plain", sd, "bfloat16", False, True, False),
            ("remat", sd, "bfloat16", True, True, False),
            ("default a", sd, "bfloat16", False, False, False),
            ("default b", sd, "bfloat16", False, False, False),
            ("float32", sd, "float32", False, False, False),
            ("damped bf16", damped, "bfloat16", False, False, False),
            ("damped bf16, resize f32", damped, "bfloat16", False, False,
             True),
            ("damped float32", damped, "float32", False, False, False)):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=dtype, remat=remat))
        trainer = Trainer(c, TrainerConfig(output_dir=out_dir), device=dev)
        st = trainer.init_state(0)
        trainer.close()
        st.model.load_state_dict(weights)
        with deterministic_algorithms(det), resize_in_float32(resize32):
            (st, losses), peak = cuda_peak(
                lambda: train_step(st, batches[0], cfg=c))
        runs[key] = (losses_ok(losses, key), peak, grad_vector(st.model).cpu(),
                     stats_vector(st.model).cpu(),
                     [int(v) - int(sd[k]) for k, v in
                      st.model.state_dict().items() if "num_batches" in k])
        del st
    (l0, p0, g0, s0, _), (l1, p1, g1, s1, tracked) = (runs["plain"],
                                                      runs["remat"])
    loss_d = max(abs(l1[k] - l0[k]) / abs(l0[k]) for k in l0)
    log(f"training: remat (deterministic algorithms): {fmt(l1)} vs "
        f"{fmt(l0)} (max rel {loss_d:.2e}), gradients |d| / |g| "
        f"{dist(g1, g0):.2e}, running statistics {dist(s1, s0):.2e}, "
        f"updates counted {set(tracked)}; peak memory {p1:.2f} GB against "
        f"{p0:.2f} GB without [{card}]")
    lf, gf = runs["float32"][0], runs["float32"][2]
    g32 = runs["damped float32"][2]
    to32 = {k: dist(runs[k][2], g32) for k in ("damped bf16",
                                                "damped bf16, resize f32")}
    log(f"training: gradients |d| / |g|: two bf16 runs with the default "
        f"kernels {dist(runs['default b'][2], runs['default a'][2]):.2e}; "
        f"bf16 (deterministic) against float32 from the same state "
        f"{dist(g0, gf):.2e} (losses rel " + ", ".join(
            f"{k} {abs(l0[k] - lf[k]) / abs(lf[k]):.2e}" for k in lf) +
        f"); damped, bf16 against float32 {to32['damped bf16']:.2e}, with "
        f"the resizes in float32 {to32['damped bf16, resize f32']:.2e} "
        f"[{card}]")
    if not (loss_d < REMAT_RTOL and dist(s1, s0) < REMAT_RTOL
            and dist(g1, g0) <= REMAT_GRAD and set(tracked) == {1}
            and p1 < p0):
        raise AssertionError("remat does not reproduce the step")
    if not to32["damped bf16"] < BF16_DAMPED_GRAD:
        raise AssertionError("the bf16 gradient is not the float32 one's")
    del runs, g0, g1, gf, g32

    # Accumulation: one step of the batch as two microbatches.
    trainer = Trainer(cfg, TrainerConfig(output_dir=out_dir), device=dev)
    st = trainer.init_state(0)
    trainer.close()
    st.model.load_state_dict(sd)
    t0 = time.perf_counter()
    (st, losses), peak = cuda_peak(
        lambda: train_step(st, batches[0], cfg=cfg, accum_steps=2))
    ms = (time.perf_counter() - t0) * 1e3
    values = losses_ok(losses, "accumulation")
    log(f"training: grad_accum_steps=2: {fmt(values)}; {ms:.1f} ms "
        f"(first call), peak memory {peak:.2f} GB [{card}]")
    del st

    # Resume: a fresh Trainer restored at step TRAIN_WARMUP takes the next
    # step to the loss the uninterrupted run logged.
    trainer = Trainer(cfg, TrainerConfig(output_dir=out_dir, log_every=1),
                      device=dev)
    st = trainer.ckpt.restore(trainer.init_state(0), step=TRAIN_WARMUP)
    st = trainer.fit(iter([(TRAIN_WARMUP, batches[TRAIN_WARMUP])]),
                     state=st, max_steps=TRAIN_WARMUP + 1)
    trainer.close()
    with open(os.path.join(out_dir, "tb_dir", "metrics.jsonl")) as f:
        got = json.loads(f.readlines()[-1])
    want = records[TRAIN_WARMUP]
    d = abs(got["total_loss"] - want["total_loss"]) / want["total_loss"]
    log(f"training: resumed at step {TRAIN_WARMUP}, step {got['step']}: "
        f"total_loss {got['total_loss']:.4f} vs {want['total_loss']:.4f} "
        f"uninterrupted (rel {d:.2e})")
    if got["step"] != want["step"] or st.step != TRAIN_WARMUP + 1 or not (
            d < RESUME_RTOL):
        raise AssertionError("the resumed run does not continue the run")


def small_train_cfg(input_shape=(64, 96), **train):
    """One stage, float32 (tests/test_train_step.py's _tiny_cfg), 4 people
    rows."""
    from smap_tpu_torch.config import Config, ModelConfig, TrainConfig

    out = (input_shape[0] // 4, input_shape[1] // 4)
    return Config(model=ModelConfig(stage_num=1, output_shape=out,
                                    compute_dtype="float32"),
                  train=TrainConfig(max_people=4, **train),
                  input_shape=input_shape, output_shape=out)


def training_card_vs_cpu(dev, card: str) -> None:
    """One step of the small config on the card and on the CPU from the
    same weights and batch, TF32 off: labels within LABEL_ATOL; loss,
    gradients and running statistics against a float64 CPU step."""
    from smap_tpu_torch.models.smap import init_smap
    from smap_tpu_torch.train.step import (TrainBatch, create_train_state,
                                           render_labels, train_step,
                                           training_model)

    cfg = small_train_cfg()
    batch = train_batch(np.random.RandomState(1),
                        torch.Generator().manual_seed(1), cfg, 2, "cpu")
    cpu = torch.device("cpu")
    labels = {d: render_labels(TrainBatch(*(x.to(d) for x in batch)),
                               cfg=cfg) for d in (dev, cpu)}
    label_err = max(float((a.cpu() - b).abs().max()) for a, b in
                    zip(labels[dev], labels[cpu]))
    sd = init_smap(cfg.model, seed=2).state_dict()
    got = {}
    for name, d, dtype in (("card", dev, torch.float32),
                           ("cpu", cpu, torch.float32),
                           ("cpu64", cpu, torch.float64)):
        model = init_smap(cfg.model, seed=2)
        model.load_state_dict(sd)
        model = training_model(model, d)
        if dtype == torch.float64:
            model.double().compute_dtype = torch.float64
        st, losses = train_step(create_train_state(model, cfg),
                                TrainBatch(*(x.to(d) for x in batch)),
                                cfg=cfg)
        got[name] = (losses_ok(losses, f"small {name}"),
                     grad_vector(st.model).cpu(), stats_vector(st.model).cpu())
    (lc, gc, sc), (l32, g32, s32), (_, g64, s64) = (
        got["card"], got["cpu"], got["cpu64"])
    loss_d = {k: abs(lc[k] - l32[k]) / abs(l32[k]) for k in lc}
    e = {"gradients": (dist(gc, g64), dist(g32, g64)),
         "statistics": (dist(sc, s64), dist(s32, s64))}
    log(f"training: card vs CPU (1 stage, 64x96, float32, TF32 off): labels "
        f"max |d| {label_err:.2e}; losses rel "
        f"{', '.join(f'{k} {v:.2e}' for k, v in loss_d.items())}; distance "
        f"to the float64 CPU step, card / CPU: " + ", ".join(
            f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in e.items()))
    if not (label_err <= LABEL_ATOL
            and all(v < CARD_LOSS_RTOL[k] for k, v in loss_d.items())
            and all(a <= CARD_NOISE * b + 1e-6 for a, b in e.values())):
        raise AssertionError("the card's step is not the CPU's")


def training_descent(dev, card: str) -> None:
    """DESCENT_STEPS steps on one memorizable batch of 2 at 32x48
    (tests/test_train_step.py's descent test: lr 0.1, warmup 1, constant
    depth), in float32 and in bf16 compute: total_loss first / last > 2
    in each."""
    import dataclasses

    from smap_tpu_torch.models.smap import init_smap
    from smap_tpu_torch.train.step import (create_train_state, train_step,
                                           training_model)

    small = small_train_cfg((32, 48), base_lr=0.1, warmup_iters=1)
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(small, model=dataclasses.replace(
            small.model, compute_dtype=dtype))
        batch = train_batch(np.random.RandomState(3),
                            torch.Generator(dev).manual_seed(3), cfg, 2, dev)
        batch.bodys[..., 2] = 200.0
        st = create_train_state(training_model(init_smap(cfg.model, seed=3),
                                               dev), cfg)
        curve = []
        t0 = time.perf_counter()
        for _ in range(DESCENT_STEPS):
            st, losses = train_step(st, batch, cfg=cfg)
            curve.append(losses)
        curve = [losses_ok(x, f"descent {dtype}") for x in curve]
        dt = (time.perf_counter() - t0) * 1e3 / DESCENT_STEPS
        first, last = curve[0]["total_loss"], curve[-1]["total_loss"]
        log(f"training: descent on one batch, {dtype}, {DESCENT_STEPS} "
            f"steps: total_loss {first:.2f} -> {last:.2f} "
            f"(x{first / last:.2f}); last {fmt(curve[-1])}; {dt:.2f} ms a "
            f"step")
        if not first / last > 2.0:
            raise AssertionError(f"training does not descend in {dtype}")


def training_refinenet(dev, card: str) -> None:
    """train_refinenet on REFINE_PAIRS seeded pairs at batch 1024 for
    REFINE_EPOCHS epochs: the training-set MSE of each epoch's snapshot
    falls, and select_best_epoch picks one of them."""
    import tempfile

    from smap_tpu_torch.config import RefineNetConfig
    from smap_tpu_torch.data.datasets import P2PDataset
    from smap_tpu_torch.train.refine import (pair_arrays,
                                             select_best_epoch,
                                             train_refinenet)

    rng = np.random.RandomState(4)
    gt = rng.randn(REFINE_PAIRS, 15, 3) * 30 + [0.0, 0.0, 400.0]
    pred = np.concatenate([gt + rng.randn(REFINE_PAIRS, 15, 3) * 5,
                           rng.randint(0, 2, (REFINE_PAIRS, 15, 1))], -1)
    pred_2d = gt[..., :2] / gt[..., 2:] * 1000 + 400
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_p2p_"),
                        "pairs.json")
    with open(path, "w") as f:
        json.dump({"3d_pairs": [
            {"pred_3d": p.tolist(), "pred_2d": q.tolist(),
             "gt_3d": g.tolist()} for p, q, g in zip(pred, pred_2d, gt)]}, f)
    dataset = P2PDataset(path)
    cfg = RefineNetConfig(num_epochs=REFINE_EPOCHS)
    lines = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snaps = train_refinenet(dataset, cfg, seed=0, log_fn=lines.append,
                            device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / REFINE_EPOCHS
    inputs, targets = (torch.from_numpy(a).to(dev) for a in pair_arrays(dataset))
    with torch.no_grad():
        mse = [float(((m(inputs) - targets) ** 2).mean())
               for m in snaps.values()]
    best, err = select_best_epoch(snaps, dataset)
    log(f"training: RefineNet, {REFINE_PAIRS} pairs, batch "
        f"{cfg.batch_size}, {REFINE_EPOCHS} epochs ({ms:.1f} ms an epoch): "
        f"training MSE of each epoch's snapshot "
        f"{', '.join(f'{x:.2f}' for x in mse)}; best epoch {best}, mean "
        f"per-joint error {err:.3f} cm")
    if not (mse[-1] < mse[0] and best in snaps and np.isfinite(err)):
        raise AssertionError("RefineNet training does not reduce the MSE")


def phase_training(dev, card: str) -> None:
    """Phase 8: the training path (no kernel of A-F on it)."""
    from smap_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    state_etc = training_full_width(dev, card)
    training_options(dev, card, *state_etc)
    del state_etc
    training_card_vs_cpu(dev, card)
    training_descent(dev, card)
    training_refinenet(dev, card)
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if kernels.EPILOGUE_LAUNCHES:
        launched["conv_epilogue"] = kernels.EPILOGUE_LAUNCHES
    log(f"training: kernels A-F launched by the training phase: "
        f"{launched or 'none'}")
    if launched:
        raise AssertionError("the training path launched a serving kernel")


def filtered_rows(img: np.ndarray, filter_type: int) -> np.ndarray:
    """A BGR uint8 frame's RGB scanlines as PNG filters them, one filter
    type on every row (1 Sub, 2 Up, 3 Average, 4 Paeth, predicted from the
    frame itself): uint8 ``[h, 1 + 3 w]``, each row led by its type."""
    h, w, _ = img.shape
    x = img[..., ::-1].reshape(h, -1).astype(np.int32)
    up = np.vstack([np.zeros((1, x.shape[1]), np.int32), x[:-1]])
    left = np.hstack([np.zeros((h, 3), np.int32), x[:, :-3]])
    if filter_type == 1:
        pred = left
    elif filter_type == 2:
        pred = up
    elif filter_type == 3:
        pred = (left + up) >> 1
    else:
        upleft = np.hstack([np.zeros((h, 3), np.int32), up[:, :-3]])
        pa, pb = np.abs(up - upleft), np.abs(left - upleft)
        pc = np.abs(left + up - 2 * upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    return np.hstack([np.full((h, 1), filter_type, np.int32),
                      (x - pred) & 255]).astype(np.uint8)


def png_bytes(img: np.ndarray, filter_type: int = 2) -> bytes:
    """A BGR uint8 frame as an RGB PNG with one filter type on every row
    (``filtered_rows``), zlib level 1: this script's own writer, with no
    OpenCV."""
    h, w, _ = img.shape
    rows = filtered_rows(img, filter_type)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + chunk(b"IEND", b""))


def cli_frames(n: int, seed: int = 0):
    """``n`` FRAME_HW BGR frames: 8x8 blocks of random colour with +-2 of
    noise."""
    rng = np.random.RandomState(seed)
    h, w = FRAME_HW
    frames = []
    for _ in range(n):
        base = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3))
        img = np.repeat(np.repeat(base, 8, 0), 8, 1)[:h, :w]
        img = img + rng.randint(-2, 3, img.shape)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def run_cli(module: str, *args: str) -> subprocess.CompletedProcess:
    """``python -m smap_tpu_torch.<module> args`` from the repository root;
    raises with its output unless it exits 0."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", f"smap_tpu_torch.{module}",
                          *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=CLI_TIMEOUT)
    if out.returncode != 0:
        raise AssertionError(f"{module} {' '.join(args)} exited "
                             f"{out.returncode}:\n{out.stdout[-4000:]}\n"
                             f"{out.stderr[-4000:]}")
    out.seconds = time.perf_counter() - t0
    return out


def same_pairs(got, want, label: str) -> float:
    """Pair lists with equal keys, counts, paths and ground truth, and
    predictions within DECODE_ATOL; returns the largest difference."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} items, want {len(want)}")
    err = 0.0
    for g, w in zip(got, want):
        if g.keys() != w.keys():
            raise AssertionError(f"{label}: keys {sorted(g)} vs {sorted(w)}")
        for key in g:
            if key in ("pred_2d", "pred_3d", "root_d"):
                a, b = np.asarray(g[key], float), np.asarray(w[key], float)
                if a.shape != b.shape:
                    raise AssertionError(f"{label}: {key} {a.shape} vs "
                                         f"{b.shape}")
                err = max(err, float(np.abs(a - b).max(initial=0.0)))
            elif g[key] != w[key]:
                raise AssertionError(f"{label}: {key} differs")
    if not err <= DECODE_ATOL:
        raise AssertionError(f"{label}: max abs err {err} > {DECODE_ATOL}")
    return err


def host_pipeline(frames, frame_dir: str, card: str):
    """Writes the frames as PNG, reads them back with ``data.image.imread``
    (equal), letterboxes and packs them; prints each stage's ms a frame,
    and the decode rate of rows filtered Sub, Average and Paeth. Returns
    the paths."""
    from smap_tpu_torch.config import INPUT_SHAPE
    from smap_tpu_torch.data.image import bgr_to_i420, imread
    from smap_tpu_torch.data.preprocess import letterbox_image

    t0 = time.perf_counter()
    paths = []
    for i, img in enumerate(frames):
        paths.append(os.path.join(frame_dir, f"frame{i:03d}.png"))
        with open(paths[-1], "wb") as f:
            f.write(png_bytes(img))
    write_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    t0 = time.perf_counter()
    back = [imread(p) for p in paths]
    read_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    if not all(np.array_equal(a, b) for a, b in zip(back, frames)):
        raise AssertionError("host: imread of the PNG frames differs")
    t0 = time.perf_counter()
    boxed = [letterbox_image(img, INPUT_SHAPE)[0] for img in back]
    box_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    t0 = time.perf_counter()
    for img in boxed:
        bgr_to_i420(img)
    i420_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    mb = frames[0].nbytes / 1e6
    log(f"host: {len(frames)} PNG frames of {FRAME_HW[0]}x{FRAME_HW[1]} "
        f"(rows filtered Up): write {write_ms:.1f} ms a frame, imread "
        f"{read_ms:.1f} ms a frame ({mb * 1e3 / read_ms:.1f} MB/s of "
        f"pixels), equal to the frames; letterbox to {INPUT_SHAPE[0]}x"
        f"{INPUT_SHAPE[1]} (resize_linear) {box_ms:.1f} ms, bgr_to_i420 "
        f"{i420_ms:.2f} ms a frame [{card}]")
    rates = []
    for kind, name in ((1, "Sub"), (3, "Average"), (4, "Paeth")):
        path = os.path.join(frame_dir, f"filter{kind}.png.tmp")
        with open(path, "wb") as f:
            f.write(png_bytes(frames[0], kind))
        os.replace(path, path[:-4])
        t0 = time.perf_counter()
        img = imread(path[:-4])
        ms = (time.perf_counter() - t0) * 1e3
        os.remove(path[:-4])
        if not np.array_equal(img, frames[0]):
            raise AssertionError(f"host: imread of a {name} PNG differs")
        rates.append(f"{name} {ms:.0f} ms ({mb * 1e3 / ms:.2f} MB/s)")
    log(f"host: imread of one frame with every row filtered " +
        ", ".join(rates) + f" [{card}]")
    return paths


def serve_cli_modes(dev, card: str, sd_path: str, sd, frame_dir: str,
                    paths, frames, only=None, fmt: str = "PNG",
                    before=None):
    """The serve CLI in its three modes (or those named in ``only``) on
    the ``fmt`` frames of ``frame_dir`` against run_batch on the same I420
    frames (``frames``: the frames decoded); the CLI's own frames/s (beside
    ``before``'s, by mode) and kernel launches. Returns (the launches
    summed over the modes, frames/s by mode)."""
    from smap_tpu_torch.config import Config
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.serve import wire_frame

    cfg = Config()
    wire = [wire_frame(img, cfg) for img in frames]
    batches = [(np.stack([w[0] for w in wire[s:s + BATCH]]),
                [w[1] for w in wire[s:s + BATCH]])
               for s in range(0, len(wire), BATCH)]
    n_batches = len(batches)
    modes = {
        "default": ([], dict(), {"fused_stem": 0, "fused_bottleneck": 0,
                                 "int8_conv": 0}),
        "folded-fused": (["--folded", "--fuse-stem", "--fuse-bottleneck"],
                         dict(quantized="folded", fuse_stem=True,
                              fuse_bottleneck=True),
                         {"fused_stem": n_batches,
                          "fused_bottleneck": 9 * n_batches,
                          "int8_conv": 0}),
        "int8-static": (["--int8-static", "--calib-dir", frame_dir],
                        dict(quantized="static",
                             calibration_batches=[batches[0][0]]),
                        {"fused_stem": 0, "fused_bottleneck": 0,
                         "int8_conv": 206 * n_batches}),
    }
    total, rates = {}, {}
    for name, (flags, kw, want_launches) in modes.items():
        if only is not None and name not in only:
            continue
        out_path = os.path.join(frame_dir, f"serve_{name}.jsonl")
        out = run_cli("serve", "--source", frame_dir, "-p", sd_path,
                      "--out", out_path, "--batch_size", str(BATCH), *flags)
        summary = json.loads(out.stderr.strip().splitlines()[-1])
        with open(out_path) as f:
            lines = [json.loads(line) for line in f]
        launches = summary["kernel_launches"]
        ok = all(launches[k] == v for k, v in want_launches.items())
        if not (ok and launches["paf_score"] >= n_batches
                and launches["associate"] == launches["paf_score"]):
            raise AssertionError(f"serve {name}: launches {launches}, want "
                                 f"{want_launches} and >= {n_batches} of A "
                                 f"and B")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

        engine = SMAPInference(sd, cfg, device=dev,
                               adaptive_capacities=LADDER, **kw)
        for images, scales in batches[:1]:                    # warm-up
            engine.results_to_pairs(engine.run_batch(images, scales),
                                    [""] * len(scales))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = []
        for i, (images, scales) in enumerate(batches):
            want += engine.results_to_pairs(
                engine.run_batch(images, scales),
                paths[i * BATCH:(i + 1) * BATCH])
        rate = len(wire) / (time.perf_counter() - t0)
        err = same_pairs(lines, json.loads(json.dumps(want)),
                         f"serve {name}")
        people = sum(len(p["pred_3d"]) for p in lines)
        rates[name] = summary["frames_per_s"]
        was = (f" (PNG: {before[name]:.2f})" if before and name in before
               else "")
        log(f"{'entry points' if fmt == 'PNG' else 'jpeg'}: serve {name}: "
            f"{summary['frames']} frames {summary['frames_per_s']:.2f} "
            f"frames/s{was} end to end ({fmt} decode, letterbox, I420, "
            f"serving, JSONL; {out.seconds:.1f} s of process), run_batch on "
            f"its I420 frames {rate:.1f} img/s; {len(lines)} lines equal to "
            f"run_batch's (max abs err {err:.3g}, {people} people); launches "
            f"{launches} [{card}]")
        del engine
    return total, rates


def labeled_annotations(rng: np.random.RandomState, frame_dir: str,
                        ext: str = "png") -> str:
    """Writes ``annot.json`` beside the first LABELED_FRAMES frames
    (``frameNNN.<ext>``), one crafted person each; returns its path."""
    h, w = FRAME_HW
    records = []
    for i in range(LABELED_FRAMES):
        bodys = np.zeros((1, 15, 11))
        bodys[..., 0] = rng.uniform(300, w - 300, 15)
        bodys[..., 1] = rng.uniform(200, h - 200, 15)
        bodys[..., 2] = rng.uniform(300, 600, 15)
        bodys[..., 3] = 2
        bodys[..., 4:7] = rng.randn(1, 15, 3) * 30
        bodys[..., 7:] = [1500.0, 1500.0, w / 2, h / 2]
        records.append({"dataset": "MUPOTS",
                        "img_paths": f"frame{i:03d}.{ext}", "img_height": h,
                        "img_width": w, "isValidation": 1,
                        "bodys": bodys.tolist()})
    annot = os.path.join(frame_dir, "annot.json")
    with open(annot, "w") as f:
        json.dump({"root": records}, f)
    return annot


def generate_cli(engine, sd_path: str, frame_dir: str, annot: str,
                 mode: str, data_mode: str, label: str):
    """``test_smap -t <mode> -d <data_mode>`` as a process on ``annot``'s
    frames against run_labeled_inference with ``engine``; returns its
    pairs."""
    from smap_tpu_torch.config import Config
    from smap_tpu_torch.data.datasets import JointDataset, load_annotations
    from smap_tpu_torch.inference import run_labeled_inference

    out = run_cli("test_smap", "-t", mode, "-d", data_mode, "-p",
                  sd_path, "--test-json", annot, "--test-root",
                  frame_dir, "--batch_size", str(BATCH), "--output-dir",
                  frame_dir)
    path = os.path.join(frame_dir, f"stage3_root2_{mode}_{data_mode}.json")
    with open(path) as f:
        got = json.load(f)
    stage = "generation" if mode == "generate_train" else "test"
    dataset = JointDataset(load_annotations(annot), {"MUPOTS": frame_dir},
                           Config(), stage)
    want = run_labeled_inference(dataset, engine, mode=mode,
                                 batch_size=BATCH)
    err = same_pairs(got["3d_pairs"],
                     json.loads(json.dumps(want["3d_pairs"])),
                     f"test_smap {mode}")
    log(f"{label}: test_smap -t {mode}: {len(got['3d_pairs'])} items equal "
        f"to run_labeled_inference's (max abs err {err:.3g}), "
        f"{out.seconds:.1f} s of process")
    return got["3d_pairs"]


def labeled_cli(dev, card: str, sd_path: str, sd, frame_dir: str,
                frames) -> None:
    """test_smap's generate modes on LABELED_FRAMES of the frames, one
    crafted person each, against run_labeled_inference; then
    train_refinenet for one epoch and test_refinenet on its snapshot."""
    from smap_tpu_torch.config import Config
    from smap_tpu_torch.inference import SMAPInference

    rng = np.random.RandomState(7)
    annot = labeled_annotations(rng, frame_dir)
    engine = SMAPInference(sd, Config(), device=dev)
    pairs = None
    for mode, data_mode in (("generate_result", "test"),
                            ("generate_train", "generation")):
        pairs = generate_cli(engine, sd_path, frame_dir, annot, mode,
                             data_mode, "entry points")


    # RefineNet on crafted pairs (random weights match few roots), after
    # the pairs generate_train wrote.
    gt = rng.randn(REFINE_PAIRS // 8, 15, 3) * 30 + [0.0, 0.0, 400.0]
    pred = np.concatenate([gt + rng.randn(*gt.shape) * 5,
                           np.ones((*gt.shape[:2], 1))], -1)
    pairs = pairs + [{"pred_3d": p.tolist(),
                      "pred_2d": (g[:, :2] / g[:, 2:] * 1000 + 400).tolist(),
                      "gt_3d": g.tolist(), "root_d": 400.0}
                     for p, g in zip(pred, gt)]
    pairs_path = os.path.join(frame_dir, "pairs.json")
    with open(pairs_path, "w") as f:
        json.dump({"3d_pairs": pairs}, f)
    snaps = os.path.join(frame_dir, "refinenet")
    out = run_cli("train_refinenet", "--pairs-json", pairs_path,
                  "--epochs", "1", "--output-dir", snaps)
    if os.listdir(snaps) != ["epoch_0.pth"]:
        raise AssertionError(f"train_refinenet wrote {os.listdir(snaps)}")
    out = run_cli("test_refinenet", "--pairs-json", pairs_path,
                  "--snapshot-dir", snaps)
    best = out.stdout.strip().splitlines()[-1]
    if not best.startswith("best epoch: 0 ("):
        raise AssertionError(f"test_refinenet: {out.stdout}")
    log(f"entry points: train_refinenet, 1 epoch on {len(pairs)} pairs, "
        f"then test_refinenet: {best}")


def train_cli(dev, card: str, frame_dir: str, ext: str = "png",
              resume: bool = True, before=None) -> dict:
    """train_smap --deterministic at full width on TRAIN_FRAMES frames
    (``frameNNN.<ext>``; MuCo and COCO records): TRAIN_CLI_STEPS - 1 steps
    with no worker, then (``resume``) --resume for one more with 4; the
    losses of Trainer.fit on the same train_iterator, in this process,
    under the same deterministic algorithms; train_iterator's samples/s at
    0 and 4 workers (beside ``before``'s). Returns those rates."""
    from smap_tpu_torch.config import Config
    from smap_tpu_torch.data.datasets import (JointDataset, load_annotations,
                                              train_iterator)
    from smap_tpu_torch.runtime import deterministic_algorithms
    from smap_tpu_torch.train.engine import Trainer, TrainerConfig

    cfg = Config()
    rng = np.random.RandomState(8)
    h, w = FRAME_HW
    steps = TRAIN_CLI_STEPS if resume else TRAIN_CLI_STEPS - 1
    label = "entry points" if ext == "png" else "jpeg"
    roots, flags = {}, []
    for name, first, count in (("MUCO", 0, 2 * TRAIN_FRAMES // 3),
                               ("COCO", 2 * TRAIN_FRAMES // 3,
                                TRAIN_FRAMES // 3)):
        records = []
        for i in range(first, first + count):
            people = rng.randint(1, 4)
            bodys = np.zeros((people, 15, 11))
            bodys[..., 0] = rng.uniform(100, w - 100, (people, 15))
            bodys[..., 1] = rng.uniform(100, h - 100, (people, 15))
            bodys[..., 2] = rng.uniform(300, 600, (people, 15))
            bodys[..., 3] = 2
            bodys[..., 4:7] = rng.randn(people, 15, 3) * 30
            bodys[..., 7:] = [1500.0, 1500.0, w / 2, h / 2]
            records.append({"dataset": name,
                            "img_paths": f"frame{i:03d}.{ext}",
                            "img_height": h, "img_width": w,
                            "isValidation": 0, "bodys": bodys.tolist()})
        annot = os.path.join(frame_dir, f"{name.lower()}.json")
        with open(annot, "w") as f:
            json.dump({"root": records}, f)
        roots[name] = frame_dir
        flags += [f"--{name.lower()}-json", annot,
                  f"--{name.lower()}-root", frame_dir]
    out_dir = os.path.join(frame_dir, "train_cli")
    flags += ["--output-dir", out_dir, "--batch-per-device",
              str(TRAIN_BATCH), "--log-every", "1", "--seed", "0",
              "--deterministic"]
    first = run_cli("train_smap", *flags, "--max-steps",
                    str(TRAIN_CLI_STEPS - 1), "--num-workers", "0")
    ckpts = sorted(os.listdir(os.path.join(out_dir, "checkpoints")))
    if ckpts != [f"{TRAIN_CLI_STEPS - 1}.pt"]:
        raise AssertionError(f"train_smap checkpoints {ckpts}")
    if resume:
        second = run_cli("train_smap", *flags, "--max-steps",
                         str(TRAIN_CLI_STEPS), "--num-workers", "4",
                         "--resume")
    with open(os.path.join(out_dir, "tb_dir", "metrics.jsonl")) as f:
        got = [json.loads(line) for line in f]

    records = (load_annotations(os.path.join(frame_dir, "coco.json"))
               + load_annotations(os.path.join(frame_dir, "muco.json")))
    dataset = JointDataset(records, roots, cfg, "train",
                           with_augmentation=True)
    ref_dir = os.path.join(frame_dir, "train_ref")
    trainer = Trainer(cfg, TrainerConfig(output_dir=ref_dir, log_every=1,
                                         seed=0), device=dev)
    batches = train_iterator(dataset, TRAIN_BATCH, steps, seed=0,
                             num_workers=4)
    t0 = time.perf_counter()
    with deterministic_algorithms():
        trainer.fit(batches, state=trainer.init_state(0), max_steps=steps)
    fit_rate = steps * TRAIN_BATCH / (time.perf_counter() - t0)
    batches.close()
    trainer.close()
    with open(os.path.join(ref_dir, "tb_dir", "metrics.jsonl")) as f:
        want = [json.loads(line) for line in f]
    keys = ("total_loss", "loss_2d", "loss_bone", "loss_root")
    want_steps = list(range(1, steps + 1))
    if ([r["step"] for r in got] != want_steps
            or [r["step"] for r in want] != want_steps):
        raise AssertionError(f"train_smap steps {[r['step'] for r in got]}, "
                             f"Trainer.fit {[r['step'] for r in want]}")
    worst = []
    for g, r in zip(got, want):
        rel = max(abs(g[k] - r[k]) / abs(r[k]) for k in keys)
        losses_ok({k: g[k] for k in keys}, f"train_smap step {g['step']}")
        if not rel <= TRAIN_CLI_RTOL:
            raise AssertionError(f"train_smap step {g['step']}: "
                                 f"{ {k: g[k] for k in keys} } vs Trainer.fit "
                                 f"{ {k: r[k] for k in keys} }")
        worst.append(rel)
    then = (f" then --resume to step {TRAIN_CLI_STEPS} with 4 workers "
            f"({second.seconds:.1f} s)" if resume else "")
    log(f"{label}: train_smap --deterministic on {ext.upper()} frames, "
        f"{TRAIN_CLI_STEPS - 1} steps ({first.seconds:.1f} s of process)"
        f"{then}: losses of Trainer.fit on the same train_iterator, largest "
        f"relative difference a step "
        f"{', '.join(f'{x:.2g}' for x in worst)}; Trainer.fit with 4 "
        f"workers {fit_rate:.2f} img/s over {steps} steps [{card}]")

    rates = {}
    for workers in (0, 4):
        it = train_iterator(dataset, TRAIN_BATCH,
                            ITER_BATCHES + bool(workers), seed=1,
                            num_workers=workers)
        if workers:
            next(it)                    # the pool's start-up, untimed
        t0 = time.perf_counter()
        n = sum(1 for _ in it)
        rates[workers] = n * TRAIN_BATCH / (time.perf_counter() - t0)
        it.close()
    from smap_tpu_torch.data.native import native_available

    was = (f" (PNG: {before[0]:.2f} and {before[4]:.2f})" if before
           else "")
    log(f"{label}: train_iterator at {FRAME_HW[0]}x{FRAME_HW[1]} on "
        f"{ext.upper()} frames (imread, rotate, resize, crop, flip, "
        f"normalize; the native libraries: "
        f"{all(native_available(n) for n in ('preprocess', 'image'))}): "
        f"{rates[0]:.2f} samples/s with no worker, {rates[4]:.2f} with "
        f"4{was} (phase 8's Trainer.fit takes {TRAIN_BATCH} a step) "
        f"[{card}]")
    return rates


def phase_entry_points(dev, card: str, tmp: str):
    """Phase 9: the user's entry points as processes, on PNG frames this
    script writes under ``tmp``. Returns the serve CLI's kernel launches
    summed over its three modes, (the weights' path, the weights, the
    frames' directory) for phases 10-12, and the serve CLI's frames/s by
    mode and train_iterator's samples/s by workers for phase 12."""
    from smap_tpu_torch.config import Config

    frames = cli_frames(CLI_FRAMES)
    sd = perturbed_state_dict(Config().model, seed=0)
    frame_dir = os.path.join(tmp, "frames")
    os.makedirs(frame_dir)
    sd_path = os.path.join(tmp, "smap.pth")
    torch.save({"model": sd}, sd_path)
    paths = host_pipeline(frames, frame_dir, card)
    launches, serve_rates = serve_cli_modes(dev, card, sd_path, sd,
                                            frame_dir, paths, frames)
    labeled_cli(dev, card, sd_path, sd, frame_dir, frames)
    iter_rates = train_cli(dev, card, frame_dir)
    return launches, (sd_path, sd, frame_dir), (serve_rates, iter_rates)


# Phase 10 (data parallelism and evaluation). (a) DP_RANKS ranks train
# DP_TRAIN_STEPS steps at full width on the global batch TRAIN_BATCH, under
# deterministic algorithms: NCCL with a card a rank, or gloo ranks sharing
# one card (plus a one-rank NCCL group taking one step) on a host with
# fewer cards. Every rank's process gets DP_TIMEOUT.
DP_RANKS = 2
DP_TRAIN_STEPS = 3
DP_TIMEOUT = 600
# Two ranks against one process at the small config (1 stage, 64x96) in
# float64 on the card: the global statistics come from all-reduced sums
# (mean(x^2) - mean(x)^2) where one process takes cuDNN's two-pass
# variance, and both round the maps to float32 at the model's output.
DP_SMALL_LOSS_RTOL, DP_SMALL_GRAD_TOL = 1e-6, 1e-5
# (b) test_smap -t generate_result in DP_RANKS processes, batch DP_BATCH.
DP_BATCH = 4
# (c) batches of BATCH served by each engine in turn.
SHARD_BATCHES = 2
# (d) a MuPoTS-shaped sequence: TS7 (1920x1080), 4 frames of 3 people, the
# camera below. The perturbed predictions move each joint by
# MUPOTS_NOISE_CM per axis and drop the last person of frame 1.
MUPOTS_TS, MUPOTS_SEED, MUPOTS_NOISE_CM = 7, 0, 5.0
MUPOTS_K = np.array([[1500.0, 0, 960], [0, 1500.0, 540], [0, 0, 1]])
# The lines the eval CLIs print for the perturbed predictions: the JAX
# package's scripts/eval_mupots.py and eval_panoptic.py print the same
# (tests/test_torch_eval.py).
MUPOTS_PINNED = {
    "relative": ["  PCK@150mm  Total:  76.98   AUC  33.15",
                 "  MPJPE: 19381.6 mm",
                 "  undetected people rate: 0.1111"],
    "absolute": ["  PCK@150mm  Total:  83.33   AUC  40.12",
                 "  MPJPE: 19094.1 mm",
                 "  ordinal depth accuracy: 1.0000",
                 "  undetected people rate: 0.1111"],
    "panoptic": ["  detection_rate: 0.8889", "  root_pck15: 0.8750",
                 "  mpjpe_abs_cm: 7.5593", "  mpjpe_rel_cm: 10.5315",
                 "  pck15_abs: 0.9750", "  pck15_rel: 0.7833",
                 "  pair_reversal_rate: 0.0000"],
}
# And for the exact predictions.
MUPOTS_PERFECT = {
    "relative": ["  PCK@150mm  Total: 100.00   AUC  96.77",
                 "  MPJPE: 0.0 mm"],
    "absolute": ["  PCK@150mm  Total: 100.00   AUC  96.77",
                 "  MPJPE: 0.0 mm", "  ordinal depth accuracy: 1.0000"],
    "panoptic": ["  mpjpe_abs_cm: 0.0000", "  pck15_abs: 1.0000",
                 "  pck15_rel: 1.0000"],
}


def mupots_sequence(seq_dir: str, seed: int = MUPOTS_SEED,
                    num_frames: int = 4, num_subjects: int = 3):
    """Writes ``annot.mat`` and ``occlusion.mat`` of a MuPoTS sequence
    (as tests/test_mupots_data.py's ``_write_sequence``): random 3D
    poses in mm, 3 m and more from the camera, one person in four marked
    invalid. Returns (valid, annot2 [2, 15], univ_annot3 [3, 15]) per
    person per frame."""
    import scipy.io as sio

    rng = np.random.RandomState(seed)
    os.makedirs(seq_dir)
    annotations = np.empty((num_frames, num_subjects), object)
    occlusions = np.empty((num_frames, num_subjects), object)
    poses = []
    for i in range(num_frames):
        frame = []
        for k in range(num_subjects):
            valid = 1 if (i + k) % 4 != 3 else 0
            annot3 = rng.randn(3, 17) * 200
            annot3[2] += 3000 + 700 * k
            annot2 = (MUPOTS_K @ (annot3 / annot3[2]))[:2]
            cell = np.zeros((1, 1), dtype=[
                ("annot2", object), ("univ_annot3", object),
                ("annot3", object), ("isValidFrame", object)])
            cell[0, 0]["annot2"] = annot2
            cell[0, 0]["univ_annot3"] = annot3
            cell[0, 0]["annot3"] = annot3
            cell[0, 0]["isValidFrame"] = np.array([[valid]])
            annotations[i, k] = cell
            occlusions[i, k] = np.zeros((17, 1))
            frame.append((valid, annot2[:, :15], annot3[:, :15]))
        poses.append(frame)
    sio.savemat(os.path.join(seq_dir, "annot.mat"),
                {"annotations": annotations})
    sio.savemat(os.path.join(seq_dir, "occlusion.mat"),
                {"occlusion_labels": occlusions})
    return poses


def mupots_result(poses, perturb: bool) -> dict:
    """A ``generate_result`` JSON for the sequence: each valid person's
    prediction in the network's joint order, 2D in the 832x512 letterbox,
    3D in cm, with its ground truth rows ([X, Y, Z, fx, fy, cx, cy] in cm,
    [x, y, Z, v]); exact, or ``perturb``-ed by seeded noise with one person
    undetected."""
    from smap_tpu_torch.evaluation.mupots import MPI_TEST_ORDER

    rng = np.random.RandomState(MUPOTS_SEED + 1)
    inv = np.argsort(np.asarray(MPI_TEST_ORDER))
    scale = min(832 / 1920, 512 / 1080)
    pad_y = (512 - 1080 * scale) // 2
    intrinsics = [MUPOTS_K[0, 0], MUPOTS_K[1, 1], MUPOTS_K[0, 2],
                  MUPOTS_K[1, 2]]
    pairs = []
    for i, frame in enumerate(poses):
        valid = [p for p in frame if p[0]]
        gt3, gt2, pred2, pred3 = [], [], [], []
        for n, (_, _, a3) in enumerate(valid):
            gt_cm = a3.T / 10.0                       # [15, 3], test order
            uv = (MUPOTS_K @ (gt_cm.T / gt_cm.T[2])).T
            gt3.append(np.concatenate(
                [gt_cm, np.tile(intrinsics, (15, 1))], -1)[inv])
            gt2.append(np.concatenate(
                [uv[:, :2], gt_cm[:, 2:], np.full((15, 1), 2.0)], -1)[inv])
            if perturb and i == 1 and n == len(valid) - 1:
                continue                              # undetected
            p_cm = gt_cm + (rng.randn(15, 3) * MUPOTS_NOISE_CM if perturb
                            else 0.0)
            uv = (MUPOTS_K @ (p_cm.T / p_cm.T[2])).T
            body2 = np.zeros((15, 4))
            body2[:, 0] = uv[:, 0] * scale
            body2[:, 1] = uv[:, 1] * scale + pad_y
            body2[:, 3] = 1
            body3 = np.concatenate([p_cm, np.ones((15, 1))], -1)
            pred2.append(body2[inv])
            pred3.append(body3[inv])
        pairs.append({"pred_2d": np.asarray(pred2).tolist(),
                      "pred_3d": np.asarray(pred3).tolist(),
                      "root_d": [float(p[2, 2]) for p in pred3],
                      "image_path": f"TS{MUPOTS_TS}/img_{i:06d}.jpg",
                      "gt_3d": np.asarray(gt3).tolist(),
                      "gt_2d": np.asarray(gt2).tolist()})
    return {"model_pattern": "MIX", "3d_pairs": pairs}


def param_digest(model) -> str:
    """sha256 of a model's parameters' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def small_dp_step(cfg, world: int, rank: int, dev):
    """One float64 step of the small config on this rank's share of a
    seeded global batch of 4 (all of it in one process): (losses, the
    gradient vector on the host)."""
    from smap_tpu_torch.models.smap import init_smap
    from smap_tpu_torch.train.step import (TrainBatch, create_train_state,
                                           train_step, training_model)

    batch = train_batch(np.random.RandomState(1),
                        torch.Generator().manual_seed(1), cfg, 4, "cpu")
    per = 4 // world
    local = TrainBatch(*(x[rank * per:(rank + 1) * per].to(dev)
                         for x in batch))
    model = training_model(init_smap(cfg.model, seed=2), dev)
    model.double().compute_dtype = torch.float64
    state, losses = train_step(create_train_state(model, cfg, world), local,
                               cfg=cfg)
    return ({k: float(v) for k, v in losses.items()},
            grad_vector(state.model).cpu())


def dp_train_rank(rank: int, world: int, coordinator: str, backend: str,
                  device: str, small: bool) -> dict:
    """One rank of phase 10 (a), in its own process: ``Config()`` at full
    width, each rank from its own seed until create_train_state copies
    rank 0's weights, DP_TRAIN_STEPS steps on this rank's share of seeded
    global batches of TRAIN_BATCH (for a group of one, rank 0's share)
    under deterministic algorithms; after every step the ranks' losses and
    parameters must be equal. Then the gradient bucket's all-reduce
    alone and ``average_gradients`` (flatten, all-reduce, write back),
    timed, and (``small``) the small float64 step. A group of one joins NCCL
    directly (initialize_distributed makes no group for one process)."""
    import torch.distributed as tdist

    from smap_tpu_torch.config import Config
    from smap_tpu_torch.models.smap import init_smap
    from smap_tpu_torch.parallel import distributed
    from smap_tpu_torch.runtime import (deterministic_algorithms, get_device,
                                        set_tf32)
    from smap_tpu_torch.train.step import (TrainBatch, create_train_state,
                                           train_step, training_model)

    if world == 1:
        torch.cuda.set_device(0)
        tdist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                 world_size=1, rank=0)
    else:
        distributed.initialize_distributed(coordinator, world, rank,
                                           backend=backend,
                                           timeout_s=DP_TIMEOUT)
    try:
        set_tf32(False)
        dev = get_device(device)
        cfg = Config()
        per = TRAIN_BATCH // DP_RANKS
        out = {"device": str(dev), "backend": tdist.get_backend(),
               "world": tdist.get_world_size(), "steps": []}
        with deterministic_algorithms():
            model = training_model(init_smap(cfg.model, seed=rank), dev)
            state = create_train_state(model, cfg, world)
            rng, gen = np.random.RandomState(0), torch.Generator(dev)
            gen.manual_seed(0)
            torch.cuda.reset_peak_memory_stats(dev)
            for _ in range(DP_TRAIN_STEPS):
                batch = train_batch(rng, gen, cfg, TRAIN_BATCH, dev)
                local = TrainBatch(*(x[rank * per:(rank + 1) * per]
                                     for x in batch))
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                state, losses = train_step(state, local, cfg=cfg)
                values = {k: float(v) for k, v in losses.items()}
                ms = (time.perf_counter() - t0) * 1e3
                mine = (values, param_digest(state.model))
                ranks = distributed.all_gather_objects(mine)
                if any(g != mine for g in ranks):
                    raise AssertionError(f"rank {rank}: the ranks' losses or "
                                         f"parameters differ after step "
                                         f"{state.step}")
                out["steps"].append({"ms": ms, "losses": values})
            out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            grads = [p for p in state.model.parameters()
                     if p.grad is not None]
            out["grad_mb"] = sum(p.grad.numel() * p.grad.element_size()
                                 for p in grads) / 1e6
            flat = torch.cat([p.grad.reshape(-1) for p in grads])
            for key, fn in (("allreduce_ms", lambda: tdist.all_reduce(flat)),
                            ("average_ms", lambda: distributed
                             .average_gradients(grads))):
                times = []
                for _ in range(3):
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize(dev)
                    times.append((time.perf_counter() - t0) * 1e3)
                out[key] = float(np.median(times))
        del state, model
        if small:
            out["small"] = small_dp_step(small_train_cfg(), world, rank, dev)
        return out
    finally:
        distributed.finalize_distributed()


def dp_training(dev, card: str, backend: str, device: str) -> None:
    """Phase 10 (a): DP_RANKS ranks with ``backend`` on ``device``, and on
    a host with fewer cards than ranks a one-rank NCCL group too; the
    small float64 step of the ranks against this process's."""
    from smap_tpu_torch.parallel.distributed import spawn_ranks

    t0 = time.perf_counter()
    ranks = spawn_ranks(dp_train_rank, DP_RANKS, backend, device, True,
                        timeout_s=DP_TIMEOUT)
    seconds = time.perf_counter() - t0
    r0 = ranks[0]
    for i, step in enumerate(r0["steps"]):
        losses_ok(step["losses"], f"data parallel step {i + 1}")
        log(f"data parallel: step {i + 1}: {fmt(step['losses'])}; ranks "
            f"equal in losses and parameters")
    ms = float(np.mean([s["ms"] for s in r0["steps"][1:]]))
    peaks = ", ".join(f"{r['peak_gb']:.2f}" for r in ranks)
    log(f"data parallel: {DP_RANKS} {r0['backend']} ranks on "
        f"{[r['device'] for r in ranks]}, Config() 512x832 bf16, global "
        f"batch {TRAIN_BATCH} ({TRAIN_BATCH // DP_RANKS} a rank), "
        f"deterministic algorithms: {ms:.1f} ms a step (rank 0, steps 2-"
        f"{DP_TRAIN_STEPS}, host clock, synchronized), "
        f"{TRAIN_BATCH * 1e3 / ms:.1f} img/s; peak memory a rank "
        f"{peaks} GB; "
        f"gradient all-reduce {r0['allreduce_ms']:.1f} ms "
        f"({r0['grad_mb']:.1f} MB of float32 gradients in one bucket; "
        f"average_gradients, with its flatten and write-back, "
        f"{r0['average_ms']:.1f} ms); "
        f"{seconds:.1f} s of processes [{card}]")
    ((l2, g2), (l2b, g2b)) = ranks[0]["small"], ranks[1]["small"]
    if l2 != l2b or not torch.equal(g2, g2b):
        raise AssertionError("data parallel: the ranks' small steps differ")
    l1, g1 = small_dp_step(small_train_cfg(), 1, 0, dev)
    loss_d = max(abs(l2[k] - l1[k]) / abs(l1[k]) for k in l1)
    grad_d = dist(g2, g1)
    log(f"data parallel: small config (1 stage, 64x96, float64), "
        f"{DP_RANKS} ranks against 1 process on the same global batch of "
        f"4: losses rel {loss_d:.2e} (tolerance {DP_SMALL_LOSS_RTOL}), "
        f"gradient vector {grad_d:.2e} (tolerance {DP_SMALL_GRAD_TOL})")
    if not (loss_d <= DP_SMALL_LOSS_RTOL and grad_d <= DP_SMALL_GRAD_TOL):
        raise AssertionError("data parallel: 2 ranks are not 1 process")
    if torch.cuda.device_count() < DP_RANKS:
        t0 = time.perf_counter()
        one = spawn_ranks(dp_train_rank, 1, "nccl", "cuda", False,
                          timeout_s=DP_TIMEOUT)[0]
        for step in one["steps"]:
            losses_ok(step["losses"], "one-rank NCCL step")
        one_ms = float(np.mean([s["ms"] for s in one["steps"][1:]]))
        log(f"data parallel: a one-rank {one['backend']} group on "
            f"{one['device']}, the same steps on one rank's share (batch "
            f"{TRAIN_BATCH // DP_RANKS}): {one_ms:.1f} ms a step (steps 2-"
            f"{DP_TRAIN_STEPS}), its gradient bucket all-reduced in "
            f"{one['allreduce_ms']:.2f} ms (average_gradients "
            f"{one['average_ms']:.2f} ms); peak {one['peak_gb']:.2f} GB; "
            f"{time.perf_counter() - t0:.1f} s of process [{card}]")


def dp_labeled(dev, card: str, backend: str, sd_path: str, sd,
               frame_dir: str) -> dict:
    """Phase 10 (b): ``test_smap -t generate_result --distributed`` in
    DP_RANKS processes on phase 9's labeled frames (``annot.json``), each
    rank on its contiguous shard: A and B launched in every rank, and the
    JSON rank 0 writes equal to ``run_labeled_inference`` over the whole
    set in this process. Returns the ranks' launches, summed."""
    from smap_tpu_torch.config import Config
    from smap_tpu_torch.data.datasets import JointDataset, load_annotations
    from smap_tpu_torch.inference import SMAPInference, run_labeled_inference
    from smap_tpu_torch.parallel.distributed import free_port

    annot = os.path.join(frame_dir, "annot.json")
    out_dir = os.path.join(frame_dir, "dp_result")
    flags = ["-m", "smap_tpu_torch.test_smap", "-t", "generate_result",
             "-p", sd_path, "--test-json", annot, "--test-root", frame_dir,
             "--batch_size", str(DP_BATCH), "--output-dir", out_dir,
             "--distributed", "--coordinator", f"localhost:{free_port()}",
             "--num-processes", str(DP_RANKS), "--backend", backend]
    if backend == "gloo":
        flags += ["--device", "cuda:0"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, *flags, "--process-id",
                               str(r)], cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(DP_RANKS)]
    try:
        outs = [p.communicate(timeout=DP_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for r, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"test_smap rank {r} exited {p.returncode}:"
                                 f"\n{stdout[-3000:]}\n{stderr[-3000:]}")
    summaries = [json.loads(err.strip().splitlines()[-1]) for _, err in outs]
    total = {}
    for r, summary in enumerate(summaries):
        launches = summary["kernel_launches"]
        if summary["rank"] != r or not (launches["paf_score"] >= 1
                                         and launches["associate"] >= 1):
            raise AssertionError(f"test_smap rank {r}: {summary}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    with open(os.path.join(out_dir, "stage3_root2_generate_result_test"
                                    ".json")) as f:
        got = json.load(f)["3d_pairs"]
    cfg = Config()
    dataset = JointDataset(load_annotations(annot), {"MUPOTS": frame_dir},
                           cfg, "test")
    want = run_labeled_inference(dataset, SMAPInference(sd, cfg, device=dev),
                                 batch_size=DP_BATCH)["3d_pairs"]
    err = same_pairs(got, json.loads(json.dumps(want)),
                     "test_smap --distributed")
    log(f"data parallel: test_smap -t generate_result in {DP_RANKS} "
        f"{backend} processes: {len(got)} items, "
        f"{sum(len(p['pred_3d']) for p in got)} people, equal to one "
        f"process's run_labeled_inference (max abs err {err:.3g}, the "
        f"same order); launches a rank "
        f"{[s['kernel_launches'] for s in summaries]}; {seconds:.1f} s of "
        f"processes [{card}]")
    return total


def dp_serving(dev, card: str, sd, batches) -> dict:
    """Phase 10 (c): ``SMAPInference(devices=...)`` over every card, or
    two replicas on one card, on SHARD_BATCHES batches of BATCH, unfolded,
    folded-fused and int8-static, against one device's ``run_batch`` on
    the same shards, concatenated: equal counts and bodies within
    DECODE_ATOL, each mode's kernels launched by every replica, img/s of
    both engines at BATCH in turns. (One device's forward of the whole
    batch is no reference for the bits: cuDNN takes other algorithms for
    a batch of 16 than for 8, and at random weights the bf16 maps move by
    ~2% of their range, which decodes another crowd; the log gives that
    distance.) Returns the sharded engines' launches, summed."""
    from smap_tpu_torch.config import Config
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.parallel.mesh import make_mesh

    cfg = Config()
    cards = torch.cuda.device_count()
    mesh = make_mesh() if cards > 1 else make_mesh([dev, dev])
    n = len(mesh)
    runs = SHARD_BATCHES
    modes = {
        "unfolded": (dict(), {}),
        "folded-fused": (dict(quantized="folded", fuse_stem=True,
                              fuse_bottleneck=True),
                         {"fused_stem": n * runs,
                          "fused_bottleneck": 9 * n * runs}),
        "int8-static": (dict(quantized="static",
                             calibration_batches=[batches[0][0]]),
                        {"int8_conv": 206 * n * runs}),
    }
    per = BATCH // n
    total = {}
    for name, (kw, want_launches) in modes.items():
        one = SMAPInference(sd, cfg, device=dev, **kw)
        sharded = SMAPInference(sd, cfg, devices=mesh, **kw)
        for engine in (one, sharded):                         # warm-up
            engine.run_batch(*batches[0]).count.cpu()
        want = [one._merge([one.run_batch(images[i * per:(i + 1) * per],
                                          scales[i * per:(i + 1) * per])
                            for i in range(n)])
                for images, scales in batches[:runs]]
        whole = one.forward(one.to_device(batches[0][0]))[0]
        split = torch.cat([one.forward(one.to_device(
            batches[0][0][i * per:(i + 1) * per]))[0] for i in range(n)])
        kernels.reset_launch_counts()
        got = [sharded.run_batch(*b) for b in batches[:runs]]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        want_launches = {"paf_score": n * runs, "associate": n * runs,
                         **want_launches}
        if any(launches[k] != v for k, v in want_launches.items()):
            raise AssertionError(f"sharded {name}: launches {launches}, "
                                 f"want {want_launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        err = 0.0
        for g, w in zip(got, want):
            if not torch.equal(g.count, w.count):
                raise AssertionError(f"sharded {name}: counts "
                                     f"{g.count.tolist()} vs "
                                     f"{w.count.tolist()}")
            for i, k in enumerate(w.count.tolist()):
                for a, b in zip(g[:3], w[:3]):
                    if k:
                        err = max(err, float((a[i, :k] - b[i, :k]).abs()
                                             .max()))
        if not err <= DECODE_ATOL:
            raise AssertionError(f"sharded {name}: max abs err {err}")

        def serve(engine):
            return lambda: [engine.run_batch(*b).count.cpu()
                            for b in batches[:runs]]

        rates = {}
        for label, engine in (("one", one), ("sharded", sharded),
                              ("sharded", sharded), ("one", one)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve(engine)()
            rates.setdefault(label, []).append(
                runs * BATCH / (time.perf_counter() - t0))
        log(f"data parallel: SMAPInference(devices={[str(d) for d in mesh]})"
            f" {name}, batch {BATCH}: counts equal to one device's run_batch "
            f"on the shards ({[int(c) for c in got[0].count[:4]]}...), max "
            f"abs err {err:.3g} (one device's 2D maps of the batch of "
            f"{BATCH} against those of its {n} shards: rms rel "
            f"{rel_err(split, whole):.2e}); launches {launches}; "
            f"{np.mean(rates['sharded']):.1f} img/s against one device's "
            f"{np.mean(rates['one']):.1f} (run_batch, results to the host, "
            f"in turns) [{card}]")
        del one, sharded
    return total


def dp_evaluation(tmp: str) -> None:
    """Phase 10 (d): the eval CLIs as processes on a MuPoTS-shaped
    sequence: the exact predictions score PCK 100, MPJPE 0 and ordinal 1;
    the perturbed ones print MUPOTS_PINNED."""
    root = os.path.join(tmp, "mupots")
    poses = mupots_sequence(os.path.join(root, f"TS{MUPOTS_TS}"))
    for label, perturb, pinned in (("exact", False, MUPOTS_PERFECT),
                                   ("perturbed", True, MUPOTS_PINNED)):
        path = os.path.join(tmp, f"mupots_{label}.json")
        with open(path, "w") as f:
            json.dump(mupots_result(poses, perturb), f)
        runs = {
            "relative": run_cli("eval_mupots", "--result-json", path,
                                "--mupots-dir", root),
            "absolute": run_cli("eval_mupots", "--result-json", path,
                                "--mupots-dir", root, "--absolute"),
            "panoptic": run_cli("eval_panoptic", "--result-json", path),
        }
        for mode, out in runs.items():
            lines = out.stdout.splitlines()
            missing = [line for line in pinned[mode] if line not in lines]
            if missing:
                raise AssertionError(f"eval {mode} on the {label} "
                                     f"predictions: {missing} not in\n"
                                     f"{out.stdout}")
        log(f"evaluation: eval_mupots (relative, --absolute) and "
            f"eval_panoptic on the {label} predictions: "
            + "; ".join(" / ".join(line.strip() for line in pinned[m])
                        for m in runs))


def phase_data_parallel(dev, card: str, tmp: str, sd_path: str, sd,
                        frame_dir: str, batches) -> dict:
    """Phase 10: data-parallel training, labeled inference across
    processes, sharded serving and the evaluation CLIs. Returns the kernel
    launches of (b) and (c), summed."""
    cards = torch.cuda.device_count()
    if cards >= DP_RANKS:
        backend, device = "nccl", "cuda"
    else:
        backend, device = "gloo", "cuda:0"
    log(f"data parallel: {cards} card(s): {DP_RANKS} {backend} ranks on "
        f"{device}" + (" (each its own card)" if backend == "nccl" else
                       " (sharing it), and a one-rank NCCL group"))
    t0 = time.perf_counter()
    dp_training(dev, card, backend, device)
    launches = dp_labeled(dev, card, backend, sd_path, sd, frame_dir)
    for k, v in dp_serving(dev, card, sd, batches).items():
        launches[k] = launches.get(k, 0) + v
    dp_evaluation(tmp)
    log(f"data parallel: phase 10 took {time.perf_counter() - t0:.1f} s")
    return launches


# Phase 11 (tools and tracing). The CUDA kernel each wrapper launches, by
# the symbol the trace records it under.
KERNEL_SYMBOLS = {"paf_score": "paf_score_kernel",
                  "associate": "associate_kernel",
                  "fused_stem": "fused_stem_kernel",
                  "fused_bottleneck": "fused_bottleneck_kernel",
                  "int8_conv": "int8_conv_kernel"}
EPILOGUE_SYMBOL = "conv_epilogue_kernel"
# (c): Trainer.fit at Config() with the checkpoint period 4 steps (one
# device, unscaled), log every 2, PROFILE_STEPS steps, the trace over
# steps (PROFILE_FIRST, PROFILE_FIRST + 2]: the JAX package's cadence
# (tests/test_engine.py).
PROFILE_STEPS, PROFILE_FIRST = 5, 2
PROFILE_CKPTS, PROFILE_LOGGED = [4, 5], [2, 4, 5]
# (d): tests/test_native.py's tolerances: the letterbox within 2 grey
# levels on 99% of values and 12 at most; the normalize within 1e-5.
NATIVE_LSB_SHARE, NATIVE_LSB_MAX, NATIVE_NORM_ATOL = 0.99, 12, 1e-5


def trace_file(log_dir: str) -> str:
    """The one Chrome trace under ``log_dir``."""
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"tools: {len(files)} traces in {log_dir}: "
                             f"{files}")
    return os.path.join(log_dir, files[0])


def trace_counts(path: str):
    """(launches of each kernel of A-E among the trace's device kernels,
    its ``annotate`` spans by kernel, its device kernels in all, and kernel
    F's launches and spans)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    spans = [e.get("name") for e in events
             if e.get("cat") == "user_annotation"]
    return ({k: sum(sym in n for n in device)
             for k, sym in KERNEL_SYMBOLS.items()},
            {k: spans.count(k) for k in KERNEL_SYMBOLS}, len(device),
            (sum(EPILOGUE_SYMBOL in n for n in device),
             spans.count("conv_epilogue")))


def cli_launches_line(stderr: str) -> dict:
    """The kernel launches that a test_smap process printed."""
    for line in reversed(stderr.splitlines()):
        if line.startswith("{") and "kernel_launches" in line:
            return json.loads(line)["kernel_launches"]
    raise AssertionError(f"no kernel_launches line in:\n{stderr[-2000:]}")


def traced_test_smap(tmp: str, sd_path: str, frame_dir: str,
                     card: str) -> dict:
    """(a) test_smap -t run_inference on phase 9's frames, with and
    without --profile-dir: the same JSON, and the trace's A and B
    launches those the process counted, one each a batch."""
    from smap_tpu_torch.inference import image_paths

    frames = len(image_paths(frame_dir))
    runs = {}
    for name in ("plain", "traced"):
        out_dir = os.path.join(tmp, f"tools_{name}")
        extra = (["--profile-dir", os.path.join(tmp, "tools_prof")]
                 if name == "traced" else [])
        out = run_cli("test_smap", "-t", "run_inference", "-p", sd_path,
                      "--dataset_path", frame_dir, "--batch_size",
                      str(BATCH), "--output-dir", out_dir, *extra)
        with open(os.path.join(out_dir, "stage3_root2_run_inference_test"
                                        ".json")) as f:
            runs[name] = (json.load(f), cli_launches_line(out.stderr),
                          out.seconds)
    if runs["traced"][0] != runs["plain"][0]:
        raise AssertionError("tools: test_smap --profile-dir changed the "
                             "result JSON")
    batches = -(-frames // BATCH)
    launches = runs["traced"][1]
    path = trace_file(os.path.join(tmp, "tools_prof"))
    counted, spans, device, epilogue = trace_counts(path)
    want = dict(paf_score=batches, associate=batches, fused_stem=0,
                fused_bottleneck=0, int8_conv=0)
    if not (launches == runs["plain"][1] == counted == spans == want):
        raise AssertionError(f"tools: test_smap launches {launches} "
                             f"(plain {runs['plain'][1]}), the trace's "
                             f"kernels {counted}, spans {spans}; want {want}")
    check_epilogues(epilogue[0], "unfolded", batches, "tools: test_smap")
    if epilogue[1] != epilogue[0]:
        raise AssertionError(f"tools: test_smap's trace: {epilogue[0]} F "
                             f"kernels, {epilogue[1]} spans")
    log(f"tools: test_smap -t run_inference on {frames} frames: "
        f"{runs['plain'][2]:.1f} s of process, {runs['traced'][2]:.1f} s "
        f"with --profile-dir (trace of {device} device kernels, "
        f"{os.path.getsize(path) / 1e6:.1f} MB); the same JSON; A and B "
        f"in the trace {counted['paf_score']} and {counted['associate']}, "
        f"one each a batch, as LAUNCHES and the annotate spans; F "
        f"{epilogue[0]}, {EPILOGUES['unfolded']} a batch [{card}]")
    return dict(counted, conv_epilogue=epilogue[0])


def traced_folded_batch(dev, tmp: str, sd, batches, card: str) -> dict:
    """(b) One folded-fused run_batch inside trace(): 1 C, 9 D, 1 A and 1
    B among the device kernels, each inside its annotate span; run_batch
    ms with and without the trace, in turns."""
    from smap_tpu_torch.config import Config
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.utils.profiling import trace

    engine = SMAPInference(sd, Config(), device=dev, quantized="folded",
                           fuse_stem=True, fuse_bottleneck=True)
    frames, scales = batches[0]

    def run():
        res = engine.run_batch(frames, scales)
        torch.cuda.synchronize()
        return res

    run()                                           # packs and warms up
    log_dir = os.path.join(tmp, "tools_folded")
    kernels.reset_launch_counts()
    with trace(log_dir):
        res = run()
    launches = dict(kernels.LAUNCHES)
    counted, spans, device, epilogue = trace_counts(trace_file(log_dir))
    want = dict(paf_score=1, associate=1, fused_stem=1, fused_bottleneck=9,
                int8_conv=0)
    if not (launches == counted == spans == want):
        raise AssertionError(f"tools: traced folded-fused batch: LAUNCHES "
                             f"{launches}, the trace's kernels {counted}, "
                             f"spans {spans}; want {want}")
    if not (kernels.EPILOGUE_LAUNCHES == epilogue[0] == epilogue[1]
            == EPILOGUES["folded-fused"]):
        raise AssertionError(f"tools: traced folded-fused batch: F "
                             f"launches {kernels.EPILOGUE_LAUNCHES}, the "
                             f"trace's kernels and spans {epilogue}; want "
                             f"{EPILOGUES['folded-fused']}")
    if not all(bool(torch.isfinite(t).all()) for t in res[:3]):
        raise AssertionError("tools: traced folded-fused batch not finite")
    ms = {"plain": [], "traced": []}
    for name in ("plain", "traced", "traced", "plain"):
        with trace(os.path.join(tmp, "tools_turns") if name == "traced"
                   else None):
            t0 = time.perf_counter()
            run()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    log(f"tools: one folded-fused run_batch traced: C {counted['fused_stem']}"
        f", D {counted['fused_bottleneck']}, A {counted['paf_score']}, B "
        f"{counted['associate']}, F {epilogue[0]} of {device} device "
        f"kernels, as the launch counts and the annotate spans; run_batch "
        f"{np.mean(ms['plain']):.2f} ms, "
        f"{np.mean(ms['traced']):.2f} ms traced (host clock, synchronized, "
        f"in turns) [{card}]")
    return dict(counted, conv_epilogue=epilogue[0])


def traced_training(dev, tmp: str, card: str) -> None:
    """(c) Trainer.fit at full width on phase 8's seeded batches under
    deterministic algorithms, PROFILE_STEPS steps with a trace window,
    against the untraced run from the same state, before and after it
    (losses and the whole state bit-equal, checkpoints and logged steps
    at the JAX cadence); ms a step of each."""
    import dataclasses

    from smap_tpu_torch.config import Config
    from smap_tpu_torch.runtime import deterministic_algorithms
    from smap_tpu_torch.train.engine import Trainer, TrainerConfig

    cfg = Config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_period=4, nominal_devices=1))
    rng, gen = np.random.RandomState(0), torch.Generator(dev).manual_seed(0)
    batches = [train_batch(rng, gen, cfg, TRAIN_BATCH, dev)
               for _ in range(PROFILE_STEPS)]
    prof_dir = os.path.join(tmp, "tools_train_prof")
    runs = {}
    for name, prof in (("untraced", ""), ("traced", prof_dir),
                       ("untraced again", "")):
        out_dir = os.path.join(tmp, f"tools_train_{len(runs)}")
        trainer = Trainer(cfg, TrainerConfig(
            output_dir=out_dir, log_every=2, seed=0, profile_dir=prof, profile_first_step=PROFILE_FIRST,
            profile_num_steps=2), device=dev)
        state = trainer.init_state(0)
        with deterministic_algorithms():
            state = trainer.fit(enumerate(batches), state=state,
                                max_steps=PROFILE_STEPS)
        steps = trainer.ckpt.all_steps()
        trainer.close()
        with open(os.path.join(out_dir, "tb_dir", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        logged = [{k: v for k, v in r.items() if k != "time"}
                  for r in records]
        if (steps != PROFILE_CKPTS
                or [r["step"] for r in logged] != PROFILE_LOGGED):
            raise AssertionError(f"tools: {name}: checkpoints {steps}, "
                                 f"logged steps {logged}")
        # Steps 3 and 4: between the losses read at 2 and at 4 (each read
        # waits for the card), before the checkpoint at 4.
        ms = (records[1]["time"] - records[0]["time"]) * 1e3 / 2
        runs[name] = (ms, logged, {k: v.cpu() for k, v in
                                   state.model.state_dict().items()},
                      state.optimizer.state_dict())
        del trainer, state
    ref = runs["untraced"]
    for name in ("traced", "untraced again"):
        got = runs[name]
        same = got[1] == ref[1] and all(
            torch.equal(got[2][k], v) for k, v in ref[2].items()) and all(
            torch.equal(got[3]["state"][i][k], v)
            for i, st in ref[3]["state"].items() for k, v in st.items())
        if not same:
            raise AssertionError(f"tools: Trainer.fit {name} differs from "
                                 f"untraced: losses {got[1]} vs {ref[1]}")
    counted, spans, device, epilogue = trace_counts(trace_file(prof_dir))
    if device == 0 or any(counted.values()) or any(epilogue):
        raise AssertionError(f"tools: the training trace holds {device} "
                             f"device kernels, A-E {counted}, F {epilogue}")
    log(f"tools: Trainer.fit at Config(), batch {TRAIN_BATCH}, "
        f"deterministic, {PROFILE_STEPS} steps: traced bit-equal to "
        f"untraced (losses at steps {PROFILE_LOGGED}, "
        f"weights, statistics, Adam), checkpoints {PROFILE_CKPTS}; the "
        f"trace of steps {PROFILE_FIRST + 1}-{PROFILE_FIRST + 2} holds "
        f"{device} device kernels, none of A-F; ms a step over steps 3-4 "
        f"(host clock between the losses read at steps 2 and 4; the "
        f"traced run's include the trace's start and export): " + ", ".join(
            f"{name} {r[0]:.2f}" for name, r in runs.items()) + f" [{card}]")


def native_host_path(frame_dir: str, card: str) -> None:
    """(d) The native library built on this machine; on a FRAME_HW frame
    its letterbox and normalize match the numpy path within
    tests/test_native.py's tolerances; ms a frame of each beside numpy's,
    and of the train sample's normalize at the input size."""
    from smap_tpu_torch.config import INPUT_SHAPE, PIXEL_STDS_BGR
    from smap_tpu_torch.data import native
    from smap_tpu_torch.data.image import imread
    from smap_tpu_torch.data.preprocess import letterbox_image, normalize_image

    if not native.native_available():
        raise AssertionError("tools: the native preprocessing library did "
                             "not build on this machine")
    img = imread(os.path.join(frame_dir, "frame000.png"))
    got, _ = native.letterbox_normalize_native(img)
    want = normalize_image(letterbox_image(img)[0])
    lsb = 2.0 / 255.0 / min(PIXEL_STDS_BGR)
    diff = np.abs(got - want)
    norm_err = float(np.abs(native.normalize_native(img)
                            - normalize_image(img)).max())
    if not (np.mean(diff < lsb) > NATIVE_LSB_SHARE
            and diff.max() < NATIVE_LSB_MAX * lsb
            and norm_err <= NATIVE_NORM_ATOL):
        raise AssertionError(f"tools: native letterbox {diff.max():.3g} "
                             f"max, {np.mean(diff < lsb):.4f} within 2 "
                             f"levels; normalize {norm_err:.3g}")
    boxed = letterbox_image(img)[0]

    def ms(fn, n=5):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n

    times = {
        "letterbox + normalize": (
            ms(lambda: native.letterbox_normalize_native(img)),
            ms(lambda: normalize_image(letterbox_image(img)[0]))),
        f"normalize {FRAME_HW[0]}x{FRAME_HW[1]}": (
            ms(lambda: native.normalize_native(img)),
            ms(lambda: normalize_image(img))),
        f"normalize {INPUT_SHAPE[0]}x{INPUT_SHAPE[1]} (the train sample)": (
            ms(lambda: native.normalize_native(boxed)),
            ms(lambda: normalize_image(boxed)))}
    lib = os.path.relpath(native.library_path(), ROOT)
    log(f"tools: native library built ({lib}, g++ "
        f"{' '.join(native.CXX_FLAGS)}); letterbox within "
        f"{diff.max() / lsb * 2:.2f} grey levels of the numpy path "
        f"({np.mean(diff < lsb):.5f} within 2), normalize within "
        f"{norm_err:.3g}; ms a frame native / numpy (one thread): "
        + ", ".join(f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in times.items())
        + f" [{card}]")


def converted_checkpoints(tmp: str, sd_path: str, sd) -> None:
    """(e) convert_checkpoint both ways as processes: phase 9's .pth -> a
    training checkpoint -> a .pth holding the same tensors bit for bit."""
    ckpt_dir = os.path.join(tmp, "tools_ckpt")
    back = os.path.join(tmp, "tools_back.pth")
    first = run_cli("convert_checkpoint", "--smap-path", sd_path,
                    "--output-dir", ckpt_dir)
    second = run_cli("convert_checkpoint", "--ckpt-dir", ckpt_dir,
                     "--to-torch", back)
    ckpt = torch.load(os.path.join(ckpt_dir, "checkpoints", "0.pt"),
                      map_location="cpu", weights_only=True)
    got = torch.load(back, map_location="cpu", weights_only=True)["model"]
    if not (ckpt["step"] == 0 and got.keys() == sd.keys() and all(
            torch.equal(got[k], v) and torch.equal(ckpt["model"][k], v)
            for k, v in sd.items())):
        raise AssertionError("tools: the checkpoint round trip changed the "
                             "weights")
    log(f"tools: convert_checkpoint .pth -> checkpoint ({first.seconds:.1f}"
        f" s of process) -> .pth ({second.seconds:.1f} s): {len(sd)} "
        f"tensors bit-equal")


def phase_tools(dev, card: str, tmp: str, sd_path: str, sd, frame_dir: str,
                batches) -> dict:
    """Phase 11: tracing and the tools, on what phase 9 left. Returns the
    kernel launches the traces of (a) and (b) counted."""
    t0 = time.perf_counter()
    counted = traced_test_smap(tmp, sd_path, frame_dir, card)
    for k, v in traced_folded_batch(dev, tmp, sd, batches, card).items():
        counted[k] += v
    traced_training(dev, tmp, card)
    native_host_path(frame_dir, card)
    converted_checkpoints(tmp, sd_path, sd)
    log(f"tools: phase 11 took {time.perf_counter() - t0:.1f} s")
    return counted


# Phase 12 (JPEG and the native image path): the JPEG fixtures and the
# manifest cv2 wrote for them on the host that made them
# (tests/make_torch_jpeg.py); the full-size ones copied under JPEG_FRAMES
# names for the entry points; the host libraries, built by g++ in phase 1.
JPEG_FIXTURES = os.path.join(ROOT, "tests", "torch_jpeg")
JPEG_FRAMES = 32
HOST_LIBRARIES = ("preprocess", "image", "jpeg")


def start_host_builds():
    """Starts g++ on each native host library (``data.native``), a thread
    each, beside nvcc; returns a function that waits for them and returns
    (seconds, {library: error})."""
    import threading

    from smap_tpu_torch.data import native

    errors = {}

    def one(name):
        try:
            native.build(name)
        except (OSError, subprocess.CalledProcessError) as e:
            stderr = getattr(e, "stderr", None) or b""
            errors[name] = f"{e}\n{stderr.decode(errors='replace')}"

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(name,))
               for name in HOST_LIBRARIES]
    for t in threads:
        t.start()

    def wait():
        for t in threads:
            t.join()
        return time.perf_counter() - t0, errors

    return wait


def ms_of(fn, n: int) -> float:
    """The median host ms of ``n`` calls of ``fn``."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def jpeg_fixtures(card: str):
    """(b) Every fixture decoded by ``data.image.imread``: the shape and
    sha256 that cv2 gave (the manifest), None where cv2 gave None; ms a
    frame of the 1080x1920 ones. Returns their paths."""
    import hashlib

    from smap_tpu_torch.data.image import imread

    with open(os.path.join(JPEG_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    for name, want in sorted(manifest.items()):
        got = imread(os.path.join(JPEG_FIXTURES, name))
        entry = None if got is None else {
            "shape": list(got.shape),
            "sha256": hashlib.sha256(got.tobytes()).hexdigest()}
        if entry != want:
            raise AssertionError(f"jpeg: {name} decodes to {entry}, cv2 "
                                 f"gave {want}")
    full = [os.path.join(JPEG_FIXTURES, n) for n in sorted(manifest)
            if n.startswith("scene_")]
    times = [f"{os.path.basename(p)} ({os.path.getsize(p) / 1e3:.0f} kB) "
             f"{ms_of(lambda: imread(p), 5):.2f}" for p in full]
    log(f"jpeg: {len(manifest)} fixtures decoded to cv2's manifest (shape "
        f"and sha256; {sum(v is None for v in manifest.values())} None as "
        f"cv2's); imread ms a {FRAME_HW[0]}x{FRAME_HW[1]} frame (median of "
        f"5): {', '.join(times)} [{card}]")
    return full


def crop_matrix(m: np.ndarray, canvas, crop_hw) -> np.ndarray:
    """A composed augmentation's map (``composed_augment_sample``): the
    rotation ``m`` onto ``canvas``, scaled into the ``crop_hw`` crop with
    an offset, flipped."""
    crop_y, crop_x = crop_hw
    a = np.vstack([m, [0.0, 0.0, 1.0]])
    scale = min(crop_x / canvas[0], crop_y / canvas[1]) * 1.1
    a = np.diag([scale, scale, 1.0]) @ a
    a[:2, 2] += [13.0, -9.0]
    return (np.array([[-1.0, 0.0, crop_x - 1.0], [0.0, 1.0, 0.0],
                      [0.0, 0.0, 1.0]]) @ a)[:2]


def native_image_ops(img: np.ndarray, card: str) -> None:
    """(c) On a FRAME_HW frame, the native library's resize (at the
    letterbox scale and at 0.5), warp (linear and cubic, on the rotation's
    canvas and on a crop) and PNG unfiltering (every row Average, then
    Paeth) bit-equal to their numpy versions; ms a frame of each (native:
    median of 3; numpy: one call)."""
    from smap_tpu_torch.config import INPUT_SHAPE
    from smap_tpu_torch.data import image
    from smap_tpu_torch.data.augmentation import _rotated_canvas

    h, w = img.shape[:2]
    box = min(INPUT_SHAPE[1] / w, INPUT_SHAPE[0] / h)
    rot, canvas = _rotated_canvas(h, w, 7.3)
    crop = crop_matrix(rot, canvas, INPUT_SHAPE)
    crop_size = (INPUT_SHAPE[1], INPUT_SHAPE[0])
    rows = {k: filtered_rows(img, k) for k in (3, 4)}
    cases = {
        f"resize_linear x{box:.4f}": (image.resize_linear,
                                      image.resize_linear_numpy,
                                      (img, box, box)),
        "resize_linear x0.5": (image.resize_linear,
                               image.resize_linear_numpy, (img, 0.5, 0.5)),
    }
    for interp in ("linear", "cubic"):
        cases[f"warp_affine {interp} rotation {canvas[0]}x{canvas[1]}"] = (
            image.warp_affine, image.warp_affine_numpy,
            (img, rot, canvas, interp))
        cases[f"warp_affine {interp} crop {crop_size[0]}x{crop_size[1]}"] = (
            image.warp_affine, image.warp_affine_numpy,
            (img, crop, crop_size, interp))
    for kind, name in ((3, "Average"), (4, "Paeth")):
        cases[f"unfilter {name}"] = (image.unfilter, image.unfilter_numpy,
                                     (rows[kind], 3))
    out = []
    for name, (fast, plain, args) in cases.items():
        got = fast(*args)
        t0 = time.perf_counter()
        want = plain(*args)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not (got.shape == want.shape and np.array_equal(got, want)):
            raise AssertionError(f"jpeg: native {name} differs from numpy")
        out.append(f"{name} {ms_of(lambda: fast(*args), 3):.2f} / "
                   f"{plain_ms:.1f}")
    log(f"jpeg: native image library bit-equal to numpy on a "
        f"{h}x{w} frame; ms a frame native / numpy (one thread): "
        + ", ".join(out) + f" [{card}]")


def phase_jpeg(dev, card: str, tmp: str, sd_path: str, sd, before,
               host_build) -> dict:
    """Phase 12: JPEG and the native image path. (a) the host libraries
    that phase 1 built here loaded (a numpy fallback fails); (b) the
    fixtures against cv2's manifest; (c) the library against numpy; (d)
    the serve CLI over JPEG_FRAMES copies of the full-size fixtures in the
    default and folded-fused modes, equal to run_batch; (e) test_smap -t
    generate_result on LABELED_FRAMES of them, equal to
    run_labeled_inference; (f) train_smap --deterministic, 2 steps on them,
    equal to Trainer.fit, and train_iterator's rates. ``before``: phase
    9's serve frames/s and train_iterator rates on PNG. Returns the serve
    CLI's kernel launches over its two modes."""
    import shutil

    from smap_tpu_torch.config import Config
    from smap_tpu_torch.data import native
    from smap_tpu_torch.data.image import imread
    from smap_tpu_torch.inference import SMAPInference

    t0 = time.perf_counter()
    seconds, errors = host_build
    for name in HOST_LIBRARIES:
        if name in errors or not native.native_available(name):
            raise AssertionError(f"jpeg: the native {name} library did not "
                                 f"build: {errors.get(name)}"
                                 f"{native.build_error(name)}")
    log(f"jpeg: native host libraries built here in {seconds:.1f} s (g++, "
        f"a process each, beside nvcc) and loaded: " + ", ".join(
            f"{os.path.relpath(native.library_path(n), ROOT)} "
            f"({' '.join(native.LIBRARIES[n][1])})" for n in HOST_LIBRARIES))
    full = jpeg_fixtures(card)
    native_image_ops(imread(full[0]), card)

    frame_dir = os.path.join(tmp, "jpeg_frames")
    os.makedirs(frame_dir)
    paths = [os.path.join(frame_dir, f"frame{i:03d}.jpg")
             for i in range(JPEG_FRAMES)]
    for i, path in enumerate(paths):
        shutil.copyfile(full[i % len(full)], path)
    frames = [imread(p) for p in paths]
    launches, _ = serve_cli_modes(dev, card, sd_path, sd, frame_dir, paths,
                                  frames, only=("default", "folded-fused"),
                                  fmt="JPEG", before=before[0])
    annot = labeled_annotations(np.random.RandomState(7), frame_dir, "jpg")
    engine = SMAPInference(sd, Config(), device=dev)
    generate_cli(engine, sd_path, frame_dir, annot, "generate_result",
                 "test", "jpeg")
    del engine
    train_cli(dev, card, frame_dir, "jpg", resume=False, before=before[1])
    log(f"jpeg: phase 12 took {time.perf_counter() - t0:.1f} s")
    return launches


def data_parallel_inputs(tmp: str):
    """What phase 9 leaves for phase 10, made alone: the first
    LABELED_FRAMES frames as PNG with their ``annot.json``, and the
    perturbed weights as a ``.pth``. Returns (the weights' path, the
    weights, the frames' directory)."""
    from smap_tpu_torch.config import Config

    frame_dir = os.path.join(tmp, "frames")
    os.makedirs(frame_dir)
    for i, img in enumerate(cli_frames(LABELED_FRAMES)):
        with open(os.path.join(frame_dir, f"frame{i:03d}.png"), "wb") as f:
            f.write(png_bytes(img))
    labeled_annotations(np.random.RandomState(7), frame_dir)
    sd = perturbed_state_dict(Config().model, seed=0)
    sd_path = os.path.join(tmp, "smap.pth")
    torch.save({"model": sd}, sd_path)
    return sd_path, sd, frame_dir


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if args not in ([], ["--data-parallel-only"]):
        print("usage: python3 chip_smoke.py [--data-parallel-only]",
              file=sys.stderr)
        return 2
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
    host_builds = start_host_builds()
    path, report = kernels.build()
    log(f"build: {time.perf_counter() - t0:.2f} s, nvcc "
        f"{' '.join(kernels.NVCC_FLAGS)} -> {os.path.relpath(path, ROOT)}")
    host_build = host_builds()
    log(f"build: native host libraries (g++) {host_build[0]:.2f} s, "
        f"failed: {sorted(host_build[1]) or 'none'}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"build: {line.strip()}")

    if args:     # phase 10 alone, e.g. on a host with several cards
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
            phase_data_parallel(dev, card, tmp, *data_parallel_inputs(tmp),
                                serving_batches(Config()))
        return finish(card)
    rows = phase_kernels(dev, card)
    phase_golden(dev)
    batches = serving_batches(Config())
    launches = phase_serving(dev, card, batches)
    epilogues = launches["conv_epilogue"]
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
    epilogue_row = phase_epilogue(dev, card, batches)
    epilogue_row["launches"] = epilogues
    epilogue_row["launches_per_forward"] = epilogues / (TIMED_BATCHES
                                                        + STREAM_BATCHES)
    phase_training(dev, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        cli_launches, cli_state, cli_rates = phase_entry_points(dev, card,
                                                                tmp)
        dp_launches = phase_data_parallel(dev, card, tmp, *cli_state,
                                          batches)
        trace_launches = phase_tools(dev, card, tmp, *cli_state, batches)
        jpeg_launches = phase_jpeg(dev, card, tmp, *cli_state[:2],
                                   cli_rates, host_build)
    for key, row in rows.items():
        row["cli_launches"] = cli_launches[key] + jpeg_launches[key]
        row["dp_launches"] = dp_launches.get(key, 0)
        row["trace_launches"] = trace_launches[key]
    epilogue_row["trace_launches"] = trace_launches["conv_epilogue"]
    rows["conv_epilogue"] = epilogue_row
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_per_forward", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "bound_kind", "share", "library_ms")
    summary = [{**{k: row[k] for k in keys},
                **{k: v for k, v in row.items() if k not in keys}}
               for row in rows.values()]
    log(json.dumps({"kernels": summary}))
    return finish(card)


def finish(card: str) -> int:
    """The last two lines: the card, then the result."""
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the device time of one serving forward, and of one decode, goes
on a CUDA card.

    python3 profile_forward.py          # from the repository root, one card

Builds the bf16 engines that ``chip_smoke.py`` phases 6 and 7 compare
(unfolded, BN-folded with cuDNN convolutions, BN-folded with kernels C and
D, and int8 through kernel E: static, calibrated on the batch, and
dynamic) at full width (``ModelConfig()``, 512x832, the same seeded weights
and BatchNorm statistics), warms each up, and runs ``torch.profiler`` over
3 forwards of the same batch of 16 letterboxed frames per engine. Prints,
per engine, the device time per forward summed over the card's kernels, by
kind (kernels C, D and E, convolutions, reductions, the passes of a plain
int8 quantize, elementwise passes, ...) and the ten largest kernels by
name. Kernel E quantizes its own input, so an int8 forward shows no
quantize passes; the dynamic one keeps its abs-max reductions.

``python3 profile_forward.py --sites`` runs only this: the device time of
one forward of the unfolded, folded-fused and int8-static engines on a
batch of 16 I420 frames (as the benchmark's serving cells send them), by
kernel kind and by the aten op the port's code called to launch it
(``aten::add_`` of a bias, ``aten::batch_norm``, ...).

Then the decode: ``postprocess`` (peaks, kernel A, kernel B, depth, back-
projection) of the unfolded engine's maps of that batch of 16, the frames
of ``chip_smoke.py`` phase 4. It prints the synchronized host ms of a
decode without the profiler, and from ``torch.profiler`` over 3 decodes:
device ms and kernels per decode by kind, the device's idle share of
each decode's window (from the decode's start on the host to the end of
its last kernel), and the device kernels, copies and fills that one
``associate`` call on the decode's own inputs puts on the card (profiled
apart, 3 calls).

Then one training step at full width (``ModelConfig()``, bf16 compute on
float32 parameters, ``TrainConfig()``, ``chip_smoke.TRAIN_BATCH`` images
from ``chip_smoke.train_batch``), as ``train.step.train_step`` runs it,
in four ranges each ended by a synchronize: label render, forward + loss,
backward, optimizer (Adam and the schedule). From ``torch.profiler`` over
3 steps after 2 warm-up steps: device ms per step of each range by kernel
kind, and each range's host ms. Last, the card's name and power limit.
Needs the card: without one it exits non-zero.
"""

from __future__ import annotations

import collections
import re
import sys
import time

import numpy as np
import torch

FORWARDS = 3
DECODES = 3
KINDS = (   # first match wins
    ("kernel F (conv_epilogue_kernel)", r"conv_epilogue_kernel"),
    ("kernel E (int8_conv_kernel)", r"int8_conv_kernel"),
    ("kernel D (fused_bottleneck_kernel)", r"fused_bottleneck_kernel"),
    ("kernel C (fused_stem_kernel)", r"fused_stem_kernel"),
    ("BatchNorm", r"batch_norm"),
    ("bilinear upsampling", r"upsample|bilinear"),
    ("max-pool", r"max_pool"),
    ("convolutions (cuDNN / cuBLAS)",
     r"conv|xmma|cudnn|gemm|cutlass|nvjet|sm90_|sm80_|implicit"),
    ("reductions (the dynamic scales' abs-max)", r"reduce"),
    # The division and rounding passes of a plain quantize_activation (its
    # clamp shares the ReLU's kernel, its casts count as copies below).
    ("int8 quantize passes (x / s_x, round)", r"DivFunctor|round_kernel"),
    ("elementwise (bias add, ReLU, residual add, scales, casts, copies)",
     r"elementwise|vectorized|copy|fill"),
)


TRAIN_STEPS = 3
TRAIN_RANGES = ("labels", "forward", "backward", "optimizer")
TRAIN_KINDS = (   # first match wins
    ("BatchNorm", r"batch_norm|bn_"),
    ("bilinear upsampling", r"upsample|bilinear"),
    ("max-pool", r"max_pool"),
    ("convolutions (cuDNN / cuBLAS)",
     r"conv|xmma|cudnn|gemm|cutlass|nvjet|sm90_|sm80_|implicit|wgrad|dgrad"),
    ("reductions", r"reduce"),
    ("Adam (multi-tensor)", r"multi_tensor|foreach|adam"),
    ("index / gather / scatter / sort", r"index|gather|scatter|sort|radix"),
    ("elementwise (casts, copies, fills, ...)",
     r"elementwise|vectorized|unrolled|copy|fill|memcpy|memset"),
)


DECODE_KINDS = (
    ("kernel A (paf_score_kernel)", r"paf_score_kernel"),
    ("kernel B (associate*_kernel)", r"associate\w*_kernel"),
    ("sort", r"sort|radix"),
    ("index / gather / scatter", r"index|gather|scatter"),
    ("reductions (sum, max, argmax, any)", r"reduce"),
    ("copies and fills", r"copy|fill|memcpy|memset"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


def kind_of(name: str, kinds=KINDS) -> str:
    for kind, pattern in kinds:
        if re.search(pattern, name, re.IGNORECASE):
            return kind
    return "other"


# The kernels' ``annotate`` span names (ops/kernels.py), which the device
# timeline shows beside the kernels.
SPANS = ("paf_score", "associate", "fused_stem", "fused_bottleneck",
         "int8_conv", "conv_epilogue")


def device_times(prof) -> dict:
    """Kernel name -> [summed device microseconds, launches] over the
    profiled run (the ``annotate`` spans on the device timeline left
    out)."""
    from torch.autograd import DeviceType

    times = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in SPANS:
            times[e.name][0] += e.time_range.elapsed_us()
            times[e.name][1] += 1
    return times


def merged(intervals) -> list:
    """The union of (start, end) intervals: sorted, disjoint intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def profile_decode(engine, frames, scales, card: str) -> None:
    """Host ms of a decode, then device ms, kernels and idle share per
    decode, and the device work of one ``associate`` call, from
    torch.profiler."""
    from torch.autograd import DeviceType

    from smap_tpu_torch.ops import postprocess

    images, info = engine.place(frames, scales)
    maps = engine.forward(images)
    for _ in range(3):
        engine.postprocess(maps, info)
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.postprocess(maps, info)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    print(f"decode: {sum(host) / len(host):.3f} ms per batch of "
          f"{frames.shape[0]} on the host clock, synchronized, no profiler "
          f"(mean of {len(host)}: {', '.join(f'{t:.3f}' for t in host)}) "
          f"[{card}]")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(DECODES):
            with torch.profiler.record_function("decode"):
                engine.postprocess(maps, info)
                torch.cuda.synchronize()
    events = prof.events()
    windows = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.name == "decode" and e.device_type == DeviceType.CPU)
    # The range shows on the device timeline too; it is no kernel.
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.name != "decode"]

    # The association alone, on the arguments the decode gave it.
    associate, calls = postprocess.associate, []

    def capture(*args, **kw):
        calls.append((args, kw))
        return associate(*args, **kw)

    postprocess.associate = capture
    try:
        engine.postprocess(maps, info)
    finally:
        postprocess.associate = associate
    args, kw = calls[-1]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(DECODES):
            associate(*args, **kw)
        torch.cuda.synchronize()
    in_associate = sum(e.device_type == DeviceType.CUDA
                       for e in prof.events())
    by_kind = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_kind[kind_of(e.name, DECODE_KINDS)][0] += e.time_range.elapsed_us()
        by_kind[kind_of(e.name, DECODE_KINDS)][1] += 1
    idle = []
    for start, end in windows:
        mine = [(e.time_range.start, e.time_range.end) for e in kernels
                if start <= e.time_range.start < end]
        stop = max([end] + [e for _, e in mine])
        idle.append(1.0 - busy_us(mine) / (stop - start))
    total = sum(us for us, _ in by_kind.values()) / DECODES / 1e3
    print(f"decode: {total:.3f} device ms and {len(kernels) / DECODES:.0f} "
          f"device kernels per decode (torch.profiler, mean of {DECODES}); "
          f"device idle share of each decode's window "
          f"{', '.join(f'{x:.3f}' for x in idle)}; one associate() call puts "
          f"{in_associate / DECODES:.0f} kernels, copies and fills on the "
          f"card [{card}]")
    for kind, (us, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us / DECODES / 1e3:8.3f} ms  {n / DECODES:5.0f} "
              f"launches  {kind}")
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    print("  largest:")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {us / DECODES / 1e3:8.3f} ms  {n / DECODES:5.0f} "
              f"launches  {name[:100]}")


def outer_op(e) -> str:
    """The outermost aten op above a profiled op: the call the port's code
    made (``aten::add_`` for a bias, ``aten::batch_norm``, ...)."""
    op = e.name
    while e.cpu_parent is not None and e.cpu_parent.name.startswith("aten::"):
        e = e.cpu_parent
        op = e.name
    return op


def profile_sites(engines: dict, images: torch.Tensor, card: str) -> None:
    """Device ms and launches of one forward by kind and by the aten op
    that launched each kernel (the card's profiler records no Python
    frames, so the op stands for its call sites; the port's own kernels
    launch through ctypes, under no aten op)."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, engine in engines.items():
        for _ in range(3):
            engine.forward(images)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            engine.forward(images)
            torch.cuda.synchronize()
        by = collections.defaultdict(lambda: [0.0, 0])
        kinds = collections.defaultdict(lambda: [0.0, 0])
        for e in prof.events():
            # The annotate spans show on the device timeline too; they are
            # no kernels.
            if e.device_type == DeviceType.CUDA and e.name not in SPANS:
                kinds[kind_of(e.name)][0] += e.time_range.elapsed_us()
                kinds[kind_of(e.name)][1] += 1
            if (e.device_type == DeviceType.CPU and e.kernels
                    and e.name.startswith("aten::")):
                for k in e.kernels:
                    row = by[(kind_of(k.name), outer_op(e))]
                    row[0] += k.duration
                    row[1] += 1
        for kind, (us, n) in kinds.items():
            got = [v for (k2, _), v in by.items() if k2 == kind]
            rest = (us - sum(v[0] for v in got), n - sum(v[1] for v in got))
            if rest[1]:
                by[(kind, "(no aten op: ctypes)")] = list(rest)
        total = sum(us for us, _ in kinds.values())
        print(f"sites, {name}: {total / 1e3:.3f} device ms in "
              f"{sum(n for _, n in kinds.values())} launches, one forward of "
              f"{images.shape[0]} I420 frames (torch.profiler) [{card}]")
        for kind, (us, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
            print(f"  {us / 1e3:8.3f} ms  {n:5d} launches  {kind}")
            for (k2, op), (o_us, o_n) in sorted(by.items(),
                                                key=lambda kv: -kv[1][0]):
                if k2 == kind:
                    print(f"      {o_us / 1e3:8.3f} ms  {o_n:5d}  {op}")


def profile_training(card: str) -> None:
    """Device ms by range and kernel kind of one full-width train step."""
    from torch.autograd import DeviceType

    from chip_smoke import TRAIN_BATCH, train_batch
    from smap_tpu_torch.config import Config
    from smap_tpu_torch.losses import smap_loss
    from smap_tpu_torch.models.smap import init_smap
    from smap_tpu_torch.train.step import (create_train_state,
                                           render_labels, training_model)

    cfg = Config()
    dev = torch.device("cuda", torch.cuda.current_device())
    batch = train_batch(np.random.RandomState(0),
                        torch.Generator(dev).manual_seed(0), cfg,
                        TRAIN_BATCH, dev)
    state = create_train_state(
        training_model(init_smap(cfg.model, seed=0), dev), cfg)
    model, opt = state.model, state.optimizer

    def step(ranges):
        """train_step_with_labels, in four synchronized ranges."""
        def timed(name, fn):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn()
                torch.cuda.synchronize()
            ranges[name].append((time.perf_counter() - t0) * 1e3)
            return out

        labels, rdepth = timed("labels", lambda: render_labels(batch,
                                                               cfg=cfg))
        opt.zero_grad(set_to_none=True)
        losses = timed("forward", lambda: smap_loss(
            model(batch.images), batch.valids, labels, rdepth, cfg.train))
        timed("backward", lambda: losses["total_loss"].backward())
        timed("optimizer", lambda: (opt.step(), state.scheduler.step()))

    warm = collections.defaultdict(list)
    for _ in range(2):
        step(warm)
    host = collections.defaultdict(list)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(TRAIN_STEPS):
            step(host)
    events = prof.events()
    windows = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in events if e.name in TRAIN_RANGES
                     and e.device_type == DeviceType.CPU)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in TRAIN_RANGES]
    by = {r: collections.defaultdict(lambda: [0.0, 0]) for r in TRAIN_RANGES}
    for e in kernels:
        for start, end, name in windows:
            if start <= e.time_range.start < end:
                kind = by[name][kind_of(e.name, TRAIN_KINDS)]
                kind[0] += e.time_range.elapsed_us()
                kind[1] += 1
                break
    total = sum(us for r in by.values() for us, _ in r.values())
    print(f"training step: {total / TRAIN_STEPS / 1e3:.3f} device ms per "
          f"step at batch {TRAIN_BATCH} (ModelConfig() "
          f"{cfg.input_shape[0]}x{cfg.input_shape[1]}, "
          f"{cfg.model.compute_dtype}; torch.profiler, mean of "
          f"{TRAIN_STEPS} steps, each range ended by a synchronize) "
          f"[{card}]")
    for name in TRAIN_RANGES:
        us = sum(v[0] for v in by[name].values())
        n = sum(v[1] for v in by[name].values())
        print(f"  {name}: {us / TRAIN_STEPS / 1e3:.3f} device ms in "
              f"{n / TRAIN_STEPS:.0f} kernels; host "
              f"{np.mean(host[name]):.3f} ms (synchronized, profiler on)")
        for kind, (k_us, k_n) in sorted(by[name].items(),
                                        key=lambda kv: -kv[1][0]):
            print(f"    {k_us / TRAIN_STEPS / 1e3:8.3f} ms  "
                  f"{k_n / TRAIN_STEPS:5.0f} launches  {kind}")


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    if args not in ([], ["--sites"]):
        print("usage: python3 profile_forward.py [--sites]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_forward: torch.cuda is not available; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import card_line, perturbed_state_dict, serving_batches
    from smap_tpu_torch.config import Config
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.models.smap import init_smap
    from smap_tpu_torch.runtime import set_tf32

    set_tf32(False)
    card = card_line()
    cfg = Config()
    frames, scales = serving_batches(cfg)[0]
    sd = perturbed_state_dict(cfg.model, seed=0)
    engines = {
        "unfolded": SMAPInference(sd, cfg, device="cuda"),
        "folded-unfused": SMAPInference(sd, cfg, device="cuda",
                                        quantized="folded"),
        "folded-fused": SMAPInference(sd, cfg, device="cuda",
                                      quantized="folded", fuse_stem=True,
                                      fuse_bottleneck=True),
        "int8-static": SMAPInference(sd, cfg, device="cuda",
                                     quantized="static",
                                     calibration_batches=frames),
        "int8-dynamic": SMAPInference(sd, cfg, device="cuda",
                                      quantized=True)}
    if args:
        from smap_tpu_torch.data.preprocess import bgr_to_i420

        i420 = np.stack([bgr_to_i420(f) for f in frames])
        profile_sites({k: engines[k] for k in ("unfolded", "folded-fused",
                                                "int8-static")},
                      engines["unfolded"].to_device(i420), card)
        print(card)
        return 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, engine in engines.items():
        images = engine.place(frames, scales)[0]
        for _ in range(3):
            engine.forward(images)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(FORWARDS):
                engine.forward(images)
            torch.cuda.synchronize()
        times = device_times(prof)
        by_kind = collections.defaultdict(lambda: [0.0, 0])
        for kname, (us, n) in times.items():
            by_kind[kind_of(kname)][0] += us
            by_kind[kind_of(kname)][1] += n
        total = sum(us for us, _ in times.values()) / FORWARDS / 1e3
        print(f"{name}: {total:.3f} device ms per forward (sum over "
              f"kernels, mean of {FORWARDS}) [{card}]")
        for kind, (us, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
            print(f"  {us / FORWARDS / 1e3:8.3f} ms  {n / FORWARDS:5.0f} "
                  f"launches  {kind}")
        print("  largest kernels:")
        for kname, (us, n) in sorted(times.items(),
                                     key=lambda kv: -kv[1][0])[:10]:
            print(f"  {us / FORWARDS / 1e3:8.3f} ms  {n / FORWARDS:5.0f} "
                  f"launches  {kname[:100]}")
    decoder = SMAPInference(init_smap(cfg.model, seed=0).state_dict(), cfg,
                            device="cuda")
    with torch.no_grad():
        profile_decode(decoder, frames, scales, card)
    del engines, decoder
    profile_training(card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

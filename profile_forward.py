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

Then the decode: ``postprocess`` (peaks, kernel A, kernel B, depth, back-
projection) of the unfolded engine's maps of that batch of 16, the frames
of ``chip_smoke.py`` phase 4. It prints the synchronized host ms of a
decode without the profiler, and from ``torch.profiler`` over 3 decodes:
device ms and kernels per decode by kind, the device's idle share of
each decode's window (from the decode's start on the host to the end of
its last kernel), and the device kernels, copies and fills that one
``associate`` call on the decode's own inputs puts on the card (profiled
apart, 3 calls). Last, the card's name and power limit. Needs the card:
without one it exits non-zero.
"""

from __future__ import annotations

import collections
import re
import sys
import time

import torch

FORWARDS = 3
DECODES = 3
KINDS = (   # first match wins
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


def device_times(prof) -> dict:
    """Kernel name -> [summed device microseconds, launches] over the
    profiled run."""
    from torch.autograd import DeviceType

    times = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            times[e.name][0] += e.time_range.elapsed_us()
            times[e.name][1] += 1
    return times


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


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


def main() -> int:
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
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

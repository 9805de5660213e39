#!/usr/bin/env python3
"""Where the device time of one serving forward goes, on a CUDA card.

    python3 profile_forward.py          # from the repository root, one card

Builds the three bf16 engines that ``chip_smoke.py`` phase 6 compares
(unfolded, BN-folded with cuDNN convolutions, BN-folded with kernels C and
D) at full width (``ModelConfig()``, 512x832, the same seeded weights and
BatchNorm statistics), warms each up, and runs ``torch.profiler`` over 3
forwards of the same batch of 16 letterboxed frames per engine. Prints, per
engine, the device time per forward summed over the card's kernels, by
kind (kernel C, kernel D, convolutions, elementwise passes, ...) and the
ten largest kernels by name, then the card's name and power limit. Needs
the card: without one it exits non-zero.
"""

from __future__ import annotations

import collections
import re
import sys

import torch

FORWARDS = 3
KINDS = (   # first match wins
    ("kernel D (fused_bottleneck_kernel)", r"fused_bottleneck_kernel"),
    ("kernel C (fused_stem_kernel)", r"fused_stem_kernel"),
    ("BatchNorm", r"batch_norm"),
    ("bilinear upsampling", r"upsample|bilinear"),
    ("max-pool", r"max_pool"),
    ("convolutions (cuDNN / cuBLAS)",
     r"conv|xmma|cudnn|gemm|cutlass|nvjet|sm90_|sm80_|implicit"),
    ("elementwise (bias add, ReLU, residual add, casts, copies)",
     r"elementwise|vectorized|copy|fill|reduce"),
)


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_forward: torch.cuda is not available; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import card_line, perturbed_state_dict, serving_batches
    from smap_tpu_torch.config import Config
    from smap_tpu_torch.inference import SMAPInference
    from smap_tpu_torch.runtime import set_tf32

    set_tf32(False)
    card = card_line()
    cfg = Config()
    sd = perturbed_state_dict(cfg.model, seed=0)
    engines = {
        "unfolded": SMAPInference(sd, cfg, device="cuda"),
        "folded-unfused": SMAPInference(sd, cfg, device="cuda",
                                        quantized="folded"),
        "folded-fused": SMAPInference(sd, cfg, device="cuda",
                                      quantized="folded", fuse_stem=True,
                                      fuse_bottleneck=True)}
    frames, scales = serving_batches(cfg)[0]
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
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Streaming serving loop: image or video frames -> 3D poses as JSON lines,
``python -m smap_tpu_torch.serve``.

* Frames come from an image directory (polled for new ones with
  ``--watch``) or a video file (OpenCV's ``VideoCapture``; OpenCV is
  needed for video only, PNG and JPEG are decoded without it).
* Each frame is letterboxed on the host and shipped as packed I420 (1.5
  bytes a pixel), converted and normalized on the device.
* Batches run through ``SMAPInference.run_stream`` with one batch in
  flight; an idle watch poll flushes the partial batch and the slot.
* The decode runs on the capacity ladder (``--adaptive-capacities``).
* ``--data-parallel`` splits each batch over every card of this host, one
  replica of the engine a card (the batch size must divide by their
  count).
* One JSON line per frame (the ``3d_pairs`` item schema), flushed per
  batch; at the end one summary line on stderr: frames, seconds from the
  first frame read to the last line written, frames/s and the launches of
  each CUDA kernel.

Kernels on the card: every mode launches A (PAF scoring) and B
(association) once a batch; ``--folded --fuse-stem --fuse-bottleneck``
adds C (the stem) and D (the bottlenecks); ``--int8`` / ``--int8-static``
run every convolution as E.

Usage:
  python -m smap_tpu_torch.serve --source imgs -p SMAP.pth --out poses.jsonl
  python -m smap_tpu_torch.serve --source imgs --watch -p SMAP.pth --out -
  python -m smap_tpu_torch.serve --source clip.mp4 --video-stride 2 ...
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

from smap_tpu_torch.config import Config


def iter_frames(source: str, watch: bool, poll_s: float = 0.5):
    """Image paths under ``source``; with ``watch``, keep polling for new
    ones and yield None after an idle poll (the caller flushes its partial
    batch then).

    In watch mode the dedup set forgets deleted files (it stays bounded),
    and a file is yielded only once its mtime is at least one poll old: a
    frame still being written is not decoded truncated."""
    seen = set()
    while True:
        paths = []
        for ext in ("jpg", "png", "jpeg"):
            paths.extend(glob.glob(os.path.join(source, f"**/*.{ext}"),
                                   recursive=True))
        if watch:
            seen &= set(paths)
        now = time.time()
        fresh = []
        for p in sorted(paths):
            if p in seen:
                continue
            if watch:
                try:
                    # Absolute age: a producer clock ahead of ours must not
                    # hold a frame back until our clock catches up.
                    if abs(now - os.stat(p).st_mtime) < poll_s:
                        continue
                except OSError:
                    continue       # deleted between glob and stat
            seen.add(p)
            fresh.append(p)
        yield from fresh
        if not watch:
            return
        if not fresh:
            yield None
        time.sleep(poll_s)


def iter_video_frames(source: str, stride: int = 1):
    """(name, BGR frame) of every ``stride``-th frame of a video file,
    read with OpenCV (an ImportError where it is absent); the name carries
    the frame index."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{source}: reading video needs OpenCV (cv2), "
                          f"which is not installed") from e

    cap = cv2.VideoCapture(source)
    if not cap.isOpened():
        raise SystemExit(f"cannot open video source: {source}")
    try:
        i = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            if i % stride == 0:
                yield f"{source}#frame{i:06d}", frame
            i += 1
    finally:
        cap.release()


def wire_frame(raw: np.ndarray, cfg: Config):
    """A BGR frame -> (packed I420 of its letterbox, scale dict)."""
    from smap_tpu_torch.data.preprocess import bgr_to_i420, letterbox_image

    img, scale = letterbox_image(raw, cfg.input_shape)
    return bgr_to_i420(img), scale


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the serving loop; returns the summary it prints on stderr."""
    parser = argparse.ArgumentParser(
        prog="python -m smap_tpu_torch.serve",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", required=True,
                        help="image directory or video file")
    parser.add_argument("--watch", action="store_true",
                        help="keep polling for new frames (directory only)")
    parser.add_argument("--video-stride", type=int, default=1,
                        help="keep every Nth frame of a video source")
    parser.add_argument("--smap-path", "-p", default="")
    parser.add_argument("--ckpt-dir", default="")
    parser.add_argument("--refine-path", "-rp", default="")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--adaptive-capacities", default="8,16,40",
                        help="peak-capacity ladder ('' decodes at "
                        "assoc_peaks)")
    parser.add_argument("--int8", action="store_true",
                        help="int8 forward: BatchNorm folded, int8 weights, "
                        "activation scales taken per call (kernel E)")
    parser.add_argument("--int8-static", action="store_true",
                        help="int8 forward with activation scales calibrated "
                        "once on up to one batch of --calib-dir frames "
                        "(default: the --source directory)")
    parser.add_argument("--calib-dir", default="",
                        help="image directory for --int8-static calibration")
    parser.add_argument("--folded", action="store_true",
                        help="bf16 forward with BatchNorm folded into the "
                        "convolutions")
    parser.add_argument("--fuse-stem", action="store_true",
                        help="with --folded: the stem as kernel C")
    parser.add_argument("--fuse-bottleneck", action="store_true",
                        help="with --folded: the eligible bottlenecks as "
                        "kernel D")
    parser.add_argument("--data-parallel", action="store_true",
                        help="split each batch over every card of this host "
                        "(batch_size must divide by their count)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--out", default="-",
                        help="output JSONL path ('-' = stdout)")
    args = parser.parse_args(argv)

    if sum((args.int8, args.int8_static, args.folded)) > 1:
        parser.error("--int8 / --int8-static / --folded are mutually "
                     "exclusive")
    if (args.fuse_stem or args.fuse_bottleneck) and not args.folded:
        parser.error("--fuse-stem / --fuse-bottleneck need --folded")

    from smap_tpu_torch.inference import (SMAPInference, image_paths,
                                          read_frame)
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.postprocess import PoseResults
    from smap_tpu_torch.parallel import mesh
    from smap_tpu_torch.test_smap import (load_refine_state_dict,
                                          load_smap_state_dict, parse_ladder)

    cfg = Config()
    state_dict = load_smap_state_dict(args)
    refine_state_dict = load_refine_state_dict(args)
    calibration_batches = None
    quantized = "folded" if args.folded else args.int8
    if args.int8_static:
        calib_dir = args.calib_dir or (
            args.source if os.path.isdir(args.source) else "")
        if not calib_dir:
            parser.error("--int8-static needs --calib-dir (or a directory "
                         "--source to calibrate on)")
        calib_paths = image_paths(calib_dir)[:args.batch_size]
        if not calib_paths:
            raise SystemExit(f"no calibration images under {calib_dir}")
        calibration_batches = [np.stack(
            [wire_frame(read_frame(p), cfg)[0] for p in calib_paths])]
        quantized = "static"

    devices = None
    if args.data_parallel:
        devices = mesh.local_mesh(args.device)
        if args.batch_size % len(devices):
            parser.error(f"--batch_size {args.batch_size} must be divisible "
                         f"by the {len(devices)} cards")
    engine = SMAPInference(state_dict, cfg, refine_state_dict,
                           device=args.device, quantized=quantized,
                           fuse_stem=args.fuse_stem,
                           fuse_bottleneck=args.fuse_bottleneck,
                           calibration_batches=calibration_batches,
                           adaptive_capacities=parse_ladder(
                               args.adaptive_capacities),
                           devices=devices)

    if os.path.isdir(args.source):
        def frames():
            """(name, BGR) per frame; None on idle watch polls."""
            from smap_tpu_torch.data.image import imread

            for path in iter_frames(args.source, args.watch):
                if path is None:
                    yield None
                    continue
                raw = imread(path)
                if raw is not None:
                    yield path, raw
    else:
        def frames():
            yield from iter_video_frames(args.source, args.video_stride)

    # run_stream items: (I420 stack, scales), or None to flush the slot in
    # flight; `meta` holds (names, real count) of each batch dispatched.
    meta = collections.deque()

    def batches():
        imgs, names, scales = [], [], []

        def make_batch():
            n = len(imgs)
            batch = imgs + [np.zeros_like(imgs[0])] * (args.batch_size - n)
            sc = scales + [scales[-1]] * (args.batch_size - n)
            meta.append((list(names), n))
            imgs.clear()
            names.clear()
            scales.clear()
            return np.stack(batch), sc

        for item in frames():
            if item is None:     # idle poll: dispatch the partial batch
                if imgs:
                    yield make_batch()
                yield None
                continue
            name, raw = item
            packed, scale = wire_frame(raw, cfg)
            imgs.append(packed)
            names.append(name)
            scales.append(scale)
            if len(imgs) == args.batch_size:
                yield make_batch()
        if imgs:
            yield make_batch()

    kernels.reset_launch_counts()
    sink = sys.stdout if args.out == "-" else open(args.out, "a")
    served = 0
    t0 = time.perf_counter()
    try:
        for res in engine.run_stream(batches()):
            names, n = meta.popleft()
            pairs = engine.results_to_pairs(
                PoseResults(*(r[:n] for r in res)), names)
            for item in pairs:
                sink.write(json.dumps(item) + "\n")
            sink.flush()
            served += n
    finally:
        if sink is not sys.stdout:
            sink.close()
    seconds = time.perf_counter() - t0
    summary = {"frames": served, "seconds": seconds,
               "frames_per_s": served / seconds if seconds > 0 else 0.0,
               "kernel_launches": dict(kernels.LAUNCHES)}
    print(json.dumps(summary), file=sys.stderr, flush=True)
    return summary


if __name__ == "__main__":
    main()

"""SMAP inference and result generation: ``python -m smap_tpu_torch.test_smap``.

Three modes:

* ``run_inference``: an image directory (``--dataset_path``) -> result
  JSON;
* ``generate_result``: a labeled set (``--test-json`` / ``--test-root``)
  -> result JSON with the ground truth, registered person by person;
* ``generate_train``: the same set -> RefineNet training pairs.

The result goes to ``<output-dir>/stage3_root2_{mode}_{data_mode}
{_json_name}.json``. Weights: a reference-layout ``.pth`` (``-p``) or the
latest checkpoint of a training run (``--ckpt-dir``, the ``--output-dir``
of ``smap_tpu_torch.train_smap``). Runs on ``--device`` (the card unless
``cpu`` is asked for). PNG and JPEG frames need no OpenCV. At the end
one JSON line on stderr gives this process's launches of each CUDA
kernel (A and B once a batch). ``--profile-dir`` traces the inference
(``utils.profiling.trace``; in a process group, one file a rank).

``--data-parallel`` splits each batch over every card of this host (one
process). ``--distributed`` (under ``torchrun``, or with
``--coordinator`` / ``--num-processes`` / ``--process-id`` in each
process): each rank takes a contiguous shard of the labeled set, the
results are gathered in rank order, and rank 0 writes the JSON.

Usage:
  python -m smap_tpu_torch.test_smap -p SMAP.pth --dataset_path imgs
  python -m smap_tpu_torch.test_smap -t generate_train -p SMAP.pth \\
      --test-json annot.json --test-root imgs -d generation
  torchrun --nproc-per-node 8 -m smap_tpu_torch.test_smap --distributed \\
      -t generate_result -p SMAP.pth --test-json annot.json --test-root imgs
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Sequence

import torch

from smap_tpu_torch.config import Config
from smap_tpu_torch.parallel import distributed


def load_smap_state_dict(args) -> Dict[str, torch.Tensor]:
    """SMAP weights from ``args.smap_path`` (a ``.pth``) or the latest
    checkpoint under ``args.ckpt_dir``; exits with a message when neither
    is there."""
    from smap_tpu_torch.models.convert import load_torch_checkpoint
    from smap_tpu_torch.train.engine import CheckpointManager

    if args.smap_path:
        if not os.path.exists(args.smap_path):
            raise SystemExit(f"No such checkpoint of SMAP {args.smap_path}")
        return load_torch_checkpoint(args.smap_path)
    if args.ckpt_dir:
        directory = os.path.join(args.ckpt_dir, "checkpoints")
        if not os.path.isdir(directory):
            raise SystemExit(f"no checkpoints under {args.ckpt_dir}")
        try:
            return CheckpointManager(directory).model_state_dict()
        except FileNotFoundError as e:
            raise SystemExit(str(e)) from None
    raise SystemExit("one of --smap-path / --ckpt-dir is required")


def load_refine_state_dict(args) -> Optional[Dict[str, torch.Tensor]]:
    """RefineNet weights from ``args.refine_path``, or None."""
    from smap_tpu_torch.models.convert import load_torch_checkpoint

    if not args.refine_path:
        return None
    if not os.path.exists(args.refine_path):
        raise SystemExit(f"No such checkpoint of RefineNet "
                         f"{args.refine_path}")
    return load_torch_checkpoint(args.refine_path)


def parse_ladder(text: str):
    """``"8,16,40"`` -> (8, 16, 40); ``""`` -> None."""
    return tuple(int(c) for c in text.split(",")) if text else None


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Runs the CLI; returns the path of the result JSON (written by the
    main process)."""
    parser = argparse.ArgumentParser(
        prog="python -m smap_tpu_torch.test_smap",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--test_mode", "-t", default="run_inference",
                        choices=["generate_train", "generate_result",
                                 "run_inference"])
    parser.add_argument("--data_mode", "-d", default="test",
                        choices=["test", "generation"])
    parser.add_argument("--smap-path", "-p", default="",
                        help="SMAP .pth in the reference layout")
    parser.add_argument("--ckpt-dir", default="",
                        help="a train_smap --output-dir: its latest "
                        "checkpoint")
    parser.add_argument("--refine-path", "-rp", default="",
                        help="RefineNet .pth")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--do_flip", type=float, default=0)
    parser.add_argument("--dataset_path", default="",
                        help="image directory for run_inference")
    parser.add_argument("--test-json", default="",
                        help="unified annotation JSON for the generate "
                        "modes")
    parser.add_argument("--test-root", default="",
                        help="image root for the generate modes")
    parser.add_argument("--json_name", default="")
    parser.add_argument("--output-dir", default="model_logs/stage3_root2/result")
    parser.add_argument("--adaptive-capacities", default="",
                        help="peak-capacity ladder for run_inference, e.g. "
                        "8,16,40 ('' decodes at assoc_peaks)")
    parser.add_argument("--data-parallel", action="store_true",
                        help="split each batch over every card of this host "
                        "(batch_size must divide by their count)")
    parser.add_argument("--profile-dir", default="",
                        help="trace the run (host, and the card's kernels) "
                        "into this directory as a Chrome trace, one file a "
                        "rank (Perfetto / TensorBoard)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; under NCCL the rank's own "
                        "card) or cpu")
    distributed.add_flags(parser)
    args = parser.parse_args(argv)

    distributed.initialize_from(args)
    try:
        return _run(parser, args)
    finally:
        distributed.finalize_distributed()


def _run(parser: argparse.ArgumentParser, args: argparse.Namespace) -> str:
    from smap_tpu_torch.data.datasets import JointDataset, load_annotations
    from smap_tpu_torch.inference import (SMAPInference, run_inference,
                                          run_labeled_inference)
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.parallel import mesh
    from smap_tpu_torch.utils.profiling import trace

    kernels.reset_launch_counts()
    cfg = Config()
    state_dict = load_smap_state_dict(args)
    refine_state_dict = load_refine_state_dict(args)
    os.makedirs(args.output_dir, exist_ok=True)
    suffix = f"_{args.json_name}" if args.json_name else ""
    out_json = os.path.join(
        args.output_dir,
        f"stage3_root2_{args.test_mode}_{args.data_mode}{suffix}.json")

    if args.test_mode == "run_inference":
        with trace(args.profile_dir):
            run_inference(
                args.dataset_path, state_dict, cfg,
                refine_state_dict=refine_state_dict,
                do_flip=bool(args.do_flip), batch_size=args.batch_size,
                output_json=(out_json if distributed.is_main_process()
                             else None), device=args.device,
                adaptive_capacities=parse_ladder(args.adaptive_capacities),
                data_parallel=args.data_parallel)
    else:
        if not args.test_json:
            parser.error(f"-t {args.test_mode} needs --test-json and "
                         f"--test-root")
        stage = "generation" if args.test_mode == "generate_train" else "test"
        dataset = JointDataset(load_annotations(args.test_json),
                               {"MUPOTS": args.test_root,
                                "MUCO": args.test_root},
                               cfg, stage, with_augmentation=False)
        devices = mesh.local_mesh(args.device) if args.data_parallel else None
        engine = SMAPInference(state_dict, cfg, refine_state_dict,
                               bool(args.do_flip), device=args.device,
                               devices=devices)
        with trace(args.profile_dir):
            result = run_labeled_inference(
                dataset, engine, mode=args.test_mode,
                batch_size=args.batch_size,
                shard=distributed.process_index(),
                num_shards=distributed.process_count(),
                gather=distributed.process_count() > 1)
        if distributed.is_main_process():
            with open(out_json, "w") as f:
                json.dump(result, f)
    print(json.dumps({"rank": distributed.process_index(),
                      "kernel_launches": dict(kernels.LAUNCHES)}),
          file=sys.stderr, flush=True)
    if distributed.is_main_process():
        print(f"results written to {out_json}")
    return out_json


if __name__ == "__main__":
    main()

"""SMAP training: ``python -m smap_tpu_torch.train_smap``.

Reads unified annotation JSONs (MuCo and/or COCO), augments each sample
on the host (``data.augmentation``: rotation, fit-scale, crop, flip; PNG
and JPEG frames, no OpenCV), and trains on one device with
``train.engine.Trainer``: loss lines every ``--log-every`` steps (also in
``<output-dir>/tb_dir/metrics.jsonl``), checkpoints in
``<output-dir>/checkpoints/<step>.pt``. ``--resume`` continues from the
latest checkpoint at its exact iteration. ``--profile-dir`` writes a
trace of steps 11-15 (``utils.profiling``).

Data parallel, one process a card: under ``torchrun`` (``--distributed``
reads its environment) or with ``--coordinator host:port
--num-processes N --process-id R`` in each process. Each rank loads its
shard of every global batch (``--batch-per-device`` samples), the global
batch being that times the world size, which also scales the learning
rate and the schedule; rank 0 writes the checkpoints and logs.

Usage:
  python -m smap_tpu_torch.train_smap --muco-json muco.json \\
      --muco-root imgs [--coco-json ... --coco-root ...] [--resume] \\
      [--max-steps N] [--batch-per-device B] [--num-workers W] \\
      [--profile-dir prof/]
  torchrun --nproc-per-node 8 -m smap_tpu_torch.train_smap --distributed \\
      --muco-json muco.json --muco-root imgs
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from smap_tpu_torch.config import Config
from smap_tpu_torch.parallel import distributed


def main(argv: Optional[Sequence[str]] = None):
    """Runs the CLI; returns the final ``TrainState``."""
    parser = argparse.ArgumentParser(
        prog="python -m smap_tpu_torch.train_smap",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--coco-json", default="")
    parser.add_argument("--muco-json", default="")
    parser.add_argument("--coco-root", default="")
    parser.add_argument("--muco-root", default="")
    parser.add_argument("--output-dir", default="model_logs/stage3_root2")
    parser.add_argument("--resume", "-c", action="store_true",
                        help="continue from the latest checkpoint")
    parser.add_argument("--max-steps", type=int, default=0,
                        help="train to this iteration (default: the "
                        "schedule's max_iter)")
    parser.add_argument("--batch-per-device", type=int, default=0,
                        help="batch size (default: TrainConfig."
                        "img_per_device)")
    parser.add_argument("--num-workers", type=int, default=0,
                        help="data-loading worker processes")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--grad-accum-steps", type=int, default=1,
                        help="microbatches a step (the batch must divide "
                        "by it)")
    parser.add_argument("--profile-dir", default="",
                        help="trace steps 11-15 (host, and the card's "
                        "kernels) into this directory as a Chrome trace "
                        "(Perfetto / TensorBoard)")
    parser.add_argument("--log-every", type=int, default=20,
                        help="log the losses every N steps")
    parser.add_argument("--deterministic", action="store_true",
                        help="PyTorch's deterministic algorithms: the run "
                        "repeats bit for bit")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; under NCCL the rank's own "
                        "card) or cpu")
    distributed.add_flags(parser)
    args = parser.parse_args(argv)

    from smap_tpu_torch.data.datasets import (JointDataset, load_annotations,
                                              train_iterator)
    from smap_tpu_torch.runtime import deterministic_algorithms
    from smap_tpu_torch.train.engine import Trainer, TrainerConfig

    cfg = Config()
    records, roots = [], {}
    if args.coco_json:
        records += load_annotations(args.coco_json)
        roots["COCO"] = args.coco_root
    if args.muco_json:
        records += load_annotations(args.muco_json)
        roots["MUCO"] = args.muco_root
    if not records:
        parser.error("at least one of --coco-json / --muco-json is required")
    dataset = JointDataset(records, roots, cfg, "train",
                           with_augmentation=True,
                           with_mds=cfg.train.with_mds)

    distributed.initialize_from(args)
    try:
        trainer = Trainer(cfg, TrainerConfig(
            output_dir=args.output_dir, log_every=args.log_every,
            seed=args.seed, grad_accum_steps=args.grad_accum_steps,
            profile_dir=args.profile_dir),
            device=args.device)
        try:
            batch = args.batch_per_device or cfg.train.img_per_device
            max_iter = args.max_steps or trainer.scaled_max_iter()
            state = trainer.init_state(args.seed)
            if args.resume:
                state = trainer.ckpt.restore(state)
                trainer.logger.info("resumed at iteration %d", state.step)
            batches = train_iterator(dataset, batch, max_iter,
                                     start_iter=state.step, seed=args.seed,
                                     num_shards=distributed.process_count(),
                                     shard=distributed.process_index(),
                                     num_workers=args.num_workers)
            try:
                with deterministic_algorithms(args.deterministic):
                    return trainer.fit(batches, state=state,
                                       max_steps=max_iter)
            finally:
                batches.close()
        finally:
            trainer.close()
    finally:
        distributed.finalize_distributed()


if __name__ == "__main__":
    main()

"""Rank functions of the port's multi-process tests
(tests/test_torch_distributed.py, test_torch_parallel.py,
test_torch_cli.py), run in
fresh processes by ``smap_tpu_torch.parallel.distributed.spawn_ranks``.
They import no JAX: each joins a gloo group on the CPU, runs what the test
asks for on its share, and returns numpy results to the test.

Run as a script, this file is an entry point for ``torchrun`` (``python -m
torch.distributed.run --nproc-per-node N tests/torch_dist_workers.py
<module> <config.pkl> <out> <args>...``): see ``torchrun_rank``."""

import hashlib

import numpy as np
import torch

from smap_tpu_torch.parallel import distributed

RANK_TIMEOUT_S = 120


def _join(rank, world, coordinator):
    torch.set_num_threads(1)
    distributed.initialize_distributed(coordinator, world, rank,
                                       backend="gloo",
                                       timeout_s=RANK_TIMEOUT_S)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _train_model(cfg, state_dict, dtype):
    from smap_tpu_torch.models.smap import SMAP
    from smap_tpu_torch.train.step import training_model

    model = SMAP(cfg.model)
    model.load_state_dict(state_dict)
    model = training_model(model, torch.device("cpu"))
    if dtype == torch.float64:
        model.double().compute_dtype = torch.float64
    return model


def train_step_result(cfg, state_dict, batch, dtype, accum_steps=1,
                      perturb=False):
    """One ``train_step`` from ``state_dict`` on ``batch`` (numpy arrays)
    through ``create_train_state`` (rank 0's weights are broadcast, so a
    ``perturb``-ed model of another rank does not matter): the losses,
    gradients, running statistics and a digest of the new parameters. In
    float64 the maps stay float64, as tests/torch_train_parity.port_step
    keeps them."""
    import smap_tpu_torch.models.smap as psmap
    from smap_tpu_torch.train import step as tstep

    model = _train_model(cfg, state_dict, dtype)
    if perturb:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1e-3)
    nhwc = psmap._nhwc_f32
    if dtype == torch.float64:
        psmap._nhwc_f32 = lambda r: (None if r is None
                                     else r.permute(0, 2, 3, 1))
    try:
        state = tstep.create_train_state(model, cfg,
                                         distributed.process_count())
        state, losses = tstep.train_step(state, tstep.TrainBatch(*batch),
                                         cfg=cfg, accum_steps=accum_steps)
    finally:
        psmap._nhwc_f32 = nhwc
    return dict(
        losses={k: v.item() for k, v in losses.items()},
        grads={n: p.grad.numpy().copy()
               for n, p in model.named_parameters()},
        stats={n: v.numpy().copy() for n, v in model.state_dict().items()
               if "running_" in n or "num_batches" in n},
        params=_digest(list(model.parameters())))


def train_rank(rank, world, coordinator, scenarios):
    """Each scenario's ``train_step_result`` on this rank's contiguous
    share of its global batch; a scenario with ``sizes`` gives rank r the
    first ``sizes[r]`` samples of its share instead, and records the error
    it raises."""
    _join(rank, world, coordinator)
    try:
        out = []
        for sc in scenarios:
            b = len(sc["batch"][0]) // world
            n = sc.get("sizes", [b] * world)[rank]
            local = tuple(x[rank * b:rank * b + n] for x in sc["batch"])
            try:
                out.append(train_step_result(
                    sc["cfg"], sc["state_dict"], local, sc["dtype"],
                    sc.get("accum_steps", 1), perturb=rank > 0))
            except ValueError as e:
                if "sizes" not in sc:
                    raise
                out.append({"error": str(e)})
        return out
    finally:
        distributed.finalize_distributed()


def frame_key(img: np.ndarray) -> bytes:
    """A normalized frame's identity: a sparse grid of its values."""
    return np.ascontiguousarray(np.asarray(img)[::17, ::29]).tobytes()


def fed_engine(dataset, cfg, state_dict, maps):
    """A CPU engine whose forward returns the ideal maps ``maps[i]`` of
    the dataset's frame i for each frame it is given (zeros for
    padding): random weights alone decode nobody."""
    from smap_tpu_torch.inference import SMAPInference

    by_frame = {frame_key(dataset.get_eval_sample(i)[0]): maps[i]
                for i in range(len(dataset))}
    zeros = tuple(np.zeros_like(m) for m in maps[0])
    engine = SMAPInference(state_dict, cfg, device="cpu")

    def forward(images):
        per = [by_frame.get(frame_key(img), zeros) for img in images.numpy()]
        return tuple(torch.from_numpy(np.stack(m).astype(np.float32))
                     for m in zip(*per))

    engine.forward = forward
    return engine


def labeled_rank(rank, world, coordinator, annot, root, cfg, state_dict,
                 maps, batch_size):
    """This rank's shard of ``run_labeled_inference(gather=True)`` on the
    fed engine, and ``all_gather_objects`` of payloads of unequal sizes.
    The rank joins as under torchrun: from ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` (``env://``)."""
    import os

    from smap_tpu_torch.data.datasets import JointDataset, load_annotations
    from smap_tpu_torch.inference import run_labeled_inference

    torch.set_num_threads(1)
    host, port = coordinator.split(":")
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR=host,
                      MASTER_PORT=port)
    distributed.initialize_distributed(backend="gloo",
                                       timeout_s=RANK_TIMEOUT_S)
    try:
        dataset = JointDataset(load_annotations(annot), {"MUPOTS": root},
                               cfg, "test")
        engine = fed_engine(dataset, cfg, state_dict, maps)
        result = run_labeled_inference(dataset, engine, batch_size=batch_size,
                                       shard=rank, num_shards=world,
                                       gather=True)
        gathered = distributed.all_gather_objects(
            {"rank": rank, "payload": "x" * (10 + 7 * rank)})
        return dict(result=result, gathered=gathered,
                    count=distributed.process_count(),
                    main=distributed.is_main_process())
    finally:
        distributed.finalize_distributed()


def cli_rank(rank, world, coordinator, module, argvs, cfg, scene=None):
    """``smap_tpu_torch.<module>.main(argvs[rank])`` as this rank of a gloo
    group on the CPU, with the module's ``Config`` patched to ``cfg`` and,
    when ``scene`` is given, the engine's forward plus those maps (the
    in-process tests' ``small_cli`` and ``people_in_every_frame``). Returns
    main's result (a TrainState as its step and a digest of its
    parameters)."""
    import importlib

    from smap_tpu_torch.inference import SMAPInference

    torch.set_num_threads(1)
    mod = importlib.import_module(f"smap_tpu_torch.{module}")
    mod.Config = lambda: cfg
    if scene is not None:
        real = SMAPInference.forward

        def forward(self, images):
            return tuple(m + torch.from_numpy(s)
                         for m, s in zip(real(self, images), scene))

        SMAPInference.forward = forward
    out = mod.main([*argvs[rank], "--coordinator", coordinator,
                    "--num-processes", str(world), "--process-id",
                    str(rank), "--backend", "gloo", "--device", "cpu"])
    if hasattr(out, "model"):
        return {"step": out.step, "params": _digest(out.model.parameters())}
    return out


def torchrun_rank(module, config_path, out, *args):
    """This rank of a ``torchrun`` group: ``smap_tpu_torch.<module>.main(
    [*args, --distributed, --backend gloo, --device cpu])`` (torchrun's
    env:// rendezvous) with the module's ``Config`` patched to the one
    pickled at ``config_path``; writes main's result (as ``cli_rank``
    returns it) to ``<out>.rank<RANK>.json``."""
    import importlib
    import json
    import os
    import pickle

    with open(config_path, "rb") as f:
        cfg = pickle.load(f)
    torch.set_num_threads(1)
    mod = importlib.import_module(f"smap_tpu_torch.{module}")
    mod.Config = lambda: cfg
    res = mod.main([*args, "--distributed", "--backend", "gloo", "--device",
                    "cpu"])
    if hasattr(res, "model"):
        res = {"step": res.step, "params": _digest(res.model.parameters())}
    with open(f"{out}.rank{os.environ['RANK']}.json", "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    import sys

    torchrun_rank(*sys.argv[1:])

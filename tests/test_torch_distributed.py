"""Data-parallel training of the port (smap_tpu_torch/parallel/,
models/layers.py's global-batch BatchNorm, losses.root_count, train/step.py's
gradient average) in two gloo ranks on the CPU, against the JAX package's
single-process step on the whole global batch (what SPMD computes), and
against the port's own one-process step.

Both ranks run in fresh processes (``parallel.distributed.spawn_ranks``:
a free port, a rendezvous timeout, a join timeout, every rank killed when
one fails), each on its contiguous half of a seeded global batch, at
tests/torch_train_parity.py's tiny config in float64 (the ill-conditioned
train mode needs it, tests/test_torch_train_step.py): losses to
LOSS64_RTOL, every gradient and the running statistics to GRAD64_TOL (the
JAX package's gradients are rounded to its float32 parameters). The two
ranks' results must be bit-equal: the same losses, gradients, statistics
and new parameters.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import torch_train_parity as tp
from smap_tpu_torch.config import ROOT_IDX
from smap_tpu_torch.models.convert import smap_state_dict
from smap_tpu_torch.parallel.distributed import spawn_ranks
from torch_dist_workers import train_rank

SHAPE = (32, 48)
SPAWN_TIMEOUT_S = 300


def _interleave(batch):
    """The batch whose microbatches of 2 (accum_steps=2 in one process)
    are the global microbatches of two ranks each taking 2 samples and
    accumulating over 2: samples (0, 2) then (1, 3)."""
    return tuple(x[[0, 2, 1, 3]] for x in batch)


@pytest.fixture(scope="module")
def runs():
    """The scenarios, each run once in two ranks, and what they are held
    to."""
    from smap_tpu_torch.models.smap import init_smap

    jcfg, cfg = tp.cfgs(SHAPE)
    _, variables = tp.jax_variables(jcfg, seed=4)
    sd = smap_state_dict(variables)
    batch = tp.batch(np.random.RandomState(5), cfg, 4)
    one_sided = tuple(x.copy() for x in batch)
    one_sided[1][2:, :, ROOT_IDX, 3] = 0      # rank 1: no valid root
    one_sided[1][:2, :, ROOT_IDX, 3] = 2
    remat_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, stage_num=2, trunk_width=8, upsample_channels=16,
        remat=True))
    remat_sd = init_smap(remat_cfg.model, seed=6).state_dict()
    f64 = torch.float64
    scenarios = {
        "step": dict(cfg=cfg, state_dict=sd, batch=batch, dtype=f64),
        "one_sided": dict(cfg=cfg, state_dict=sd, batch=one_sided,
                          dtype=f64),
        "accum": dict(cfg=cfg, state_dict=sd, batch=batch, dtype=f64,
                      accum_steps=2),
        "remat": dict(cfg=remat_cfg, state_dict=remat_sd, batch=batch,
                      dtype=f64),
        "float32": dict(cfg=cfg, state_dict=sd, batch=batch,
                        dtype=torch.float32),
        "unequal": dict(cfg=cfg, state_dict=sd, batch=batch, dtype=f64,
                        sizes=[2, 1]),
    }
    got = spawn_ranks(train_rank, 2, list(scenarios.values()),
                      timeout_s=SPAWN_TIMEOUT_S)
    ranks = {name: [got[r][i] for r in range(2)]
             for i, name in enumerate(scenarios)}
    return dict(cfg=cfg, jcfg=jcfg, variables=variables, batch=batch,
                one_sided=one_sided, remat_cfg=remat_cfg, remat_sd=remat_sd,
                ranks=ranks)


def _one_process(cfg, state_dict, batch, dtype, accum_steps=1):
    from torch_dist_workers import train_step_result

    return train_step_result(cfg, state_dict, batch, dtype, accum_steps)


def _ranks_equal(pair):
    a, b = pair
    assert a["losses"] == b["losses"]
    assert a["params"] == b["params"]
    for key in ("grads", "stats"):
        assert a[key].keys() == b[key].keys()
        for n in a[key]:
            assert np.array_equal(a[key][n], b[key][n]), (key, n)
    return a


def _tracked(run):
    """The set of the BatchNorms' update counts after a step."""
    return {int(v) for n, v in run["stats"].items() if "num_batches" in n}


def _flat(d, names):
    return tp.flat([d[n] for n in names])


def _close(got, want, what, grad_tol=tp.GRAD64_TOL):
    """A rank's step against a one-process step (``want``: losses,
    grads, stats by the port's names)."""
    for k in tp.LOSS_RTOL:
        np.testing.assert_allclose(got["losses"][k], float(want["losses"][k]),
                                   rtol=tp.LOSS64_RTOL, err_msg=f"{what} {k}")
    names = sorted(got["grads"])
    assert tp.dist(_flat(got["grads"], names),
                   _flat(want["grads"], names)) < grad_tol, what
    stats = sorted(n for n in want["stats"] if "running_" in n)
    assert tp.dist(_flat(got["stats"], stats),
                   _flat(want["stats"], stats)) < 1e-6, what


def test_two_ranks_match_the_jax_global_batch_step(runs):
    """The float64 step of two ranks, each on half the batch, against the
    JAX package's train_step on the whole batch: losses, every gradient and
    the new running statistics."""
    import smap_tpu.train.step as jstep

    got = _ranks_equal(runs["ranks"]["step"])
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        tp.use_smap64(mp, jstep)
        want = tp.jax_step(jstep, runs["jcfg"], runs["variables"],
                           runs["batch"])
    _close(got, want, "2 ranks vs JAX")
    assert _tracked(got) == {1}


def test_two_ranks_match_one_process(runs):
    """The same step against the port's one-process step on the global
    batch, in float64 and in float32 (float32: losses 1e-5, gradients
    within the ill-conditioned train mode's float32 noise, 0.05)."""
    cfg, sd = runs["cfg"], smap_state_dict(runs["variables"])
    for dtype, name in ((torch.float64, "step"), (torch.float32, "float32")):
        got = _ranks_equal(runs["ranks"][name])
        want = _one_process(cfg, sd, runs["batch"], dtype)
        if dtype == torch.float64:
            _close(got, want, "2 ranks vs 1 process")
            continue
        for k in tp.LOSS_RTOL:
            np.testing.assert_allclose(got["losses"][k], want["losses"][k],
                                       rtol=1e-5, err_msg=k)
        names = sorted(got["grads"])
        assert tp.dist(_flat(got["grads"], names),
                       _flat(want["grads"], names)) < 0.05


def test_root_depth_count_is_global(runs):
    """Only rank 0 holds valid roots: its loss term divides by the global
    count over the world size, so the ranks' mean loss_root and gradient
    are the global batch's (a per-rank count would halve loss_root)."""
    cfg, sd = runs["cfg"], smap_state_dict(runs["variables"])
    got = _ranks_equal(runs["ranks"]["one_sided"])
    want = _one_process(cfg, sd, runs["one_sided"], torch.float64)
    _close(got, want, "one-sided roots")
    assert want["losses"]["loss_root"] > 0


def test_accumulation_and_remat_keep_their_meaning(runs):
    """accum_steps=2 in two ranks: each microbatch normalized by its
    global statistics, as one process accumulating over the same global
    microbatches; remat in two ranks as remat in one process."""
    cfg, sd = runs["cfg"], smap_state_dict(runs["variables"])
    got = _ranks_equal(runs["ranks"]["accum"])
    want = _one_process(cfg, sd, _interleave(runs["batch"]),
                        torch.float64, accum_steps=2)
    _close(got, want, "accumulation")
    got = _ranks_equal(runs["ranks"]["remat"])
    want = _one_process(runs["remat_cfg"], runs["remat_sd"], runs["batch"],
                        torch.float64)
    _close(got, want, "remat")
    assert _tracked(got) == {1}


def test_unequal_local_batches_raise_on_every_rank(runs):
    errors = [r.get("error", "") for r in runs["ranks"]["unequal"]]
    assert all("differ in size" in e for e in errors), errors


def test_batch_norm_without_a_group_is_the_native_path():
    """No process group, and a group of one: train-mode BatchNorm is
    torch.native_batch_norm bit for bit, and the running statistics move
    by the biased variance taken back from its inverse deviation."""
    import torch.distributed as dist

    from smap_tpu_torch.models.layers import BatchNorm1d, BatchNorm2d
    from smap_tpu_torch.parallel.distributed import (finalize_distributed,
                                                     free_port)

    gen = torch.Generator().manual_seed(0)

    def check():
        for bn, shape in ((BatchNorm2d(6, momentum=0.1), (3, 6, 5, 7)),
                          (BatchNorm1d(6, momentum=0.1), (9, 6))):
            with torch.no_grad():
                bn.weight.uniform_(0.5, 1.5, generator=gen)
                bn.bias.normal_(generator=gen)
            x = torch.randn(shape, generator=gen).to(torch.bfloat16)
            before = (bn.running_mean.clone(), bn.running_var.clone())
            y = bn.train()(x)
            want, mean, invstd = torch.native_batch_norm(
                x, bn.weight, bn.bias, None, None, True, 0.0, bn.eps)
            var = invstd.double().pow(-2).sub_(bn.eps).clamp_(min=0).float()
            assert y.dtype == x.dtype and torch.equal(y, want)
            m = bn.momentum
            assert torch.equal(bn.running_mean,
                               before[0].mul(1 - m).add(mean, alpha=m))
            assert torch.equal(bn.running_var,
                               before[1].mul(1 - m).add(var, alpha=m))

    check()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        check()
    finally:
        finalize_distributed()

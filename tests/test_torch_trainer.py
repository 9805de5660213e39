"""The port's Trainer (smap_tpu_torch/train/engine.py): its loop, logs,
metrics and checkpoints on the CPU, and gradient accumulation against the
JAX package's make_jitted_accum_step.

Tolerances: a resumed run equals the uninterrupted one bit for bit (same
code, same order of operations on the CPU). Accumulation against JAX: as
tests/test_torch_train_step.py explains (float64 runs of both packages,
maps, loss and gradients in float64: losses rtol 1e-7, statistics 1e-6,
gradients 1e-6; the port's float32 gradients within 10% and statistics
within 1e-5 of the float64 truth).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_train_parity as tp
from smap_tpu_torch.config import Config, ModelConfig, TrainConfig
from smap_tpu_torch.models.convert import smap_state_dict
from smap_tpu_torch.train import step as tstep
from smap_tpu_torch.train.engine import (CheckpointManager, Trainer,
                                         TrainerConfig)


def test_accumulation_matches_jax():
    """train_step(accum_steps=2) against make_jitted_accum_step (float64):
    the microbatch-mean losses, the averaged gradient and the statistics
    chained through both microbatches."""
    import smap_tpu.train.step as jstep
    from smap_tpu.parallel.mesh import make_mesh, shard_batch

    jcfg, cfg = tp.cfgs()
    _, variables = tp.jax_variables(jcfg, seed=4)
    s = dict(cfg=cfg, variables=variables,
             batch=tp.batch(np.random.RandomState(5), cfg, 2))
    tx = tp.expose_grads()
    mesh = make_mesh(jax.devices()[:1])
    stacked = jstep.TrainBatch(*(x.reshape(2, 1, *x.shape[1:])
                                 for x in s["batch"]))
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        # The scan carries the statistics, in float64 from the start.
        state = jstep.TrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=jax.tree.map(lambda a: np.asarray(a, np.float64),
                                     variables["batch_stats"]),
            opt_state=tx.init(variables["params"]))
        tp.use_smap64(mp, jstep)
        accum = jstep.make_jitted_accum_step(jcfg, mesh, tx, 2)
        new, losses = jax.device_get(
            accum(state, shard_batch(stacked, mesh, stacked=True)))
    jax64 = dict(losses=losses,
                 grads=smap_state_dict({"params": new.opt_state}),
                 stats=smap_state_dict({"params": variables["params"],
                                        "batch_stats": new.batch_stats}))
    port32 = tp.port_step(s, torch.float32, accum_steps=2)
    tp.check_step(port32, tp.port_step(s, torch.float64, accum_steps=2),
                  jax64, "accumulation")
    # Not the single-batch step: the statistics chained through two
    # microbatches differ from one step's on the whole batch.
    single = tp.port_step(s, torch.float32)[0].model.state_dict()
    names = tp.stat_names(single)
    assert tp.dist(tp.state_arrays(port32[0].model.state_dict(), names),
                   tp.state_arrays(single, names)) > 1e-3


def _cfg():
    """A narrow one-stage model at 32x48, checkpoint period 2 (one
    device, nominal_devices 1: no rescaling)."""
    out = (8, 12)
    return Config(
        model=ModelConfig(stage_num=1, trunk_width=8, upsample_channels=16,
                          output_shape=out, compute_dtype="float32"),
        train=TrainConfig(max_people=4, nominal_devices=1, max_iter=3,
                          checkpoint_period=2, warmup_iters=2),
        input_shape=(32, 48), output_shape=out)


def _batches(cfg, n, start=0):
    rng = np.random.RandomState(11)
    all_batches = [tstep.TrainBatch(*tp.batch(rng, cfg, 2)) for _ in range(n)]
    return [(i, all_batches[i]) for i in range(start, n)]


def _metrics(out_dir):
    with open(os.path.join(out_dir, "tb_dir", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _fit(cfg, out_dir, batches, tc_kw=(), **kw):
    tc = TrainerConfig(**{**dict(output_dir=str(out_dir), log_every=1,
                                 seed=3, grad_accum_steps=kw.pop("accum", 1)),
                          **dict(tc_kw)})
    trainer = Trainer(cfg, tc, device="cpu")
    try:
        state = trainer.fit(iter(batches), **kw)
        steps = trainer.ckpt.all_steps()
    finally:
        trainer.close()
    return state, steps


def _assert_same_state(a, b):
    for (k, x), (_, y) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert torch.equal(x, y), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, s in oa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a.step == b.step
    assert a.scheduler.state_dict() == b.scheduler.state_dict()


def test_fit_resume_equals_the_uninterrupted_run(tmp_path):
    """3 steps with a checkpoint at 2; a fresh Trainer resumed from it
    takes step 3 to the same model, optimizer, schedule and metrics, bit
    for bit. The log, metrics.jsonl and checkpoints follow the cadence."""
    cfg = _cfg()
    full, steps = _fit(cfg, tmp_path / "full", _batches(cfg, 3))
    assert full.step == 3 and steps == [2, 3]
    part, steps = _fit(cfg, tmp_path / "part", _batches(cfg, 2), max_steps=2)
    assert part.step == 2 and steps == [2]
    resumed, steps = _fit(cfg, tmp_path / "part", _batches(cfg, 3, start=2),
                          resume=True)
    assert steps == [2, 3]
    _assert_same_state(resumed, full)

    want = _metrics(tmp_path / "full")
    got = _metrics(tmp_path / "part")
    assert [r["step"] for r in want] == [r["step"] for r in got] == [1, 2, 3]
    keys = ("total_loss", "loss_2d", "loss_bone", "loss_root")
    for a, b in zip(got, want):
        assert set(keys) < set(a)
        assert [a[k] for k in keys] == [b[k] for k in keys]
        assert np.isfinite([a[k] for k in keys]).all()
    with open(tmp_path / "part" / "log.txt") as f:
        log = f.read()
    assert "Iter:3, total_loss:" in log and "resumed at iteration 2" in log
    assert "checkpoint saved at iteration 3" in log


def test_fit_with_accumulation_is_train_step_with_accumulation(tmp_path):
    """TrainerConfig.grad_accum_steps routes each batch through
    train_step(accum_steps=2): the same state as calling it directly."""
    cfg = _cfg()
    fitted, _ = _fit(cfg, tmp_path / "a", _batches(cfg, 2), max_steps=2,
                     accum=2)
    trainer = Trainer(cfg, TrainerConfig(output_dir=str(tmp_path / "b"),
                                         seed=3), device="cpu")
    state = trainer.init_state(3)
    trainer.close()
    for _, b in _batches(cfg, 2):
        state, _ = tstep.train_step(state, b, cfg=cfg, accum_steps=2)
    _assert_same_state(fitted, state)
    with pytest.raises(ValueError, match="not divisible"):
        tstep.train_step(state, tstep.TrainBatch(
            *(x[:1] for x in _batches(cfg, 1)[0][1])), cfg=cfg,
            accum_steps=2)


def _cadence_cfg():
    return dataclasses.replace(_cfg(), train=dataclasses.replace(
        _cfg().train, checkpoint_period=4, max_iter=100))


def test_fit_follows_the_jax_cadence(tmp_path):
    """log_every 2, checkpoint period 4 (the JAX package's expectations,
    tests/test_engine.py, at one step an execution): max_steps=5
    checkpoints at 4 and 5 and logs at 2, 4 and 5; an iterator of 3
    before max_iter stops at step 3 with no checkpoint beyond the
    periodic ones."""
    cfg = _cadence_cfg()
    tc = dict(log_every=2)
    state, steps = _fit(cfg, tmp_path / "a", _batches(cfg, 5), tc,
                        max_steps=5)
    assert state.step == 5 and steps == [4, 5]
    assert [r["step"] for r in _metrics(tmp_path / "a")] == [2, 4, 5]
    state, steps = _fit(cfg, tmp_path / "b", _batches(cfg, 3), tc,
                        max_steps=100)
    assert state.step == 3 and steps == []
    assert [r["step"] for r in _metrics(tmp_path / "b")] == [2]


def test_fit_with_a_trace_window_equals_untraced(tmp_path):
    """A trace of steps 3-4 changes no result: the same model, optimizer,
    schedule and losses, bit for bit, as the untraced run; the window
    writes one Chrome trace."""
    cfg = _cadence_cfg()
    plain, _ = _fit(cfg, tmp_path / "plain", _batches(cfg, 5), max_steps=5)
    prof = str(tmp_path / "prof")
    traced, steps = _fit(cfg, tmp_path / "traced", _batches(cfg, 5),
                         dict(profile_dir=prof, profile_first_step=2,
                              profile_num_steps=2), max_steps=5)
    _assert_same_state(traced, plain)
    assert steps == [4, 5]
    keys = ("step", "total_loss", "loss_2d", "loss_bone", "loss_root")
    assert [[r[k] for k in keys] for r in _metrics(tmp_path / "traced")] \
        == [[r[k] for k in keys] for r in _metrics(tmp_path / "plain")]
    assert len([f for f in os.listdir(prof)
                if f.endswith(".pt.trace.json")]) == 1


def test_fit_writes_a_trace_cut_short(tmp_path):
    """Training that ends inside the trace window still writes the trace
    (fit closes the window)."""
    cfg = _cadence_cfg()
    prof = str(tmp_path / "prof")
    state, _ = _fit(cfg, tmp_path / "out", _batches(cfg, 3),
                    dict(profile_dir=prof, profile_first_step=1,
                         profile_num_steps=5), max_steps=3)
    assert state.step == 3
    assert len([f for f in os.listdir(prof)
                if f.endswith(".pt.trace.json")]) == 1


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    cfg = _cfg()
    trainer = Trainer(cfg, TrainerConfig(output_dir=str(tmp_path)),
                      device="cpu")
    state = trainer.init_state(0)
    trainer.close()
    ckpt = CheckpointManager(str(tmp_path / "c"), max_to_keep=2)
    assert ckpt.latest_step() is None
    assert ckpt.restore(state) is state and state.step == 0
    for step in (4, 8, 12):
        state.step = step
        ckpt.save(step, state)
    assert ckpt.all_steps() == [8, 12] and ckpt.latest_step() == 12
    state.step = 0
    assert ckpt.restore(state, step=8).step == 8


def test_trainer_defaults_to_the_card():
    """Trainer's device is "cuda" unless the caller asks for the CPU; on a
    host without a card that raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(_cfg(), TrainerConfig(output_dir="unused"))
    defaults = dataclasses.asdict(TrainerConfig())
    assert defaults["grad_accum_steps"] == 1
    # The JAX package's defaults.
    assert {k: defaults[k] for k in (
        "profile_dir", "profile_first_step", "profile_num_steps")} == dict(
            profile_dir="", profile_first_step=10, profile_num_steps=5)

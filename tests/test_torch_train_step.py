"""The port's training step (smap_tpu_torch/train/, models in train mode)
against the JAX package's (smap_tpu/train/step.py, solver.py), on the same
weights and seeded batches, at tiny shapes (one stage, float32, as
tests/test_train_step.py's _tiny_cfg).

Tolerances. BatchNorm by the batch makes this network ill-conditioned in
float32 at these shapes: one bottleneck's rounding grows ~1e4-fold by the
heads, so float32 outputs are good to ~2e-3 (32x48) and the trunk's
gradients to a few percent, in both packages (the JAX package's float32
results are the noisier, by 2-4x). So each model is also run in float64
(the JAX one by a subclass of its SMAP that computes in float64, under
jax.enable_x64): outputs and statistics of the two float64 runs agree to
1e-6, which an unbiased variance (a factor 192/191) or any other change of
the math would break. In the float64 steps both packages keep their maps,
loss and gradients in float64 (torch_train_parity.use_smap64, port_step):
losses agree to rtol 1e-7 and every gradient to 1e-6 (the JAX package's
gradients are rounded to its float32 parameters, ~4e-8). Each float32
result must be no farther from the float64 truth than the JAX package's
own float32 result (times 1.5, plus 1e-6). float32 losses: rtol 1e-4 (the
root-depth loss, which samples a few raw output pixels, 1e-2). The
schedule: rtol 1e-6; Adam on the same gradients over 6 steps: rtol 1e-5.
tests/test_torch_train_bf16.py holds the bf16 step.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_train_parity as tp
from smap_tpu.config import TrainConfig as JTrain
from smap_tpu_torch.config import TrainConfig
from smap_tpu_torch.models.convert import smap_state_dict
from smap_tpu_torch.train import step as tstep
from torch_parity import random_variables


def test_conv_bn_block_train_mode_matches_flax(rng):
    """One ConvBnRelu in train mode on 2 x 8 x 12 pixels, against Flax's
    (batch statistics, biased variance in the running statistics): tight.
    PyTorch's stock update (unbiased, 192/191) is outside the tolerance."""
    from smap_tpu.models.layers import ConvBnRelu as JBlock

    from smap_tpu_torch.models.layers import ConvBnRelu

    x = rng.randn(2, 8, 12, 16).astype(np.float32)
    jblock = JBlock(32, (3, 3), padding=[(1, 1), (1, 1)])
    variables = random_variables(jblock, jnp.asarray(x), seed=3)
    y, mutated = jblock.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    block = ConvBnRelu(16, 32, 3)
    block.load_state_dict(smap_state_dict(variables))
    block.train()
    got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y), rtol=1e-5, atol=1e-5)
    stats = mutated["batch_stats"]["bn"]
    np.testing.assert_allclose(block.bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(block.bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5)
    stock = torch.nn.BatchNorm2d(32).train()
    stock.running_mean.copy_(torch.from_numpy(
        np.asarray(variables["batch_stats"]["bn"]["mean"])))
    stock.running_var.copy_(torch.from_numpy(
        np.asarray(variables["batch_stats"]["bn"]["var"])))
    with torch.no_grad():
        stock(torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), block.conv.weight,
            block.conv.bias, padding=1))
    assert not np.allclose(stock.running_var.numpy(),
                           np.asarray(stats["var"]), rtol=1e-5)


def test_train_forward_and_statistics():
    """SMAP in train mode at 32x48 (the heads' BatchNorms see 192
    pixels) against model.apply(train=True, mutable=["batch_stats"]):
    every output map and every new running statistic."""
    jcfg, cfg = tp.cfgs((32, 48))
    jmodel, variables = tp.jax_variables(jcfg)
    images = np.random.RandomState(1).randn(2, 32, 48, 3).astype(np.float32)
    keys = ("heatmap_2d", "det_d", "root_d")
    names = tp.stat_names(smap_state_dict(variables))

    def jax_run(model):
        outs, mutated = jax.jit(functools.partial(
            model.apply, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(images))
        sd = smap_state_dict({"params": variables["params"],
                              "batch_stats": mutated["batch_stats"]})
        return (tp.flat([np.asarray(m) for k in keys for m in outs[k][0]]),
                tp.state_arrays(sd, names), outs)

    j32, js32, outs = jax_run(jmodel)
    with jax.enable_x64(True):
        j64, js64, _ = jax_run(tp.smap64()(jcfg.model))
    got = {}
    for dtype in (torch.float32, torch.float64):
        model = tp.port(cfg, variables, dtype)
        with torch.no_grad():
            o = model(torch.from_numpy(images))
        got[dtype] = (tp.flat([m for k in keys for m in o[k][0]]),
                       tp.state_arrays(model.state_dict(), names))
        for k in keys:
            for m, j in zip(o[k][0], outs[k][0]):
                assert tuple(m.shape) == j.shape and m.dtype == torch.float32
    assert tp.dist(got[torch.float64][0], j64) < 1e-6
    assert tp.dist(got[torch.float64][1], js64) < 1e-6
    tp.within_jax_noise(got[torch.float32][0], j32, j64, "outputs")
    tp.within_jax_noise(got[torch.float32][1], js32, js64, "statistics")


@pytest.fixture(scope="module")
def step_setup():
    """The JAX train_step's losses, gradients and statistics at 64x96,
    batch 2, in float32 and in float64, each compiled once."""
    import smap_tpu.train.step as jstep

    jcfg, cfg = tp.cfgs()
    _, variables = tp.jax_variables(jcfg, seed=4)
    batch = tp.batch(np.random.RandomState(5), cfg, 2)
    runs = {}
    for x64 in (False, True):
        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(x64):
            if x64:
                tp.use_smap64(mp, jstep)
            runs[x64] = tp.jax_step(jstep, jcfg, variables, batch)
    return dict(jcfg=jcfg, cfg=cfg, variables=variables, batch=batch,
                jax32=runs[False], jax64=runs[True])


def test_train_step_matches_jax(step_setup):
    """One train_step: the four losses, every parameter's gradient and the
    new running statistics against JAX's train_step."""
    s = step_setup
    port32 = tp.port_step(s, torch.float32)
    assert port32[0].step == 1
    tp.check_step(port32, tp.port_step(s, torch.float64), s["jax64"],
                  "step", s["jax32"])


def test_remat_matches_no_remat():
    """cfg.remat recomputes each stage in the backward pass: the same
    losses and gradients, and the running statistics moved once (two
    narrow stages at 32x48)."""
    from smap_tpu_torch.models.smap import init_smap

    _, cfg = tp.cfgs((32, 48), stage_num=2, trunk_width=8,
                   upsample_channels=16)
    batch = tstep.TrainBatch(*tp.batch(np.random.RandomState(6), cfg, 2))
    runs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, remat=remat))
        model = tstep.training_model(init_smap(c.model, seed=6), tp.CPU)
        _, losses = tstep.train_step(tp.sgd_state(model), batch, cfg=c)
        runs.append((losses, {n: p.grad for n, p in model.named_parameters()},
                     model.state_dict()))
    (l0, g0, sd0), (l1, g1, sd1) = runs
    for k in l0:
        np.testing.assert_allclose(l1[k].item(), l0[k].item(), rtol=1e-6)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=1e-5,
                                   atol=1e-6 * float(g0[n].abs().max()),
                                   err_msg=n)
    for n in sd0:
        assert torch.equal(sd0[n], sd1[n]), n
    tracked = [int(v) for n, v in sd1.items() if "num_batches" in n]
    assert tracked and set(tracked) == {1}


def test_schedule_matches_make_schedule():
    """The learning rate at steps 0, warmup - 1, warmup and max_iter (one
    device: max_iter x 8), and the rate the optimizer runs step k at
    through the scheduler, as optax reads its schedule before the update."""
    from smap_tpu.train.solver import make_schedule as jschedule

    from smap_tpu_torch.train.solver import make_optimizer, make_schedule

    for cfg in (TrainConfig(), TrainConfig(warmup_iters=3, max_iter=2)):
        jcfg = JTrain(**{k: v for k, v in dataclasses.asdict(cfg).items()})
        want, got = jschedule(jcfg, 1), make_schedule(cfg, 1)
        w, m = cfg.warmup_iters, cfg.max_iter * 8
        for it in (0, 1, w - 1, w, w + 1, m // 2, m):
            np.testing.assert_allclose(got(it), float(want(it)), rtol=1e-6,
                                       atol=1e-12, err_msg=str(it))
        opt, sched = make_optimizer([torch.zeros(1, requires_grad=True)],
                                    cfg, 1)
        for it in range(6):
            np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                       float(want(it)), rtol=1e-6)
            opt.step()
            sched.step()


def test_adam_matches_optax_on_the_same_gradients():
    """make_optimizer against optax's chain (make_optimizer of the JAX
    package, flattened) over 6 steps across the warmup boundary, on the
    same gradients each step: Adam with the weight decay folded into the
    gradient."""
    from smap_tpu.train.solver import make_optimizer as jmake

    from smap_tpu_torch.train.solver import make_optimizer

    cfg = TrainConfig(warmup_iters=3, max_iter=2, weight_decay=0.05)
    jcfg = JTrain(**dataclasses.asdict(cfg))
    rng = np.random.RandomState(7)
    shapes = {"kernel": (3, 3, 4, 5), "bias": (5,), "scale": (5,)}
    params = {k: rng.randn(*v).astype(np.float32) for k, v in shapes.items()}
    tx = jmake(jcfg, 1)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    opt, sched = make_optimizer(list(tp.values()), cfg, 1)
    for it in range(6):
        grads = {k: rng.randn(*v).astype(np.float32)
                 for k, v in shapes.items()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        sched.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k} step {it}")

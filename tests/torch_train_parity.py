"""Shared helpers of the port's training parity tests
(tests/test_torch_train_step.py, tests/test_torch_trainer.py): configs and
batches at tiny shapes, the JAX package's SMAP in float64, and the checks
of one step against the JAX package's (the tolerances are explained in
tests/test_torch_train_step.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from smap_tpu.config import Config as JConfig
from smap_tpu.config import ModelConfig as JModel
from smap_tpu.config import TrainConfig as JTrain
from smap_tpu_torch.config import Config, ModelConfig, TrainConfig
from smap_tpu_torch.models.convert import smap_state_dict
from smap_tpu_torch.models.smap import SMAP
from smap_tpu_torch.train import step as tstep
from torch_parity import random_variables

CPU = torch.device("cpu")
LOSS_RTOL = {"total_loss": 1e-4, "loss_2d": 1e-4, "loss_bone": 1e-4,
             "loss_root": 1e-2}
# The float64 runs of both packages: losses, and every gradient (the JAX
# package's rounded to its float32 parameters, ~4e-8 apart).
LOSS64_RTOL, GRAD64_TOL = 1e-7, 1e-6


def cfgs(input_shape=(64, 96), **model):
    out = (input_shape[0] // 4, input_shape[1] // 4)
    kw = dict(dict(stage_num=1, output_shape=out, compute_dtype="float32"),
              **model)
    return (JConfig(model=JModel(**kw), train=JTrain(max_people=4),
                    input_shape=input_shape, output_shape=out),
            Config(model=ModelConfig(**kw), train=TrainConfig(max_people=4),
                   input_shape=input_shape, output_shape=out))


def batch(rng, cfg, batch_size):
    """tests/test_train_step.py's _batch, as a tuple of numpy arrays."""
    h, w = cfg.input_shape
    images = rng.randn(batch_size, h, w, 3).astype(np.float32)
    bodys = np.zeros((batch_size, cfg.train.max_people, 15, 11), np.float32)
    bodys[..., 0] = rng.uniform(0, w - 1, bodys.shape[:3])
    bodys[..., 1] = rng.uniform(0, h - 1, bodys.shape[:3])
    bodys[..., 2] = rng.uniform(100, 400, bodys.shape[:3])
    bodys[..., 3] = rng.randint(0, 3, bodys.shape[:3])
    bodys[..., 7] = 1100.0
    return (images, bodys, np.ones((batch_size, 57), np.float32),
            np.full((batch_size,), 0.5, np.float32))


def jax_variables(jcfg, seed=0):
    from smap_tpu.models.smap import SMAP as JSMAP

    model = JSMAP(jcfg.model)
    return model, random_variables(
        model, jnp.zeros((1, *jcfg.input_shape, 3), jnp.float32), seed=seed)


def smap64():
    """The JAX package's SMAP computing in float64 (float32 parameters
    cast up per call, as its bf16 mode casts down)."""
    from smap_tpu.models.smap import SMAP as JSMAP

    class SMAP64(JSMAP):
        def _dtype(self):
            return jnp.float64

    return SMAP64


class _Jnp64:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def use_smap64(mp, jstep):
    """Through ``mp``: the JAX train step's SMAP computes in float64 and
    returns its maps in float64 (its last cast, to ``jnp.float32``, reads
    ``_Jnp64``), so its loss and gradients are float64 throughout but for
    the cast of each gradient to its float32 parameter."""
    import smap_tpu.models.smap as jsmap

    mp.setattr(jstep, "SMAP", smap64())
    mp.setattr(jsmap, "jnp", _Jnp64())


def _nhwc(r):
    return None if r is None else r.permute(0, 2, 3, 1)


def port(cfg, variables, dtype=torch.float32):
    """The port's model in train mode from the JAX variables; computing in
    float64, on float64 parameters, when asked."""
    model = SMAP(cfg.model)
    model.load_state_dict(smap_state_dict(variables))
    model = tstep.training_model(model, CPU)
    if dtype == torch.float64:
        model.double().compute_dtype = torch.float64
    return model


def sgd_state(model):
    """A TrainState whose optimizer is plain SGD at lr 1e-3 (the JAX
    package's own accumulation test uses SGD: Adam's first step is
    +-lr sign(g), which turns float noise into flips)."""
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    return tstep.TrainState(model, opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: 1.0))


def expose_grads():
    """An optax transformation that applies nothing and keeps the
    gradient it was given as its state: JAX's own step functions then
    return the gradient they computed."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def jax_step(jstep, jcfg, variables, batch):
    """The JAX package's train_step (compiled) on ``batch``: its losses,
    gradients and new statistics, by the port's state_dict names."""
    import functools

    tx = expose_grads()
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                             params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=tx.init(variables["params"]))
    new, losses = jax.device_get(jax.jit(functools.partial(
        jstep.train_step, cfg=jcfg, tx=tx))(
        state, jstep.TrainBatch(*map(jnp.asarray, batch))))
    return dict(losses=losses,
                grads=smap_state_dict({"params": new.opt_state}),
                stats=smap_state_dict({"params": variables["params"],
                                       "batch_stats": new.batch_stats}))


def flat(tensors):
    return np.concatenate([np.asarray(t, np.float64).ravel()
                           for t in tensors])


def dist(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def within_jax_noise(port32, jax32, truth, what):
    """The port's float32 result is no farther from the float64 truth than
    the JAX package's float32 result is (times 1.5, plus 1e-6)."""
    e_port, e_jax = dist(port32, truth), dist(jax32, truth)
    assert e_port <= 1.5 * e_jax + 1e-6, (what, e_port, e_jax)


def state_arrays(sd, names):
    return flat([sd[n].numpy() for n in names])


def stat_names(sd):
    return sorted(n for n in sd if "running_" in n)


def port_step(s, dtype, accum_steps=1):
    """train_step of the port from ``s``'s variables on its batch (SGD):
    (state, losses, gradients). In float64 the maps stay float64 (as
    ``use_smap64`` keeps the JAX package's), and so do the loss and
    gradients."""
    import smap_tpu_torch.models.smap as psmap

    model = port(s["cfg"], s["variables"], dtype)
    with pytest.MonkeyPatch.context() as mp:
        if dtype == torch.float64:
            mp.setattr(psmap, "_nhwc_f32", _nhwc)
        state, losses = tstep.train_step(sgd_state(model),
                                         tstep.TrainBatch(*s["batch"]),
                                         cfg=s["cfg"],
                                         accum_steps=accum_steps)
    grads = {n: p.grad for n, p in model.named_parameters()}
    return state, losses, grads


def check_step(port32, port64, jax64, what, jax32=None):
    """A port step (float32 and float64: (state, losses, grads)) against
    JAX's float64 one, and its float32 one for the noise when given."""
    (st32, l32, g32), (st64, l64, g64) = port32, port64
    for k in LOSS_RTOL:
        np.testing.assert_allclose(l64[k].item(), float(jax64["losses"][k]),
                                   rtol=LOSS64_RTOL, err_msg=f"{what} {k}")
        if jax32 is not None:
            np.testing.assert_allclose(l32[k].item(),
                                       float(jax32["losses"][k]),
                                       rtol=LOSS_RTOL[k],
                                       err_msg=f"{what} {k}")
    names = sorted(g32)
    truth = state_arrays(jax64["grads"], names)
    assert dist(flat([g64[n] for n in names]), truth) < GRAD64_TOL, what
    stats = stat_names(jax64["stats"])
    s64 = state_arrays(jax64["stats"], stats)
    assert dist(state_arrays(st64.model.state_dict(), stats), s64) < 1e-6
    if jax32 is None:   # no JAX float32 run to measure the noise by
        assert dist(flat([g32[n] for n in names]), truth) < 0.1, what
        assert dist(state_arrays(st32.model.state_dict(), stats), s64) < 1e-5
    else:
        within_jax_noise(flat([g32[n] for n in names]),
                         state_arrays(jax32["grads"], names), truth,
                         f"{what} gradients")
        within_jax_noise(state_arrays(st32.model.state_dict(), stats),
                         state_arrays(jax32["stats"], stats), s64,
                         f"{what} statistics")



"""The port's training step in bf16 compute on float32 parameters (the
full-width configuration's mixed precision: each conv casts its float32
weights to bf16 per call, BatchNorm normalises in float32 and returns bf16,
the maps come out in float32) against the JAX package's, both held to the
JAX package's float64 step on the same weights and batch, at 64x96, one
stage, batch 2.

Conditioning. A freshly initialised stack of residual blocks with BatchNorm
by the batch is chaotic: one rounding in the trunk grows past the gradient
itself, so at these weights the bf16 gradients of both packages lie ~1.4
(relative 2-norm) from the float64 ones, where an unrelated gradient of
the same size would lie too. The weights here therefore have the last
BatchNorm scale of every bottleneck (the output of each residual branch)
multiplied by 0.1, a damped-residual start: the bf16 steps of both
packages then lie ~0.28 from the float64 one, bf16's own rounding through
the network, and a gradient of other math ~1 or more away (a bf16 forward
that stops the gradient at the upsampling path: ~0.9).

Tolerances. bf16 gradients and new statistics: no farther from the float64
step than the JAX package's bf16 step is (times 1.5, plus 1e-6). bf16
losses: no farther from the float64 loss than the JAX package's bf16 loss
(times 1.5), plus one bf16 rounding of it (2^-8 relative).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from flax import traverse_util

import torch_train_parity as tp

BF16_ROUNDING = 2.0 ** -8


def damped_residuals(variables, factor=0.1):
    """``variables`` with every bottleneck's last BatchNorm scale times
    ``factor``."""
    flat = traverse_util.flatten_dict(variables["params"])
    flat = {k: v * factor if k[-3:] == ("conv_bn_relu3", "bn", "scale")
            else v for k, v in flat.items()}
    assert sum(k[-3:] == ("conv_bn_relu3", "bn", "scale") for k in flat)
    return dict(variables, params=traverse_util.unflatten_dict(flat))


@pytest.fixture(scope="module")
def bf16_setup():
    """The JAX train_step at the damped weights, in bf16 compute and in
    float64, each compiled once."""
    import smap_tpu.train.step as jstep

    jcfg, cfg = tp.cfgs()
    _, variables = tp.jax_variables(jcfg, seed=4)
    variables = damped_residuals(variables)
    batch = tp.batch(np.random.RandomState(5), cfg, 2)
    jbf16 = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, compute_dtype="bfloat16"))
    bf16 = tp.jax_step(jstep, jbf16, variables, batch)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        tp.use_smap64(mp, jstep)
        f64 = tp.jax_step(jstep, jcfg, variables, batch)
    return dict(cfg=cfg, variables=variables, batch=batch, jax_bf16=bf16,
                jax64=f64)


def test_bf16_train_step_matches_jax(bf16_setup):
    """One bf16 train_step: the four losses, every gradient and the new
    running statistics, each as close to the float64 step as JAX's."""
    s = bf16_setup
    cfg = dataclasses.replace(s["cfg"], model=dataclasses.replace(
        s["cfg"].model, compute_dtype="bfloat16"))
    state, losses, grads = tp.port_step(dict(s, cfg=cfg), torch.float32)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in state.model.parameters())
    jb, j64 = s["jax_bf16"], s["jax64"]
    for k in tp.LOSS_RTOL:
        want = float(j64["losses"][k])
        err, jax_err = (abs(losses[k].item() - want),
                        abs(float(jb["losses"][k]) - want))
        assert err <= 1.5 * jax_err + BF16_ROUNDING * abs(want), (
            k, err, jax_err)
    names = sorted(grads)
    truth = tp.state_arrays(j64["grads"], names)
    port_g = tp.flat([grads[n] for n in names])
    tp.within_jax_noise(port_g, tp.state_arrays(jb["grads"], names), truth,
                        "bf16 gradients")
    assert tp.dist(port_g, truth) < 0.5     # bf16's rounding, not chaos
    stats = tp.stat_names(j64["stats"])
    tp.within_jax_noise(tp.state_arrays(state.model.state_dict(), stats),
                        tp.state_arrays(jb["stats"], stats),
                        tp.state_arrays(j64["stats"], stats),
                        "bf16 statistics")

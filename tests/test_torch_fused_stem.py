"""The port's fused stem (smap_tpu_torch/ops/fused_stem.py) against the JAX
package's: the plain version against ``stem_reference`` and the Pallas
kernel in interpret mode, and the stem-fused folded model against the
float32 truth. Kernel C itself is held against the plain version on the
card (tests/test_torch_kernels.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from torch_parity import INPUT_HW, folded_fused_errors

torch.set_num_threads(1)

# tests/test_fused_stem.py's own bound: bf16 operands, float32 sums in
# another order; a conv output near a bf16 rounding point of the pooled
# result can round the other way (one bf16 ulp).
ATOL, RTOL = 2e-2, 1e-2

SHAPES = [   # b, h, w, cin, cout, tile_p: tests/test_fused_stem.py's
    (2, 64, 96, 3, 64, 8),
    (1, 32, 48, 3, 16, 4),
    (2, 64, 64, 4, 32, 8),
    (1, 128, 96, 3, 8, 8),
]


def _inputs(rng, b, h, w, cin, cout, bias_value=None):
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(7, 7, cin, cout) * 0.2).astype(np.float32)   # HWIO
    bias = ((rng.randn(cout) * 0.1).astype(np.float32) if bias_value is None
            else np.full((cout,), bias_value, np.float32))
    return x, k, bias


def _port(x, k, bias):
    from smap_tpu_torch.ops.fused_stem import fused_stem

    got = fused_stem(torch.from_numpy(x),
                     torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                     torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    return got.float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_stem_matches_jax(shape):
    import jax.numpy as jnp

    from smap_tpu.ops.fused_stem import (double_space_to_depth, fused_stem,
                                         stem_reference)

    b, h, w, cin, cout, tile_p = shape
    x, k, bias = _inputs(np.random.RandomState(h + w + cin), b, h, w, cin,
                         cout)
    got = _port(x, k, bias)
    want = np.asarray(stem_reference(jnp.asarray(x), jnp.asarray(k),
                                     jnp.asarray(bias)), np.float32)
    kernel = np.asarray(fused_stem(double_space_to_depth(jnp.asarray(x)),
                                   jnp.asarray(k), jnp.asarray(bias),
                                   tile_p=tile_p, interpret=True), np.float32)
    assert got.shape == want.shape == kernel.shape == (b, h // 4, w // 4,
                                                       cout)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=RTOL)


def test_plain_stem_negative_bias_pools_to_zero():
    """Every conv output relus to 0: exact, and the pool's padding never
    wins over them."""
    import jax.numpy as jnp

    from smap_tpu.ops.fused_stem import (double_space_to_depth, fused_stem,
                                         stem_reference)

    x, k, bias = _inputs(np.random.RandomState(0), 1, 32, 48, 3, 16, -10.0)
    k *= 0.25
    got = _port(x, k, bias)
    want = np.asarray(stem_reference(jnp.asarray(x), jnp.asarray(k),
                                     jnp.asarray(bias)), np.float32)
    kernel = np.asarray(fused_stem(double_space_to_depth(jnp.asarray(x)),
                                   jnp.asarray(k), jnp.asarray(bias),
                                   tile_p=4, interpret=True), np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, kernel)
    assert got.max() == 0.0


def test_stem_fused_folded_model_error_vs_f32_truth(monkeypatch):
    """JAX's and the port's folded bf16 models with the fused stem, each
    within 2x the plain bf16 graph's distance to the float32 truth + 1e-4
    (tests/test_fused_block.py's invariant)."""
    for name, (noise, jax_err, port_err) in folded_fused_errors(
            monkeypatch, fuse_stem=True, fuse_bottleneck=False).items():
        assert noise > 0, name
        assert jax_err <= 2.0 * noise + 1e-4, (name, jax_err, noise)
        assert port_err <= 2.0 * noise + 1e-4, (name, port_err, noise)


@pytest.mark.parametrize("hw,fused", [(INPUT_HW, 1), ((64, 90), 0),
                                      ((48, 96), 0)])
def test_stem_fuses_where_jax_does(monkeypatch, hw, fused):
    """The stem takes the kernel in the port exactly when it does in JAX:
    folded, width 64, H % 32 == 0 and W % 4 == 0."""
    import jax
    import jax.numpy as jnp

    import smap_tpu.models.smap as jsmap
    import smap_tpu.ops.fused_stem as jstem
    from smap_tpu.models.smap import ResNetTop as JResNetTop

    import smap_tpu_torch.ops.fused_stem as tstem
    from smap_tpu_torch.models.smap import ResNetTop

    calls = {"jax": 0, "port": 0}

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(jsmap, "FUSE_STEM", True)
    monkeypatch.setattr(jstem, "fused_stem",
                        counted("jax", jstem.fused_stem))
    monkeypatch.setattr(tstem, "fused_stem_plain",
                        counted("port", tstem.fused_stem_plain))
    jtop = JResNetTop(quant="folded", dtype=jnp.bfloat16)
    jax.eval_shape(lambda x: jtop.init_with_output(jax.random.PRNGKey(0), x),
                   jnp.zeros((1, *hw, 3), jnp.float32))
    with torch.no_grad():
        ResNetTop(quant="folded", fuse=True)(torch.zeros((1, 3, *hw)))
    assert calls == {"jax": fused, "port": fused}


@pytest.mark.parametrize("cin", [3, 4])
def test_pack_stem_for_kernel_round_trips(cin):
    """Kernel C's weight rows: element kh*32 + kw*4 + ci of row co is
    kernel[co, ci, kh, kw], zero for the padding tap, the padding channel
    and the row's tail; the inverse gives the kernel back exactly."""
    from smap_tpu_torch.ops.fused_stem import (STEM_ROW, pack_stem_for_kernel,
                                               unpack_stem_for_kernel)

    k = torch.from_numpy(np.random.RandomState(cin).randn(64, cin, 7, 7)
                         .astype(np.float32)).to(torch.bfloat16)
    packed = pack_stem_for_kernel(k)
    assert packed.shape == (64, STEM_ROW) and packed.dtype == torch.bfloat16
    want = torch.zeros((64, STEM_ROW), dtype=torch.bfloat16)
    for kh in range(7):
        for kw in range(7):
            for ci in range(cin):
                want[:, kh * 32 + kw * 4 + ci] = k[:, ci, kh, kw]
    assert torch.equal(packed, want)
    assert torch.equal(unpack_stem_for_kernel(packed, cin), k)

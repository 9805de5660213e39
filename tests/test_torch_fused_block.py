"""The port's fused bottleneck (smap_tpu_torch/ops/fused_block.py) against
the JAX package's: the plain version against ``bottleneck_reference`` and
the Pallas kernel in interpret mode, the folded serving model with both
fused paths against the float32 truth, and which blocks fuse. Kernel D
itself is held against the plain version on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from torch_parity import INPUT_HW, folded_fused_errors

torch.set_num_threads(1)

# bf16 operands, float32 sums in another order (oneDNN's vs XLA's): y and
# z are rounded to bf16 after the same f32 values up to a few f32 ulps, so
# a rounding of y or z flips only at a tie; tests/test_fused_block.py's own
# kernel-vs-oracle bound.
ATOL = RTOL = 1e-3


def _rand_block(rng, cin, cm, cout, with_ds):
    """tests/test_fused_block.py's block parameters."""
    w = [(rng.randn(cin, cm) * 0.2), (rng.randn(cm) * 0.1),
         (rng.randn(3, 3, cm, cm) * 0.2), (rng.randn(cm) * 0.1),
         (rng.randn(cm, cout) * 0.2), (rng.randn(cout) * 0.1)]
    if with_ds:
        w += [(rng.randn(cin, cout) * 0.2), (rng.randn(cout) * 0.1)]
    return [a.astype(np.float32) for a in w]


@pytest.mark.parametrize("shape,tile_rows", [
    ((2, 16, 24, 32, 8, 32), 8),     # tests/test_fused_block.py's shapes
    ((1, 32, 13, 16, 8, 16), 8),
    ((2, 24, 24, 24, 8, 40), 4),
])
@pytest.mark.parametrize("with_ds", [False, True])
def test_plain_bottleneck_matches_jax(shape, tile_rows, with_ds):
    import jax.numpy as jnp

    from smap_tpu.ops.fused_block import bottleneck_reference, fused_bottleneck

    from smap_tpu_torch.ops.fused_block import fused_bottleneck as port

    b, h, w, cin, cm, cout = shape
    if cout != cin and not with_ds:
        with pytest.raises(ValueError):
            port(torch.zeros((b, h, w, cin)),
                 *map(torch.from_numpy, _rand_block(
                     np.random.RandomState(0), cin, cm, cout, False)))
        return
    rng = np.random.RandomState(h * w + cin + with_ds)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    params = _rand_block(rng, cin, cm, cout, with_ds)
    got = port(torch.from_numpy(x), *map(torch.from_numpy, params))
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, cout)
    got = got.float().numpy()
    jparams = [jnp.asarray(p) for p in params]
    want = np.asarray(bottleneck_reference(jnp.asarray(x), *jparams),
                      np.float32)
    kernel = np.asarray(fused_bottleneck(jnp.asarray(x), *jparams,
                                         tile_rows=tile_rows, interpret=True),
                        np.float32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=RTOL)


def test_fused_folded_model_error_vs_f32_truth(monkeypatch):
    """The serving configuration, both fused paths on: JAX's and the
    port's folded bf16 models each within 2x the plain bf16 graph's
    distance to the float32 truth + 1e-4 (tests/test_fused_block.py's
    invariant)."""
    for name, (noise, jax_err, port_err) in folded_fused_errors(
            monkeypatch, fuse_stem=True, fuse_bottleneck=True).items():
        assert noise > 0, name
        assert jax_err <= 2.0 * noise + 1e-4, (name, jax_err, noise)
        assert port_err <= 2.0 * noise + 1e-4, (name, port_err, noise)


def _count_calls(monkeypatch):
    import smap_tpu.models.layers as jlayers
    import smap_tpu.ops.fused_block as jblock

    import smap_tpu_torch.ops.fused_block as tblock

    calls = {"jax": 0, "port": 0}

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(jlayers, "FUSE_BOTTLENECK", True)
    monkeypatch.setattr(jblock, "fused_bottleneck",
                        counted("jax", jblock.fused_bottleneck))
    monkeypatch.setattr(tblock, "fused_bottleneck_plain",
                        counted("port", tblock.fused_bottleneck_plain))
    return calls


@pytest.mark.parametrize("h,cin,planes,stride,has_ds,fused", [
    (16, 64, 64, 1, True, 1),      # layer1_0
    (16, 256, 64, 1, False, 1),    # layer1_1, layer1_2
    (20, 256, 64, 1, False, 0),    # H not a multiple of 8
    (16, 256, 128, 2, True, 0),    # layer2_0: stride 2
    (16, 512, 128, 1, False, 0),   # layer2_1: planes 128
])
def test_bottleneck_fuses_where_jax_does(monkeypatch, h, cin, planes, stride,
                                         has_ds, fused):
    import jax
    import jax.numpy as jnp

    from smap_tpu.models.layers import Bottleneck as JBottleneck

    from smap_tpu_torch.models.layers import Bottleneck

    calls = _count_calls(monkeypatch)
    jblock = JBottleneck(planes, stride, has_ds, quant="folded",
                         dtype=jnp.bfloat16)
    jax.eval_shape(lambda x: jblock.init_with_output(jax.random.PRNGKey(0),
                                                     x),
                   jnp.zeros((1, h, 24, cin), jnp.float32))
    block = Bottleneck(cin, planes, stride, has_ds, quant="folded", fuse=True)
    with torch.no_grad():
        block(torch.zeros((1, cin, h, 24)))
    assert calls == {"jax": fused, "port": fused}


def test_model_fuses_three_blocks_per_stage(monkeypatch):
    """Three stages at full width: layer1_{0,1,2} of each stage fuse in both
    packages, 9 blocks per forward, as on the card at 512x832."""
    import jax
    import jax.numpy as jnp

    from smap_tpu.config import ModelConfig as JModelConfig
    from smap_tpu.models.smap import SMAP as JSMAP

    from smap_tpu_torch.config import ModelConfig
    from smap_tpu_torch.models.smap import SMAP

    calls = _count_calls(monkeypatch)
    cfg = dict(stage_num=3, output_shape=(16, 24), quantized="folded")
    jmodel = JSMAP(JModelConfig(**cfg))
    jax.eval_shape(lambda x: jmodel.init_with_output(
        jax.random.PRNGKey(0), x, method=JSMAP.infer),
        jnp.zeros((1, *INPUT_HW, 3), jnp.float32))
    model = SMAP(ModelConfig(**cfg), fuse_bottleneck=True).eval()
    with torch.no_grad():
        model.infer(torch.zeros((1, *INPUT_HW, 3)))
    assert calls == {"jax": 9, "port": 9}


@pytest.mark.parametrize("cin,cm,cout,proj", [
    (64, 64, 256, True),      # layer1_0
    (256, 64, 256, False),    # layer1_1, layer1_2
    (32, 16, 48, True),       # padded Cin, Cm and Cout
    (16, 16, 16, False),
])
def test_pack_bottleneck_for_kernel_round_trips(cin, cm, cout, proj):
    """Kernel D's weight image: the swizzled block layout the kernel
    addresses, conv3's column order, and the exact inverse."""
    from smap_tpu_torch.ops.fused_block import (conv3_column_order,
                                                pack_bottleneck_for_kernel,
                                                unpack_bottleneck)

    rng = np.random.RandomState(cin + cm + cout)
    params = [torch.from_numpy(a) for a in _rand_block(rng, cin, cm, cout,
                                                       proj)]
    want = [p.to(torch.bfloat16) if p.ndim > 1 else p for p in params]
    packed = pack_bottleneck_for_kernel(*params)
    nk = -(-cin // 64)
    assert packed.weights.dtype == torch.bfloat16
    assert packed.weights.numel() * 2 == (nk + 9 + 4 + 4 * proj) * 8192
    assert packed.bias.shape == (640,)

    # Byte n*128 + ((k // 8) ^ (n % 8))*16 + (k % 8)*2 of a block holds
    # B[n][k]: w1[k, n] in block 0, and w3[k, channel] in row
    # conv3_column_order()[channel] of the w3 block.
    img = packed.weights
    n, k = torch.meshgrid(torch.arange(64), torch.arange(64), indexing="ij")
    pos = n * 64 + ((k // 8) ^ (n % 8)) * 8 + k % 8
    w1 = torch.zeros((64, 64), dtype=torch.bfloat16)
    w1[:min(cin, 64), :cm] = want[0][:64]
    assert torch.equal(img[pos], w1.t())
    order = conv3_column_order()
    w3_block = img[(nk + 9) * 4096:(nk + 13) * 4096]
    col, k = torch.meshgrid(torch.arange(256), torch.arange(64),
                            indexing="ij")
    got_w3 = w3_block[col * 64 + ((k // 8) ^ (col % 8)) * 8 + k % 8]
    w3 = torch.zeros((64, 256), dtype=torch.bfloat16)
    w3[:cm, :cout] = want[4]
    assert torch.equal(got_w3, w3.t()[order])

    got = unpack_bottleneck(packed)
    assert (got[6] is None) == (not proj)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B,H,W", [(16, 128, 208), (3, 36, 100), (2, 20, 13)])
def test_tile_walk_covers_every_pixel_once(B, H, W):
    """Kernel D's persistent walk on a grid of 132 CTAs (one per H100 SM):
    CTA c takes tiles c, c + 132, ...; the 8 x 16 tiles cover every output
    pixel exactly once, ragged edges included."""
    from smap_tpu_torch.ops.fused_block import (TILE_H, TILE_W,
                                                tile_origins)

    ntiles = B * -(-H // TILE_H) * -(-W // TILE_W)
    grid = min(ntiles, 132)
    count = torch.zeros((B, H, W), dtype=torch.int64)
    for cta in range(grid):
        tiles = torch.arange(cta, ntiles, grid)
        assert len(tiles) == (ntiles - cta + grid - 1) // grid
        for b, h0, w0 in zip(*(t.tolist() for t in tile_origins(tiles, B,
                                                                 H, W))):
            count[b, h0:h0 + TILE_H, w0:w0 + TILE_W] += 1
    assert bool((count == 1).all())

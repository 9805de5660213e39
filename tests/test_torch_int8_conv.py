"""The int8 convolution (smap_tpu_torch/ops/int8_conv.py) and the int8 conv
block (models/layers.py, Int8Conv) against the JAX package's int8
``ConvBnRelu``, on the same carried-across int8 weights and seeded inputs.

The activation scale and the int8 activations must be bit-equal, and the
float32 outputs equal to JAX's run op by op, which rounds as the port does.
Jitted on the CPU, XLA contracts JAX's ``acc * scale + bias`` into one
fused multiply-add, where the port (and kernel E on the card) rounds the
product and the sum each on its own, as the JAX program is written: the
jitted output then differs by at most half an ulp of the product and an
ulp of the sum (many ulps of the sum where the bias cancels the
product)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _jax_qvars(cout, k, stride, pad, relu, x, seed):
    """quantize_variables of a JAX ConvBnRelu with seeded non-identity
    BatchNorm statistics."""
    import jax
    import jax.numpy as jnp

    from smap_tpu.models.layers import ConvBnRelu
    from smap_tpu.models.quantize import quantize_variables

    mod = ConvBnRelu(cout, (k, k), strides=(stride, stride),
                     padding=[(pad, pad), (pad, pad)], has_relu=relu)
    v = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(seed),
                                          jnp.asarray(x)))
    rng = np.random.RandomState(seed)
    v["params"]["conv"]["bias"] = rng.randn(cout).astype(np.float32) * 0.1
    v["params"]["bn"]["scale"] = rng.uniform(0.5, 1.5, cout).astype(
        np.float32)
    v["params"]["bn"]["bias"] = rng.randn(cout).astype(np.float32) * 0.1
    v["batch_stats"]["bn"]["mean"] = rng.randn(cout).astype(np.float32) * 0.1
    v["batch_stats"]["bn"]["var"] = rng.uniform(0.5, 1.5, cout).astype(
        np.float32)
    return jax.tree.map(np.asarray, quantize_variables(v))


def _port_weights(qv):
    conv = qv["params"]["conv"]
    return (torch.from_numpy(conv["kernel_q"].transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(conv["kernel_scale"].copy()),
            torch.from_numpy(conv["bias"].copy()))


# (Cin, Cout, k, stride, pad, relu, H, W): the stem, 1x1 and 3x3 convs at
# stride 1 and 2, ragged sizes, and the heads' Cout of 43, 14 and 1.
SHAPES = [(3, 16, 7, 2, 3, True, 20, 30),
          (16, 8, 1, 1, 0, True, 9, 11),
          (16, 32, 1, 2, 0, False, 10, 13),
          (8, 8, 3, 1, 1, True, 12, 10),
          (8, 16, 3, 2, 1, True, 11, 9),
          (16, 43, 3, 1, 1, False, 8, 12),
          (16, 14, 3, 1, 1, False, 8, 12),
          (16, 1, 3, 1, 1, False, 7, 5)]


@pytest.mark.parametrize("mode", [True, "static"])
@pytest.mark.parametrize("cin,cout,k,stride,pad,relu,h,w", SHAPES)
def test_int8_conv_matches_jax_conv_block(mode, cin, cout, k, stride, pad,
                                          relu, h, w):
    import jax
    import jax.numpy as jnp

    from smap_tpu.models.layers import ConvBnRelu

    from smap_tpu_torch.ops.int8_conv import (dynamic_scale,
                                              int8_conv2d_plain,
                                              quantize_activation)

    seed = cin * 31 + cout + k + stride
    x = (np.random.RandomState(seed).randn(2, h, w, cin) * 3.0).astype(
        np.float32)
    qv = _jax_qvars(cout, k, stride, pad, relu, x, seed)

    def block(quant):
        return ConvBnRelu(cout, (k, k), strides=(stride, stride),
                          padding=[(pad, pad), (pad, pad)], has_relu=relu,
                          quant=quant)

    want, mut = block(True).apply(qv, jnp.asarray(x), False,
                                  mutable=["intermediates"])
    absmax = np.float32(mut["intermediates"]["conv"]["act_absmax"][0])
    s_jax = np.maximum(absmax, np.float32(1e-6)) * np.float32(1.0 / 127.0)
    if mode == "static":
        qv = {"params": {"conv": dict(qv["params"]["conv"],
                                      act_scale=s_jax)}}
        want = block("static").apply(qv, jnp.asarray(x), False)
    jitted = np.asarray(jax.jit(lambda v, x: block(mode).apply(v, x, False))(
        qv, jnp.asarray(x)))
    want = np.asarray(want)

    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    s_x = dynamic_scale(xt)
    assert s_x.shape == () and s_x.dtype == torch.float32
    assert s_x.numpy().tobytes() == s_jax.tobytes()
    xq = quantize_activation(xt, s_x)
    want_q = np.clip(np.round(x / s_jax), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(), want_q)
    wq, w_scale, bias = _port_weights(qv)
    got = int8_conv2d_plain(xq, wq, w_scale, s_x, bias, stride, pad, relu,
                            torch.float32).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    acc = torch.nn.functional.conv2d(xq.double(), wq.double(), None, stride,
                                     pad).float()
    product = (acc * (s_x * w_scale)[:, None, None]).permute(0, 2, 3, 1)
    bound = (np.spacing(np.abs(product.numpy()))
             + np.spacing(np.maximum(np.abs(got), np.abs(jitted))))
    assert np.all(np.abs(got - jitted) <= bound)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", [True, "static"])
@pytest.mark.parametrize("cin,cout,k,stride,pad,relu,h,w", SHAPES)
def test_int8_conv2d_quantizes_as_jax_conv_block(in_dtype, mode, cin, cout,
                                                 k, stride, pad, relu, h, w):
    """The fused function as kernel E computes it (float or bf16 input and
    the scale in, the conv out), on its plain path, bit-equal to JAX's int8
    ConvBnRelu run op by op on the same input: the bf16 input is made by
    one round-to-nearest-even cast of the same float32 numpy values on both
    sides."""
    import jax.numpy as jnp

    from smap_tpu.models.layers import ConvBnRelu

    from smap_tpu_torch.ops.int8_conv import dynamic_scale, int8_conv2d

    seed = cin * 31 + cout + k + stride
    x = (np.random.RandomState(seed + 1).randn(2, h, w, cin) * 3.0).astype(
        np.float32)
    qv = _jax_qvars(cout, k, stride, pad, relu, x, seed)
    xj = jnp.asarray(x).astype(getattr(jnp, in_dtype))
    xt = torch.from_numpy(x).to(getattr(torch, in_dtype))
    np.testing.assert_array_equal(
        np.asarray(xj.astype(jnp.float32)),
        xt.float().numpy())               # the same input on both sides

    def block(quant):
        return ConvBnRelu(cout, (k, k), strides=(stride, stride),
                          padding=[(pad, pad), (pad, pad)], has_relu=relu,
                          quant=quant)

    s_x = dynamic_scale(xt.permute(0, 3, 1, 2))
    if mode == "static":
        s_x = s_x * 0.5                    # a frozen scale that clips
        qv = {"params": {"conv": dict(qv["params"]["conv"],
                                      act_scale=s_x.numpy())}}
    want = np.asarray(block(mode).apply(qv, xj, False))
    wq, w_scale, bias = _port_weights(qv)
    got = int8_conv2d(xt.permute(0, 3, 1, 2), wq, w_scale, s_x, bias, stride,
                      pad, relu, torch.float32)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_int8_conv2d_on_the_cpu_is_the_plain_version():
    from smap_tpu_torch.ops.int8_conv import (int8_conv2d, int8_conv2d_plain,
                                              pack_int8_weights)

    gen = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (2, 8, 9, 7), generator=gen,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (5, 8, 3, 3), generator=gen,
                       dtype=torch.int8)
    args = (xq, wq, torch.rand(5, generator=gen), torch.tensor(0.03),
            torch.randn(5, generator=gen), 2, 1, True, torch.bfloat16)
    got = int8_conv2d(*args, packed=pack_int8_weights(wq))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 5, 5, 4)
    assert torch.equal(got, int8_conv2d_plain(*args))
    assert float(got.float().min()) >= 0.0


@pytest.mark.parametrize("cin,k", [(3, 7), (8, 3), (16, 1), (64, 3)])
def test_int8_weight_rows_layout(cin, k):
    """Row co, element (dh * k + dw) * Cin_pad + ci is wq[co, ci, dh, dw];
    Cin padded to a multiple of 4, K to a multiple of 32, with zeros."""
    from smap_tpu_torch.ops.int8_conv import int8_weight_rows

    wq = torch.randint(-127, 128, (6, cin, k, k),
                       generator=torch.Generator().manual_seed(cin),
                       dtype=torch.int8)
    rows = int8_weight_rows(wq)
    cin_pad = -(-cin // 4) * 4
    assert rows.dtype == torch.int8 and rows.shape[0] == 6
    assert rows.shape[1] % 32 == 0
    assert rows.shape[1] - k * k * cin_pad in range(32)
    want = np.zeros((6, rows.shape[1]), np.int8)
    w = wq.numpy()
    for dh in range(k):
        for dw in range(k):
            for ci in range(cin):
                want[:, (dh * k + dw) * cin_pad + ci] = w[:, ci, dh, dw]
    np.testing.assert_array_equal(rows.numpy(), want)


@pytest.mark.parametrize("cout,cin,k", [(1, 3, 7), (14, 8, 3), (43, 16, 1),
                                        (64, 64, 3), (100, 4, 1),
                                        (300, 16, 1)])
def test_pack_int8_weights_layout(cout, cin, k):
    """Kernel E's weight image, as csrc/int8_conv.cu's header note says:
    (co, tap, ci) with k = tap * Cin_pad + ci lies in block (co // N,
    k // 32), row n = co % N, byte n * 32 + 16 * ((k % 32) // 16 ^ (n // 4)
    % 2) + k % 16; everything else is zero. N is the narrowest tile width
    that holds Cout (8, 16, 48, 64, 128), else 256."""
    from smap_tpu_torch.ops import kernels
    from smap_tpu_torch.ops.int8_conv import pack_int8_weights

    wq = torch.randint(-127, 128, (cout, cin, k, k),
                       generator=torch.Generator().manual_seed(cout + cin),
                       dtype=torch.int8)
    wq[wq == 0] = 1                      # every real weight is nonzero
    packed = pack_int8_weights(wq).numpy()
    n_tile = kernels.int8_tile_n(cout)
    assert n_tile == next(n for n in (8, 16, 48, 64, 128, 256, 10 ** 9)
                          if cout <= n or n == 256)
    cin_pad = -(-cin // 4) * 4
    kpad = -(-k * k * cin_pad // 32) * 32
    ntn = -(-cout // n_tile)
    assert packed.dtype == np.int8 and packed.shape == (ntn * n_tile * kpad,)
    want = np.zeros_like(packed)
    w = wq.numpy()
    for co in range(cout):
        n = co % n_tile
        for dh in range(k):
            for dw in range(k):
                for ci in range(cin):
                    kk = (dh * k + dw) * cin_pad + ci
                    block = (co // n_tile) * (kpad // 32) + kk // 32
                    b = kk % 32
                    at = (block * n_tile * 32 + n * 32
                          + 16 * ((b // 16) ^ ((n // 4) % 2)) + b % 16)
                    assert want[at] == 0
                    want[at] = w[co, ci, dh, dw]
    np.testing.assert_array_equal(packed, want)


def test_quantize_activation_rounds_half_to_even_and_clips():
    from smap_tpu_torch.ops.int8_conv import quantize_activation

    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0, 126.6])
    got = quantize_activation(x, torch.tensor(1.0))
    assert got.tolist() == [0, 2, 2, 0, -2, 127, -127, 127]
    with pytest.raises(ValueError):
        quantize_activation(x, torch.tensor(1.0, device="meta"))


def test_int8_conv_block_static_equals_dynamic_on_its_batch():
    """As tests/test_quantize.py's block test: the scale frozen from a
    batch's abs-max gives the dynamic block's output on that batch, bit
    for bit; a static block without a scale refuses to run."""
    from smap_tpu_torch.models.layers import ConvBnRelu
    from smap_tpu_torch.ops.int8_conv import scale_from_absmax

    gen = torch.Generator().manual_seed(3)
    dyn = ConvBnRelu(16, 8, 3, quant=True)
    with torch.no_grad():
        dyn.conv.kernel_q.copy_(torch.randint(-127, 128, (8, 16, 3, 3),
                                              generator=gen))
        dyn.conv.kernel_scale.copy_(torch.rand(8, generator=gen) * 0.01)
        dyn.conv.bias.copy_(torch.randn(8, generator=gen))
    x = torch.randn((2, 16, 8, 8), generator=gen) * 3.0
    dyn.conv.record = []
    with torch.no_grad():
        want = dyn(x)
    (absmax,) = dyn.conv.record
    sd = dict(dyn.state_dict())
    static = ConvBnRelu(16, 8, 3, quant="static")
    with pytest.raises(RuntimeError, match="act_scale"):
        static(x)
    sd["conv.act_scale"] = torch.tensor(
        np.maximum(np.float32(absmax), np.float32(1e-6))
        * np.float32(1.0 / 127.0))
    static.load_state_dict(sd, strict=True)
    assert torch.equal(static.conv.act_scale, scale_from_absmax(absmax))
    with torch.no_grad():
        assert torch.equal(static(x), want)
    assert float(want.min()) >= 0.0


def test_int8_conv_block_loads_with_or_without_act_scale():
    """A strict load takes a static block's state_dict with or without
    act_scale (a conv the readout never runs has none after calibration);
    the dynamic block has no act_scale key."""
    from smap_tpu_torch.models.layers import ConvBnRelu

    dyn = ConvBnRelu(4, 4, 1, quant=True)
    assert set(dyn.state_dict()) == {"conv.kernel_q", "conv.kernel_scale",
                                     "conv.bias"}
    static = ConvBnRelu(4, 4, 1, quant="static")
    static.load_state_dict(dyn.state_dict(), strict=True)
    assert static.conv.act_scale is None
    assert "conv.act_scale" not in static.state_dict()
    static.load_state_dict(dict(dyn.state_dict(),
                                **{"conv.act_scale": torch.tensor(0.5)}),
                           strict=True)
    assert float(static.state_dict()["conv.act_scale"]) == 0.5
    with pytest.raises(RuntimeError):
        dyn.load_state_dict(static.state_dict(), strict=True)

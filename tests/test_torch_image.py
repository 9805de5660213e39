"""The port's host image operations (``smap_tpu_torch.data.image``) against
the OpenCV calls they replace: PNG decoding, the letterbox resize and the
I420 packing bit for bit; the affine warps within a stated remainder. The
native library's resize, warp and PNG unfiltering (``csrc/image.cc``)
bit for bit against their numpy versions, and the numpy fallback where it
cannot be built. JPEG: tests/test_torch_jpeg.py."""

import math
import struct
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from smap_tpu_torch.data import image, native

# warp_affine against cv2.warpAffine: OpenCV's vector code forms the
# coordinates and sums with fused multiply-adds in an order the numpy
# model follows but for a few lanes, so a pixel near a rounding point may
# land one grey level away. Measured worst cases (tests below): linear
# 5e-6 of the pixels, cubic 1.7e-3 on a rotated 1080x1920 frame; the bound
# is one level on at most 1% of the pixels, with the output shape exact.
WARP_MAX_DIFF, WARP_MAX_SHARE = 1, 0.01


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _png_bytes(rows: np.ndarray, width: int, depth: int, ctype: int,
               palette=None, filter_type: int = 0) -> bytes:
    """A PNG of the packed scanlines ``rows`` [H, stride] with one filter
    type on every row (0 None, 1 Sub: the writer's own, for cases cv2
    cannot write: palettes and sub-byte depths)."""
    height, stride = rows.shape
    lines = []
    for r in range(height):
        line = rows[r]
        if filter_type == 1:
            line = line - np.concatenate([[0], line[:-1]]).astype(np.uint8)
        lines.append(bytes([filter_type]) + line.astype(np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
    if palette is not None:
        out += _png_chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return (out + _png_chunk(b"IDAT", zlib.compress(b"".join(lines)))
            + _png_chunk(b"IEND", b""))


def _smooth(rng, h, w, c, dtype=np.uint8):
    """Blocky content with noise: every filter wins on some rows."""
    top = 65535 if dtype == np.uint16 else 255
    base = rng.randint(0, top, (h // 4 + 1, w // 4 + 1, c))
    img = np.repeat(np.repeat(base, 4, 0), 4, 1)[:h, :w]
    img = img + rng.randint(-3, 4, img.shape) * (top // 255)
    return np.clip(img, 0, top).astype(dtype)


FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE,
           "sub": cv2.IMWRITE_PNG_FILTER_SUB,
           "up": cv2.IMWRITE_PNG_FILTER_UP,
           "avg": cv2.IMWRITE_PNG_FILTER_AVG,
           "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
           "all": cv2.IMWRITE_PNG_ALL_FILTERS}


@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra", "gray16", "bgr16",
                                  "bgra16"])
@pytest.mark.parametrize("filt", sorted(FILTERS))
def test_imread_png_written_by_cv2(tmp_path, kind, filt):
    """Every colour type cv2 writes, each filter, compression 0-9."""
    rng = np.random.RandomState(len(kind) * 7 + len(filt))
    channels = {"gray": 1, "bgr": 3, "bgra": 4}[kind.rstrip("16")]
    dtype = np.uint16 if kind.endswith("16") else np.uint8
    for level in range(10):
        h, w = rng.randint(1, 40), rng.randint(1, 50)
        img = _smooth(rng, h, w, channels, dtype)
        if channels == 1:
            img = img[..., 0]
        path = str(tmp_path / f"{kind}_{filt}_{level}.png")
        assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level,
                                       cv2.IMWRITE_PNG_FILTER, FILTERS[filt]])
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        got = image.imread(path)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want), (kind, filt, level)


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("ctype", [0, 3])
def test_imread_png_palette_and_low_depth(tmp_path, depth, ctype):
    """Grey and palette PNGs at 1-8 bits a sample, which cv2 reads but
    does not write."""
    rng = np.random.RandomState(depth + ctype)
    h, w = 13, 29
    values = rng.randint(0, 1 << depth, (h, w))
    bits = ((values[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    rows = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
    palette = (rng.randint(0, 256, (1 << depth, 3)) if ctype == 3 else None)
    for filt in (0, 1):
        path = tmp_path / f"p{depth}_{ctype}_{filt}.png"
        path.write_bytes(_png_bytes(rows, w, depth, ctype, palette, filt))
        want = cv2.imread(str(path), cv2.IMREAD_COLOR)
        got = image.imread(str(path))
        assert want is not None and np.array_equal(got, want)


def test_imread_missing_corrupt_and_unsupported(tmp_path):
    """None for a missing or corrupt file, as cv2.imread; an extension
    with no decoder and an interlaced PNG raise."""
    assert image.imread(str(tmp_path / "missing.png")) is None
    assert image.imread(str(tmp_path / "missing.jpg")) is None
    (tmp_path / "bad.png").write_bytes(b"\x89PNG\r\n\x1a\nnot a png")
    assert image.imread(str(tmp_path / "bad.png")) is None
    good = tmp_path / "good.png"
    cv2.imwrite(str(good), np.zeros((4, 4, 3), np.uint8))
    (tmp_path / "cut.png").write_bytes(good.read_bytes()[:-20])
    assert image.imread(str(tmp_path / "cut.png")) is None
    with pytest.raises(ValueError, match="no decoder"):
        image.imread(str(tmp_path / "frame.bmp"))
    data = bytearray(good.read_bytes())
    data[28] = 1                         # IHDR's interlace byte
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    (tmp_path / "adam7.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        image.imread(str(tmp_path / "adam7.png"))


def _resize_case(h, w, fx, fy, seed, cn=3):
    img = np.random.RandomState(seed).randint(0, 256, (h, w, cn)).astype(
        np.uint8)
    want = cv2.resize(img, (0, 0), fx=fx, fy=fy)
    if want.ndim == 2:
        want = want[..., None]
    got = image.resize_linear(img, fx, fy)
    assert got.shape == want.shape
    assert np.array_equal(got, want), (h, w, fx, fy)
    assert np.array_equal(image.resize_linear_numpy(img, fx, fy), got)


@pytest.mark.parametrize("h,w,net_h,net_w", [
    (1080, 1920, 512, 832), (480, 640, 512, 832), (2048, 2048, 512, 832),
    (512, 832, 512, 832), (1024, 1664, 512, 832), (720, 1280, 512, 832),
    (101, 77, 512, 832), (1080, 1920, 256, 416)])
def test_resize_linear_letterbox_scales(h, w, net_h, net_w):
    """The letterbox's own scales, down and up, and the exact half."""
    scale = min(net_w / w, net_h / h)
    _resize_case(h, w, scale, scale, seed=h + w)


def test_resize_linear_half_is_the_area_path():
    """At exactly 0.5 OpenCV halves by area; odd sizes cut the edge
    blocks."""
    for h, w in [(2, 3), (7, 11), (6, 8), (3, 7), (5, 3), (1023, 1663),
                 (1024, 1664)]:
        _resize_case(h, w, 0.5, 0.5, seed=h * w)
    _resize_case(30, 40, 0.5, 0.25, seed=1)      # not both 0.5: linear


@settings(max_examples=50, deadline=None)
@given(h=st.integers(1, 2100), w=st.integers(1, 2100),
       fx=st.floats(0.05, 4.0), fy=st.floats(0.05, 4.0),
       seed=st.integers(0, 1000))
def test_resize_linear_sweep(h, w, fx, fy, seed):
    """Any size and scale, down and up, including ones whose row length
    is not a multiple of OpenCV's vector width."""
    if round(w * fx) < 1 or round(h * fy) < 1:
        return
    if h * w * max(1.0, fx * fy) > 3e6:      # keep the sweep quick
        h = w = 64
    _resize_case(h, w, fx, fy, seed)


@pytest.mark.parametrize("h,w", [(2, 2), (4, 6), (10, 14), (64, 96),
                                 (512, 832), (100, 202), (1080, 1920)])
def test_bgr_to_i420(h, w):
    img = np.random.RandomState(h).randint(0, 256, (h, w, 3)).astype(
        np.uint8)
    want = cv2.cvtColor(img, cv2.COLOR_BGR2YUV_I420)
    assert np.array_equal(image.bgr_to_i420(img), want)
    with pytest.raises(ValueError, match="even"):
        image.bgr_to_i420(img[:1])


def _rotation(rng, h, w, max_deg=10.0):
    """rotate_augment's matrix and canvas, from cv2."""
    degree = (rng.random_sample() - 0.5) * 2 * max_deg
    m = cv2.getRotationMatrix2D((w // 2, h // 2), -degree, 1.0)
    cos, sin = abs(m[0, 0]), abs(m[0, 1])
    nw, nh = int(h * sin + w * cos), int(h * cos + w * sin)
    m[0, 2] += nw / 2 - w // 2
    m[1, 2] += nh / 2 - h // 2
    return m, (nw, nh)


def _composed(rng, h, w, crop=(64, 96)):
    """A composed augmentation matrix (rotation, scale, offset, flip)."""
    m, (nw, nh) = _rotation(rng, h, w)
    a = np.vstack([m, [0.0, 0.0, 1.0]])
    scale = min(crop[1] / nw, crop[0] / nh) * rng.uniform(0.8, 1.1)
    a = np.diag([scale, scale, 1.0]) @ a
    a[:2, 2] += rng.randint(-20, 20, 2)
    if rng.rand() < 0.5:
        a = np.array([[-1.0, 0, crop[1] - 1.0], [0, 1, 0], [0, 0, 1]]) @ a
    return a[:2], (crop[1], crop[0])


def _check_warp(img, m, size, interp):
    flag = cv2.INTER_LINEAR if interp == "linear" else cv2.INTER_CUBIC
    want = cv2.warpAffine(img, m, size, flags=flag,
                          borderMode=cv2.BORDER_CONSTANT,
                          borderValue=(128, 128, 128))
    got = image.warp_affine(img, m, size, interp)
    assert got.shape == want.shape
    assert np.array_equal(image.warp_affine_numpy(img, m, size, interp), got)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= WARP_MAX_DIFF
    assert (diff > 0).mean() <= WARP_MAX_SHARE
    return diff


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_warp_affine_simple_maps(interp):
    """Identity and whole-pixel shifts are exact; sub-pixel shifts and a
    shear within the remainder; the border reads 128."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (40, 50, 3)).astype(np.uint8)
    for m, exact in (([[1, 0, 0], [0, 1, 0]], True),
                     ([[1, 0, -3], [0, 1, 2]], True),
                     ([[1, 0, 0.3], [0, 1, 0.7]], False),
                     ([[0.9, 0.1, 3], [-0.1, 0.9, 2]], False)):
        diff = _check_warp(img, np.array(m, np.float64), (50, 40), interp)
        if exact:
            assert diff.max() == 0


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_warp_affine_augmentation_maps(interp):
    """Rotations drawn as rotate_augment draws them and composed matrices
    as composed_augment_sample builds them, on small frames."""
    rng = np.random.RandomState(1)
    for _ in range(8):
        h, w = rng.randint(20, 200), rng.randint(20, 200)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        _check_warp(img, *_rotation(rng, h, w), interp)
        _check_warp(img, *_composed(rng, h, w), interp)


def test_warp_affine_full_frame():
    """rotate_augment's cubic warp of one 1080x1920 frame."""
    rng = np.random.RandomState(2)
    img = _smooth(rng, 1080, 1920, 3)
    _check_warp(img, *_rotation(rng, 1080, 1920), "cubic")


def test_rotation_matrix_and_flip():
    rng = np.random.RandomState(3)
    for _ in range(50):
        center = (int(rng.randint(0, 2000)), int(rng.randint(0, 2000)))
        angle = (rng.random_sample() - 0.5) * 20
        want = cv2.getRotationMatrix2D(center, angle, 1.0)
        got = image.rotation_matrix_2d(center, angle, 1.0)
        assert got.dtype == np.float64 and np.array_equal(got, want)
    assert np.array_equal(image.rotation_matrix_2d((3.5, 1.25), 30, 0.5),
                          cv2.getRotationMatrix2D((3.5, 1.25), 30, 0.5))
    img = rng.randint(0, 256, (7, 9, 3)).astype(np.uint8)
    assert np.array_equal(image.flip_horizontal(img), cv2.flip(img, 1))
    assert math.isclose(float(image.rotation_matrix_2d((0, 0), 90, 1)[0, 1]),
                        1.0)


# device_letterbox_normalize against the JAX package's (jax.image.resize,
# linear, no antialias): both float32, the interpolation's products summed
# in another order; normalized values a few float32 ulps apart (measured
# 9.5e-7 at most), held to 1e-5 (0.0006 of a grey level).
DEVICE_LETTERBOX_ATOL = 1e-5


@pytest.mark.parametrize("h,w", [(300, 500), (100, 80), (512, 832),
                                 (600, 700), (33, 1000)])
def test_device_letterbox_normalize_matches_jax(h, w):
    import jax.numpy as jnp
    import torch

    from smap_tpu.data import preprocess as jpre

    from smap_tpu_torch.data import preprocess

    img = np.random.RandomState(h).randint(0, 256, (h, w, 3)).astype(
        np.uint8)
    want = np.asarray(jpre.device_letterbox_normalize(jnp.asarray(img),
                                                      (h, w)))
    got = preprocess.device_letterbox_normalize(torch.from_numpy(img), (h, w))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=DEVICE_LETTERBOX_ATOL)
    # The host letterbox (OpenCV's arithmetic) and normalize, exact.
    boxed, scale = preprocess.letterbox_image(img)
    jboxed, jscale = jpre.letterbox_image(img)
    assert np.array_equal(boxed, jboxed) and scale == jscale
    assert np.array_equal(preprocess.normalize_image(boxed),
                          jpre.normalize_image(boxed))


@pytest.fixture
def image_library():
    assert native.native_available("image"), native.build_error("image")


@pytest.mark.parametrize("cn", [1, 3, 4])
@pytest.mark.parametrize("fx,fy", [(832 / 1920, 832 / 1920), (0.5, 0.5),
                                   (1.7, 2.3), (4.0, 4.0), (0.26, 0.9)])
def test_resize_linear_native_equals_numpy_and_cv2(image_library, cn, fx,
                                                   fy):
    """The library's resize, bit for bit the numpy version and cv2: the
    letterbox scale, the area halving, upscales and mixed scales."""
    for h, w in [(1080, 1920), (37, 91), (2, 3), (101, 77)]:
        if round(w * fx) >= 1 and round(h * fy) >= 1:
            _resize_case(h, w, fx, fy, seed=h + cn, cn=cn)


@pytest.mark.parametrize("interp", ["linear", "cubic"])
@pytest.mark.parametrize("cn", [1, 3, 4])
def test_warp_affine_native_equals_numpy(image_library, interp, cn):
    """The library's warp, bit for bit the numpy version, over seeded
    rotations, composed augmentation matrices and random affines, borders
    included."""
    rng = np.random.RandomState(cn)
    for _ in range(6):
        h, w = rng.randint(1, 160), rng.randint(1, 160)
        img = rng.randint(0, 256, (h, w, cn)).astype(np.uint8)
        cases = [_rotation(rng, h, w), _composed(rng, h, w),
                 (rng.uniform(-2, 2, (2, 3)) * [1, 1, 40],
                  (int(rng.randint(1, 120)), int(rng.randint(1, 120))))]
        for m, size in cases:
            border = int(rng.randint(0, 256))
            got = image.warp_affine(img, m, size, interp, border)
            want = image.warp_affine_numpy(img, m, size, interp, border)
            assert got.shape == want.shape == (size[1], size[0], cn)
            assert np.array_equal(got, want)


@pytest.mark.parametrize("bpp", range(1, 9))
def test_unfilter_native_equals_numpy(image_library, bpp):
    """PNG unfiltering, all five filter types mixed row by row, at every
    bytes-a-pixel decode_png uses."""
    rng = np.random.RandomState(bpp)
    for height, width in [(1, 1), (7, 3), (40, 37)]:
        raw = rng.randint(0, 256, (height, 1 + bpp * width)).astype(np.uint8)
        raw[:, 0] = rng.randint(0, 5, height)
        got = image.unfilter(raw, bpp)
        assert got.dtype == np.uint8 and got.shape == (height, bpp * width)
        assert np.array_equal(got, image.unfilter_numpy(raw, bpp))
    raw[0, 0] = 5
    for fn in (image.unfilter, image.unfilter_numpy):
        with pytest.raises(image.PngError, match="filter type"):
            fn(raw, bpp)


def test_image_library_fallback_is_numpy(monkeypatch):
    """Where the library cannot be built: one warning, then the numpy
    versions, the same bits."""
    def no_gxx(name="preprocess"):
        raise FileNotFoundError("g++")

    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (30, 41, 3)).astype(np.uint8)
    m, size = _rotation(rng, 30, 41)
    want = (image.resize_linear(img, 0.7, 0.7),
            image.warp_affine(img, m, size, "cubic"))
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_errors", {})
    monkeypatch.setattr(native, "build", no_gxx)
    got = (image.resize_linear(img, 0.7, 0.7),
           image.warp_affine(img, m, size, "cubic"))
    assert not native.native_available("image")
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    png = _png_bytes(img[..., ::-1].reshape(30, -1), 41, 8, 2)
    assert np.array_equal(image.decode_png(png), img)

"""Host image operations without OpenCV: the port's counterparts of the
``cv2`` calls in the JAX package's data path.

On ``[H, W, 3]`` uint8 BGR arrays, each reproducing the OpenCV 5.0
function it replaces (``tests/test_torch_image.py`` and
``tests/test_torch_jpeg.py`` hold each against ``cv2``). The heavy ones
run in the native library (``data.native``: ``csrc/jpeg.cc`` and
``csrc/image.cc``); the numpy versions beside them are their plain
versions, bit for bit the same, and run where the library cannot be built:

* ``imread``: ``cv2.imread(path, IMREAD_COLOR)``. PNG is decoded here
  (``zlib``, the rows unfiltered by the library or ``unfilter_numpy``);
  JPEG by the native decoder (``decode_jpeg``), which gives libjpeg-turbo's
  bits and applies the EXIF orientation as OpenCV does. JPEG has no numpy
  version.
* ``resize_linear``: ``cv2.resize(img, (0, 0), fx=, fy=)`` with
  ``INTER_LINEAR``, bit for bit: 11-bit fixed-point coefficients, the
  exact integer horizontal pass, and the vertical pass as OpenCV's vector
  code rounds it, which covers every column; at exactly 0.5, OpenCV's
  area halving. Plain version: ``resize_linear_numpy``.
* ``bgr_to_i420``: ``cv2.cvtColor(COLOR_BGR2YUV_I420)``, bit for bit.
* ``warp_affine``: ``cv2.warpAffine`` with ``BORDER_CONSTANT``: source
  coordinates, weights and sums in float32 as OpenCV's vector code forms
  them. Linear and cubic differ from OpenCV by one grey level on under
  0.2% of the pixels (``tests/test_torch_image.py`` states the bound).
  Plain version: ``warp_affine_numpy``.
* ``rotation_matrix_2d`` (``cv2.getRotationMatrix2D``) and
  ``flip_horizontal`` (``cv2.flip(img, 1)``), exact.
"""

from __future__ import annotations

import ctypes
import math
import os
import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

from smap_tpu_torch.data import native

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8"
# PNG colour type -> samples a pixel.
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PngError(ValueError):
    """Corrupt PNG data."""


def imread(path: str) -> Optional[np.ndarray]:
    """``[H, W, 3]`` uint8 BGR, or None for a missing or unreadable file.

    ``.png``, ``.jpg`` and ``.jpeg`` files are read, each decoded as what
    its first bytes say it is (PNG or JPEG), as OpenCV does; anything else
    gives None. Any other extension, and a feature the decoders lack (an
    interlaced PNG; an arithmetic-coded, lossless, 12-bit, CMYK or RGB
    JPEG...) raise ValueError. Where the native JPEG decoder cannot be
    built, reading a JPEG raises RuntimeError with the build's error."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".png", ".jpg", ".jpeg"):
        raise ValueError(f"{path}: no decoder for {ext or 'no extension'!r}"
                         f" (PNG or JPEG)")
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if data.startswith(_PNG_SIGNATURE):
        try:
            return decode_png(data)
        except PngError:
            return None
    if data.startswith(_JPEG_SIGNATURE):
        try:
            return decode_jpeg(data)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    return None


# EXIF orientation -> (transpose, flip) as OpenCV applies it: flip 1 is
# horizontal, 0 vertical, -1 both.
_ORIENTATION = {2: (False, 1), 3: (False, -1), 4: (False, 0),
                5: (True, None), 6: (True, 1), 7: (True, -1), 8: (True, 0)}


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> ``[H, W, 3]`` uint8 BGR as ``cv2.imread(...,
    IMREAD_COLOR)`` gives it (EXIF orientation applied), or None where
    OpenCV gives None. A feature the decoder lacks raises ValueError
    naming it; a host where the decoder cannot be built, RuntimeError."""
    lib = native.load("jpeg")
    if lib is None:
        raise RuntimeError(f"the native JPEG decoder did not build:\n"
                           f"{native.build_error('jpeg')}")
    h, w, orient = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    args = (ctypes.byref(h), ctypes.byref(w), ctypes.byref(orient), err,
            len(err))
    rc = lib.jpeg_decode(data, len(data), None, 0, *args)
    if rc == 0:
        out = np.empty((h.value, w.value, 3), np.uint8)
        rc = lib.jpeg_decode(data, len(data), native.u8ptr(out), out.nbytes,
                             *args)
    if rc == 1:
        return None
    if rc == 2:
        raise ValueError(f"unsupported JPEG: {err.value.decode()}")
    transpose, flip = _ORIENTATION.get(orient.value, (False, None))
    if transpose:
        out = out.transpose(1, 0, 2)
    if flip is not None:
        out = out[:, ::-1] if flip == 1 else (
            out[::-1] if flip == 0 else out[::-1, ::-1])
    return np.ascontiguousarray(out)


def _png_chunks(data: bytes):
    if data[:8] != _PNG_SIGNATURE:
        raise PngError("not a PNG")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise PngError("truncated chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise PngError("no IEND chunk")


def _unfilter_average(cur: bytearray, prev: bytes, bpp: int) -> None:
    """Average filter, in place: each byte adds the floor mean of the
    reconstructed byte to its left and the one above."""
    for i in range(len(cur)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 255


def _unfilter_paeth(cur: bytearray, prev: bytes, bpp: int) -> None:
    """Paeth filter, in place: each byte adds whichever of left, above and
    upper-left is nearest to left + above - upper-left."""
    for i in range(len(cur)):
        if i >= bpp:
            a, c = cur[i - bpp], prev[i - bpp]
        else:
            a = c = 0
        b = prev[i]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 255


def unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Filtered scanlines ``[height, 1 + stride]`` uint8 -> ``[height,
    stride]`` bytes, ``bpp`` bytes a pixel (at least 1), in the native
    library; ``unfilter_numpy`` where it cannot be built."""
    lib = native.load("image")
    if lib is None:
        return unfilter_numpy(raw, bpp)
    raw = np.ascontiguousarray(raw, np.uint8)
    height, stride = raw.shape[0], raw.shape[1] - 1
    out = np.empty((height, stride), np.uint8)
    if lib.png_unfilter(native.u8ptr(raw), height, stride, bpp,
                        native.u8ptr(out)):
        raise PngError("bad filter type")
    return out


def unfilter_numpy(raw: np.ndarray, bpp: int) -> np.ndarray:
    """``unfilter`` in numpy: None, Sub and Up are whole-row operations;
    Average and Paeth run byte by byte, each byte depending on the one to
    its left."""
    height, stride = raw.shape[0], raw.shape[1] - 1
    types = raw[:, 0]
    if int(types.max(initial=0)) > 4:
        raise PngError("bad filter type")
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        line, kind = raw[r, 1:], types[r]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        else:
            buf = bytearray(line.tobytes())
            (_unfilter_average if kind == 3 else _unfilter_paeth)(
                buf, prev.tobytes(), bpp)
            cur = np.frombuffer(buf, np.uint8)
        out[r] = cur
        prev = out[r]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> ``[H, W, 3]`` uint8 BGR as ``IMREAD_COLOR`` gives it:
    grey replicated, alpha dropped, a palette looked up, 16-bit samples
    cut to their high byte. Corrupt data raises PngError, an interlaced
    PNG ValueError."""
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise PngError("no IHDR or IDAT chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise PngError("bad IHDR")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    channels = _PNG_CHANNELS[ctype]
    stride = (width * channels * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError(f"bad image data: {e}") from None
    if len(raw) < height * (stride + 1):
        raise PngError("truncated image data")
    raw = np.frombuffer(raw, np.uint8)[:height * (stride + 1)]
    rows = unfilter(raw.reshape(height, stride + 1),
                    max(1, channels * depth // 8))
    if depth == 16:
        px = rows.reshape(height, width, channels, 2)[..., 0]
    elif depth == 8:
        px = rows.reshape(height, width, channels)
    else:
        bits = np.unpackbits(rows, axis=1)[:, :width * depth]
        weights = 1 << np.arange(depth - 1, -1, -1, dtype=np.uint8)
        px = (bits.reshape(height, width, depth) * weights).sum(
            axis=-1, dtype=np.uint8)[..., None]
        if ctype == 0:   # grey scaled to 0..255
            px = px * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if palette is None:
            raise PngError("palette image without PLTE")
        rgb = palette[np.minimum(px[..., 0], len(palette) - 1)]
    elif channels <= 2:
        rgb = np.repeat(px[..., :1], 3, axis=-1)
    else:
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def _linear_taps(n_dst: int, n_src: int, scale: float, clamp: bool):
    """Source index and the two 11-bit weights of each destination index:
    ``(d + 0.5) * scale - 0.5`` rounded to float32, its floor and fraction
    in float32, each weight ``rint(w * 2048)``. ``clamp``: outside the
    source the fraction is 0 at the nearest edge (OpenCV clamps columns
    here, rows when it fetches them)."""
    d = np.arange(n_dst, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    if clamp:
        low, high = s < 0, s >= n_src - 1
        f[low | high] = 0.0
        s = np.clip(s, 0, n_src - 1)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(2048.0)).astype(np.int32)
    w1 = np.rint(f * np.float32(2048.0)).astype(np.int32)
    return s, w0, w1


def _half_by_area(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """OpenCV's ``INTER_AREA`` halving, which it runs for ``INTER_LINEAR``
    at exactly 0.5: each whole 2x2 block's mean rounded half up (its
    vector code), a block cut by an odd edge the float mean of its pixels
    rounded half to even."""
    h, w, cn = img.shape
    fh, fw = h // 2, w // 2
    px = img.astype(np.int32)
    out = np.empty((dh, dw, cn), np.int32)
    blocks = px[:2 * fh, :2 * fw].reshape(fh, 2, fw, 2, cn).sum(axis=(1, 3))
    out[:fh, :fw] = (blocks + 2) >> 2

    def mean(vals: np.ndarray, count: int) -> np.ndarray:
        return np.rint(vals.astype(np.float32) / np.float32(count))

    if dw > fw:     # the last column's blocks hold one source column
        out[:fh, fw] = mean(px[:2 * fh, w - 1].reshape(fh, 2, cn).sum(1), 2)
    if dh > fh:     # the last row's blocks hold one source row
        out[fh, :fw] = mean(px[h - 1, :2 * fw].reshape(fw, 2, cn).sum(1), 2)
        if dw > fw:
            out[fh, fw] = px[h - 1, w - 1]
    return out.astype(np.uint8)


def _resize_plan(img: np.ndarray, fx: float, fy: float):
    """(output width, height, "copy" | "half" | "linear")."""
    h, w = img.shape[:2]
    dw, dh = int(round(w * fx)), int(round(h * fy))
    if dw <= 0 or dh <= 0:
        raise ValueError(f"resize of {w}x{h} by ({fx}, {fy}) is empty")
    if (dw, dh) == (w, h):
        return dw, dh, "copy"
    # OpenCV's test: 1 / f within DBL_EPSILON of the integer 2.
    eps = np.finfo(np.float64).eps
    if abs(1.0 / fx - 2) < eps and abs(1.0 / fy - 2) < eps:
        return dw, dh, "half"
    return dw, dh, "linear"


def resize_linear(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """``cv2.resize(img, (0, 0), fx=fx, fy=fy)`` (``INTER_LINEAR``) of a
    ``[H, W, C]`` uint8 image: the output is ``round(W * fx)`` x
    ``round(H * fy)`` (ties to even), the source coordinate of destination
    ``d`` is ``(d + 0.5) / f - 0.5``. Same size: a copy; a scale of
    exactly 0.5 on both axes: OpenCV's area halving. In the native
    library; ``resize_linear_numpy`` where it cannot be built."""
    dw, dh, mode = _resize_plan(img, fx, fy)
    lib = native.load("image")
    if lib is None or img.ndim != 3 or img.dtype != np.uint8:
        return resize_linear_numpy(img, fx, fy)
    if mode == "copy":
        return img.copy()
    src = np.ascontiguousarray(img)
    h, w, cn = src.shape
    out = np.empty((dh, dw, cn), np.uint8)
    if mode == "half":
        lib.half_by_area_u8(native.u8ptr(src), h, w, cn, native.u8ptr(out),
                            dh, dw)
    else:
        lib.resize_linear_u8(native.u8ptr(src), h, w, cn, native.u8ptr(out),
                             dh, dw, 1.0 / fx, 1.0 / fy)
    return out


def resize_linear_numpy(img: np.ndarray, fx: float, fy: float
                        ) -> np.ndarray:
    """``resize_linear`` in numpy."""
    h, w = img.shape[:2]
    dw, dh, mode = _resize_plan(img, fx, fy)
    if mode == "copy":
        return img.copy()
    if mode == "half":
        return _half_by_area(img, dw, dh)
    xs, xw0, xw1 = _linear_taps(dw, w, 1.0 / fx, clamp=True)
    ys, yw0, yw1 = _linear_taps(dh, h, 1.0 / fy, clamp=False)
    r0, r1 = np.clip(ys, 0, h - 1), np.clip(ys + 1, 0, h - 1)
    # The horizontal pass, exact in int32, on the rows the output reads.
    used = np.unique(np.concatenate([r0, r1]))
    src = img[used].astype(np.int32)
    x1 = np.minimum(xs + 1, w - 1)
    rows = (src[:, xs] * xw0[None, :, None]
            + src[:, x1] * xw1[None, :, None])
    pos = np.searchsorted(used, r0), np.searchsorted(used, r1)
    t0 = rows[pos[0]] >> 4
    t1 = rows[pos[1]] >> 4
    # The vertical pass as OpenCV's vector code rounds it: each row's
    # product with its weight keeps its high 16 bits, then (sum + 2) >> 2.
    b0, b1 = yw0[:, None, None], yw1[:, None, None]
    out = (((t0 * b0) >> 16) + ((t1 * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def bgr_to_i420(img: np.ndarray) -> np.ndarray:
    """``[H, W, 3]`` uint8 BGR -> packed planar I420 ``[3H/2, W]`` uint8,
    as ``cv2.cvtColor(COLOR_BGR2YUV_I420)``: BT.601 in 20-bit fixed point,
    U and V from the top-left pixel of each 2x2 block. H and W even."""
    h, w = img.shape[:2]
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs an even size, got {w}x{h}")
    px = img.astype(np.int64)
    b, g, r = px[..., 0], px[..., 1], px[..., 2]
    half = 1 << 19
    y = (269484 * r + 528482 * g + 102760 * b + half + (16 << 20)) >> 20
    r, g, b = r[::2, ::2], g[::2, ::2], b[::2, ::2]
    u = (-155188 * r - 305135 * g + 460324 * b + half + (128 << 20)) >> 20
    v = (460324 * r - 385875 * g - 74448 * b + half + (128 << 20)) >> 20
    planes = np.concatenate([y.reshape(-1), u.reshape(-1), v.reshape(-1)])
    return np.clip(planes, 0, 255).astype(np.uint8).reshape(h * 3 // 2, w)


def rotation_matrix_2d(center: Tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: ``[2, 3]`` float64 rotating by
    ``angle`` degrees (counter-clockwise) about ``center`` (rounded to
    float32, as OpenCV takes it)."""
    cx, cy = (float(np.float32(c)) for c in center)
    rad = angle * (math.pi / 180)
    alpha, beta = math.cos(rad) * scale, math.sin(rad) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def flip_horizontal(img: np.ndarray) -> np.ndarray:
    """``cv2.flip(img, 1)``."""
    return np.ascontiguousarray(img[:, ::-1])


def _invert_affine(m: np.ndarray) -> Sequence[float]:
    """The inverse map of a ``[2, 3]`` affine, in OpenCV's order of
    double operations."""
    m0, m1, m2, m3, m4, m5 = (float(v) for v in np.asarray(m).reshape(6))
    d = m0 * m4 - m1 * m3
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m4 * d, m0 * d
    m0, m1, m3, m4 = a11, m1 * -d, m3 * -d, a22
    return m0, m1, -m0 * m2 - m1 * m5, m3, m4, -m3 * m2 - m4 * m5


def _fma32(a, b, c) -> np.ndarray:
    """``a * b + c`` of float32 operands, rounded once to float32 (the
    product is exact in float64)."""
    return (np.float64(a) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


# warp_affine's rows a block: its gathers stay tens of MB at 2000 columns.
_WARP_ROWS = 64


def _cubic_weights(t: np.ndarray):
    """The four bicubic weights (A = -0.75) at fraction ``t``, float32."""
    a, one = np.float32(-0.75), np.float32(1.0)
    w0 = ((a * (t + one) - 5 * a) * (t + one) + 8 * a) * (t + one) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + one
    w2 = ((a + 2) * (one - t) - (a + 3)) * (one - t) * (one - t) + one
    return w0, w1, w2, one - w0 - w1 - w2


def warp_affine(img: np.ndarray, m: np.ndarray, size: Tuple[int, int],
                interp: str = "linear", border: int = 128) -> np.ndarray:
    """``cv2.warpAffine(img, m, size, flags=INTER_LINEAR | INTER_CUBIC,
    borderMode=BORDER_CONSTANT, borderValue=(border,) * 3)`` of a
    ``[H, W, C]`` uint8 image (``warp_affine_numpy`` states the
    arithmetic); ``size`` is ``(width, height)``. In the native library
    for up to 4 channels; ``warp_affine_numpy`` where it cannot be
    built."""
    if interp not in ("linear", "cubic"):
        raise ValueError(f"interp {interp!r}: 'linear' or 'cubic'")
    lib = native.load("image")
    if (lib is None or img.ndim != 3 or img.dtype != np.uint8
            or img.shape[2] > 4):
        return warp_affine_numpy(img, m, size, interp, border)
    w, h = size
    src = np.ascontiguousarray(img)
    src_h, src_w, cn = src.shape
    minv = np.asarray(_invert_affine(m), np.float64).astype(np.float32)
    out = np.empty((h, w, cn), np.uint8)
    lib.warp_affine_u8(native.u8ptr(src), src_h, src_w, cn,
                       native.u8ptr(out), h, w,
                       minv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       int(interp == "cubic"), int(border))
    return out


def warp_affine_numpy(img: np.ndarray, m: np.ndarray,
                      size: Tuple[int, int], interp: str = "linear",
                      border: int = 128) -> np.ndarray:
    """``cv2.warpAffine(img, m, size, flags=INTER_LINEAR | INTER_CUBIC,
    borderMode=BORDER_CONSTANT, borderValue=(border,) * 3)`` of a
    ``[H, W, C]`` uint8 image; ``size`` is ``(width, height)``.

    Destination ``(x, y)`` reads the source at the inverse map, formed in
    float32 as ``fma(x, m0, y * m1 + m2)``; taps outside the source read
    ``border``; linear interpolates with two float32 lerps, cubic with
    separable A = -0.75 weights, rows first; the result rounds to nearest
    even."""
    if interp not in ("linear", "cubic"):
        raise ValueError(f"interp {interp!r}: 'linear' or 'cubic'")
    w, h = size
    src_h, src_w, cn = img.shape
    minv = np.asarray(_invert_affine(m), np.float64).astype(np.float32)
    taps = 2 if interp == "linear" else 4
    pad = taps
    padded = np.full((src_h + 2 * pad, src_w + 2 * pad, cn), border, np.uint8)
    padded[pad:pad + src_h, pad:pad + src_w] = img
    flat = padded.reshape(-1, cn)
    pw = padded.shape[1]
    xs = np.arange(w, dtype=np.float32)
    out = np.empty((h, w, cn), np.uint8)
    lo = 1 - taps // 2            # the first tap's offset from the floor
    for y0 in range(0, h, _WARP_ROWS):
        ys = np.arange(y0, min(h, y0 + _WARP_ROWS), dtype=np.float32)
        row_x = ys * minv[1] + minv[2]
        row_y = ys * minv[4] + minv[5]
        sx = _fma32(minv[0], xs[None, :], row_x[:, None])
        sy = _fma32(minv[3], xs[None, :], row_y[:, None])
        fx, fy = np.floor(sx), np.floor(sy)
        ax, ay = sx - fx, sy - fy
        # Coordinates far outside the source read the border through the
        # clipped index of a padded corner.
        ix = np.clip(fx, -pad, src_w + pad).astype(np.int64) + pad + lo
        iy = np.clip(fy, -pad, src_h + pad).astype(np.int64) + pad + lo
        ix = np.clip(ix, 0, pw - taps)
        iy = np.clip(iy, 0, padded.shape[0] - taps)
        base = iy * pw + ix

        def tap(dy, dx):
            return flat[base + dy * pw + dx].astype(np.float32)

        if interp == "linear":
            a, b = ax[..., None], ay[..., None]
            p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
            v = _lerp(b, _lerp(a, p00, p01), _lerp(a, p10, p11))
        else:
            wx = [c[..., None] for c in _cubic_weights(ax)]
            wy = [c[..., None] for c in _cubic_weights(ay)]
            v = np.zeros(ax.shape + (cn,), np.float32)
            for dy in range(4):
                row = np.zeros_like(v)
                for dx in range(4):
                    row += tap(dy, dx) * wx[dx]
                v += row * wy[dy]
        out[y0:y0 + len(ys)] = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return out


def _lerp(t: np.ndarray, p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """``fma(t, q - p, p)``, ``q - p`` rounded to float32 first."""
    return (t.astype(np.float64) * (q - p).astype(np.float64)
            + p).astype(np.float32)

"""The port's JPEG decoder (``smap_tpu_torch/csrc/jpeg.cc`` through
``data.image.imread``) against ``cv2.imread(path, IMREAD_COLOR)``, bit for
bit: frames written by OpenCV and PIL over sizes that are not multiples of
the MCU, qualities, samplings, grey, progressive, restart intervals,
optimized and missing Huffman tables, 16-bit quantization tables, the EXIF
orientations, truncated files and corrupt scan data; the committed
fixtures (``tests/torch_jpeg/``) against their manifest; the modes it does
not decode raise ValueError naming them; and it needs no OpenCV."""

import builtins
import hashlib
import io
import json
import os
import struct
import threading

import cv2
import numpy as np
import pytest
from PIL import Image

from make_torch_jpeg import OUT as FIXTURES
from make_torch_jpeg import cv2_entry, textured, with_orientation
from smap_tpu_torch.data import image, native

SIZES = [(1, 1), (1, 2), (2, 1), (3, 5), (5, 3), (7, 9), (8, 8), (9, 7),
         (16, 16), (17, 33), (33, 17), (61, 83), (31, 4), (4, 31)]
CV2_SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


@pytest.fixture(autouse=True)
def decoder_built():
    assert native.native_available("jpeg"), native.build_error("jpeg")


class Files:
    """Writes JPEG bytes to files and holds imread to cv2.imread on each."""

    def __init__(self, tmp_path):
        self.dir, self.n = tmp_path, 0

    def check(self, data: bytes, label: str = ""):
        path = str(self.dir / f"f{self.n}.jpg")
        self.n += 1
        with open(path, "wb") as f:
            f.write(data)
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        got = image.imread(path)
        if want is None:
            assert got is None, label
        else:
            assert got is not None, label
            assert got.dtype == np.uint8 and got.shape == want.shape, label
            assert np.array_equal(got, want), label
        return got


def _pil(img, **kw):
    buf = io.BytesIO()
    src = img[..., 0] if img.shape[2] == 1 else img[..., ::-1]
    Image.fromarray(np.ascontiguousarray(src)).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("sampling", sorted(CV2_SAMPLING))
@pytest.mark.parametrize("progressive", [0, 1])
def test_cv2_encoded(tmp_path, sampling, progressive):
    """cv2.imencode at qualities 10-100, every size, each sampling,
    sequential and progressive."""
    files, rng = Files(tmp_path), np.random.RandomState(len(sampling))
    for h, w in SIZES:
        img = textured(rng, h, w)
        for q in (10, 50, 75, 95, 100):
            files.check(cv2.imencode(".jpg", img, [
                cv2.IMWRITE_JPEG_QUALITY, q,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, CV2_SAMPLING[sampling],
                cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])[1].tobytes(),
                f"{h}x{w} q{q}")


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("kind", ["baseline", "optimized", "progressive"])
def test_pil_encoded(tmp_path, subsampling, kind):
    """PIL at qualities 10-100 and each subsampling: standard tables,
    optimized tables, and progressive with optimized tables."""
    files, rng = Files(tmp_path), np.random.RandomState(subsampling)
    kw = {"baseline": {}, "optimized": {"optimize": True},
          "progressive": {"optimize": True, "progressive": True}}[kind]
    for h, w in SIZES:
        img = textured(rng, h, w)
        for q in (10, 50, 75, 95, 100):
            files.check(_pil(img, quality=q, subsampling=subsampling, **kw),
                        f"{h}x{w} q{q}")


def test_grey_restart_and_16bit_tables(tmp_path):
    """Grey frames (cv2 and PIL, progressive too), restart intervals of 1-5
    MCUs, and quantization tables with 16-bit entries (extended
    sequential)."""
    files, rng = Files(tmp_path), np.random.RandomState(3)
    for h, w in SIZES:
        img = textured(rng, h, w)
        grey = img[..., :1]
        files.check(cv2.imencode(".jpg", grey[..., 0])[1].tobytes())
        files.check(_pil(grey, quality=70))
        files.check(_pil(grey, quality=70, progressive=True))
        for rst in (1, 2, 5):
            files.check(cv2.imencode(".jpg", img, [
                cv2.IMWRITE_JPEG_RST_INTERVAL, rst])[1].tobytes())
        table = list(range(200, 264))
        wide = [t * 3 for t in table]          # entries above 255
        data = _pil(img, qtables=[wide, table], subsampling=0)
        assert b"\xff\xc1" in data                 # SOF1
        files.check(data, f"16-bit {h}x{w}")


def _strip(data: bytes, marker: int) -> bytes:
    """``data`` without its segments of ``marker`` before the first
    scan."""
    out, pos = bytearray(data[:2]), 2
    while True:
        m = data[pos + 1]
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if m == 0xDA:
            return bytes(out + data[pos:])
        if m != marker:
            out += data[pos:pos + 2 + length]
        pos += 2 + length


def test_standard_tables_where_none_are_given(tmp_path):
    """A file with no DHT (Motion JPEG's frames): the standard tables."""
    files, rng = Files(tmp_path), np.random.RandomState(4)
    for h, w in SIZES[::3]:
        img = textured(rng, h, w)
        data = cv2.imencode(".jpg", img)[1].tobytes()
        files.check(_strip(data, 0xC4), f"{h}x{w}")


@pytest.mark.parametrize("orientation", range(0, 10))
def test_exif_orientation(tmp_path, orientation):
    """Orientation 1-8 transposed and flipped as OpenCV does; 0 and 9
    leave the frame as it is."""
    img = textured(np.random.RandomState(5), 45, 70)
    data = cv2.imencode(".jpg", img)[1].tobytes()
    got = Files(tmp_path).check(with_orientation(data, orientation))
    assert got.shape == ((70, 45, 3) if orientation in (5, 6, 7, 8)
                         else (45, 70, 3))


@pytest.mark.parametrize("kind", ["420", "444", "restart", "grey"])
def test_truncated(tmp_path, kind):
    """Cut at points through the headers (None) and the scan (the rest
    grey, as libjpeg finishes a file that ends early)."""
    files, rng = Files(tmp_path), np.random.RandomState(6)
    img = textured(rng, 70, 110)
    params = {"420": [], "444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
              "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
              "grey": []}[kind]
    src = img[..., 0] if kind == "grey" else img
    data = cv2.imencode(".jpg", src, params)[1].tobytes()
    scan = data.index(b"\xff\xda")
    cuts = sorted(set(list(range(0, scan + 20, 9))
                      + list(range(scan, len(data), 41)) + [len(data) - 1]))
    results = [files.check(data[:cut], f"cut {cut}") for cut in cuts]
    assert results[0] is None and results[-1] is not None


def test_corrupt_scan_data(tmp_path):
    """Bytes of the scan overwritten at seeded places: libjpeg decodes on
    (bad codes, runs past the block, DC drift) and so does the port."""
    files, rng = Files(tmp_path), np.random.RandomState(7)
    for kind in ("420", "444", "restart"):
        img = textured(rng, 64, 96)
        params = {"420": [cv2.IMWRITE_JPEG_QUALITY, 50],
                  "444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
                  "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]}[kind]
        data = cv2.imencode(".jpg", img, params)[1].tobytes()
        scan = data.index(b"\xff\xda") + 14
        for trial in range(25):
            bad = bytearray(data)
            for _ in range(rng.randint(1, 5)):
                bad[rng.randint(scan, len(bad) - 2)] = rng.randint(0, 256)
            files.check(bytes(bad), f"{kind} {trial}")


def test_fixtures_manifest_is_cv2():
    """The committed manifest is what cv2.imread gives here."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    assert len(manifest) == len(os.listdir(FIXTURES)) - 1
    for name, want in manifest.items():
        assert cv2_entry(os.path.join(FIXTURES, name)) == want, name


def test_fixtures_decode_to_the_manifest():
    """Every fixture decodes to its manifest entry; cv2's None is None."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    assert sum(v is None for v in manifest.values()) == 1
    for name, want in manifest.items():
        got = image.imread(os.path.join(FIXTURES, name))
        if want is None:
            assert got is None, name
            continue
        assert list(got.shape) == want["shape"], name
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]


def test_reads_without_opencv(tmp_path, monkeypatch):
    """imread of a JPEG with ``import cv2`` failing: the native decoder,
    equal to what cv2 gave before it was blocked."""
    rng = np.random.RandomState(0)
    path = str(tmp_path / "f.jpg")
    cv2.imwrite(path, textured(rng, 16, 24))
    want = cv2.imread(path)
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2" or name.startswith("cv2."):
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    assert np.array_equal(image.imread(path), want)
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401


def test_no_compiler_raises_with_the_build_error(tmp_path, monkeypatch):
    """Where the decoder cannot be built, reading a JPEG raises with the
    build's error; it never falls back to anything else."""
    def no_gxx(name="preprocess"):
        raise FileNotFoundError("g++ not found")

    path = str(tmp_path / "f.jpg")
    cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8))
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_errors", {})
    monkeypatch.setattr(native, "build", no_gxx)
    with pytest.raises(RuntimeError, match=r"(?s)JPEG decoder did not "
                                           r"build.*g\+\+ not found"):
        image.imread(path)


def _with_byte(data: bytes, find: bytes, offset: int, value: int) -> bytes:
    out = bytearray(data)
    out[data.index(find) + offset] = value
    return bytes(out)


def test_unsupported_modes_raise(tmp_path):
    """Arithmetic coding, lossless, hierarchical, 12-bit samples, CMYK,
    RGB, an unfinished progressive file and more than 2^30 pixels (where
    cv2.imread raises) each raise ValueError naming the mode."""
    rng = np.random.RandomState(8)
    img = textured(rng, 16, 16)
    base = cv2.imencode(".jpg", img)[1].tobytes()
    prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                      1])[1].tobytes()
    cmyk = io.BytesIO()
    Image.fromarray(img[..., ::-1]).convert("CMYK").save(cmyk, "JPEG")
    # No JFIF marker and components named R, G, B: an RGB file.
    rgb = bytearray(_strip(
        cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])[1]
        .tobytes(), 0xE0))
    sof = rgb.index(b"\xff\xc0")
    for k, cid in enumerate(b"RGB"):
        rgb[sof + 10 + 3 * k] = cid
    sos = rgb.index(b"\xff\xda")
    for k, cid in enumerate(b"RGB"):
        rgb[sos + 5 + 2 * k] = cid
    cases = {
        "arithmetic": _with_byte(base, b"\xff\xc0", 1, 0xC9),
        "lossless": _with_byte(base, b"\xff\xc0", 1, 0xC3),
        "hierarchical": _with_byte(base, b"\xff\xc0", 1, 0xC5),
        "12-bit": _with_byte(base, b"\xff\xc0", 4, 12),
        "CMYK": cmyk.getvalue(),
        "RGB": bytes(rgb),
        "progressive": prog[:prog.rindex(b"\xff\xda")],   # no last scan
        "pixels": _with_byte(_with_byte(base, b"\xff\xc0", 5, 0x9C),
                             b"\xff\xc0", 7, 0x9C),       # 39952 x 39952
    }
    for word, data in cases.items():
        path = tmp_path / f"{word}.jpg"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=f"{path.name}: unsupported "
                                             f"JPEG: .*{word}"):
            image.imread(str(path))


def test_decodes_in_parallel_threads(tmp_path):
    """The decoder keeps no state and ctypes drops the GIL: threads decode
    at once, each frame equal to its decode alone."""
    rng = np.random.RandomState(9)
    paths = []
    for i in range(8):
        paths.append(str(tmp_path / f"f{i}.jpg"))
        cv2.imwrite(paths[-1], textured(rng, 120, 160))
    want = [image.imread(p) for p in paths]
    got = [None] * len(paths)

    def work(i):
        for _ in range(3):
            got[i] = image.imread(paths[i])

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(paths))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_not_a_jpeg_and_png_by_content(tmp_path):
    """As cv2.imread: files are decoded by what their bytes are, so a PNG
    named .jpg reads; an empty file or garbage gives None."""
    img = textured(np.random.RandomState(10), 9, 13)
    png = tmp_path / "png.jpg"
    png.write_bytes(cv2.imencode(".png", img)[1].tobytes())
    assert np.array_equal(image.imread(str(png)),
                          cv2.imread(str(png), cv2.IMREAD_COLOR))
    for name, data in (("empty.jpg", b""), ("junk.jpeg", b"\x00" * 100),
                       ("soi.jpg", b"\xff\xd8")):
        (tmp_path / name).write_bytes(data)
        assert cv2.imread(str(tmp_path / name)) is None
        assert image.imread(str(tmp_path / name)) is None

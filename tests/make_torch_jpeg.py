"""Writes the JPEG fixtures of ``tests/torch_jpeg/`` and their manifest.

    python tests/make_torch_jpeg.py      # needs cv2 and PIL

The files are encoded by OpenCV and by PIL from seeded frames: odd sizes
that are not multiples of the MCU at qualities 10-100 and 4:4:4, 4:2:2 and
4:2:0 sampling, grey frames, progressive frames of both encoders, a
restart interval, PIL's optimized Huffman tables, the eight EXIF
orientations, a file cut inside its scan and one cut inside its headers,
and two 1080x1920 frames of a rendered scene. ``manifest.json`` records
what ``cv2.imread(path, IMREAD_COLOR)`` returns for each file: its shape
and the sha256 of its bytes, or null where it returns None.
``tests/test_torch_jpeg.py`` holds the manifest to cv2 and the port's
decoder to the manifest; ``chip_smoke.py`` holds the decoder to it on the
card's machine, which has no OpenCV.
"""

import hashlib
import io
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_jpeg")
SMALL_SIZES = [(1, 1), (7, 9), (17, 33), (61, 83)]
QUALITIES = [10, 50, 75, 95, 100]
# cv2 sampling flag name -> file tag; PIL subsampling 0/1/2 = 4:4:4/2:2/2:0.
SAMPLINGS = {"444": 0, "422": 1, "420": 2}
FULL_HW = (1080, 1920)


def textured(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A smooth random field with mild noise, BGR uint8."""
    import cv2

    base = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.float32)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_LINEAR)
    return np.clip(img + rng.randn(h, w, 3) * 6, 0, 255).astype(np.uint8)


def rendered_scene(rng: np.random.RandomState) -> np.ndarray:
    """A FULL_HW frame: a lit room (gradient wall, tiled floor) and a few
    shaded standing figures, with mild sensor noise."""
    h, w = FULL_HW
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    wall = np.stack([120 + 60 * x / w, 110 + 40 * y / h,
                     90 + 30 * (1 - x / w)], -1)
    horizon = int(h * 0.6)
    tiles = ((x // 96 + (y - horizon) // 48) % 2)[..., None] * 30 + 60
    floor = np.concatenate([tiles + 40, tiles + 20, tiles], -1)
    img = np.where((y >= horizon)[..., None], floor, wall)
    for _ in range(rng.randint(3, 6)):
        cx, top = rng.uniform(200, w - 200), rng.uniform(150, 350)
        height = rng.uniform(500, 750)
        colour = rng.uniform(30, 220, 3)
        for cy, ry, rx in ((top, 60, 45), (top + height * 0.35, height * 0.25,
                                           90), (top + height * 0.75,
                                                 height * 0.25, 60)):
            d = ((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2
            shade = np.clip(1.2 - 0.5 * d, 0.4, 1.2)[..., None]
            img = np.where((d <= 1)[..., None], colour * shade, img)
    img = img + rng.randn(h, w, 3) * 2
    return np.clip(img, 0, 255).astype(np.uint8)


def pil_jpeg(img_bgr: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    mode = "L" if img_bgr.ndim == 2 else "RGB"
    src = img_bgr if img_bgr.ndim == 2 else img_bgr[..., ::-1]
    Image.fromarray(np.ascontiguousarray(src), mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def cv2_jpeg(img: np.ndarray, *params) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def with_orientation(data: bytes, orientation: int) -> bytes:
    """``data`` with an EXIF APP1 segment holding only the Orientation tag,
    after SOI (little-endian for odd values, big-endian for even)."""
    import struct

    little = orientation % 2 == 1
    e = "<" if little else ">"
    tiff = ((b"II" if little else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    seg = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg \
        + data[2:]


def fixtures():
    """name -> JPEG bytes."""
    import cv2

    rng = np.random.RandomState(0)
    files = {}
    flags = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
    for h, w in SMALL_SIZES:
        img = textured(rng, h, w)
        for q in QUALITIES:
            for tag, flag in flags.items():
                files[f"cv2_{h}x{w}_q{q}_{tag}.jpg"] = cv2_jpeg(
                    img, cv2.IMWRITE_JPEG_QUALITY, q,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag)
        files[f"grey_cv2_{h}x{w}.jpg"] = cv2_jpeg(img[..., 1])
        files[f"grey_pil_{h}x{w}.jpg"] = pil_jpeg(img[..., 2], quality=90)
        for tag, sub in SAMPLINGS.items():
            files[f"prog_cv2_{h}x{w}_{tag}.jpg"] = cv2_jpeg(
                img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flags[tag])
            files[f"prog_pil_{h}x{w}_{tag}.jpg"] = pil_jpeg(
                img, quality=80, subsampling=sub, progressive=True)
            files[f"optimized_pil_{h}x{w}_{tag}.jpg"] = pil_jpeg(
                img, quality=85, subsampling=sub, optimize=True)
        files[f"restart_{h}x{w}.jpg"] = cv2_jpeg(
            img, cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
    img = textured(rng, 45, 70)
    plain = cv2_jpeg(img, cv2.IMWRITE_JPEG_QUALITY, 90)
    for o in range(1, 9):
        files[f"exif_orientation{o}.jpg"] = with_orientation(plain, o)
    whole = cv2_jpeg(textured(rng, 64, 96), cv2.IMWRITE_JPEG_QUALITY, 90)
    scan = whole.index(b"\xff\xda")
    files["cut_in_scan.jpg"] = whole[:scan + (len(whole) - scan) // 2]
    files["cut_in_headers.jpg"] = whole[:scan // 2]
    files["scene_a_1080x1920.jpg"] = cv2_jpeg(rendered_scene(rng),
                                              cv2.IMWRITE_JPEG_QUALITY, 85)
    files["scene_b_1080x1920.jpg"] = pil_jpeg(rendered_scene(rng),
                                              quality=85, progressive=True,
                                              optimize=True)
    return files


def cv2_entry(path: str):
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        return None
    return {"shape": list(img.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
            .hexdigest()}


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    manifest = {}
    for name, data in sorted(fixtures().items()):
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        manifest[name] = cv2_entry(path)
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"{len(manifest)} files, {total / 1e6:.2f} MB in {OUT}")


if __name__ == "__main__":
    main()

"""The port's native preprocessing library (smap_tpu_torch/data/native.py,
smap_tpu_torch/csrc/preprocess.cc) against the JAX package's: the same
source and flags on the same host, so the same bits; against OpenCV and
numpy within the JAX package's own tolerances (tests/test_native.py: the
port's letterbox_image is OpenCV's resize bit for bit); its
numpy fallback, and where it builds."""

import logging

import numpy as np
import pytest

from smap_tpu.data import native as jnative
from smap_tpu_torch.config import PIXEL_STDS_BGR
from smap_tpu_torch.data import native
from smap_tpu_torch.data.preprocess import letterbox_image, normalize_image

SHAPES = [(1080, 1920), (2048, 2048), (480, 640), (512, 832), (37, 91)]
# tests/test_native.py: 2 uint8 levels on 99% of pixels, 12 at most.
LSB = 2.0 / 255.0 / min(PIXEL_STDS_BGR)


@pytest.fixture
def both_built():
    if not (native.native_available() and jnative.native_available()):
        pytest.skip("a native preprocessing library did not build")


def _image(hw, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(*hw, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("hw", SHAPES)
def test_bit_equal_to_the_jax_library(both_built, hw):
    img = _image(hw)
    got, scale = native.letterbox_normalize_native(img)
    want, jscale = jnative.letterbox_normalize_native(img)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want) and scale == jscale
    assert np.array_equal(native.normalize_native(img),
                          jnative.normalize_native(img))
    got, _ = native.letterbox_normalize_native(img, (64, 96))
    want, _ = jnative.letterbox_normalize_native(img, (64, 96))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("hw", SHAPES[:4])
def test_matches_opencv_and_numpy(both_built, hw):
    img = _image(hw, seed=1)
    got, scale = native.letterbox_normalize_native(img)
    boxed, want_scale = letterbox_image(img)
    diff = np.abs(got - normalize_image(boxed))
    assert np.mean(diff < LSB) > 0.99 and diff.max() < 12 * LSB
    assert scale == want_scale
    np.testing.assert_allclose(native.normalize_native(img),
                               normalize_image(img), rtol=0, atol=1e-5)


def test_fallback_is_the_numpy_path(monkeypatch):
    monkeypatch.setattr(native, "load", lambda name="preprocess": None)
    img = _image((90, 70), seed=2)
    assert not native.native_available()
    assert np.array_equal(native.normalize_native(img), normalize_image(img))
    got, scale = native.letterbox_normalize_native(img, (64, 96))
    boxed, want_scale = letterbox_image(img, (64, 96))
    assert np.array_equal(got, normalize_image(boxed))
    assert scale == want_scale


def test_no_compiler_warns_once(monkeypatch, caplog):
    """A host where the build fails: one warning, then the numpy path."""
    def no_gxx(name="preprocess"):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_errors", {})
    monkeypatch.setattr(native, "build", no_gxx)
    img = _image((20, 30), seed=3)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        for _ in range(3):
            assert np.array_equal(native.normalize_native(img),
                                  normalize_image(img))
    assert not native.native_available()
    warned = [r for r in caplog.records if "numpy path" in r.getMessage()]
    assert len(warned) == 1


def test_builds_under_the_port_only(both_built):
    """Into smap_tpu_torch/_build/, named by the source, flags and host
    CPU; the JAX package's library is its own file."""
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("smap_tpu_torch", "_build")
    assert native.CXX_FLAGS == ("-O3", "-march=native", "-shared", "-fPIC")
    assert not jnative._SO.startswith(str(native.BUILD_DIR))


def test_another_cpu_gets_another_library(monkeypatch):
    """-march=native code is the host's own: a checkout shared with a host
    of another CPU names (and so builds) another library."""
    here = native.library_path()
    assert native.library_path() == here
    monkeypatch.setattr(native, "_host_cpu", lambda: "another cpu")
    other = native.library_path()
    assert other != here and other.parent == here.parent


def test_rejects_other_images(both_built):
    with pytest.raises(ValueError, match="uint8"):
        native.normalize_native(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        native.letterbox_normalize_native(np.zeros((4, 4), np.uint8))

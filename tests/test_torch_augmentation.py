"""The port's host augmentation (``smap_tpu_torch.data.augmentation``)
against the JAX package's (``smap_tpu.data.augmentation``, on OpenCV):
the same ``RandomState`` seeds give the same draws, the same joint tables
(float64, exact) and the same images, exact where the chain only resizes
and within ``warp_affine``'s stated remainder where it rotates."""

import dataclasses

import numpy as np
import pytest

from smap_tpu.config import TrainConfig as JTrainConfig
from smap_tpu.data import augmentation as jaug

from smap_tpu_torch.config import TrainConfig
from smap_tpu_torch.data import augmentation as aug
from test_torch_image import WARP_MAX_DIFF, WARP_MAX_SHARE

CROP = (64, 96)


def assert_image_close(got, want, exact):
    """Equal shapes; equal pixels, or within the warp's remainder."""
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if exact:
        assert diff.max(initial=0) == 0
    else:
        assert diff.max(initial=0) <= WARP_MAX_DIFF
        assert (diff > 0).mean() <= WARP_MAX_SHARE


def _sample(seed, h=None, w=None, people=3):
    """A frame and its joint rows: some joints off the frame, some
    invisible."""
    rng = np.random.RandomState(seed)
    h = h or rng.randint(40, 160)
    w = w or rng.randint(40, 220)
    base = rng.randint(0, 256, (h // 4 + 1, w // 4 + 1, 3))
    img = np.repeat(np.repeat(base, 4, 0), 4, 1)[:h, :w]
    img = np.clip(img + rng.randint(-5, 6, img.shape), 0, 255).astype(
        np.uint8)
    bodys = np.zeros((people, 15, 11))
    bodys[..., 0] = rng.uniform(-20, w + 20, (people, 15))
    bodys[..., 1] = rng.uniform(-20, h + 20, (people, 15))
    bodys[..., 2] = rng.uniform(200, 500, (people, 15))
    bodys[..., 3] = rng.choice([0, 1, 2], (people, 15))
    bodys[..., 4:7] = rng.randn(people, 15, 3) * 40
    bodys[..., 7:] = [900.0, 910.0, w / 2, h / 2]
    return img, bodys


def _cfgs(**kw):
    return TrainConfig(**kw), JTrainConfig(**kw)


@pytest.mark.parametrize("seed", range(4))
def test_rotate_augment(seed):
    img, bodys = _sample(seed)
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    got_img, got_b = aug.rotate_augment(img, bodys, r1, 10.0)
    want_img, want_b = jaug.rotate_augment(img, bodys, r2, 10.0)
    assert np.array_equal(got_b, want_b)
    assert_image_close(got_img, want_img, exact=False)
    assert r1.random_sample() == r2.random_sample()


@pytest.mark.parametrize("scale_aug,jitter", [(True, 40.0), (False, 0.0),
                                               (True, 0.0)])
def test_croppad_augment(scale_aug, jitter):
    cfg, jcfg = _cfgs()
    for seed in range(4):
        img, bodys = _sample(seed + 10)
        center = np.array([img.shape[1] // 2, img.shape[0] // 2])
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        got = aug.croppad_augment(img, bodys, center, r1, cfg, CROP,
                                  scale_aug, jitter)
        want = jaug.croppad_augment(img, bodys, center, r2, jcfg, CROP,
                                    scale_aug, jitter)
        assert_image_close(got[0], want[0], exact=True)
        assert np.array_equal(got[1], want[1])
        assert got[2] == want[2]
        assert r1.random_sample() == r2.random_sample()


def test_flip_and_mark_out_of_crop():
    img, bodys = _sample(20)
    flipped = 0
    for seed in range(8):
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        got = aug.flip_augment(img, bodys, r1, 0.5)
        want = jaug.flip_augment(img, bodys, r2, 0.5)
        assert_image_close(got[0], want[0], exact=True)
        assert np.array_equal(got[1], want[1])
        flipped += got[0] is not img
    assert 0 < flipped < 8
    assert np.array_equal(aug.mark_out_of_crop(bodys, CROP),
                          jaug.mark_out_of_crop(bodys, CROP))
    empty = np.zeros((0, 15, 11))
    assert aug.mark_out_of_crop(empty, CROP).shape == (0, 15, 11)


@pytest.mark.parametrize("with_aug,is_coco", [(True, True), (True, False),
                                              (False, True)])
def test_composed_augment_sample(with_aug, is_coco):
    cfg, jcfg = _cfgs(composed_warp=True)
    for seed in range(4):
        img, bodys = _sample(seed + 30)
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        got = aug.composed_augment_sample(img, bodys, r1, cfg, CROP,
                                          is_coco, with_aug)
        want = jaug.composed_augment_sample(img, bodys, r2, jcfg, CROP,
                                            is_coco, with_aug)
        assert_image_close(got[0], want[0], exact=False)
        assert np.array_equal(got[1], want[1])
        assert got[2] == want[2]
        assert r1.random_sample() == r2.random_sample()


@pytest.mark.parametrize("composed", [False, True])
@pytest.mark.parametrize("with_aug", [False, True])
@pytest.mark.parametrize("is_coco", [False, True])
def test_augment_sample_chains(composed, with_aug, is_coco):
    """Both chains, with and without augmentation, COCO and not; an image
    with no people too. Without augmentation the chain only resizes, and
    the image is exact."""
    cfg, jcfg = _cfgs(composed_warp=composed)
    for seed in range(3):
        img, bodys = _sample(seed + 40, people=seed)
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        got = aug.augment_sample(img, bodys, r1, cfg, CROP, is_coco,
                                 with_aug)
        want = jaug.augment_sample(img, bodys, r2, jcfg, CROP, is_coco,
                                   with_aug)
        assert_image_close(got[0], want[0], exact=not with_aug)
        assert got[1].dtype == want[1].dtype
        assert np.array_equal(got[1], want[1])
        assert got[2] == want[2]
        assert r1.random_sample() == r2.random_sample()


def test_train_config_fields_match():
    """The augmentation fields carry over field for field."""
    names = ("center_trans_max", "rotate_max_deg", "flip_prob", "scale_min",
             "scale_max", "composed_warp")
    cfg, jcfg = _cfgs()
    assert all(getattr(cfg, n) == getattr(jcfg, n) for n in names)
    assert {f.name for f in dataclasses.fields(cfg)} >= set(names)

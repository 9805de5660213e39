"""Host-side geometric augmentation: rotate, fit-crop/pad, flip
(counterpart of ``smap_tpu/data/augmentation.py``, on ``data.image`` in
place of OpenCV).

The same random draws in the same order from a ``numpy.random.RandomState``
and the same integer truncations as the JAX package, so the joint tables
are equal; the images are equal up to ``data.image.warp_affine``'s stated
remainder where a rotation is warped.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from smap_tpu_torch.config import FLIP_ORDER, TrainConfig
from smap_tpu_torch.data.image import (flip_horizontal, resize_linear,
                                       rotation_matrix_2d, warp_affine)


def _rotated_canvas(h: int, w: int, degree: float):
    """The rotation by ``degree`` about the image center, shifted onto
    the canvas that holds the whole rotated image: (M [2, 3], (nw, nh))."""
    cx, cy = w // 2, h // 2
    m = rotation_matrix_2d((cx, cy), -degree, 1.0)
    cos, sin = abs(m[0, 0]), abs(m[0, 1])
    nw = int(h * sin + w * cos)
    nh = int(h * cos + w * sin)
    m[0, 2] += nw / 2 - cx
    m[1, 2] += nh / 2 - cy
    return m, (nw, nh)


def _apply_affine(bodys: np.ndarray, m: np.ndarray) -> np.ndarray:
    """``bodys`` with the xy of every joint mapped through ``m`` [2, 3]."""
    bodys = bodys.copy()
    if len(bodys):
        pts = np.concatenate([bodys[..., :2],
                              np.ones((*bodys.shape[:2], 1))], axis=-1)
        bodys[..., :2] = np.einsum("ij,pkj->pki", m, pts)
    return bodys


def rotate_augment(img: np.ndarray, bodys: np.ndarray, rng,
                   max_degree: float) -> Tuple[np.ndarray, np.ndarray]:
    """Random rotation onto an expanded canvas, bicubic, gray (128)
    border."""
    degree = (rng.random_sample() - 0.5) * 2 * max_degree
    h, w = img.shape[:2]
    m, size = _rotated_canvas(h, w, degree)
    out = warp_affine(img, m, size, "cubic", border=128)
    return out, _apply_affine(bodys, m)


def croppad_augment(img: np.ndarray, bodys: np.ndarray, center: np.ndarray,
                    rng, cfg: TrainConfig, crop_hw: Tuple[int, int],
                    scale_aug: bool, jitter_max: float
                    ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Fit-scale (times a random factor when ``scale_aug``), center jitter
    up to ``jitter_max``, gray (128) pad and crop. Returns (img, bodys,
    scale)."""
    dice_x = rng.random_sample()
    dice_y = rng.random_sample()
    scale_random = rng.random_sample()
    crop_y, crop_x = crop_hw
    scale = min(crop_x / float(img.shape[1]), crop_y / float(img.shape[0]))
    if scale_aug:
        scale *= ((cfg.scale_max - cfg.scale_min) * scale_random
                  + cfg.scale_min)
    img = resize_linear(img, scale, scale)
    bodys = bodys.copy()
    if len(bodys):
        bodys[..., :2] *= scale

    x_offset = int((dice_x - 0.5) * 2 * jitter_max)
    y_offset = int((dice_y - 0.5) * 2 * jitter_max)
    ctr = (center * scale + np.array([x_offset, y_offset])).astype(int)

    pad_v = np.full((crop_y, img.shape[1], 3), 128, np.uint8)
    img = np.concatenate((pad_v, img, pad_v), axis=0)
    pad_h = np.full((img.shape[0], crop_x, 3), 128, np.uint8)
    img = np.concatenate((pad_h, img, pad_h), axis=1)
    img = img[int(ctr[1] + crop_y / 2):int(ctr[1] + crop_y / 2 + crop_y),
              int(ctr[0] + crop_x / 2):int(ctr[0] + crop_x / 2 + crop_x), :]

    offset = np.array([crop_x / 2 - ctr[0], crop_y / 2 - ctr[1]], np.int64)
    if len(bodys):
        bodys[..., :2] += offset
    return img, mark_out_of_crop(bodys, crop_hw), scale


def flip_augment(img: np.ndarray, bodys: np.ndarray, rng,
                 flip_prob: float) -> Tuple[np.ndarray, np.ndarray]:
    """Random horizontal mirror, with the left and right joints swapped."""
    if rng.random_sample() > flip_prob:
        return img, bodys
    img = flip_horizontal(img)
    bodys = bodys.copy()
    if len(bodys):
        bodys[..., 0] = img.shape[1] - 1 - bodys[..., 0]
        bodys = bodys[:, list(FLIP_ORDER), :]
    return img, bodys


def mark_out_of_crop(bodys: np.ndarray, crop_hw: Tuple[int, int]
                     ) -> np.ndarray:
    """``bodys`` with the visibility of every joint outside the crop 0."""
    crop_y, crop_x = crop_hw
    bodys = bodys.copy()
    if len(bodys):
        bad = ((bodys[..., 0] >= crop_x) | (bodys[..., 0] < 0) |
               (bodys[..., 1] >= crop_y) | (bodys[..., 1] < 0))
        bodys[..., 3] = np.where(bad, 0, bodys[..., 3])
    return bodys


def composed_augment_sample(img: np.ndarray, bodys: np.ndarray, rng,
                            cfg: TrainConfig, crop_hw: Tuple[int, int],
                            is_coco: bool, with_augmentation: bool
                            ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Rotate, scale, crop and flip as one affine map, warped once with
    ``INTER_LINEAR`` (``TrainConfig.composed_warp``): the sequential
    chain's draws, joint geometry and truncations, one resample in place
    of its cubic rotation and linear resize."""
    crop_y, crop_x = crop_hw
    h, w = img.shape[:2]
    center = np.array([w // 2, h // 2])

    # The sequential chain's draws, in its order.
    degree = ((rng.random_sample() - 0.5) * 2 * cfg.rotate_max_deg
              if with_augmentation else 0.0)
    dice_x = rng.random_sample()
    dice_y = rng.random_sample()
    scale_random = rng.random_sample()
    do_flip = with_augmentation and rng.random_sample() <= cfg.flip_prob

    m, (nw, nh) = _rotated_canvas(h, w, degree)
    a = np.vstack([m, [0.0, 0.0, 1.0]])
    scale = min(crop_x / float(nw), crop_y / float(nh))
    if with_augmentation and is_coco:
        scale *= ((cfg.scale_max - cfg.scale_min) * scale_random
                  + cfg.scale_min)
    jitter_max = cfg.center_trans_max if with_augmentation else 0.0
    x_offset = int((dice_x - 0.5) * 2 * jitter_max)
    y_offset = int((dice_y - 0.5) * 2 * jitter_max)
    ctr = (center * scale + np.array([x_offset, y_offset])).astype(int)
    offset = np.array([crop_x / 2 - ctr[0], crop_y / 2 - ctr[1]], np.int64)

    a = np.diag([scale, scale, 1.0]) @ a
    a[0, 2] += offset[0]
    a[1, 2] += offset[1]
    if do_flip:
        a = np.array([[-1.0, 0.0, crop_x - 1.0],
                      [0.0, 1.0, 0.0],
                      [0.0, 0.0, 1.0]]) @ a

    out = warp_affine(img, a[:2], (crop_x, crop_y), "linear", border=128)
    bodys = _apply_affine(bodys, a[:2])
    if do_flip and len(bodys):
        bodys = bodys[:, list(FLIP_ORDER), :]
    return out, mark_out_of_crop(bodys, crop_hw), scale


def augment_sample(img: np.ndarray, bodys: np.ndarray, rng,
                   cfg: TrainConfig, crop_hw: Tuple[int, int],
                   is_coco: bool, with_augmentation: bool
                   ) -> Tuple[np.ndarray, np.ndarray, float]:
    """The whole chain: rotate, fit-crop/pad (scale only for COCO), flip,
    invalidate the joints outside the crop. Returns (img, bodys, scale)."""
    # Composed only when augmenting: without augmentation the chain is one
    # resize already, and a zero-degree rotation would shift odd sizes by
    # half a pixel.
    if cfg.composed_warp and with_augmentation:
        return composed_augment_sample(img, bodys, rng, cfg, crop_hw,
                                       is_coco, with_augmentation)
    # The center is the image's before the rotation, as the reference
    # takes it.
    center = np.array([img.shape[1] // 2, img.shape[0] // 2])
    if with_augmentation:
        img, bodys = rotate_augment(img, bodys, rng, cfg.rotate_max_deg)
    img, bodys, scale = croppad_augment(
        img, bodys, center, rng, cfg, crop_hw,
        scale_aug=with_augmentation and is_coco,
        jitter_max=cfg.center_trans_max if with_augmentation else 0.0)
    if with_augmentation:
        img, bodys = flip_augment(img, bodys, rng, cfg.flip_prob)
    bodys = mark_out_of_crop(bodys, crop_hw)
    return img, bodys, scale

"""Training losses (counterpart of ``smap_tpu/losses.py``): masked
per-channel L2 with online hard keypoint mining, sparse root-depth L1, and
the full multi-stage, multi-scale SMAP objective.

Channel layouts are NHWC (``[B, H, W, C]``), as the model's outputs;
labels are ``[B, 5, H, W, 57]``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from smap_tpu_torch.config import NUM_JOINTS, NUM_LIMBS, TrainConfig
from smap_tpu_torch.parallel.distributed import all_reduce_mean, process_count


def joints_l2_loss(output: torch.Tensor, valid: torch.Tensor,
                   label: torch.Tensor, *, ohkm: bool = False,
                   topk: int = 8, paf_num: int = 0,
                   thres: float = 0.0) -> torch.Tensor:
    """Masked per-channel MSE; with ``ohkm`` the mean of the ``topk``
    largest channels of each sample (keypoints), plus that of the
    ``2 * topk`` largest PAF channels when ``paf_num`` > 0.

    Args:
      output / label: ``[B, H, W, C]``.
      valid: ``[B, C]`` per-channel validity weights.
    """
    per_chan = ((output - label) ** 2).mean(dim=(1, 2))      # [B, C]
    per_chan = per_chan * (valid > thres).to(per_chan.dtype)
    if not ohkm:
        return per_chan.mean()
    if paf_num == 0:
        return torch.topk(per_chan, topk, dim=1).values.mean()
    kpt_num = per_chan.shape[1] - paf_num * 2
    kpt_top = torch.topk(per_chan[:, :kpt_num], topk, dim=1).values
    paf_top = torch.topk(per_chan[:, kpt_num:], topk * 2, dim=1).values
    return kpt_top.mean() + paf_top.mean()


def depth_loss(output: torch.Tensor, rdepth: torch.Tensor,
               count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sparse L1 root-depth loss: the summed error over the valid roots
    divided by ``count``, by default their number in this batch.

    Args:
      output: ``[B, H, W, 1]`` root-depth map.
      rdepth: ``[B, P, 3]`` rows of (y / stride, x / stride, normalized Z);
        Z <= 0 marks padding. Coordinates are truncated and clipped to the
        map.
      count: the divisor (no gradient flows through it); under data
        parallelism the ranks' mean count (:func:`root_count`).

    With no valid root (``count`` 0) the loss is 0, and so is its
    gradient.
    """
    b, h, w, _ = output.shape
    ys = rdepth[..., 0].to(torch.int64).clamp(0, h - 1)
    xs = rdepth[..., 1].to(torch.int64).clamp(0, w - 1)
    z = rdepth[..., 2]
    valid = z > 0
    batch_idx = torch.arange(b, device=output.device)[:, None]
    pred = output[batch_idx, ys, xs, 0]                      # [B, P]
    err = torch.abs(pred - z) * valid
    if count is None:
        count = valid.sum()
    divisor = torch.where(count > 0, count, 1)
    return torch.where(count > 0, err.sum() / divisor, 0.0)


def root_count(rdepth: torch.Tensor) -> torch.Tensor:
    """The divisor of :func:`depth_loss` for this rank's batch: the number
    of valid roots (Z > 0), or in a group of several ranks their global
    number divided by the world size. Each rank's loss is then its share of
    the global batch's, scaled so that the ranks' mean is the global loss
    and their mean gradient the global gradient, as the JAX package takes
    the count over the global batch. Raises, on every rank alike, when the
    ranks' batches differ in size: the means over samples of the other
    losses decompose over ranks only for equal batches."""
    count = (rdepth[..., 2] > 0).sum()
    if process_count() == 1:
        return count
    b = rdepth.shape[0]
    local = torch.stack([count.double(),
                         *count.new_tensor([b, b * b], dtype=torch.float64)])
    mean_count, mean_b, mean_b2 = all_reduce_mean(local).unbind()
    if float(mean_b2) != float(mean_b) ** 2:
        raise ValueError("the ranks' local batches differ in size; data "
                         "parallelism needs equal batches")
    return mean_count.to(rdepth.dtype)


def _label_index(device: torch.device):
    """(2D channels, delta-Z channels) of a 57-channel label map: the 15
    heatmaps and each limb's x / y, then each limb's Z."""
    paf = [NUM_JOINTS + i for i in range(3 * NUM_LIMBS) if i % 3 != 2]
    z = [NUM_JOINTS + i for i in range(3 * NUM_LIMBS) if i % 3 == 2]
    return (torch.tensor(list(range(NUM_JOINTS)) + paf, device=device),
            torch.tensor(z, device=device))


def smap_loss(outputs: Dict[str, List[List[torch.Tensor]]],
              valids: torch.Tensor, labels: torch.Tensor,
              rdepth: torch.Tensor, cfg: TrainConfig = TrainConfig()
              ) -> Dict[str, torch.Tensor]:
    """The training objective: over stages and scales,
    ``0.1 * 2D + 5 * delta-Z + 10 * root depth``, the three coarse scales
    divided by 4, OHKM on the finest scale, and on the last stage each
    scale held to the next finer label level (``cfg.coarse_to_fine``).

    Args:
      outputs: ``SMAP.forward``'s dict of per-stage lists of 4 NHWC maps.
      valids: ``[B, 57]`` channel validity (43 2D + 14 delta-Z).
      labels: ``[B, 5, H, W, 57]`` label pyramids (coarse blur -> fine).
      rdepth: ``[B, P, 3]`` sparse root-depth targets.

    Returns ``total_loss`` and the finest scale's ``loss_2d``,
    ``loss_bone`` and ``loss_root`` summed over stages. In a group of
    several ranks these are this rank's share (:func:`root_count`): their
    mean over the ranks is the global batch's loss.
    """
    kpt_paf = NUM_JOINTS + 2 * NUM_LIMBS                     # 43
    count = root_count(rdepth)
    idx_2d, idx_z = _label_index(labels.device)
    stage_num = len(outputs["heatmap_2d"])
    zero = torch.zeros((), device=labels.device)
    total, loss_2d, loss_bone, loss_root = zero, zero, zero, zero
    for i in range(stage_num):
        for j in range(4):
            ind = j + (1 if i == stage_num - 1 and cfg.coarse_to_fine
                       else 0)
            lbl = labels[:, ind]                             # [B, H, W, 57]
            use_ohkm = j == 3 and cfg.ohkm
            l2d = joints_l2_loss(outputs["heatmap_2d"][i][j],
                                 valids[:, :kpt_paf], lbl[..., idx_2d],
                                 ohkm=use_ohkm, topk=cfg.topk,
                                 paf_num=NUM_LIMBS if use_ohkm else 0)
            l3d = joints_l2_loss(outputs["det_d"][i][j],
                                 valids[:, kpt_paf:], lbl[..., idx_z],
                                 ohkm=use_ohkm, topk=cfg.topk, paf_num=0)
            ld = depth_loss(outputs["root_d"][i][j], rdepth, count)
            if j == 3:
                loss_2d = loss_2d + l2d
                loss_bone = loss_bone + l3d
                loss_root = loss_root + ld
            stage_loss = 0.1 * l2d + 5.0 * l3d + 10.0 * ld
            if j < 3:
                stage_loss = stage_loss / 4.0
            total = total + stage_loss
    return {"total_loss": total, "loss_2d": loss_2d,
            "loss_bone": loss_bone, "loss_root": loss_root}

"""RefineNet lifting: per-person inputs and folding the predictions back
(counterpart of ``smap_tpu/ops/refine.py``). Any leading axes."""

from __future__ import annotations

import torch

from smap_tpu_torch.config import ROOT_IDX


def build_refine_input(bodies_2d: torch.Tensor, bodies_3d: torch.Tensor,
                       *, root_idx: int = ROOT_IDX) -> torch.Tensor:
    """[..., P, J, 4] x2 -> [..., P, J*5]: root-relative 2D xy and 3D XYZ
    per joint, the root row holding its absolute values."""
    J = bodies_2d.shape[-2]
    root2d = bodies_2d[..., root_idx, :2]
    root3d = bodies_3d[..., root_idx, :3]
    joint_ok = bodies_3d[..., 3] > 0
    feat = torch.cat([bodies_2d[..., :2] - root2d[..., None, :],
                      bodies_3d[..., :3] - root3d[..., None, :]], dim=-1)
    feat = torch.where(joint_ok[..., None], feat,
                       torch.zeros((), device=feat.device))
    feat[..., root_idx, :] = torch.cat([root2d, root3d], dim=-1)
    return feat.reshape(*feat.shape[:-2], J * 5)


def apply_refinement(pred_rel: torch.Tensor, bodies_3d: torch.Tensor,
                     *, root_idx: int = ROOT_IDX) -> torch.Tensor:
    """Root-relative MLP output [..., P, J*3] -> absolute [..., P, J, 4];
    the score column is 1 for persons with a detected root, else 0."""
    J = bodies_3d.shape[-2]
    pred = pred_rel.reshape(*pred_rel.shape[:-1], J, 3)
    root3d = bodies_3d[..., root_idx, :3]
    out = pred + root3d[..., None, :]
    out[..., root_idx, :] = root3d
    person_ok = (bodies_3d[..., root_idx, 3] > 0).to(out.dtype)
    score = person_ok[..., None].expand(*person_ok.shape, J)
    return torch.cat([out, score[..., None]], dim=-1)

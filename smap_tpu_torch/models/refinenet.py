"""RefineNet: the per-person pose-refinement MLP (counterpart of
``smap_tpu/models/refinenet.py``).

75 -> (160, 256, 256, 128) -> 45 with BatchNorm1d + ReLU between the
linear layers. Keys follow the reference layout: ``block.layerN.0`` Linear,
``block.layerN.1`` BatchNorm1d, ``block.layer5`` Linear. In train mode the
BatchNorms update their statistics as Flax's do
(``models.layers.BatchNorm1d``).
"""

from __future__ import annotations

import torch
from torch import nn

from smap_tpu_torch.config import RefineNetConfig
from smap_tpu_torch.models.layers import BatchNorm1d


class RefineNet(nn.Module):
    def __init__(self, cfg: RefineNetConfig = RefineNetConfig()):
        super().__init__()
        self.block = nn.Module()
        dims = (cfg.in_dim,) + tuple(cfg.hidden)
        for i in range(len(cfg.hidden)):
            setattr(self.block, f"layer{i + 1}", nn.Sequential(
                nn.Linear(dims[i], dims[i + 1]),
                BatchNorm1d(dims[i + 1], eps=1e-5, momentum=0.1),
                nn.ReLU()))
        setattr(self.block, f"layer{len(cfg.hidden) + 1}",
                nn.Linear(dims[-1], cfg.out_dim))
        self.num_layers = len(cfg.hidden) + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self.block, f"layer{i + 1}")(x)
        return x

"""BatchNorm folded into the convolutions for serving (the ``"folded"`` half
of ``smap_tpu/models/quantize.py``; its int8 modes are not ported yet).

Every conv block ``{prefix}.conv`` followed by an eval-mode
``{prefix}.bn`` becomes one conv with
``kernel * inv`` and ``bn.bias + (conv.bias - mean) * inv``, where
``inv = bn.weight / sqrt(running_var + eps)``, in float32 and in the JAX
package's order of operations. The result loads into a model built with
``ModelConfig(quantized="folded")``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

BN_EPS = 1e-5   # the eps of every BatchNorm in the model


def fold_bn_state_dict(state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """A SMAP state_dict -> its BN-folded serving state_dict (float32);
    every ``*.bn.*`` key is consumed."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if ".bn." not in f".{key}":
            out[key] = value
    for key in list(out):
        if not key.endswith("conv.weight"):
            continue
        prefix = key[:-len("conv.weight")]
        if f"{prefix}bn.weight" not in state_dict:
            continue
        kernel = state_dict[key].float()
        bias = state_dict[f"{prefix}conv.bias"].float()
        inv = (state_dict[f"{prefix}bn.weight"].float()
               / torch.sqrt(state_dict[f"{prefix}bn.running_var"].float()
                            + BN_EPS))
        out[key] = kernel * inv[:, None, None, None]   # over out channels
        out[f"{prefix}conv.bias"] = (
            state_dict[f"{prefix}bn.bias"].float()
            + (bias - state_dict[f"{prefix}bn.running_mean"].float()) * inv)
    return out

"""Serving weight transforms (counterpart of ``smap_tpu/models/quantize.py``):
BatchNorm folded into the convolutions, and int8 quantization.

Every conv block ``{prefix}.conv`` followed by an eval-mode
``{prefix}.bn`` becomes one conv with
``kernel * inv`` and ``bn.bias + (conv.bias - mean) * inv``, where
``inv = bn.weight / sqrt(running_var + eps)``, in float32 and in the JAX
package's order of operations. The result loads into a model built with
``ModelConfig(quantized="folded")``.

:func:`quantize_state_dict` then makes each folded kernel int8 per output
channel (``ModelConfig(quantized=True)``: activations quantized per tensor
with a scale taken from each input), and
:func:`calibrate_activation_scales` freezes per-conv activation scales
(``ModelConfig(quantized="static")``). The roundings are those of the JAX
functions run as written, op by op: under ``jax.jit`` XLA rewrites
``a / sqrt(b)`` as ``a * rsqrt(b)`` with an approximate rsqrt, a division
by 127 as a multiply, and a multiply-add as an FMA, which moves last bits
(``tests/test_torch_quantize.py`` measures how far).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Union

import numpy as np
import torch

BN_EPS = 1e-5   # the eps of every BatchNorm in the model
# A weight scale is taken from an abs-max of at least this.
MIN_KERNEL_ABSMAX = 1e-8


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
        # The square root in float64, rounded once to float32: correctly
        # rounded, as XLA's is (PyTorch's float32 sqrt on the CPU is not
        # always).
        root = torch.sqrt((state_dict[f"{prefix}bn.running_var"].float()
                           + BN_EPS).double()).float()
        inv = state_dict[f"{prefix}bn.weight"].float() / root
        out[key] = kernel * inv[:, None, None, None]   # over out channels
        out[f"{prefix}conv.bias"] = (
            state_dict[f"{prefix}bn.bias"].float()
            + (bias - state_dict[f"{prefix}bn.running_mean"].float()) * inv)
    return out


def quantize_state_dict(state_dict: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A SMAP state_dict (BatchNorm folded or not) -> the int8 serving
    state_dict of ``ModelConfig(quantized=True)`` (the counterpart of
    ``quantize_variables``): every conv becomes ``conv.kernel_q`` (int8
    OIHW), ``conv.kernel_scale`` (float32 per output channel, ``max(
    max |kernel|, 1e-8) / 127``) and ``conv.bias`` (float32), BatchNorm
    folded in first."""
    out = fold_bn_state_dict(state_dict)
    for key in [k for k in out if k.endswith("conv.weight")]:
        kernel = out.pop(key).float()
        prefix = key[:-len("weight")]
        absmax = kernel.abs().amax(dim=(1, 2, 3))
        scale = torch.clamp(absmax, min=MIN_KERNEL_ABSMAX) / 127.0
        out[f"{prefix}kernel_q"] = torch.clamp(
            torch.round(kernel / scale[:, None, None, None]), -127,
            127).to(torch.int8)
        out[f"{prefix}kernel_scale"] = scale
        out[f"{prefix}bias"] = out[f"{prefix}bias"].float()
    return out


def check_static_scales(state_dict: Mapping[str, torch.Tensor]) -> None:
    """Reject an uncalibrated static-int8 state_dict loudly: one with no
    ``act_scale`` at all, or with one that is not finite and positive."""
    found, bad = 0, []
    for key, value in state_dict.items():
        if key.endswith("act_scale"):
            found += 1
            a = value.detach().float().cpu().numpy()
            if not np.all(np.isfinite(a)) or np.any(a <= 0):
                bad.append(key[:-len(".act_scale")])
    if not found:
        raise ValueError(
            "static-int8 weights carry no act_scale parameters; run "
            "quantize.calibrate_activation_scales on them first")
    if bad:
        raise ValueError(
            f"static-int8 act_scale is non-positive/non-finite (i.e. "
            f"uncalibrated) for conv blocks: {bad[:5]}"
            f"{' ...' if len(bad) > 5 else ''}; run "
            f"quantize.calibrate_activation_scales on these weights")


def calibrate_activation_scales(
        state_dict: Mapping[str, torch.Tensor], model_cfg,
        batches: Union[torch.Tensor, Iterable[torch.Tensor]],
        device=None) -> Dict[str, torch.Tensor]:
    """Freeze per-conv activation scales from calibration batches.

    Runs the dynamic int8 deployment readout (``SMAP.infer``) of
    ``model_cfg`` (its ``quantized`` field is set to True here) over the
    prepared float32 NHWC batches, on ``device`` (the first batch's when
    None), records each conv's input abs-max, takes the elementwise max
    across batches, and writes ``act_scale = max(absmax, 1e-6) *
    float32(1 / 127)``, computed with numpy float32 as the dynamic scale is
    on the device: with one calibration batch the static forward equals
    the dynamic one on it, bit for bit. Convs the readout never runs (the
    heads it skips) get no ``act_scale``.

    Args:
      state_dict: :func:`quantize_state_dict`'s output.
      batches: one [B, H, W, 3] float32 tensor (normalized, as
        ``data.preprocess.prepare_images`` leaves it) or an iterable.

    Returns:
      The state_dict of ``ModelConfig(quantized="static")``.
    """
    from smap_tpu_torch.models.layers import Int8Conv, to_compute_dtype
    from smap_tpu_torch.models.smap import SMAP
    from smap_tpu_torch.runtime import compute_dtype

    if isinstance(batches, torch.Tensor):
        batches = [batches]
    batches = list(batches)
    if not batches:
        raise ValueError("calibration needs at least one batch")
    model = SMAP(dataclasses.replace(model_cfg, quantized=True)).eval()
    model.load_state_dict({k: v for k, v in state_dict.items()
                           if not k.endswith("act_scale")}, strict=True)
    dev = batches[0].device if device is None else torch.device(device)
    to_compute_dtype(model, dev, compute_dtype(model_cfg.compute_dtype))
    convs = {name: m for name, m in model.named_modules()
             if isinstance(m, Int8Conv)}
    agg: Dict[str, np.ndarray] = {}
    with torch.no_grad():
        for x in batches:
            records: Dict[str, List[torch.Tensor]] = {}
            for name, m in convs.items():
                m.record = records.setdefault(name, [])
            try:
                model.infer(x.to(dev, torch.float32))
            finally:
                for m in convs.values():
                    m.record = None
            for name, seen in records.items():
                if seen:
                    a = np.float32(torch.stack(seen).max().item())
                    agg[name] = np.maximum(agg.get(name, a), a)
    out = dict(state_dict)
    for name, absmax in agg.items():
        out[f"{name}.act_scale"] = torch.tensor(
            np.maximum(absmax, np.float32(1e-6)) * np.float32(1.0 / 127.0),
            dtype=torch.float32)
    return out

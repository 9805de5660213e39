"""Weights carried across from the JAX package.

Turns a JAX ``{'params', 'batch_stats'}`` tree (nested dicts of numpy
arrays) into the port's state_dict, for SMAP and for RefineNet: the inverse
of ``convert_smap_state_dict`` / ``convert_refinenet_state_dict`` in
``smap_tpu/models/torch_convert.py``.

* conv kernels HWIO -> OIHW; dense kernels ``[in, out]`` -> ``[out, in]``;
* BatchNorm ``scale`` -> ``weight``; stats ``mean`` / ``var`` ->
  ``running_mean`` / ``running_var``, with ``num_batches_tracked`` 0;
* Flax block names ``layerN_i`` -> torch Sequential keys ``layerN.i``.

A BN-folded tree (``fold_bn_variables``' output: ``"params"`` only, every
block ``{conv: {kernel, bias}}``) gives the folded model's state_dict.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_MERGED_LAYER = re.compile(r"^(layer[1-4])_(\d+)$")


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _key(scope: Tuple[str, ...]) -> str:
    parts = []
    for p in scope:
        m = _MERGED_LAYER.match(p)
        parts.append(f"{m.group(1)}.{m.group(2)}" if m else p)
    return ".".join(parts)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.tensor(arr, dtype=torch.float32)   # a contiguous copy


def _zero_count() -> torch.Tensor:
    return torch.tensor(0, dtype=torch.int64)


def smap_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX SMAP variables -> the port's (and the reference's) state_dict;
    a BN-folded tree -> the state_dict of ``ModelConfig(quantized="folded")``."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(variables["params"]):
        *scope, module, leaf = path
        key = _key(tuple(scope) + (module,))
        if module == "conv":
            out[f"{key}.weight" if leaf == "kernel" else f"{key}.bias"] = (
                _tensor(arr.transpose(3, 2, 0, 1) if leaf == "kernel"
                        else arr))
        elif module == "bn":
            out[f"{key}.{'weight' if leaf == 'scale' else 'bias'}"] = (
                _tensor(arr))
        else:
            raise KeyError(f"unexpected param module in {path}")
    for path, arr in _flatten(variables.get("batch_stats", {})):
        *scope, module, leaf = path
        key = _key(tuple(scope) + (module,))
        out[f"{key}.running_{'mean' if leaf == 'mean' else 'var'}"] = (
            _tensor(arr))
        out[f"{key}.num_batches_tracked"] = _zero_count()
    return out


def refinenet_state_dict(variables: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """JAX RefineNet variables -> the port's state_dict (Flax ``layerN`` /
    ``bnN`` -> ``block.layerN.0`` / ``block.layerN.1``; the last dense
    layer -> ``block.layerN``)."""
    params = variables["params"]
    last = max(int(n[len("layer"):]) for n in params if n.startswith("layer"))
    out: Dict[str, torch.Tensor] = {}
    for (name, leaf), arr in _flatten(params):
        if name.startswith("layer"):
            key = f"block.{name}" if name == f"layer{last}" else (
                f"block.{name}.0")
            out[f"{key}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
                _tensor(arr.T if leaf == "kernel" else arr))
        else:
            n = name[len("bn"):]
            out[f"block.layer{n}.1.{'weight' if leaf == 'scale' else 'bias'}"
                ] = _tensor(arr)
    for (name, leaf), arr in _flatten(variables["batch_stats"]):
        n = name[len("bn"):]
        out[f"block.layer{n}.1.running_{'mean' if leaf == 'mean' else 'var'}"
            ] = _tensor(arr)
        out[f"block.layer{n}.1.num_batches_tracked"] = _zero_count()
    return out

"""Suffix-matched partial checkpoint loading (counterpart of
``smap_tpu/utils/align.py``).

Equivalent of the reference's maskrcnn-benchmark-style loader
(``cvpack/torch_modeling/engine/checkpoint.py:50-89`` and
``lib/utils/model_serialization.py:8-78`` in zju3dv/SMAP): when a
checkpoint's keys are prefixed or renamed (e.g. backbone-only weights,
``module.`` of ``DistributedDataParallel``), each entry of the model's
state_dict takes the loaded entry whose ``.``-separated name is the
longest suffix match, shapes permitting; unmatched entries keep their
current values and are reported.

    sd, missing = align_and_update(model.state_dict(),
                                   load_torch_checkpoint("backbone.pth"))
    model.load_state_dict(sd)
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch


def _matches(name: str, loaded_name: str) -> bool:
    return (name == loaded_name or name.endswith("." + loaded_name)
            or loaded_name.endswith("." + name))


def align_and_update(target: Mapping[str, torch.Tensor],
                     loaded: Mapping[str, Any],
                     logger: Optional[logging.Logger] = None
                     ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Fills ``target`` (a state_dict) from ``loaded`` (a state_dict of
    tensors or arrays) by the longest suffix match of equal shape.

    Returns (a new state_dict, the target's keys that nothing matched, in
    the target's order). ``target`` is not changed.
    """
    out: Dict[str, torch.Tensor] = {}
    missing: List[str] = []
    for name, value in target.items():
        best = None
        for lname, lval in loaded.items():
            if (_matches(name, lname)
                    and tuple(lval.shape) == tuple(value.shape)
                    and (best is None or len(lname) > len(best))):
                best = lname
        if best is None:
            out[name] = value
            missing.append(name)
        else:
            out[name] = torch.as_tensor(loaded[best])
    if missing and logger is not None:
        logger.warning("unmatched parameters kept at init: %s",
                       ", ".join(missing[:20]))
    return out, missing

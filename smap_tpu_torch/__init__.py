"""smap_tpu_torch: the PyTorch / CUDA port of smap_tpu.

The serving path of the JAX package (``smap_tpu/``), written in PyTorch:
preprocessing, the SMAP forward, peak NMS, PAF scoring, depth-aware greedy
association, depth chaining, back-projection and RefineNet. PAF scoring and
the per-limb greedy run as hand-written CUDA kernels on a GPU
(``smap_tpu_torch/ops/kernels.py``, ``smap_tpu_torch/csrc/``) and as their
plain PyTorch versions on the CPU. The package imports no JAX.
"""

from smap_tpu_torch.config import Config

__all__ = ["Config"]

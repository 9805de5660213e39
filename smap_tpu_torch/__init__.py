"""smap_tpu_torch: the PyTorch / CUDA port of smap_tpu.

The serving path of the JAX package (``smap_tpu/``), written in PyTorch:
preprocessing, the SMAP forward (also BN-folded, with a fused stem and
fused bottlenecks), peak NMS, PAF scoring, depth-aware greedy association,
depth chaining, back-projection and RefineNet. PAF scoring, the per-limb
greedy, the fused stem and the fused bottleneck run as hand-written CUDA
kernels on a GPU (``smap_tpu_torch/ops/kernels.py``,
``smap_tpu_torch/csrc/``) and as their plain PyTorch versions on the CPU.
The package imports no JAX.
"""

from smap_tpu_torch.config import Config

__all__ = ["Config"]

"""The port imports no JAX: every module of the serving, training,
data-parallel and evaluation slices, the tools and every entry point loads
in a fresh interpreter without jax, flax, the JAX package, OpenCV, triton
or matplotlib (the viewer imports it when it draws)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = (
    "smap_tpu_torch",
    "smap_tpu_torch.config",
    "smap_tpu_torch.runtime",
    "smap_tpu_torch.camera",
    "smap_tpu_torch.data.image",
    "smap_tpu_torch.data.preprocess",
    "smap_tpu_torch.data.augmentation",
    "smap_tpu_torch.models.layers",
    "smap_tpu_torch.models.smap",
    "smap_tpu_torch.models.refinenet",
    "smap_tpu_torch.models.convert",
    "smap_tpu_torch.models.quantize",
    "smap_tpu_torch.ops.nms",
    "smap_tpu_torch.ops.paf",
    "smap_tpu_torch.ops.association",
    "smap_tpu_torch.ops.depth",
    "smap_tpu_torch.ops.refine",
    "smap_tpu_torch.ops.postprocess",
    "smap_tpu_torch.ops.kernels",
    "smap_tpu_torch.ops.int8_conv",
    "smap_tpu_torch.ops.fused_stem",
    "smap_tpu_torch.ops.fused_block",
    "smap_tpu_torch.inference",
    "smap_tpu_torch.golden",
    "smap_tpu_torch.data.labels",
    "smap_tpu_torch.data.datasets",
    "smap_tpu_torch.losses",
    "smap_tpu_torch.utils.metrics",
    "smap_tpu_torch.train.solver",
    "smap_tpu_torch.train.step",
    "smap_tpu_torch.train.engine",
    "smap_tpu_torch.train.refine",
    "smap_tpu_torch.evaluation",
    "smap_tpu_torch.evaluation.register",
    "smap_tpu_torch.evaluation.mupots",
    "smap_tpu_torch.evaluation.mupots_data",
    "smap_tpu_torch.evaluation.convert",
    "smap_tpu_torch.evaluation.panoptic",
    "smap_tpu_torch.parallel",
    "smap_tpu_torch.parallel.distributed",
    "smap_tpu_torch.parallel.mesh",
    "smap_tpu_torch.serve",
    "smap_tpu_torch.test_smap",
    "smap_tpu_torch.train_smap",
    "smap_tpu_torch.train_refinenet",
    "smap_tpu_torch.test_refinenet",
    "smap_tpu_torch.eval_mupots",
    "smap_tpu_torch.eval_panoptic",
    "smap_tpu_torch.data.native",
    "smap_tpu_torch.data.coco_convert",
    "smap_tpu_torch.utils.profiling",
    "smap_tpu_torch.utils.timer",
    "smap_tpu_torch.utils.align",
    "smap_tpu_torch.utils.visualize",
    "smap_tpu_torch.convert_checkpoint",
    "smap_tpu_torch.visualize",
)


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'smap_tpu', 'cv2', 'triton',\n"
        "              'matplotlib'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _run_without_a_card(script):
    """Runs ``script`` as __main__ with no card visible; checks it imported
    nothing of JAX nor OpenCV and returns the finished process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    code = ("import runpy, sys\n"
            "try:\n"
            f"    runpy.run_path({script!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "                 ('jax', 'jaxlib', 'flax', 'smap_tpu', 'cv2'))\n"
            "    assert not bad, bad\n"
            "    raise\n")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_imports_no_jax_and_needs_a_card():
    """chip_smoke.py imports nothing of JAX and, with no card, exits
    non-zero before printing any result."""
    out = _run_without_a_card("chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "cuda" in out.stderr.lower()


def test_profile_forward_imports_no_jax_and_needs_a_card():
    """profile_forward.py, like chip_smoke.py, needs the card and imports
    nothing of JAX."""
    out = _run_without_a_card("profile_forward.py")
    assert out.returncode != 0
    assert out.stdout == ""
    assert "cuda" in out.stderr.lower()

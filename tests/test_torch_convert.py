"""Weights carried across: the port's converter against the JAX package's
exporter, and the port's config against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import TINY_MODEL, jax_refinenet, jax_smap

torch.set_num_threads(1)


def _assert_same_state_dict(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.shape == np.shape(v), k
        # A transpose and a copy: exact.
        np.testing.assert_array_equal(g, np.asarray(v), err_msg=k)


def test_smap_state_dict_matches_export_and_loads_strict():
    from smap_tpu.models.torch_convert import export_smap_state_dict

    from smap_tpu_torch.config import ModelConfig
    from smap_tpu_torch.models.convert import smap_state_dict
    from smap_tpu_torch.models.smap import SMAP

    _, variables = jax_smap()
    sd = smap_state_dict(variables)
    _assert_same_state_dict(sd, export_smap_state_dict(variables))
    model = SMAP(ModelConfig(**TINY_MODEL))
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)


@pytest.mark.parametrize("random_stats", [False, True])
def test_refinenet_state_dict_matches_export_and_loads_strict(random_stats):
    import jax
    import jax.numpy as jnp

    from smap_tpu.config import RefineNetConfig as JRefineNetConfig
    from smap_tpu.models.refinenet import RefineNet as JRefineNet
    from smap_tpu.models.torch_convert import export_refinenet_state_dict

    from smap_tpu_torch.models.convert import refinenet_state_dict
    from smap_tpu_torch.models.refinenet import RefineNet

    if random_stats:
        _, variables = jax_refinenet()
    else:   # the Flax init itself, as tests/make_golden.py makes it
        variables = JRefineNet(JRefineNetConfig()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 75), jnp.float32))
    variables = jax.tree.map(np.asarray, variables)
    sd = refinenet_state_dict(variables)
    _assert_same_state_dict(sd, export_refinenet_state_dict(variables))
    RefineNet().load_state_dict(sd, strict=True)


def test_config_mirrors_jax_config():
    """The port's config module repeats the JAX package's serving values;
    this pins them equal."""
    import smap_tpu.config as jc

    import smap_tpu_torch.config as tc

    for name in ("NUM_JOINTS", "FLIP_ORDER", "PAF_VECTOR",
                 "NUM_LIMBS", "PAF_FLIP_CHANNEL", "ROOT_IDX", "BONE_LENGTHS",
                 "INPUT_SHAPE", "STRIDE", "OUTPUT_SHAPE", "PIXEL_MEANS_BGR",
                 "PIXEL_STDS_BGR"):
        assert getattr(tc, name) == getattr(jc, name), name
    for cls in ("SkeletonConfig", "ModelConfig", "PostProcessConfig",
                "TrainConfig", "RefineNetConfig"):
        port = dataclasses.asdict(getattr(tc, cls)())
        ref = dataclasses.asdict(getattr(jc, cls)())
        assert port == {k: ref[k] for k in port}, cls
    # Training: every TrainConfig field but the relay's flatten_opt, and
    # the model's remat.
    assert (set(dataclasses.asdict(jc.TrainConfig()))
            - set(dataclasses.asdict(tc.TrainConfig()))) == {"flatten_opt"}
    assert "remat" in dataclasses.asdict(tc.ModelConfig())
    port = tc.Config()
    ref = jc.Config()
    for f in ("input_shape", "output_shape", "stride"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.train == tc.TrainConfig()
    assert dataclasses.asdict(port.skeleton) == dataclasses.asdict(
        ref.skeleton)
    assert port.skeleton.num_2d_channels == ref.skeleton.num_2d_channels == 43
    assert tc.default_config() == port

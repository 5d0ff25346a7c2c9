"""The parameter bridge (flax params + batch_stats -> the port's state dict):
complete and strict in both directions on the full DLA-34 MonoFlex tree, and
each layout converter inverts the JAX package's importer converter."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from monoflex_tpu.models.backbone.dla import DLASeg as JaxDLASeg
from monoflex_tpu.models.detector import MonoFlex as JaxMonoFlex
from monoflex_tpu.models.heads.predictor import build_predictor as jax_build_predictor
from monoflex_tpu.utils.weight_import import _t_conv, _t_conv1d, _t_depthwise, unflatten_params
from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.utils.param_bridge import (conv1d_to_torch, flax_to_state_dict,
                                                   hwio_to_oihw, load_flax_variables)

RUN_YAML = os.path.join(os.path.dirname(__file__), "..", "runs", "monoflex.yaml")


@pytest.fixture(scope="module")
def cfg():
    c = get_cfg_defaults()
    c.merge_from_file(RUN_YAML)
    return c


@pytest.fixture(scope="module")
def flax_tree(cfg):
    """Seeded numpy values in the exact shapes of the JAX model's variables
    (traced, not run: the tree does not depend on the DCN impl or the input
    size)."""
    model = JaxMonoFlex(backbone=JaxDLASeg(dcn_impl="gather"), predictor=jax_build_predictor(cfg))
    args = (jnp.zeros((1, 32, 64, 3), jnp.uint8), jnp.zeros((1, 48, 2), jnp.int32),
            jnp.zeros((1,), jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args, train=False))
    rng = np.random.RandomState(0)
    fill = {k: {p: rng.randn(*s.shape).astype(np.float32)
                for p, s in flatten_dict(v, sep="/").items()}
            for k, v in shapes.items()}
    return fill["params"], fill["batch_stats"]


def test_bridge_loads_every_weight(cfg, flax_tree):
    params, stats = flax_tree
    model = build_model(cfg, device="cpu")
    load_flax_variables(model, unflatten_params(params), unflatten_params(stats), cfg)
    state = model.state_dict()
    # spot-check each layout: OIHW conv, depthwise transposed conv, conv1d, BN stat
    np.testing.assert_array_equal(
        state["backbone.base.base_layer.0.weight"].numpy(),
        params["backbone/base/Conv_0/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state["backbone.ida_up.up_2.weight"].numpy(),
        params["backbone/ida_up/up_2/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state["heads.predictor.trunc_heatmap_conv.0.weight"].numpy(),
        params["predictor/trunc_heatmap_conv/Conv_0/kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(
        state["heads.predictor.class_head.2.bias"].numpy(), params["predictor/class_out/bias"])
    np.testing.assert_array_equal(
        state["backbone.dla_up.ida_0.proj_1.actf.0.running_var"].numpy(),
        stats["backbone/dla_up/ida_0/proj_1/BatchNorm_0/var"])
    n_flax = len(params) + len(stats)
    n_port = sum(1 for k in state if not k.endswith("num_batches_tracked"))
    assert n_flax == n_port


def test_bridge_rejects_a_missing_flax_leaf(cfg, flax_tree):
    params, stats = flax_tree
    params = dict(params)
    del params["predictor/reg_out_depth/bias"]
    with pytest.raises(KeyError, match="reg_heads"):
        flax_to_state_dict(unflatten_params(params), unflatten_params(stats), cfg)


def test_bridge_rejects_an_unmapped_flax_leaf(cfg, flax_tree):
    params, stats = flax_tree
    stats = dict(stats)
    stats["backbone/base/Extra_0/mean"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="Extra_0"):
        flax_to_state_dict(unflatten_params(params), unflatten_params(stats), cfg)


def test_bridge_rejects_a_model_with_other_names(cfg, flax_tree):
    params, stats = flax_tree
    model = build_model(cfg, device="cpu")
    model.extra = torch.nn.Linear(2, 2)
    with pytest.raises(KeyError, match="extra"):
        load_flax_variables(model, unflatten_params(params), unflatten_params(stats), cfg)


def test_bridge_rejects_a_wrong_shape(cfg, flax_tree):
    params, stats = flax_tree
    params = dict(params)
    params["predictor/class_out/bias"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="class_head.2.bias"):
        load_flax_variables(build_model(cfg, device="cpu"), unflatten_params(params),
                            unflatten_params(stats), cfg)


@pytest.mark.parametrize("forward,inverse,shape", [
    (_t_conv, hwio_to_oihw, (16, 8, 3, 3)),
    (_t_conv, hwio_to_oihw, (27, 64, 3, 3)),
    (_t_depthwise, hwio_to_oihw, (64, 1, 8, 8)),
    (_t_conv1d, conv1d_to_torch, (256, 256, 3)),
])
def test_converters_round_trip(forward, inverse, shape):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(inverse(forward(w)), w)

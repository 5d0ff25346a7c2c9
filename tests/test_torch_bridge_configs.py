"""The parameter bridge on every new model configuration: complete and strict
in both directions, as ``test_torch_bridge.py`` holds it on DLA-34 with the
DCN neck.  For GN heads, ``none`` heads, ``dla34_nodcn``, a mixed per-stage
neck with a plain-conv stage, and the dlav0 family (a Bottleneck and a
BottleneckX member, and the deepest, dla169), seeded numpy values in the
JAX model's variable shapes (traced, not run) load into the port's model,
and a missing leaf, an unmapped leaf and a wrong shape each raise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

from monoflex_tpu.models.detector import build_model as jax_build_model
from monoflex_tpu.utils.weight_import import unflatten_params
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.utils.param_bridge import flax_to_state_dict, load_flax_variables
from test_torch_configs import cfgs

CONFIGS = {
    "gn_heads": ("MODEL.HEAD.USE_NORMALIZATION", "GN"),
    "none_heads": ("MODEL.HEAD.USE_NORMALIZATION", "none"),
    "dla34_nodcn": ("MODEL.BACKBONE.CONV_BODY", "dla34_nodcn"),
    "mixed_none": ("TPU.DCN_IMPL_PER_STAGE", ("none", "gather", "pallas3b", "pallas3b")),
    "dlav0_dla46_c": ("MODEL.BACKBONE.CONV_BODY", "dlav0_dla46_c"),
    "dlav0_dla46x_c": ("MODEL.BACKBONE.CONV_BODY", "dlav0_dla46x_c"),
    "dlav0_dla169": ("MODEL.BACKBONE.CONV_BODY", "dlav0_dla169"),
}


def flax_tree(jcfg):
    model = jax_build_model(jcfg)
    args = (jnp.zeros((1, 32, 64, 3), jnp.uint8), jnp.zeros((1, 48, 2), jnp.int32),
            jnp.zeros((1,), jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args, train=False))
    rng = np.random.RandomState(0)
    return [{p: rng.randn(*s.shape).astype(np.float32)
             for p, s in flatten_dict(shapes[k], sep="/").items()}
            for k in ("params", "batch_stats")]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bridge_is_complete_and_strict(name):
    cfg, jcfg = cfgs(CONFIGS[name])
    params, stats = flax_tree(jcfg)
    model = build_model(cfg, device="cpu")
    load_flax_variables(model, unflatten_params(params), unflatten_params(stats), cfg)
    state = model.state_dict()
    assert len(params) + len(stats) == sum(1 for k in state
                                           if not k.endswith("num_batches_tracked"))
    some = sorted(params)[len(params) // 2]

    missing = dict(params)
    del missing[some]
    with pytest.raises(KeyError):
        flax_to_state_dict(unflatten_params(missing), unflatten_params(stats), cfg)
    extra = dict(stats, **{"backbone/base/Extra_0/mean": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="Extra_0"):
        flax_to_state_dict(unflatten_params(params), unflatten_params(extra), cfg)
    wrong = dict(params, **{some: np.zeros(params[some].shape + (1,), np.float32)})
    with pytest.raises(ValueError):
        load_flax_variables(build_model(cfg, device="cpu"), unflatten_params(wrong),
                            unflatten_params(stats), cfg)

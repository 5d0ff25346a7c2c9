"""The model configurations beyond DLA-34 with the DCN neck and BN heads: the
port against the JAX model on the same weights, which reach the port through
its parameter bridge (``utils/param_bridge.py``, strict about every name).

- ``dla34_nodcn`` and DCN impl "none": the DCN neck's topology with a plain
  3x3 conv with bias in each block (the JAX block's ``Conv_0``);
- heads under ``MODEL.HEAD.USE_NORMALIZATION`` "GN" (flax's GroupNorm, 32
  groups, epsilon 1e-6) and "none";
- a dlav0 trunk outside the family is refused, as the JAX package refuses
  it.  The family itself is in ``test_torch_dlav0.py``.

Weights: seeded numpy values in the JAX model's variable shapes (its init
is not compiled), with BN and GN scales, biases and running statistics off
their inits and asymmetric upsampling kernels (the statistics and the
transposed conv's orientation then matter).  Tolerance on the head maps
1e-4 abs, as ``test_torch_slice.py``, plus 1e-5 relative: float32 both
sides, summation order only, and with the statistics off their inits some
regression maps reach O(100).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu.config import get_cfg_defaults as jax_cfg_defaults
from monoflex_tpu.models.backbone.dla import DLASeg as JaxDLASeg
from monoflex_tpu.models.detector import MonoFlex as JaxMonoFlex
from monoflex_tpu.models.heads.predictor import build_predictor as jax_build_predictor
from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.data.synthetic import make_inference_batch
from monoflex_tpu_torch.models.backbone.dla import resolve_dcn_specs
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.utils.param_bridge import load_flax_variables, name_map
from test_torch_slice import ATOL, NARROW_CHANNELS, RUN_YAML, port_narrow_model

FIELDS = ("image", "edge_indices", "edge_len")
RTOL = 1e-5


def cfgs(overrides, head=32):
    """(port cfg, JAX cfg) of runs/monoflex.yaml with ``overrides``."""
    out = []
    for defaults in (get_cfg_defaults, jax_cfg_defaults):
        cfg = defaults()
        cfg.merge_from_file(RUN_YAML)
        cfg.MODEL.HEAD.NUM_CHANNEL = head
        cfg.TPU.DCN_FORCE_IMPL = "gather"
        cfg.merge_from_list(list(overrides))
        out.append(cfg)
    return out


def seeded(tree, rs, path=""):
    """Seeded numpy values for a tree of flax variable shapes: kernels
    normal / sqrt(fan in) (the upsampling kernels positive), BN and GN
    scales 1 +- 0.1, biases and running means 0.1 N(0, 1), variances in
    [0.5, 1.5]."""
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}"
        if hasattr(v, "items"):
            out[k] = seeded(v, rs, p)
            continue
        shape = v.shape
        if k == "kernel" and "/up_" in p:
            v = 0.5 + rs.rand(*shape)
        elif k == "kernel":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif k == "scale":
            v = 1 + 0.1 * rs.randn(*shape)
        elif k == "var":
            v = 0.5 + rs.rand(*shape)
        else:                       # bias, mean
            v = 0.1 * rs.randn(*shape)
        out[k] = np.asarray(v, np.float32)
    return out


def compare(jmodel, port_model, cfg, B=1, H=32, W=64, seed=0):
    """The JAX model's variable shapes (no compile), seeded values, the
    forward of both at the same weights."""
    batch = make_inference_batch(B, H, W)
    jargs = [jnp.asarray(batch[k]) for k in FIELDS]
    shapes = jax.eval_shape(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a, train=False),
                            *jargs)
    rs = np.random.RandomState(seed)
    params = seeded(shapes["params"], rs)
    stats = seeded(shapes.get("batch_stats", {}), rs)
    ref = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        {"params": params, "batch_stats": stats}, *jargs)
    load_flax_variables(port_model, params, stats, cfg)
    with torch.no_grad():
        out = port_model.eval()(*(torch.from_numpy(batch[k]) for k in FIELDS))
    pairs = [(out["cls"], ref["cls"])] + list(zip(out["reg"], ref["reg"]))
    assert len(pairs) == 10
    for got, want in pairs:
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("overrides", [("MODEL.BACKBONE.CONV_BODY", "dla34_nodcn"),
                                       ("TPU.DCN_FORCE_IMPL", "none")],
                         ids=["dla34_nodcn", "impl_none"])
def test_plain_conv_neck_matches_jax(overrides):
    cfg, jcfg = cfgs(overrides, head=16)
    assert {s.impl for s in resolve_dcn_specs(cfg)} == {"none"}
    jmodel = JaxMonoFlex(backbone=JaxDLASeg(channels=NARROW_CHANNELS, dcn_impl="none"),
                         predictor=jax_build_predictor(jcfg))
    model = port_narrow_model(cfg)
    block = model.backbone.ida_up.node_1
    assert isinstance(block.conv, torch.nn.Conv2d) and block.conv.bias is not None
    assert name_map(cfg)["backbone.ida_up.node_1.conv.bias"] == \
        "backbone/ida_up/node_1/Conv_0/bias"
    compare(jmodel, model, cfg, B=2)


@pytest.mark.parametrize("norm", ["GN", "none"])
def test_head_normalization_matches_jax(norm):
    cfg, jcfg = cfgs(("MODEL.HEAD.USE_NORMALIZATION", norm))
    jmodel = JaxMonoFlex(backbone=JaxDLASeg(channels=NARROW_CHANNELS, dcn_impl="gather"),
                         predictor=jax_build_predictor(jcfg))
    model = port_narrow_model(cfg)
    slot = model.heads["predictor"].class_head[1]
    if norm == "GN":
        assert slot.eps == 1e-6 and slot.num_groups == 32
    else:
        assert not list(slot.parameters())
    compare(jmodel, model, cfg, B=2)


def test_a_trunk_outside_the_family_is_refused():
    cfg, _ = cfgs(("MODEL.BACKBONE.CONV_BODY", "dlav0_dla35"))
    with pytest.raises(NotImplementedError, match="dla35"):
        build_model(cfg, device="cpu")

"""The vanilla DLA family (``CONV_BODY`` "dlav0" and "dlav0_<name>",
``models/backbone/dlav0.py``) against the JAX package's on the same weights:
DLA-34 with the plain-conv neck, one Bottleneck member (dla46_c) and one
BottleneckX member (dla46x_c, cardinality 32), at full width; and every
member of ``DLAV0_FAMILY`` builds with its trunk's output width and a bridge
map that names every state-dict entry.  Weights and tolerance as in
``test_torch_configs.py``.
"""

import pytest
import torch

from monoflex_tpu.models.backbone.dlav0 import DLAV0_FAMILY as JAX_DLAV0_FAMILY
from monoflex_tpu.models.detector import build_model as jax_build_model
from monoflex_tpu_torch.models.backbone.dla import build_backbone
from monoflex_tpu_torch.models.backbone.dlav0 import DLAV0_FAMILY
from monoflex_tpu_torch.models.detector import build_model
from monoflex_tpu_torch.utils.param_bridge import name_map
from test_torch_configs import cfgs, compare


@pytest.mark.parametrize("body", ["dlav0", "dlav0_dla46_c", "dlav0_dla46x_c"])
def test_vanilla_family_matches_jax(body):
    """DLA-34 (BasicBlock), dla46_c (Bottleneck) and dla46x_c (BottleneckX,
    cardinality 32) at full width."""
    cfg, jcfg = cfgs(("MODEL.BACKBONE.CONV_BODY", body), head=16)
    model = build_model(cfg, device="cpu")
    block = {"dlav0": "BasicBlock", "dlav0_dla46_c": "Bottleneck",
             "dlav0_dla46x_c": "BottleneckX"}[body]
    assert type(model.backbone.base.level2.tree1).__name__ == block
    compare(jax_build_model(jcfg), model, cfg)


def test_every_family_member_builds():
    assert DLAV0_FAMILY == JAX_DLAV0_FAMILY
    for name, (_, channels, *_rest) in DLAV0_FAMILY.items():
        cfg, _ = cfgs(("MODEL.BACKBONE.CONV_BODY", f"dlav0_{name}"))
        with torch.device("meta"):
            backbone = build_backbone(cfg)
        assert backbone.out_channels == channels[2], name
        names = {k for k in name_map(cfg) if k.startswith("backbone.")}
        state = {k for k in backbone.state_dict() if not k.endswith("num_batches_tracked")}
        assert names == {f"backbone.{k}" for k in state}, name

"""The port's inference slice (normalize -> DLA trunk -> DCN neck -> heads with
edge fusion) against the JAX model on the same weights.

A narrow model keeps the CPU run short: trunk widths (8, 8, 16, 24, 32, 48)
(each tree widens, as in DLA-34, so the trunk's name map applies) and 16-wide
heads at 64x128, batch 2.  The JAX side runs the clamped DCN as the XLA shift
op; the port runs its kernel wrapper, which takes the plain op on the CPU.

Weights start as the port's seeded init with the offset/mask convs, the
upsampling kernels and every BatchNorm perturbed off their inits, so offsets
are fractional and partly clamped, the transposed conv's orientation matters
and the statistics are used.  They go to flax through the JAX package's own
torch-name importer, and come back through the port's parameter bridge into a
fresh port model, which is the one compared.

Tolerance 1e-4 abs on the head maps (a sigmoid heatmap and O(1) regression
maps): float32 on both sides, differing in summation order only.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu.data.synthetic import make_dummy_batch
from monoflex_tpu.models.backbone.dla import DLASeg as JaxDLASeg
from monoflex_tpu.models.detector import MonoFlex as JaxMonoFlex
from monoflex_tpu.models.heads.predictor import build_predictor as jax_build_predictor
from monoflex_tpu.utils.monoflex_import import monoflex_name_map
from monoflex_tpu.utils.weight_import import convert_torch_entry, unflatten_params
from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.data.synthetic import make_inference_batch
from monoflex_tpu_torch.models.backbone.dla import DCN, BilinearUp, DLASeg, resolve_dcn_specs
from monoflex_tpu_torch.models.detector import MonoFlex, build_model, init_parameters
from monoflex_tpu_torch.models.heads.predictor import build_predictor
from monoflex_tpu_torch.utils.param_bridge import load_flax_variables

RUN_YAML = os.path.join(os.path.dirname(__file__), "..", "runs", "monoflex.yaml")
BF16_YAML = os.path.join(os.path.dirname(__file__), "..", "runs", "monoflex_bf16.yaml")
NARROW_CHANNELS = (8, 8, 16, 24, 32, 48)
STAGE_R = (2, 1, 1, 1)   # per-stage clamp: ida_0, ida_1, ida_2, ida_up
H, W, B = 64, 128, 2
ATOL = 1e-4


def narrow_cfg(impl="pallas3"):
    cfg = get_cfg_defaults()
    cfg.merge_from_file(RUN_YAML)
    cfg.MODEL.HEAD.NUM_CHANNEL = 16
    cfg.TPU.DCN_FORCE_IMPL = impl
    cfg.TPU.DCN_MAX_OFFSET_PER_STAGE = STAGE_R
    return cfg


def jax_narrow_model(cfg):
    return JaxMonoFlex(backbone=JaxDLASeg(channels=NARROW_CHANNELS, dcn_impl="shift",
                                          dcn_max_offsets=STAGE_R),
                       predictor=jax_build_predictor(cfg))


def port_narrow_model(cfg):
    return MonoFlex(DLASeg(resolve_dcn_specs(cfg), channels=NARROW_CHANNELS),
                    build_predictor(cfg, in_channels=NARROW_CHANNELS[2])).eval()


@torch.no_grad()
def perturbed_port_model(cfg, seed=0):
    model = port_narrow_model(cfg)
    g = torch.Generator().manual_seed(seed)
    init_parameters(model, g)
    for m in model.modules():
        if isinstance(m, DCN):              # zero at init: no deformation
            conv = m.conv_offset_mask
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g)
                              * 2 / conv.weight[0].numel() ** 0.5)
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=g))
        elif isinstance(m, BilinearUp):     # symmetric at init
            m.weight.mul_(0.5 + torch.rand(m.weight.shape, generator=g))
        elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.weight.add_(torch.randn(m.weight.shape, generator=g) * 0.1)
            m.bias.add_(torch.randn(m.bias.shape, generator=g) * 0.1)
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
            m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
    return model


def to_flax(model, cfg):
    """(params, batch_stats) numpy trees from the port's state dict, through
    the JAX package's importer (name map + layout converters).  The arrays
    are copies: jax may take a numpy array without copying it, and a train
    step of the port updates its BN buffers in place."""
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    trees = {"params": {}, "stats": {}}
    for torch_name, flax_path in monoflex_name_map(cfg).items():
        _, value = convert_torch_entry(torch_name, state[torch_name])
        is_stat = flax_path.startswith("stats:")
        trees["stats" if is_stat else "params"][flax_path.split(":")[-1]] = value
    return unflatten_params(trees["params"]), unflatten_params(trees["stats"])


@pytest.fixture(scope="module")
def slice_outputs():
    cfg = narrow_cfg()
    batch = make_inference_batch(B, H, W)
    source = perturbed_port_model(cfg)
    params, stats = to_flax(source, cfg)
    model = port_narrow_model(cfg)
    load_flax_variables(model, params, stats, cfg)
    for key, value in source.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key

    jmodel = jax_narrow_model(cfg)
    ref = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        {"params": params, "batch_stats": stats},
        *(jnp.asarray(batch[k]) for k in ("image", "edge_indices", "edge_len")))
    with torch.no_grad():
        out = model(*(torch.from_numpy(batch[k]) for k in ("image", "edge_indices", "edge_len")))
    return ref, out


def test_heatmap_matches_jax(slice_outputs):
    ref, out = slice_outputs
    got = out["cls"].permute(0, 2, 3, 1).numpy()
    assert got.shape == (B, H // 4, W // 4, 3)
    np.testing.assert_allclose(got, np.asarray(ref["cls"]), atol=ATOL)


def test_regression_maps_match_jax(slice_outputs):
    ref, out = slice_outputs
    assert len(out["reg"]) == len(ref["reg"]) == 9
    for got, want in zip(out["reg"], ref["reg"]):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=ATOL)


def test_inference_batch_matches_jax_batch_maker():
    """The port's numpy batch maker gives the JAX batch maker's inference
    fields, bit for bit."""
    ours = make_inference_batch(3, 64, 128, seed=7)
    theirs = make_dummy_batch(3, 64, 128, seed=7)
    for key, value in ours.items():
        np.testing.assert_array_equal(value, theirs[key], err_msg=key)
        assert value.dtype == theirs[key].dtype, key


@pytest.mark.parametrize("override", [
    ("TPU.DCN_FORCE_IMPL", "pallas4"), ("MODEL.BACKBONE.CONV_BODY", "dla35")])
def test_unserved_configs_raise(override):
    """An impl the port does not know, and a backbone the JAX package's
    ``build_backbone`` rejects too."""
    cfg = narrow_cfg("")
    cfg.merge_from_list(list(override))
    with pytest.raises(NotImplementedError):
        build_model(cfg, device="cpu")


def test_dcn_stage_specs_follow_the_config():
    cfg = narrow_cfg("")
    specs = resolve_dcn_specs(cfg)
    assert [s.max_offset for s in specs] == list(STAGE_R)
    assert all(s.transfer_dtype == torch.bfloat16 and s.use_kernel for s in specs)
    assert not any(s.use_kernel for s in resolve_dcn_specs(cfg, use_kernel=False))
    cfg.TPU.USE_PALLAS_DCN = False
    assert all(s.transfer_dtype == torch.float32 and not s.use_kernel
               for s in resolve_dcn_specs(cfg))

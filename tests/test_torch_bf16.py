"""``runs/monoflex_bf16.yaml`` (``TPU.COMPUTE_DTYPE`` "bfloat16", pallas3b)
in the port against the JAX model on the same weights: the head maps, the
decoded rows, and the 11 loss terms and every gradient of the loss.

The narrow model of ``test_torch_slice.py`` (64x128, batch 2) under the bf16
config, its weights perturbed as there (the offset/mask convs scaled by 0.1,
as in ``test_torch_train_step.py``, and the heatmap spread over (0, 1) so
top-k has no near-ties), sent to flax through the JAX package's importer.
The JAX side's v3 kernel runs as its plain reference, the XLA gather on
offsets clipped to +-R, which is the kernel's function with the port's
floor-based derivative (the kernel's hat window gives 0 at integer offsets,
ROADMAP C1, and bf16-quantised offsets land on integers).  Everything else
is the JAX model as built for bf16.

Tolerances.  bf16 keeps 8 bits: every activation of the trunk, neck and
towers is rounded to 2^-9 relative, and the two sides round at the same
points but after f32 sums in another order, so about 1e-4 of the elements of
a layer round to the neighbouring bf16 value (measured on each op in
``test_torch_bf16_layers.py``); the f32 tests' 1e-4 does not hold.
- head maps, eval mode, heatmap at its prior: 5e-3 abs; measured 1.9e-3
  (the f32 slice 2e-4 on the same maps).
- decoded rows of the spread heatmap, matched by (image, class, peak): 2e-2
  abs + 2e-2 relative on every field (depths reach tens of metres through
  1/sigmoid); measured 8e-3 of |x| + 1.  The spread multiplies the class
  feature's bf16 noise by 40, which reorders near-tied peaks: at most 5 of
  the 50 rows of an image may have no partner (measured 4), and a matched
  row may fall on the other side of the score threshold only within the
  score's tolerance of it.
- the 11 terms and every gradient of their sum, BN in eval mode (running
  statistics): terms 1e-3 relative (measured 2.3e-4); each gradient 0.5
  relative L2 and their median over the parameters 5e-2 (measured: max 0.31,
  median 2.0e-2, where the JAX bf16 gradients lie from the JAX f32 ones at
  max 0.34, median 1.8e-2: the backward through 30 bf16 layers adds a bf16
  rounding at each).  In train mode the batch statistics make the step
  chaotic under bf16 (``test_torch_bf16_step.py``), so the gradients are
  held here, with the statistics fixed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monoflex_tpu.ops.dcn_pallas_v3 as V3
from monoflex_tpu.data.synthetic import make_dummy_batch
from monoflex_tpu.decode.postprocessor import PostProcessor as JaxPostProcessor
from monoflex_tpu.losses.loss_computation import LossComputer as JaxLossComputer
from monoflex_tpu.models.backbone.dla import DLASeg as JaxDLASeg
from monoflex_tpu.models.detector import MonoFlex as JaxMonoFlex
from monoflex_tpu.models.heads.predictor import build_predictor as jax_build_predictor
from monoflex_tpu.ops.dcn import modulated_deform_conv as jax_gather
from monoflex_tpu.utils.weight_import import flatten_params
from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.data.synthetic import make_inference_batch, make_train_batch
from monoflex_tpu_torch.decode.postprocessor import PostProcessor
from monoflex_tpu_torch.losses.loss_computation import LossComputer
from monoflex_tpu_torch.models.backbone.dla import DCN
from monoflex_tpu_torch.models.layers import set_compute_dtype
from test_torch_slice import (BF16_YAML, B, H, NARROW_CHANNELS, STAGE_R, W, perturbed_port_model,
                              to_flax)
from test_torch_train_step import flax_layout

MAP_ATOL = 5e-3
ROW_TOL = dict(atol=2e-2, rtol=2e-2)
MAX_SWAPPED = 5
TERM_RTOL = 1e-3
GRAD_REL_L2, GRAD_MEDIAN = 0.5, 5e-2


def bf16_cfg(defaults=get_cfg_defaults):
    cfg = defaults()
    cfg.merge_from_file(BF16_YAML)
    cfg.MODEL.HEAD.NUM_CHANNEL = 16
    cfg.TPU.DCN_FORCE_IMPL = "pallas3b"
    cfg.TPU.DCN_MAX_OFFSET_PER_STAGE = STAGE_R
    return cfg


def clipped_gather(x, offset, mask, weight, bias, max_offset=2, transfer_dtype=None):
    """The v3 kernel's function as XLA: the gather on clipped offsets."""
    if transfer_dtype is not None:
        x = x.astype(transfer_dtype).astype(jnp.float32)
    return jax_gather(x, jnp.clip(offset, -max_offset, max_offset), mask, weight, bias)


@pytest.fixture(scope="module")
def v3_as_xla():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(V3, "dcn_pallas_v3_vjp", clipped_gather)
        yield


def jax_bf16_model(cfg):
    return JaxMonoFlex(backbone=JaxDLASeg(channels=NARROW_CHANNELS, dcn_impl="pallas3b",
                                          dcn_max_offsets=STAGE_R, dtype=jnp.bfloat16),
                       predictor=jax_build_predictor(cfg))


@torch.no_grad()
def bf16_port_model(cfg, spread=False):
    """The perturbed narrow model in bf16, offset/mask convs scaled by 0.1;
    with ``spread`` its heatmap spread over (0, 1)."""
    model = perturbed_port_model(cfg)
    set_compute_dtype(model.backbone, torch.bfloat16)
    for m in model.modules():
        if isinstance(m, DCN):
            m.conv_offset_mask.weight.mul_(0.1)
    if spread:
        out = model.heads["predictor"].class_head[2]
        out.weight.mul_(40)
        out.bias.copy_(torch.tensor([-1.0, -1.5, -2.0]))
    return model


def keyed_rows(rows, valid, points):
    """Per image: ({(class, x, y): row}, {keys of the rows above threshold})."""
    out = []
    for r, v, p in zip(rows, valid, points):
        keys = [(int(row[0]), int(x), int(y)) for row, (x, y) in zip(r, p)]
        out.append((dict(zip(keys, r)), {k for k, ok in zip(keys, v) if ok}))
    return out


@pytest.fixture(scope="module")
def forward(v3_as_xla):
    """Head maps of the model, then the decoded rows of the same model with
    its heatmap spread, both sides."""
    from monoflex_tpu.config import get_cfg_defaults as jax_cfg_defaults

    cfg = bf16_cfg()
    batch = make_inference_batch(B, H, W)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jmodel, jpost = jax_bf16_model(cfg), JaxPostProcessor(bf16_cfg(jax_cfg_defaults))

    @jax.jit
    def jstep(variables, batch):
        out = jmodel.apply(variables, batch["image"], batch["edge_indices"], batch["edge_len"],
                           train=False)
        return out, jpost(out, batch)

    sides = {}
    for spread in (False, True):
        model = bf16_port_model(cfg, spread=spread).eval()
        params, stats = to_flax(model, cfg)
        ref, (jrows, jvalid, jextras) = jstep({"params": params, "batch_stats": stats}, jbatch)
        with torch.no_grad():
            out = model(tbatch["image"], tbatch["edge_indices"], tbatch["edge_len"])
            rows, valid, extras = PostProcessor(cfg)(out, tbatch)
        sides[spread] = dict(
            ref=ref, out=out, rows=(rows.numpy(), valid.numpy(), extras["points"].numpy()),
            jrows=(np.asarray(jrows), np.asarray(jvalid), np.asarray(jextras["points"])))
    return dict(ref=sides[False]["ref"], out=sides[False]["out"], rows=sides[True]["rows"],
                jrows=sides[True]["jrows"])


def test_head_maps_match_jax(forward):
    ref, out = forward["ref"], forward["out"]
    assert out["cls"].dtype == torch.float32 and all(r.dtype == torch.float32 for r in out["reg"])
    pairs = [(out["cls"], ref["cls"])] + list(zip(out["reg"], ref["reg"]))
    assert len(pairs) == 10
    for got, want in pairs:
        assert np.asarray(want).dtype == np.float32
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   atol=MAP_ATOL)


def test_decoded_rows_match_jax(forward):
    ours, theirs = keyed_rows(*forward["rows"]), keyed_rows(*forward["jrows"])
    threshold = bf16_cfg().TEST.DETECTIONS_THRESHOLD
    n_valid = 0
    for (by_key, valid_keys), (jby_key, jvalid_keys) in zip(ours, theirs):
        common = by_key.keys() & jby_key.keys()
        assert len(common) >= len(by_key) - MAX_SWAPPED
        for key in common:
            np.testing.assert_allclose(by_key[key], jby_key[key], err_msg=str(key), **ROW_TOL)
            if (key in valid_keys) != (key in jvalid_keys):
                assert abs(jby_key[key][-1] - threshold) <= ROW_TOL["atol"], key
        n_valid += len(valid_keys)
    assert n_valid > 0


@pytest.fixture(scope="module")
def eval_mode_grads(v3_as_xla):
    cfg = bf16_cfg()
    model = bf16_port_model(cfg).eval()
    params, stats = to_flax(model, cfg)
    jbatch = {k: jnp.asarray(v) for k, v in make_dummy_batch(B, H, W).items()}
    jmodel, jloss = jax_bf16_model(cfg), JaxLossComputer(cfg)

    def loss_fn(p):
        out = jmodel.apply({"params": p, "batch_stats": stats}, jbatch["image"],
                           jbatch["edge_indices"], jbatch["edge_len"], train=False)
        terms = jloss(out, jbatch)[0]
        return sum(jax.tree.leaves(terms)), terms

    (_, jterms), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    batch = {k: torch.from_numpy(v) for k, v in make_train_batch(B, H, W).items()}
    out = model(batch["image"], batch["edge_indices"], batch["edge_len"])
    terms = LossComputer(cfg)(out, batch)[0]
    sum(terms[k] for k in sorted(terms)).backward()
    # a deeper tree's projection runs only in train mode: no gradient here
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    return dict(cfg=cfg, terms=terms, jterms=jterms, grads=flax_layout(grads, cfg),
                jgrads={k: np.asarray(v) for k, v in flatten_params(jgrads).items()})


def test_loss_terms_match_jax(eval_mode_grads):
    terms, jterms = eval_mode_grads["terms"], eval_mode_grads["jterms"]
    assert len(terms) == len(eval_mode_grads["cfg"].MODEL.HEAD.LOSS_NAMES) == 11
    assert set(terms) == set(jterms)
    for key, want in jterms.items():
        np.testing.assert_allclose(terms[key].item(), float(want), rtol=TERM_RTOL, err_msg=key)


def test_every_gradient_matches_jax(eval_mode_grads):
    got, want = eval_mode_grads["grads"], eval_mode_grads["jgrads"]
    errs = []
    for path, g in want.items():
        if not g.any():
            assert path not in got or not got[path].any(), path
            continue
        assert got[path].dtype == np.float32
        err = np.linalg.norm(got[path] - g) / np.linalg.norm(g)
        assert err <= GRAD_REL_L2, (path, err)
        errs.append(err)
    assert len(errs) > 100
    assert np.median(errs) <= GRAD_MEDIAN, np.median(errs)

"""The port's loss primitives, box encoding, 3D IoU and ``LossComputer`` against
the JAX package on the same numpy inputs.

``LossComputer`` is fed seeded head maps (NHWC for JAX, the same arrays as
NCHW for the port) and the JAX package's ``make_dummy_batch``, once as made
and once with truncated objects, yaws, 3D offsets and invalid keypoint depths
drawn in, so every branch of the 11 terms carries weight.  The regression
rows at the objects' centers are set near the ground truth, so the 3D IoU and
the depth ensembles see overlapping boxes.

Tolerances.  float32 on both sides, summation order only: loss terms, log
entries and primitive outputs 1e-5 relative (plus 1e-6 abs for values near
0); box corners 1e-4 abs (metres, up to 50); gradients of the total with
respect to the head maps 1e-5 of the largest element of each map.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu.core import geometry_jax as GJ
from monoflex_tpu.data.synthetic import make_dummy_batch
from monoflex_tpu.losses import primitives as JP
from monoflex_tpu.losses.loss_computation import LossComputer as JaxLossComputer
from monoflex_tpu.models.heads.key2channel import Key2Channel
from monoflex_tpu.ops.rotated_iou import iou_3d_pairs as jax_iou_3d_pairs
from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.core import geometry as G
from monoflex_tpu_torch.losses import primitives as P
from monoflex_tpu_torch.losses.loss_computation import LossComputer
from monoflex_tpu_torch.ops.rotated_iou import iou_3d_pairs

RUN_YAML = os.path.join(os.path.dirname(__file__), "..", "runs", "monoflex.yaml")
RTOL, ATOL = 1e-5, 1e-6
CORNER_ATOL = 1e-4
GRAD_RTOL = 1e-5
B, H, W = 2, 64, 128


def cfg_with(**overrides):
    cfg = get_cfg_defaults()
    cfg.merge_from_file(RUN_YAML)
    for key, value in overrides.items():
        cfg.merge_from_list([key, value])
    return cfg


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------- primitives

def test_masked_mean_and_pointwise_losses():
    rng = np.random.RandomState(0)
    pred, target = rng.randn(2, 64).astype(np.float32) * 3
    mask = (rng.rand(64) > 0.5).astype(np.float32)
    close(P.masked_mean(t(pred), t(mask)), JP.masked_mean(pred, mask))
    close(P.masked_mean(t(pred), t(0 * mask)), JP.masked_mean(pred, 0 * mask))
    for name in ("l1", "smooth_l1", "berhu_loss", "inverse_sigmoid_loss"):
        close(getattr(P, name)(t(pred), t(target)), getattr(JP, name)(pred, target), msg=name)
    depth = np.abs(target) + 0.5
    close(P.log_l1_loss(t(np.abs(pred)), t(depth)), JP.log_l1_loss(np.abs(pred), depth))


def test_focal_loss_with_ignored_and_gaussian_pixels():
    rng = np.random.RandomState(1)
    pred = rng.uniform(1e-4, 1 - 1e-4, (2, 16, 32, 3)).astype(np.float32)
    target = rng.choice([-1.0, 0.0, 0.3, 0.9, 1.0], size=pred.shape).astype(np.float32)
    got = P.penalty_reduced_focal_loss(t(pred), t(target), 2.0, 4.0)
    want = JP.penalty_reduced_focal_loss(pred, target, 2.0, 4.0)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("loss_type", ["iou", "linear_iou", "giou"])
def test_iou_loss_2d(loss_type):
    rng = np.random.RandomState(2)
    pred, target = np.abs(rng.randn(2, 50, 4)).astype(np.float32) * 5
    for g, w in zip(P.iou_loss_2d(t(pred), t(target), loss_type),
                    JP.iou_loss_2d(pred, target, loss_type)):
        close(g, w)


def test_multibin_orientation_loss():
    rng = np.random.RandomState(3)
    vec = rng.randn(30, 16).astype(np.float32)
    gt = np.concatenate([rng.randint(0, 2, (30, 4)), rng.uniform(-3, 3, (30, 4))],
                        axis=1).astype(np.float32)
    mask = (rng.rand(30) > 0.3).astype(np.float32)
    close(P.multibin_orientation_loss(t(vec), t(gt), t(mask), 4),
          JP.multibin_orientation_loss(vec, gt, mask, 4))


# ---------------------------------------------------------- geometry and IoU

def random_boxes(rng, n):
    rotys = rng.uniform(-math.pi, math.pi, n).astype(np.float32)
    dims = rng.uniform(0.5, 4.0, (n, 3)).astype(np.float32)
    locs = np.stack([rng.uniform(-10, 10, n), rng.uniform(0, 2, n),
                     rng.uniform(5, 50, n)], axis=1).astype(np.float32)
    return rotys, dims, locs


def test_encode_box3d():
    rotys, dims, locs = random_boxes(np.random.RandomState(4), 64)
    close(G.rad_to_matrix(t(rotys)), GJ.rad_to_matrix(rotys), atol=ATOL)
    close(G.encode_box3d(t(rotys), t(dims), t(locs)), GJ.encode_box3d(rotys, dims, locs),
          rtol=0, atol=CORNER_ATOL)


def test_iou_3d_pairs():
    """Pairs that overlap partly, fully (a box with itself), and not at all."""
    rng = np.random.RandomState(5)
    rotys, dims, locs = random_boxes(rng, 48)
    a = GJ.encode_box3d(rotys, dims, locs)
    jitter = [rotys + rng.uniform(-0.5, 0.5, 48).astype(np.float32),
              dims * rng.uniform(0.7, 1.3, (48, 3)).astype(np.float32),
              locs + rng.uniform(-1, 1, (48, 3)).astype(np.float32)]
    b = np.array(GJ.encode_box3d(*jitter))
    b[:8] = np.asarray(a)[:8]
    b[-8:] += 100.0
    a = np.asarray(a)
    got = iou_3d_pairs(t(a), t(b)).numpy()
    want = np.asarray(jax_iou_3d_pairs(jnp.asarray(a), jnp.asarray(b)))
    close(got, want, atol=1e-5)
    assert (want[8:-8] > 0.05).mean() > 0.5 and np.allclose(want[:8], 1.0, atol=1e-4)
    assert (want[-8:] == 0).all()


# ------------------------------------------------------------ LossComputer

def varied_batch(batch, seed):
    """Truncated objects, yaws, 3D offsets and invalid keypoint depths on the
    valid slots of a make_dummy_batch batch."""
    rng = np.random.RandomState(seed)
    out = dict(batch)
    valid = batch["reg_mask"] > 0
    out["trunc_mask"] = (valid & (rng.rand(*valid.shape) > 0.5)).astype(np.float32)
    out["rotys"] = np.where(valid, rng.uniform(-3, 3, valid.shape), 0).astype(np.float32)
    out["offset_3D"] = (rng.uniform(-0.5, 0.5, batch["offset_3D"].shape)
                        * valid[..., None]).astype(np.float32)
    out["keypoints_depth_mask"] = (batch["keypoints_depth_mask"]
                                   * (rng.rand(*valid.shape, 3) > 0.3)).astype(np.float32)
    return out


def head_maps(cfg, batch, seed):
    """Seeded NHWC head maps, each regression row at an object's center set
    near the values that decode to its ground truth."""
    h = cfg.MODEL.HEAD
    k2c = Key2Channel(h.REGRESSION_HEADS, h.REGRESSION_CHANNELS)
    rng = np.random.RandomState(seed)
    Ho, Wo = batch["hm"].shape[1:3]
    cls = rng.uniform(1e-4, 1 - 1e-4, batch["hm"].shape).astype(np.float32)
    reg = (rng.randn(B, Ho, Wo, k2c.total_channels) * 0.3).astype(np.float32)
    mean = np.asarray(h.DIMENSION_MEAN, np.float32)
    for b, i in zip(*np.nonzero(batch["reg_mask"])):
        cx, cy = batch["target_centers"][b, i]
        row = reg[b, cy, cx]
        box = batch["2d_bboxes"][b, i]
        row[k2c("2d_dim")] = np.concatenate([[cx, cy] - box[:2], box[2:] - [cx, cy]])
        row[k2c("3d_offset")] = batch["offset_3D"][b, i]
        row[k2c("corner_offset")] = batch["keypoints"][b, i, :, :2].reshape(-1)
        row[k2c("3d_dim")] = np.log(batch["dimensions"][b, i] / mean[batch["cls_ids"][b, i]])
        row[k2c("depth")] = -math.log(batch["locations"][b, i, 2])
        row = row + (rng.randn(row.size) * 0.1).astype(np.float32)
        # trust the direct depth over the keypoint depths (the keypoint
        # targets are noise), so the soft and hard depth ensembles place
        # the boxes near their targets
        row[k2c("corner_uncertainty")] = 8.0
        reg[b, cy, cx] = row
    splits = np.cumsum(k2c.channels)[:-1]
    return cls, np.split(reg, splits, axis=-1)


def jax_losses(cfg, cls, reg, batch):
    computer = JaxLossComputer(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def total(maps):
        loss_dict, log_dict = computer({"cls": maps[0], "reg": list(maps[1])}, jbatch)
        return sum(jax.tree.leaves(loss_dict)), (loss_dict, log_dict)

    (_, (loss_dict, log_dict)), grads = jax.value_and_grad(total, has_aux=True)(
        (jnp.asarray(cls), [jnp.asarray(r) for r in reg]))
    return loss_dict, log_dict, [grads[0]] + list(grads[1])


def port_losses(cfg, cls, reg, batch):
    maps = [t(cls).permute(0, 3, 1, 2).requires_grad_()]
    maps += [t(r).permute(0, 3, 1, 2).requires_grad_() for r in reg]
    loss_dict, log_dict = LossComputer(cfg)({"cls": maps[0], "reg": tuple(maps[1:])},
                                            {k: t(v) for k, v in batch.items()})
    sum(loss_dict[k] for k in sorted(loss_dict)).backward()
    return loss_dict, log_dict, [m.grad.permute(0, 2, 3, 1).numpy() for m in maps]


@pytest.mark.parametrize("variant,overrides", [
    ("dummy", {}),
    ("varied", {}),
    ("varied", {"MODEL.HEAD.CORNER_LOSS_DEPTH": "hard_combine"}),
    ("varied", {"MODEL.HEAD.CORNER_LOSS_DEPTH": "keypoint_mean",
                "MODEL.HEAD.LOSS_TYPE": ["Penalty_Reduced_FocalLoss", "smoothL1", "iou",
                                         "berhu"]}),
    ("varied", {"MODEL.HEAD.CORNER_LOSS_DEPTH": "direct",
                "MODEL.HEAD.LOSS_TYPE": ["Penalty_Reduced_FocalLoss", "L1", "linear_iou",
                                         "log"],
                "MODEL.HEAD.TRUNCATION_OFFSET_LOSS": "L1",
                "MODEL.HEAD.MODIFY_INVALID_KEYPOINT_DEPTH": False}),
])
def test_loss_computer_matches_jax(variant, overrides):
    cfg = cfg_with(**overrides)
    batch = make_dummy_batch(B, H, W, n_valid=5, seed=11)
    if variant == "varied":
        batch = varied_batch(batch, seed=12)
    cls, reg = head_maps(cfg, batch, seed=13)
    jloss, jlog, jgrads = jax_losses(cfg, cls, reg, batch)
    loss, log, grads = port_losses(cfg, cls, reg, batch)

    assert set(loss) == set(jloss) and len(loss) == len(cfg.MODEL.HEAD.LOSS_NAMES) == 11
    assert set(log) == set(jlog)
    for key in jloss:
        close(loss[key].detach(), jloss[key], msg=key)
        assert float(jloss[key]) != 0.0 or key == "trunc_offset_loss" and variant == "dummy", key
    for key in jlog:
        close(log[key].detach(), jlog[key], msg=key)
    if cfg.MODEL.HEAD.CORNER_LOSS_DEPTH != "keypoint_mean":
        assert float(jlog["3D_IoU"]) > 0.05
    for i, (g, want) in enumerate(zip(grads, jgrads)):
        want = np.asarray(want)
        assert np.abs(g - want).max() <= GRAD_RTOL * np.abs(want).max(), i

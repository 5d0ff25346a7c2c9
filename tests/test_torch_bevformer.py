"""The port's BEVFormer (``MODEL.META_ARCHITECTURE`` "BEVFormer") against the
plain reference ``tests/plain_bevformer.py``, on the CPU at the published
widths (256 channels, 8 heads, 8 and 4 points, 4 levels, R-101 with its 26
DCNs) with the BEV grid (12 x 12), the layer counts (2 and 2) and the
images (six 45 x 80 cameras, padded to 64 x 96) cut.

- The seeded weights are the reference's, parameter for parameter.
- One call, and three calls of a scene (a shift and a 3 degree turn), each
  given the port's own previous BEV on both sides: the BEV, the class
  logits and the box codes agree within ``TOL`` of each one's RMS (the
  largest difference).  Both sides compute in float32, TF32 off, with the
  same DCN clamp and float32 x: what separates them is the order of float32
  sums, in the trunk (the channels-last convolutions and the DCNs, several
  pixels of offset) above all; measured here 4.8e-5 (logits) to 4.8e-4
  (BEV).  ``TOL`` = 3e-3.  A bfloat16 forward reads 0.087 (logits) to 0.78
  (BEV) (``test_a_bf16_forward_misses_the_tolerance``).
- A scene start takes the no-history path whatever the buffer holds; a
  camera that sees no cell adds nothing; the port's masked spatial
  cross-attention equals the published ``nonzero`` rebatch; the rotation's
  index map equals torchvision's rotate; the decode keeps the reference's
  boxes.
- The eval path: ``make_eval_step`` and its counters; the training entry
  points refuse the model.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import plain_bevformer as plain  # noqa: E402
from monoflex_tpu_torch.config import get_cfg_defaults  # noqa: E402
from monoflex_tpu_torch.decode.postprocessor import build_postprocessor  # noqa: E402
from monoflex_tpu_torch.models import bevformer as B  # noqa: E402
from monoflex_tpu_torch.models.detector import build_model  # noqa: E402

TOL = 3e-3
SEED = 7
BEV = 12
LAYERS = 2
OPTS = ["MODEL.META_ARCHITECTURE", "BEVFormer", "MODEL.BACKBONE.CONV_BODY", "R-101",
        "INPUT.PIXEL_MEAN", "[0.406, 0.456, 0.485]",
        "INPUT.PIXEL_STD", f"[{1 / 255!r}, {1 / 255!r}, {1 / 255!r}]", "INPUT.TO_BGR", "True",
        "DATALOADER.SIZE_DIVISIBILITY", "32", "TPU.DCN_MAX_OFFSET", "2",
        "TPU.DCN_FORCE_IMPL", "pallas3"]
# nuScenes' six ring cameras (front, front right, back right, back, back
# left, front left): yaw left of forward (degrees) and (fx, cx, cy) at 1600 x 900
YAWS = (0.0, -55.0, -110.0, 180.0, 110.0, 55.0)
INTRINSICS = ((1266.4, 816.3, 491.5), (1260.8, 808.0, 495.3), (1259.5, 807.3, 501.2),
              (809.2, 829.2, 481.8), (1256.7, 792.1, 492.8), (1272.6, 826.6, 479.8))
IMG = (45, 80)


def config(*opts):
    cfg = get_cfg_defaults()
    cfg.merge_from_list(OPTS + list(opts))
    return cfg


def lidar2img(scale: float = IMG[1] / 1600) -> torch.Tensor:
    """(6, 4, 4): the intrinsics at ``scale`` after each camera's extrinsics
    in the lidar frame (x right, y forward, z up; cameras 1 m out along
    their axis, 0.3 m below the lidar)."""
    out = []
    for yaw, (f, cx, cy) in zip(YAWS, INTRINSICS):
        a = math.radians(yaw)
        d = np.array([-math.sin(a), math.cos(a), 0.0])
        R = np.stack([np.array([math.cos(a), math.sin(a), 0.0]), np.array([0.0, 0.0, -1.0]), d])
        E = np.eye(4)
        E[:3, :3] = R
        E[:3, 3] = -R @ (d * 1.0 + np.array([0.0, 0.0, -0.3]))
        K = np.eye(4)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = f * scale, f * scale, cx * scale, cy * scale
        out.append(K @ E)
    return torch.tensor(np.stack(out), dtype=torch.float32)


def images(seed: int = 0, n: int = 6) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    low = torch.rand(n, 3, 5, 8, generator=g) * 255
    img = torch.nn.functional.interpolate(low, size=IMG, mode="bilinear")
    return img.permute(0, 2, 3, 1).round().to(torch.uint8).contiguous()


def can_bus(dx=0.0, dy=0.0, yaw=0.3, dyaw=0.0) -> torch.Tensor:
    c = torch.zeros(18)
    c[0], c[1], c[16], c[17] = dx, dy, yaw, dyaw
    c[3] = 1.0
    return c


@pytest.fixture(scope="module", autouse=True)
def narrow():
    saved = (B.BEV_H, B.BEV_W, B.ENCODER_LAYERS, B.DECODER_LAYERS)
    B.BEV_H = B.BEV_W = BEV
    B.ENCODER_LAYERS = B.DECODER_LAYERS = LAYERS
    yield
    B.BEV_H, B.BEV_W, B.ENCODER_LAYERS, B.DECODER_LAYERS = saved


def reference(compute_dtype=torch.float32) -> plain.BEVFormer:
    return plain.BEVFormer(bev_h=BEV, bev_w=BEV, encoder_layers=LAYERS, decoder_layers=LAYERS,
                           transfer_dtype=torch.float32, compute_dtype=compute_dtype).eval()


@torch.no_grad()
def regime(model, x: torch.Tensor, seed: int) -> dict:
    """The benchmark's regime: seeded DCN offset convs and deformable
    sampling offsets and attention weights (offsets of a few cells or
    pixels), BN bias 2 and the BN statistics of ``x`` (one train-mode pass
    of the reference); returns the state the reference loads."""
    g = torch.Generator().manual_seed(seed + 1)
    for name, p in model.named_parameters():
        if ".conv_offset_mask." in name or name.endswith(
                ("sampling_offsets.weight", "attention_weights.weight")):
            scale = 2.0 / math.sqrt(p[0].numel()) if p.dim() > 1 else 1.0
            p.copy_(torch.randn(p.shape, generator=g) * scale)
        elif name.endswith(".bias") and ("bn" in name or "downsample.1" in name):
            p.fill_(2.0)
    ref = reference()
    ref.load_state_dict(model.state_dict(), strict=False)
    for m in ref.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    ref.backbone.train()
    ref.features(x)
    stats = {k: v for k, v in ref.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    model.load_state_dict(stats, strict=False)
    return {k: v for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def models():
    """(port, reference) on the same weights, in the benchmark's regime."""
    port = build_model(config(), device="cpu", seed=SEED)
    x = images()
    state = regime(port, x, SEED)
    ref = reference()
    ref.load_state_dict(state)
    return port, ref


def rms_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().square().mean().sqrt())


def gaps(out, want):
    return {k: rms_gap(out[k], want[k]) for k in ("bev", "cls", "boxes")}


def port_call(port, img, l2i, bus, start):
    with torch.no_grad():
        return port(img, l2i, bus, torch.tensor([start]))


def test_the_reference_imports_neither_jax_nor_the_port():
    code = ("import sys, json; sys.path.insert(0, 'tests'); import plain_bevformer; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         check=True, timeout=120)
    tops = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "monoflex_tpu", "monoflex_tpu_torch"}


def test_seeded_weights_are_the_references():
    port = build_model(config(), device="cpu", seed=SEED)
    ref = reference()
    plain.init(ref, SEED)
    ours, theirs = port.state_dict(), ref.state_dict()
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k


def test_one_call_matches_the_reference(models):
    port, ref = models
    x, l2i, bus = images(), lidar2img(), can_bus()
    out = port_call(port, x, l2i, bus, True)
    with torch.no_grad():
        want = ref(x, l2i, bus, None)
    got = gaps(out, want)
    assert max(got.values()) < TOL, got


def test_a_scene_carries_its_history(models):
    """Three calls: a scene start, then two with a shift of about a cell
    and a 3 degree turn; each side is given the port's own previous BEV."""
    port, ref = models
    l2i = lidar2img()
    calls = [(images(1), can_bus(), True), (images(2), can_bus(6.0, 2.0, 0.35, 3.0), False),
             (images(3), can_bus(5.0, 3.5, 0.40, 3.0), False)]
    prev = None
    for x, bus, start in calls:
        out = port_call(port, x, l2i, bus, start)
        with torch.no_grad():
            want = ref(x, l2i, bus, None if start else prev)
        got = gaps(out, want)
        assert max(got.values()) < TOL, got
        prev = out["bev"].clone()
    assert torch.equal(port.prev_bev, prev)
    # without the history the last call is another call
    with torch.no_grad():
        fresh = ref(x, l2i, bus, None)
    assert rms_gap(out["bev"], fresh["bev"]) > 100 * TOL


def test_a_scene_start_ignores_the_buffer(models):
    port, _ = models
    x, l2i, bus = images(4), lidar2img(), can_bus(3.0, 1.0, 0.2, 2.0)
    first = port_call(port, x, l2i, bus, True)
    port_call(port, images(5), l2i, can_bus(4.0, 0.0, 0.3, -2.0), False)
    again = port_call(port, x, l2i, bus, True)
    for k in first:
        assert torch.equal(first[k], again[k]), k


def test_a_camera_that_sees_no_cell(models):
    port, ref = models
    x, l2i, bus = images(6), lidar2img(), can_bus()
    l2i[2, 2] = torch.tensor([0.0, 0.0, 0.0, -1.0])        # every point behind it
    from monoflex_tpu_torch.models.bevformer import point_sampling
    _, visible = point_sampling(port.ref_3d, l2i, (64, 96))
    assert not visible[2].any() and visible.any(1).sum() == 5
    out = port_call(port, x, l2i, bus, True)
    with torch.no_grad():
        want = ref(x, l2i, bus, None)
    got = gaps(out, want)
    assert max(got.values()) < TOL, got


def test_the_masked_cross_attention_is_the_published_rebatch():
    """The port's spatial cross-attention (every cell a camera, masked)
    against the reference's (each camera's visible cells by ``nonzero``,
    padded to the longest list), on the same weights and random inputs: a
    camera that sees no cell, cells seen by none, one or several."""
    torch.manual_seed(0)
    port, ref = B.SpatialCrossAttention(), plain.SpatialCrossAttention()
    for m in port.modules():
        if isinstance(m, torch.nn.Linear):
            torch.nn.init.normal_(m.weight, std=0.1)
            torch.nn.init.normal_(m.bias, std=0.1)
    ref.load_state_dict(port.state_dict())
    shapes = [(6, 10), (3, 5), (2, 3), (1, 2)]
    S, Q, N, D = sum(h * w for h, w in shapes), 50, 6, 4
    q = torch.randn(Q, 256)
    feats = torch.randn(N, S, 256)
    ref_cam = torch.rand(N, Q, D, 2)
    bev_mask = torch.rand(N, Q, D) < 0.3
    bev_mask[3] = False
    bev_mask[:, :5] = False
    with torch.no_grad():
        got = port(q, feats, shapes, ref_cam, bev_mask.any(-1))
        want = ref(q[None], feats, ref_cam[:, None], bev_mask[:, None], shapes)[0]
    assert (got - want).abs().max() < 1e-5 * want.abs().max()


@pytest.mark.parametrize("size", [BEV, 200])
def test_the_rotation_index_map_is_torchvisions_rotate(size):
    x = torch.randn(3, size, size)
    for angle in (0.0, 3.0, -7.5, 90.0, 181.3, 359.0):
        want = plain.rotate(x, angle, center=(size / 2, size / 2))
        got = B.rotate_bev(x.permute(1, 2, 0).reshape(size * size, 3), torch.tensor(angle),
                           size, size)
        assert torch.equal(got.reshape(size, size, 3).permute(2, 0, 1), want), angle


def test_the_shift_is_the_published_one():
    for bus in (can_bus(3.0, 4.0, 0.7), can_bus(-2.0, 0.5, 4.0), can_bus()):
        want = plain.shift_from_can_bus(bus.double().numpy(), 200, 200)
        got = B.bev_shift(bus, 200, 200)
        assert np.allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_the_decoder_keeps_the_references_boxes():
    g = torch.Generator().manual_seed(3)
    cls = torch.randn(900, 10, generator=g) * 2 - 3
    boxes = torch.randn(900, 10, generator=g)
    boxes[:, [0, 1]] *= 40
    boxes[:, 4] *= 6
    boxes[:, 0] += torch.where(torch.arange(900) % 7 == 0, 70.0, 0.0)   # outside the range
    rows, valid, extras = build_postprocessor(config())(
        {"bev": torch.zeros(1), "cls": cls, "boxes": boxes}, {"scene_start": torch.tensor([1])})
    want = plain.decode(cls, boxes)
    got = rows[0][valid[0]]
    assert 0 < len(got) < 300 and len(got) == len(want["boxes"])
    assert torch.equal(got[:, :9], want["boxes"])
    assert torch.equal(got[:, 9], want["scores"]) and torch.equal(got[:, 10].long(), want["labels"])
    assert torch.equal(extras["queries"][0][valid[0]], want["queries"])


def test_the_eval_step_counts_its_history(models):
    from monoflex_tpu_torch.train.train_step import make_eval_step
    from monoflex_tpu_torch.utils import trace

    port, _ = models
    step = make_eval_step(port, build_postprocessor(config()))
    l2i, x = lidar2img(), images(7)
    trace.drain()
    trace.on()
    try:
        for start in (True, False, False):
            rows, valid, extras = step({"image": x, "lidar2img": l2i, "can_bus": can_bus(1.0),
                                        "scene_start": torch.tensor([start])})
    finally:
        trace.off()
    drained = trace.drain()
    assert drained.counters["bev.history_used"] == 2 and drained.counters["bev.scene_starts"] == 1
    # the counters read the path the forward took, not the batch's flag
    out = port(x, l2i, can_bus(1.0), torch.tensor([True]))
    assert out["history_used"].tolist() == [0]
    trace.on()
    try:
        build_postprocessor(config())({**out, "history_used": torch.ones(1, dtype=torch.int32)},
                                      {"scene_start": torch.tensor([True])})
    finally:
        trace.off()
    assert trace.drain().counters == {"bev.history_used": 1, "bev.scene_starts": 0}
    names = {s.name for s in drained.spans}
    assert {"bev.encoder", "bev.decoder", "decode.bevformer", "eval_step.forward"} <= names
    assert rows.shape == (1, 300, 11) and extras["bev"].shape == (BEV * BEV, 256)


def test_a_bf16_forward_misses_the_tolerance(models):
    _, ref = models
    port16 = build_model(config("TPU.COMPUTE_DTYPE", "bfloat16"), device="cpu", seed=SEED)
    port16.load_state_dict(ref.state_dict())
    x, l2i, bus = images(), lidar2img(), can_bus()
    out = port_call(port16, x, l2i, bus, True)
    with torch.no_grad():
        want = ref(x, l2i, bus, None)
    got = gaps(out, want)
    assert min(got.values()) > 3 * TOL, got


def test_training_entry_points_refuse_it():
    from monoflex_tpu_torch.models.detector import require_trainable

    with pytest.raises(NotImplementedError, match="F11"):
        require_trainable("BEVFormer")

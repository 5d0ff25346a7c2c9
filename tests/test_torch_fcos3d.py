"""The port's FCOS3D (``MODEL.META_ARCHITECTURE`` "FCOSMono3D") against the
plain reference ``tests/plain_fcos3d.py``, on the CPU at a small input
(two 90x160 images, padded to 96x160) and full widths and depth (R-101).

- The seeded weights are the reference's, parameter for parameter.
- The trunk's C3-C5, the FPN's P3-P7 and the head's maps agree within
  ``TOL`` of each map's RMS (the largest difference), with the weights in
  the benchmark's regime (offsets of several pixels, BN statistics of the
  input, BN bias 2).  Both sides compute in float32, TF32 off, with the
  same DCN clamp and float32 x: what separates them is the order of
  float32 sums (the channels-last convolutions against the plain ones),
  3.4e-6 of the RMS at C3, which has no DCN.  Each DCN grows it, since an
  offset that moves by e moves its sample by e along the map's gradient:
  the 23 of stage 3 to 6-9e-5 at C4, the 3 of stage 4 (several pixels of
  offset on a 3x5 map) to 4.7e-4-1.1e-3 at C5, and the head reads
  1.1e-4-2.6e-4 (measured here at clamps 2 and 4, and under "shift").
  ``TOL`` = 3e-3 leaves the worst 2.7x of room.  A bfloat16 forward (one
  rounding is 4e-3 a layer) reads 3.4e-2 at C3 and 0.09-0.29 at the head,
  10-100x over it (``test_a_bf16_forward_misses_the_tolerance``).
- The decoder keeps exactly the reference's boxes on the same head maps.
- On the card the graphed forward is bit-equal to the eager one and runs
  36 ``dcn_fwd`` launches a forward.
- The training entry points refuse the configuration.
"""

import math
import os
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import plain_fcos3d as plain  # noqa: E402
from monoflex_tpu_torch.config import get_cfg_defaults  # noqa: E402
from monoflex_tpu_torch.models.detector import build_model  # noqa: E402

TOL = 3e-3
SEED = 5
OPTS = ["MODEL.META_ARCHITECTURE", "FCOSMono3D", "MODEL.BACKBONE.CONV_BODY", "R-101",
        "INPUT.PIXEL_MEAN", "[0.406, 0.456, 0.485]",
        "INPUT.PIXEL_STD", f"[{1 / 255!r}, {1 / 255!r}, {1 / 255!r}]", "INPUT.TO_BGR", "True",
        "DATALOADER.SIZE_DIVISIBILITY", "32"]
# nuScenes' CAM_FRONT and CAM_BACK, at the test's 160-pixel width
CAMS = torch.tensor([[[126.6, 0.0, 81.6], [0.0, 126.6, 50.4], [0.0, 0.0, 1.0]],
                     [[80.9, 0.0, 82.6], [0.0, 80.9, 51.1], [0.0, 0.0, 1.0]]])


def config(*opts):
    cfg = get_cfg_defaults()
    cfg.merge_from_list(OPTS + list(opts))
    return cfg


def images(seed: int = 0, n: int = 2) -> torch.Tensor:
    """Smooth seeded images (blobs of colour), so the maps vary in space."""
    g = torch.Generator().manual_seed(seed)
    low = torch.rand(n, 3, 6, 10, generator=g) * 255
    img = torch.nn.functional.interpolate(low, size=(90, 160), mode="bilinear")
    return img.permute(0, 2, 3, 1).round().to(torch.uint8).contiguous()


@torch.no_grad()
def regime(model, x: torch.Tensor, seed: int) -> dict:
    """The benchmark's regime on the port's model: seeded offset convs, BN
    bias 2, and BN statistics of ``x`` (one train-mode pass of the
    reference); returns the state the reference loads."""
    g = torch.Generator().manual_seed(seed + 1)
    for name, p in model.named_parameters():
        if ".conv_offset_mask." in name:
            scale = 2.0 / math.sqrt(p[0].numel()) if p.dim() > 1 else 1.0
            p.copy_(torch.randn(p.shape, generator=g) * scale)
        elif name.endswith(".bias") and ("bn" in name or "downsample.1" in name):
            p.fill_(2.0)
    ref = reference(model.state_dict())
    for m in ref.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    ref.train()
    ref(x)
    stats = {k: v for k, v in ref.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    model.load_state_dict(stats, strict=False)
    return model.state_dict()


def reference(state=None, **kw) -> plain.FCOS3D:
    model = plain.FCOS3D(transfer_dtype=kw.pop("transfer_dtype", torch.float32), **kw)
    if state is not None:
        model.load_state_dict(state)
    return model.eval()


def rms_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().square().mean().sqrt())


def test_the_reference_imports_neither_jax_nor_the_port():
    code = ("import sys, json; sys.path.insert(0, 'tests'); import plain_fcos3d; "
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
    assert list(ours) == list(theirs)
    assert 54e6 < sum(p.numel() for p in port.parameters()) < 56e6   # FCOS3D R-101: 55.0M
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("max_offset", [2, 4])
def test_trunk_fpn_and_head_match_the_reference(max_offset):
    x = images()
    port = build_model(config("TPU.DCN_FORCE_IMPL", "pallas3", "TPU.DCN_MAX_OFFSET",
                              str(max_offset)), device="cpu", seed=SEED)
    ref = reference(regime(port, x, SEED), max_offset=float(max_offset))
    with torch.no_grad():
        got, want = port(x), ref(x)
        xi = plain.F.pad(((x.float() / 255).flip(-1) - ref.mean) / ref.std, (0, 0, 0, 0, 0, 6))
        c_got = port.backbone(xi.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
        c_want = ref.backbone(xi.permute(0, 3, 1, 2).contiguous())
        p_got, p_want = port.fpn(c_got), ref.fpn(c_want)
    assert [tuple(m.shape) for m in got] == [(2, 31, 12, 20), (2, 31, 6, 10), (2, 31, 3, 5),
                                             (2, 31, 2, 3), (2, 31, 1, 2)]
    for name, a, b in ([("C", *ab) for ab in zip(c_got, c_want)]
                       + [("P", *ab) for ab in zip(p_got, p_want)]
                       + [("head", *ab) for ab in zip(got, want)]):
        assert rms_gap(a, b) < TOL, name


def test_a_bf16_forward_misses_the_tolerance():
    x = images()
    port = build_model(config("TPU.COMPUTE_DTYPE", "bfloat16"), device="cpu", seed=SEED)
    ref = reference(regime(port, x, SEED), transfer_dtype=torch.bfloat16)
    with torch.no_grad():
        got, want = port(x), ref(x)
    assert max(rms_gap(a, b) for a, b in zip(got, want)) > 10 * TOL


@torch.no_grad()
def test_the_decoder_keeps_the_references_boxes(monkeypatch):
    from monoflex_tpu_torch.decode import fcos3d as decode
    from monoflex_tpu_torch.models.heads.fcos3d import FIELDS as f

    # fewer candidates and rows than published, so the CPU's maps fill them
    monkeypatch.setattr(decode, "NMS_PRE", 100)
    monkeypatch.setattr(decode, "MAX_PER_IMG", 60)
    x = images(1)
    port = build_model(config(), device="cpu", seed=SEED)
    regime(port, x, SEED)
    head = port.heads["predictor"]
    head.conv_cls.bias.fill_(-1.5)          # many candidates above 0.05
    head.conv_regs[1].bias.fill_(math.log(20.0))
    maps = port(x)
    rows, valid, extras = decode.FCOS3DDecoder()(maps, {"cam_intrinsic": CAMS})
    want = plain.decode(maps, CAMS, nms_pre=100, max_per_img=60)
    assert torch.equal(extras["locations"], want["locations"])
    assert torch.equal(extras["candidates"], want["candidates"])
    n_pairs = int((want["candidates"][..., f["cls"]].sigmoid()
                   * want["candidates"][..., f["centerness"]].sigmoid() > 0.05).sum())
    for b in range(2):
        assert want["borderline"][b] == 0
        kept = extras["kept"][b][valid[b]]
        got = {(int(extras["locations"][b, n]), int(r[10])): r
               for n, r in zip(kept, rows[b][valid[b]])}
        assert set(got) == {(loc, c) for loc, c, _ in want["boxes"][b]}
        for loc, c, row in want["boxes"][b]:
            r = torch.tensor(row)
            gap = (got[loc, c] - r).abs() / (r.abs() + 1)
            gap[6] = (torch.remainder(got[loc, c][6] - r[6] + math.pi, 2 * math.pi)
                      - math.pi).abs()
            assert float(gap.max()) < 1e-5, (b, loc, c)
    # the NMS had work: more pairs above the threshold than boxes kept
    assert n_pairs > 1.5 * int(valid.sum()) and int(valid.sum()) > 20


def test_bev_iou_matches_the_reference():
    from monoflex_tpu_torch.ops.rotated_iou import bev_iou_pairs

    g = torch.Generator().manual_seed(3)
    n = 3000
    a = torch.cat([torch.rand(n, 2, generator=g) * 4, torch.rand(n, 2, generator=g) * 3 + 0.5,
                   torch.rand(n, 1, generator=g) * 6 - 3], 1).double()
    b = a + torch.cat([torch.randn(n, 2, generator=g) * 0.7,
                       torch.randn(n, 2, generator=g) * 0.3,
                       torch.randn(n, 1, generator=g) * 0.5], 1).double()
    b[:, 2:4] = b[:, 2:4].abs() + 0.1
    got = bev_iou_pairs(a, b)
    ref = plain.polygon_iou(plain.quad(a), plain.quad(b))
    assert float((got - ref).abs().max()) < 1e-10
    assert float((bev_iou_pairs(b, a) - ref).abs().max()) < 1e-10
    assert 0.05 < float((got > 0.5).double().mean()) and float(got.max()) <= 1.0
    assert torch.allclose(bev_iou_pairs(a[:5], a[:5]), torch.ones(5, dtype=torch.float64))


@pytest.mark.parametrize("a, b, want", [
    ((1, 2, 2, 1, 0.3), (1, 2, 2, 1, 0.3), 1.0),          # the same box
    ((1, 0.5, 2, 1, 0), (3, 0.5, 2, 1, 0), 0.0),          # touching along an edge
    ((1, 0.5, 2, 1, 0), (2, 0.5, 2, 1, 0), 1 / 3),        # two edges on the same lines
    ((1, 0.5, 2, 1, 0), (0.5, 0.5, 1, 1, 0), 0.5),        # inside, three edges shared
    ((0, 0, 4, 1, 0), (0, 0, 1, 4, 0), 1 / 7),            # a cross
], ids=["same", "touching", "collinear", "inside", "cross"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bev_iou_of_boxes_that_share_edges(a, b, want, dtype):
    """Edges that lie on one line count once in the boundary of the
    intersection, whichever box comes first."""
    from monoflex_tpu_torch.ops.rotated_iou import bev_iou_pairs

    a, b = torch.tensor([a], dtype=dtype), torch.tensor([b], dtype=dtype)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    assert abs(float(bev_iou_pairs(a, b)) - want) < tol
    assert abs(float(bev_iou_pairs(b, a)) - want) < tol


def test_training_entry_points_refuse_it():
    from monoflex_tpu_torch.losses.loss_computation import LossComputer
    from monoflex_tpu_torch.train.solver import build_optimizer
    from monoflex_tpu_torch.train.train_step import make_train_step

    cfg = config()
    model = build_model(cfg, device="cpu", seed=0)
    optimizer, _, _ = build_optimizer(cfg, model, 10)
    with pytest.raises(NotImplementedError, match="evaluation path only"):
        make_train_step(model, LossComputer(cfg), optimizer)


def test_build_errors_name_what_is_served():
    with pytest.raises(NotImplementedError, match="'dlav0_<name>', 'R-101'"):
        build_model(config("MODEL.BACKBONE.CONV_BODY", "R-18"), device="cpu")
    with pytest.raises(NotImplementedError, match="does not take"):
        build_model(config("MODEL.BACKBONE.CONV_BODY", "dla34"), device="cpu")
    with pytest.raises(NotImplementedError, match="does not take"):
        build_model(config("MODEL.META_ARCHITECTURE", "MonoFlex"), device="cpu")
    with pytest.raises(NotImplementedError, match="one of"):
        build_model(config("MODEL.META_ARCHITECTURE", "CenterNet"), device="cpu")


@pytest.mark.cuda
@torch.no_grad()
def test_graphed_forward_is_bit_equal_on_the_card():
    from monoflex_tpu_torch.ops import dcn_cuda
    from monoflex_tpu_torch.train.eval_graph import GraphedForward

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the DCN kernel and CUDA graphs have no CPU mode")
    cfg = config("TPU.COMPUTE_DTYPE", "bfloat16")
    model = build_model(cfg, device="cuda", seed=SEED)
    x = images().cuda()
    before = dcn_cuda.dcn_forward.launches
    eager = [m.clone() for m in model(x)]
    assert dcn_cuda.dcn_forward.launches - before == 36
    forward = GraphedForward(model)
    with torch.inference_mode():
        for _ in range(3):
            got = forward(x, None, None)
    for a, b in zip(got, eager):
        assert torch.equal(a, b)

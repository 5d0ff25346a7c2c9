"""The multi-scale deformable attention kernel (``ops/msda.py``,
``csrc/msda/msda_fwd.cu``) against its plain version, and BEVFormer's
graphed forward with its history, on the card (marked ``cuda``: they skip
without one).  Run there with ``python -m pytest tests/test_torch_msda_cuda.py
--noconftest -q``.

The kernel at BEVFormer-base's three shape families, with bf16 values (and
f32 ones, a float32 model's) and f32 locations and weights as the model
gives them, its output in the value's dtype: the spatial cross-attention (6 cameras' P3-P6 of a 928 x 1600
image, 40,000 cells, 8 points about 4 anchors, a visibility mask), the
temporal self-attention (2 BEV queues of 200 x 200, 4 points, their mean)
and the decoder (one BEV, 900 queries).  Both sum the same values in f32 in
other orders: the gap is a few f32 roundings of the output's size (``TOL``
of its RMS; a bf16 output one bf16 rounding).

The graphed forward: five calls (a scene start, two with history, a
scene start, one with history) replayed from one graph, each equal to the
eager forward from the same history, 18 kernel launches a call."""

import math

import pytest
import torch

TOL = 1e-5
SCA_SHAPES = [(116, 200), (58, 100), (29, 50), (15, 25)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def operands(G, shapes, Q, P, A, Go, Gw, masked, value_dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    S, H = sum(h * w for h, w in shapes), 8
    L = len(shapes)
    value = torch.randn(G, S, H, 32, device="cuda", generator=g).to(value_dtype)
    ref = torch.rand(G, Q, A, 2, device="cuda", generator=g) * 1.2 - 0.1
    offsets = torch.randn(Q, H, Go, L, P, 2, device="cuda", generator=g) * 3
    weights = torch.rand(Q, H, Gw, L, P, device="cuda", generator=g)
    weights = weights / weights.sum((-1, -2), keepdim=True)
    mask = (torch.rand(G, Q, device="cuda", generator=g) < 0.3) if masked else None
    return value, ref, offsets, weights, mask


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["sca", "tsa", "decoder"])
@pytest.mark.parametrize("value_dtype", [torch.bfloat16, torch.float32])
def test_the_kernel_matches_the_plain_op(card, family, value_dtype):
    from monoflex_tpu_torch.ops import msda

    if family == "sca":
        shapes, args = SCA_SHAPES, dict(G=6, Q=40000, P=8, A=4, Go=1, Gw=1, masked=True)
        scale = 1.0
    elif family == "tsa":
        shapes, args = [(200, 200)], dict(G=2, Q=40000, P=4, A=1, Go=2, Gw=2, masked=False)
        scale = 0.5
    else:
        shapes, args = [(200, 200)], dict(G=1, Q=900, P=4, A=1, Go=1, Gw=1, masked=False)
        scale = 1.0
    value, ref, offsets, weights, mask = operands(shapes=shapes, value_dtype=value_dtype, **args)
    before = msda.msda_forward.launches
    got = msda.msda_forward(value, shapes, ref, offsets, weights, mask, scale)
    torch.cuda.synchronize()
    assert msda.msda_forward.launches == before + 1
    assert got.dtype == value_dtype
    want = msda.msda_plain(value, shapes, ref, offsets, weights, mask, scale, torch.float32)
    rms = want.square().mean().sqrt()
    tol = TOL if value_dtype == torch.float32 else 2 ** -8
    assert float((got.float() - want).abs().max() / rms) < tol * max(1.0, want.abs().max() / rms)
    assert torch.equal(got, msda.msda_forward(value, shapes, ref, offsets, weights, mask,
                                              scale))      # no atomics: bit-equal


@pytest.mark.cuda
def test_the_graphed_forward_carries_the_history(card):
    from monoflex_tpu_torch.config import get_cfg_defaults
    from monoflex_tpu_torch.decode.postprocessor import build_postprocessor
    from monoflex_tpu_torch.models.detector import build_model
    from monoflex_tpu_torch.ops import msda
    from monoflex_tpu_torch.train.train_step import make_eval_step
    from monoflex_tpu_torch.utils import trace

    cfg = get_cfg_defaults()
    cfg.merge_from_list(["MODEL.META_ARCHITECTURE", "BEVFormer", "MODEL.BACKBONE.CONV_BODY",
                         "R-101", "INPUT.PIXEL_MEAN", "[0.406, 0.456, 0.485]",
                         "INPUT.PIXEL_STD", f"[{1 / 255!r}, {1 / 255!r}, {1 / 255!r}]",
                         "INPUT.TO_BGR", "True", "DATALOADER.SIZE_DIVISIBILITY", "32",
                         "TPU.COMPUTE_DTYPE", "bfloat16"])
    model = build_model(cfg, device="cuda", seed=3)
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randint(0, 256, (6, 900, 1600, 3), device="cuda", generator=g,
                           dtype=torch.uint8)
    l2i = torch.eye(4, device="cuda").repeat(6, 1, 1)
    for n in range(6):
        a = math.radians(60.0 * n)
        rot = torch.tensor([[math.cos(a), math.sin(a), 0.0], [0.0, 0.0, -1.0],
                            [-math.sin(a), math.cos(a), 0.0]], device="cuda")
        K = torch.tensor([[1266.0, 0.0, 800.0], [0.0, 1266.0, 450.0], [0.0, 0.0, 1.0]],
                         device="cuda")
        l2i[n, :3, :3] = K @ rot
    starts = [True, False, False, True, False]

    def bus(i):
        c = torch.zeros(18, device="cuda")
        c[0], c[1], c[16], c[17] = 2.0 + i, 0.5, 0.1 * i, 1.5 * i
        return c

    # eager, from an empty history
    eager = []
    model.prev_bev.zero_()
    with torch.inference_mode():
        for i, s in enumerate(starts):
            eager.append({k: v.clone() for k, v in
                          model(images, l2i, bus(i), torch.tensor([s], device="cuda")).items()})
    model.prev_bev.zero_()
    step = make_eval_step(model, build_postprocessor(cfg))
    trace.drain()
    trace.on()
    before = msda.msda_forward.launches
    try:
        for i, s in enumerate(starts):
            rows, valid, extras = step({"image": images, "lidar2img": l2i, "can_bus": bus(i),
                                        "scene_start": torch.tensor([s], device="cuda")})
            for k in ("bev", "cls", "boxes"):
                assert torch.allclose(extras[k].float(), eager[i][k].float(), rtol=0,
                                      atol=1e-3 * float(eager[i][k].float().abs().max())), (i, k)
    finally:
        trace.off()
    counters = trace.drain().counters
    assert msda.msda_forward.launches - before == 18 * len(starts)
    assert counters["eval_step.graph_captures"] == 1
    assert counters["eval_step.graph_replays"] == len(starts) - 1
    assert counters["bev.scene_starts"] == 2 and counters["bev.history_used"] == 3

"""The eval forward as CUDA graphs (``train/eval_graph.py``), on the narrow
model of the other eval tests (channels (8, 8, 16, 24, 32, 48), 64x128).

On the CPU: the signature a graph is kept under, and that a CPU model never
captures and returns what the plain forward and decode return.  On the card
(``cuda``-marked; ``--noconftest``, since the test conftest imports jax):
    python -m pytest tests/test_torch_eval_graph.py --noconftest -q
the replay against the eager forward and decode, bit for bit: at batch 1
and 8, f32 and bf16, edge fusion on; after an in-place weight change; from
a model left in training mode; over
a second signature and past ``MAX_GRAPHS``; with a returned heatmap kept
across the next call; the counters; a capture that fails.
"""

import dataclasses
import logging
import os

import pytest
import torch

from monoflex_tpu_torch.config import get_cfg_defaults
from monoflex_tpu_torch.data.synthetic import make_inference_batch
from monoflex_tpu_torch.decode.postprocessor import PostProcessor
from monoflex_tpu_torch.models.backbone.dla import DCN, DLASeg, resolve_dcn_specs
from monoflex_tpu_torch.models.detector import MonoFlex, init_parameters
from monoflex_tpu_torch.models.heads.predictor import build_predictor
from monoflex_tpu_torch.models.layers import set_compute_dtype
from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.train import eval_graph, graphs
from monoflex_tpu_torch.train.eval_graph import GraphedForward, graphable, signature
from monoflex_tpu_torch.train.solver import ParamEma, ema_params
from monoflex_tpu_torch.train.train_step import make_eval_step
from monoflex_tpu_torch.utils import trace
from monoflex_tpu_torch.utils.precision import resolve_precision

RUNS = os.path.join(os.path.dirname(__file__), "..", "runs")
NARROW_CHANNELS = (8, 8, 16, 24, 32, 48)
STAGE_R = (2, 1, 1, 1)
H, W = 64, 128
COUNTERS = ("eval_step.graph_captures", "eval_step.graph_replays", "eval_step.graph_fallbacks")


def narrow_cfg(yaml="monoflex.yaml"):
    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(RUNS, yaml))
    cfg.MODEL.HEAD.NUM_CHANNEL = 16
    cfg.TPU.DCN_FORCE_IMPL = "pallas3b" if "bf16" in yaml else "pallas3"
    cfg.TPU.DCN_MAX_OFFSET_PER_STAGE = STAGE_R
    return cfg


@torch.no_grad()
def narrow_model(cfg, device="cpu", seed=0):
    """The narrow model with deforming offsets and its heatmap spread over
    (0, 1) (at init every peak sits near 0.01), in the config's compute
    dtype and precision flags."""
    model = MonoFlex(DLASeg(resolve_dcn_specs(cfg), channels=NARROW_CHANNELS),
                     build_predictor(cfg, in_channels=NARROW_CHANNELS[2]))
    g = torch.Generator().manual_seed(seed)
    init_parameters(model, g)
    for m in model.modules():
        if isinstance(m, DCN):
            w = m.conv_offset_mask.weight
            w.copy_(torch.randn(w.shape, generator=g) * 0.2 / w[0].numel() ** 0.5)
    out = model.heads["predictor"].class_head[2]
    out.weight.mul_(40)
    out.bias.copy_(torch.tensor([-1.0, -1.5, -2.0]))
    if cfg.TPU.COMPUTE_DTYPE == "bfloat16":
        set_compute_dtype(model.backbone, torch.bfloat16)
    model.precision = resolve_precision(cfg)
    return model.to(device, memory_format=torch.channels_last).eval()


def inputs(batch_size, device="cpu", seed=0):
    """A batch of the inference fields (uint8 images, the edge chain padded
    to its full length, the camera fields)."""
    return {k: torch.from_numpy(v).to(device) for k, v in
            make_inference_batch(batch_size, H, W, seed=seed).items()}


def args(batch):
    return batch["image"], batch.get("edge_indices"), batch.get("edge_len")


def eager(model, post, batch):
    """The forward and decode as they run without graphs."""
    with torch.inference_mode():
        model.eval()
        return post(model(*args(batch)), batch)


def assert_same(got, want):
    """Bit-equal rows, valid and extras."""
    (rows, valid, extras), (wrows, wvalid, wextras) = got, want
    assert torch.equal(rows, wrows) and torch.equal(valid, wvalid)
    assert sorted(extras) == sorted(wextras)
    for k in extras:
        assert torch.equal(extras[k], wextras[k]), k


@pytest.fixture(scope="module")
def cpu_model():
    return narrow_model(narrow_cfg())


# ---------------------------------------------------------------------------
# the signature, on the CPU


def key(model, batch):
    with torch.inference_mode():
        return signature(model, args(batch))


def _batch_of_one(model, batch):
    return inputs(1)


def _float_image(model, batch):
    return {**batch, "image": batch["image"].float()}


def _no_edges(model, batch):
    return {k: v for k, v in batch.items() if k not in ("edge_indices", "edge_len")}


def _wider_edges(model, batch):
    return {**batch, "edge_indices": batch["edge_indices"].long()}


def _dcn_spec(model, batch):
    dcn = next(m for m in model.modules() if isinstance(m, DCN))
    dcn.spec = dataclasses.replace(dcn.spec, max_offset=dcn.spec.max_offset + 1)
    return batch


def _replaced_parameter(model, batch):
    conv = model.heads["predictor"].class_head[2]
    conv.weight = torch.nn.Parameter(conv.weight.detach().clone())
    return batch


def _replaced_data(model, batch):
    bn = next(m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm))
    bn.running_var.data = bn.running_var.data.clone()
    return batch


@pytest.mark.parametrize("change", [_batch_of_one, _float_image, _no_edges, _wider_edges,
                                    _dcn_spec, _replaced_parameter, _replaced_data])
def test_a_new_signature(change):
    model = narrow_model(narrow_cfg())
    batch = inputs(2)
    before = key(model, batch)
    assert key(model, change(model, batch)) != before


def _same_batch_anew(model, batch):
    return inputs(2, seed=1)


def _copied_weights(model, batch):
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p * 0.5)
    return batch


def _loaded_state(model, batch):
    model.load_state_dict(narrow_model(narrow_cfg(), seed=3).state_dict())
    return batch


@pytest.mark.parametrize("change", [_same_batch_anew, _copied_weights, _loaded_state])
def test_the_same_signature(change):
    model = narrow_model(narrow_cfg())
    batch = inputs(2)
    before = key(model, batch)
    assert key(model, change(model, batch)) == before


def test_the_same_signature_under_ema_params(cpu_model):
    batch = inputs(2)
    before = key(cpu_model, batch)
    ema = ParamEma(cpu_model, 0.9)
    with ema_params(cpu_model, ema):
        assert key(cpu_model, batch) == before
    assert key(cpu_model, batch) == before


def test_a_forward_hook_leaves_the_call_eager(cpu_model):
    batch = inputs(2)
    handle = cpu_model.backbone.register_forward_hook(lambda *a: None)
    try:
        assert key(cpu_model, batch) is None
    finally:
        handle.remove()
    assert key(cpu_model, batch) is not None


def test_a_cpu_model_never_captures(cpu_model):
    post = PostProcessor(narrow_cfg())
    batch = inputs(2)
    with torch.inference_mode():
        assert not graphable(args(batch))
    want = eager(cpu_model, post, batch)
    forward = GraphedForward(cpu_model)
    trace.drain()
    trace.on()
    try:
        step = make_eval_step(cpu_model, post)
        for _ in range(3):
            cpu_model.train()
            assert_same(step(batch), want)
            assert not any(m.training for m in cpu_model.modules())
            with torch.inference_mode():
                out = forward(*args(batch))
        assert torch.equal(out["cls"], want[2]["heatmap"])
    finally:
        trace.off()
        counters = trace.drain().counters
    assert not forward.cache.graphs
    assert not any(c in counters for c in COUNTERS)


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.benchmark)
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.benchmark) = flags


@pytest.fixture
def counted():
    """The tracer on for the test; yields a function that drains it."""
    trace.drain()
    trace.on()
    yield lambda: trace.drain().counters
    trace.off()
    trace.drain()


def card_step(device, yaml="monoflex.yaml"):
    cfg = narrow_cfg(yaml)
    model = narrow_model(cfg, device)
    post = PostProcessor(cfg)
    return model, post, make_eval_step(model, post)


@pytest.mark.cuda
@pytest.mark.parametrize("yaml", ["monoflex.yaml", "monoflex_bf16.yaml"])
@pytest.mark.parametrize("batch_size", [1, 8])
def test_replay_is_bit_equal_to_eager(device, counted, yaml, batch_size):
    model, post, step = card_step(device, yaml)
    assert model.heads["predictor"].enable_edge_fusion
    batch = inputs(batch_size, device)
    want = eager(model, post, batch)
    for _ in range(4):             # eager, capture and replay, replays
        assert_same(step(batch), want)
    assert counted() == {"eval_step.graph_captures": 1, "eval_step.graph_replays": 3}


@pytest.mark.cuda
def test_replay_reads_weights_changed_in_place(device):
    model, post, step = card_step(device)
    batch = inputs(2, device)
    for _ in range(2):
        step(batch)
    ema = ParamEma(model, 0.9)
    with torch.no_grad():
        for s in ema.shadow.values():
            s.mul_(0.9)
    with ema_params(model, ema):
        want = eager(model, post, batch)
        assert_same(step(batch), want)
    assert not torch.equal(step(batch)[0], want[0])
    assert_same(step(batch), eager(model, post, batch))


@pytest.mark.cuda
def test_a_model_left_training_is_put_in_eval_mode(device, counted):
    model, post, step = card_step(device)
    batch = inputs(2, device)
    want = eager(model, post, batch)
    for _ in range(3):
        model.train()
        assert_same(step(batch), want)
        assert not any(m.training for m in model.modules())
    assert counted() == {"eval_step.graph_captures": 1, "eval_step.graph_replays": 2}


@pytest.mark.cuda
def test_a_second_signature_captures_a_second_graph(device, counted):
    model, post, step = card_step(device)
    big, small = inputs(8, device), inputs(3, device, seed=1)
    want = {8: eager(model, post, big), 3: eager(model, post, small)}
    for batch in (big, big, small, small, big, small):
        assert_same(step(batch), want[batch["image"].shape[0]])
    assert counted() == {"eval_step.graph_captures": 2, "eval_step.graph_replays": 4}


@pytest.mark.cuda
def test_at_most_max_graphs_are_kept(device):
    model = narrow_model(narrow_cfg(), device)
    forward = GraphedForward(model)
    batches = [inputs(b, device) for b in range(1, eval_graph.MAX_GRAPHS + 2)]
    with torch.inference_mode():
        for batch in batches:
            for _ in range(2):
                forward(*args(batch))
        kept = [k[0][0][0][0] for k, v in forward.cache.graphs.items()]
        assert kept == [b["image"].shape[0] for b in batches[1:]]
        assert all(isinstance(v, graphs.Graph) for v in forward.cache.graphs.values())
        out = forward(*args(batches[0]))          # dropped: eager again
        assert not isinstance(forward.cache.graphs[key(model, batches[0])], graphs.Graph)
        assert torch.equal(out["cls"], model(*args(batches[0]))["cls"])


@pytest.mark.cuda
def test_a_returned_heatmap_outlives_the_next_call(device):
    model, post, step = card_step(device)
    a, b = inputs(2, device), inputs(2, device, seed=1)
    want = eager(model, post, a)
    for _ in range(2):
        step(a)
    rows, valid, extras = step(a)
    step(b)
    assert_same((rows, valid, extras), want)


@pytest.mark.cuda
def test_dcn_launches_count_one_forward_a_call(device):
    model, post, step = card_step(device)
    batch = inputs(2, device)
    before = dcn_cuda.dcn_forward.launches
    eager(model, post, batch)
    per_forward = dcn_cuda.dcn_forward.launches - before
    assert per_forward == 16
    before = dcn_cuda.dcn_forward.launches
    for _ in range(5):
        step(batch)
    assert dcn_cuda.dcn_forward.launches - before == 5 * per_forward


@pytest.mark.cuda
def test_a_capture_that_fails_leaves_the_signature_eager(device, counted, caplog):
    model, post, step = card_step(device)
    predictor = model.heads["predictor"]
    plain = predictor.forward

    def syncs(features, *rest):
        float(features.float().sum())        # waits for the card: no capture
        return plain(features, *rest)

    predictor.forward = syncs
    batch = inputs(2, device)
    want = eager(model, post, batch)
    with caplog.at_level(logging.WARNING, logger="monoflex.eval_graph"):
        for _ in range(4):
            assert_same(step(batch), want)
    assert counted() == {"eval_step.graph_fallbacks": 1}
    assert sum("capture failed" in r.getMessage() for r in caplog.records) == 1
    assert_same(eager(model, post, batch), want)

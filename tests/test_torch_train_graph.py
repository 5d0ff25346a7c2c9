"""The training step as CUDA graphs (``train/train_graph.py``), on the narrow
model of ``test_torch_eval_graph.py`` (channels (8, 8, 16, 24, 32, 48),
64x128, batch 2, edge fusion on).

On the CPU: the signature a graph is kept under, and that a CPU model never
captures and returns what the eager step returns.  On the card
(``cuda``-marked; ``--noconftest``, since the test conftest imports jax):
    python -m pytest tests/test_torch_train_graph.py --noconftest -q
five graphed calls against five eager steps, bit for bit in the metrics,
the parameters, the moments, the BN buffers, the EMA and the optimizer's
counters: in f32 and bf16; with the LR changing between replays (warm-up,
one-cycle) and the EMA on; with a non-finite step among them; after a
parameter written in place (a replay) or replaced (a recapture); a capture
that fails; and the calls that stay eager (world size above 1, hooks, an
optimizer without a device update).  torch's deterministic algorithms are
on there, and cuDNN's autotune off, so that two eager steps repeat.
"""

import logging
from types import SimpleNamespace

import pytest
import torch
from torch import nn

from monoflex_tpu_torch.data.synthetic import make_train_batch
from monoflex_tpu_torch.losses.loss_computation import LossComputer
from monoflex_tpu_torch.models.backbone.dla import DCN
from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.train import train_graph
from monoflex_tpu_torch.train.solver import build_optimizer, ema_params
from monoflex_tpu_torch.train.train_graph import TrainGraphs, graphable, signature
from monoflex_tpu_torch.train.train_step import TrainState, make_train_step
from monoflex_tpu_torch.utils import trace
from test_torch_eval_graph import H, W, narrow_cfg, narrow_model

B = 2
CALLS = 5
LAUNCHES = [(f, "launches") for f in (dcn_cuda.dcn_forward, dcn_cuda.dcn_bwd_dx,
                                      dcn_cuda.dcn_bwd_dwmo)]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the test workers share the machine's cores, and
    more threads than cores makes each parallel region wait for spinning
    threads of other processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def train_cfg(yaml="monoflex.yaml", **solver):
    cfg = narrow_cfg(yaml)
    cfg.CUDNN_BENCHMARK = False
    cfg.SOLVER.EVAL_AND_SAVE_EPOCH = False
    cfg.SOLVER.MAX_ITERATION = 10
    for k, v in solver.items():
        setattr(cfg.SOLVER, k, v)
    return cfg


def batch_of(device="cpu", seed=0):
    return {k: torch.from_numpy(v).to(device)
            for k, v in make_train_batch(B, H, W, seed=seed).items()}


def trainer(cfg, device="cpu"):
    """(model, optimizer, make_train_step's step)."""
    model = narrow_model(cfg, device)
    optimizer = build_optimizer(cfg, model)[0]
    return model, optimizer, make_train_step(model, LossComputer(cfg), optimizer)


def stepped(cfg, device="cpu"):
    """A trainer after one step: its optimizer has moments."""
    model, optimizer, step = trainer(cfg, device)
    step(TrainState(), batch_of(device))
    return model, optimizer, step


def same(x, y):
    """Bit-equal up to NaN payloads."""
    nan = x.isnan()
    return (x.dtype == y.dtype and torch.equal(nan, y.isnan())
            and torch.equal(x.masked_fill(nan, 0), y.masked_fill(nan, 0)))


def assert_same_metrics(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert same(got[k], v), k
        else:
            assert got[k] == v, k


def assert_same_state(a, opt_a, b, opt_b):
    """Bit-equal parameters, buffers, moments, EMA and counters."""
    for (n, x), (_, y) in zip(list(a.named_parameters()) + list(a.named_buffers()),
                              list(b.named_parameters()) + list(b.named_buffers())):
        assert torch.equal(x, y), n
    assert opt_a.count == opt_b.count
    for pa, pb in zip(opt_a.params, opt_b.params):
        sa, sb = opt_a.inner.state.get(pa, {}), opt_b.inner.state.get(pb, {})
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for ga, gb in zip(opt_a.inner.param_groups, opt_b.inner.param_groups):
        assert (ga["lr"], ga.get("betas")) == (gb["lr"], gb.get("betas"))
    if opt_a.ema is not None:
        assert opt_a.ema.count == opt_b.ema.count
        for n, s in opt_a.ema.shadow.items():
            assert torch.equal(s, opt_b.ema.shadow[n]), n


# ---------------------------------------------------------------------------
# the signature, on the CPU


def _batch_of_three(model, opt, batch):
    return {k: torch.cat([v, v[:1]]) for k, v in batch.items()}


def _more_objects(model, opt, batch):
    return {**batch, "reg_mask": torch.cat([batch["reg_mask"]] * 2, dim=1)}


def _no_edges(model, opt, batch):
    return {k: v for k, v in batch.items() if k not in ("edge_indices", "edge_len")}


def _wider_target(model, opt, batch):
    return {**batch, "cls_ids": batch["cls_ids"].long()}


def _dcn_spec(model, opt, batch):
    import dataclasses

    dcn = next(m for m in model.modules() if isinstance(m, DCN))
    dcn.spec = dataclasses.replace(dcn.spec, max_offset=dcn.spec.max_offset + 1)
    return batch


def replace_parameter(model, opt):
    """The class head's weight replaced by a copy, in the model and in the
    optimizer, with its moments."""
    conv = model.heads["predictor"].class_head[2]
    old = conv.weight
    new = conv.weight = nn.Parameter(old.detach().clone())
    opt.params = [new if p is old else p for p in opt.params]
    for g in opt.inner.param_groups:
        g["params"] = [new if p is old else p for p in g["params"]]
    opt.inner.state[new] = opt.inner.state.pop(old)


def _replaced_parameter(model, opt, batch):
    replace_parameter(model, opt)
    return batch


def _replaced_buffer(model, opt, batch):
    bn = next(m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm))
    bn.running_var.data = bn.running_var.data.clone()
    return batch


def _replaced_moments(model, opt, batch):
    state = opt.inner.state[opt.params[0]]
    state["exp_avg"] = state["exp_avg"].clone()
    return batch


def _clip(model, opt, batch):
    opt.grad_clip = 1.0
    return batch


def _eps(model, opt, batch):
    opt.inner.param_groups[0]["eps"] = 1e-6
    return batch


@pytest.mark.parametrize("change", [_batch_of_three, _more_objects, _no_edges, _wider_target,
                                    _dcn_spec, _replaced_parameter, _replaced_buffer,
                                    _replaced_moments, _clip, _eps])
def test_a_new_signature(change):
    model, opt, _ = stepped(train_cfg())
    batch = batch_of()
    before = signature(model, opt, batch)
    assert before is not None
    assert signature(model, opt, change(model, opt, batch)) != before


def _batch_anew(model, opt, batch):
    return batch_of(seed=1)


def _weights_in_place(model, opt, batch):
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    return batch


def _loaded_model(model, opt, batch):
    model.load_state_dict(narrow_model(train_cfg(), seed=3).state_dict())
    return batch


def _a_count(model, opt, batch):
    opt.count += 7
    return batch


def _eval_mode(model, opt, batch):
    model.eval()
    return batch


@pytest.mark.parametrize("change", [_batch_anew, _weights_in_place, _loaded_model, _a_count,
                                    _eval_mode])
def test_the_same_signature(change):
    model, opt, _ = stepped(train_cfg())
    batch = batch_of()
    before = signature(model, opt, batch)
    assert signature(model, opt, change(model, opt, batch)) == before


def test_the_same_signature_under_ema_params():
    model, opt, _ = stepped(train_cfg(EMA_DECAY=0.9))
    batch = batch_of()
    before = signature(model, opt, batch)
    with ema_params(model, opt.ema):
        assert signature(model, opt, batch) == before
    assert signature(model, opt, batch) == before


def test_no_signature_before_the_first_step():
    model, opt, _ = trainer(train_cfg())
    assert signature(model, opt, batch_of()) is None


@pytest.mark.parametrize("hook", ["forward", "backward", "gradient", "accumulated"])
def test_a_hook_leaves_the_step_without_signature(hook):
    model, opt, _ = stepped(train_cfg())
    batch = batch_of()
    head = model.heads["predictor"]
    weight = head.class_head[2].weight
    handle = {"forward": lambda: head.register_forward_hook(lambda *a: None),
              "backward": lambda: head.register_full_backward_hook(lambda *a: None),
              "gradient": lambda: weight.register_hook(lambda g: g),
              "accumulated": lambda: weight.register_post_accumulate_grad_hook(
                  lambda p: None)}[hook]()
    assert signature(model, opt, batch) is None
    handle.remove()
    assert signature(model, opt, batch) is not None


def test_a_cpu_model_never_captures():
    cfg = train_cfg()
    a, opt_a, step_a = trainer(cfg)
    b, opt_b, step_b = trainer(cfg)
    assert isinstance(step_b, TrainGraphs) and not graphable(b, batch_of())
    trace.drain()
    trace.on()
    try:
        sa = sb = TrainState()
        for i in range(3):
            sa, ma = step_a.eager(sa, batch_of(seed=i))
            sb, mb = step_b(sb, batch_of(seed=i))
            assert sa == sb
            assert_same_metrics(mb, ma)
        assert_same_state(a, opt_a, b, opt_b)
    finally:
        trace.off()
        counters = trace.drain().counters
    assert not step_b.cache.graphs
    assert not any(c.startswith("train_step.graph") for c in counters)


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def device(monkeypatch):
    """The card, with torch's deterministic algorithms (the edge fusion's
    accumulating scatter and the gathers' backward otherwise add with
    atomics, and two eager steps differ in the last bits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield torch.device("cuda")
    torch.use_deterministic_algorithms(False)
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic) = flags


@pytest.fixture
def counted():
    """The tracer on for the test; yields a function that drains it."""
    trace.drain()
    trace.on()
    yield lambda: {k: v for k, v in trace.drain().counters.items()
                   if k.startswith("train_step.graph")}
    trace.off()
    trace.drain()


def pair(cfg, device):
    """Two trainers from one seed: the eager step of the first, the step of
    the second."""
    a, opt_a, step_a = trainer(cfg, device)
    b, opt_b, step_b = trainer(cfg, device)
    return (a, opt_a, step_a.eager), (b, opt_b, step_b)


def drive(eager, graphed, batches, between=None):
    """Each batch through both; bit-equal after every call, the DCN kernels'
    launches included."""
    (a, opt_a, step_a), (b, opt_b, step_b) = eager, graphed
    sa = sb = TrainState()
    out = []
    for i, batch in enumerate(batches):
        if between is not None:
            between(i)
        before = [getattr(f, c) for f, c in LAUNCHES]
        sa, ma = step_a(sa, batch)
        mid = [getattr(f, c) for f, c in LAUNCHES]
        sb, mb = step_b(sb, batch)
        after = [getattr(f, c) for f, c in LAUNCHES]
        assert [m - x for m, x in zip(mid, before)] == [x - m for x, m in zip(after, mid)], i
        assert sa == sb, i
        assert_same_metrics(mb, ma)
        assert_same_state(a, opt_a, b, opt_b)
        out.append(mb)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("yaml", ["monoflex.yaml", "monoflex_bf16.yaml"])
def test_replays_are_bit_equal_to_eager_steps(device, counted, yaml):
    eager, graphed = pair(train_cfg(yaml), device)
    assert graphed[0].heads["predictor"].enable_edge_fusion
    drive(eager, graphed, [batch_of(device, seed=i) for i in range(CALLS)])
    assert counted() == {"train_step.graph_captures": 1, "train_step.graph_replays": CALLS - 1}
    assert all(p.grad is not None for p in graphed[0].parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("solver", [
    {"OPTIMIZER": "adamw", "LR_WARMUP": True, "WARMUP_STEPS": 4, "EMA_DECAY": 0.9},
    {"OPTIMIZER": "adam_onecycle", "EMA_DECAY": 0.99},
    {"OPTIMIZER": "adam", "GRAD_NORM_CLIP": 0.5, "STEPS": (3,)},
], ids=["warmup_ema", "onecycle", "adam_clip_decay"])
def test_per_step_values_come_from_the_card(device, counted, solver):
    eager, graphed = pair(train_cfg(**solver), device)
    lrs = []
    drive(eager, graphed, [batch_of(device, seed=i) for i in range(CALLS)],
          between=lambda i: lrs.append(graphed[1].inner.param_groups[0]["lr"]))
    assert len(set(lrs[1:])) > 1             # the LR moved between replays
    assert counted() == {"train_step.graph_captures": 1, "train_step.graph_replays": CALLS - 1}


@pytest.mark.cuda
def test_a_nonfinite_step_skips_as_the_eager_step_does(device, counted):
    eager, graphed = pair(train_cfg(EMA_DECAY=0.9), device)
    batches = [batch_of(device, seed=i) for i in range(CALLS)]
    bad = batches[2]["locations"].clone()
    bad[0, 0, 2] = float("nan")                  # a valid object's depth
    batches[2] = {**batches[2], "locations": bad}
    model, opt, step = graphed
    kept = {}

    def between(i):
        if i == 2:
            kept.update({n: t.clone() for n, t in model.state_dict().items()})
            kept["count"] = opt.count
    out = drive(eager, graphed, batches, between)
    assert [m["skipped"] for m in out] == [0.0, 0.0, 1.0, 0.0, 0.0]
    assert [m["consecutive_skips"] for m in out] == [0.0, 0.0, 1.0, 0.0, 0.0]
    assert counted() == {"train_step.graph_captures": 1, "train_step.graph_replays": CALLS - 1}
    # and the skipped step changed nothing: rerun the first three calls
    model2, opt2, step2 = trainer(train_cfg(EMA_DECAY=0.9), device)
    state = TrainState()
    for batch in batches[:3]:
        state, _ = step2(state, batch)
    assert state == TrainState(step=3, skips=1)
    assert opt2.count == kept["count"] == 2
    for n, t in model2.state_dict().items():
        assert torch.equal(t, kept[n]), n


@pytest.mark.cuda
def test_a_parameter_written_in_place_replays(device, counted):
    eager, graphed = pair(train_cfg(), device)

    def halve(i):
        if i == 3:
            with torch.no_grad():
                for m in (eager[0], graphed[0]):
                    m.heads["predictor"].class_head[2].weight.mul_(0.5)
    drive(eager, graphed, [batch_of(device, seed=i) for i in range(CALLS)], halve)
    assert counted() == {"train_step.graph_captures": 1, "train_step.graph_replays": CALLS - 1}


@pytest.mark.cuda
def test_a_parameter_replaced_recaptures(device, counted):
    eager, graphed = pair(train_cfg(), device)

    def replace(i):
        if i == 2:
            for model, opt, _ in (eager, graphed):
                replace_parameter(model, opt)
    drive(eager, graphed, [batch_of(device, seed=i) for i in range(CALLS)], replace)
    # eager, capture; eager (a new signature), capture, replay
    assert counted() == {"train_step.graph_captures": 2, "train_step.graph_replays": 3}
    assert len(graphed[2].cache.graphs) == 2


@pytest.mark.cuda
def test_a_capture_that_fails_leaves_the_signature_eager(device, counted, caplog):
    eager, graphed = pair(train_cfg(), device)
    predictor = graphed[0].heads["predictor"]
    plain = predictor.forward

    def syncs(features, *rest):
        float(features.float().sum())        # waits for the card: no capture
        return plain(features, *rest)

    predictor.forward = syncs
    with caplog.at_level(logging.WARNING, logger="monoflex.train_graph"):
        drive(eager, graphed, [batch_of(device, seed=i) for i in range(CALLS)])
    assert counted() == {"train_step.graph_fallbacks": 1}
    assert sum("capture failed" in r.getMessage() for r in caplog.records) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["world", "hook", "sgd"])
def test_steps_that_stay_eager(device, counted, caplog, monkeypatch, case):
    solver = {"OPTIMIZER": "sgd"} if case == "sgd" else {}
    eager, graphed = pair(train_cfg(**solver), device)
    if case == "world":
        monkeypatch.setattr(train_graph, "comm", SimpleNamespace(get_world_size=lambda: 2))
        assert not graphable(graphed[0], batch_of(device))
    if case == "hook":
        for model, _, _ in (eager, graphed):
            model.backbone.register_forward_hook(lambda *a: None)
    with caplog.at_level(logging.WARNING, logger="monoflex.train_graph"):
        drive(eager, graphed, [batch_of(device, seed=i) for i in range(CALLS)])
    assert not graphed[2].cache.graphs
    want = {"train_step.graph_fallbacks": 1} if case == "sgd" else {}
    assert counted() == want
    assert sum("no device update" in r.getMessage() for r in caplog.records) == len(want)

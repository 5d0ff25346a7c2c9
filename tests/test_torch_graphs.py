"""The CUDA-graph cache that the eval forward and the training step share
(``train/graphs.py``), on the CPU with no model: ``torch.cuda``'s stream,
graph and capture are replaced by stand-ins that record what runs where,
and the capture function is a fake that bumps the DCN launch counters.

Covered: seen -> capture -> replay, the LRU at ``max_graphs``, a capture
that raises (eager from then on, one fallback counted, one warning logged),
the launch counters put back after a capture, failed or not, and one
call's launches added per replay."""

import contextlib
import logging

import pytest
import torch

from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.train import graphs
from monoflex_tpu_torch.train.graphs import EAGER, SEEN, Graph, GraphCache
from monoflex_tpu_torch.utils import trace

CPU = torch.device("cpu")
logger = logging.getLogger("monoflex.test_graphs")


class _Stream:
    def __init__(self, device):
        self.device = device


class _CUDAGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _Entry(Graph):
    def __init__(self, arg):
        self.arg = arg


@pytest.fixture
def card(monkeypatch):
    """Stand-ins for the stream, the graph and the capture; yields a dict
    whose "capturing" is True inside a capture."""
    state = {"capturing": False, "streams": 0}

    def stream(device):
        state["streams"] += 1
        return _Stream(device)

    @contextlib.contextmanager
    def capture(graph, stream, capture_error_mode):
        assert isinstance(graph, _CUDAGraph) and isinstance(stream, _Stream)
        assert capture_error_mode == "thread_local"
        state["capturing"] = True
        try:
            yield
        finally:
            state["capturing"] = False

    monkeypatch.setattr(graphs.torch.cuda, "Stream", stream)
    monkeypatch.setattr(graphs.torch.cuda, "CUDAGraph", _CUDAGraph)
    monkeypatch.setattr(graphs.torch.cuda, "graph", capture)
    trace.off()
    trace.drain()
    trace.on()
    yield state
    trace.off()
    trace.drain()


def launches():
    return dcn_cuda.dcn_forward.launches, dcn_cuda.dcn_bwd_dx.launches


def fake(card, warm_up=0, per_call=0, fail=None):
    """(prepare, record): prepare launches ``warm_up`` forwards outside the
    capture, record ``per_call`` forwards and one dx inside it, then raises
    ``fail`` if given."""
    def prepare(stream, arg):
        assert not card["capturing"] and isinstance(stream, _Stream)
        dcn_cuda.dcn_forward.launches += warm_up
        return arg

    def record(arg):
        assert card["capturing"]
        dcn_cuda.dcn_forward.launches += per_call
        dcn_cuda.dcn_bwd_dx.launches += 1
        if fail is not None:
            raise fail
        return _Entry(arg)
    return prepare, record


def test_seen_capture_replay(card):
    cache = GraphCache("t", 2, logger)
    prepare, record = fake(card)
    assert cache.get("a") is None
    cache.seen("a")
    assert cache.get("a") is SEEN
    entry = cache.capture("a", CPU, prepare, record, "x")
    assert isinstance(entry, _Entry) and entry.arg == "x"
    assert isinstance(entry.graph, _CUDAGraph) and entry.graph.replays == 0
    assert cache.get("a") is entry
    for n in range(1, 4):
        cache.replay(entry)
        assert entry.graph.replays == n
    cache.seen("a")                      # a kept key stays as it is
    assert cache.get("a") is entry
    cache.seen(None)                     # a call without a key is never kept
    assert cache.get(None) is None and list(cache.graphs) == ["a"]
    assert trace.drain().counters == {"t.graph_captures": 1, "t.graph_replays": 3}


def test_one_side_stream_a_device(card):
    cache = GraphCache("t", 4, logger)
    prepare, record = fake(card)
    for key in "abc":
        cache.capture(key, CPU, prepare, record, key)
    assert card["streams"] == 1
    cache.capture("d", torch.device("meta"), prepare, record, "d")
    assert card["streams"] == 2


def test_lru_drops_the_least_recently_used(card):
    cache = GraphCache("t", 2, logger)
    prepare, record = fake(card)
    cache.seen("a")
    cache.seen("b")
    assert cache.get("a") is SEEN        # a is now the most recently used
    cache.seen("c")
    assert list(cache.graphs) == ["a", "c"]
    cache.capture("b", CPU, prepare, record, "b")
    assert list(cache.graphs) == ["c", "b"]
    assert cache.get("a") is None        # dropped: eager, then seen again


def test_a_capture_that_raises_leaves_the_signature_eager(card, caplog):
    cache = GraphCache("t", 4, logger)
    with caplog.at_level(logging.WARNING, logger=logger.name):
        for key, fail in (("a", RuntimeError("waits for the card")), ("b", ValueError("no"))):
            prepare, record = fake(card, fail=fail)
            assert cache.capture(key, CPU, prepare, record, key) is EAGER
            assert cache.get(key) is EAGER
    assert trace.drain().counters == {"t.graph_fallbacks": 2}
    warnings = [r.getMessage() for r in caplog.records if r.name == logger.name]
    assert len(warnings) == 1 and "capture failed (waits for the card)" in warnings[0]


def test_an_error_of_another_kind_is_raised(card):
    cache = GraphCache("t", 4, logger)
    prepare, record = fake(card, fail=KeyError("bug"))
    with pytest.raises(KeyError):
        cache.capture("a", CPU, prepare, record, "a")


def test_a_refusal_is_counted_without_a_key(card, caplog):
    cache = GraphCache("t", 4, logger)
    with caplog.at_level(logging.WARNING, logger=logger.name):
        cache.fall_back(None, "its optimizer has no device update (SGD)")
    assert not cache.graphs
    assert trace.drain().counters == {"t.graph_fallbacks": 1}
    assert [r.getMessage() for r in caplog.records if r.name == logger.name] == [
        "t runs eagerly: its optimizer has no device update (SGD)"]


@pytest.mark.parametrize("fail", [None, RuntimeError("waits for the card")])
def test_the_launch_counters_are_put_back_after_a_capture(card, fail):
    cache = GraphCache("t", 4, logger)
    prepare, record = fake(card, warm_up=5, per_call=16, fail=fail)
    before = launches()
    cache.capture("a", CPU, prepare, record, "a")
    assert launches() == before


def test_a_replay_adds_one_calls_launches(card):
    cache = GraphCache("t", 4, logger)
    prepare, record = fake(card, warm_up=5, per_call=16)
    entry = cache.capture("a", CPU, prepare, record, "a")
    assert entry.launches == {(dcn_cuda.dcn_forward, "launches"): 16,
                              (dcn_cuda.dcn_bwd_dx, "launches"): 1}
    before = launches()
    for _ in range(3):
        cache.replay(entry)
    assert launches() == (before[0] + 3 * 16, before[1] + 3)

"""The yardstick's counts: FLOPs stored in the configuration files
recomputed from shapes, the roofline bound of a DCN call from its shape
alone, and a share that a kernel at its bound reads as 100%."""

import json

import pytest

from mfbench import work
from mfbench.harness import Run
from mfbench.reference.config import Config
from mfbench.spec import data_file


@pytest.mark.parametrize("config", ["monoflex-f32", "monoflex-bf16"])
def test_stored_flops_and_dcn_layers(config):
    conf = json.load(open(data_file("configs", config)))
    at = conf["work"]["at"]
    got = work.count_work(Config(conf["cfg"]), at["batch"], at["height"], at["width"])
    assert got["forward_flops_per_image"] == conf["work"]["forward_flops_per_image"]
    assert got["train_flops_per_image"] == conf["work"]["train_flops_per_image"]
    strides = [[at["height"] // H, C, Co] for _, H, _, C, Co in got["dcn_layers"]]
    assert strides == conf["work"]["dcn_layers"]


def test_dcn_work_from_shapes():
    layer = work.DcnLayer(B=8, H=96, W=320, C=64, Co=64)
    n = 8 * 96 * 320
    fwd = work.fwd_work(layer, x_bytes=2)
    assert fwd["flops"] == 2 * 9 * 64 * 64 * n
    assert fwd["bytes"] == n * 64 * 2 + n * 27 * 4 + 9 * 64 * 64 * 4 + 64 * 4 + n * 64 * 4
    bwd = work.bwd_work(layer, x_bytes=4)
    assert bwd["flops"] == 2 * fwd["flops"]
    assert bwd["bytes"] == 2 * (n * 64 * 4 + n * 27 * 4 + 9 * 64 * 64 * 4) + n * 64 * 4
    # this layer is bound by its bytes
    assert work.bound_s(fwd) == fwd["bytes"] / work.PEAK_HBM_BYTES_PER_S


@pytest.mark.parametrize("kind,groups,metric", [
    ("fwd", ("dcn_fwd",), "dcn_fwd_roofline"),
    ("bwd", ("dcn_bwd_dx", "dcn_bwd_dwmo"), "dcn_bwd_roofline")])
def test_a_kernel_at_its_bound_reads_100(kind, groups, metric):
    from mfbench.harness import read_metric
    from mfbench.trace import DeviceTrace

    conf = json.load(open(data_file("configs", "monoflex-bf16")))
    run = Run(cell="x", kind="train", batch=8, x_bytes=2, height=384, width=1280,
              work=conf["work"])
    layers = [work.DcnLayer(8, 384 // s, 1280 // s, c, co)
              for s, c, co in conf["work"]["dcn_layers"]]
    bound = work.layers_bound_s(layers, 2, kind)
    # two calls, each spending exactly its bound in the kernels (split over the groups)
    ops, t = [], 0.0
    for _ in range(2):
        for g in groups:
            name = {"dcn_fwd": "dcn_fwd_kernel", "dcn_bwd_dx": "dcn_bwd_dx_kernel",
                    "dcn_bwd_dwmo": "dcn_bwd_dwmo_kernel"}[g]
            ops.append((name, t, t + bound / len(groups)))
            t += bound / len(groups)
    run.trace, run.trace_calls = DeviceTrace(0.0, t, ops), 2
    assert read_metric(metric, run) == pytest.approx(100.0)
    run.trace = DeviceTrace(0.0, 2 * t, [(n, 2 * s, 2 * e) for n, s, e in ops])
    assert read_metric(metric, run) == pytest.approx(50.0)


def test_mfu_against_the_bf16_peak():
    from mfbench.harness import read_metric
    from mfbench.trace import DeviceTrace

    run = Run(cell="x", kind="infer", batch=8,
              work={"forward_flops_per_image": 1e11, "train_flops_per_image": 3e11})
    run.trace, run.trace_calls = DeviceTrace(0.0, 1.0, [("k", 0.0, 0.5)]), 10
    # after the trace: 100 calls of 8 in 1 s, 800 img/s x 1e11 FLOP over 989e12
    run.untraced_calls, run.untraced_s = 100, 1.0
    assert read_metric("mfu.infer", run) == pytest.approx(100 * 800 * 1e11 / 989e12)
    assert read_metric("mfu.train", run) == pytest.approx(100 * 800 * 3e11 / 989e12)

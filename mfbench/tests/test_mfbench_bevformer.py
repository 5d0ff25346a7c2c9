"""The BEVFormer cell (``infer-bevformer-bf16-b6``) on the CPU at the narrow
size: the float8 control and each planted fault read gaps well over a
sound run's; its inputs repeat from the seed and follow the scenes; its
readers read what they should; its work counts are the configuration's;
its reference loads nothing of the program.  The limits were set on the
card at the cell's own size (``calibrate.py``, ``PERF.md``)."""

import argparse
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, SMALL
from mfbench.harness import Run, Session, process_start, read_metric
from mfbench.spec import data_file, load_json
from mfbench.trace import DeviceTrace

CELL = "infer-bevformer-bf16-b6"
NARROW = {**SMALL, "check_calls": 8}


# its first four scenes turn at 0.19-0.23 rad/s, 5.6-6.7 degrees a sample,
# so the history's rotation moves cells of the narrow grid in whichever
# scene the window's last calls fall (at 2.6 degrees, as seed 26's second
# scene turns, a 10 x 10 grid's nearest rotation moves almost none)
SEED = 23


def calibrate_line(fault=None, control=False, seed=SEED, seconds=10.0):
    torch.set_num_threads(2)
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=seconds, trace=0,
                              process_start=process_start())
    session = Session(args, "cpu", NARROW, [fault] if fault else None)
    try:
        session.measure()
        numbers = session.judge()
        ctrl = session.judge(session.cell.config["control"]) if control else None
    finally:
        session.close()
    return numbers, ctrl


@pytest.fixture(scope="module")
def sound():
    return calibrate_line(control=True)


def test_the_control_reads_wider_gaps(sound):
    numbers, control = sound
    assert numbers["rows_gap"] == 0.0 and np.isfinite(numbers["chain_bev_median_gap"])
    assert control["bev_median_gap"] > 4 * numbers["bev_median_gap"], (numbers, control)


@pytest.mark.parametrize("fault", ["history_dropped", "history_unrotated", "class_norm_dropped"])
def test_a_fault_reads_wider_gaps(sound, fault):
    numbers, _ = calibrate_line(fault)
    base = sound[0]
    key = "cls_median_gap" if fault == "class_norm_dropped" else "bev_median_gap"
    assert numbers[key] > 4 * base[key], (base, numbers)


def test_the_class_bias_puts_its_pairs_over_the_score():
    from mfbench.weights_bevformer import class_bias

    logits = torch.randn(900, 10, generator=torch.Generator().manual_seed(4)) * 2.1
    weights = {"confident_pairs": 30, "confident_score": 0.3}
    b = class_bias(logits, weights)
    assert int(((logits + b).sigmoid() > 0.3).sum()) == 30


def test_samples_follow_the_scenes():
    from mfbench.sources import camera_scene_batches as src

    traffic = load_json(data_file("traffic", "camera_scenes"))
    shape = {"batch": 2, "height": 90, "width": 160}
    a = src.make({**traffic, "pool": 2}, shape, 2 ** 31 + 17, None, None, None)
    b = src.make({**traffic, "pool": 3}, shape, 2 ** 31 + 17, None, None, None)
    c = src.make({**traffic, "pool": 2}, shape, 2 ** 31 + 18, None, None, None)
    n = traffic["scene_samples"]
    for i in (0, 1, 5, n, n + 1):
        x, y = a.next(i), b.next(i)
        assert np.array_equal(x["can_bus"], y["can_bus"])
        assert bool(x["scene_start"][0]) is (i % n == 0)
    assert np.array_equal(a.next(0)["image"], b.next(0)["image"])     # pool-size free
    assert not np.array_equal(a.next(0)["image"], c.next(0)["image"])
    assert not np.array_equal(a.next(1)["can_bus"], c.next(1)["can_bus"])
    first, second = a.next(n), a.next(n + 1)
    assert not first["can_bus"][[0, 1, 2, 17]].any()                  # a scene start
    step = np.hypot(*second["can_bus"][:2])
    assert 0 <= step <= 15 * traffic["dt"] + 1e-3
    assert abs(second["can_bus"][17]) <= np.degrees(0.25 * traffic["dt"]) + 1e-3 or \
        abs(abs(second["can_bus"][17]) - 360) < 5
    assert a.next(0)["image"].shape == (2, 90, 160, 3)
    assert a.next(0)["lidar2img"].shape == (2, 4, 4)


def test_the_kept_positions():
    from mfbench.kinds.infer_bevformer import positions

    for seed in (1, 2 ** 31 + 5, 77):
        got = positions(seed, 40, 8)
        assert len(got) == 8 and got[0] == 0 and max(got) >= 10 and got == sorted(set(got))
    assert positions(3, 40, 8) == positions(3, 40, 8)


def test_the_work_counts_are_the_configurations():
    from mfbench import work_bevformer as W

    conf = load_json(data_file("configs", "bevformer-base-r101-bf16"))
    traffic = load_json(data_file("traffic", "camera_scenes"))
    got = W.count_work(conf["cfg"], traffic)
    assert got["msda_calls"] == conf["work"]["msda_calls"]
    assert got["dcn_calls"] == conf["work"]["dcn_calls"]
    fcos3d = load_json(data_file("configs", "fcos3d-r101-dcn-bf16"))["work"]["dcn_calls"]
    assert got["dcn_calls"] == fcos3d[:26]         # the trunk's, FCOS3D's first 26
    assert got["forward_flops_per_image"] == pytest.approx(conf["work"]["forward_flops_per_image"])
    calls = got["msda_calls"]
    assert len(calls) == 18 and [c["groups"] for c in calls[:2]] == [2, 6]
    sca = W.msda_work(calls[1])
    assert sca["flops"] == calls[1]["pairs"] * 8 * 4 * 8 * 320
    # the spatial cross-attention is bound by its bytes: 95 MB of values,
    # 82 MB of offsets, 41 MB of weights, 8 MB of reference points, the mask, 20 MB out
    assert W.bound_s(sca) == sca["bytes"] / 3.35e12
    assert 2.4e8 < sca["bytes"] < 2.5e8


def test_the_roofline_reader():
    from mfbench import work_bevformer as W

    conf = load_json(data_file("configs", "bevformer-base-r101-bf16"))
    run = Run(cell="x", kind="infer", batch=6, x_bytes=2, height=900, width=1600,
              work=conf["work"])
    bound = W.calls_bound_s(conf["work"]["msda_calls"])
    ops = [("void (anonymous namespace)::msda_fwd_kernel<__nv_bfloat16, __nv_bfloat16>", 0.0,
            bound), ("other_kernel", bound, 2 * bound),
           ("void (anonymous namespace)::msda_fwd_kernel<__nv_bfloat16, __nv_bfloat16>", 2 * bound,
            4 * bound)]
    run.trace, run.trace_calls = DeviceTrace(0.0, 4 * bound, ops), 2
    assert read_metric("msda_roofline.bevformer", run) == pytest.approx(200 / 3)
    # the trunk's 26 DCN calls, read by FCOS3D's reader from the same work
    dcn = [("void (anonymous namespace)::dcn_fwd_kernel<__nv_bfloat16, false, false, 256>",
            4 * bound, 5 * bound)]
    run.trace.ops = ops + dcn
    assert read_metric("dcn_fwd_roofline.fcos3d", run) > 0
    run.trace.ops = ops[1:2]
    assert read_metric("msda_roofline.bevformer", run) is None        # no such kernel
    run.height = 96
    assert read_metric("msda_roofline.bevformer", run) is None        # another size


def _program_run(counters):
    from mfbench.metrics._program import ProgramTrace

    run = Run(cell="x", kind="infer", batch=6)
    run.trace = DeviceTrace(0.0, 1.0, [])
    run.__dict__["_program_trace"] = ProgramTrace(main=[
        ("eval_step.forward", 0.001, 0.003), ("eval_step.forward", 0.1, 0.102),
        ("eval_step.forward", 0.2, 0.202), ("eval_step.forward", 0.3, 0.302),
        ("eval_step.forward", 1.5, 1.6)], counters=counters)
    return run


def test_the_program_counter_readers():
    run = _program_run({"eval_step.graph_replays": 4, "bev.history_used": 3,
                        "bev.scene_starts": 1})
    assert read_metric("eval_graph_share.bevformer", run) == pytest.approx(1.0)
    assert read_metric("bev_history_share.bevformer", run) == pytest.approx(0.75)
    run = _program_run({})
    assert read_metric("eval_graph_share.bevformer", run) is None
    assert read_metric("bev_history_share.bevformer", run) is None     # a program without them


def test_the_new_metrics_are_listed_for_their_cells():
    bench = json.load(open(f"{ROOT}/BENCHMARK.json"))
    cells = {m["name"]: m["workloads"] for m in bench["per_layer"]}
    for name in ("msda_roofline.bevformer", "eval_graph_share.bevformer",
                 "bev_history_share.bevformer"):
        assert cells[name] == [CELL], name
    for name in ("forward_enqueue_ms.infer", "device_idle_pct.infer", "mfu.infer",
                 "dcn_fwd_roofline.fcos3d"):
        assert cells[name][-1] == CELL, name
    for name in ("conv_ms.train", "dcn_bwd_roofline", "mfu.train", "device_idle_pct.train",
                 "step_host_ms.train", "upload_gbps.train"):
        assert cells[name][-1] == "train-f32-step", name
    e2e = {m["name"]: m["workloads"] for m in bench["end_to_end"] if "workloads" in m}
    assert e2e["infer_img_per_s"][-1] == CELL and e2e["train_img_per_s"][-1] == "train-f32-step"
    from mfbench.kinds.infer_bevformer import NUMBERS

    for cell in (CELL, "train-f32-step"):
        limits = load_json(data_file("limits", cell))["limits"]
        assert limits and all(np.isfinite(v) for v in limits.values())
    assert set(load_json(data_file("limits", CELL))["limits"]) <= set(NUMBERS)


def test_the_reference_loads_none_of_the_program():
    code = ("import sys, json; import mfbench.reference_bevformer.model, mfbench.work_bevformer; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "monoflex_tpu", "monoflex_tpu_torch"}


def test_the_reference_is_the_tests_reference():
    import filecmp

    assert filecmp.cmp(f"{ROOT}/mfbench/reference_bevformer/bevformer.py",
                       f"{ROOT}/tests/plain_bevformer.py", shallow=False)

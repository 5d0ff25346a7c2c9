"""The metric arithmetic on made-up spans and runs: the busy union and the
idle share, a percentile over every request (not over chunk medians), the
stream's timing from each frame's due time, and the spans' attribution of
idle time."""

import statistics
import time

import pytest

from mfbench.harness import Run, percentile, read_metric, window
from mfbench.trace import DeviceTrace, Spans, busy, group_of, union


def test_busy_union_and_idle_share():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (10.0, 10.0)]
    assert union(spans) == [(0.0, 2.0), (3.0, 4.0), (10.0, 10.0)]
    assert busy(spans) == pytest.approx(3.0)
    trace = DeviceTrace(0.0, 5.0, [("k", s, e) for s, e in spans[:4]])
    run = Run(cell="x", kind="train", batch=8)
    run.trace, run.trace_calls = trace, 1
    assert read_metric("device_idle_pct.train", run) == pytest.approx(100 * (1 - 3.0 / 5.0))
    assert trace.gaps() == [(2.0, 3.0), (4.0, 5.0)]


def test_percentile_is_over_all_requests():
    # one slow request in every ten: the medians of chunks of ten hide them
    values = [100.0 if i % 10 == 9 else 1.0 for i in range(200)]
    chunk_medians = [statistics.median(values[i:i + 10]) for i in range(0, 200, 10)]
    assert percentile(chunk_medians, 95) == pytest.approx(1.0)
    assert percentile(values, 95) == pytest.approx(100.0)


def test_open_loop_times_from_the_due_time():
    run = Run(cell="x", kind="infer", batch=1)

    def call(i):
        time.sleep(0.25 if i == 2 else 0.001)   # frame 2 stalls

    window(run, call, seconds=0.5, trace_seconds=0.0, device="cpu", rate_hz=20.0)
    lat = run.latencies_s
    assert len(lat) == 10                      # every frame due in the window
    assert lat[2] >= 0.25
    # the stall delays the frames behind it: frame 3 was due 50 ms after
    # frame 2 and waited for it
    assert lat[3] >= 0.25 - 0.05
    assert lat[3] > 20 * lat[0]
    assert all(x < 0.05 for x in lat[:2])


def test_closed_loop_counts_calls_and_window():
    run = Run(cell="x", kind="train", batch=4)
    window(run, lambda i: time.sleep(0.01), seconds=0.2, trace_seconds=0.0, device="cpu")
    assert run.calls >= 5
    assert run.images_per_s() == pytest.approx(run.calls * 4 / run.window_s)


def test_idle_time_goes_to_the_open_span():
    spans = Spans()
    spans.items += [("data_wait", 0.0, 1.0), ("step", 1.0, 3.0), ("decode", 1.5, 2.0)]
    trace = DeviceTrace(0.0, 3.0, [("k", 1.2, 1.6), ("k", 2.5, 3.0)])
    got = dict(trace.idle_by_span(spans))
    assert got["data_wait"] == pytest.approx(1.2)  # (0, 1.2): midpoint 0.6
    assert got["step"] == pytest.approx(0.9)       # (1.6, 2.5): midpoint 2.05
    assert spans.at(1.7) == "decode"


def test_span_readers():
    run = Run(cell="x", kind="train", batch=8)
    run.spans = Spans()
    run.spans.items += [("data_wait", 0.1, 0.2), ("data_wait", 1.0, 1.4), ("data_wait", 9, 9.5)]
    run.trace, run.trace_calls = DeviceTrace(0.0, 2.0, [("k", 0.0, 1.0)]), 2
    assert read_metric("data_wait_ms.train", run) == pytest.approx(250.0)
    run.trace = None
    assert read_metric("data_wait_ms.train", run) is None


# kernel names as the H100's libraries and the port's kernels give them
KERNELS = {
    "void cudnn::batchnorm_bwtr_nhwc_semiPersist<float, float, float, 512, 16, 3, 4, 1, 0, "
    "true, 2>(cudnn::NhwcBatchNormBwdParams<float, float>)": "batch norm",
    "void cudnn::batchnorm_fwtr_nhwc_semiPersist<float, float, float, 512, 16, 3, 4, 1, 0, "
    "true, 2>(cudnn::NhwcBatchNormFwdParams<float, float>)": "batch norm",
    "void cudnn::bn_fw_inf_1C11_kernel_NHWC<float, float, true, true>(float, float)": "batch norm",
    "void at::native::batch_norm_collect_statistics_channels_last_kernel<at::native::Var, "
    "c10::BFloat16, float, 4>(c10::BFloat16 const*)": "batch norm",
    "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, "
    "at::native::WelfordOps<float, float, int>>>": "batch norm",
    "void (anonymous namespace)::dx_weight_image_kernel(float const*, __nv_bfloat16*)":
        "dcn_bwd_dx",
    "void (anonymous namespace)::dx_wide_gather_kernel(float const*)": "dcn_bwd_dx",
    "void (anonymous namespace)::dx_wide_u_kernel(float const*)": "dcn_bwd_dx",
    "void (anonymous namespace)::dcn_bwd_dx_kernel<__nv_bfloat16, false, 64>()": "dcn_bwd_dx",
    "void (anonymous namespace)::dcn_bwd_dw_reduce_kernel(float const*)": "dcn_bwd_dwmo",
    "void (anonymous namespace)::dcn_bwd_mo_kernel<__nv_bfloat16, false, 1>()": "dcn_bwd_dwmo",
    "void (anonymous namespace)::fwd_weight_image_kernel(float const*)": "dcn_fwd",
    "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize64x32x8_stage3_"
    "warpsize1x2x1_g1_ffma_aligna4_alignc4_execute_kernel__5x_cudnn": "convolutions",
    "void cudnn::cnn::dgrad2d_grouped_direct_kernel<__nv_bfloat16, int, float, float, false, "
    "true, 1, 0>(cudnn::cnn::DgradGroupedDirectParams)": "convolutions",
    "void tensorTransformGeneric<__nv_bfloat16, __nv_bfloat16, float, true, false, false, "
    "(cudnnKernelDataType_t)0>(cudnnTensorTransformStruct)": "layout transposes",
    "void cudnn::engines_precompiled::nhwcToNchwKernel<float, float, float, true, false, "
    "(cudnnKernelDataType_t)0>()": "layout transposes",
}


@pytest.mark.parametrize("name,group", list(KERNELS.items()))
def test_kernel_groups_of_real_names(name, group):
    assert group_of(name) == group


def test_mfu_reads_the_calls_after_the_trace():
    run = Run(cell="x", kind="train", batch=8, work={"train_flops_per_image": 1e12})
    run.trace, run.trace_calls = DeviceTrace(0.0, 6.0, [("k", 0.0, 1.0)]), 3
    assert read_metric("mfu.train", run) is None           # no call after the trace
    run.untraced_calls, run.untraced_s = 30, 10.0          # 24 img/s
    assert read_metric("mfu.train", run) == pytest.approx(100 * 24e12 / 989e12)


def test_end_to_end_readers():
    run = Run(cell="x", kind="infer", batch=8, setup_s=12.5, calls=10, window_s=4.0)
    assert read_metric("setup_s", run) == 12.5
    assert read_metric("infer_img_per_s", run) == pytest.approx(20.0)
    assert read_metric("train_img_per_s", run) is None
    assert read_metric("stream_p95_ms", run) is None
    run.latencies_s = [0.01] * 19 + [1.0]
    assert read_metric("stream_p95_ms", run) == pytest.approx(percentile(run.latencies_s, 95) * 1e3)
    assert read_metric("infer_img_per_s", run) is None

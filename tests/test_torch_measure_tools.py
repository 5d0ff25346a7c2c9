"""tools/profile_split.py, tools/step_drift.py and tools/bf16_step_spread.py:
the profile's kernel groups and busy-time union, step_drift's parameter
classes and arguments, bf16_step_spread's distances, and that each exits
non-zero without a card (they measure the card only)."""

import os
import subprocess
import sys

import pytest
import torch

from monoflex_tpu_torch.tools.bf16_step_spread import step_distances
from monoflex_tpu_torch.tools.profile_split import busy_ms, group_of
from monoflex_tpu_torch.tools.step_drift import PLAIN, feeds_train_bn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::dcn_fwd_kernel<float, true, false, 64>(...)", "dcn_fwd"),
    ("(anonymous namespace)::fwd_weight_image_kernel(float const*, ...)", "dcn_fwd"),
    ("void (anonymous namespace)::dcn_bwd_mo_kernel<__nv_bfloat16, false, 1>(...)",
     "dcn_bwd_dwmo"),
    ("(anonymous namespace)::dcn_bwd_dw_reduce_kernel(float const*, float*, int, int)",
     "dcn_bwd_dwmo"),
    ("void (anonymous namespace)::dcn_bwd_dx_kernel<false>(...)", "dcn_bwd_dx"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, false>",
     "layout transposes"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc", "convolutions (cuDNN/cuBLAS)"),
    ("void at::native::batch_norm_collect_statistics_channels_last_kernel", "batch norm"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("Memcpy DtoD (Device -> Device)", "copies"),
    ("void something_else()", "other"),
])
def test_kernel_groups(name, group):
    assert group_of(name) == group


def test_busy_is_the_union_of_spans():
    assert busy_ms([(0, 1000), (500, 1500), (3000, 4000), (3100, 3200)]) == 2.5


@pytest.mark.parametrize("name,feeds", [
    ("backbone.base.base_layer.0.conv.bias", True),
    ("backbone.dla_up.ida_0.proj_1.conv.conv_offset_mask.bias", False),
    ("heads.predictor.trunc_offset.0.bias", True),
    ("heads.predictor.reg_features.7.0.weight", False),
])
def test_biases_that_feed_a_train_bn(name, feeds):
    assert feeds_train_bn(name) == feeds


def test_step_drift_replaces_each_kernel_by_its_plain_version():
    from monoflex_tpu_torch.ops import dcn_cuda
    assert sorted(PLAIN) == ["dwmo", "dx", "fwd"]
    assert all(callable(getattr(dcn_cuda, attr)) for attr, _ in PLAIN.values())


def test_step_distances():
    """Relative errors against the second step; a zero gradient there has
    no relative error and is left out."""
    ref = (2.0, {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0]),
                 "c": torch.tensor([2.0]), "z": torch.zeros(2)})
    got = (2.5, {"a": torch.tensor([3.0, 4.5]), "b": torch.tensor([1.5]),
                 "c": torch.tensor([2.0]), "z": torch.ones(2)})
    d = step_distances(got, ref)
    assert d["loss_rel_err"] == 0.25
    assert d["params"] == 3
    assert d["grad_worst"] == 0.5 and d["worst_param"] == "b"
    assert d["grad_median"] == pytest.approx(0.1)
    with pytest.raises(AssertionError, match="different parameters"):
        step_distances((2.0, {"a": ref[1]["a"]}), ref)


@pytest.mark.parametrize("tool", ["profile_split", "step_drift", "bf16_step_spread"])
def test_exits_without_a_gpu(tool):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-m", f"monoflex_tpu_torch.tools.{tool}"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr

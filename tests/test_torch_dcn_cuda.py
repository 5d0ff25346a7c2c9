"""The Hopper DCNv2 kernels against the port's plain op and its backward, on
the card.

Needs a CUDA device and nvcc; skipped without a device.  On the GPU
(``--noconftest``: the test conftest imports jax):
    python -m pytest tests/test_torch_dcn_cuda.py --noconftest -q

Tolerances.  1e-4 abs on the forward's O(1) outputs and on dx, dmask and
doffset (O(1) to O(10) sums over at most 9*C*16 terms): both sides take the
same (optionally bf16-rounded) x and accumulate in float32; only the
summation order differs (and dx's atomics make its order vary from run to
run).  dW sums over every pixel of the batch (up to 61,440 here), so it is
held to 1e-5 of its largest element.  TF32 is off for the plain op's matmul
and for cuDNN.
"""

import pytest
import torch

from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.ops.dcn import (modulated_deform_conv, modulated_deform_conv_backward,
                                        modulated_deform_conv_bn_relu)

pytestmark = pytest.mark.cuda
ATOL = 1e-4
DW_RTOL = 1e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def make_inputs(device, B, H, W, C, Co, seed=0, bias=True):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(B, H, W, C, device=device, generator=g),
            torch.randn(B, H, W, 18, device=device, generator=g) * 1.5,
            torch.rand(B, H, W, 9, device=device, generator=g),
            torch.randn(3, 3, C, Co, device=device, generator=g) / (9 * C) ** 0.5,
            torch.randn(Co, device=device, generator=g) if bias else None)


# ragged shapes: pixel count, C and Co off the kernel's 64/32/64 tiles
@pytest.mark.parametrize("shape", [(1, 16, 32, 8, 8), (2, 13, 20, 24, 16), (2, 9, 7, 40, 72),
                                   (8, 48, 160, 128, 64)])
@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("transfer", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_op(device, shape, R, transfer):
    args = make_inputs(device, *shape, bias=shape[0] != 2)
    before = dcn_cuda.dcn_forward.launches
    y = dcn_cuda.dcn_forward(*args, max_offset=R, transfer_dtype=transfer)
    torch.cuda.synchronize()
    assert dcn_cuda.dcn_forward.launches == before + 1
    ref = modulated_deform_conv(*args, max_offset=R, transfer_dtype=transfer)
    assert (y - ref).abs().max().item() <= ATOL


@pytest.mark.parametrize("shape", [(1, 16, 32, 8, 8), (2, 9, 7, 40, 72), (8, 48, 160, 128, 64)])
@pytest.mark.parametrize("transfer", [torch.float32, torch.bfloat16])
def test_epilogue_kernel_matches_plain_fused_op(device, shape, transfer):
    """dcn_fwd with the fused BN+ReLU epilogue: one launch, counted on its
    own wrapper, equal to relu(DCN(x; no bias) * scale + shift)."""
    x, off, mask, w, _ = make_inputs(device, *shape, seed=3, bias=False)
    g = torch.Generator(device=device).manual_seed(4)
    scale = 1 + 0.3 * torch.randn(shape[-1], device=device, generator=g)
    shift = 0.2 * torch.randn(shape[-1], device=device, generator=g)
    before = dcn_cuda.dcn_forward_bn_relu.launches, dcn_cuda.dcn_forward.launches
    with torch.inference_mode():
        y = dcn_cuda.dcn_forward_bn_relu(x, off, mask, w, scale, shift, max_offset=2,
                                         transfer_dtype=transfer)
        torch.cuda.synchronize()
        ref = modulated_deform_conv_bn_relu(x, off, mask, w, scale, shift, max_offset=2,
                                            transfer_dtype=transfer)
    assert (dcn_cuda.dcn_forward_bn_relu.launches, dcn_cuda.dcn_forward.launches) == (
        before[0] + 1, before[1])
    assert (y - ref).abs().max().item() <= ATOL
    assert 0 < (y == 0).float().mean().item() < 1


def test_kernel_zero_offsets_is_a_conv(device):
    x, _, _, w, b = make_inputs(device, 2, 16, 24, 16, 32)
    y = dcn_cuda.dcn_forward(x, torch.zeros(2, 16, 24, 18, device=device),
                             torch.ones(2, 16, 24, 9, device=device), w, b, max_offset=2)
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                                     padding=1).permute(0, 2, 3, 1)
    assert (y - ref).abs().max().item() <= ATOL


def test_kernel_rejects_what_it_cannot_take(device):
    x, off, mask, w, b = make_inputs(device, 1, 8, 8, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        dcn_cuda.dcn_forward(x.transpose(1, 2).contiguous().transpose(1, 2), off, mask, w, b,
                             max_offset=2)
    with pytest.raises(ValueError, match="cpu"):
        dcn_cuda.dcn_forward(x, off.cpu(), mask, w, b, max_offset=2)
    with pytest.raises(ValueError, match="transfer_dtype"):
        dcn_cuda.dcn_forward(x, off, mask, w, b, max_offset=2, transfer_dtype=torch.float16)


def grad_errors(got, ref):
    """Max abs error of (dx, doffset, dmask) and of dW relative to max |dW|."""
    errs = [(a - b).abs().max().item() for a, b in zip(got[:3], ref[:3])]
    dw_rel = ((got[3] - ref[3]).abs().max() / ref[3].abs().max()).item()
    return errs, dw_rel


@pytest.mark.parametrize("shape", [(1, 16, 32, 8, 8), (2, 13, 20, 24, 16), (2, 9, 7, 40, 72),
                                   (8, 48, 160, 128, 64)])
@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("transfer", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain_backward(device, shape, R, transfer):
    x, off, mask, w, _ = make_inputs(device, *shape, bias=False)
    g = torch.randn(*shape[:3], shape[4], device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    xt = x.to(transfer)
    before = dcn_cuda.dcn_bwd_dx.launches, dcn_cuda.dcn_bwd_dwmo.launches
    dx = dcn_cuda.dcn_bwd_dx(xt, off, mask, w, g, max_offset=R)
    dmask, dw, doff = dcn_cuda.dcn_bwd_dwmo(xt, off, mask, w, g, max_offset=R)
    torch.cuda.synchronize()
    assert (dcn_cuda.dcn_bwd_dx.launches, dcn_cuda.dcn_bwd_dwmo.launches) == (
        before[0] + 1, before[1] + 1)
    rdx, rdoff, rdmask, rdw, _ = modulated_deform_conv_backward(
        x, off, mask, w, g, max_offset=R, transfer_dtype=transfer)
    errs, dw_rel = grad_errors((dx, doff, dmask, dw), (rdx, rdoff, rdmask, rdw))
    assert max(errs) <= ATOL, errs
    assert dw_rel <= DW_RTOL, dw_rel


@pytest.mark.parametrize("transfer", [torch.float32, torch.bfloat16])
def test_autograd_through_the_kernels(device, transfer):
    """Every operand of dcn_forward gets its gradient from the backward
    kernels, equal to autograd of the plain op (P1: the kernel path once
    returned a result with no grad_fn)."""
    shape = (2, 13, 20, 24, 16)
    leaves = [t.requires_grad_() for t in make_inputs(device, *shape)]
    gy = torch.randn(*shape[:3], shape[4], device=device)
    counts = [f.launches for f in (dcn_cuda.dcn_forward, dcn_cuda.dcn_bwd_dx,
                                   dcn_cuda.dcn_bwd_dwmo)]
    y = dcn_cuda.dcn_forward(*leaves, max_offset=2, transfer_dtype=transfer)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y * gy).sum(), leaves)
    torch.cuda.synchronize()
    assert [f.launches for f in (dcn_cuda.dcn_forward, dcn_cuda.dcn_bwd_dx,
                                 dcn_cuda.dcn_bwd_dwmo)] == [c + 1 for c in counts]
    assert all(t is not None for t in got)
    ref = torch.autograd.grad(
        (modulated_deform_conv(*leaves, max_offset=2, transfer_dtype=transfer) * gy).sum(),
        leaves)
    x_, off_, mask_, w_, b_ = got
    errs, dw_rel = grad_errors((x_, off_, mask_, w_), ref[:4])
    assert max(errs) <= ATOL, errs
    assert dw_rel <= DW_RTOL, dw_rel
    assert (b_ - ref[4]).abs().max().item() <= ATOL

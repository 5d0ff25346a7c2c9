"""The Hopper DCNv2 kernel against the port's plain op, on the card.

Needs a CUDA device and nvcc; skipped without a device.  On the GPU
(``--noconftest``: the test conftest imports jax):
    python -m pytest tests/test_torch_dcn_cuda.py --noconftest -q

Tolerance 1e-4 abs on O(1) outputs: both sides take the same (optionally
bf16-rounded) x and accumulate in float32; only the summation order differs.
TF32 is off for the plain op's matmul and for cuDNN.
"""

import pytest
import torch

from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.ops.dcn import modulated_deform_conv

pytestmark = pytest.mark.cuda
ATOL = 1e-4


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

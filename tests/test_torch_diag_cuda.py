"""The kernels of the diagnostics path against their plain versions, on the
card: the ablation kernel ``csrc/dcn_ablate.cu``, the relayout kernel
``csrc/relayout.cu`` and the bf16 window math of ``dcn_fwd``,
``dcn_bwd_dx`` and ``dcn_bwd_dwmo``.

Needs a CUDA device and nvcc; skipped without a device.  On the GPU
(``--noconftest``: the test conftest imports jax):
    python -m pytest tests/test_torch_diag_cuda.py --noconftest -q

Tolerances.  dma and the relayout move data: exact.  The other ablations
are float32 on both sides and differ in summation order only: 1e-5 of the
largest |output|.  The bf16-math kernels round at the same points as the
plain op, so they differ by the order of float32 sums and, rarely, a
sampled value rounded to the neighbouring bf16: 1e-4 of the largest
|output| or |gradient|.  The same kernels in f32 math lie about 1e-3 of it
from the bf16 plain op (bf16 keeps 8 bits), so the tolerance tells the two
modes apart, and the test asserts that for every output.
"""

import pytest
import torch

from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.ops.dcn import modulated_deform_conv, modulated_deform_conv_backward
from monoflex_tpu_torch.ops.dcn_ablate import VARIANTS, dcn_ablate, dcn_ablate_reference
from monoflex_tpu_torch.ops.relayout import relayout, relayout_reference
from test_torch_dcn_cuda import device, make_inputs  # noqa: F401 (fixture)

pytestmark = pytest.mark.cuda
ABLATE_RTOL = 1e-5
BF16_RTOL = 1e-4
BF16 = torch.bfloat16


def rel_err(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


# H = 13: one nobcast row tile of 16 with 3 padded rows; H = 40: three tiles,
# the last with 8 padded rows; (9, 7, 40, 72): C and Co off every tile;
# (3, 11, 37, 20, 24): no dimension a multiple of the kernels' tiles (8 x 16
# pixels, 64 channels, 8-channel groups); (1, 9, 13, 6, 10): C not a
# multiple of 4 (dma copies element by element)
@pytest.mark.parametrize("shape", [(1, 16, 16, 8, 8), (2, 13, 20, 24, 16), (1, 40, 16, 8, 8),
                                   (2, 9, 7, 40, 72), (3, 11, 37, 20, 24), (1, 9, 13, 6, 10)])
@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("variant", VARIANTS)
def test_ablate_kernel_matches_plain(device, variant, shape, R):
    x, off, mask, w, _ = make_inputs(device, *shape, bias=False)
    before = dict(dcn_ablate.launches)
    y = dcn_ablate(x, off, mask, w, variant=variant, max_offset=R)
    torch.cuda.synchronize()
    assert dcn_ablate.launches == {**before, variant: before[variant] + 1}
    ref = dcn_ablate_reference(x, off, mask, w, variant=variant, max_offset=R)
    assert y.shape == ref.shape
    if variant == "dma":
        assert torch.equal(y, x)
    else:
        assert rel_err(y, ref) <= ABLATE_RTOL


# R = 3 and 7 stage x's halo for nomap and nobcast in 32 and 16 channels; at
# Co = 128 matmul takes dcn_fwd's 128-channel tile, nomap and nobcast two
# tiles of 64; a kernel_diag shape at batch 2
@pytest.mark.parametrize("shape", [(2, 19, 35, 72, 128), (2, 24, 80, 256, 128)])
@pytest.mark.parametrize("R", [0, 3, 7])
@pytest.mark.parametrize("variant", VARIANTS)
def test_ablate_kernel_wide_reach(device, variant, shape, R):
    """Every variant against its plain version where the halo of x takes
    fewer channels, and bit-equal over two launches."""
    x, off, mask, w, _ = make_inputs(device, *shape, seed=11, bias=False)
    y = dcn_ablate(x, off, mask, w, variant=variant, max_offset=R)
    again = dcn_ablate(x, off, mask, w, variant=variant, max_offset=R)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    ref = dcn_ablate_reference(x, off, mask, w, variant=variant, max_offset=R)
    if variant == "dma":
        assert torch.equal(y, x)
    else:
        assert rel_err(y, ref) <= ABLATE_RTOL


def test_ablate_rejects_what_it_cannot_take(device):
    x, off, mask, w, _ = make_inputs(device, 1, 8, 8, 8, 8)
    with pytest.raises(ValueError, match="max_offset"):
        dcn_ablate(x, off, mask, w, variant="window", max_offset=8)
    with pytest.raises(ValueError, match="variant"):
        dcn_ablate(x, off, mask, w, variant="full", max_offset=2)


@pytest.mark.parametrize("shape", [(2, 16, 20, 6), (1, 13, 5, 3), (8, 96, 320, 64)])
@pytest.mark.parametrize("R", [1, 2])
def test_relayout_kernel_matches_plain(device, shape, R):
    x = torch.randn(*shape, device=device)
    before = relayout.launches
    y = relayout(x, R)
    torch.cuda.synchronize()
    assert relayout.launches == before + 1
    assert torch.equal(y, relayout_reference(x, R))


@pytest.mark.parametrize("shape", [(1, 16, 32, 8, 8), (2, 13, 20, 24, 16), (8, 48, 160, 128, 64)])
@pytest.mark.parametrize("R", [1, 2])
def test_bf16_math_kernels_match_plain(device, shape, R):
    x, off, mask, w, b = make_inputs(device, *shape)
    g = torch.randn(*shape[:3], shape[4], device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    wrappers = (dcn_cuda.dcn_forward, dcn_cuda.dcn_bwd_dx, dcn_cuda.dcn_bwd_dwmo)
    before = [(f.launches, f.bf16_math_launches) for f in wrappers]
    with torch.no_grad():
        y = dcn_cuda.dcn_forward(x, off, mask, w, b, max_offset=R, compute_dtype=BF16)
    dx = dcn_cuda.dcn_bwd_dx(x, off, mask, w, g, max_offset=R, compute_dtype=BF16)
    dmask, dw, doff = dcn_cuda.dcn_bwd_dwmo(x, off, mask, w, g, max_offset=R, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert [(f.launches, f.bf16_math_launches) for f in wrappers] == [
        (n, m + 1) for n, m in before]
    ref_y = modulated_deform_conv(x, off, mask, w, b, max_offset=R, compute_dtype=BF16)
    rdx, rdoff, rdmask, rdw, _ = modulated_deform_conv_backward(x, off, mask, w, g, max_offset=R,
                                                                compute_dtype=BF16)
    with torch.no_grad():
        f32_y = dcn_cuda.dcn_forward(x, off, mask, w, b, max_offset=R)
    f32_dx = dcn_cuda.dcn_bwd_dx(x, off, mask, w, g, max_offset=R)
    f32_dmask, f32_dw, f32_doff = dcn_cuda.dcn_bwd_dwmo(x, off, mask, w, g, max_offset=R)
    for name, got, f32, ref in (("fwd", y, f32_y, ref_y), ("dx", dx, f32_dx, rdx),
                                ("doffset", doff, f32_doff, rdoff),
                                ("dmask", dmask, f32_dmask, rdmask), ("dW", dw, f32_dw, rdw)):
        assert rel_err(got, ref) <= BF16_RTOL, name
        assert rel_err(f32, ref) > BF16_RTOL, f"{name}: bf16 math is a no-op"


def test_bf16_math_autograd(device):
    """dcn_forward(compute_dtype=bf16) runs the three kernels in bf16 math
    under autograd and gives the plain backward's bf16-math gradients (g
    rounded to bf16)."""
    shape = (2, 13, 20, 24, 16)
    leaves = [t.requires_grad_() for t in make_inputs(device, *shape)]
    gy = torch.randn(*shape[:3], shape[4], device=device)
    wrappers = (dcn_cuda.dcn_forward, dcn_cuda.dcn_bwd_dx, dcn_cuda.dcn_bwd_dwmo)
    counts = [f.bf16_math_launches for f in wrappers]
    y = dcn_cuda.dcn_forward(*leaves, max_offset=2, compute_dtype=BF16)
    got = torch.autograd.grad(y, leaves, gy)
    torch.cuda.synchronize()
    assert [f.bf16_math_launches for f in wrappers] == [c + 1 for c in counts]
    x, off, mask, w, _ = (t.detach() for t in leaves)
    dx, doff, dmask, dw, db = modulated_deform_conv_backward(x, off, mask, w, gy, max_offset=2,
                                                             compute_dtype=BF16)
    for a, b in zip(got, (dx, doff, dmask, dw, db)):
        assert rel_err(a, b) <= BF16_RTOL


def test_kernel_sweep_times_each_kernel_three_ways(device):
    """kernel_sweep at a model shape whose C (Co = C) dcn_bwd_dwmo takes,
    every kernel of --what: the three times of each record positive."""
    from monoflex_tpu_torch.tools import kernel_sweep
    from monoflex_tpu_torch.tools.kernel_bench import MODEL_SHAPES

    recs = list(kernel_sweep.sweep(["f32r2"], [MODEL_SHAPES[6]], kernel_sweep.WHAT, batch=2,
                                   iters=3))
    assert [r["kernel"] for r in recs] == list(kernel_sweep.WHAT)
    for rec in recs:
        assert "error" not in rec, rec
        assert rec["ms_device"] > 0 and rec["ms_loop"] > 0 and rec["ms_percall"] > 0, rec

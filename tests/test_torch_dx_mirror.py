"""dcn_bwd_dx's algorithm on the CPU: the mirrored gather
(``ops/dcn.py::modulated_deform_conv_dx_mirrored``, z_k by gathering at each
output pixel the corners that land on it, then dx = sum_k z_k W_k^T), the
wide path's (``modulated_deform_conv_dx_wide``: u_k = g W_k^T first, then
the same gather of u, beyond R' = 11), the layout of W_k^T that the kernel's first launch writes, and the split-bf16
arithmetic of its tensor-core products.

Tolerances.  The mirrored dx against the port's plain backward: 1e-5 of
max |ref| (float32 both sides, the contraction reassociated; about 3e-7 is
seen); the wide path's too.  Against the JAX dx5 in interpret mode: 1e-5 abs, as
``test_torch_dcn_bwd.py::test_dx_matches_dx5``.  The split products: as
``test_torch_split_bf16.py``, BWD_RTOL / 10 of the float64 product.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import monoflex_tpu.ops.dcn_pallas_v3 as DP3
from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.ops.dcn import (modulated_deform_conv_backward,
                                        modulated_deform_conv_dx_mirrored,
                                        modulated_deform_conv_dx_wide)
from monoflex_tpu_torch.ops.dcn_cuda import (DX_MAX_REACH, DX_WIDE_MAX_REACH, SMEM_LIMIT,
                                             dx_halo_channels,
                                             dx_smem_bytes, dx_tile_c, dx_weight_image,
                                             split_bf16, swizzle_128b)
from monoflex_tpu_torch.tools.kernel_bench import MODEL_SHAPES
from test_torch_dcn import interpret_mode, make_inputs  # noqa: F401 (fixture)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (importing it runs nothing on a device)

sys.path.pop(0)
RTOL = 1e-5
ATOL = 1e-5
BOUND = chip_smoke.BWD_RTOL / 10


def dx_inputs(seed, B, H, W, C, Co, R):
    """make_inputs' operands with g, and offsets that also sit at exactly
    +-R (the corner at R + 1 then has weight 0) and beyond it (clipped)."""
    x, off, mask, w, _ = make_inputs(seed=seed, B=B, H=H, W=W, C=C, Co=Co)
    rng = np.random.RandomState(seed + 50)
    flat = off.reshape(-1)
    flat[rng.rand(flat.size) < 0.1] = R
    flat[rng.rand(flat.size) < 0.1] = -R
    flat[rng.rand(flat.size) < 0.05] *= 3
    g = rng.randn(B, H, W, Co).astype(np.float32)
    return x, off, mask, w, g


def wide_inputs(seed, B, H, W, C, Co, R):
    """make_inputs' operands with g, and offsets spread over (-R, R), so that
    sources up to R pixels away land on a pixel, each at least 0.05 from an
    integer (ROADMAP C1)."""
    x, _, mask, w, _ = make_inputs(seed=seed, B=B, H=H, W=W, C=C, Co=Co)
    rng = np.random.RandomState(seed + 60)
    off = rng.uniform(-R + 0.05, R - 0.05, size=(B, H, W, 18)).astype(np.float32)
    off[np.abs(off - np.round(off)) < 0.05] += 0.1
    g = rng.randn(B, H, W, Co).astype(np.float32)
    return x, off, mask, w, g


# odd H and W, C and Co off multiples of 64, every pixel of a small map near
# a border; R up to 8, the first stage's reach under the per-stage clamp
@pytest.mark.parametrize("shape", [(1, 9, 13, 40, 72), (2, 7, 5, 8, 16), (1, 11, 21, 24, 8)])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_mirrored_dx_equals_plain_backward(shape, R, compute_dtype):
    x, off, mask, w, g = map(torch.from_numpy, dx_inputs(0, *shape, R))
    ref = modulated_deform_conv_backward(x, off, mask, w, g, max_offset=R,
                                         compute_dtype=compute_dtype, wrt=("x",))[0]
    got = modulated_deform_conv_dx_mirrored(off, mask, w, g, max_offset=R,
                                            compute_dtype=compute_dtype)
    assert (got - ref).abs().max().item() <= RTOL * ref.abs().max().item()


def test_bf16_math_rounds_the_gather():
    """Under bf16 math the mirrored dx rounds g, W and each corner weight: it
    lies far from the f32 dx, as the plain op's bf16 math does."""
    x, off, mask, w, g = map(torch.from_numpy, dx_inputs(1, 1, 9, 13, 40, 72, 2))
    f32 = modulated_deform_conv_dx_mirrored(off, mask, w, g, max_offset=2)
    bf16 = modulated_deform_conv_dx_mirrored(off, mask, w, g, max_offset=2,
                                             compute_dtype=torch.bfloat16)
    assert (bf16 - f32).abs().max().item() > 100 * RTOL * f32.abs().max().item()


# R = 5 and 8: the reaches of the wide layout (g in 16-channel slices, the
# floors per tap), 8 the first stage's of TPU.DCN_MAX_OFFSET_PER_STAGE
@pytest.mark.parametrize("R", [1, 2, 5, 8])
def test_mirrored_dx_matches_dx5(interpret_mode, R):
    arrays = (dx_inputs if R <= 2 else wide_inputs)(2, 1, 9, 13, 40, 24, R)
    ref = np.asarray(DP3.dcn_pallas_v5_bwd_dx(*map(jnp.asarray, arrays), max_offset=R))
    _, off, mask, w, g = map(torch.from_numpy, arrays)
    got = modulated_deform_conv_dx_mirrored(off, mask, w, g, max_offset=R).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


# R = 12 and 16: past the halo path's reach (DX_MAX_REACH = 11)
@pytest.mark.parametrize("shape", [(1, 9, 13, 40, 72), (2, 7, 5, 8, 16)])
@pytest.mark.parametrize("R", [12, 16])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_wide_dx_equals_plain_backward(shape, R, compute_dtype):
    x, off, mask, w, g = map(torch.from_numpy, wide_inputs(4, *shape, R))
    ref = modulated_deform_conv_backward(x, off, mask, w, g, max_offset=R,
                                         compute_dtype=compute_dtype, wrt=("x",))[0]
    got = modulated_deform_conv_dx_wide(off, mask, w, g, max_offset=R,
                                        compute_dtype=compute_dtype)
    assert (got - ref).abs().max().item() <= RTOL * ref.abs().max().item()


def test_wide_dx_matches_dx5(interpret_mode):
    """The wide path's algorithm at R = 12, which the TPU's dx5 takes too,
    against dx5 in interpret mode on a tiny map (offsets away from integers,
    C1)."""
    R = DX_MAX_REACH + 1
    arrays = wide_inputs(5, 1, 6, 9, 8, 8, R)
    ref = np.asarray(DP3.dcn_pallas_v5_bwd_dx(*map(jnp.asarray, arrays), max_offset=R))
    _, off, mask, w, g = map(torch.from_numpy, arrays)
    got = modulated_deform_conv_dx_wide(off, mask, w, g, max_offset=R).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def gaussian(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("C,Co", [(8, 8), (40, 72), (64, 64), (72, 40), (512, 256)])
@pytest.mark.parametrize("bf16_math", [False, True])
def test_dx_weight_image_holds_w_transposed(C, Co, bf16_math):
    w = gaussian(4, 3, 3, C, Co)
    img = dx_weight_image(w, bf16_math)
    bn = dx_tile_c(C)
    cc, ct = -(-Co // 64), -(-C // bn)
    assert bn == (128 if C > 64 else 64)
    assert img.shape == (9, cc, ct, 2, bn, 64) and img.dtype == torch.bfloat16
    tiles = swizzle_128b(img).float()                    # (9, cc, ct, 2, bn c, 64 co)
    full = tiles.permute(0, 3, 2, 4, 1, 5).reshape(9, 2, ct * bn, cc * 64)
    hi, lo = split_bf16(w.reshape(9, C, Co))
    assert torch.equal(full[:, 0, :C, :Co], hi.float())
    assert torch.equal(full[:, 1, :C, :Co], torch.zeros_like(lo.float()) if bf16_math
                       else lo.float())
    assert not full[:, :, C:].any() and not full[:, :, :, Co:].any()


def staged(a, b, passes):
    """a b over K in stages of 64 (one tap's chunk), each stage's passes in
    a fresh f32 sum added into the total, as dcn_bwd_dx takes them."""
    total = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], 64):
        total += passes(a[:, k0:k0 + 64], b[k0:k0 + 64])
    return total


def three_pass(a, b):
    (ah, al), (bh, bl) = split_bf16(a), split_bf16(b)
    return ah.float() @ bh.float() + ah.float() @ bl.float() + al.float() @ bh.float()


def two_pass(a, b):
    """Under bf16 math: z in two parts against bf16-exact W."""
    ah, al = split_bf16(a)
    return ah.float() @ b + al.float() @ b


# (M, K, N): dx's depth 9*Co at Co = 64 and 256, N a 64-channel tile of C
@pytest.mark.parametrize("mkn", [(128, 576, 64), (128, 2304, 64)])
def test_dx_split_passes_meet_the_backward_tolerance(mkn):
    M, K, N = mkn
    z, w = gaussian(2, M, K), gaussian(3, K, N)
    ref = z.double() @ w.double()
    scale = ref.abs().max().item()
    err3 = (staged(z, w, three_pass).double() - ref).abs().max().item() / scale
    one = staged(z, w, lambda a, b: a.bfloat16().float() @ b.bfloat16().float())
    err1 = (one.double() - ref).abs().max().item() / scale
    assert err3 <= BOUND, err3
    assert err1 > BOUND, err1
    wb = w.bfloat16().float()
    ref_b = z.double() @ wb.double()
    err2 = (staged(z, wb, two_pass).double() - ref_b).abs().max().item()
    assert err2 <= BOUND * ref_b.abs().max().item(), err2


def test_cpu_dx_takes_any_r():
    """The halo limit (R <= 11) is the kernel's: on CPU tensors dcn_bwd_dx is
    the plain backward at any R."""
    R = DX_MAX_REACH + 1
    x, off, mask, w, g = map(torch.from_numpy, dx_inputs(3, 1, 9, 13, 8, 8, R))
    got = dcn_cuda.dcn_bwd_dx(x, off, mask, w, g, max_offset=R)
    ref = modulated_deform_conv_backward(x, off, mask, w, g, max_offset=R, wrt=("x",))[0]
    assert torch.equal(got, ref)


def kernel_constant(name):
    src = (dcn_cuda._PKG / "csrc" / "dcn_bwd_dx.cu").read_text()
    return int(src.split(f"constexpr int {name} = ")[1].split(";")[0])


def test_max_reach_is_the_kernels():
    """The wrapper's limit DX_MAX_REACH is the largest reach whose block
    fits a block's shared memory in the mirror of the kernel's layout, built
    on the kernel's own constants, and the next reach's does not: the
    wrapper raises where the kernel's entry would refuse, and nowhere else."""
    assert (kernel_constant("kSmemLimit"), kernel_constant("kNarrowReach"),
            kernel_constant("kMaxCand"), kernel_constant("PARTS"), kernel_constant("THREADS"),
            (kernel_constant("TH"), kernel_constant("TW"))) == (
        SMEM_LIMIT, dcn_cuda._DX_NARROW_REACH, dcn_cuda._DX_MAX_CAND, dcn_cuda.DX_PARTS,
        dcn_cuda._DX_THREADS, dcn_cuda._DX_TILE)
    r = DX_MAX_REACH
    assert r >= 8 and dx_halo_channels(r) and not dx_halo_channels(r + 1)
    assert (2 * dcn_cuda._DX_NARROW_REACH + 1) ** 2 <= dcn_cuda._DX_MAX_CAND
    # the wide path's limit: its signed-byte floor codes
    assert kernel_constant("kWideMaxReach") == DX_WIDE_MAX_REACH == 127


# the (C, Co) of the neck's DCN layers (tools/kernel_bench.py::MODEL_SHAPES)
@pytest.mark.parametrize("C,Co", [shape[2:] for shape in MODEL_SHAPES])
def test_dx_layout_fits_every_reach(C, Co):
    """Every reach from 1 to DX_MAX_REACH lays a block out within its shared
    memory at the neck's channel counts: 64 halo channels up to R' = 2, 32
    at 3 and 4, 16 beyond (the floors then per tap)."""
    for reach in range(1, DX_MAX_REACH + 1):
        nbytes = dx_smem_bytes(reach, C)
        assert 0 < nbytes <= SMEM_LIMIT, (reach, nbytes)
        assert dx_halo_channels(reach) == (64 if reach <= 2 else 32 if reach <= 4 else 16)
    assert dx_smem_bytes(DX_MAX_REACH + 1, C) == 0

"""The split-bf16 arithmetic of the tensor-core DCN kernels (dcn_fwd and
dcn_bwd_dwmo), and the layout of W that their first launch writes.

Each f32 operand is split into bf16 parts (``ops/dcn_cuda.py::split_bf16``).
dcn_bwd_dwmo takes two (hi + lo) and a product a b as a_hi b_hi + a_hi b_lo
+ a_lo b_hi in three tensor-core passes with f32 sums.  Emulated here on the
CPU with f32 matmuls of the bf16 parts (a bf16 x bf16 product is exact in
f32), the 3-pass product stays within BWD_RTOL / 10 of the float64 product's
largest element at the contraction depths the kernels see: 9*C = 576 and
4608 for dcn_fwd and u = g W^T, 61,440 pixels for dW.  A 1-pass bf16 product
misses the same bound, which is why the kernels split.  dcn_fwd takes three
parts and six passes, which lands within the float32 product's own distance
from float64, times 4.
"""

import os
import sys

import numpy as np
import pytest
import torch

from monoflex_tpu_torch.ops.dcn_cuda import (dwmo_weight_image, fwd_tile_n, fwd_weight_image,
                                             split_bf16, swizzle_128b)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (importing it runs nothing on a device)

sys.path.pop(0)
BOUND = chip_smoke.BWD_RTOL / 10


def gaussian(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def test_split_keeps_16_bits():
    t = gaussian(0, 100_000) * torch.from_numpy(
        np.exp(np.random.default_rng(1).uniform(-20, 20, 100_000)).astype(np.float32))
    hi, lo = split_bf16(t)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, t.to(torch.bfloat16))
    rel = ((hi.double() + lo.double() - t.double()).abs() / t.double().abs()).max().item()
    assert rel <= 2.0 ** -16, rel
    # lo is what hi left, rounded: at most half a bf16 ulp of hi
    assert ((lo.double().abs() / hi.double().abs()).max().item()) <= 2.0 ** -8


def f32_product(p, q):
    return p.float() @ q.float()


def three_pass(a, b):
    (ah, al), (bh, bl) = split_bf16(a), split_bf16(b)
    return f32_product(ah, bh) + f32_product(ah, bl) + f32_product(al, bh)


def six_pass(a, b):
    (ah, am, al), (bh, bm, bl) = split_bf16(a, 3), split_bf16(b, 3)
    return (f32_product(ah, bh) + f32_product(ah, bm) + f32_product(am, bh)
            + f32_product(ah, bl) + f32_product(al, bh) + f32_product(am, bm))


def one_pass(a, b):
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


# (M, K, N): dcn_fwd's and u's 9*C at C = 64 and 512; dW's pixel depth
@pytest.mark.parametrize("mkn", [(256, 576, 64), (128, 4608, 256), (64, 61_440, 64)])
def test_three_passes_meet_the_backward_tolerance(mkn):
    M, K, N = mkn
    a, b = gaussian(2, M, K), gaussian(3, K, N)
    ref = a.double() @ b.double()
    scale = ref.abs().max().item()
    err3 = (three_pass(a, b).double() - ref).abs().max().item() / scale
    err1 = (one_pass(a, b).double() - ref).abs().max().item() / scale
    assert err3 <= BOUND, err3
    assert err1 > BOUND, err1


def test_three_parts_keep_f32():
    t = gaussian(6, 100_000) * torch.from_numpy(
        np.exp(np.random.default_rng(7).uniform(-20, 20, 100_000)).astype(np.float32))
    hi, mid, lo = split_bf16(t, 3)
    assert torch.equal(hi, t.to(torch.bfloat16))
    assert torch.equal(hi.double() + mid.double() + lo.double(), t.double())


@pytest.mark.parametrize("mkn", [(256, 576, 64), (128, 4608, 256)])
def test_six_passes_are_the_f32_class(mkn):
    """dcn_fwd's six passes lie as close to the float64 product as a float32
    matmul does (within 4x), and 20x closer than three passes."""
    M, K, N = mkn
    a, b = gaussian(8, M, K), gaussian(9, K, N)
    ref = a.double() @ b.double()
    err6 = (six_pass(a, b).double() - ref).abs().max().item()
    err_f32 = (f32_product(a, b).double() - ref).abs().max().item()
    err3 = (three_pass(a, b).double() - ref).abs().max().item()
    assert err6 <= 4 * err_f32, (err6, err_f32)
    assert 20 * err6 < err3, (err6, err3)


def unswizzle(t):
    """swizzle_128b is its own inverse: the group map j -> j ^ (r % 8) is."""
    return swizzle_128b(t)


def test_swizzle_moves_16_byte_groups():
    t = torch.arange(16 * 64).view(16, 64)
    s = swizzle_128b(t)
    for r in range(16):
        for j in range(8):
            assert torch.equal(s[r, 8 * (j ^ (r % 8)):8 * (j ^ (r % 8)) + 8], t[r, 8 * j:8 * j + 8])
    assert torch.equal(unswizzle(s), t)


@pytest.mark.parametrize("C,Co", [(8, 8), (40, 72), (64, 64), (128, 256)])
@pytest.mark.parametrize("bf16_math", [False, True])
def test_fwd_weight_image_holds_w(C, Co, bf16_math):
    w = gaussian(4, 3, 3, C, Co)
    bn = fwd_tile_n(Co)
    img = fwd_weight_image(w, bn, bf16_math)
    cc, nt = -(-C // 64), -(-Co // bn)
    assert img.shape == (9, cc, nt, 3, bn, 64) and img.dtype == torch.bfloat16
    tiles = unswizzle(img).float()                       # (9, cc, nt, 3, bn, 64): [co][c]
    full = tiles.permute(0, 3, 1, 5, 2, 4).reshape(9, 3, cc * 64, nt * bn)
    parts = split_bf16(w.reshape(9, C, Co), 3)
    assert torch.equal(full[:, 0, :C, :Co], parts[0].float())
    for p in (1, 2):
        assert torch.equal(full[:, p, :C, :Co], torch.zeros_like(parts[p].float())
                           if bf16_math else parts[p].float())
    assert not full[:, :, C:].any() and not full[:, :, :, Co:].any()


@pytest.mark.parametrize("C,Co", [(8, 8), (40, 72), (512, 256)])
def test_dwmo_weight_image_holds_w(C, Co):
    w = gaussian(5, 3, 3, C, Co)
    img = dwmo_weight_image(w)
    ct, kc = -(-C // 64), -(-Co // 64)
    assert img.shape == (9, ct, 2, kc, 64, 64)
    tiles = unswizzle(img).float()                       # (9, ct, 2, kc, 64 c, 64 co)
    full = tiles.permute(0, 2, 1, 4, 3, 5).reshape(9, 2, ct * 64, kc * 64)
    hi, lo = split_bf16(w.reshape(9, C, Co))
    assert torch.equal(full[:, 0, :C, :Co], hi.float())
    assert torch.equal(full[:, 1, :C, :Co], lo.float())
    assert not full[:, :, C:].any() and not full[:, :, :, Co:].any()

"""The plain versions of ``csrc/dcn_ablate.cu``'s algorithms on the CPU:
``separable`` below (nomap and nobcast as the kernel takes them: per 8-row
block and tap a row pass, then a column pass) against
``dcn_ablate_reference``, the output-channel tile the wrapper lays W out
for, the CPU path of the ``dcn_ablate`` wrapper, and the helpers of
``tools/ablate_time.py`` (rotating input copies, nomap as one convolution).
The kernel itself is held to its plain versions on the card
(``tests/test_torch_diag_cuda.py``).

Tolerance.  Both sides are float32 and sum the same terms; the separable
form reassociates the window (rows first), so it is held to ABLATE_RTOL,
1e-5 of the largest |output|, as the kernel is on the card.
"""

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from monoflex_tpu_torch.ops.dcn_ablate import (R_MAX, VARIANTS, WINDOW, _tile_maxima, ablate_tile_n,
                                               dcn_ablate, dcn_ablate_reference)
from monoflex_tpu_torch.ops.dcn_cuda import fwd_tile_n
from monoflex_tpu_torch.tools.ablate_time import main as ablate_time_main
from monoflex_tpu_torch.tools.ablate_time import nomap_conv_weight, rotating

ABLATE_RTOL = 1e-5
TILE_ROWS = 8   # the rows of gemm_window_kernel's pixel tile (csrc/dcn_ablate.cu TH)


def separable(x, offset, mask, weight, *, variant, max_offset):
    """nomap or nobcast by the algorithm of ``csrc/dcn_ablate.cu``'s
    ``gemm_window_kernel``: per block of 8 output rows (whose rows share one
    row tile's weights) and tap k, a row pass t[r] = sum_f wx(k,f)
    x[r, w+kx+f] over the 8 + 2R rows the block reads, then a column pass
    sum_e wy(k,e) t[h+ky+e], contracted with W_k; nobcast's weights are its
    tile maxima, nomap's 0.5 a row and a column."""
    if variant not in WINDOW:
        raise ValueError(f"variant must be nomap or nobcast, got {variant!r}")
    R = int(max_offset)
    B, H, W, C = x.shape
    P = R + 1
    xp = F.pad(x, (0, 0, P, P, P, P))                    # (B, H + 2P, W + 2P, C)
    out = torch.zeros(B, H, W, weight.shape[3])
    if variant == "nobcast":
        wy, wx, tile_h = _tile_maxima(offset, mask, R)
    else:
        wy = wx = torch.full((B, 1, 9, 2 * R + 1), 0.5)
        tile_h = H
    for h0 in range(0, H, TILE_ROWS):
        th = min(TILE_ROWS, H - h0)
        for k in range(9):
            ky, kx = k // 3 - 1, k % 3 - 1
            wy_k, wx_k = wy[:, h0 // tile_h, k], wx[:, h0 // tile_h, k]   # (B, 2R+1)
            src = xp[:, h0 + ky + 1: h0 + ky + 1 + th + 2 * R]   # rows h0 + ky - R ..
            rows = sum(src[:, :, P + kx + f: P + kx + f + W] * wx_k[:, f + R, None, None, None]
                       for f in range(-R, R + 1))
            a = sum(rows[:, e + R: e + R + th] * wy_k[:, e + R, None, None, None]
                    for e in range(-R, R + 1))
            out[:, h0:h0 + th] += a @ weight[k // 3, k % 3]
    return out


def inputs(seed, B, H, W, C, Co):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, H, W, C)), rng.standard_normal((B, H, W, 18)) * 1.5,
              rng.random((B, H, W, 9)), rng.standard_normal((3, 3, C, Co)) / (9 * C) ** 0.5)
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


# H = 13: one row tile (16) holding two 8-row blocks, the second cut short;
# H = 40: three row tiles, the last padded; W and C off every tile
@pytest.mark.parametrize("shape", [(2, 13, 11, 5, 7), (1, 40, 9, 8, 8), (1, 7, 21, 3, 4)])
@pytest.mark.parametrize("R", [0, 1, 2, 3, R_MAX])
@pytest.mark.parametrize("variant", ["nomap", "nobcast"])
def test_separable_window_equals_reference(variant, shape, R):
    x, off, mask, w = inputs(0, *shape)
    ref = dcn_ablate_reference(x, off, mask, w, variant=variant, max_offset=R)
    got = separable(x, off, mask, w, variant=variant, max_offset=R)
    assert ref.abs().max().item() > 0
    assert (got - ref).abs().max().item() <= ABLATE_RTOL * ref.abs().max().item()


def test_separable_window_takes_only_the_windows():
    x, off, mask, w = inputs(1, 1, 8, 8, 4, 4)
    with pytest.raises(ValueError, match="nomap or nobcast"):
        separable(x, off, mask, w, variant="matmul", max_offset=2)


@pytest.mark.parametrize("Co", [8, 64, 72, 128, 256])
def test_products_tile_of_output_channels(Co):
    """matmul takes dcn_fwd's tile of output channels, nomap and nobcast 64
    (the kernel refuses any other)."""
    assert ablate_tile_n("matmul", Co) == fwd_tile_n(Co)
    assert ablate_tile_n("nomap", Co) == ablate_tile_n("nobcast", Co) == 64


@pytest.mark.parametrize("variant", VARIANTS)
def test_cpu_wrapper_is_the_reference(variant):
    """On CPU tensors the wrapper runs the plain version and counts no launch."""
    x, off, mask, w = inputs(2, 2, 9, 7, 8, 16)
    before = dict(dcn_ablate.launches)
    got = dcn_ablate(x, off, mask, w, variant=variant, max_offset=2)
    assert dcn_ablate.launches == before
    assert torch.equal(got, dcn_ablate_reference(x, off, mask, w, variant=variant, max_offset=2))
    if variant == "dma":
        assert torch.equal(got, x)


def test_rotating_sets_exceed_the_bytes_asked_for():
    """Each set holds equal copies in buffers of its own, and together they
    take at least ``min_bytes`` (two sets at least)."""
    a, b = torch.arange(12.0).view(3, 4), torch.ones(5)
    sets = rotating(a, b, min_bytes=1000)
    assert len(sets) == 15        # 68 bytes a set
    assert all(torch.equal(s[0], a) and torch.equal(s[1], b) for s in sets)
    assert len({s[0].data_ptr() for s in sets}) == len(sets)
    assert len(rotating(a, b, min_bytes=1)) == 2


@pytest.mark.parametrize("R", [0, 2])
def test_nomap_is_one_convolution(R):
    """The library call timed beside nomap, F.conv2d with the combined
    (2R+3)^2 kernel, computes nomap."""
    x, off, mask, w = inputs(3, 2, 11, 13, 6, 5)
    ref = dcn_ablate_reference(x, off, mask, w, variant="nomap", max_offset=R)
    got = F.conv2d(x.permute(0, 3, 1, 2), nomap_conv_weight(w, R), padding=R + 1)
    assert (got.permute(0, 2, 3, 1) - ref).abs().max().item() <= ABLATE_RTOL * ref.abs().max().item()


def test_ablate_time_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        ablate_time_main(["--no-times"])

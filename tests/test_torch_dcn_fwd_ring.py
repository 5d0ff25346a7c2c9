"""dcn_fwd's warp-specialised ring (``csrc/fwd_stages.cuh::run_ring``) at
every tile of output channels: the rule that picks the tile
(``ops/dcn_cuda.py::fwd_tile_n``), the layout of W it reads
(``fwd_weight_image``, 32-channel chunks in wgmma's 64-byte swizzle) and the
``wide_launches`` counter, on the CPU; on the card, the kernel against the
plain op at every tile, the fused epilogue, the folded bf16 cast, bf16
math, two launches and a CUDA-graph replay.

The card tests skip without a device.  On the GPU (``--noconftest``: the
test conftest imports jax):
    python -m pytest tests/test_torch_dcn_fwd_ring.py --noconftest -q

Tolerances as ``tests/test_torch_dcn_cuda.py``: 1e-4 abs on O(1) outputs
(both sides take the same x and sum in float32, in another order); bf16
math 1e-4 of the largest |output| (chip_smoke.py's BF16_RTOL: both round at
the same points).  Two launches and a replay are bit-equal: every sum runs
in a fixed order.
"""

import logging
import math

import pytest
import torch

from monoflex_tpu_torch.ops import dcn_cuda
from monoflex_tpu_torch.ops.dcn import modulated_deform_conv, modulated_deform_conv_bn_relu
from monoflex_tpu_torch.ops.dcn_cuda import (FWD_PARTS, FWD_WIDE_ROWS, fwd_image_numel,
                                             fwd_tile_n, fwd_weight_image, split_bf16,
                                             swizzle_64b)
from monoflex_tpu_torch.train import graphs
from monoflex_tpu_torch.train.graphs import Graph, GraphCache

ATOL = 1e-4
BF16_RTOL = 1e-4
R = 2
# (C, Co) of the card checks, every tile: Co 64 and 192 (ragged: three
# 64-channel chunks) on the 64 tile, 128 on the 128 tile, 256 and 512 on the
# wide tile; C 96 (ragged: three 32-channel stages), 256 and 512
CHANNELS = [(96, 64), (96, 128), (96, 192), (256, 256), (512, 512), (256, 128), (512, 256)]
# a map off every pixel tile (962 pixels: 7.5 narrow blocks, 15.03 wide)
MAP = (2, 13, 37)


# ------------------------------------------------------------------ CPU ----

@pytest.mark.parametrize("Co,bn", [(8, 64), (64, 64), (72, 128), (128, 128), (192, 64),
                                   (256, 256), (320, 64), (384, 128), (512, 256), (1024, 256)])
def test_tile_rule(Co, bn):
    """The wide tile where Co pads to a multiple of 256, else 128 where it
    pads to a multiple of 128, else 64."""
    assert fwd_tile_n(Co) == bn


# (B, H, W, Co): stream-b1's (12, 40, 512 -> 256) and (24, 80, 256 -> 256),
# FCOS3D's smallest maps (8, 13) and (15, 25) at batch 6 and its Co = 512
@pytest.mark.parametrize("B,H,W,Co", [(1, 12, 40, 256), (1, 24, 80, 256), (6, 8, 13, 256),
                                      (6, 15, 25, 256), (6, 29, 50, 512)])
def test_wide_tile_keeps_the_blocks(B, H, W, Co):
    """The wide tile (64 pixels x 256 channels a block) gives a grid at least
    as large as the narrow 128 x 128 tile's: no shape loses blocks to it."""
    npix = B * H * W
    assert fwd_tile_n(Co) == 256
    wide = math.ceil(npix / FWD_WIDE_ROWS) * math.ceil(Co / 256)
    narrow = math.ceil(npix / 128) * math.ceil(Co / 128)
    assert wide >= narrow


def test_swizzle_64b_moves_16_byte_groups():
    t = torch.arange(16 * 32).view(16, 32)
    s = swizzle_64b(t)
    for r in range(16):
        for j in range(4):
            g = j ^ ((r // 2) % 4)
            assert torch.equal(s[r, 8 * g:8 * g + 8], t[r, 8 * j:8 * j + 8])
    assert torch.equal(swizzle_64b(s), t)


@pytest.mark.parametrize("C,Co,bn", [(96, 192, 64), (40, 72, 128), (96, 256, 256),
                                     (64, 512, 256), (8, 8, 64)])
@pytest.mark.parametrize("bf16_math", [False, True])
def test_weight_image_holds_w_at_every_tile(C, Co, bn, bf16_math):
    """fwd_weight_image at every tile: per (tap, 32-channel chunk, tile) the
    three parts of W's rows of output channels, C padded to a multiple of 32
    and Co to the tile with zeros; its size is fwd_image_numel's."""
    g = torch.Generator().manual_seed(C + Co)
    w = torch.randn(3, 3, C, Co, generator=g)
    img = fwd_weight_image(w, bn, bf16_math)
    cc, nt = math.ceil(C / 32), math.ceil(Co / bn)
    assert img.shape == (9, cc, nt, FWD_PARTS, bn, 32) and img.dtype == torch.bfloat16
    assert img.numel() == fwd_image_numel(C, Co, bn)
    tiles = swizzle_64b(img).float()                     # (9, cc, nt, 3, bn, 32): [co][c]
    full = tiles.permute(0, 3, 1, 5, 2, 4).reshape(9, FWD_PARTS, cc * 32, nt * bn)
    parts = split_bf16(w.reshape(9, C, Co), FWD_PARTS)
    for p in range(FWD_PARTS):
        want = parts[p].float() if p == 0 or not bf16_math else torch.zeros(9, C, Co)
        assert torch.equal(full[:, p, :C, :Co], want)
    assert not full[:, :, C:].any() and not full[:, :, :, Co:].any()


def test_wide_launches_are_counted_like_launches():
    """Both forward wrappers carry ``wide_launches``, and the CUDA-graph
    cache counts it on replay as it counts ``launches``."""
    assert "wide_launches" in graphs._COUNTERS
    for f in (dcn_cuda.dcn_forward, dcn_cuda.dcn_forward_bn_relu):
        assert isinstance(f.wide_launches, int)
    counts = graphs._launch_counts()
    assert (dcn_cuda.dcn_forward, "wide_launches") in counts
    assert (dcn_cuda.dcn_forward_bn_relu, "wide_launches") in counts


def test_cpu_wrapper_counts_no_launch():
    """On CPU tensors the plain op runs: no launch, wide or not, is counted."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 5, 7, 16, generator=g)
    off = torch.randn(1, 5, 7, 18, generator=g)
    mask = torch.rand(1, 5, 7, 9, generator=g)
    w = torch.randn(3, 3, 16, 256, generator=g)
    before = dcn_cuda.dcn_forward.launches, dcn_cuda.dcn_forward.wide_launches
    with torch.no_grad():
        y = dcn_cuda.dcn_forward(x, off, mask, w, None, max_offset=R)
    assert torch.equal(y, modulated_deform_conv(x, off, mask, w, None, max_offset=R))
    assert (dcn_cuda.dcn_forward.launches, dcn_cuda.dcn_forward.wide_launches) == before


# ----------------------------------------------------------------- card ----

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def make_inputs(device, B, H, W, C, Co, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(B, H, W, C, device=device, generator=g),
            # fractional, and beyond +-R often enough to exercise the clamp
            torch.randn(B, H, W, 18, device=device, generator=g) * 1.5,
            torch.rand(B, H, W, 9, device=device, generator=g),
            torch.randn(3, 3, C, Co, device=device, generator=g) / (9 * C) ** 0.5,
            torch.randn(Co, device=device, generator=g) * 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("C,Co", CHANNELS)
@pytest.mark.parametrize("transfer", [torch.float32, torch.bfloat16])
def test_every_tile_matches_plain_op(device, C, Co, transfer):
    """The kernel at the tile fwd_tile_n picks against the plain op; a launch
    on the wide tile is counted in wide_launches too."""
    x, off, mask, w, b = make_inputs(device, *MAP, C, Co)
    with torch.no_grad():
        ref = modulated_deform_conv(x, off, mask, w, b, max_offset=R, transfer_dtype=transfer)
        before = dcn_cuda.dcn_forward.launches, dcn_cuda.dcn_forward.wide_launches
        y = dcn_cuda.dcn_forward(x, off, mask, w, b, max_offset=R, transfer_dtype=transfer)
        torch.cuda.synchronize()
    wide = int(fwd_tile_n(Co) == 256)
    assert (dcn_cuda.dcn_forward.launches, dcn_cuda.dcn_forward.wide_launches) == (
        before[0] + 1, before[1] + wide)
    assert (y - ref).abs().max().item() <= ATOL


@pytest.mark.cuda
def test_map_smaller_than_a_block(device):
    """A 5 x 7 map (35 pixels, under one block) on the wide tile against the
    plain op."""
    x, off, mask, w, b = make_inputs(device, 1, 5, 7, 256, 256, seed=1)
    with torch.no_grad():
        ref = modulated_deform_conv(x, off, mask, w, b, max_offset=R)
        y = dcn_cuda.dcn_forward(x, off, mask, w, b, max_offset=R)
        torch.cuda.synchronize()
    assert (y - ref).abs().max().item() <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("C,Co", [(96, 64), (96, 192), (256, 256), (512, 512)])
def test_epilogue_and_folded_cast_at_every_tile(device, C, Co):
    """The fused BN+ReLU epilogue against its plain version, counted on its
    own wrapper (wide launches too); f32 x rounded as it is loaded bit-equal
    to x cast to bf16 first."""
    x, off, mask, w, b = make_inputs(device, *MAP, C, Co, seed=2)
    g = torch.Generator(device=device).manual_seed(3)
    scale = 1 + 0.3 * torch.randn(Co, device=device, generator=g)
    shift = 0.2 * torch.randn(Co, device=device, generator=g)
    f = dcn_cuda.dcn_forward_bn_relu
    with torch.no_grad():
        ref = modulated_deform_conv_bn_relu(x, off, mask, w, scale, shift, max_offset=R,
                                            transfer_dtype=torch.bfloat16)
        before = f.launches, f.wide_launches
        fused = f(x, off, mask, w, scale, shift, max_offset=R, transfer_dtype=torch.bfloat16)
        folded = dcn_cuda._fwd_kernel(x, off, mask, w, b, R, round_x=True)
        cast_first = dcn_cuda._fwd_kernel(x.to(torch.bfloat16), off, mask, w, b, R)
        torch.cuda.synchronize()
    assert (f.launches, f.wide_launches) == (before[0] + 1, before[1] + int(fwd_tile_n(Co) == 256))
    assert (fused - ref).abs().max().item() <= ATOL
    assert torch.equal(folded, cast_first)


@pytest.mark.cuda
@pytest.mark.parametrize("C,Co", [(96, 64), (96, 128), (256, 256)])
def test_bf16_math_at_every_tile(device, C, Co):
    """The one-pass bf16 window math against the plain op in bf16 math."""
    x, off, mask, w, b = make_inputs(device, *MAP, C, Co, seed=4)
    bf16 = torch.bfloat16
    x16 = x.to(bf16)
    before = dcn_cuda.dcn_forward.bf16_math_launches
    with torch.no_grad():
        ref = modulated_deform_conv(x16, off, mask, w, b, max_offset=R, compute_dtype=bf16)
        y = dcn_cuda.dcn_forward(x16, off, mask, w, b, max_offset=R, transfer_dtype=bf16,
                                 compute_dtype=bf16)
        torch.cuda.synchronize()
    assert dcn_cuda.dcn_forward.bf16_math_launches == before + 1
    assert (y - ref).abs().max().item() <= BF16_RTOL * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("C,Co", [(96, 64), (256, 128), (512, 256)])
def test_two_launches_are_bit_equal(device, C, Co):
    x, off, mask, w, b = make_inputs(device, *MAP, C, Co, seed=5)
    with torch.no_grad():
        y1 = dcn_cuda.dcn_forward(x, off, mask, w, b, max_offset=R, transfer_dtype=torch.bfloat16)
        y2 = dcn_cuda.dcn_forward(x, off, mask, w, b, max_offset=R, transfer_dtype=torch.bfloat16)
        torch.cuda.synchronize()
    assert torch.equal(y1, y2)


class _Forward(Graph):
    def __init__(self, out):
        self.out = out


@pytest.mark.cuda
def test_graph_replay_is_bit_equal_and_counts_wide_launches(device):
    """A CUDA graph of two forwards (the wide tile at Co = 256, the narrow at
    Co = 128) replays bit-equal to the eager calls, and each replay counts
    two launches, one of them wide, on the forward wrapper."""
    first = make_inputs(device, *MAP, 256, 256, seed=6)
    second = make_inputs(device, *MAP, 128, 128, seed=7)

    def call(args):
        return [dcn_cuda.dcn_forward(*a, max_offset=R, transfer_dtype=torch.bfloat16)
                for a in args]

    with torch.no_grad():
        eager = call((first, second))
        cache = GraphCache("test_dcn_fwd_ring", 1, logging.getLogger("test_dcn_fwd_ring"))
        entry = cache.capture("forward", device, lambda stream, arg: arg,
                              lambda arg: _Forward(call(arg)), (first, second))
        assert isinstance(entry, _Forward)
        before = dcn_cuda.dcn_forward.launches, dcn_cuda.dcn_forward.wide_launches
        cache.replay(entry)
        torch.cuda.synchronize()
    assert (dcn_cuda.dcn_forward.launches, dcn_cuda.dcn_forward.wide_launches) == (
        before[0] + 2, before[1] + 1)
    for a, b in zip(entry.out, eager):
        assert torch.equal(a, b)

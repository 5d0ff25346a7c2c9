"""The Hopper DCNv2 kernels: build, ctypes bindings, launch wrappers and the
autograd Function the model calls.

Three hand-written kernels of the model, each in its own ``csrc/*.cu``:

- ``dcn_fwd.cu`` replaces ``monoflex_tpu/ops/dcn_pallas_v3.py::dcn_pallas_v3``,
  with its optional eval BN+ReLU epilogue (``dcn_forward_bn_relu``);
- ``dcn_bwd_dx.cu`` replaces ``dcn_pallas_v5_bwd_dx`` (and its siblings
  dx3/dx4, which compute the same dx);
- ``dcn_bwd_dwmo.cu`` replaces ``dcn_pallas_v3_bwd_dwmo`` (dmask, dW and
  doffset in one call).

Two more, of the kernel-diagnostics tools, are built here too and wrapped in
their own modules: ``dcn_ablate.cu`` (``ops/dcn_ablate.py``) and
``relayout.cu`` (``ops/relayout.py``).

``dcn_forward`` is the op the model calls: ``DCNFunction``, whose forward is
``dcn_fwd`` and whose backward is ``dcn_backward``: ``dcn_bwd_dx`` +
``dcn_bwd_dwmo`` + a torch sum of g for the bias.  ``dcn_forward_bn_relu``
is the fused eval BN+ReLU forward, inference-only like the JAX path (no
gradient).  The v1 and v2 TPU generations compute the same functions; the
model routes them here with float32 transfer.  Their
``compute_dtype=bfloat16`` window math (``ops/dcn.py``) is a template
parameter of all three kernels, reached through ``compute_dtype=`` and
used only by the kernel-diagnostics tools (``monoflex_tpu_torch/tools``).
Each wrapper launches its kernel on a CUDA tensor or raises; on a CPU tensor
it runs the plain PyTorch version in ``ops/dcn.py``.  There is no fallback
from one to the other.  ``<wrapper>.launches`` counts a wrapper's kernel
launches with float32 math, ``<wrapper>.bf16_math_launches`` those with
bf16 window math.

All three run their products on Hopper's tensor cores (wgmma,
``csrc/sm90_mma.cuh``) on operands split into bf16 parts (``split_bf16``):
dcn_fwd in three parts and six passes, the f32 class of the plain op;
dcn_bwd_dwmo and dcn_bwd_dx in two parts and three passes; each first
launches a small kernel that splits W and lays it out for wgmma (plain
versions: ``fwd_weight_image``, ``dwmo_weight_image``, ``dx_weight_image``).
dcn_bwd_dx is a mirrored gather over a shared-memory halo of g (plain
version of its algorithm: ``ops/dcn.py::modulated_deform_conv_dx_mirrored``),
and beyond a clamp reach of 11, where that halo outgrows shared memory, a
product u = g W^T on the CUDA cores and a gather of u from device memory
(``modulated_deform_conv_dx_wide``);
none of the three uses atomics, so two launches are bit-equal.  Under
``torch.no_grad()`` the forward takes f32 x and rounds it to the bf16
transfer dtype inside the kernel, bit-equal to casting it first; under
autograd ``DCNFunction`` casts, because it saves the bf16 x for the
backward.  A bf16 x (a bf16 model's activation) goes to the kernels as it
is, whatever the transfer dtype: its values are exact in either, and the
kernels' bf16-x entry (the bf16 transfer's) reads them with no f32 copy.

Every source is compiled by nvcc for sm_90a on first use, one nvcc per source
started together, into ``_build/<hash>/`` next to the package, where the hash
covers all the sources, the shared headers (``csrc/*.cuh``) and the flags;
each library is loaded with ctypes.  Nothing is built or loaded at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .dcn import (COMPUTE_DTYPES, check_compute_dtype, check_dcn_inputs, check_epilogue,
                  modulated_deform_conv, modulated_deform_conv_backward,
                  modulated_deform_conv_bn_relu)

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_TRANSFER_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2**31 - 1
# dcn_bwd_dwmo splits the dW pixel reduction into at most two waves of blocks
# over the 132 SMs of an H100 (three blocks an SM at a 64-wide output-channel
# tile, two at 128, one at 256), with at least 64 pixels (one stage) each
_SMS = 132
_DW_TILE_PIXELS = 64
_DW_C_TILE = 64
# the swizzled tile layout of csrc/sm90_mma.cuh: 64 bf16 columns a chunk, 16-byte groups
_CHUNK = 64
# bf16 parts of each f32 operand of dcn_fwd (csrc/dcn_fwd.cu's PARTS, which
# its entry checks)
FWD_PARTS = 3
# the pixels a block of dcn_fwd's wide tile owns and the input channels of
# a stage of its ring (csrc/fwd_stages.cuh's FwdTile<256>::kRows and
# kImageChunk: one row of wgmma's 64-byte swizzle)
FWD_WIDE_ROWS = 64
_FWD_CHUNK = 32
_MAX_MO_CO = 256
# bf16 parts of z and W in dcn_bwd_dx (csrc/dcn_bwd_dx.cu's PARTS, which its
# entry checks)
DX_PARTS = 2
# a block's dynamic shared memory on sm_90 (the kernels' kSmemLimit)
SMEM_LIMIT = 232448
# dcn_bwd_dx's output tile (8 x 16 pixels), threads, and the largest clamp
# reach whose floors of all 9 taps it stages at once (csrc/dcn_bwd_dx.cu's
# TH, TW, THREADS, kNarrowReach and kMaxCand)
_DX_TILE = (8, 16)
_DX_THREADS = 512
_DX_NARROW_REACH = 4
_DX_MAX_CAND = 96

_vp, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "dcn_fwd": [_vp, _i32, _i32, _i32, _vp, _vp, _vp, _vp, _i32, _i32, _vp, _vp, _vp, _vp,
                _i32, _i32, _i32, _i32, _i32, _f32, _vp],
    "dcn_bwd_dx": [_i32, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _vp, _vp, _i32, _i32, _i32, _i32,
                   _i32, _f32, _i32, _vp],
    "dcn_bwd_dx_wide": [_i32, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32,
                        _f32, _i32, _vp],
    "dcn_bwd_dwmo": [_vp, _i32, _i32, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32,
                     _i32, _i32, _i32, _i32, _i32, _i32, _f32, _vp],
    "dcn_ablate": [_i32, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32,
                   _i32, _i32, _i32, _i32, _vp],
    "relayout": [_vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _vp],
}

# the entry points of each library beyond the one named after it
_MORE_SYMBOLS = {"dcn_bwd_dx": ("dcn_bwd_dx_wide",)}

_libs: Optional[Dict[str, ctypes.CDLL]] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc") or (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not found or not os.path.exists(found):
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH or set CUDA_HOME")
    return found


def build_dir() -> Path:
    """Where the libraries of these sources and flags are built:
    ``_build/<hash>/``, with each nvcc's log (ptxas -v) beside its library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / digest.hexdigest()[:16]


def build() -> Dict[str, ctypes.CDLL]:
    """Compile (once per hash of the sources and flags) and load every
    kernel library; returns them by kernel name."""
    global _libs
    if _libs is not None:
        return _libs
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, out_dir / f"{src.stem}.so") for src in SOURCES}
    procs = {}
    for name, (src, so) in targets.items():
        if not so.exists():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log = proc.communicate()[0]
        so = targets[name][1]
        # ptxas -v: registers, shared memory and spills of each kernel
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    libs = {}
    for name, (_, so) in targets.items():
        lib = ctypes.CDLL(str(so))
        for symbol in (name,) + _MORE_SYMBOLS.get(name, ()):
            fn = getattr(lib, symbol)
            fn.argtypes = _ARGTYPES[symbol]
            fn.restype = _i32
        libs[name] = lib
    _libs = libs
    return libs


def _check_kernel_operands(name: str, B: int, H: int, W: int, C: int, Co: int,
                           **operands: Optional[torch.Tensor]) -> None:
    """Raise unless the operands are contiguous CUDA tensors and every index
    the kernel forms fits in 32 bits."""
    for key, t in operands.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if max(B * H * W * max(C, Co, 18), 9 * C * Co) > _INT32_MAX:
        raise ValueError(f"{name}: shape {(B, H, W, C)} -> {Co} overflows the kernel's "
                         f"32-bit indices")


def _check_device(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {x.device}")


def _check_grad_inputs(x, offset, mask, weight, g) -> None:
    check_dcn_inputs(x, offset, mask, weight, None, x_dtypes=_TRANSFER_DTYPES)
    B, H, W, _ = x.shape
    shape = (B, H, W, weight.shape[3])
    if tuple(g.shape) != shape or g.dtype != torch.float32 or g.device != x.device:
        raise ValueError(f"g must be float32 {shape} on {x.device}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")


def _launch(name: str, x: torch.Tensor, *args, symbol: Optional[str] = None) -> None:
    """Call the entry point ``symbol`` (by default ``name``) of kernel
    library ``name`` on x's device and current stream."""
    lib = build()
    symbol = symbol or name
    with torch.cuda.device(x.device):
        err = getattr(lib[name], symbol)(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def split_bf16(t: torch.Tensor, parts: int = 2) -> Tuple[torch.Tensor, ...]:
    """t as ``parts`` bfloat16 tensors that sum to it: each the rest of t
    after the ones before, rounded to bf16 (to nearest).  Two parts keep
    about 16 significant bits of t, and a product a b taken as a_hi b_hi +
    a_hi b_lo + a_lo b_hi (dcn_bwd_dwmo's three tensor-core passes, summed
    in f32) is within about 2^-16 |a b|.  Three parts keep about 24 bits,
    and dcn_fwd's six passes (every pair of parts whose orders sum to at
    most 2) are within about 2^-25 |a b|, the f32 class."""
    out, rest = [], t.float()
    for _ in range(parts):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].float()
    return tuple(out)


def swizzle_128b(t: torch.Tensor) -> torch.Tensor:
    """Rows of 64 bf16 (..., R, 64) in the 128-byte swizzle that wgmma reads
    (``csrc/sm90_mma.cuh``): the 16-byte group j of row r moves to j ^ (r % 8)."""
    R = t.shape[-2]
    groups = t.unflatten(-1, (8, 8))
    r = torch.arange(R, device=t.device).view(R, 1)
    src = torch.arange(8, device=t.device).view(1, 8) ^ (r % 8)
    return groups.gather(-2, src[..., None].expand(groups.shape)).flatten(-2)


def swizzle_64b(t: torch.Tensor) -> torch.Tensor:
    """Rows of 32 bf16 (..., R, 32) in wgmma's 64-byte swizzle
    (``csrc/sm90_mma.cuh``): the 16-byte group j of row r moves to
    j ^ ((r // 2) % 4).  Its own inverse."""
    R = t.shape[-2]
    groups = t.unflatten(-1, (4, 8))
    r = torch.arange(R, device=t.device).view(R, 1)
    src = torch.arange(4, device=t.device).view(1, 4) ^ ((r // 2) % 4)
    return groups.gather(-2, src[..., None].expand(groups.shape)).flatten(-2)


def _pad(t: torch.Tensor, dims: Dict[int, int]) -> torch.Tensor:
    """t zero-padded at the end of each dim to the given size."""
    pads = [0] * (2 * t.dim())
    for d, size in dims.items():
        pads[2 * (t.dim() - 1 - d) + 1] = size - t.shape[d]
    return torch.nn.functional.pad(t, pads)


def _parts(w: torch.Tensor, parts: int, bf16_math: bool) -> torch.Tensor:
    """W's bf16 parts stacked on a new dim 0; under bf16 math W is rounded,
    so the first part is exact and the others are 0."""
    split = split_bf16(w, parts)
    return torch.stack([split[0]] + [torch.zeros_like(p) if bf16_math else p
                                     for p in split[1:]])


def fwd_tile_n(Co: int) -> int:
    """dcn_fwd's output channels per block: 256, the wide tile of
    ``FWD_WIDE_ROWS`` pixels a block, where Co pads to a multiple of 256 (each
    sampled A tile then feeds 256 output channels, in about as many blocks
    as 128-pixel blocks of 128 channels: faster on the card at every such
    shape of MonoFlex and FCOS3D, a 10-block grid too); else 128 where Co
    pads to a multiple of 128; else 64 (both 128 pixels a block)."""
    chunks = math.ceil(Co / _CHUNK)
    return 256 if chunks % 4 == 0 else 128 if chunks % 2 == 0 else 64


def fwd_image_numel(C: int, Co: int, bn: int) -> int:
    return 9 * math.ceil(C / _FWD_CHUNK) * math.ceil(Co / bn) * FWD_PARTS * bn * _FWD_CHUNK


def dwmo_image_numel(C: int, Co: int) -> int:
    return 9 * math.ceil(C / _CHUNK) * 2 * math.ceil(Co / _CHUNK) * _CHUNK * _CHUNK


def dx_tile_c(C: int) -> int:
    """dcn_bwd_dx's input channels per block: 128 (four warpgroups multiply)
    where C exceeds 64, so the gather of z is shared by twice the channels;
    else 64."""
    return 128 if C > _CHUNK else _CHUNK


def dx_image_numel(C: int, Co: int) -> int:
    bn = dx_tile_c(C)
    return 9 * math.ceil(Co / _CHUNK) * math.ceil(C / bn) * DX_PARTS * bn * _CHUNK


def _dx_layout_bytes(reach: int, hc: int, bn: int) -> Tuple[int, int]:
    """(bytes, pixels) of a dcn_bwd_dx block's shared memory and halo at
    clamp reach R', hc halo channels and bn input channels: the mirror of
    ``csrc/dcn_bwd_dx.cu``'s Layout.  Two A stages and W's chunk (bf16
    parts), g's halo (f32), the floors (a u16 code and three f32 a halo pixel
    and tap: all 9 taps at R' <= 4, two beyond), the candidate table, the hit
    lists and the mbarrier, plus 1024 bytes of alignment."""
    th, tw = _DX_TILE
    P = reach + 1
    nh = (th + 2 * P) * (tw + 2 * P)
    taps = 9 if reach <= _DX_NARROW_REACH else 2
    ncand = _DX_MAX_CAND if reach <= _DX_NARROW_REACH else -(-(2 * reach + 1) ** 2 // 32) * 32
    a_bytes = 128 * 128                               # one bf16 part of a 128 x 64 A tile
    nbytes = (2 * DX_PARTS * a_bytes + DX_PARTS * bn * 128 + nh * hc * 4
              + -(-taps * nh * 2 // 16) * 16 + 3 * taps * nh * 4 + ncand * 4
              + _DX_THREADS // 8 * 32 * 4 + 8 + 1024)
    return nbytes, nh


def dx_halo_channels(reach: int) -> int:
    """g's channels a dcn_bwd_dx block stages at once at clamp reach R'
    (``csrc/dcn_bwd_dx.cu``'s halo_channels): at R' <= 4, 64 where that fits
    at either tile of C (and the raw offsets and masks fit the A stages), else
    32; beyond, 16; 0 where nothing fits."""
    if reach < 0:
        return 0
    if reach > _DX_NARROW_REACH:
        return 16 if _dx_layout_bytes(reach, 16, 128)[0] <= SMEM_LIMIT else 0
    for hc in (64, 32):
        nbytes, nh = _dx_layout_bytes(reach, hc, 128)
        if nbytes <= SMEM_LIMIT and nh * 27 * 4 <= 2 * DX_PARTS * 128 * 128:
            return hc
    return 0


def dx_smem_bytes(reach: int, C: int) -> int:
    """The dynamic shared memory of a dcn_bwd_dx block at clamp reach R' and
    C input channels, as the kernel's entry computes it (and checks against
    this count); 0 where the reach does not fit."""
    hc = dx_halo_channels(reach)
    return _dx_layout_bytes(reach, hc, dx_tile_c(C))[0] if hc else 0


# the largest clamp reach ceil(R) whose halo of g, floors and stages fit a
# dcn_bwd_dx block's shared memory (11: g in 16-channel slices); beyond it
# the kernel's wide path, without a halo, up to DX_WIDE_MAX_REACH, where its
# floor codes (a signed byte each, csrc/dcn_bwd_dx.cu's kWideMaxReach) end
DX_MAX_REACH = max(r for r in range(64) if dx_halo_channels(r))
DX_WIDE_MAX_REACH = 127


def fwd_weight_image(weight: torch.Tensor, bn: int, bf16_math: bool = False) -> torch.Tensor:
    """W (3,3,C,Co) as dcn_fwd's B operand: (9, ceil(C/32), Co_pad/bn, 3,
    bn, 32) bf16, each (tap, 32-channel chunk, output-channel tile) one bulk
    copy of its hi, mid and lo tiles (one stage of the kernel's ring), rows
    of output channels with 32 channels each, zero-padded and swizzled in
    the 64-byte mode.  The plain version of the layout kernel that
    ``csrc/dcn_fwd.cu`` launches before the forward."""
    _, _, C, Co = weight.shape
    cc, nt = math.ceil(C / _FWD_CHUNK), math.ceil(Co / bn)
    w = _pad(weight.reshape(9, C, Co), {1: cc * _FWD_CHUNK, 2: nt * bn})
    w = w.view(9, cc, _FWD_CHUNK, nt, bn).permute(0, 1, 3, 4, 2)    # (9, cc, nt, bn, 32)
    return swizzle_64b(_parts(w, FWD_PARTS, bf16_math).permute(1, 2, 3, 0, 4, 5)).contiguous()


def dwmo_weight_image(weight: torch.Tensor, bf16_math: bool = False) -> torch.Tensor:
    """W (3,3,C,Co) as the B operand of dcn_bwd_dwmo's u = g W_k^T: (9,
    ceil(C/64), 2, ceil(Co/64), 64, 64) bf16, each (tap, channel tile) one
    bulk copy of its hi then lo chunks, rows of channels with 64 output
    channels each, zero-padded and swizzled.  The plain version of the
    layout kernel that ``csrc/dcn_bwd_dwmo.cu`` launches first."""
    _, _, C, Co = weight.shape
    ct, kc = math.ceil(C / _CHUNK), math.ceil(Co / _CHUNK)
    w = _pad(weight.reshape(9, C, Co), {1: ct * _CHUNK, 2: kc * _CHUNK})
    w = w.view(9, ct, _CHUNK, kc, _CHUNK).permute(0, 1, 3, 2, 4)     # (9, ct, kc, 64, 64)
    return swizzle_128b(_parts(w, 2, bf16_math).permute(1, 2, 0, 3, 4, 5)).contiguous()


def dx_weight_image(weight: torch.Tensor, bf16_math: bool = False) -> torch.Tensor:
    """W (3,3,C,Co) as dcn_bwd_dx's B operand, W_k^T: (9, ceil(Co/64),
    ceil(C/bn), 2, bn, 64) bf16 with bn = ``dx_tile_c(C)``, each (tap, Co
    chunk, C tile) one bulk copy of its hi then lo tiles, rows of input
    channels with 64 output-gradient channels each, zero-padded and
    swizzled.  The plain version of the layout kernel that
    ``csrc/dcn_bwd_dx.cu`` launches first."""
    _, _, C, Co = weight.shape
    bn = dx_tile_c(C)
    ct, cc = math.ceil(C / bn), math.ceil(Co / _CHUNK)
    w = _pad(weight.reshape(9, C, Co), {1: ct * bn, 2: cc * _CHUNK})
    w = w.view(9, ct, bn, cc, _CHUNK).permute(0, 3, 1, 2, 4)         # (9, cc, ct, bn, 64)
    return swizzle_128b(_parts(w, DX_PARTS, bf16_math).permute(1, 2, 3, 0, 4, 5)).contiguous()


def _fwd_kernel(xt: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, bias: Optional[torch.Tensor], max_offset: int,
                epilogue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                bf16_math: bool = False, round_x: bool = False) -> torch.Tensor:
    """Launch dcn_fwd on x in its transfer dtype (bf16 under bf16 math), or
    on f32 x that the kernel rounds to bf16 as it loads it (``round_x``),
    with the BN+ReLU epilogue when given (scale, shift), at the tile
    ``fwd_tile_n`` picks; the caller has checked the operands and counts the
    launch."""
    B, H, W, C = xt.shape
    Co = weight.shape[3]
    if round_x and xt.dtype != torch.float32:
        raise ValueError("dcn_fwd: round_x takes float32 x")
    scale, shift = epilogue or (None, None)
    bn = fwd_tile_n(Co)
    # scratch for W's split and layout, which the kernel's first launch writes
    w_img = torch.empty(fwd_image_numel(C, Co, bn), device=xt.device, dtype=torch.bfloat16)
    out = torch.empty((B, H, W, Co), device=xt.device, dtype=torch.float32)
    _launch("dcn_fwd", xt, xt.data_ptr(), int(xt.dtype == torch.bfloat16), int(round_x),
            int(bf16_math), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
            w_img.data_ptr(), FWD_PARTS, bn, _ptr(bias), _ptr(scale), _ptr(shift), out.data_ptr(), B, H, W,
            C, Co, float(max_offset))
    return out


def _count(wrapper, bf16_math: bool) -> None:
    if bf16_math:
        wrapper.bf16_math_launches += 1
    else:
        wrapper.launches += 1


def _count_wide(wrapper, Co: int) -> None:
    """``wrapper.wide_launches``: its dcn_fwd launches whose block covers 256
    output channels (``fwd_tile_n``)."""
    if fwd_tile_n(Co) == 256:
        wrapper.wide_launches += 1


def _math_x(x: torch.Tensor, bf16_math: bool) -> torch.Tensor:
    """x as the kernels read it: bf16 under bf16 window math, else as given."""
    return x.to(torch.bfloat16) if bf16_math else x


def dcn_bwd_dx(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
               weight: torch.Tensor, g: torch.Tensor, *, max_offset: int,
               compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dx (B,H,W,C) float32 for the output gradient g (B,H,W,Co) float32.

    x is the forward's input as its kernel read it (float32, or bfloat16
    under bf16 transfer); only its shape is used: dx does not depend on x.
    On a CUDA tensor, up to ceil(R) = DX_MAX_REACH (11) the kernel gathers,
    for each output pixel, the corners that land on it from a halo of g in
    shared memory and contracts W_k^T on the tensor cores; beyond, its wide
    path contracts first (u = g W^T) and gathers u from device memory
    (plain version: ``ops/dcn.py::modulated_deform_conv_dx_wide``).  Every
    sum runs in a fixed order, so two launches are bit-equal.  It raises
    ValueError, naming R, for ceil(R) > DX_WIDE_MAX_REACH (127), where the
    wide path's one-byte floor codes end.  ``dcn_bwd_dx.launches``
    (``.bf16_math_launches`` under ``compute_dtype=bfloat16``) counts kernel
    launches, of either path.
    """
    _check_grad_inputs(x, offset, mask, weight, g)
    bf16_math = check_compute_dtype(compute_dtype)
    if x.device.type == "cpu":
        return modulated_deform_conv_backward(x.float(), offset, mask, weight, g,
                                              max_offset=max_offset, compute_dtype=compute_dtype,
                                              wrt=("x",))[0]
    _check_device("dcn_bwd_dx", x)
    B, H, W, C = x.shape
    Co = weight.shape[3]
    _check_kernel_operands("dcn_bwd_dx", B, H, W, C, Co, offset=offset, mask=mask,
                           weight=weight, g=g)
    reach = math.ceil(max_offset)
    if not 0 <= reach <= DX_WIDE_MAX_REACH:
        raise ValueError(f"dcn_bwd_dx: max_offset R = {max_offset} does not fit the kernel: its "
                         f"floor codes take |floor(offset)| <= {DX_WIDE_MAX_REACH}")
    # every element of dx is written once: no zeroing
    dx = torch.empty((B, H, W, C), device=x.device, dtype=torch.float32)
    if reach > DX_MAX_REACH:
        code = torch.empty((B, H, W, 9), device=x.device, dtype=torch.int16)
        u = torch.empty((B, H, W, 9, C), device=x.device, dtype=torch.float32)
        _launch("dcn_bwd_dx", x, int(bf16_math), offset.data_ptr(), mask.data_ptr(),
                weight.data_ptr(), g.data_ptr(), code.data_ptr(), u.data_ptr(), dx.data_ptr(),
                B, H, W, C, Co, float(max_offset), reach, symbol="dcn_bwd_dx_wide")
        _count(dcn_bwd_dx, bf16_math)
        return dx
    w_img = torch.empty(dx_image_numel(C, Co), device=x.device, dtype=torch.bfloat16)
    _launch("dcn_bwd_dx", x, int(bf16_math), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), w_img.data_ptr(), DX_PARTS, dx_tile_c(C), dx_smem_bytes(reach, C),
            g.data_ptr(), dx.data_ptr(), B, H, W, C, Co, float(max_offset), reach)
    _count(dcn_bwd_dx, bf16_math)
    return dx


def dw_tile_n(Co: int) -> int:
    """dcn_bwd_dwmo's dW output channels per block: the largest of 256, 128
    and 64 that divides Co padded to a multiple of 64."""
    padded = math.ceil(Co / _CHUNK) * _CHUNK
    return next(n for n in (256, 128, 64) if padded % n == 0)


def dw_splits(npix: int, C: int, Co: int) -> int:
    """How many pixel slices dcn_bwd_dwmo reduces dW over (one partial each)."""
    bn = dw_tile_n(Co)
    tiles = 9 * math.ceil(C / _DW_C_TILE) * math.ceil(Co / bn)
    slots = _SMS * {256: 1, 128: 2, 64: 3}[bn]
    return max(1, min(math.ceil(npix / _DW_TILE_PIXELS), 2 * slots // tiles))


def dcn_bwd_dwmo(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                 weight: torch.Tensor, g: torch.Tensor, *, max_offset: int,
                 compute_dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dmask (B,H,W,9), dweight (3,3,C,Co), doffset (B,H,W,18)), float32,
    evaluated at x as the forward's kernel read it (float32, or bfloat16
    under bf16 transfer; x is rounded to bf16 under bf16 window math).
    ``dcn_bwd_dwmo.launches`` (``.bf16_math_launches`` under
    ``compute_dtype=bfloat16``) counts calls that launch the kernels.
    """
    _check_grad_inputs(x, offset, mask, weight, g)
    bf16_math = check_compute_dtype(compute_dtype)
    if x.device.type == "cpu":
        _, doffset, dmask, dweight, _ = modulated_deform_conv_backward(
            x.float(), offset, mask, weight, g, max_offset=max_offset,
            compute_dtype=compute_dtype, wrt=("offset", "mask", "weight"))
        return dmask, dweight, doffset
    _check_device("dcn_bwd_dwmo", x)
    x = _math_x(x, bf16_math)
    B, H, W, C = x.shape
    Co = weight.shape[3]
    _check_kernel_operands("dcn_bwd_dwmo", B, H, W, C, Co, x=x, offset=offset, mask=mask,
                           weight=weight, g=g)
    if Co > _MAX_MO_CO:
        raise ValueError(f"dcn_bwd_dwmo: Co = {Co} > {_MAX_MO_CO}, the most its dmask/doffset "
                         f"kernel stages in shared memory")
    nsplit = dw_splits(B * H * W, C, Co)
    if nsplit * 9 * C * Co > _INT32_MAX:
        raise ValueError(f"dcn_bwd_dwmo: {nsplit} dW partials of {(9, C, Co)} overflow "
                         f"32-bit indices")
    new = dict(device=x.device, dtype=torch.float32)
    dmask = torch.empty((B, H, W, 9), **new)
    doffset = torch.empty((B, H, W, 18), **new)
    dw_partial = torch.empty((nsplit, 9, C, Co), **new)
    dweight = torch.empty((3, 3, C, Co), **new)
    w_img = torch.empty(dwmo_image_numel(C, Co), **{**new, "dtype": torch.bfloat16})
    _launch("dcn_bwd_dwmo", x, x.data_ptr(), int(x.dtype == torch.bfloat16), int(bf16_math),
            offset.data_ptr(), mask.data_ptr(), weight.data_ptr(), w_img.data_ptr(), g.data_ptr(),
            dmask.data_ptr(), doffset.data_ptr(), dw_partial.data_ptr(), dweight.data_ptr(),
            nsplit, dw_tile_n(Co), B, H, W, C, Co, float(max_offset))
    _count(dcn_bwd_dwmo, bf16_math)
    return dmask, dweight, doffset


def dcn_backward(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                 weight: torch.Tensor, g: torch.Tensor, *, max_offset: int,
                 compute_dtype: torch.dtype = torch.float32):
    """(dx, doffset, dmask, dweight, dbias) of the DCN for the output gradient
    g: ``dcn_bwd_dx``, ``dcn_bwd_dwmo`` and the sum of g, the counterpart of
    ``monoflex_tpu/ops/dcn_pallas_bwd.py::dcn_pallas_bwd``.  Both kernels sum
    in a fixed order (no atomics): two launches are bit-equal."""
    dx = dcn_bwd_dx(x, offset, mask, weight, g, max_offset=max_offset,
                    compute_dtype=compute_dtype)
    dmask, dweight, doffset = dcn_bwd_dwmo(x, offset, mask, weight, g, max_offset=max_offset,
                                           compute_dtype=compute_dtype)
    return dx, doffset, dmask, dweight, g.sum(dim=(0, 1, 2))


def _transfer_x(x: torch.Tensor, transfer_dtype: torch.dtype) -> torch.Tensor:
    """x as the kernels take it: a bf16 x as it is (exact in either transfer
    dtype), an f32 x cast to the transfer dtype."""
    return x if x.dtype == torch.bfloat16 else x.to(transfer_dtype)


def _check_bounded(max_offset) -> None:
    if max_offset is None:
        raise ValueError("the DCN kernels clamp the offsets: max_offset=None (the unbounded "
                         "'gather' op) has no kernel; call ops.dcn.modulated_deform_conv")


class DCNFunction(torch.autograd.Function):
    """DCNv2 with the kernels' forward and backward (the plain op's on CPU
    tensors).  It saves x already rounded to the transfer dtype (half the
    residual under bf16) and no im2col."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, max_offset, transfer_dtype, compute_dtype):
        bf16_math = check_compute_dtype(compute_dtype)
        xt = _math_x(_transfer_x(x, transfer_dtype), bf16_math)
        if x.device.type == "cpu":
            out = modulated_deform_conv(xt.float(), offset, mask, weight, bias,
                                        max_offset=max_offset, compute_dtype=compute_dtype)
        else:
            out = _fwd_kernel(xt, offset, mask, weight, bias, max_offset, bf16_math=bf16_math)
            _count(dcn_forward, bf16_math)
            _count_wide(dcn_forward, weight.shape[3])
        ctx.save_for_backward(xt, offset, mask, weight)
        ctx.max_offset = max_offset
        ctx.compute_dtype = compute_dtype
        ctx.has_bias = bias is not None
        return out

    @staticmethod
    def backward(ctx, g):
        xt, offset, mask, weight = ctx.saved_tensors
        g = g.contiguous()
        kw = dict(max_offset=ctx.max_offset, compute_dtype=ctx.compute_dtype)
        if g.device.type == "cpu":
            dx, doffset, dmask, dweight, dbias = modulated_deform_conv_backward(
                xt.float(), offset, mask, weight, g, **kw)
        else:
            dx, doffset, dmask, dweight, dbias = dcn_backward(xt, offset, mask, weight, g, **kw)
        return dx, doffset, dmask, dweight, dbias if ctx.has_bias else None, None, None, None


def _rounds_x(x: torch.Tensor, transfer_dtype: torch.dtype) -> bool:
    """Whether dcn_fwd rounds x to bf16 as it loads it: an f32 x under bf16
    transfer (a bf16 x arrives rounded)."""
    return x.dtype == torch.float32 and transfer_dtype == torch.bfloat16


def dcn_forward(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                max_offset: int,
                transfer_dtype: torch.dtype = torch.float32,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """DCNv2 forward with the kernels' gradient, same contract as
    ``ops.dcn.modulated_deform_conv``.

    CUDA tensors go through the kernels, which take contiguous operands on
    one device, x cast to ``transfer_dtype`` (float32 or bfloat16; bfloat16
    under ``compute_dtype=bfloat16``, the bf16 window math; a bf16 x as it
    is) and indices that fit in 32 bits.  ``max_offset`` must be a bound.
    ``dcn_forward.launches`` (``.bf16_math_launches``) counts forward kernel
    launches, ``.wide_launches`` those (of either) on the wide tile.
    """
    check_dcn_inputs(x, offset, mask, weight, bias, x_dtypes=COMPUTE_DTYPES)
    _check_bounded(max_offset)
    if transfer_dtype not in _TRANSFER_DTYPES:
        raise ValueError(f"transfer_dtype must be one of {_TRANSFER_DTYPES}, got {transfer_dtype}")
    check_compute_dtype(compute_dtype)
    if x.device.type != "cpu":
        _check_device("dcn_forward", x)
        _check_kernel_operands("dcn_fwd", *x.shape, weight.shape[3], x=x, offset=offset,
                               mask=mask, weight=weight, bias=bias)
        needs_grad = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, offset, mask, weight, bias))
        if not needs_grad and compute_dtype == torch.float32:
            # no residual to save: the kernel rounds f32 x to the transfer dtype
            out = _fwd_kernel(x, offset, mask, weight, bias, max_offset,
                              round_x=_rounds_x(x, transfer_dtype))
            dcn_forward.launches += 1
            _count_wide(dcn_forward, weight.shape[3])
            return out
    return DCNFunction.apply(x, offset, mask, weight, bias, max_offset, transfer_dtype,
                             compute_dtype)


def dcn_forward_bn_relu(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                        weight: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
                        max_offset: int,
                        transfer_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """relu(DCN(x; no bias) * scale + shift), the eval BN+ReLU fused into
    dcn_fwd's output write (``ops.dcn.modulated_deform_conv_bn_relu`` on a
    CPU tensor).  Inference only, as the JAX epilogue has no VJP: it raises
    if autograd would need a gradient of any operand.
    ``dcn_forward_bn_relu.launches`` counts kernel launches, ``.wide_launches``
    those on the wide tile."""
    check_dcn_inputs(x, offset, mask, weight, None, x_dtypes=COMPUTE_DTYPES)
    check_epilogue(x, weight, scale, shift)
    _check_bounded(max_offset)
    if transfer_dtype not in _TRANSFER_DTYPES:
        raise ValueError(f"transfer_dtype must be one of {_TRANSFER_DTYPES}, got {transfer_dtype}")
    operands = (x, offset, mask, weight, scale, shift)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError("dcn_forward_bn_relu is inference-only: it has no gradient; run "
                           "it under torch.no_grad() or torch.inference_mode()")
    if x.device.type == "cpu":
        return modulated_deform_conv_bn_relu(*operands, max_offset=max_offset,
                                             transfer_dtype=transfer_dtype)
    _check_device("dcn_forward_bn_relu", x)
    _check_kernel_operands("dcn_fwd", *x.shape, weight.shape[3], x=x, offset=offset, mask=mask,
                           weight=weight, scale=scale, shift=shift)
    out = _fwd_kernel(x, offset, mask, weight, None, max_offset, epilogue=(scale, shift),
                      round_x=_rounds_x(x, transfer_dtype))
    dcn_forward_bn_relu.launches += 1
    _count_wide(dcn_forward_bn_relu, weight.shape[3])
    return out


for _wrapper in (dcn_forward, dcn_bwd_dx, dcn_bwd_dwmo):
    _wrapper.launches = 0
    _wrapper.bf16_math_launches = 0
dcn_forward_bn_relu.launches = 0
dcn_forward.wide_launches = dcn_forward_bn_relu.wide_launches = 0

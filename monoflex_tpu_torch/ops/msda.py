"""Multi-scale deformable attention (MSDA) forward: the plain op and the
Hopper kernel, for BEVFormer (``models/bevformer.py``).

The JAX package has no counterpart: no model of it attends deformably, so
this kernel replaces no Pallas kernel.  It is the sampling core of
Deformable DETR's ``MultiScaleDeformableAttnFunction`` (mmcv's
``ms_deform_attn_cuda``), generalised to the three ways BEVFormer calls it:

- ``value`` (G, S, H, D): G value maps ("groups": the six cameras of the
  spatial cross-attention, the two BEV queues of the temporal
  self-attention, the one BEV of the decoder), each of S keys that hold the
  levels' maps one after another, row-major, H heads of D = 32 channels;
- ``shapes``: the levels' (H_l, W_l), host integers;
- ``ref`` (G, Q, A, 2) float32: each query's reference point (x, y) in
  [0, 1] in each group, A anchors (the point p of a level takes anchor
  p % A: the spatial cross-attention's 8 points are 2 around each of its 4
  pillar heights);
- ``offsets`` (Q, H, Go, L, P, 2) float32, in cells of each level (Go = G,
  or 1 for offsets every group shares): the location is ref + offset /
  (W_l, H_l);
- ``weights`` (Q, H, Gw, L, P) float32 (Gw = G or 1), already softmaxed;
- ``mask`` (G, Q) bool or None: where given, a query sums over the groups
  whose mask is set and divides by their count (at least 1), the spatial
  cross-attention's cameras that see a BEV cell; without it every group
  counts and the sum is multiplied by ``scale`` (0.5: the mean of the two
  BEV queues).

A sample is bilinear with zero padding, at ``align_corners=False``
(``F.grid_sample``'s and mmcv's convention: pixel x * W_l - 0.5).  The
result is (Q, H * D), summed in float32 and written in the value's dtype
(``msda_plain`` may write it in another, ``out_dtype``).

``msda_plain`` is the op in PyTorch (``F.grid_sample`` level by level, as
mmcv's ``multi_scale_deformable_attn_pytorch``); ``msda_forward`` launches
the kernel (``csrc/msda/msda_fwd.cu``) on CUDA tensors and runs the plain op
on CPU tensors, with no fallback from one to the other.
``msda_forward.launches`` counts its kernel launches.

What bounds the kernel on the card: the gathers.  At BEVFormer-base's
spatial cross-attention a layer reads about 15 M bilinear samples (four
corners of 32 bf16 channels each) scattered over a 95 MB value map, larger
than the 50 MB L2, for 0.5 GFLOP of blending.  Its design: one thread
block of 256 threads walks 32 (query, head) pairs, 8 lanes a pair, 4
channels a lane, so a corner is one 8-byte load a lane and 64 contiguous
bytes a pair; a query's groups, levels and points are a loop in its lanes
(a camera that does not see the cell costs one byte of mask), and its
locations are formed from the reference points and offsets in the kernel,
so no (G, Q, H, L, P, 2) location tensor is written to device memory.
Consecutive blocks take neighbouring BEV cells, which sample neighbouring
pixels of the same camera.

The library is built with nvcc for sm_90a on first use into
``_build/msda-<hash>/`` (the hash covers the source and the flags) and
bound with ctypes, apart from the DCN kernels (``ops/dcn_cuda.py``): only a
model that calls this op builds or loads it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .dcn_cuda import BUILD_DIR, NVCC_FLAGS, _nvcc

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "msda" / "msda_fwd.cu"
HEAD_DIM = 32        # the kernel's channels a head (8 lanes x 4)
MAX_LEVELS = 4

_vp, _i32, _i64, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_vp, _i32, _i64, _vp, _i32, _i32, _i32,      # value, bf16, its group stride,
                                                           # shapes, L, H, P
             _vp, _i64, _i32,                              # ref, group stride, anchors
             _vp, _i32, _i32, _i32,                        # offsets and their q, h, g strides
             _vp, _i32, _i32, _i32,                        # weights and theirs
             _vp, _i32, _i32, _f32,                        # mask, groups, queries, scale
             _vp, _vp]                                     # out, stream
_lib: Optional[ctypes.CDLL] = None


def build_dir() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"msda-{digest.hexdigest()[:16]}"


def build() -> ctypes.CDLL:
    """Compile (once per hash of the source and flags) and load the kernel
    library; nvcc's ptxas log lies beside it."""
    global _lib
    if _lib is not None:
        return _lib
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "msda_fwd.so"
    if not so.exists():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        so.with_suffix(".log").write_text(proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on msda_fwd.cu:\n{proc.stdout}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.msda_fwd.argtypes = _ARGTYPES
    lib.msda_fwd.restype = _i32
    _lib = lib
    return lib


def _check(value, shapes, ref, offsets, weights, mask) -> Tuple[int, int, int, int, int, int]:
    """(G, Q, H, L, P, A) of consistent operands; raises otherwise."""
    if value.dim() != 4:
        raise ValueError(f"value must be (groups, keys, heads, dim), got {tuple(value.shape)}")
    G, S, H, D = value.shape
    L = len(shapes)
    if not 1 <= L <= MAX_LEVELS or sum(h * w for h, w in shapes) != S:
        raise ValueError(f"levels {list(shapes)} do not hold the value's {S} keys")
    if offsets.dim() != 6 or offsets.shape[1] != H or offsets.shape[2] not in (1, G) \
            or offsets.shape[3] != L or offsets.shape[5] != 2:
        raise ValueError(f"offsets must be (Q, {H}, 1 or {G}, {L}, P, 2), got "
                         f"{tuple(offsets.shape)}")
    Q, P = offsets.shape[0], offsets.shape[4]
    if weights.dim() != 5 or weights.shape[0] != Q or weights.shape[1] != H \
            or weights.shape[2] not in (1, G) or tuple(weights.shape[3:]) != (L, P):
        raise ValueError(f"weights must be ({Q}, {H}, 1 or {G}, {L}, {P}), got "
                         f"{tuple(weights.shape)}")
    if ref.dim() != 4 or ref.shape[0] != G or ref.shape[1] != Q or ref.shape[3] != 2 \
            or P % ref.shape[2]:
        raise ValueError(f"ref must be ({G}, {Q}, anchors dividing {P}, 2), got "
                         f"{tuple(ref.shape)}")
    if mask is not None and tuple(mask.shape) != (G, Q):
        raise ValueError(f"mask must be ({G}, {Q}), got {tuple(mask.shape)}")
    return G, Q, H, L, P, ref.shape[2]


def msda_plain(value: torch.Tensor, shapes: Sequence[Tuple[int, int]], ref: torch.Tensor,
               offsets: torch.Tensor, weights: torch.Tensor, mask: Optional[torch.Tensor] = None,
               scale: float = 1.0, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The op in PyTorch, in float32 (module docstring)."""
    G, Q, H, L, P, A = _check(value, shapes, ref, offsets, weights, mask)
    D = value.shape[3]
    acc = value.new_zeros(H, D, Q, dtype=torch.float32)
    anchor = torch.arange(P, device=value.device) % A
    start = 0
    levels = []
    for h, w in shapes:
        levels.append((start, h, w))
        start += h * w
    for g in range(G):
        part = torch.zeros_like(acc)
        og = offsets[:, :, g if offsets.shape[2] > 1 else 0].float()        # (Q, H, L, P, 2)
        wg = weights[:, :, g if weights.shape[2] > 1 else 0].float()        # (Q, H, L, P)
        rg = ref[g].float()[:, anchor]                                       # (Q, P, 2)
        for l, (s, h, w) in enumerate(levels):
            v = value[g, s:s + h * w].float().permute(1, 2, 0).reshape(H, D, h, w)
            norm = torch.tensor([w, h], dtype=torch.float32, device=value.device)
            loc = rg[:, None] + og[:, :, l] / norm                           # (Q, H, P, 2)
            grid = (2 * loc - 1).permute(1, 0, 2, 3)                         # (H, Q, P, 2)
            got = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=False)                        # (H, D, Q, P)
            part += (got * wg[:, :, l].permute(1, 0, 2)[:, None]).sum(-1)
        if mask is not None:
            part = part * mask[g].to(part.dtype)
        acc += part
    if mask is not None:
        acc = acc / mask.sum(0).clamp(min=1).to(acc.dtype)
    else:
        acc = acc * scale
    return acc.permute(2, 0, 1).reshape(Q, H * D).to(out_dtype or value.dtype)


def msda_forward(value: torch.Tensor, shapes: Sequence[Tuple[int, int]], ref: torch.Tensor,
                 offsets: torch.Tensor, weights: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, scale: float = 1.0) -> torch.Tensor:
    """The op, written in the value's dtype: the kernel on CUDA tensors,
    ``msda_plain`` on CPU tensors."""
    if value.device.type == "cpu":
        return msda_plain(value, shapes, ref, offsets, weights, mask, scale)
    if value.device.type != "cuda":
        raise ValueError(f"msda_forward runs on cpu or cuda tensors, not {value.device}")
    G, Q, H, L, P, A = _check(value, shapes, ref, offsets, weights, mask)
    if value.shape[3] != HEAD_DIM or value.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel takes float32 or bfloat16 heads of {HEAD_DIM} channels, "
                         f"got {value.dtype} heads of {value.shape[3]}")
    for name, t in (("ref", ref), ("offsets", offsets), ("weights", weights)):
        if t.dtype != torch.float32 or t.device != value.device:
            raise ValueError(f"{name} must be float32 on {value.device}")
    value, ref = value.contiguous(), ref.contiguous()
    offsets, weights = offsets.contiguous(), weights.contiguous()
    if mask is not None:
        mask = mask.to(torch.uint8).contiguous()
    out = torch.empty(Q, H * HEAD_DIM, dtype=value.dtype, device=value.device)
    Go, Gw = offsets.shape[2], weights.shape[2]
    dims = (ctypes.c_int * (2 * L))(*[int(v) for hw in shapes for v in hw])
    lib = build()
    with torch.cuda.device(value.device):
        err = lib.msda_fwd(
            value.data_ptr(), int(value.dtype == torch.bfloat16), value[0].numel(), dims, L, H, P,
            ref.data_ptr(), ref[0].numel(), A,
            offsets.data_ptr(), offsets[0].numel(), offsets[0, 0].numel(),
            offsets[0, 0, 0].numel() if Go > 1 else 0,
            weights.data_ptr(), weights[0].numel(), weights[0, 0].numel(),
            weights[0, 0, 0].numel() if Gw > 1 else 0,
            None if mask is None else mask.data_ptr(), G, Q, float(scale),
            out.data_ptr(), torch.cuda.current_stream(value.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"msda_fwd launch failed: CUDA error {err}")
    msda_forward.launches += 1
    return out


msda_forward.launches = 0

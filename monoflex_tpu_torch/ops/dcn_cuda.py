"""The Hopper DCNv2 kernels: build, ctypes bindings, launch wrappers and the
autograd Function the model calls.

Three hand-written kernels, each in its own ``csrc/*.cu``:

- ``dcn_fwd.cu`` replaces ``monoflex_tpu/ops/dcn_pallas_v3.py::dcn_pallas_v3``,
  with its optional eval BN+ReLU epilogue (``dcn_forward_bn_relu``);
- ``dcn_bwd_dx.cu`` replaces ``dcn_pallas_v5_bwd_dx`` (and its siblings
  dx3/dx4, which compute the same dx);
- ``dcn_bwd_dwmo.cu`` replaces ``dcn_pallas_v3_bwd_dwmo`` (dmask, dW and
  doffset in one call).

``dcn_forward`` is the op the model calls: ``DCNFunction``, whose forward is
``dcn_fwd`` and whose backward is ``dcn_bwd_dx`` + ``dcn_bwd_dwmo`` + a torch
sum of g for the bias.  ``dcn_forward_bn_relu`` is the fused eval BN+ReLU
forward, inference-only like the JAX path (no gradient).  The v1 and v2 TPU
generations compute the same functions; the model routes them here with
float32 transfer.  Each wrapper launches its kernel on a CUDA tensor or
raises; on a CPU tensor it runs the plain PyTorch version in ``ops/dcn.py``.
There is no fallback from one to the other.  ``<wrapper>.launches`` counts a
wrapper's kernel launches.

Every source is compiled by nvcc for sm_90a on first use, one nvcc per source
started together, into ``_build/<hash>/`` next to the package, where the hash
covers all the sources and the flags; each library is loaded with ctypes.
Nothing is built or loaded at import time.
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

from .dcn import (check_dcn_inputs, check_epilogue, modulated_deform_conv,
                  modulated_deform_conv_backward, modulated_deform_conv_bn_relu)

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_TRANSFER_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2**31 - 1
# dcn_bwd_dwmo splits the dW pixel reduction so that about this many blocks
# run (8 per SM of an H100), with at least 32 pixels (one staged tile) each
_DW_TARGET_BLOCKS = 8 * 132
_DW_TILE_PIXELS = 32
_DW_CO_TILE, _DW_C_TILE = 64, 64

_vp, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "dcn_fwd": [_vp, _i32, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32,
                _f32, _vp],
    "dcn_bwd_dx": [_vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _f32, _vp],
    "dcn_bwd_dwmo": [_vp, _i32, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32,
                     _i32, _i32, _i32, _i32, _i32, _f32, _vp],
}

_libs: Optional[Dict[str, ctypes.CDLL]] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc") or (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not found or not os.path.exists(found):
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH or set CUDA_HOME")
    return found


def build() -> Dict[str, ctypes.CDLL]:
    """Compile (once per hash of the sources and flags) and load every
    kernel library; returns them by kernel name."""
    global _libs
    if _libs is not None:
        return _libs
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode() + src.read_bytes())
    out_dir = BUILD_DIR / digest.hexdigest()[:16]
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
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
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


def _launch(name: str, x: torch.Tensor, *args) -> None:
    lib = build()
    with torch.cuda.device(x.device):
        err = getattr(lib[name], name)(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _fwd_kernel(xt: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, bias: Optional[torch.Tensor], max_offset: int,
                epilogue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Launch dcn_fwd on x already in its transfer dtype, with the BN+ReLU
    epilogue when given (scale, shift); the caller has checked the operands
    and counts the launch."""
    B, H, W, C = xt.shape
    Co = weight.shape[3]
    scale, shift = epilogue or (None, None)
    out = torch.empty((B, H, W, Co), device=xt.device, dtype=torch.float32)
    _launch("dcn_fwd", xt, xt.data_ptr(), int(xt.dtype == torch.bfloat16), offset.data_ptr(),
            mask.data_ptr(), weight.data_ptr(), _ptr(bias), _ptr(scale), _ptr(shift),
            out.data_ptr(), B, H, W, C, Co, float(max_offset))
    return out


def dcn_bwd_dx(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
               weight: torch.Tensor, g: torch.Tensor, *, max_offset: int) -> torch.Tensor:
    """dx (B,H,W,C) float32 for the output gradient g (B,H,W,Co) float32.

    x is the forward's input as its kernel read it (float32, or bfloat16
    under bf16 transfer); only its shape is used: dx does not depend on x.
    ``dcn_bwd_dx.launches`` counts kernel launches.
    """
    _check_grad_inputs(x, offset, mask, weight, g)
    if x.device.type == "cpu":
        return modulated_deform_conv_backward(x.float(), offset, mask, weight, g,
                                              max_offset=max_offset, wrt=("x",))[0]
    _check_device("dcn_bwd_dx", x)
    B, H, W, C = x.shape
    Co = weight.shape[3]
    _check_kernel_operands("dcn_bwd_dx", B, H, W, C, Co, offset=offset, mask=mask,
                           weight=weight, g=g)
    dx = torch.zeros((B, H, W, C), device=x.device, dtype=torch.float32)
    _launch("dcn_bwd_dx", x, offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
            g.data_ptr(), dx.data_ptr(), B, H, W, C, Co, float(max_offset))
    dcn_bwd_dx.launches += 1
    return dx


def dw_splits(npix: int, C: int, Co: int) -> int:
    """How many pixel slices dcn_bwd_dwmo reduces dW over (one partial each)."""
    tiles = 9 * math.ceil(C / _DW_C_TILE) * math.ceil(Co / _DW_CO_TILE)
    return max(1, min(math.ceil(npix / _DW_TILE_PIXELS), math.ceil(_DW_TARGET_BLOCKS / tiles)))


def dcn_bwd_dwmo(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                 weight: torch.Tensor, g: torch.Tensor, *, max_offset: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dmask (B,H,W,9), dweight (3,3,C,Co), doffset (B,H,W,18)), float32,
    evaluated at x as the forward's kernel read it (float32, or bfloat16
    under bf16 transfer).  ``dcn_bwd_dwmo.launches`` counts calls that
    launch the kernels.
    """
    _check_grad_inputs(x, offset, mask, weight, g)
    if x.device.type == "cpu":
        _, doffset, dmask, dweight, _ = modulated_deform_conv_backward(
            x.float(), offset, mask, weight, g, max_offset=max_offset,
            wrt=("offset", "mask", "weight"))
        return dmask, dweight, doffset
    _check_device("dcn_bwd_dwmo", x)
    B, H, W, C = x.shape
    Co = weight.shape[3]
    _check_kernel_operands("dcn_bwd_dwmo", B, H, W, C, Co, x=x, offset=offset, mask=mask,
                           weight=weight, g=g)
    nsplit = dw_splits(B * H * W, C, Co)
    if nsplit * 9 * C * Co > _INT32_MAX:
        raise ValueError(f"dcn_bwd_dwmo: {nsplit} dW partials of {(9, C, Co)} overflow "
                         f"32-bit indices")
    new = dict(device=x.device, dtype=torch.float32)
    dmask = torch.empty((B, H, W, 9), **new)
    doffset = torch.empty((B, H, W, 18), **new)
    dw_partial = torch.empty((nsplit, 9, C, Co), **new)
    dweight = torch.empty((3, 3, C, Co), **new)
    _launch("dcn_bwd_dwmo", x, x.data_ptr(), int(x.dtype == torch.bfloat16),
            offset.data_ptr(), mask.data_ptr(), weight.data_ptr(), g.data_ptr(),
            dmask.data_ptr(), doffset.data_ptr(), dw_partial.data_ptr(), dweight.data_ptr(),
            nsplit, B, H, W, C, Co, float(max_offset))
    dcn_bwd_dwmo.launches += 1
    return dmask, dweight, doffset


class DCNFunction(torch.autograd.Function):
    """DCNv2 with the kernels' forward and backward (the plain op's on CPU
    tensors).  It saves x already rounded to the transfer dtype (half the
    residual under bf16) and no im2col."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, max_offset, transfer_dtype):
        xt = x.to(transfer_dtype)
        if x.device.type == "cpu":
            out = modulated_deform_conv(xt.float(), offset, mask, weight, bias,
                                        max_offset=max_offset)
        else:
            out = _fwd_kernel(xt, offset, mask, weight, bias, max_offset)
            dcn_forward.launches += 1
        ctx.save_for_backward(xt, offset, mask, weight)
        ctx.max_offset = max_offset
        ctx.has_bias = bias is not None
        return out

    @staticmethod
    def backward(ctx, g):
        xt, offset, mask, weight = ctx.saved_tensors
        g = g.contiguous()
        R = ctx.max_offset
        if g.device.type == "cpu":
            dx, doffset, dmask, dweight, dbias = modulated_deform_conv_backward(
                xt.float(), offset, mask, weight, g, max_offset=R)
        else:
            dx = dcn_bwd_dx(xt, offset, mask, weight, g, max_offset=R)
            dmask, dweight, doffset = dcn_bwd_dwmo(xt, offset, mask, weight, g, max_offset=R)
            dbias = g.sum(dim=(0, 1, 2))
        return dx, doffset, dmask, dweight, dbias if ctx.has_bias else None, None, None


def dcn_forward(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                max_offset: int,
                transfer_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """DCNv2 forward with the kernels' gradient, same contract as
    ``ops.dcn.modulated_deform_conv``.

    CUDA tensors go through the kernels, which take contiguous operands on
    one device, x cast to ``transfer_dtype`` (float32 or bfloat16) and
    indices that fit in 32 bits.  ``dcn_forward.launches`` counts forward
    kernel launches.
    """
    check_dcn_inputs(x, offset, mask, weight, bias)
    if transfer_dtype not in _TRANSFER_DTYPES:
        raise ValueError(f"transfer_dtype must be one of {_TRANSFER_DTYPES}, got {transfer_dtype}")
    if x.device.type != "cpu":
        _check_device("dcn_forward", x)
        _check_kernel_operands("dcn_fwd", *x.shape, weight.shape[3], x=x, offset=offset,
                               mask=mask, weight=weight, bias=bias)
    return DCNFunction.apply(x, offset, mask, weight, bias, max_offset, transfer_dtype)


def dcn_forward_bn_relu(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                        weight: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
                        max_offset: int,
                        transfer_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """relu(DCN(x; no bias) * scale + shift), the eval BN+ReLU fused into
    dcn_fwd's output write (``ops.dcn.modulated_deform_conv_bn_relu`` on a
    CPU tensor).  Inference only, as the JAX epilogue has no VJP: it raises
    if autograd would need a gradient of any operand.
    ``dcn_forward_bn_relu.launches`` counts kernel launches."""
    check_dcn_inputs(x, offset, mask, weight, None)
    check_epilogue(x, weight, scale, shift)
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
    out = _fwd_kernel(x.to(transfer_dtype), offset, mask, weight, None, max_offset,
                      epilogue=(scale, shift))
    dcn_forward_bn_relu.launches += 1
    return out


dcn_forward.launches = 0
dcn_forward_bn_relu.launches = 0
dcn_bwd_dx.launches = 0
dcn_bwd_dwmo.launches = 0

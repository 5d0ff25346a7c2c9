"""The Hopper DCNv2 forward kernel: build, ctypes binding and launch wrapper.

``dcn_forward`` is the op the model calls.  For a CPU tensor it runs the plain
PyTorch op (``ops/dcn.py``); for a CUDA tensor it launches the hand-written
kernel in ``csrc/dcn_fwd.cu`` (which replaces the TPU kernel
``monoflex_tpu/ops/dcn_pallas_v3.py::dcn_pallas_v3``) or raises.  There is no
fallback from one to the other.

The kernel is compiled by nvcc for sm_90a on first use, into ``_build/`` next
to the package, under a name keyed on a hash of the source and the flags, and
loaded with ctypes.  Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from .dcn import check_dcn_inputs, modulated_deform_conv

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dcn_fwd.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_TRANSFER_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2**31 - 1

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc") or (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not found or not os.path.exists(found):
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH or set CUDA_HOME")
    return found


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"dcn_fwd-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        # ptxas -v: registers, shared memory and spills of each kernel
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dcn_fwd.argtypes = [vp, i32, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
                            ctypes.c_float, vp]
    lib.dcn_fwd.restype = i32
    _lib = lib
    return lib


def dcn_forward(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                max_offset: int,
                transfer_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """DCNv2 forward, same contract as ``ops.dcn.modulated_deform_conv``.

    CUDA tensors go through the kernel, which takes contiguous operands on one
    device, x cast to ``transfer_dtype`` (float32 or bfloat16) and indices
    that fit in 32 bits.  ``dcn_forward.launches`` counts kernel launches.
    """
    check_dcn_inputs(x, offset, mask, weight, bias)
    if x.device.type == "cpu":
        return modulated_deform_conv(x, offset, mask, weight, bias,
                                     max_offset=max_offset, transfer_dtype=transfer_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_forward runs on cpu or cuda tensors, not {x.device}")
    if transfer_dtype not in _TRANSFER_DTYPES:
        raise ValueError(f"transfer_dtype must be one of {_TRANSFER_DTYPES}, got {transfer_dtype}")
    operands = {"x": x, "offset": offset, "mask": mask, "weight": weight}
    if bias is not None:
        operands["bias"] = bias
    for name, t in operands.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, H, W, C = x.shape
    Co = weight.shape[3]
    if max(x.numel(), offset.numel(), B * H * W * Co) > _INT32_MAX:
        raise ValueError(f"shape {tuple(x.shape)} -> {Co} overflows the kernel's 32-bit indices")

    lib = build()
    with torch.cuda.device(x.device):
        xt = x.to(transfer_dtype)
        out = torch.empty((B, H, W, Co), device=x.device, dtype=torch.float32)
        err = lib.dcn_fwd(xt.data_ptr(), int(transfer_dtype == torch.bfloat16),
                          offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
                          None if bias is None else bias.data_ptr(), out.data_ptr(),
                          B, H, W, C, Co, float(max_offset),
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dcn_fwd launch failed: CUDA error {err}")
    dcn_forward.launches += 1
    return out


dcn_forward.launches = 0

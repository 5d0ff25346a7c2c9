"""The KITTI evaluator's C++ fast path (a copy of the JAX package's
``monoflex_tpu/native``): rotated BEV, 3D and 2D box overlaps and the
per-image true/false-positive counts over every score threshold, loaded with
ctypes.

``load_native()`` compiles ``src/rotate_iou.cpp`` with g++ at first use into
``monoflex_tpu_torch/_build/native/`` (gitignored; the library's name carries
a hash of the source and the flags) and returns the library, or None where
no compiler is found; the evaluator (``eval/rotate_iou.py``, ``eval/ap.py``)
then runs its numpy path, as the JAX package does.  It logs once which path
it took; ``evaluator_path()`` says which.  ``numpy_only()`` makes the
evaluator take its numpy path while it is active (the tests and
``chip_smoke.py`` compare the two).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "src" / "rotate_iou.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
# no -march=native: the library lives in the checkout, which may be copied
# to another host whose CPU lacks this one's instructions
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
# the detections of one image the C++ per-threshold pass takes
MAX_DETECTIONS = 4096

_lib: Optional[ctypes.CDLL] = None
_tried = False
_numpy_only = False
logger = logging.getLogger("monoflex")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"librotate_iou_{digest}.so"


def build_native() -> Optional[Path]:
    """The compiled library's path, compiling it first where it is missing;
    None where g++ is not found or fails (the reason is logged)."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        logger.warning("KITTI evaluator: no g++ on PATH, so no C++ fast path")
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        logger.warning(f"KITTI evaluator: g++ failed on {_SRC.name}:\n{proc.stderr}")
        return None
    os.replace(tmp, lib)
    return lib


def load_native() -> Optional[ctypes.CDLL]:
    """The C++ library (built at first use), or None: no compiler, or inside
    ``numpy_only()``."""
    global _lib, _tried
    if _numpy_only:
        return None
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = build_native()
    if path is not None:
        lib = ctypes.CDLL(str(path))
        dptr = ctypes.POINTER(ctypes.c_double)
        for name in ("rotate_iou_eval", "d3_box_overlap", "image_box_overlap"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [dptr, ctypes.c_long, dptr, ctypes.c_long, ctypes.c_int, dptr]
        lptr = ctypes.POINTER(ctypes.c_long)
        fn = lib.compute_statistics_thresholds
        fn.restype = None
        fn.argtypes = [dptr, dptr, dptr, dptr, dptr, lptr, lptr, dptr, ctypes.c_long,
                       ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_double, dptr,
                       ctypes.c_long, ctypes.c_int, dptr]
        _lib = lib
    logger.info(f"KITTI evaluator: {evaluator_path()} path"
                + (f" ({path})" if path is not None else ""))
    return _lib


def evaluator_path() -> str:
    """"native" where the evaluator runs the C++ library, else "numpy"."""
    return "native" if load_native() is not None else "numpy"


@contextlib.contextmanager
def numpy_only():
    """The evaluator's numpy path while active, whether or not the library
    loads."""
    global _numpy_only
    before, _numpy_only = _numpy_only, True
    try:
        yield
    finally:
        _numpy_only = before


_dptr = ctypes.POINTER(ctypes.c_double)


def _doubles(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float64)


def _call(fn_name: str, boxes: np.ndarray, qboxes: np.ndarray, criterion: int) -> np.ndarray:
    lib = load_native()
    if lib is None:
        raise RuntimeError("the KITTI evaluator's C++ library is not loaded")
    boxes, qboxes = _doubles(boxes), _doubles(qboxes)
    n, k = boxes.shape[0], qboxes.shape[0]
    out = np.zeros((n, k), dtype=np.float64)
    getattr(lib, fn_name)(boxes.ctypes.data_as(_dptr), n, qboxes.ctypes.data_as(_dptr), k,
                          criterion, out.ctypes.data_as(_dptr))
    return out


def rotate_iou_eval_native(boxes, qboxes, criterion=-1):
    return _call("rotate_iou_eval", boxes, qboxes, criterion)


def d3_box_overlap_native(boxes, qboxes, criterion=-1):
    return _call("d3_box_overlap", boxes, qboxes, criterion)


def image_box_overlap_native(boxes, qboxes, criterion=-1):
    return _call("image_box_overlap", boxes, qboxes, criterion)


def compute_statistics_thresholds_native(overlaps, dt_scores, dt_alphas, gt_alphas, dt_bboxes,
                                         ignored_gt, ignored_det, dc_bboxes, metric,
                                         min_overlap, thresholds, compute_aos) -> np.ndarray:
    """(T, 4) tp / fp / fn / similarity of one image over every threshold
    (the C++ pass of ``eval/ap.py::compute_statistics`` at each threshold)."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("the KITTI evaluator's C++ library is not loaded")
    n_dt, n_gt = overlaps.shape if overlaps.size else (len(dt_scores), len(gt_alphas))
    if n_dt > MAX_DETECTIONS:
        raise ValueError(f"{n_dt} detections in one image: the C++ pass takes at most "
                         f"{MAX_DETECTIONS}")
    lptr = ctypes.POINTER(ctypes.c_long)

    def longs(x):
        return np.ascontiguousarray(x, dtype=np.int64)

    ov = (_doubles(overlaps).reshape(n_dt, n_gt) if overlaps.size
          else np.zeros((max(n_dt, 1), max(n_gt, 1))))
    thresholds = _doubles(thresholds)
    pr = np.zeros((len(thresholds), 4), dtype=np.float64)
    args = [_doubles(a) for a in (ov, dt_scores, dt_alphas, gt_alphas, dt_bboxes)]
    ints = [longs(ignored_gt), longs(ignored_det)]
    dc = _doubles(dc_bboxes)
    lib.compute_statistics_thresholds(
        *(a.ctypes.data_as(_dptr) for a in args), *(a.ctypes.data_as(lptr) for a in ints),
        dc.ctypes.data_as(_dptr), n_dt, n_gt, len(dc_bboxes), metric, float(min_overlap),
        thresholds.ctypes.data_as(_dptr), len(thresholds), int(compute_aos),
        pr.ctypes.data_as(_dptr))
    return pr

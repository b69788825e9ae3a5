"""ctypes binding for the native selective video decoder
(native/videodec/videodec.cpp at the repository root; a copy of
``vgqa_tpu/native/videodec.py``, so that the port imports nothing of the JAX
package). Auto-builds the shared library on first use when the libav
toolchain is present; callers fall back to OpenCV when not
(``vgqa_tpu_torch/data/video_io.py``)."""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC_DIR = os.path.join(_REPO_ROOT, "native", "videodec")
_LIB_PATH = os.path.join(_SRC_DIR, "libvideodec.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _SRC_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    # always run make: it is a no-op when libvideodec.so is newer than the
    # source, and rebuilds a stale .so from an older revision that would
    # otherwise be missing the newest entry points (dlopen would then fail
    # symbol binding and silently disable the whole native decoder)
    if os.path.exists(os.path.join(_SRC_DIR, "videodec.cpp")):
        _build()
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    if not hasattr(lib, "vd_read_frames_scaled_yuv_mt"):
        return None
    lib.vd_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.vd_info.restype = ctypes.c_int
    lib.vd_read_frames.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.vd_read_frames.restype = ctypes.c_int
    lib.vd_read_frames_scaled.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.vd_read_frames_scaled.restype = ctypes.c_int
    lib.vd_read_frames_scaled_mt.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.vd_read_frames_scaled_mt.restype = ctypes.c_int
    lib.vd_read_frames_scaled_yuv_mt.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.vd_read_frames_scaled_yuv_mt.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def video_info(path: str) -> Tuple[int, float, int, int]:
    lib = _load()
    assert lib is not None
    frames = ctypes.c_int()
    fps = ctypes.c_double()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.vd_info(
        path.encode(), ctypes.byref(frames), ctypes.byref(fps),
        ctypes.byref(w), ctypes.byref(h),
    )
    if rc != 0:
        raise RuntimeError(f"videodec.vd_info failed ({rc}) for {path}")
    return frames.value, fps.value, w.value, h.value


def default_threads() -> int:
    """Decode-thread count: ``VGQA_DECODE_THREADS`` or the CPU count.
    Each thread owns an independent demux+codec+swscale context over a
    contiguous slice of the wanted frames, so decode scales with cores on
    serving hosts (output is bit-identical to single-thread)."""
    env = os.environ.get("VGQA_DECODE_THREADS")
    if env:
        return max(1, int(env))
    return max(1, os.cpu_count() or 1)


def read_frames(
    path: str,
    frame_ids: List[int],
    size: Optional[Tuple[int, int]] = None,
    threads: Optional[int] = None,
) -> np.ndarray:
    """Decode the listed frames; ``size=(w, h)`` scales inside the same
    swscale pass that converts pixel format (one pass instead of
    decode-then-resize). ``threads`` overrides ``default_threads()``."""
    lib = _load()
    assert lib is not None
    if size is None:
        _, _, w, h = video_info(path)
    else:
        w, h = size
    n = len(frame_ids)
    ids = (ctypes.c_long * n)(*[int(i) for i in frame_ids])
    out = np.empty((n, h, w, 3), dtype=np.uint8)
    rc = lib.vd_read_frames_scaled_mt(
        path.encode(), ids, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
        threads if threads is not None else default_threads(),
    )
    if rc != 0:
        raise RuntimeError(f"videodec.vd_read_frames failed ({rc}) for {path}")
    return out


def read_frames_yuv(
    path: str,
    frame_ids: List[int],
    size: Tuple[int, int],
    threads: Optional[int] = None,
) -> Tuple[np.ndarray, bool]:
    """Decode the listed frames as scaled planar YUV420P (I420): returns
    ``(frames [n, h*w*3//2] uint8, full_range)``. Half the bytes of the RGB
    path — for serving links where host-to-device upload is the
    bottleneck; the caller converts to RGB on-device
    (inference/grounding.py). ``size=(w, h)`` must be even."""
    lib = _load()
    assert lib is not None
    w, h = size
    if w % 2 or h % 2:
        raise ValueError(f"YUV420 decode needs even dims, got {(w, h)}")
    n = len(frame_ids)
    ids = (ctypes.c_long * n)(*[int(i) for i in frame_ids])
    out = np.empty((n, (h * w * 3) // 2), dtype=np.uint8)
    full_range = ctypes.c_int(0)
    rc = lib.vd_read_frames_scaled_yuv_mt(
        path.encode(), ids, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
        threads if threads is not None else default_threads(),
        ctypes.byref(full_range),
    )
    if rc != 0:
        raise RuntimeError(
            f"videodec.vd_read_frames_scaled_yuv_mt failed ({rc}) for {path}"
        )
    return out, bool(full_range.value)

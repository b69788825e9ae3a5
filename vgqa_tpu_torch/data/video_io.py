"""Video decode interface (a copy of ``vgqa_tpu/data/video_io.py``: the port
imports nothing of the JAX package; OpenCV is imported only inside the
decode functions).

The reference's data path decodes the ENTIRE video per sample with an
ffmpeg-python subprocess rawvideo pipe and then indexes the wanted frames
(the reference's vgqa/data/vidstg_dataset.py:105-141) — wall-clock dominant
in training. Here decode is *seek-based and frame-selective*:

* :func:`read_frames` — primary path through the native C++ libav decoder
  (native/videodec, built against libavformat/libavcodec), which seeks to
  keyframes and decodes only the requested samples;
* OpenCV ``VideoCapture`` fallback when the native library is not built.

Both return uint8 RGB [T, H, W, 3].
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

_native = None
_native_checked = False


def _load_native():
    global _native, _native_checked
    if not _native_checked:
        _native_checked = True
        try:
            from ..native import videodec  # noqa: WPS433

            _native = videodec if videodec.available() else None
        except Exception:
            _native = None
    return _native


def video_info(path: str) -> Tuple[int, float, int, int]:
    """(total_frames, fps, width, height)."""
    nat = _load_native()
    if nat is not None:
        return nat.video_info(path)
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"Cannot open video: {path}")
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    finally:
        cap.release()
    return total, fps, w, h


def read_frames(
    path: str,
    frame_ids: List[int],
    patience: int = 3,
    size: Optional[Tuple[int, int]] = None,
    threads: Optional[int] = None,
) -> np.ndarray:
    """Decode the requested frames as uint8 RGB [T, H, W, 3].

    ``size=(w, h)`` scales during decode (the native decoder folds the
    resize into the same swscale pass that converts pixel format — one
    pass instead of decode-then-cv2.resize). ``patience`` retries
    transient decode failures (the reference retries whole-video decodes
    20x, vidstg_dataset.py:116-131; selective decode makes retries
    cheap). ``threads`` overrides the native decoder's thread count —
    dense contiguous reads (the training loader) should pass 1: slicing a
    contiguous clip across threads re-decodes the shared GOP prefix per
    thread, and loader prefetch workers already provide the parallelism."""
    last_err: Optional[Exception] = None
    for _ in range(max(1, patience)):
        try:
            nat = _load_native()
            if nat is not None:
                return nat.read_frames(path, frame_ids, size=size,
                                       threads=threads)
            raw = _cv2_read_frames(path, frame_ids)
            if size is not None and raw.shape[2:0:-1] != size:
                import cv2

                out = np.empty((raw.shape[0], size[1], size[0], 3), np.uint8)
                for i, f in enumerate(raw):
                    out[i] = cv2.resize(f, size, interpolation=cv2.INTER_LINEAR)
                raw = out
            return raw
        except Exception as e:  # pragma: no cover - IO flake path
            last_err = e
    raise RuntimeError(f"Load Video Error: {path}") from last_err


def read_frames_yuv(
    path: str,
    frame_ids: List[int],
    size: Tuple[int, int],
    patience: int = 3,
):
    """Decode as scaled planar YUV420P: ``(frames [T, h*w*3//2] uint8,
    full_range)`` — half the bytes of RGB for host-to-device upload-bound
    serving (the caller converts on-device, inference/grounding.py).
    Native decoder only; returns ``None`` when it is unavailable or the
    size is odd (caller falls back to :func:`read_frames`)."""
    nat = _load_native()
    if nat is None or size[0] % 2 or size[1] % 2:
        return None
    last_err: Optional[Exception] = None
    for _ in range(max(1, patience)):
        try:
            return nat.read_frames_yuv(path, frame_ids, size=size)
        except Exception as e:  # pragma: no cover - IO flake path
            last_err = e
    raise RuntimeError(f"Load Video Error: {path}") from last_err


def _cv2_read_frames(path: str, frame_ids: List[int]) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"Cannot open video: {path}")
    try:
        out = []
        ordered = sorted(set(int(i) for i in frame_ids))
        got = {}
        pos = -10**9
        for fid in ordered:
            if fid != pos + 1:
                cap.set(cv2.CAP_PROP_POS_FRAMES, fid)
            ok, frame = cap.read()
            if not ok:
                raise RuntimeError(f"Failed to read frame {fid} of {path}")
            got[fid] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            pos = fid
        out = [got[int(i)] for i in frame_ids]
    finally:
        cap.release()
    return np.stack(out)


def uniform_sample_indices(total_frames: int, target_frames: int) -> List[int]:
    """Parity with the reference's vgqa/inference/video_utils.py:29-34."""
    target = max(1, min(int(target_frames), int(total_frames)))
    if target == total_frames:
        return list(range(total_frames))
    return [
        int(round(i * (total_frames - 1) / (target - 1))) for i in range(target)
    ]


def frame_indices_with_bound(
    bound, fps: float, max_frame: int, num_segments: int = 32
) -> np.ndarray:
    """Segment-centered sampling with optional temporal bound (parity with
    the reference's vgqa/inference/video_utils.py:58-78)."""
    if bound:
        start, end = bound[0], bound[1]
    else:
        start, end = -100000, 100000
    start_idx = max(0, round(start * fps))
    end_idx = min(round(end * fps), max_frame)
    seg = float(end_idx - start_idx) / num_segments
    return np.array(
        [
            int(start_idx + (seg / 2) + np.round(seg * i))
            for i in range(num_segments)
        ]
    )

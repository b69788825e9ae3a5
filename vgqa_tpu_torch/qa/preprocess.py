"""Image tiling and normalization for the QA vision tower (host, numpy).

Counterpart of ``vgqa_tpu/qa/preprocess.py``: dynamic aspect-ratio tiling
into 448 px tiles plus an optional thumbnail (bicubic resize), ImageNet
normalization, and bounded segment frame sampling. OpenCV is imported only
inside the functions that resize or decode, so the module imports on a
machine without it; videos decode through the port's own
``data/video_io.py`` (native libav decoder, OpenCV fallback).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def find_closest_aspect_ratio(
    aspect_ratio: float,
    target_ratios: List[Tuple[int, int]],
    width: int,
    height: int,
    image_size: int,
) -> Tuple[int, int]:
    best_diff = float("inf")
    best = (1, 1)
    area = width * height
    for ratio in target_ratios:
        target = ratio[0] / ratio[1]
        diff = abs(aspect_ratio - target)
        if diff < best_diff:
            best_diff = diff
            best = ratio
        elif diff == best_diff:
            if area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
                best = ratio
    return best


def dynamic_tile(
    image: np.ndarray,
    min_num: int = 1,
    max_num: int = 6,
    image_size: int = 448,
    use_thumbnail: bool = True,
) -> np.ndarray:
    """Split an RGB uint8 image into aspect-matched tiles:
    [n_tiles, image_size, image_size, 3] uint8."""
    import cv2

    h, w = image.shape[:2]
    aspect = w / h
    ratios = sorted(
        {
            (i, j)
            for n in range(min_num, max_num + 1)
            for i in range(1, n + 1)
            for j in range(1, n + 1)
            if min_num <= i * j <= max_num
        },
        key=lambda x: x[0] * x[1],
    )
    rw, rh = find_closest_aspect_ratio(aspect, ratios, w, h, image_size)
    tw, th = image_size * rw, image_size * rh
    resized = cv2.resize(image, (tw, th), interpolation=cv2.INTER_CUBIC)
    tiles = []
    for i in range(rw * rh):
        x0 = (i % rw) * image_size
        y0 = (i // rw) * image_size
        tiles.append(resized[y0: y0 + image_size, x0: x0 + image_size])
    if use_thumbnail and len(tiles) != 1:
        tiles.append(
            cv2.resize(image, (image_size, image_size), interpolation=cv2.INTER_CUBIC)
        )
    return np.stack(tiles)


def normalize_tiles(tiles: np.ndarray) -> np.ndarray:
    """uint8 [N, S, S, 3] -> normalized float32."""
    return (tiles.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def load_video_tiles(
    video_path: str,
    bound: Optional[Tuple[float, float]] = None,
    input_size: int = 448,
    max_num: int = 1,
    num_segments: int = 32,
    normalized: bool = False,
):
    """Video -> (stacked tiles, per-frame tile counts). Tiles are uint8
    unless ``normalized`` (the engine normalizes uint8 tiles on the device)."""
    from ..data.video_io import frame_indices_with_bound, read_frames, video_info

    total, fps, _, _ = video_info(video_path)
    ids = frame_indices_with_bound(bound, fps, total - 1, num_segments)
    ids = np.clip(ids, 0, total - 1)
    frames = read_frames(video_path, [int(i) for i in ids])
    tiles_list = []
    num_patches = []
    for frame in frames:
        tiles = dynamic_tile(
            frame, image_size=input_size, use_thumbnail=True, max_num=max_num
        )
        tiles_list.append(normalize_tiles(tiles) if normalized else tiles)
        num_patches.append(tiles.shape[0])
    return np.concatenate(tiles_list, axis=0), num_patches


def load_video_tiles_yuv(
    video_path: str,
    bound: Optional[Tuple[float, float]] = None,
    input_size: int = 448,
    num_segments: int = 32,
):
    """I420-plane variant of :func:`load_video_tiles` for the max_num=1
    protocol (one stretched tile per frame, scaled inside the native
    decoder): ``(YUVTiles, [1] * frames)``, or None when the native decoder
    is unavailable or the size is odd."""
    from ..data.video_io import frame_indices_with_bound, read_frames_yuv, video_info
    from .engine import YUVTiles

    total, fps, _, _ = video_info(video_path)
    ids = frame_indices_with_bound(bound, fps, total - 1, num_segments)
    ids = [int(i) for i in np.clip(ids, 0, total - 1)]
    out = read_frames_yuv(video_path, ids, size=(input_size, input_size))
    if out is None:
        return None
    planes, full_range = out
    return YUVTiles(planes, full_range), [1] * len(ids)

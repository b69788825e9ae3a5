"""Synthetic VidSTG-style dataset (counterpart of ``vgqa_tpu/data/synthetic.py``:
the same videos, annotations and metadata for the same arguments).

``make_synthetic_dataset`` writes a miniature dataset in the reference's
on-disk layout: videos with a moving target square, sentence annotations,
box trajectories and subject/verb metadata, so every stage (decode, clip
sampling, transforms, training, evaluation) runs without outside data.

The frames come from a numpy renderer, :func:`synthetic_frames`, which the
mp4 writer encodes (OpenCV, imported there only). ``write_videos=False``
writes the annotations alone, for a host without a video encoder or
decoder: :func:`frame_reader` then serves the renderer's frames in place of
``video_io.read_frames``, uncompressed.
"""

from __future__ import annotations

import json
import os
import random
import re
import threading
from typing import Callable, Dict, List, Tuple

import numpy as np


def _box(t: int, num_frames: int, w: int, h: int) -> List[float]:
    bw, bh = w // 5, h // 5
    fx = int((w - bw - 2) * t / max(1, num_frames - 1)) + 1
    fy = int((h - bh - 2) * (0.5 + 0.4 * np.sin(t / 5))) % (h - bh - 1) + 1
    return [float(fx), float(fy), float(fx + bw), float(fy + bh)]


def synthetic_frames(num_frames: int, size: Tuple[int, int],
                     seed: int = 0) -> Tuple[np.ndarray, List[List[float]]]:
    """RGB uint8 frames [T, H, W, 3] of a green square moving over noise
    (``size`` = (w, h)), and the per-frame target box [x1, y1, x2, y2]."""
    rng = np.random.RandomState(seed)
    w, h = size
    frames = np.empty((num_frames, h, w, 3), np.uint8)
    boxes = []
    for t in range(num_frames):
        frames[t] = rng.randint(0, 80, (h, w, 3), np.uint8)
        box = _box(t, num_frames, w, h)
        x0, y0, x1, y1 = (int(v) for v in box)
        frames[t, y0:y1, x0:x1] = (30, 200, 60)
        boxes.append(box)
    return frames, boxes


def write_synthetic_video(path: str, num_frames: int, size: Tuple[int, int],
                          seed: int = 0) -> List[List[float]]:
    """Encode :func:`synthetic_frames` as an mp4 at 10 fps; returns the boxes."""
    import cv2

    frames, boxes = synthetic_frames(num_frames, size, seed)
    w, h = size
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2 cannot open a writer for {path}")
    try:
        for frame in frames:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
    return boxes


def make_synthetic_dataset(
    data_dir: str,
    num_videos: int = 2,
    frames_per_video: int = 40,
    size: Tuple[int, int] = (96, 64),
    splits: Tuple[str, ...] = ("train", "test"),
    seed: int = 0,
    write_videos: bool = True,
) -> None:
    """Write the dataset; video ``{split}_vid{i:03d}`` renders with seed
    ``seed + i``. ``write_videos=False`` writes everything but the mp4s."""
    for sub in ("videos", "sent_annos", "bbox_annos", "annos"):
        os.makedirs(os.path.join(data_dir, sub), exist_ok=True)

    rng = random.Random(seed)
    w, h = size
    pair_counter = {s: 0 for s in splits}

    for split in splits:
        sent_annos = []
        meta = {}
        for vi in range(num_videos):
            vid = f"{split}_vid{vi:03d}"
            if write_videos:
                boxes = write_synthetic_video(os.path.join(data_dir, "videos", vid + ".mp4"),
                                              frames_per_video, size, seed=seed + vi)
            else:
                boxes = [_box(t, frames_per_video, w, h) for t in range(frames_per_video)]
            begin = rng.randint(4, 10)
            end = rng.randint(frames_per_video - 12, frames_per_video - 5)
            sent_annos.append({
                "vid": vid,
                "fps": 10,
                "frame_count": frames_per_video,
                "width": w,
                "height": h,
                "used_segment": {"begin_fid": 0, "end_fid": frames_per_video - 1},
                "temporal_gt": {"begin_fid": begin, "end_fid": end},
                "subject/objects": [{"tid": 0, "category": "square"}],
                "captions": [{"description": "a green square moves to the right",
                              "target_id": 0}],
                "questions": [{"description": "what moves to the right", "target_id": 0}],
            })
            trajectories = [[{"tid": 0, "bbox": {
                "xmin": b[0], "ymin": b[1], "xmax": b[2], "ymax": b[3]}}] for b in boxes]
            with open(os.path.join(data_dir, "bbox_annos", vid + ".json"), "w") as f:
                json.dump({"trajectories": trajectories}, f)

            for _ in range(2):  # caption + question pairs
                meta[str(pair_counter[split])] = {
                    "sub": "the green square",
                    "verb_index_list": [1],
                    "adj_index_list": [0, 2],
                }
                pair_counter[split] += 1

        with open(os.path.join(data_dir, "sent_annos", f"{split}_annotations.json"), "w") as f:
            json.dump(sent_annos, f)
        with open(os.path.join(data_dir, "annos", f"{split}_meta.json"), "w") as f:
            json.dump(meta, f)


_VID = re.compile(r"^[a-z]+_vid(\d+)$")


def frame_reader(frames_per_video: int, size: Tuple[int, int], seed: int = 0
                 ) -> Callable[..., np.ndarray]:
    """A stand-in for ``video_io.read_frames(path, frame_ids, ...)`` over a
    set that :func:`make_synthetic_dataset` wrote with these arguments: it
    renders each video once (thread-safe; kept for the reader's life) and
    returns the requested frames, uncompressed. Decode options are ignored."""
    cache: Dict[str, np.ndarray] = {}
    lock = threading.Lock()

    def read_frames(path: str, frame_ids: List[int], *args, **kwargs) -> np.ndarray:
        vid = os.path.splitext(os.path.basename(path))[0]
        m = _VID.match(vid)
        if m is None:
            raise FileNotFoundError(f"{path} is not a synthetic video")
        with lock:
            if vid not in cache:
                cache[vid] = synthetic_frames(frames_per_video, size,
                                              seed + int(m.group(1)))[0]
        return cache[vid][np.asarray(frame_ids, dtype=np.int64)]

    return read_frames

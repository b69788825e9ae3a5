"""Spatio-temporal video grounding inference API (counterpart of
``vgqa_tpu/inference/grounding.py``).

Decode a video, sample 2 x TRAIN_SAMPLE_NUM frames, square-resize, run the
even/odd two-pass protocol (V = 2 rows per video: its even and its odd
frames), merge with linear interpolation and return
``{"temporal": {...}, "tube": [...]}`` with the reference's schema.

Frames travel to the device as uint8 (or as I420 planes when the native
decoder is present, half the bytes); the normalization and the BT.601
conversion run on the device. ``predict_many`` launches each video's
forward as soon as its frames are uploaded, so the device works on video i
while the host decodes video i+1; results are fetched after the last
launch. A request may also carry already-decoded frames (``frames``), which
enter the same path after the decode.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..config import build_default_cfg
from ..data.tokenizer import batch_encode, build_tokenizer
from ..data.video_io import (
    read_frames,
    read_frames_yuv,
    uniform_sample_indices,
    video_info,
)
from ..models import GroundingConfig, VSTGNet
from ..models.init_weights import init_weights
from ..training.evaluator import (
    convert_outputs,
    dispatch_forward,
    linear_interp,
    linear_interp_conf,
    make_eval_forward,
)
from ..utils.containers import TextBatch, VideoBatch
from ..utils.device import resolve_device

DEFAULT_CONFIG_PATH = "configs/grounding_vidstg.yaml"
DEFAULT_CHECKPOINT_PATH = "checkpoints/grounding/vidstg.pt"
DECODE_CHUNKS = 4

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass
class LoadedModel:
    """A model ready to serve: its config, weights on ``device`` in
    ``dtype``, the tokenizer, and the two upload-format forwards."""

    cfg: Any
    model: VSTGNet
    tokenizer: Any
    device: torch.device
    dtype: torch.dtype
    fwd_u8: Callable
    fwd_yuv: Callable


def load_model(cfg, ckpt_path: str = "", device=None, seed: int = 0,
               state_dict: Optional[Dict[str, torch.Tensor]] = None) -> LoadedModel:
    """Build the grounding model for serving.

    Weights come from ``state_dict`` if given, else from the ``torch.save``d
    state dict at ``ckpt_path`` if it exists, else from a seeded random
    initialization (``torch.Generator`` seeded with ``seed``). A JAX
    checkpoint (an orbax directory) raises ``ValueError``: export it first
    with ``tools/export_torch_checkpoint.py grounding``. The model is
    cast to ``cfg.TPU.COMPUTE_DTYPE`` (the serving precision). ``device``
    defaults to the card; without one it raises (pass ``device="cpu"``)."""
    device = resolve_device(device)
    model = VSTGNet(GroundingConfig.from_cfg(cfg))
    init_weights(model, torch.Generator().manual_seed(seed))
    if state_dict is None and ckpt_path:
        if os.path.isdir(ckpt_path):
            raise ValueError(
                f"{ckpt_path} is an orbax checkpoint of the JAX package; export it where JAX "
                "is installed with `python tools/export_torch_checkpoint.py grounding "
                f"{ckpt_path} OUT.pt` and pass OUT.pt")
        if os.path.exists(ckpt_path):
            state_dict = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        else:
            warnings.warn(f"Checkpoint not found: {ckpt_path}; using random initialization")
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    dtype = _DTYPES[cfg.TPU.COMPUTE_DTYPE]
    model = model.to(device=device, dtype=dtype).eval()
    model.vis_encoder.to(memory_format=torch.channels_last)
    tokenizer = build_tokenizer(cfg.MODEL.TEXT_MODEL.VOCAB_DIR)
    fwd = make_eval_forward(model)
    mean = torch.tensor(cfg.INPUT.PIXEL_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(cfg.INPUT.PIXEL_STD, dtype=torch.float32, device=device)
    res = cfg.INPUT.RESOLUTION

    def split_halves(x):
        """[N, T2, ...] -> [2N, T2/2, ...]: video i's even frames at row 2i,
        its odd frames at row 2i + 1."""
        n, t2 = x.shape[:2]
        both = torch.stack([x[:, 0::2], x[:, 1::2]], dim=1)
        return both.reshape(2 * n, t2 // 2, *x.shape[2:])

    def fwd_u8(frames_all, pixel_mask, time_mask, text, ori_sizes, letterbox):
        frames = (split_halves(frames_all).float() / 255.0 - mean) / std
        return fwd(VideoBatch(frames.to(dtype), pixel_mask, time_mask), text,
                   ori_sizes, letterbox)

    def fwd_yuv(frames_all, pixel_mask, time_mask, text, ori_sizes, letterbox,
                full_range):
        """I420 planes [N, T2, res*res*3/2] -> BT.601 RGB on the device;
        ``full_range`` [N] selects full (JPEG) or limited (MPEG) range per
        video."""
        n, t2, _ = frames_all.shape
        npx, nc = res * res, (res // 2) * (res // 2)
        y = frames_all[..., :npx].reshape(n, t2, res, res).float()
        u = frames_all[..., npx:npx + nc].reshape(n, t2, res // 2, res // 2).float()
        v = frames_all[..., npx + nc:].reshape(n, t2, res // 2, res // 2).float()
        # nearest 2x2 chroma upsample (swscale's unscaled yuv420p->rgb)
        u = u.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3) - 128.0
        v = v.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3) - 128.0
        fr = (full_range > 0)[:, None, None, None]

        def coef(full, limited):
            return torch.where(fr, torch.tensor(full, device=device),
                               torch.tensor(limited, device=device))

        yl = torch.where(fr, y, 1.1643835616 * (y - 16.0))
        r = yl + coef(1.402, 1.5960267857) * v
        g = yl - coef(0.344136, 0.3917622768) * u - coef(0.714136, 0.8129676339) * v
        b = yl + coef(1.772, 2.0172321429) * u
        rgb = torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)
        frames = (split_halves(rgb) / 255.0 - mean) / std
        return fwd(VideoBatch(frames.to(dtype), pixel_mask, time_mask), text,
                   ori_sizes, letterbox)

    return LoadedModel(cfg, model, tokenizer, device, dtype, fwd_u8, fwd_yuv)


def _load_yaml_config(config_path: str):
    if not os.path.exists(config_path):
        raise FileNotFoundError(f"Config file not found: {config_path}")
    cfg = build_default_cfg()
    cfg.merge_from_file(config_path)
    cfg.freeze()
    return cfg


@lru_cache(maxsize=2)
def _load_model(config_path: str, ckpt_path: str, device_str: Optional[str] = None):
    return load_model(_load_yaml_config(config_path), ckpt_path, device_str)


def _upload(chunk: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(chunk)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def _decode_upload(video_path: str, frame_ids, res: int, device):
    """Decode the sampled frames in chunks, each uploaded as soon as it is
    decoded. I420 planes when the native decoder is present, RGB
    otherwise. Returns ``(frames [T2, ...] on device, frame_ids, yuv,
    full_range)``."""
    n_chunks = min(DECODE_CHUNKS, max(1, len(frame_ids)))
    chunks = [[int(i) for i in c] for c in np.array_split(np.asarray(frame_ids), n_chunks)]
    full_range = 0.0
    first = read_frames_yuv(video_path, chunks[0], (res, res))
    if first is None:
        parts = [_upload(read_frames(video_path, c, size=(res, res)), device)
                 for c in chunks]
        yuv = False
    else:
        parts = [_upload(first[0], device)]
        for c in chunks[1:]:
            parts.append(_upload(read_frames_yuv(video_path, c, (res, res))[0], device))
        full_range = float(first[1])
        yuv = True
    return torch.cat(parts, dim=0), np.asarray(frame_ids), yuv, full_range


def _even_frames(frames: torch.Tensor, frame_ids):
    """Make the frame count even and at least 2 (the even/odd split
    duplicates the last frame of an odd-count video)."""
    frame_ids = list(frame_ids)
    if frames.shape[0] < 2:
        frames = torch.cat([frames, frames], dim=0)
        frame_ids = frame_ids * 2
    if frames.shape[0] % 2:
        frames = torch.cat([frames, frames[-1:]], dim=0)
        frame_ids = frame_ids + [frame_ids[-1]]
    return frames, np.asarray(frame_ids)


def _merge_halves(b1, a1, t1, row: int, fps: float) -> Dict[str, Any]:
    """Merge one video's even/odd half predictions (rows ``row``/``row+1``)
    into the reference's response schema."""
    b1[row].update(b1[row + 1])
    bbox_full = linear_interp(b1[row])
    a1[row].update(a1[row + 1])
    att_full = linear_interp_conf(a1[row])
    merged_sted = [min(t1[row]["sted"][0], t1[row + 1]["sted"][0]),
                   max(t1[row]["sted"][1], t1[row + 1]["sted"][1])]
    temporal = {
        "start": float(merged_sted[0]) / max(fps, 1e-6),
        "end": float(merged_sted[1]) / max(fps, 1e-6),
        "score": 1.0,
    }
    tube = []
    for fid in sorted(bbox_full.keys()):
        conf = att_full.get(fid, 1.0)
        tube.append({
            "frame": int(fid),
            "bbox": [float(b) for b in bbox_full[fid][0]],
            "score": float(conf[0] if isinstance(conf, list) else conf),
        })
    return {"temporal": temporal, "tube": tube}


def _group_inputs(loaded: LoadedModel, group):
    """Forward inputs for a group of prepared videos: V = 2N rows.

    Returns ``(fwd, video, text, infos, gt_act, canvas)`` for
    ``dispatch_forward``."""
    res = loaded.cfg.INPUT.RESOLUTION
    dev = loaded.device
    n = len(group)
    frames = torch.stack([g["frames"] for g in group])       # [N, T2, ...]
    t_half = frames.shape[1] // 2
    video = VideoBatch(frames=frames,
                       pixel_mask=torch.ones((2 * n, res, res), dtype=torch.bool, device=dev),
                       time_mask=torch.ones((2 * n, t_half), dtype=torch.bool, device=dev))
    if group[0]["yuv"]:
        fr = torch.tensor([g["full_range"] for g in group], dtype=torch.float32, device=dev)

        def fwd(v, t, o, lb):
            return loaded.fwd_yuv(v.frames, v.pixel_mask, v.time_mask, t, o, lb, fr)
    else:
        def fwd(v, t, o, lb):
            return loaded.fwd_u8(v.frames, v.pixel_mask, v.time_mask, t, o, lb)
    queries = []
    for g in group:
        queries += [g["query"], g["query"]]
    ids, mask = batch_encode(loaded.tokenizer, queries, loaded.cfg.INPUT.MAX_QUERY_LEN)
    text = TextBatch(torch.from_numpy(ids).long().to(dev), torch.from_numpy(mask).to(dev))
    infos = [
        {
            "item_id": 2 * i + half,
            "vid": f"video{i}",
            "frame_ids": group[i]["frame_ids"][half::2],
            "duration": t_half,
            "qtype": "declar",
            "ori_size": group[i]["ori_size"],
        }
        for i in range(n)
        for half in (0, 1)
    ]
    gt_act = np.ones((2 * n, t_half), np.float32)
    return fwd, video, text, infos, gt_act, (res, res)


def _prepare(loaded: LoadedModel, req) -> Dict[str, Any]:
    """A request as a job dict: decode + upload a ``video_path``, or take
    already-decoded uint8 ``frames`` [T2, res, res, 3] with ``fps``,
    ``ori_size`` (h, w) and optional ``frame_ids``."""
    res = loaded.cfg.INPUT.RESOLUTION
    if "frames" in req:
        frames = torch.as_tensor(req["frames"])
        if frames.dtype != torch.uint8 or tuple(frames.shape[1:]) != (res, res, 3):
            raise ValueError(f"frames must be uint8 [T, {res}, {res}, 3], got "
                             f"{frames.dtype} {tuple(frames.shape)}")
        frame_ids = req.get("frame_ids", range(frames.shape[0]))
        frames, frame_ids = _even_frames(frames.to(loaded.device), frame_ids)
        return {"frames": frames, "frame_ids": frame_ids, "yuv": False,
                "full_range": 0.0, "fps": float(req["fps"]),
                "ori_size": tuple(req["ori_size"]), "query": req["query"]}
    path = req["video_path"]
    if not os.path.exists(path):
        raise FileNotFoundError(f"Video not found: {path}")
    total_frames, fps, w0, h0 = video_info(path)
    target_t = max(2, int(loaded.cfg.INPUT.TRAIN_SAMPLE_NUM) * 2)
    frame_ids = uniform_sample_indices(total_frames, target_t)
    frames, frame_ids, yuv, full_range = _decode_upload(path, frame_ids, res, loaded.device)
    frames, frame_ids = _even_frames(frames, frame_ids)
    return {"frames": frames, "frame_ids": frame_ids, "yuv": yuv,
            "full_range": full_range, "fps": fps, "ori_size": (h0, w0),
            "query": req["query"]}


def predict(
    video_path: str,
    query: str,
    cfg_path: str = DEFAULT_CONFIG_PATH,
    ckpt_path: str = DEFAULT_CHECKPOINT_PATH,
    device_str: Optional[str] = None,
    batch_size: int = 32,
) -> Dict[str, Any]:
    """Ground ``query`` in one video: the temporal span in seconds and a
    per-frame tube (the reference's schema). ``batch_size`` is accepted
    for the reference's signature; the two halves run as one batch."""
    del batch_size
    loaded = _load_model(cfg_path, ckpt_path, device_str)
    result = predict_many([{"video_path": video_path, "query": query}], loaded=loaded)[0]
    if isinstance(result, Exception):
        raise result
    return result


def predict_many(requests, cfg_path: str = DEFAULT_CONFIG_PATH,
                 ckpt_path: str = DEFAULT_CHECKPOINT_PATH,
                 loaded: Optional[LoadedModel] = None):
    """Serve N grounding requests, pipelined: each video's V = 2 forward is
    launched as soon as its frames are on the device, and all results are
    fetched after the last launch.

    ``requests``: dicts with ``query`` and either ``video_path`` or decoded
    ``frames`` (see ``_prepare``). ``loaded`` serves with an already built
    model instead of the cached one for (cfg_path, ckpt_path). Returns a list
    aligned with ``requests``: each slot is the response dict or the
    exception raised preparing that request (a bad video fails only its
    own slot)."""
    loaded = loaded or _load_model(cfg_path, ckpt_path)
    slots = [None] * len(requests)
    pending = []
    for i, req in enumerate(requests):
        try:
            job = _prepare(loaded, req)
        except Exception as e:  # noqa: BLE001 - per-slot failure isolation
            slots[i] = e
            continue
        fwd, video, text, infos, gt_act, canvas = _group_inputs(loaded, [job])
        pending.append((i, job, dispatch_forward(fwd, video, text, infos, canvas=canvas),
                        infos, gt_act))
    for i, job, (packed, span), infos, gt_act in pending:
        b1, a1, t1, _ = convert_outputs(packed, span, infos, gt_act)
        slots[i] = _merge_halves(b1, a1, t1, 0, job["fps"])
    return slots

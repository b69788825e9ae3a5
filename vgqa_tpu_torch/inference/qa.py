"""Video Question Answering inference API.

Counterpart of ``vgqa_tpu/inference/qa.py``: sample frames from the
(optionally bounded) video segment, tile them, run the multimodal model and
return ``{"answer": str}``. ``model_dir`` may hold the engine config
(``vgqa_tpu_config.json``), a SentencePiece ``tokenizer.model`` and raw HF
weights (``*.bin`` / ``*.pth``, converted on load); ``"__tiny__"`` builds a
small random model. A converted orbax checkpoint (a ``params/`` directory)
loads from ``params_torch.pt`` beside it, which
``tools/export_torch_checkpoint.py qa MODEL_DIR`` writes where JAX is
installed (float, int8 or int4 trees); without that file it raises.

Every entry point takes ``device``: the card by default, and without one it
raises unless ``device="cpu"``.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..qa.engine import GenerationConfig, QAEngine
from ..qa.llm import LLMConfig
from ..qa.preprocess import load_video_tiles, load_video_tiles_yuv
from ..qa.vit import ViTConfig
from ..utils import trace
from ..utils.device import resolve_device

DEFAULT_MODEL_DIR = "checkpoints/qa/InternVideo2_5_Chat_8B"
EXPORTED_TREE = "params_torch.pt"      # tools/export_torch_checkpoint.py qa


def load_exported_tree(path: str) -> Dict[str, Any]:
    """The ``{llm, embed, vision}`` tree that ``tools/export_torch_checkpoint.py
    qa`` wrote, its torch leaves as stored and memory-mapped from the file.
    ``QAEngine.load_tree`` copies each leaf into its module in the engine's
    dtype, so the host holds the engine's weights and the file's pages, never
    a widened copy of the tree."""
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def _load_tiles(video_path, bound, input_size, max_num, num_segments):
    """I420 planes when the native decoder can emit them (one stretched tile
    per frame, max_num = 1), RGB uint8 tiles otherwise."""
    if max_num == 1:
        out = load_video_tiles_yuv(video_path, bound=bound, input_size=input_size,
                                   num_segments=num_segments)
        if out is not None:
            return out
    return load_video_tiles(video_path, bound=bound, input_size=input_size,
                            max_num=max_num, num_segments=num_segments)


def _load_hf_weights(engine: QAEngine, model_dir: str, files: List[str]) -> None:
    """Raw HF torch checkpoint files -> the engine's modules, in its dtype."""
    from ..qa.convert import convert_internvideo, torch_state_dict_to_numpy

    sd: Dict[str, Any] = {}
    for f in sorted(files):
        part = torch.load(os.path.join(model_dir, f), map_location="cpu", weights_only=True)
        sd.update(torch_state_dict_to_numpy(part))
    engine.load_tree(convert_internvideo(sd, engine.llm_cfg, engine.vit_cfg))


@lru_cache(maxsize=1)
def _load_cached(model_dir: str, device: torch.device) -> QAEngine:
    if model_dir == "__tiny__":
        return QAEngine.init_random(LLMConfig.tiny(), ViTConfig.tiny(), device=device)
    if not os.path.exists(model_dir):
        raise FileNotFoundError(f"QA model local directory not found: {model_dir}")
    cfg_path = os.path.join(model_dir, "vgqa_tpu_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = json.load(f)
        llm_cfg = LLMConfig(**raw.get("llm", {}))
        # the JAX config's "flash" picks a route, not a shape: here the
        # engine's use_kernels does
        vit_cfg = ViTConfig(**{k: v for k, v in raw.get("vit", {}).items() if k != "flash"})
    else:
        llm_cfg, vit_cfg = LLMConfig.internlm2_5_7b(), ViTConfig.internvit_300m()
    exported = os.path.join(model_dir, EXPORTED_TREE)
    if not os.path.exists(exported) and os.path.exists(os.path.join(model_dir, "params")):
        raise RuntimeError(
            f"{model_dir}/params is an orbax checkpoint, which only the JAX package "
            "reads; export it where JAX is installed with `python "
            f"tools/export_torch_checkpoint.py qa {model_dir}` (writes {EXPORTED_TREE}), "
            "or point model_dir at the raw HF weights (*.bin / *.pth)")
    tokenizer = None
    sp_model = os.path.join(model_dir, "tokenizer.model")
    if os.path.exists(sp_model):
        from ..qa.sp_tokenizer import SentencePieceBPE

        tokenizer = SentencePieceBPE(sp_model)
    engine = QAEngine.init_random(llm_cfg, vit_cfg, device=device, dtype=torch.bfloat16,
                                  tokenizer=tokenizer)
    files = [f for f in os.listdir(model_dir) if f.endswith((".bin", ".pth"))]
    if os.path.exists(exported):
        engine.load_tree(load_exported_tree(exported))
    elif files:
        _load_hf_weights(engine, model_dir, files)
    return engine


def _load_engine(model_dir: str, device=None) -> QAEngine:
    """The engine for ``model_dir`` on ``device`` (cached, one at a time).
    Like the JAX package it keeps ``QAEngine``'s default context of 8192
    tokens, which a 32-frame request (8192 image tokens + the template)
    exceeds; build the engine with ``max_seq_len=9216`` to serve that."""
    return _load_cached(model_dir, resolve_device(device))


def _gen(max_new_tokens: int, temperature: float, top_p: float) -> GenerationConfig:
    return GenerationConfig(max_new_tokens=max_new_tokens, temperature=max(temperature, 0.01),
                            top_p=top_p, do_sample=temperature > 0)


def predict(
    video_path: str,
    question: str,
    bound: Optional[Tuple[float, float]] = None,
    model_dir: str = DEFAULT_MODEL_DIR,
    num_frames: int = 32,
    max_new_tokens: int = 128,
    temperature: float = 0.2,
    top_p: float = 0.9,
    input_size: int = 448,
    max_num: int = 1,
    device=None,
) -> Dict[str, Any]:
    """Offline VideoQA on one video (the JAX signature, plus ``device``)."""
    if not os.path.exists(video_path):
        raise FileNotFoundError(f"Video not found: {video_path}")
    engine = _load_engine(model_dir, device)
    tile_size = engine.vit_cfg.image_size       # the tiny engine uses small tiles
    tiles, num_patches_list = _load_tiles(
        video_path, bound, tile_size if input_size == 448 else input_size, max_num, num_frames)
    answer = engine.chat(tiles, question, _gen(max_new_tokens, temperature, top_p),
                         num_patches_list=num_patches_list)
    return {"answer": str(answer)}


def predict_many(
    requests: List[Dict[str, Any]],
    model_dir: str = DEFAULT_MODEL_DIR,
    device=None,
) -> List[Any]:
    """Serve N VideoQA requests with one lockstep batched decode.

    ``requests``: dicts with ``video_path`` and ``question`` plus optional
    ``bound`` / ``num_frames`` / ``max_new_tokens`` / ``temperature`` /
    ``top_p`` / ``input_size`` / ``max_num``. Returns a list aligned with
    ``requests``: each slot is ``{"answer": str}`` or the exception raised
    while preparing that request; a bad request fails its own slot only."""
    engine = _load_engine(model_dir, device)
    tile_size = engine.vit_cfg.image_size
    out: List[Any] = [None] * len(requests)
    prepped, slots, gens = [], [], []
    for i, req in enumerate(requests):
        try:
            path = req["video_path"]
            if not os.path.exists(path):
                raise FileNotFoundError(f"Video not found: {path}")
            input_size = int(req.get("input_size", 448))
            tiles, num_patches_list = _load_tiles(
                path, req.get("bound"), tile_size if input_size == 448 else input_size,
                int(req.get("max_num", 1)), int(req.get("num_frames", 32)))
            # an over-long prompt fails its own slot here, not the whole batch
            ids, _ = engine.build_prompt_ids(req["question"], num_patches_list)
            if len(ids) > engine.max_seq_len:
                raise ValueError(f"prompt is {len(ids)} tokens but the model's context "
                                 f"is {engine.max_seq_len}; reduce num_frames or tiles")
            gens.append(_gen(int(req.get("max_new_tokens", 128)),
                             float(req.get("temperature", 0.2)), float(req.get("top_p", 0.9))))
            prepped.append((tiles, req["question"], num_patches_list))
            slots.append(i)
        except Exception as e:  # noqa: BLE001 - per-slot failure isolation
            out[i] = e
    if prepped:
        # the kept slots' request ids: a failed slot leaves the batch
        answers = engine.chat_batch(prepped, gens=gens,
                                    rids=[trace.request_rid(i) for i in slots])
        for i, ans in zip(slots, answers):
            out[i] = {"answer": str(ans)}
    return out

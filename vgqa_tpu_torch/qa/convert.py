"""InternVL-family torch checkpoints -> the QA engine's parameter trees.

A numpy copy of ``vgqa_tpu/qa/convert.py`` (the port imports nothing of the
JAX package): maps an InternVideo2.5 / InternVL chat state dict
(InternViT-300M + InternLM2.5-7B + MLP projector) onto the flax-layout tree
``{"llm", "embed", "vision"}``, which ``models/convert_jax.state_dict_from_jax``
then turns into the port's state dicts. Handles InternLM2's grouped-
interleaved fused ``wqkv`` and llama-style separate projections.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .llm import LLMConfig
from .vit import ViTConfig

StateDict = Dict[str, np.ndarray]


def torch_state_dict_to_numpy(state_dict) -> StateDict:
    """Detach a torch state dict to numpy (host-side)."""
    out = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu()
            out[k] = (v.float() if v.dtype.is_floating_point else v).numpy()
        else:
            out[k] = np.asarray(v)
    return out


def _linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def _ln(sd: StateDict, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _dense(sd: StateDict, prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": _linear(sd[f"{prefix}.weight"]), "bias": sd[f"{prefix}.bias"]}


def split_internlm2_wqkv(w: np.ndarray, num_heads: int, num_kv_heads: int, head_dim: int):
    """InternLM2 fused wqkv [(H + 2*KVH)*hd, D] -> (wq, wk, wv); per KV group
    the rows are [group query heads..., k head, v head]."""
    group = num_heads // num_kv_heads
    d = w.shape[1]
    w = w.reshape(num_kv_heads, group + 2, head_dim, d)
    wq = w[:, :group].reshape(num_kv_heads * group * head_dim, d)
    wk = w[:, group].reshape(num_kv_heads * head_dim, d)
    wv = w[:, group + 1].reshape(num_kv_heads * head_dim, d)
    return wq, wk, wv


def convert_internlm2(sd: StateDict, cfg: LLMConfig):
    """``language_model.*``-stripped InternLM2 dict -> (llm, embed) trees."""
    llm: Dict = {}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        if f"{p}.attention.wqkv.weight" in sd:
            wq, wk, wv = split_internlm2_wqkv(
                sd[f"{p}.attention.wqkv.weight"],
                cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            )
            o = sd[f"{p}.attention.wo.weight"]
            gate = sd[f"{p}.feed_forward.w1.weight"]
            up = sd[f"{p}.feed_forward.w3.weight"]
            down = sd[f"{p}.feed_forward.w2.weight"]
            attn_norm = sd[f"{p}.attention_norm.weight"]
            ffn_norm = sd[f"{p}.ffn_norm.weight"]
        else:  # llama/qwen naming
            wq = sd[f"{p}.self_attn.q_proj.weight"]
            wk = sd[f"{p}.self_attn.k_proj.weight"]
            wv = sd[f"{p}.self_attn.v_proj.weight"]
            o = sd[f"{p}.self_attn.o_proj.weight"]
            gate = sd[f"{p}.mlp.gate_proj.weight"]
            up = sd[f"{p}.mlp.up_proj.weight"]
            down = sd[f"{p}.mlp.down_proj.weight"]
            attn_norm = sd[f"{p}.input_layernorm.weight"]
            ffn_norm = sd[f"{p}.post_attention_layernorm.weight"]
        llm[f"layer_{i}"] = {
            "q_proj": {"kernel": _linear(wq)},
            "k_proj": {"kernel": _linear(wk)},
            "v_proj": {"kernel": _linear(wv)},
            "o_proj": {"kernel": _linear(o)},
            "gate_proj": {"kernel": _linear(gate)},
            "up_proj": {"kernel": _linear(up)},
            "down_proj": {"kernel": _linear(down)},
            "attn_norm": {"scale": attn_norm},
            "mlp_norm": {"scale": ffn_norm},
        }
    llm["final_norm"] = {"scale": sd["model.norm.weight"]}
    head = sd["output.weight"] if "output.weight" in sd else sd["lm_head.weight"]
    llm["lm_head"] = {"kernel": _linear(head)}
    tok_key = ("model.tok_embeddings.weight" if "model.tok_embeddings.weight" in sd
               else "model.embed_tokens.weight")
    embed = {"tok_embeddings": {"embedding": sd[tok_key]}}
    return llm, embed


def convert_internvit(sd: StateDict, cfg: ViTConfig, mlp1: StateDict) -> Dict:
    """``vision_model.*``-stripped InternViT dict + ``mlp1.*`` projector ->
    the VisionTower tree."""
    params: Dict = {
        "cls_token": sd["embeddings.class_embedding"].reshape(1, 1, -1),
        "pos_embed": sd["embeddings.position_embedding"].reshape(1, -1, cfg.hidden_size),
        "patch_embed": {
            "kernel": np.transpose(sd["embeddings.patch_embedding.weight"], (2, 3, 1, 0)),
            "bias": sd["embeddings.patch_embedding.bias"],
        },
    }
    for i in range(cfg.num_layers):
        p = f"encoder.layers.{i}"
        params[f"block_{i}"] = {
            "qkv": _dense(sd, f"{p}.attn.qkv"),
            "proj": _dense(sd, f"{p}.attn.proj"),
            "ls1": sd[f"{p}.ls1"],
            "ls2": sd[f"{p}.ls2"],
            "norm1": _ln(sd, f"{p}.norm1"),
            "norm2": _ln(sd, f"{p}.norm2"),
            "fc1": _dense(sd, f"{p}.mlp.fc1"),
            "fc2": _dense(sd, f"{p}.mlp.fc2"),
        }
    # mlp1 projector: [0] = LayerNorm, [1] = Linear, [3] = Linear (InternVL)
    params["proj_norm"] = _ln(mlp1, "0")
    params["proj_fc1"] = _dense(mlp1, "1")
    params["proj_fc2"] = _dense(mlp1, "3")
    return params


def convert_internvideo(sd: StateDict, llm_cfg: LLMConfig, vit_cfg: ViTConfig) -> Dict:
    """Full InternVideo2.5 / InternVL chat checkpoint -> {llm, embed, vision}."""

    def strip(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    llm, embed = convert_internlm2(strip("language_model."), llm_cfg)
    vision = convert_internvit(strip("vision_model."), vit_cfg, strip("mlp1."))
    return {"llm": llm, "embed": embed, "vision": vision}

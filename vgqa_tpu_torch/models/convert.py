"""Pretrained-weight converters: torch state dicts -> flax-layout trees.

A numpy copy of ``vgqa_tpu/models/convert.py`` (the port imports nothing of
the JAX package). The reference consumes pretrained weights as torch
checkpoints: torchvision ResNet-101, HF RobertaModel, Kinetics-400 Video
Swin (with the temporal patch-embed sum) and MDETR-format warm starts.
These functions map those layouts onto the flax parameter trees of the JAX
package, whose names the port's modules keep, so
``models/convert_jax.state_dict_from_jax`` turns each tree into the port's
state dict:

* conv kernels OIHW -> HWIO (and OIDHW -> DHWIO for 3D),
* linear weights [out, in] -> [in, out],
* BatchNorm (weight, bias, mean, var) folded into FrozenAffine
  (scale, bias) with eps=1e-5,
* Swin patch-embed temporal dim summed 2 -> 1 (the (1,4,4) patch trick).

Inputs are {name: np.ndarray} dicts (``qa/convert.torch_state_dict_to_numpy``
of a loaded torch checkpoint).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

Array = np.ndarray
StateDict = Dict[str, Array]


def _conv2d(w: Array) -> Array:
    return np.transpose(w, (2, 3, 1, 0))


def _conv3d(w: Array) -> Array:
    return np.transpose(w, (2, 3, 4, 1, 0))


def _linear(w: Array) -> Array:
    return np.transpose(w, (1, 0))


def _fold_bn(sd: StateDict, prefix: str, eps: float = 1e-5) -> Dict[str, Array]:
    w = sd[f"{prefix}.weight"]
    b = sd[f"{prefix}.bias"]
    mean = sd[f"{prefix}.running_mean"]
    var = sd[f"{prefix}.running_var"]
    scale = w / np.sqrt(var + eps)
    return {"scale": scale, "bias": b - mean * scale}


# ---------------------------------------------------------------------------
# ResNet (torchvision layout)
# ---------------------------------------------------------------------------
def convert_resnet(sd: StateDict, depths: Sequence[int] = (3, 4, 23, 3)) -> Dict:
    params: Dict = {
        "conv1": {"kernel": _conv2d(sd["conv1.weight"])},
        "bn1": _fold_bn(sd, "bn1"),
    }
    for s, blocks in enumerate(depths):
        for b in range(blocks):
            p = f"layer{s + 1}.{b}"
            entry = {
                "conv1": {"kernel": _conv2d(sd[f"{p}.conv1.weight"])},
                "bn1": _fold_bn(sd, f"{p}.bn1"),
                "conv2": {"kernel": _conv2d(sd[f"{p}.conv2.weight"])},
                "bn2": _fold_bn(sd, f"{p}.bn2"),
                "conv3": {"kernel": _conv2d(sd[f"{p}.conv3.weight"])},
                "bn3": _fold_bn(sd, f"{p}.bn3"),
            }
            if f"{p}.downsample.0.weight" in sd:
                entry["downsample_conv"] = {
                    "kernel": _conv2d(sd[f"{p}.downsample.0.weight"])
                }
                entry["downsample_bn"] = _fold_bn(sd, f"{p}.downsample.1")
            params[f"layer{s + 1}_{b}"] = entry
    return params


# ---------------------------------------------------------------------------
# RoBERTa (HF transformers layout)
# ---------------------------------------------------------------------------
def _ln(sd: StateDict, prefix: str) -> Dict[str, Array]:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _dense(sd: StateDict, prefix: str) -> Dict[str, Array]:
    return {"kernel": _linear(sd[f"{prefix}.weight"]), "bias": sd[f"{prefix}.bias"]}


def convert_roberta(sd: StateDict, num_layers: int = 12) -> Dict:
    """HF ``RobertaModel`` state dict -> RobertaModel flax params."""
    params: Dict = {
        "word_embeddings": {"embedding": sd["embeddings.word_embeddings.weight"]},
        "position_embeddings": {
            "embedding": sd["embeddings.position_embeddings.weight"]
        },
        "token_type_embeddings": {
            "embedding": sd["embeddings.token_type_embeddings.weight"]
        },
        "embeddings_ln": _ln(sd, "embeddings.LayerNorm"),
        "pooler": _dense(sd, "pooler.dense"),
    }
    for i in range(num_layers):
        p = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attention": {
                "q_proj": _dense(sd, f"{p}.attention.self.query"),
                "k_proj": _dense(sd, f"{p}.attention.self.key"),
                "v_proj": _dense(sd, f"{p}.attention.self.value"),
                "out_proj": _dense(sd, f"{p}.attention.output.dense"),
            },
            "attention_ln": _ln(sd, f"{p}.attention.output.LayerNorm"),
            "intermediate": _dense(sd, f"{p}.intermediate.dense"),
            "output": _dense(sd, f"{p}.output.dense"),
            "output_ln": _ln(sd, f"{p}.output.LayerNorm"),
        }
    return params


# ---------------------------------------------------------------------------
# Video Swin (mmaction/K400 layout)
# ---------------------------------------------------------------------------
def convert_video_swin(
    sd: StateDict,
    depths: Sequence[int] = (2, 2, 6, 2),
    sum_temporal_patch: bool = True,
) -> Dict:
    """K400 Video Swin ``backbone.*`` dict -> VideoSwinBackbone params.

    ``sum_temporal_patch`` applies the reference's temporal-sum of the
    (2, 4, 4) patch kernel down to (1, 4, 4)
    (video_swin_transformer.py:642-645)."""
    patch_w = sd["patch_embed.proj.weight"]
    if sum_temporal_patch and patch_w.shape[2] > 1:
        patch_w = patch_w.sum(axis=2, keepdims=True)
    params: Dict = {
        # reshape+matmul patch embedding keeps the conv kernel layout
        # [pd, ph, pw, 3, C] (video_swin.py)
        "patch_embed_kernel": _conv3d(patch_w),
        "patch_embed_bias": sd["patch_embed.proj.bias"],
    }
    if "patch_embed.norm.weight" in sd:
        params["patch_norm"] = _ln(sd, "patch_embed.norm")
    for s, blocks in enumerate(depths):
        for b in range(blocks):
            p = f"layers.{s}.blocks.{b}"
            params[f"stage{s}_block{b}"] = {
                "norm1": _ln(sd, f"{p}.norm1"),
                "attn": {
                    "relative_position_bias_table": sd[
                        f"{p}.attn.relative_position_bias_table"
                    ],
                    "qkv": _dense(sd, f"{p}.attn.qkv"),
                    "proj": _dense(sd, f"{p}.attn.proj"),
                },
                "norm2": _ln(sd, f"{p}.norm2"),
                "mlp_fc1": _dense(sd, f"{p}.mlp.fc1"),
                "mlp_fc2": _dense(sd, f"{p}.mlp.fc2"),
            }
        if s < len(depths) - 1:
            p = f"layers.{s}.downsample"
            params[f"downsample{s}"] = {
                "norm": _ln(sd, f"{p}.norm"),
                "reduction": {"kernel": _linear(sd[f"{p}.reduction.weight"])},
            }
    return params

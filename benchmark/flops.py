"""Model FLOPs: the work a cell's model requires, whatever implements it,
for the ``mfu`` metrics.

Grounding: counted from the reference's own forward (serving) or forward,
loss and backward (training) on the ``meta`` device with
``torch.utils.flop_counter``, which counts every matrix product and
convolution by its shapes: no data is made and nothing runs. QA: counted
from the published geometry, since the reference's full-length forward
computes the masked half of causal attention, which the model does not
need.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch


def count_flops(fn: Callable[[], object]) -> Tuple[object, int]:
    """(fn's result, the FLOPs its products and convolutions took)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn()
    return out, int(counter.get_total_flops())


class _MetaRng:
    """A training step's randomness on the ``meta`` device: dropout and
    DropPath add no products, so keeping everything leaves the count as it
    is."""

    def dropout(self, x, rate):
        return x

    def bernoulli(self, p):
        return torch.ones_like(p, dtype=torch.bool)

    def seed(self):
        return 0


def _meta(tree):
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device="meta")
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta(v) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return type(tree)(**{k: _meta(getattr(tree, k)) for k in tree.__dataclass_fields__})
    return tree


def grounding_request_flops(values: Dict[str, Any]) -> int:
    """One served grounding request: the reference's V = 2 forward of the
    configuration ``values`` (its two halves of ``INPUT.TRAIN_SAMPLE_NUM``
    frames at ``INPUT.RESOLUTION``, the query padded to
    ``INPUT.MAX_QUERY_LEN`` as the served path pads it)."""
    from reference.vstg.containers import TextBatch, VideoBatch
    from vstg_common import reference_module

    model = reference_module(values).eval()
    T, S = values["INPUT.TRAIN_SAMPLE_NUM"], values["INPUT.RESOLUTION"]
    L = values["INPUT.MAX_QUERY_LEN"]
    with torch.device("meta"):
        video = VideoBatch(torch.empty(2, T, S, S, 3), torch.ones(2, S, S, dtype=torch.bool),
                           torch.ones(2, T, dtype=torch.bool))
        text = TextBatch(torch.zeros(2, L, dtype=torch.long),
                         torch.ones(2, L, dtype=torch.bool))
    with torch.no_grad():
        return count_flops(lambda: model(video, text))[1]


def grounding_step_flops(values: Dict[str, Any], batch) -> int:
    """One training step of the reference over a batch of the shapes of
    ``batch`` ((video, text, targets) as the loader hands them): forward,
    the weighted loss and its backward."""
    from reference.vstg.containers import normalize_uint8_video
    from reference.vstg.loss import build_loss, build_weight_dict
    from vstg_common import reference_cfg, reference_module

    model = reference_module(values).train()
    ns = reference_cfg(values)
    loss_fn, wd = build_loss(ns), build_weight_dict(ns)
    stats = (tuple(values["INPUT.PIXEL_MEAN"]), tuple(values["INPUT.PIXEL_STD"]))
    video, text, targets = _meta(batch)

    def step():
        out = model(normalize_uint8_video(video, stats, dtype=torch.float32), text,
                    train=True, rng=_MetaRng())
        ls = loss_fn(out, targets)
        sum(ls[n] * wd[n] for n in ls if n in wd).backward()

    return count_flops(step)[1]


def vit_flops(tiles: int, image: int = 448, patch: int = 14, width: int = 1024,
              layers: int = 24, mlp: int = 4096, out_dim: int = 4096,
              shuffle: float = 0.5) -> float:
    """InternViT forward over ``tiles`` tiles plus the pixel-shuffle MLP
    projector (2 FLOPs per multiply-add)."""
    g = image // patch
    L = g * g + 1
    per_layer = 2 * L * (4 * width * width + 2 * width * mlp) + 4 * L * L * width
    embed = 2 * g * g * width * 3 * patch * patch
    mixed = int(width / shuffle ** 2)
    tokens = int((g * shuffle) ** 2)
    proj = 2 * tokens * (mixed * out_dim + out_dim * out_dim)
    return tiles * (embed + layers * per_layer + proj)


def qa_answer_flops(vit, llm, frames: int, prompt: int, new_tokens: int) -> float:
    """One QA answer of the geometry ``vit`` / ``llm`` (the reference's
    ``VitGeometry`` / ``LlmGeometry``): vision over ``frames`` tiles, a
    prefill of ``prompt`` tokens and the decode of ``new_tokens``."""
    return (vit_flops(frames, vit.image_size, vit.patch_size, vit.hidden_size, vit.num_layers,
                      vit.intermediate_size, vit.llm_hidden_size, vit.downsample_ratio)
            + llm_flops(prompt, new_tokens, llm.hidden_size, llm.num_layers, llm.num_heads,
                        llm.num_kv_heads, llm.intermediate_size, llm.vocab_size))


def llm_flops(prompt: int, new_tokens: int, hidden: int = 4096, layers: int = 32,
              heads: int = 32, kv_heads: int = 8, ffn: int = 14336,
              vocab: int = 92553) -> float:
    """A prefill of ``prompt`` tokens (the head on its last token) and
    ``new_tokens - 1`` decode steps (each token attends to every earlier
    one; the last sampled token needs no forward)."""
    hd = hidden // heads
    proj = 2 * (2 * hidden * hidden + 2 * hidden * kv_heads * hd + 3 * hidden * ffn)
    tokens = prompt + max(0, new_tokens - 1)
    # causal attention: position p attends to p + 1 keys; QK^T and PV
    attn_pairs = tokens * (tokens + 1) // 2
    attn = 4 * heads * hd * attn_pairs
    heads_out = 2 * hidden * vocab * (1 + max(0, new_tokens - 1))
    return layers * (tokens * proj + attn) + heads_out

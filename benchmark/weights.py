"""Model weights made from the run's seed on the device, for the program and
the reference alike.

``seeded_weights(module, seed, device, dtype)`` walks the parameters of a
module built on the ``meta`` device and fills every one from two calls of
a ``torch.Generator`` on ``device`` (one normal draw and one uniform draw
over flat buffers, each parameter a view of them), scaled by flax-like
rules: linear, convolution and patch kernels N(0, 1/fan_in), embeddings
N(0, 1/dim), norms and layer scales N(1, 0.01), biases N(0, 0.01), the
Swin relative-position tables and ViT tokens N(0, 0.02), the learned
2-D position tables U(0, 1), the decoder's time embedding N(0, 1). The
biases and norm scales are not the zeros and ones of an initialisation, so
that a path that drops one of them shows in the comparison.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn


def _rule(mod: nn.Module, leaf: str, p: torch.Tensor) -> Tuple[str, float, float]:
    """(draw, std, mean) of one parameter."""
    kind = type(mod).__name__
    if leaf in ("row_embed", "col_embed"):
        return "uniform", 1.0, 0.0
    if leaf == "time_embed":
        return "normal", 1.0, 0.0
    if leaf in ("relative_position_bias_table", "cls_token", "pos_embed"):
        return "normal", 0.02, 0.0
    if leaf in ("ls1", "ls2"):
        return "normal", 0.01, 1.0
    if leaf == "patch_embed_kernel":
        return "normal", p[0, ..., 0].numel() ** -0.5, 0.0
    if isinstance(mod, nn.Embedding):
        return "normal", p.shape[1] ** -0.5, 0.0
    if kind in ("LayerNorm", "RMSNorm", "FrozenAffine"):
        return ("normal", 0.01, 1.0) if leaf == "weight" else ("normal", 0.01, 0.0)
    if leaf == "weight" and p.dim() >= 2:
        return "normal", p[0].numel() ** -0.5, 0.0
    return "normal", 0.01, 0.0


def seeded_weights(module: nn.Module, seed: int, device, dtype=torch.float32,
                   scales: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor on ``device`` in ``dtype``} for every
    parameter of ``module`` (built on ``meta``), drawn from ``seed``.
    ``scales`` {regular expression: factor} multiplies the std of every
    parameter whose name matches (a configuration's ``weight_scales``)."""
    plan = []
    rules = [(re.compile(k), v) for k, v in (scales or {}).items()]
    for mname, mod in module.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{leaf}" if mname else leaf
            draw, std, mean = _rule(mod, leaf, p)
            for rx, f in rules:
                if rx.search(name):
                    std *= f
            plan.append((name, tuple(p.shape), draw, std, mean))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    sizes = {"normal": 0, "uniform": 0}
    for _, shape, draw, _, _ in plan:
        sizes[draw] += int(torch.Size(shape).numel())
    flat = {}
    for draw in ("normal", "uniform"):
        buf = torch.empty(sizes[draw], dtype=dtype, device=device)
        if sizes[draw]:
            if draw == "normal":
                buf.normal_(generator=gen)
            else:
                buf.uniform_(generator=gen)
        flat[draw] = buf
    out, offset = {}, {"normal": 0, "uniform": 0}
    with torch.no_grad():
        for name, shape, draw, std, mean in plan:
            n = int(torch.Size(shape).numel())
            t = flat[draw][offset[draw]:offset[draw] + n].view(shape)
            offset[draw] += n
            if std != 1.0:
                t.mul_(std)
            if mean:
                t.add_(mean)
            out[name] = t
    return out

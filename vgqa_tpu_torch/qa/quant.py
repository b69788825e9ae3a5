"""Weight forms of the QA LLM's linear layers: bf16, int8 and int4.

Counterpart of ``vgqa_tpu/qa/quant.py``:

* int8 weight-only, per output channel (absmax / 127): ``kernel_q`` int8
  [in, out] + ``scale`` f32 [out]; :func:`quant_matmul` upcasts the weight
  and scales the output. :func:`quant_matmul_w8a8` quantizes each
  activation row on the fly and contracts int8 x int8 exactly in integers.
* int4 weight-only, group-wise (group 128 along the input axis, absmax / 7):
  ``kernel_q4`` int8 [in/2, out] packs rows k (low nibble) and in/2 + k
  (high nibble), ``scale4`` f32 [in/g, out]. The pack is bit-identical to
  the JAX package's, so packed tensors move between the packages as they
  are. :func:`quant_matmul_int4` routes decode-sized products to the K6
  kernel (``ops/kernels/int4_matmul.py``) by the JAX gate and computes the
  rest in the half-matmul form.

Each form is one linear module: ``DenseLinear`` and ``Int8Linear`` take
``forward(x, w8a8=False)``, ``Int4Linear`` takes ``forward(x, kernels=True)``
(int4 activations stay bf16, so W8A8 does not apply);
:func:`quantize_llm_params` / :func:`quantize_llm_params_int4` swap the
modules of an LLM in place, on the device the weights are on;
:func:`quantize_llm_tree` quantizes a flax-layout parameter tree instead
(what ``tools/convert_weights qa --quantize`` writes).

SmoothQuant (before quantizing): :func:`collect_smooth_stats` runs the float
LLM over calibration tokens and reads each projection input's per-channel
absmax; :func:`smooth_llm_params` folds s = a^alpha / w^(1-alpha) into the
norms and kernels, exact in real arithmetic. Its accuracy gate
(``qa/gate_w8a8.py`` in the JAX package) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

QUANT_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj", "lm_head",
)
INT4_GROUP = 128
INT4_TARGETS = QUANT_TARGETS[:-1]


# -- int8 ---------------------------------------------------------------------
def quantize_kernel(kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[in, out] kernel -> {kernel_q int8 [in, out], scale f32 [out]}
    (contiguous, whatever the strides of ``kernel``)."""
    k = kernel.float().contiguous()
    scale = k.abs().amax(0).clamp_min(1e-8) / 127.0
    q = torch.round(k / scale).clamp(-127, 127).to(torch.int8)
    return {"kernel_q": q, "scale": scale}


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] of one dtype, accumulated and returned in f32
    (JAX's ``preferred_element_type=jnp.float32``), so that the caller
    rounds to the input dtype once. On the card a bf16 / f16 product is one
    cuBLAS call with an f32 output (``aten::mm.dtype``); on the CPU, which
    lacks that operator, the operands go to f32 first: products of bf16
    values are exact in f32, so the sum is the same f32 accumulation."""
    *lead, K = x.shape
    x2 = x.reshape(-1, K)
    if x2.is_cuda and x2.dtype != torch.float32:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = x2.float() @ w.float()
    return y.reshape(*lead, w.shape[1])


def quant_matmul(x: torch.Tensor, qparams: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x [..., in] @ dequant(kernel) -> [..., out] (weight-only int8): the
    f32 product, scaled, rounded to x's dtype once."""
    y = matmul_f32(x, qparams["kernel_q"].to(x.dtype))
    return (y * qparams["scale"]).to(x.dtype)


def _int8_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 contraction [M, K] @ [K, N], returned as f32 (what
    the JAX int32 dot gives after its cast). ``torch._int_mm`` where its
    shape rules allow on the card; elsewhere float64, which holds every
    partial sum exactly (|sum| <= K * 127^2 < 2^53), in column chunks."""
    M, K = xq.shape
    N = wq.shape[1]
    if xq.is_cuda and M > 16 and K % 8 == 0 and N % 8 == 0:
        return torch._int_mm(xq, wq).float()
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    x64 = xq.double()
    step = max(1, (1 << 26) // max(K, 1))
    for n0 in range(0, N, step):
        out[:, n0:n0 + step] = (x64 @ wq[:, n0:n0 + step].double()).float()
    return out


def quant_matmul_w8a8(x: torch.Tensor, qparams: Dict[str, torch.Tensor]) -> torch.Tensor:
    """W8A8: per-row absmax int8 activations x int8 weights, exact integer
    contraction, rescaled by (row scale x per-channel weight scale)."""
    *lead, K = x.shape
    x_scale = x.float().abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
    xq = torch.round(x / x_scale.to(x.dtype)).clamp(-127, 127).to(torch.int8)
    y = _int8_dot(xq.reshape(-1, K), qparams["kernel_q"]).reshape(*lead, -1)
    return (y * x_scale * qparams["scale"]).to(x.dtype)


# -- int4 ---------------------------------------------------------------------
def _int4_group(in_dim: int, group_size: int) -> int:
    g = min(group_size, in_dim)
    while in_dim % g:
        g //= 2
    return max(g, 1)


def quantize_kernel_int4(kernel: torch.Tensor,
                         group_size: int = INT4_GROUP) -> Dict[str, torch.Tensor]:
    """[in, out] kernel -> {kernel_q4 int8 [in/2, out], scale4 f32 [in/g, out]},
    bit-identical to the JAX pack."""
    inn, out = kernel.shape
    if inn % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {inn}")
    g = _int4_group(inn, group_size)
    k = kernel.float().contiguous().reshape(inn // g, g, out)
    scale = k.abs().amax(1).clamp_min(1e-8) / 7.0                     # [n_g, out]
    q = torch.round(k / scale[:, None, :]).clamp(-7, 7).to(torch.int8).reshape(inn, out)
    lo, hi = q[: inn // 2], q[inn // 2:]
    packed = (lo & 0x0F) | (hi << 4)
    return {"kernel_q4": packed, "scale4": scale}


def dequantize_kernel_int4(qparams: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    """Inverse of the pack (up to the rounding): [in, out]."""
    from ..ops.kernels.int4_matmul import unpack_int4

    lo, hi = unpack_int4(qparams["kernel_q4"])
    q = torch.cat([lo, hi], dim=0)
    inn, out = q.shape
    scale = qparams["scale4"]
    n_g = scale.shape[0]
    w = q.to(dtype).reshape(n_g, inn // n_g, out) * scale[:, None, :].to(dtype)
    return w.reshape(inn, out)


def quant_matmul_int4(x: torch.Tensor, qparams: Dict[str, torch.Tensor],
                      kernels: bool = True) -> torch.Tensor:
    """x [..., in] @ dequant4(kernel) -> [..., out].

    With ``kernels`` on, products the JAX gate admits (decode-sized M at
    split-half group shapes) go to ``int4_matmul`` (K6 on the card, its
    plain version on the CPU). Otherwise the half-matmul form: low nibbles
    x rows [0, in/2) plus high nibbles x rows [in/2, in), each half's group
    scales on its weight operand, f32 partials added; or, where a group
    straddles the halves (toy dims), the explicit dequantized matmul."""
    from ..ops.kernels.int4_matmul import (int4_matmul, int4_matmul_kernel_applicable,
                                           unpack_int4)

    packed, scale = qparams["kernel_q4"], qparams["scale4"]
    half, out = packed.shape
    n_g = scale.shape[0]
    g = (half * 2) // n_g
    m = x.numel() // x.shape[-1]
    if kernels and int4_matmul_kernel_applicable(m, half * 2, out, n_g):
        return int4_matmul(x, packed, scale)
    if n_g % 2 or half % g:
        w = dequantize_kernel_int4(qparams, dtype=x.dtype)
        return matmul_f32(x, w).to(x.dtype)
    n2 = n_g // 2
    lo, hi = unpack_int4(packed)

    def _half(q, s, xs):
        w = q.to(x.dtype).reshape(n2, g, out) * s[:, None, :].to(x.dtype)
        return matmul_f32(xs, w.reshape(half, out))

    y = _half(lo, scale[:n2], x[..., :half]) + _half(hi, scale[n2:], x[..., half:])
    return y.to(x.dtype)


# -- the linear modules -----------------------------------------------------------
class DenseLinear(nn.Module):
    """bf16 / f32 weight ``weight`` [out, in] (no bias, as in the LLM)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))

    def forward(self, x, w8a8: bool = False):
        return torch.nn.functional.linear(x, self.weight.to(x.dtype))


class Int8Linear(nn.Module):
    """Per-output-channel int8: ``kernel_q`` [in, out], ``scale`` [out]."""

    def __init__(self, kernel_q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("kernel_q", torch.empty(kernel_q.shape, dtype=torch.int8,
                                                     device=kernel_q.device))
        self.register_buffer("scale", torch.empty(scale.shape, device=scale.device))

    def qparams(self):
        return {"kernel_q": self.kernel_q, "scale": self.scale}

    def forward(self, x, w8a8: bool = False):
        if w8a8:
            return quant_matmul_w8a8(x, self.qparams())
        return quant_matmul(x, self.qparams())


class Int4Linear(nn.Module):
    """Group-wise int4: ``kernel_q4`` [in/2, out] packed, ``scale4`` [in/g, out].
    Always bf16 activations (the group scales do not factor out of an int8
    x int8 dot), so W8A8 does not apply, as in the JAX package."""

    def __init__(self, kernel_q4: torch.Tensor, scale4: torch.Tensor):
        super().__init__()
        self.register_buffer("kernel_q4", torch.empty(kernel_q4.shape, dtype=torch.int8,
                                                      device=kernel_q4.device))
        self.register_buffer("scale4", torch.empty(scale4.shape, device=scale4.device))

    def qparams(self):
        return {"kernel_q4": self.kernel_q4, "scale4": self.scale4}

    def forward(self, x, kernels: bool = True):
        return quant_matmul_int4(x, self.qparams(), kernels)


def _filled(cls, params: Dict[str, torch.Tensor]) -> nn.Module:
    mod = cls(*params.values())
    for name, t in params.items():
        getattr(mod, name).copy_(t)
    return mod


def _swap(llm: nn.Module, make) -> nn.Module:
    """Replace each ``DenseLinear`` that ``make(name, module)`` maps to a new
    module, dropping the dense weight as soon as its replacement exists."""
    names = [n for n, m in llm.named_modules() if isinstance(m, DenseLinear)]
    for name in names:
        parent, _, leaf = name.rpartition(".")
        with torch.no_grad():
            new = make(leaf, llm.get_submodule(name))
        if new is not None:
            setattr(llm.get_submodule(parent) if parent else llm, leaf, new)
    return llm


def quantize_llm_params(llm: nn.Module) -> nn.Module:
    """int8 every projection and the head (in place; returns ``llm``)."""
    return _swap(llm, lambda leaf, m: _filled(Int8Linear, quantize_kernel(m.weight.t()))
                 if leaf in QUANT_TARGETS else None)


def quantize_llm_params_int4(llm: nn.Module) -> nn.Module:
    """int4 (groups of ``INT4_GROUP``) for the seven projections of every
    layer, the head int8 per channel: the JAX package's defaults. In place,
    returns ``llm``; modules already quantized are left as they are."""

    def make(leaf: str, m: DenseLinear):
        w = m.weight.t()
        if leaf in INT4_TARGETS:
            return _filled(Int4Linear, quantize_kernel_int4(w))
        if leaf == "lm_head":
            return _filled(Int8Linear, quantize_kernel(w))
        return None

    return _swap(llm, make)


def is_quantized(llm: nn.Module) -> bool:
    q = getattr(getattr(llm, "layer_0", None), "q_proj", None)
    return isinstance(q, (Int8Linear, Int4Linear))


def linear_forms(llm: nn.Module) -> Dict[str, Any]:
    """Count of linear modules per weight form (for reports)."""
    out: Dict[str, Any] = {}
    for m in llm.modules():
        if isinstance(m, (DenseLinear, Int8Linear, Int4Linear)):
            out[type(m).__name__] = out.get(type(m).__name__, 0) + 1
    return out


# -- parameter trees ----------------------------------------------------------------
def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def quantize_llm_tree(tree: Dict[str, Any], int4: bool = False,
                      group_size: int = INT4_GROUP) -> Dict[str, Any]:
    """A flax-layout llm tree with its projections quantized: int8 per
    channel for every target (``int4=False``), or int4 (groups of
    ``group_size``) for the seven projections with the head int8, as the JAX
    package's ``quantize_llm_params`` / ``quantize_llm_params_int4`` do.
    Leaves may be numpy or torch; the quantized ones come back as torch
    tensors, the rest as they were. Projections already quantized (no
    ``kernel``) are kept."""
    def walk(node):
        out = {}
        for k, v in node.items():
            if not isinstance(v, dict):
                out[k] = v
            elif "kernel" in v and int4 and k in INT4_TARGETS:
                out[k] = quantize_kernel_int4(_tensor(v["kernel"]), group_size)
            elif "kernel" in v and k in QUANT_TARGETS:
                out[k] = quantize_kernel(_tensor(v["kernel"]))
            else:
                out[k] = walk(v)
        return out

    return walk(tree)


# -- SmoothQuant ------------------------------------------------------------------
def collect_smooth_stats(raw_params: Dict[str, Any], cfg, token_ids,
                         dtype: torch.dtype = torch.float32,
                         device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Calibration pass: per-layer, per-input-channel activation absmax.

    ``raw_params`` is the unquantized llm tree, holding ``tok_embeddings``
    for the embedding lookup as converted trees do; ``token_ids`` [B, L] are
    calibration prompts (random ids over the vocab will do: the outlier
    channels live in the weights and embeddings). The LLM is built on
    ``device`` (the card unless ``"cpu"``) in ``dtype`` and run causally
    over the ids. Returns f32 CPU tensors, ``{layer_i: {qkv_in, o_in,
    mlp_in, down_in}}``."""
    from ..models.convert_jax import state_dict_from_jax
    from ..utils.device import resolve_device
    from .llm import LLM, load_llm_state

    device = resolve_device(device)
    with torch.device("meta"):
        llm = LLM(cfg)
    llm = llm.to_empty(device=device).to(dtype).eval()
    load_llm_state(llm, state_dict_from_jax(
        {k: v for k, v in raw_params.items() if k != "tok_embeddings"}))
    ids = _tensor(token_ids).long().clamp(0, cfg.vocab_size - 1)
    B, L = ids.shape
    table = _tensor(raw_params["tok_embeddings"]["embedding"])
    embeds = table[ids].to(device=device, dtype=dtype)
    pos = torch.arange(L, device=device)[None].expand(B, L)
    mask = torch.ones((L, L), dtype=torch.bool, device=device).tril()[None].expand(B, L, L)
    with torch.no_grad():
        _, _, stats = llm(embeds, pos, mask, collect_act_stats=True)
    return {layer: {k: v.cpu() for k, v in st.items()} for layer, st in stats.items()}


def _smooth_scales(act_max, weight_in_absmax, alpha: float = 0.5,
                   lo: float = 1e-2, hi: float = 1e4) -> torch.Tensor:
    """Per-input-channel migration factor s = a^alpha / w^(1-alpha)."""
    a = _tensor(act_max).float().clamp_min(1e-5)
    w = _tensor(weight_in_absmax).float().clamp_min(1e-5)
    return (a ** alpha / w ** (1.0 - alpha)).clamp(lo, hi)


def smooth_llm_params(raw_params: Dict[str, Any], cfg, stats: Dict[str, Any],
                      alpha: float = 0.5) -> Dict[str, Any]:
    """Migrate activation channel outliers into the weights of a raw llm
    tree, exact in real arithmetic and free at run time (every divide folds
    into a static parameter):

    * qkv inputs: attn_norm.scale /= s; q/k/v kernel rows *= s
    * mlp inputs: mlp_norm.scale /= s; gate/up kernel rows *= s
    * o_proj input (the attention context): v_proj output columns /= s,
      o_proj rows *= s. Context channel (head h, dim d) comes from v column
      (kv_head h // group, d), shared by the group's heads, so s is taken
      per (kv_head, d) with a max over the group.
    * down_proj input: up_proj output columns /= s; down_proj rows *= s
      (m = silu(gate) * up is linear in up).

    Apply before quantizing. Returns a new tree (touched leaves as torch
    tensors; the rest as they were)."""
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in raw_params.items()}
    group = cfg.num_heads // cfg.num_kv_heads
    hd = cfg.head_dim
    qkv, gate_up = ("q_proj", "k_proj", "v_proj"), ("gate_proj", "up_proj")

    for i in range(cfg.num_layers):
        p = {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in raw_params[f"layer_{i}"].items()}
        st = stats[f"layer_{i}"]

        def kernel(name):
            return _tensor(p[name]["kernel"])

        def rows_absmax(names):
            return torch.stack([kernel(n).abs().amax(1) for n in names]).amax(0)

        s1 = _smooth_scales(st["qkv_in"], rows_absmax(qkv), alpha)
        p["attn_norm"]["scale"] = _tensor(p["attn_norm"]["scale"]) / s1
        for n in qkv:
            p[n]["kernel"] = kernel(n) * s1[:, None]

        s2 = _smooth_scales(st["mlp_in"], rows_absmax(gate_up), alpha)
        p["mlp_norm"]["scale"] = _tensor(p["mlp_norm"]["scale"]) / s2
        for n in gate_up:
            p[n]["kernel"] = kernel(n) * s2[:, None]

        a_ctx = _tensor(st["o_in"]).reshape(cfg.num_kv_heads, group, hd).amax(1)
        w_o = kernel("o_proj").abs().amax(1).reshape(cfg.num_kv_heads, group, hd).amax(1)
        s3 = _smooth_scales(a_ctx, w_o, alpha)                            # [KVH, hd]
        p["v_proj"]["kernel"] = kernel("v_proj") / s3.reshape(-1)[None, :]
        o_rows = s3[:, None, :].expand(-1, group, -1).reshape(-1)
        p["o_proj"]["kernel"] = kernel("o_proj") * o_rows[:, None]

        s4 = _smooth_scales(st["down_in"], kernel("down_proj").abs().amax(1), alpha)
        p["up_proj"]["kernel"] = kernel("up_proj") / s4[None, :]
        p["down_proj"]["kernel"] = kernel("down_proj") * s4[:, None]
        out[f"layer_{i}"] = p
    return out


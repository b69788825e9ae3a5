"""Serving engine of the multimodal QA model: vision encode, (chunked)
prefill into a KV cache, and greedy or nucleus-sampled decode.

Counterpart of ``vgqa_tpu/qa/engine.py``. The prompt (text ids with
IMG_CONTEXT spans) is embedded and the span positions are overwritten with
vision-tower tokens; prefill runs one causal pass over the padded prompt,
or, for long prompts, ``PREFILL_CHUNK``-sized chunks against the cache;
decode is a plain Python loop of one-token forwards (JAX runs it as one
``while_loop`` program; CUDA graphs are later work) with the same
semantics: a ``[max_new_tokens]`` buffer with -1 past the stop, a stop at
position ``S - 1``, and the nucleus cutoff of the JAX sampler.

The JAX engine's environment switches become constructor keywords with
the same defaults: ``kv_int8`` (int8 KV cache for decode, filled by one
pass after the bf16 prefill), ``w8a8_prefill`` (int8 activations in
prefill for int8 weights), ``vision_chunk`` 8 and ``vision_chunk_yuv`` 4.
Kernel routes follow the tensors' device (the card launches the kernels,
the CPU runs their plain versions); ``use_kernels`` False takes the JAX
package's non-kernel routes instead (einsum ViT and prefill attention,
half-matmul int4), for comparisons. Sampling draws from explicit
``torch.Generator``s. Not ported: the stacked KV layouts and the scanned
decode (``VGQA_STACKED_KV``, ``VGQA_SCAN_DECODE``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .llm import (LLM, LLMConfig, RMSNorm, TokenEmbedding, init_kv_cache, kv_seq_len,
                  load_llm_state, quantize_kv_cache)
from .quant import DenseLinear
from .vit import ViTConfig, VisionTower


class ByteTokenizer:
    """Byte-level reversible tokenizer with chat special tokens (the debug
    tokenizer of the JAX package; real checkpoints ship SentencePiece)."""

    PAD, BOS, EOS, IM_START, IM_END, IMG_CONTEXT = 0, 1, 2, 3, 4, 5
    IMG_START, IMG_END = 6, 7
    OFFSET = 16

    vocab_size = 256 + OFFSET

    def encode(self, text: str) -> List[int]:
        return [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        data = bytes(i - self.OFFSET for i in ids if self.OFFSET <= i < self.OFFSET + 256)
        return data.decode("utf-8", errors="ignore")


@dataclass
class GenerationConfig:
    max_new_tokens: int = 128
    temperature: float = 0.2
    top_p: float = 0.9
    do_sample: bool = True
    # decode exactly max_new_tokens even if EOS fires (benchmarks)
    ignore_eos: bool = False


def _bucket(n: int, minimum: int = 64) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class YUVTiles:
    """I420-plane tile batch: ``planes`` [n_tiles, S*S*3//2] uint8 (Y, U, V
    per tile), ``full_range`` selects JPEG- or MPEG-range BT.601. Half the
    upload bytes of RGB tiles; the engine converts on the device."""

    __slots__ = ("planes", "full_range")

    def __init__(self, planes, full_range: bool = False):
        self.planes = planes
        self.full_range = bool(full_range)

    @property
    def shape(self):
        return self.planes.shape


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def nucleus_logits(logits: torch.Tensor, temperature: torch.Tensor,
                   top_p: torch.Tensor) -> torch.Tensor:
    """The JAX sampler's nucleus mask (engine.py:709-718), per row:
    logits [B, V], temperature/top_p [B]. Returns the temperature-scaled f32
    logits with every logit below the nucleus cutoff set to -inf."""
    scaled = logits.float() / temperature.float().clamp_min(0.01)[:, None]
    sorted_logits = scaled.sort(dim=-1, descending=True).values
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(-1)
    cutoff_idx = (cum < top_p.float()[:, None]).sum(-1).clamp_max(scaled.shape[-1] - 1)
    cutoff = sorted_logits.gather(-1, cutoff_idx[:, None])
    return torch.where(scaled >= cutoff, scaled, float("-inf"))


def _draw(masked: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw from masked logits [V] -> int64 0-d tensor."""
    return torch.multinomial(torch.softmax(masked, dim=-1), 1, generator=generator)[0]


def init_qa_modules(modules: Sequence[torch.nn.Module], generator: torch.Generator) -> None:
    """Seeded random weights with flax-like scales, written in place in the
    parameters' own device and dtype: linear and conv weights N(0, 1/fan_in),
    zero biases, unit norms and layer scales, N(0, 1/dim) embeddings,
    N(0, 0.02) class token and positions."""
    with torch.no_grad():
        for root in modules:
            for m in root.modules():
                if isinstance(m, (torch.nn.Linear, DenseLinear, torch.nn.Conv2d)):
                    m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
                    if getattr(m, "bias", None) is not None:
                        m.bias.zero_()
                elif isinstance(m, torch.nn.Embedding):
                    m.weight.normal_(0.0, m.weight.shape[1] ** -0.5, generator=generator)
                elif isinstance(m, (torch.nn.LayerNorm, RMSNorm)):
                    m.weight.fill_(1.0)
                    if getattr(m, "bias", None) is not None:
                        m.bias.zero_()
            for name, p in root.named_parameters():
                leaf = name.rpartition(".")[2]
                if leaf in ("ls1", "ls2"):
                    p.fill_(1.0)
                elif leaf in ("cls_token", "pos_embed"):
                    p.normal_(0.0, 0.02, generator=generator)


class QAEngine:
    PREFILL_CHUNK = 1024

    # the system message of the "internvl2_5" conversation template
    SYSTEM_PROMPT = (
        "你是书生·万象，英文名"
        "是InternVL，是由上海人工智能"
        "实验室、清华大学及多家"
        "合作单位联合开发的多模"
        "态大语言模型。"
    )

    def __init__(
        self,
        llm_cfg: LLMConfig,
        vit_cfg: ViTConfig,
        llm: LLM,
        embed: TokenEmbedding,
        vision: VisionTower,
        tokenizer=None,
        max_seq_len: int = 8192,
        dtype: torch.dtype = torch.float32,
        kv_int8: bool = True,
        w8a8_prefill: bool = True,
        vision_chunk: int = 8,
        vision_chunk_yuv: int = 4,
        use_kernels: bool = True,
    ):
        """Wrap modules already built on one device (see :meth:`init_random`
        and ``inference/qa._load_engine``)."""
        self.llm_cfg = llm_cfg
        self.vit_cfg = vit_cfg
        self.llm, self.embed, self.vision = llm, embed, vision
        for m in (llm, embed, vision):
            m.requires_grad_(False)         # a serving engine: no autograd
        self.device = embed.tok_embeddings.weight.device
        self.tokenizer = tokenizer or ByteTokenizer()
        self.max_seq_len = min(max_seq_len, llm_cfg.max_seq_len)
        self.dtype = dtype
        # real checkpoints need the published template verbatim; the byte
        # tokenizer of small test engines gets a compact prompt
        self.system_prompt = (self.SYSTEM_PROMPT if tokenizer is not None
                              else "You are a helpful video assistant.")
        g = vit_cfg.grid
        self.num_image_token = int((g * vit_cfg.downsample_ratio) ** 2)
        self.kv_int8 = kv_int8
        self.w8a8_prefill = w8a8_prefill
        self.vision_chunk = vision_chunk
        self.vision_chunk_yuv = vision_chunk_yuv
        # kernel routes (K4 ViT attention, K5 prefill attention, K6 int4
        # decode products) or the JAX package's plain routes; the one flag
        # the modules are called with
        self.use_kernels = use_kernels

    @classmethod
    def init_random(cls, llm_cfg: LLMConfig, vit_cfg: ViTConfig, seed: int = 0,
                    device=None, dtype: torch.dtype = torch.float32, **kw) -> "QAEngine":
        """Random weights from ``seed``, made on ``device`` (the card unless
        ``device="cpu"``) straight in ``dtype``."""
        device = resolve_device(device)
        with torch.device("meta"):
            llm, embed, vision = LLM(llm_cfg), TokenEmbedding(llm_cfg), VisionTower(vit_cfg)
        mods = [m.to_empty(device=device).to(dtype) for m in (llm, embed, vision)]
        init_qa_modules(mods, torch.Generator(device=device).manual_seed(seed))
        for m in mods:
            m.eval()
        return cls(llm_cfg, vit_cfg, *mods, dtype=dtype, **kw)

    def load_tree(self, params) -> "QAEngine":
        """Load a flax-layout tree ``{"llm", "embed", "vision"}`` (numpy or
        array leaves; dense, int8 or int4 projections, as the JAX package
        holds them) into the modules: float leaves in the engine dtype,
        quantized leaves as stored."""
        from ..models.convert_jax import state_dict_from_jax

        load_llm_state(self.llm, state_dict_from_jax(params["llm"]))
        self.embed.load_state_dict(state_dict_from_jax(params["embed"]))
        self.vision.load_state_dict(state_dict_from_jax(params["vision"]))
        return self

    # -- prefill / decode -----------------------------------------------------
    def _flash(self, q_offset: int, length: torch.Tensor):
        return {"q_offset": q_offset, "length": length} if self.use_kernels else None

    def _prefill_impl(self, embeds: torch.Tensor, length: torch.Tensor, cache):
        """embeds [1, Lp, D]; causal mask limited to ``length`` real tokens;
        the prefill K/V are copied into the persistent ``cache``."""
        Lp = embeds.shape[1]
        idx = torch.arange(Lp, device=self.device)
        pos = idx[None]
        mask = (idx[None, :, None] >= idx[None, None, :]) & (idx[None, None, :] < length)
        logits, new_cache = self.llm(
            embeds, pos, mask, cache=None, lm_head_rows=(length - 1).reshape(1),
            flash_prefill=self._flash(0, length), w8a8=self.w8a8_prefill,
            kernels=self.use_kernels)
        for (ck, cv), (nk, nv) in zip(cache, new_cache):
            ck[:, :, :Lp] = nk
            cv[:, :, :Lp] = nv
        return logits[:, 0], cache

    def _prefill_chunked_impl(self, embeds: torch.Tensor, length: torch.Tensor, cache):
        """Long prompts stream through the cache in ``PREFILL_CHUNK``-sized
        causal chunks: chunk i writes its K/V at offset i*CK and attends over
        everything written so far."""
        CK = self.PREFILL_CHUNK
        Lp = embeds.shape[1]
        if Lp % CK:
            raise ValueError(f"chunked prefill length {Lp} is not a multiple of {CK}")
        S = kv_seq_len(cache)
        key_idx = torch.arange(S, device=self.device)
        last = None
        for i in range(Lp // CK):
            pos = (i * CK + torch.arange(CK, device=self.device))[None]
            mask = (key_idx[None, None, :] <= pos[:, :, None]) & (key_idx[None, None, :] < length)
            li = (length - 1 - i * CK).clamp(0, CK - 1)
            logits, cache = self.llm(
                embeds[:, i * CK:(i + 1) * CK], pos, mask, cache=cache, cache_index=i * CK,
                lm_head_rows=li.reshape(1), flash_prefill=self._flash(i * CK, length),
                w8a8=self.w8a8_prefill, kernels=self.use_kernels)
            cand = logits[:, 0]
            if last is None:
                last = cand
            else:
                in_chunk = (length - 1 >= i * CK) & (length - 1 < (i + 1) * CK)
                last = torch.where(in_chunk, cand, last)
        return last, cache

    def _plan_prefill(self, length: int):
        """(padded prefill length, chunked): short prompts pad to a power of
        two and prefill in one pass; long ones (> 4 chunks) pad to a chunk
        multiple under the chunk-rounded context, else one pass."""
        Lp = min(_bucket(length), self.max_seq_len)
        chunked = Lp > 4 * self.PREFILL_CHUNK
        if chunked:
            CK = self.PREFILL_CHUNK
            cap = (self.max_seq_len // CK) * CK
            if length <= cap:
                Lp = min(-(-length // CK) * CK, cap)
            else:
                chunked = False
        return Lp, chunked

    def _decode_impl(self, cache, token: torch.Tensor, position):
        """token [B] ids; position a host int (all rows) or [B] tensor."""
        embeds = self.embed(token[:, None]).to(self.dtype)
        S = kv_seq_len(cache)
        ar = torch.arange(S, device=self.device)
        if isinstance(position, int):
            pos = torch.full((token.shape[0], 1), position, device=self.device)
            mask = (ar <= position)[None, None].expand(token.shape[0], 1, S)
        else:
            pos = position[:, None]
            mask = ar[None, None, :] <= position[:, None, None]
        logits, cache = self.llm(embeds, pos, mask, cache=cache, cache_index=position,
                                 kernels=self.use_kernels)
        return logits[:, 0], cache

    def _stop_ids(self, ignore_eos: bool):
        tok = self.tokenizer
        return [] if ignore_eos else [tok.EOS, tok.IM_END]

    def _generate(self, cache, first_logits, length: int, gen: GenerationConfig,
                  generator: Optional[torch.Generator]) -> List[int]:
        """The solo greedy / nucleus loop: emits up to ``max_new_tokens``,
        stops at a stop id or when the cache position reaches S - 1."""
        S = kv_seq_len(cache)
        stops = self._stop_ids(gen.ignore_eos)
        sample = gen.do_sample and gen.temperature > 0
        temp = torch.tensor([gen.temperature], device=self.device)
        top_p = torch.tensor([gen.top_p], device=self.device)
        logits, position, out = first_logits, length, []
        for t in range(gen.max_new_tokens):
            if sample:
                next_id = _draw(nucleus_logits(logits, temp, top_p)[0], generator)
            else:
                next_id = logits[0].argmax()
            if position >= S - 1 or (stops and int(next_id) in stops):
                break
            out.append(next_id)
            if t + 1 == gen.max_new_tokens:
                break
            logits, cache = self._decode_impl(cache, next_id.reshape(1), position)
            position += 1
        return [int(i) for i in torch.stack(out).tolist()] if out else []

    # -- prompt assembly --------------------------------------------------------
    def build_prompt_ids(self, question: str, num_patches_list: List[int]):
        """The "internvl2_5" chat template with per-frame IMG_CONTEXT spans
        (``vgqa_tpu/qa/engine.py:748``)."""
        tok = self.tokenizer
        enc = tok.encode
        img_s = getattr(tok, "IMG_START", tok.IM_START)
        img_e = getattr(tok, "IMG_END", tok.IM_END)

        ids: List[int] = [tok.BOS]
        ids += [tok.IM_START] + enc("system\n" + self.system_prompt)
        ids += [tok.IM_END] + enc("\n")
        ids += [tok.IM_START] + enc("user\n")
        img_positions: List[int] = []
        for i, n_tiles in enumerate(num_patches_list):
            ids += enc(f"Frame{i + 1}: ") + [img_s]
            for _ in range(n_tiles * self.num_image_token):
                img_positions.append(len(ids))
                ids.append(tok.IMG_CONTEXT)
            ids += [img_e] + enc("\n")
        ids += enc(question) + [tok.IM_END] + enc("\n")
        ids += [tok.IM_START] + enc("assistant\n")
        return ids, img_positions

    # -- vision -----------------------------------------------------------------
    def _upload(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, non_blocking=True)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, non_blocking=True)

    def _vision_apply(self, tiles: torch.Tensor) -> torch.Tensor:
        """uint8 tiles are normalized on the device ((x/255 - mean)/std as one
        multiply-add in the engine dtype); float tiles go in as they are."""
        if tiles.dtype == torch.uint8:
            std = torch.tensor(IMAGENET_STD, device=self.device)
            mean = torch.tensor(IMAGENET_MEAN, device=self.device)
            scale = (1.0 / (255.0 * std)).to(self.dtype)
            bias = (-mean / std).to(self.dtype)
            tiles = tiles.to(self.dtype) * scale + bias
        return self.vision(tiles.to(self.dtype), flash=self.use_kernels)

    def _vision_apply_yuv(self, planes: torch.Tensor, full_range: bool) -> torch.Tensor:
        """I420 planes [n, S*S*3//2] uint8 -> vision tokens: BT.601 (nearest
        2x2 chroma upsample) and ImageNet normalization in f32 on the device."""
        S = self.vit_cfg.image_size
        npx, nc = S * S, (S // 2) * (S // 2)
        n = planes.shape[0]
        y = planes[:, :npx].reshape(n, S, S).float()
        u = planes[:, npx:npx + nc].reshape(n, S // 2, S // 2).float()
        v = planes[:, npx + nc:].reshape(n, S // 2, S // 2).float()
        u = u.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
        v = v.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
        if full_range:
            yl, cr, gu, gv, bu = y, 1.402, 0.344136, 0.714136, 1.772
        else:
            yl = 1.1643835616 * (y - 16.0)
            cr, gu, gv, bu = 1.5960267857, 0.3917622768, 0.8129676339, 2.0172321429
        rgb = torch.stack([yl + cr * v, yl - gu * u - gv * v, yl + bu * u], -1).clamp(0.0, 255.0)
        std = torch.tensor(IMAGENET_STD, device=self.device)
        mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        tiles = (rgb * (1.0 / (255.0 * std)) + (-mean / std)).to(self.dtype)
        return self.vision(tiles, flash=self.use_kernels)

    def _encode_vision(self, tiles) -> torch.Tensor:
        """Upload host tiles and run the vision tower -> [n_tiles, tok, D].
        uint8 and I420 batches larger than the chunk size upload and encode
        chunk by chunk (each chunk's upload overlaps the previous chunk's
        compute); a ragged remainder runs as a smaller last chunk."""
        with torch.no_grad():
            if isinstance(tiles, YUVTiles):
                planes, ck = tiles.planes, self.vision_chunk_yuv
                n = planes.shape[0]
                step = n if ck <= 0 or n <= ck else ck
                return torch.cat([self._vision_apply_yuv(self._upload(planes[i:i + step]),
                                                         tiles.full_range)
                                  for i in range(0, n, step)], 0)
            n, ck = tiles.shape[0], self.vision_chunk
            uint8 = tiles.dtype in (np.uint8, torch.uint8)
            step = n if (not uint8 or ck <= 0 or n <= ck) else ck
            return torch.cat([self._vision_apply(self._upload(tiles[i:i + step]))
                              for i in range(0, n, step)], 0)

    def _embed_prompt(self, ids: List[int], img_positions: List[int], vision_tokens, Lp: int):
        ids_arr = np.zeros((1, Lp), np.int64)
        ids_arr[0, :len(ids)] = ids
        embeds = self.embed(self._upload(ids_arr)).to(self.dtype)
        if img_positions:
            embeds[0, self._upload(np.asarray(img_positions, np.int64))] = \
                vision_tokens.to(self.dtype)
        return embeds

    def _prefill(self, embeds, length: int, Lp: int, chunked: bool, max_total: int):
        """bf16 (engine dtype) prefill into a fresh cache, then the int8
        conversion for decode when ``kv_int8``."""
        cache = init_kv_cache(self.llm_cfg, 1, max_total, self.dtype, device=self.device)
        n = torch.tensor(length, device=self.device)
        fn = self._prefill_chunked_impl if chunked else self._prefill_impl
        logits, cache = fn(embeds, n, cache)
        if self.kv_int8:
            cache = quantize_kv_cache(cache)
        return logits, cache

    # -- public chat API --------------------------------------------------------
    @torch.no_grad()
    def chat(
        self,
        tiles,                               # [n, S, S, 3] uint8 / float, or YUVTiles
        question: str,
        gen: Optional[GenerationConfig] = None,
        num_patches_list: Optional[List[int]] = None,
        generator: Optional[torch.Generator] = None,
        return_stats: bool = False,
    ):
        """The answer string; with ``return_stats`` ``(answer, stats)`` with
        the phases' wall times and rates (``vision_s``, ``prefill_s``,
        ``prefill_tok_s``, ``decode_s``, ``decode_tok_s``), each phase fenced
        by a scalar read from the device."""
        gen = gen or GenerationConfig()
        if num_patches_list is None:
            num_patches_list = [tiles.shape[0]]
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        stats: Dict[str, Any] = {}

        t0 = time.perf_counter()
        vision_tokens = self._encode_vision(tiles)
        vision_tokens = vision_tokens.reshape(-1, vision_tokens.shape[-1])
        if return_stats:
            float(vision_tokens[0, 0])         # fence: the phase has run
            stats["vision_s"] = time.perf_counter() - t0
            stats["vision_tiles"] = int(tiles.shape[0])
            t0 = time.perf_counter()

        ids, img_positions = self.build_prompt_ids(question, num_patches_list)
        if len(img_positions) != vision_tokens.shape[0]:
            raise ValueError(f"{len(img_positions)} image-token slots vs "
                             f"{vision_tokens.shape[0]} vision tokens")
        length = len(ids)
        if length > self.max_seq_len:
            raise ValueError(
                f"prompt is {length} tokens but the model's context is "
                f"{self.max_seq_len}; reduce num_frames or tiles "
                f"({len(num_patches_list)} frames x {self.num_image_token} "
                "image tokens per tile)")
        Lp, chunked = self._plan_prefill(length)
        max_total = min(self.max_seq_len, Lp + gen.max_new_tokens)
        embeds = self._embed_prompt(ids, img_positions, vision_tokens, Lp)
        logits, cache = self._prefill(embeds, length, Lp, chunked, max_total)
        if return_stats:
            float(logits[0, 0])
            stats["prefill_s"] = time.perf_counter() - t0
            stats["prefill_tokens"] = length
            stats["prefill_tok_s"] = length / stats["prefill_s"]
            stats["prefill_chunked"] = bool(chunked)
            t0 = time.perf_counter()

        out_ids = self._generate(cache, logits, length, gen, generator)
        text = self.tokenizer.decode(out_ids)
        if return_stats:
            stats["decode_s"] = time.perf_counter() - t0
            stats["decode_tokens"] = len(out_ids)
            stats["decode_tok_s"] = max(len(out_ids), 1) / stats["decode_s"]
            return text, stats
        return text

    @torch.no_grad()
    def prefill_logits(self, tiles, question: str, num_patches_list=None) -> torch.Tensor:
        """The last prompt token's logits [1, V] (vision + prefill only)."""
        npl = num_patches_list or [tiles.shape[0]]
        vision_tokens = self._encode_vision(tiles)
        vision_tokens = vision_tokens.reshape(-1, vision_tokens.shape[-1])
        ids, img_positions = self.build_prompt_ids(question, npl)
        Lp, chunked = self._plan_prefill(len(ids))
        embeds = self._embed_prompt(ids, img_positions, vision_tokens, Lp)
        cache = init_kv_cache(self.llm_cfg, 1, Lp, self.dtype, device=self.device)
        n = torch.tensor(len(ids), device=self.device)
        fn = self._prefill_chunked_impl if chunked else self._prefill_impl
        return fn(embeds, n, cache)[0]

    @torch.no_grad()
    def chat_batch(
        self,
        requests,
        gen: Optional[GenerationConfig] = None,
        gens: Optional[List[GenerationConfig]] = None,
        generators: Optional[List[torch.Generator]] = None,
        return_stats: bool = False,
    ):
        """Serve B requests with one lockstep batched decode.

        ``requests``: ``(tiles, question)`` or ``(tiles, question,
        num_patches_list)`` tuples. Vision and prefill run per request, each
        into its own row of a shared [B, ...] cache; then all rows decode
        together, each at its own position, with its own ``max_new_tokens``,
        temperature, top-p and generator (``generators[b]``, default seeded
        ``b``), so a row draws what a solo chat with that generator draws. Returns the answers (and stats with ``return_stats``)."""
        if gens is not None:
            if len(gens) != len(requests):
                raise ValueError(f"{len(gens)} generation configs for {len(requests)} requests")
        else:
            gens = [gen or GenerationConfig()] * len(requests)
        if not requests:
            return ([], {}) if return_stats else []
        t0 = time.perf_counter()
        prepped = []
        for req in requests:
            tiles, question = req[0], req[1]
            npl = list(req[2]) if len(req) > 2 else [tiles.shape[0]]
            vision_tokens = self._encode_vision(tiles)
            vision_tokens = vision_tokens.reshape(-1, vision_tokens.shape[-1])
            ids, img_positions = self.build_prompt_ids(question, npl)
            if len(img_positions) != vision_tokens.shape[0]:
                raise ValueError(f"{len(img_positions)} image-token slots vs "
                                 f"{vision_tokens.shape[0]} vision tokens")
            if len(ids) > self.max_seq_len:
                raise ValueError(f"prompt is {len(ids)} tokens but the model's context "
                                 f"is {self.max_seq_len}")
            prepped.append((vision_tokens, ids, img_positions, len(ids)))

        # one prefill shape from the longest prompt (shorter rows pad; their
        # cache rows are masked by the per-row positions during decode)
        Lp, chunked = self._plan_prefill(max(p[3] for p in prepped))
        max_new = max(g.max_new_tokens for g in gens)
        max_total = min(self.max_seq_len, Lp + max_new)
        B = len(prepped)
        batch_cache = init_kv_cache(self.llm_cfg, B, max_total, self.dtype,
                                    quant="int8" if self.kv_int8 else None, device=self.device)
        first = []
        for i, (vision_tokens, ids, img_positions, length) in enumerate(prepped):
            embeds = self._embed_prompt(ids, img_positions, vision_tokens, Lp)
            logits, cache = self._prefill(embeds, length, Lp, chunked, max_total)
            for dst, src in zip(batch_cache, cache):            # row i, in place
                pairs = dst.items() if isinstance(dst, dict) else enumerate(dst)
                for key, buf in pairs:
                    buf[i:i + 1].copy_(src[key])
            del cache
            first.append(logits)

        tokens = self._generate_batch(batch_cache, torch.cat(first, 0),
                                      [p[3] for p in prepped], gens, generators)
        answers = [self.tokenizer.decode([t for t in row if t >= 0]) for row in tokens]
        if return_stats:
            dt = time.perf_counter() - t0
            return answers, {"batch": B, "total_s": dt,
                             "agg_tok_s_e2e": sum(g.max_new_tokens for g in gens) / dt}
        return answers

    def _generate_batch(self, cache, first_logits, lengths: List[int],
                        gens: List[GenerationConfig], generators) -> List[List[int]]:
        """The lockstep loop: a finished row keeps riding the batch (emitting
        -1) until every row has stopped or the longest budget is spent."""
        S = kv_seq_len(cache)
        B = len(gens)
        dev = self.device
        max_new = max(g.max_new_tokens for g in gens)
        stops = self._stop_ids(all(g.ignore_eos for g in gens))
        stop_t = torch.tensor(stops or [-1], device=dev)
        limits = torch.tensor([g.max_new_tokens for g in gens], device=dev)
        sampled = [bool(g.do_sample and g.temperature > 0) for g in gens]
        if any(sampled) and generators is None:
            generators = [torch.Generator(device=dev).manual_seed(b) for b in range(B)]
        temps = torch.tensor([g.temperature for g in gens], device=dev)
        top_ps = torch.tensor([g.top_p for g in gens], device=dev)
        position = torch.tensor(lengths, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        tokens = torch.full((max_new, B), -1, dtype=torch.int64, device=dev)
        logits = first_logits
        for t in range(max_new):
            next_id = logits.argmax(-1)
            if any(sampled):
                masked = nucleus_logits(logits, temps, top_ps)
                draws = [_draw(masked[b], generators[b]) if sampled[b] else next_id[b]
                         for b in range(B)]
                next_id = torch.stack(draws)
            is_stop = torch.isin(next_id, stop_t) | (position >= S - 1) | (t >= limits)
            tokens[t] = torch.where(done | is_stop, -1, next_id)
            done = done | is_stop
            if t + 1 == max_new or bool(done.all()):
                break
            logits, cache = self._decode_impl(cache, tokens[t].clone(), position)
            position = position + 1
        return tokens.t().tolist()

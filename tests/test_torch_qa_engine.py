"""The port's QA engine against ``vgqa_tpu.qa.engine.QAEngine`` on one
weight tree: greedy chat tokens identical (tiny config, and an int4 config
whose projections all pass the K6 gate), with the kernel routes on (Pallas
in interpret mode on the JAX side, the kernels' plain versions here) and
off; chunked prefill; I420 tiles; the nucleus mask; batched decode against
solo chats. float32 engines."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgqa_tpu.qa import engine as jeng_mod
from vgqa_tpu.qa import quant as jquant
from vgqa_tpu.qa.llm import LLMConfig as JLLMConfig
from vgqa_tpu.qa.vit import ViTConfig as JViTConfig
from vgqa_tpu_torch.qa import engine as teng_mod
from vgqa_tpu_torch.qa.llm import LLMConfig
from vgqa_tpu_torch.qa.vit import ViTConfig

INT4_LLM = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                intermediate_size=512, max_seq_len=512, rope_theta=10000.0)


class IdTokenizer(jeng_mod.ByteTokenizer):
    """Byte tokenizer whose decode returns the ids, so answers compare as
    token sequences (special and out-of-range ids included)."""

    def decode(self, ids):
        return ",".join(str(int(i)) for i in ids)


def _configs(kind):
    if kind in ("tiny", "int8"):
        return dict(), dict()
    return INT4_LLM, dict(llm_hidden_size=256)


def _engines(monkeypatch, kind: str, routes: bool, max_seq_len: int = 256, **port_kw):
    """(jax engine, port engine) on one tree; the JAX engine reads its
    routes and switches from the environment when it is built, the port
    takes them as keywords (``port_kw``)."""
    if routes:
        monkeypatch.setenv("VGQA_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("VGQA_PALLAS_INTERPRET", raising=False)
    lk, vk = _configs(kind)
    jl = JLLMConfig(**lk) if lk else JLLMConfig.tiny()
    jv = JViTConfig(**{**JViTConfig.tiny().__dict__, **vk})
    tok = IdTokenizer()
    jeng = jeng_mod.QAEngine.init_random(jl, jv, rng=jax.random.PRNGKey(3), tokenizer=tok,
                                         max_seq_len=max_seq_len)
    params = jax.tree.map(np.array, jeng.params)
    if kind in ("int8", "int4"):
        quantize = (jquant.quantize_llm_params if kind == "int8"
                    else jquant.quantize_llm_params_int4)
        params["llm"] = jax.tree.map(np.array, quantize(params["llm"]))
        jeng.params = jax.tree.map(jnp.asarray, params)
    tl = LLMConfig(**lk) if lk else LLMConfig.tiny()
    tv = ViTConfig(**{**ViTConfig.tiny().__dict__, **vk})
    teng = teng_mod.QAEngine.init_random(tl, tv, device="cpu", tokenizer=tok,
                                         max_seq_len=max_seq_len, use_kernels=routes,
                                         **port_kw)
    teng.load_tree(params)
    return jeng, teng


def _tiles(n, s=32, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, s, s, 3), np.uint8)


GREEDY = dict(max_new_tokens=8, do_sample=False, ignore_eos=True)


@pytest.mark.parametrize("kind", ["tiny", "int4"])
@pytest.mark.parametrize("routes", [True, False])
def test_greedy_chat_tokens_equal_jax(monkeypatch, kind, routes):
    jeng, teng = _engines(monkeypatch, kind, routes)
    tiles = _tiles(2)
    want = jeng.chat(tiles, "what is the man doing?", jeng_mod.GenerationConfig(**GREEDY))
    got, stats = teng.chat(tiles, "what is the man doing?",
                           teng_mod.GenerationConfig(**GREEDY), return_stats=True)
    assert got == want
    assert len(got.split(",")) == 8
    assert stats["decode_tokens"] == 8 and not stats["prefill_chunked"]
    assert all(np.isfinite(v) for v in stats.values() if isinstance(v, float))


@pytest.mark.parametrize("env,port_kw,kind", [
    ({}, {}, "int8"),
    ({"VGQA_W8A8_PREFILL": "0"}, {"w8a8_prefill": False}, "int8"),
    ({"VGQA_KV_INT8": "0"}, {"kv_int8": False}, "tiny"),
    ({"VGQA_VISION_CHUNKS": "1"}, {"vision_chunk": 1}, "tiny"),
])
def test_engine_switches_equal_jax_environment(monkeypatch, env, port_kw, kind):
    """Each environment switch of the JAX engine is a keyword of the port's:
    the same setting gives the same greedy tokens (int8 weights with W8A8
    prefill on and off, the bf16 KV cache, one tile per vision chunk)."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jeng, teng = _engines(monkeypatch, kind, True, **port_kw)
    tiles = _tiles(3, seed=13)
    want = jeng.chat(tiles, "what is on the table?", jeng_mod.GenerationConfig(**GREEDY))
    got = teng.chat(tiles, "what is on the table?", teng_mod.GenerationConfig(**GREEDY))
    assert got == want and len(got.split(",")) == 8


@pytest.mark.parametrize("routes", [True, False])
def test_chunked_prefill_equals_jax_and_one_shot(monkeypatch, routes):
    """PREFILL_CHUNK 16: the prompt (~90 tokens) streams through the cache
    in chunks; logits as JAX's chunked prefill and as the one-shot pass."""
    jeng, teng = _engines(monkeypatch, "tiny", routes)
    for e in (jeng, teng):
        e.PREFILL_CHUNK = 16
    tiles = _tiles(2, seed=1)
    ids, img_pos = teng.build_prompt_ids("where is the dog?", [1, 1])
    Lp, chunked = teng._plan_prefill(len(ids))
    assert chunked and Lp % 16 == 0
    vt = teng._encode_vision(tiles).reshape(-1, teng.llm_cfg.hidden_size)
    embeds = teng._embed_prompt(ids, img_pos, vt, Lp)
    from vgqa_tpu_torch.qa.llm import init_kv_cache

    with torch.no_grad():
        got, _ = teng._prefill_chunked_impl(embeds, torch.tensor(len(ids)),
                                            init_kv_cache(teng.llm_cfg, 1, Lp + 8,
                                                          torch.float32))
        one, _ = teng._prefill_impl(embeds, torch.tensor(len(ids)),
                                    init_kv_cache(teng.llm_cfg, 1, Lp + 8, torch.float32))
    from vgqa_tpu.qa.llm import init_kv_cache as jinit

    want, _ = jeng._prefill_chunked_impl(jeng.params, jnp.asarray(embeds.numpy()),
                                         jnp.asarray(len(ids)),
                                         jinit(jeng.llm_cfg, 1, Lp + 8, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=2e-4, rtol=1e-3)
    a = teng.chat(tiles, "where is the dog?", teng_mod.GenerationConfig(**GREEDY))
    b = jeng.chat(tiles, "where is the dog?", jeng_mod.GenerationConfig(**GREEDY))
    assert a == b


def _i420_to_rgb_host(planes, s, full_range):
    n = planes.shape[0]
    npx, nc = s * s, (s // 2) * (s // 2)
    y = planes[:, :npx].reshape(n, s, s).astype(np.float32)
    u = planes[:, npx:npx + nc].reshape(n, s // 2, s // 2).astype(np.float32)
    v = planes[:, npx + nc:].reshape(n, s // 2, s // 2).astype(np.float32)
    u = np.repeat(np.repeat(u, 2, 1), 2, 2) - 128.0
    v = np.repeat(np.repeat(v, 2, 1), 2, 2) - 128.0
    if full_range:
        yl, cr, gu, gv, bu = y, 1.402, 0.344136, 0.714136, 1.772
    else:
        yl = 1.1643835616 * (y - 16.0)
        cr, gu, gv, bu = 1.5960267857, 0.3917622768, 0.8129676339, 2.0172321429
    return np.clip(np.stack([yl + cr * v, yl - gu * u - gv * v, yl + bu * u], -1), 0.0, 255.0)


@pytest.mark.parametrize("full_range", [False, True])
def test_yuv_tiles_match_host_conversion_and_jax(monkeypatch, full_range):
    """I420 tiles through _encode_vision equal the tower on host-converted
    float tiles (tests/test_qa.py:816-858) and the JAX engine's I420 path;
    chunked (2 per chunk, ragged remainder) equals one shot."""
    jeng, teng = _engines(monkeypatch, "tiny", True)
    s = teng.vit_cfg.image_size
    planes = np.random.RandomState(11).randint(0, 256, (5, s * s * 3 // 2), dtype=np.uint8)
    rgb = _i420_to_rgb_host(planes, s, full_range)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    ref = ((rgb / 255.0 - mean) / std).astype(np.float32)
    yuv = teng_mod.YUVTiles(planes, full_range)
    got = teng._encode_vision(yuv)
    want = teng._encode_vision(ref)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    jgot = jeng._encode_vision(jeng_mod.YUVTiles(planes, full_range))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=2e-4, rtol=1e-3)
    teng.vision_chunk_yuv = 2
    np.testing.assert_allclose(teng._encode_vision(yuv).numpy(), got.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_nucleus_mask_equals_jax_formula():
    rng = np.random.RandomState(12)
    logits = rng.randn(3, 50).astype(np.float32) * 3
    temps = np.array([0.2, 1.0, 0.001], np.float32)
    top_ps = np.array([0.9, 0.5, 0.99], np.float32)

    def jax_mask(lg, temperature, top_p):       # engine.py:709-718
        scaled = lg.astype(jnp.float32) / jnp.maximum(temperature, 0.01)
        sorted_logits = jnp.sort(scaled)[::-1]
        cum = jnp.cumsum(jax.nn.softmax(sorted_logits))
        cutoff = sorted_logits[jnp.minimum(jnp.sum(cum < top_p), scaled.shape[0] - 1)]
        return jnp.where(scaled >= cutoff, scaled, -jnp.inf)

    want = np.stack([np.asarray(jax_mask(jnp.asarray(logits[b]), temps[b], top_ps[b]))
                     for b in range(3)])
    got = teng_mod.nucleus_logits(torch.from_numpy(logits), torch.from_numpy(temps),
                                  torch.from_numpy(top_ps)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)], rtol=1e-6)


def test_chat_batch_equals_solo_chats(monkeypatch):
    """Lockstep decode: each row answers as its solo chat, greedy rows with
    their own token budgets and a sampled row with its own generator."""
    _, teng = _engines(monkeypatch, "tiny", True)
    reqs = [(_tiles(2, seed=2), "what happens?"), (_tiles(1, seed=3), "who is there")]
    gens = [teng_mod.GenerationConfig(max_new_tokens=6, do_sample=False, ignore_eos=True),
            teng_mod.GenerationConfig(max_new_tokens=4, temperature=0.8, top_p=0.9,
                                      ignore_eos=True)]
    got = teng.chat_batch(reqs, gens=gens, generators=[torch.Generator().manual_seed(7),
                                                       torch.Generator().manual_seed(8)])
    solo0 = teng.chat(*reqs[0], gens[0])
    solo1 = teng.chat(*reqs[1], gens[1], generator=torch.Generator().manual_seed(8))
    assert got == [solo0, solo1]
    assert len(got[0].split(",")) == 6 and len(got[1].split(",")) == 4
    again = teng.chat(*reqs[1], gens[1], generator=torch.Generator().manual_seed(8))
    assert again == solo1


def test_greedy_batch_equals_jax_chat_batch(monkeypatch):
    jeng, teng = _engines(monkeypatch, "int4", True)
    reqs = [(_tiles(2, seed=4), "what happens?"), (_tiles(1, seed=5), "who is there")]
    g = dict(max_new_tokens=5, do_sample=False, ignore_eos=True)
    want = jeng.chat_batch(reqs, gen=jeng_mod.GenerationConfig(**g))
    got = teng.chat_batch(reqs, gen=teng_mod.GenerationConfig(**g))
    assert got == want

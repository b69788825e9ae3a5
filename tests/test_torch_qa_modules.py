"""The port's QA modules against ``vgqa_tpu``'s on one numpy weight tree:
the InternViT block and vision tower (flash route on and off), the LLM
forward for prefill and decode over dense, int8 and int4 weights and both
KV cache forms, the int8 matmuls, and the KV quantizer. The Pallas routes
of the JAX side run in interpret mode. float32; atol 2e-4 / rtol 1e-3 as in
``tests/test_pallas.py`` (sums in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgqa_tpu.qa import llm as jllm
from vgqa_tpu.qa import llm_functional as jlf
from vgqa_tpu.qa import quant as jquant
from vgqa_tpu.qa import vit as jvit
from vgqa_tpu_torch.models.convert_jax import state_dict_from_jax
from vgqa_tpu_torch.qa import llm as tllm
from vgqa_tpu_torch.qa import quant as tquant
from vgqa_tpu_torch.qa import vit as tvit

TOL = dict(atol=2e-4, rtol=1e-3)
# the int4 geometry: every projection passes the K6 gate (K, N multiples of 128)
INT4_LLM = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                intermediate_size=512, max_seq_len=512, rope_theta=10000.0)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _noisy(tree, seed):
    """Perturb every float leaf so unit norms / layer scales are exercised."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: a + 0.1 * rng.randn(*a.shape).astype(a.dtype)
        if a.dtype == np.float32 else a, _np_tree(tree))


def _port_vit_cfg(cfg):
    """The port's config of a JAX ViTConfig (its ``flash`` field is the
    port's ``forward(..., flash=)`` argument)."""
    fields = dataclasses.asdict(cfg)
    fields.pop("flash")
    return tvit.ViTConfig(**fields)


@pytest.mark.parametrize("flash", [False, True])
def test_vit_block_matches_jax(monkeypatch, flash):
    monkeypatch.setenv("VGQA_PALLAS_INTERPRET", "1")
    cfg = dataclasses.replace(jvit.ViTConfig.tiny(), flash=flash)
    x = np.random.RandomState(0).randn(2, 17, cfg.hidden_size).astype(np.float32)
    params = _noisy(jvit.ViTBlock(cfg).init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    want = jvit.ViTBlock(cfg).apply({"params": params}, jnp.asarray(x))
    block = tvit.ViTBlock(_port_vit_cfg(cfg))
    block.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = block(torch.from_numpy(x), flash=flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("flash", [False, True])
def test_vision_tower_matches_jax(monkeypatch, flash):
    monkeypatch.setenv("VGQA_PALLAS_INTERPRET", "1")
    cfg = dataclasses.replace(jvit.ViTConfig.tiny(), flash=flash)
    tiles = np.random.RandomState(2).randn(3, 32, 32, 3).astype(np.float32)
    params = _noisy(jvit.VisionTower(cfg).init(jax.random.PRNGKey(1),
                                               jnp.asarray(tiles))["params"], 3)
    want = jvit.VisionTower(cfg).apply({"params": params}, jnp.asarray(tiles))
    tower = tvit.VisionTower(_port_vit_cfg(cfg))
    tower.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = tower(torch.from_numpy(tiles), flash=flash)
    assert got.shape == (3, 4, cfg.llm_hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _llm_pair(form: str, seed: int = 0):
    """(jax cfg, jax tree, port LLM) on one tree of the given weight form."""
    jcfg = jllm.LLMConfig(**INT4_LLM)
    L = 8
    params = jllm.LLM(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, L, jcfg.hidden_size)),
                                 jnp.zeros((1, L), jnp.int32), jnp.ones((1, L, L), bool))["params"]
    params = _noisy(params, seed)
    if form == "int8":
        params = jquant.quantize_llm_params(params)
    elif form == "int4":
        params = jquant.quantize_llm_params_int4(params)
    params = _np_tree(params)
    model = tllm.load_llm_state(tllm.LLM(tllm.LLMConfig(**INT4_LLM)), state_dict_from_jax(params))
    return jcfg, params, model


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("form", ["dense", "int8", "int4"])
@pytest.mark.parametrize("flash", [False, True])
def test_llm_prefill_matches_jax(monkeypatch, form, flash):
    """One-shot prefill of a padded prompt (length < L), W8A8 on, head on
    the last real row; logits and the returned K/V."""
    monkeypatch.setenv("VGQA_PALLAS_INTERPRET", "1")
    jcfg, params, model = _llm_pair(form)
    L, length = 24, 19
    x = np.random.RandomState(4).randn(1, L, jcfg.hidden_size).astype(np.float32)
    idx = np.arange(L)
    mask = (idx[None, :, None] >= idx[None, None, :]) & (idx[None, None, :] < length)
    rows = np.array([length - 1])
    want, wcache = jlf.llm_forward(
        params, jcfg, jnp.asarray(x), jnp.asarray(idx[None]), jnp.asarray(mask),
        lm_head_rows=jnp.asarray(rows),
        flash_prefill={"q_offset": 0, "length": jnp.asarray(length), "interpret": True}
        if flash else None, w8a8=True)
    with torch.no_grad():
        got, gcache = model(_t(x), _t(idx[None]), _t(mask), lm_head_rows=_t(rows),
                            flash_prefill={"q_offset": 0, "length": torch.tensor(length)}
                            if flash else None, w8a8=True, kernels=flash)
    assert got.shape == (1, 1, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for (gk, gv), (wk, wv) in zip(gcache, wcache):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)


@pytest.mark.parametrize("form", ["dense", "int8", "int4"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_llm_decode_matches_jax(monkeypatch, form, kv):
    """Batched decode step: two rows at their own positions ([B]
    cache_index) against a filled cache; int4 products ride K6's route."""
    monkeypatch.setenv("VGQA_PALLAS_INTERPRET", "1")
    jcfg, params, model = _llm_pair(form, seed=5)
    rng = np.random.RandomState(6)
    B, S = 2, 40
    shape = (B, jcfg.num_kv_heads, S, jcfg.head_dim)
    jcache = [(jnp.asarray(rng.randn(*shape).astype(np.float32)),
               jnp.asarray(rng.randn(*shape).astype(np.float32)))
              for _ in range(jcfg.num_layers)]
    if kv == "int8":
        jcache = jllm.quantize_kv_cache(jcache)
    tcache = jax.tree.map(_t, jcache, is_leaf=lambda a: hasattr(a, "shape"))
    tcache = [dict(c) if isinstance(c, dict) else tuple(c) for c in tcache]
    pos = np.array([17, 33])
    x = rng.randn(B, 1, jcfg.hidden_size).astype(np.float32)
    mask = np.arange(S)[None, None, :] <= pos[:, None, None]
    want, wcache = jlf.llm_forward(params, jcfg, jnp.asarray(x), jnp.asarray(pos[:, None]),
                                   jnp.asarray(mask), cache=jcache,
                                   cache_index=jnp.asarray(pos))
    with torch.no_grad():
        got, gcache = model(_t(x), _t(pos[:, None]), _t(mask), cache=tcache,
                            cache_index=_t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for g, w in zip(gcache, wcache):
        pairs = [(g[n], w[n]) for n in ("kq", "ks", "vq", "vs")] if kv == "int8" else zip(g, w)
        for a, b in pairs:
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                       atol=1.0 if a.dtype == torch.int8 else 2e-4, rtol=1e-3)


def test_int8_matmuls_match_jax():
    rng = np.random.RandomState(7)
    w = rng.randn(96, 40).astype(np.float32)
    x = rng.randn(3, 5, 96).astype(np.float32)
    jq = jquant.quantize_llm_params({"q_proj": {"kernel": jnp.asarray(w)}})["q_proj"]
    tq = tquant.quantize_kernel(_t(w))
    np.testing.assert_array_equal(tq["kernel_q"].numpy(), np.asarray(jq["kernel_q"]))
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    np.testing.assert_allclose(tquant.quant_matmul(_t(x), tq).numpy(),
                               np.asarray(jquant.quant_matmul(jnp.asarray(x), jq)), **TOL)
    np.testing.assert_allclose(tquant.quant_matmul_w8a8(_t(x), tq).numpy(),
                               np.asarray(jquant.quant_matmul_w8a8(jnp.asarray(x), jq)),
                               atol=1e-5, rtol=1e-6)


def test_kv_quantizer_matches_jax():
    t = np.random.RandomState(8).randn(2, 3, 7, 16).astype(np.float32)
    t[0, 0, 0] = 0.0                      # an unwritten row: floor scale
    jq, js = jllm.quantize_kv(jnp.asarray(t))
    tq, ts = tllm.quantize_kv(_t(t))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(tllm.dequantize_kv(tq, ts, torch.float32).numpy(),
                               np.asarray(jllm.dequantize_kv(jq, js, jnp.float32)), rtol=1e-6)


def test_quantize_llm_int4_in_place_equals_jax_tree():
    """The port's in-place module swap gives the JAX tree's packed weights
    and an int8 head."""
    jcfg, params, model = _llm_pair("dense", seed=9)
    tquant.quantize_llm_params_int4(model)
    assert tquant.is_quantized(model)
    assert tquant.linear_forms(model) == {"Int4Linear": 14, "Int8Linear": 1}
    want = jquant.quantize_llm_params_int4(params)
    sd = model.state_dict()
    for name in ("layer_1.down_proj.kernel_q4", "layer_0.k_proj.scale4", "lm_head.kernel_q"):
        *path, leaf = name.split(".")
        node = want
        for p in path:
            node = node[p]
        np.testing.assert_array_equal(sd[name].numpy(), np.asarray(node[leaf]))


def test_state_dict_from_jax_keeps_quantized_leaves():
    tree = {"q_proj": {"kernel_q4": np.zeros((4, 3), np.int8),
                       "scale4": np.ones((1, 3), np.float32)},
            "lm_head": {"kernel_q": np.zeros((4, 3), np.int8), "scale": np.ones(3, np.float32)},
            "norm": {"scale": np.ones(4, np.float64)},
            "block": {"ls1": np.ones(4, np.float32)}}
    sd = state_dict_from_jax(tree)
    assert sd["q_proj.kernel_q4"].dtype == torch.int8 and sd["q_proj.kernel_q4"].shape == (4, 3)
    assert sd["lm_head.scale"].dtype == torch.float32 and "lm_head.weight" not in sd
    assert sd["norm.weight"].dtype == torch.float32 and "block.ls1" in sd
    with pytest.raises(KeyError):
        state_dict_from_jax({"q_proj": {"kernel_q": np.zeros((2, 2), np.int8), "zz": 1.0}})
    with pytest.raises(TypeError):
        state_dict_from_jax({"q_proj": {"kernel_q": np.zeros((2, 2), np.float32)}})

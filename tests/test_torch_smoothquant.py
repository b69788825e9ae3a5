"""The SmoothQuant fold of the port (``qa/quant.py``) against
``vgqa_tpu.qa.quant`` on the tiny LLM, float32, one numpy tree for both:

* ``collect_smooth_stats`` (the LLM forward's ``collect_act_stats``) and
  ``smooth_llm_params``: within 1e-5 of max |JAX| per tensor;
* the smoothed float model's logits equal the unsmoothed ones within 1e-4
  of their max (the fold is exact in real arithmetic);
* ``quantize_llm_tree`` (int8, int4) bit-equal to the JAX tree quantizers;
* the ``qa --quantize`` path of ``tools/convert_weights`` against the JAX
  tool's library calls on the same tiny tree: equal scales within 1e-5 and
  int values that differ by at most one level, in at most 0.1% of
  elements (rounding ties of the smoothed kernels).
"""

import jax
import numpy as np
import pytest
import torch

from vgqa_tpu.qa import quant as jquant
from vgqa_tpu.qa.llm import LLMConfig as JLLMConfig
from vgqa_tpu.qa.vit import ViTConfig as JViTConfig
from vgqa_tpu_torch.models.convert_jax import state_dict_from_jax
from vgqa_tpu_torch.qa import quant as tquant
from vgqa_tpu_torch.qa.llm import LLM, LLMConfig, load_llm_state

REL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def setup():
    """(numpy tree {llm, embed, vision}, calibration ids, JAX stats)."""
    from test_torch_qa_serving import _hf_state_dict

    from vgqa_tpu.qa.convert import convert_internvideo
    from vgqa_tpu_torch.qa.vit import ViTConfig

    sd = {k: v.numpy() for k, v in _hf_state_dict(LLMConfig.tiny(), ViTConfig.tiny(), 3).items()}
    tree = convert_internvideo(sd, JLLMConfig.tiny(), JViTConfig.tiny())
    ids = np.random.RandomState(0).randint(0, 256, (2, 24))
    calib = dict(tree["llm"], tok_embeddings=tree["embed"]["tok_embeddings"])
    stats = jax.tree.map(np.asarray, jquant.collect_smooth_stats(calib, JLLMConfig.tiny(), ids))
    return tree, ids, stats


def test_collect_smooth_stats_matches_jax(setup):
    tree, ids, stats = setup
    calib = dict(tree["llm"], tok_embeddings=tree["embed"]["tok_embeddings"])
    got = tquant.collect_smooth_stats(calib, LLMConfig.tiny(), ids, device="cpu")
    assert got.keys() == stats.keys()
    for layer in stats:
        assert got[layer].keys() == stats[layer].keys() == {"qkv_in", "o_in", "mlp_in",
                                                           "down_in"}
        for k, v in stats[layer].items():
            assert got[layer][k].dtype == torch.float32 and got[layer][k].shape == v.shape
            assert _rel(got[layer][k], v) < REL, (layer, k)


def test_smooth_scales_match_jax():
    rng = np.random.RandomState(1)
    a, w = np.abs(rng.randn(64)) * 10, np.abs(rng.randn(64))
    a[:4] = [0.0, 1e-9, 1e6, 3.0]
    for alpha in (0.5, 0.8):
        assert _rel(tquant._smooth_scales(a, w, alpha), jquant._smooth_scales(a, w, alpha)) < REL


def test_smooth_llm_params_matches_jax(setup):
    tree, _, stats = setup
    want = jax.tree.map(np.asarray, jquant.smooth_llm_params(tree["llm"], JLLMConfig.tiny(),
                                                             stats))
    before = np.array(tree["llm"]["layer_0"]["q_proj"]["kernel"])
    got = tquant.smooth_llm_params(tree["llm"], LLMConfig.tiny(), stats)
    sd_t, sd_j = state_dict_from_jax(got), state_dict_from_jax(want)
    assert sd_t.keys() == sd_j.keys()
    for k in sd_j:
        assert _rel(sd_t[k], sd_j[k]) < REL, k
    # the input tree is left as it was
    assert np.array_equal(np.asarray(tree["llm"]["layer_0"]["q_proj"]["kernel"]), before)


def _logits(llm_tree, embed_table, ids):
    cfg = LLMConfig.tiny()
    llm = LLM(cfg)
    load_llm_state(llm, state_dict_from_jax(llm_tree))
    L = ids.shape[1]
    embeds = torch.from_numpy(np.asarray(embed_table)[ids])
    mask = torch.ones((L, L), dtype=torch.bool).tril()[None].expand(ids.shape[0], L, L)
    with torch.no_grad():
        return llm(embeds, torch.arange(L)[None].expand(ids.shape[0], L), mask)[0]


def test_smoothed_logits_equal_unsmoothed(setup):
    tree, _, stats = setup
    ids = np.random.RandomState(7).randint(0, 256, (2, 16))
    table = tree["embed"]["tok_embeddings"]["embedding"]
    smoothed = tquant.smooth_llm_params(tree["llm"], LLMConfig.tiny(), stats)
    ref = _logits(tree["llm"], table, ids)
    assert _rel(_logits(smoothed, table, ids), ref) < 1e-4


@pytest.mark.parametrize("int4", [False, True])
def test_quantize_llm_tree_matches_jax(setup, int4):
    tree, _, _ = setup
    # one layer's seven projections, the head and a norm (eager JAX: under
    # jit, XLA may divide by 127 as a multiply and move a scale by an ulp)
    llm = {k: tree["llm"][k] for k in ("layer_0", "lm_head", "final_norm")}
    if int4:       # tiny widths: groups of 32 split the 64-wide inputs in halves
        want = jquant.quantize_llm_params_int4(llm, group_size=32)
        got = tquant.quantize_llm_tree(llm, int4=True, group_size=32)
    else:
        want = jquant.quantize_llm_params(llm)
        got = tquant.quantize_llm_tree(llm)
    sd_t, sd_j = state_dict_from_jax(got), state_dict_from_jax(jax.tree.map(np.asarray, want))
    assert sd_t.keys() == sd_j.keys()
    assert any(k.endswith("kernel_q4" if int4 else "kernel_q") for k in sd_t)
    for k in sd_j:
        assert sd_t[k].dtype == sd_j[k].dtype and torch.equal(sd_t[k], sd_j[k]), k


@pytest.mark.parametrize("wq", ["int8", "int4"])
def test_convert_weights_qa_quantize_matches_jax_tool(setup, monkeypatch, wq):
    """The port tool's ``qa --quantize --wq WQ`` pipeline (convert, smooth on
    the CPU, quantize) against the JAX tool's library calls, on the tiny
    geometry patched into both packages' 7B constructors."""
    from test_torch_qa_serving import _hf_state_dict

    from vgqa_tpu.qa.convert import convert_internvideo as jconvert
    from vgqa_tpu_torch.qa.vit import ViTConfig
    from vgqa_tpu_torch.tools import convert_weights as tool

    for cls in (JLLMConfig, LLMConfig):
        monkeypatch.setattr(cls, "internlm2_5_7b", classmethod(lambda c: c.tiny()))
    for cls in (JViTConfig, ViTConfig):
        monkeypatch.setattr(cls, "internvit_300m", classmethod(lambda c: c.tiny()))
    sd = {k: v.numpy() for k, v in _hf_state_dict(LLMConfig.tiny(), ViTConfig.tiny(), 2).items()}
    ids = np.random.RandomState(0).randint(0, 256, (1, 32))

    got = tool.convert_qa(sd, quantize=True, wq=wq, calib_ids=ids, device="cpu",
                          log=lambda *_: None)
    jl = JLLMConfig.internlm2_5_7b()
    want = jconvert(sd, jl, JViTConfig.internvit_300m())
    calib = dict(want["llm"], tok_embeddings=want["embed"]["tok_embeddings"])
    want["llm"] = jquant.smooth_llm_params(want["llm"], jl,
                                           jquant.collect_smooth_stats(calib, jl, ids))
    want["llm"] = jax.jit(jquant.quantize_llm_params_int4 if wq == "int4"
                          else jquant.quantize_llm_params)(want["llm"])
    sd_t = state_dict_from_jax(got["llm"])
    sd_j = state_dict_from_jax(jax.tree.map(np.asarray, want["llm"]))
    assert sd_t.keys() == sd_j.keys()
    n_int = n_off = 0
    for k in sd_j:
        assert sd_t[k].dtype == sd_j[k].dtype, k
        if sd_j[k].dtype == torch.int8:
            t, j = sd_t[k], sd_j[k]
            if k.endswith("kernel_q4"):          # unpack both nibbles
                from vgqa_tpu_torch.ops.kernels.int4_matmul import unpack_int4

                t, j = torch.cat(unpack_int4(t)), torch.cat(unpack_int4(j))
            d = (t.int() - j.int()).abs()
            assert int(d.max()) <= 1, k
            n_int, n_off = n_int + d.numel(), n_off + int((d > 0).sum())
        else:
            assert _rel(sd_t[k], sd_j[k]) < REL, k
    assert n_off <= 1e-3 * n_int, (n_off, n_int)
    for part in ("embed", "vision"):
        for k, v in state_dict_from_jax(want[part]).items():
            assert torch.equal(state_dict_from_jax(got[part])[k], v), k

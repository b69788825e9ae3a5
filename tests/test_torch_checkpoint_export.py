"""JAX checkpoints reach the port: ``tools/export_torch_checkpoint.py``.

* Grounding: the JAX ``CheckpointManager`` saves a params-only twin and a
  full TrainState of the tiny float32 config; the exporter writes a state
  dict, and the port's ``load_model(ckpt_path=..., device="cpu")`` gives the
  JAX forward's outputs (atol 1e-3, the slice parity tolerance of
  ``test_torch_slice.py``: float32 summation order over ~40 layers).
* QA: a tiny ``{llm, embed, vision}`` tree, float and int4, saved as JAX's
  ``params/``; the exported file loads through the port's QA loader (its
  bf16 engine holds the JAX tree cast as the JAX loader casts it) and, into
  a float32 engine, gives the JAX engine's greedy tokens.
* A missing source raises ``FileNotFoundError``; an orbax directory handed
  to the port raises the error that names the exporter.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_modules import random_params
from vgqa_tpu.config import build_default_cfg as jax_default_cfg
from vgqa_tpu.models import GroundingConfig as JConfig
from vgqa_tpu.models import VSTGNet as JNet
from vgqa_tpu.qa import engine as jeng_mod
from vgqa_tpu.qa import quant as jquant
from vgqa_tpu.qa.llm import LLMConfig as JLLMConfig
from vgqa_tpu.qa.vit import ViTConfig as JViTConfig
from vgqa_tpu.training.checkpoint import CheckpointManager
from vgqa_tpu.training.train_step import create_train_state
from vgqa_tpu.utils.containers import TextBatch as JText
from vgqa_tpu.utils.containers import VideoBatch as JVideo
from vgqa_tpu_torch.config import build_default_cfg
from vgqa_tpu_torch.inference import grounding
from vgqa_tpu_torch.inference import qa as tqa
from vgqa_tpu_torch.qa import engine as teng_mod
from vgqa_tpu_torch.qa.llm import LLMConfig
from vgqa_tpu_torch.qa.vit import ViTConfig
from vgqa_tpu_torch.utils.containers import TextBatch, VideoBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-3


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint", os.path.join(REPO, "tools", "export_torch_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(cfg):
    rng = np.random.RandomState(4)
    res, T, L = cfg.INPUT.RESOLUTION, cfg.INPUT.TRAIN_SAMPLE_NUM, cfg.INPUT.MAX_QUERY_LEN
    frames = rng.randn(1, T, res, res, 3).astype(np.float32)
    ids = rng.randint(4, 100, (1, L)).astype(np.int32)
    return frames, np.ones((1, res, res), bool), np.ones((1, T), bool), ids, np.ones((1, L), bool)


@pytest.fixture(scope="module")
def grounding_ckpts(tmp_path_factory):
    """(cfg path, params, twin dir, TrainState dir) of the tiny float32 config."""
    root = tmp_path_factory.mktemp("ground")
    jcfg = jax_default_cfg()
    jcfg.merge_from_file(os.path.join(REPO, "configs", "grounding_vidstg_tiny.yaml"))
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    cfg_path = str(root / "tiny_f32.yaml")
    with open(cfg_path, "w") as f:
        f.write(jcfg.dump())
    frames, pm, tm, ids, tmask = _inputs(jcfg)
    params = random_params(JNet(JConfig.from_cfg(jcfg)),
                           JVideo(jnp.asarray(frames), jnp.asarray(pm), jnp.asarray(tm)),
                           JText(jnp.asarray(ids), jnp.asarray(tmask)), seed=11)
    mgr = CheckpointManager(str(root / "out"))
    state = create_train_state(jax.tree.map(jnp.asarray, params), optax.sgd(0.1), use_ema=True)
    state = dataclasses.replace(state, ema_params=jax.tree.map(lambda x: x * 0.5,
                                                               state.ema_params))
    full = mgr.save("model_000002", state)
    twin = mgr.save("model_000002_params", params, tag=False)
    return cfg_path, jcfg, params, twin, full


@pytest.mark.parametrize("which", ["params_twin", "train_state", "train_state_ema"])
def test_grounding_export_serves_the_jax_outputs(grounding_ckpts, tmp_path, which):
    cfg_path, jcfg, params, twin, full = grounding_ckpts
    dst = str(tmp_path / "vidstg.pt")
    ema = which == "train_state_ema"
    _exporter().main(["grounding", twin if which == "params_twin" else full, dst,
                      "--config", cfg_path] + (["--ema"] if ema else []))
    want_params = jax.tree.map(lambda x: x * 0.5, params) if ema else params

    cfg = build_default_cfg()
    cfg.merge_from_file(cfg_path)
    loaded = grounding.load_model(cfg, ckpt_path=dst, device="cpu")
    frames, pm, tm, ids, tmask = _inputs(jcfg)
    jnet = JNet(JConfig.from_cfg(jcfg))
    out_j = jax.jit(lambda p: jnet.apply(p, JVideo(jnp.asarray(frames), jnp.asarray(pm),
                                                   jnp.asarray(tm)),
                                         JText(jnp.asarray(ids), jnp.asarray(tmask))))(
        jax.tree.map(jnp.asarray, want_params))
    with torch.no_grad():
        out_t = loaded.model(VideoBatch(torch.from_numpy(frames), torch.from_numpy(pm),
                                        torch.from_numpy(tm)),
                             TextBatch(torch.from_numpy(ids).long(), torch.from_numpy(tmask)))
    for k in ("pred_boxes", "pred_sted", "att_sequences"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), atol=ATOL)


def test_grounding_export_errors(grounding_ckpts, tmp_path):
    cfg_path, _, _, twin, _ = grounding_ckpts
    with pytest.raises(FileNotFoundError):
        _exporter().main(["grounding", str(tmp_path / "missing"), str(tmp_path / "x.pt")])
    cfg = build_default_cfg()
    cfg.merge_from_file(cfg_path)
    with pytest.raises(ValueError, match="export_torch_checkpoint.py grounding"):
        grounding.load_model(cfg, ckpt_path=twin, device="cpu")


INT4_LLM = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                intermediate_size=512, max_seq_len=512, rope_theta=10000.0)


class IdTokenizer(jeng_mod.ByteTokenizer):
    def decode(self, ids):
        return ",".join(str(int(i)) for i in ids)


@pytest.mark.parametrize("kind", ["float", "bf16", "int4"])
def test_qa_export_loads_and_chats_like_jax(tmp_path, kind):
    lk, vk = (INT4_LLM, dict(llm_hidden_size=256)) if kind == "int4" else ({}, {})
    jl = JLLMConfig(**lk) if lk else JLLMConfig.tiny()
    jv = JViTConfig(**{**JViTConfig.tiny().__dict__, **vk})
    tok = IdTokenizer()
    jeng = jeng_mod.QAEngine.init_random(jl, jv, rng=jax.random.PRNGKey(5), tokenizer=tok,
                                         max_seq_len=256)
    tree = jax.tree.map(np.array, jeng.params)
    if kind == "int4":
        tree["llm"] = jax.tree.map(np.array, jquant.quantize_llm_params_int4(tree["llm"]))
    if kind == "bf16":
        tree = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.dtype == np.float32 else x,
                            tree)
    model_dir = tmp_path / "qa"
    CheckpointManager(str(model_dir)).save("params", tree, tag=False)
    (model_dir / "vgqa_tpu_config.json").write_text(json.dumps(
        {"llm": dataclasses.asdict(jl), "vit": dataclasses.asdict(jv)}))

    with pytest.raises(RuntimeError, match="export_torch_checkpoint.py qa"):
        tqa._load_cached.cache_clear()
        tqa._load_engine(str(model_dir), device="cpu")
    _exporter().main(["qa", str(model_dir)])
    exported = tqa.load_exported_tree(str(model_dir / tqa.EXPORTED_TREE))
    # torch leaves as stored: a bf16 tree is not widened on the host
    floats = {v.dtype for v in jax.tree.leaves(exported) if v.is_floating_point()}
    assert floats == ({torch.bfloat16} if kind == "bf16" else {torch.float32})

    # the port's QA loader: a bf16 engine holding the tree as the JAX loader
    # casts it (floats to bf16, quantized leaves and their scales as stored)
    tqa._load_cached.cache_clear()
    eng = tqa._load_engine(str(model_dir), device="cpu")
    assert eng.dtype == torch.bfloat16
    ref = teng_mod.QAEngine.init_random(
        LLMConfig(**lk) if lk else LLMConfig.tiny(),
        ViTConfig(**{**ViTConfig.tiny().__dict__, **vk}), device="cpu",
        dtype=torch.bfloat16).load_tree(tree)
    for a, b in ((eng.llm, ref.llm), (eng.embed, ref.embed), (eng.vision, ref.vision)):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    tqa._load_cached.cache_clear()

    # a float32 engine from the exported file: the JAX engine's greedy tokens
    # (a bf16 tree widened exactly for both)
    jeng.params = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float32 if x.dtype == jnp.bfloat16 else x.dtype), tree)
    teng = teng_mod.QAEngine.init_random(
        LLMConfig(**lk) if lk else LLMConfig.tiny(),
        ViTConfig(**{**ViTConfig.tiny().__dict__, **vk}), device="cpu", tokenizer=tok,
        max_seq_len=256, use_kernels=False).load_tree(exported)
    tiles = np.random.RandomState(0).randint(0, 256, (2, 32, 32, 3), np.uint8)
    g = dict(max_new_tokens=8, do_sample=False, ignore_eos=True)
    want = jeng.chat(tiles, "what is the man doing?", jeng_mod.GenerationConfig(**g))
    got = teng.chat(tiles, "what is the man doing?", teng_mod.GenerationConfig(**g))
    assert got == want and len(got.split(",")) == 8


def test_qa_export_missing_params(tmp_path):
    with pytest.raises(FileNotFoundError):
        _exporter().main(["qa", str(tmp_path)])

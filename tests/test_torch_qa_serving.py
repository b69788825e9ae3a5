"""The port's QA serving entry points: ``predict`` / ``predict_many`` on the
tiny random model (``device="cpu"``), per-slot failure isolation, the card
default, loading raw HF weights through the numpy converter (equal to the
JAX package's), and a chat with the JAX stack, PyYAML, OpenCV and
``vgqa_tpu`` import-blocked, as on the card machine."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    from vgqa_tpu.data.synthetic import write_synthetic_video

    path = str(tmp_path_factory.mktemp("qa") / "v.mp4")
    write_synthetic_video(path, 24, (64, 48), seed=3)
    return path


def test_predict_and_predict_many_on_tiny(video):
    from vgqa_tpu_torch.inference import qa

    out = qa.predict(video, "what moves?", model_dir="__tiny__", num_frames=4,
                     max_new_tokens=6, temperature=0, device="cpu")
    assert set(out) == {"answer"} and isinstance(out["answer"], str)
    again = qa.predict(video, "what moves?", model_dir="__tiny__", num_frames=4,
                       max_new_tokens=6, temperature=0, device="cpu")
    assert again == out
    many = qa.predict_many([
        {"video_path": video, "question": "what moves?", "num_frames": 4,
         "max_new_tokens": 6, "temperature": 0},
        {"video_path": "/nonexistent.mp4", "question": "x"},
        {"video_path": video, "question": "and now?", "num_frames": 2, "max_new_tokens": 3,
         "temperature": 0.7},
        {"video_path": video, "question": "too long", "num_frames": 64},
    ], model_dir="__tiny__", device="cpu")
    assert many[0] == out
    assert isinstance(many[1], FileNotFoundError)
    assert isinstance(many[2]["answer"], str)
    assert isinstance(many[3], ValueError)


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch, video):
    from vgqa_tpu_torch.inference import qa
    from vgqa_tpu_torch.qa import LLMConfig, QAEngine, ViTConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        QAEngine.init_random(LLMConfig.tiny(), ViTConfig.tiny())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        qa._load_engine("__tiny__")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        qa.predict(video, "q", model_dir="__tiny__")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        qa.predict_many([{"video_path": video, "question": "q"}], model_dir="__tiny__")
    assert QAEngine.init_random(LLMConfig.tiny(), ViTConfig.tiny(),
                                device="cpu").device.type == "cpu"


def _hf_state_dict(llm, vit, seed=0):
    """A random InternVL-layout checkpoint (fused wqkv InternLM2 naming)."""
    rng = np.random.RandomState(seed)

    def r(*s):
        return torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1)

    D, hd = llm.hidden_size, llm.head_dim
    sd = {"language_model.model.tok_embeddings.weight": r(llm.vocab_size, D),
          "language_model.model.norm.weight": 1 + r(D),
          "language_model.output.weight": r(llm.vocab_size, D)}
    for i in range(llm.num_layers):
        p = f"language_model.model.layers.{i}"
        sd[f"{p}.attention.wqkv.weight"] = r((llm.num_heads + 2 * llm.num_kv_heads) * hd, D)
        sd[f"{p}.attention.wo.weight"] = r(D, D)
        sd[f"{p}.feed_forward.w1.weight"] = r(llm.intermediate_size, D)
        sd[f"{p}.feed_forward.w3.weight"] = r(llm.intermediate_size, D)
        sd[f"{p}.feed_forward.w2.weight"] = r(D, llm.intermediate_size)
        sd[f"{p}.attention_norm.weight"] = 1 + r(D)
        sd[f"{p}.ffn_norm.weight"] = 1 + r(D)
    C, g = vit.hidden_size, vit.grid
    v = "vision_model."
    sd.update({v + "embeddings.class_embedding": r(1, 1, C),
               v + "embeddings.position_embedding": r(1, g * g + 1, C),
               v + "embeddings.patch_embedding.weight": r(C, 3, vit.patch_size, vit.patch_size),
               v + "embeddings.patch_embedding.bias": r(C)})
    for i in range(vit.num_layers):
        p = f"{v}encoder.layers.{i}"
        for name, (o, n) in {"attn.qkv": (3 * C, C), "attn.proj": (C, C),
                             "mlp.fc1": (vit.intermediate_size, C),
                             "mlp.fc2": (C, vit.intermediate_size)}.items():
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = r(o, n), r(o)
        for name in ("norm1", "norm2"):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = 1 + r(C), r(C)
        sd[f"{p}.ls1"], sd[f"{p}.ls2"] = 1 + r(C), 1 + r(C)
    mixed = 4 * C
    sd.update({"mlp1.0.weight": 1 + r(mixed), "mlp1.0.bias": r(mixed),
               "mlp1.1.weight": r(vit.llm_hidden_size, mixed), "mlp1.1.bias": r(vit.llm_hidden_size),
               "mlp1.3.weight": r(vit.llm_hidden_size, vit.llm_hidden_size),
               "mlp1.3.bias": r(vit.llm_hidden_size)})
    return sd


def test_load_engine_reads_raw_hf_weights_like_jax(tmp_path):
    """A model dir of vgqa_tpu_config.json + a .bin state dict loads into the
    port's modules exactly as the JAX converter maps it; an orbax params/
    dir raises with the reason."""
    import dataclasses

    from vgqa_tpu.qa.convert import convert_internvideo
    from vgqa_tpu.qa.llm import LLMConfig as JLLMConfig
    from vgqa_tpu.qa.vit import ViTConfig as JViTConfig
    from vgqa_tpu_torch.inference import qa
    from vgqa_tpu_torch.models.convert_jax import state_dict_from_jax

    llm, vit = JLLMConfig.tiny(), JViTConfig.tiny()
    sd = _hf_state_dict(llm, vit)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    (tmp_path / "vgqa_tpu_config.json").write_text(json.dumps(
        {"llm": dataclasses.asdict(llm), "vit": dataclasses.asdict(vit)}))
    eng = qa._load_engine(str(tmp_path), device="cpu")
    tree = convert_internvideo({k: v.numpy() for k, v in sd.items()}, llm, vit)
    for mod, part in ((eng.llm, "llm"), (eng.embed, "embed"), (eng.vision, "vision")):
        want = state_dict_from_jax(tree[part])
        got = mod.state_dict()
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k].float(), want[k].bfloat16().float(),
                                       atol=0, rtol=0)
    assert eng.dtype == torch.bfloat16
    tiles = np.random.RandomState(0).randint(0, 256, (1, 32, 32, 3), np.uint8)
    from vgqa_tpu_torch.qa.engine import GenerationConfig

    assert isinstance(eng.chat(tiles, "q", GenerationConfig(max_new_tokens=3, do_sample=False)),
                      str)
    (tmp_path / "params").mkdir()
    qa._load_cached.cache_clear()
    with pytest.raises(RuntimeError, match="orbax"):
        qa._load_engine(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        qa._load_engine(str(tmp_path / "missing"), device="cpu")


_NO_JAX = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "yaml", "cv2", "vgqa_tpu"}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is not installed on the card machine")
            return None

    sys.meta_path.insert(0, Refuse())
    import numpy as np
    from vgqa_tpu_torch.qa import LLMConfig, ViTConfig, QAEngine
    from vgqa_tpu_torch.qa.engine import GenerationConfig, YUVTiles
    from vgqa_tpu_torch.qa.quant import quantize_llm_params_int4
    from vgqa_tpu_torch.inference import qa

    eng = QAEngine.init_random(LLMConfig.tiny(), ViTConfig.tiny(), device="cpu", seed=1)
    tiles = np.random.RandomState(0).randint(0, 256, (3, 32, 32, 3), np.uint8)
    g = GenerationConfig(max_new_tokens=5, do_sample=False, ignore_eos=True)
    a, stats = eng.chat(tiles, "what?", g, return_stats=True)
    quantize_llm_params_int4(eng.llm)
    b = eng.chat_batch([(tiles, "what?"), (tiles[:1], "who?")], gen=g)
    planes = np.random.RandomState(1).randint(0, 256, (2, 32 * 32 * 3 // 2), np.uint8)
    c = eng.chat(YUVTiles(planes), "yuv?", g, num_patches_list=[1, 1])
    assert isinstance(qa._load_engine("__tiny__", device="cpu"), QAEngine)
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    print("SERVED", stats["decode_tokens"], len(b), type(c).__name__)
""")


def test_qa_serves_without_jax_yaml_cv2():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED 5 2 str" in proc.stdout

"""Reference weights reach the port without JAX: the numpy converters of
``vgqa_tpu_torch/models/convert*.py`` and ``python -m
vgqa_tpu_torch.tools.convert_weights``.

* Each converter against its ``vgqa_tpu`` original on synthetic state dicts
  shaped like the reference checkpoint's (``vgqa_tpu.models.reference_shapes``,
  the tiny geometry of ``tests/test_convert_grounding.py``): both trees go
  through ``state_dict_from_jax`` and every tensor must be equal.
* ``convert_weights grounding``'s state dict loads strictly into
  ``Trainer._warm_start`` (the whole chain, tool -> ``load_model`` -> the
  served forward against the JAX package's, is in
  ``test_torch_serve_entry.py``); a checkpoint that names a component
  otherwise fails the tool, naming the prefix it looked for.
* ``mdetr`` fills the port model's seeded initialization with exactly the
  leaves the JAX merge loads; the backbone fragments equal the matching
  entries of the full state dict.
* ``qa``: a float tree equal to JAX ``convert_internvideo``'s; a smoothed int4
  tree that ``inference/qa._load_cached`` loads and answers with, on the tiny
  geometry (``internlm2_5_7b`` / ``internvit_300m`` patched to ``tiny`` in
  both packages).
"""

import os
import re

import numpy as np
import pytest
import torch

from vgqa_tpu.models import convert as jconv
from vgqa_tpu.models import convert_grounding as jcg
from vgqa_tpu.models.reference_shapes import build_reference_state_dict
from vgqa_tpu_torch.config import build_default_cfg
from vgqa_tpu_torch.models import convert as tconv
from vgqa_tpu_torch.models import convert_grounding as tcg
from vgqa_tpu_torch.models.convert_jax import state_dict_from_jax
from vgqa_tpu_torch.tools import convert_weights as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "grounding_vidstg_tiny.yaml")
DEPTHS = dict(enc_layers=2, dec_layers=2, resnet_depths=(1, 1, 1, 1), swin_depths=(1, 1, 1, 1),
              roberta_layers=2)


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _mdetr_sd(sd):
    """A reference-named state dict in MDETR/TubeDETR naming (the inverse of
    ``mdetr_to_reference_sd``); the Swin, classifiers and heads have none."""
    out = {}
    for k, v in sd.items():
        for ref, mdetr in (("vis_encoder.0.body.", "backbone.0.body."),
                           ("text_encoder.body.", "transformer.text_encoder."),
                           ("text_encoder.resizer.", "transformer.resizer."),
                           ("input_proj.", "input_proj."),
                           ("ground_encoder.encoder.spatial_layers.",
                            "transformer.encoder.layers."),
                           ("ground_decoder.", "transformer.")):
            if k.startswith(ref):
                out[mdetr + k[len(ref):]] = v
                break
    return out


def _assert_equal_sd(a, b):
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:10]
    for k in a:
        assert a[k].shape == b[k].shape and torch.equal(a[k].contiguous(), b[k].contiguous()), k


@pytest.fixture(scope="module")
def ref_sd():
    return build_reference_state_dict()


@pytest.fixture(scope="module")
def tiny_f32(tmp_path_factory):
    """The tiny config in float32, written by the port's ``dump``."""
    cfg = build_default_cfg()
    cfg.merge_from_file(TINY)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    path = str(tmp_path_factory.mktemp("cfg") / "tiny_f32.yaml")
    with open(path, "w") as f:
        f.write(cfg.dump())
    return path


CONVERTERS = {
    "resnet": lambda m, sd: m.convert_resnet(_sub(sd, "vis_encoder.0.body."), (1, 1, 1, 1)),
    "roberta": lambda m, sd: m.convert_roberta(_sub(sd, "text_encoder.body."), 2),
    "video_swin": lambda m, sd: m.convert_video_swin(_sub(sd, "vid."), (1, 1, 1, 1)),
    "video_swin_no_sum": lambda m, sd: m.convert_video_swin(_sub(sd, "vid."), (1, 1, 1, 1),
                                                            sum_temporal_patch=False),
    "grounding_head": lambda m, sd: m.convert_grounding_head(sd, 2, 2),
    "grounding_reference": lambda m, sd: m.convert_grounding_reference(sd, **DEPTHS),
    "mdetr_warmstart": lambda m, sd: m.convert_mdetr_warmstart(
        _mdetr_sd(sd), enc_layers=2, dec_layers=2, resnet_depths=(1, 1, 1, 1),
        roberta_layers=2)[0],
}


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_converter_matches_jax(ref_sd, name):
    mods = {"t": (tconv, tcg), "j": (jconv, jcg)}
    trees = {}
    for side, (conv, cg) in mods.items():
        fn = CONVERTERS[name]
        owner = conv if name in ("resnet", "roberta", "video_swin", "video_swin_no_sum") else cg
        trees[side] = fn(owner, ref_sd)
    _assert_equal_sd(state_dict_from_jax(trees["t"]), state_dict_from_jax(trees["j"]))


def test_mdetr_key_remap_and_merge_match_jax(ref_sd):
    mdetr = _mdetr_sd(ref_sd)
    assert tcg.mdetr_to_reference_sd(mdetr).keys() == jcg.mdetr_to_reference_sd(mdetr).keys()
    _, loaded_t = tcg.convert_mdetr_warmstart(mdetr, 2, 2, (1, 1, 1, 1), 2)
    _, loaded_j = jcg.convert_mdetr_warmstart(mdetr, 2, 2, (1, 1, 1, 1), 2)
    assert loaded_t == loaded_j
    rng = np.random.RandomState(0)
    base = {"a": {"w": rng.randn(3, 2), "b": rng.randn(2)}, "c": rng.randn(4)}
    part = {"a": {"w": rng.randn(3, 2), "b": rng.randn(5), "x": rng.randn(1)}, "c": rng.randn(4)}
    mt, nt, st = tcg.merge_partial_params(base, part)
    mj, nj, sj = jcg.merge_partial_params(base, part)
    assert (nt, st) == (nj, sj) == (2, ["/a/b", "/a/x"])
    for path in (("a", "w"), ("a", "b")):
        assert np.array_equal(mt[path[0]][path[1]], mj[path[0]][path[1]])


def test_reference_depths_read_the_checkpoint(ref_sd):
    assert tcg.reference_depths(ref_sd) == DEPTHS


@pytest.mark.parametrize("prefix", ["ground_encoder.encoder.spatial_layers.",
                                    "ground_decoder.time_decoder.layers.",
                                    "vis_encoder.0.body.layer3.", "vid.layers.2.blocks.",
                                    "text_encoder.body.encoder.layer."])
def test_reference_depths_refuse_a_missing_component(ref_sd, prefix):
    """A component named otherwise fails the tool, not a later strict load."""
    sd = {("renamed." + k if k.startswith(prefix) else k): v for k, v in ref_sd.items()}
    with pytest.raises(ValueError, match=re.escape(prefix)):
        tcg.reference_depths(sd)
    with pytest.raises(ValueError, match=re.escape(prefix)):
        tool.convert_grounding(sd)


def test_grounding_state_dict_warm_starts_the_trainer(ref_sd, tiny_f32, tmp_path):
    from vgqa_tpu_torch.training.trainer import Trainer

    src, dst = str(tmp_path / "vidstg.pth"), str(tmp_path / "vidstg.pt")
    torch.save({k: torch.from_numpy(v) for k, v in ref_sd.items()}, src)
    tool.main(["grounding", "--src", src, "--dst", dst])
    want = torch.load(dst, weights_only=True)
    cfg = build_default_cfg()
    cfg.merge_from_file(tiny_f32)
    cfg.merge_from_list(["MODEL.WEIGHT", dst, "OUTPUT_DIR", str(tmp_path / "out")])
    trainer = Trainer(cfg, device="cpu")
    trainer.setup(max_iter=1)
    got = trainer.state.model.state_dict()
    for k in want:
        assert torch.equal(got[k].float(), want[k]), k


def test_mdetr_fills_the_seeded_model(ref_sd, tiny_f32, tmp_path):
    from vgqa_tpu_torch.models import GroundingConfig, VSTGNet
    from vgqa_tpu_torch.models.init_weights import init_weights

    src, dst = str(tmp_path / "mdetr.pth"), str(tmp_path / "warm.pt")
    mdetr = _mdetr_sd(ref_sd)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in mdetr.items()}}, src)
    tool.main(["mdetr", "--src", src, "--dst", dst, "--config", tiny_f32])
    got = torch.load(dst, weights_only=True)

    cfg = build_default_cfg()
    cfg.merge_from_file(tiny_f32)
    model = VSTGNet(GroundingConfig.from_cfg(cfg))
    init_weights(model, torch.Generator().manual_seed(0))
    fresh = model.state_dict()
    model.load_state_dict(got, strict=True)
    partial = state_dict_from_jax(jcg.convert_mdetr_warmstart(
        mdetr, 2, 2, (1, 1, 1, 1), 2)[0])
    assert len(partial) > 100
    for k in fresh:
        want = partial[k] if k in partial else fresh[k]
        assert torch.equal(got[k], want.contiguous()), k


@pytest.mark.parametrize("kind", ["resnet", "roberta", "video_swin"])
def test_backbone_fragments(ref_sd, tmp_path, monkeypatch, kind):
    prefix = {"resnet": "vis_encoder.0.body.", "roberta": "text_encoder.body.",
              "video_swin": "backbone."}[kind]
    src_sd = (_sub(ref_sd, "vid.") if kind == "video_swin" else _sub(ref_sd, prefix))
    if kind == "video_swin":            # a K400 release keeps its Swin under backbone.
        src_sd = {"backbone." + k: v for k, v in src_sd.items()}
    src, dst = str(tmp_path / "src.pth"), str(tmp_path / "frag.pt")
    torch.save({k: torch.from_numpy(v) for k, v in src_sd.items()}, src)
    depths = {"resnet": ("convert_resnet", (1, 1, 1, 1)), "roberta": ("convert_roberta", 2),
              "video_swin": ("convert_video_swin", (1, 1, 1, 1))}[kind]
    real = getattr(tool, depths[0])
    monkeypatch.setattr(tool, depths[0], lambda sd, *a: real(sd, depths[1]))
    tool.main([kind, "--src", src, "--dst", dst])
    frag = torch.load(dst, weights_only=True)
    full = state_dict_from_jax(jcg.convert_grounding_reference(ref_sd, **DEPTHS))
    assert frag and all(k.startswith(tool.FRAGMENT_PREFIX[kind]) for k in frag)
    for k, v in frag.items():
        assert torch.equal(v, full[k].contiguous()), k
    assert set(frag) == {k for k in full if k.startswith(tool.FRAGMENT_PREFIX[kind])}


def _internvideo_sd(llm, vit, seed=0):
    from test_torch_qa_serving import _hf_state_dict

    return {k: v.numpy() for k, v in _hf_state_dict(llm, vit, seed).items()}


@pytest.fixture
def tiny_geometry(monkeypatch):
    """``internlm2_5_7b`` / ``internvit_300m`` -> ``tiny`` in both packages."""
    from vgqa_tpu.qa.llm import LLMConfig as JL
    from vgqa_tpu.qa.vit import ViTConfig as JV
    from vgqa_tpu_torch.qa.llm import LLMConfig
    from vgqa_tpu_torch.qa.vit import ViTConfig

    for cls in (JL, LLMConfig):
        monkeypatch.setattr(cls, "internlm2_5_7b", classmethod(lambda c: c.tiny()))
    for cls in (JV, ViTConfig):
        monkeypatch.setattr(cls, "internvit_300m", classmethod(lambda c: c.tiny()))
    return LLMConfig.tiny(), ViTConfig.tiny()


def test_qa_float_tree_matches_jax(tiny_geometry, tmp_path):
    from vgqa_tpu.qa.convert import convert_internvideo as jconvert

    llm, vit = tiny_geometry
    sd = _internvideo_sd(llm, vit)
    src = tmp_path / "hf"
    src.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(src / "model.bin"))
    tool.main(["qa", "--src", str(src), "--dst", str(tmp_path / "qa")])
    got = torch.load(str(tmp_path / "qa" / tool.QA_EXPORT_NAME), weights_only=True)
    want = jconvert(sd, llm, vit)
    for part in ("llm", "embed", "vision"):
        _assert_equal_sd(state_dict_from_jax(got[part]), state_dict_from_jax(want[part]))


def test_qa_int4_smoothed_tree_serves(tiny_geometry, tmp_path):
    """``qa --quantize --wq int4`` (SmoothQuant on the CPU): int4 projections
    and an int8 head, loaded by the port's QA loader, which then answers."""
    from vgqa_tpu_torch.inference import qa
    from vgqa_tpu_torch.qa.quant import linear_forms

    llm, vit = tiny_geometry
    src = str(tmp_path / "model.pth")
    torch.save({k: torch.from_numpy(v) for k, v in _internvideo_sd(llm, vit, 1).items()}, src)
    dst = tmp_path / "qa"
    tool.main(["qa", "--src", src, "--dst", str(dst), "--quantize", "--wq", "int4",
               "--device", "cpu"])
    tree = torch.load(str(dst / tool.QA_EXPORT_NAME), weights_only=True)
    assert tree["llm"]["layer_0"]["q_proj"]["kernel_q4"].dtype == torch.int8
    assert tree["llm"]["lm_head"]["kernel_q"].dtype == torch.int8
    qa._load_cached.cache_clear()
    try:
        eng = qa._load_engine(str(dst), device="cpu")
        assert linear_forms(eng.llm) == {"Int4Linear": 7 * llm.num_layers, "Int8Linear": 1}
        tiles = np.random.RandomState(0).randint(0, 256, (2, vit.image_size, vit.image_size, 3),
                                                 np.uint8)
        from vgqa_tpu_torch.qa.engine import GenerationConfig

        answer = eng.chat(tiles, "what moves?", GenerationConfig(max_new_tokens=4,
                                                                 do_sample=False))
        assert isinstance(answer, str)
    finally:
        qa._load_cached.cache_clear()

"""Convert pretrained torch checkpoints into the files the port loads
(counterpart of ``tools/convert_weights.py``, which writes orbax trees for
the JAX package; this one needs no JAX).

    python -m vgqa_tpu_torch.tools.convert_weights SUBCOMMAND --src SRC --dst DST [...]

Subcommands:
  grounding   a reference VSTGNet checkpoint (e.g. the TA-STVG ``vidstg.pth``
              release) -> the port's full state dict (``torch.save``), which
              ``inference/grounding.load_model(cfg, ckpt_path=DST)`` and the
              trainer's ``MODEL.WEIGHT`` read. Layer counts come from the
              checkpoint's keys; ``--config`` also checks it against the
              port's model of that config.
  mdetr       an MDETR/TubeDETR-format checkpoint -> the full state dict of
              the port's model of ``--config``: the warm-startable parts
              (backbone, text tower, input_proj, encoder layers, TubeDETR
              decoders) remapped, the rest the model's seeded initialization
              (seed 0), which the trainer warm-starts from strictly.
  resnet      torchvision ResNet-101 (``--resnet50``: ResNet-50) state dict
  roberta     HF RobertaModel state dict
  video_swin  K400 Video Swin checkpoint
              -> each a fragment of the port's state dict under its module
              names in ``VSTGNet`` (``vis_encoder.``, ``text_encoder.body.``,
              ``vid.``), for ``load_state_dict(..., strict=False)``.
  qa          an InternVideo2.5 / InternVL chat checkpoint (a file, or a
              directory of ``*.bin`` / ``*.pth`` shards) -> ``DST/params_torch.pt``,
              the ``{llm, embed, vision}`` tree that ``inference/qa`` loads
              (the layout ``tools/export_torch_checkpoint.py qa`` writes), at
              the InternLM2.5-7B / InternViT-300M geometry. ``--quantize``
              stores the LLM's projections as int8 (``--wq int8``) or int4
              groups of 128 with an int8 head (``--wq int4``), after the
              SmoothQuant fold (``--no-smooth`` skips it; its calibration
              runs the float LLM on ``--device``, the card unless ``cpu``,
              over ``--calib-ids`` or 256 random ids).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..models.convert import convert_resnet, convert_roberta, convert_video_swin
from ..models.convert_grounding import (
    convert_grounding_reference,
    convert_mdetr_warmstart,
    merge_partial_params,
    reference_depths,
)
from ..models.convert_jax import state_dict_from_jax
from ..qa.convert import torch_state_dict_to_numpy

QA_EXPORT_NAME = "params_torch.pt"
# where each backbone fragment sits in VSTGNet
FRAGMENT_PREFIX = {"resnet": "vis_encoder.", "roberta": "text_encoder.body.",
                   "video_swin": "vid."}


def _load_torch_sd(path: str) -> Dict[str, np.ndarray]:
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("state_dict", "model", "model_ema"):
            if key in ckpt and isinstance(ckpt[key], dict):
                ckpt = ckpt[key]
                break
    sd = torch_state_dict_to_numpy(ckpt)
    if sd and all(k.startswith("module.") for k in sd):       # a DDP prefix
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return sd


def _load_sources(src: str) -> Dict[str, np.ndarray]:
    if not os.path.isdir(src):
        return _load_torch_sd(src)
    sd: Dict[str, np.ndarray] = {}
    for f in sorted(os.listdir(src)):
        if f.endswith((".bin", ".pth")):
            sd.update(_load_torch_sd(os.path.join(src, f)))
    return sd


def _model(config: str):
    from ..config import build_default_cfg
    from ..models import GroundingConfig, VSTGNet

    cfg = build_default_cfg()
    cfg.merge_from_file(config)
    gcfg = GroundingConfig.from_cfg(cfg)
    return gcfg, VSTGNet(gcfg)


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def convert_grounding(sd: Dict[str, np.ndarray], config: str = "") -> Dict[str, torch.Tensor]:
    """Reference VSTGNet state dict -> the port's state dict (checked against
    the port's model of ``config`` when given)."""
    tree = convert_grounding_reference(sd, **reference_depths(sd))
    return state_dict_from_jax(tree, _model(config)[1] if config else None)


def convert_mdetr(sd: Dict[str, np.ndarray], config: str, seed: int = 0):
    """MDETR-format state dict -> ``(state dict, components, leaves loaded,
    skipped paths)``: the warm-startable parts over the seeded initialization
    of the port's model of ``config``."""
    from ..models.init_weights import init_weights

    gcfg, model = _model(config)
    init_weights(model, torch.Generator().manual_seed(seed))
    base = model.state_dict()
    resnet_depths = tuple(
        len({k.split(".")[1] for k in base if k.startswith(f"vis_encoder.layer{s + 1}_")})
        for s in range(4))
    partial, loaded = convert_mdetr_warmstart(
        sd, enc_layers=gcfg.enc_layers, dec_layers=gcfg.dec_layers,
        resnet_depths=resnet_depths, roberta_layers=gcfg.text.num_layers)
    merged, n_loaded, skipped = merge_partial_params(_nest(base),
                                                     _nest(state_dict_from_jax(partial)))
    return ({k: v.contiguous() for k, v in _flatten(merged).items()}, loaded, n_loaded,
            skipped)


def convert_fragment(kind: str, sd: Dict[str, np.ndarray],
                     resnet50: bool = False) -> Dict[str, torch.Tensor]:
    """A backbone checkpoint -> its fragment of the port's state dict."""
    if kind == "resnet":
        tree = convert_resnet(sd, (3, 4, 6, 3) if resnet50 else (3, 4, 23, 3))
    elif kind == "roberta":
        tree = convert_roberta(sd)
    else:
        if any(k.startswith("backbone.") for k in sd):
            sd = {k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")}
        tree = convert_video_swin(sd)
    return {FRAGMENT_PREFIX[kind] + k: v for k, v in state_dict_from_jax(tree).items()}


def convert_qa(sd: Dict[str, np.ndarray], quantize: bool = False, wq: str = "int8",
               smooth: bool = True, calib_ids: Optional[np.ndarray] = None,
               device=None, log=print) -> Dict[str, Any]:
    """InternVideo chat state dict -> the ``{llm, embed, vision}`` tree with
    torch leaves (float32, or int8 / int4 projections with f32 scales)."""
    from ..qa.convert import convert_internvideo
    from ..qa.llm import LLMConfig
    from ..qa.quant import collect_smooth_stats, quantize_llm_tree, smooth_llm_params
    from ..qa.vit import ViTConfig

    llm_cfg = LLMConfig.internlm2_5_7b()
    tree = convert_internvideo(sd, llm_cfg, ViTConfig.internvit_300m())
    if quantize:
        if smooth:
            ids = calib_ids if calib_ids is not None else np.random.RandomState(0).randint(
                0, llm_cfg.vocab_size, size=(1, 256))
            calib = dict(tree["llm"], tok_embeddings=tree["embed"]["tok_embeddings"])
            stats = collect_smooth_stats(calib, llm_cfg, ids, device=device)
            tree["llm"] = smooth_llm_params(tree["llm"], llm_cfg, stats)
            log(f"applied SmoothQuant fold (alpha=0.5, {ids.shape[0]}x{ids.shape[1]} "
                "calibration tokens)")
        else:
            log("WARNING: quantizing without the SmoothQuant fold: W8A8 prefill is meant "
                "for smoothed weights")
        tree["llm"] = quantize_llm_tree(tree["llm"], int4=wq == "int4")

    def leaves(node):
        if isinstance(node, dict):
            return {k: leaves(v) for k, v in node.items()}
        t = node if isinstance(node, torch.Tensor) else torch.from_numpy(np.array(node))
        return t.contiguous()

    return leaves(tree)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("grounding", "mdetr", "resnet", "roberta", "video_swin", "qa"):
        p = sub.add_parser(name)
        p.add_argument("--src", required=True, help="torch checkpoint path")
        p.add_argument("--dst", required=True,
                       help="output model dir" if name == "qa" else "output .pt file")
        if name == "qa":
            p.add_argument("--quantize", action="store_true",
                           help="quantize the LLM's projections (int8 per channel by default)")
            p.add_argument("--wq", choices=("int8", "int4"), default="int8",
                           help="with --quantize: int8 per channel, or int4 groups of 128 "
                                "with the lm_head int8")
            p.add_argument("--no-smooth", action="store_true",
                           help="skip the SmoothQuant fold before quantizing")
            p.add_argument("--calib-ids", default="",
                           help="optional .npy of [B, L] int token ids for the smoothing "
                                "calibration (default: 256 random ids over the vocab)")
            p.add_argument("--device", default=None,
                           help="where the calibration forward runs: cuda (default) or cpu")
        if name == "mdetr":
            p.add_argument("--config", required=True,
                           help="model config yaml (the model whose shapes are filled)")
        if name == "grounding":
            p.add_argument("--config", default="",
                           help="check the state dict against the port's model of this config")
        if name == "resnet":
            p.add_argument("--resnet50", action="store_true", help="ResNet-50 depths")
    args = parser.parse_args(argv)

    if args.cmd == "qa":
        ids = np.load(args.calib_ids) if args.calib_ids else None
        tree = convert_qa(_load_sources(args.src), args.quantize, args.wq,
                          not args.no_smooth, ids, args.device)
        os.makedirs(args.dst, exist_ok=True)
        out = os.path.join(args.dst, QA_EXPORT_NAME)
        torch.save(tree, out)
        print(f"wrote {out}")
        return 0

    sd = _load_torch_sd(args.src)
    if args.cmd == "grounding":
        state = convert_grounding(sd, args.config)
    elif args.cmd == "mdetr":
        state, loaded, n_loaded, skipped = convert_mdetr(sd, args.config)
        print(f"warm-started components: {loaded}")
        print(f"leaves loaded: {n_loaded}, shape-skipped: {len(skipped)}")
        if skipped:
            print("skipped:", skipped[:10])
    else:
        state = convert_fragment(args.cmd, sd, getattr(args, "resnet50", False))
    os.makedirs(os.path.dirname(os.path.abspath(args.dst)), exist_ok=True)
    torch.save({k: v.contiguous() for k, v in state.items()}, args.dst)
    print(f"wrote {len(state)} tensors to {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

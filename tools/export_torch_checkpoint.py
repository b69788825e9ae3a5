"""Export a JAX (orbax) checkpoint of vgqa_tpu as a file the PyTorch port
(vgqa_tpu_torch) loads.

    python tools/export_torch_checkpoint.py grounding SRC DST.pt [--config CFG] [--ema]
    python tools/export_torch_checkpoint.py qa MODEL_DIR [--dst FILE]

Run it where JAX and orbax are installed: the port reads no orbax files, and
the machine that serves the port need not have JAX.

* ``grounding``: SRC is an orbax directory that ``tools/train.py`` wrote,
  either a params-only twin (``model_*_params``, the weights JAX serving
  restores) or a full TrainState (``model_*``; its ``params``, or with
  ``--ema`` its EMA weights, as ``eval_params`` takes them). DST receives
  ``torch.save(state_dict)`` of ``vgqa_tpu_torch.models.convert_jax.
  state_dict_from_jax``, which ``vgqa_tpu_torch.inference.grounding.
  load_model(cfg, ckpt_path=DST)`` reads. With ``--config`` the state dict
  is first checked against the port's VSTGNet built from that config (every
  parameter named once, with its shape).
* ``qa``: MODEL_DIR holds ``params/``, the orbax tree ``{llm, embed,
  vision}`` of ``tools/convert_weights.py qa`` in float, int8
  (``kernel_q``) or int4 (``kernel_q4``) form. ``MODEL_DIR/params_torch.pt``
  (or ``--dst``) receives the same tree with torch leaves (float32 and
  bfloat16 floats as stored, int8 as stored), which the port's
  ``inference/qa.py`` loads into its engine with ``QAEngine.load_tree``.

A missing SRC or MODEL_DIR/params raises ``FileNotFoundError``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Mapping

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

QA_EXPORT_NAME = "params_torch.pt"


def restore(path: str) -> Any:
    """The orbax tree at ``path`` in its saved structure (numpy leaves)."""
    import jax

    from vgqa_tpu.training.checkpoint import CheckpointManager

    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    path = os.path.abspath(path)
    tree = CheckpointManager(os.path.dirname(path), save_to_disk=False).load_saved(path)
    return jax.tree.map(np.asarray, tree)


def grounding_params(tree: Mapping, ema: bool = False) -> Mapping:
    """The model parameters of a restored grounding checkpoint: a params
    twin as it is, a TrainState's ``params`` (``ema_params`` with ``ema``)."""
    if "opt_state" in tree or "step" in tree:
        key = "ema_params" if ema else "params"
        if tree.get(key) is None:
            raise KeyError(f"the TrainState holds no {key}")
        return tree[key]
    if ema:
        raise ValueError("--ema needs a full TrainState, not a params twin")
    return tree


def export_grounding(src: str, dst: str, config: str = "", ema: bool = False) -> dict:
    import torch

    from vgqa_tpu_torch.models.convert_jax import state_dict_from_jax

    module = None
    if config:
        from vgqa_tpu_torch.config import build_default_cfg
        from vgqa_tpu_torch.models import GroundingConfig, VSTGNet

        cfg = build_default_cfg()
        cfg.merge_from_file(config)
        module = VSTGNet(GroundingConfig.from_cfg(cfg))
    sd = state_dict_from_jax(grounding_params(restore(src), ema), module)
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    torch.save(sd, dst)
    return sd


def _torch_leaf(x: np.ndarray):
    import torch

    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":            # ml_dtypes: no numpy view in torch
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def export_qa(model_dir: str, dst: str = "") -> dict:
    import jax
    import torch

    tree = restore(os.path.join(model_dir, "params"))
    for part in ("llm", "embed", "vision"):
        if part not in tree:
            raise KeyError(f"{model_dir}/params holds no {part!r} tree")
    out = jax.tree.map(_torch_leaf, {k: tree[k] for k in ("llm", "embed", "vision")})
    torch.save(out, dst or os.path.join(model_dir, QA_EXPORT_NAME))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="kind", required=True)
    g = sub.add_parser("grounding", help="an orbax grounding checkpoint -> state dict .pt")
    g.add_argument("src")
    g.add_argument("dst")
    g.add_argument("--config", default="", help="check against the port's model of this config")
    g.add_argument("--ema", action="store_true", help="a TrainState's EMA weights")
    q = sub.add_parser("qa", help="MODEL_DIR/params -> MODEL_DIR/params_torch.pt")
    q.add_argument("model_dir")
    q.add_argument("--dst", default="")
    a = ap.parse_args(argv)
    if a.kind == "grounding":
        sd = export_grounding(a.src, a.dst, a.config, a.ema)
        print(f"wrote {len(sd)} tensors to {a.dst}")
    else:
        export_qa(a.model_dir, a.dst)
        print(f"wrote {a.dst or os.path.join(a.model_dir, QA_EXPORT_NAME)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

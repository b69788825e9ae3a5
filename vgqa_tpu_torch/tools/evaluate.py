"""Evaluate a grounding checkpoint on the VidSTG test split (counterpart of
``tools/evaluate.py``): the even/odd two-pass evaluation, then the metrics
as JSON on stdout.

    python -m vgqa_tpu_torch.tools.evaluate --config-file configs/grounding_vidstg.yaml \
        [--device cpu] [--save-pred] [KEY VALUE ...]

Weights come from ``MODEL.WEIGHT_EVAL`` (else ``MODEL.WEIGHT``): a port
state dict, such as ``tools/train`` writes as ``model_final_params`` or
``tools/export_torch_checkpoint.py`` exports. A JAX orbax directory raises
and names the exporter; a missing file evaluates the seeded random
initialization, with a warning. The model is ``inference/grounding.
load_model``'s in float32, as the JAX tool's is, under the port's float32
policy (``utils/device.apply_precision_policy``: TF32 off in cuBLAS and
cuDNN). Runs on the card unless ``--device cpu``.

Started as N processes (``python -m torch.distributed.run --nproc_per_node
N -m vgqa_tpu_torch.tools.evaluate ...``, or the ``VGQA_*`` contract of
``parallel/distributed.py``), each rank evaluates its slice of the split on
its own card and the predictions are merged; rank 0 prints the metrics of
all items.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from ..config import build_default_cfg
from ..data.loader import make_data_loader
from ..data.metrics import build_evaluator
from ..inference.grounding import load_model
from ..parallel.distributed import (destroy, get_rank, get_world_size, initialize_multihost,
                                    is_main_process)
from ..training.evaluator import do_eval
from ..utils.log_setup import setup_logger


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Grounding evaluation")
    parser.add_argument("--config-file", default="", metavar="FILE", type=str)
    parser.add_argument("--save-pred", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    formed = initialize_multihost(device=args.device)      # before any CUDA call

    cfg = build_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()

    logger = setup_logger("Video Grounding Eval", cfg.OUTPUT_DIR, rank=get_rank())
    weight = cfg.MODEL.WEIGHT_EVAL or cfg.MODEL.WEIGHT
    if not (weight and os.path.exists(weight)):
        logger.warning("No eval checkpoint found; evaluating random init")
        weight = ""
    f32 = cfg.clone()                 # evaluated in float32, as the JAX tool's model is
    f32.defrost()
    f32.TPU.COMPUTE_DTYPE = "float32"
    f32.freeze()
    loaded = load_model(f32, ckpt_path=weight, device=args.device)
    if weight:
        logger.info(f"Loaded eval weights from {weight}")
    model = loaded.model
    loader = make_data_loader(cfg, "test", global_batch=get_world_size(),
                              pin_memory=loaded.device.type == "cuda")
    evaluator = build_evaluator(cfg, logger, mode="test", save_pred=args.save_pred)
    results = do_eval(cfg, "test", logger, model, loader, evaluator)
    if is_main_process():
        print(json.dumps(results, indent=2, default=float))
    if formed:
        destroy()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

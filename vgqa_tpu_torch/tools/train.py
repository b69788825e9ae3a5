"""Train the grounding model over the VidSTG data (counterpart of
``tools/train.py``), then evaluate it on the test split.

    python -m vgqa_tpu_torch.tools.train --config-file configs/grounding_vidstg.yaml \
        [--device cpu] [--seed 2021] [--skip-test] [KEY VALUE ...]

Runs on the card unless ``--device cpu``. The float32 policy of the port's
entry points holds (``utils/device.apply_precision_policy``: TF32 off in
cuBLAS and cuDNN, so ``TPU.TRAIN_DTYPE float32`` trains every product in
float32). Writes ``OUTPUT_DIR/config.yml``, the log, ``model_final`` (the
resumable train state) and ``model_final_params`` (the model's state dict,
the EMA weights when ``MODEL.EMA`` is on; ``tools/evaluate`` and
``inference/grounding.load_model`` read it). ``tools/bench_train.py``'s A/B
flags are not part of the port.

Data parallel on N cards, one process per card:

    python -m torch.distributed.run --nproc_per_node N -m vgqa_tpu_torch.tools.train \
        --config-file configs/grounding_vidstg.yaml [KEY VALUE ...]

or N processes started with the JAX package's contract (``VGQA_COORDINATOR``
host:port, ``VGQA_NUM_PROCESSES``, ``VGQA_PROCESS_ID``; see
``parallel/distributed.py``). Each rank trains on card ``LOCAL_RANK`` over
NCCL (gloo with ``--device cpu``) at a global batch of N videos; rank 0
writes the log, ``config.yml`` and the checkpoints. Sequence and tensor
parallelism (``TPU.MESH_SP`` / ``MESH_TP`` above 1) raise.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from ..config import build_default_cfg
from ..parallel.distributed import destroy, get_rank, initialize_multihost, is_main_process
from ..training.trainer import Trainer
from ..utils.log_setup import setup_logger


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Spatio-Temporal Grounding Training")
    parser.add_argument("--config-file", default="", metavar="FILE", type=str)
    parser.add_argument("--seed", type=int, default=2021)
    parser.add_argument("--skip-test", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    formed = initialize_multihost(device=args.device)      # before any CUDA call

    cfg = build_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()

    if cfg.OUTPUT_DIR:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logger = setup_logger("Video Grounding", cfg.OUTPUT_DIR, rank=get_rank())
    trainer = Trainer(cfg, args.device, args.seed, logger=logger)
    logger.info(f"Device: {trainer.device}")
    if cfg.OUTPUT_DIR and is_main_process():
        with open(os.path.join(cfg.OUTPUT_DIR, "config.yml"), "w") as f:
            f.write(cfg.dump())
    trainer.setup()
    trainer.fit()
    if not args.skip_test:
        trainer.test()
    if formed:
        destroy()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

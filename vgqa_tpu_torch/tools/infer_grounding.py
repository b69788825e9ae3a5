"""Spatio-temporal grounding on videos (counterpart of
``tools/infer_grounding.py``).

    python -m vgqa_tpu_torch.tools.infer_grounding --video V.mp4 --query "..." \
        [--video V2.mp4 --query "..." ...] [--config CFG] [--checkpoint CKPT.pt] \
        [--output OUT.json] [--device cpu]

One ``--video`` prints its ``{"temporal": ..., "tube": [...]}``; repeated
``--video`` / ``--query`` pairs go through ``inference.grounding.predict_many``
in one call (pipelined, or one V = 2N forward per frame count under
``VGQA_GROUND_COALESCE=1``) and print the list. The JSON goes to stdout and,
with ``--output``, to that file. The checkpoint is the port's state dict
(``tools/convert_weights`` or ``tools/export_torch_checkpoint.py`` writes
one); runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

from ..inference.grounding import (
    DEFAULT_CHECKPOINT_PATH,
    DEFAULT_CONFIG_PATH,
    coalesce_from_env,
    predict,
    predict_many,
)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Spatio-temporal grounding inference")
    parser.add_argument("--video", required=True, action="append",
                        help="path to input video (repeatable, one --query each)")
    parser.add_argument("--query", required=True, action="append",
                        help="natural-language query (one per --video)")
    parser.add_argument("--config", default=DEFAULT_CONFIG_PATH)
    parser.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT_PATH)
    parser.add_argument("--output", default="", help="optional JSON output path")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if len(args.video) != len(args.query):
        parser.error(f"{len(args.video)} --video flags but {len(args.query)} --query flags")
    if len(args.video) == 1:
        result = predict(args.video[0], args.query[0], args.config, args.checkpoint,
                         device_str=args.device)
    else:
        result = predict_many([{"video_path": v, "query": q}
                               for v, q in zip(args.video, args.query)],
                              args.config, args.checkpoint, device=args.device,
                              coalesce=coalesce_from_env())
        errs = [r for r in result if isinstance(r, Exception)]
        if errs:
            raise errs[0]
    text = json.dumps(result, indent=2)
    if args.output:
        Path(args.output).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

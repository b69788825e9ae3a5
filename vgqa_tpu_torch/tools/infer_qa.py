"""Video question answering (counterpart of ``tools/infer_qa.py``).

    python -m vgqa_tpu_torch.tools.infer_qa --video V.mp4 --question "..." \
        [--video V2.mp4 --question "..." ...] [--model-dir DIR] [--num-frames 32] \
        [--max-new-tokens 128] [--temperature 0.2] [--top-p 0.9] \
        [--bound-start S --bound-end E] [--output OUT.json] [--device cpu]

One ``--video`` prints ``{"answer": ...}``; repeated ``--video`` /
``--question`` pairs go through ``inference.qa.predict_many`` (one lockstep
batched decode) and print the list. The JSON goes to stdout and, with
``--output``, to that file. ``--model-dir`` is read as ``inference/qa``
reads it (``__tiny__``: a small random model); runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

from ..inference.qa import DEFAULT_MODEL_DIR, predict, predict_many


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Video question answering")
    parser.add_argument("--video", required=True, action="append",
                        help="path to input video (repeatable, one --question each)")
    parser.add_argument("--question", required=True, action="append")
    parser.add_argument("--model-dir", default=DEFAULT_MODEL_DIR)
    parser.add_argument("--num-frames", type=int, default=32)
    parser.add_argument("--max-new-tokens", type=int, default=128)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--top-p", type=float, default=0.9)
    parser.add_argument("--bound-start", type=float, default=None)
    parser.add_argument("--bound-end", type=float, default=None)
    parser.add_argument("--output", default="")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if len(args.video) != len(args.question):
        parser.error(f"{len(args.video)} --video flags but {len(args.question)} "
                     "--question flags")
    bound = None
    if args.bound_start is not None and args.bound_end is not None:
        bound = (args.bound_start, args.bound_end)
    settings = dict(bound=bound, num_frames=args.num_frames,
                    max_new_tokens=args.max_new_tokens, temperature=args.temperature,
                    top_p=args.top_p)
    if len(args.video) == 1:
        result = predict(args.video[0], args.question[0], model_dir=args.model_dir,
                         device=args.device, **settings)
    else:
        result = predict_many([dict(settings, video_path=v, question=q)
                               for v, q in zip(args.video, args.question)],
                              model_dir=args.model_dir, device=args.device)
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

"""Data-parallel training of the port across the cards of one machine, in turns.

    python3 chip_ddp.py [WORLD ...]          (default: 1 N 1 N, N = min(cards, 4))

Builds the kernels, writes ``chip_smoke.py``'s synthetic VidSTG set, and runs
``chip_smoke.run_nccl`` at each world size in the order given: the train tool
on ``configs/grounding_vidstg.yaml`` (float32, 64f@420, V = 1 per rank) over
NCCL, one spawned rank per card; at world size 1, 3 steps, above, 2 epochs of
the 8 train items and the merged test. Each run passes ``train_ddp``'s checks
(exact launches per rank, bit-equal ranks, one checkpoint write, equal merged
metrics) and prints its line: s/step per rank, the gradient all-reduce's ms
per step (CUDA events) and bytes, rank 0's idle share, peak GiB per rank,
beside the card line. Alternating the world sizes on one machine is what makes
their s/step comparable. Exits non-zero without a card or when a run fails.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import torch

import chip_smoke as cs


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_ddp: no CUDA device visible", file=sys.stderr)
        return 1
    card = cs.card_line()
    cards = torch.cuda.device_count()
    print(f"{card}  torch {torch.__version__}  cuda {torch.version.cuda}  cards {cards}")
    n = min(cards, 4)
    worlds = [int(w) for w in argv] or [1, n, 1, n]
    if max(worlds) > cards:
        raise SystemExit(f"world size {max(worlds)} needs {max(worlds)} cards; {cards} visible")

    from vgqa_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    print(f"kernels built+loaded in {time.perf_counter() - t0:.1f} s")
    here = os.path.dirname(os.path.abspath(__file__))
    yaml_path = os.path.join(here, "configs", "grounding_vidstg.yaml")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_", dir=here) as root:
        data = os.path.join(root, "data")
        cs.write_vidstg_set(data)
        common = ["DATA_DIR", data, "TENSORBOARD_DIR", ""]
        for world in worlds:
            run, secs = cs.run_nccl(world, yaml_path, common, root)
            launches = cs._check_ddp_run(*run, 4, skip_test=world == 1)
            cs._ddp_line(run[0], f"nccl on {world} of {cards} cards", card)
            print(f"world {world}: {secs:.1f} s; launches over its ranks {launches}; all-reduce "
                  f"ms per step per rank {[[round(x, 3) for x in r['allreduce_ms']] for r in run[0]]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

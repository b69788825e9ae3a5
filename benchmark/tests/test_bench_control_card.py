"""The control of each cell, on the card at the cell's own size, on three
seeds: the reference one precision below the configuration's, put in the
program's place, must come out as not correct.

    python -m pytest benchmark/tests/test_bench_control_card.py -m cuda -q
"""

import pytest

import control
from harness import load_json

SEEDS = (3_500_000_001, 3_500_000_002, 3_500_000_003)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vstg420_serve_c4", "vstg420_train_f32", "ivc8b_qa_b4"])
def test_control_is_not_correct(card, cell):
    limits = load_json("workloads", cell + ".json")["limits"]
    for seed in SEEDS:
        r = control.readings(cell, seed, 4.0, device=card)
        assert any(r["control"][k] > limits[k] for k in limits), r
        assert all(r["program"][k] <= limits[k] for k in limits), r

"""The lockstep batched decode of the port's QA engine on the CPU (tiny
config, float32): the loop that reads nothing from the device before its
end when every row ignores EOS, and ``done`` every ``DONE_EVERY`` steps
when stop ids apply, emits each row's solo-chat tokens; the batch cache is
kept per key, at most ``KEPT_DECODE_KEYS`` of them. The graph replay of the
step runs on the card only (``tests/test_torch_qa_graph_cuda.py``)."""

import numpy as np
import pytest
import torch

from vgqa_tpu_torch.qa import engine as teng_mod
from vgqa_tpu_torch.qa.llm import LLMConfig
from vgqa_tpu_torch.qa.vit import ViTConfig
from vgqa_tpu_torch.utils import trace


class IdTokenizer(teng_mod.ByteTokenizer):
    """Byte tokenizer whose decode returns the ids (EOS = 2, IM_END = 4)."""

    def decode(self, ids):
        return ",".join(str(int(i)) for i in ids)


@pytest.fixture(scope="module")
def engine():
    return teng_mod.QAEngine.init_random(LLMConfig.tiny(), ViTConfig.tiny(), seed=3,
                                         device="cpu", tokenizer=IdTokenizer(),
                                         max_seq_len=256)


def _tiles(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 32, 32, 3), np.uint8)


# prompts of 219, 214 and 233 tokens; with ignore_eos and 20 greedy tokens
# row 1 emits EOS (2) at step 10 and rows 0 and 2 emit neither stop id
REQS = [(_tiles(2, 2), "what happens?"), (_tiles(1, 3), "who is there"),
        (_tiles(2, 4), "where is the dog going now?")]


def _gen(n, sampled=False, ignore_eos=True):
    if sampled:
        return teng_mod.GenerationConfig(max_new_tokens=n, temperature=0.8, top_p=0.9,
                                         ignore_eos=ignore_eos)
    return teng_mod.GenerationConfig(max_new_tokens=n, do_sample=False, ignore_eos=ignore_eos)


CASES = {
    # every row ignores EOS, each at its own budget, row 1 sampled
    "budgets": (256, [_gen(3), _gen(7, sampled=True), _gen(12)], 12, False),
    # stop ids apply: row 1 stops at EOS on step 10, rows 0 and 2 spend
    # their budgets by step 9; the read at step 16 ends the loop
    "stop_id": (256, [_gen(9, ignore_eos=False), _gen(20, ignore_eos=False),
                      _gen(9, sampled=True, ignore_eos=False)], 16, True),
    # a 240-position context: row 2 (233 tokens) reaches S - 1 at step 6,
    # after the other rows' budgets, so the cache's end bounds the loop
    "cache_end": (240, [_gen(3), _gen(4, sampled=True), _gen(12)], 7, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lockstep_equals_solo_chats(engine, case):
    max_seq_len, gens, steps, reads_done = CASES[case]
    engine.max_seq_len = max_seq_len
    try:
        with trace.tracing():
            got = engine.chat_batch(REQS, gens=gens, generators=[
                torch.Generator().manual_seed(10 + b) for b in range(len(REQS))])
            snap = trace.snapshot()
        want = [engine.chat(*req, g, generator=torch.Generator().manual_seed(10 + b))
                for b, (req, g) in enumerate(zip(REQS, gens))]
    finally:
        engine.max_seq_len = 256
    assert got == want
    lengths = [len(a.split(",")) if a else 0 for a in got]
    if case == "budgets":
        assert lengths == [3, 7, 12]
    elif case == "stop_id":
        assert lengths == [9, 10, 9]
    else:
        assert lengths == [3, 4, 6]
    assert snap["counters"]["qa.decode_steps"] == steps
    assert snap["counters"]["qa.decode.forwards"] >= steps - 1
    assert "qa.decode.graph_replays" not in snap["counters"]
    decode = next(s for s in snap["spans"] if s["name"] == "vgqa.qa.decode")
    sites = [s["attrs"]["site"] for s in snap["spans"]
             if s["name"] == trace.SYNC_SPAN and s["parent"] == decode["id"]]
    if reads_done:
        assert sites == ["qa.decode.done", "qa.decode.done", "qa.decode.tokens"]
    else:
        assert sites == ["qa.decode.tokens"]


def test_lockstep_keeps_the_newest_keys(engine):
    """A key's cache is reused as it is (each row overwritten whole), and
    only the two most recent keys stay allocated."""
    gen = _gen(4)
    first = engine.chat_batch(REQS[:2], gen=gen)
    kept = list(engine._lockstep.values())[-1]
    assert engine.chat_batch(REQS[:2], gen=gen) == first
    assert list(engine._lockstep.values())[-1] is kept
    engine.chat_batch(REQS[:1], gen=gen)
    engine.chat_batch(REQS, gen=gen)
    assert len(engine._lockstep) == engine.KEPT_DECODE_KEYS
    assert kept not in engine._lockstep.values()
    assert sorted(k[0] for k in engine._lockstep) == [1, 3]
    assert engine.chat_batch(REQS[:2], gen=gen) == first

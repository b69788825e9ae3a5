"""The QA engine's lockstep decode step as a CUDA graph replay, on the card
(tiny config, bf16): a replayed call emits the eager call's tokens exactly,
greedy and sampled rows with fixed generators, at B = 1 and 4, over the
bf16 and the int8 cache, with bf16, int8 and int4 (K6) weights; after a
key's first call every forward is a replay; a capture that raises leaves
the key eager and is counted. Every
test needs a CUDA device and skips without one; the module imports no
JAX:

    python -m pytest tests/test_torch_qa_graph_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vgqa_tpu_torch.qa import engine as teng_mod
from vgqa_tpu_torch.qa.llm import LLMConfig
from vgqa_tpu_torch.qa.quant import quantize_llm_params, quantize_llm_params_int4
from vgqa_tpu_torch.qa.vit import ViTConfig
from vgqa_tpu_torch.utils import trace


class IdTokenizer(teng_mod.ByteTokenizer):
    def decode(self, ids):
        return ",".join(str(int(i)) for i in ids)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graph is captured on the device")
    return torch.device("cuda")


# widths at which every int4 projection passes K6's gate
INT4_LLM = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                intermediate_size=512, max_seq_len=512, rope_theta=10000.0)


def _engine(dev, kv_int8, weights):
    llm, vit = LLMConfig.tiny(), ViTConfig.tiny()
    if weights == "int4":
        llm, vit = LLMConfig(**INT4_LLM), ViTConfig(**{**vit.__dict__, "llm_hidden_size": 256})
    eng = teng_mod.QAEngine.init_random(llm, vit, seed=3, device=dev, dtype=torch.bfloat16,
                                        tokenizer=IdTokenizer(), max_seq_len=256,
                                        kv_int8=kv_int8)
    if weights == "int8":
        quantize_llm_params(eng.llm)
    elif weights == "int4":
        quantize_llm_params_int4(eng.llm)
    return eng


def _requests(B):
    qs = ["what happens?", "who is there", "where is the dog going now?", "what is on the table"]
    return [(np.random.RandomState(b).randint(0, 256, (1 + b % 2, 32, 32, 3), np.uint8), qs[b])
            for b in range(B)]


def _call(eng, B, dev, ignore_eos=True):
    """One chat_batch of B requests, row 0 greedy when B > 1 and the rest
    sampled; (answers, the call's tracer counters)."""
    gens = [teng_mod.GenerationConfig(max_new_tokens=12, do_sample=bool(b or B == 1),
                                      temperature=0.7, top_p=0.9, ignore_eos=ignore_eos)
            for b in range(B)]
    generators = [torch.Generator(device=dev).manual_seed(100 + b) for b in range(B)]
    with trace.tracing():
        out = eng.chat_batch(_requests(B), gens=gens, generators=generators)
        counters = trace.snapshot()["counters"]
    return out, counters


@pytest.mark.cuda
@pytest.mark.parametrize("B,kv_int8,ignore_eos,weights", [
    (1, False, True, "bf16"), (1, True, True, "bf16"), (4, False, True, "bf16"),
    (4, True, True, "bf16"), (4, True, False, "bf16"), (4, True, True, "int8"),
    (4, True, True, "int4")])
def test_replayed_decode_equals_eager(cuda, B, kv_int8, ignore_eos, weights):
    eager = _engine(cuda, kv_int8, weights)
    plain = eager._decode_impl

    def no_capture(*args):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("capture refused")
        return plain(*args)

    eager._decode_impl = no_capture
    want, c_eager = _call(eager, B, cuda, ignore_eos)
    again, c_again = _call(eager, B, cuda, ignore_eos)
    assert again == want
    assert c_eager["qa.decode.graph_failures"] == 1
    assert "qa.decode.graph_failures" not in c_again
    for c in (c_eager, c_again):
        assert c["qa.decode.forwards"] > 0 and "qa.decode.graph_replays" not in c
    del eager

    graphed = _engine(cuda, kv_int8, weights)
    first, c_first = _call(graphed, B, cuda, ignore_eos)
    second, c_second = _call(graphed, B, cuda, ignore_eos)
    assert first == want and second == want
    assert c_first["qa.decode.graph_captures"] == 1
    assert c_first["qa.decode.graph_replays"] == c_first["qa.decode.forwards"] - 1
    assert c_second["qa.decode.graph_replays"] == c_second["qa.decode.forwards"] > 0
    assert "qa.decode.graph_captures" not in c_second
    if ignore_eos:
        assert all(len(a.split(",")) == 12 for a in want)

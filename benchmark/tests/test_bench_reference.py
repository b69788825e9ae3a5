"""The QA reference's prefix sharing: scoring several answers about the
same frames from one run of their common prefix gives the gaps that a
whole-sequence forward of each gives."""

import torch

from reference.qa import (LlmGeometry, QAModel, VitGeometry, answer_gaps, logits_at,
                          prompt_ids, vision_tokens)
from harness import load_module
from test_bench_cpu_runs import QA
from weights import seeded_weights


def test_prefix_shared_gaps_match_whole_forwards():
    with torch.device("meta"):
        model = QAModel(LlmGeometry(**QA["llm"]), VitGeometry(**QA["vit"]))
    model.load_state_dict(seeded_weights(model, 11, torch.device("cpu"), torch.float32),
                          assign=True)
    tok, it = load_module("traffic", "qa_batches").IdTokenizer(), 4
    g = torch.Generator().manual_seed(2)
    videos = [torch.randint(0, 256, (3, 32, 32, 3), generator=g, dtype=torch.uint8)
              for _ in range(2)]
    items = [(v, videos[v], q, [int(t) for t in torch.randint(16, 250, (5,), generator=g)])
             for v, q in [(0, "What is it?"), (1, "Who runs first here?"), (0, "Why (A) or (B)?")]]
    gaps, lengths = answer_gaps(model, tok, items, it)
    for (_, tiles, question, served), got, n in zip(items, gaps, lengths):
        ids, pos = prompt_ids(tok, question, tiles.shape[0], it)
        seq = ids + served[:-1]
        ref = logits_at(model, seq, pos, vision_tokens(model.vision, tiles),
                        list(range(len(ids) - 1, len(seq))))
        want = ref.max(-1).values - ref.gather(-1, torch.tensor(served)[:, None])[:, 0]
        assert n == len(ids)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)

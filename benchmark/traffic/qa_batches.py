"""Video QA in batches, as the server's QA coalescer serves them.

Parameters: ``batch`` requests per ``QAEngine.chat_batch`` call, calls back
to back; ``videos`` distinct pre-made videos of ``frames`` uint8 448 px
tiles (one per frame), cycled; multiple-choice questions of
``question_words`` words; ``new_tokens`` answer tokens (``ignore_eos``),
sampled at ``temperature`` / ``top_p`` with per-request generators from the
seed, except ``greedy_per_call`` requests of each call, in slots drawn from
the seed call by call, which decode greedily; ``check_requests`` greedy
answers of the window drawn from the seed for the comparison, which counts
their tokens more than ``far_gap`` logits below the reference's best;
``trace_calls`` calls of the window profiled when traced.

The program is the port's engine built from the seeded weights
(``QAEngine`` over its own modules; bf16, int8 KV cache, ``max_seq_len``
from the configuration) with the benchmark's tokenizer: byte-level ids
with the chat special ids, whose ``decode`` writes the ids themselves, so
the answers carry the served tokens.
"""

from __future__ import annotations

import json
import random
import time

import torch

from harness import Check, DeviceTrace, log
from reference.precision import float32
from reference.qa import LlmGeometry, QAModel, VitGeometry, answer_gaps, prompt_ids
from weights import seeded_weights


class IdTokenizer:
    """UTF-8 bytes offset by 16, the chat special ids below them; ``decode``
    returns the ids as comma-separated text."""

    PAD, BOS, EOS, IM_START, IM_END, IMG_CONTEXT = 0, 1, 2, 3, 4, 5
    IMG_START, IMG_END = 6, 7
    OFFSET = 16
    vocab_size = 256 + OFFSET

    def encode(self, text):
        return [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, ids):
        return ",".join(str(int(i)) for i in ids)


_TOPICS = ["the person in the red jacket", "the dog", "the cyclist", "the chef", "the child",
           "the man near the window", "the woman holding a cup", "the car", "the players",
           "the bird on the fence"]
_ASKS = ["What does {} do right after entering the scene?",
         "In which order do the actions of {} happen?",
         "Why does {} stop moving in the middle of the video?",
         "Where is {} at the end of the video compared with the start?",
         "How many times does {} turn around during the clip?",
         "What object does {} pick up first?"]
_OPTIONS = ["opens the door", "sits down", "walks away", "picks up a bag", "waves a hand",
            "turns left", "runs to the car", "puts the cup on the table", "jumps twice",
            "looks at the camera", "stands still", "leaves the room"]


def questions(seed: int, n: int, lo: int, hi: int):
    """``n`` multiple-choice questions of ``lo``-``hi`` words (MVBench /
    Video-MME style: a question, four options, an instruction)."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        target = rng.randint(lo, hi)
        opts = rng.sample(_OPTIONS, 4)
        text = rng.choice(_ASKS).format(rng.choice(_TOPICS))
        text += " " + " ".join(f"({c}) {o}." for c, o in zip("ABCD", opts))
        text += " Answer with the option's letter."
        words = text.split()
        while len(words) < target:
            words.insert(-5, rng.choice(["Watch", "closely", "please", "carefully", "now"]))
        out.append(" ".join(words[:hi]))
    return out


def setup(ctx):
    from vgqa_tpu_torch.qa.engine import GenerationConfig, QAEngine
    from vgqa_tpu_torch.qa.llm import LLM, LLMConfig, TokenEmbedding
    from vgqa_tpu_torch.qa.vit import ViTConfig, VisionTower

    p = ctx.params
    c = ctx.config
    llm_g = LlmGeometry(**dict(c["llm"], **ctx.overrides.get("llm", {})))
    vit_g = VitGeometry(**dict(c["vit"], **ctx.overrides.get("vit", {})))
    with torch.device("meta"):
        ref = QAModel(llm_g, vit_g)
    dtype = getattr(torch, c["dtype"])
    scales = dict(c.get("weight_scales", {}), **ctx.overrides.get("weight_scales", {}))
    weights = seeded_weights(ref, ctx.seed, ctx.device, dtype, scales)
    ref.load_state_dict(weights, assign=True)
    llm_cfg = LLMConfig(**{f: getattr(llm_g, f) for f in llm_g.__dataclass_fields__},
                        max_seq_len=c["max_seq_len"])
    vit_cfg = ViTConfig(**{f: getattr(vit_g, f) for f in vit_g.__dataclass_fields__})
    with torch.device("meta"):
        mods = {"llm": LLM(llm_cfg), "embed": TokenEmbedding(llm_cfg),
                "vision": VisionTower(vit_cfg)}
    for name, mod in mods.items():
        pre = name + "."
        mod.load_state_dict({k[len(pre):]: v for k, v in weights.items() if k.startswith(pre)},
                            assign=True)
        mod.eval()
    tok = IdTokenizer()
    engine = QAEngine(llm_cfg, vit_cfg, mods["llm"], mods["embed"], mods["vision"],
                      tokenizer=tok, max_seq_len=c["max_seq_len"], dtype=dtype,
                      kv_int8=c["kv_int8"])
    g = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    S = vit_g.image_size
    videos = [torch.randint(0, 256, (p["frames"], S, S, 3), generator=g, device=ctx.device,
                            dtype=torch.uint8).cpu().numpy() for _ in range(p["videos"])]
    qs = questions(ctx.seed, 1024, *p["question_words"])
    image_tokens = engine.num_image_token
    state = {"engine": engine, "ref": ref, "videos": videos, "questions": qs, "tok": tok,
             "image_tokens": image_tokens, "counter": 0, "answers": {}, "GenerationConfig":
             GenerationConfig}
    ctx.plant(state)
    _call(ctx, state)                       # warm-up: the cell's own shapes
    state["answers"].clear()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    return state


def _request(ctx, state, k: int):
    p = ctx.params
    return (state["videos"][k % len(state["videos"])], state["questions"][k % 1024],
            [1] * p["frames"])


def _greedy(ctx, k: int) -> bool:
    """Whether request ``k`` decodes greedily: ``greedy_per_call`` slots of
    its call, drawn from the seed and the call's index, so that every slot
    of the batch is compared."""
    p = ctx.params
    call, slot = divmod(k, p["batch"])
    rng = random.Random(ctx.seed * 1_000_003 + call)
    return slot in rng.sample(range(p["batch"]), p["greedy_per_call"])


def _call(ctx, state):
    """One chat_batch call of the next ``batch`` requests."""
    p = ctx.params
    GC = state["GenerationConfig"]
    ks = list(range(state["counter"], state["counter"] + p["batch"]))
    state["counter"] += p["batch"]
    gens = [GC(max_new_tokens=p["new_tokens"], temperature=p["temperature"],
               top_p=p["top_p"], do_sample=not _greedy(ctx, k), ignore_eos=True) for k in ks]
    generators = [torch.Generator(device=ctx.device).manual_seed(
        (ctx.seed * 7919 + k) % (1 << 62)) for k in ks]
    with torch.profiler.record_function("qa.chat_batch"):
        answers = state["engine"].chat_batch([_request(ctx, state, k) for k in ks], gens=gens,
                                             generators=generators)
    for k, a in zip(ks, answers):
        state["answers"][k] = [int(t) for t in a.split(",")] if a else []
    return len(ks)


def window(ctx, state):
    p = ctx.params
    t0 = time.perf_counter()
    n, calls, traced = 0, 0, None
    while True:
        if ctx.trace and calls == 1:
            with DeviceTrace() as tr:
                got = sum(_call(ctx, state) for _ in range(p["trace_calls"]))
            traced = tr.data
            traced.counters["answers"] = got
            traced.counters["first_request"] = state["counter"] - got
            n += got
            calls += p["trace_calls"]
        else:
            n += _call(ctx, state)
            calls += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    span = time.perf_counter() - t0
    log(f"window: {n} answers in {calls} calls, {span:.3f} s")
    out = {"metrics": {"qa_answers_per_s": n / span}, "attempted": n, "failed": 0}
    short = [k for k, a in state["answers"].items() if len(a) != p["new_tokens"]]
    out["failed"] = len(short)
    if ctx.trace:
        tok, it = state["tok"], state["image_tokens"]
        first = traced.counters["first_request"]
        traced.counters["prompt_lengths"] = [
            len(prompt_ids(tok, _request(ctx, state, k)[1], p["frames"], it)[0])
            for k in range(first, first + traced.counters["answers"])]
        out["trace"] = traced
    return out


def release(ctx, state):
    state.pop("engine", None)


def check(ctx, state, control: bool = False):
    """A seeded sample of the window's greedy answers: the reference runs
    once over each prompt with its served tokens and reads, at each served
    token, the gap by which its logit lies below the reference's best.
    Compared: the share of the sample's tokens whose gap exceeds
    ``far_gap``. The widest and the mean gap are logged beside it: the
    random model's near-ties set the widest gap, and the mean follows each
    seed's logit scale, for the program and the control alike, so neither
    separates them. With ``control`` the token scored at each position is
    the one the reference in float8 products puts first."""
    p = ctx.params
    greedy = sorted(k for k in state["answers"] if _greedy(ctx, k))
    rng = random.Random(ctx.seed)
    sample = rng.sample(greedy, min(p["check_requests"], len(greedy)))
    whole = [k for k in sample if len(state["answers"][k]) == p["new_tokens"]]
    items = []
    for k in whole:
        tiles, question, _ = _request(ctx, state, k)
        items.append((k % len(state["videos"]), torch.from_numpy(tiles).to(ctx.device),
                      question, state["answers"][k]))
    with float32():
        gaps, _ = answer_gaps(state["ref"], state["tok"], items, state["image_tokens"],
                              control=control)
    per_token = [[round(float(x), 4) for x in g] for g in gaps]
    per_token += [[float("inf")]] * (len(sample) - len(whole))
    slots = sorted({k % p["batch"] for k in sample})
    gaps = [g for row in per_token for g in row] or [float("inf")]
    far = sum(g > p["far_gap"] for g in gaps) / len(gaps)
    log(f"check: {len(sample)} greedy answers in slots {slots}, {len(gaps)} served tokens "
        f"compared, widest gap {max(gaps):.4f}, mean gap {sum(gaps) / len(gaps):.4f}; "
        "per token " + json.dumps(per_token))
    return [Check("far_token_share", far, ctx.workload["limits"]["far_token_share"])]

"""Faults that break a cell's timed path underneath, for showing that its
comparison catches them: the CPU tests plant them in whole runs at tiny
sizes (``tests/test_bench_cpu_runs.py``), and ``control.py --fault`` reads
them on the card at the cell's own size. Each takes the driver's state once
the program is built, wraps a part of the program in place and returns a
function that takes the wrap off again; the benchmark's own runs never
call them."""

from __future__ import annotations

import torch


def serve_answer_altered(state):
    """The served span's start halved where the forward produces it."""
    loaded = state["loaded"]
    fwd = loaded.fwd_u8

    def altered(*args):
        packed, span = fwd(*args)
        return packed, torch.stack([span[:, 0] // 2, span[:, 1]], -1)

    loaded.fwd_u8 = altered
    return lambda: setattr(loaded, "fwd_u8", fwd)


def serve_half_batch(state):
    """Half of each coalesced batch run, its answers copied to the rest."""
    c = state["coalescer"]
    inner = c.run_batch

    def half(requests):
        out = inner(requests[: max(1, len(requests) // 2)])
        return out + out[:1] * (len(requests) - len(out))

    c.run_batch = half
    return lambda: setattr(c, "run_batch", inner)


def serve_box_first_layer(state):
    """The box head reads the spatial decoder's first layer instead of its
    last: every layer's boxes are the first layer's."""
    mods = [m for m in state["loaded"].model.modules() if type(m).__name__ == "PosDecoder"]
    for mod in mods:
        def first(*args, _inner=mod.forward, **kw):
            boxes = _inner(*args, **kw)
            return boxes[:1].expand_as(boxes).clone()

        mod.forward = first
    return lambda: [delattr(m, "forward") for m in mods]


def train_state_unchanged(state):
    """The optimizer's step leaves the parameters as they were."""
    opt = state["trainer"].state.optimizer
    inner = opt.step
    opt.step = lambda step: torch.zeros(())
    return lambda: setattr(opt, "step", inner)


def qa_token_altered(state):
    """Every decoded token moved to the next id where it is produced."""
    eng = state["engine"]
    inner = eng._generate_batch

    def altered(*args, **kw):
        rows = inner(*args, **kw)
        return [[(t + 1) % eng.llm_cfg.vocab_size for t in r] for r in rows]

    eng._generate_batch = altered
    return lambda: setattr(eng, "_generate_batch", inner)


def qa_half_batch(state):
    """Half of each chat_batch call run, its first answer copied to the rest."""
    eng = state["engine"]
    inner = eng.chat_batch

    def half(requests, gens=None, generators=None, **kw):
        n = max(1, len(requests) // 2)
        out = inner(requests[:n], gens=gens[:n], generators=generators[:n], **kw)
        return out + out[:1] * (len(requests) - n)

    eng.chat_batch = half
    return lambda: setattr(eng, "chat_batch", inner)


def qa_last_slot_altered(state):
    """The last slot of each batch decodes one id off, the others right:
    a fault of one row of the batched decode."""
    eng = state["engine"]
    inner = eng._generate_batch

    def altered(*args, **kw):
        rows = inner(*args, **kw)
        rows[-1] = [(t + 1) % eng.llm_cfg.vocab_size for t in rows[-1]]
        return rows

    eng._generate_batch = altered
    return lambda: setattr(eng, "_generate_batch", inner)

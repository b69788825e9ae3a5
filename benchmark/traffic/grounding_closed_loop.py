"""Grounding serving under a closed loop of clients.

Parameters (the cell's ``params``): ``clients`` callers, each sending its
next request when the previous one is answered; ``videos`` distinct
pre-made videos of ``frames`` uint8 frames at the configuration's
resolution, cycled; ``fps`` and ``ori_size`` of each video; queries of
``query_words`` words; ``max_batch`` requests per coalesced call, as the
server's grounding coalescer drains them; ``check_requests`` answers of
the window drawn from the seed for the comparison; ``trace_seconds`` of the
window profiled when traced.

The program is driven as ``app/server.py`` drives it after decoding: a
``_Coalescer`` whose batch runner is ``inference/grounding.predict_many``
over already-decoded ``frames`` (the server's default, pipelined policy),
with the model from ``load_model`` holding the seeded weights.
"""

from __future__ import annotations

import json
import random
import threading
import time

import numpy as np
import torch

from harness import Check, DeviceTrace, log, percentile
from vstg_common import declarative_queries, program_cfg, reference_model


def _frames(seed: int, n: int, t2: int, res: int, device) -> list:
    """``n`` videos of uint8 frames [t2, res, res, 3] in host memory, drawn
    on the device from the seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(n):
        v = torch.randint(0, 256, (t2, res, res, 3), generator=g, device=device,
                          dtype=torch.uint8)
        out.append(v.cpu().numpy())
    return out


def setup(ctx):
    from vgqa_tpu_torch.app.server import _Coalescer
    from vgqa_tpu_torch.inference.grounding import load_model, predict_many

    p = ctx.params
    cfg = program_cfg(ctx.cfg_values)
    ref, weights = reference_model(ctx.cfg_values, ctx.seed, ctx.device)
    loaded = load_model(cfg, "", device=ctx.device, seed=ctx.seed, state_dict=weights)
    res, t2 = cfg.INPUT.RESOLUTION, 2 * cfg.INPUT.TRAIN_SAMPLE_NUM
    videos = _frames(ctx.seed, p["videos"], t2, res, ctx.device)
    queries = declarative_queries(ctx.seed, 4096, *p["query_words"])
    calls = []

    def run_batch(requests):
        calls.append(len(requests))
        with torch.profiler.record_function("serve.run_batch"):
            return predict_many(requests, loaded=loaded, coalesce=False)

    coalescer = _Coalescer(p["max_batch"], 600.0, run_batch)
    state = {"ref": ref, "weights": weights, "loaded": loaded, "videos": videos,
             "queries": queries, "coalescer": coalescer, "calls": calls, "res": res,
             "t2": t2, "cfg": cfg, "counter": 0, "lock": threading.Lock()}
    ctx.plant(state)
    # warm-up: the cell's own shapes, through the same closed loop
    _loop(ctx, state, seconds=0.0, min_requests=p["warmup_requests"])
    calls.clear()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    return state


def _request(ctx, state, k: int):
    p = ctx.params
    v = k % len(state["videos"])
    return {"frames": state["videos"][v], "fps": float(p["fps"]),
            "ori_size": tuple(p["ori_size"]), "query": state["queries"][k % 4096]}


def _loop(ctx, state, seconds: float, min_requests: int = 0, on_start=None):
    """Run the closed loop until the first answer after ``seconds`` (and at
    least ``min_requests`` answers); returns (t0, t_end, records), each
    record (k, submitted, answered, result or exception)."""
    p = ctx.params
    coalescer = state["coalescer"]
    records, lock = [], state["lock"]
    t0 = time.perf_counter()
    end = {"t": None}

    def client():
        while True:
            with lock:
                if end["t"] is not None:
                    return
                k = state["counter"]
                state["counter"] += 1
            req = _request(ctx, state, k)
            sent = time.perf_counter()
            try:
                out = coalescer.submit(req)
            except Exception as e:  # noqa: BLE001 - a failed request is counted
                out = e
            done = time.perf_counter()
            with lock:
                records.append((k, sent, done, out))
                if (end["t"] is None and done - t0 >= seconds
                        and len(records) >= min_requests):
                    end["t"] = done

    threads = [threading.Thread(target=client) for _ in range(p["clients"])]
    for t in threads:
        t.start()
    if on_start is not None:
        on_start(t0)
    for t in threads:
        t.join()
    return t0, end["t"], records


def window(ctx, state):
    p = ctx.params
    traced = {}

    def profile_part(t0):
        if not ctx.trace:
            return
        time.sleep(min(2.0, ctx.seconds / 4))
        with DeviceTrace() as tr:
            state["calls_before"] = len(state["calls"])
            time.sleep(p["trace_seconds"])
        traced["data"] = tr.data
        traced["calls"] = state["calls"][state["calls_before"]:]

    t0, t_end, records = _loop(ctx, state, ctx.seconds, on_start=profile_part)
    inside = [r for r in records if r[2] <= t_end]
    ok = [r for r in inside if not isinstance(r[3], Exception)]
    lat = [r[2] - r[1] if not isinstance(r[3], Exception) else float("inf") for r in inside]
    state["answers"] = {r[0]: r[3] for r in ok}
    span = t_end - t0
    log(f"window: {len(inside)} requests in {span:.3f} s, {len(inside) - len(ok)} failed, "
        f"{len(state['calls'])} calls")
    metrics = {"ground_clips_per_s": 2.0 * len(ok) / span,
               "ground_latency_p95_s": percentile(lat, 95)}
    out = {"metrics": metrics, "attempted": len(inside), "failed": len(inside) - len(ok)}
    if ctx.trace:
        tr = traced["data"]
        tr.counters["calls"] = traced["calls"]
        out["trace"] = tr
    return out


def release(ctx, state):
    for key in ("loaded", "coalescer"):
        state.pop(key, None)


def check(ctx, state, control: bool = False):
    """A seeded sample of the window's answers against the reference's
    answers to the same requests. Per request: the root mean square of the
    box gaps over its frames (pixels over the longer side), that of the
    per-frame score gaps, and the log-probability deficit of the served
    span under the reference's start and end scores
    (``reference.vstg.serve.span_deficit``). Compared: the 75th percentile of
    the span deficit over the sample (a request at a near-tie of the random
    model moves by more than rounding, and the videos repeat across
    requests), and the median request's box gap, which covers the spatial
    half of the answer (the spatial decoder, the box head, the post-process
    and the merge's interpolation). The score gaps are logged beside them.
    With ``control`` the answers judged are the reference's own in float8
    products instead of the program's."""
    from reference.precision import Float8Products, float32
    from reference.vstg.serve import ground, span_deficit

    p = ctx.params
    answers = state["answers"]
    keys = sorted(answers)
    rng = random.Random(ctx.seed)
    sample = rng.sample(keys, min(p["check_requests"], len(keys)))
    model = state["ref"].eval()
    max_q = ctx.cfg_values["INPUT.MAX_QUERY_LEN"]
    ori_h, ori_w = p["ori_size"]
    fps = float(p["fps"])
    gaps = []                                # (box rms, score rms, span deficit)
    with torch.no_grad(), float32():
        for k in sample:
            req = _request(ctx, state, k)
            frames = torch.from_numpy(req["frames"]).to(ctx.device)

            def one():
                return ground(model, frames, fps, (ori_h, ori_w), req["query"], max_q)

            ref = one()
            got = answers[k]
            if control:
                with Float8Products():
                    got = one()
            if [t["frame"] for t in got["tube"]] != [t["frame"] for t in ref["tube"]]:
                gaps.append((float("inf"),) * 3)
                continue
            b_got = np.asarray([t["bbox"] for t in got["tube"]], np.float64)
            b_ref = np.asarray([t["bbox"] for t in ref["tube"]], np.float64)
            s_got = np.asarray([t["score"] for t in got["tube"]], np.float64)
            s_ref = np.asarray([t["score"] for t in ref["tube"]], np.float64)
            start = int(round(got["temporal"]["start"] * fps))
            end = int(round(got["temporal"]["end"] * fps))
            gaps.append((float(np.sqrt((((b_got - b_ref) / max(ori_h, ori_w)) ** 2).mean())),
                         float(np.sqrt(((s_got - s_ref) ** 2).mean())),
                         float(span_deficit(ref["deficits"], start, end))))
    g = np.asarray(gaps if gaps else [(float("inf"),) * 3])
    q75 = np.percentile(g, 75, axis=0)
    box_median = float(np.median(g[:, 0]))
    log(f"check: {len(gaps)} answers; median box rms {box_median:.5f}; 75th percentile of "
        f"the score rms {q75[1]:.5f}; per request (box rms, score rms, span deficit) "
        + json.dumps([[round(float(x), 6) for x in row] for row in g]))
    lim = ctx.workload["limits"]
    return [Check("span_gap_q75", q75[2], lim["span_gap_q75"]),
            Check("box_rms_median", box_median, lim["box_rms_median"])]

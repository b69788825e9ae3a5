"""The port's tracer (``vgqa_tpu_torch/utils/trace.py``) on the CPU: off it
records nothing; spans nest with parents, request ids and self time;
cross-thread spans; one session per traced part; the record cap; the
``VGQA_TRACE`` export; syncs counted against the innermost span; and the
spans of ``predict_many`` (both policies), the coalescer, ``chat_batch``
and ``fit`` under ``torch.profiler``, tiny configurations."""

import collections
import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vgqa_tpu_torch.utils import trace

SYNC_WARNING = "called a synchronizing CUDA operation"


def _profiled(fn):
    """Run ``fn`` under a CPU profiler; the profiler's user annotations by
    name and count, and the program tracer's snapshot."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("vgqa."):
            names[e.name()] = names.get(e.name(), 0) + 1
    return names, trace.snapshot()


def _count(snap, name):
    return sum(s["name"] == name for s in snap["spans"])


def _sync_sites(snap):
    """The ``vgqa.sync`` spans by (site, the name of the span they wait in)."""
    by_id = {s["id"]: s for s in snap["spans"]}
    return dict(collections.Counter((s["attrs"]["site"], by_id[s["parent"]]["name"])
                                    for s in snap["spans"] if s["name"] == "vgqa.sync"))


def test_off_records_nothing_and_opens_no_record_function(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or trace._OFF)
    t = trace.Tracer()
    assert not t.on()
    with t.span("vgqa.a", rid=1) as rec, t.sync("site"):
        t.begin("vgqa.b").end()
        t.count("c")
    assert rec is None and opened == []
    assert t.snapshot() == {"session": None, "cuda": False, "spans": [], "counters": {},
                            "untimed_syncs": {}}
    with t.tracing():
        with t.span("vgqa.a"):
            pass
    assert opened == ["vgqa.a"]


def test_nesting_parents_self_time_and_rid():
    t = trace.Tracer()

    @t.traced("vgqa.other")
    def other():
        return 1

    with t.tracing():
        with t.span("vgqa.outer", rid=7, k=1):
            time.sleep(0.02)
            with t.span("vgqa.inner"):
                time.sleep(0.03)
        assert other() == 1
    spans = {s["name"]: s for s in t.snapshot()["spans"]}
    outer, inner, other = spans["vgqa.outer"], spans["vgqa.inner"], spans["vgqa.other"]
    assert inner["parent"] == outer["id"] and outer["parent"] is None
    assert other["parent"] is None and other["rid"] is None
    assert inner["rid"] == outer["rid"] == 7 and outer["attrs"] == {"k": 1}
    assert (outer["dev_start_ns"], outer["dev_end_ns"]) == (outer["start_ns"], outer["end_ns"])
    whole = (outer["end_ns"] - outer["start_ns"]) / 1e9
    own = trace.self_time(outer, list(spans.values()))
    assert own == pytest.approx(whole - (inner["end_ns"] - inner["start_ns"]) / 1e9)
    assert 0.015 < own < whole - 0.025


def test_cross_thread_span():
    t = trace.Tracer()
    with t.tracing():
        with t.span("vgqa.request", rid=3):
            handle = t.begin("vgqa.queue")
        worker = threading.Thread(target=handle.end)
        worker.start()
        worker.join(timeout=10)
    assert not worker.is_alive()
    spans = {s["name"]: s for s in t.snapshot()["spans"]}
    q = spans["vgqa.queue"]
    assert q["parent"] == spans["vgqa.request"]["id"] and q["rid"] == 3
    assert q["end_ns"] >= spans["vgqa.request"]["end_ns"]


def test_two_profiled_parts_are_two_sessions():
    t = trace.Tracer()

    def part(name):
        with profile(activities=[ProfilerActivity.CPU]):
            with t.span(name):
                t.count("n")
            cut = t.begin("vgqa.cut")         # ends after the part: not kept
        return cut

    part("vgqa.first").end()
    with t.span("vgqa.untraced"):
        pass
    first = t.snapshot()
    part("vgqa.second").end()
    second = t.snapshot()
    assert [s["name"] for s in first["spans"]] == ["vgqa.first"]
    assert [s["name"] for s in second["spans"]] == ["vgqa.second"]
    assert second["session"] == first["session"] + 1 and second["counters"] == {"n": 1}
    t.reset()
    assert t.snapshot()["spans"] == []


def test_record_cap_counts_dropped(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    t = trace.Tracer()
    with t.tracing():
        for _ in range(5):
            with t.span("vgqa.s"):
                pass
    snap = t.snapshot()
    assert len(snap["spans"]) == 3 and snap["counters"]["dropped"] == 2


def test_vgqa_trace_exports_json(tmp_path):
    t, at_exit = trace.Tracer(), []
    path = str(tmp_path / "spans.json")
    trace.start_from_env(t, {"VGQA_TRACE": path}, lambda fn, *a: at_exit.append((fn, a)))
    trace.start_from_env(t, {}, lambda fn, *a: at_exit.append((fn, a)))
    assert t.on() and len(at_exit) == 1
    with t.span("vgqa.a", rid=5):
        t.count("c", 2)
    fn, args = at_exit[0]
    fn(*args)
    got = json.load(open(path))
    assert [(s["name"], s["rid"]) for s in got["spans"]] == [("vgqa.a", 5)]
    assert got["counters"] == {"c": 2}


def test_syncs_count_against_the_innermost_span(recwarn):
    t = trace.Tracer()
    with t.tracing():
        with t.span("vgqa.outer"):
            with t.span("vgqa.inner"):
                warnings.warn(SYNC_WARNING)
                warnings.warn(SYNC_WARNING)
            warnings.warn(SYNC_WARNING)
            warnings.warn("an unrelated warning")
        warnings.warn(SYNC_WARNING)                     # outside every span
    spans = {s["name"]: s for s in t.snapshot()["spans"]}
    assert spans["vgqa.inner"]["syncs"] == 2 and spans["vgqa.outer"]["syncs"] == 1
    assert t.snapshot()["counters"]["syncs"] == 4
    assert [str(w.message) for w in recwarn] == ["an unrelated warning"]
    warnings.warn(SYNC_WARNING)                          # session closed: a plain warning
    assert t.snapshot()["counters"]["syncs"] == 4 and len(recwarn) == 2


class _FakeEvent:
    """A CUDA event on a fake device that runs 1 ms behind the host."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter_ns() + 1_000_000

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


def test_cuda_session_times_spans_and_restores_the_sync_mode(monkeypatch):
    modes = [0]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    t = trace.Tracer()
    with t.tracing():
        with t.span("vgqa.a"):
            time.sleep(0.01)
            with t.sync("site"):                      # a timed wait
                warnings.warn(SYNC_WARNING)
            with t.sync("quiet"):                     # no sync inside: none counted
                pass
            warnings.warn(SYNC_WARNING)               # a wait left untimed
        assert modes == [0, "warn"]
    assert modes == [0, "warn", 0]
    snap = t.snapshot()
    a, site, quiet = snap["spans"]
    assert snap["cuda"] and snap["counters"]["syncs"] == 2
    assert (a["syncs"], site["syncs"], quiet["syncs"]) == (1, 1, 0)
    assert a["dev_end_ns"] - a["dev_start_ns"] == pytest.approx(
        a["end_ns"] - a["start_ns"], abs=200_000)
    # a sync span is host-only: its device interval is its host interval
    assert (site["dev_start_ns"], site["dev_end_ns"]) == (site["start_ns"], site["end_ns"])
    (where, n), = snap["untimed_syncs"].items()
    assert n == 1 and where.startswith("tests/test_torch_trace.py:")


@pytest.fixture(scope="module")
def grounding_model():
    from vgqa_tpu_torch.config import build_default_cfg
    from vgqa_tpu_torch.inference.grounding import load_model

    cfg = build_default_cfg()
    cfg.merge_from_list(["INPUT.RESOLUTION", 32, "INPUT.TRAIN_SAMPLE_NUM", 2,
                         "MODEL.VISION_BACKBONE.NAME", "resnet_test",
                         "MODEL.VIDEO_SWIN.MODEL_NAME", "video_swin_test",
                         "MODEL.VIDEO_SWIN.FEATURE_DIM", 64, "MODEL.TEXT_MODEL.NUM_LAYERS", 1,
                         "MODEL.VSTG.HIDDEN", 32, "MODEL.VSTG.HEADS", 4,
                         "MODEL.VSTG.ENC_LAYERS", 1, "MODEL.VSTG.DEC_LAYERS", 1,
                         "MODEL.VSTG.FFN_DIM", 64, "TPU.COMPUTE_DTYPE", "float32"])
    return load_model(cfg, "", device="cpu")


def _ground_requests(n):
    rng = np.random.RandomState(0)
    return [{"frames": rng.randint(0, 256, (4, 32, 32, 3), np.uint8), "fps": 5.0,
             "ori_size": (48, 64), "query": f"a red ball rolls {i}"} for i in range(n)]


@pytest.mark.parametrize("coalesce", [False, True])
def test_predict_many_spans(grounding_model, coalesce):
    from vgqa_tpu_torch.inference.grounding import predict_many

    out = []
    names, snap = _profiled(lambda: out.extend(
        predict_many(_ground_requests(2), loaded=grounding_model, coalesce=coalesce)))
    assert all(isinstance(o, dict) for o in out)
    launches = 1 if coalesce else 2
    want = {"vgqa.ground.prepare": 2, "vgqa.ground.launch": launches,
            "vgqa.ground.fetch": launches, "vgqa.ground.merge": 2,
            "vgqa.sync": 2 + 5 * launches}
    assert {n: _count(snap, n) for n in want} == want
    assert names == want                              # each in the profiler's timeline
    # every upload and fetch is a timed wait in the phase that makes it
    assert _sync_sites(snap) == {
        ("ground.frames", "vgqa.ground.prepare"): 2,
        ("ground.text", "vgqa.ground.launch"): launches,
        ("forward.sizes", "vgqa.ground.launch"): launches,
        ("postprocess.letterbox", "vgqa.ground.launch"): launches,
        ("postprocess.neg", "vgqa.ground.launch"): launches,
        ("convert_outputs", "vgqa.ground.fetch"): launches}


def test_coalescer_spans_share_request_ids():
    from vgqa_tpu_torch.app.server import _Coalescer

    def run_batch(requests):
        for i, _ in enumerate(requests):
            with trace.span("vgqa.ground.prepare", rid=trace.request_rid(i)):
                pass
        return [r["x"] for r in requests]

    coal = _Coalescer(2, 30.0, run_batch)
    got = []

    def clients():
        threads = [threading.Thread(target=lambda k=k: got.append(coal.submit({"x": k})))
                   for k in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)

    names, snap = _profiled(clients)
    assert sorted(got) == [0, 1, 2]
    requests = [s for s in snap["spans"] if s["name"] == "vgqa.serve.request"]
    queued = [s for s in snap["spans"] if s["name"] == "vgqa.serve.queue"]
    batches = [s for s in snap["spans"] if s["name"] == "vgqa.serve.batch"]
    prepared = [s for s in snap["spans"] if s["name"] == "vgqa.ground.prepare"]
    rids = sorted(s["rid"] for s in requests)
    assert len(set(rids)) == 3
    assert sorted(s["rid"] for s in queued) == sorted(s["rid"] for s in prepared) == rids
    assert sorted(r for b in batches for r in b["attrs"]["rids"]) == rids
    assert {s["parent"] for s in queued} == {s["id"] for s in requests}
    assert "vgqa.serve.queue" not in names               # host-only: no record_function


@pytest.fixture(scope="module")
def qa_engine():
    from vgqa_tpu_torch.qa.engine import QAEngine
    from vgqa_tpu_torch.qa.llm import LLMConfig
    from vgqa_tpu_torch.qa.vit import ViTConfig

    return QAEngine.init_random(LLMConfig.tiny(), ViTConfig.tiny(), device="cpu")


def test_chat_batch_spans_and_chat_stats(qa_engine):
    from vgqa_tpu_torch.qa.engine import GenerationConfig

    eng = qa_engine
    gen = GenerationConfig(max_new_tokens=4, do_sample=False, ignore_eos=True)
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, 256, (2, 32, 32, 3), np.uint8), f"what happens {i}?")
            for i in range(3)]
    answers = []
    names, snap = _profiled(lambda: answers.extend(eng.chat_batch(reqs, gen=gen)))
    assert len(answers) == 3
    want = {"vgqa.qa.vision": 3, "vgqa.qa.prefill": 3, "vgqa.qa.decode": 1}
    assert {n: _count(snap, n) for n in want} == want
    assert {n: names[n] for n in want} == want
    assert snap["counters"]["qa.decode_steps"] == 4
    # ignore_eos: the lockstep loop reads the device once, for the tokens
    assert _sync_sites(snap) == {
        ("qa.vision.stats", "vgqa.qa.vision"): 3, ("qa.prefill.length", "vgqa.qa.prefill"): 3,
        ("qa.decode.tokens", "vgqa.qa.decode"): 1}

    text, stats = eng.chat(reqs[0][0], reqs[0][1], gen, return_stats=True)
    assert not trace.on()
    assert set(stats) == {"vision_tiles", "vision_s", "prefill_tokens", "prefill_s",
                          "prefill_tok_s", "prefill_chunked", "decode_s", "decode_tokens",
                          "decode_tok_s"}
    assert all(stats[k] > 0 for k in ("vision_s", "prefill_s", "decode_s"))
    assert text == eng.chat(reqs[0][0], reqs[0][1], gen)


def test_chat_stats_past_the_record_cap(qa_engine, monkeypatch):
    """A span past the cap is not kept, but its record still times the call."""
    from vgqa_tpu_torch.qa.engine import GenerationConfig

    monkeypatch.setattr(trace, "MAX_RECORDS", 0)
    gen = GenerationConfig(max_new_tokens=2, do_sample=False, ignore_eos=True)
    tiles = np.random.RandomState(2).randint(0, 256, (2, 32, 32, 3), np.uint8)
    _, stats = qa_engine.chat(tiles, "what happens?", gen, return_stats=True)
    assert all(stats[k] > 0 for k in ("vision_s", "prefill_s", "decode_s"))
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["counters"]["dropped"] >= 3


def test_qa_predict_many_request_ids_past_a_failed_slot(qa_engine, monkeypatch, tmp_path):
    """A request that fails preparation leaves the batch; the requests after
    it keep their own ids in the vision and prefill spans."""
    from vgqa_tpu_torch.inference import qa as qa_inference

    rng = np.random.RandomState(3)
    monkeypatch.setattr(qa_inference, "_load_engine", lambda model_dir, device=None: qa_engine)
    monkeypatch.setattr(qa_inference, "_load_tiles", lambda path, bound, size, max_num, n: (
        rng.randint(0, 256, (2, 32, 32, 3), np.uint8), [2]))
    paths = [tmp_path / "a.mp4", tmp_path / "missing.mp4", tmp_path / "c.mp4"]
    paths[0].write_bytes(b"")
    paths[2].write_bytes(b"")
    reqs = [{"video_path": str(p), "question": f"what happens {i}?", "max_new_tokens": 2}
            for i, p in enumerate(paths)]
    with trace.tracing(), trace.span("vgqa.serve.batch", rids=[11, 12, 13]):
        out = qa_inference.predict_many(reqs, device="cpu")
    assert isinstance(out[1], FileNotFoundError)
    assert isinstance(out[0]["answer"], str) and isinstance(out[2]["answer"], str)
    snap = trace.snapshot()
    for name in ("vgqa.qa.vision", "vgqa.qa.prefill"):
        assert [s["rid"] for s in snap["spans"] if s["name"] == name] == [11, 13], name


def test_fit_spans():
    from vgqa_tpu_torch.config import build_default_cfg
    from vgqa_tpu_torch.data.synthetic_batch import synthetic_batch
    from vgqa_tpu_torch.training.trainer import Trainer

    cfg = build_default_cfg()
    cfg.merge_from_list(["INPUT.RESOLUTION", 32, "INPUT.TRAIN_SAMPLE_NUM", 2,
                         "MODEL.VISION_BACKBONE.NAME", "resnet_test",
                         "MODEL.VIDEO_SWIN.MODEL_NAME", "video_swin_test",
                         "MODEL.VIDEO_SWIN.FEATURE_DIM", 64, "MODEL.TEXT_MODEL.NUM_LAYERS", 1,
                         "MODEL.VSTG.HIDDEN", 32, "MODEL.VSTG.HEADS", 4,
                         "MODEL.VSTG.ENC_LAYERS", 1, "MODEL.VSTG.DEC_LAYERS", 1,
                         "MODEL.VSTG.FFN_DIM", 64, "OUTPUT_DIR", "", "TENSORBOARD_DIR", "",
                         "SOLVER.TO_VAL", False])
    trainer = Trainer(cfg, device="cpu", seed=0)
    trainer.setup(max_iter=2)
    logged = []
    names, snap = _profiled(lambda: logged.extend(
        trainer.fit([synthetic_batch(cfg, seed=0)], 2)))
    assert [r["step"] for r in logged] == [1, 2]
    steps = {s["id"] for s in snap["spans"] if s["name"] == "vgqa.train.step"}
    assert len(steps) == 2
    for child in ("forward", "loss", "backward", "optimizer", "ema"):
        spans = [s for s in snap["spans"] if s["name"] == f"vgqa.train.{child}"]
        assert len(spans) == 2 and {s["parent"] for s in spans} == steps, child
    assert _count(snap, "vgqa.train.log") == 2 and _count(snap, "vgqa.train.allreduce") == 0
    assert {n: names[n] for n in ("vgqa.train.step", "vgqa.train.log")} == {
        "vgqa.train.step": 2, "vgqa.train.log": 2}
    assert _sync_sites(snap) == {("normalize.stats", "vgqa.train.step"): 2,
                                 ("reduce_mean", "vgqa.train.log"): 2}

"""The port's web app (``vgqa_tpu_torch.app.server``) over a real socket, on
the CPU (``DEVICE = "cpu"``, as ``--device cpu`` sets it), with
``configs/grounding_vidstg_tiny.yaml`` and QA ``__tiny__``: the cases of
``tests/test_server.py`` against the port's server, then its error mapping
(a JAX orbax checkpoint answers 500 naming the exporter, a missing model
directory 503, a job left queued past its timeout 504 and is withdrawn)."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "grounding_vidstg_tiny.yaml")


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from vgqa_tpu_torch.app import server as mod
    from vgqa_tpu_torch.data.synthetic import write_synthetic_video

    videos = tmp_path_factory.mktemp("videos")
    write_synthetic_video(str(videos / "demo.mp4"), 12, (64, 48), seed=0)
    saved = (mod.VIDEOS_ROOT, mod.QA_MODEL_DIR, mod.DEVICE, mod.GROUNDING_CONFIG,
             mod.GROUNDING_CKPT)
    mod.VIDEOS_ROOT = type(mod.VIDEOS_ROOT)(str(videos))
    mod.QA_MODEL_DIR = "__tiny__"
    mod.DEVICE = "cpu"
    mod.GROUNDING_CONFIG = TINY
    mod.GROUNDING_CKPT = ""
    srv = mod.make_server(0, "127.0.0.1")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", mod
    srv.shutdown()
    srv.server_close()
    (mod.VIDEOS_ROOT, mod.QA_MODEL_DIR, mod.DEVICE, mod.GROUNDING_CONFIG,
     mod.GROUNDING_CKPT) = saved


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def _post_error(url, body):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, body)
    return e.value.code, json.loads(e.value.read())


def test_health(server):
    base, _ = server
    assert _get(base + "/api/health") == (200, {"ok": True})


def test_videos_and_meta(server):
    base, _ = server
    _, body = _get(base + "/api/videos")
    assert body["files"] == ["demo.mp4"]
    _, meta = _get(base + "/api/meta?video=demo.mp4")
    assert meta["total_frames"] == 12 and meta["width"] == 64


def test_meta_missing_param(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/api/meta")
    assert e.value.code == 422


def test_path_traversal_blocked(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/api/meta?video=../../../etc/passwd")
    assert e.value.code in (400, 404)


def test_unknown_video_404(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/api/meta?video=nope.mp4")
    assert e.value.code == 404


def test_qa_endpoint(server):
    base, _ = server
    status, body = _post(base + "/api/qa", {"video": "demo.mp4", "question": "what moves?",
                                            "num_frames": 2, "max_tokens": 4})
    assert status == 200 and isinstance(body["answer"], str)


def test_qa_missing_fields(server):
    base, _ = server
    code, _ = _post_error(base + "/api/qa", {"video": "demo.mp4"})
    assert code == 422


def _queued_then_drained(coalescer, send, n):
    """Send ``n`` concurrent requests, let them all queue before the drain
    thread starts (it is held back as if one were running), then start it:
    it takes them in batches of its ``max_batch``."""
    results = [None] * n
    with coalescer._mutex:
        assert not coalescer._alive
        coalescer._alive = True
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, send(i)))
               for i in range(n)]
    for t in threads:
        t.start()
    for _ in range(400):
        with coalescer._mutex:
            if len(coalescer._jobs) == n:
                break
        time.sleep(0.01)
    threading.Thread(target=coalescer._drain_loop, daemon=True).start()
    for t in threads:
        t.join(timeout=280)
    return results


def test_grounding_coalesces_concurrent_requests(server, monkeypatch):
    """Concurrent /api/predict requests share one ``predict_many`` call."""
    import vgqa_tpu_torch.inference.grounding as g_mod

    base, mod = server
    batch_sizes = []
    real_many = g_mod.predict_many

    def spying_many(requests, *args, **kwargs):
        batch_sizes.append(len(requests))
        assert kwargs["device"] == "cpu"
        assert kwargs["coalesce"] is mod.GROUND_COALESCE is False   # read once at start
        return real_many(requests, *args, **kwargs)

    monkeypatch.setattr(g_mod, "predict_many", spying_many)
    results = _queued_then_drained(mod._ground_coalescer, lambda i: _post(
        base + "/api/predict", {"video": "demo.mp4", "query": f"a square {i}"}), 3)
    assert all(r is not None and r[0] == 200 for r in results)
    for _, body in results:
        assert set(body["result"]) == {"temporal", "tube"}
    assert batch_sizes == [2, 1]          # VGQA_GROUND_MAX_BATCH: pairs


def test_qa_coalesces_concurrent_requests(server, monkeypatch):
    """Concurrent /api/qa requests share one ``predict_many`` (one
    ``chat_batch``)."""
    import vgqa_tpu_torch.inference.qa as qa_mod
    from vgqa_tpu_torch.qa.engine import QAEngine

    base, mod = server
    batch_sizes, chat_batches = [], []
    real_many, real_chat_batch = qa_mod.predict_many, QAEngine.chat_batch

    def spying_many(requests, model_dir=qa_mod.DEFAULT_MODEL_DIR, device=None):
        batch_sizes.append(len(requests))
        return real_many(requests, model_dir=model_dir, device=device)

    def spying_chat_batch(self, requests, *args, **kwargs):
        chat_batches.append(len(requests))
        return real_chat_batch(self, requests, *args, **kwargs)

    monkeypatch.setattr(qa_mod, "predict_many", spying_many)
    monkeypatch.setattr(QAEngine, "chat_batch", spying_chat_batch)
    results = _queued_then_drained(mod._qa_coalescer, lambda i: _post(
        base + "/api/qa", {"video": "demo.mp4", "question": f"what moves {i}?",
                           "num_frames": 2, "max_tokens": 4}), 3)
    for status, body in results:
        assert status == 200 and "answer" in body
    assert batch_sizes == chat_batches == [3]


def test_video_range_request(server):
    base, mod = server
    full = (mod.VIDEOS_ROOT / "demo.mp4").read_bytes()
    with urllib.request.urlopen(base + "/videos/demo.mp4", timeout=30) as r:
        assert r.status == 200 and r.headers["Accept-Ranges"] == "bytes"
        assert r.read() == full

    def ranged(spec):
        req = urllib.request.Request(base + "/videos/demo.mp4", headers={"Range": spec})
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers["Content-Range"], r.read()

    assert ranged("bytes=10-29") == (206, f"bytes 10-29/{len(full)}", full[10:30])
    assert ranged(f"bytes={len(full) - 5}-")[::2] == (206, full[-5:])
    assert ranged("bytes=-7")[::2] == (206, full[-7:])
    with pytest.raises(urllib.error.HTTPError) as e:
        ranged(f"bytes={len(full) + 100}-")
    assert e.value.code == 416


def test_sibling_prefix_dir_blocked(server):
    _, mod = server
    root = mod.VIDEOS_ROOT
    sibling = type(root)(str(root) + "-private")
    sibling.mkdir(exist_ok=True)
    (sibling / "secret.mp4").write_bytes(b"x")
    try:
        with pytest.raises(mod.HTTPError) as e:
            mod._safe_join_video(f"../{sibling.name}/secret.mp4")
        assert e.value.status == 400
    finally:
        (sibling / "secret.mp4").unlink()
        sibling.rmdir()


def test_index_served(server):
    base, _ = server
    with urllib.request.urlopen(base + "/", timeout=30) as r:
        html = r.read().decode()
    assert "VGQA" in html and "runGrounding" in html


def test_parse_queries_from_answer(server):
    _, mod = server
    numbered = ("Here are queries:\n1. a person walking left\n2) a red ball rolling\n"
                "- someone waving hand\n3. hi\n")
    assert mod._parse_queries_from_answer(numbered) == [
        "a person walking left", "a red ball rolling", "someone waving hand"]
    fallback = mod._parse_queries_from_answer("The person walks to the door. Then he waves. ok.")
    assert "The person walks to the door" in fallback and "ok" not in fallback
    assert mod._parse_queries_from_answer("") == []


def test_generate_queries_endpoint(server):
    base, _ = server
    status, body = _post(base + "/api/generate-queries",
                         {"video": "demo.mp4", "num_queries": 3, "num_frames": 2,
                          "max_tokens": 8})
    assert status == 200 and isinstance(body["queries"], list)
    assert isinstance(body["raw_answer"], str)


def test_predict_endpoint_tiny(server):
    base, _ = server
    status, body = _post(base + "/api/predict", {"video": "demo.mp4", "query": "a square"})
    assert status == 200
    assert body["video"] == {"name": "demo.mp4", "url": "/videos/demo.mp4"}
    assert body["meta"]["total_frames"] == 12
    t = body["result"]["temporal"]
    assert 0 <= t["start"] <= t["end"] and len(body["result"]["tube"]) > 0


def test_orbax_checkpoint_answers_500_naming_the_exporter(server, tmp_path, monkeypatch):
    base, mod = server
    (tmp_path / "model_final_params").mkdir()
    monkeypatch.setattr(mod, "GROUNDING_CKPT", str(tmp_path / "model_final_params"))
    code, body = _post_error(base + "/api/predict", {"video": "demo.mp4", "query": "a"})
    assert code == 500 and "ValueError" in body["detail"]
    assert "export_torch_checkpoint.py grounding" in body["detail"]


def test_missing_model_dir_503_and_queue_timeout_504(server, tmp_path, monkeypatch):
    import vgqa_tpu_torch.inference.qa as qa_mod

    base, mod = server
    monkeypatch.setattr(mod, "QA_MODEL_DIR", str(tmp_path / "absent"))
    code, body = _post_error(base + "/api/qa", {"video": "demo.mp4", "question": "q"})
    assert code == 503 and "not found" in body["detail"]

    # jobs that cannot reach the device in time answer 504; the one still
    # queued is withdrawn, so the drain runs only the one it had taken
    batch_sizes = []
    real_many = qa_mod.predict_many
    monkeypatch.setattr(qa_mod, "predict_many", lambda reqs, **kw: (
        batch_sizes.append(len(reqs)), real_many(reqs, **kw))[1])
    monkeypatch.setattr(mod._qa_coalescer, "timeout_s", 1.0)
    coal = mod._qa_coalescer
    assert mod._infer_lock.acquire(blocking=False)
    try:
        results = [None, None]
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, _post_error(
            base + "/api/qa", {"video": "demo.mp4", "question": f"q{i}"}))) for i in range(2)]
        threads[0].start()
        for _ in range(600):              # the drain has taken the first job
            with coal._mutex:
                if coal._alive and not coal._jobs:
                    break
            time.sleep(0.005)
        threads[1].start()                # so the second stays queued
        for t in threads:
            t.join(timeout=60)
        with coal._mutex:
            queued = len(coal._jobs)
    finally:
        mod._infer_lock.release()
    for _ in range(200):
        with coal._mutex:
            if not coal._alive:
                break
        time.sleep(0.05)
    assert [r[0] for r in results] == [504, 504] and queued == 0
    assert results[0][1]["detail"] == "request timed out in queue"
    assert batch_sizes == [1]


def test_coalescer_under_contention(server):
    """Many threads against one coalescer (no model, a shortened switch
    interval): every caller gets its own answer, no batch exceeds
    ``max_batch``, every job runs once, and a failing slot fails only its
    caller."""
    import sys

    _, mod = server
    ran = []

    def run_batch(reqs):
        ran.append(len(reqs))
        time.sleep(0.001)
        return [ValueError("odd") if r % 7 == 3 else r * r for r in reqs]

    coal = mod._Coalescer(3, 30.0, run_batch)
    n = 48
    results = [None] * n
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def call(i):
            try:
                results[i] = coal.submit(i)
            except mod.HTTPError as e:
                results[i] = (e.status, e.message)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert results == [(500, "ValueError: odd") if i % 7 == 3 else i * i for i in range(n)]
    assert sum(ran) == n and max(ran) <= 3


"""VGQA web interface over the port (counterpart of ``app/server.py``).

    python -m vgqa_tpu_torch.app.server [--port N] [--device cpu]

The same endpoints, environment variables and JSON as the JAX package's
server, on the standard library's ``ThreadingHTTPServer``:

* GET ``/api/health``, ``/api/videos[?dir=]``, ``/api/meta?video=``,
  ``/videos/<name>`` (with ``Range`` requests, so the browser can seek), and
  ``/`` or ``/app/...``, the single-page UI read from ``app/static/`` at the
  repository root;
* POST ``/api/predict`` {video, query}, ``/api/qa`` {video, question,
  [bound_start, bound_end, num_frames, max_tokens]} and
  ``/api/generate-queries`` {video, [num_queries, num_frames, max_tokens]}.

Video names resolve strictly inside ``VGQA_VIDEOS_DIR`` (a sibling directory
sharing its prefix is outside). Both inference endpoints coalesce concurrent
requests: each handler thread queues a job and waits; a drain thread takes
up to ``VGQA_{GROUND,QA}_MAX_BATCH`` queued jobs (2 and 4) into one call of
``inference.grounding.predict_many`` (pairs of videos; one V = 2N forward
each under ``VGQA_GROUND_COALESCE=1``, read at start as
``GROUND_COALESCE``) or ``inference.qa.predict_many`` (one
lockstep batched decode), holding ``_infer_lock``, so one thread at a time
drives the device. A job still queued after ``VGQA_{GROUND,QA}_TIMEOUT_S``
is withdrawn and answers 504; a request that fails in its own slot answers
500, a missing model directory 503.

Models: ``VGQA_GROUNDING_CONFIG`` (``configs/grounding_vidstg.yaml``) with
the state dict ``VGQA_GROUNDING_CKPT`` (``checkpoints/grounding/vidstg.pt``;
seeded random weights if it is absent, 500 naming the exporter if it is a
JAX orbax directory), and ``VGQA_QA_MODEL_DIR`` (see ``inference/qa``). They
are built on the first request, on the card unless ``--device cpu``
(``DEVICE``). ``VGQA_SERVER_VERBOSE`` logs each request.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence
from urllib.parse import parse_qs, urlparse

from ..inference import grounding as grounding_inference
from ..inference import qa as qa_inference

PROJECT_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_VIDEOS = PROJECT_ROOT / "videos"
VIDEOS_ROOT = Path(os.getenv("VGQA_VIDEOS_DIR", str(DEFAULT_VIDEOS))).resolve()
STATIC_DIR = PROJECT_ROOT / "app" / "static"

GROUNDING_CONFIG = os.getenv("VGQA_GROUNDING_CONFIG", grounding_inference.DEFAULT_CONFIG_PATH)
GROUNDING_CKPT = os.getenv("VGQA_GROUNDING_CKPT", grounding_inference.DEFAULT_CHECKPOINT_PATH)
QA_MODEL_DIR = os.getenv("VGQA_QA_MODEL_DIR", qa_inference.DEFAULT_MODEL_DIR)
DEVICE: Optional[str] = None        # the card; "cpu" to serve on the CPU
GROUND_COALESCE = grounding_inference.coalesce_from_env()

# one inference at a time: the thread that holds it is the one on the device
_infer_lock = threading.Lock()


class HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _contained(p: Path, root: Path) -> bool:
    # strict containment: a string prefix check would admit a sibling
    # directory that shares the prefix (videos-private next to videos)
    return p == root or p.is_relative_to(root)


def _safe_join_video(name: str) -> Path:
    p = (VIDEOS_ROOT / name).resolve()
    if not _contained(p, VIDEOS_ROOT):
        raise HTTPError(400, "Invalid path")
    if not p.exists() or not p.is_file():
        raise HTTPError(404, "Video not found")
    return p


def _list_videos_in(dir_path: Optional[str]) -> List[str]:
    base = (VIDEOS_ROOT if not dir_path else VIDEOS_ROOT / dir_path).resolve()
    if not _contained(base, VIDEOS_ROOT):
        raise HTTPError(400, "Invalid directory")
    if not base.exists():
        return []
    exts = {".mp4", ".avi", ".mov", ".mkv", ".webm"}
    return sorted(f.name for f in base.iterdir() if f.is_file() and f.suffix.lower() in exts)


def _video_meta(path: Path) -> Dict[str, Any]:
    from ..data.video_io import video_info

    total, fps, w, h = video_info(str(path))
    return {"fps": fps, "total_frames": total, "width": w, "height": h}


def _parse_queries_from_answer(answer: str) -> List[str]:
    """Grounding queries from a QA answer: numbered or bulleted lines (more
    than 5 characters), else sentences of 11-99 characters; at most 20."""
    queries: List[str] = []
    patterns = [r"^\d+[\.)]\s*(.+)$", r"^[-•]\s*(.+)$"]
    for line in answer.split("\n"):
        line = line.strip()
        if not line:
            continue
        for pattern in patterns:
            m = re.match(pattern, line)
            if m:
                q = m.group(1).strip().strip("\"'.,:")
                if q and len(q) > 5:
                    queries.append(q)
                break
    if not queries and answer:
        for sentence in re.split(r"[.!?]\s+", answer):
            sentence = sentence.strip()
            if 10 < len(sentence) < 100:
                queries.append(sentence)
    return queries[:20]


class _Coalescer:
    """Queue + drain-thread request coalescer around a batched runner.

    ``run_batch(requests) -> list[result | Exception]`` runs one drained
    batch (aligned with its input); an Exception in a slot fails only its
    own caller."""

    def __init__(self, max_batch: int, timeout_s: float, run_batch):
        self.max_batch = max(1, max_batch)
        self.timeout_s = timeout_s
        self.run_batch = run_batch
        self._jobs: List[Dict[str, Any]] = []
        self._mutex = threading.Lock()
        self._alive = False

    def _run_jobs(self, jobs: List[Dict[str, Any]]) -> None:
        try:
            with _infer_lock:
                results = self.run_batch([j["request"] for j in jobs])
            for job, res in zip(jobs, results):
                if isinstance(res, Exception):
                    job["error"] = res
                else:
                    job["result"] = res
        except Exception as e:  # noqa: BLE001 - a failed batch fails its jobs
            for job in jobs:
                if job["result"] is None and job["error"] is None:
                    job["error"] = e
        finally:
            for job in jobs:
                job["done"].set()

    def _drain_loop(self) -> None:
        while True:
            with self._mutex:
                if not self._jobs:
                    self._alive = False
                    return
                batch = self._jobs[: self.max_batch]
                del self._jobs[: self.max_batch]
            self._run_jobs(batch)

    def submit(self, request: Dict[str, Any]) -> Dict[str, Any]:
        job: Dict[str, Any] = {"request": request, "done": threading.Event(),
                               "result": None, "error": None}
        with self._mutex:
            self._jobs.append(job)
            if not self._alive:
                self._alive = True
                threading.Thread(target=self._drain_loop, daemon=True).start()
        if not job["done"].wait(timeout=self.timeout_s):
            # withdraw a job that is still queued, so no slot of the device
            # computes an answer nobody reads (one in flight is discarded)
            with self._mutex:
                try:
                    self._jobs.remove(job)
                except ValueError:
                    pass
            raise HTTPError(504, "request timed out in queue")
        if job["error"] is not None:
            err = job["error"]
            # HTTPError and FileNotFoundError keep their own status
            # (do_POST: a missing model directory is 503)
            if isinstance(err, (HTTPError, FileNotFoundError)):
                raise err
            raise HTTPError(500, f"{type(err).__name__}: {err}")
        return job["result"]


def _run_qa_batch(requests: List[Dict[str, Any]]) -> List[Any]:
    return qa_inference.predict_many(requests, model_dir=QA_MODEL_DIR, device=DEVICE)


def _run_ground_batch(requests: List[Dict[str, Any]]) -> List[Any]:
    return grounding_inference.predict_many(requests, GROUNDING_CONFIG, GROUNDING_CKPT,
                                            device=DEVICE, coalesce=GROUND_COALESCE)


_qa_coalescer = _Coalescer(int(os.getenv("VGQA_QA_MAX_BATCH", "4")),
                           float(os.getenv("VGQA_QA_TIMEOUT_S", "600")), _run_qa_batch)
_ground_coalescer = _Coalescer(int(os.getenv("VGQA_GROUND_MAX_BATCH", "2")),
                               float(os.getenv("VGQA_GROUND_TIMEOUT_S", "600")),
                               _run_ground_batch)


def _submit_qa(request: Dict[str, Any]) -> Dict[str, Any]:
    return _qa_coalescer.submit(request)


# -- endpoints ----------------------------------------------------------------------
def handle_health() -> Dict[str, Any]:
    return {"ok": True}


def handle_videos(dir_path: Optional[str]) -> Dict[str, Any]:
    return {"directory": str(VIDEOS_ROOT), "files": _list_videos_in(dir_path)}


def handle_meta(video: str) -> Dict[str, Any]:
    return _video_meta(_safe_join_video(video))


def handle_predict(body: Dict[str, Any]) -> Dict[str, Any]:
    path = _safe_join_video(body["video"])
    meta = _video_meta(path)
    res = _ground_coalescer.submit({"video_path": str(path), "query": body["query"]})
    return {"video": {"name": path.name, "url": f"/videos/{path.name}"}, "meta": meta,
            "result": res}


def handle_qa(body: Dict[str, Any]) -> Dict[str, Any]:
    path = _safe_join_video(body["video"])
    bound = None
    if body.get("bound_start") is not None and body.get("bound_end") is not None:
        bound = (body["bound_start"], body["bound_end"])
    return _submit_qa({"video_path": str(path), "question": body["question"], "bound": bound,
                       "num_frames": body.get("num_frames", 32),
                       "max_new_tokens": body.get("max_tokens", 256)})


def generate_queries_question(num_queries: int) -> str:
    """The question /api/generate-queries asks the QA model."""
    return (f"Generate {num_queries} text queries for video grounding. Each query should be "
            "a short phrase describing a visible action (e.g., 'a person walking to the "
            "left', 'a red ball rolling', 'someone waving hand'). List them numbered.")


def handle_generate_queries(body: Dict[str, Any]) -> Dict[str, Any]:
    path = _safe_join_video(body["video"])
    question = generate_queries_question(body.get("num_queries", 10))
    res = _submit_qa({"video_path": str(path), "question": question, "bound": None,
                      "num_frames": body.get("num_frames", 64),
                      "max_new_tokens": body.get("max_tokens", 300)})
    answer = res.get("answer", "")
    return {"queries": _parse_queries_from_answer(answer), "raw_answer": answer}


# -- HTTP plumbing --------------------------------------------------------------------
class Handler(BaseHTTPRequestHandler):
    server_version = "VGQA/0.1"

    def _send_json(self, obj: Any, status: int = 200):
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_file(self, path: Path, content_type: str, ranged: bool = False):
        """Stream a file in constant memory; with ``ranged``, answer a
        ``Range: bytes=`` header with 206 and ``Content-Range`` (416 when
        it cannot be satisfied)."""
        size = path.stat().st_size
        start, end = 0, size - 1
        status = 200
        range_header = self.headers.get("Range") if ranged else None
        if range_header:
            m = re.match(r"bytes=(\d*)-(\d*)$", range_header.strip())
            if not m or (not m.group(1) and not m.group(2)):
                return self._send_json({"detail": "invalid Range"}, 416)
            if m.group(1):
                start = int(m.group(1))
                end = int(m.group(2)) if m.group(2) else size - 1
            else:                   # a suffix range: the last N bytes
                start = max(0, size - int(m.group(2)))
            end = min(end, size - 1)
            if start >= size or start > end:
                self.send_response(416)
                self.send_header("Content-Range", f"bytes */{size}")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            status = 206
        length = end - start + 1
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(length))
        if ranged:
            self.send_header("Accept-Ranges", "bytes")
        if status == 206:
            self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
        self.end_headers()
        with path.open("rb") as f:
            f.seek(start)
            remaining = length
            while remaining > 0:
                chunk = f.read(min(1 << 20, remaining))
                if not chunk:
                    break
                self.wfile.write(chunk)
                remaining -= len(chunk)

    def log_message(self, fmt, *args):
        if os.getenv("VGQA_SERVER_VERBOSE"):
            super().log_message(fmt, *args)

    def do_GET(self):
        url = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        try:
            if url.path in ("/", "/app", "/app/"):
                index = STATIC_DIR / "index.html"
                if index.exists():
                    return self._send_file(index, "text/html")
                return self._send_json({"message": "Static UI not found."})
            if url.path == "/api/health":
                return self._send_json(handle_health())
            if url.path == "/api/videos":
                return self._send_json(handle_videos(q.get("dir")))
            if url.path == "/api/meta":
                if "video" not in q:
                    raise HTTPError(422, "missing required query param: video")
                return self._send_json(handle_meta(q["video"]))
            if url.path.startswith("/videos/"):
                p = _safe_join_video(url.path[len("/videos/"):])
                return self._send_file(p, "video/mp4", ranged=True)
            if url.path.startswith("/app/"):
                p = (STATIC_DIR / url.path[len("/app/"):]).resolve()
                if not _contained(p, STATIC_DIR) or not p.is_file():
                    raise HTTPError(404, "Not found")
                return self._send_file(p, "text/html" if p.suffix == ".html" else "text/plain")
            raise HTTPError(404, "Not found")
        except HTTPError as e:
            self._send_json({"detail": e.message}, e.status)
        except Exception as e:  # noqa: BLE001
            self._send_json({"detail": f"{type(e).__name__}: {e}"}, 500)

    def do_POST(self):
        url = urlparse(self.path)
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            routes = {"/api/predict": (handle_predict, ("video", "query")),
                      "/api/qa": (handle_qa, ("video", "question")),
                      "/api/generate-queries": (handle_generate_queries, ("video",))}
            if url.path not in routes:
                raise HTTPError(404, "Not found")
            fn, required = routes[url.path]
            missing = [k for k in required if k not in body]
            if missing:
                raise HTTPError(422, f"missing required fields: {missing}")
            return self._send_json(fn(body))
        except HTTPError as e:
            self._send_json({"detail": e.message}, e.status)
        except json.JSONDecodeError:
            self._send_json({"detail": "invalid JSON body"}, 400)
        except FileNotFoundError as e:
            self._send_json({"detail": str(e)}, 503)
        except Exception as e:  # noqa: BLE001
            self._send_json({"detail": f"Inference failed: {type(e).__name__}: {e}"}, 500)


def make_server(port: int = 8000, host: str = "0.0.0.0") -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), Handler)


def main(argv: Optional[Sequence[str]] = None) -> int:
    global DEVICE
    parser = argparse.ArgumentParser(description="VGQA web interface (PyTorch port)")
    parser.add_argument("--port", type=int, default=int(os.getenv("PORT", "8000")))
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    DEVICE = args.device
    srv = make_server(args.port, args.host)
    print(f"VGQA server listening on {args.host}:{srv.server_address[1]} "
          f"(videos: {VIDEOS_ROOT}, device: {DEVICE or 'cuda'})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's tracer: spans and counters at its layer boundaries.

    from vgqa_tpu_torch.utils import trace

    with trace.span("vgqa.qa.prefill", rid=rid):      # one thread
        ...
    queued = trace.begin("vgqa.serve.queue", rid=rid)  # ends in another thread
    queued.end()
    trace.count("qa.decode_steps", steps)
    with trace.sync("convert_outputs"):                # a host wait on the device
        host = t.cpu()

``traced(name)`` is ``span``'s decorator form: each call of the function
opens the span.

**When it is on.** After ``enable()`` (until the matching ``disable()``;
``tracing()`` is the pair as a context manager), for the whole process
under ``VGQA_TRACE=<path>`` (``snapshot()`` is written to that path as JSON
at exit), and while a ``torch.profiler`` is recording. Off, a span costs
a flag check and returns a shared null context: no record, no CUDA event,
no ``record_function``.

**What a span records.** Its name, host start and end
(``time.perf_counter_ns``), its parent (the innermost open span of its
thread), its thread, its request id (``rid``; inherited from the parent
when not given) and keyword attributes. A same-thread span also opens
``torch.profiler.record_function(name)``, so it sits in the profiler's
timeline beside the kernels, and, once CUDA is initialized, records a
CUDA event pair on the current stream; ``snapshot()`` resolves the pairs after
one synchronize into device intervals, on the host clock from a reference
event recorded when the session began (on the CPU the device interval is
the host interval). Cross-thread spans (``begin``) and ``sync`` spans are
host-only.

**Sessions.** A session opens at the first span or count while tracing is
on and ends when a span is entered, or a traced span or a sync ends, while
it is off; the next one starts empty. A span belongs to the session it
was entered in, and only spans that begin and end inside one session are
kept, so two traced parts of one process never mix. ``snapshot()`` returns
the newest session; ``reset()`` empties it.

**Syncs.** While a session is open CUDA's sync debug mode is ``warn`` and
its warning is routed here (never printed): each synchronizing CUDA call
adds one to the counter ``syncs`` and to the ``syncs`` of the innermost
open span of its thread. torch hands the warning over only once the call
has returned, so the wait itself is timed by the program: each of its
synchronizing calls (a device-to-host read, an upload from pageable host
memory) sits inside ``sync(site)``, a ``vgqa.sync`` span (a child of the
span it waits in) whose host interval is the wait. A sync counted outside
every ``vgqa.sync`` span is a wait left untimed: ``snapshot()`` lists it
under ``untimed_syncs`` by call site (``dir/file.py:line``).

**Bounds.** At most ``MAX_RECORDS`` spans per session; past that a span is
not kept (its record still serves the caller: ``device_s`` reads it) and
the counter ``dropped`` grows.
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import itertools
import json
import os
import sys
import threading
import time
import warnings
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SYNC_SPAN = "vgqa.sync"
MAX_RECORDS = 200_000
_SYNC_MESSAGE = "called a synchronizing CUDA operation"

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _profiling() -> bool:
        return _autograd_profiler._is_profiler_enabled
else:                                        # older torch: the C flag
    _profiling = torch._C._autograd._profiler_enabled


class _Off:
    """The shared null span (a context manager that records nothing)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def end(self) -> None:
        pass


_OFF = _Off()


class _Record:
    __slots__ = ("id", "name", "parent", "thread", "rid", "attrs", "start", "end", "syncs",
                 "events", "dev", "session")

    def __init__(self, sid, name, parent, rid, attrs):
        self.id = next(_ids)
        self.session = sid
        self.name = name
        self.parent = parent
        self.thread = threading.get_ident()
        self.rid = rid
        self.attrs = attrs
        self.start = time.perf_counter_ns()
        self.end = None
        self.syncs = 0
        self.events = None
        self.dev = None


_ids = itertools.count(1)
_rids = itertools.count(1)


class _Session:
    def __init__(self, sid: int):
        self.id = sid
        self.cuda = False                  # CUDA in use: device intervals, syncs
        self.records: List[_Record] = []
        self.counters: Dict[str, int] = {}
        self.ref = None                    # CUDA event at the session's start
        self.ref_ns = 0
        self.sync_mode = None              # the debug mode to restore
        self.sync_filter = None
        self.show = None                   # the warnings.showwarning replaced
        self.untimed: Dict[str, int] = {}  # syncs outside vgqa.sync, by call site


class _Span:
    """A same-thread span while tracing is on."""

    __slots__ = ("tracer", "session", "name", "rid", "attrs", "rec", "rf", "site")

    def __init__(self, tracer, session, name, rid, attrs, site=False):
        self.tracer, self.session, self.name = tracer, session, name
        self.rid, self.attrs, self.site = rid, attrs, site
        self.rec = self.rf = None

    def __enter__(self):
        t, s = self.tracer, self.session
        stack = t._stack()
        parent = stack[-1] if stack and stack[-1].session == s.id else None
        rec = t._new_record(s, self.name, parent, self.rid, self.attrs)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        cuda = s.cuda or (torch.cuda.is_initialized() and t._use_cuda(s))
        if cuda and not self.site:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            rec.events = (e0, None)
        rec.start = time.perf_counter_ns()
        stack.append(rec)
        self.rec = rec
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        end = time.perf_counter_ns()
        t, s = self.tracer, self.session
        if rec.events is not None:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            rec.events = (rec.events[0], e1)
        self.rf.__exit__(*exc)
        stack = t._stack()
        if rec in stack:
            del stack[stack.index(rec):]
        if t._still(s):
            rec.end = end
        return False


class _Handle:
    """A cross-thread span: ``end()`` may be called from any thread."""

    __slots__ = ("tracer", "session", "rec")

    def __init__(self, tracer, session, rec):
        self.tracer, self.session, self.rec = tracer, session, rec

    def end(self) -> None:
        rec = self.rec
        if rec is not None and rec.end is None and self.tracer._still(self.session):
            rec.end = time.perf_counter_ns()


class Tracer:
    """Spans and counters of one process (the module-level functions are
    the default tracer's methods)."""

    def __init__(self):
        self._forced = 0
        self._lock = threading.RLock()
        self._local = threading.local()
        self._session: Optional[_Session] = None     # the open session
        self._newest: Optional[_Session] = None      # the open or last closed one
        self._sids = itertools.count(1)
        self._quiet = False

    # -- on and off -------------------------------------------------------------
    def on(self) -> bool:
        return bool(self._forced) or _profiling()

    def enable(self) -> None:
        with self._lock:
            self._forced += 1

    def disable(self) -> None:
        with self._lock:
            self._forced = max(0, self._forced - 1)
            if not self.on():
                self._close()

    @contextlib.contextmanager
    def tracing(self):
        """Tracing on inside the block (in the session that is open, or a
        new one)."""
        self.enable()
        try:
            yield self
        finally:
            self.disable()

    # -- recording --------------------------------------------------------------
    def span(self, name: str, rid: Optional[int] = None, **attrs):
        """A same-thread span (context manager; its ``__enter__`` returns the
        record, or None while tracing is off)."""
        if self._off():
            return _OFF
        return _Span(self, self._session or self._open(), name, rid, attrs)

    def traced(self, name: str, **attrs):
        """``span`` as a decorator: each call of the function opens it."""
        def wrap(fn):
            @functools.wraps(fn)
            def inner(*args, **kwargs):
                with self.span(name, **attrs):
                    return fn(*args, **kwargs)
            return inner
        return wrap

    def begin(self, name: str, rid: Optional[int] = None, **attrs):
        """A span that may end in another thread: call ``end()`` on the
        handle. Host-only; a child of this thread's innermost open span."""
        if self._off():
            return _OFF
        s = self._session or self._open()
        stack = self._stack()
        parent = stack[-1] if stack and stack[-1].session == s.id else None
        return _Handle(self, s, self._new_record(s, name, parent, rid, attrs))

    def sync(self, site: str):
        """A ``vgqa.sync`` span around a host wait on the device (host-only:
        its interval is the wait)."""
        if self._off():
            return _OFF
        return _Span(self, self._session or self._open(), SYNC_SPAN, None, {"site": site},
                     site=True)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` of the open session."""
        if self._off():
            return
        s = self._session or self._open()
        with self._lock:
            s.counters[name] = s.counters.get(name, 0) + n

    def new_rid(self) -> int:
        """A fresh request id."""
        return next(_rids)

    def request_rid(self, i: int) -> Optional[int]:
        """The id of request ``i`` of the batch that the innermost open span
        of this thread carrying ``rids`` names; None if there is none."""
        if self._off():
            return None
        for rec in reversed(self._stack()):
            rids = rec.attrs.get("rids")
            if rids is not None:
                return rids[i] if 0 <= i < len(rids) else None
        return None

    # -- reading ----------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The newest session: ``spans`` (those that began and ended in it,
        with host and device intervals in ns and their ``syncs``),
        ``counters`` (``dropped`` among them), ``untimed_syncs`` (by call
        site), ``session`` and ``cuda``."""
        self._off()
        s = self._newest
        if s is None:
            return {"session": None, "cuda": False, "spans": [], "counters": {},
                    "untimed_syncs": {}}
        with self._lock:
            recs = [r for r in s.records if r.end is not None]
            counters = dict(s.counters)
            untimed = dict(s.untimed)
        self._resolve(s, recs)
        spans = [{"id": r.id, "name": r.name, "parent": r.parent.id if r.parent else None,
                  "thread": r.thread, "rid": r.rid, "start_ns": r.start, "end_ns": r.end,
                  "dev_start_ns": r.dev[0], "dev_end_ns": r.dev[1], "syncs": r.syncs,
                  "attrs": r.attrs} for r in recs]
        return {"session": s.id, "cuda": s.cuda, "spans": spans, "counters": counters,
                "untimed_syncs": untimed}

    def reset(self) -> None:
        """Empty the newest session's spans and counters."""
        with self._lock:
            if self._newest is not None:
                self._newest.records = []
                self._newest.counters = {}
                self._newest.untimed = {}

    def device_s(self, rec) -> float:
        """Seconds of a finished span record's device interval (its host
        interval on the CPU); synchronizes once if its events are pending."""
        if rec.events is not None:
            s = self._session if self._session and self._session.id == rec.session \
                else self._newest
            self._resolve(s, [rec])
        dev = rec.dev or (rec.start, rec.end)
        return (dev[1] - dev[0]) / 1e9

    def export(self, path: str) -> None:
        """Write ``snapshot()`` to ``path`` as JSON."""
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, default=str)

    # -- internals --------------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _off(self) -> bool:
        """Whether tracing is off (closing the session that is open)."""
        if self._forced or _profiling():
            return False
        if self._session is not None:
            self._close()
        return True

    def _still(self, s: _Session) -> bool:
        """Whether ``s`` is still the open session with tracing on."""
        return not self._off() and self._session is s

    def _new_record(self, s: _Session, name, parent, rid, attrs) -> _Record:
        if rid is None and parent is not None:
            rid = parent.rid
        rec = _Record(s.id, name, parent, rid, attrs)
        with self._lock:
            if len(s.records) < MAX_RECORDS:
                s.records.append(rec)
            else:
                s.counters["dropped"] = s.counters.get("dropped", 0) + 1
        return rec

    def _open(self) -> _Session:
        with self._lock:
            if self._session is not None:
                return self._session
            s = _Session(next(self._sids))
            warnings.filterwarnings("always", message=".*" + _SYNC_MESSAGE,
                                    category=UserWarning)
            s.sync_filter = warnings.filters[0]
            s.show = warnings.showwarning
            warnings.showwarning = self._show
            self._session = self._newest = s
            if torch.cuda.is_initialized():
                self._use_cuda(s)
            return s

    def _use_cuda(self, s: _Session) -> bool:
        """Time the session's spans on the device and count its syncs, from
        the first span after CUDA is initialized."""
        with self._lock:
            if not s.cuda and self._session is s:
                s.ref = torch.cuda.Event(enable_timing=True)
                s.ref.record()
                s.ref_ns = time.perf_counter_ns()
                s.sync_mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
                s.cuda = True
        return s.cuda

    def _close(self) -> None:
        with self._lock:
            s = self._session
            if s is None:
                return
            self._session = None
            if s.cuda:
                torch.cuda.set_sync_debug_mode(s.sync_mode)
            if warnings.showwarning == self._show:
                warnings.showwarning = s.show
            with contextlib.suppress(ValueError):
                warnings.filters.remove(s.sync_filter)
                getattr(warnings, "_filters_mutated", lambda: None)()

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if issubclass(category, UserWarning) and _SYNC_MESSAGE in str(message):
            s = self._session
            if s is not None and not self._quiet and self._still(s):
                stack = self._stack()
                rec = stack[-1] if stack and stack[-1].session == s.id else None
                with self._lock:
                    s.counters["syncs"] = s.counters.get("syncs", 0) + 1
                    if rec is not None:
                        rec.syncs += 1
                    if rec is None or rec.name != SYNC_SPAN:
                        site = "/".join(filename.replace(os.sep, "/").split("/")[-2:])
                        site = f"{site}:{lineno}"
                        s.untimed[site] = s.untimed.get(site, 0) + 1
            return
        show = self._session.show if self._session is not None else warnings._showwarning_orig
        show(message, category, filename, lineno, file, line)

    def _resolve(self, s: Optional[_Session], recs: Iterable[_Record]) -> None:
        pending = [r for r in recs if r.events is not None and r.events[1] is not None]
        for r in recs:
            if r.dev is None and r.events is None and r.end is not None:
                r.dev = (r.start, r.end)
        if not pending:
            return
        self._quiet = True
        try:
            torch.cuda.synchronize()
        finally:
            self._quiet = False
        for r in pending:
            e0, e1 = r.events
            r.dev = (s.ref_ns + round(s.ref.elapsed_time(e0) * 1e6),
                     s.ref_ns + round(s.ref.elapsed_time(e1) * 1e6))
            r.events = None


def self_time(span: Dict[str, Any], spans: Optional[List[Dict[str, Any]]] = None) -> float:
    """Seconds of ``span``'s host interval that none of its children (in
    ``spans``, by default the newest session's) covers."""
    if spans is None:
        spans = snapshot()["spans"]
    s0, s1 = span["start_ns"], span["end_ns"]
    cover = sorted((max(c["start_ns"], s0), min(c["end_ns"], s1)) for c in spans
                   if c["parent"] == span["id"])
    covered, reach = 0, s0
    for a, b in cover:
        a = max(a, reach)
        if b > a:
            covered += b - a
            reach = b
    return (s1 - s0 - covered) / 1e9


_TRACER = Tracer()
on = _TRACER.on
enable = _TRACER.enable
disable = _TRACER.disable
tracing = _TRACER.tracing
span = _TRACER.span
traced = _TRACER.traced
begin = _TRACER.begin
sync = _TRACER.sync
count = _TRACER.count
new_rid = _TRACER.new_rid
request_rid = _TRACER.request_rid
snapshot = _TRACER.snapshot
reset = _TRACER.reset
device_s = _TRACER.device_s


def _export_at_exit(tracer: Tracer, path: str) -> None:
    try:
        tracer.export(path)
    except (OSError, RuntimeError) as e:
        print(f"VGQA_TRACE: could not write {path}: {e}", file=sys.stderr)


def start_from_env(tracer: Tracer, environ=os.environ, register=atexit.register) -> None:
    """``VGQA_TRACE=<path>``: turn ``tracer`` on and write its snapshot to
    the path at exit (run once, when this module is imported)."""
    path = environ.get("VGQA_TRACE")
    if path:
        tracer.enable()
        register(_export_at_exit, tracer, path)


start_from_env(_TRACER)

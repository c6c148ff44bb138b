"""The port's tracer: host spans and counts at the boundaries of its layers.

Off by default. ``enable()`` starts a recording, ``disable()`` stops it,
``snapshot()`` returns what was recorded and ``write_chrome_trace(path)``
writes it for chrome://tracing or Perfetto. While off, ``span()`` returns
one shared no-op object: a span costs one flag check, with no clock read,
no allocation and no device synchronisation.

A span records its name, start and end on ``time.perf_counter_ns`` (the
clock of the timing ledger, utils/results.py), the id of its parent span,
its thread, a request id and small integer counts. The request id is the
BO iteration in the loop (``bo.iteration`` sets it) and a fresh evidence
number for each ``nested_sampling`` call; a span without one takes its
parent's, and a thread's first span takes what ``adopt()`` gave the thread
(the MC-pool refresh thread adopts the iteration that started it). A span
opened with ``sync=True`` closes a layer's device work: it synchronises the
current CUDA stream before it reads its end. Counts are host integers
(``Span.count``, or ``count()`` into the thread's innermost open span),
never read from the device.

Closed spans go to a buffer of at most ``cap`` records; past it they are
counted as dropped, and a reader refuses a snapshot that dropped any.
``enable()`` also takes the clock anchor that places the spans on the Unix
clock (a device trace's clock): the tightest of a few back-to-back
(``time.time_ns``, ``perf_counter_ns``) pairs.
"""
from __future__ import annotations

import functools
import itertools
import json
import os
import sys
import threading
import time
from typing import Any, Dict, NamedTuple, Optional

_on = False
_rec = None             # the current recording (_Recording)
_local = threading.local()
_requests: Dict[str, Any] = {}  # kind -> itertools.count of fresh ids

DEFAULT_CAP = 1 << 20


class SpanRecord(NamedTuple):
    """A closed span. Times are ``perf_counter_ns``."""

    id: int
    name: str
    parent: Optional[int]
    thread: str
    request: Any
    start_ns: int
    end_ns: int
    counts: Optional[Dict[str, Any]]


class _Recording:
    def __init__(self, cap: int):
        self.cap = int(cap)
        self.spans = []         # closed Span objects, in closing order
        self.dropped = 0
        self.ids = itertools.count(1)
        self.lock = threading.Lock()
        self.anchor = clock_anchor()


def clock_anchor(tries: int = 5) -> Dict[str, int]:
    """The tightest of ``tries`` readings of the Unix clock between two of
    ``perf_counter_ns``: ``unix_ns`` at ``perf_ns``, to within ``width_ns``."""
    best = None
    for _ in range(tries):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[2]:
            best = (u, (a + b) // 2, b - a)
    return {"unix_ns": best[0], "perf_ns": best[1], "width_ns": best[2]}


def _sync_stream():
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _local.thread = threading.current_thread().name
        _local.request = None
        return _local.stack


class _Null:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, a, b, c):
        return None

    def close(self):
        return None

    def count(self, key: str, n: int = 1):
        pass

    def set(self, key: str, value):
        pass


NULL = _Null()


class Span:
    """An open span; ``close()`` (or leaving its ``with``) records it."""

    __slots__ = ("id", "name", "parent", "thread", "request", "start_ns",
                 "end_ns", "counts", "sync", "_rec", "_stack")

    def __init__(self, rec, name, sync, request, start_ns):
        st = _stack()
        top = st[-1] if st else None
        self._rec, self._stack = rec, st
        self.id = next(rec.ids)
        self.name = name
        self.thread = _local.thread
        self.parent = top.id if top is not None else None
        if request is None:
            request = top.request if top is not None else _local.request
        self.request = request
        self.sync = sync
        self.counts = None
        self.end_ns = None
        st.append(self)
        self.start_ns = time.perf_counter_ns() if start_ns is None \
            else start_ns

    def __enter__(self):
        return self

    def __exit__(self, a, b, c):
        self.close()

    def count(self, key: str, n: int = 1):
        c = self.counts
        if c is None:
            c = self.counts = {}
        c[key] = c.get(key, 0) + int(n)

    def set(self, key: str, value):
        if self.counts is None:
            self.counts = {}
        self.counts[key] = value

    def close(self) -> int:
        """Record the span (synchronising first if it closes device work);
        spans still open inside it close with it. Returns its end."""
        if self.end_ns is not None:
            return self.end_ns
        if self.sync:
            _sync_stream()
        t = time.perf_counter_ns()
        st = self._stack
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            while st:
                top = st.pop()
                if top is self:
                    break
                top._finish(t)
        self._finish(t)
        return t

    def _finish(self, t):
        self.end_ns = t
        rec = self._rec
        # list.append is atomic; two threads at the cap may pass it by one
        if len(rec.spans) < rec.cap:
            rec.spans.append(self)
        else:
            with rec.lock:
                rec.dropped += 1

    def record(self) -> SpanRecord:
        return SpanRecord(self.id, self.name, self.parent, self.thread,
                          self.request, self.start_ns, self.end_ns,
                          None if self.counts is None else dict(self.counts))


def span(name: str, sync: bool = False, request=None, fresh: str = None,
         start_ns: int = None):
    """Open a span now (a ``with`` block closes it, or ``close()``).
    ``request``: its request id, else its parent's; ``fresh``: a new id of
    that kind ("evidence 3"); ``start_ns``: a ``perf_counter_ns`` reading
    already taken for its start."""
    if not _on:
        return NULL
    if fresh is not None:
        ids = _requests.setdefault(fresh, itertools.count(1))
        request = f"{fresh} {next(ids)}"
    return Span(_rec, name, sync, request, start_ns)


def traced(name: str, **span_kw):
    """Decorator: each call of the function is a span (``span``'s keywords)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name, **span_kw):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def count(key: str, n: int = 1):
    """Add ``n`` to ``key`` of this thread's innermost open span."""
    if not _on:
        return
    st = _stack()
    if st:
        st[-1].count(key, n)


def adopt(request):
    """The request id of this thread's spans that have no parent."""
    _stack()
    _local.request = request


def current_request():
    """This thread's innermost open span's request id (or adopted one)."""
    if not _on:
        return None
    st = _stack()
    return st[-1].request if st else _local.request


def enable(cap: int = DEFAULT_CAP):
    """Start a new recording of at most ``cap`` spans, and take the clock
    anchor."""
    global _on, _rec
    _requests.clear()
    _rec = _Recording(cap)
    _on = True


def disable():
    """Stop recording; what was recorded stays for ``snapshot()``."""
    global _on
    _on = False


def snapshot() -> Dict[str, Any]:
    """The recording so far: ``spans`` (SpanRecord, in the order they
    closed), ``dropped``, ``cap``, ``anchor`` (clock_anchor at enable) and
    ``counters`` (every count summed by "span.key")."""
    rec = _rec
    if rec is None:
        return {"spans": [], "dropped": 0, "cap": 0, "anchor": None,
                "counters": {}}
    spans = [s.record() for s in list(rec.spans)]
    dropped = rec.dropped
    counters: Dict[str, int] = {}
    for s in spans:
        for k, v in (s.counts or {}).items():
            if isinstance(v, int):
                key = f"{s.name}.{k}"
                counters[key] = counters.get(key, 0) + v
    return {"spans": spans, "dropped": dropped, "cap": rec.cap,
            "anchor": dict(rec.anchor), "counters": counters}


def write_chrome_trace(path: str, snap: Optional[Dict[str, Any]] = None):
    """Write the recording (or ``snap``) as a Chrome trace-event JSON file,
    times in microseconds on the Unix clock."""
    snap = snap if snap is not None else snapshot()
    anchor = snap["anchor"] or {"unix_ns": 0, "perf_ns": 0}
    shift = anchor["unix_ns"] - anchor["perf_ns"]
    pid = os.getpid()
    tids: Dict[str, int] = {}
    events = []
    for s in snap["spans"]:
        tid = tids.setdefault(s.thread, len(tids) + 1)
        args = {"id": s.id, "parent": s.parent, "request": s.request}
        args.update(s.counts or {})
        events.append({"name": s.name, "ph": "X", "pid": pid, "tid": tid,
                       "ts": (s.start_ns + shift) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    for name, tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"dropped": snap["dropped"]}}, f)

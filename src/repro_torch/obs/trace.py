"""TraceKit spans — per-wave tracing for the async join pipeline.

The wave pipeline (engine/waves.py) interleaves three kinds of work:
device traversal dispatched asynchronously, small blocking seed-feedback
fetches, and host-side pair/cache assembly running in the shadow of the
device. End-of-join aggregates (``JoinStats``) cannot show *when* each
piece ran — whether the pipeline overlap actually hides assembly, why one
wave's re-rank band overflowed, or how long the host sat blocked.

``Tracer`` records nestable spans with wall-clock (``perf_counter_ns``),
the recording thread, and structured attributes (wave index, band
occupancy, re-rank capacity, bytes moved per transfer class), grouped
into named *lanes*. ``to_chrome()`` / ``export()`` emit the Chrome /
Perfetto ``trace.json`` format (one ``pid`` per tracer, one ``tid`` per
lane), so the traversal⇆assembly overlap is visible as two lanes whose
spans interleave in time.

Two span flavors match the pipeline's two execution models:

  * ``span(name, lane=...)`` — a *synchronous* context-manager span for
    host phases. Spans on one lane nest like the call stack; Perfetto
    renders the nesting.
  * ``begin(name, lane=...)`` / ``Span.end()`` — an *asynchronous* span
    for device phases, opened at dispatch and closed at the first host
    contact with the results. The device executes waves serially even
    when two are in flight, so async lanes are **exclusive**: at end
    time the span's start is clamped to the lane's previous end, keeping
    the lane a well-formed serial timeline (wave *k+1* is dispatched
    while wave *k* is still open; its device time only starts once the
    device finishes wave *k*).

Tracing off is the default and must cost nothing on the hot path:
``tracer()`` returns the module-level ``NOOP_TRACER`` singleton, which
is *falsy* (guard attribute computation with ``if tr:``) and whose
``span``/``begin`` return one shared no-op span — no event, no
allocation beyond the call itself. Tracing never touches the data path,
so traced and untraced runs emit bit-identical pair sets (asserted in
tests/test_obs.py).
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["Span", "Tracer", "NOOP_TRACER", "tracer", "enable", "disable",
           "tracing", "env_trace_path", "env_trace_enabled"]

_now_ns = time.perf_counter_ns


class _NoopSpan:
    """Shared do-nothing span (both flavors). Falsy, reusable, immutable."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        return self

    def end(self, **attrs):
        return None


NOOP_SPAN = _NoopSpan()


class _NoopTracer:
    """Disabled tracer: every operation returns the shared no-op span.

    Falsy so call sites can guard attribute computation:
    ``if tr: tr.instant("x", n=int(arr.sum()))`` allocates nothing when
    tracing is off.
    """
    __slots__ = ()
    enabled = False

    def __bool__(self):
        return False

    def span(self, name, lane="host", **attrs):
        return NOOP_SPAN

    def begin(self, name, lane="device", **attrs):
        return NOOP_SPAN

    def instant(self, name, lane="host", **attrs):
        return None


NOOP_TRACER = _NoopTracer()


class Span:
    """One open span; close with ``end()`` (async) or ``with`` (sync)."""
    __slots__ = ("_tr", "name", "lane", "t0", "attrs", "exclusive",
                 "thread", "_open")

    def __init__(self, tr: "Tracer", name: str, lane: str,
                 exclusive: bool, attrs: dict):
        self._tr = tr
        self.name = name
        self.lane = lane
        self.t0 = _now_ns()
        self.attrs = attrs
        self.exclusive = exclusive
        self.thread = threading.get_ident()
        self._open = True

    def __bool__(self):
        return True

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, **attrs) -> None:
        if not self._open:        # idempotent: double-end records once
            return
        self._open = False
        if attrs:
            self.attrs.update(attrs)
        self._tr._finish(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


class Tracer:
    """Span recorder with Chrome/Perfetto export.

    Events are stored as finished-span tuples and serialized on demand;
    recording one span is two clock reads, one small object, and one
    list append. All methods are safe under the GIL from any thread (the
    wave loop is single-threaded today; callbacks may not be).
    """
    enabled = True

    def __init__(self, *, process_name: str = "repro-join"):
        self.process_name = process_name
        self.t0 = _now_ns()
        self.main_thread = threading.get_ident()
        self._events: list[dict] = []
        self._lanes: dict[str, int] = {}
        self._lane_last_end: dict[str, int] = {}

    def __bool__(self):
        return True

    # -- recording ----------------------------------------------------------

    def span(self, name: str, lane: str = "host", **attrs) -> Span:
        """Open a synchronous (nestable) span on ``lane``."""
        return Span(self, name, lane, False, attrs)

    def begin(self, name: str, lane: str = "device", **attrs) -> Span:
        """Open an asynchronous span on an *exclusive* lane: at ``end()``
        its start is clamped to the lane's previous end, modeling serial
        device execution under double-buffered dispatch."""
        return Span(self, name, lane, True, attrs)

    def instant(self, name: str, lane: str = "host", **attrs) -> None:
        """A zero-duration marker (e.g. an overflow-retry decision)."""
        t = _now_ns()
        self._push(name, lane, t, 0, threading.get_ident(), attrs)

    def _finish(self, sp: Span) -> None:
        t1 = _now_ns()
        t0 = sp.t0
        if sp.exclusive:
            t0 = max(t0, self._lane_last_end.get(sp.lane, t0))
            t0 = min(t0, t1)
            self._lane_last_end[sp.lane] = t1
        self._push(sp.name, sp.lane, t0, t1 - t0, sp.thread, sp.attrs)

    def _push(self, name, lane, t0_ns, dur_ns, thread, attrs) -> None:
        tid = self._lanes.setdefault(lane, len(self._lanes))
        ev = dict(name=name, lane=lane, tid=tid, ts_ns=t0_ns - self.t0,
                  dur_ns=dur_ns, attrs=dict(attrs))
        if thread != self.main_thread:
            ev["attrs"]["thread"] = thread
        self._events.append(ev)

    # -- introspection (tests, benches) -------------------------------------

    @property
    def n_events(self) -> int:
        return len(self._events)

    def lanes(self) -> dict[str, list[dict]]:
        """Finished events grouped by lane, sorted by start time."""
        out: dict[str, list[dict]] = {ln: [] for ln in self._lanes}
        for ev in self._events:
            out[ev["lane"]].append(ev)
        for evs in out.values():
            evs.sort(key=lambda e: (e["ts_ns"], -e["dur_ns"]))
        return out

    def summary(self) -> dict[tuple[str, str], tuple[int, float]]:
        """{(lane, name): (count, total_seconds)} — the per-phase
        aggregate bench_breakdown reports for the pipelined loop."""
        agg: dict[tuple[str, str], list] = {}
        for ev in self._events:
            cell = agg.setdefault((ev["lane"], ev["name"]), [0, 0])
            cell[0] += 1
            cell[1] += ev["dur_ns"]
        return {k: (c, ns / 1e9) for k, (c, ns) in agg.items()}

    # -- export -------------------------------------------------------------

    def to_chrome(self) -> dict:
        """Chrome Trace Event JSON (Perfetto-loadable): ``X`` complete
        events (µs timestamps) plus thread-name metadata per lane."""
        events = []
        for lane, tid in sorted(self._lanes.items(), key=lambda kv: kv[1]):
            events.append(dict(name="thread_name", ph="M", pid=0, tid=tid,
                               args=dict(name=lane)))
        events.append(dict(name="process_name", ph="M", pid=0, tid=0,
                           args=dict(name=self.process_name)))
        for ev in self._events:
            ph = "X" if ev["dur_ns"] > 0 else "i"
            rec = dict(name=ev["name"], ph=ph, pid=0, tid=ev["tid"],
                       ts=ev["ts_ns"] / 1e3)
            if ph == "X":
                rec["dur"] = ev["dur_ns"] / 1e3
            else:
                rec["s"] = "t"           # instant scoped to its thread
            if ev["attrs"]:
                rec["args"] = _jsonable(ev["attrs"])
            events.append(rec)
        return dict(traceEvents=events, displayTimeUnit="ms")

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


def _jsonable(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (bool, int, float, str)) or v is None:
            out[k] = v
        else:
            out[k] = str(v)
    return out


# ---------------------------------------------------------------------------
# process-global active tracer (OTel-style ambient instrumentation)
# ---------------------------------------------------------------------------

_ACTIVE = NOOP_TRACER


def tracer():
    """The active tracer — ``NOOP_TRACER`` unless ``enable()`` ran."""
    return _ACTIVE


def enable(tr: Tracer | None = None) -> Tracer:
    """Install ``tr`` (or a fresh ``Tracer``) as the active tracer."""
    global _ACTIVE
    _ACTIVE = tr if tr is not None else Tracer()
    return _ACTIVE


def disable():
    """Restore the no-op tracer; returns the tracer that was active."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = NOOP_TRACER
    return prev


class tracing:
    """``with tracing() as tr:`` — enable a tracer for a scope, restoring
    the previous one on exit; optionally export on clean exit."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.tracer: Tracer | None = None
        self._prev = None

    def __enter__(self) -> Tracer:
        self._prev = _ACTIVE
        self.tracer = enable(Tracer())
        return self.tracer

    def __exit__(self, et, ev, tb) -> bool:
        global _ACTIVE
        _ACTIVE = self._prev
        if et is None and self.path:
            self.tracer.export(self.path)
        return False


# ---------------------------------------------------------------------------
# REPRO_TRACE env override (mirrors REPRO_OVERLAP / REPRO_EARLY_EXIT)
# ---------------------------------------------------------------------------

_OFF = ("0", "off", "false", "no")
_ON = ("1", "on", "true", "yes")


def env_trace_enabled() -> bool:
    """Whether ``REPRO_TRACE`` asks for tracing (empty counts as unset,
    so CI matrices can template the variable per leg)."""
    env = os.environ.get("REPRO_TRACE")
    if env is None or not env.strip():
        return False
    return env.strip().lower() not in _OFF


def env_trace_path() -> str | None:
    """``REPRO_TRACE`` doubles as the export path: any value that is not
    a plain on/off token (e.g. ``REPRO_TRACE=/tmp/run.json``) names the
    ``trace.json`` to write."""
    env = os.environ.get("REPRO_TRACE")
    if env is None or not env.strip():
        return None
    v = env.strip()
    if v.lower() in _OFF + _ON:
        return None
    return v

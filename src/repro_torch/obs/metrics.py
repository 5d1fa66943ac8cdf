"""Metrics registry — counters, gauges, and fixed-bucket histograms.

The accumulation backend behind ``JoinStats`` and the engine/serving
surfaces: instruments register by name on a ``Metrics`` registry and
accumulate in place; ``snapshot()`` returns plain dicts and
``prometheus_text()`` renders the Prometheus exposition format (the
``--metrics-dump`` output of ``launch/join.py``).

``JoinStats`` stays the public per-join dataclass; each finished join is
*published* into the registry (``JoinStats.publish``) and the engine's
lifetime aggregate is *materialized back* from it
(``JoinStats.from_metrics`` / ``JoinEngine.cumulative_stats``) — the
registry is the single source of truth across joins, while the wave
runners keep their cheap in-band counter threading (device-side counts
are reduced on the device and fetched once per wave).

A process-global default registry (``metrics()``) serves ambient
instrumentation (wave-level histograms in engine/waves.py) exactly like
``trace.tracer()`` serves spans; engines default to it but accept a
private registry for isolation.

Everything here is host-side Python on wave/join granularity — dict
lookups and integer adds, never per-candidate work — so metrics stay on
unconditionally (unlike spans, which are opt-in).
"""
from __future__ import annotations

import re
import threading

__all__ = ["Counter", "Gauge", "Histogram", "Metrics", "metrics",
           "POW2_BUCKETS", "LATENCY_BUCKETS", "compile_count",
           "enable_compile_counter"]

# Fixed default bucket grids. Powers of two suit count-shaped
# distributions (band occupancy, pairs per wave); the latency grid spans
# 100 µs .. ~100 s in half-decades.
POW2_BUCKETS = tuple(float(1 << i) for i in range(0, 21, 2))
LATENCY_BUCKETS = tuple(1e-4 * (10 ** (i / 2)) for i in range(13))


class Counter:
    """Monotonically increasing value (int or float)."""
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        self.value += n


class Gauge:
    """Last-set value; ``set_max`` keeps a high-water mark."""
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def set_max(self, v) -> None:
        if v > self.value:
            self.value = v


class Histogram:
    """Fixed-bucket histogram (cumulative-count exposition like
    Prometheus: ``counts[i]`` = observations ≤ ``buckets[i]``, plus a
    +Inf overflow, ``sum`` and ``count``)."""
    __slots__ = ("name", "help", "buckets", "counts", "sum", "count")

    def __init__(self, name: str, buckets=POW2_BUCKETS, help: str = ""):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must be sorted"
                             f" and non-empty ({buckets!r})")
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # +Inf tail
        self.sum = 0.0
        self.count = 0

    def observe(self, v) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> list[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


class Metrics:
    """Name-keyed registry. ``counter``/``gauge``/``histogram`` are
    get-or-create; re-registering with a different kind raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_name: dict[str, object] = {}

    def _get(self, cls, name: str, *args, **kw):
        with self._lock:
            cur = self._by_name.get(name)
            if cur is None:
                cur = self._by_name[name] = cls(name, *args, **kw)
            elif type(cur) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(cur).__name__}, requested {cls.__name__}")
            return cur

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help=help)

    def histogram(self, name: str, buckets=POW2_BUCKETS,
                  help: str = "") -> Histogram:
        return self._get(Histogram, name, buckets, help=help)

    def get(self, name: str):
        """The instrument registered under ``name``, or None."""
        return self._by_name.get(name)

    def value(self, name: str, default=0):
        """Scalar value of a counter/gauge (histograms: observation
        count); ``default`` when unregistered."""
        m = self._by_name.get(name)
        if m is None:
            return default
        return m.count if isinstance(m, Histogram) else m.value

    def names(self) -> list[str]:
        return sorted(self._by_name)

    def clear(self) -> None:
        with self._lock:
            self._by_name.clear()

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-dict dump: ``{"counters": {...}, "gauges": {...},
        "histograms": {name: {buckets, counts, sum, count}}}``."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in self.names():
            m = self._by_name[name]
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = dict(
                    buckets=list(m.buckets), counts=list(m.counts),
                    sum=m.sum, count=m.count)
        return out

    def prometheus_text(self) -> str:
        """Prometheus exposition format (dots → underscores; histograms
        as cumulative ``_bucket{le=...}`` series + ``_sum``/``_count``)."""
        lines: list[str] = []
        for name in self.names():
            m = self._by_name[name]
            pn = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pn} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pn} counter")
                lines.append(f"{pn} {_prom_val(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pn} gauge")
                lines.append(f"{pn} {_prom_val(m.value)}")
            else:
                lines.append(f"# TYPE {pn} histogram")
                cum = m.cumulative()
                for b, c in zip(m.buckets, cum):
                    lines.append(f'{pn}_bucket{{le="{_prom_val(b)}"}} {c}')
                lines.append(f'{pn}_bucket{{le="+Inf"}} {cum[-1]}')
                lines.append(f"{pn}_sum {_prom_val(m.sum)}")
                lines.append(f"{pn}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    pn = _PROM_BAD.sub("_", name)
    if pn and pn[0].isdigit():
        pn = "_" + pn
    return pn


def _prom_val(v) -> str:
    if isinstance(v, float):
        return repr(v) if v != int(v) else str(int(v))
    return str(v)


# ---------------------------------------------------------------------------
# process-global default registry
# ---------------------------------------------------------------------------

_DEFAULT = Metrics()


def metrics() -> Metrics:
    """The process-global default registry (ambient instrumentation and
    the default backend of every ``JoinEngine``)."""
    return _DEFAULT



# ---------------------------------------------------------------------------
# kernel-build counter (the bucket-ladder steady-state guard)
# ---------------------------------------------------------------------------

# The port has no jit: what a first call compiles is the CUDA kernel
# library (``kernels/_build.py`` running nvcc; loading a library already
# built for the sources' hash is not a build). ``_build`` reports each
# build here; it counts once the counter is enabled.
_BUILD_COUNTER = "kernels.builds"
_compile_counter_enabled = False


def enable_compile_counter() -> None:
    """Start counting kernel-library builds behind ``compile_count()``
    (idempotent, process-global). ``JoinService`` enables it at
    construction; tests may call it directly."""
    global _compile_counter_enabled
    _DEFAULT.counter(_BUILD_COUNTER,
                     help="CUDA kernel library builds (nvcc runs)")
    _compile_counter_enabled = True


def note_kernel_build() -> None:
    """Called by ``kernels._build`` after it compiled the library."""
    if _compile_counter_enabled:
        _DEFAULT.counter(_BUILD_COUNTER).inc()


def compile_count() -> int:
    """Kernel-library builds seen since ``enable_compile_counter()`` was
    first called (0 before): the port's counterpart of the reference's
    XLA compile count.

    The library holds every kernel at every shape and is built at most
    once a process (and not at all when a library for the sources' hash
    is on disk), so once it is loaded this count is flat by construction:
    the guard cannot see a shape the warmup missed, as the reference's
    can. It shows only that serving built nothing."""
    return int(_DEFAULT.value(_BUILD_COUNTER, 0))

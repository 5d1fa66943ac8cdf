"""Serving plumbing shared by the front ends (port of the admission half
of ``repro.serve.engine``): the ``RequestRejected`` admission error and
``_MetricsDict``, a stats dict that writes through to registry gauges.
The LM decode engine of that module arrives with the LM slice."""
from __future__ import annotations

from repro_torch.obs import metrics as obs_metrics


class RequestRejected(ValueError):
    """A request failed admission validation (shape mismatch, unknown
    tenant, full queue, ...). Serving front ends catch it at the admission
    boundary and record the request as failed instead of crashing
    mid-batch."""


class _MetricsDict(dict):
    """Serving stats dict that writes through to a metrics registry
    (``<prefix>.<key>`` gauges), so ``svc.stats["rejected"] += 1`` keeps
    the registry the single accumulation backend.

    ``update``/``setdefault`` route through ``__setitem__``, so the gauges
    cannot drift from the dict; the removal mutators (``pop``,
    ``popitem``, ``clear``, ``del``) are rejected, for a gauge cannot be
    unregistered and would keep a vanished key's last value."""

    def __init__(self, metrics: obs_metrics.Metrics, prefix: str, **init):
        super().__init__()
        self._metrics = metrics
        self._prefix = prefix
        for k, v in init.items():
            self[k] = v

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self._metrics.gauge(f"{self._prefix}.{k}").set(v)

    def update(self, *args, **kw):
        for k, v in dict(*args, **kw).items():
            self[k] = v

    def setdefault(self, k, default=None):
        if k not in self:
            self[k] = default
        return self[k]

    def _reject(self, *a, **kw):
        raise TypeError(
            f"{self._prefix}.* stats write through to registry gauges, "
            "which cannot be unregistered; removal would desynchronize "
            "them")

    __delitem__ = pop = popitem = clear = _reject

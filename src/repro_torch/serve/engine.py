"""Continuous-batching decode engine (port of ``repro.serve.engine``), and
the serving plumbing the front ends share: the ``RequestRejected``
admission error and ``_MetricsDict``, a stats dict that writes through
to registry gauges.

Slots share one batched cache per layer; lanes are *ragged* (per-lane
cache lengths: the decode paths take a (B,) ``cache_index``), so a
finished request's slot is refilled at once by prefilling the next
queued request and copying its B = 1 cache into that slot, without
stalling the other lanes.

Greedy (temperature 0) or sampled decoding. A sampled token's Gumbel
noise is drawn on the engine's device from a ``torch.Generator`` seeded
from (seed, uid, position), so a request's tokens depend on nothing but
its own logits (and the device's generator); the reference
folds the same triple into a JAX key, whose bits the port cannot
reproduce.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.models import model as M
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


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (S,) int32 tokens or (S, fd) frames
    max_new: int = 16
    eos: int | None = None


@dataclasses.dataclass
class _Slot:
    uid: int = -1
    remaining: int = 0
    eos: int | None = None
    out: list[int] = dataclasses.field(default_factory=list)

    @property
    def active(self) -> bool:
        return self.uid >= 0


class ServeEngine:
    """``model`` (a ``models.model.Model`` of config ``mc``) serving
    ``n_slots`` lanes with caches of ``s_max`` positions on ``device``
    (``None``: the card; the model is moved there)."""

    def __init__(self, mc: M.ModelConfig, model: M.Model, *, n_slots: int,
                 s_max: int, temperature: float = 0.0, seed: int = 0,
                 metrics: obs_metrics.Metrics | None = None, device=None):
        if mc.encoder_only:
            raise ValueError("encoder-only architectures have no decode step")
        self.device = resolve_device(device)
        self.mc = mc
        self.model = model.to(self.device)
        self.n_slots = n_slots
        self.s_max = s_max
        self.temperature = temperature
        self.seed = seed
        self._gen = torch.Generator(device=self.device)
        self.caches = M.init_caches(mc, n_slots, s_max, self.device)
        self.lengths = np.zeros(n_slots, np.int32)
        self.last_tok = np.zeros(n_slots, np.int32)
        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: collections.deque[Request] = collections.deque()
        self.done: dict[int, list[int]] = {}
        self.failed: dict[int, str] = {}
        self.metrics = metrics if metrics is not None else \
            obs_metrics.metrics()
        self.stats = _MetricsDict(self.metrics, "serve", decode_steps=0,
                                  prefills=0, generated=0, failed=0,
                                  occupancy_sum=0.0)

    # ------------------------------------------------------------------
    def metrics_snapshot(self) -> dict:
        """Plain-dict dump of the engine's metrics registry (the
        ``serve.*`` gauges behind ``self.stats``, plus whatever else
        shares the registry)."""
        return self.metrics.snapshot()

    def submit(self, reqs: list[Request]) -> None:
        self.queue.extend(reqs)

    def validate(self, req: Request) -> None:
        """Admission validation: raises ``RequestRejected`` for an empty
        prompt or one whose prompt + generation budget cannot fit the
        cache (a prefill past ``s_max`` would write other rows)."""
        S = int(np.asarray(req.prompt).shape[0])
        if S <= 0:
            raise RequestRejected(f"uid={req.uid}: empty prompt")
        if S + req.max_new > self.s_max:
            raise RequestRejected(
                f"uid={req.uid}: prompt ({S}) + max_new ({req.max_new}) "
                f"exceeds the KV cache (s_max={self.s_max})")

    def _positions(self, pos: np.ndarray) -> torch.Tensor:
        p = torch.from_numpy(np.array(pos, np.int32)).to(self.device)
        if self.mc.pos_dims > 1:
            p = torch.stack([p] * self.mc.pos_dims, -1)
        return p

    @torch.inference_mode()
    def _insert(self, slot: int, req: Request) -> None:
        """Prefill a request and copy its cache into the batch's slot."""
        self.validate(req)
        prompt = np.asarray(req.prompt)
        S = prompt.shape[0]
        inputs = torch.from_numpy(np.ascontiguousarray(prompt)).to(
            self.device)[None]
        pos = self._positions(np.arange(S, dtype=np.int32)[None])
        logits, cache1 = M.prefill(self.model, inputs, pos, self.s_max)
        for c, c1 in zip(self.caches, cache1):
            for k in c:
                c[k][slot] = c1[k][0].to(c[k].dtype)
        tok, = self._pick(logits, [(req.uid, S)])
        self.lengths[slot] = S
        self.last_tok[slot] = tok
        self.slots[slot] = _Slot(uid=req.uid, remaining=req.max_new,
                                 eos=req.eos, out=[])
        self.stats["prefills"] += 1
        # the prefill's own next-token counts as the first generated token
        self._commit_token(slot, tok)

    def _pick(self, logits: torch.Tensor,
              keys: list[tuple[int, int]]) -> list[int]:
        """The next token of each row of ``logits`` (one row a lane, on the
        device), all rows in one argmax. Greedy: the first maximal logit.
        Sampled: Gumbel-max over logits / temperature, row r's noise drawn
        on the device from a generator seeded by (seed, uid, position) of
        ``keys[r]``, so a lane's tokens do not depend on the others."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, -1).tolist()
        lg = logits.float() / self.temperature
        noise = torch.empty_like(lg)
        for row, (uid, position) in zip(noise, keys):
            self._gen.manual_seed(int(np.random.SeedSequence(
                [self.seed, uid, position]).generate_state(1, np.uint64)[0]
                >> np.uint64(1)))
            row.exponential_(generator=self._gen)
        return torch.argmax(lg - noise.log(), -1).tolist()

    def _commit_token(self, slot: int, tok: int) -> None:
        s = self.slots[slot]
        s.out.append(tok)
        s.remaining -= 1
        self.stats["generated"] += 1
        if s.remaining <= 0 or (s.eos is not None and tok == s.eos):
            self.done[s.uid] = s.out
            self.slots[slot] = _Slot()
            self.lengths[slot] = 0

    def _refill(self) -> None:
        """Fill every free slot from the FIFO. A request that fails
        admission validation is recorded as failed (empty output in
        ``done``, reason in ``failed``) and the slot moves on to the next
        queued request."""
        for i in range(self.n_slots):
            while not self.slots[i].active and self.queue:
                req = self.queue.popleft()
                try:
                    self._insert(i, req)
                except RequestRejected as e:
                    self.done[req.uid] = []
                    self.failed[req.uid] = str(e)
                    self.stats["failed"] += 1

    @torch.inference_mode()
    def step(self) -> None:
        """One batched decode step over all lanes; inactive lanes decode at
        length 0 (writing slot 0, which a refill overwrites)."""
        active = np.array([s.active for s in self.slots])
        if not active.any():
            return
        tokens = torch.from_numpy(self.last_tok[:, None].copy()).to(
            self.device)
        pos = self._positions(self.lengths[:, None])
        logits, self.caches = M.decode_step(
            self.model, tokens, pos, self.caches,
            torch.from_numpy(self.lengths.copy()).to(self.device))
        self.stats["decode_steps"] += 1
        self.stats["occupancy_sum"] += float(active.mean())
        lanes = np.flatnonzero(active)
        self.lengths[lanes] += 1
        toks = self._pick(
            logits[torch.from_numpy(lanes).to(self.device)],
            [(self.slots[i].uid, int(self.lengths[i])) for i in lanes])
        for i, tok in zip(lanes, toks):
            self.last_tok[i] = tok
            self._commit_token(i, tok)

    def run(self, reqs: list[Request]) -> dict[int, list[int]]:
        """Serve to completion; returns uid → generated tokens."""
        self.submit(reqs)
        self._refill()
        while any(s.active for s in self.slots) or self.queue:
            self.step()
            self._refill()
        return self.done

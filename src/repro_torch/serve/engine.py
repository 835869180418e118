"""Batched serving engine: slot-based lock-step decode, a memory sidecar,
and promote-to-retrieval.

This package's port of the JAX package's ``serve/engine.py``.  A fixed
pool of ``n_slots`` sequences decodes in lock-step (one ``decode_step``
per engine tick); a finished slot is refilled from the request queue by
feeding the prompt one token at a time.  Each slot is isolated: while a
prompt is fed into one slot, the other slots' recurrent states (RG-LRU,
RWKV6) keep their values and their pending next tokens stay in the token
buffer, and a slot's recurrent state goes to zero when a request enters
it.  The reference lets the feed's token 0 advance the other slots'
states, carries a finished request's state into the next one, and zeroes
the whole token buffer for each fed token, so a slot filled earlier in
the same refill decodes token 0 in place of its prompt's last token
(ROADMAP, faults of the reference).  Attention caches need no care: the
next real write at a position overwrites the feed's, and positions mask
the rest.  ``promote_to_retrieval`` seals a
linear KV cache into HNTL-KV retrieval indexes, after which a decode
step's attention costs O(G + P*cap + C) instead of O(S): the store's seal
applied to attention state.

The memory sidecar (``retrieve``, the coalescing window, ``remember`` /
``evict`` / ``refresh``, ``memory_residency``) also works on an engine
made with ``ServeEngine.__new__`` and only its attributes set, as the
reference's tests make one.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core import routing
from ..core.store import VectorStore
from ..core.types import SearchResult
from . import tenancy


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new: int = 32
    out: Optional[list] = None
    done: bool = False


class ServeEngine:
    # class-level defaults: the sidecar works on an engine built with
    # __new__ and only the attributes it needs set
    memory: Optional[VectorStore] = None
    scan_impl: Optional[str] = None
    budgets: Optional[tuple] = None
    tenants = None                  # Optional[tenancy.TenantRegistry]
    memory_mesh = None
    adaptive: bool = False
    probe_margin: Optional[float] = None
    min_probes: Optional[int] = None
    memory_budget: Optional[int] = None

    def __init__(self, model, params, *, n_slots: int = 4,
                 max_len: int = 512, temperature: float = 0.0, seed: int = 0,
                 memory: Optional[VectorStore] = None, memory_mesh=None,
                 scan_impl: Optional[str] = None,
                 budgets: Optional[tuple] = None, tenants=None,
                 adaptive: bool = False,
                 probe_margin: Optional[float] = None,
                 min_probes: Optional[int] = None,
                 memory_budget: Optional[int] = None):
        """``model``: a ``models.Model``; ``params``: the module its
        ``init`` returned (the caches go on its device).  The knobs are
        checked as the reference checks them (the adaptive knobs, then
        ``memory_budget``, which is then set on the store)."""
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.temperature = temperature
        self.memory = memory
        # tenants= without memory=: the registry's base serves tenant-less
        # calls
        self.tenants = tenants
        if memory is None and tenants is not None:
            self.memory = tenants.base
        self.memory_mesh = memory_mesh
        self.scan_impl = scan_impl
        self.budgets = budgets
        routing.check_probe_args(adaptive, probe_margin, min_probes)
        self.adaptive = adaptive
        self.probe_margin = probe_margin
        self.min_probes = min_probes
        if memory_budget is not None:
            if isinstance(memory_budget, bool) \
                    or not isinstance(memory_budget, int) \
                    or memory_budget < 0:
                raise ValueError(
                    "memory_budget must be a non-negative int (bytes of "
                    f"device residency), got {memory_budget!r}")
            if self.memory is None:
                raise ValueError(
                    "memory_budget= requires memory= (or tenants=); there "
                    "is no store to apply the residency budget to")
            if memory_mesh is not None:
                raise ValueError(
                    "memory_budget= is single-device tiered residency; the "
                    "sharded plane (memory_mesh=) keeps every shard "
                    "resident: drop one of the two")
            self.memory.device_budget = memory_budget
        self.memory_budget = memory_budget
        self.rng = np.random.default_rng(seed)
        self.device = params.device
        self.caches = model.init_cache(n_slots, max_len, self.device)
        # the layers whose state is recurrent (every leaf has the slots on
        # its leading axis), and the slot axis to select on
        from ..models.transformer import layer_specs
        self._recurrent = [li for li, spec in enumerate(layer_specs(self.cfg))
                           if spec.kind != "attn"]
        self._slot_ids = torch.arange(n_slots, device=self.device)
        self.pos = np.zeros(n_slots, np.int64)        # next position per slot
        self.active: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        self._token_buf = np.zeros(n_slots, np.int64)
        self.steps = 0
        # monotonic: the queue drains as slots refill, so len(queue) would
        # re-issue rids across submit waves
        self._next_rid = 0

    # ------------------------------------------------------------- intake
    def submit(self, prompt, max_new: int = 32) -> Request:
        req = Request(rid=self._next_rid,
                      prompt=np.asarray(prompt, np.int32),
                      max_new=max_new, out=[])
        self._next_rid += 1
        self.queue.append(req)
        return req

    def _decode(self, tokens: np.ndarray, pos: np.ndarray):
        """One ``decode_step`` over every slot (copies of the host
        buffers go to the device)."""
        logits, self.caches = self.model.decode_step(
            self.params, torch.from_numpy(tokens.copy()).to(self.device),
            self.caches, torch.from_numpy(pos.copy()).to(self.device))
        return logits

    def _map_recurrent(self, fn) -> None:
        """Replace every leaf of each recurrent layer's state (mixer and
        channel-mix) by ``fn(layer, part, name, leaf)``."""
        caches = list(self.caches)
        for li in self._recurrent:
            caches[li] = {part: ({k: fn(li, part, k, v)
                                  for k, v in st.items()} if st else st)
                          for part, st in caches[li].items()}
        self.caches = caches

    def _slot_mask(self, slot: int, leaf: torch.Tensor) -> torch.Tensor:
        return (self._slot_ids == slot).reshape(
            (-1,) + (1,) * (leaf.dim() - 1))

    def _reset_recurrent(self, slot: int) -> None:
        """Slot ``slot``'s recurrent state to zero: a request starts from
        the state ``prefill`` starts from."""
        self._map_recurrent(lambda li, part, k, v: v.masked_fill(
            self._slot_mask(slot, v), 0))

    def _keep_others(self, slot: int, before: list) -> None:
        """Every slot but ``slot`` takes its recurrent state from
        ``before``, the caches the last step read."""
        self._map_recurrent(lambda li, part, k, v: torch.where(
            self._slot_mask(slot, v), v, before[li][part][k]))

    def _fill_slot(self, slot: int, req: Request):
        """Prefill one request into a slot by single-token decode feed
        (the other slots are fed token 0 at their positions; their
        recurrent states are put back after each step, and their pending
        tokens stay in ``_token_buf``)."""
        self._reset_recurrent(slot)
        feed = np.zeros_like(self._token_buf)
        for tok in req.prompt[:-1]:
            feed[slot] = tok
            before = self.caches
            self._decode(feed, np.maximum(self.pos, 0))
            self._keep_others(slot, before)
            self.pos[slot] += 1
        self._token_buf[slot] = req.prompt[-1]
        self.active[slot] = req

    def _refill(self):
        for slot in range(self.n_slots):
            if self.active[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.pos[slot] = 0
                self._fill_slot(slot, req)

    # ------------------------------------------------------------- decode
    def step(self):
        """One lock-step decode tick across all slots."""
        self._refill()
        if all(a is None for a in self.active):
            return False
        logits = self._decode(self._token_buf, self.pos)
        logits = logits.to(torch.float32).cpu().numpy()
        if self.temperature > 0:
            z = logits / self.temperature
            z = z - z.max(axis=-1, keepdims=True)
            p = np.exp(z) / np.exp(z).sum(axis=-1, keepdims=True)
            nxt = np.array([self.rng.choice(len(row), p=row) for row in p],
                           np.int64)
        else:
            nxt = logits.argmax(axis=-1)
        self.steps += 1
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[slot] += 1
            req.out.append(int(nxt[slot]))
            if len(req.out) >= req.max_new \
                    or self.pos[slot] >= self.max_len - 1:
                req.done = True
                self.active[slot] = None
                self._token_buf[slot] = 0
            else:
                self._token_buf[slot] = nxt[slot]
        return True

    def run_to_completion(self, max_ticks: int = 10_000):
        while (self.queue or any(self.active)) and max_ticks > 0:
            if not self.step():
                break
            max_ticks -= 1

    # ---------------------------------------------------------- retrieval
    def _check_retrieval_args(self, topk, mode) -> None:
        """Request validation up front: a malformed request fails here,
        not as a shape error in the dispatch."""
        if isinstance(topk, bool) or not isinstance(topk, int) or topk <= 0:
            raise ValueError(f"topk must be a positive int, got {topk!r}")
        if mode not in ("A", "B"):
            raise ValueError(f"mode must be 'A' or 'B', got {mode!r}")
        if self.memory is None:
            raise ValueError(
                "engine built without memory= or tenants=; attach a "
                "VectorStore (or a TenantRegistry) to serve retrievals")

    def _check_query(self, q: np.ndarray) -> np.ndarray:
        if q.ndim == 1:
            q = q[None]
        d = self.memory.cfg.d
        if q.ndim != 2 or q.shape[1] != d:
            raise ValueError(
                f"query must be [d] or [Q, d] with d={d}, got {q.shape}")
        return q

    def retrieve(self, q_embed, *, topk: int = 4, mode: str = "B",
                 tag_mask: Optional[int] = None,
                 ts_range: Optional[tuple] = None,
                 tenant: Optional[str] = None) -> SearchResult:
        """Context docs from the attached memory: one fused search over
        every sealed segment plus the memtable.

        tenant: search one namespace of the engine's ``TenantRegistry``
        (the shared corpus plus the tenant's own writes, never another
        tenant's rows), through the coalesced path as a window of its own.
        Returns [Q, topk] ids and dists on the store's device.
        """
        self._check_retrieval_args(topk, mode)
        q = self._check_query(np.asarray(q_embed, np.float32))
        if tenant is not None:
            if self.tenants is None:
                raise ValueError(
                    "tenant= requires the engine to be built with "
                    "tenants=TenantRegistry(...)")
            reqs = [tenancy.RetrievalRequest(
                rid=i, tenant=tenant, q=q[i], topk=topk, mode=mode,
                tag_mask=tag_mask, ts_range=ts_range)
                for i in range(q.shape[0])]
            self._coalesce(reqs)
            return SearchResult(
                ids=torch.stack([r.result.ids for r in reqs]),
                dists=torch.stack([r.result.dists for r in reqs]))
        return self.memory.search(q, topk=topk, mode=mode,
                                  tag_mask=tag_mask, ts_range=ts_range,
                                  mesh=self.memory_mesh,
                                  scan_impl=self.scan_impl,
                                  budgets=self.budgets,
                                  adaptive=self.adaptive,
                                  probe_margin=self.probe_margin,
                                  min_probes=self.min_probes)

    def _coalesce(self, reqs: list, now: Optional[float] = None) -> list:
        return tenancy.coalesced_retrieve(
            self.tenants, reqs, mesh=self.memory_mesh,
            scan_impl=self.scan_impl, budgets=self.budgets,
            adaptive=self.adaptive, probe_margin=self.probe_margin,
            min_probes=self.min_probes, now=now)

    def submit_retrieval(self, q_embed, *, tenant: str, topk: int = 4,
                         mode: str = "B", tag_mask: Optional[int] = None,
                         ts_range: Optional[tuple] = None):
        """Queue one tenant-scoped retrieval for the next window; returns
        the pending request (``flush_retrievals`` fills ``.result`` and
        ``.done``).  Checked now, so a bad request never fails a window."""
        if self.tenants is None:
            raise ValueError("submit_retrieval requires tenants=")
        self._check_retrieval_args(topk, mode)
        q = np.asarray(q_embed, np.float32)
        if q.ndim != 1 or q.shape[0] != self.memory.cfg.d:
            raise ValueError(
                f"submit_retrieval takes ONE query [d={self.memory.cfg.d}],"
                f" got {q.shape}")
        queue = self.__dict__.setdefault("_retrieval_queue", [])
        rid = self.__dict__.setdefault("_next_rrid", 0)
        self._next_rrid = rid + 1
        req = tenancy.RetrievalRequest(rid=rid, tenant=tenant, q=q,
                                       topk=topk, mode=mode,
                                       tag_mask=tag_mask, ts_range=ts_range)
        queue.append(req)
        return req

    def flush_retrievals(self, *, max_batch: Optional[int] = None,
                         now: Optional[float] = None) -> list:
        """Serve the queued window: one padded dispatch per (mode, topk,
        filter) group across all tenants.  Returns the completed requests
        in arrival order.  How the queue is cut (``max_batch``) or ordered
        changes no request's result beyond the batch shape's float
        order."""
        queue = self.__dict__.setdefault("_retrieval_queue", [])
        if not queue:
            return []
        n = len(queue) if max_batch is None else min(max_batch, len(queue))
        batch, self._retrieval_queue = queue[:n], queue[n:]
        return self._coalesce(batch, now=now)

    def memory_residency(self) -> Optional[dict]:
        """The attached memory's tiered-plane counters, or None when it
        serves all-warm (no ``device_budget``)."""
        if self.memory is None or self.memory.device_budget is None:
            return None
        return self.memory.residency_stats()

    def _memory_for(self, tenant: Optional[str]) -> VectorStore:
        if tenant is None:
            if self.memory is None:
                raise ValueError("engine built without memory=")
            return self.memory
        if self.tenants is None:
            raise ValueError("tenant= requires tenants=")
        return self.tenants.get(tenant)

    def remember(self, vecs, *, tags=None, ts=None, ttl=None,
                 tenant: Optional[str] = None) -> np.ndarray:
        """Write docs or session state into the memory (``ttl`` seconds
        makes them expire).  Returns their gids.  ``tenant=`` writes into
        that namespace's branch (its memtable overflow force-seals)."""
        return self._memory_for(tenant).add(np.asarray(vecs, np.float32),
                                            tags=tags, ts=ts, ttl=ttl)

    def evict(self, ids, *, tenant: Optional[str] = None) -> int:
        """Tombstone entries by gid; the next retrieval masks them in the
        scan, with no re-stack.  Returns the number newly evicted."""
        return self._memory_for(tenant).delete(ids)

    def refresh(self, ids, vecs, *, tags=None, ts=None, ttl=None,
                tenant: Optional[str] = None) -> np.ndarray:
        """Re-embed docs in place (upsert): the same gids, new vectors;
        older versions are shadowed at once and reclaimed by compaction."""
        return self._memory_for(tenant).upsert(
            ids, np.asarray(vecs, np.float32), tags=tags, ts=ts, ttl=ttl)


def promote_to_retrieval(model, caches, cache_len: int):
    """Seal a linear decode cache into HNTL-KV retrieval indexes.

    Every global attention layer (``window is None``) whose linear cache
    holds at least one grain of tokens gets a ``KVIndex`` over positions
    [0, sealed), sealed = (cache_len // kv_cap) * kv_cap, with the cache's
    next ``kv_tail`` slots (zero-padded) as its hot tail; windowed layers
    keep their ring caches.  Returns a new list; the index's raw tier is
    a view of the linear cache, so drop the linear caches after.
    """
    from ..models import hntl_attention as H
    from ..models.transformer import layer_specs
    cfg = model.cfg
    sealed = (cache_len // cfg.kv_cap) * cfg.kv_cap
    if sealed == 0:
        return caches
    out = []
    for spec, lc in zip(layer_specs(cfg), caches):
        if spec.kind != "attn" or spec.window is not None:
            out.append(lc)
            continue
        kc, vc = lc["mixer"]["k"], lc["mixer"]["v"]
        idx = H.build_kv_index(kc[:, :sealed], vc[:, :sealed], cfg,
                               device=kc.device)
        tail_k = kc[:, sealed:sealed + cfg.kv_tail]
        tail_v = vc[:, sealed:sealed + cfg.kv_tail]
        pad = cfg.kv_tail - tail_k.shape[1]
        if pad > 0:
            tail_k = torch.nn.functional.pad(tail_k, (0, 0, 0, 0, 0, pad))
            tail_v = torch.nn.functional.pad(tail_v, (0, 0, 0, 0, 0, pad))
        out.append({"mixer": dataclasses.replace(idx, tail_k=tail_k,
                                                 tail_v=tail_v),
                    "ffn": lc["ffn"]})
    return out

"""The serving engine's memory sidecar: retrieval and memory writes.

The JAX package's ``repro.serve.engine.ServeEngine`` is a slot-based
continuous-batching decoder with a vector memory beside it.  The port
carries the part that needs no model: request validation, ``retrieve``
(tenant-less, or tenant-scoped through ``serve.tenancy``),
``submit_retrieval`` / ``flush_retrievals`` (the coalescing window),
``remember`` / ``evict`` / ``refresh`` and ``memory_residency``.  The
decoder (``submit``, ``step``, ``run_to_completion``) and
``promote_to_retrieval`` need a model of the repo, which is not ported
yet, so ``ServeEngine(...)`` checks its arguments as the reference does
and then refuses.  The sidecar works on an engine made with
``ServeEngine.__new__`` and its attributes set, as the reference's tests
make one.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import routing
from ..core.store import VectorStore, _unported
from ..core.types import SearchResult
from . import tenancy


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
        """The reference's argument checks, in its order (the adaptive
        knobs, then ``memory_budget``), then a refusal: the decoder needs
        a model of the repo, which is not ported yet.  No store is
        changed."""
        routing.check_probe_args(adaptive, probe_margin, min_probes)
        if memory is None and tenants is not None:
            memory = tenants.base
        if memory_budget is not None:
            if isinstance(memory_budget, bool) \
                    or not isinstance(memory_budget, int) \
                    or memory_budget < 0:
                raise ValueError(
                    "memory_budget must be a non-negative int (bytes of "
                    f"device residency), got {memory_budget!r}")
            if memory is None:
                raise ValueError(
                    "memory_budget= requires memory= (or tenants=); there "
                    "is no store to apply the residency budget to")
            if memory_mesh is not None:
                raise ValueError(
                    "memory_budget= is single-device tiered residency; the "
                    "sharded plane (memory_mesh=) keeps every shard "
                    "resident: drop one of the two")
        raise _unported("ServeEngine(model, params, ...)", 9,
                        "a model of the repo for its decoder")

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

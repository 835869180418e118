"""HNSW baseline (paper Table 1 comparison).

This package's own copy of the JAX package's ``core/hnsw.py``, which is
numpy only: the port imports nothing of that package, and its benchmarks
compare against this graph.  Same seed, same data: the same graph and the
same ids.

A compact, faithful numpy implementation of Hierarchical Navigable Small
World graphs [Malkov & Yashunin 2018]: multi-layer greedy search with
heuristic neighbour selection.  Exists (a) as the recall baseline the paper
compares against (M=16, efSearch=50) and (b) as the *pointer-chasing*
traversal workload for the Table 2 layout benchmark — every hop is a
data-dependent neighbour-list load, which is precisely the access pattern
HNTL eliminates.
"""
from __future__ import annotations

import heapq
import math

import numpy as np


class HNSW:
    def __init__(self, d: int, m: int = 16, ef_construction: int = 200,
                 seed: int = 0):
        self.d = d
        self.m = m
        self.m0 = 2 * m                      # layer-0 degree bound
        self.efc = ef_construction
        self.ml = 1.0 / math.log(m)
        self.rng = np.random.default_rng(seed)
        self.vectors = None                  # [N, d]
        self.levels: list[int] = []
        self.neighbors: list[list[np.ndarray]] = []   # per node, per layer
        self.entry = -1
        self.max_level = -1

    # -- distances -----------------------------------------------------
    def _d2(self, q, ids):
        diff = self.vectors[ids] - q
        return np.einsum("nd,nd->n", diff, diff)

    def _d2_one(self, q, i):
        diff = self.vectors[i] - q
        return float(diff @ diff)

    # -- search inside one layer ----------------------------------------
    def _search_layer(self, q, entry_points, ef, layer):
        visited = set(entry_points)
        cand = []                                    # min-heap by dist
        best = []                                    # max-heap by -dist
        for ep in entry_points:
            d = self._d2_one(q, ep)
            heapq.heappush(cand, (d, ep))
            heapq.heappush(best, (-d, ep))
        while cand:
            d, c = heapq.heappop(cand)
            if d > -best[0][0]:
                break
            for nb in self.neighbors[c][layer]:
                nb = int(nb)
                if nb in visited:
                    continue
                visited.add(nb)
                dn = self._d2_one(q, nb)
                if len(best) < ef or dn < -best[0][0]:
                    heapq.heappush(cand, (dn, nb))
                    heapq.heappush(best, (-dn, nb))
                    if len(best) > ef:
                        heapq.heappop(best)
        out = sorted([(-nd, i) for nd, i in best])
        return out                                    # [(dist, id)] ascending

    # -- heuristic neighbour selection (Malkov Alg. 4, simple variant) ---
    def _select(self, cands, m):
        cands = sorted(cands)
        selected = []
        for d, c in cands:
            ok = True
            for _, s in selected:
                if self._d2_one(self.vectors[c], s) < d:
                    ok = False
                    break
            if ok:
                selected.append((d, c))
            if len(selected) >= m:
                break
        # backfill with closest rejected if underfull
        if len(selected) < m:
            chosen = {c for _, c in selected}
            for d, c in cands:
                if c not in chosen:
                    selected.append((d, c))
                    if len(selected) >= m:
                        break
        return [c for _, c in selected]

    # -- construction -----------------------------------------------------
    def build(self, x: np.ndarray):
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        self.vectors = x
        self.levels = [int(-math.log(self.rng.random()) * self.ml)
                       for _ in range(n)]
        self.neighbors = [
            [np.empty(0, np.int32) for _ in range(lvl + 1)]
            for lvl in self.levels]
        for i in range(n):
            self._insert(i)
        return self

    def _insert(self, i):
        lvl = self.levels[i]
        if self.entry < 0:
            self.entry = i
            self.max_level = lvl
            return
        q = self.vectors[i]
        ep = [self.entry]
        for layer in range(self.max_level, lvl, -1):
            res = self._search_layer(q, ep, 1, layer)
            ep = [res[0][1]]
        for layer in range(min(lvl, self.max_level), -1, -1):
            res = self._search_layer(q, ep, self.efc, layer)
            mmax = self.m0 if layer == 0 else self.m
            nbs = self._select(res, self.m)
            self.neighbors[i][layer] = np.asarray(nbs, np.int32)
            for nb in nbs:
                lst = self.neighbors[nb][layer]
                if len(lst) < mmax:
                    self.neighbors[nb][layer] = np.append(lst, i).astype(np.int32)
                else:
                    # prune with the same heuristic
                    cands = [(self._d2_one(self.vectors[nb], int(c)), int(c))
                             for c in lst] + [(self._d2_one(self.vectors[nb], i), i)]
                    self.neighbors[nb][layer] = np.asarray(
                        self._select(cands, mmax), np.int32)
            ep = [r[1] for r in res]
        if lvl > self.max_level:
            self.max_level = lvl
            self.entry = i

    # -- query -----------------------------------------------------------
    def search(self, q: np.ndarray, topk: int = 10, ef_search: int = 50):
        q = np.asarray(q, np.float32)
        single = q.ndim == 1
        qs = q[None] if single else q
        all_ids, all_d = [], []
        for qq in qs:
            ep = [self.entry]
            for layer in range(self.max_level, 0, -1):
                res = self._search_layer(qq, ep, 1, layer)
                ep = [res[0][1]]
            res = self._search_layer(qq, ep, max(ef_search, topk), 0)[:topk]
            all_ids.append([i for _, i in res])
            all_d.append([d for d, _ in res])
        ids = np.asarray(all_ids, np.int32)
        d = np.asarray(all_d, np.float32)
        return (ids[0], d[0]) if single else (ids, d)

    # -- accounting (paper §3.2 memory comparison) -------------------------
    def graph_bytes(self) -> int:
        """Bytes of neighbour lists (4-byte ids) + per-node headers."""
        total = 0
        for per_node in self.neighbors:
            for lst in per_node:
                total += 4 * len(lst)
        total += 8 * len(self.neighbors)          # level + offset headers
        return total

    def vector_bytes(self) -> int:
        return int(self.vectors.size * 4)

"""Sequential oracle implementation (host-side, numpy + heapq).

A from-scratch, readably-slow reimplementation of the reference algorithm's
*semantics* — insert-at-a-time HNSW-variant construction with
anti-topological pruning and two-heap beam search (reference:
src/antitopo_engine.h:262-308 prune_edges, :310-465 _store_vector,
:495-708 query_k_at_layer, :853-928 _query_k).  It exists to serve as the
correctness oracle in tests: the batched device engine must match its recall
on small datasets, and the batched prune must reproduce its edge selections
given identical candidate lists.  Only the canonical ``ortho_count=1``
configuration is implemented (in that configuration the construction beam
search runs with an empty ortho set, so scoring is plain L2 — see
src/antitopo_engine.h:396-414 with i ranging over a single iteration).

Not a performance path; do not use for corpora beyond a few thousand rows.
"""

from __future__ import annotations

import heapq
import math
from typing import List, Tuple

import numpy as np


def _d2(a: np.ndarray, b: np.ndarray) -> float:
    diff = a - b
    return float(np.dot(diff, diff))


class SequentialOracle:
    def __init__(
        self,
        M: int = 8,
        M0: int = 0,
        ef_construction: int = 32,
        ortho_factor: float = 0.5,
        ortho_bias: float = 0.0,
        prune_overflow: int = 0,
        seed: int = 0,
    ):
        self.M = M
        self.M0 = M0 or 2 * M
        self.ef_construction = ef_construction
        self.ortho_factor = ortho_factor
        self.ortho_bias = ortho_bias
        self.prune_overflow = prune_overflow
        self.rng = np.random.default_rng(seed)
        # RECORD_STATS parity (src/antitopo_engine.h:125-128): one count
        # per _d2 evaluated during queries; reset manually between runs
        self.num_distcomps = 0
        self.vecs: List[np.ndarray] = []
        # per node: list over layers of edge lists [(d, id), ...]
        self.edges: List[List[List[Tuple[float, int]]]] = []
        self.max_layer = 0
        self.starting_vertex = 0

    # --- anti-topo prune (semantics of src/antitopo_engine.h:262-308) ---
    def prune(self, layer: int, node: int, lazy: bool) -> None:
        cap = self.M0 if layer == 0 else self.M
        to = self.edges[node][layer]
        if lazy and len(to) <= cap:
            return
        cands = sorted(to)
        ret: List[Tuple[float, int]] = []
        while len(ret) < cap and cands:
            best = None
            best_score = math.inf
            for c in cands:
                d_c, id_c = c
                score = d_c
                leniency = self.prune_overflow + 1
                dead = False
                for _, id_s in ret:
                    co = _d2(self.vecs[id_s], self.vecs[id_c])
                    if co < d_c:
                        score += self.ortho_factor * (d_c - co) + self.ortho_bias
                        leniency -= 1
                        if leniency == 0:
                            dead = True
                            break
                if dead:
                    continue
                if score < best_score:
                    best_score = score
                    best = c
            if best is None:
                break
            ret.append(best)
            cands.remove(best)
        self.edges[node][layer] = ret

    # --- beam search on one layer (src/antitopo_engine.h:495-708) ---
    def search_layer(
        self, q: np.ndarray, layer: int, entry_points: List[int], ef: int
    ) -> List[Tuple[float, int]]:
        visited = set(entry_points)
        eps = [( _d2(q, self.vecs[e]), e) for e in entry_points]
        self.num_distcomps += len(eps)
        candidates = list(eps)
        heapq.heapify(candidates)  # min-heap by distance
        nearest = [(-d, e) for d, e in eps]  # max-heap via negation
        heapq.heapify(nearest)
        while len(nearest) > ef:
            heapq.heappop(nearest)
        while candidates:
            d_cur, cur = heapq.heappop(candidates)
            if len(nearest) == ef and d_cur > -nearest[0][0]:
                break
            for nb in (e for _, e in self.edges[cur][layer]):
                if nb in visited:
                    continue
                visited.add(nb)
                d_nb = _d2(q, self.vecs[nb])
                self.num_distcomps += 1
                if len(nearest) < ef or d_nb < -nearest[0][0]:
                    heapq.heappush(candidates, (d_nb, nb))
                    heapq.heappush(nearest, (-d_nb, nb))
                    if len(nearest) > ef:
                        heapq.heappop(nearest)
        return sorted((-nd, e) for nd, e in nearest)

    # --- greedy upper descent (src/antitopo_engine.h:878-893) ---
    def _descend(self, q: np.ndarray, from_layer: int, to_layer: int) -> int:
        ep = self.starting_vertex
        ep_d = _d2(q, self.vecs[ep])
        self.num_distcomps += 1
        for layer in range(from_layer, to_layer, -1):
            changed = True
            while changed:
                changed = False
                for _, nb in self.edges[ep][layer]:
                    d_nb = _d2(q, self.vecs[nb])
                    self.num_distcomps += 1
                    if d_nb < ep_d:
                        ep, ep_d = nb, d_nb
                        changed = True
        return ep

    # --- insert (src/antitopo_engine.h:310-465) ---
    def store_vector(self, v: np.ndarray) -> None:
        v = np.asarray(v, np.float32)
        idx = len(self.vecs)
        self.vecs.append(v)
        u = float(self.rng.random())
        u = min(max(u, 1e-300), 1.0 - 1e-16)
        new_level = int(math.floor(-math.log(u) / math.log(self.M)))
        self.edges.append([[] for _ in range(max(new_level + 1, 1))])

        if idx > 0:
            ep = self._descend(v, self.max_layer - 1, new_level)
            cur = [ep]
            for layer in range(min(new_level, self.max_layer - 1), -1, -1):
                results = self.search_layer(v, layer, cur, self.ef_construction)
                self.edges[idx][layer] = list(results)
                self.prune(layer, idx, lazy=False)
                for d_e, e in self.edges[idx][layer]:
                    if not any(o == idx for _, o in self.edges[e][layer]):
                        self.edges[e][layer].append((d_e, idx))
                        self.prune(layer, e, lazy=True)
                cur = [results[0][1]]

        while new_level >= self.max_layer:
            self.max_layer += 1
            self.starting_vertex = idx

    def build(self) -> None:
        pass

    def query_k(self, q: np.ndarray, k: int, ef_search: int = 0) -> List[int]:
        q = np.asarray(q, np.float32)
        ef = max(ef_search or k, k)
        ep = self._descend(q, self.max_layer - 1, 0)
        res = self.search_layer(q, 0, [ep], ef)
        return [e for _, e in res[:k]]

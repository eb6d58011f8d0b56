"""Monotone hyperplane tree with Hilbert exclusion (Connor et al., TOIS 2016).

The paper's best-performing simple index (the "tree" mechanism, and the
re-index behind L_rei / N_rei).  Generic over the row space: pass any
(N, D) tensor plus a ``dist_fn(q, rows) -> (len,)`` tensor function:
original vectors with the original metric, apex tables with l2, LAESA
tables with Chebyshev.

Exclusion rules applied during descent (each independently sound):
  * range      : d(q, p_i) > r_i + t          (covering radius, any metric)
  * hyperbolic : (d(q,p_i) - d(q,p_j))/2 > t  (any metric)
  * hilbert    : |x_q - d12/2| > t where x_q = (dq1² + d12² - dq2²)/(2·d12)
                 (valid iff the row space has the four-point property:
                 true for l2 over apex rows, NOT for Chebyshev over LAESA
                 rows; the constructor takes this as ``supermetric``)

"Monotone": each child inherits the parent pivot nearest to it, so a query
descent costs ONE new distance per internal node.

The rows and every ``dist_fn`` call live on the rows' device; the recursion,
the pivot draws (``np.random.default_rng(seed)``, in the JAX package's
order, so both packages pick the same pivots) and the exclusion decisions
are host control flow, as in the JAX package's ``repro.index.hyperplane_tree``.
Each node's distances come back to the host, so a node costs a launch and a
device-to-host copy.
"""

from __future__ import annotations

import heapq
import sys
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.index.knn import knn_select
from repro_torch.index.stats import QueryStats

__all__ = ["HyperplaneTree"]

DistFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclass
class _Node:
    p1: int
    p2: int = -1
    d12: float = 0.0
    r1: float = 0.0
    r2: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    items: Optional[np.ndarray] = None  # leaf payload (row indices)

    @property
    def is_leaf(self) -> bool:
        return self.items is not None


class HyperplaneTree:
    def __init__(self, rows: torch.Tensor, dist_fn: DistFn, *, supermetric: bool = True,
                 leaf_size: int = 32, seed: int = 0):
        self.rows = rows
        self.dist_fn = dist_fn
        self.supermetric = supermetric
        self.leaf_size = leaf_size
        self._rng = np.random.default_rng(seed)
        self.build_calls = 0
        n = self.rows.shape[0]
        if n == 0:
            raise ValueError("empty index")
        root_p1 = int(self._rng.integers(n))
        items = np.arange(n)
        d = self._dist(self.rows[root_p1], items)
        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 100_000))
        try:
            self.root = self._build(items, root_p1, d)
        finally:
            sys.setrecursionlimit(old_limit)

    # -- distances -------------------------------------------------------------
    def _q(self, q_vec) -> torch.Tensor:
        if isinstance(q_vec, torch.Tensor):
            return q_vec.to(self.rows.device)
        return torch.as_tensor(np.asarray(q_vec), device=self.rows.device)

    def _to(self, q: torch.Tensor, items: np.ndarray) -> np.ndarray:
        """Host float64 distances from ``q`` to the rows ``items``."""
        rows = self.rows[torch.as_tensor(items, device=self.rows.device)]
        return self.dist_fn(q, rows).to(torch.float64).cpu().numpy()

    def _to_one(self, q: torch.Tensor, i: int) -> float:
        return float(self.dist_fn(q, self.rows[i:i + 1])[0])

    # -- build ---------------------------------------------------------------
    def _dist(self, q_vec, item_idx) -> np.ndarray:
        self.build_calls += len(item_idx)
        return self._to(q_vec, item_idx)

    def _build(self, items: np.ndarray, p1: int, d_p1: np.ndarray) -> _Node:
        if len(items) <= self.leaf_size:
            return _Node(p1=p1, items=items)
        # choose p2 among items at nonzero distance from p1 (duplicates of the
        # pivot cannot define a hyperplane)
        nz = np.where(d_p1 > 1e-12)[0]
        if len(nz) == 0:
            return _Node(p1=p1, items=items)
        pos2 = int(nz[self._rng.integers(len(nz))])
        p2 = int(items[pos2])
        d12 = float(d_p1[pos2])
        d_p2 = self._dist(self.rows[p2], items)
        left_mask = d_p1 <= d_p2
        # guard: degenerate split (all rows identical) -> leaf
        if left_mask.all() or (~left_mask).all():
            return _Node(p1=p1, items=items)
        li, ri = items[left_mask], items[~left_mask]
        node = _Node(
            p1=p1,
            p2=p2,
            d12=d12,
            r1=float(d_p1[left_mask].max()),
            r2=float(d_p2[~left_mask].max()),
        )
        node.left = self._build(li, p1, d_p1[left_mask])
        node.right = self._build(ri, p2, d_p2[~left_mask])
        return node

    # -- query ---------------------------------------------------------------
    def query(self, q_vec, threshold: float):
        """All row indices within ``threshold`` of ``q_vec`` in this row space.

        Returns (indices, QueryStats).  The distance calls land in
        ``stats.surrogate_calls`` (the caller knows whether those calls were
        original-space or surrogate).
        """
        idx, _, stats = self.query_with_distances(q_vec, threshold)
        return idx, stats

    def query_with_distances(self, q_vec, threshold: float):
        """Like ``query`` but also returns the row-space distances of hits:
        (indices, distances, QueryStats)."""
        q = self._q(q_vec)
        t = float(threshold)
        out_idx: List[np.ndarray] = []
        out_d: List[np.ndarray] = []
        calls = 1
        stack = [(self.root, self._to_one(q, self.root.p1))]
        while stack:
            node, dq1 = stack.pop()
            if node.is_leaf:
                d = self._to(q, node.items)
                calls += len(node.items)
                hit = d <= t
                out_idx.append(node.items[hit])
                out_d.append(d[hit])
                continue
            dq2 = self._to_one(q, node.p2)
            calls += 1
            skip_left = dq1 > node.r1 + t  # range
            skip_right = dq2 > node.r2 + t
            if self.supermetric and node.d12 > 1e-12:
                x_q = (dq1**2 + node.d12**2 - dq2**2) / (2.0 * node.d12)
                skip_left = skip_left or (x_q - node.d12 / 2.0 > t)
                skip_right = skip_right or (node.d12 / 2.0 - x_q > t)
            else:  # hyperbolic, valid in any metric
                skip_left = skip_left or ((dq1 - dq2) / 2.0 > t)
                skip_right = skip_right or ((dq2 - dq1) / 2.0 > t)
            if not skip_left:
                stack.append((node.left, dq1))
            if not skip_right:
                stack.append((node.right, dq2))
        if out_idx:
            idx = np.concatenate(out_idx)
            d = np.concatenate(out_d)
        else:
            idx = np.empty(0, dtype=np.int64)
            d = np.empty(0)
        stats = QueryStats(surrogate_calls=calls, candidates=int(len(idx)))
        return idx, d, stats

    # -- k-NN ----------------------------------------------------------------
    def knn(self, q_vec, k: int):
        """Exact k nearest rows by best-first branch-and-bound.

        Nodes are visited in order of their optimistic lower bound (covering
        radius + the hyperbolic/Hilbert half-plane bounds, whichever is
        tighter); a node is expanded only while its bound does not exceed the
        running k-th distance.

        Returns (ids, distances, QueryStats); ids sorted by (distance, id).
        """
        n = self.rows.shape[0]
        k = min(int(k), n)
        if k <= 0:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float64), QueryStats()
        q = self._q(q_vec)
        calls = 1
        evaluated = 0
        # cut = tau widened by an fp slack: node bounds are arithmetic over
        # computed distances, so a boundary tie can sit an ulp above tau
        tau, cut = np.inf, np.inf
        best_i = np.empty(0, dtype=np.int64)
        best_d = np.empty(0, dtype=np.float64)
        seq = 0                                   # heap tie-breaker
        heap = [(0.0, seq, self.root, self._to_one(q, self.root.p1))]
        while heap and heap[0][0] <= cut:
            lb, _, node, dq1 = heapq.heappop(heap)
            if node.is_leaf:
                d = self._to(q, node.items)
                calls += len(node.items)
                evaluated += len(node.items)
                best_i = np.concatenate([best_i, node.items.astype(np.int64)])
                best_d = np.concatenate([best_d, d])
                if best_d.shape[0] >= k:
                    # select even at exactly k: tau must be the k-th (i.e.
                    # largest kept) distance, and the buffer is unsorted
                    best_i, best_d = knn_select(best_d, best_i, k)
                    tau = float(best_d[-1])
                    cut = tau + 1e-9 * max(tau, 1.0)
                continue
            dq2 = self._to_one(q, node.p2)
            calls += 1
            lb_left = max(lb, dq1 - node.r1)      # covering radius
            lb_right = max(lb, dq2 - node.r2)
            if self.supermetric and node.d12 > 1e-12:
                x_q = (dq1**2 + node.d12**2 - dq2**2) / (2.0 * node.d12)
                lb_left = max(lb_left, x_q - node.d12 / 2.0)
                lb_right = max(lb_right, node.d12 / 2.0 - x_q)
            else:                                 # hyperbolic, any metric
                lb_left = max(lb_left, (dq1 - dq2) / 2.0)
                lb_right = max(lb_right, (dq2 - dq1) / 2.0)
            if lb_left <= cut:
                seq += 1
                heapq.heappush(heap, (lb_left, seq, node.left, dq1))
            if lb_right <= cut:
                seq += 1
                heapq.heappush(heap, (lb_right, seq, node.right, dq2))
        ids, dists = knn_select(best_d, best_i, k)
        return ids, dists, QueryStats(surrogate_calls=calls, candidates=evaluated)

    # -- serialization --------------------------------------------------------
    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Flatten the node graph into plain arrays (the JAX package's layout).

        Preorder layout: ``left[i]``/``right[i]`` hold child slots (-1 for
        leaves); leaf payloads live concatenated in ``items`` addressed by
        ``(leaf_off[i], leaf_len[i])`` with -1 offsets on internal nodes.
        """
        nodes: List[_Node] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            nodes.append(node)
            if not node.is_leaf:
                stack.append(node.right)
                stack.append(node.left)
        slot = {id(n): i for i, n in enumerate(nodes)}
        m = len(nodes)
        p1 = np.empty(m, dtype=np.int64)
        p2 = np.empty(m, dtype=np.int64)
        d12 = np.empty(m, dtype=np.float64)
        r1 = np.empty(m, dtype=np.float64)
        r2 = np.empty(m, dtype=np.float64)
        left = np.full(m, -1, dtype=np.int64)
        right = np.full(m, -1, dtype=np.int64)
        leaf_off = np.full(m, -1, dtype=np.int64)
        leaf_len = np.zeros(m, dtype=np.int64)
        payload: List[np.ndarray] = []
        off = 0
        for i, n in enumerate(nodes):
            p1[i], p2[i], d12[i], r1[i], r2[i] = n.p1, n.p2, n.d12, n.r1, n.r2
            if n.is_leaf:
                leaf_off[i] = off
                leaf_len[i] = len(n.items)
                payload.append(np.asarray(n.items, dtype=np.int64))
                off += len(n.items)
            else:
                left[i] = slot[id(n.left)]
                right[i] = slot[id(n.right)]
        items = np.concatenate(payload) if payload else np.empty(0, dtype=np.int64)
        return dict(
            tree_p1=p1, tree_p2=p2, tree_d12=d12, tree_r1=r1, tree_r2=r2,
            tree_left=left, tree_right=right,
            tree_leaf_off=leaf_off, tree_leaf_len=leaf_len, tree_items=items,
        )

    @classmethod
    def from_arrays(cls, rows: torch.Tensor, dist_fn: DistFn, arrays: Dict[str, np.ndarray], *,
                    supermetric: bool = True, leaf_size: int = 32, seed: int = 0) -> "HyperplaneTree":
        """Rebuild a tree from ``to_arrays`` output (either package's)
        without re-measuring."""
        tree = object.__new__(cls)
        tree.rows = rows
        tree.dist_fn = dist_fn
        tree.supermetric = bool(supermetric)
        tree.leaf_size = int(leaf_size)
        tree._rng = np.random.default_rng(seed)
        tree.build_calls = 0
        m = len(arrays["tree_p1"])
        nodes = [
            _Node(
                p1=int(arrays["tree_p1"][i]),
                p2=int(arrays["tree_p2"][i]),
                d12=float(arrays["tree_d12"][i]),
                r1=float(arrays["tree_r1"][i]),
                r2=float(arrays["tree_r2"][i]),
            )
            for i in range(m)
        ]
        items = np.asarray(arrays["tree_items"], dtype=np.int64)
        for i, node in enumerate(nodes):
            li, ri = int(arrays["tree_left"][i]), int(arrays["tree_right"][i])
            if li >= 0:
                node.left = nodes[li]
                node.right = nodes[ri]
            else:
                off = int(arrays["tree_leaf_off"][i])
                node.items = items[off: off + int(arrays["tree_leaf_len"][i])]
        tree.root = nodes[0]
        return tree

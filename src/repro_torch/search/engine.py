"""Exact search engine: the paper's five mechanisms behind one dispatcher.

  L_seq : LAESA table, full Chebyshev scan, recheck survivors.
  L_rei : hyperplane tree over LAESA rows (Chebyshev; hyperbolic+range
          exclusions: Chebyshev lacks the four-point property).
  N_seq : apex table, fused two-sided-bound scan; upb admits, recheck rest.
  N_rei : hyperplane tree over apex rows (l2; Hilbert exclusion), then upb
          admit / recheck.
  tree  : hyperplane tree over the original space with the original metric
          (Hilbert exclusion: all our metrics are supermetric).

Every mechanism is EXACT for both workloads: threshold results equal brute
force, and k-NN results equal the brute-force oracle including tie order
(ties broken by id).  Stats follow the paper's Table 3: original-space
calls (incl. the n pivot distances) and surrogate/re-indexed-space calls.

The JAX package's ``repro.search.engine`` on one device: the tables, the
trees' rows and every distance live there (N_seq runs the kernels K1-K4
and K6, and K5 for Jensen-Shannon wherever a JSD distance is measured); the
tree descents and the refinement loops are host control flow.  The
sequential mechanisms and the plain tree are protocol indexes (exposed in
``self.indexes``); only the two re-index combinations (a surrogate tree
stacked on a table) live here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.api.indexes import MetricTreeIndex, PivotTableIndex, SimplexTableIndex
from repro_torch.api.types import QueryResult, QueryStats
from repro_torch.core import select_pivots
from repro_torch.device import resolve_device
from repro_torch.index.hyperplane_tree import HyperplaneTree
from repro_torch.index.knn import knn_refine, knn_select
from repro_torch.index.laesa import LaesaIndex
from repro_torch.index.nsimplex_index import NSimplexIndex
from repro_torch.metrics import Metric, get_metric

__all__ = ["ExactSearchEngine", "MECHANISMS", "SearchReport"]

MECHANISMS = ("L_seq", "L_rei", "N_seq", "N_rei", "tree")


def _cheb(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return (rows - q[None, :]).abs().amax(dim=1)


def _l2(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    diff = rows - q[None, :]
    return torch.sqrt(torch.clamp_min(torch.einsum("ij,ij->i", diff, diff), 0.0))


@dataclass
class SearchReport:
    results: np.ndarray
    original_calls: int
    surrogate_calls: int
    accepted_no_check: int
    elapsed_s: float
    distances: Optional[np.ndarray] = None   # true distances (k-NN reports)


def _report(res: QueryResult, elapsed_s: float, *, knn: bool = False) -> SearchReport:
    ids = np.asarray(res.ids, dtype=np.int64)
    return SearchReport(
        results=ids if knn else np.sort(ids),
        original_calls=res.stats.original_calls,
        surrogate_calls=res.stats.surrogate_calls,
        accepted_no_check=res.stats.accepted_no_check,
        elapsed_s=elapsed_s,
        distances=res.distances,
    )


class ExactSearchEngine:
    """Builds every requested mechanism once over one (data, metric) pair
    on ``device`` ("cuda" by default; "cpu" only when passed).

    N_seq and N_rei always follow the JAX package's ``use_kernel=True``
    algorithm (the bound scan through K1-K3); there is no host scan to
    choose, so the engine takes no ``use_kernel``.

    ``build_s`` maps each built mechanism to the seconds of its own
    structure, the device synchronised: the table for L_seq / N_seq, the
    surrogate tree alone for L_rei / N_rei (on top of their table), the
    tree for ``tree``.
    """

    def __init__(
        self,
        data,
        metric: Union[Metric, str],
        *,
        n_pivots: int = 20,
        mechanisms=MECHANISMS,
        pivot_strategy: str = "random",
        leaf_size: int = 32,
        seed: int = 0,
        eps: float = 1e-6,
        device="cuda",
    ):
        self.device = resolve_device(device)
        data = np.asarray(data)
        self.data = torch.tensor(data, device=self.device)
        self.metric = metric = get_metric(metric) if isinstance(metric, str) else metric
        self.eps = eps
        self.mechanisms = tuple(mechanisms)
        self.laesa: Optional[LaesaIndex] = None
        self.nsimplex: Optional[NSimplexIndex] = None
        self.trees: Dict[str, HyperplaneTree] = {}
        #: mechanism -> repro_torch.api protocol index (the single-structure ones)
        self.indexes = {}
        self.build_s: Dict[str, float] = {}

        if any(m != "tree" for m in self.mechanisms):
            pivots = select_pivots(data, n_pivots, strategy=pivot_strategy, seed=seed, metric=metric)
        if "L_seq" in self.mechanisms or "L_rei" in self.mechanisms:
            t0 = time.perf_counter()
            self.laesa = LaesaIndex(data, pivots, metric, device=self.device)
            self.indexes["L_seq"] = PivotTableIndex(self.laesa, metric)
            self._built("L_seq", t0)
        if "N_seq" in self.mechanisms or "N_rei" in self.mechanisms:
            t0 = time.perf_counter()
            self.nsimplex = NSimplexIndex(data, pivots, metric, eps=eps, device=self.device)
            self.indexes["N_seq"] = SimplexTableIndex(self.nsimplex, metric)
            self._built("N_seq", t0)
        if "L_rei" in self.mechanisms:
            t0 = time.perf_counter()
            self.trees["L_rei"] = HyperplaneTree(
                self.laesa.table, _cheb, supermetric=False, leaf_size=leaf_size, seed=seed
            )
            self._built("L_rei", t0)
        if "N_rei" in self.mechanisms:
            t0 = time.perf_counter()
            self.trees["N_rei"] = HyperplaneTree(
                self.nsimplex.table, _l2, supermetric=True, leaf_size=leaf_size, seed=seed
            )
            self._built("N_rei", t0)
        if "tree" in self.mechanisms:
            t0 = time.perf_counter()
            self.indexes["tree"] = MetricTreeIndex.build(
                data, metric, leaf_size=leaf_size, seed=seed, device=self.device
            )
            self.trees["tree"] = self.indexes["tree"]._tree
            self._built("tree", t0)

    def _built(self, mechanism: str, t0: float) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.build_s[mechanism] = time.perf_counter() - t0

    def _check_mechanism(self, mechanism: str) -> None:
        if mechanism not in MECHANISMS:
            raise KeyError(f"unknown mechanism {mechanism!r}; one of {MECHANISMS}")
        built = mechanism in self.indexes if mechanism in ("L_seq", "N_seq", "tree") else mechanism in self.trees
        if not built:
            raise KeyError(
                f"mechanism {mechanism!r} was not built; this engine has {sorted(self.mechanisms)}"
            )

    def _q(self, q) -> torch.Tensor:
        return torch.as_tensor(np.asarray(q), device=self.device)

    # -- threshold search -----------------------------------------------------
    def search(self, mechanism: str, q, threshold: float) -> SearchReport:
        """Exact threshold search via one mechanism. Returns a SearchReport."""
        self._check_mechanism(mechanism)
        t0 = time.perf_counter()
        if mechanism in self.indexes:
            res = self.indexes[mechanism].search(q, threshold)
        elif mechanism == "L_rei":
            res = self._laesa_tree_search(q, threshold)
        else:  # N_rei
            res = self._nsimplex_tree_search(q, threshold)
        return _report(res, time.perf_counter() - t0)

    def search_batch(self, mechanism: str, queries, thresholds) -> List[SearchReport]:
        """Batched exact search: one SearchReport per query row.

        The sequential mechanisms (``L_seq``, ``N_seq``) filter the whole
        block in one scan; only per-query recheck sets touch the original
        metric.  Tree mechanisms batch the surrogate projection (pivot
        distances / apexes for all queries at once) and then descend per
        query, with the same original-space call counts.
        """
        self._check_mechanism(mechanism)
        queries = np.atleast_2d(np.asarray(queries))
        Q = queries.shape[0]
        thresholds = np.broadcast_to(np.asarray(thresholds, dtype=np.float64), (Q,))
        t0 = time.perf_counter()
        if mechanism in self.indexes:
            results = list(self.indexes[mechanism].search_batch(queries, thresholds))
        elif mechanism == "L_rei":
            qds = self.laesa.query_distances_batch(queries)
            results = [self._laesa_tree_search(q, t, qd=qd) for q, t, qd in zip(queries, thresholds, qds)]
        else:  # N_rei
            apexes = self.nsimplex.query_apex_batch(queries)
            results = [
                self._nsimplex_tree_search(q, t, apex=apex) for q, t, apex in zip(queries, thresholds, apexes)
            ]
        elapsed = time.perf_counter() - t0
        return [_report(res, elapsed / Q) for res in results]

    # -- k-NN -----------------------------------------------------------------
    def knn(self, mechanism: str, q, k: int) -> SearchReport:
        """Exact k nearest neighbours via one mechanism: ``results`` holds
        ids sorted by (distance, id), as the ``knn_brute`` oracle, and
        ``distances`` their true distances."""
        self._check_mechanism(mechanism)
        t0 = time.perf_counter()
        if mechanism in self.indexes:
            res = self.indexes[mechanism].knn(q, k)
        else:
            res = self._rei_knn(q, k, mechanism)
        return _report(res, time.perf_counter() - t0, knn=True)

    def knn_batch(self, mechanism: str, queries, k: int) -> List[SearchReport]:
        """Batched exact k-NN: one SearchReport per query row."""
        self._check_mechanism(mechanism)
        queries = np.atleast_2d(np.asarray(queries))
        Q = queries.shape[0]
        t0 = time.perf_counter()
        if mechanism in self.indexes:
            results = list(self.indexes[mechanism].knn_batch(queries, k))
        elif mechanism == "L_rei":
            qds = self.laesa.query_distances_batch(queries)
            results = [self._rei_knn(q, k, "L_rei", surrogate_q=qd) for q, qd in zip(queries, qds)]
        else:  # N_rei
            apexes = self.nsimplex.query_apex_batch(queries)
            results = [self._rei_knn(q, k, "N_rei", surrogate_q=apex) for q, apex in zip(queries, apexes)]
        elapsed = time.perf_counter() - t0
        return [_report(res, elapsed / Q, knn=True) for res in results]

    # -- brute-force oracles ---------------------------------------------------
    def brute_force(self, q, threshold: float) -> np.ndarray:
        d = self.metric.one_to_many(self._q(q), self.data).cpu().numpy()
        return np.where(d <= threshold)[0]

    def brute_force_batch(self, queries, thresholds) -> List[np.ndarray]:
        queries = np.atleast_2d(np.asarray(queries))
        thresholds = np.broadcast_to(np.asarray(thresholds, dtype=np.float64), (queries.shape[0],))
        D = self.metric.cross(self._q(queries), self.data).cpu().numpy()
        return [np.where(row <= t)[0] for row, t in zip(D, thresholds)]

    def knn_brute(self, q, k: int):
        """Oracle: exact k-NN by full scan. Returns (ids, distances) sorted
        by (distance, id), the tie order every mechanism must reproduce."""
        d = self.metric.one_to_many(self._q(q), self.data).cpu().numpy()
        return knn_select(d, np.arange(len(d), dtype=np.int64), min(k, len(d)))

    def knn_brute_batch(self, queries, k: int):
        return [self.knn_brute(q, k) for q in np.atleast_2d(np.asarray(queries))]

    # -- re-index combinations (surrogate tree over a table) -------------------
    # L_rei: tree over LAESA rows in Chebyshev space
    def _laesa_tree_search(self, q, threshold, qd=None) -> QueryResult:
        st = QueryStats()
        if qd is None:
            qd = self.laesa.query_distances(q)
        st.original_calls += self.laesa.n_pivots
        cand, tstats = self.trees["L_rei"].query(qd, threshold * (1.0 + self.eps) + 1e-12)
        st.surrogate_calls += tstats.surrogate_calls
        st.candidates = len(cand)
        if len(cand) == 0:
            return QueryResult(ids=np.empty(0, dtype=np.int64), stats=st)
        d = self.laesa._dist_fn(self._q(q))(cand)
        st.original_calls += len(cand)
        return QueryResult(ids=cand[d <= threshold], stats=st)

    # N_rei: tree over apex rows in l2 (supermetric => Hilbert exclusion),
    # then the upper bound admits results without recheck.
    def _nsimplex_tree_search(self, q, threshold, apex=None) -> QueryResult:
        st = QueryStats()
        ns = self.nsimplex
        if apex is None:
            apex = ns.query_apex(q)
        st.original_calls += ns.n_pivots
        cand, tstats = self.trees["N_rei"].query(apex, threshold * (1.0 + self.eps) + 1e-12)
        st.surrogate_calls += tstats.surrogate_calls
        st.candidates = len(cand)
        if len(cand) == 0:
            return QueryResult(ids=np.empty(0, dtype=np.int64), stats=st)
        upb = self._apex_upb(apex, cand)
        t_lo = threshold * (1.0 - self.eps) - 1e-12
        admit = upb <= t_lo
        st.accepted_no_check = int(admit.sum())
        accepted = cand[admit]
        recheck = cand[~admit]
        if len(recheck):
            d = ns._dist_fn(self._q(q))(recheck)
            st.original_calls += len(recheck)
            confirmed = recheck[d <= threshold]
        else:
            confirmed = np.empty(0, dtype=np.int64)
        return QueryResult(ids=np.concatenate([accepted, confirmed]), stats=st)

    def _apex_upb(self, apex: torch.Tensor, rows_idx: np.ndarray) -> np.ndarray:
        """Simplex upper bound of selected table rows against a query apex."""
        rows = self.nsimplex.table[torch.as_tensor(rows_idx, device=self.device)]
        head = ((rows[:, :-1] - apex[None, :-1]) ** 2).sum(dim=1)
        return torch.sqrt(torch.clamp_min(head + (rows[:, -1] + apex[-1]) ** 2, 0.0)).cpu().numpy()

    def _laesa_upb(self, qd: torch.Tensor, rows_idx: np.ndarray) -> np.ndarray:
        """Pivot triangle upper bound of selected LAESA rows."""
        rows = self.laesa.table[torch.as_tensor(rows_idx, device=self.device)]
        return LaesaIndex._tile_upb(qd[None, :], rows)[0].cpu().numpy()

    def _rei_knn(self, q, k: int, mechanism: str, surrogate_q=None) -> QueryResult:
        """Exact k-NN through a re-index tree, no full table scan.

        1. k-NN in the surrogate row space (lower-bounding distances) seeds
           an upper-bound radius from those k rows' table upper bounds;
        2. a surrogate tree threshold query at that radius yields every row
           whose true distance could beat it;
        3. shrinking-radius refinement over that candidate set (ascending
           surrogate lower bound) finds the exact answer.
        """
        st = QueryStats()
        if mechanism == "L_rei":
            table = self.laesa
            if surrogate_q is None:
                surrogate_q = table.query_distances(q)
            upb_of = self._laesa_upb
        else:
            table = self.nsimplex
            if surrogate_q is None:
                surrogate_q = table.query_apex(q)
            upb_of = self._apex_upb
        st.original_calls += table.n_pivots
        tree = self.trees[mechanism]
        k_eff = min(int(k), self.data.shape[0])
        if k_eff <= 0:
            return QueryResult(ids=np.empty(0, dtype=np.int64), distances=np.empty(0, dtype=np.float64), stats=st)
        # 1. seed radius from the surrogate k-NN's upper bounds
        seed_ids, _, tstats = tree.knn(surrogate_q, k_eff)
        st.surrogate_calls += tstats.surrogate_calls
        radius = float(np.max(upb_of(surrogate_q, seed_ids)))
        slack = self.eps * radius + 1e-12
        # 2. candidates: every row whose surrogate lower bound beats radius
        cand, lwb_c, qstats = tree.query_with_distances(surrogate_q, radius + slack)
        st.surrogate_calls += qstats.surrogate_calls
        st.candidates = len(cand)
        order = np.argsort(cand, kind="stable")   # id order => stable tie-break
        cand, lwb_c = cand[order], lwb_c[order]
        # 3. refine exactly over the candidate set
        dist = table._dist_fn(self._q(q))
        pos, d, n_eval, _ = knn_refine(
            lambda p: dist(cand[p]),
            lwb_c,
            upb_of(surrogate_q, cand),
            k_eff,
            slack=slack,
        )
        st.original_calls += n_eval
        return QueryResult(ids=cand[pos], distances=d, stats=st)

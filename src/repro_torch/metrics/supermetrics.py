"""Supermetric distance functions on tensors.

The same five metrics as the JAX package (Euclidean, cosine chord,
sqrt-Jensen-Shannon in bits, sqrt half triangular discrimination, and the
quadratic form), each with two functions that run on the device their
operands lie on:

* ``one_to_many(q, X)`` — distances from one vector to each row of ``X``.
* ``cross(X, Y)``       — the (B, M) cross-distance matrix, always float64.

Their dtypes follow the reference's host forms (``one_to_many_np`` /
``cross_np``), which the index uses for pivot distances and refinement:

* ``cross`` upcasts to float64 for every metric;
* ``one_to_many`` upcasts to float64 for cosine, Jensen-Shannon,
  triangular and the quadratic form, but Euclidean keeps the operands'
  promoted dtype: a float32 corpus is refined in float32, exactly as the
  reference does.

Jensen-Shannon goes through ``repro_torch.kernels.jsd_pairwise`` in
float64: the kernel K5 on CUDA tensors, its plain version on the CPU.  That
covers the index's pivot fit, table build, query pivot distances and
refinement.  Only ``one_to_many`` on the CPU keeps the elementwise form of
the JAX package's host ``one_to_many_np``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import jsd_pairwise
from repro_torch.kernels.ref import xlogx as _xlogx

__all__ = [
    "Metric",
    "EuclideanMetric",
    "CosineMetric",
    "JensenShannonMetric",
    "TriangularMetric",
    "QuadraticFormMetric",
    "METRIC_REGISTRY",
    "PARAMETRIC_METRICS",
    "get_metric",
    "metric_to_config",
    "metric_from_config",
]

_EPS = 1e-12
_LN2 = float(np.log(2.0))


def _f64(x: torch.Tensor) -> torch.Tensor:
    return torch.atleast_2d(x).to(torch.float64)


class Metric:
    """Base class: implement ``one_to_many``; ``cross`` derives from it."""

    name: str = "abstract"
    #: True when the metric is defined on nonnegative (histogram-like) data.
    requires_nonnegative: bool = False

    #: element budget for the (chunk, M, d) temporaries of the broadcast
    #: cross forms; the row chunk is derived from it so memory stays bounded
    _CROSS_BUDGET_ELEMS = 1 << 23

    def _cross_chunk_rows(self, M: int, d: int) -> int:
        return max(1, self._CROSS_BUDGET_ELEMS // max(1, M * d))

    def one_to_many(self, q: torch.Tensor, X: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def cross(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """Float64 (B, M) cross distances: one ``one_to_many`` row per query."""
        X, Y = _f64(X), _f64(Y)
        out = torch.empty((X.shape[0], Y.shape[0]), dtype=torch.float64, device=X.device)
        for i in range(X.shape[0]):
            out[i] = self.one_to_many(X[i], Y)
        return out

    def cost_flops(self, dim: int) -> float:
        return 3.0 * dim

    def __repr__(self):
        return f"{type(self).__name__}()"


class EuclideanMetric(Metric):
    name = "euclidean"

    def one_to_many(self, q, X):
        diff = X - q[None, :]
        return torch.sqrt(torch.clamp_min((diff * diff).sum(dim=1), 0.0))

    def cross(self, X, Y):
        X, Y = _f64(X), _f64(Y)
        x2 = (X * X).sum(dim=1)[:, None]
        y2 = (Y * Y).sum(dim=1)[None, :]
        d2 = x2 + y2 - 2.0 * (X @ Y.T)
        # the GEMM identity cancels catastrophically when d << |x|,|y|;
        # recompute those (rare) near-coincident pairs in difference form so
        # tiny distances keep full relative accuracy
        tiny = d2 < 1e-10 * (x2 + y2)
        if bool(tiny.any()):
            i, j = torch.nonzero(tiny, as_tuple=True)
            diff = X[i] - Y[j]
            d2[i, j] = (diff * diff).sum(dim=1)
        return torch.sqrt(torch.clamp_min(d2, 0.0))


def _l2_normalise(X: torch.Tensor) -> torch.Tensor:
    return X / torch.clamp_min(torch.linalg.vector_norm(X, dim=-1, keepdim=True), _EPS)


class CosineMetric(Metric):
    """Chord distance: Euclidean distance between L2-normalised vectors."""

    name = "cosine"

    def one_to_many(self, q, X):
        qn = _l2_normalise(q.to(torch.float64))
        Xn = _l2_normalise(_f64(X))
        cos = torch.clamp(Xn @ qn, -1.0, 1.0)
        return torch.sqrt(torch.clamp_min(2.0 - 2.0 * cos, 0.0))

    def cross(self, X, Y):
        Xn = _l2_normalise(_f64(X))
        Yn = _l2_normalise(_f64(Y))
        cos = torch.clamp(Xn @ Yn.T, -1.0, 1.0)
        return torch.sqrt(torch.clamp_min(2.0 - 2.0 * cos, 0.0))

    def cost_flops(self, dim: int) -> float:
        return 5.0 * dim


def _l1_normalise(X: torch.Tensor) -> torch.Tensor:
    return X / torch.clamp_min(X.sum(dim=-1, keepdim=True), _EPS)


class JensenShannonMetric(Metric):
    """sqrt of base-2 Jensen-Shannon divergence over probability vectors.

    Inputs are L1-normalised internally, so raw histograms are accepted.
    """

    name = "jensen_shannon"
    requires_nonnegative = True

    def one_to_many(self, q, X):
        if X.is_cuda:
            return jsd_pairwise(q.to(torch.float64)[None, :], _f64(X))[0]
        p = _l1_normalise(q.to(torch.float64))[None, :]
        Q = _l1_normalise(_f64(X))
        m = 0.5 * (p + Q)
        jsd_nats = (0.5 * _xlogx(p) + 0.5 * _xlogx(Q) - _xlogx(m)).sum(dim=1)
        return torch.sqrt(torch.clamp(jsd_nats / _LN2, 0.0, 1.0))

    def cross(self, X, Y):
        return jsd_pairwise(_f64(X), _f64(Y))

    def cost_flops(self, dim: int) -> float:
        # three transcendental logs per component; ~30 flops-equivalent each
        return 100.0 * dim


def _triangular_terms(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    num = (P - Q) ** 2
    den = P + Q
    return torch.where(den > _EPS, num / torch.clamp_min(den, _EPS), 0.0).sum(dim=-1)


class TriangularMetric(Metric):
    """sqrt of (half the) triangular discrimination over probability vectors."""

    name = "triangular"
    requires_nonnegative = True

    def one_to_many(self, q, X):
        p = _l1_normalise(q.to(torch.float64))[None, :]
        td = _triangular_terms(p, _l1_normalise(_f64(X)))
        return torch.sqrt(torch.clamp(0.5 * td, 0.0, 1.0))

    def cross(self, X, Y):
        P = _l1_normalise(_f64(X))
        Q = _l1_normalise(_f64(Y))
        out = torch.empty((P.shape[0], Q.shape[0]), dtype=torch.float64, device=P.device)
        chunk = self._cross_chunk_rows(Q.shape[0], Q.shape[1])
        for lo in range(0, P.shape[0], chunk):
            hi = min(lo + chunk, P.shape[0])
            td = _triangular_terms(P[lo:hi, None, :], Q[None, :, :])
            out[lo:hi] = torch.clamp(0.5 * td, 0.0, 1.0)
        return torch.sqrt(out)

    def cost_flops(self, dim: int) -> float:
        return 6.0 * dim


class QuadraticFormMetric(Metric):
    """d(x, y) = sqrt((x-y)^T W (x-y)) for PSD W, evaluated in float64."""

    name = "quadratic_form"

    def __init__(self, W):
        self.W = np.asarray(W, dtype=np.float64)
        self._W_on = {}

    def _w(self, device: torch.device) -> torch.Tensor:
        w = self._W_on.get(device)
        if w is None:
            w = self._W_on[device] = torch.as_tensor(self.W, device=device)
        return w

    def one_to_many(self, q, X):
        diff = _f64(X) - q.to(torch.float64)[None, :]
        d2 = ((diff @ self._w(diff.device)) * diff).sum(dim=1)
        return torch.sqrt(torch.clamp_min(d2, 0.0))

    def cost_flops(self, dim: int) -> float:
        return 2.0 * dim * dim

    @staticmethod
    def random(dim: int, seed: int = 0, conditioning: float = 0.1):
        rng = np.random.default_rng(seed)
        A = rng.normal(size=(dim, dim)) / np.sqrt(dim)
        return QuadraticFormMetric(A @ A.T + conditioning * np.eye(dim))


METRIC_REGISTRY = {
    "euclidean": EuclideanMetric,
    "cosine": CosineMetric,
    "jensen_shannon": JensenShannonMetric,
    "jsd": JensenShannonMetric,
    "triangular": TriangularMetric,
}

#: parameterised metrics resolvable by name but needing kwargs
PARAMETRIC_METRICS = {"quadratic_form": "W=<PSD matrix> (or dim=<int>[, seed=<int>])"}


def metric_to_config(metric: Metric) -> dict:
    """JSON-able description of a metric, for index manifests; the quadratic
    form's ``W`` rides under ``"arrays"`` for the npz beside the manifest."""
    cfg = {"name": metric.name}
    if isinstance(metric, QuadraticFormMetric):
        cfg["arrays"] = {"metric_W": np.asarray(metric.W, dtype=np.float64)}
    return cfg


def metric_from_config(cfg: dict, arrays=None) -> Metric:
    """Inverse of ``metric_to_config``; ``arrays`` is the npz mapping."""
    name = cfg["name"]
    if name == "quadratic_form":
        if arrays is None or "metric_W" not in arrays:
            raise KeyError("quadratic_form metric needs the saved metric_W array")
        return QuadraticFormMetric(np.asarray(arrays["metric_W"]))
    return get_metric(name)


def get_metric(name: str, **kwargs) -> Metric:
    if name == "quadratic_form":
        if "W" in kwargs:
            return QuadraticFormMetric(kwargs["W"])
        if "dim" in kwargs:
            return QuadraticFormMetric.random(kwargs["dim"], kwargs.get("seed", 0))
        raise ValueError(
            "get_metric('quadratic_form') needs "
            f"{PARAMETRIC_METRICS['quadratic_form']}; e.g. "
            "get_metric('quadratic_form', dim=8) or "
            "get_metric('quadratic_form', W=my_psd_matrix)"
        )
    try:
        return METRIC_REGISTRY[name]()
    except KeyError:
        parametric = ", ".join(
            f"{n} (needs {req})" for n, req in sorted(PARAMETRIC_METRICS.items())
        )
        raise KeyError(
            f"unknown metric {name!r}; available: {sorted(METRIC_REGISTRY)} + {parametric}"
        ) from None

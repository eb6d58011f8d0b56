"""Two-sided n-simplex distance bounds (paper §4.2) on tensors.

For apexes ``x = φ_n(s1)``, ``y = φ_n(s2)``:

    lwb(x, y) = sqrt( Σ_{i<n} (x_i - y_i)^2 + (x_n - y_n)^2 )   (= plain l2)
    upb(x, y) = sqrt( Σ_{i<n} (x_i - y_i)^2 + (x_n + y_n)^2 )

Both share the first ``n-1`` accumulator terms, so the fused computation
costs one l2 evaluation.  ``mean_bound`` is the (lwb+upb)/2 estimator of the
approximate path.  ``dims=k`` evaluates the k-prefix (truncated-apex)
bounds: the first ``k-1`` coordinates and the altitude folded from the tail,
``alt_k = sqrt(Σ_{i>=k} x_i²)``; lwb is non-decreasing and upb
non-increasing in k (Lemma 2).

Plain functions with broadcasting over leading dimensions, as the JAX
package's ``repro.core.bounds``; they take tensors (numpy arrays are
converted) and work in the operands' dtype on their device.
"""

from __future__ import annotations

import torch

__all__ = [
    "ACCEPT",
    "EXCLUDE",
    "RECHECK",
    "filter_decisions",
    "lower_bound",
    "mean_bound",
    "truncate_apexes",
    "two_sided",
    "upper_bound",
]

# decision codes for exact threshold search
EXCLUDE, RECHECK, ACCEPT = 0, 1, 2


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def truncate_apexes(x, dims: int) -> torch.Tensor:
    """Fold (..., n) apexes to their (..., dims) truncated form: the first
    ``dims - 1`` head coordinates, then the k-pivot altitude
    ``sqrt(Σ_{i >= dims} x_i²)``.  Identity when the input is already
    ``dims`` wide."""
    x = _t(x)
    n = x.shape[-1]
    if not (2 <= dims <= n):
        raise ValueError(f"dims must be in [2, {n}]; got {dims}")
    if dims == n:
        return x
    tail_sq = (x[..., dims - 1:] ** 2).sum(dim=-1, keepdim=True)
    return torch.cat([x[..., : dims - 1], torch.sqrt(torch.clamp_min(tail_sq, 0.0))], dim=-1)


def two_sided(x, y, *, dims: int | None = None):
    """Fused (lwb, upb); broadcasts (..., n) against (..., n).  ``dims=k``
    gives the k-prefix bounds instead."""
    x, y = _t(x), _t(y)
    if dims is not None:
        x = truncate_apexes(x, dims)
        y = truncate_apexes(y, dims)
    head = ((x[..., :-1] - y[..., :-1]) ** 2).sum(dim=-1)
    last_m = (x[..., -1] - y[..., -1]) ** 2
    last_p = (x[..., -1] + y[..., -1]) ** 2
    lwb = torch.sqrt(torch.clamp_min(head + last_m, 0.0))
    upb = torch.sqrt(torch.clamp_min(head + last_p, 0.0))
    return lwb, upb


def lower_bound(x, y, *, dims: int | None = None) -> torch.Tensor:
    return two_sided(x, y, dims=dims)[0]


def upper_bound(x, y, *, dims: int | None = None) -> torch.Tensor:
    return two_sided(x, y, dims=dims)[1]


def mean_bound(x, y, *, dims: int | None = None) -> torch.Tensor:
    lwb, upb = two_sided(x, y, dims=dims)
    return 0.5 * (lwb + upb)


def filter_decisions(query_apex, table, threshold, *, eps_rel=1e-5, eps_abs=1e-6) -> torch.Tensor:
    """Per-row 3-way decision for exact search with float-safety slack.

    EXCLUDE: lwb > t (cannot be a result); the slack ensures no false exclusion.
    ACCEPT : upb <= t (a guaranteed result, no recheck needed).
    RECHECK: straddles; must be verified in the original space.
    """
    query_apex, table = _t(query_apex), _t(table)
    lwb, upb = two_sided(query_apex[None, :], table)
    t = torch.as_tensor(threshold, dtype=lwb.dtype, device=lwb.device)
    hi = t * (1.0 + eps_rel) + eps_abs
    lo = t * (1.0 - eps_rel) - eps_abs
    return torch.where(lwb > hi, EXCLUDE, torch.where(upb <= lo, ACCEPT, RECHECK))

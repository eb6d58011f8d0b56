"""Launch-plan tuner of the bound-scan kernels K1, K2 and K3: sweep,
validate, time, cache.

The knobs are the wrappers' own launch-plan parameters (``kernels/ops.py``):

  * K1 (``apex_bounds_batch``): ``plan``, one of ``"stream"`` (one thread
    per row, the default) and ``"tile"`` (the first design);
  * K2 (``apex_topk``) and K3 (``apex_threshold``): ``max_group``, the
    largest query group G a block scans for (K3 also takes 0, one query per
    block, the first design), and the slice rule: enough row slices for
    ``waves`` waves of blocks over the card's SMs, each slice at least
    ``slice_rows`` rows (``ops._slices``).

Like the JAX package's tile tuner, the sweep is keyed by
``(kernel, n_pivots, dims, dtype)``: Q and N only scale the grid, and the
plan functions turn a config into a plan for the Q and N at hand, so a
winner transfers across them.  Each candidate is VALIDATED against the
plain versions before it is timed — a fast wrong plan never wins — and
the winner is persisted in a small versioned JSON cache.  K1 is held to
``ref.apex_bounds_batch_ref`` within K1's tolerance.  K2 and K3 are held
bit for bit to the plain selections of ``ref.apex_topk_ref`` and
``ref.apex_threshold_ref`` (``ref.topk_from_bounds``,
``ref.threshold_from_bounds``) over K1's own bound matrices: on the card
K1, K2 and K3 share one rounded bound routine, while the plain K1 rounds
in another order (the GEMM form), so the plain versions' bounds differ from
the kernels' in the last ulp.  On the CPU K1 is its plain version, and the
references are ``apex_topk_ref`` and ``apex_threshold_ref`` themselves.

Lookup discipline (``lookup``):

  * a cache hit for the exact key returns the stored winner;
  * anything else — no cache file, a corrupt file, an old schema, an
    unknown key, an invalid entry — falls back to ``DEFAULT_CONFIG``, the
    plans the wrappers launch without a cache.  Lookup never raises and
    never tunes; tuning is an explicit step (``autotune``).
  * the wrappers consult it only for tensors on a CUDA device and only when
    no private ``_plan`` is passed; the CPU path (the plain versions) never
    reads the cache.

The winner is the smallest measured time, ties broken by the config's
order ``(plan, max_group, waves, slice_rows)`` — deterministic for a fixed
timer.  The cache lives at ``$REPRO_TORCH_KERNEL_TUNE_CACHE``, else
``~/.cache/repro_torch/kernel_tuning.json``.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import asdict, dataclass
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "KernelConfig",
    "DEFAULT_CONFIG",
    "KERNELS",
    "TUNE_SCHEMA_VERSION",
    "TuningCache",
    "autotune",
    "candidate_space",
    "default_cache_path",
    "lookup",
    "make_key",
    "reset_lookup_memo",
]

#: bump when the cache payload shape changes; older files are ignored whole
TUNE_SCHEMA_VERSION = 1

#: environment override for the cache location
CACHE_ENV_VAR = "REPRO_TORCH_KERNEL_TUNE_CACHE"

#: the tunable kernels, by their ``ops.LAUNCHES`` names
KERNELS = ("apex_bounds_batch", "apex_topk", "apex_threshold")

#: the SM count plans are computed for when the tensors lie on the CPU
#: (where the plain versions ignore the plan): the H100 SXM's
_CPU_SMS = 132


@dataclass(frozen=True, order=True)
class KernelConfig:
    """One point of the sweep.  K1 reads ``plan``; K2 and K3 read the rest."""

    plan: str = "stream"
    max_group: int = 32
    waves: int = 2
    slice_rows: int = 8192

    def validate(self) -> "KernelConfig":
        from repro_torch.kernels.ops import _K1_PLANS, _TOPK_MAX_GROUP

        if (
            self.plan not in _K1_PLANS
            or not 0 <= int(self.max_group) <= _TOPK_MAX_GROUP
            or int(self.waves) < 1
            or int(self.slice_rows) < 1
        ):
            raise ValueError(f"invalid kernel config: {self}")
        return KernelConfig(str(self.plan), int(self.max_group), int(self.waves), int(self.slice_rows))


#: the plans every wrapper launches with no cache file
DEFAULT_CONFIG = KernelConfig()


def default_cache_path() -> str:
    return os.environ.get(CACHE_ENV_VAR) or os.path.expanduser("~/.cache/repro_torch/kernel_tuning.json")


def _dtype_name(dtype) -> str:
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else np.dtype(dtype).name


def make_key(kernel: str, n_pivots: int, dims: Optional[int], dtype) -> str:
    """Cache key: the kernel and the facts that change its inner geometry
    (the table's row width, the bound's head width, the element type)."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    d = int(n_pivots if dims is None else dims)
    return f"{kernel}/n{int(n_pivots)}/d{d}/{_dtype_name(dtype)}"


class TuningCache:
    """Versioned on-disk winner cache with atomic writes.

    The file is one JSON object: ``{"schema_version": V, "entries": {key:
    {"plan", "max_group", "waves", "slice_rows", "us_per_call"}}}``.  Any
    parse error, wrong schema or malformed entry reads as a miss.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self._entries: dict = {}
        self._loaded = False

    def load(self) -> "TuningCache":
        self._loaded = True
        self._entries = {}
        try:
            with open(self.path) as f:
                payload = json.load(f)
            if payload.get("schema_version") != TUNE_SCHEMA_VERSION:
                return self
            entries = payload.get("entries")
            if isinstance(entries, dict):
                self._entries = entries
        except (OSError, ValueError, AttributeError):
            pass
        return self

    def save(self) -> str:
        """Atomic write (a temporary file, then a rename)."""
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        payload = {"schema_version": TUNE_SCHEMA_VERSION, "entries": self._entries}
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path) or ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return self.path

    def get(self, key: str) -> Optional[KernelConfig]:
        if not self._loaded:
            self.load()
        entry = self._entries.get(key)
        if not isinstance(entry, dict):
            return None
        try:
            return KernelConfig(plan=entry["plan"], max_group=entry["max_group"], waves=entry["waves"],
                                slice_rows=entry["slice_rows"]).validate()
        except (KeyError, TypeError, ValueError):
            return None

    def put(self, key: str, config: KernelConfig, us_per_call: float = float("nan")):
        if not self._loaded:
            self.load()
        self._entries[key] = {**asdict(config.validate()), "us_per_call": float(us_per_call)}

    def keys(self) -> Tuple[str, ...]:
        if not self._loaded:
            self.load()
        return tuple(sorted(self._entries))


# -- lookup (the launch-path entry point) ---------------------------------------
_LOOKUP_MEMO: dict = {}


def reset_lookup_memo() -> None:
    """Drop the in-process lookup memo (tests; after re-tuning)."""
    _LOOKUP_MEMO.clear()


def lookup(kernel: str, n_pivots: int, dims: Optional[int], dtype, *, path: Optional[str] = None) -> KernelConfig:
    """The cached winner for this key, or ``DEFAULT_CONFIG`` — never raises.
    Memoised per (cache path, key) until ``reset_lookup_memo``."""
    memo_key = (path or os.environ.get(CACHE_ENV_VAR), kernel, n_pivots, dims, dtype)
    config = _LOOKUP_MEMO.get(memo_key)
    if config is not None:
        return config
    try:
        config = TuningCache(path or default_cache_path()).get(make_key(kernel, n_pivots, dims, dtype))
    except Exception:  # noqa: BLE001 - the launch path must never fail on the cache
        config = None
    config = config or DEFAULT_CONFIG
    _LOOKUP_MEMO[memo_key] = config
    return config


# -- sweeping -------------------------------------------------------------------
def candidate_space(N: int, Q: int, *, kernel: str = "apex_bounds_batch",
                    quick: bool = False) -> Tuple[KernelConfig, ...]:
    """The sweep grid of ``kernel`` for an (N, Q) problem.  Groups larger
    than Q and slices longer than N change nothing, so they are left out;
    ``DEFAULT_CONFIG`` is always in the space, so the sweep can never pick
    worse than the default."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    from repro_torch.kernels.ops import _K1_PLANS

    out = {DEFAULT_CONFIG}
    if kernel == "apex_bounds_batch":
        out.update(KernelConfig(plan=p) for p in _K1_PLANS)
        return tuple(sorted(out))
    groups = (1, 8, 32) if quick else (1, 2, 4, 8, 16, 32)
    if kernel == "apex_threshold":
        groups = (0,) + groups
    waves = (1, 2) if quick else (1, 2, 4)
    rows = (2048, 8192) if quick else (2048, 8192, 32768)
    for g in groups:
        if g > max(1, Q):
            continue
        for w in waves:
            for r in rows:
                if r > max(2048, N):
                    continue
                out.add(KernelConfig(max_group=g, waves=w, slice_rows=r))
    return tuple(sorted(out))


def _cuda_timer(thunk: Callable[[], object], config: KernelConfig, reps: int = 20) -> float:
    """Seconds per call from CUDA events over ``reps`` calls, after a warmup."""
    import torch

    thunk()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        thunk()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps / 1e3


def _wall_timer(thunk: Callable[[], object], config: KernelConfig) -> float:
    """Median-of-3 host seconds per call after a warmup (CPU tensors)."""
    thunk()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        thunk()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _k1_agrees(got, want) -> bool:
    """K1's tolerance: rtol = atol = 2e-5 (f32) or 1e-12 (f64) against the
    plain version, and the sandwich lwb <= upb."""
    import torch

    (lwb, upb), (rl, ru) = got, want
    tol = 1e-12 if lwb.dtype == torch.float64 else 2e-5
    return bool(torch.allclose(lwb, rl, rtol=tol, atol=tol) and torch.allclose(upb, ru, rtol=tol, atol=tol)
                and (lwb <= upb).all())


def _exact(got, want) -> bool:
    import torch

    return all(torch.equal(g, w) for g, w in zip(got, want))


def _validate_against_ref(kernel: str, got, want) -> bool:
    """A candidate is admissible only if it reproduces the plain version:
    K1 within its tolerance, K2 and K3 bit for bit (ids, bounds, counts) to
    the plain selection over K1's bounds."""
    return _k1_agrees(got, want) if kernel == "apex_bounds_batch" else _exact(got, want)


def _plan_of(kernel: str, config: KernelConfig, table, Q: int, width: int):
    """The ``_plan`` a wrapper takes for ``config`` at this problem."""
    from repro_torch.kernels import ops

    if kernel == "apex_bounds_batch":
        return config.plan
    sms = ops._sm_count(table.device.index or 0) if table.is_cuda else _CPU_SMS
    plan = ops.topk_plan if kernel == "apex_topk" else ops.threshold_plan
    return plan(width, Q, table.shape[0], sms, config)


def autotune(
    table,
    queries,
    *,
    kernel: str = "apex_bounds_batch",
    dims: Optional[int] = None,
    k: int = 10,
    key: str = "upb",
    cap: int = 512,
    thresholds=None,
    candidates: Optional[Iterable[KernelConfig]] = None,
    timer: Optional[Callable[[Callable[[], object], KernelConfig], float]] = None,
    cache: Optional[TuningCache] = None,
    save: bool = True,
) -> Tuple[KernelConfig, Sequence[dict]]:
    """Sweep ``kernel``'s candidates on a representative problem; return
    the winner and the per-candidate report.

    ``table`` (N, n) and ``queries`` (Q, n or dims) are tensors on the
    device to tune (a CUDA card; CPU tensors run the plain versions, for
    tests of the sweep's logic).  K2 selects ``k`` rows by ``key``, K3 up to
    ``cap`` rows under ``thresholds`` (one per query).  Every candidate is
    run once and checked against the plain version before it is timed;
    one that fails (or raises) is recorded invalid and never wins.
    Candidates that give the same launch plan are timed once.  The winner
    is the min over valid candidates by ``(time, config)``.  ``cache``
    persists it under ``make_key(kernel, n_pivots, dims, dtype)`` when
    ``save`` is true.
    """
    import torch

    from repro_torch.kernels import ops, ref

    queries = torch.atleast_2d(queries)
    N, n_pivots = table.shape
    Q = queries.shape[0]
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    if kernel == "apex_bounds_batch":
        width = 0

        def call(plan):
            return ops.apex_bounds_batch(table, queries, dims=dims, _plan=plan)

        want = ref.apex_bounds_batch_ref(table, queries, n_pivots if dims is None else int(dims))
    else:
        lwb, upb = ops.apex_bounds_batch(table, queries, dims=dims)     # K1's own bounds
    if kernel == "apex_topk":
        width = int(min(k, N))

        def call(plan):
            return ops.apex_bounds_topk(table, queries, width, key=key, dims=dims, _plan=plan)

        want = ref.topk_from_bounds(lwb, upb, width, key)
        del lwb, upb
    elif kernel == "apex_threshold":
        width = int(min(cap, N))
        if thresholds is None:
            raise ValueError("autotune of apex_threshold needs thresholds")
        thresholds = torch.as_tensor(thresholds, dtype=torch.float32, device=table.device).reshape(-1)

        def call(plan):
            return ops.apex_bounds_threshold(table, queries, thresholds, width, dims=dims, _plan=plan)

        want = ref.threshold_from_bounds(lwb, upb, thresholds, width)
        del lwb, upb
    if candidates is None:
        candidates = candidate_space(N, Q, kernel=kernel)
    if timer is None:
        timer = _cuda_timer if table.is_cuda else _wall_timer

    rows = []
    timed: list = []
    seconds_by_plan: dict = {}
    for config in candidates:
        config = config.validate()
        plan = _plan_of(kernel, config, table, Q, width)
        row = {**asdict(config), "launch": list(plan) if isinstance(plan, tuple) else plan, "valid": False,
               "us_per_call": float("inf")}
        try:
            row["valid"] = _validate_against_ref(kernel, call(plan), want)
        except Exception as exc:  # noqa: BLE001 - a plan the kernel refuses is invalid, not fatal
            row["error"] = f"{type(exc).__name__}: {exc}"
        if row["valid"]:
            if plan not in seconds_by_plan:
                seconds_by_plan[plan] = float(timer(lambda p=plan: call(p), config))
            row["us_per_call"] = seconds_by_plan[plan] * 1e6
            timed.append((row["us_per_call"], config))
        rows.append(row)

    if not timed:
        raise RuntimeError(f"autotune: no candidate validated against the plain version (swept {len(rows)})")
    winner_us, winner = min(timed)
    if cache is not None:
        cache.put(make_key(kernel, n_pivots, dims, table.dtype), winner, winner_us)
        if save:
            cache.save()
        reset_lookup_memo()
    return winner, rows

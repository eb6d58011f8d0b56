"""Admission control in the port (``repro_torch.serve.admission``).

Twins every test of the JAX package's ``tests/test_admission.py`` (token
buckets under an injected clock, the shed order, degradation of
``mode="auto"`` specs only), then holds the port's decisions to the JAX
package's: for the same sequence of queue depths, wait estimates, deadlines,
specs and token-bucket clock, both controllers return the same verdicts
(admitted, reason, retry-after and wait estimate exactly, degraded spec
equal field for field) and the same counters.
"""

import pytest

from repro import api as rapi
from repro import serve as rserve
from repro_torch.api import Query
from repro_torch.serve import AdmissionController, AdmissionRejected, TokenBucket
from repro_torch.serve.admission import DEFAULT_DEGRADE_REFINE


class _Clock:
    """Manually-advanced monotonic clock."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _StubService:
    """Queue-depth / wait-estimate stub standing in for a SearchService."""

    def __init__(self, depth=0, wait_s=0.0):
        self.depth = depth
        self.wait_s = wait_s

    def queue_depth(self):
        return self.depth

    def estimated_wait_s(self):
        return self.wait_s


class TestTokenBucket:
    def test_burst_then_rate(self):
        clock = _Clock()
        bucket = TokenBucket(rate=10.0, burst=3, clock=clock)
        assert [bucket.try_acquire() for _ in range(3)] == [0.0, 0.0, 0.0]
        wait = bucket.try_acquire()           # bucket empty
        assert wait == pytest.approx(0.1)     # 1 token / 10 per s
        clock.advance(0.1)
        assert bucket.try_acquire() == 0.0    # refilled exactly one token

    def test_refill_caps_at_burst(self):
        clock = _Clock()
        bucket = TokenBucket(rate=100.0, burst=2, clock=clock)
        clock.advance(60.0)                   # idle forever: still only burst
        assert bucket.try_acquire() == 0.0
        assert bucket.try_acquire() == 0.0
        assert bucket.try_acquire() > 0.0

    def test_validates(self):
        with pytest.raises(ValueError, match="rate"):
            TokenBucket(rate=0.0, burst=1)
        with pytest.raises(ValueError, match="burst"):
            TokenBucket(rate=1.0, burst=0.5)


class TestShedding:
    def test_admits_when_unloaded(self):
        ctl = AdmissionController(_StubService(), max_queue=8)
        d = ctl.admit(Query.knn(5), deadline_s=1.0)
        assert d.admitted and d.reason == "ok" and not d.degraded
        assert d.spec == Query.knn(5)

    def test_rate_limited_shed_with_retry_after(self):
        clock = _Clock()
        ctl = AdmissionController(
            _StubService(), rate=10.0, burst=1, max_queue=8, clock=clock
        )
        assert ctl.admit(Query.knn(5)).admitted
        d = ctl.admit(Query.knn(5))
        assert not d.admitted and d.reason == "rate_limited"
        assert d.retry_after_s == pytest.approx(0.1)
        assert ctl.counters()["rejected_rate_limited"] == 1

    def test_queue_full_shed(self):
        ctl = AdmissionController(_StubService(depth=8, wait_s=0.5), max_queue=8)
        d = ctl.admit(Query.knn(5))
        assert not d.admitted and d.reason == "queue_full"
        assert d.retry_after_s > 0.0
        assert ctl.counters()["rejected_queue_full"] == 1

    def test_deadline_unmeetable_shed(self):
        """A deadline shorter than the estimated queue wait is shed NOW
        (cheap 429) instead of expiring in queue (wasted batch slot)."""
        ctl = AdmissionController(_StubService(depth=2, wait_s=0.4), max_queue=8)
        d = ctl.admit(Query.knn(5), deadline_s=0.1)
        assert not d.admitted and d.reason == "deadline_unmeetable"
        assert d.estimated_wait_s == pytest.approx(0.4)
        assert d.retry_after_s == pytest.approx(0.3)
        # a feasible deadline sails through the same state
        assert ctl.admit(Query.knn(5), deadline_s=1.0).admitted
        assert ctl.counters()["rejected_deadline_unmeetable"] == 1

    def test_deadline_rescued_by_degradation(self):
        """A deadline the exact-path wait estimate breaks but the ~2x-faster
        degraded path can meet is admitted degraded instead of shed."""
        ctl = AdmissionController(
            _StubService(depth=2, wait_s=0.4), max_queue=8,
            index_stats=lambda: {"n_pivots": 16},
        )
        d = ctl.admit(Query.knn(5), deadline_s=0.3)   # 0.4 > 0.3 > 0.4 * 0.5
        assert d.admitted and d.degraded
        assert d.spec.mode == "approx" and d.spec.dims == 8
        # a deadline even the degraded path breaks is still shed
        d2 = ctl.admit(Query.knn(5), deadline_s=0.1)  # 0.1 < 0.4 * 0.5
        assert not d2.admitted and d2.reason == "deadline_unmeetable"
        # explicit exact requests are never rescued — contract over latency
        d3 = ctl.admit(Query.knn(5, mode="exact"), deadline_s=0.3)
        assert not d3.admitted and d3.reason == "deadline_unmeetable"

    def test_no_deadline_never_deadline_shed(self):
        ctl = AdmissionController(_StubService(depth=2, wait_s=99.0), max_queue=8)
        assert ctl.admit(Query.knn(5), deadline_s=None).admitted

    def test_shed_fraction(self):
        ctl = AdmissionController(_StubService(depth=8, wait_s=0.1), max_queue=8)
        ctl.admit(Query.knn(5))               # queue_full
        ctl2 = AdmissionController(_StubService(), max_queue=8)
        assert ctl.counters()["shed_fraction"] == 1.0
        assert ctl2.counters()["shed_fraction"] == 0.0


class TestDegradation:
    def _ctl(self, depth, **kwargs):
        kwargs.setdefault("index_stats", lambda: {"n_pivots": 16, "kind": "nsimplex"})
        return AdmissionController(
            _StubService(depth=depth, wait_s=0.01), max_queue=8,
            degrade_at=0.5, **kwargs,
        )

    def test_auto_degrades_under_pressure(self):
        d = self._ctl(depth=4).admit(Query.knn(5))     # 4 >= 0.5 * 8
        assert d.admitted and d.degraded
        assert d.spec.mode == "approx"
        assert d.spec.dims == 8                        # n_pivots // 2
        assert d.spec.refine == DEFAULT_DEGRADE_REFINE
        assert d.spec.k == 5                           # the question is unchanged

    def test_no_pressure_no_degrade(self):
        d = self._ctl(depth=3).admit(Query.knn(5))     # 3 < 0.5 * 8
        assert d.admitted and not d.degraded
        assert d.spec.mode == "auto"

    def test_explicit_modes_never_rewritten(self):
        ctl = self._ctl(depth=8 - 1)
        exact = ctl.admit(Query.knn(5, mode="exact"))
        assert exact.admitted and not exact.degraded and exact.spec.mode == "exact"
        approx = ctl.admit(Query.knn(5, mode="approx", dims=4))
        assert approx.admitted and not approx.degraded and approx.spec.dims == 4

    def test_explicit_dims_refine_survive_degrade(self):
        d = self._ctl(depth=4).admit(Query.knn(5, dims=6, refine=10))
        assert d.degraded and d.spec.dims == 6 and d.spec.refine == 10

    def test_no_pivots_no_degrade(self):
        """Indexes without a truncatable surrogate (the tree) are never
        flipped — there is no approx path to flip to."""
        ctl = self._ctl(depth=4, index_stats=lambda: {"kind": "tree"})
        d = ctl.admit(Query.knn(5))
        assert d.admitted and not d.degraded and d.spec.mode == "auto"

    def test_degrade_disabled(self):
        ctl = AdmissionController(
            _StubService(depth=7, wait_s=0.01), max_queue=8, degrade_at=None,
            index_stats=lambda: {"n_pivots": 16},
        )
        d = ctl.admit(Query.knn(5))
        assert d.admitted and not d.degraded

    def test_degraded_counted(self):
        ctl = self._ctl(depth=4)
        ctl.admit(Query.knn(5))
        counters = ctl.counters()
        assert counters["admitted"] == 1 and counters["degraded"] == 1


class TestAdmissionRejected:
    def test_carries_decision(self):
        ctl = AdmissionController(_StubService(depth=8, wait_s=0.2), max_queue=8)
        decision = ctl.admit(Query.knn(5))
        err = AdmissionRejected(decision)
        assert err.decision is decision
        assert "queue_full" in str(err)


# -- parity with the JAX package ---------------------------------------------------

#: (queue depth, wait estimate s, clock advance s, spec fields, deadline s)
SCRIPT = [
    (0, 0.0, 0.0, dict(task="knn", k=5), None),
    (0, 0.0, 0.0, dict(task="knn", k=5), 1.0),
    (1, 0.05, 0.01, dict(task="knn", k=5), None),
    (3, 0.08, 0.0, dict(task="knn", k=5), None),            # pressure: degrade
    (3, 0.08, 0.0, dict(task="knn", k=5, mode="exact"), None),
    (3, 0.08, 0.02, dict(task="range", threshold=0.1), 0.5),
    (2, 0.4, 0.3, dict(task="knn", k=5), 0.3),               # rescued by degradation
    (2, 0.4, 0.0, dict(task="knn", k=5), 0.1),               # deadline unmeetable
    (2, 0.4, 0.0, dict(task="knn", k=5, dims=6, refine=10), 0.3),
    (8, 0.5, 0.5, dict(task="knn", k=5), None),              # queue full
    (0, 0.0, 0.0, dict(task="knn", k=3), None),              # rate limited
    (0, 0.0, 0.0, dict(task="knn", k=3), None),
    (0, 0.0, 0.2, dict(task="knn", k=3, mode="approx", dims=4), None),
]


def _decision(d):
    spec = None if d.spec is None else d.spec.to_dict()
    return (d.admitted, d.reason, d.retry_after_s, d.degraded, d.estimated_wait_s, spec)


@pytest.mark.parametrize("rate", [None, 5.0])
@pytest.mark.parametrize("stats", [{"n_pivots": 16, "kind": "nsimplex"}, {"kind": "tree"}])
def test_decisions_equal_reference(rate, stats):
    port_svc, ref_svc = _StubService(), _StubService()
    port_clock, ref_clock = _Clock(), _Clock()
    kw = dict(rate=rate, burst=2 if rate else None, max_queue=8, degrade_at=0.25, index_stats=lambda: stats)
    port = AdmissionController(port_svc, clock=port_clock, **kw)
    ref = rserve.AdmissionController(ref_svc, clock=ref_clock, **kw)
    for depth, wait, dt, fields, deadline in SCRIPT:
        for svc, clock in ((port_svc, port_clock), (ref_svc, ref_clock)):
            svc.depth, svc.wait_s = depth, wait
            clock.advance(dt)
        got = port.admit(Query(**fields), deadline_s=deadline)
        want = ref.admit(rapi.Query(**fields), deadline_s=deadline)
        assert _decision(got) == _decision(want), (depth, wait, fields, deadline)
    for n in (1, 3):
        assert _decision(port.admit_write(n)) == _decision(ref.admit_write(n))
    assert port.counters() == ref.counters()

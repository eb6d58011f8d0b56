import math
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from portbench.loop import Window, closed_loop, p95_ms, qps


def _window(rows, t_open=0.0, t_close=2.0):
    """A window from (submit, done, ok) rows."""
    win = Window(len(rows))
    for i, (a, b, ok) in enumerate(rows):
        win.t_submit[i], win.t_done[i], win.ok[i] = a, b, ok
    win.issued, win.t_open, win.t_close = len(rows), t_open, t_close
    return win


def test_qps_counts_every_answer_and_the_share_of_those_in_flight():
    rows = [(0.1 * i, 0.1 * i + 0.05, True) for i in range(10)]     # 10 answered inside [0, 2)
    rows.append((1.5, 2.5, True))                                    # half of it inside
    rows.append((1.0, 1.2, False))                                   # failed: no work done
    assert qps(_window(rows)) == pytest.approx((10 + 0.5) / 2.0)


def test_p95_is_over_all_requests_and_a_stall_moves_it():
    steady = [(i, i + 0.010, True) for i in range(10)]
    assert p95_ms(_window(steady)) == pytest.approx(10.0)
    stalled = steady[:9] + [(9.0, 19.0, True)]       # answered long after the window closed
    assert p95_ms(_window(stalled)) == pytest.approx(10_000.0)
    failed = steady[:9] + [(9.0, math.inf, False)]
    assert p95_ms(_window(failed)) == math.inf
    # nearest rank over 40: the 38th smallest
    many = [(0.0, 0.001 * (i + 1), True) for i in range(40)]
    assert p95_ms(_window(many)) == pytest.approx(38.0)


def _service(fail=()):
    """A stand-in service: answers each request on a worker thread."""
    pool = ThreadPoolExecutor(max_workers=2)
    seen = []

    def answer(q):
        time.sleep(0.0005)
        if q in fail:
            raise RuntimeError("boom")
        return ("answer", q)

    def submit(q):
        seen.append(q)
        return pool.submit(answer, q)

    return submit, seen, pool


def test_closed_loop_issues_the_pool_in_order_and_waits_for_each_answer():
    submit, seen, pool = _service()
    win = closed_loop(submit, list(range(100_000)), clients=3, seconds=0.2, digest=lambda a: a[1])
    pool.shutdown()
    n = win.issued
    assert win.t_close - win.t_open == pytest.approx(0.2) and n > 10
    assert win.ok[:n].all() and win.kept[:n] == list(range(n))
    assert (win.t_submit[:n] >= win.t_open).all() and (win.t_submit[:n] < win.t_close).all()
    assert (win.t_done[:n] > win.t_submit[:n]).all()
    assert sorted(seen) == list(range(n))


def test_closed_loop_keeps_c_requests_outstanding():
    live, peak = [0], [0]
    pool = ThreadPoolExecutor(max_workers=8)

    def answer(q):
        time.sleep(0.002)
        live[0] -= 1

    def submit(q):
        live[0] += 1
        peak[0] = max(peak[0], live[0])
        return pool.submit(answer, q)

    closed_loop(submit, list(range(100_000)), clients=4, seconds=0.2)
    pool.shutdown()
    assert peak[0] == 4


def test_closed_loop_counts_a_failed_request_and_refuses_to_repeat_queries():
    submit, _, pool = _service(fail={1})
    with pytest.raises(RuntimeError, match="query pool"):
        closed_loop(submit, [0, 1, 2], clients=1, seconds=1.0)
    win = closed_loop(submit, list(range(100_000)), clients=1, seconds=0.05)
    pool.shutdown()
    assert win.ok[0] and not win.ok[1] and "boom" in win.errors[1]

"""``correct`` on the CPU at a small size: sound runs pass, the control and
each fault planted under the timed path fail."""

import time

import numpy as np
import pytest
from conftest import TINY

from portbench import bench
from portbench.control import control_numbers

CELLS = ["colors112k-eu.knn-exact", "colors112k-jsd.knn-exact"]


class Faulty:
    """The index under the service, with one fault planted in its answers."""

    def __init__(self, index, fault):
        self._index, self._fault, self._prev = index, fault, None

    def query(self, q, spec, *, plan=None):
        from repro_torch.api import QueryResult

        res = self._index.query(q, spec, plan=plan)
        rs = res.results
        if self._fault == "stale":              # the answers of the batch before, state unchanged
            prev, self._prev = self._prev, list(rs)
            if prev is not None:
                res.results = [prev[i % len(prev)] for i in range(len(rs))]
        elif self._fault == "half_left_out":    # half of the batch never computed
            for i in range(len(rs) // 2, len(rs)):
                rs[i] = QueryResult(ids=np.empty(0, dtype=np.int64), distances=np.empty(0))
        elif self._fault == "answer_altered":   # one id changed where it is produced
            for r in rs:
                if len(r.ids):
                    r.ids = r.ids.copy()
                    r.ids[-1] = (r.ids[-1] + 1) % 3000
        return res

    def __getattr__(self, name):
        return getattr(self._index, name)


def _run(cell, seed, wrap=None):
    return bench.run_cell(bench.load_cell(cell), seed=seed, seconds=1.0, trace=False, t_start=time.perf_counter(),
                          device="cpu", sizes=TINY, wrap_index=wrap)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell, 2**31 + 101)
    assert res["out"]["correct"], res["checks"]
    assert res["out"]["failed"] == 0 and res["n_compared"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    numbers = control_numbers(bench.load_cell(cell), 2**31 + 102, n_answers=400, device="cpu", sizes=TINY)
    limits = bench.load_cell(cell)["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("fault", ["stale", "half_left_out", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault):
    res = _run(cell, 2**31 + 103, wrap=lambda index: Faulty(index, fault))
    assert not res["out"]["correct"], res["checks"]


@pytest.mark.gpu
def test_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = bench.run_cell(bench.load_cell("colors112k-eu.knn-exact"), seed=2**31 + 104, seconds=3.0, trace=True,
                         t_start=time.perf_counter())
    assert res["out"]["correct"]
    assert res["trace"].busy_s > 0 and "kernel_roofline_pct" in res["out"]["metrics"]

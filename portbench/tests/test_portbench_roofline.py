import pytest

from portbench import roofline as R


def test_k1_by_hand():
    # Q 1, dims 20 over 1M x 20: bytes 1M*20*4 + 1*20*4 + 2*1*1M*4; ops 1M*(2*19+12)
    N, n = 1_000_000, 20
    b = N * n * 4 + 20 * 4 + 2 * N * 4
    ops = N * (2 * 19 + 12)
    assert R.least_seconds("apex_bounds_batch", (1, 20), N=N, n=n) == pytest.approx(max(b / R.HBM_BPS, ops / R.F32_FLOPS))
    assert b / R.HBM_BPS > ops / R.F32_FLOPS          # bytes bound it


def test_k2_k3_by_hand():
    N, n = 1_000_000, 20
    # K2 (64, 10, upb, 20): table + queries read once, 64*10 (id, lwb, upb) written; per
    # (query, row) 2*19 + 3 + 3 operations, per kept row 6
    b = N * n * 4 + 64 * 20 * 4 + 64 * 10 * 12
    ops = 64 * N * (38 + 6) + 640 * 6
    assert R.least_seconds("apex_topk", (64, 10, "upb", 20), N=N, n=n) == pytest.approx(max(b / R.HBM_BPS, ops / R.F32_FLOPS))
    # the mid key squares twice
    ops_mid = 64 * N * (2 * 9 + 3 + 6) + 64 * 64 * 6
    b_mid = N * n * 4 + 64 * 10 * 4 + 64 * 64 * 12
    assert R.least_seconds("apex_topk", (64, 64, "mid", 10), N=N, n=n) == pytest.approx(
        max(b_mid / R.HBM_BPS, ops_mid / R.F32_FLOPS))
    # K3 (64, 512, 20): no kept rows counted (data-dependent), the cap written
    b3 = N * n * 4 + 64 * 20 * 4 + 64 * (512 * 12 + 4)
    ops3 = 64 * N * (38 + 6)
    assert R.least_seconds("apex_threshold", (64, 512, 20), N=N, n=n) == pytest.approx(max(b3 / R.HBM_BPS, ops3 / R.F32_FLOPS))
    # an f64 table is read at 8 bytes against the f64 peak
    assert R.least_seconds("apex_threshold", (64, 512, 20, "float64"), N=N, n=n) > \
        R.least_seconds("apex_threshold", (64, 512, 20), N=N, n=n)


def test_k4_k5_k6_by_hand():
    N, n = 1_000_000, 20
    h = 19
    b4 = 2 * 64 * 20 * 8 + (h * h + h) * 8
    ops4 = 64 * (2 * h * h + 4 * h + 4)
    assert R.least_seconds("apex_project", (64, 20, "float64"), N=N, n=n) == pytest.approx(
        max(b4 / R.HBM_BPS, ops4 / R.F64_FLOPS))
    # K5's bucket 256 holds P in (128, 256]: the least P, 129, is counted
    P, d, lf = 129, 112, R.LOG_F64_FLOPS
    ops5 = 1 * P * d * (4 + lf) + (1 + P) * d * (4 + lf)
    b5 = (1 + P) * d * 8 + P * 8
    assert R.least_seconds("jsd_pairwise", (1, 256, 112, "float64"), N=N, n=n) == pytest.approx(
        max(b5 / R.HBM_BPS, ops5 / R.F64_FLOPS))
    # at or under 32 rows the class is the exact P
    ops20 = 64 * 20 * d * (4 + lf) + 84 * d * (4 + lf)
    assert R.least_seconds("jsd_pairwise", (64, 20, 112, "float64"), N=N, n=n) == pytest.approx(
        max((84 * d * 8 + 64 * 20 * 8) / R.HBM_BPS, ops20 / R.F64_FLOPS))
    b6 = (N * n + n) * 4 + 2 * N * 4
    assert R.least_seconds("apex_bounds", (20, "float32"), N=N, n=n) == pytest.approx(b6 / R.HBM_BPS)

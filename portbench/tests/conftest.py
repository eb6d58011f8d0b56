"""The harness's CPU tests: ``python -m pytest -q portbench/tests`` from the
repository root (not collected by the repository's own test run)."""

import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
for p in (str(_ROOT / "src"), str(_ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a cell cut to a size a CPU test can hold (rows, pool, clients, checked answers)
TINY = {"n_rows": 3000, "query_pool": 4000, "clients": 8, "check_sample": 400}

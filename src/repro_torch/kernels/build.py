"""Build and load the port's CUDA kernels (plain C interface, ``ctypes``).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (``select_epilogue.cu`` by one process per
part of its entry points, ``_PARTS``); the objects are linked into one shared
library under ``build/repro_torch_kernels/<hash>/`` at the repository root,
keyed by a hash of the sources and flags, so a checkout builds everything
at first use and a rebuilt source never loads a stale library.

No ``--use_fast_math``: it flushes denormals and approximates ``sqrt``, and
the soundness slack of the f32 scan assumes IEEE f32.  ``--fmad=false``
keeps the compiler from contracting any product that the sources did not
spell as a fused multiply-add themselves.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_library", "library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
_LIB_NAME = "librepro_torch_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
)

#: sources compiled once per part (``-DREPRO_SELECT_PART=<part>``): the
#: f32 and f64 K2, K3 and wide-plan entry points, whose instantiations make
#: the longest single nvcc job when compiled together
_PARTS = {"select_epilogue.cu": 6}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "repro_apex_bounds_f32": [_P, _I, _I, _P, _P, _P, _P],
    "repro_apex_bounds_f64": [_P, _I, _I, _P, _P, _P, _P],
    "repro_apex_bounds_batch_f32": [_P, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P],
    "repro_apex_bounds_batch_f64": [_P, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P],
    "repro_apex_topk": [_P, _I, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "repro_apex_topk_f64": [_P, _I, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "repro_apex_threshold": [
        _P, _I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
    ],
    "repro_apex_threshold_f64": [
        _P, _I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
    ],
    "repro_select_wide_f32": [
        _I, _P, _I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    ],
    "repro_select_wide_f64": [
        _I, _P, _I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    ],
    "repro_apex_project_f32": [_P, _I, _I, _P, _P, _P, _I, _I, _P],
    "repro_apex_project_f64": [_P, _I, _I, _P, _P, _P, _I, _I, _P],
    "repro_launch_floor": [_P],
    "repro_jsd_pairwise_f32": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P],
    "repro_jsd_pairwise_f64": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else None
    )
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(sorted(_PARTS.items()))).encode())
    srcs, headers = _sources()
    for p in srcs + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    out = _BUILD_ROOT / _digest() / _LIB_NAME
    if out.exists():
        return out
    nvcc = _nvcc()
    work = out.parent / f"tmp-{os.getpid()}-{threading.get_ident()}"
    work.mkdir(parents=True, exist_ok=True)
    srcs, _ = _sources()
    jobs = []  # (source, object, extra flags)
    for s in srcs:
        parts = _PARTS.get(s.name)
        if parts is None:
            jobs.append((s, work / (s.stem + ".o"), []))
        else:
            jobs += [(s, work / f"{s.stem}.part{i}.o", [f"-DREPRO_SELECT_PART={i}"]) for i in range(parts)]
    objs = [o for _, o, _ in jobs]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for s, o, extra in jobs
    ]
    failed = []
    for (s, o, _), p in zip(jobs, procs):
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{o.name} ({s.name}):\n{log.decode(errors='replace')}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    tmp_lib = work / _LIB_NAME
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed\n" + link.stdout.decode(errors="replace"))
    os.replace(tmp_lib, out)
    shutil.rmtree(work, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib

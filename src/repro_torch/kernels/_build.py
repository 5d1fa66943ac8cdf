"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into an object, all
of them at once in parallel processes, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use and is keyed by a hash of the sources and flags, so a
fresh checkout builds itself (a few seconds) and later processes reuse the
library. Output goes to ``build/repro_torch_kernels/`` at the root of the
checkout (``.gitignore`` lists ``build/``).

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from repro_torch.obs import metrics as obs_metrics

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "distance.cu", CSRC / "int8.cu", CSRC / "topk_merge.cu",
           CSRC / "bits.cu", CSRC / "pdx.cu", CSRC / "nlj.cu")
# headers the sources include; they key the build too
HEADERS = (CSRC / "tile.cuh", CSRC / "int8_tile.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of csrc/*.cu (every pointer and the stream as void*)
_SIGNATURES = {
    "repro_pairwise_sq_dists": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "repro_rowwise_sq_dists": (_P, _P, _P, _LL, _I, _I, _I, _P),
    "repro_gather_sq_dists": (_P, _P, _P, _P, _P, _LL, _I, _I, _LL, _I, _I,
                              _P),
    "repro_gather_sq_dists_bf16": (_P, _P, _P, _P, _LL, _I, _I, _LL, _I, _I,
                                   _P),
    "repro_pairlist_sq_dists": (_P, _P, _P, _P, _P, _P, _P, _LL, _I, _LL,
                                _LL, _P),
    "repro_pairwise_sq_dists_int8": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _P),
    "repro_pairwise_bounds_int8": (_P,) * 9 + (_I, _I, _I, _I, _F, _P),
    "repro_rowwise_sq_dists_int8": (_P,) * 9 + (_LL, _I, _I, _I, _LL, _I,
                                                 _I, _P),
    "repro_topk_merge": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "repro_topk_merge_warp": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "repro_pairwise_hamming": (_P, _P, _P, _I, _I, _I, _I, _P),
    "repro_rowwise_hamming": (_P, _P, _P, _P, _LL, _I, _I, _LL, _I, _P),
    "repro_pairwise_sq_dists_pdx": (_P,) * 13 + (_I, _I, _I, _I, _F, _F, _F,
                                                  _F, _I, _P),
    "repro_pairwise_bounds_pdx": (_P,) * 14 + (_I, _I, _I, _I, _F, _F, _F, _F,
                                                _I, _P),
    "repro_pdx_gather_sq_dists": (_P,) * 9 + (_LL, _I, _I, _I, _LL, _F, _F,
                                              _F, _I, _I, _P),
    "repro_nlj_count": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "repro_gather_sketch_bounds": (_P,) * 9 + (_I, _I, _I, _I, _I, _F, _F,
                                               _F, _I, _P),
    "repro_pdx_compact_gather": (_P,) * 12 + (_I, _I, _LL, _LL, _I, _I, _I,
                                              _LL, _F, _F, _F, _I, _I, _I,
                                              _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of this process's build
build_log: str = ""                  # nvcc's output (-Xptxas -v registers)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _key() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels_{_key()}.so"


def build() -> Path:
    """Compile the sources unless a library for their hash exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [Path(work) / f"{src.stem}.o" for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(f"== {src.name}\n{log}"
                            for src, log in zip(SOURCES, logs))
        bad = [src.name for src, p in zip(SOURCES, procs) if p.returncode]
        if bad:
            raise RuntimeError(f"nvcc failed on {bad}:\n{build_log}")
        tmp = Path(work) / "lib.so"
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, out)   # atomic: a concurrent build never sees a torn file
    (BUILD_DIR / f"{out.stem}.log").write_text(build_log)
    build_seconds = time.perf_counter() - t0
    obs_metrics.note_kernel_build()
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:            # every launch asks: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = load().repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")

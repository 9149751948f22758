"""Native (C++/OpenMP) host runtime: loader and ctypes bindings.

PyTorch-port counterpart of `conflux_tpu/native`, with its own copy of the
C++ source (`src/conflux_host.cc`): the seeded matrix fill (so both
packages factor the same benchmark matrices), row permutations, strided
copies, the block-cyclic staging permutation, the LAPACK IPIV walk and
the semiprof-parity profiler. This is host code: every entry point has a
numpy fallback, so the package works without a toolchain.

The library is built with g++ at first use into the package's gitignored
`_build/` directory, as `libconflux_host-<hash>.so`, the hash covering
the source and the flags. A build writes a file of its own (named after
the process and thread) and renames it into place, so processes that
build at once (parallel test workers) each load a complete library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "src" / "conflux_host.cc"
_BUILD = _HERE.parent / "_build"
_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
          "-std=c++17"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD / f"libconflux_host-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    """Compile the library into a temporary file and rename it to `lib`;
    without -march=native if the first try fails (portability)."""
    _BUILD.mkdir(exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    for flags in (_FLAGS, [f for f in _FLAGS if f != "-march=native"]):
        cmd = ["g++", *flags, str(_SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except (subprocess.SubprocessError, FileNotFoundError):
            continue
        os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
        return True
    tmp.unlink(missing_ok=True)
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _lib_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        i64, u64, f32p, f64p, i64p, charp = (
            ctypes.c_int64,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p,
        )
        lib.ct_fill_random_f32.argtypes = [f32p, i64, i64, u64]
        lib.ct_fill_random_f64.argtypes = [f64p, i64, i64, u64]
        lib.ct_permute_rows_f32.argtypes = [f32p, f32p, i64p, i64, i64]
        lib.ct_inverse_permute_rows_f32.argtypes = [f32p, f32p, i64p, i64, i64]
        lib.ct_mcopy_f32.argtypes = [f32p, f32p, i64, i64, i64, i64]
        lib.ct_cyclic_permute_f32.argtypes = [f32p, f32p, i64, i64, i64, i64,
                                              i64]
        lib.ct_perm_to_ipiv.argtypes = [i64p, i64p, i64]
        lib.ct_prof_enter.argtypes = [charp]
        lib.ct_prof_report.argtypes = [ctypes.c_char_p, i64]
        lib.ct_prof_report.restype = i64
        lib.ct_num_threads.restype = ctypes.c_int
        for name in ("ct_fill_random_f32", "ct_fill_random_f64",
                     "ct_permute_rows_f32", "ct_inverse_permute_rows_f32",
                     "ct_mcopy_f32", "ct_cyclic_permute_f32",
                     "ct_perm_to_ipiv", "ct_prof_enter", "ct_prof_leave",
                     "ct_prof_clear"):
            getattr(lib, name).restype = None
        lib.ct_prof_leave.argtypes = []
        lib.ct_prof_clear.argtypes = []
        lib.ct_num_threads.argtypes = []
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def num_threads() -> int:
    lib = _load()
    return lib.ct_num_threads() if lib else 1


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def fill_random(m: int, n: int, seed: int = 42, dtype=np.float32) -> np.ndarray:
    """5 + U[0,1) fill (lu_params.hpp:364-375 semantics), OpenMP-parallel.

    Only f32/f64 take the native path: any other dtype would let the C
    writer overrun the narrower output buffer."""
    lib = _load()
    dtype = np.dtype(dtype)
    out = np.empty((m, n), dtype)
    if lib is None or dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        rng = np.random.default_rng(seed)
        out[:] = (5.0 + rng.random((m, n))).astype(dtype)
        return out
    if dtype == np.float32:
        lib.ct_fill_random_f32(_f32p(out), m, n, seed)
    else:
        lib.ct_fill_random_f64(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), m, n, seed
        )
    return out


def permute_rows(a: np.ndarray, perm: np.ndarray, inverse: bool = False) -> np.ndarray:
    """out[i] = a[perm[i]] (or out[perm[i]] = a[i] when inverse): the
    reference's permute_rows / inverse_permute_rows (utils.hpp:49,86)."""
    lib = _load()
    a = np.ascontiguousarray(a, np.float32)
    perm = np.ascontiguousarray(perm, np.int64)
    if lib is None:
        if inverse:
            out = np.empty_like(a)
            out[perm] = a
            return out
        return a[perm].copy()
    out = np.empty_like(a)
    fn = lib.ct_inverse_permute_rows_f32 if inverse else lib.ct_permute_rows_f32
    fn(_f32p(a), _f32p(out),
       perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
       a.shape[0], a.shape[1])
    return out


def cyclic_permute(a: np.ndarray, v: int, Px: int, Py: int) -> np.ndarray:
    """Dense -> block-cyclic staging layout (the host half of
    layout.distribute)."""
    lib = _load()
    a = np.ascontiguousarray(a, np.float32)
    M, N = a.shape
    if M % (v * Px) or N % (v * Py):
        raise ValueError(
            f"cyclic_permute requires M % (v*Px) == 0 and N % (v*Py) == 0, "
            f"got {M}x{N} with v={v}, Px={Px}, Py={Py}"
        )
    if lib is None:
        mtl, ntl = M // (v * Px), N // (v * Py)
        return (
            a.reshape(mtl, Px, v, ntl, Py, v)
            .transpose(1, 0, 2, 4, 3, 5)
            .reshape(M, N)
            .copy()
        )
    out = np.empty_like(a)
    lib.ct_cyclic_permute_f32(_f32p(a), _f32p(out), M, N, v, Px, Py)
    return out


def mcopy(src: np.ndarray, rows: int, cols: int, row0: int = 0, col0: int = 0) -> np.ndarray:
    """Strided submatrix copy src[row0:row0+rows, col0:col0+cols]: the
    reference's mcopy/parallel_mcopy (memory_utils.hpp:8-49)."""
    lib = _load()
    src = np.ascontiguousarray(src, np.float32)
    if row0 + rows > src.shape[0] or col0 + cols > src.shape[1]:
        raise ValueError(f"mcopy of [{row0}:{row0 + rows}, {col0}:"
                         f"{col0 + cols}] outside a {src.shape} source")
    out = np.empty((rows, cols), np.float32)
    if lib is None:
        out[:] = src[row0 : row0 + rows, col0 : col0 + cols]
        return out
    base = src[row0:, col0:]
    lib.ct_mcopy_f32(_f32p(base), _f32p(out), rows, cols, src.shape[1], cols)
    return out


def perm_to_ipiv(perm: np.ndarray) -> np.ndarray:
    """Permutation vector (slot -> original row) -> LAPACK getrf-style
    sequential-swap IPIV (1-based). Sequential state walk; native C++ with a
    pure-Python fallback."""
    lib = _load()
    perm = np.ascontiguousarray(perm, np.int64)
    n = perm.shape[0]
    ipiv = np.empty(n, np.int64)
    if lib is not None:
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.ct_perm_to_ipiv(perm.ctypes.data_as(i64p),
                            ipiv.ctypes.data_as(i64p), n)
        return ipiv
    work = np.arange(n)
    pos = np.arange(n)
    for i in range(n):
        j = pos[perm[i]]
        ipiv[i] = j + 1
        wi, wj = work[i], work[j]
        work[i], work[j] = wj, wi
        pos[wi], pos[wj] = j, i
    return ipiv


class NativeProfiler:
    """semiprof-parity profiler backed by the C++ region tree."""

    def __init__(self):
        self._lib = _load()

    @property
    def active(self) -> bool:
        return self._lib is not None

    def enter(self, name: str) -> None:
        if self._lib:
            self._lib.ct_prof_enter(name.encode())

    def leave(self) -> None:
        if self._lib:
            self._lib.ct_prof_leave()

    def clear(self) -> None:
        if self._lib:
            self._lib.ct_prof_clear()

    def report(self) -> str:
        if not self._lib:
            return ""
        buf = ctypes.create_string_buffer(1 << 20)
        n = self._lib.ct_prof_report(buf, len(buf))
        return buf.raw[:n].decode()

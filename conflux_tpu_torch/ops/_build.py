"""Build the package's CUDA sources into shared libraries at first use.

Each library is one `csrc/<name>.cu` with a plain C interface, compiled by
`nvcc` for Hopper (`sm_90a`) into `_build/lib<name>-<hash>.so` inside the
package and loaded with `ctypes`. The hash covers that source, the
`csrc/` headers it includes (`#include "x.cuh"`, and the headers those
include) and the compiler flags, so an edited source or header builds
anew, an unchanged one loads the library already built, and editing one
kernel leaves the others' libraries valid. Nothing here runs when the
module is imported: the CPU-only test environment has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME:
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _headers(src: bytes) -> list:
    """The `csrc/` headers `src` includes by name, directly or through
    another such header, in sorted order."""
    seen, todo = set(), list(_INCLUDE.findall(src))
    while todo:
        header = todo.pop()
        if header not in seen:
            seen.add(header)
            todo += _INCLUDE.findall((_CSRC / header.decode()).read_bytes())
    return sorted(seen)


def _digest(name: str) -> str:
    """Hash of the flags, `csrc/<name>.cu` and the `csrc/` headers it
    includes, and of nothing else."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    src = (_CSRC / f"{name}.cu").read_bytes()
    h.update(src)
    for header in _headers(src):
        h.update(header)
        h.update((_CSRC / header.decode()).read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return _BUILD / f"lib{name}-{_digest(name)}.so"


def build(names) -> None:
    """Build every library of `names` that the current sources lack, with
    one `nvcc` per source, all started together. Raises if any fails."""
    todo = [(name, _lib_path(name)) for name in names]
    todo = [(name, lib) for name, lib in todo if not lib.exists()]
    if not todo:
        return
    nvcc = _nvcc()
    _BUILD.mkdir(exist_ok=True)
    jobs = []
    for name, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, lib, tmp, cmd, proc))
    failed = []
    for name, lib, tmp, cmd, proc in jobs:
        out, err = proc.communicate()
        (_BUILD / f"lib{name}.log").write_text(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {name}:\n{err}")
        else:
            os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Load `lib<name>`, building it from `csrc/<name>.cu` first if the
    current source has not been built yet. Raises on a failed build."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LOADED[name]


def build_log(name: str) -> str:
    """nvcc's output from the last build of `lib<name>` (ptxas register and
    shared-memory report included), or '' if it was never built here."""
    log = _BUILD / f"lib{name}.log"
    return log.read_text() if log.exists() else ""

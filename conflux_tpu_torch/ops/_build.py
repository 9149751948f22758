"""Build the package's CUDA sources into shared libraries at first use.

Each kernel is one `csrc/<name>.cu` with a plain C interface, compiled by
`nvcc` for Hopper (`sm_90a`) into `_build/lib<name>-<hash>.so` inside the
package and loaded with `ctypes`. The hash covers every source under
`csrc/` and the compiler flags, so an edited source builds anew and an
unchanged one loads the library already built. Nothing here runs when the
module is imported: the CPU-only test environment has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """Load `lib<name>`, building it from `csrc/<name>.cu` first if the
    current sources have not been built yet. Raises on a failed build."""
    if name in _LOADED:
        return _LOADED[name]
    lib = _BUILD / f"lib{name}-{_digest()}.so"
    if not lib.exists():
        _BUILD.mkdir(exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        (_BUILD / f"lib{name}.log").write_text(
            " ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{res.stderr}")
        os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
    _LOADED[name] = ctypes.CDLL(str(lib))
    return _LOADED[name]


def build_log(name: str) -> str:
    """nvcc's output from the last build of `lib<name>` (ptxas register and
    shared-memory report included), or '' if it was never built here."""
    log = _BUILD / f"lib{name}.log"
    return log.read_text() if log.exists() else ""

"""Matrix generation and binary file IO.

PyTorch-port counterpart of `conflux_tpu/io.py`: the generators return
numpy arrays, bit for bit the JAX package's (large fills go through the
same native fill, `conflux_tpu_torch.native`), so both packages factor
the same matrices. Capability parity with:
  * `lu_params::InitMatrix` (src/conflux/lu/lu_params.hpp:141-376): seeded
    uniform random fill `5 + U[0,1)` for benchmarking, plus small
    deterministic debug matrices with planted dominant entries that force
    known pivot movements;
  * `CholeskyIO::generateInputMatrixDistributed` (src/conflux/cholesky/
    CholeskyIO.cpp:100-172): an O(v^2)-state SPD generator, a seeded v x v
    Gram tile replicated across the matrix plus a diagonal-dominance boost;
  * `CholeskyIO` file dump/parse + `cholesky_helper --generate/--compare`
    (examples/cholesky_helper.cpp): raw float64 row-major binary files.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def random_matrix(M: int, N: int, seed: int = 42, dtype=np.float32) -> np.ndarray:
    """Benchmark fill: 5 + U[0,1) (lu_params.hpp:364-375 semantics).

    Fills of 2^22 entries or more go through the native OpenMP generator
    when it builds, as in the JAX package; the two routes use different
    PRNGs, so the same switch keeps both packages on the same matrix."""
    if M * N >= 1 << 22:
        from conflux_tpu_torch import native

        if native.available():
            return native.fill_random(M, N, seed=seed, dtype=dtype)
    rng = np.random.default_rng(seed)
    return (5.0 + rng.random((M, N))).astype(dtype)


def debug_matrix(n: int, seed: int = 7, dtype=np.float32) -> np.ndarray:
    """Small deterministic matrix with planted dominant off-diagonal entries
    so tournament pivoting must move known rows (the role of the hard-coded
    matrices in lu_params.hpp:157-363)."""
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 10, size=(n, n)).astype(dtype)
    # plant dominant values off the diagonal: row i's champion lives in
    # column (2*i+1) % n, so natural (no-pivot) order is always wrong
    for i in range(0, n, max(1, n // 8)):
        A[(2 * i + 1) % n, i] = 100.0 * (1 + i)
    return A


def spd_matrix(
    N: int, v: int = 128, seed: int = 42, dtype=np.float32
) -> np.ndarray:
    """SPD generator with O(v^2) entropy: replicated seeded Gram tile plus a
    diagonal boost (CholeskyIO.cpp:100-172 semantics). The replication makes
    the full matrix PSD; the diagonal shift makes it strictly SPD and
    well-conditioned.

    The JAX package forms A = tile(G) + 2v I and (A + A^T) / 2 over the
    whole matrix in float64, about five float64 copies at once (over
    100 GB at N = 65536). Entry for entry that is the symmetrised tile
    (G[a, b] + G[b, a]) / 2 off the diagonal and G[a, a] + 2v on it, so
    the tile is symmetrised once at [v, v] and the matrix is tiled
    straight into `dtype`: the same bits in one copy."""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((v, v))
    G = (R @ R.T) / v
    reps = -(-N // v)
    A = np.tile(((G + G.T) / 2).astype(dtype), (reps, reps))
    if reps * v != N:
        A = np.ascontiguousarray(A[:N, :N])
    d = np.arange(N)
    A[d, d] = (np.diagonal(G)[d % v] + 2.0 * v).astype(dtype)
    return A


def dense_spd_matrix(N: int, seed: int = 42, dtype=np.float32) -> np.ndarray:
    """Full-entropy SPD matrix (B B^T + N I) for correctness tests."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((N, N))
    return (B @ B.T + N * np.eye(N)).astype(dtype)


# -- binary file IO (cholesky_helper format: raw row-major float64) ----------

def save_matrix(path: str, A) -> None:
    """Write A (numpy, or a tensor on any device) as raw row-major f64."""
    import torch

    if isinstance(A, torch.Tensor):
        A = A.detach().cpu().double().numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.asarray(A, dtype=np.float64).tofile(path)


def load_matrix(path: str, N: int, M: Optional[int] = None) -> np.ndarray:
    M = M if M is not None else N
    data = np.fromfile(path, dtype=np.float64, count=M * N)
    if data.size != M * N:
        from conflux_tpu_torch.errors import ConfluxError, ErrorCode

        raise ConfluxError(
            ErrorCode.IO_ERROR,
            f"{path}: expected {M*N} float64 values, got {data.size}",
        )
    return data.reshape(M, N)


def save_dist(path: str, G, desc, root: int = 0) -> None:
    """Persist a distributed matrix (checkpoint parity with the reference's
    MPI-IO dumps, CholeskyIO.cpp:384-501) from this rank's block G: the
    blocks are gathered to grid rank `root` (`layout.undistribute`), which
    writes the padded [M, N] matrix as raw f64. Every rank of the grid
    calls it."""
    from conflux_tpu_torch.layout import undistribute

    A = undistribute(G, desc, root)
    if A is not None:
        save_matrix(path, A)


def load_dist(path: str, desc, dtype=np.float32):
    """This rank's block of a matrix saved by save_dist, on the grid's
    device (`layout.distribute`; None on an idle rank). `dtype` is the
    block's numpy dtype (the file is always f64, the reference's
    CholeskyIO format): np.float64 round-trips a double matrix exactly.
    Every rank of the grid calls it."""
    from conflux_tpu_torch.layout import distribute

    A = load_matrix(path, desc.N, desc.M)
    return distribute(A.astype(dtype), desc)

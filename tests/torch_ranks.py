"""Rank programs of the port's distributed CPU tests.

`launch.run_ranks` runs each function below in every process of a gloo
world, on the CPU; the test files (test_torch_grid_layout.py,
test_torch_comm.py, test_torch_lu_dist.py, test_torch_cholesky_dist.py)
hold the results to the JAX package, which runs in the parent only. This
module imports torch, numpy and conflux_tpu_torch, never jax: each
function reports whether jax reached its process.
"""

from __future__ import annotations

import sys
import time
import warnings

import torch

from conflux_tpu_torch.cholesky.p25d import cholesky_25d, pcholesky
from conflux_tpu_torch.comm import SUBSETS
from conflux_tpu_torch.grid import make_grid
from conflux_tpu_torch.layout import BlockCyclic, distribute, undistribute
from conflux_tpu_torch.lu.p25d import lu_25d, plu


def _jax_free():
    return "jax" not in sys.modules


def _numpy(t):
    return None if t is None else t.numpy()


def layout_cases(shape, mats):
    """Each rank's block of each (A, v) in `mats` from `distribute`, the
    descriptor's fields, and the matrix `undistribute` gives back on rank
    0. On the (2, 2, 2) world also a (2, 2, 1) grid over its 8 ranks: it
    must warn and leave ranks 4-7 idle."""
    grid = make_grid(shape, device="cpu")
    out = {"coords": (grid.pi, grid.pj, grid.pz), "blocks": [], "back": [],
           "desc": []}
    for A, v in mats:
        desc = BlockCyclic.create(A.shape[0], A.shape[1], v, grid)
        out["desc"].append((desc.M, desc.N, desc.Ml, desc.Nl, desc.nlayr))
        G = distribute(A, desc)
        out["blocks"].append(G.numpy())
        out["back"].append(_numpy(undistribute(G, desc)))
    if shape == (2, 2, 2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            small = make_grid((2, 2, 1), device="cpu")
        out["idle_warned"] = any("idle" in str(w.message) for w in caught)
        out["idle"] = small.idle
        A, v = mats[0]
        desc = BlockCyclic.create(A.shape[0], A.shape[1], v, small)
        G = distribute(A, desc)
        out["small_block"] = _numpy(G)
        out["small_back"] = _numpy(undistribute(G, desc))
    out["jax_free"] = _jax_free()
    return out


def comm_cases(shape, X, ppermute_pairs):
    """Every collective of `comm.Comm` on this rank's slice X[rank]: psum
    over each axis subset, all_gather over each axis, ppermute over 'x'
    for each pair list, psum_scatter over 'x' along dims 0 and 1; and the
    record of what was issued."""
    grid = make_grid(shape, device="cpu")
    comm = grid.comm
    t = torch.from_numpy(X[grid.rank])
    out = {}
    for axes in SUBSETS:
        out[("psum", axes)] = comm.psum(t, axes).numpy()
    for ax in ("x", "y", "z"):
        out[("all_gather", ax)] = comm.all_gather(t, ax).numpy()
    for pairs in ppermute_pairs:
        out[("ppermute", pairs)] = comm.ppermute(t, "x", pairs).numpy()
    for dim in (0, 1):
        out[("psum_scatter", dim)] = comm.psum_scatter(t, "x", dim).numpy()
    out["records"] = list(comm.record)
    out["jax_free"] = _jax_free()
    return out


def comm_volume_cases(shape, A, S, v, lu_runs, chol_variants):
    """Each rank's record of the collectives of one factorization per run:
    lu_25d('tournament', 'highest', variant, rowpart) on A for each
    (variant, rowpart) of `lu_runs`, cholesky_25d('highest', variant) on S
    for each variant of `chol_variants`."""
    grid = make_grid(shape, device="cpu")
    n = A.shape[0]
    desc = BlockCyclic.create(n, n, v, grid)
    out = {}
    for variant, rowpart in lu_runs:
        G = distribute(A, desc)
        grid.comm.record.clear()
        lu_25d(G, desc, "tournament", "highest", variant, rowpart=rowpart)
        out[("lu", variant, rowpart)] = list(grid.comm.record)
    for variant in chol_variants:
        G = distribute(S, desc)
        grid.comm.record.clear()
        cholesky_25d(G, desc, "highest", variant)
        out[("cholesky", variant)] = list(grid.comm.record)
    out["jax_free"] = _jax_free()
    return out


def lu_cases(shape, cases):
    """The LU of each case dict (A, v, pivoting, variant, rowpart, api) at
    'highest': through `plu` (api 'plu') or `distribute`, `lu_25d` and
    `undistribute`. Returns rank 0's dense factor and every rank's pivot
    vector."""
    grid = make_grid(shape, device="cpu")
    out = []
    for c in cases:
        A = c["A"]
        if c["api"] == "plu":
            F, perm = plu(A, grid, c["v"], c["pivoting"], "highest",
                          c["variant"])
        else:
            desc = BlockCyclic.create(A.shape[0], A.shape[1], c["v"], grid)
            F, perm = lu_25d(distribute(A, desc), desc, c["pivoting"],
                             "highest", c["variant"], rowpart=c["rowpart"])
            F = undistribute(F, desc)
        out.append({"F": _numpy(F), "perm": perm.numpy()})
    return {"cases": out, "jax_free": _jax_free()}


def cholesky_cases(shape, cases):
    """The Cholesky factor of each case dict (A, v, variant, api) at
    'highest': through `pcholesky` (api 'pcholesky', cropped to A's shape)
    or `distribute`, `cholesky_25d` and `undistribute` (the padded
    factor). Returns rank 0's dense factor and whether this rank's block
    is zero off layer 0."""
    grid = make_grid(shape, device="cpu")
    out = []
    for c in cases:
        A = c["A"]
        if c["api"] == "pcholesky":
            L = pcholesky(A, grid, c["v"], "highest", c["variant"])
            zero_off_layer0 = True
        else:
            desc = BlockCyclic.create(A.shape[0], A.shape[1], c["v"], grid)
            G = cholesky_25d(distribute(A, desc), desc, "highest",
                             c["variant"])
            zero_off_layer0 = grid.pz == 0 or not bool(G.any())
            L = undistribute(G, desc)
        out.append({"L": _numpy(L), "zero_off_layer0": zero_off_layer0})
    return {"cases": out, "jax_free": _jax_free()}


def fail_on_rank(bad: int):
    """Raises on grid rank `bad` after the world is up; the others wait
    for it in a collective."""
    import torch.distributed as dist

    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    dist.barrier()
    return dist.get_rank()


def outlive(seconds: float):
    """Rank 0 returns; the others sleep past the caller's timeout."""
    import torch.distributed as dist

    if dist.get_rank():
        time.sleep(seconds)
    return dist.get_rank()


def comm_world(shape, comm_args, volume_args):
    """`comm_cases` and `comm_volume_cases` in one world."""
    return {"comm": comm_cases(shape, *comm_args),
            "volume": comm_volume_cases(shape, *volume_args)}

"""Rank programs of the port's distributed CPU tests.

`launch.run_ranks` runs each function below in every process of a gloo
world, on the CPU; the test files (test_torch_grid_layout.py,
test_torch_comm.py, test_torch_lu_dist.py, test_torch_cholesky_dist.py,
test_torch_lu_crout.py, test_torch_dist_rest.py) hold the results to the
JAX package, which runs in the parent only. This
module imports torch, numpy and conflux_tpu_torch, never jax: each
function reports whether jax reached its process.
"""

from __future__ import annotations

import sys
import time
import warnings

import torch

from conflux_tpu_torch import profiler
from conflux_tpu_torch.cholesky.p25d import cholesky_25d, pcholesky
from conflux_tpu_torch.cholesky.profiled import cholesky_25d_profiled
from conflux_tpu_torch.comm import SUBSETS
from conflux_tpu_torch.grid import choose_grid_cholesky, choose_grid_lu, \
    make_grid
from conflux_tpu_torch.layout import (
    BlockCyclic,
    distribute,
    redistribute,
    retile,
    undistribute,
)
from conflux_tpu_torch.lu.cp25d import clu_25d
from conflux_tpu_torch.lu.p25d import lu_25d, plu
from conflux_tpu_torch.lu.profiled import lu_25d_profiled
from conflux_tpu_torch.pgemm import pchol_residual_25d, pgemm, \
    plu_residual_25d
from conflux_tpu_torch.scalapack import pdgetrf, pdpotrf
from conflux_tpu_torch.validation import cholesky_residual_dist, \
    lu_residual_dist


def _jax_free():
    return "jax" not in sys.modules


def _numpy(t):
    return None if t is None else t.numpy()


def _dense(t):
    """numpy of a tensor, a bf16 one read as float32 (numpy has no
    bfloat16); None stays None."""
    if t is None:
        return None
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


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


def rank_devices():
    """Where a rank's bare "cuda" tensor lands, beside the card
    `make_grid` gives the rank: run_ranks' default device is the card."""
    import torch.distributed as dist

    grid = make_grid((dist.get_world_size(), 1, 1))
    return {"rank": dist.get_rank(), "count": torch.cuda.device_count(),
            "bare": str(torch.zeros(1, device="cuda").device),
            "grid": str(grid.device)}


def comm_world(shape, comm_args, volume_args):
    """`comm_cases` and `comm_volume_cases` in one world."""
    return {"comm": comm_cases(shape, *comm_args),
            "volume": comm_volume_cases(shape, *volume_args)}


def _grids():
    """make_grid by shape, each grid made once: every rank creates the
    same grids in the same order, so their groups match."""
    grids = {}

    def get(shape):
        if shape not in grids:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")      # idle ranks
                grids[shape] = make_grid(shape, device="cpu")
        return grids[shape]

    return get


def crout_cases(cases):
    """The LU of each case dict (shape, A, v, pivoting, variant, rowpart)
    at 'highest' through `distribute`, `lu_25d` and `undistribute`, each
    on its grid of this world. Returns rank 0's dense factor, every
    rank's pivot vector and every rank's record of the factorization's
    collectives."""
    grid_of = _grids()
    out = []
    for c in cases:
        grid = grid_of(c["shape"])
        A = c["A"]
        desc = BlockCyclic.create(A.shape[0], A.shape[1], c["v"], grid)
        G = distribute(A, desc)
        grid.comm.record.clear()
        F, perm = lu_25d(G, desc, c["pivoting"], "highest", c["variant"],
                         rowpart=c["rowpart"])
        records = list(grid.comm.record)
        out.append({"F": _numpy(undistribute(F, desc)),
                    "perm": _numpy(perm), "records": records})
    return {"cases": out, "jax_free": _jax_free()}


def _blocks_to_rank0(comm, t):
    """Every rank's block (None on an idle rank: the grid's ranks only),
    gathered to rank 0 in grid-rank order."""
    return None if t is None else _numpy(comm.gather(t, 0))


def dist_rest_cases(cfg):
    """pgemm, the SUMMA residual gates, retile / redistribute, pdgetrf /
    pdpotrf and the profiled rank programs, each on its grid of this
    world (cfg: the inputs per part; test_torch_dist_rest.py)."""
    grid_of = _grids()
    out = {}

    # pgemm: rank 0's dense C per grid shape
    A, B, v = cfg["pgemm"]
    for shape in cfg["pgemm_shapes"]:
        grid = grid_of(shape)
        desc = BlockCyclic.create(A.shape[0], A.shape[1], v, grid)
        C = pgemm(distribute(A, desc), distribute(B, desc), desc)
        out[("pgemm", shape)] = _numpy(undistribute(C, desc))

    # the distributed gates on each rank beside rank 0's gathered factor
    for i, (shape, A, v) in enumerate(cfg["lu_gates"]):
        grid = grid_of(shape)
        m, n = A.shape
        desc = BlockCyclic.create(m, n, v, grid)
        G = distribute(A, desc)
        F, perm = lu_25d(G, desc, "tournament", "highest")
        res = (lu_residual_dist(G, F, perm, desc) if (m, n) == (desc.M,
                                                              desc.N)
               else plu_residual_25d(G, F, perm, desc, n_true=n, m_true=m))
        out[("lu_gate", i)] = {"res": res, "perm": _numpy(perm),
                               "F": _numpy(undistribute(F, desc))}
    for i, (shape, S, v) in enumerate(cfg["chol_gates"]):
        grid = grid_of(shape)
        n = S.shape[0]
        desc = BlockCyclic.create(n, n, v, grid)
        G = distribute(S, desc)
        L = cholesky_25d(G, desc, "highest")
        res = (cholesky_residual_dist(G, L, desc) if n == desc.N
               else pchol_residual_25d(G, L, desc, n_true=n))
        out[("chol_gate", i)] = {"res": res,
                                 "L": _numpy(undistribute(L, desc))}

    # retile / redistribute: every rank's destination block on rank 0
    A, moves = cfg["retile"]
    for i, (s_shape, s_v, d_shape, d_v) in enumerate(moves):
        src = BlockCyclic.create(A.shape[0], A.shape[1], s_v,
                                 grid_of(s_shape))
        dst = BlockCyclic.create(A.shape[0], A.shape[1], d_v,
                                 grid_of(d_shape))
        move = retile if s_shape == d_shape else redistribute
        G2 = move(distribute(A, src), src, dst)
        back = retile(G2, dst, src)
        out[("retile", i)] = {
            "blocks": _blocks_to_rank0(dst.grid.comm, G2),
            "back_equal": None if back is None
            else bool(torch.equal(back, distribute(A, src)))}

    # the ScaLAPACK-style entry points at their default tile
    A, S, shape = cfg["scalapack"]
    grid = grid_of(shape)
    f = pdgetrf(A, grid)
    ch = pdpotrf(S, grid)
    dense_f, dense_l = f.dense(), ch.dense()
    out["pdgetrf"] = {"v": f.desc.v, "F": _numpy(dense_f),
                      "perm": _numpy(f.perm),
                      "ipiv": f.ipiv() if dense_f is not None else None}
    out["pdpotrf"] = {"v": ch.desc.v, "L": _numpy(dense_l)}

    # the profiled rank programs: the same bits as the unprofiled ones,
    # and the region table of each
    A, S, v = cfg["profiled"]
    for shape in cfg["profiled_shapes"]:
        grid = grid_of(shape)
        n = A.shape[0]
        desc = BlockCyclic.create(n, n, v, grid)
        G, GS = distribute(A, desc), distribute(S, desc)
        profiler.enable(True)
        try:
            tables = {}
            profiler.PC()
            F1, p1 = lu_25d_profiled(G, desc, "tournament", "highest")
            tables["lu"] = {k: (c.calls, c.wall) for k, c in
                            profiler._GLOBAL.root.children.items()}
            profiler.PC()
            L1 = cholesky_25d_profiled(GS, desc, "highest")
            tables["cholesky"] = {k: (c.calls, c.wall) for k, c in
                                  profiler._GLOBAL.root.children.items()}
            report = profiler._GLOBAL.report()
        finally:
            profiler.enable(False)
            profiler.PC()
        F2, p2 = lu_25d(G, desc, "tournament", "highest", unroll=False)
        L2 = cholesky_25d(GS, desc, "highest", unroll=False)
        same = (None if F1 is None else
                bool(torch.equal(F1, F2) and torch.equal(p1, p2)
                     and torch.equal(L1, L2)))
        out[("profiled", shape)] = {"tables": tables, "same": same,
                                    "report": report, "Nt": desc.Nt}
    out["jax_free"] = _jax_free()
    return out


def dtype_cases(cases):
    """Each case dict (kind 'lu', 'chol', 'clu', 'pdgetrf', 'pdpotrf' or
    'retile'; A as numpy; dtype the torch dtype's name, the tensor made
    from A by torch; shape, v, variant, precision, method, shape2, v2 as
    they apply) on its grid of this world: the distributed factorization,
    this rank's record of its collectives, its distributed gate on every
    rank, and rank 0's dense factor (bf16 as float32) with its dtype and
    the pivots; for 'retile', whether this rank's destination block
    equals `distribute`'s."""
    grid_of = _grids()
    out = []
    for c in cases:
        A = torch.from_numpy(c["A"]).to(getattr(torch, c["dtype"]))
        kind = c["kind"]
        perm = None
        if kind == "retile":
            # from the grid `shape` to `shape2` at tile v2; a rank idle in
            # the source names the dtype it cannot read off a block
            src = BlockCyclic.create(*A.shape, c["v"], grid_of(c["shape"]))
            dst = BlockCyclic.create(*A.shape, c["v2"], grid_of(c["shape2"]))
            G2 = retile(distribute(A, src), src, dst, A.dtype)
            out.append({"equal": None if G2 is None
                        else bool(torch.equal(G2, distribute(A, dst))),
                        "dtype": None if G2 is None else str(G2.dtype)})
            continue
        if kind in ("pdgetrf", "pdpotrf"):
            # the grid pdgetrf / pdpotrf choose over the world's ranks, on
            # the CPU; the tile is theirs
            import torch.distributed as dist

            P = dist.get_world_size()
            shape = (choose_grid_lu(*A.shape, P) if kind == "pdgetrf"
                     else choose_grid_cholesky(P, A.shape[0]))
            f = (pdgetrf if kind == "pdgetrf" else pdpotrf)(
                A, grid_of(shape))
            desc, F, perm, G = f.desc, f.data, f.perm, None
            records = []
        else:
            grid = grid_of(c["shape"])
            desc = BlockCyclic.create(A.shape[0], A.shape[1], c["v"], grid)
            G = distribute(A, desc)
            grid.comm.record.clear()
            if kind == "lu":
                F, perm = lu_25d(G, desc, "tournament", c["precision"],
                                 c["variant"])
            elif kind == "clu":
                F, perm = clu_25d(G, desc, c["method"])
            else:
                F = cholesky_25d(G, desc, c["precision"], c["variant"])
            records = list(grid.comm.record)
        if G is None:
            G = distribute(A, desc)
        gate = (cholesky_residual_dist(G, F, desc) if perm is None
                else lu_residual_dist(G, F, perm, desc))
        out.append({"F": _dense(undistribute(F, desc)),
                    "dtype": None if F is None else str(F.dtype),
                    "perm": _numpy(perm), "gate": gate, "v": desc.v,
                    "grid": str(desc.grid), "records": records})
    return {"cases": out, "jax_free": _jax_free()}

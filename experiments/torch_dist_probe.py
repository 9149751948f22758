"""The distributed layer on one card: which collectives a gloo world takes
on CUDA tensors, and where the rank programs' time goes.

    python3 -m experiments.torch_dist_probe --ops
    python3 -m experiments.torch_dist_probe --dtypes
    python3 -m experiments.torch_dist_probe --breakdown [--n 16384 --v 512]

--ops tries each collective that `comm.Comm` issues on a CUDA tensor
(`probe_ops("cpu")` does the same on CPU tensors), each in a gloo world
of two ranks of its own (`launch.run_ranks`: an op gloo does not take can
abort the process), and prints what each one did: the evidence for which
collectives `comm.Comm` stages through host memory on a gloo world.

--dtypes tries each of those collectives but isend/irecv on CUDA tensors
of bfloat16, float64, complex64 and complex128 in one gloo world of two
ranks, and prints whether each ran and gave the right value: the
evidence for the dtypes `comm.Comm` moves as they are and those it moves
as their real view.

--breakdown runs chip_smoke's distributed LU and Cholesky at N = 16384
(lu_25d at the auto variant and 'crout', tournament, and cholesky_25d at
the auto variant, 'high', on a (2, 2, 2) grid of 8 gloo ranks on the
card, chip_smoke's inputs), each as distribute, the factorization and
the gather to rank 0, then its SUMMA gate (`validation.lu_residual_dist`
/ `cholesky_residual_dist`) on the distributed blocks, with every `Comm`
collective timed on each rank, the card synchronised before and after
it: per rank, the wall of each path and the seconds and calls of each
collective, and the gate's own seconds and collectives apart; the rest
of a wall is the rank's own work (its kernels, its host code, and
waiting for the card that 8 processes share). --device cpu rehearses it
on CPU ranks.
"""

from __future__ import annotations

import argparse
import subprocess

OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "all_to_all_single", "isend/irecv", "gather")
COLLECTIVES = ("psum", "all_gather", "ppermute", "psum_scatter", "gather",
               "all_to_all")
PATHS = ("lu_25d", "lu_25d crout", "cholesky_25d")


def _op_rank(op: str, where: str):
    """One collective `op` on a tensor on `where` in a world of two ranks;
    what rank 0 received, as a string."""
    import torch
    import torch.distributed as dist

    r = dist.get_rank()
    x = torch.full((4,), float(r + 1), device=where)
    if op == "all_reduce":
        dist.all_reduce(x)
        got = x[0]
    elif op == "broadcast":
        dist.broadcast(x, 0)
        got = x[0]
    elif op == "all_gather":
        parts = [torch.empty(4, device=where) for _ in range(2)]
        dist.all_gather(parts, x)
        got = parts[1][0]
    elif op == "all_gather_into_tensor":
        y = torch.empty(8, device=where)
        dist.all_gather_into_tensor(y, x)
        got = y[4]
    elif op == "reduce_scatter_tensor":
        y = torch.empty(2, device=where)
        dist.reduce_scatter_tensor(y, x)
        got = y[0]
    elif op == "all_to_all_single":
        # uneven splits, as layout.retile sends them
        y = torch.empty(4, device=where)
        splits = [1, 3] if r == 0 else [3, 1]
        dist.all_to_all_single(y, x, splits, splits)
        got = y[-1]
    elif op == "isend/irecv":
        y = torch.empty(4, device=where)
        for w in (dist.isend(x, 1 - r), dist.irecv(y, 1 - r)):
            w.wait()
        got = y[0]
    else:
        parts = ([torch.empty(4, device=where) for _ in range(2)]
                 if r == 0 else None)
        dist.gather(x, parts, dst=0)
        got = parts[1][0] if parts else x[0]
    return f"ok: {got.item():g} on {got.device.type}"


DTYPES = ("bfloat16", "float64", "complex64", "complex128")
# the collectives the rank programs run on other dtypes than float32 (every
# one but isend/irecv, which Comm stages through the host on gloo + CUDA)
DTYPE_OPS = tuple(op for op in OPS if op != "isend/irecv")


def _dtype_rank(where: str):
    """Each op of DTYPE_OPS on each dtype of DTYPES in one world of two
    ranks: {(op, dtype): 'ok: <value rank 0 received>', 'wrong: ...' or
    'fails: ...'}. Rank r sends r + 1 (+ (r + 1) i for complex)."""
    import torch
    import torch.distributed as dist

    r = dist.get_rank()
    out = {}
    for name in DTYPES:
        dt = getattr(torch, name)
        val = complex(r + 1, r + 1) if dt.is_complex else float(r + 1)
        for op in DTYPE_OPS:
            x = torch.full((4,), val, dtype=dt, device=where)
            try:
                if op == "all_reduce":
                    dist.all_reduce(x)
                    got, want = x[0], 3
                elif op == "broadcast":
                    dist.broadcast(x, 0)
                    got, want = x[0], 1
                elif op == "all_gather":
                    parts = [torch.empty_like(x) for _ in range(2)]
                    dist.all_gather(parts, x)
                    got, want = parts[1][0], 2
                elif op == "all_gather_into_tensor":
                    y = x.new_empty(8)
                    dist.all_gather_into_tensor(y, x)
                    got, want = y[4], 2
                elif op == "reduce_scatter_tensor":
                    y = x.new_empty(2)
                    dist.reduce_scatter_tensor(y, x)
                    got, want = y[0], 3
                elif op == "all_to_all_single":
                    y = torch.empty_like(x)
                    splits = [1, 3] if r == 0 else [3, 1]
                    dist.all_to_all_single(y, x, splits, splits)
                    got, want = y[-1], 2
                else:
                    parts = ([torch.empty_like(x) for _ in range(2)]
                             if r == 0 else None)
                    dist.gather(x, parts, dst=0)
                    got, want = (parts[1][0] if parts else x[0]), 2
                if dt.is_complex:
                    want = complex(want, want)
                good = got.item() == want
                out[(op, name)] = (f"{'ok' if good else 'wrong'}: "
                                   f"{got.item()} on {got.device.type}")
            except (RuntimeError, TypeError, ValueError) as e:
                out[(op, name)] = "fails: " + str(e).splitlines()[0][:160]
    return out


def probe_dtypes(where: str) -> dict:
    """_dtype_rank's findings on rank 0 of one gloo world of two ranks."""
    from conflux_tpu_torch.launch import run_ranks

    return run_ranks(2, _dtype_rank, where, backend="gloo", device=where,
                     timeout=120)[0]


def probe_ops(where: str) -> dict:
    """Each op of OPS in a gloo world of its own: {op: what happened}."""
    from conflux_tpu_torch.launch import run_ranks

    out = {}
    for op in OPS:
        try:
            out[op] = run_ranks(2, _op_rank, op, where, backend="gloo",
                                device=where, timeout=90)[0]
        except (RuntimeError, TimeoutError) as e:      # the probe's finding
            lines = [ln for ln in str(e).splitlines() if ln.strip()]
            out[op] = "fails: " + " | ".join(lines[:1] + lines[-1:])[:240]
    return out


def _breakdown_rank(n: int, v: int, device: str):
    """One rank of the breakdown: each path's wall and its collectives'
    seconds and calls by kind, then its gate's, with the card
    synchronised around each."""
    import time

    import torch
    import torch.distributed as dist

    from chip_smoke import DIST_GRID, _dist_inputs
    from conflux_tpu_torch import comm
    from conflux_tpu_torch.cholesky.p25d import cholesky_25d
    from conflux_tpu_torch.grid import make_grid
    from conflux_tpu_torch.layout import BlockCyclic, distribute, \
        undistribute
    from conflux_tpu_torch.lu.p25d import lu_25d
    from conflux_tpu_torch.validation import cholesky_residual_dist, \
        lu_residual_dist

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    spent: dict = {}

    def timed(name, fn):
        def call(self, *args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            sync()
            s, c = spent.get(name, (0.0, 0))
            spent[name] = (s + time.perf_counter() - t0, c + 1)
            return out
        return call

    for name in COLLECTIVES:
        setattr(comm.Comm, name, timed(name, getattr(comm.Comm, name)))
    grid = make_grid(DIST_GRID, device=device)
    A, S = _dist_inputs(n, device)
    desc = BlockCyclic.create(n, n, v, grid)
    out = {}
    for path in PATHS:
        sync()
        dist.barrier()
        spent.clear()
        t0 = time.perf_counter()
        if path == "cholesky_25d":
            G = distribute(S, desc)
            F, perm = cholesky_25d(G, desc, "high"), None
        else:
            G = distribute(A, desc)
            F, perm = lu_25d(G, desc, "tournament", "high",
                             "crout" if path.endswith("crout") else None)
        undistribute(F, desc)
        sync()
        wall = time.perf_counter() - t0
        factor = dict(spent)
        spent.clear()
        t0 = time.perf_counter()
        if perm is None:
            cholesky_residual_dist(G, F, desc)
        else:
            lu_residual_dist(G, F, perm, desc)
        sync()
        out[path] = {"wall": wall, "spent": factor,
                     "gate": time.perf_counter() - t0,
                     "gate_spent": dict(spent)}
        del G, F, perm
    return out


def breakdown(n: int, v: int, device: str, smi: str):
    from chip_smoke import DIST_GRID
    from conflux_tpu_torch.launch import run_ranks

    P = DIST_GRID[0] * DIST_GRID[1] * DIST_GRID[2]
    ranks = run_ranks(P, _breakdown_rank, n, v, device, backend="gloo",
                      device=device, timeout=900)

    def ops(spent):
        return ", ".join(f"{k} {s:.3f} ({c})"
                         for k, (s, c) in sorted(spent.items()))

    for path in PATHS:
        print(f"{path} {'x'.join(map(str, DIST_GRID))} N={n} v={v} 'high', "
              f"{P} gloo ranks on {device} ({smi}); seconds per rank:")
        for r, res in enumerate(ranks):
            e = res[path]
            comm_s = sum(s for s, _ in e["spent"].values())
            gate_s = sum(s for s, _ in e["gate_spent"].values())
            print(f"  rank {r}: wall {e['wall']:.3f}, collectives "
                  f"{comm_s:.3f} [{ops(e['spent'])}], own work "
                  f"{e['wall'] - comm_s:.3f}; SUMMA gate {e['gate']:.3f}, "
                  f"its collectives {gate_s:.3f} [{ops(e['gate_spent'])}]")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int)
    ap.add_argument("--v", type=int)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--ops", action="store_true")
    mode.add_argument("--dtypes", action="store_true")
    mode.add_argument("--breakdown", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    smi = "the CPU"
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {smi}")
    if args.ops:
        for op, what in probe_ops(args.device).items():
            print(f"gloo {op:24s} on {args.device}: {what}", flush=True)
        return 0
    if args.dtypes:
        for (op, dt), what in probe_dtypes(args.device).items():
            print(f"gloo {op:24s} {dt:10s} on {args.device}: {what}",
                  flush=True)
        return 0
    import chip_smoke

    if args.device == "cuda":
        chip_smoke.phase_build()
    breakdown(args.n or chip_smoke.DIST_N, args.v or chip_smoke.DIST_V,
              args.device, smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

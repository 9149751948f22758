"""Start the ranks of a distributed run: the counterpart of `mpirun`.

    from conflux_tpu_torch.launch import run_ranks
    results = run_ranks(8, fn, *args, backend="gloo")

runs fn(*args) in 8 processes of one torch.distributed world and returns
each rank's result, in rank order. The processes start through the
`spawn` context and meet through a `file://` rendezvous in a fresh
temporary directory, so concurrent worlds (parallel test workers) never
compete for a port. `fn` and its arguments must pickle (a module-level
function), and so must its result. A rank that raises or outlives
`timeout` fails the whole run: every rank is stopped and the error names
the rank. device='cuda', the default as in every entry point of the
package, gives each rank card rank % device_count
(`torch.cuda.set_device`), the card `grid.make_grid` places it on; one
card can hold every rank of a gloo world, since gloo passes data through
host memory. device='cpu' runs the ranks on the CPU.

The same entry points run under `torchrun` (`env://`): `make_grid` calls
`init_from_env` first, which joins the world torchrun describes.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback


def init_from_env(backend: str | None = None) -> None:
    """Join the world described by torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) unless a process group exists
    already or no such environment is set. backend None: NCCL when every
    rank has a card of its own, gloo otherwise."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if backend is None:
        world = int(os.environ["WORLD_SIZE"])
        one_card_each = (torch.cuda.is_available()
                         and torch.cuda.device_count() >= world)
        backend = "nccl" if one_card_each else "gloo"
    dist.init_process_group(backend, init_method="env://")


def _rank_main(rank, P, init, backend, device, timeout, results, fn, args):
    import torch
    import torch.distributed as dist

    try:
        if device.startswith("cuda"):
            torch.cuda.set_device(rank % torch.cuda.device_count())
        # P ranks share the host's cores: one rank's threads must not
        # starve the others
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // P))
        dist.init_process_group(
            backend, init_method=init, world_size=P, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        # every rank has joined before any runs fn: a rank that returns
        # at once tears its group down, and a peer still connecting to it
        # would fail
        dist.barrier()
        results.put((rank, True, fn(*args)))
    except BaseException:                      # reported, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(P: int, fn, *args, backend: str = "gloo",
              device: str = "cuda", timeout: float = 600.0):
    """fn(*args) on each of P ranks of a new world; returns their results
    in rank order. Raises RuntimeError naming the first rank that fails
    (with its traceback), TimeoutError naming the ranks that have not
    finished after `timeout` seconds; every rank process is stopped
    either way."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="conflux_ranks_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, P, init, backend, str(device), timeout,
                               results, fn, args))
             for r in range(P)]
    out = [None] * P
    pending = set(range(P))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while pending:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in pending if procs[r].exitcode is not None]
                if dead:
                    # give a report that is still in flight a last chance
                    try:
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(pending)} of {P} did not finish "
                        f"within {timeout} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {P} failed:\n{payload}")
            out[rank] = payload
            pending.discard(rank)
    finally:
        procs = [p for p in procs if p.pid is not None]   # the started ones
        for p in procs:
            if p.is_alive() and pending:
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out

"""The ranks of the 2.5D LU driver (`drivers/lu25d.py`): one world of
torch.distributed processes, one rank per card, whose rank 0 is the
harness's own process.

Rank 0 starts ranks 1 .. P-1 as processes of

    python -m benchmark.drivers.lu25d_ranks <command fd> <reply fd>

Every rank, rank 0 too, joins the world by the port's torchrun path: RANK,
WORLD_SIZE, MASTER_ADDR (127.0.0.1) and MASTER_PORT in the environment,
`launch.init_from_env` (NCCL where every rank has a card of its own,
gloo otherwise, gloo always on the CPU), then `grid.make_grid` on the
configuration's grid, each rank on card RANK (% the cards there are).
Rank 0 builds and loads the program's kernels first, so the ranks only
load them.

Rank 0 drives the others by small host messages on a pipe each; every
rank then runs the same collective work:

  * ("setup", config, device kind): join the world;
  * ("input", key, n, seed, j): make input j of a run with `seed` from
    the seed on this rank's card and keep this rank's block of it
    (`layout.distribute`); rank 0 keeps the whole matrix too;
  * ("scatter", key, n): a matrix rank 0 holds and no rank made (a
    control, a calibration input) is broadcast from rank 0, and each rank
    keeps its block;
  * ("factor", key, oid, precision): `lu_25d` on the block `key`; each
    worker keeps its block of the factor as output `oid`, and every rank
    ends with one one-element all-reduce over the world, so that rank
    0's synchronize waits for every rank;
  * ("gather", oid): `layout.undistribute` of output `oid` to rank 0;
  * ("exit",).

Each message also carries the inputs and outputs rank 0 has freed since
the last one (its tensors' finalizers list them), which the workers then
drop. A worker answers each message with ("done", seq) once its card has
finished it, or with ("error", traceback) before it exits non-zero.

Bounded failure. A watchdog thread on rank 0 ends the process non-zero
(and every worker with it) when a worker exits, reports an error, or
leaves a message unanswered for STALL_S seconds; a worker ends itself
when rank 0's process is gone or its pipe closes. A worker that finds
the JAX package, JAX or flax loaded exits non-zero.
"""

from __future__ import annotations

import atexit
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
import weakref
from collections import Counter
from itertools import count
from multiprocessing.connection import Connection
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
# seconds a worker may leave a message unanswered before rank 0 ends the run
STALL_S = 120.0
# seconds the workers get to leave at shutdown before they are killed
EXIT_S = 30.0
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

_WORLD = None
_SERIALS = count(1)


def tile(config: dict, n: int) -> int:
    """The configuration's tile at its size; a tiny n (the CPU tests)
    takes n // 8, at least 8, so that the step loop has eight steps."""
    return min(config["call"]["v"], max(8, n // 8))


class Rank:
    """This rank's part of the world: its grid, its resident input
    blocks and the factor blocks it holds."""

    def __init__(self, config: dict, kind: str):
        from conflux_tpu_torch.grid import make_grid
        from conflux_tpu_torch.launch import init_from_env

        rank = int(os.environ["RANK"])
        if kind == "cuda":
            card = rank % torch.cuda.device_count()
            torch.cuda.set_device(card)
            self.device = torch.device("cuda", card)
        else:
            self.device = torch.device("cpu")
        init_from_env("gloo" if kind == "cpu" else None)
        self.grid = make_grid(tuple(config["grid"]), device=self.device)
        self.config = config
        self.blocks = {}         # key -> (desc, block)
        self.held = {}           # oid -> (desc, F block), workers only
        self.collectives = Counter()   # the driver's own, by kind

    def desc(self, n: int):
        from conflux_tpu_torch.layout import BlockCyclic

        return BlockCyclic.create(n, n, tile(self.config, n), self.grid)

    def drop(self, frees):
        for kind, key in frees:
            (self.blocks if kind == "in" else self.held).pop(key, None)

    def make(self, key, n: int, seed: int, j: int) -> torch.Tensor:
        from benchmark import inputs
        from conflux_tpu_torch.layout import distribute

        A = inputs.make(self.config["input"], n, seed, j, self.device)
        d = self.desc(n)
        self.blocks[key] = (d, distribute(A, d))
        return A

    def scatter(self, key, n: int, A=None):
        import torch.distributed as dist

        from conflux_tpu_torch.layout import distribute

        if A is None:
            A = torch.empty((n, n), dtype=torch.float32, device=self.device)
        else:
            A = A.to(self.device, torch.float32).contiguous()
        dist.broadcast(A, src=0)
        self.collectives["broadcast"] += 1
        d = self.desc(n)
        self.blocks[key] = (d, distribute(A, d))

    def factor(self, key, precision: str):
        import torch.distributed as dist

        from conflux_tpu_torch.lu.p25d import lu_25d

        d, G = self.blocks[key]
        F, pivots = lu_25d(G, d, pivoting=self.config["call"]["pivoting"],
                           precision=precision)
        done = torch.ones(1, device=self.device)
        dist.all_reduce(done)
        self.collectives["all_reduce"] += 1
        return d, F, pivots

    def gather(self, desc, F):
        from conflux_tpu_torch.layout import undistribute

        return undistribute(F, desc, 0)


# -- rank 0 ---------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _load_kernels():
    """Build and load the distributed LU's kernels once, before any
    worker starts, so that no two ranks build them at once."""
    from conflux_tpu_torch.ops import _build, cuda_gemm, cuda_lanes, \
        cuda_panel, cuda_trsm

    _build.build(("rank1_panel", "schur_update", "panel_trsm", "lane_move"))
    cuda_panel._load()
    cuda_gemm._load()
    cuda_trsm._load()
    cuda_lanes._load()


class World:
    """Rank 0's side of the world: the workers, their pipes, the watchdog
    and rank 0's own Rank."""

    def __init__(self, config: dict, kind: str):
        self.kind = kind
        P = config["processes"]
        if kind == "cuda":
            _load_kernels()
        env = {"WORLD_SIZE": str(P), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(_free_port())}
        self.procs, self.pipes, self.replies = [], [], []
        for r in range(1, P):
            cmd_r, cmd_w = os.pipe()
            rep_r, rep_w = os.pipe()
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "benchmark.drivers.lu25d_ranks",
                 str(cmd_r), str(rep_w)],
                cwd=ROOT, env=dict(os.environ, RANK=str(r), **env),
                pass_fds=(cmd_r, rep_w), stdin=subprocess.DEVNULL,
                stdout=2))
            os.close(cmd_r)
            os.close(rep_w)
            self.pipes.append(Connection(cmd_w, readable=False))
            self.replies.append(Connection(rep_r, writable=False))
        self.serial = next(_SERIALS)
        self.seq = 0
        self.sent_at = {}                    # seq -> host clock
        self.answered = [0] * (P - 1)
        self.sent = Counter()                # messages by kind
        self.frees = []
        self.oids = 0
        self.closing = False
        self.watchdog = threading.Thread(target=self._watch, daemon=True)
        self.watchdog.start()
        self.send(("setup", config, kind))
        saved = {k: os.environ.get(k) for k in _ENV}
        os.environ.update(env, RANK="0")
        try:
            self.rank = Rank(config, kind)
        finally:
            for k, value in saved.items():
                if value is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = value

    # -- messages and the watchdog ----------------------------------------

    def send(self, msg):
        """One message to every worker, with the frees since the last."""
        self.seq += 1
        self.sent_at[self.seq] = time.monotonic()
        self.sent[msg[0]] += 1
        frees, self.frees = self.frees, []
        for r, pipe in enumerate(self.pipes):
            try:
                pipe.send((self.seq, msg, frees))
            except OSError:
                self._die(f"rank {r + 1} is gone")

    def _die(self, why: str):
        print(f"benchmark.drivers.lu25d_ranks: {why}; ending the run",
              file=sys.stderr, flush=True)
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        os._exit(3)

    def _watch(self):
        while not self.closing:
            now = time.monotonic()
            for r, (proc, reply) in enumerate(zip(self.procs, self.replies)):
                try:
                    while reply.poll():
                        what, payload = reply.recv()
                        if what == "error":
                            if not self.closing:
                                self._die(f"rank {r + 1} failed:\n{payload}")
                        else:
                            self.answered[r] = payload
                except (EOFError, OSError):
                    pass
                if self.closing:
                    return
                code = proc.poll()
                if code is not None:
                    self._die(f"rank {r + 1} exited with code {code}")
                pending = self.answered[r] + 1
                if (pending <= self.seq
                        and now - self.sent_at[pending] > STALL_S):
                    self._die(f"rank {r + 1} left message {pending} "
                              f"unanswered for {STALL_S:.0f} s")
            time.sleep(0.2)

    def freed(self, kind: str, key):
        """A finalizer's note: rank 0 dropped input or output `key`; the
        workers drop theirs with the next message."""
        self.frees.append((kind, key))
        self.rank.drop([(kind, key)])

    # -- the commands ---------------------------------------------------

    def make(self, n: int, seed: int, j: int) -> torch.Tensor:
        key = (self.serial, self.seq + 1)
        self.send(("input", key, n, seed, j))
        A = self.rank.make(key, n, seed, j)
        A._lu25d_key = key
        weakref.finalize(A, self.freed, "in", key)
        return A

    def factor(self, A: torch.Tensor, precision: str):
        """(F, pivots): rank 0's block of A's factor and the pivots."""
        key = getattr(A, "_lu25d_key", None)
        if key is None or key not in self.rank.blocks:
            key = (self.serial, self.seq + 1)
            self.send(("scatter", key, A.shape[0]))
            self.rank.scatter(key, A.shape[0], A)
            A._lu25d_key = key
            weakref.finalize(A, self.freed, "in", key)
        self.oids += 1
        oid = self.oids
        self.send(("factor", key, oid, precision))
        desc, F, pivots = self.rank.factor(key, precision)
        F._lu25d_out = (oid, desc)
        weakref.finalize(F, self.freed, "out", oid)
        return F, pivots

    def gather(self, F: torch.Tensor) -> torch.Tensor:
        """The whole factor of which F is rank 0's block."""
        oid, desc = F._lu25d_out
        self.send(("gather", oid))
        return self.rank.gather(desc, F)

    def close(self):
        """Let the workers go and leave the world; every worker is gone
        on return. Returns their exit codes."""
        import torch.distributed as dist

        if self.closing:
            return [p.returncode for p in self.procs]
        self.closing = True
        self.watchdog.join()
        self.send(("exit",))
        deadline = time.monotonic() + EXIT_S
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for c in self.pipes + self.replies:
            c.close()
        if dist.is_initialized():
            dist.destroy_process_group()
        return [p.returncode for p in self.procs]


def world(config: dict, device) -> World:
    """The process's world on the device kind of `device` (None: the
    card), started on first use and kept for the process's life; a world
    on the other kind is closed first."""
    global _WORLD
    kind = torch.device("cuda" if device is None else device).type
    if _WORLD is not None and _WORLD.kind != kind:
        shutdown()
    if _WORLD is None:
        _WORLD = World(config, kind)
    return _WORLD


def shutdown():
    """Close the world if there is one; the workers' exit codes."""
    global _WORLD
    w, _WORLD = _WORLD, None
    return w.close() if w is not None else []


atexit.register(shutdown)


# -- ranks 1 .. P-1 ----------------------------------------------------------


def _watch_parent(parent: int):
    while os.getppid() == parent:
        time.sleep(0.5)
    os._exit(4)


def _forbidden():
    from benchmark.run import forbidden_modules

    return forbidden_modules()


def worker(cmd_fd: int, reply_fd: int):
    """A worker's life: join the world on ("setup", ...), then run rank
    0's messages (module docstring) until ("exit",) or rank 0 is gone."""
    cmd = Connection(cmd_fd, writable=False)
    reply = Connection(reply_fd, readable=False)
    threading.Thread(target=_watch_parent, args=(os.getppid(),),
                     daemon=True).start()
    try:
        rank = None
        while True:
            seq, msg, frees = cmd.recv()
            what = msg[0]
            if what == "exit":
                break
            if what == "setup":
                config, kind = msg[1], msg[2]
                if kind == "cpu":
                    torch.set_num_threads(max(
                        1, (os.cpu_count() or 1) // config["processes"]))
                rank = Rank(config, kind)
            else:
                rank.drop(frees)
                if what == "input":
                    rank.make(*msg[1:])
                elif what == "scatter":
                    rank.scatter(*msg[1:])
                elif what == "factor":
                    _, key, oid, precision = msg
                    desc, F, _ = rank.factor(key, precision)
                    rank.held[oid] = (desc, F)
                elif what == "gather":
                    rank.gather(*rank.held[msg[1]])
                else:
                    raise ValueError(f"unknown message {what!r}")
            bad = _forbidden()
            if bad:
                raise RuntimeError(f"this rank loaded {bad}: the benchmark "
                                   "measures the PyTorch port alone")
            if rank.device.type == "cuda":
                torch.cuda.synchronize(rank.device)
            reply.send(("done", seq))
    except EOFError:
        os._exit(0)                     # rank 0 is gone
    except BaseException:
        tb = traceback.format_exc()
        print(tb, file=sys.stderr, flush=True)
        try:
            reply.send(("error", tb))
        except OSError:
            pass
        os._exit(1)
    os._exit(0)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]))

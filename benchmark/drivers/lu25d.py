"""Driver of the 2.5D LU configurations: the program's distributed entry
point, `conflux_tpu_torch.lu.p25d.lu_25d`, called on every rank of a world
of one process per card, the harness's process being rank 0
(`drivers/lu25d_ranks.py` starts the others and passes the work on).

  * `prepare` joins the world (started once per process) and returns the
    timed call: A -> (F, pivots), F rank 0's block of the factor, the
    pivots the global pivot vector. Each call sends every worker one
    small host message; every rank then runs `lu_25d` on its block of A
    and ends with one one-element all-reduce, so that the harness's
    synchronize on rank 0's card waits for every rank.
  * `make_input` makes input j on every rank from the seed, each rank
    keeping its block (inputs are resident); rank 0 returns the whole
    matrix. A matrix the call did not get from `make_input` (a control's,
    a calibration's) is broadcast from rank 0 and distributed first.
  * `readings` gathers the blocks of the output it is given to rank 0,
    after the window, and judges the whole factor with
    `reference.lu_readings`; an output that is already whole is judged as
    it is, and one whose pivots are not a permutation of its rows reads
    inf on every number.
  * `plain` and the control `control_tf32` are the plain CALU of
    `lu25d_plain.py` on rank 0, in IEEE fp32 and with TF32 products;
    `program_bf16` is the program itself on every rank at 'bf16'.
  * `work_of` counts rank 0's K1 blocks and K3 updates in the 'windowed'
    program (below); where the configuration's `work_path` is one that
    `benchmark.work` counts, it hands over to `drivers/single.py`.

Everything after the window (gathers, judging) and before it (the world,
the inputs, the warm calls) lies outside the window's clock.
"""

from __future__ import annotations

from benchmark import inputs, reference, work
from benchmark.drivers import lu25d_plain, lu25d_ranks, single

# the step loop counted by `work_of`: `lu_25d`'s right-looking rank
# program as dispatch.choose_variant picks it at the cell's size
WORK_PATH = "lu25d_windowed"
WINDOWS = 8            # lu_25d's windows (its default)
K1_BLOCK = 64          # ops/panel._BLOCK: the local selections' K1 blocks


def prepare(config: dict, n, device):
    """The timed call on the configuration's precision."""
    return _program(config, config["call"]["precision"], device)


def _program(config: dict, precision: str, device=None):
    world = lu25d_ranks.world(config, device)

    def call(A):
        return world.factor(A, precision)
    return call


def make_input(config: dict, n: int, seed: int, j: int, device):
    """Input j of a run with `seed`, made on every rank; rank 0's whole
    matrix."""
    return lu25d_ranks.world(config, device).make(n, seed, j)


def judge_input(config: dict, n: int, seed: int, j: int, device):
    """The same matrix as `make_input`'s, made on rank 0 alone."""
    return inputs.make(config["input"], n, seed, j, device)


def readings(config: dict, A, out) -> dict:
    F, perm = out
    n = A.shape[0]
    if getattr(F, "_lu25d_out", None) is not None:
        F = lu25d_ranks.world(config, A.device).gather(F)
    elif tuple(F.shape) != (n, n) or perm.numel() != n:
        return {k: float("inf") for k in ("resid_f", "resid_max",
                                          "max_abs_l")}
    return reference.lu_readings(A, F, perm)


def _px(config: dict) -> int:
    return config["grid"][0]


def plain(config: dict, A):
    """The plain CALU in the program's place, IEEE fp32."""
    n = A.shape[0]
    return lu25d_plain.calu(A, lu25d_ranks.tile(config, n), _px(config))


def controls(config: dict) -> dict:
    """The two stand-ins one precision below the configuration's: the
    plain CALU with its products on TF32 operands, and the program on
    every rank with one bf16 pass a product ('bf16')."""
    def tf32(A):
        n = A.shape[0]
        return lu25d_plain.calu(A, lu25d_ranks.tile(config, n),
                                _px(config), tf32=True)

    def bf16(A):
        return _program(config, "bf16", A.device)(A)
    return {"control_tf32": tf32, "program_bf16": bf16}


# -- the work of rank 0 ------------------------------------------------------


def _segment_starts(Nt: int, windows: int):
    """The first step of each window of `windows` near-equal segments
    (dispatch.segment_bounds)."""
    w = max(1, min(windows, Nt))
    chunk = -(-Nt // w)
    return range(0, Nt, chunk)


def _row_frontier(n: int, steps_done: int, v: int, Px: int) -> int:
    """The working rows after a rebalance (lu.p25d._row_frontier): the
    live rows over Px, rounded up to 8, at least v rounded up to 8."""
    live = n - steps_done * v
    return max(-(-v // 8) * 8, -(-live // Px // 8) * 8)


def steps(n: int, v: int, Px: int, Py: int):
    """(mr, nc) of each step of rank 0 in the 'windowed' program on an
    [n, n] matrix: its working rows (Ml until a rebalance at the end of a
    window shrinks them to the frontier) and its live columns, the local
    width from the step's frozen-column frontier on."""
    Nt, Ml, Nl = n // v, n // Px, n // Py
    rebalance = {lo - 1 for lo in _segment_starts(Nt, WINDOWS) if lo > 0}
    mr, out = Ml, []
    for k in range(Nt):
        out.append((mr, Nl - (k // Py) * v))
        if k in rebalance:
            mr = min(mr, _row_frontier(n, k + 1, v, Px))
    return out


def k1_blocks(n: int, v: int, Px: int, Py: int):
    """(w, m, forced) of rank 0's K1 blocks: per step the local selection
    on its [mr, v] panel column, then in each butterfly round the merge of
    2v candidates, and in the last round the forced elimination of the v
    winners (ops/panel._lu_select_loop_t in blocks of 64)."""
    per = v // K1_BLOCK
    rounds = (Px - 1).bit_length()
    blocks = []
    for mr, _ in steps(n, v, Px, Py):
        blocks += [(K1_BLOCK, mr, False)] * per
        blocks += [(K1_BLOCK, 2 * v, False)] * (per * rounds)
        if rounds:
            blocks += [(K1_BLOCK, v, True)] * per
    return blocks


def k3_updates(n: int, v: int, Px: int, Py: int, Pz: int, precision: str):
    """(m, n', k) of rank 0's K3 trailing updates R[m, n'] -= L[m, k] @
    Y[k, n'] (lu.p25d._trailing_sub: K3 takes a float32 update in 'high'
    and 'bf16' whose rank k = ceil(v / Pz) is a multiple of 128); [] where
    no update takes K3."""
    l = -(-v // Pz)
    if precision not in ("high", "bf16") or l % 128:
        return []
    return [(mr, nc, l) for mr, nc in steps(n, v, Px, Py)]


def k3_least_ms(updates, precision: str) -> float | None:
    """Sum over the updates of each one's least time: its passes at the
    bf16 peak, or R read and written once and L and Y read once, in fp32,
    the larger."""
    if not updates or precision not in work.PRODUCT:
        return None
    passes, flop_s = work.PRODUCT[precision]
    return sum(work.least_ms(passes * 2.0 * m * nn * k,
                             8.0 * m * nn + 4.0 * (m * k + k * nn), flop_s)
               for m, nn, k in updates)


def work_of(config: dict, n: int) -> dict:
    """Rank 0's K1 and K3 least times per factorization and their
    launches ('rank1_panel', 'schur_update') in the 'windowed' program.
    No K2 runs there: its least time is counted as 0, so `k2_roofline`
    reads 0 % over the split pass its group shares with K3. The K1 time
    follows `work.k1_least_ms`' rule on each block. `benchmark.work`'s
    paths hand over to drivers/single.py; another path has no work here
    (None)."""
    path = config.get("work_path")
    if path in work.PATHS:
        return single.work_of(config, n)
    if path != WORK_PATH:
        return {"k1_least_ms": None, "k2_least_ms": None,
                "k3_least_ms": None, "launches": None}
    v = lu25d_ranks.tile(config, n)
    Px, Py, Pz = config["grid"]
    precision = config["call"]["precision"]
    blocks = k1_blocks(n, v, Px, Py)
    updates = k3_updates(n, v, Px, Py, Pz, precision)
    return {"k1_least_ms": sum(work.least_ms(
                1.0 * w * (w - 1) * m + w * m,
                4.0 * (2 * w * m + 2 * m) + 8.0 * w, work.FP32_FLOP_S)
                for w, m, _ in blocks),
            "k2_least_ms": 0.0,
            "k3_least_ms": k3_least_ms(updates, precision),
            "launches": {"rank1_panel": len(blocks),
                         "schur_update": len(updates)}}

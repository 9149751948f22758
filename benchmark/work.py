"""The work of one factorization, call by call, from its step loop; the
card's published peaks; and each call's least time by the roofline rule.

Frozen copies, so that a later change to the program cannot move the
yardstick:

  * `k1_blocks` is `chip_smoke.k1_blocks` (chip_smoke.py:186-212 at
    commit 6687417) for the crout and Cholesky paths, the two that the
    benchmark's configurations run;
  * `k2_calls` extends `chip_smoke.loop_launches` (chip_smoke.py:215-228)
    from a count of K2's launches to the shape of each big-K product
    R - A @ B that the step loop forms;
  * the bounds are chip_smoke's: K1's operations and bytes
    (chip_smoke.py:608-612), K2's (chip_smoke.py:1023-1025), the peaks of
    chip_smoke.py:338-345 (NVIDIA H100 SXM data sheet, dense rates).

The work is keyed on the operation each step computes (a panel's
elimination, a big-K product), not on the kernel that ran it, so a change
that routes a product elsewhere is read against the same work.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
FP32_FLOP_S = 67e12

# each precision of `lu_factor`/`cholesky`: the passes of one product and
# the peak of their type ('high' three bf16 passes, 'highest' IEEE fp32)
PRODUCT = {"high": (3, BF16_FLOP_S), "bf16": (1, BF16_FLOP_S),
           "highest": (1, FP32_FLOP_S)}
# the step loops whose calls are counted here
PATHS = ("crout", "cholesky")


def k1_blocks(path: str, n: int, v: int):
    """(w, m, forced) of every K1 block of one n, v factorization of
    `path` ('crout' or 'cholesky'): crout step k factors its panel of
    w = min(v, n - k) columns over the m = n - k live rows in 128-wide
    blocks; Cholesky factors each [w, w] diagonal tile, forced, in [64, w]
    blocks. None for another path."""
    if path not in PATHS:
        return None
    blocks = []
    for k in range(0, n, v):
        w = min(v, n - k)
        if path == "cholesky":
            blocks += [(64, w, True)] * (w // 64)
        else:
            blocks += [(128, n - k, False)] * (w // 128)
    return blocks


def k2_calls(path: str, n: int, v: int):
    """(m, k, n') of every big-K product R[m, n'] - A[m, k] @ B[k, n'] of
    one n, v factorization of `path`: crout's panel update [n - k, w] at
    each step with k > 0 and its pivot-row refresh [w, n - k - w] where
    k + w < n; Cholesky's panel update [n - k, w] at each step with
    k > 0. None for another path."""
    if path not in PATHS:
        return None
    calls = []
    for k in range(v, n, v):
        w = min(v, n - k)
        calls.append((n - k, k, w))
        if path == "crout" and k + w < n:
            calls.append((w, k, n - k - w))
    return calls


def least_ms(flops: float, nbytes: float, flop_s: float) -> float:
    """The least time the card could take: operations over their peak or
    bytes over the memory's, the larger, in ms."""
    return 1e3 * max(flops / flop_s, nbytes / HBM_BYTES_S)


def k1_least_ms(path: str, n: int, v: int) -> float | None:
    """Sum over K1's blocks of each block's least time: w (w - 1) / 2
    rank-1 multiply-adds per lane and m w divisions in fp32, the block and
    its pivot lanes read once and written once. None for a path with no
    step loop here."""
    blocks = k1_blocks(path, n, v)
    if blocks is None:
        return None
    return sum(least_ms(1.0 * w * (w - 1) * m + w * m,
                        4.0 * (2 * w * m + 2 * m) + 8.0 * w, FP32_FLOP_S)
               for w, m, _ in blocks)


def k2_least_ms(path: str, n: int, v: int, precision: str) -> float | None:
    """Sum over the big-K products of each one's least time: its passes
    at the peak of their type, or R, A and B read once and the fp32
    result written once. None for a path with no step loop here or a
    precision with no peak."""
    calls = k2_calls(path, n, v)
    if calls is None or precision not in PRODUCT:
        return None
    passes, flop_s = PRODUCT[precision]
    return sum(least_ms(passes * 2.0 * m * nn * k,
                        8.0 * m * nn + 4.0 * (m * k + k * nn), flop_s)
               for m, k, nn in calls)


def launches(path: str, n: int, v: int) -> dict | None:
    """K1's and K2's launches in one factorization, one per block and per
    product (chip_smoke.loop_launches' 'rank1_panel' and
    'sub_matmul_bigk'). None for a path with no step loop here."""
    if path not in PATHS:
        return None
    return {"rank1_panel": len(k1_blocks(path, n, v)),
            "sub_matmul_bigk": len(k2_calls(path, n, v))}

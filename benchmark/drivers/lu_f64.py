"""Driver of the float64 LU configurations: the configuration's entry point
called as `drivers/single.py` calls it, on inputs made in float64, judged
by the plain reference, with controls one precision below float64 and the
work of the step loop counted at the card's FP64 peaks.

The work (`work_of`) keeps `benchmark.work`'s step loops and roofline rule
with 8-byte elements and the peak each f64 part runs at on an H100 SXM
(NVIDIA's data sheet, dense rates): K1 in double on the CUDA cores' FP64
pipes, 34 TFLOP/s; the big-K products on the FP64 tensor cores, where
cuBLAS forms them, 67 TFLOP/s.
"""

from __future__ import annotations

import warnings

import torch

from benchmark import inputs, reference, work
from benchmark.drivers import single

FP64_FLOP_S = 34e12
FP64_TENSOR_FLOP_S = 67e12
# each precision of `lu_factor` on float64: the peak of its one product per
# big-K call ('highest' and 'high' one IEEE f64 product, 'bf16' one bf16
# pass on the operands rounded to bf16)
PRODUCT_F64 = {"highest": FP64_TENSOR_FLOP_S, "high": FP64_TENSOR_FLOP_S,
               "bf16": work.BF16_FLOP_S}

prepare = single.prepare


def make_input(config: dict, n: int, seed: int, j: int, device):
    """Input j of a run with `seed`, in float64: the configuration's
    uniform fill, from the generator seed `inputs.input_seed` gives."""
    spec = dict(config["input"])
    if spec.pop("generator") != "uniform":
        raise ValueError("drivers/lu_f64.py makes the uniform fill only")
    gen = torch.Generator(device=device).manual_seed(
        inputs.input_seed(seed, j))
    return inputs.uniform(n, gen, device, dtype=torch.float64, **spec)


judge_input = make_input


def readings(config: dict, A, out) -> dict:
    """The reference's LU readings of (F, perm). A float64 F is judged
    through an exact complex128 copy: lu_readings' F.to(float64).triu_()
    returns a float64 F itself (and a clone of it likewise) and would zero
    its L before reading it, where the complex copy casts to a new tensor;
    L's entries and their magnitudes read the same from it."""
    F, perm = out
    if F.dtype == torch.float64:
        F = F.to(torch.complex128)
    with warnings.catch_warnings():
        # the cast back to float64 drops the imaginary part, which is zero
        warnings.simplefilter("ignore", UserWarning)
        return reference.lu_readings(A, F, perm)


def controls(config: dict) -> dict:
    """The two stand-ins one precision below float64, each run on the
    input rounded to float32 and judged against the float64 input: the
    program itself in 'highest' (IEEE fp32) and the reference's blocked
    LU in IEEE fp32."""
    program = prepare(dict(config, call=dict(config["call"],
                                             precision="highest")),
                      None, None)
    v = config["call"]["v"]
    return {"program_f32": lambda A: program(A.to(torch.float32)),
            "reference_f32": lambda A: reference.lu_blocked(
                A.to(torch.float32), v)}


def plain(config: dict, A):
    """The reference in the program's place: its blocked LU on the float64
    input, every operation in f64."""
    return reference.lu_blocked(A, config["call"]["v"])


def k1_least_ms(path: str, n: int, v: int) -> float | None:
    """Sum over K1's blocks of each block's least time in double:
    `work.k1_least_ms`' operations at the FP64 peak, its elements (the
    block and the lanes' availability, read once and written once) at 8
    bytes. None for a path with no step loop in `benchmark.work`."""
    blocks = work.k1_blocks(path, n, v)
    if blocks is None:
        return None
    return sum(work.least_ms(1.0 * w * (w - 1) * m + w * m,
                             8.0 * (2 * w * m + 2 * m) + 8.0 * w,
                             FP64_FLOP_S)
               for w, m, _ in blocks)


def k2_least_ms(path: str, n: int, v: int,
                precision: str) -> float | None:
    """Sum over the big-K products R - A @ B of each one's least time:
    its one product at the peak of the precision's type, or R, A and B
    read once and the result written once at 8 bytes, the larger. None
    for a path with no step loop in `benchmark.work` or a precision with
    no peak here."""
    calls = work.k2_calls(path, n, v)
    if calls is None or precision not in PRODUCT_F64:
        return None
    flop_s = PRODUCT_F64[precision]
    return sum(work.least_ms(2.0 * m * nn * k,
                             8.0 * (2 * m * nn + m * k + k * nn), flop_s)
               for m, k, nn in calls)


def work_of(config: dict, n: int) -> dict:
    """K1's and the big-K products' least time per factorization in
    double, and their launches, each None where `benchmark.work` has no
    step loop, or this driver no peak, for the configuration's path and
    precision."""
    path, v = config.get("work_path"), config["call"]["v"]
    return {"k1_least_ms": k1_least_ms(path, n, v),
            "k2_least_ms": k2_least_ms(path, n, v,
                                       config["call"].get("precision")),
            "launches": work.launches(path, n, v)}

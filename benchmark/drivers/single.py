"""Driver of the single-device configurations: one public entry point of
the program (the configuration's "entry", called with its "call"
arguments) on one input at a time, on one card.

The configuration also names its judge ("lu" or "cholesky", see
`benchmark.reference`), its input generator ("input", see
`benchmark.inputs`), and the step loop whose work the rooflines count
("work_path", see `benchmark.work`).
"""

from __future__ import annotations

import functools
import importlib

from benchmark import inputs, reference, work


def prepare(config: dict, n: int, device):
    """The timed call: A -> the entry point's output."""
    module, name = config["entry"].rsplit(".", 1)
    return functools.partial(getattr(importlib.import_module(module), name),
                             **config["call"])


def make_input(config: dict, n: int, seed: int, j: int, device):
    """Input j of a run with `seed`, as the timed call takes it."""
    return inputs.make(config["input"], n, seed, j, device)


judge_input = make_input


def readings(config: dict, A, out) -> dict:
    return reference.readings(config["judge"], A, out)


def controls(config: dict) -> dict:
    """The two stand-ins one precision below the configuration's: the
    reference in the program's place with its products on TF32 operands,
    and the program with its own lower precision, one bf16 pass a
    product ('bf16')."""
    lower = prepare(dict(config, call=dict(config["call"], precision="bf16")),
                    None, None)
    return {"control_tf32": lambda A: reference.factor(
                config["judge"], A, config["call"]["v"], tf32=True),
            "program_bf16": lower}


def plain(config: dict, A):
    """The reference in the program's place in IEEE fp32."""
    return reference.factor(config["judge"], A, config["call"]["v"])


def work_of(config: dict, n: int) -> dict:
    """K1's and K2's least time per factorization and their launches, each
    None where `benchmark.work` has no step loop or no peak for the
    configuration's path and precision."""
    path, v = config.get("work_path"), config["call"]["v"]
    precision = config["call"].get("precision")
    return {"k1_least_ms": work.k1_least_ms(path, n, v),
            "k2_least_ms": work.k2_least_ms(path, n, v, precision),
            "launches": work.launches(path, n, v)}

"""Shared plumbing of the miniapps and the sweep: the device, the grid
string and the ranks.

The JAX miniapps run one controller over a (virtual) mesh; the port runs
one process per rank. Under torchrun every rank runs the miniapp's body
itself. Otherwise a miniapp whose world has more than one rank starts
its ranks through `launch.run_ranks` (gloo), each rank runs the body, and
the starting process prints what grid rank 0 printed. `--platform` picks
the device (the card by default, `cpu` on request) and `--force_devices
N` the number of ranks started. Times are `timing.timed_run`: CUDA
events on the card, the host's clock on the CPU.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import math
import os


def setup_platform(platform: str | None) -> str:
    """The device the ranks run on: 'cuda' unless `platform` is 'cpu'.
    Asking for the card where there is none raises: nothing falls back to
    the CPU."""
    import torch

    if platform in (None, "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --platform cpu to run "
                               "on the CPU")
        return "cuda"
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"unknown platform {platform!r} (cuda or cpu)")


def parse_grid(s: str | None):
    """'PxxPyxPz' -> (Px, Py, Pz), e.g. '4x4x1' (miniapp -p/--p_grid format,
    examples/conflux_miniapp.cpp:42-67)."""
    if not s:
        return None
    parts = s.lower().split("x")
    if len(parts) != 3:
        raise ValueError(f"grid must be PxxPyxPz, got {s!r}")
    return tuple(int(p) for p in parts)


def grid_device(device: str):
    """make_grid's device for this rank: its own card (None: the
    default), or the CPU."""
    return None if device == "cuda" else device


def _rank_body(module: str, argv):
    """One rank of a started world: the miniapp's body with its standard
    output captured, returned to the starting process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        importlib.import_module(module).run(argv)
    return buf.getvalue()


def start(module: str, argv, platform, grid, force_devices) -> int:
    """Run `module`.run(argv) on every rank of a world of `force_devices`
    ranks (default: the grid's P, one without a grid): in this process
    when it is a rank of torchrun's world or the world has one rank; else
    on ranks started here (gloo), whose grid rank 0's output this process
    prints."""
    device = setup_platform(platform)
    shape = parse_grid(grid)
    world = force_devices or (math.prod(shape) if shape else 1)
    if "WORLD_SIZE" in os.environ or world == 1:
        importlib.import_module(module).run(argv)
        return 0
    from conflux_tpu_torch.launch import run_ranks

    outs = run_ranks(world, _rank_body, module, argv, backend="gloo",
                     device=device)
    print("".join(outs), end="")
    return 0

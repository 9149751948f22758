"""Offline SPD matrix generator / comparator: parity with
examples/cholesky_helper.cpp and `conflux_tpu/cli/cholesky_helper.py`
(the same files, byte for byte): `--generate N` writes data/input_N.bin
plus a reference factor result_N.bin; `--compare N` diffs
data/output_N.bin against the reference. Files are raw row-major float64
(io.py). Host code: numpy only."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cholesky_helper")
    ap.add_argument("--generate", type=int, metavar="N")
    ap.add_argument("--compare", type=int, metavar="N")
    ap.add_argument("--dir", default="data")
    ap.add_argument("--tol", type=float, default=1e-8)
    args = ap.parse_args(argv)

    from conflux_tpu_torch.io import dense_spd_matrix, load_matrix, \
        save_matrix

    if args.generate:
        n = args.generate
        A = dense_spd_matrix(n, seed=42, dtype=np.float64)
        save_matrix(os.path.join(args.dir, f"input_{n}.bin"), A)
        L = np.linalg.cholesky(A)
        save_matrix(os.path.join(args.dir, f"result_{n}.bin"), L)
        print(f"generated {args.dir}/input_{n}.bin and {args.dir}/result_{n}.bin")
        return 0

    if args.compare:
        n = args.compare
        ref = load_matrix(os.path.join(args.dir, f"result_{n}.bin"), n)
        out = load_matrix(os.path.join(args.dir, f"output_{n}.bin"), n)
        diff = np.abs(np.tril(out) - np.tril(ref)).max()
        print(f"max |output - reference| = {diff:.3e}")
        if diff > args.tol:
            print("MISMATCH")
            return 1
        print("OK")
        return 0

    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())

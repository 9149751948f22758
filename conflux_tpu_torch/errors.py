"""Typed exceptions with error codes.

Parity with the reference's `CholeskyException` error-code taxonomy
(src/conflux/cholesky/CholeskyTypes.h:58-105): setup-time misconfiguration
raises a coded exception; runtime device failures follow JAX's fail-fast
model (the reference is likewise MPI-fatal at runtime, SURVEY.md §5).
"""

from __future__ import annotations

import enum


class ErrorCode(enum.Enum):
    INVALID_GRID = "invalid processor grid"
    INVALID_TILE = "invalid tile size"
    INVALID_SHAPE = "invalid matrix shape"
    INVALID_TYPE = "invalid element dtype"
    DEVICE_SHORTAGE = "not enough devices for the grid"
    LAYOUT_MISMATCH = "descriptor / layout mismatch"
    IO_ERROR = "matrix file IO error"
    NOT_FACTORIZED = "operation requires a factorization"


class ConfluxError(ValueError):
    """Setup-time error with a machine-checkable code."""

    def __init__(self, code: ErrorCode, detail: str = ""):
        self.code = code
        super().__init__(f"[{code.name}] {code.value}" + (f": {detail}" if detail else ""))

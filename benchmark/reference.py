"""The plain reference: what decides a run's `correct`.

Plain PyTorch, importing nothing of the program. It judges a
factorization that the program returned by its backward error against
the input, which the harness makes again from the seed:

  * LU (F, perm), F the merged unit-lower L and upper U:
    resid_f = ||A[perm] - L U||_F / (N ||A||_F), the CONFLUX gate's
    quantity; resid_max = max |A[perm] - L U| / max |A|, which a few
    wrong entries or rows move; max_abs_l = max |L| below the diagonal,
    at most 1 under partial pivoting.
  * Cholesky L: resid_f = ||A - L L^T||_F / (N ||A||_F) and
    resid_max = max |A - L L^T| / max |A|, with L as returned (an upper
    triangle that is not zero counts against it).

Both are computed in float64, a block of rows at a time, so the
reference fits beside the inputs once the program's state is freed.

`lu_blocked` and `cholesky_blocked` are the plain factorizations that
stand in the program's place for the control: blocked right-looking,
each panel or tile by the library (`torch.linalg.lu_factor`,
`torch.linalg.cholesky`), every matrix product in IEEE fp32, or with
`tf32=True` on operands rounded to TF32 (10 mantissa bits, round to
nearest, ties away, as the tensor cores round them) with fp32
accumulation: the precision one step below the configurations' float32
with TF32 off, made the same on the card and the CPU.
"""

from __future__ import annotations

import contextlib

import torch

_KNOBS = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


@contextlib.contextmanager
def ieee():
    """fp32 matrix products in IEEE fp32 inside the block; the caller's
    settings are given back on the way out."""
    saved = [knob.fp32_precision for knob in _KNOBS]
    try:
        for knob in _KNOBS:
            knob.fp32_precision = "ieee"
        yield
    finally:
        for knob, value in zip(_KNOBS, saved):
            knob.fp32_precision = value


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32's 10 mantissa bits, to nearest, ties away
    from zero (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _sub_product(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 tf32: bool):
    """C -= A @ B in place, fp32 accumulation."""
    if tf32:
        A, B = tf32_round(A), tf32_round(B)
    C.addmm_(A, B, alpha=-1.0)


def _swaps_to_perm(piv: torch.Tensor, m: int) -> torch.Tensor:
    """LAPACK's 1-based row swaps of a panel as a permutation of its m
    rows."""
    p = list(range(m))
    for i, t in enumerate(piv.tolist()):
        t -= 1
        p[i], p[t] = p[t], p[i]
    return torch.tensor(p, dtype=torch.int64, device=piv.device)


def lu_blocked(A: torch.Tensor, b: int, tf32: bool = False):
    """Right-looking LU with partial pivoting of the fp32 square A in
    panels of b columns: (F, perm) with A[perm] = L U, F merged."""
    with ieee():
        W = A.clone()
        n = W.shape[0]
        perm = torch.arange(n, device=W.device)
        for k in range(0, n, b):
            w = min(b, n - k)
            LU, piv = torch.linalg.lu_factor(W[k:, k:k + w])
            p = _swaps_to_perm(piv, n - k)
            W[k:] = W[k:][p]
            perm[k:] = perm[k:][p]
            W[k:, k:k + w] = LU
            if k + w < n:
                L11 = torch.tril(LU[:w], -1) + torch.eye(
                    w, dtype=W.dtype, device=W.device)
                W[k:k + w, k + w:] = torch.linalg.solve_triangular(
                    L11, W[k:k + w, k + w:], upper=False,
                    unitriangular=True)
                _sub_product(W[k + w:, k + w:], W[k + w:, k:k + w],
                             W[k:k + w, k + w:], tf32)
        return W, perm


def cholesky_blocked(A: torch.Tensor, b: int, tf32: bool = False):
    """Right-looking lower Cholesky of the fp32 SPD A in tiles of b."""
    with ieee():
        W = A.clone()
        n = W.shape[0]
        for k in range(0, n, b):
            w = min(b, n - k)
            L11 = torch.linalg.cholesky(W[k:k + w, k:k + w])
            W[k:k + w, k:k + w] = L11
            if k + w < n:
                L21 = torch.linalg.solve_triangular(
                    L11, W[k + w:, k:k + w].T, upper=False).T
                W[k + w:, k:k + w] = L21
                _sub_product(W[k + w:, k + w:], L21, L21.T.contiguous(),
                             tf32)
        return W.tril_()


def lu_readings(A: torch.Tensor, F: torch.Tensor, perm: torch.Tensor,
                block: int = 2048) -> dict:
    """resid_f, resid_max and max_abs_l of the square LU (F, perm) of A."""
    n = F.shape[0]
    f64 = torch.float64
    U = F.to(f64).triu_()
    sq, dmax, lmax = 0.0, 0.0, 0.0
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        Lb = torch.tril(F[r0:r1, :r1], r0 - 1)
        lmax = max(lmax, float(Lb.abs().max()))
        Lb = Lb.to(f64)
        Lb[:, r0:r1].diagonal().fill_(1.0)
        D = A[perm[r0:r1]].to(f64) - Lb @ U[:r1]
        sq += float((D * D).sum())
        dmax = max(dmax, float(D.abs().max()))
        del Lb, D
    del U
    a2 = float(torch.linalg.norm(A.to(f64)))
    amax = float(A.abs().max())
    return {"resid_f": sq ** 0.5 / (n * a2), "resid_max": dmax / amax,
            "max_abs_l": lmax}


def cholesky_readings(A: torch.Tensor, L: torch.Tensor,
                      block: int = 2048) -> dict:
    """resid_f and resid_max of the Cholesky factor L of A, L taken as
    returned, upper triangle included; and L's distance from the float64
    factor of A, which is unique: off_err = max |L - L64| below the
    diagonal over max |L64| there, off_err_f the same in Frobenius norms,
    diag_err = max |diag(L - L64)| / max diag(L64)."""
    n = L.shape[0]
    f64 = torch.float64
    Lt = L.to(f64).T
    sq, dmax = 0.0, 0.0
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        D = A[r0:r1].to(f64) - Lt[:, r0:r1].T @ Lt
        sq += float((D * D).sum())
        dmax = max(dmax, float(D.abs().max()))
        del D
    del Lt
    A64 = A.to(f64)
    a2 = float(torch.linalg.norm(A64))
    amax = float(A.abs().max())
    L64 = torch.linalg.cholesky(A64)
    del A64
    off = {"max": 0.0, "sq": 0.0, "ref_max": 0.0, "ref_sq": 0.0}
    ddiff = 0.0
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        R = torch.tril(L64[r0:r1, :r1], r0 - 1)
        E = torch.tril(L[r0:r1, :r1].to(f64), r0 - 1) - R
        off["max"] = max(off["max"], float(E.abs().max()))
        off["sq"] += float((E * E).sum())
        off["ref_max"] = max(off["ref_max"], float(R.abs().max()))
        off["ref_sq"] += float((R * R).sum())
        ddiff = max(ddiff, float((L[r0:r1, r0:r1].diagonal().to(f64)
                                  - L64[r0:r1, r0:r1].diagonal()).abs()
                                 .max()))
        del R, E
    dref = float(L64.diagonal().max())
    del L64
    return {"resid_f": sq ** 0.5 / (n * a2), "resid_max": dmax / amax,
            "off_err": off["max"] / off["ref_max"],
            "off_err_f": (off["sq"] / off["ref_sq"]) ** 0.5,
            "diag_err": ddiff / dref}


JUDGES = {
    "lu": (lambda A, out: lu_readings(A, *out),
           lambda A, b, tf32: lu_blocked(A, b, tf32)),
    "cholesky": (cholesky_readings,
                 lambda A, b, tf32: cholesky_blocked(A, b, tf32)),
}


def readings(judge: str, A: torch.Tensor, out) -> dict:
    """The numbers compared for one output of the factorization `judge`
    names ('lu': out = (F, perm); 'cholesky': out = L)."""
    return JUDGES[judge][0](A, out)


def factor(judge: str, A: torch.Tensor, b: int, tf32: bool = False):
    """The plain factorization `judge` names, in IEEE fp32 or, with tf32,
    its products on TF32 operands: the output `readings` takes."""
    return JUDGES[judge][1](A, b, tf32)

"""conflux-tpu on PyTorch and CUDA: the port of `conflux_tpu` to an NVIDIA
H100.

The JAX package `conflux_tpu` stays the reference; this package has its
module layout and function names, and imports torch, numpy and the
standard library only. So far it holds the single-device LU with partial
pivoting in its crout (with the 'gather', 'split' and 'swap'
compactions), flat and recursive schemes (`lu.single`), the single-device
Cholesky (`cholesky.single`), the solves (`solve`), the panel
factorization (`ops.panel`), the matrix-product kernels (`ops.gemm`), the
row movement (`ops.scatter`), the triangular layer (`ops.tri`) and the
residual gates (`validation`). Each kernel the JAX package wrote in Pallas
is hand-written CUDA here, bound through ctypes: K1, the rank-1 panel
block (`ops.cuda_panel`); K3, the fused trailing update, K2, the big-K
R - A @ B, and K4, the plain GEMM (`ops.cuda_gemm`); K5 and K6, the row
scatter and gather (`ops.cuda_scatter`). CPU tensors take their plain
PyTorch versions.

The 2.5D distributed LU (`lu.p25d`: `lu_25d`, `plu`) and Cholesky
(`cholesky.p25d`: `cholesky_25d`, `pcholesky`) run one process per rank
of a torch.distributed world (`launch.run_ranks`, or torchrun): `grid`
places the rank in its (Px, Py, Pz) grid, `comm` gives it JAX's
named-axis collectives, `layout` (un)distributes the block-cyclic matrix
and moves it between descriptors (`retile`). `scalapack` has the
ScaLAPACK-style entry points `pdgetrf` / `pdpotrf`; `pgemm` the SUMMA product
(`pgemm.pgemm`) behind the distributed gates `validation.lu_residual_dist` /
`cholesky_residual_dist`; `profiler` the semiprof-style region timers of
the substep-profiled rank programs (`lu.profiled`, `cholesky.profiled`)
and the phase spans of the single-card step loops (`profiler.span`);
`spec` the serial numpy simulation and the comm models.

`lu.stepped.lu_factor_stepped` and `cholesky.stepped.cholesky_stepped`
factor in one copy of A on the card (the caller's tensor, consumed, or
one uploaded buffer), for matrices the in-memory paths cannot hold
twice; the factor stays there or streams to the host. The front ends are
`cli` (the LU and Cholesky miniapps with the `_result_` protocol, the
Cholesky helper and the ini-driven sweep), `bench` (the benchmarks.csv
harness and plots), `io` (the seeded generators and the raw f64 files)
and `native` (the C++/OpenMP host runtime, built with g++ at first
use).

Every factorization entry point takes the JAX package's dtypes: float32,
float64 (f64 throughout; K1 in double, `csrc/rank1_panel_f64.cu`) and
bfloat16 storage (a bf16 buffer and factor, with f32 panels, pivoting,
TRSMs and reductions and f32-accumulated products; K2's bf16-operand
entry). Complex64 and complex128 LU are `lu.csingle.clu_factor` and
`lu.cp25d.clu_25d` (ops/cplx.py: real products of the parts).
"""

__version__ = "0.1.0"

from conflux_tpu_torch.errors import ConfluxError, ErrorCode


def __getattr__(name):
    # the factorization API resolves lazily to keep `import` light. No
    # name here is also a submodule's ('pgemm'): importing the submodule
    # binds it as a package attribute, which would shadow this hook and
    # turn the name from the function into the module
    import importlib

    lazy = {
        "lu_factor": "conflux_tpu_torch.lu.single",
        "lu_residual": "conflux_tpu_torch.lu.single",
        "lu_factor_stepped": "conflux_tpu_torch.lu.stepped",
        "cholesky_stepped": "conflux_tpu_torch.cholesky.stepped",
        "clu_factor": "conflux_tpu_torch.lu.csingle",
        "clu_residual": "conflux_tpu_torch.lu.csingle",
        "clu_25d": "conflux_tpu_torch.lu.cp25d",
        "lu_residual_blocked": "conflux_tpu_torch.validation",
        "cholesky_residual_blocked": "conflux_tpu_torch.validation",
        "lu_solve": "conflux_tpu_torch.solve",
        "cho_solve": "conflux_tpu_torch.solve",
        "Grid": "conflux_tpu_torch.grid",
        "make_grid": "conflux_tpu_torch.grid",
        "choose_grid_lu": "conflux_tpu_torch.grid",
        "choose_grid_cholesky": "conflux_tpu_torch.grid",
        "BlockCyclic": "conflux_tpu_torch.layout",
        "distribute": "conflux_tpu_torch.layout",
        "undistribute": "conflux_tpu_torch.layout",
        "redistribute": "conflux_tpu_torch.layout",
        "retile": "conflux_tpu_torch.layout",
        "cholesky_residual": "conflux_tpu_torch.cholesky.single",
        "lu_25d": "conflux_tpu_torch.lu.p25d",
        "plu": "conflux_tpu_torch.lu.p25d",
        "cholesky_25d": "conflux_tpu_torch.cholesky.p25d",
        "pcholesky": "conflux_tpu_torch.cholesky.p25d",
        "run_ranks": "conflux_tpu_torch.launch",
        "pdgetrf": "conflux_tpu_torch.scalapack",
        "pdpotrf": "conflux_tpu_torch.scalapack",
        "plu_residual_25d": "conflux_tpu_torch.pgemm",
        "pchol_residual_25d": "conflux_tpu_torch.pgemm",
        "lu_residual_dist": "conflux_tpu_torch.validation",
        "cholesky_residual_dist": "conflux_tpu_torch.validation",
    }
    if name in lazy:
        return getattr(importlib.import_module(lazy[name]), name)
    raise AttributeError(name)


__all__ = ["Grid", "make_grid", "choose_grid_lu", "choose_grid_cholesky",
           "BlockCyclic", "distribute", "undistribute", "redistribute",
           "retile", "ConfluxError", "ErrorCode", "lu_factor",
           "lu_residual", "cholesky_residual",
           "lu_factor_stepped", "cholesky_stepped",
           "clu_factor", "clu_residual", "clu_25d",
           "lu_residual_blocked", "cholesky_residual_blocked",
           "lu_solve", "cho_solve", "lu_25d", "plu",
           "cholesky_25d", "pcholesky", "run_ranks", "pdgetrf", "pdpotrf",
           "plu_residual_25d", "pchol_residual_25d", "lu_residual_dist",
           "cholesky_residual_dist"]

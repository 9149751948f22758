"""Parity of the port's float64 and complex128 paths with the JAX
package's x64 mode, on the same numpy inputs.

JAX's `jax_enable_x64` is process-global, so the JAX side runs in one
subprocess, as tests/test_f64_mode.py runs it, on the 8-device virtual CPU
mesh: it reads the inputs from an .npz under tmp_path, runs every case and
writes its factors to another .npz, which the tests here hold the port
to. The port runs its single-device cases here and its distributed ones
in one gloo world of 8 CPU ranks (tests/torch_ranks.py).

Cases: `lu_factor` in every scheme and compaction, `cholesky` in both
schemes, `lu_25d` under every variant name on (2, 2, 2) and the fused
crout panel on (1, 2, 2), `cholesky_25d` under every variant name,
`pdgetrf` / `pdpotrf` at their default grid and tile over 8 ranks, and
complex128 `clu_factor` ('4m', '3m') and `clu_25d` on (2, 2, 2).

Held to: the pivots identical, the factors within 1e-12 of max|F|
(both run IEEE f64 in the same operation order up to the products'
summation order: ~1e-15 apart), and the reference's gate
||PA - LU||_F / (N ||A||_F) (or the Cholesky one) < 1e-14, the JAX
package's own f64 bound (tests/test_f64_mode.py); the port's distributed
SUMMA gate on every rank to the same bound.

The benchmark's float64 configuration (benchmark/configs/lu-f64.json):
`lu_factor` in float64, scheme 'auto' and 'crout', against the plain
reference `benchmark.reference.lu_blocked` in float64 on seeded 5 + U[0,1)
inputs, the precisions' effect on a float64 factor, and the count of f64
products `ops.gemm.sub_dot` forms.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_ranks
from conflux_tpu_torch import validation
from conflux_tpu_torch.cholesky.single import cholesky
from conflux_tpu_torch.launch import run_ranks
from conflux_tpu_torch.lu.csingle import clu_factor, clu_residual
from conflux_tpu_torch.lu.single import lu_factor
from conflux_tpu_torch.ops import gemm

F_TOL = 1e-12
GATE = 1e-14
N, V = 96, 16              # single device
ND, VD = 96, 8             # distributed
SCHEMES = (("crout", "gather"), ("crout", "split"), ("crout", "swap"),
           ("flat", "gather"), ("recursive", "gather"))
VARIANTS = ("fori", "unrolled", "lookahead", "windowed", "crout")
# (kind, grid shape, variant or method) of each distributed case
DIST = ([("lu", (2, 2, 2), var) for var in VARIANTS]
        + [("lu", (1, 2, 2), "crout")]
        + [("chol", (2, 2, 2), var) for var in VARIANTS]
        + [("pdgetrf", None, None), ("pdpotrf", None, None),
           ("clu", (2, 2, 2), "4m")])


def _inputs():
    rng = np.random.default_rng(64)
    A = rng.standard_normal((N, N))
    X = rng.standard_normal((N, N))
    S = X @ X.T + N * np.eye(N)
    Z = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    return {"A": A, "S": S, "Z": Z}


JAX_SIDE = textwrap.dedent(r"""
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from conflux_tpu.cholesky.p25d import cholesky_25d
    from conflux_tpu.cholesky.single import cholesky
    from conflux_tpu.grid import make_grid
    from conflux_tpu.layout import BlockCyclic, distribute, undistribute
    from conflux_tpu.lu.cp25d import clu_25d
    from conflux_tpu.lu.csingle import clu_factor
    from conflux_tpu.lu.p25d import lu_25d
    from conflux_tpu.lu.single import lu_factor
    from conflux_tpu.scalapack import pdgetrf, pdpotrf

    src, dst, N, V, ND, VD = sys.argv[1:7]
    N, V, ND, VD = int(N), int(V), int(ND), int(VD)
    inp = np.load(src)
    A, S, Z = inp["A"], inp["S"], inp["Z"]
    out = {}
    for scheme, comp in (("crout", "gather"), ("crout", "split"),
                         ("crout", "swap"), ("flat", "gather"),
                         ("recursive", "gather")):
        F, p = lu_factor(jnp.asarray(A), v=V, precision="high",
                         scheme=scheme, compaction=comp)
        assert F.dtype == jnp.float64
        out[f"lu/{scheme}/{comp}/F"] = np.asarray(F)
        out[f"lu/{scheme}/{comp}/p"] = np.asarray(p)
    for scheme in ("flat", "recursive"):
        out[f"chol/{scheme}"] = np.asarray(
            cholesky(jnp.asarray(S), v=V, precision="high", scheme=scheme))
    for method in ("4m", "3m"):
        F, p = clu_factor(jnp.asarray(Z), v=V, method=method)
        assert F.dtype == jnp.complex128
        out[f"clu/{method}/F"] = np.asarray(F)
        out[f"clu/{method}/p"] = np.asarray(p)
    grids = {s: make_grid(s) for s in ((2, 2, 2), (1, 2, 2))}
    for shape, var in [((2, 2, 2), v) for v in
                       ("fori", "unrolled", "lookahead", "windowed",
                        "crout")] + [((1, 2, 2), "crout")]:
        desc = BlockCyclic.create(ND, ND, VD, grids[shape])
        F, p = lu_25d(distribute(A, desc), desc, "tournament", "high", var)
        key = "x".join(map(str, shape))
        out[f"lu25d/{key}/{var}/F"] = np.asarray(undistribute(F, desc))
        out[f"lu25d/{key}/{var}/p"] = np.asarray(p)
    desc = BlockCyclic.create(ND, ND, VD, grids[(2, 2, 2)])
    for var in ("fori", "unrolled", "lookahead", "windowed", "crout"):
        L = cholesky_25d(distribute(S, desc), desc, "high", var)
        out[f"chol25d/{var}"] = np.asarray(undistribute(L, desc))
    F, p = clu_25d(distribute(Z, desc), desc, "4m")
    assert F.dtype == jnp.complex128
    out["clu25d/F"] = np.asarray(undistribute(F, desc))
    out["clu25d/p"] = np.asarray(p)
    f = pdgetrf(A)
    out["pdgetrf/F"], out["pdgetrf/p"] = f.dense(), np.asarray(f.perm)
    out["pdgetrf/v"] = np.asarray(f.desc.v)
    c = pdpotrf(S)
    out["pdpotrf/L"], out["pdpotrf/v"] = c.dense(), np.asarray(c.desc.v)
    np.savez(dst, **out)
    print("X64_OK")
""")


@pytest.fixture(scope="module")
def jax64(tmp_path_factory):
    """The JAX package's x64-mode results for every case, from one
    subprocess (jax_enable_x64 is process-global)."""
    tmp = tmp_path_factory.mktemp("x64")
    src, dst = tmp / "inputs.npz", tmp / "jax64.npz"
    np.savez(src, **_inputs())
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    env["JAX_PLATFORMS"] = "cpu"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(src), str(dst),
                        str(N), str(V), str(ND), str(VD)],
                       capture_output=True, text=True, env=env, timeout=900)
    assert "X64_OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(dst))


@pytest.fixture(scope="module")
def world():
    """The port's distributed cases in one gloo world of 8 CPU ranks."""
    inp = _inputs()
    cases = []
    for kind, shape, var in DIST:
        mat = {"chol": "S", "pdpotrf": "S", "clu": "Z"}.get(kind, "A")
        cases.append(dict(kind=kind, shape=shape, A=inp[mat],
                          dtype="complex128" if kind == "clu" else "float64",
                          v=VD, variant=var, method=var, precision="high"))
    return run_ranks(8, torch_ranks.dtype_cases, cases, device="cpu",
                     timeout=600)


def _padded(A, shape):
    """A in the top-left corner of `shape`, ones on the trailing diagonal:
    the identity-padded matrix a descriptor whose tiling does not divide
    A factorizes (layout.pad_like)."""
    if A.shape == shape:
        return A
    out = np.zeros(shape, A.dtype)
    n = A.shape[0]
    out[:n, :n] = A
    idx = np.arange(n, shape[0])
    out[idx, idx] = 1
    return out


def _close(Ft, Fj):
    return float(np.abs(Ft - Fj).max()) <= F_TOL * float(np.abs(Fj).max())


@pytest.mark.parametrize("scheme,compaction", SCHEMES)
def test_lu_factor_f64_matches_jax_x64(jax64, scheme, compaction):
    A = _inputs()["A"]
    F, p = lu_factor(torch.from_numpy(A), V, "high", scheme=scheme,
                     compaction=compaction)
    assert F.dtype == torch.float64
    key = f"lu/{scheme}/{compaction}"
    np.testing.assert_array_equal(p.numpy(), jax64[key + "/p"])
    assert _close(F.numpy(), jax64[key + "/F"])
    assert validation.lu_residual_dense(A, F, p) < GATE
    # the blocked gate runs in f64 on a float64 factor
    assert validation.lu_residual_blocked(torch.from_numpy(A), F, p,
                                          block=40) < GATE


@pytest.mark.parametrize("scheme", ["flat", "recursive"])
def test_cholesky_f64_matches_jax_x64(jax64, scheme):
    S = _inputs()["S"]
    L = cholesky(torch.from_numpy(S), V, "high", scheme=scheme)
    assert L.dtype == torch.float64
    assert _close(L.numpy(), jax64[f"chol/{scheme}"])
    assert validation.cholesky_residual_dense(S, L) < GATE
    assert validation.cholesky_residual_blocked(torch.from_numpy(S), L,
                                                block=40) < GATE


@pytest.mark.parametrize("method", ["4m", "3m"])
def test_clu_factor_c128_matches_jax_x64(jax64, method):
    Z = _inputs()["Z"]
    F, p = clu_factor(torch.from_numpy(Z), V, method)
    assert F.dtype == torch.complex128
    np.testing.assert_array_equal(p.numpy(), jax64[f"clu/{method}/p"])
    assert _close(F.numpy(), jax64[f"clu/{method}/F"])
    assert clu_residual(Z, F, p) < GATE


def _dist_id(i):
    kind, shape, var = DIST[i]
    grid = "default" if shape is None else "x".join(map(str, shape))
    return f"{kind}-{grid}-{var}"


@pytest.mark.parametrize("i", range(len(DIST)), ids=_dist_id)
def test_25d_f64_matches_jax_x64(jax64, world, i):
    kind, shape, var = DIST[i]
    inp = _inputs()
    got = world[0]["cases"][i]
    assert all(r["jax_free"] for r in world)
    P = 8 if shape is None else int(np.prod(shape))
    gates = {r["cases"][i]["gate"] for r in world[:P]}
    assert len(gates) == 1 and got["gate"] < GATE
    if kind in ("chol", "pdpotrf"):
        assert got["dtype"] == "torch.float64"
        Lj = (jax64[f"chol25d/{var}"] if kind == "chol"
              else jax64["pdpotrf/L"])
        if kind == "pdpotrf":
            assert got["v"] == int(jax64["pdpotrf/v"])
        assert _close(got["F"], Lj)
        S = _padded(inp["S"], got["F"].shape)
        assert validation.cholesky_residual_dense(S, got["F"]) < GATE
        return
    if kind == "clu":
        assert got["dtype"] == "torch.complex128"
        Fj, pj = jax64["clu25d/F"], jax64["clu25d/p"]
        np.testing.assert_array_equal(got["perm"], pj)
        assert _close(got["F"], Fj)
        assert clu_residual(inp["Z"], got["F"], got["perm"]) < GATE
        return
    assert got["dtype"] == "torch.float64"
    if kind == "pdgetrf":
        Fj, pj = jax64["pdgetrf/F"], jax64["pdgetrf/p"]
        assert got["v"] == int(jax64["pdgetrf/v"])
    else:
        key = f"lu25d/{'x'.join(map(str, shape))}/{var}"
        Fj, pj = jax64[key + "/F"], jax64[key + "/p"]
    np.testing.assert_array_equal(got["perm"], pj)
    assert _close(got["F"], Fj)
    A = _padded(inp["A"], got["F"].shape)
    assert validation.lu_residual_dense(A, got["F"], got["perm"]) < GATE


# -- the benchmark's float64 configuration, against its plain reference -----

# (n, v): crout takes two steps (the cell's v) and four
F64_SIZES = [(2048, 1536), (512, 128)]


def _uniform64(n, seed):
    """The cell's fill 5 + U[0, 1) in float64, seeded."""
    from benchmark import inputs

    g = torch.Generator().manual_seed(seed)
    return inputs.uniform(n, g, "cpu", 5.0, 6.0, dtype=torch.float64)


@pytest.mark.parametrize("n,v", F64_SIZES)
@pytest.mark.parametrize("scheme", ["auto", "crout"])
def test_lu_factor_f64_matches_the_plain_reference(scheme, n, v):
    from benchmark import reference, work

    A = _uniform64(n, 2 ** 31 + n)
    before = gemm.SUB_DOT_F64_PRODUCTS
    F, p = lu_factor(A, v=v, precision="highest", scheme=scheme)
    formed = gemm.SUB_DOT_F64_PRODUCTS - before
    Fr, pr = reference.lu_blocked(A, v)
    assert F.dtype == torch.float64
    assert torch.equal(p, pr)
    # both are backward stable LUs in f64, each within a few roundings
    # times the growth of A's exact factors; the factors' first-order
    # perturbation bound turns that into eps kappa_2(A) of max|F|, which
    # the two stay 100-1000x under (5e-13 - 2e-12 of max|F| on these
    # inputs, kappa_2 2e5 - 1e7)
    kappa = float(torch.linalg.cond(A))
    tol = torch.finfo(torch.float64).eps * kappa * float(Fr.abs().max())
    assert float((F - Fr).abs().max()) <= tol
    # crout forms one f64 product per big-K call of its step loop; 'auto'
    # runs recursive below 2048 rows, which forms none through sub_dot
    crout = scheme == "crout" or n >= 2048
    assert formed == (len(work.k2_calls("crout", n, v)) if crout else 0)


@pytest.mark.parametrize("n,v", F64_SIZES)
def test_f64_highest_and_high_give_one_factor(n, v):
    A = _uniform64(n, 7)
    F1, p1 = lu_factor(A, v=v, precision="highest", scheme="crout")
    F2, p2 = lu_factor(A, v=v, precision="high", scheme="crout")
    assert torch.equal(p1, p2) and torch.equal(F1, F2)


@pytest.mark.parametrize("n,v", F64_SIZES)
def test_f64_bf16_products_fail_the_cells_limit(n, v):
    """'bf16' rounds the f64 operands of the big products to bf16: its
    factor reads resid_f above the float64 cell's limit, the program's
    'highest' factor far below it."""
    from benchmark import spec

    cell = spec.load_cell("lu.f64.n32768")
    drv, limit = cell.driver, cell.limits["resid_f"]["limit"]
    A = _uniform64(n, 8)
    low = drv.readings(cell.config, A, lu_factor(
        A, v=v, precision="bf16", scheme="crout"))
    ieee = drv.readings(cell.config, A, lu_factor(
        A, v=v, precision="highest", scheme="crout"))
    assert low["resid_f"] > limit > 1e3 * ieee["resid_f"]
    assert ieee["max_abs_l"] <= 1.0


def test_sub_dot_counts_its_f64_products():
    g = torch.Generator().manual_seed(9)
    R, A, B = (torch.rand(s, generator=g, dtype=torch.float64)
               for s in ((6, 5), (6, 4), (4, 5)))
    before = gemm.SUB_DOT_F64_PRODUCTS
    for precision in ("highest", "high"):
        out = gemm.sub_dot(R, A, B, precision)
        assert out.dtype == torch.float64
        assert torch.allclose(out, R - A @ B, rtol=0, atol=1e-15)
    low = gemm.sub_dot(R, A, B, "bf16")
    assert gemm.SUB_DOT_F64_PRODUCTS == before + 3
    ref = R - (A.to(torch.bfloat16).double() @ B.to(torch.bfloat16).double())
    assert torch.allclose(low, ref, rtol=0, atol=1e-6)
    # a float32 R is not counted
    gemm.sub_dot(R.float(), A.float(), B.float(), "highest")
    assert gemm.SUB_DOT_F64_PRODUCTS == before + 3

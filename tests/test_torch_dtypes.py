"""Parity of the port's bf16 storage with the JAX package's, on the same
numpy inputs: single-device `lu_factor` (crout 'gather', 'split', 'swap',
flat, and a 'recursive' request, which runs crout) and `cholesky`, and the
2.5D `lu_25d` under every variant name on (2, 2, 2), (1, 2, 2) and
(2, 2, 1) and `cholesky_25d` under every variant name on the same grids.

A bf16 input is made in float32 numpy and rounded by each package
(`jnp.asarray(A, jnp.bfloat16)`, `torch.from_numpy(A).to(torch.bfloat16)`);
the two must give the same bits before anything else is compared.

What each case is held to:

  * on a diagonally dominant input (A = N(0, 1) + n I, whose pivot order
    no last-bit difference can change): the pivots identical and F within
    2 bf16 ulps of max|F| of JAX's F. Most cases are bit-equal; the
    arithmetic differs in the last f32 bits where the two packages' panel
    eliminations and product summations round differently (their f32
    panels already differ at ~1e-6, tests/test_torch_panel.py), and on
    flat, whose trailing update the JAX package's CPU path rounds twice
    (the product to bf16, then the sum) while the port rounds once, as the
    TPU kernel does (K3's 'bf16out');
  * on the JAX package's own test families (5 + U(0, 1) single-device,
    N(0, 1) distributed; near-ties, where a one-ulp difference may flip a
    pivot): the JAX package's gate for the path, ||PA - LU||_F / ||A||_F
    < 0.05 single-device (tests/test_single_device.py:271-290),
    ||PA - LU||_F / (N ||A||_F) < 6e-4 distributed (tests/test_lu_dist.py:
    404) and ||A - L L^T||_F / (N ||A||_F) < 2e-4 for Cholesky
    (tests/test_cholesky_dist.py:217, also the single-device bound here),
    the distributed SUMMA gate on every rank to the same bound, and the
    port's residual within 2x of JAX's on the same input.

The port's per-rank record of its collectives under bf16 storage must
equal the collectives of the JAX program's jaxpr, operation, axes, shape
and dtype, as a multiset: every slice moves in the dtype JAX moves it in.
(The comm model's crout term pivot_bcast_y over-counts under bf16 storage,
a known defect of the reference's spec.py:258, ADVICE.md:3; the records
are held to JAX's program, not to that model.)
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from conflux_tpu.cholesky.p25d import cholesky_25d as jcholesky_25d
from conflux_tpu.cholesky.single import cholesky as jcholesky
from conflux_tpu.grid import make_grid as jmake_grid
from conflux_tpu.layout import BlockCyclic as JBlockCyclic
from conflux_tpu.layout import distribute as jdistribute
from conflux_tpu.layout import undistribute as jundistribute
from conflux_tpu.lu.p25d import lu_25d as jlu_25d
from conflux_tpu.lu.single import lu_factor as jlu_factor
from conflux_tpu_torch import validation
from conflux_tpu_torch.cholesky.single import cholesky
from conflux_tpu_torch.launch import run_ranks
from conflux_tpu_torch.lu.single import lu_factor

BF16 = torch.bfloat16
ULPS = 2
LU_GATE_SINGLE = 0.05     # ||PA - LU||_F / ||A||_F
LU_GATE_DIST = 6e-4       # ||PA - LU||_F / (N ||A||_F)
CHOL_GATE = 2e-4          # ||A - L L^T||_F / (N ||A||_F)
RATIO = 2.0

N1, V1 = 128, 16          # single device
ND, VD = 64, 8            # distributed
GRIDS = ((2, 2, 2), (1, 2, 2), (2, 2, 1))
VARIANTS = ("fori", "unrolled", "lookahead", "windowed", "crout")
SCHEMES = (("crout", "gather"), ("crout", "split"), ("crout", "swap"),
           ("flat", "gather"), ("recursive", "gather"))


def _dd(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)


def _spd(n, seed):
    X = np.random.default_rng(seed).random((n, n))
    return ((X + X.T) / 2 + n * np.eye(n)).astype(np.float32)


def _bf16_pair(A):
    """(JAX bf16 array, torch bf16 tensor) of the float32 array A."""
    return jnp.asarray(A, jnp.bfloat16), torch.from_numpy(A).to(BF16)


def _jnp_f32(X):
    return np.asarray(jnp.asarray(X).astype(jnp.float32))


def _within_ulps(Ft, Fj):
    """|Ft - Fj| <= ULPS bf16 ulps of max|Fj| (8 significant bits)."""
    _, e = np.frexp(np.abs(Fj).max())
    return float(np.abs(Ft - Fj).max()) <= ULPS * np.ldexp(1.0, e - 8)


def _plain_residual(A, F, perm):
    """||PA - LU||_F / ||A||_F in float64 (the JAX single-device bf16
    gate's normalisation)."""
    return validation.lu_residual_dense(A, F, perm) * F.shape[1]


@pytest.mark.parametrize("family", ["dd", "jax"])
def test_bf16_inputs_are_bit_identical(family):
    A = _dd(N1, 1) if family == "dd" else (
        5.0 + np.random.default_rng(2).random((N1, N1))).astype(np.float32)
    Aj, At = _bf16_pair(A)
    assert np.array_equal(_jnp_f32(Aj), At.float().numpy())


@pytest.mark.parametrize("scheme,compaction", SCHEMES)
def test_lu_factor_bf16_matches_jax(scheme, compaction):
    Aj, At = _bf16_pair(_dd(N1, 3))
    assert np.array_equal(_jnp_f32(Aj), At.float().numpy())
    Fj, pj = jlu_factor(Aj, v=V1, scheme=scheme, compaction=compaction)
    Ft, pt = lu_factor(At, V1, scheme=scheme, compaction=compaction)
    assert Ft.dtype == BF16 and Fj.dtype == jnp.bfloat16
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert _within_ulps(Ft.float().numpy(), _jnp_f32(Fj))
    if scheme == "recursive":
        # bf16 storage runs crout for any other scheme, as in JAX
        Fc, pc = lu_factor(At, V1, scheme="crout")
        assert torch.equal(Ft, Fc) and torch.equal(pt, pc)


@pytest.mark.parametrize("scheme,compaction", SCHEMES[:4])
def test_lu_factor_bf16_meets_the_jax_gate(scheme, compaction):
    # the JAX package's bf16 test family: near-ties, so pivots may flip
    A = (5.0 + np.random.default_rng(4).random((N1, N1))).astype(np.float32)
    Aj, At = _bf16_pair(A)
    Fj, pj = jlu_factor(Aj, v=V1, scheme=scheme, compaction=compaction)
    Ft, pt = lu_factor(At, V1, scheme=scheme, compaction=compaction)
    Ab = At.float().numpy()
    rt = _plain_residual(Ab, Ft, pt)
    rj = _plain_residual(Ab, _jnp_f32(Fj), np.asarray(pj))
    np.testing.assert_array_equal(np.sort(pt.numpy()), np.arange(N1))
    assert rt < LU_GATE_SINGLE
    assert rj / RATIO <= rt <= rj * RATIO, (rt, rj)
    # the blocked gate keeps the factor bf16 (f32 accumulation)
    blocked = validation.lu_residual_blocked(At, Ft, pt, block=48)
    assert blocked == pytest.approx(rt / N1, rel=1e-2)


@pytest.mark.parametrize("scheme", ["flat", "recursive"])
def test_cholesky_bf16_matches_jax(scheme):
    S = _spd(N1, 5)
    Sj, St = _bf16_pair(S)
    assert np.array_equal(_jnp_f32(Sj), St.float().numpy())
    Lj = _jnp_f32(jcholesky(Sj, v=V1, scheme=scheme))
    Lt = cholesky(St, V1, scheme=scheme)
    assert Lt.dtype == BF16
    assert _within_ulps(Lt.float().numpy(), Lj)
    Sb = St.float().numpy()
    rt = validation.cholesky_residual_dense(Sb, Lt)
    assert rt < CHOL_GATE
    assert rt / RATIO <= validation.cholesky_residual_dense(Sb, Lj) \
        <= rt * RATIO
    blocked = validation.cholesky_residual_blocked(St, Lt, block=48)
    assert blocked == pytest.approx(rt, rel=1e-2)


def test_cholesky_bf16_panel_update_runs_through_k2(monkeypatch):
    """The bf16 Cholesky's panel updates go through ops/gemm's
    sub_matmul_bigk (K2's bf16-operand entry on the card), one a step with
    k > 0, each on bf16 operands with B the transposed view
    F[k:k+w, :k].T; on the CPU the factor equals the library expression
    it replaced, col - schur_dot(L21, L1t, 'bf16'), bit for bit."""
    import conflux_tpu_torch.cholesky.single as csingle
    from conflux_tpu_torch.ops.tri import schur_dot

    S = _spd(N1, 5)
    _, St = _bf16_pair(S)
    calls = []
    real = csingle.sub_matmul_bigk

    def counted(R, A, B, mode):
        calls.append((A.dtype, B.dtype, B.stride(0), mode))
        return real(R, A, B, mode)

    monkeypatch.setattr(csingle, "sub_matmul_bigk", counted)
    L = cholesky(St, V1)
    steps = -(-N1 // V1)
    assert calls == [(BF16, BF16, 1, "bf16")] * (steps - 1)

    def library(R, A, B, mode):
        return R - schur_dot(A, B, mode)

    monkeypatch.setattr(csingle, "sub_matmul_bigk", library)
    assert torch.equal(cholesky(St, V1), L)


# ------------------------------------------------------------ distributed

def _cases():
    """(kind, grid, variant, family) of every distributed case; the
    world's rank program gets the matrices from _input."""
    out = []
    for shape in GRIDS:
        for variant in VARIANTS:
            out += [("lu", shape, variant, "dd"),
                    ("lu", shape, variant, "jax"),
                    ("chol", shape, variant, "spd")]
    return out


CASES = _cases()


def _input(family):
    if family == "dd":
        return _dd(ND, 6)
    if family == "spd":
        return _spd(ND, 7)
    return np.random.default_rng(8).standard_normal((ND, ND)).astype(
        np.float32)


# retile of a bf16 matrix from (2, 2, 1) to (2, 2, 2) (ranks 4-7 idle in
# the source) and back, at another tile: the data moves as bf16
RETILE = [((2, 2, 1), VD, (2, 2, 2), 2 * VD), ((2, 2, 2), VD, (2, 2, 1), VD)]


@pytest.fixture(scope="module")
def world():
    """Every distributed case, in one gloo world of 8 CPU ranks, each case
    on its grid of that world; then the RETILE moves."""
    cases = [dict(kind=kind, shape=shape, A=_input(family), dtype="bfloat16",
                  v=VD, variant=variant, precision="high")
             for kind, shape, variant, family in CASES]
    cases += [dict(kind="retile", shape=s1, v=v1, shape2=s2, v2=v2,
                   A=_input("jax"), dtype="bfloat16")
              for s1, v1, s2, v2 in RETILE]
    return run_ranks(8, torch_ranks.dtype_cases, cases, device="cpu",
                     timeout=600)


@pytest.mark.parametrize("j", range(len(RETILE)))
def test_retile_bf16_from_idle_ranks(world, j):
    _, _, s2, _ = RETILE[j]
    got = [r["cases"][len(CASES) + j] for r in world]
    P2 = int(np.prod(s2))
    assert all(g["equal"] and g["dtype"] == "torch.bfloat16"
               for g in got[:P2])
    assert all(g["equal"] is None for g in got[P2:])


def _jax_dist(kind, shape, variant, A):
    desc = JBlockCyclic.create(ND, ND, VD, jmake_grid(shape))
    G = jdistribute(jnp.asarray(A, jnp.bfloat16), desc)
    if kind == "lu":
        F, perm = jlu_25d(G, desc, "tournament", "high", variant)
        return _jnp_f32(jundistribute(F, desc)), np.asarray(perm), F.dtype
    L = jcholesky_25d(G, desc, "high", variant)
    return _jnp_f32(jundistribute(L, desc)), None, L.dtype


def _id(i):
    kind, shape, variant, family = CASES[i]
    return f"{kind}-{'x'.join(map(str, shape))}-{variant}-{family}"


@pytest.mark.parametrize("i", range(len(CASES)), ids=_id)
def test_25d_bf16_matches_jax(world, i):
    kind, shape, variant, family = CASES[i]
    A = _input(family)
    Aj, At = _bf16_pair(A)
    assert np.array_equal(_jnp_f32(Aj), At.float().numpy())
    assert all(r["jax_free"] for r in world)
    got = world[0]["cases"][i]
    P = int(np.prod(shape))
    # the grid's ranks return the same gate; the others are idle
    gates = {r["cases"][i]["gate"] for r in world[:P]}
    assert len(gates) == 1 and all(r["cases"][i]["gate"] is None
                                   for r in world[P:])
    assert got["dtype"] == "torch.bfloat16"
    Fj, pj, jdtype = _jax_dist(kind, shape, variant, A)
    assert jdtype == jnp.bfloat16
    Ft, Ab = got["F"], At.float().numpy()
    if kind == "chol":
        assert _within_ulps(Ft, Fj)
        rt = validation.cholesky_residual_dense(Ab, Ft)
        assert rt < CHOL_GATE and got["gate"] < CHOL_GATE
        return
    pt = got["perm"]
    for r in world[:P]:
        np.testing.assert_array_equal(r["cases"][i]["perm"], pt)
    if family == "dd":
        np.testing.assert_array_equal(pt, pj)
        assert _within_ulps(Ft, Fj)
        return
    rt = validation.lu_residual_dense(Ab, Ft, pt)
    rj = validation.lu_residual_dense(Ab, Fj, pj)
    np.testing.assert_array_equal(np.sort(pt), np.arange(ND))
    assert rt < LU_GATE_DIST and got["gate"] < LU_GATE_DIST
    assert rj / RATIO <= rt <= rj * RATIO, (rt, rj)


_PRIMS = {"psum": "psum", "psum_invariant": "psum",
          "all_gather": "all_gather", "ppermute": "ppermute",
          "reduce_scatter": "psum_scatter"}


def _kind(dtype: str) -> str:
    """A record's dtype class: index and mask collectives move int32 in
    JAX and int64 or bool in the port; float dtypes must match."""
    return "int" if "int" in dtype or dtype == "bool" else dtype


def _jax_collectives(kind, shape, variant, A) -> Counter:
    """(op, axes, shape, dtype) of every collective in the JAX program's
    jaxpr, one per operand, as a multiset."""
    desc = JBlockCyclic.create(ND, ND, VD, jmake_grid(shape))
    G = jdistribute(jnp.asarray(A, jnp.bfloat16), desc)
    if kind == "lu":
        def fn(G):
            return jlu_25d(G, desc, "tournament", "high", variant)
    else:
        def fn(G):
            return jcholesky_25d(G, desc, "high", variant)
    out = Counter()

    def walk(jx):
        for eqn in jx.eqns:
            name = eqn.primitive.name
            if name in _PRIMS:
                ax = eqn.params.get("axes", eqn.params.get("axis_name"))
                ax = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
                ax = tuple(a for a in "xyz" if a in ax)
                for x in eqn.invars:
                    out[(_PRIMS[name], ax, tuple(x.aval.shape),
                         _kind(str(x.aval.dtype)))] += 1
            for p in eqn.params.values():
                if hasattr(p, "jaxpr"):
                    walk(p.jaxpr)
                elif hasattr(p, "eqns"):
                    walk(p)

    walk(jax.make_jaxpr(fn)(G).jaxpr)
    return out


# the JAX 'fori' programs trace their step once (a fori_loop), so their
# jaxpr holds one step's collectives at full width; the others unroll
@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES)
                               if c[3] != "jax" and c[2] != "fori"], ids=_id)
def test_25d_bf16_collectives_match_jax(world, i):
    kind, shape, variant, family = CASES[i]
    port = Counter((r.op, tuple(r.axes), tuple(r.shape), _kind(r.dtype))
                   for r in world[0]["cases"][i]["records"])
    assert port == _jax_collectives(kind, shape, variant, _input(family))
    # the LU crout's U slab moves as bf16, as in JAX (its Cholesky twin
    # upcasts before the psum, as JAX does)
    if kind == "lu" and variant == "crout":
        assert any(k[3] == "bfloat16" for k in port)

"""Parity of the PyTorch port's whole-row movement (conflux_tpu_torch/ops/
scatter.py: the plain versions of K5 `scatter_rows` and K6 `gather_rows`)
with the JAX reference's Pallas kernels in conflux_tpu/ops/pallas_scatter.py
run in interpret mode, as tests/test_pallas_scatter.py runs them. Rows move
whole and unchanged, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import conflux_tpu.ops.pallas_scatter as ps
from conflux_tpu_torch.ops import cuda_scatter
from conflux_tpu_torch.ops import scatter as tscatter


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def icall(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ps.pl, "pallas_call", icall)


# tests/test_pallas_scatter.py's shapes (m, n, w, group)
@pytest.mark.parametrize("m,n,w,group", [(64, 256, 16, 8), (128, 128, 32, 8),
                                         (96, 384, 24, 8)])
def test_scatter_rows_matches_pallas(interpret, rng, m, n, w, group):
    R = rng.standard_normal((m, n)).astype(np.float32)
    src = rng.standard_normal((w, n)).astype(np.float32)
    slots = rng.choice(m, w, replace=False)
    ref = ps.scatter_rows(jnp.asarray(R), jnp.asarray(src),
                          jnp.asarray(slots.astype(np.int32)), group=group)
    Rt = torch.from_numpy(R.copy())
    out = tscatter.scatter_rows(Rt, torch.from_numpy(src),
                                torch.from_numpy(slots))
    assert out is Rt                                    # in place
    np.testing.assert_array_equal(Rt.numpy(), np.asarray(ref))


def test_scatter_rows_self_writes_are_noops(interpret, rng):
    # the push-up encoding of padded pairs: src[i] == R[slots[i]]
    m, n, w = 64, 256, 16
    R = rng.standard_normal((m, n)).astype(np.float32)
    slots = np.arange(w) * 3
    ref = ps.scatter_rows(jnp.asarray(R), jnp.asarray(R[slots]),
                          jnp.asarray(slots.astype(np.int32)), group=8)
    Rt = torch.from_numpy(R.copy())
    tscatter.scatter_rows(Rt, Rt[torch.from_numpy(slots)],
                          torch.from_numpy(slots))
    np.testing.assert_array_equal(Rt.numpy(), R)
    np.testing.assert_array_equal(np.asarray(ref), R)


def test_scatter_rows_bf16_matches_pallas(interpret, rng):
    m, n, w = 64, 256, 16
    R = jnp.asarray(rng.standard_normal((m, n))).astype(jnp.bfloat16)
    src = jnp.asarray(rng.standard_normal((w, n))).astype(jnp.bfloat16)
    slots = rng.choice(m, w, replace=False)
    ref = ps.scatter_rows(R, src, jnp.asarray(slots.astype(np.int32)),
                          group=8)
    Rt = torch.from_numpy(np.array(R.astype(jnp.float32))).bfloat16()
    st = torch.from_numpy(np.array(src.astype(jnp.float32))).bfloat16()
    tscatter.scatter_rows(Rt, st, torch.from_numpy(slots))
    np.testing.assert_array_equal(Rt.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_matches_pallas(interpret, rng, dtype):
    m, n, w = 128, 256, 32
    R = jnp.asarray(rng.standard_normal((m, n))).astype(dtype)
    idx = rng.choice(m, w, replace=False)
    ref = ps.gather_rows(R, jnp.asarray(idx.astype(np.int32)), group=8)
    Rt = torch.from_numpy(np.array(R.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = tscatter.gather_rows(Rt, torch.from_numpy(idx))
    assert got.dtype == Rt.dtype and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_gather_rows_from_a_column_slice(rng):
    # the split compaction gathers from T[:, k:k+w], a strided view, and
    # the width need not be a multiple of anything
    T = torch.from_numpy(rng.standard_normal((50, 70)).astype(np.float32))
    idx = torch.from_numpy(rng.choice(50, 20, replace=False))
    got = tscatter.gather_rows(T[:, 13:46], idx)
    assert got.is_contiguous()
    assert torch.equal(got, torch.from_numpy(T.numpy()[idx.numpy(), 13:46]))


def test_row_moves_reject_what_the_kernels_do_not_take():
    R = torch.zeros(8, 4)
    idx = torch.arange(3)
    with pytest.raises(TypeError, match="int64"):
        tscatter.gather_rows(R, idx.int())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tscatter.gather_rows(R.double(), idx)
    with pytest.raises(ValueError, match="does not fit"):
        tscatter.scatter_rows(R, torch.zeros(3, 5), idx)
    # the kernels' wrappers refuse CPU tensors and launch nothing
    before = (cuda_scatter.SCATTER_ROWS_LAUNCHES,
              cuda_scatter.GATHER_ROWS_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_scatter.gather_rows(R, idx)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_scatter.scatter_rows(R, torch.zeros(3, 4), idx)
    assert (cuda_scatter.SCATTER_ROWS_LAUNCHES,
            cuda_scatter.GATHER_ROWS_LAUNCHES) == before

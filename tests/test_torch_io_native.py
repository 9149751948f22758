"""Parity of the port's generators and files (conflux_tpu_torch/io.py) and
native host runtime (conflux_tpu_torch/native) with the JAX package's
(conflux_tpu/io.py, conflux_tpu/native): the same seeds give the same
matrices bit for bit, below and above the 2^22-entry switch to the
native fill; the C++ entry points give the JAX native's results exactly;
files round-trip; and processes that build the library at once each
load a complete one.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import conflux_tpu.io as jio
from conflux_tpu import native as jnative
from conflux_tpu_torch import io as tio
from conflux_tpu_torch import native as tnative
from conflux_tpu_torch.errors import ConfluxError, ErrorCode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def libs():
    if not (tnative.available() and jnative.available()):
        pytest.skip("native toolchain unavailable")
    return True


# below the switch (numpy's PCG64) and at or above it (the native fill)
@pytest.mark.parametrize("m,n", [(16, 16), (300, 200), (2048, 2048),
                                 (4099, 1031)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_random_matrix_is_the_jax_packages(m, n, dtype):
    A = tio.random_matrix(m, n, seed=42, dtype=dtype)
    assert A.dtype == dtype and A.shape == (m, n)
    np.testing.assert_array_equal(A, jio.random_matrix(m, n, seed=42,
                                                       dtype=dtype))


@pytest.mark.parametrize("n,v,dtype", [(64, 16, np.float32),
                                       (100, 16, np.float32),
                                       (257, 32, np.float32),
                                       (300, 128, np.float64),
                                       (2048, 256, np.float32),
                                       (5, 8, np.float32)])
def test_spd_matrix_is_the_jax_packages(n, v, dtype):
    S = tio.spd_matrix(n, v=v, seed=3, dtype=dtype)
    assert S.flags.c_contiguous
    np.testing.assert_array_equal(S, jio.spd_matrix(n, v=v, seed=3,
                                                    dtype=dtype))


def test_other_generators_are_the_jax_packages():
    np.testing.assert_array_equal(tio.dense_spd_matrix(48, seed=5),
                                  jio.dense_spd_matrix(48, seed=5))
    np.testing.assert_array_equal(tio.debug_matrix(16), jio.debug_matrix(16))


def test_fill_random_is_the_jax_natives(libs):
    for dtype in (np.float32, np.float64):
        np.testing.assert_array_equal(
            tnative.fill_random(64, 32, seed=7, dtype=dtype),
            jnative.fill_random(64, 32, seed=7, dtype=dtype))
    A = tnative.fill_random(32, 32, seed=3, dtype=np.float16)
    assert A.dtype == np.float16 and (np.asarray(A, np.float32) >= 5).all()


def test_host_kernels_are_the_jax_natives(libs, rng):
    A = rng.standard_normal((40, 12)).astype(np.float32)
    perm = rng.permutation(40)
    for inverse in (False, True):
        np.testing.assert_array_equal(
            tnative.permute_rows(A, perm, inverse=inverse),
            jnative.permute_rows(A, perm, inverse=inverse))
    B = rng.standard_normal((32, 48)).astype(np.float32)
    np.testing.assert_array_equal(tnative.cyclic_permute(B, 4, 2, 3),
                                  jnative.cyclic_permute(B, 4, 2, 3))
    with pytest.raises(ValueError):
        tnative.cyclic_permute(B[:12, :12], 4, 2, 3)
    C = rng.standard_normal((20, 16)).astype(np.float32)
    np.testing.assert_array_equal(tnative.mcopy(C, 5, 6, 3, 4),
                                  jnative.mcopy(C, 5, 6, 3, 4))
    # the port checks the bounds the C copy would read past
    with pytest.raises(ValueError):
        tnative.mcopy(C, 5, 6, 18, 4)
    for n in (1, 7, 300):
        p = rng.permutation(n)
        np.testing.assert_array_equal(tnative.perm_to_ipiv(p),
                                      jnative.perm_to_ipiv(p))


def test_numpy_fallbacks_match_the_library(libs, rng, monkeypatch):
    A = rng.standard_normal((24, 8)).astype(np.float32)
    perm = rng.permutation(24)
    B = rng.standard_normal((32, 48)).astype(np.float32)
    want = (tnative.permute_rows(A, perm),
            tnative.permute_rows(A, perm, inverse=True),
            tnative.cyclic_permute(B, 4, 2, 3), tnative.mcopy(A, 5, 3, 2, 1),
            tnative.perm_to_ipiv(perm))
    monkeypatch.setattr(tnative, "_load", lambda: None)
    got = (tnative.permute_rows(A, perm),
           tnative.permute_rows(A, perm, inverse=True),
           tnative.cyclic_permute(B, 4, 2, 3), tnative.mcopy(A, 5, 3, 2, 1),
           tnative.perm_to_ipiv(perm))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (tnative.fill_random(8, 8, seed=1) >= 5).all()
    assert not tnative.NativeProfiler().active


def test_native_profiler(libs):
    prof = tnative.NativeProfiler()
    prof.clear()
    prof.enter("outer")
    prof.enter("inner")
    prof.leave()
    prof.leave()
    rep = prof.report()
    assert "/outer" in rep and "/outer/inner" in rep
    prof.clear()


def test_ipiv_of_a_factorization_uses_the_native_walk(libs, rng):
    from conflux_tpu_torch.scalapack import Factorization

    perm = torch.from_numpy(rng.permutation(50))
    f = Factorization(None, None, perm)
    np.testing.assert_array_equal(f.ipiv(),
                                  jnative.perm_to_ipiv(perm.numpy()))


def test_save_load_round_trip(tmp_path, rng):
    A = rng.standard_normal((12, 10)).astype(np.float32)
    p = str(tmp_path / "sub" / "m.bin")
    tio.save_matrix(p, torch.from_numpy(A))
    # the JAX package reads the port's file, and the other way round
    np.testing.assert_array_equal(jio.load_matrix(p, 10, 12), A)
    q = str(tmp_path / "j.bin")
    jio.save_matrix(q, A)
    np.testing.assert_array_equal(tio.load_matrix(q, 10, 12), A)
    with open(p, "rb") as f, open(q, "rb") as g:
        assert f.read() == g.read()
    with pytest.raises(ConfluxError) as e:
        tio.load_matrix(p, 20)
    assert e.value.code == ErrorCode.IO_ERROR


def test_save_dist_load_dist_round_trip(tmp_path, rng):
    from conflux_tpu_torch.grid import make_grid
    from conflux_tpu_torch.layout import BlockCyclic, distribute

    A = rng.standard_normal((64, 64))
    desc = BlockCyclic.create(64, 64, 16, make_grid((1, 1, 1), device="cpu"))
    G = distribute(A, desc)
    p = str(tmp_path / "d.bin")
    tio.save_dist(p, G, desc)
    np.testing.assert_array_equal(tio.load_matrix(p, 64), A)
    G2 = tio.load_dist(p, desc, dtype=np.float64)
    assert torch.equal(G, G2)
    assert tio.load_dist(p, desc).dtype == torch.float32


_BUILD_ONE = """
import sys
from pathlib import Path
from conflux_tpu_torch import native
native._BUILD = Path(sys.argv[1])
assert native.available()
print(int(native.fill_random(64, 64, seed=9).sum() * 1000))
"""


def test_processes_building_at_once_both_load_it(tmp_path):
    # two processes build into one empty directory at the same moment:
    # each writes its own temporary file and renames it into place, so
    # each loads a complete library
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=REPO)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    libs = [f.name for f in tmp_path.iterdir()]
    assert len(libs) == 1 and libs[0].startswith("libconflux_host-"), libs

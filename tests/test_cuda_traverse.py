"""The CUDA traversal kernel (accel/cuda_traverse.py).

The kernel has no interpret mode. The CPU tests cover what surrounds it:
its stack bound, where its library is built, the error without `nvcc`,
and the shapes of the FFI call. The `gpu` test compares it with the
plain-XLA traversal on a card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from henjou.accel import cuda_traverse, traverse
from henjou.accel.lbvh import build_lbvh, lbvh_depth
from henjou.math.constants import TMAX_RAY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(n, seed=0, spread=4.0, size=0.3):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n, 1, 3))
    return jnp.asarray((c + rng.normal(scale=size, size=(n, 3, 3))).astype(np.float32))


def _rays(n, seed=1, spread=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_stack_bound_matches_the_kernel_source():
    with open(cuda_traverse.SOURCE) as f:
        m = re.search(r"constexpr int kStackSize = (\d+);", f.read())
    assert m and int(m.group(1)) == cuda_traverse.STACK_SIZE


@pytest.mark.parametrize("n", [1, 2, 700])
def test_lbvh_depth_within_both_stacks(n):
    # coincident centroids force the index tie-break down the whole tree
    tris = _scene(n, size=0.3) if n > 2 else _scene(n, spread=0.0)
    depth = lbvh_depth(build_lbvh(tris))
    assert depth <= max(n - 1, 0)
    assert depth < min(traverse.STACK_SIZE, cuda_traverse.STACK_SIZE)


def test_library_is_built_into_the_ignored_build_dir():
    path = cuda_traverse.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "cuda")
    assert re.fullmatch(r"libbvh_traverse-[0-9a-f]{12}\.so", os.path.basename(path))
    assert "sm_90a" in " ".join(cuda_traverse.NVCC_FLAGS)


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(cuda_traverse.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda_traverse.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_traverse.build_library()


@pytest.mark.parametrize("any_hit", [False, True])
def test_ffi_call_shapes(monkeypatch, any_hit):
    """The wrapper's FFI call: scalar tmin/tmax broadcast per ray, four
    outputs plus the derived hit mask, any_hit passed as an attribute."""
    monkeypatch.setattr(cuda_traverse, "register", lambda: cuda_traverse.FFI_TARGET)
    bvh = build_lbvh(_scene(40))
    o, d = _rays(96)

    def f(o, d):
        return cuda_traverse.traverse_cuda(bvh, o, d, 1e-3, any_hit=any_hit)

    out = jax.eval_shape(f, o, d)
    assert [(x.shape, x.dtype) for x in out] == [
        ((96,), jnp.float32), ((96,), jnp.int32), ((96,), jnp.float32),
        ((96,), jnp.float32), ((96,), jnp.bool_),
    ]
    (call,) = [e for e in jax.make_jaxpr(f)(o, d).jaxpr.eqns
               if e.primitive.name == "ffi_call"]
    assert call.params["target_name"] == cuda_traverse.FFI_TARGET
    assert dict(call.params["attributes"]) == {"any_hit": int(any_hit)}
    assert [v.aval.shape for v in call.invars[-4:]] == [(96, 3), (96, 3), (96,), (96,)]


@pytest.mark.gpu
@pytest.mark.parametrize("n_tris", [1, 300, 5000])
def test_cuda_matches_traverse_py(n_tris):
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")
    tris = _scene(n_tris, seed=n_tris)
    bvh = jax.jit(build_lbvh)(tris)
    o, d = _rays(4096, seed=7)
    ref = [np.asarray(x) for x in traverse.traverse_closest(bvh, o, d, 1e-3)]
    got = [np.asarray(x) for x in jax.jit(
        lambda b, o, d: cuda_traverse.traverse_cuda(b, o, d, 1e-3))(bvh, o, d)]
    h = ref[4]
    assert (got[4] == h).all()
    np.testing.assert_allclose(got[0][h], ref[0][h], rtol=1e-5)
    same = got[1][h] == ref[1][h]
    assert (same | (np.abs(got[0][h] - ref[0][h]) <= 1e-5 * ref[0][h])).all()
    np.testing.assert_allclose(got[2][h][same], ref[2][h][same], atol=1e-4)
    np.testing.assert_allclose(got[3][h][same], ref[3][h][same], atol=1e-4)
    assert (got[1][~h] == -1).all() and np.isinf(got[0][~h]).all()
    tmax = jnp.asarray(np.where(h, ref[0] * 0.5, TMAX_RAY).astype(np.float32))
    occ_ref = np.asarray(traverse.traverse_closest(bvh, o, d, 1e-3, tmax, any_hit=True)[4])
    occ = np.asarray(cuda_traverse.traverse_cuda(bvh, o, d, 1e-3, tmax, any_hit=True)[4])
    assert (occ == occ_ref).all()

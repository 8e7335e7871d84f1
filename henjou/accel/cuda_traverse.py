"""LBVH traversal as a CUDA kernel (accel/cuda/bvh_traverse.cu), called
through `jax.ffi`: the GPU route's intersector.

The kernel gives each ray its own thread and its own stack, so the stack
stays in registers and local memory and every ray retires on its own.
The plain-XLA `accel/traverse.py` keeps the same contract and arithmetic;
it is the CPU route and the reference the kernel is checked against.

The shared library is built from the source with `nvcc` for `sm_90a` at
first use, into `build/cuda/` at the repository root (git-ignored). Its
name carries a hash of the source and flags, so an edited kernel is
rebuilt. There
is no fallback: if the library cannot be built or loaded, tracing a ray
on the GPU raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from henjou.accel.lbvh import LBVH
from henjou.math.constants import TMAX_RAY

FFI_TARGET = "henjou_bvh_traverse"
# kStackSize of the kernel: no LBVH path is deeper (see the .cu)
STACK_SIZE = 64
_SYMBOL = "HenjouBvhTraverse"
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda", "bvh_traverse.cu")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "cuda")
# --fmad=false: no multiply-add contraction, so the kernel rounds like
# XLA's traverse.py (barycentrics agree to ~1e-7 instead of ~1e-3 on
# grazing hits)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the CUDA traversal kernel")


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libbvh_traverse-{digest}.so")


def build_library() -> str:
    """Compile the kernel if its library is missing; return its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", jax.ffi.include_dir(), SOURCE]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        tmp = os.path.join(td, os.path.basename(out))
        proc = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {SOURCE} (rc {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    return out


@functools.cache
def register() -> str:
    """Build, load and register the FFI target once per process."""
    lib = ctypes.cdll.LoadLibrary(build_library())
    jax.ffi.register_ffi_target(
        FFI_TARGET, jax.ffi.pycapsule(getattr(lib, _SYMBOL)), platform="CUDA"
    )
    return FFI_TARGET


def traverse_cuda(bvh: LBVH, ray_o, ray_d, tmin, tmax=TMAX_RAY, any_hit=False):
    """Same contract as `traverse.traverse_closest`: (t[R] (inf on a
    miss), prim[R] (ORIGINAL triangle ids, -1 on a miss), u[R], v[R],
    is_hit[R])."""
    target = register()
    r = ray_o.shape[0]
    f32 = jax.ShapeDtypeStruct((r,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((r,), jnp.int32)
    t, prim, u, v = jax.ffi.ffi_call(
        target, (f32, i32, f32, f32), vmap_method="sequential"
    )(
        bvh.left, bvh.right, bvh.aabb_min, bvh.aabb_max, bvh.tri_order,
        bvh.tri_verts,
        jnp.asarray(ray_o, jnp.float32), jnp.asarray(ray_d, jnp.float32),
        jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,)),
        jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,)),
        any_hit=np.int32(bool(any_hit)),
    )
    return t, prim, u, v, prim >= 0


def make_cuda_intersector(bvh: LBVH):
    """(intersect_fn, occluded_fn) with the accel.bruteforce contract."""

    def intersect_fn(tri_verts, ray_o, ray_d, tmin, tmax=TMAX_RAY):
        # tri_verts ignored: geometry lives (sorted) inside the BVH
        return traverse_cuda(bvh, ray_o, ray_d, tmin, tmax)

    def occluded_fn(tri_verts, ray_o, ray_d, tmin, tmax):
        return traverse_cuda(bvh, ray_o, ray_d, tmin, tmax, any_hit=True)[4]

    return intersect_fn, occluded_fn

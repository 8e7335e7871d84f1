// Per-thread stack traversal of the LBVH built by accel/lbvh.py: the
// software stand-in for the reference's RT-core optixTrace (rt.h:15-69)
// on a card without RT cores, called from JAX through the XLA FFI.
//
// Contract and arithmetic follow accel/traverse.py, which is the plain
// reference and the CPU route: same node layout (internal nodes
// [0, T-2], leaf T-1+i holds sorted triangle i), same slab test with the
// same reciprocal direction, same Moller-Trumbore test, near child first.
// Each thread walks one ray with its own stack and retires on its own;
// the any-hit mode stops at the first confirmed intersection.
//
// Outputs per ray: t (inf on a miss), prim (ORIGINAL triangle id, -1 on
// a miss), u, v.

#include <cmath>
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// Stack bound. Along any root-to-leaf path of a Karras LBVH the common-
// prefix length of the node's key range strictly grows; keys are 30-bit
// Morton codes in 32-bit words with a 32-bit index tie-break, so a path
// has at most 62 internal nodes. Near-first traversal defers at most one
// sibling per level, so 64 entries never overflow.
constexpr int kStackSize = 64;
constexpr float kDetEps = 1e-12f;
constexpr int kBlock = 128;

struct Bvh {
  const int32_t* left;    // [T-1]
  const int32_t* right;   // [T-1]
  const float* aabb_min;  // [2T-1, 3]
  const float* aabb_max;  // [2T-1, 3]
  const int32_t* order;   // [T] leaf -> original triangle id
  const float* verts;     // [T, 3, 3] in leaf order
  int num_tris;
};

__device__ __forceinline__ float3 load3(const float* p) {
  return make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

__device__ __forceinline__ float3 sub3(float3 a, float3 b) {
  return make_float3(a.x - b.x, a.y - b.y, a.z - b.z);
}

__device__ __forceinline__ float3 cross3(float3 a, float3 b) {
  return make_float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                     a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// Ray/AABB slab test of `node`; returns hit and writes the entry distance.
__device__ __forceinline__ bool slab(const Bvh& bvh, int node, float3 o,
                                     float3 inv, float tmin, float tmax,
                                     float* tnear_out) {
  const float3 lo = load3(bvh.aabb_min + 3 * node);
  const float3 hi = load3(bvh.aabb_max + 3 * node);
  const float x1 = (lo.x - o.x) * inv.x, x2 = (hi.x - o.x) * inv.x;
  const float y1 = (lo.y - o.y) * inv.y, y2 = (hi.y - o.y) * inv.y;
  const float z1 = (lo.z - o.z) * inv.z, z2 = (hi.z - o.z) * inv.z;
  const float tnear = fmaxf(
      fmaxf(fmaxf(fminf(x1, x2), fminf(y1, y2)), fminf(z1, z2)), tmin);
  const float tfar = fminf(
      fminf(fminf(fmaxf(x1, x2), fmaxf(y1, y2)), fmaxf(z1, z2)), tmax);
  *tnear_out = tnear;
  return tnear <= tfar;
}

__device__ __forceinline__ float inv_component(float d) {
  const float tiny = d >= 0.0f ? 1e-12f : -1e-12f;
  return 1.0f / (fabsf(d) < 1e-12f ? tiny : d);
}

__global__ void __launch_bounds__(kBlock)
    traverse_kernel(Bvh bvh, const float* __restrict__ ray_o,
                    const float* __restrict__ ray_d,
                    const float* __restrict__ ray_tmin,
                    const float* __restrict__ ray_tmax, int64_t n,
                    bool any_hit, float* __restrict__ t_out,
                    int32_t* __restrict__ prim_out, float* __restrict__ u_out,
                    float* __restrict__ v_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float3 o = load3(ray_o + 3 * i);
  const float3 d = load3(ray_d + 3 * i);
  const float3 inv =
      make_float3(inv_component(d.x), inv_component(d.y), inv_component(d.z));
  const float tmin = ray_tmin[i];
  float best_t = ray_tmax[i];
  int32_t best_prim = -1;
  float best_u = 0.0f, best_v = 0.0f;

  const int leaf_base = bvh.num_tris - 1;
  int stack[kStackSize];
  float stack_t[kStackSize];
  int sp = 0;
  // With one triangle, leaf_base is 0 and node 0 is that leaf.
  int node = 0;
  while (true) {
    if (node < leaf_base) {
      const int l = __ldg(bvh.left + node);
      const int r = __ldg(bvh.right + node);
      float tl, tr;
      const bool hl = slab(bvh, l, o, inv, tmin, best_t, &tl);
      const bool hr = slab(bvh, r, o, inv, tmin, best_t, &tr);
      if (hl && hr) {
        const bool l_near = tl <= tr;
        if (sp < kStackSize) {
          stack[sp] = l_near ? r : l;
          stack_t[sp] = l_near ? tr : tl;
          ++sp;
        }
        node = l_near ? l : r;
        continue;
      }
      if (hl || hr) {
        node = hl ? l : r;
        continue;
      }
    } else {
      const int tri = node - leaf_base;
      const float* tv = bvh.verts + 9 * static_cast<int64_t>(tri);
      const float3 v0 = load3(tv);
      const float3 e1 = sub3(load3(tv + 3), v0);
      const float3 e2 = sub3(load3(tv + 6), v0);
      const float3 pvec = cross3(d, e2);
      const float det = dot3(e1, pvec);
      const bool det_ok = fabsf(det) > kDetEps;
      const float inv_det = det_ok ? 1.0f / det : 0.0f;
      const float3 tvec = sub3(o, v0);
      const float u = dot3(tvec, pvec) * inv_det;
      const float3 qvec = cross3(tvec, e1);
      const float v = dot3(d, qvec) * inv_det;
      const float t = dot3(e2, qvec) * inv_det;
      if (det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin &&
          t < best_t) {
        best_t = t;
        best_prim = __ldg(bvh.order + tri);
        best_u = u;
        best_v = v;
        if (any_hit) break;
      }
    }
    // Pop the nearest deferred node that can still beat best_t (a box
    // entered at or beyond best_t cannot hold a closer hit).
    bool found = false;
    while (sp > 0) {
      --sp;
      if (stack_t[sp] <= best_t) {
        node = stack[sp];
        found = true;
        break;
      }
    }
    if (!found) break;
  }
  const bool hit = best_prim >= 0;
  t_out[i] = hit ? best_t : INFINITY;
  prim_out[i] = best_prim;
  u_out[i] = hit ? best_u : 0.0f;
  v_out[i] = hit ? best_v : 0.0f;
}

ffi::Error TraverseImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> left,
                        ffi::Buffer<ffi::S32> right,
                        ffi::Buffer<ffi::F32> aabb_min,
                        ffi::Buffer<ffi::F32> aabb_max,
                        ffi::Buffer<ffi::S32> order,
                        ffi::Buffer<ffi::F32> verts,
                        ffi::Buffer<ffi::F32> ray_o,
                        ffi::Buffer<ffi::F32> ray_d,
                        ffi::Buffer<ffi::F32> tmin, ffi::Buffer<ffi::F32> tmax,
                        int32_t any_hit, ffi::ResultBuffer<ffi::F32> t_out,
                        ffi::ResultBuffer<ffi::S32> prim_out,
                        ffi::ResultBuffer<ffi::F32> u_out,
                        ffi::ResultBuffer<ffi::F32> v_out) {
  const int64_t n = static_cast<int64_t>(tmin.element_count());
  const int64_t num_tris = static_cast<int64_t>(order.element_count());
  if (num_tris < 1 || num_tris > (int64_t{1} << 30)) {
    return ffi::Error::InvalidArgument("bvh_traverse: bad triangle count " +
                                       std::to_string(num_tris));
  }
  const int64_t num_nodes = 2 * num_tris - 1;
  const int64_t num_inner = num_tris > 1 ? num_tris - 1 : 1;
  if (static_cast<int64_t>(verts.element_count()) != 9 * num_tris ||
      static_cast<int64_t>(aabb_min.element_count()) < 3 * num_nodes ||
      static_cast<int64_t>(aabb_max.element_count()) < 3 * num_nodes ||
      static_cast<int64_t>(left.element_count()) != num_inner ||
      static_cast<int64_t>(right.element_count()) != num_inner) {
    return ffi::Error::InvalidArgument("bvh_traverse: inconsistent LBVH shapes");
  }
  if (static_cast<int64_t>(ray_o.element_count()) != 3 * n ||
      static_cast<int64_t>(ray_d.element_count()) != 3 * n ||
      static_cast<int64_t>(tmax.element_count()) != n) {
    return ffi::Error::InvalidArgument("bvh_traverse: inconsistent ray shapes");
  }
  if (n == 0) return ffi::Error::Success();
  const Bvh bvh{left.typed_data(),     right.typed_data(),
                aabb_min.typed_data(), aabb_max.typed_data(),
                order.typed_data(),    verts.typed_data(),
                static_cast<int>(num_tris)};
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  traverse_kernel<<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      bvh, ray_o.typed_data(), ray_d.typed_data(), tmin.typed_data(),
      tmax.typed_data(), n, any_hit != 0, t_out->typed_data(),
      prim_out->typed_data(), u_out->typed_data(), v_out->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("bvh_traverse launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(HenjouBvhTraverse, TraverseImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // left
                                  .Arg<ffi::Buffer<ffi::S32>>()  // right
                                  .Arg<ffi::Buffer<ffi::F32>>()  // aabb_min
                                  .Arg<ffi::Buffer<ffi::F32>>()  // aabb_max
                                  .Arg<ffi::Buffer<ffi::S32>>()  // tri_order
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tri_verts
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ray_o
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ray_d
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tmin
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tmax
                                  .Attr<int32_t>("any_hit")
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::S32>>()  // prim
                                  .Ret<ffi::Buffer<ffi::F32>>()  // u
                                  .Ret<ffi::Buffer<ffi::F32>>()  // v
);

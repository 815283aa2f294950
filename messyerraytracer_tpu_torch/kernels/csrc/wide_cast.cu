// wide_cast.cu — kernel B4 of the port: closest-hit / any-hit cast of a ray
// batch over the wide-node tables (kernels/wide.py::WideScene), binary or
// 8-wide, with exact or quantized child boxes.  Hopper, sm_90a.
//
// Replaces these TPU kernels of the JAX package:
//   * messyerraytracer_tpu/kernels/traverse_pallas.py::_mega_kernel (B4),
//     the resident-scene cast of cast_rays_wide, columnar or not, and its
//     quantized "q" variant (the CWBVH-style 8-bit child boxes);
//   * ...::_traverse_kernel (B5), the streamed casts (stream_leaves /
//     stream_nodes).  It exists only because a scene over the TPU's VMEM
//     budget must stream nodes and leaves from HBM one pop at a time; here
//     every cast reads the scene from device memory through L2, so this
//     kernel serves both contracts.
//   Each thread reads its ray's fields straight from the SoA tensors origin
//   (N,3), direction (N,3), t_min (N,), t_max (N,): no packed copy, no tile
//   padding, no tile bucketing.
//
// Design.  One thread per ray with its own traversal stack (the shape of
// the reference's bvh_traverse.comp.glsl / cwbvh_traverse.comp.glsl), not
// the TPU schedule: no ray tile sharing one stack, no leaf ring queue and
// drains, no dummy node or dummy leaf pops, no unroll / interleave / or_any
// knobs, no columnar broadcast staging, no DMA double buffers.
//   * The root is pushed unconditionally.  A dead ray (t_max < t_min) tests
//     against cap = -BIG and so opens nothing.  Each pop slab-tests the K
//     (2 or 8) children against cap = min(best, t_max) with the safe
//     inverse direction; an absent child has code -1 and is skipped by its
//     code, never by a NaN box (fminf/fmaxf drop NaN operands).
//   * Children are visited front-to-back by the ray's OWN direction sign on
//     the node's split axis (the TPU kernel used a tile consensus): hit
//     leaves near-to-far, each intersected at once if its entry distance is
//     still <= cap; then hit internal children are pushed far-to-near.  A
//     push that does not fit kstack is dropped and counted in the global
//     stack_drops — never silently (the JAX kernel drops past 64 silently).
//   * A leaf runs the classic Moller-Trumbore of traverse_pallas.py:754-789
//     (|det| >= eps, u in [0,1], v >= 0, u+v <= 1, t in [t_min, t_max], no
//     barycentric band) over its triangles in index order with a strictly
//     closer update; the winner's slot is leaf*4 + k.  A triangle with
//     (layers & query_mask) == 0 is rejected here (-1 = no filter), so no
//     masked copy of the leaves is needed.
//   * Quantized nodes decode each child bound as anchor + q * scale in
//     float32 (kernels/wide.py::WideScene.quantized), a box that contains
//     the exact one, so the traversal visits a superset and the hits stay.
//   * Any-hit retires the ray after the leaf that produced a hit.
//   * Counters are per ray (tri_tests: a leaf's real triangle count per
//     visit); pops and stack_drops are summed per warp and then added to two
//     global counters with atomics.
//
// Numerics.  Built with -fmad=false: the plain PyTorch version
// (kernels/traverse_pallas.py::wide_cast_plain) evaluates the same
// expressions in the same order with separately rounded IEEE operations,
// so hits and counters agree bit for bit on one card.  The f32 constants
// come in as arguments from the same Python values.
//
// What bounds it on the H100: dependent fetches from device memory.  Each
// pop reads one node (8-wide: 8 child boxes of 24 bytes, codes, axis; or
// 88 bytes quantized), each leaf visit 4 triangles of 36 bytes, and every
// next address depends on the last result; warps diverge where their rays
// take different paths.  The per-ray state lives in registers, the stack in
// local memory (cached in L1), the caller's block-swizzled frame order lets
// most of a warp share each node and leaf fetch, and the scene tables are
// left to the card's 50 MB L2.  Aligned 16-byte records, a compressed stack
// and wider work per fetch are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLeafCap = 4;

struct Consts {
  float det_eps, inv_eps, big, t_miss;
};

struct Scene {
  const float* node_box;    // (W, K, 6) child boxes [min.xyz, max.xyz]
  const int* node_child;    // (W, K) 2*ptr + is_leaf, -1 absent
  const int* node_axis;     // (W,)
  const float* q_anchor;    // (W, 3) quantized nodes only
  const float* q_scale;     // (W, 3)
  const int* q_lo;          // (W, 8) x | y << 8 | z << 16
  const int* q_hi;          // (W, 8)
  const float* leaf_tri;    // (L, 4, 9) [v0, e1, e2]
  const int* leaf_count;    // (L,)
  const int* slot_layers;   // (4L,)
};

struct Hit {
  float best, u, v;
  int slot, tri_tests;
};

__device__ __forceinline__ float safe_inv(float x, float eps) {
  if (fabsf(x) < eps) return (x < 0.f ? -1.f : 1.f) / eps;
  return 1.f / x;
}

// Child c of wide node `node`: its box [min.xyz, max.xyz].
template <int K, bool Q>
__device__ __forceinline__ void child_box(const Scene& s, int node, int c,
                                          float b[6]) {
  if (Q) {
    const float* an = s.q_anchor + 3 * node;
    const float* sc = s.q_scale + 3 * node;
    const int lo = s.q_lo[8 * node + c];
    const int hi = s.q_hi[8 * node + c];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      b[a] = an[a] + (float)((lo >> (8 * a)) & 255) * sc[a];
      b[3 + a] = an[a] + (float)((hi >> (8 * a)) & 255) * sc[a];
    }
  } else {
    const float* p = s.node_box + ((size_t)node * K + c) * 6;
#pragma unroll
    for (int j = 0; j < 6; ++j) b[j] = p[j];
  }
}

// One leaf visit: the classic Moller-Trumbore test of each of the leaf's
// triangles, updating `h` with the closest hit.
__device__ __forceinline__ void intersect_leaf(
    const Scene& s, int leaf, float ox, float oy, float oz, float dx,
    float dy, float dz, float tmin, float tmax, int qmask, const Consts& k,
    Hit& h) {
  const int cnt = s.leaf_count[leaf];
  const float* tri = s.leaf_tri + (size_t)leaf * (kLeafCap * 9);
  for (int j = 0; j < cnt; ++j) {
    if (qmask != -1 && (s.slot_layers[kLeafCap * leaf + j] & qmask) == 0)
      continue;
    const float* f = tri + 9 * j;
    const float e1x = f[3], e1y = f[4], e1z = f[5];
    const float e2x = f[6], e2y = f[7], e2z = f[8];
    const float pvx = dy * e2z - dz * e2y;
    const float pvy = dz * e2x - dx * e2z;
    const float pvz = dx * e2y - dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const bool ok = fabsf(det) >= k.det_eps;
    const float idet = 1.f / (ok ? det : 1.f);
    const float tvx = ox - f[0];
    const float tvy = oy - f[1];
    const float tvz = oz - f[2];
    const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * idet;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float v = (dx * qvx + dy * qvy + dz * qvz) * idet;
    const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * idet;
    if (ok && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f &&
        t >= tmin && t <= tmax && t < h.best) {
      h.best = t;
      h.u = u;
      h.v = v;
      h.slot = kLeafCap * leaf + j;
    }
  }
  h.tri_tests += cnt;
}

template <int K, bool Q, bool ANY, int KCAP>
__global__ void __launch_bounds__(kThreads) wide_cast_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ t_min, const float* __restrict__ t_max, int n,
    Scene s, int qmask, int kstack, Consts k, float* __restrict__ fout,
    int* __restrict__ iout, unsigned long long* __restrict__ counters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned int pops = 0, drops = 0;
  if (i < n) {
    const float ox = origin[3 * i], oy = origin[3 * i + 1],
                oz = origin[3 * i + 2];
    const float dx = direction[3 * i], dy = direction[3 * i + 1],
                dz = direction[3 * i + 2];
    const float tmin = t_min[i], tmax = t_max[i];
    const float lim = tmax >= tmin ? tmax : -k.big;   // dead: cap = -BIG
    const float ix = safe_inv(dx, k.inv_eps);
    const float iy = safe_inv(dy, k.inv_eps);
    const float iz = safe_inv(dz, k.inv_eps);
    Hit h = {k.big, 0.f, 0.f, -1, 0};
    int stack[KCAP];
    int sp = 1;
    stack[0] = 0;                             // root, pushed unconditionally
    while (sp > 0) {
      const int node = stack[--sp];
      ++pops;
      const float cap = fminf(h.best, lim);
      const int* nc = s.node_child + (size_t)node * K;
      const int axis = s.node_axis[node];
      const bool fwd = (axis == 0 ? dx : (axis == 1 ? dy : dz)) >= 0.f;
      int code[K];
      float tn[K];
      unsigned int hit = 0;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        code[c] = nc[c];
        float b[6];
        child_box<K, Q>(s, node, c, b);
        float t1 = (b[0] - ox) * ix, t2 = (b[3] - ox) * ix;
        float tnear = fminf(t1, t2), tfar = fmaxf(t1, t2);
        t1 = (b[1] - oy) * iy;
        t2 = (b[4] - oy) * iy;
        tnear = fmaxf(tnear, fminf(t1, t2));
        tfar = fminf(tfar, fmaxf(t1, t2));
        t1 = (b[2] - oz) * iz;
        t2 = (b[5] - oz) * iz;
        tnear = fmaxf(tnear, fminf(t1, t2));
        tfar = fminf(tfar, fmaxf(t1, t2));
        tn[c] = tnear;
        if (code[c] >= 0 && tfar >= fmaxf(tnear, 0.f) && tnear <= cap)
          hit |= 1u << c;
      }
      bool done = false;
      for (int p = 0; p < K; ++p) {           // leaves, near to far
        const int c = fwd ? p : K - 1 - p;
        if (!((hit >> c) & 1u) || !(code[c] & 1)) continue;
        if (!(tn[c] <= fminf(h.best, lim))) continue;
        intersect_leaf(s, code[c] >> 1, ox, oy, oz, dx, dy, dz, tmin, tmax,
                       qmask, k, h);
        if (ANY && h.slot >= 0) {
          done = true;
          break;
        }
      }
      if (ANY && done) break;
      for (int p = K - 1; p >= 0; --p) {      // internal children, far to near
        const int c = fwd ? p : K - 1 - p;
        if (!((hit >> c) & 1u) || (code[c] & 1)) continue;
        if (sp < kstack)
          stack[sp++] = code[c] >> 1;
        else
          ++drops;
      }
    }
    const bool found = h.slot >= 0;
    fout[i] = found ? h.best : k.t_miss;
    fout[n + i] = found ? h.u : 0.f;
    fout[2 * n + i] = found ? h.v : 0.f;
    iout[i] = h.slot;
    iout[n + i] = h.tri_tests;
  }
  // every thread of the warp reaches here: reduce, then one atomic per warp
  pops = __reduce_add_sync(0xffffffffu, pops);
  drops = __reduce_add_sync(0xffffffffu, drops);
  if ((threadIdx.x & 31) == 0) {
    if (pops) atomicAdd(&counters[0], (unsigned long long)pops);
    if (drops) atomicAdd(&counters[1], (unsigned long long)drops);
  }
}

struct Launch {
  const float *o, *d, *t0, *t1;
  int n;
  Scene s;
  int qmask, kstack;
  Consts k;
  float* fout;
  int* iout;
  unsigned long long* cnt;
  int grid;
  cudaStream_t st;
};

template <int K, bool Q, bool ANY, int KCAP>
void launch(const Launch& a) {
  wide_cast_kernel<K, Q, ANY, KCAP><<<a.grid, kThreads, 0, a.st>>>(
      a.o, a.d, a.t0, a.t1, a.n, a.s, a.qmask, a.kstack, a.k, a.fout, a.iout,
      a.cnt);
}

template <int K, bool Q, bool ANY>
int launch_kcap(int kcap, const Launch& a) {
  switch (kcap) {
    case 64: launch<K, Q, ANY, 64>(a); return 0;
    case 128: launch<K, Q, ANY, 128>(a); return 0;
    case 256: launch<K, Q, ANY, 256>(a); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int K, bool Q>
int launch_any(bool any, int kcap, const Launch& a) {
  return any ? launch_kcap<K, Q, true>(kcap, a)
             : launch_kcap<K, Q, false>(kcap, a);
}

}  // namespace

// C entry, bound with ctypes.  Launches on `stream`, does not synchronize
// and allocates nothing; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a branching, quantized mode or stack capacity
// it was not compiled for.
extern "C" int mrt_wide_cast(
    const float* origin, const float* direction, const float* t_min,
    const float* t_max, int n, const float* node_box, const int* node_child,
    const int* node_axis, const float* q_anchor, const float* q_scale,
    const int* q_lo, const int* q_hi, const float* leaf_tri,
    const int* leaf_count, const int* slot_layers, int branching,
    int quantized, int query_mask, int any_hit, int kstack, int kcap,
    float det_eps, float inv_eps, float big, float t_miss, float* fout,
    int* iout, unsigned long long* counters, void* stream) {
  const Scene s = {node_box, node_child, node_axis, q_anchor, q_scale,
                   q_lo,     q_hi,       leaf_tri,  leaf_count, slot_layers};
  const Launch a = {origin, direction, t_min, t_max, n,
                    s, query_mask, kstack,
                    {det_eps, inv_eps, big, t_miss},
                    fout, iout, counters,
                    (n + kThreads - 1) / kThreads,
                    static_cast<cudaStream_t>(stream)};
  if (kstack > kcap) return (int)cudaErrorInvalidValue;
  const bool any = any_hit != 0;
  int err;
  if (branching == 2 && !quantized)
    err = launch_any<2, false>(any, kcap, a);
  else if (branching == 8 && !quantized)
    err = launch_any<8, false>(any, kcap, a);
  else if (branching == 8 && quantized)
    err = launch_any<8, true>(any, kcap, a);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// cluster_cast.cu — kernel B1 of the port: closest-hit / any-hit cast of a
// ray batch over the cluster tables (kernels/cluster.py::ClusterScene,
// kernels/cluster_tlas.py::ClusterTLAS).  Hopper, sm_90a.
//
// Replaces these TPU kernels of the JAX package:
//   * messyerraytracer_tpu/kernels/cluster_v2.py::_cluster_kernel_v2, flat
//     and instanced (B1);
//   * messyerraytracer_tpu/kernels/cluster.py::_pack_kernel (B2), fused:
//     each thread reads its ray's eight fields straight from the SoA
//     tensors origin (N,3), direction (N,3), t_min (N,), t_max (N,), in
//     coalesced loads — no packed copy, no tile padding, no tile bucketing.
//
// Design.  One thread per ray with its own traversal stack (the shape of
// the reference's GPU shaders), not the TPU schedule: no tile-shared stack,
// no 128-lane rows, no integers stored as floats, no DMA ring, no tile
// liveness table, no nway/qd/dmode/popn/qroom knobs.
//   * A dead ray (t_max < t_min) opens no node.  The stack starts with the
//     root wide node.  Each pop slab-tests the 8 children against
//     cap = min(best, t_max); an absent child has code -1 and is skipped by
//     its code, never by a NaN box (fminf/fmaxf drop NaN operands, so a NaN
//     box could pass a slab test).
//   * Children are visited front-to-back by the ray's OWN direction sign on
//     the node's split axis (the TPU kernel used a tile consensus): hit
//     clusters near-to-far, each intersected at once if its entry distance
//     is still <= min(best, t_max); then hit internal children are pushed
//     far-to-near.  A push that does not fit kstack is dropped and counted
//     in the global stack_drops — never silently.
//   * A cluster visit runs the anchored Plucker Moller-Trumbore of
//     cluster_v2.py:366-396 over the cluster's triangles in index order with
//     a strictly-closer update, so the lowest index wins a tie inside a
//     cluster.  Instanced: the ray goes to object space by iinv (no
//     renormalization, t stays in world units), the normal comes back
//     through ifwd, the prim id gets iprim[inst] added, the instance id is
//     reported.  A triangle with (layers & query_mask) == 0 is rejected here
//     (query_mask -1 = no filter), so no masked copy of the scene is needed.
//   * Any-hit retires the ray after the cluster that produced a hit.
//   * Counters are per ray (tri_tests: a cluster's triangle count per visit;
//     node_visits: child boxes hit); pops and stack_drops are summed per warp
//     and then added to two global counters with atomics.
//
// Numerics.  Built with -fmad=false: the plain PyTorch version of this
// kernel (kernels/cluster_v2.py::cluster_cast_plain) evaluates the same
// expressions in the same order with separately rounded IEEE operations,
// so hits and counters agree bit for bit on one card.  The f32 constants
// (epsilons, band limits) come in as arguments from the same Python values.
// This has a price.  On an H100 80GB HBM3 at 700 W, the 1080p headline
// frame is 13.5% faster instanced and 5.0% faster flat with FMA
// contraction on.  That build breaks the parity rule against the plain
// version on the flat frame, though: 25 rays change prim and the largest t
// error is 2.79.  So the shipped build keeps -fmad=false.
//
// What bounds it on the H100: dependent fetches from device memory — each
// pop reads one node (8 child boxes, codes, axis), each cluster visit the
// cluster's triangle records, and every next address depends on the last
// result — plus warp divergence where the rays of one warp take different
// paths.  The design keeps the per-ray state in registers, reads each
// 64-byte triangle record as four 16-byte loads, relies on the caller's
// block-swizzled frame order so most of a warp shares each node and cluster
// fetch, and leaves the scene tables to the card's L2 cache.  Wider work per
// fetch (wgmma, TMA, persistent blocks) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLocalBits = 13;                  // gid = inst << 13 | local
constexpr int kLocalMask = (1 << kLocalBits) - 1;

struct Consts {
  float det_eps, bary_lo, bary_hi, inv_eps, big, t_miss;
};

struct Scene {
  const float* node_box;    // (NW, 8, 6) child boxes [min.xyz, max.xyz]
  const int* node_child;    // (NW, 8) 2*ptr + is_cluster, -1 absent
  const int* node_axis;     // (NW,)
  const float* tri;         // (C, T, 16) anchored Plucker fields
  const int* tri_prim;      // (C, T)
  const int* tri_layers;    // (C, T)
  const float* cl_anchor;   // (C, 3)
  const int* cl_count;      // (C,)
  int tcap;
  const int* inst_cbase;    // (Ni,) instanced only
  const int* iprim;         // (Ni,)
  const float* iinv;        // (Ni, 12)
  const float* ifwd;        // (Ni, 9)
};

struct Hit {
  float best, u, v, nx, ny, nz;
  int prim, layers, inst, tri_tests;
};

__device__ __forceinline__ float safe_inv(float x, float eps) {
  if (fabsf(x) < eps) return (x < 0.f ? -1.f : 1.f) / eps;
  return 1.f / x;
}

// One cluster visit: the anchored Plucker test of every triangle of the
// cluster with leaf payload `code`, updating `h` with the closest hit.
template <bool INST>
__device__ __forceinline__ void intersect_cluster(
    const Scene& s, int code, float ox, float oy, float oz, float dx,
    float dy, float dz, float tmin, float tmax, int qmask, const Consts& k,
    Hit& h) {
  int c = code, inst = -1;
  if (INST) {
    inst = code >> kLocalBits;
    c = s.inst_cbase[inst] + (code & kLocalMask);
    const float* m = s.iinv + 12 * inst;
    const float px = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
    const float py = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
    const float pz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
    const float qx = m[0] * dx + m[1] * dy + m[2] * dz;
    const float qy = m[4] * dx + m[5] * dy + m[6] * dz;
    const float qz = m[8] * dx + m[9] * dy + m[10] * dz;
    ox = px; oy = py; oz = pz;
    dx = qx; dy = qy; dz = qz;
  }
  const float ax = s.cl_anchor[3 * c];
  const float ay = s.cl_anchor[3 * c + 1];
  const float az = s.cl_anchor[3 * c + 2];
  const int cnt = s.cl_count[c];
  float tau = dx * (ax - ox) + dy * (ay - oy) + dz * (az - oz);
  if (INST) tau = tau * (1.f / (dx * dx + dy * dy + dz * dz));
  // re-anchor at the closest approach to the cluster anchor
  const float ocx = ox + tau * dx - ax;
  const float ocy = oy + tau * dy - ay;
  const float ocz = oz + tau * dz - az;
  const float mx = ocy * dz - ocz * dy;
  const float my = ocz * dx - ocx * dz;
  const float mz = ocx * dy - ocy * dx;

  const size_t base = (size_t)c * s.tcap;
  const float4* rec = reinterpret_cast<const float4*>(s.tri + base * 16);
  int bk = -1;
  for (int j = 0; j < cnt; ++j) {
    if (qmask != -1 && (s.tri_layers[base + j] & qmask) == 0) continue;
    const float4 a = rec[4 * j];       // -n.xyz, (v0' x e2).x
    const float4 b = rec[4 * j + 1];   // (v0' x e2).yz, e2.xy
    const float4 e = rec[4 * j + 2];   // e2.z, -(v0' x e1).xyz
    const float4 f = rec[4 * j + 3];   // -e1.xyz, -v0'.n
    const float det = a.x * dx + a.y * dy + a.z * dz;
    const float un = a.w * dx + b.x * dy + b.y * dz + b.z * mx + b.w * my +
                     e.x * mz;
    const float vn = e.y * dx + e.z * dy + e.w * dz + f.x * mx + f.y * my +
                     f.z * mz;
    const float tn = -(a.x * ocx + a.y * ocy + a.z * ocz) + f.w;
    const bool ok = fabsf(det) >= k.det_eps;
    const float idet = 1.f / (ok ? det : 1.f);
    const float u = un * idet;
    const float v = vn * idet;
    const float t = tn * idet + tau;
    if (ok && u >= k.bary_lo && u <= k.bary_hi && v >= k.bary_lo &&
        u + v <= k.bary_hi && t >= tmin && t <= tmax && t < h.best) {
      h.best = t;
      h.u = u;
      h.v = v;
      bk = j;
    }
  }
  h.tri_tests += cnt;
  if (bk >= 0) {
    const float* w = s.tri + (base + bk) * 16;
    float nx = w[0], ny = w[1], nz = w[2];
    int prim = s.tri_prim[base + bk];
    if (INST) {
      const float* fw = s.ifwd + 9 * inst;
      const float wx = fw[0] * nx + fw[1] * ny + fw[2] * nz;
      const float wy = fw[3] * nx + fw[4] * ny + fw[5] * nz;
      const float wz = fw[6] * nx + fw[7] * ny + fw[8] * nz;
      nx = wx; ny = wy; nz = wz;
      prim += s.iprim[inst];
      h.inst = inst;
    }
    h.nx = nx; h.ny = ny; h.nz = nz;
    h.prim = prim;
    h.layers = s.tri_layers[base + bk];
  }
}

template <int KCAP, bool INST, bool ANY>
__global__ void __launch_bounds__(kThreads) cluster_cast_kernel(
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
    Hit h = {k.big, 0.f, 0.f, 0.f, 0.f, 0.f, -1, 0, -1, 0};
    int node_visits = 0;
    if (tmax >= tmin) {                       // dead rays open no node
      const float ix = safe_inv(dx, k.inv_eps);
      const float iy = safe_inv(dy, k.inv_eps);
      const float iz = safe_inv(dz, k.inv_eps);
      int stack[KCAP];
      int sp = 1;
      stack[0] = 0;                           // root wide node
      while (sp > 0) {
        const int node = stack[--sp];
        ++pops;
        const float cap = fminf(h.best, tmax);
        const float* nb = s.node_box + (size_t)node * 48;
        const int* nc = s.node_child + (size_t)node * 8;
        const int axis = s.node_axis[node];
        const bool fwd = (axis == 0 ? dx : (axis == 1 ? dy : dz)) >= 0.f;
        int code[8];
        float tn[8];
        unsigned int hit = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          code[c] = nc[c];
          const float* b = nb + 6 * c;
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
        node_visits += __popc(hit);
        bool done = false;
        for (int p = 0; p < 8; ++p) {         // clusters, near to far
          const int c = fwd ? p : 7 - p;
          if (!((hit >> c) & 1u) || !(code[c] & 1)) continue;
          if (!(tn[c] <= fminf(h.best, tmax))) continue;
          intersect_cluster<INST>(s, code[c] >> 1, ox, oy, oz, dx, dy, dz,
                                  tmin, tmax, qmask, k, h);
          if (ANY && h.prim >= 0) {
            done = true;
            break;
          }
        }
        if (ANY && done) break;
        for (int p = 7; p >= 0; --p) {        // internal children, far to near
          const int c = fwd ? p : 7 - p;
          if (!((hit >> c) & 1u) || (code[c] & 1)) continue;
          if (sp < kstack)
            stack[sp++] = code[c] >> 1;
          else
            ++drops;
        }
      }
    }
    const bool found = h.prim >= 0;
    fout[i] = found ? h.best : k.t_miss;
    fout[n + i] = found ? h.u : 0.f;
    fout[2 * n + i] = found ? h.v : 0.f;
    fout[3 * n + i] = h.nx;
    fout[4 * n + i] = h.ny;
    fout[5 * n + i] = h.nz;
    iout[i] = h.prim;
    iout[n + i] = h.layers;
    iout[2 * n + i] = h.tri_tests;
    iout[3 * n + i] = h.inst;
    iout[4 * n + i] = node_visits;
  }
  // every thread of the warp reaches here: reduce, then one atomic per warp
  pops = __reduce_add_sync(0xffffffffu, pops);
  drops = __reduce_add_sync(0xffffffffu, drops);
  if ((threadIdx.x & 31) == 0) {
    if (pops) atomicAdd(&counters[0], (unsigned long long)pops);
    if (drops) atomicAdd(&counters[1], (unsigned long long)drops);
  }
}

template <int KCAP, bool INST>
void launch_any(bool any, int grid, cudaStream_t st, const float* o,
                const float* d, const float* t0, const float* t1, int n,
                const Scene& s, int qmask, int kstack, const Consts& k,
                float* fout, int* iout, unsigned long long* cnt) {
  if (any)
    cluster_cast_kernel<KCAP, INST, true><<<grid, kThreads, 0, st>>>(
        o, d, t0, t1, n, s, qmask, kstack, k, fout, iout, cnt);
  else
    cluster_cast_kernel<KCAP, INST, false><<<grid, kThreads, 0, st>>>(
        o, d, t0, t1, n, s, qmask, kstack, k, fout, iout, cnt);
}

template <int KCAP>
void launch_inst(bool inst, bool any, int grid, cudaStream_t st,
                 const float* o, const float* d, const float* t0,
                 const float* t1, int n, const Scene& s, int qmask,
                 int kstack, const Consts& k, float* fout, int* iout,
                 unsigned long long* cnt) {
  if (inst)
    launch_any<KCAP, true>(any, grid, st, o, d, t0, t1, n, s, qmask, kstack,
                           k, fout, iout, cnt);
  else
    launch_any<KCAP, false>(any, grid, st, o, d, t0, t1, n, s, qmask,
                            kstack, k, fout, iout, cnt);
}

}  // namespace

// C entry, bound with ctypes.  Launches on `stream`, does not synchronize
// and allocates nothing; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a stack capacity it was not compiled for.
extern "C" int mrt_cluster_cast(
    const float* origin, const float* direction, const float* t_min,
    const float* t_max, int n, const float* node_box, const int* node_child,
    const int* node_axis, const float* tri, const int* tri_prim,
    const int* tri_layers, const float* cl_anchor, const int* cl_count,
    int tcap, const int* inst_cbase, const int* iprim, const float* iinv,
    const float* ifwd, int query_mask, int any_hit, int kstack, int kcap,
    float det_eps, float bary_lo, float bary_hi, float inv_eps, float big,
    float t_miss, float* fout, int* iout, unsigned long long* counters,
    void* stream) {
  const Scene s = {node_box,  node_child, node_axis, tri,        tri_prim,
                   tri_layers, cl_anchor, cl_count,  tcap,       inst_cbase,
                   iprim,      iinv,      ifwd};
  const Consts k = {det_eps, bary_lo, bary_hi, inv_eps, big, t_miss};
  const bool inst = inst_cbase != nullptr;
  const bool any = any_hit != 0;
  const int grid = (n + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kstack > kcap) return (int)cudaErrorInvalidValue;
  switch (kcap) {
    case 64:
      launch_inst<64>(inst, any, grid, st, origin, direction, t_min, t_max,
                      n, s, query_mask, kstack, k, fout, iout, counters);
      break;
    case 128:
      launch_inst<128>(inst, any, grid, st, origin, direction, t_min, t_max,
                       n, s, query_mask, kstack, k, fout, iout, counters);
      break;
    case 256:
      launch_inst<256>(inst, any, grid, st, origin, direction, t_min, t_max,
                       n, s, query_mask, kstack, k, fout, iout, counters);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

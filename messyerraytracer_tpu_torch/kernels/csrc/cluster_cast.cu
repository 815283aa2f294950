// cluster_cast.cu — kernel B1 of the port: closest-hit / any-hit cast of a
// ray batch over the cluster tables (kernels/cluster.py::ClusterScene,
// kernels/cluster_tlas.py::ClusterTLAS).  Hopper, sm_90a.
//
// Replaces these TPU kernels of the JAX package:
//   * messyerraytracer_tpu/kernels/cluster_v2.py::_cluster_kernel_v2, flat
//     and instanced (B1), and through its entry points the v1 kernel
//     messyerraytracer_tpu/kernels/cluster.py::_cluster_kernel (B3);
//   * messyerraytracer_tpu/kernels/cluster.py::_pack_kernel (B2), fused:
//     each thread reads its ray from the SoA tensors origin (N,3),
//     direction (N,3), t_min (N,), t_max (N,) in coalesced loads.
//
// What each ray computes (the plain version, kernels/cluster_v2.py::
// cluster_cast_plain, does the same things in the same order):
//   * a dead ray (t_max < t_min) opens no node; the stack starts with the
//     root wide node; each pop slab-tests the 8 children against
//     cap = min(best, t_max); an absent child has code -1 and is skipped
//     by its code, never by a NaN box (fminf/fmaxf drop NaN operands);
//   * children are taken front-to-back by the ray's own direction sign on
//     the node's split axis: hit clusters near-to-far, each intersected if
//     its entry distance is still <= min(best, t_max); then hit internal
//     children are pushed far-to-near, and a push that does not fit kstack
//     is dropped and counted in stack_drops;
//   * a cluster runs the anchored Plucker Moller-Trumbore of the JAX
//     kernel (cluster_v2.py:366-396) over its triangles; the closest valid
//     t wins and the lowest index wins a tie.  Instanced: the ray goes to
//     object space by iinv (no renormalization: t stays in world units),
//     the normal comes back through ifwd, the prim id gets iprim[inst]
//     added.  (layers & query_mask) == 0 rejects a triangle (-1: no mask);
//   * any-hit retires the ray after the cluster that produced a hit.
//
// What bounds it.  The work itself is small: 5.7 pops and 54 triangle
// tests per ray on the 1080p headline frame, about 0.22 ms of float32 lane
// instructions on an H100 (no FMA: see Numerics).  The earlier design, one
// thread per ray intersecting each cluster at the pop that found it, ran
// 8x above that: while one lane looped over its cluster's up to T = 64
// triangles, the lanes of its warp whose child at that slot was no live
// cluster sat idle, and lanes that met clusters at different slots or pops
// looped in separate passes; 28% of the lanes were busy in those loops.
// So the schedule is the warp's, a "while-while" loop with postponed
// cluster visits, each pass in two phases:
//   * node phase: each lane with no queued cluster and a non-empty stack
//     pops nodes, writing each node's hit children, near-to-far, with
//     their entry distances, to its queue of 8 in shared memory, until
//     every lane of the warp has a cluster queued or an empty stack.  A
//     node's internal children are pushed once its queued clusters are
//     done (pushing at pop time would change stack_drops under any-hit
//     and a small stack); a node with no cluster pushes them at once;
//   * cluster phase: each lane takes its nearest queued cluster that
//     passes the cull, so lanes that found clusters at different slots
//     and pops test them together.
// The warp picks the cluster phase's mode per pass from the number k of
// lanes that want a cluster:
//   * lane-serial: each lane loops over its own cluster's triangles
//     (unrolled by 2); in a coherent warp the loads are broadcasts;
//   * warp-cooperative, the TPU kernel's block test turned around: for
//     each wanting lane L in turn, L's ray (already in its cluster's
//     frame) is broadcast through shared memory, lane j tests triangles
//     j, j+32, ... in 32 consecutive 64-byte records (coalesced), and five
//     xor-shuffle rounds reduce (t, index) to the least t and, among equal
//     t, the least index: the serial strictly-closer loop's winner.
// Cooperative costs k * (ceil(T/32) + r) triangle-test times, serial about
// T, so the warp goes cooperative when k * (ceil(T/32) + r) < T.  r, the
// reduction and broadcast in triangle-test units, is kCoopR = 4: of the r
// measured on the card (b1_variants.py: -0.9 to 8 on the 1080p frames),
// 4 was fastest on the instanced and flat T=64 frames.  Both modes run one
// triangle test, tri_test(), so they cannot drift apart.  Node boxes and
// codes come in 16-byte loads, and __launch_bounds__ keeps 6 blocks per SM.
// What bounds it now is still not the operations: on an H100 80GB HBM3
// at 700 W it runs 4.4x above them (b1_variants.py), with 40% of the
// lanes idle in the cluster phase (rays that are done, or whose queue is
// empty when the warp's stacks run dry) and the latency of each pass's
// dependent node and cluster fetches.
//
// No tensor cores.  A cluster test is a product of (rays x 10) by
// (10 x 4T), but TF32 keeps 10 mantissa bits and split-TF32 sums are not
// bit-exact: the kernel must equal its plain version bit for bit and keep
// the parity rule, which an FMA build already breaks on the flat frame.
//
// Numerics.  Built with -fmad=false: the plain version evaluates the same
// expressions in the same order with separately rounded IEEE operations,
// so hits and counters agree bit for bit on one card.  The f32 constants
// (epsilons, band limits) come in as arguments from the same Python values.
//
// Counters: tri_tests (a cluster's triangle count per visit) and
// node_visits (child boxes hit) per ray; pops and stack_drops per warp,
// then one atomic each per warp.  With a non-null warp_stats the launch
// also counts, per warp: cluster-phase passes, wanting lanes summed over
// them, and (lane, cluster) pairs tested cooperatively.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// 6 resident blocks per SM caps the kernel at 85 registers: measured
// faster than 5 (102 registers) and 7 (73) on the H100.
constexpr int kMinBlocks = 6;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLocalBits = 13;                  // gid = inst << 13 | local
constexpr int kLocalMask = (1 << kLocalBits) - 1;
constexpr int kNoIndex = 0x7fffffff;
// the switch point's r, in triangle-test units (measured, see the note)
constexpr float kCoopR = 4.f;

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

// A ray in one cluster's frame: (object-space) direction, the origin
// re-anchored at its closest approach to the cluster anchor, the moment
// m = oc x d, and tau, the distance along d to that point.
struct ClusterRay {
  float dx, dy, dz, ocx, ocy, ocz, mx, my, mz, tau;
};

__device__ __forceinline__ float safe_inv(float x, float eps) {
  if (fabsf(x) < eps) return (x < 0.f ? -1.f : 1.f) / eps;
  return 1.f / x;
}

// The ray of leaf payload `code` in its cluster's frame; sets the cluster
// id c, the instance (-1 when flat) and the triangle count.
template <bool INST>
__device__ __forceinline__ ClusterRay cluster_ray(
    const Scene& s, int code, float ox, float oy, float oz, float dx,
    float dy, float dz, int& c, int& inst, int& cnt) {
  c = code;
  inst = -1;
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
  cnt = s.cl_count[c];
  ClusterRay r;
  float tau = dx * (ax - ox) + dy * (ay - oy) + dz * (az - oz);
  if (INST) tau = tau * (1.f / (dx * dx + dy * dy + dz * dz));
  r.tau = tau;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.ocx = ox + tau * dx - ax;
  r.ocy = oy + tau * dy - ay;
  r.ocz = oz + tau * dz - az;
  r.mx = r.ocy * dz - r.ocz * dy;
  r.my = r.ocz * dx - r.ocx * dz;
  r.mz = r.ocx * dy - r.ocy * dx;
  return r;
}

// The anchored Plucker test of triangle j of the cluster at row `base`:
// true, with t, u, v, when it is a valid hit closer than `best`.
__device__ __forceinline__ bool tri_test(
    const Scene& s, size_t base, int j, const ClusterRay& r, float tmin,
    float tmax, float best, int qmask, const Consts& k, float& t, float& u,
    float& v) {
  if (qmask != -1 && (s.tri_layers[base + j] & qmask) == 0) return false;
  const float4* rec = reinterpret_cast<const float4*>(s.tri + (base + j) * 16);
  const float4 a = rec[0];       // -n.xyz, (v0' x e2).x
  const float4 b = rec[1];       // (v0' x e2).yz, e2.xy
  const float4 e = rec[2];       // e2.z, -(v0' x e1).xyz
  const float4 f = rec[3];       // -e1.xyz, -v0'.n
  const float det = a.x * r.dx + a.y * r.dy + a.z * r.dz;
  const float un = a.w * r.dx + b.x * r.dy + b.y * r.dz + b.z * r.mx +
                   b.w * r.my + e.x * r.mz;
  const float vn = e.y * r.dx + e.z * r.dy + e.w * r.dz + f.x * r.mx +
                   f.y * r.my + f.z * r.mz;
  const float tn = -(a.x * r.ocx + a.y * r.ocy + a.z * r.ocz) + f.w;
  const bool ok = fabsf(det) >= k.det_eps;
  const float idet = 1.f / (ok ? det : 1.f);
  u = un * idet;
  v = vn * idet;
  t = tn * idet + r.tau;
  return ok && u >= k.bary_lo && u <= k.bary_hi && v >= k.bary_lo &&
         u + v <= k.bary_hi && t >= tmin && t <= tmax && t < best;
}

// The winner bk of a cluster visit into h: normal, prim id, layers and,
// instanced, the normal through ifwd, the prim base and the instance id.
template <bool INST>
__device__ __forceinline__ void take_winner(const Scene& s, size_t base,
                                            int bk, int inst, Hit& h) {
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

template <int KCAP, bool INST, bool ANY, bool STATS>
__global__ void __launch_bounds__(kThreads, kMinBlocks) cluster_cast_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ t_min, const float* __restrict__ t_max, int n,
    Scene s, int qmask, int kstack, Consts k, float* __restrict__ fout,
    int* __restrict__ iout, unsigned long long* __restrict__ counters,
    unsigned long long* __restrict__ warp_stats) {
  // per lane: its node's hit children in near-to-far slots, and the
  // cooperative mode's copy of its cluster ray
  __shared__ int q_code[8][kThreads];
  __shared__ float q_tn[8][kThreads];
  __shared__ float4 stage[4][kThreads];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wbase = tid - lane;
  const int i = blockIdx.x * kThreads + tid;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, tmax = -1.f;
  if (i < n) {
    ox = origin[3 * i]; oy = origin[3 * i + 1]; oz = origin[3 * i + 2];
    dx = direction[3 * i]; dy = direction[3 * i + 1];
    dz = direction[3 * i + 2];
    tmin = t_min[i];
    tmax = t_max[i];
  }
  Hit h = {k.big, 0.f, 0.f, 0.f, 0.f, 0.f, -1, 0, -1, 0};
  int node_visits = 0;
  unsigned int pops = 0, drops = 0;
  unsigned long long passes = 0, wanting = 0, coop_pairs = 0;
  const float ix = safe_inv(dx, k.inv_eps);
  const float iy = safe_inv(dy, k.inv_eps);
  const float iz = safe_inv(dz, k.inv_eps);
  const float coop_cost = (float)((s.tcap + 31) >> 5) + kCoopR;
  int stack[KCAP];
  int sp = (i < n && tmax >= tmin) ? 1 : 0;   // dead rays open no node
  stack[0] = 0;                               // root wide node
  unsigned int qclu = 0, qint = 0;            // queued cluster / inner slots
  // the drained queue's internal children onto the stack, far to near
  auto push_inner = [&]() {
    while (qint != 0) {
      const int p = 31 - __clz(qint);
      qint &= ~(1u << p);
      if (sp < kstack)
        stack[sp++] = q_code[p][tid] >> 1;
      else
        ++drops;
    }
  };

  while (__any_sync(kFull, qclu != 0 || sp > 0)) {
    // ---- node phase: lanes with no pending cluster pop nodes until each
    // lane has a cluster queued or an empty stack
    while (__any_sync(kFull, qclu == 0 && sp > 0)) {
      if (qclu != 0 || sp == 0) continue;
      const int node = stack[--sp];
      ++pops;
      const float cap = fminf(h.best, tmax);
      const int axis = s.node_axis[node];
      const bool fwd = (axis == 0 ? dx : (axis == 1 ? dy : dz)) >= 0.f;
      // 16-byte loads: the 8 codes, then 2 child boxes per 3 loads
      const float4* nb = reinterpret_cast<const float4*>(s.node_box) +
                         (size_t)node * 12;
      const int4* nc = reinterpret_cast<const int4*>(s.node_child) +
                       (size_t)node * 2;
      const int4 ca = nc[0], cb = nc[1];
      const int code[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
      // child c's slab test against its box [b0 b1 b2] - [b3 b4 b5]
      auto child = [&](int c, float b0, float b1, float b2, float b3,
                       float b4, float b5) {
        float t1 = (b0 - ox) * ix, t2 = (b3 - ox) * ix;
        float tnear = fminf(t1, t2), tfar = fmaxf(t1, t2);
        t1 = (b1 - oy) * iy;
        t2 = (b4 - oy) * iy;
        tnear = fmaxf(tnear, fminf(t1, t2));
        tfar = fminf(tfar, fmaxf(t1, t2));
        t1 = (b2 - oz) * iz;
        t2 = (b5 - oz) * iz;
        tnear = fmaxf(tnear, fminf(t1, t2));
        tfar = fminf(tfar, fmaxf(t1, t2));
        if (code[c] >= 0 && tfar >= fmaxf(tnear, 0.f) && tnear <= cap) {
          const int p = fwd ? c : 7 - c;      // slot in near-to-far order
          q_code[p][tid] = code[c];
          q_tn[p][tid] = tnear;
          if (code[c] & 1)
            qclu |= 1u << p;
          else
            qint |= 1u << p;
        }
      };
#pragma unroll
      for (int c = 0; c < 8; c += 2) {
        const float4 v0 = nb[3 * c / 2], v1 = nb[3 * c / 2 + 1];
        const float4 v2 = nb[3 * c / 2 + 2];
        child(c, v0.x, v0.y, v0.z, v0.w, v1.x, v1.y);
        child(c + 1, v1.z, v1.w, v2.x, v2.y, v2.z, v2.w);
      }
      node_visits += __popc(qclu | qint);
      if (qclu == 0) push_inner();
    }

    // ---- cluster phase: the nearest queued cluster that passes the cull
    int code = -1;
    while (qclu != 0) {
      const int p = __ffs(qclu) - 1;
      qclu &= qclu - 1;
      if (q_tn[p][tid] <= fminf(h.best, tmax)) {
        code = q_code[p][tid] >> 1;
        break;
      }
    }
    const bool want = code >= 0;
    const unsigned int wmask = __ballot_sync(kFull, want);
    if (wmask != 0) {
      const int nwant = __popc(wmask);
      const bool coop = (float)nwant * coop_cost < (float)s.tcap;
      if (STATS) {
        ++passes;
        wanting += nwant;
        if (coop) coop_pairs += nwant;
      }
      int c = 0, inst = -1, cnt = 0, bk = -1;
      ClusterRay r = {};
      if (want)
        r = cluster_ray<INST>(s, code, ox, oy, oz, dx, dy, dz, c, inst, cnt);
      const size_t base = (size_t)c * s.tcap;
      if (coop) {
        if (want) {
          stage[0][tid] = make_float4(r.dx, r.dy, r.dz, r.tau);
          stage[1][tid] = make_float4(r.ocx, r.ocy, r.ocz, tmin);
          stage[2][tid] = make_float4(r.mx, r.my, r.mz, tmax);
          stage[3][tid] = make_float4(h.best, __int_as_float(c),
                                      __int_as_float(cnt), 0.f);
        }
        __syncwarp();
        for (unsigned int rem = wmask; rem != 0; rem &= rem - 1) {
          const int src = __ffs(rem) - 1;
          const float4 s0 = stage[0][wbase + src];
          const float4 s1 = stage[1][wbase + src];
          const float4 s2 = stage[2][wbase + src];
          const float4 s3 = stage[3][wbase + src];
          const ClusterRay lr = {s0.x, s0.y, s0.z, s1.x, s1.y,
                                 s1.z, s2.x, s2.y, s2.z, s0.w};
          const size_t lbase = (size_t)__float_as_int(s3.y) * s.tcap;
          const int lcnt = __float_as_int(s3.z);
          float tb = __int_as_float(0x7f800000), ub = 0.f, vb = 0.f;
          int ib = kNoIndex;
          for (int j = lane; j < lcnt; j += 32) {
            float t, u, v;
            if (tri_test(s, lbase, j, lr, s1.w, s2.w, s3.x, qmask, k, t, u,
                         v) &&
                t < tb) {
              tb = t; ub = u; vb = v; ib = j;
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const float ot = __shfl_xor_sync(kFull, tb, off);
            const int oi = __shfl_xor_sync(kFull, ib, off);
            if (ot < tb || (ot == tb && oi < ib)) {
              tb = ot;
              ib = oi;
            }
          }
          if (ib != kNoIndex) {               // warp-uniform
            const float u = __shfl_sync(kFull, ub, ib & 31);
            const float v = __shfl_sync(kFull, vb, ib & 31);
            if (lane == src) {
              h.best = tb; h.u = u; h.v = v; bk = ib;
            }
          }
        }
        __syncwarp();                         // stage is rewritten next pass
      } else if (want) {
#pragma unroll 2
        for (int j = 0; j < cnt; ++j) {
          float t, u, v;
          if (tri_test(s, base, j, r, tmin, tmax, h.best, qmask, k, t, u,
                       v)) {
            h.best = t; h.u = u; h.v = v; bk = j;
          }
        }
      }
      if (want) {
        h.tri_tests += cnt;
        if (bk >= 0) take_winner<INST>(s, base, bk, inst, h);
        if (ANY && h.prim >= 0) {             // retire: no pushes, no drops
          qclu = 0;
          qint = 0;
          sp = 0;
        }
      }
    }

    // ---- the queue has drained: internal children, far to near
    if (qclu == 0) push_inner();
  }

  if (i < n) {
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
  pops = __reduce_add_sync(kFull, pops);
  drops = __reduce_add_sync(kFull, drops);
  if (lane == 0) {
    if (pops) atomicAdd(&counters[0], (unsigned long long)pops);
    if (drops) atomicAdd(&counters[1], (unsigned long long)drops);
    if (STATS) {                              // warp-uniform sums
      atomicAdd(&warp_stats[0], passes);
      atomicAdd(&warp_stats[1], wanting);
      atomicAdd(&warp_stats[2], coop_pairs);
    }
  }
}

struct Launch {
  int grid;
  cudaStream_t st;
  const float *o, *d, *t0, *t1;
  int n;
  Scene s;
  int qmask, kstack;
  Consts k;
  float* fout;
  int* iout;
  unsigned long long *cnt, *stats;
};

template <int KCAP, bool INST, bool ANY>
void launch_stats(const Launch& a) {
  if (a.stats)
    cluster_cast_kernel<KCAP, INST, ANY, true><<<a.grid, kThreads, 0, a.st>>>(
        a.o, a.d, a.t0, a.t1, a.n, a.s, a.qmask, a.kstack, a.k, a.fout,
        a.iout, a.cnt, a.stats);
  else
    cluster_cast_kernel<KCAP, INST, ANY, false><<<a.grid, kThreads, 0, a.st>>>(
        a.o, a.d, a.t0, a.t1, a.n, a.s, a.qmask, a.kstack, a.k, a.fout,
        a.iout, a.cnt, nullptr);
}

template <int KCAP>
void launch_kcap(bool inst, bool any, const Launch& a) {
  if (inst)
    any ? launch_stats<KCAP, true, true>(a) : launch_stats<KCAP, true, false>(a);
  else
    any ? launch_stats<KCAP, false, true>(a)
        : launch_stats<KCAP, false, false>(a);
}

}  // namespace

// C entry, bound with ctypes.  Launches on `stream`, does not synchronize
// and allocates nothing; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a stack capacity it was not compiled for.
// warp_stats: null, or (3,) counters [passes, wanting lanes, cooperative
// pairs] added to by the launch.
extern "C" int mrt_cluster_cast(
    const float* origin, const float* direction, const float* t_min,
    const float* t_max, int n, const float* node_box, const int* node_child,
    const int* node_axis, const float* tri, const int* tri_prim,
    const int* tri_layers, const float* cl_anchor, const int* cl_count,
    int tcap, const int* inst_cbase, const int* iprim, const float* iinv,
    const float* ifwd, int query_mask, int any_hit, int kstack, int kcap,
    float det_eps, float bary_lo, float bary_hi, float inv_eps, float big,
    float t_miss, float* fout, int* iout, unsigned long long* counters,
    unsigned long long* warp_stats, void* stream) {
  const Scene s = {node_box,  node_child, node_axis, tri,        tri_prim,
                   tri_layers, cl_anchor, cl_count,  tcap,       inst_cbase,
                   iprim,      iinv,      ifwd};
  const Consts k = {det_eps, bary_lo, bary_hi, inv_eps, big, t_miss};
  const Launch a = {(n + kThreads - 1) / kThreads,
                    static_cast<cudaStream_t>(stream),
                    origin, direction, t_min, t_max, n, s, query_mask, kstack,
                    k, fout, iout, counters, warp_stats};
  const bool inst = inst_cbase != nullptr;
  const bool any = any_hit != 0;
  if (kstack > kcap) return (int)cudaErrorInvalidValue;
  switch (kcap) {
    case 64:
      launch_kcap<64>(inst, any, a);
      break;
    case 128:
      launch_kcap<128>(inst, any, a);
      break;
    case 256:
      launch_kcap<256>(inst, any, a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

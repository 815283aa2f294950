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
// What each ray computes (the plain version, kernels/traverse_pallas.py::
// wide_cast_plain, does the same things in the same order):
//   * the root is pushed unconditionally; a dead ray (t_max < t_min) tests
//     against cap = -BIG and so opens nothing.  Each pop slab-tests the K
//     (2 or 8) children against cap = min(best, t_max) with the safe
//     inverse direction; an absent child has code -1 and is skipped by its
//     code, never by a NaN box (fminf/fmaxf drop NaN operands);
//   * children are taken front-to-back by the ray's own direction sign on
//     the node's split axis: hit leaves near-to-far, each intersected if
//     its entry distance is still <= min(best, t_max); then hit internal
//     children are pushed far-to-near, and a push that does not fit kstack
//     is dropped and counted in stack_drops (the JAX kernel drops past 64
//     silently);
//   * a leaf runs the classic Moller-Trumbore of traverse_pallas.py:754-789
//     (|det| >= eps, u in [0,1], v >= 0, u+v <= 1, t in [t_min, t_max], no
//     barycentric band) over its triangles in index order with a strictly
//     closer update, so the lower slot wins a tie; the winner's slot is
//     leaf*4 + k.  (layers & query_mask) == 0 rejects a triangle (-1: no
//     mask);
//   * quantized nodes decode each child bound as anchor + q * scale in
//     float32 (kernels/wide.py::WideScene.quantized), a box that contains
//     the exact one, so the traversal visits a superset and the hits stay;
//   * any-hit retires the ray after the leaf that produced a hit.
//
// What bounds it.  The work is node tests: on the 1M-triangle 1080p frame
// (8-wide) a ray pops 7.06 nodes, 8 slab tests each, against 3.9 triangle
// tests, so 87% of the 0.10 ms operations bound is the pop loop.  The first
// design, one thread per ray testing each leaf inside its child loop at
// the pop that found it, ran 7x above that bound (0.715 ms on an H100 80GB
// HBM3 at 700 W; PERF.md): its pop loop kept 81% of the lanes busy, but at
// each child slot only the lanes with a live leaf there tested one, 12% of
// the lanes in each of its leaf passes.  B1's schedule, which postpones
// every leaf until each lane of the warp has one, made that 47% but halved
// the pop loop's (46%), and the pop loop is most of the work: within 3% of
// the first design.  So each pass of the warp has two phases:
//   * node phase: each lane with no queued leaf and a non-empty stack pops
//     a node, slab-tests its children pair by pair as their boxes arrive,
//     and writes the hit ones, near-to-far, with their entry distances, to
//     its queue of K slots in shared memory; the warp keeps popping until
//     kLeafBatch = 4 lanes have a leaf queued or no lane can pop (measured
//     against 1 to 32: 71% of the lanes pop, 26% test).  A node's
//     internal children are pushed once its queued leaves are done
//     (pushing at pop time would change stack_drops under any-hit and a
//     small stack); a node with no hit leaf pushes them at once;
//   * leaf phase: each lane takes its nearest queued leaf that passes the
//     cull.  With at most kCoopLeaves = 16 such lanes the warp tests them
//     cooperatively, in rounds of 8 leaves: the 4 lanes of a group test one
//     triangle each against the ray's best at the pass's start, and two
//     xor-shuffle rounds reduce (t, index) to the least t and, among equal
//     t, the least index, the serial loop's winner.  With more, each lane
//     loops over its own leaf.  Both run one test, tri_hit().
// Every record comes in 16-byte loads through the read-only path (a node's
// child boxes, 12 x 16 bytes 8-wide, 3 binary, and codes; its q_lo / q_hi
// rows when quantized; a leaf row, 9 x 16 bytes, and its layers); the
// wrapper checks that every table is 16-byte aligned.  __launch_bounds__
// keeps 8 blocks per SM: 64 registers and about 90 bytes of spills, measured
// faster than 4 to 7 blocks (without a cap the kernel takes 80 registers,
// 6 blocks, 8% slower).  In one process on that card the kernel takes
// 0.514 ms (8-wide), 0.412 (8-wide any-hit), 0.536 (binary) and 0.708
// (quantized) against the first design's 0.715, 0.572, 0.615 and 0.858.
// What bounds it now is still not the operations, 5x below its time: each
// pass waits on its dependent node or leaf fetch, and 29% of the lanes sit
// out each node pass (done, or holding a queued leaf).  Prefetching into
// L1 at each pop the node a lane pops next measured 4-11% slower, its
// nearest leaf within 1%; keeping the stack top in a register 1-2% slower
// (one more register under the cap).
//
// No tensor cores.  A slab test is 6 subtractions and 6 products per child,
// and a triangle test a chain of crosses and dots; as a matrix product it
// would run in TF32, which keeps 10 mantissa bits, and split-TF32 sums are
// not bit-exact: the kernel must equal its plain version bit for bit.
//
// Numerics.  Built with -fmad=false: the plain version evaluates the same
// expressions in the same order with separately rounded IEEE operations,
// so hits and counters agree bit for bit on one card.  The f32 constants
// come in as arguments from the same Python values.
//
// Counters: tri_tests per ray (a leaf's real triangle count per visit);
// pops and stack_drops per warp, then one atomic each per warp.  With a
// non-null warp_stats the launch also counts, per warp: node-phase passes,
// popping lanes summed over them, leaf-phase passes, wanting lanes summed
// over them, and the lanes whose leaf was tested cooperatively, added with
// one atomic each per warp at exit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// 8 resident blocks per SM cap the kernel at 64 registers: measured faster
// than 4-7 on the H100 (see the note)
constexpr int kMinBlocks = 8;
// the warp leaves its node phase for a leaf phase once this many lanes
// have a leaf queued (or no lane can pop): measured against 1-32
constexpr int kLeafBatch = 4;
// a leaf phase with at most this many wanting lanes tests cooperatively:
// measured against 4-32
constexpr int kCoopLeaves = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLeafCap = 4;
constexpr int kLeafF4 = kLeafCap * 9 / 4;     // a leaf row in float4s
constexpr int kGroups = 32 / kLeafCap;        // leaves per cooperative round
constexpr int kNoIndex = kLeafCap;            // no hit in the reduction

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

// The codes of wide node `node`'s K children, in 16-byte (8-wide) or
// 8-byte (binary) loads.
template <int K>
__device__ __forceinline__ void node_codes(const Scene& s, int node,
                                           int code[K]) {
  if constexpr (K == 8) {
    const int4* p = reinterpret_cast<const int4*>(s.node_child) +
                    (size_t)node * 2;
    const int4 a = __ldg(p), b = __ldg(p + 1);
    code[0] = a.x; code[1] = a.y; code[2] = a.z; code[3] = a.w;
    code[4] = b.x; code[5] = b.y; code[6] = b.z; code[7] = b.w;
  } else {
    const int2 a = __ldg(reinterpret_cast<const int2*>(s.node_child) + node);
    code[0] = a.x; code[1] = a.y;
  }
}

// A quantized node's decode inputs: anchor, scale, q_lo and q_hi rows
// (the rows in two 16-byte loads each).
struct QNode {
  float a[3], f[3];
  int lo[8], hi[8];
};

__device__ __forceinline__ QNode quantized_node(const Scene& s, int node) {
  QNode q;
  const float* an = s.q_anchor + 3 * (size_t)node;
  const float* sc = s.q_scale + 3 * (size_t)node;
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    q.a[x] = __ldg(an + x);
    q.f[x] = __ldg(sc + x);
  }
  const int4* lp = reinterpret_cast<const int4*>(s.q_lo) + (size_t)node * 2;
  const int4* hp = reinterpret_cast<const int4*>(s.q_hi) + (size_t)node * 2;
  const int4 l0 = __ldg(lp), l1 = __ldg(lp + 1);
  const int4 h0 = __ldg(hp), h1 = __ldg(hp + 1);
  q.lo[0] = l0.x; q.lo[1] = l0.y; q.lo[2] = l0.z; q.lo[3] = l0.w;
  q.lo[4] = l1.x; q.lo[5] = l1.y; q.lo[6] = l1.z; q.lo[7] = l1.w;
  q.hi[0] = h0.x; q.hi[1] = h0.y; q.hi[2] = h0.z; q.hi[3] = h0.w;
  q.hi[4] = h1.x; q.hi[5] = h1.y; q.hi[6] = h1.z; q.hi[7] = h1.w;
  return q;
}

// The boxes of children c and c+1 of wide node `node`, [min.xyz,
// max.xyz]: exact, in three 16-byte loads; or decoded from `qn` as
// anchor + q * scale.
template <int K, bool Q>
__device__ __forceinline__ void pair_boxes(const Scene& s, int node, int c,
                                           const QNode& qn, float b[2][6]) {
  if constexpr (Q) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        b[e][x] = qn.a[x] + (float)((qn.lo[c + e] >> (8 * x)) & 255) * qn.f[x];
        b[e][3 + x] =
            qn.a[x] + (float)((qn.hi[c + e] >> (8 * x)) & 255) * qn.f[x];
      }
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(s.node_box) +
                      (size_t)node * (K * 6 / 4) + 3 * c / 2;
    const float4 v0 = __ldg(p), v1 = __ldg(p + 1), v2 = __ldg(p + 2);
    b[0][0] = v0.x; b[0][1] = v0.y; b[0][2] = v0.z;
    b[0][3] = v0.w; b[0][4] = v1.x; b[0][5] = v1.y;
    b[1][0] = v1.z; b[1][1] = v1.w; b[1][2] = v2.x;
    b[1][3] = v2.y; b[1][4] = v2.z; b[1][5] = v2.w;
  }
}

// Triangle g = [v0, e1, e2]: the classic Moller-Trumbore test, true with
// t, u, v when it is a valid hit closer than `best`.  Every leaf test, the
// serial loop and the cooperative one, runs this function.
__device__ __forceinline__ bool tri_hit(
    const float g[9], float ox, float oy, float oz, float dx, float dy,
    float dz, float tmin, float tmax, float best, const Consts& k, float& t,
    float& u, float& v) {
  const float e1x = g[3], e1y = g[4], e1z = g[5];
  const float e2x = g[6], e2y = g[7], e2z = g[8];
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool ok = fabsf(det) >= k.det_eps;
  const float idet = 1.f / (ok ? det : 1.f);
  const float tvx = ox - g[0];
  const float tvy = oy - g[1];
  const float tvz = oz - g[2];
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * idet;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  v = (dx * qvx + dy * qvy + dz * qvz) * idet;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * idet;
  return ok && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f &&
         t >= tmin && t <= tmax && t < best;
}

// One leaf visit by one lane: its triangles in index order with a strictly
// closer update of `h`.  The leaf's 144-byte row comes in nine 16-byte
// loads (unused slots are zeros).
__device__ __forceinline__ void intersect_leaf(
    const Scene& s, int leaf, float ox, float oy, float oz, float dx,
    float dy, float dz, float tmin, float tmax, int qmask, const Consts& k,
    Hit& h) {
  const int cnt = __ldg(s.leaf_count + leaf);
  const float4* row = reinterpret_cast<const float4*>(s.leaf_tri) +
                      (size_t)leaf * kLeafF4;
  float f[kLeafCap * 9];
#pragma unroll
  for (int q = 0; q < kLeafF4; ++q) {
    const float4 v = __ldg(row + q);
    f[4 * q] = v.x; f[4 * q + 1] = v.y; f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
  int lay[kLeafCap] = {-1, -1, -1, -1};
  if (qmask != -1) {
    const int4 l = __ldg(reinterpret_cast<const int4*>(s.slot_layers) + leaf);
    lay[0] = l.x; lay[1] = l.y; lay[2] = l.z; lay[3] = l.w;
  }
#pragma unroll
  for (int j = 0; j < kLeafCap; ++j) {
    if (j >= cnt) break;
    if ((lay[j] & qmask) == 0) continue;
    float t, u, v;
    if (tri_hit(f + 9 * j, ox, oy, oz, dx, dy, dz, tmin, tmax, h.best, k, t,
                u, v)) {
      h.best = t;
      h.u = u;
      h.v = v;
      h.slot = kLeafCap * leaf + j;
    }
  }
  h.tri_tests += cnt;
}

template <int K, bool Q, bool ANY, int KCAP, bool STATS>
__global__ void __launch_bounds__(kThreads, kMinBlocks) wide_cast_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ t_min, const float* __restrict__ t_max, int n,
    Scene s, int qmask, int kstack, Consts k, float* __restrict__ fout,
    int* __restrict__ iout, unsigned long long* __restrict__ counters,
    unsigned long long* __restrict__ warp_stats) {
  // per lane: its node's hit children in near-to-far slots
  __shared__ int q_code[K][kThreads];
  __shared__ float q_tn[K][kThreads];
  // the cooperative leaf test's copy of each wanting lane's ray, by rank
  __shared__ float4 stage[3][kThreads];
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
  const float lim = tmax >= tmin ? tmax : -k.big;   // dead: cap = -BIG
  const float ix = safe_inv(dx, k.inv_eps);
  const float iy = safe_inv(dy, k.inv_eps);
  const float iz = safe_inv(dz, k.inv_eps);
  Hit h = {k.big, 0.f, 0.f, -1, 0};
  unsigned int pops = 0, drops = 0;
  unsigned long long node_passes = 0, popping = 0, leaf_passes = 0,
                     wanting = 0, coop_lanes = 0;
  int stack[KCAP];
  int sp = i < n ? 1 : 0;
  stack[0] = 0;                               // root, pushed unconditionally
  unsigned int qleaf = 0, qint = 0;           // queued leaf / inner slots
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

  while (__any_sync(kFull, qleaf != 0 || sp > 0)) {
    // ---- node phase: lanes with no queued leaf pop nodes until each lane
    // has a leaf queued or an empty stack
    for (;;) {
      const bool pop = qleaf == 0 && sp > 0;
      const unsigned int pmask = __ballot_sync(kFull, pop);
      if (pmask == 0 ||
          __popc(__ballot_sync(kFull, qleaf != 0)) >= kLeafBatch)
        break;
      if (STATS) {
        ++node_passes;
        popping += __popc(pmask);
      }
      if (!pop) continue;
      const int node = stack[--sp];
      ++pops;
      const float cap = fminf(h.best, lim);
      const int axis = __ldg(s.node_axis + node);
      int code[K];
      node_codes<K>(s, node, code);
      QNode qn;
      if constexpr (Q) qn = quantized_node(s, node);
      const bool fwd = (axis == 0 ? dx : (axis == 1 ? dy : dz)) >= 0.f;
      // child c's slab test against its box b; a hit goes to the queue
      auto child = [&](int c, const float b[6]) {
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
        if (code[c] >= 0 && tfar >= fmaxf(tnear, 0.f) && tnear <= cap) {
          const int p = fwd ? c : K - 1 - c;  // slot in near-to-far order
          q_code[p][tid] = code[c];
          if (code[c] & 1) {
            q_tn[p][tid] = tnear;
            qleaf |= 1u << p;
          } else {
            qint |= 1u << p;
          }
        }
      };
#pragma unroll
      for (int c = 0; c < K; c += 2) {
        float b[2][6];
        pair_boxes<K, Q>(s, node, c, qn, b);
        child(c, b[0]);
        child(c + 1, b[1]);
      }
      if (qleaf == 0) push_inner();
    }

    // ---- leaf phase: the nearest queued leaf that passes the cull
    int leaf = -1;
    while (qleaf != 0) {
      const int p = __ffs(qleaf) - 1;
      qleaf &= qleaf - 1;
      if (q_tn[p][tid] <= fminf(h.best, lim)) {
        leaf = q_code[p][tid] >> 1;
        break;
      }
    }
    const unsigned int wmask = __ballot_sync(kFull, leaf >= 0);
    const int nwant = __popc(wmask);
    if (STATS && nwant != 0) {
      ++leaf_passes;
      wanting += nwant;
      if (nwant <= kCoopLeaves) coop_lanes += nwant;
    }
    if (nwant != 0 && nwant <= kCoopLeaves) {
      // cooperative: the leaf of the r-th wanting lane is tested by lanes
      // 4r' .. 4r'+3 of round r / 8 (r' = r % 8), triangle j by lane 4r'+j
      // against the ray's best at the pass's start; the least (t, j) is
      // the serial loop's winner
      const int rank = __popc(wmask & ((1u << lane) - 1));
      if (leaf >= 0) {
        stage[0][wbase + rank] = make_float4(ox, oy, oz, tmin);
        stage[1][wbase + rank] = make_float4(dx, dy, dz, tmax);
        stage[2][wbase + rank] =
            make_float4(h.best, __int_as_float(leaf), 0.f, 0.f);
      }
      __syncwarp();
      const int j = lane & (kLeafCap - 1);
      for (int r0 = 0; r0 < nwant; r0 += kGroups) {
        const int r = r0 + lane / kLeafCap;
        float tb = __int_as_float(0x7f800000), ub = 0.f, vb = 0.f;
        int ib = kNoIndex, cnt = 0;
        if (r < nwant) {
          const float4 ra = stage[0][wbase + r], rb = stage[1][wbase + r];
          const float4 rc = stage[2][wbase + r];
          const int lf = __float_as_int(rc.y);
          cnt = __ldg(s.leaf_count + lf);
          if (j < cnt &&
              (qmask == -1 ||
               (__ldg(s.slot_layers + kLeafCap * lf + j) & qmask) != 0)) {
            const float* f = s.leaf_tri + ((size_t)lf * kLeafCap + j) * 9;
            float g[9];
#pragma unroll
            for (int q = 0; q < 9; ++q) g[q] = __ldg(f + q);
            float t, u, v;
            if (tri_hit(g, ra.x, ra.y, ra.z, rb.x, rb.y, rb.z, ra.w, rb.w,
                        rc.x, k, t, u, v)) {
              tb = t; ub = u; vb = v; ib = j;
            }
          }
        }
#pragma unroll
        for (int off = 1; off < kLeafCap; off <<= 1) {
          const float ot = __shfl_xor_sync(kFull, tb, off);
          const int oi = __shfl_xor_sync(kFull, ib, off);
          if (ot < tb || (ot == tb && oi < ib)) {
            tb = ot;
            ib = oi;
          }
        }
        const int wl = (lane & ~(kLeafCap - 1)) | (ib & (kLeafCap - 1));
        ub = __shfl_sync(kFull, ub, wl);
        vb = __shfl_sync(kFull, vb, wl);
        // each wanting lane of this round reads its group's result
        const bool mine = leaf >= 0 && rank >= r0 && rank < r0 + kGroups;
        const int src = mine ? kLeafCap * (rank - r0) : lane;
        tb = __shfl_sync(kFull, tb, src);
        ib = __shfl_sync(kFull, ib, src);
        ub = __shfl_sync(kFull, ub, src);
        vb = __shfl_sync(kFull, vb, src);
        cnt = __shfl_sync(kFull, cnt, src);
        if (mine) {
          h.tri_tests += cnt;
          if (ib != kNoIndex) {
            h.best = tb; h.u = ub; h.v = vb; h.slot = kLeafCap * leaf + ib;
          }
        }
      }
      __syncwarp();                           // stage is rewritten next pass
    } else if (leaf >= 0) {
      intersect_leaf(s, leaf, ox, oy, oz, dx, dy, dz, tmin, tmax, qmask, k,
                     h);
    }
    if (ANY && leaf >= 0 && h.slot >= 0) {    // retire: no pushes, no drops
      qleaf = 0;
      qint = 0;
      sp = 0;
    }

    // ---- the queue has drained: internal children, far to near
    if (qleaf == 0) push_inner();
  }

  if (i < n) {
    const bool found = h.slot >= 0;
    fout[i] = found ? h.best : k.t_miss;
    fout[n + i] = found ? h.u : 0.f;
    fout[2 * n + i] = found ? h.v : 0.f;
    iout[i] = h.slot;
    iout[n + i] = h.tri_tests;
  }
  // every thread of the warp reaches here: reduce, then one atomic per warp
  pops = __reduce_add_sync(kFull, pops);
  drops = __reduce_add_sync(kFull, drops);
  if (lane == 0) {
    if (pops) atomicAdd(&counters[0], (unsigned long long)pops);
    if (drops) atomicAdd(&counters[1], (unsigned long long)drops);
    if (STATS) {                              // warp-uniform sums
      atomicAdd(&warp_stats[0], node_passes);
      atomicAdd(&warp_stats[1], popping);
      atomicAdd(&warp_stats[2], leaf_passes);
      atomicAdd(&warp_stats[3], wanting);
      atomicAdd(&warp_stats[4], coop_lanes);
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

template <int K, bool Q, bool ANY, int KCAP>
void launch_stats(const Launch& a) {
  if (a.stats)
    wide_cast_kernel<K, Q, ANY, KCAP, true><<<a.grid, kThreads, 0, a.st>>>(
        a.o, a.d, a.t0, a.t1, a.n, a.s, a.qmask, a.kstack, a.k, a.fout,
        a.iout, a.cnt, a.stats);
  else
    wide_cast_kernel<K, Q, ANY, KCAP, false><<<a.grid, kThreads, 0, a.st>>>(
        a.o, a.d, a.t0, a.t1, a.n, a.s, a.qmask, a.kstack, a.k, a.fout,
        a.iout, a.cnt, nullptr);
}

template <int K, bool Q, bool ANY>
int launch_kcap(int kcap, const Launch& a) {
  switch (kcap) {
    case 64: launch_stats<K, Q, ANY, 64>(a); return 0;
    case 128: launch_stats<K, Q, ANY, 128>(a); return 0;
    case 256: launch_stats<K, Q, ANY, 256>(a); return 0;
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
// it was not compiled for.  warp_stats: null, or (4,) counters [node-phase
// passes, popping lanes, leaf-phase passes, wanting lanes] added to by the
// launch.  Every table must be 16-byte aligned (the wrapper checks).
extern "C" int mrt_wide_cast(
    const float* origin, const float* direction, const float* t_min,
    const float* t_max, int n, const float* node_box, const int* node_child,
    const int* node_axis, const float* q_anchor, const float* q_scale,
    const int* q_lo, const int* q_hi, const float* leaf_tri,
    const int* leaf_count, const int* slot_layers, int branching,
    int quantized, int query_mask, int any_hit, int kstack, int kcap,
    float det_eps, float inv_eps, float big, float t_miss, float* fout,
    int* iout, unsigned long long* counters, unsigned long long* warp_stats,
    void* stream) {
  const Scene s = {node_box, node_child, node_axis, q_anchor, q_scale,
                   q_lo,     q_hi,       leaf_tri,  leaf_count, slot_layers};
  const Launch a = {(n + kThreads - 1) / kThreads,
                    static_cast<cudaStream_t>(stream),
                    origin, direction, t_min, t_max, n, s, query_mask, kstack,
                    {det_eps, inv_eps, big, t_miss},
                    fout, iout, counters, warp_stats};
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

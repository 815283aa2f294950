// tlas_refit.cu — the refit of the instanced cluster TLAS after an instance
// move (kernels/cluster_tlas.py::set_transforms), in one launch.  Hopper,
// sm_90a.
//
// Replaces no Pallas kernel: the JAX package refits its pair tree in jnp
// (messyerraytracer_tpu/kernels/cluster_tlas.py, set_transforms), and the
// port's plain version (cluster_tlas.py::_refit_pairs_plain) is about
// 1,800 eager PyTorch ops a move: 8 box corners, one gather-min-max sweep
// per tree level (21 on the headline scene), the child-slot regather.
// Each op is a launch of a few microseconds of work, so the move was bound
// by the host's launches, not by the card.
//
// What one launch computes, from the host's (Ni, 33) instance rows
// [forward R|t (12) | iinv (12) | ifwd (9)] (float32, bit for bit the
// host's float64 inverse rounded):
//   * threads < Ni copy the rows' iinv and ifwd into their own tables;
//   * threads over the W x 8 child slots write NaN where child_node < 0;
//   * one thread per leaf of the pair tree pushes each of its pairs'
//     object-space boxes through the pair's instance rows (8 corners, the
//     plain version's float32 operations in its order: no FMA, -fmad=false)
//     and takes min / max over the corners and the leaf's slots;
//   * then it walks up the tree through the build-time parent table.  Each
//     node has an arrival counter: a thread that finishes a node makes its
//     writes visible (__threadfence) and adds 1 to its parent's counter;
//     the first to arrive stops, the second computes the parent's box from
//     its two children (left node + 1, right left_first[node], min / max
//     in that argument order), sets the counter back to 0 for the next
//     launch, and goes on up.  Every node's finisher writes the node's box
//     to aabb_min / aabb_max and, through the build-time node -> slot
//     table, to its slot of node_box.
//
// Min and max are torch.minimum / torch.maximum as ATen computes them on
// the card: NaN (0x7fc00000) if either operand is NaN, else fminf / fmaxf.
// With the plain version's argument order that gives its bits on the card,
// signed zeros included.
//
// What bounds it.  The launch reads the rows (28 KB at 215 instances), the
// pairs' object boxes, instances and slot order (0.73 MB at 22,744 pairs),
// the topology (0.55 MB at 45,487 nodes and 7,315 wide nodes) and writes
// the node boxes (1.09 MB) and node_box (1.40 MB): about 3.8 MB, 1.1 us at
// 3.35 TB/s.  The walk up is a chain of dependent steps as long as the
// tree is deep (21 on the headline scene), each an atomic and two loads
// from L2, so the launch's latency, not its bytes, is what it costs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 33;        // forward (12) | iinv (12) | ifwd (9)

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// torch.minimum / torch.maximum on the card (ATen's CUDA kernels)
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? qnan() : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? qnan() : fmaxf(a, b);
}

struct Tables {
  const float* rows;
  int n_inst;
  const float* obj_min;
  const float* obj_max;
  const int* pair_inst;
  const int* tri_order;
  const int* left_first;
  const int* count;
  const int* parent;
  const int* node_slot;
  int n_nodes;
  const int* child_node;
  int n_slots;
  int* arrivals;
  float* aabb_min;
  float* aabb_max;
  float* node_box;
  float* iinv;
  float* ifwd;
};

// the world box of pair p under its instance's forward rows: the corners
// in the plain version's order (x outer, z inner), min / max from +-inf
__device__ void pair_box(const Tables& t, int p, float lo[3], float hi[3]) {
  const float* m = t.rows + t.pair_inst[p] * kRow;
  const float l[3] = {t.obj_min[3 * p], t.obj_min[3 * p + 1],
                      t.obj_min[3 * p + 2]};
  const float h[3] = {t.obj_max[3 * p], t.obj_max[3 * p + 1],
                      t.obj_max[3 * p + 2]};
  for (int r = 0; r < 3; ++r) {
    lo[r] = __int_as_float(0x7f800000);      // +inf
    hi[r] = -lo[r];
  }
  for (int cx = 0; cx < 2; ++cx)
    for (int cy = 0; cy < 2; ++cy)
      for (int cz = 0; cz < 2; ++cz) {
        const float c0 = cx ? h[0] : l[0];
        const float c1 = cy ? h[1] : l[1];
        const float c2 = cz ? h[2] : l[2];
        for (int r = 0; r < 3; ++r) {
          const float w = m[4 * r] * c0 + m[4 * r + 1] * c1
                          + m[4 * r + 2] * c2 + m[4 * r + 3];
          lo[r] = tmin(lo[r], w);
          hi[r] = tmax(hi[r], w);
        }
      }
}

__device__ void store_node(const Tables& t, int node, const float lo[3],
                           const float hi[3]) {
  for (int k = 0; k < 3; ++k) {
    t.aabb_min[3 * node + k] = lo[k];
    t.aabb_max[3 * node + k] = hi[k];
  }
  const int s = t.node_slot[node];
  if (s >= 0) {
    for (int k = 0; k < 3; ++k) {
      t.node_box[6 * s + k] = lo[k];
      t.node_box[6 * s + 3 + k] = hi[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads) tlas_refit_kernel(Tables t) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < t.n_inst) {
    const float* r = t.rows + i * kRow;
    for (int k = 0; k < 12; ++k) t.iinv[12 * i + k] = r[12 + k];
    for (int k = 0; k < 9; ++k) t.ifwd[9 * i + k] = r[24 + k];
  }
  if (i < t.n_slots && t.child_node[i] < 0) {
    for (int k = 0; k < 6; ++k) t.node_box[6 * i + k] = qnan();
  }
  if (i >= t.n_nodes) return;
  const int cnt = t.count[i];
  if (cnt == 0) return;

  // the leaf: its first pair's box, then min / max over the others
  float lo[3], hi[3], plo[3], phi[3];
  const int first = t.left_first[i];
  pair_box(t, t.tri_order[first], lo, hi);
  for (int s = first + 1; s < first + cnt; ++s) {
    pair_box(t, t.tri_order[s], plo, phi);
    for (int k = 0; k < 3; ++k) {
      lo[k] = tmin(lo[k], plo[k]);
      hi[k] = tmax(hi[k], phi[k]);
    }
  }

  // up the tree: the second child to arrive finishes its parent
  int node = i;
  while (true) {
    store_node(t, node, lo, hi);
    const int p = t.parent[node];
    if (p < 0) break;
    __threadfence();
    if (atomicAdd(t.arrivals + p, 1) == 0) break;
    __threadfence();
    t.arrivals[p] = 0;
    const int a = p + 1, b = t.left_first[p];
    for (int k = 0; k < 3; ++k) {
      lo[k] = tmin(__ldcg(t.aabb_min + 3 * a + k),
                   __ldcg(t.aabb_min + 3 * b + k));
      hi[k] = tmax(__ldcg(t.aabb_max + 3 * a + k),
                   __ldcg(t.aabb_max + 3 * b + k));
    }
    node = p;
  }
}

}  // namespace

// C entry: every pointer is a contiguous device tensor of the sizes the
// wrapper (cluster_tlas.py::refit_pairs_cuda) checks; launches on
// ``stream`` and returns cudaGetLastError().
extern "C" int mrt_tlas_refit(
    const float* rows, int n_inst, const float* obj_min, const float* obj_max,
    const int* pair_inst, const int* tri_order, const int* left_first,
    const int* count, const int* parent, const int* node_slot, int n_nodes,
    const int* child_node, int n_slots, int* arrivals, float* aabb_min,
    float* aabb_max, float* node_box, float* iinv, float* ifwd,
    void* stream) {
  const Tables t = {rows,       n_inst,    obj_min,   obj_max,  pair_inst,
                    tri_order,  left_first, count,    parent,   node_slot,
                    n_nodes,    child_node, n_slots,  arrivals, aabb_min,
                    aabb_max,   node_box,  iinv,      ifwd};
  int n = n_nodes > n_slots ? n_nodes : n_slots;
  n = n > n_inst ? n : n_inst;
  if (n > 0) {
    tlas_refit_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(t);
  }
  return static_cast<int>(cudaGetLastError());
}

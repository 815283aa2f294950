// morton_keys.cu — kernel M1: the ray sort keys of dispatch/morton.py on a
// card in one launch.  Hopper, sm_90a.
//
// Replaces no Pallas kernel: the JAX package computes these keys in jnp
// (messyerraytracer_tpu/dispatch/morton.py: _keys_6d, ray_6d_morton,
// ray_direction_morton).  Added to make a keyed sort's keys one launch: the
// port's plain version (dispatch/morton.py, _keys_6d) runs each step as an
// eager int64 PyTorch op, 102 launches for an octant-major batch (104 with
// live flags), each writing and reading back a whole int64 array.
//
// What one launch computes, one thread a ray, in the plain version's float32
// steps and order.  Each float32 step is the correctly rounded operation
// (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn; built with -fmad=false);
// clamps pass NaN through and otherwise take fmaxf / fminf, as ATen's CUDA
// clamp kernels do; a float becomes an integer by the static_cast to a 64-bit
// integer that PyTorch's .to(torch.int64) compiles to.  So the keys are the
// plain version's bit for bit, for non-finite inputs too:
//   unit box     u_c = (o_c - lo_c) / clamp_min(hi_c - lo_c, 1e-12)
//   quantize     q(x, s) = (int64) (clamp(x, 0, 1) * s)
//   Morton code  morton_spread_10 of each axis, merged x << 2 | y << 1 | z
//   kind 0, octant-major with b = dir_bits in 1..9, m = 28 - 3 b:
//                qd_c = min(q((d_c + 1) * 0.5, 2^b), 2^b - 1),
//                key = morton(qd) << m | morton(q(u, 511)) >> (27 - m)
//   kind 1, origin-major: key = morton(q(u, 511)) << 3 | octant(d), the
//                x sign high (a -0 is not negative, nor is NaN)
//   kind 2, direction: key = morton(q((d + 1) * 0.5, 1023))
// A ray whose live flag is false gets DEAD_KEY (0x7FFFFFFF), above every key
// (octant-major keys are below 2^28, the others below 2^30).  Keys are
// written as int32, which holds every one of them; the spread's masks keep
// each of its steps below 2^30, so it runs in 32 bits.
//
// What bounds it.  A ray reads 24 bytes (origin 12, direction 12; a live
// flag 1 more) and writes a 4-byte key: 28 bytes, 14,680,064 for a 524,288-ray
// batch, 0.0044 ms at 3.35 TB/s (0.0026 ms at 307,200 rays).  Its ~130 lane
// instructions a ray, most of them integer, take about as long on the
// integer lanes.  So the design is one pass with no intermediates in device
// memory, where the plain version moves ~100 int64 arrays: each thread loads
// its ray, keeps every step in registers and stores one key.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDeadKey = 0x7FFFFFFF;
enum Kind : int { kOctantMajor = 0, kOriginMajor = 1, kDirection = 2 };

// clamp_min's 1e-12, rounded to float32 as ATen rounds a scalar
constexpr float kMinExtent = static_cast<float>(1e-12);

// ATen's CUDA clamp(x, 0, 1): NaN passes through
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

// (clamp(x, 0, 1) * s).to(torch.int64)
__device__ __forceinline__ long long quantize(float x, float s) {
  return static_cast<long long>(__fmul_rn(clamp01(x), s));
}

// (x + 1) * 0.5, the direction in the unit box
__device__ __forceinline__ float unit_dir(float x) {
  return __fmul_rn(__fadd_rn(x, 1.0f), 0.5f);
}

// morton_spread_10: 10 bits to 30
__device__ __forceinline__ unsigned spread10(long long q) {
  unsigned v = static_cast<unsigned>(q & 0x3FF);
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

__device__ __forceinline__ unsigned morton3(const long long q[3]) {
  return (spread10(q[0]) << 2) | (spread10(q[1]) << 1) | spread10(q[2]);
}

__global__ void __launch_bounds__(kThreads)
    morton_keys_kernel(long long n, int kind, int bits,
                       const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const float* __restrict__ lo,
                       const float* __restrict__ hi,
                       const bool* __restrict__ live, int* __restrict__ keys) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  if (live != nullptr && !live[i]) {
    keys[i] = kDeadKey;
    return;
  }
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = direction[3 * i + k];
  long long q[3];
  unsigned key;
  if (kind == kDirection) {
#pragma unroll
    for (int k = 0; k < 3; ++k) q[k] = quantize(unit_dir(d[k]), 1023.0f);
    key = morton3(q);
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float l = __ldg(lo + k);
      const float ext = __fsub_rn(__ldg(hi + k), l);
      const float e = isnan(ext) ? ext : fmaxf(ext, kMinExtent);
      q[k] = quantize(__fdiv_rn(__fsub_rn(origin[3 * i + k], l), e), 511.0f);
    }
    const unsigned okey = morton3(q);    // 27 bits
    if (kind == kOriginMajor) {
      key = (okey << 3) | (static_cast<unsigned>(d[0] < 0.0f) << 2) |
            (static_cast<unsigned>(d[1] < 0.0f) << 1) |
            static_cast<unsigned>(d[2] < 0.0f);
    } else {
      const long long qmax = (1LL << bits) - 1;
      const float scale = static_cast<float>(qmax + 1);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const long long v = quantize(unit_dir(d[k]), scale);
        q[k] = v < qmax ? v : qmax;
      }
      const int minor = 28 - 3 * bits;
      key = (morton3(q) << minor) | (okey >> (27 - minor));
    }
  }
  keys[i] = static_cast<int>(key);
}

}  // namespace

extern "C" int mrt_morton_keys(int n, int kind, int dir_bits,
                               const float* origin, const float* direction,
                               const float* lo, const float* hi,
                               const bool* live, int* keys, void* stream) {
  if (n < 0 || kind < kOctantMajor || kind > kDirection || dir_bits < 1 ||
      dir_bits > 9) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>(
        (static_cast<long long>(n) + kThreads - 1) / kThreads);
    morton_keys_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        n, kind, dir_bits, origin, direction, lo, hi, live, keys);
  }
  return static_cast<int>(cudaGetLastError());
}

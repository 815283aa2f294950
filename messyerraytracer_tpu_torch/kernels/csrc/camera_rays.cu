// camera_rays.cu — a frame of camera rays (render/camera.py::generate_rays on
// a card) in one launch.  Hopper, sm_90a.
//
// Replaces no Pallas kernel: the JAX package makes its camera rays in jnp
// (messyerraytracer_tpu/render/camera.py, generate_rays).  Added to make a
// frame's rays one launch with no host sync: the port's plain version
// (camera.py::_generate_rays) runs each float32 step as a float64 op and a
// rounding, about 35 launches a frame, and uploads its eight scalars one
// pageable copy at a time, each of which waits for the stream.
//
// What one launch computes, one thread a ray in raster order, with the plain
// version's float32 steps in its order.  Each step is the correctly rounded
// float32 operation (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn;
// built with -fmad=false), which is what the plain version's float64 step
// rounded to float32 gives (camera.py's docstring), so the rays are its rays
// bit for bit:
//   u = ((2 (x + jx)) / w) - 1,  v = 1 - ((2 (y + jy)) / h)
//   perspective:  a = u sx, b = v sy (sx = half_w, sy = tan(fov / 2)),
//                 d_c = (a B[c][0] + b B[c][1]) - B[c][2],
//                 direction = d / sqrt((d0 d0 + d1 d1) + d2 d2), origin = o
//   orthographic: uw = u sx, vh = v sy (sx = half_w, sy = half_h),
//                 origin_c = (o_c + B[c][0] uw) + B[c][1] vh,
//                 direction = -B[:, 2]
// and t_min, t_max of every ray.  Every scalar comes by value, rounded to
// float32 on the host; jitter is a scalar pair or two (H, W) arrays.
//
// What bounds it.  The launch writes 32 bytes a ray (origin 12, direction
// 12, t_min 4, t_max 4): 66,355,200 bytes a 1920x1080 frame, 0.0198 ms at
// 3.35 TB/s; its 60-80 lane instructions a ray are under 0.005 ms.  So the
// stores are what it costs.  A thread writes its t_min and t_max directly
// (coalesced); the (N, 3) origins and directions go through shared memory,
// and the block writes them out as 16-byte stores.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Camera {
  float o[3];
  float b[9];           // basis, row-major: b[3 c + k] = basis[c][k]
  float jx, jy;         // scalar jitter, where jx_px / jy_px are null
  const float* jx_px;   // (H, W) jitter, or null
  const float* jy_px;
  float w, h;           // width and height as float32
  float sx, sy;         // half_w and tan_half, or half_w and half_h
  float t_min, t_max;
  int width, height;
  int ortho;
};

// ``count`` rays' (count, 3) floats from shared memory to ``out``; 16-byte
// stores where the block is whole (its first float lies on 16 bytes).
__device__ __forceinline__ void store3(const float* s, float* out, int count,
                                       bool vector) {
  const int m = 3 * count;
  if (vector && m == 3 * kThreads) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int k = threadIdx.x; k < m / 4; k += kThreads) o4[k] = s4[k];
  } else {
    for (int k = threadIdx.x; k < m; k += kThreads) out[k] = s[k];
  }
}

__global__ void __launch_bounds__(kThreads)
    camera_rays_kernel(Camera c, float* origin, float* direction,
                       float* t_min, float* t_max, bool vector) {
  __shared__ __align__(16) float so[3 * kThreads];
  __shared__ __align__(16) float sd[3 * kThreads];
  const long long n = static_cast<long long>(c.width) * c.height;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const long long i = first + threadIdx.x;
  const int t = threadIdx.x;
  if (i < n) {
    const int y = static_cast<int>(i / c.width);
    const int x = static_cast<int>(i - static_cast<long long>(y) * c.width);
    const float jx = c.jx_px ? c.jx_px[i] : c.jx;
    const float jy = c.jy_px ? c.jy_px[i] : c.jy;
    const float u = __fsub_rn(
        __fdiv_rn(__fmul_rn(2.0f, __fadd_rn(static_cast<float>(x), jx)),
                  c.w),
        1.0f);
    const float v = __fsub_rn(
        1.0f,
        __fdiv_rn(__fmul_rn(2.0f, __fadd_rn(static_cast<float>(y), jy)),
                  c.h));
    const float a = __fmul_rn(u, c.sx);
    const float b = __fmul_rn(v, c.sy);
    if (!c.ortho) {
      float d[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        d[k] = __fsub_rn(__fadd_rn(__fmul_rn(a, c.b[3 * k]),
                                   __fmul_rn(b, c.b[3 * k + 1])),
                         c.b[3 * k + 2]);
      }
      const float n2 = __fadd_rn(
          __fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
          __fmul_rn(d[2], d[2]));
      const float len = __fsqrt_rn(n2);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        so[3 * t + k] = c.o[k];
        sd[3 * t + k] = __fdiv_rn(d[k], len);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        so[3 * t + k] = __fadd_rn(__fadd_rn(c.o[k], __fmul_rn(c.b[3 * k], a)),
                                  __fmul_rn(c.b[3 * k + 1], b));
        sd[3 * t + k] = -c.b[3 * k + 2];
      }
    }
    t_min[i] = c.t_min;
    t_max[i] = c.t_max;
  }
  __syncthreads();
  const long long left = n - first;
  const int count = left < kThreads ? static_cast<int>(left) : kThreads;
  store3(so, origin + 3 * first, count, vector);
  store3(sd, direction + 3 * first, count, vector);
}

}  // namespace

extern "C" int mrt_camera_rays(
    int width, int height, int ortho, float ox, float oy, float oz,
    float b00, float b01, float b02, float b10, float b11, float b12,
    float b20, float b21, float b22, float jx, float jy, const float* jx_px,
    const float* jy_px, float w, float h, float sx, float sy, float t_min,
    float t_max, float* origin, float* direction, float* t_min_out,
    float* t_max_out, void* stream) {
  const Camera c = {{ox, oy, oz},
                    {b00, b01, b02, b10, b11, b12, b20, b21, b22},
                    jx, jy, jx_px, jy_px, w, h, sx, sy, t_min, t_max,
                    width, height, ortho};
  const long long n = static_cast<long long>(width) * height;
  // 16-byte stores need both (N, 3) outputs on 16 bytes; a block's first
  // float then is too (3 x 256 floats a block)
  const bool vector =
      ((reinterpret_cast<unsigned long long>(origin) |
        reinterpret_cast<unsigned long long>(direction)) & 15) == 0;
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    camera_rays_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        c, origin, direction, t_min_out, t_max_out, vector);
  }
  return static_cast<int>(cudaGetLastError());
}

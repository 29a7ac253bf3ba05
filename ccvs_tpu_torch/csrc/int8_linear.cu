// K3: the int8 decode step's dense product, one launch per product.
//
// Replaces the XLA product of ccvs_tpu/nn/quantized.py (_dot_int8, a
// lax.dot_general with int32 accumulation, not a Pallas kernel) together with
// the element-wise work around it, which the PyTorch port would otherwise run
// as some 15 separate launches per product: the per-row activation
// quantization, the int8 x int8 -> int32 product, the scaling and the bias.
//
//   s_x[r]  = max(max_i |x[r, i]|, 1e-8) / 127            (fp32, IEEE division)
//   x8[r,i] = clamp(rint(x[r, i] / s_x[r]), -127, 127)    (half to even)
//   acc     = sum_i x8[r, i] * w8[o, i]                   (int32, exact)
//   out     = float(acc) * (s_x[r] * s_w[o]) (+ bias[o])  (fp32, each op rounded)
//
// Every step is the plain version's, in the same order, with the rounding of
// each operation explicit (no fused multiply-add, no reciprocal), so the
// result is bit-equal to the CPU's.
//
// Design: the decode step has 2 rows (the batch) and a weight of up to
// 4096 x 1024 int8, so the product is a matrix-vector product bound by the
// weight's bytes (4 MB: 1.3 us at 3.35 TB/s) and, at this size, by the launch.
// Each block of 8 warps quantizes all rows of x into shared memory (the rows
// are 8 KB at most; every block redoing it costs L2 reads, not a second
// launch), then each warp takes output rows in turn: its lanes read the
// weight row in 16-byte pieces, multiply them with __dp4a against the int8
// rows in shared memory, and the warp sums its int32 partials with shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 8;  // rows of x per launch; the caller splits more

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(THREADS)
int8_linear_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w8,
                   const float* __restrict__ w_scale, const TB* __restrict__ bias,
                   float* __restrict__ out, int rows, int in, int n_out) {
  extern __shared__ int4 smem[];  // x8: rows x in int8
  int8_t* x8 = reinterpret_cast<int8_t*>(smem);
  __shared__ float red[WARPS][MAX_ROWS];
  __shared__ float sx[MAX_ROWS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // per-row max |x|
  float amax[MAX_ROWS];
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    amax[r] = 0.f;
    if (r < rows)
      for (int i = tid; i < in; i += THREADS)
        amax[r] = fmaxf(amax[r], fabsf(to_float(x[(size_t)r * in + i])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffffu, amax[r], off));
    if (lane == 0) red[warp][r] = amax[r];
  }
  __syncthreads();
  if (tid < rows) {
    float m = red[0][tid];
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w][tid]);
    sx[tid] = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
  }
  __syncthreads();
  for (int r = 0; r < rows; ++r) {
    const float s = sx[r];
    for (int i = tid; i < in; i += THREADS) {
      const float q = rintf(__fdiv_rn(to_float(x[(size_t)r * in + i]), s));
      x8[r * in + i] = static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
    }
  }
  __syncthreads();

  // one output row per warp at a time; 16 int8 of the row per lane and load
  const int pieces = in / 16;
  const int4* xs = reinterpret_cast<const int4*>(x8);
  for (int o = blockIdx.x * WARPS + warp; o < n_out; o += gridDim.x * WARPS) {
    const int4* wrow = reinterpret_cast<const int4*>(w8 + (size_t)o * in);
    int acc[MAX_ROWS];
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) acc[r] = 0;
    for (int p = lane; p < pieces; p += 32) {
      const int4 wv = __ldg(wrow + p);
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r) {
        if (r < rows) {
          const int4 xv = xs[r * pieces + p];
          acc[r] = __dp4a(wv.x, xv.x, acc[r]);
          acc[r] = __dp4a(wv.y, xv.y, acc[r]);
          acc[r] = __dp4a(wv.z, xv.z, acc[r]);
          acc[r] = __dp4a(wv.w, xv.w, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    if (lane == 0) {
      const float sw = w_scale[o];
      for (int r = 0; r < rows; ++r) {
        float y = __fmul_rn(__int2float_rn(acc[r]), __fmul_rn(sx[r], sw));
        if (bias != nullptr) y = __fadd_rn(y, to_float(bias[o]));
        out[(size_t)r * n_out + o] = y;
      }
    }
  }
}

template <typename TX, typename TB>
int launch(const void* x, const void* w8, const void* w_scale, const void* bias, void* out,
           int rows, int in, int n_out, cudaStream_t s) {
  const int blocks = (n_out + WARPS - 1) / WARPS;
  int8_linear_kernel<TX, TB><<<blocks, THREADS, rows * in, s>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(w8),
      static_cast<const float*>(w_scale), static_cast<const TB*>(bias), static_cast<float*>(out),
      rows, in, n_out);
  return cudaGetLastError();
}

}  // namespace

// The most rows of x that one call takes.
extern "C" int ccvs_int8_linear_max_rows() { return MAX_ROWS; }

// x (rows, in) in fp32 (x_dtype 0) or bf16 (1); w8 (n_out, in) int8;
// w_scale (n_out,) fp32; bias (n_out,) in fp32 (bias_dtype 0) or bf16 (1), or
// null; out (rows, n_out) fp32. All contiguous and 16-byte aligned, with
// 1 <= rows <= 8, in a positive multiple of 16 and rows * in <= 48 KB. One
// launch; returns cudaGetLastError() after it.
extern "C" int ccvs_int8_linear(const void* x, int x_dtype, const void* w8, const void* w_scale,
                                const void* bias, int bias_dtype, void* out, int rows, int in,
                                int n_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > MAX_ROWS || in <= 0 || in % 16 != 0 || n_out <= 0 ||
      rows * in > 48 * 1024)
    return cudaErrorInvalidValue;
  if (x_dtype == 1) {
    if (bias_dtype == 1)
      return launch<__nv_bfloat16, __nv_bfloat16>(x, w8, w_scale, bias, out, rows, in, n_out, s);
    return launch<__nv_bfloat16, float>(x, w8, w_scale, bias, out, rows, in, n_out, s);
  }
  if (bias_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w8, w_scale, bias, out, rows, in, n_out, s);
  return launch<float, float>(x, w8, w_scale, bias, out, rows, in, n_out, s);
}

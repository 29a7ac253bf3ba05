// K2: single-token cached attention (flash decode).
//
// Replaces the Pallas TPU kernel ccvs_tpu/ops/attention_pallas.py (_kernel,
// flash_decode_attention). Same contract: s = K q / sqrt(hd) in fp32,
// positions > pos excluded, fp32 softmax, out = softmax . V in fp32, written
// in q's dtype. Excluded positions are skipped rather than read: the Pallas
// kernel gives them a -1e9 score, whose weight is exactly 0 in fp32 once
// pos >= 0, so the result is the same.
//
// Bound on an H100 SXM: at the BAIR serving shape (q 2 x 16 x 64, caches
// 2 x 16 x 1024 x 64, bf16) one call reads at most 8.4 MB of cache and does
// about 4 MFLOP, so it is bound by bytes: 2.5 us at 3.35 TB/s with the whole
// cache live, and on average half of that over a rollout, since only
// positions <= pos are read.
//
// Design. One block per (batch * head, chunk of 64 positions), so a full
// cache gives 32 x 16 = 512 blocks instead of the 32 that one block per head
// would leave on 132 SMs. With so little work per block the time is memory
// latency, so every thread issues all its loads at once: a key or value row
// is read by hd / VEC neighbouring threads with one 16-byte load each
// (coalesced), and the rows of the chunk are spread over the block, so a
// thread holds 4 independent loads per pass (bf16, hd 64). The block keeps
// its chunk's max, sum of exponentials and unnormalised output in fp32 and
// writes them to a small scratch buffer; a second kernel combines the chunks
// of each head (online-softmax rescaling) and writes the output. Faster
// designs (one launch, TMA) are later work.
//
// Built for head size 64, that of every configuration of the model, in bf16
// (the serving dtype) and fp32 (a model built in fp32 on the card).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CHUNK = 64;     // cache positions per block
constexpr int THREADS = 128;  // 4 warps
constexpr int HD = 64;        // head size

// One 16-byte load of VEC elements, widened to fp32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static float one(float x) { return x; }
  __device__ static float cast(float x) { return x; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static float one(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 cast(float x) { return __float2bfloat16(x); }
};

// part[(bh * n_chunks + c) * (hd + 2) + {0: max, 1: sum, 2..: output}]
template <typename T>
__global__ void __launch_bounds__(THREADS)
fd_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, float* __restrict__ part, int len,
                  int pos, float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int R = HD / VEC;            // threads per row
  constexpr int ROWS = THREADS / R;      // rows per pass
  constexpr int PASSES = CHUNK / ROWS;
  static_assert(HD % VEC == 0 && 32 % R == 0 && CHUNK % ROWS == 0, "unsupported shape");
  __shared__ float es[CHUNK];
  __shared__ float red[ROWS][HD];
  __shared__ float stats[2];

  const int bh = blockIdx.x, c = blockIdx.y, n_chunks = gridDim.y;
  const int p0 = c * CHUNK;
  const int np = min(CHUNK, pos + 1 - p0);  // live positions in this chunk
  const int col = (threadIdx.x % R) * VEC;
  const int row0 = threadIdx.x / R;
  const T* kb = kc + ((size_t)bh * len + p0) * HD + col;
  const T* vb = vc + ((size_t)bh * len + p0) * HD + col;

  float qv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) qv[i] = Vec<T>::one(q[(size_t)bh * HD + col + i]);

  // scores: all key loads of a thread first, then the dot products
  float kv[PASSES][VEC] = {};
#pragma unroll
  for (int r = 0; r < PASSES; ++r) {
    const int row = r * ROWS + row0;
    if (row < np) Vec<T>::load(kb + (size_t)row * HD, kv[r]);
  }
#pragma unroll
  for (int r = 0; r < PASSES; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc = fmaf(qv[i], kv[r][i], acc);
#pragma unroll
    for (int off = R / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const int row = r * ROWS + row0;
    if (threadIdx.x % R == 0 && row < np) es[row] = acc * scale;
  }

  // the value loads do not depend on the softmax: issue them now
  float vv[PASSES][VEC] = {};
#pragma unroll
  for (int r = 0; r < PASSES; ++r) {
    const int row = r * ROWS + row0;
    if (row < np) Vec<T>::load(vb + (size_t)row * HD, vv[r]);
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // max and sum of exponentials over the chunk
    float m = -INFINITY;
    for (int p = threadIdx.x; p < np; p += 32) m = fmaxf(m, es[p]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int p = threadIdx.x; p < np; p += 32) l += expf(es[p] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (threadIdx.x == 0) {
      stats[0] = m;
      stats[1] = l;
    }
  }
  __syncthreads();

  const float m = stats[0];
  float acc[VEC] = {};
#pragma unroll
  for (int r = 0; r < PASSES; ++r) {
    const int row = r * ROWS + row0;
    if (row < np) {
      const float e = expf(es[row] - m);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(e, vv[r][i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) red[row0][col + i] = acc[i];
  __syncthreads();

  float* out = part + ((size_t)bh * n_chunks + c) * (HD + 2);
  if (threadIdx.x < HD) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < ROWS; ++g) s += red[g][threadIdx.x];
    out[2 + threadIdx.x] = s;
  }
  if (threadIdx.x == 0) {
    out[0] = m;
    out[1] = stats[1];
  }
}

// One block of hd threads per head. hd is a run-time argument although it is
// always HD: with the compile-time constant this kernel measured slower on the
// H100 (chip_smoke.py's K2 time).
template <typename T>
__global__ void fd_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                                  int n_chunks, int hd) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const float* pb = part + (size_t)bh * n_chunks * (hd + 2);
  float m = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, pb[c * (hd + 2)]);
  float l = 0.f, o = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float w = expf(pb[c * (hd + 2)] - m);
    l = fmaf(pb[c * (hd + 2) + 1], w, l);
    o = fmaf(pb[c * (hd + 2) + 2 + d], w, o);
  }
  out[(size_t)bh * hd + d] = Vec<T>::cast(o / l);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* part, void* out,
           int bh, int len, int pos, float scale, cudaStream_t s) {
  const int n_chunks = pos / CHUNK + 1;  // chunks holding positions 0..pos
  fd_partial_kernel<T><<<dim3(bh, n_chunks), THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(part), len, pos, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fd_combine_kernel<T><<<bh, HD, 0, s>>>(static_cast<const float*>(part),
                                          static_cast<T*>(out), n_chunks, HD);
  return cudaGetLastError();
}

}  // namespace

// q (bh, hd); k, v (bh, len, hd), all contiguous, 16-byte aligned and of one
// dtype (0 = fp32, 1 = bf16); out (bh, hd) in that dtype; part holds
// bh * (pos / 64 + 1) * (hd + 2) floats. Needs 0 <= pos < len and hd = 64.
// Returns cudaGetLastError() after both launches.
extern "C" int ccvs_flash_decode(const void* q, const void* k, const void* v,
                                 void* part, void* out, int bh, int len, int hd,
                                 int pos, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd != HD) return cudaErrorInvalidValue;
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, part, out, bh, len, pos, scale, s);
  return launch<float>(q, k, v, part, out, bh, len, pos, scale, s);
}

// Cache positions per block, so the caller can size the scratch buffer.
extern "C" int ccvs_flash_decode_chunk() { return CHUNK; }

// The head size the kernel is built for.
extern "C" int ccvs_flash_decode_head_dim() { return HD; }

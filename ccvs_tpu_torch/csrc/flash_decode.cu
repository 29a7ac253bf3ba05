// K2: single-token cached attention (flash decode), one launch per call.
//
// Replaces the Pallas TPU kernel ccvs_tpu/ops/attention_pallas.py (_kernel,
// flash_decode_attention). Same contract: s = K q / sqrt(hd) in fp32,
// positions > pos excluded, fp32 softmax, out = softmax . V in fp32, written
// in q's dtype. Like the Pallas kernel, which reads pos from a scalar in SMEM,
// this kernel reads pos at run time, from an int32 in device memory, and
// clamps it to len - 1 (the Pallas mask gives the same result for any
// pos >= len - 1). Excluded positions are skipped rather than read: the
// Pallas kernel gives them a -1e9 score, whose weight is exactly 0 in fp32
// once pos >= 0, so the result is the same. A negative pos is outside the
// contract.
//
// Bound on an H100 SXM: at the BAIR serving shape (q 2 x 16 x 64, caches
// 2 x 16 x 1024 x 64, bf16) one call at pos 1023 reads 8.4 MB of cache and
// does about 4 MFLOP, so it is bound by bytes: 2.5 us at 3.35 TB/s. At a
// smaller pos only the live rows count.
//
// Design, against what held the earlier two-kernel version back:
// 1. Two launches and a per-call scratch buffer: here each (batch * head) is
//    one thread-block cluster of 8 CTAs (the portable size). CTA r owns
//    positions [r L/8, (r+1) L/8). Each CTA keeps its fp32 (max, sum of
//    exponentials, unnormalised output[64]) and writes them into the shared
//    memory of rank 0 of its cluster (distributed shared memory); after one
//    cluster barrier rank 0 combines the 8 parts and writes the output. No
//    global scratch, no second kernel.
// 2. A grid that depended on pos: the grid is (8, B * nh) for any pos, and
//    pos is read inside the kernel, so one launch can be captured in a CUDA
//    graph and replayed at every position. The bytes a CTA copies follow pos.
// 3. Small blocks with loads through registers: one thread of each CTA
//    issues bulk asynchronous copies (cp.async.bulk, completing on mbarriers)
//    of the CTA's live key rows, then its live value rows, into shared
//    memory: 16 KB + 16 KB in bf16 at L 1024. The value copy is in flight
//    while the scores are computed. Each thread computes one row's score
//    (two threads a row in fp32) without shuffles, from 16-byte reads whose
//    order is rotated by thread so that neighbours hit different banks; the
//    tile's max and sum go through shuffles and one word per warp, in the
//    log2 domain (exp2), and the exponentials are kept for the value
//    product. Where L/8 rows exceed a 16 KB tile (L > 1024 in bf16, L > 512
//    in fp32) the CTA loops over tiles through a two-stage ring, with the
//    online-softmax rescaling between tiles.
//
// Empty parts: a CTA whose positions all lie past pos copies nothing and
// contributes (-inf, 0, 0). Rank 0 always holds position 0, so the cluster's
// max is finite and exp(-inf - (-inf)) is never formed.
//
// Built for head size 64, that of every configuration of the model, in bf16
// (the serving dtype) and fp32 (a model built in fp32 on the card). Rows are
// then 128 or 256 bytes, so every copy is 16-byte aligned and a multiple of
// 16 bytes, as the bulk copy needs; the caller checks the base pointers.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;         // CTAs per (batch * head)
constexpr int THREADS = 128;       // 4 warps per CTA
constexpr int WARPS = THREADS / 32;
constexpr int HD = 64;             // head size
constexpr int TILE_BYTES = 16384;  // one key or value tile in shared memory
constexpr int STAGES = 2;          // ring depth for L/8 rows > one tile

// One 16-byte load of VEC elements, widened to fp32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
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
  __device__ static __nv_bfloat16 cast(float x) { return __float2bfloat16(x); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arm `bar` for `bytes` and copy them from global `src` to shared `dst`; the
// barrier's phase completes when the bytes have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

template <typename T>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ pos_dev,
                    int pos_host, T* __restrict__ out, int len, float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int R = HD / VEC;                          // 16-byte chunks per row (8 or 16)
  constexpr int ROWS = THREADS / R;                    // rows per pass of the value product
  constexpr int TILE = TILE_BYTES / (HD * sizeof(T));  // rows per tile (128 or 64)
  constexpr int PASSES = TILE / ROWS;
  constexpr int TPR = THREADS / TILE;                  // threads per row for the scores (1 or 2)
  constexpr int CH = R / TPR;                          // chunks per thread for the scores
  // CH == 8: the 8 threads of a quarter-warp read 8 different bank groups
  static_assert(32 % R == 0 && TILE % ROWS == 0 && CH == 8, "unsupported shape");
  constexpr float LOG2E = 1.4426950408889634f;  // scores are kept in the log2 domain

  extern __shared__ __align__(128) unsigned char ring[];  // STAGES x (key tile, value tile)
  __shared__ __align__(8) uint64_t kbar[STAGES], vbar[STAGES];
  __shared__ __align__(16) T qs[HD];  // the query, in its own dtype like a key row
  __shared__ float es[TILE];          // the tile's exp2(s - max)
  __shared__ float wred[2][WARPS];    // per-warp max and sum of the tile
  __shared__ float red[WARPS][HD];    // per-warp partial outputs
  __shared__ float part_o[CLUSTER][HD];  // in rank 0: every rank's unnormalised output
  __shared__ float part_ml[CLUSTER][2];  // in rank 0: every rank's (log2 max, sum of exponentials)

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // This CTA has started; the matching wait comes before the first write
  // into rank 0's shared memory, so the barrier's latency hides behind the loads.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  if (tid < R) reinterpret_cast<uint4*>(qs)[tid] = reinterpret_cast<const uint4*>(q + (size_t)bh * HD)[tid];
  const int pos = min(pos_dev != nullptr ? *pos_dev : pos_host, len - 1);
  // while q and pos are in flight: the barriers, ready before anyone waits on them
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kbar[s]);
      mbar_init(&vbar[s]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // also publishes qs

  const int span = len / CLUSTER;
  const int p0 = rank * span;
  const int n_live = max(0, min(span, pos + 1 - p0));  // rank 0: >= 1
  const int n_tiles = (n_live + TILE - 1) / TILE;
  const T* kb = kc + ((size_t)bh * len + p0) * HD;
  const T* vb = vc + ((size_t)bh * len + p0) * HD;
  auto k_tile = [&](int s) { return reinterpret_cast<T*>(ring + (2 * s) * TILE_BYTES); };
  auto v_tile = [&](int s) { return reinterpret_cast<T*>(ring + (2 * s + 1) * TILE_BYTES); };
  auto issue = [&](int t) {  // tile t's key rows, then its value rows
    const int s = t % STAGES;
    const uint32_t bytes = min(TILE, n_live - t * TILE) * HD * sizeof(T);
    bulk_load(k_tile(s), kb + (size_t)t * TILE * HD, bytes, &kbar[s]);
    bulk_load(v_tile(s), vb + (size_t)t * TILE * HD, bytes, &vbar[s]);
  };

  if (tid == 0)
    for (int t = 0; t < min(n_tiles, STAGES); ++t) issue(t);

  const float scale2 = scale * LOG2E;
  const int row = tid / TPR, half = tid % TPR;  // scores: row `row`, chunks half * CH + ...
  const int col = (tid % R) * VEC;              // value product: columns col .. col + VEC,
  const int rg = tid / R;                       // rows rg, rg + ROWS, ...
  float m_run = -INFINITY, l_run = 0.f;  // log2 domain, identical in every thread
  float acc[VEC] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;
    const int n = min(TILE, n_live - t * TILE);  // >= 1
    const T* kt = k_tile(s);
    const T* vt = v_tile(s);

    mbar_wait(&kbar[s], parity);
    // one score per row: no shuffles; chunk j of thread tid is rotated by
    // tid, so a quarter-warp's 16-byte reads hit 8 different bank groups
    float d0 = 0.f, d1 = 0.f;
    if (row < n) {
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int c = half * CH + ((tid + j) % CH);
        float kv[VEC], qv[VEC];
        Vec<T>::load(kt + row * HD + c * VEC, kv);
        Vec<T>::load(qs + c * VEC, qv);
#pragma unroll
        for (int i = 0; i < VEC; i += 2) {
          d0 = fmaf(qv[i], kv[i], d0);
          d1 = fmaf(qv[i + 1], kv[i + 1], d1);
        }
      }
    }
    float d = d0 + d1;
    if (TPR == 2) d += __shfl_xor_sync(0xffffffffu, d, 1);
    const float s2 = row < n ? d * scale2 : -INFINITY;

    // the tile's max, then exp2(s - max) and its sum: warps by shuffles, then across warps
    float mt = s2;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    if (lane == 0) wred[0][warp] = mt;
    __syncthreads();
    mt = wred[0][0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mt = fmaxf(mt, wred[0][w]);
    const float m_new = fmaxf(m_run, mt);      // finite: the tile has a live row
    const float alpha = exp2f(m_run - m_new);  // 0 on the first tile (m_run = -inf)
    const float p = exp2f(s2 - m_new);         // 0 past the live rows
    if (half == 0) es[row] = p;
    float lt = half == 0 ? p : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    if (lane == 0) wred[1][warp] = lt;
    __syncthreads();  // es and the sums are complete
    lt = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) lt += wred[1][w];
    l_run = fmaf(l_run, alpha, lt);
    m_run = m_new;

    mbar_wait(&vbar[s], parity);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
#pragma unroll
    for (int r = 0; r < PASSES; ++r) {
      const int vrow = r * ROWS + rg;
      if (vrow < n) {  // rows past n were not copied
        const float e = es[vrow];
        float vv[VEC];
        Vec<T>::load(vt + vrow * HD + col, vv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(e, vv[i], acc[i]);
      }
    }
    __syncthreads();  // es, wred and stage s are free again
    if (tid == 0 && t + STAGES < n_tiles) {
      // the generic-proxy reads of stage s come before the async-proxy writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(t + STAGES);
    }
  }

  // sum the row groups' outputs: inside each warp by shuffles, then across warps
#pragma unroll
  for (int off = R; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  if (lane < R)
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[warp][col + i] = acc[i];
  __syncthreads();

  // every CTA of the cluster has started, so rank 0's shared memory may be written
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < HD) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += red[w][tid];
    cluster.map_shared_rank(&part_o[rank][0], 0)[tid] = o;
  }
  if (tid == 0) {
    float* ml = cluster.map_shared_rank(&part_ml[rank][0], 0);
    ml[0] = m_run;  // -inf for an empty part, with l_run = 0 and o = 0
    ml[1] = l_run;
  }
  cluster.sync();  // the 8 parts are in rank 0's shared memory

  if (rank == 0 && tid < HD) {
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) m = fmaxf(m, part_ml[r][0]);  // finite: rank 0 holds pos 0
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) {
      const float w = part_ml[r][0] == -INFINITY ? 0.f : exp2f(part_ml[r][0] - m);
      l = fmaf(part_ml[r][1], w, l);
      o = fmaf(part_o[r][tid], w, o);
    }
    out[(size_t)bh * HD + tid] = Vec<T>::cast(o / l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos_dev, int pos_host,
           void* out, int bh, int len, float scale, cudaStream_t s) {
  constexpr int TILE = TILE_BYTES / (HD * sizeof(T));
  constexpr int MAX_DEVICES = 64;
  static bool smem_set[MAX_DEVICES] = {};  // above 48 KB needs the attribute, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_decode_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               STAGES * 2 * TILE_BYTES);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const int span = len / CLUSTER;
  const int stages = std::min(STAGES, (span + TILE - 1) / TILE);
  flash_decode_kernel<T><<<dim3(CLUSTER, bh), THREADS, stages * 2 * TILE_BYTES, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos_dev,
      pos_host, static_cast<T*>(out), len, scale);
  return cudaGetLastError();
}

}  // namespace

// q (bh, hd); k, v (bh, len, hd), all contiguous, 16-byte aligned and of one
// dtype (0 = fp32, 1 = bf16); out (bh, hd) in that dtype. The position is
// *pos_dev (an int32 in device memory, read by the kernel) or, where pos_dev
// is null, pos_host; it is clamped to len - 1 and must be >= 0. Needs
// hd = 64 and len a positive multiple of 8. One launch; returns
// cudaGetLastError() after it.
extern "C" int ccvs_flash_decode(const void* q, const void* k, const void* v,
                                 const void* pos_dev, int pos_host, void* out, int bh,
                                 int len, int hd, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd != HD || len <= 0 || len % CLUSTER != 0 || bh <= 0) return cudaErrorInvalidValue;
  const int* pd = static_cast<const int*>(pos_dev);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, pd, pos_host, out, bh, len, scale, s);
  return launch<float>(q, k, v, pd, pos_host, out, bh, len, scale, s);
}

// The head size the kernel is built for.
extern "C" int ccvs_flash_decode_head_dim() { return HD; }

// K3: the int8 decode step's dense products, one launch for all the
// products that take the same input (q, k and v; or one product alone).
//
// Replaces the XLA product of ccvs_tpu/nn/quantized.py (_dot_int8, a
// lax.dot_general with int32 accumulation, not a Pallas kernel) together with
// the element-wise work around it: the per-row activation quantization, the
// int8 x int8 -> int32 product, the scaling and the bias. For each weight s
// of the launch (up to three, each with its own scale, bias and output):
//
//   s_x[r]  = max(max_i |x[r, i]|, 1e-8) / 127               (fp32, IEEE division)
//   x8[r,i] = clamp(rint(x[r, i] / s_x[r]), -127, 127)       (half to even)
//   acc     = sum_i x8[r, i] * w8_s[o, i]                    (int32, exact)
//   out_s   = float(acc) * (s_x[r] * s_w_s[o]) (+ bias_s[o]) (fp32, each op rounded)
//
// Every step is the plain version's, in the same order, with the rounding of
// each operation explicit (no fused multiply-add, no reciprocal), so the
// result is bit-equal to the CPU's. x is quantized once for all the weights.
//
// What bounds it: the decode step has 2-16 rows (the batch) and weights of
// 1-4 MB in int8, so by its bytes the product needs 0.3-1.3 us at 3.35 TB/s.
// On an H100 a launch takes 6-7 us of device time at two rows, and that
// time is a chain of latencies, not bytes: the launch, reading x, two
// cluster barriers, the product's shared-memory reads and its reduction.
// The weight's copy, in flight from the entry, lands before x is quantized.
//
// Design:
// 1. The weight first. The grid covers the weights' rows (all segments one
//    after the other) in one wave of about one CTA per SM, each CTA a slice
//    of a multiple of 8 rows. At entry one thread of the last warp starts
//    bulk asynchronous copies (cp.async.bulk, completing on one mbarrier) of
//    the slice's rows, scales and biases into shared memory: 8 KB a CTA for
//    a 1 MB weight, 24 KB for q/k/v, 32 KB for fc1 and fc2. Meanwhile the
//    other warps read x; the CTA waits on the barrier last.
// 2. x quantized once a cluster. A cluster of 8 CTAs (4 where the width is
//    an odd multiple of 16) shares the work: each CTA loads its share of the
//    columns into registers (one 4-column piece a thread, up to 8), reduces
//    its partial row maxima, the CTAs read each other's maxima through
//    distributed shared memory after one cluster barrier, and each quantizes
//    its share from the registers into the shared memory of every CTA of the
//    cluster before a second. At 16 rows of 4096 fp32 columns (fc2 at batch
//    16) that is 256 KB of x read once a cluster instead of once a CTA.
//    Reading all of x in every CTA to save the first barrier was slower at
//    two rows: the longer read outweighs the barrier.
// 3. Up to 16 rows a launch (MAX_ROWS), in instances for 2, 8 and 16 rows,
//    the int8 rows in dynamic shared memory above the 48 KB default: beam
//    4 (8 rows) and batch 16 read each weight once.
// 4. The product on __dp4a (exact): each warp takes its weight rows in one
//    pass of up to 4 and keeps a pass's 16-byte pieces in registers against
//    each row of x, so one shared-memory read of x feeds 4-16 dp4a. The
//    warp's (weight rows x x rows) partial sums are reduced by a butterfly
//    that halves the values a lane holds at each step (62 shuffles for 64
//    sums instead of 320); the lane left holding a sum scales it and writes
//    it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

// The weight side of a launch: 1-3 weights (n_out, in) that take the same x.
// The caller builds it once per weight set and passes its address.
struct K3Weights {
  const int8_t* w8[3];    // (n_out, in) int8, contiguous, 16-byte aligned
  const float* scale[3];  // (n_out,) fp32, 16-byte aligned
  const void* bias[3];    // (n_out,) or null, 16-byte aligned
  int bias_dtype;         // of every bias that is not null: 0 fp32, 1 bf16
  int segments;
  int in;                 // a positive multiple of 16
  int n_out;              // a positive multiple of 8
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 16;      // rows of x per launch; the caller splits more
constexpr int MAX_SEGMENTS = 3;
constexpr int CLUSTER = 8;        // CTAs that share x's quantization, where in % 32 == 0
constexpr int KQ = 8;             // 4-column pieces of x a thread keeps in registers
constexpr int MAX_DYN_SMEM = 232448 - 1024;  // sm_90's 227 KB a block, less the static part
constexpr int MAX_DEVICES = 64;

struct K3Launch {
  K3Weights w;
  const void* x;          // (rows, in)
  float* out;             // weight s, row r, output o at out[s * seg_stride + r * n_out + o]
  long long seg_stride;
  int rows;
  int rows_per_cta;       // weight rows (over the segments in turn) a CTA holds, a multiple of 8
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// 4 consecutive elements of x (16 or 8 bytes, aligned) as fp32.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ int quant1(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<int>(q) & 0xff;
}

__device__ __forceinline__ int quant4(float4 v, float s) {
  return quant1(v.x, s) | quant1(v.y, s) << 8 | quant1(v.z, s) << 16 | quant1(v.w, s) << 24;
}

// a[s] for s in [0, 3) without indexing the kernel's parameters by a
// register (which copies them to local memory)
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[3], int s) {
  const T a0 = a[0], a1 = a[1], a2 = a[2];
  return s == 0 ? a0 : (s == 1 ? a1 : a2);
}

__host__ __device__ constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

// Sum N (a power of two) values over the warp. Each step sends half of the
// values a lane holds to its partner and keeps the other half, so that after
// the halving steps lane l holds the full sums of values
// (l >> (5 - H)) * PER + i, i < PER (H = min(log2 N, 5) halving steps,
// PER = max(N / 32, 1)); with N < 32 the remaining steps add whole values,
// and every lane of a group of 2^(5-H) holds the same sum. One instance a
// step, so that every index is a constant and v stays in registers.
template <int N, int STEP = 0>
__device__ __forceinline__ void warp_reduce_scatter(int (&v)[N], int lane) {
  if constexpr (STEP < 5) {
    constexpr int off = 16 >> STEP;
    constexpr int half = (N >> STEP) / 2;
    if constexpr (half >= 1) {
      // all ones in the upper lane of each pair; a select by mask, not by
      // index
      const int upper = -((lane & off) != 0);
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const int lo = v[i], hi = v[i + half];
        const int send = hi ^ ((lo ^ hi) & upper);
        const int keep = lo ^ ((lo ^ hi) & upper);
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    }
    warp_reduce_scatter<N, STEP + 1>(v, lane);
  }
}

// The CTA's slice in shared memory: weight rows, the int8 rows of x, the
// rows' scales and biases.
struct Slice {
  int8_t* w;
  int8_t* x8;
  float* scale;
  unsigned char* bias;
};

// cnt <= RW weight rows (local rows j0, j0 + WARPS, ...) against the NR rows
// of x8, reduced, scaled and written by this warp.
template <int NR, int RW>
__device__ __forceinline__ void rows_product(const K3Launch& p, const Slice& sl, const float* sx,
                                             int j0, int cnt, int row0, int lane) {
  const int in = p.w.in, pieces = in / 16;
  const int4* xs = reinterpret_cast<const int4*>(sl.x8);
  constexpr int N = NR * RW;
  int acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0;
  for (int q = lane; q < pieces; q += 32) {
    int4 wv[RW];
#pragma unroll
    for (int k = 0; k < RW; ++k)
      wv[k] = k < cnt ? reinterpret_cast<const int4*>(sl.w + static_cast<size_t>(j0 + k * WARPS) * in)[q]
                      : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int4 xv = xs[r * pieces + q];
#pragma unroll
      for (int k = 0; k < RW; ++k) {
        int a = acc[k * NR + r];
        a = __dp4a(wv[k].x, xv.x, a);
        a = __dp4a(wv[k].y, xv.y, a);
        a = __dp4a(wv[k].z, xv.z, a);
        a = __dp4a(wv[k].w, xv.w, a);
        acc[k * NR + r] = a;
      }
    }
  }
  warp_reduce_scatter<N>(acc, lane);
  constexpr int H = N >= 32 ? 5 : log2i(N);
  constexpr int PER = N >= 32 ? N / 32 : 1;
  if ((lane & ((1 << (5 - H)) - 1)) != 0) return;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = (lane >> (5 - H)) * PER + i;
    const int k = idx / NR, r = idx % NR;
    if (r >= p.rows || k >= cnt) continue;
    const int j = j0 + k * WARPS, g = row0 + j;
    const int s = g / p.w.n_out, o = g - s * p.w.n_out;
    float y = __fmul_rn(__int2float_rn(acc[i]), __fmul_rn(sx[r], sl.scale[j]));
    if (pick(p.w.bias, s) != nullptr)
      y = __fadd_rn(y, p.w.bias_dtype == 1
                           ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(sl.bias)[j])
                           : reinterpret_cast<const float*>(sl.bias)[j]);
    p.out[s * p.seg_stride + static_cast<long long>(r) * p.w.n_out + o] = y;
  }
}

// Items of x: 4-column pieces of this CTA's share of the columns, row-major,
// THREADS * KQ a pass; v[k] holds item base + k * THREADS + tid.
template <typename TX>
__device__ __forceinline__ void load_items(const TX* x, float4 (&v)[KQ], int base, int items,
                                           int quads, int in, int c0, int tid) {
#pragma unroll
  for (int k = 0; k < KQ; ++k) {
    const int it = base + k * THREADS + tid;
    if (it < items) {
      const int r = it / quads, c = it - r * quads;
      v[k] = load4(x + static_cast<size_t>(r) * in + c0 + 4 * c);
    }
  }
}

__device__ __forceinline__ void max_items(const float4 (&v)[KQ], int* pmax, int base, int items,
                                          int quads, int tid) {
  const int lane = tid & 31;
#pragma unroll
  for (int k = 0; k < KQ; ++k) {
    const int it = base + k * THREADS + tid;
    const int first = it - lane;  // the warp's first item
    if (first >= items) break;
    float m = 0.f;
    if (it < items)
      m = fmaxf(fmaxf(fabsf(v[k].x), fabsf(v[k].y)), fmaxf(fabsf(v[k].z), fabsf(v[k].w)));
    if (quads % 32 == 0) {  // the warp's 32 items lie in one row
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) atomicMax(&pmax[first / quads], __float_as_int(m));
    } else if (it < items) {
      atomicMax(&pmax[it / quads], __float_as_int(m));
    }
  }
}

// Quantize the items into the x8 of every CTA of the cluster.
__device__ __forceinline__ void quant_items(const float4 (&v)[KQ], const float* sx, int8_t* x8,
                                            int base, int items, int quads, int in, int c0,
                                            int tid, cg::cluster_group& cluster, int csize) {
#pragma unroll
  for (int k = 0; k < KQ; ++k) {
    const int it = base + k * THREADS + tid;
    const int r = it / quads, col = c0 + 4 * (it - r * quads);
    if (it < items) {
      const int q = quant4(v[k], sx[r]);
      int* dst = reinterpret_cast<int*>(x8 + static_cast<size_t>(r) * in + col);
      for (int cc = 0; cc < csize; ++cc) *cluster.map_shared_rank(dst, cc) = q;
    }
  }
}

template <typename TX, int NR>
__global__ void __launch_bounds__(THREADS, 1) int8_linear_kernel(const K3Launch p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t wbar;
  __shared__ int pmax[NR];  // this CTA's partial max |x| a row, as fp32 bits (all >= 0)
  __shared__ float sx[NR];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int in = p.w.in, n_out = p.w.n_out, rpc = p.rows_per_cta;
  const int row0 = blockIdx.x * rpc;
  const int nrows = max(0, min(rpc, p.w.segments * n_out - row0));
  const int belem = p.w.bias_dtype == 1 ? 2 : 4;
  Slice sl;
  sl.w = reinterpret_cast<int8_t*>(smem);
  sl.x8 = sl.w + static_cast<size_t>(rpc) * in;
  sl.scale = reinterpret_cast<float*>(sl.x8 + static_cast<size_t>(NR) * in);
  sl.bias = reinterpret_cast<unsigned char*>(sl.scale + rpc);

  // 1. the weight slice, its scales and biases: bulk copies for each weight
  // the slice touches, all completing on one barrier, issued by the last
  // warp while the first ones read x
  if (tid == THREADS - 32) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&wbar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (nrows > 0) {
      uint32_t bytes = 0;
      for (int g = row0; g < row0 + nrows;) {
        const int s = g / n_out, o = g - s * n_out, n = min(row0 + nrows - g, n_out - o);
        bytes += n * (in + 4 + (pick(p.w.bias, s) != nullptr ? belem : 0));
        g += n;
      }
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(smem_addr(&wbar)), "r"(bytes) : "memory");
      for (int g = row0; g < row0 + nrows;) {
        const int s = g / n_out, o = g - s * n_out, n = min(row0 + nrows - g, n_out - o);
        const int j = g - row0;
        bulk_load(sl.w + static_cast<size_t>(j) * in, pick(p.w.w8, s) + static_cast<size_t>(o) * in,
                  static_cast<uint32_t>(n * in), &wbar);
        bulk_load(sl.scale + j, pick(p.w.scale, s) + o, static_cast<uint32_t>(4 * n), &wbar);
        const unsigned char* b = static_cast<const unsigned char*>(pick(p.w.bias, s));
        if (b != nullptr)
          bulk_load(sl.bias + j * belem, b + static_cast<size_t>(o) * belem,
                    static_cast<uint32_t>(n * belem), &wbar);
        g += n;
      }
    }
  }
  if (tid < NR) pmax[tid] = 0;

  // 2. this CTA's share of the columns of x, in registers: its row maxima
  const TX* x = static_cast<const TX*>(p.x);
  const int share = in / csize, c0 = rank * share, quads = share / 4;
  const int items = p.rows * quads;
  float4 v[KQ];
  load_items(x, v, 0, items, quads, in, c0, tid);
  __syncthreads();  // pmax is zeroed
  max_items(v, pmax, 0, items, quads, tid);
  for (int base = THREADS * KQ; base < items; base += THREADS * KQ) {
    load_items(x, v, base, items, quads, in, c0, tid);
    max_items(v, pmax, base, items, quads, tid);
  }
  cluster.sync();  // every CTA has started and written its partial maxima
  if (tid < p.rows) {
    float mx = 0.f;
    for (int k = 0; k < csize; ++k)
      mx = fmaxf(mx, __int_as_float(*cluster.map_shared_rank(&pmax[tid], k)));
    sx[tid] = __fdiv_rn(fmaxf(mx, 1e-8f), 127.f);
  }
  __syncthreads();

  // 3. quantize the share into the x8 of every CTA of the cluster (from the
  // registers where x took one pass, else read again)
  for (int base = 0; base < items; base += THREADS * KQ) {
    if (items > THREADS * KQ) load_items(x, v, base, items, quads, in, c0, tid);
    quant_items(v, sx, sl.x8, base, items, quads, in, c0, tid, cluster, csize);
  }
  cluster.sync();  // x8 is whole in every CTA; no CTA touches another's memory after this

  // 4. the product, once the slice has landed
  if (nrows == 0) return;
  mbar_wait(&wbar, 0);
  // this warp's rows in passes of up to 4 (3 rows take one pass of 4)
  const int mine = nrows > warp ? (nrows - warp + WARPS - 1) / WARPS : 0;
  for (int t = 0; t < mine;) {
    const int rem = mine - t, j0 = warp + t * WARPS;
    if (rem >= 3) {
      rows_product<NR, 4>(p, sl, sx, j0, min(rem, 4), row0, lane);
      t += 4;
    } else if (rem == 2) {
      rows_product<NR, 2>(p, sl, sx, j0, 2, row0, lane);
      t += 2;
    } else {
      rows_product<NR, 1>(p, sl, sx, j0, 1, row0, lane);
      t += 1;
    }
  }
}

int sm_count(int dev) {
  static int sms[MAX_DEVICES] = {};
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms[dev];
}

size_t smem_bytes(int rows_per_cta, int nr, int in) {
  return static_cast<size_t>(rows_per_cta + nr) * in + 8 * static_cast<size_t>(rows_per_cta);
}

template <typename TX, int NR>
int launch(const K3Launch& p, int cluster, int dev, cudaStream_t s) {
  static bool smem_set[MAX_DEVICES] = {};  // above 48 KB needs the attribute, once per device
  if (!smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_linear_kernel<TX, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYN_SMEM);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const int total = p.w.segments * p.w.n_out;
  const int blocks = (total + p.rows_per_cta - 1) / p.rows_per_cta;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blocks + cluster - 1) / cluster * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(p.rows_per_cta, NR, p.w.in);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, int8_linear_kernel<TX, NR>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TX>
int launch_rows(const K3Launch& p, int cluster, int dev, cudaStream_t s) {
  if (p.rows <= 2) return launch<TX, 2>(p, cluster, dev, s);
  if (p.rows <= 8) return launch<TX, 8>(p, cluster, dev, s);
  return launch<TX, 16>(p, cluster, dev, s);
}

// the rows of x a launch's instance computes (2, 8 or 16)
int padded_rows(int rows) { return rows <= 2 ? 2 : rows <= 8 ? 8 : 16; }

}  // namespace

// The most rows of x that one call takes.
extern "C" int ccvs_int8_linear_max_rows() { return MAX_ROWS; }

// One launch of K3: x (rows, in) in fp32 (x_dtype 0) or bf16 (1), contiguous
// and 16-byte aligned, 1 <= rows <= 16, through the 1-3 weights of *w (in a
// positive multiple of 16, n_out of 8, every pointer 16-byte aligned); out:
// weight s's (rows, n_out) fp32 block at out + s * seg_stride floats.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments outside this contract.
extern "C" int ccvs_int8_linear(const K3Weights* w, const void* x, int x_dtype, void* out,
                                long long seg_stride, int rows, void* stream) {
  if (w == nullptr || w->segments < 1 || w->segments > MAX_SEGMENTS || w->in <= 0 ||
      w->in % 16 != 0 || w->n_out <= 0 || w->n_out % 8 != 0 || w->bias_dtype < 0 ||
      w->bias_dtype > 1 || rows < 1 || rows > MAX_ROWS || x_dtype < 0 || x_dtype > 1)
    return cudaErrorInvalidValue;
  // each CTA's share of the columns a whole number of 4-column pieces
  const int cluster = w->in % (4 * CLUSTER) == 0 ? CLUSTER : CLUSTER / 2;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  const int sms = sm_count(dev);
  if (sms <= 0) return cudaErrorInvalidDevice;
  // one wave: about one CTA an SM, each holding a slice of a multiple of 8
  // rows (so that every copy of scales and biases is 16-byte aligned)
  const int total = w->segments * w->n_out;
  int rpc = ((total + sms - 1) / sms + 7) / 8 * 8;
  while (rpc > 8 && smem_bytes(rpc, padded_rows(rows), w->in) > MAX_DYN_SMEM) rpc -= 8;
  if (smem_bytes(rpc, padded_rows(rows), w->in) > MAX_DYN_SMEM) return cudaErrorInvalidValue;
  K3Launch p;
  p.w = *w;
  p.x = x;
  p.out = static_cast<float*>(out);
  p.seg_stride = seg_stride;
  p.rows = rows;
  p.rows_per_cta = rpc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1) return launch_rows<__nv_bfloat16>(p, cluster, dev, s);
  return launch_rows<float>(p, cluster, dev, s);
}

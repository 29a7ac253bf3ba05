// K1: nearest-codebook search, idx[n] = argmin_k (||e_k||^2 - 2 z_n . e_k).
//
// Replaces the Pallas TPU kernel ccvs_tpu/ops/vq_pallas.py (_vq_kernel,
// vq_indices_pallas). Same contract: fp32 inputs, the first (smallest) index
// wins a tie, and the N x K distance matrix never reaches device memory.
//
// Bound on an H100 SXM. The function is 2 N K D multiply-adds and reads
// 4 (N D + K D) bytes. In fp32 on the CUDA cores (67 TFLOP/s) that is
// 0.0321 ms at the BAIR shape (z 2048 x 512, codebook 1024 x 512) and
// 0.2564 ms at the Kinetics-600 one (z 2048 x 256, codebook 16384 x 256).
// This kernel does the products on the tensor cores in TF32 (495 TFLOP/s),
// three times over (below): 3 x 2 N K D operations, 0.0130 ms and 0.1041 ms.
// The bytes take 0.0019 ms and 0.0056 ms at 3.35 TB/s, so both shapes are
// bound by operations.
//
// Why three TF32 products keep the argmin of fp32. A TF32 operand keeps 10
// of fp32's 23 mantissa bits, so one TF32 product is off by ~1e-3 of |z.e|:
// on z ~ N(0, 1) that moves distances by as much as the 1e-5 relative gap
// that separates a near-tie from a wrong index. Each fp32 operand x is split
// into hi = tf32(x) and lo = tf32(x - hi), rounded to nearest (cvt.rna; the
// MMA itself would only drop the 13 low bits), so x = hi + lo to ~2^-22 |x|.
// z . e = hi.hi + hi.lo + lo.hi + lo.lo, and the dropped lo.lo term is
// ~2^-22 |z.e|: the sum of the three products ("3xTF32") is as close to
// the fp32 dot product as fp32 rounding itself, and needs no re-check.
//
// Design:
// 1. A pre-pass (vq_split_kernel) writes z_hi, z_lo (N x Dp), cb_hi, cb_lo
//    (K x Dp) and e2[k] = ||e_k||^2 in fp32, once per code (the CUDA-core
//    kernel this replaces recomputed it in every row tile). D is
//    zero-padded to Dp, a multiple of 32; zeros add nothing. e2 is padded
//    with +inf to a whole number of code tiles, which masks codes >= K.
// 2. The main kernel (vq_mma_kernel): a block takes 128 rows of z and a
//    share of the code tiles (the split over codes fills the 132 SMs: at N
//    2048 there are only 16 row tiles). Warp 0 keeps in flight TMA copies
//    (cp.async.bulk.tensor.2d, 128-byte swizzle) of a 128 x 32 fp32 tile of
//    z_hi, z_lo, cb_hi and cb_lo per stage (64 KB) into a 3-stage ring on
//    mbarriers; rows past N or K are zero-filled by the copy. Two consumer
//    warpgroups of 64 rows each run wgmma.m64n128k8.f32.tf32.tf32 three
//    times per k8 step (hi.hi, hi.lo, lo.hi) into one fp32 accumulator.
//    Both operands are K-major in shared memory, as TF32 wgmma requires,
//    and that is the row-major layout of z and the codebook: nothing is
//    transposed. A 32-column fp32 tile row is one 128-byte swizzle row, so a
//    k8 step advances the descriptors by 32 bytes.
// 3. Fused epilogue per code tile: dist = e2[code] - 2 acc; each thread
//    scans its own accumulator columns in increasing code order with a
//    strict '<', keeping each of its two rows' (min, argmin) in registers
//    across the block's code tiles; the 4 lanes of a quad, which hold the
//    same rows, then combine with better().
// 4. vq_merge_kernel merges the splits of each row in increasing k, so the
//    first index wins across blocks too.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // z rows per block: two consumer warpgroups of 64
constexpr int BN = 128;        // codes per tile (the wgmma's N)
constexpr int BK = 32;         // fp32 columns per stage: one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int THREADS = 384;   // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int CONSUMER_WARPS = 8;
constexpr int TILE_BYTES = 128 * BK * 4;        // one operand tile, 16 KB
constexpr int STAGE_BYTES = 4 * TILE_BYTES;     // z hi, z lo, cb hi, cb lo
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;  // + alignment, barriers
constexpr int SPLIT_THREADS = 256;              // pre-pass: one warp per row

static_assert(BM == 128 && BN == 128, "the tensor maps' box is 128 rows for both operands");

// (v, i) beats (bv, bi): smaller distance, then smaller index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// TMA copy of the box at (column c0, row c1) of `map` into shared `dst`,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3}], [%4];\n"
               ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
               : "memory");
}

// wgmma shared-memory descriptor of a K-major tile whose rows are 128 bytes
// with the 128-byte swizzle, 1024-byte aligned: 8-row groups 1024 bytes apart
// (stride byte offset), leading byte offset unused by this layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= A . B^T for A 64 x 8 and B 128 x 8 TF32 in shared memory; d is the
// warpgroup's 64 x 128 fp32 accumulator, 64 values a thread. scale_d 0
// overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keep the compiler from moving reads or writes of the accumulator across
// the asynchronous wgmma's start and its wait.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) : : "memory");
}

// One warp per row of z (rows [0, n)) and of the codebook (rows [n, n + kp)):
// hi and lo of each element, columns [d, dp) zero; for the codebook also
// e2 = sum of squares in fp32, and +inf for the padding rows [k, kp).
__global__ void __launch_bounds__(SPLIT_THREADS)
vq_split_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                float* __restrict__ z_split, float* __restrict__ cb_split,
                float* __restrict__ e2, int n, int k, int kp, int d, int dp) {
  const int row = (blockIdx.x * SPLIT_THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n + kp) return;
  const bool is_z = row < n;
  const int r = is_z ? row : row - n;
  if (!is_z && r >= k) {
    if (lane == 0) e2[r] = INFINITY;
    return;
  }
  const int rows = is_z ? n : k;
  const float* src = (is_z ? z : cb) + static_cast<size_t>(r) * d;
  float* hi = (is_z ? z_split : cb_split) + static_cast<size_t>(r) * dp;
  float* lo = hi + static_cast<size_t>(rows) * dp;
  float s = 0.f;
  for (int c = lane; c < dp; c += 32) {
    const float x = c < d ? src[c] : 0.f;
    const float h = tf32_rna(x);
    hi[c] = h;
    lo[c] = tf32_rna(x - h);
    s = fmaf(x, x, s);
  }
  if (!is_z) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) e2[r] = s;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
vq_mma_kernel(const __grid_constant__ CUtensorMap z_hi, const __grid_constant__ CUtensorMap z_lo,
              const __grid_constant__ CUtensorMap cb_hi, const __grid_constant__ CUtensorMap cb_lo,
              const float* __restrict__ e2, float* __restrict__ part_val,
              int* __restrict__ part_idx, int n, int d_stages, int k_tiles,
              int tiles_per_split) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;  // the swizzle wants 1024 B
  const uint32_t full_bar = ring + STAGES * STAGE_BYTES;        // STAGES x 8 bytes
  const uint32_t empty_bar = full_bar + STAGES * 8;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(k_tiles, t_begin + tiles_per_split);
  const int n0 = blockIdx.x * BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        for (int ds = 0; ds < d_stages; ++ds) {
          const uint32_t full = full_bar + 8 * stage;
          mbar_wait(empty_bar + 8 * stage, phase ^ 1);
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                       ::"r"(full), "r"(STAGE_BYTES) : "memory");
          const uint32_t dst = ring + stage * STAGE_BYTES;
          tma_load(dst, &z_hi, ds * BK, n0, full);
          tma_load(dst + TILE_BYTES, &z_lo, ds * BK, n0, full);
          tma_load(dst + 2 * TILE_BYTES, &cb_hi, ds * BK, t * BN, full);
          tma_load(dst + 3 * TILE_BYTES, &cb_lo, ds * BK, t * BN, full);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup c takes rows [64 c, 64 c + 64) of the block's 128
  const int c = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = n0 + 64 * c + 16 * warp + lane / 4;  // and row0 + 8
  float acc[64] = {};
  float best0 = INFINITY, best1 = INFINITY;
  int arg0 = 0, arg1 = 0;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    for (int ds = 0; ds < d_stages; ++ds) {
      mbar_wait(full_bar + 8 * stage, phase);
      const uint32_t s0 = ring + stage * STAGE_BYTES;
      const uint64_t a_hi = smem_desc(s0 + 64 * c * 128);
      const uint64_t a_lo = smem_desc(s0 + TILE_BYTES + 64 * c * 128);
      const uint64_t b_hi = smem_desc(s0 + 2 * TILE_BYTES);
      const uint64_t b_lo = smem_desc(s0 + 3 * TILE_BYTES);
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint64_t off = 2 * kk;  // 8 fp32 = 32 bytes, in 16-byte units
        wgmma_tf32(acc, a_hi + off, b_hi + off, ds > 0 || kk > 0);
        wgmma_tf32(acc, a_hi + off, b_lo + off, 1);
        wgmma_tf32(acc, a_lo + off, b_hi + off, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(acc);
      if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    // acc[4 j + 2 h + x] is row row0 + 8 h, code t BN + 8 j + 2 (lane % 4) + x:
    // j, then x, is increasing code order, and '<' keeps the first index
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int code = t * BN + 8 * j + 2 * (lane % 4);
      const float2 e = __ldg(reinterpret_cast<const float2*>(e2 + code));
      const float ex[2] = {e.x, e.y};
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float v0 = ex[x] - 2.f * acc[4 * j + x];
        const float v1 = ex[x] - 2.f * acc[4 * j + 2 + x];
        arg0 = v0 < best0 ? code + x : arg0;
        best0 = fminf(v0, best0);
        arg1 = v1 < best1 ? code + x : arg1;
        best1 = fminf(v1, best1);
      }
    }
  }

  // the 4 lanes of a quad hold the same two rows
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float o0 = __shfl_xor_sync(0xffffffffu, best0, off);
    const int i0 = __shfl_xor_sync(0xffffffffu, arg0, off);
    const float o1 = __shfl_xor_sync(0xffffffffu, best1, off);
    const int i1 = __shfl_xor_sync(0xffffffffu, arg1, off);
    if (better(o0, i0, best0, arg0)) {
      best0 = o0;
      arg0 = i0;
    }
    if (better(o1, i1, best1, arg1)) {
      best1 = o1;
      arg1 = i1;
    }
  }
  if (lane % 4 == 0) {
    const size_t base = static_cast<size_t>(blockIdx.y) * n;
    if (row0 < n) {
      part_val[base + row0] = best0;
      part_idx[base + row0] = arg0;
    }
    if (row0 + 8 < n) {
      part_val[base + row0 + 8] = best1;
      part_idx[base + row0 + 8] = arg1;
    }
  }
}

// Merge the splits of each row in increasing k.
__global__ void vq_merge_kernel(const float* __restrict__ part_val,
                                const int* __restrict__ part_idx,
                                int* __restrict__ idx, int n, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float v = part_val[row];
  int vi = part_idx[row];
  for (int s = 1; s < splits; ++s) {
    const float ov = part_val[(size_t)s * n + row];
    const int oi = part_idx[(size_t)s * n + row];
    if (better(ov, oi, v, vi)) {
      v = ov;
      vi = oi;
    }
  }
  idx[row] = vi;
}

// Errors of the tensor-map set-up, outside cudaError_t's range.
constexpr int ERR_NO_ENCODER = -1;
constexpr int ERR_ENCODE = -2;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda.so.1 that the CUDA runtime
// has loaded (so the library links nothing new).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// Tensor map of a (rows, dp) fp32 row-major matrix, box 32 columns x 128
// rows with the 128-byte swizzle; rows past `rows` read as zeros.
int make_map(CUtensorMap* map, const float* base, int rows, int dp) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(dp), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(dp) * sizeof(float)};
  const cuuint32_t box[2] = {BK, 128};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

}  // namespace

// Scratch sizes: the depth padded to whole 32-column stages, and the codes
// padded to whole 128-code tiles (the length of e2).
extern "C" int ccvs_vq_padded_depth(int d) { return (d + BK - 1) / BK * BK; }
extern "C" int ccvs_vq_padded_codes(int k) { return (k + BN - 1) / BN * BN; }

// Number of code splits for n rows and k codes: one block per SM of a 132-SM
// H100 (the ring takes most of an SM's shared memory), no split empty.
extern "C" int ccvs_vq_splits(int n, int k) {
  const int row_tiles = (n + BM - 1) / BM;
  const int k_tiles = (k + BN - 1) / BN;
  int want = 132 / row_tiles;
  want = want < 1 ? 1 : (want > k_tiles ? k_tiles : want);
  const int per = (k_tiles + want - 1) / want;
  return (k_tiles + per - 1) / per;
}

// z (n, d) and cb (k, d) fp32, contiguous. Scratch: z_split (2, n, dp) and
// cb_split (2, k, dp) fp32, e2 (kp,) fp32 (dp, kp from the functions above),
// part_val / part_idx (splits * n) (splits from ccvs_vq_splits); output
// idx (n,) int32. Returns cudaGetLastError() after the launches, or a
// negative code if the tensor maps could not be made.
extern "C" int ccvs_vq_argmin(const void* z, const void* cb, void* z_split, void* cb_split,
                              void* e2, void* part_val, void* part_idx, void* idx, int n,
                              int k, int d, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = ccvs_vq_padded_depth(d);
  const int kp = ccvs_vq_padded_codes(k);
  float* zs = static_cast<float*>(z_split);
  float* cs = static_cast<float*>(cb_split);
  CUtensorMap maps[4];
  int err = make_map(&maps[0], zs, n, dp);
  if (err == 0) err = make_map(&maps[1], zs + static_cast<size_t>(n) * dp, n, dp);
  if (err == 0) err = make_map(&maps[2], cs, k, dp);
  if (err == 0) err = make_map(&maps[3], cs + static_cast<size_t>(k) * dp, k, dp);
  if (err != 0) return err;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(vq_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return e;
    configured = true;
  }

  const int split_rows = n + kp;
  vq_split_kernel<<<(split_rows * 32 + SPLIT_THREADS - 1) / SPLIT_THREADS, SPLIT_THREADS, 0, s>>>(
      static_cast<const float*>(z), static_cast<const float*>(cb), zs, cs,
      static_cast<float*>(e2), n, k, kp, d, dp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int k_tiles = kp / BN;
  const int tiles_per_split = (k_tiles + splits - 1) / splits;
  dim3 grid((n + BM - 1) / BM, splits);
  vq_mma_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(e2),
      static_cast<float*>(part_val), static_cast<int*>(part_idx), n, dp / BK, k_tiles,
      tiles_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  vq_merge_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_val), static_cast<const int*>(part_idx),
      static_cast<int*>(idx), n, splits);
  return cudaGetLastError();
}

// Message for a code returned by an entry point of this library.
extern "C" const char* ccvs_error_string(int err) {
  if (err == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (err == ERR_ENCODE) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

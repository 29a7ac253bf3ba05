// K1: nearest-codebook search, idx[n] = argmin_k (||e_k||^2 - 2 z_n . e_k).
//
// Replaces the Pallas TPU kernel ccvs_tpu/ops/vq_pallas.py (_vq_kernel,
// vq_indices_pallas). Same contract: fp32 accumulation, the first (smallest)
// index wins a tie, and the N x K distance matrix never reaches device memory.
//
// Bound on an H100 SXM: at the BAIR serving shape (z 2048 x 512, codebook
// 1024 x 512, fp32) the kernel does 2.1 GFLOP of fp32 on the CUDA cores and
// reads 6.3 MB, so it is bound by operations: 32 us at 67 TFLOP/s against
// 1.9 us for the bytes. The Pallas kernel fed the TPU's matrix unit; this one
// stays on the CUDA cores in plain fp32 (no TF32), because indices must match
// an fp32 argmin and TF32 keeps only ~3 decimal digits.
//
// Design. The TPU walks its grid in order and carries the running (min,
// argmin) of a row tile across the K sweep in scratch. Here blocks run in no
// order, so the K sweep is split across blocks to fill the 132 SMs (32 row
// tiles alone would leave 100 SMs idle): block (row tile, split) keeps each
// row's running (min, argmin) in registers over its share of codebook tiles,
// and a second small kernel merges the splits in increasing k. Codebook and z
// tiles are staged in shared memory; each of 256 threads computes a 4 x 4
// block of dot products, and ||e_k||^2 per tile is accumulated alongside.
// Ragged N, K and D are masked in the kernel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TN = 64;        // z rows per block
constexpr int TK = 64;        // codes per codebook tile
constexpr int TD = 32;        // feature depth per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, each 4 rows x 4 codes

// (v, i) beats (bv, bi): smaller distance, then smaller index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(THREADS)
vq_partial_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                  float* __restrict__ part_val, int* __restrict__ part_idx,
                  int n, int k, int d, int tiles_per_split) {
  __shared__ float zs[TD][TN + 1];
  __shared__ float cs[TD][TK + 1];
  const int tx = threadIdx.x % 16;  // code group
  const int ty = threadIdx.x / 16;  // row group
  const int n0 = blockIdx.x * TN;
  const int k_begin = blockIdx.y * tiles_per_split * TK;
  const int k_end = min(k, k_begin + tiles_per_split * TK);

  float best[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = INFINITY;
    best_i[i] = 0;
  }

  for (int kt = k_begin; kt < k_end; kt += TK) {
    float acc[4][4] = {};
    float e2[4] = {};
    for (int d0 = 0; d0 < d; d0 += TD) {
      for (int i = threadIdx.x; i < TN * TD; i += THREADS) {
        const int r = i / TD, c = i % TD;
        const int gr = n0 + r, gc = d0 + c;
        zs[c][r] = (gr < n && gc < d) ? z[(size_t)gr * d + gc] : 0.f;
      }
      for (int i = threadIdx.x; i < TK * TD; i += THREADS) {
        const int r = i / TD, c = i % TD;
        const int gr = kt + r, gc = d0 + c;
        cs[c][r] = (gr < k_end && gc < d) ? cb[(size_t)gr * d + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < TD; ++c) {
        float zv[4], cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) zv[i] = zs[c][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) cv[j] = cs[c][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(zv[i], cv[j], acc[i][j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) e2[j] = fmaf(cv[j], cv[j], e2[j]);
      }
      __syncthreads();
    }
    // codes in increasing order with a strict '<': the first index wins
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int code = kt + tx * 4 + j;
      if (code < k_end) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float dist = e2[j] - 2.f * acc[i][j];
          if (dist < best[i]) {
            best[i] = dist;
            best_i[i] = code;
          }
        }
      }
    }
  }

  // merge the 16 code groups of each row (lanes of one half-warp)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = best[i];
    int vi = best_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, vi, off);
      if (better(ov, oi, v, vi)) {
        v = ov;
        vi = oi;
      }
    }
    const int row = n0 + ty * 4 + i;
    if (tx == 0 && row < n) {
      part_val[(size_t)blockIdx.y * n + row] = v;
      part_idx[(size_t)blockIdx.y * n + row] = vi;
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

}  // namespace

// Number of K splits for n rows and k codes: about 4 blocks per SM of a
// 132-SM H100, at most one split per codebook tile.
extern "C" int ccvs_vq_splits(int n, int k) {
  const int row_tiles = (n + TN - 1) / TN;
  const int k_tiles = (k + TK - 1) / TK;
  const int want = (4 * 132 + row_tiles - 1) / row_tiles;
  const int splits = want < k_tiles ? want : k_tiles;
  return splits > 1 ? splits : 1;
}

// z (n, d) fp32, cb (k, d) fp32, both contiguous; part_val / part_idx hold
// splits * n entries (splits from ccvs_vq_splits); idx (n,) int32.
// Returns cudaGetLastError() after both launches.
extern "C" int ccvs_vq_argmin(const void* z, const void* cb, void* part_val,
                              void* part_idx, void* idx, int n, int k, int d,
                              int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_tiles = (k + TK - 1) / TK;
  const int tiles_per_split = (k_tiles + splits - 1) / splits;  // a split past k finds no code
  dim3 grid((n + TN - 1) / TN, splits);
  vq_partial_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(z), static_cast<const float*>(cb),
      static_cast<float*>(part_val), static_cast<int*>(part_idx), n, k, d,
      tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vq_merge_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_val), static_cast<const int*>(part_idx),
      static_cast<int*>(idx), n, splits);
  return cudaGetLastError();
}

// Message for a code returned by an entry point above.
extern "C" const char* ccvs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

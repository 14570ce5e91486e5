// P1 and P2: the row-gather probes of tools/gather_micro.py as hand-written
// kernels for Hopper (sm_90a); built by nvcc into a shared library with a plain
// C interface and called through ctypes (mopa_tpu_torch/ops/gather.py).
//
// P1 (mopa_row_gather) replaces the Pallas TPU kernel tools/gather_micro.py::
// kern in pallas_gather: a per-sample row gather
//   out[s, i, :] = tab[s, idx[s, i], :]
// with tab (S, V, D) bfloat16, idx (S, N) int32, out (S, N, D) bfloat16. (The
// reference's body reads the whole (1, V, 3C) block where it means the
// sample's (V, 3C) table; this computes what it means, as its fused sibling
// indexes it.)
//
// P2 (mopa_gather_gemm) replaces kern in fused: the same gather fused with
// the wide-column GEMM of the level-0 conv,
//   out[s, v, :] = bf16( sum over j < 8 of tab[s, idx[s, 8v+j], :] @ w[jD:(j+1)D, :] ),
// with w (8D, 16) bfloat16, out (S, N/8, 16) bfloat16, products accumulated in
// float32.
//
// An index outside [0, V) is a caller error; it reads nothing and gives a row
// of zeros.
//
// Bound on this card: both are bytes-bound. P1 writes 8 rows for every table
// row it reads (at the probe's shape 302 MB of output against 38 MB of table
// and 13 MB of ranks); P2 reads the same table and ranks but writes only 13 MB,
// while its 2*8D*16 FLOPs per output row are ~4x below what the memory time
// leaves on the tensor cores. PERF.md has the numbers.
//
// Design (simple and right first):
// * P1: a block is (D/8 chunk lanes) x (256 / (D/8) rows); each thread copies
//   one 16-byte vector, so a warp's loads cover whole rows and its stores are
//   one contiguous run of the output. The ranks of a sample are sorted, so
//   consecutive blocks read nearby rows of a 1.5 MiB table that stays in L2;
//   the output is written with streaming stores so it does not evict it.
// * P2: a CTA owns 64 output rows x 16 columns and walks the 8 taps. For each
//   tap it stages the tap's D x 16 weight slice (float32) and the 64 gathered
//   rows (16-byte loads, widened to float32) in shared memory; each of its 128
//   threads keeps 2 rows x 4 columns of the output in float32 registers.
//   CUDA cores only: tensor cores come with the pair-driven conv redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 8;            // bfloat16 lanes per 16-byte vector
constexpr int kGatherThreads = 256;  // P1 threads per block (at most)
constexpr int kTaps = 8;             // wide columns per output row (P2)
constexpr int kTileRows = 64;        // P2 output rows per CTA
constexpr int kGemmThreads = 128;    // P2 threads per CTA
constexpr int kCout = 16;            // P2 output columns
constexpr int kDMax = 128;           // P2's widest row (bfloat16 lanes)

__global__ void row_gather_kernel(const uint4* __restrict__ tab,
                                  const int* __restrict__ idx,
                                  uint4* __restrict__ out, int n, int v) {
  const int chunks = blockDim.x;
  const int s = blockIdx.y;
  const int i = blockIdx.x * blockDim.y + threadIdx.y;
  if (i >= n) return;
  const size_t row = static_cast<size_t>(s) * n + i;
  const int src = __ldg(idx + row);
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (src >= 0 && src < v)
    val = __ldg(tab + (static_cast<size_t>(s) * v + src) * chunks +
                threadIdx.x);
  __stcs(out + row * chunks + threadIdx.x, val);
}

__global__ void __launch_bounds__(kGemmThreads)
gather_gemm_kernel(const __nv_bfloat16* __restrict__ tab,
                   const int* __restrict__ idx,
                   const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ out, int m, int v, int d) {
  __shared__ float a_s[kTileRows][kDMax + 1];  // +1: rows on distinct banks
  __shared__ __align__(16) float w_s[kDMax][kCout];
  __shared__ int src_s[kTileRows];

  const int tid = threadIdx.x;
  const int s = blockIdx.y;
  const int r0 = blockIdx.x * kTileRows;
  const int cg = tid % 4;   // output columns 4*cg .. 4*cg+3
  const int rg = tid / 4;   // output rows rg and rg + 32 of the tile
  const int chunks = d / kLanes;

  float acc[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[h][q] = 0.f;

  for (int j = 0; j < kTaps; ++j) {
    if (tid < kTileRows) {
      const int r = r0 + tid;
      int src = -1;
      if (r < m) {
        src = __ldg(idx + (static_cast<size_t>(s) * m + r) * kTaps + j);
        if (src < 0 || src >= v) src = -1;
      }
      src_s[tid] = src;
    }
    const __nv_bfloat16* wj = w + static_cast<size_t>(j) * d * kCout;
    for (int e = tid; e < d * kCout; e += kGemmThreads)
      w_s[e / kCout][e % kCout] = __bfloat162float(wj[e]);
    __syncthreads();

    for (int e = tid; e < kTileRows * chunks; e += kGemmThreads) {
      const int rr = e / chunks;
      const int c = e - rr * chunks;
      const int src = src_s[rr];
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (src >= 0)
        raw = __ldg(reinterpret_cast<const uint4*>(
                        tab + (static_cast<size_t>(s) * v + src) * d) + c);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float* dst = &a_s[rr][c * kLanes];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(h2[q]);
        dst[2 * q] = f.x;
        dst[2 * q + 1] = f.y;
      }
    }
    __syncthreads();

    for (int k = 0; k < d; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(&w_s[k][cg * 4]);
      const float a0 = a_s[rg][k];
      const float a1 = a_s[rg + 32][k];
      acc[0][0] = fmaf(a0, wv.x, acc[0][0]);
      acc[0][1] = fmaf(a0, wv.y, acc[0][1]);
      acc[0][2] = fmaf(a0, wv.z, acc[0][2]);
      acc[0][3] = fmaf(a0, wv.w, acc[0][3]);
      acc[1][0] = fmaf(a1, wv.x, acc[1][0]);
      acc[1][1] = fmaf(a1, wv.y, acc[1][1]);
      acc[1][2] = fmaf(a1, wv.z, acc[1][2]);
      acc[1][3] = fmaf(a1, wv.w, acc[1][3]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + rg + 32 * h;
    if (r >= m) continue;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
        out + (static_cast<size_t>(s) * m + r) * kCout + cg * 4);
    o[0] = __floats2bfloat162_rn(acc[h][0], acc[h][1]);
    o[1] = __floats2bfloat162_rn(acc[h][2], acc[h][3]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// P1. tab (s, v, d) and out (s, n, d) bfloat16, idx (s, n) int32, all
// contiguous and 16-byte aligned; d a multiple of 8 lanes, at most 2048.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int mopa_row_gather(const void* tab, const void* idx, void* out,
                               int s, int v, int n, int d, void* stream) {
  if (s < 1 || s > 65535 || v < 1 || n < 0 || d < kLanes || d % kLanes != 0 ||
      d / kLanes > kGatherThreads || !aligned16(tab) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int chunks = d / kLanes;
  const dim3 block(chunks, kGatherThreads / chunks);
  const dim3 grid((n + block.y - 1) / block.y, s);
  row_gather_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(tab), static_cast<const int*>(idx),
      static_cast<uint4*>(out), n, v);
  return static_cast<int>(cudaGetLastError());
}

// P2. tab (s, v, d) bfloat16, idx (s, 8m) int32, w (8d, 16) bfloat16, out
// (s, m, 16) bfloat16, all contiguous; tab 16-byte aligned, out 8-byte
// aligned; d a multiple of 8 lanes, at most 128; cout must be 16. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int mopa_gather_gemm(const void* tab, const void* idx,
                                const void* w, void* out, int s, int v, int m,
                                int d, int cout, void* stream) {
  if (s < 1 || s > 65535 || v < 1 || m < 0 || d < kLanes ||
      d % kLanes != 0 || d > kDMax || cout != kCout || !aligned16(tab) ||
      (reinterpret_cast<uintptr_t>(out) & 7u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const dim3 grid((m + kTileRows - 1) / kTileRows, s);
  gather_gemm_kernel<<<grid, kGemmThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(tab), static_cast<const int*>(idx),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      m, v, d);
  return static_cast<int>(cudaGetLastError());
}

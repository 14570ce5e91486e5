// K2, weight half: d_w of the submanifold 3x3x3 sparse convolution over a
// flat wide-column plan. Hand-written for Hopper (sm_90a); built by nvcc into
// a shared library with a plain C interface and called through ctypes
// (mopa_tpu_torch/ops/sparse_conv_cuda.py). The d_feats half of the backward
// runs K1's kernel in its mirror mode (submanifold_conv.cu).
//
// Replaces the d_w half of the Pallas TPU kernel
// mopa_tpu/ops/sparse_conv_pallas.py::_bwd_kernel, which accumulated
// feats^T @ aligned_g into one VMEM-resident (9*Cin, 3*Cout) block across its
// sequential grid. On this card blocks run in parallel and in no order, so the
// sum over voxels is split into a fixed number of voxel ranges: each CTA writes
// the partial sum of its range, and a second kernel adds the ranges in a fixed
// order. No floating-point atomics: two runs give the same bits.
//
// What it computes (the direct form; JAX's mirror form sums the same pairs):
//   d_w[k][ci][co] = sum over voxels v whose kernel offset k exists of
//                    feats[row(v, k)][ci] * g[v][co],
// with row(v, k) resolved from the plan exactly as K1 resolves it (column
// c = k / 3 holds rows ranks[v*9+c] + j; the dz code of row j must be k % 3;
// rows outside [0, V) never count). Neither g nor feats is masked: padding
// slots have all-miss codes, so they take part in no pair. Inputs are float32
// or bfloat16; products are accumulated in float32 and d_w is float32.
//
// Bound on this card: 2*Cin*Cout FLOPs per existing neighbour pair against
// (Cin + Cout) * dtype + 72 bytes per voxel read once, so the float32 CUDA-core
// rate (or, in bfloat16, the memory rate at narrow widths) bounds it; PERF.md
// has the numbers.
//
// Design (simple and right first; tensor cores and pair compaction come
// later): grid = (voxel ranges, 27 offsets, ceil(Cin / 32)). A CTA owns a
// 32 x Cout (<= 192) block of d_w[k] in registers (4 input channels x
// ceil(Cout/32) output channels per thread) and walks its voxel range in
// chunks of 32: it resolves the chunk's source rows for offset k, skips the
// chunk if none exists, stages the 32 gathered feats rows (its 32 channels)
// and the chunk's 32 g rows in shared memory (zero where the pair is absent),
// and runs the FMA loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunkV = 32;         // voxels per staged chunk
constexpr int kTileCi = 32;         // input channels per CTA
constexpr int kCoutMax = 192;       // widest Cout the register tile holds
constexpr int kThreadsX = 32;       // output channels per pass
constexpr int kThreadsY = 8;        // input-channel rows per pass
constexpr int kCiRows = kTileCi / kThreadsY;
constexpr int kRowsPerRange = 2048;  // target voxels per range
constexpr int kMaxRanges = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Voxel ranges for V rows: a function of V alone, so the summation order (and
// the result's bits) never changes between runs.
int num_ranges(int V) {
  const int n = (V + kRowsPerRange - 1) / kRowsPerRange;
  return n < 1 ? 1 : (n > kMaxRanges ? kMaxRanges : n);
}

int rows_per_range(int V) {
  const int n = num_ranges(V);
  const int rows = (V + n - 1) / n;
  return (rows + kChunkV - 1) / kChunkV * kChunkV;
}

// NM = ceil(Cout / 32). partial is (ranges, 27, cin, cout) float32.
template <typename T, int NM>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
subm_conv_dw_partial(const T* __restrict__ feats, const T* __restrict__ g,
                     const int* __restrict__ ranks,
                     const int* __restrict__ sel, float* __restrict__ partial,
                     int V, int cin, int cout, int range_rows) {
  __shared__ int src_s[kChunkV];
  __shared__ float a_s[kChunkV][kTileCi];
  __shared__ float g_s[kChunkV][kCoutMax];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int nthreads = kThreadsX * kThreadsY;
  const int range = blockIdx.x;
  const int k = blockIdx.y;
  const int ci0 = blockIdx.z * kTileCi;
  const int col = k / 3;
  const int slot = k % 3;
  const int kc = min(kTileCi, cin - ci0);
  const long long v_begin = static_cast<long long>(range) * range_rows;
  const long long v_end =
      min(static_cast<long long>(V), v_begin + range_rows);

  float acc[kCiRows][NM];
#pragma unroll
  for (int i = 0; i < kCiRows; ++i)
#pragma unroll
    for (int m = 0; m < NM; ++m) acc[i][m] = 0.f;

  for (long long vb = v_begin; vb < v_end; vb += kChunkV) {
    int row = -1;
    if (tid < kChunkV) {
      const long long v = vb + tid;
      if (v < v_end) {
        const int r = ranks[v * 9 + col];
        const int code = sel[v * 9 + col];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const long long rr = static_cast<long long>(r) + j;
          if (((code >> (2 * j)) & 3) == slot && rr >= 0 && rr < V)
            row = static_cast<int>(rr);
        }
      }
      src_s[tid] = row;
    }
    // barrier + vote: skip chunks where no voxel has offset k (uniform)
    if (!__syncthreads_or(row >= 0)) continue;

    for (int i = tid; i < kChunkV * kTileCi; i += nthreads) {
      const int vv = i / kTileCi;
      const int kk = i % kTileCi;
      const int r = src_s[vv];
      a_s[vv][kk] = (r >= 0 && kk < kc)
                        ? to_f32(feats[static_cast<size_t>(r) * cin + ci0 + kk])
                        : 0.f;
    }
    for (int i = tid; i < kChunkV * cout; i += nthreads) {
      const int vv = i / cout;
      const int co = i % cout;
      g_s[vv][co] =
          src_s[vv] >= 0
              ? to_f32(g[static_cast<size_t>(vb + vv) * cout + co])
              : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int vv = 0; vv < kChunkV; ++vv) {
      float gv[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int co = tx + kThreadsX * m;
        gv[m] = co < cout ? g_s[vv][co] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kCiRows; ++i) {
        const float a = a_s[vv][ty + kThreadsY * i];
#pragma unroll
        for (int m = 0; m < NM; ++m) acc[i][m] = fmaf(a, gv[m], acc[i][m]);
      }
    }
    __syncthreads();
  }

  float* out = partial + (static_cast<size_t>(range) * 27 + k) * cin * cout;
#pragma unroll
  for (int i = 0; i < kCiRows; ++i) {
    const int ci = ci0 + ty + kThreadsY * i;
    if (ci >= cin) continue;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int co = tx + kThreadsX * m;
      if (co < cout) out[static_cast<size_t>(ci) * cout + co] = acc[i][m];
    }
  }
}

// d_w[i] = sum over r = 0 .. ranges-1, in that order, of partial[r][i].
__global__ void subm_conv_dw_reduce(const float* __restrict__ partial,
                                    float* __restrict__ dw, int ranges,
                                    long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
      + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int r = 0; r < ranges; ++r) s += partial[r * n + i];
  dw[i] = s;
}

template <typename T>
void launch(int nm, const void* feats, const void* g, const void* ranks,
            const void* sel, float* partial, int V, int cin, int cout,
            cudaStream_t stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid(num_ranges(V), 27, (cin + kTileCi - 1) / kTileCi);
  const int rows = rows_per_range(V);
  const T* f = static_cast<const T*>(feats);
  const T* gg = static_cast<const T*>(g);
  const int* r = static_cast<const int*>(ranks);
  const int* s = static_cast<const int*>(sel);
  switch (nm) {
#define MOPA_CASE(N)                                                       \
    case N:                                                                \
      subm_conv_dw_partial<T, N><<<grid, block, 0, stream>>>(              \
          f, gg, r, s, partial, V, cin, cout, rows);                       \
      break;
    MOPA_CASE(1) MOPA_CASE(2) MOPA_CASE(3) MOPA_CASE(4) MOPA_CASE(5)
    default: MOPA_CASE(6)
#undef MOPA_CASE
  }
}

}  // namespace

// Voxel ranges the d_w reduction splits V rows into; the caller allocates a
// (ranges, 27, cin, cout) float32 scratch for mopa_subm_conv_bwd_dw.
extern "C" int mopa_subm_conv_dw_ranges(int V) { return num_ranges(V); }

// feats (V, cin) and g (V, cout) are float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1), contiguous; ranks and sel are int32 (V*9); partial is the
// scratch above; dw (27, cin, cout) float32. Launches both kernels on `stream`
// and returns cudaGetLastError().
extern "C" int mopa_subm_conv_bwd_dw(const void* feats, const void* g,
                                     const void* ranks, const void* sel,
                                     void* partial, void* dw, int V, int cin,
                                     int cout, int is_bf16, void* stream) {
  if (cin < 1 || cout < 1 || cout > kCoutMax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = 27LL * cin * cout;
  if (V <= 0) return static_cast<int>(cudaMemsetAsync(dw, 0, n * 4, st));
  const int nm = (cout + kThreadsX - 1) / kThreadsX;
  float* p = static_cast<float*>(partial);
  if (is_bf16)
    launch<__nv_bfloat16>(nm, feats, g, ranks, sel, p, V, cin, cout, st);
  else
    launch<float>(nm, feats, g, ranks, sel, p, V, cin, cout, st);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int threads = 256;
  subm_conv_dw_reduce<<<static_cast<unsigned>((n + threads - 1) / threads),
                        threads, 0, st>>>(p, static_cast<float*>(dw),
                                          num_ranges(V), n);
  return static_cast<int>(cudaGetLastError());
}

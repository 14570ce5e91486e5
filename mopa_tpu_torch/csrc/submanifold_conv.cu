// K1: submanifold 3x3x3 sparse convolution, forward, over a flat wide-column
// plan, and the d_feats half of its backward (K2). Hand-written for Hopper
// (sm_90a); built by nvcc into a shared library with a plain C interface and
// called through ctypes (mopa_tpu_torch/ops/sparse_conv_cuda.py).
//
// Replaces the Pallas TPU kernel mopa_tpu/ops/sparse_conv_pallas.py::
// _conv_kernel (+ _gather_window), and the d_feats half of _bwd_kernel: the
// backward's d_feats is the SAME windowed conv of the cotangent g with the
// mirrored, transposed weight W'[k] = W[26-k]^T (u is v's neighbour at offset
// o iff v is u's at -o, and the offsets enumerate symmetrically). The mirror
// mode below reads W' straight out of the forward weight, so no transposed
// copy is made. The Pallas kernels kept a whole per-sample feature table in
// VMEM. A 15,564-row table does not fit an SM's shared memory, so this
// kernel works on the GLOBAL flat plan instead: no per-sample localisation.
//
// What it computes, for every voxel v and every (dx, dy) column c (0..8):
// rows ranks[v*9+c] + j, j = 0..2, are the column's consecutive z-run; the
// packed code sel[v*9+c] holds, in bits [2j, 2j+2), the dz slot t (0..2) that
// row j feeds, 3 = none. Slot t of column c multiplies kernel offset k = 3c+t,
// i.e. weight[k] (Cin x Cout). out[v] = sum over the existing (row, k) pairs
// of feats[row] @ weight[k], accumulated in float32, written in the feature
// dtype (float32 or bfloat16). Rows outside [0, V) never contribute: the
// all-miss sentinel of the last sample points one past the table.
//
// Bound on this card: at the shapes of the eval path the work is
// 2*Cin*Cout FLOPs per existing neighbour pair (about 10-20 pairs per voxel of
// 27) against (Cin+Cout)*dtype + 72 bytes of compulsory traffic per voxel, so
// in float32 the card's CUDA-core rate bounds it and in bfloat16 the memory
// rate does (see PERF.md for the numbers).
//
// Design (simple and right first; wgmma/TMA come later): one CTA owns a tile
// of 64 voxels and all Cout (<= 192, the widest d_feats of the backward:
// l5_conv2's Cin) outputs, kept in registers
// (8 voxels x ceil(Cout/32) channels per thread). It first resolves, for each
// of its voxels, the source row of each of the 27 kernel offsets into shared
// memory. Then, for each offset that any voxel of the tile has, it gathers the
// tile's rows through L1/L2 in 32-channel chunks into shared memory (zero where
// absent), stages the matching 32 x Cout slice of weight[k] next to it, and
// runs the FMA loop. Offsets no voxel of the tile has are skipped. No whole
// table and no whole weight is ever staged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileV = 64;       // voxels per CTA
constexpr int kChunk = 32;       // input channels per staged chunk
constexpr int kCoutMax = 192;    // widest Cout the register tile holds
constexpr int kThreadsX = 32;    // output channels per pass
constexpr int kThreadsY = 8;     // voxel rows per pass
constexpr int kRows = kTileV / kThreadsY;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// NM = ceil(Cout / 32): output-channel passes held per thread. mirror = 0:
// weight is (27, cin, cout) and offset k multiplies weight[k]. mirror = 1 (the
// backward's d_feats): weight is the forward's (27, cout, cin) and offset k
// multiplies weight[26 - k]^T.
template <typename T, int NM>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
subm_conv_fwd_kernel(const T* __restrict__ feats, const int* __restrict__ ranks,
                     const int* __restrict__ sel, const T* __restrict__ weight,
                     T* __restrict__ out, int V, int cin, int cout,
                     int mirror) {
  __shared__ int src_s[kTileV][27];
  __shared__ int any_s[27];
  __shared__ float a_s[kTileV][kChunk];
  // +1 column: the mirror mode writes along kk, which would otherwise hit one
  // bank 32 times
  __shared__ float w_s[kChunk][kCoutMax + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int nthreads = kThreadsX * kThreadsY;
  const long long v0 = static_cast<long long>(blockIdx.x) * kTileV;

  for (int i = tid; i < kTileV * 27; i += nthreads) (&src_s[0][0])[i] = -1;
  if (tid < 27) any_s[tid] = 0;
  __syncthreads();

  // Resolve each voxel's source row per kernel offset. Codes strictly
  // increase along j, so no two rows of a column share a slot.
  for (int i = tid; i < kTileV * 9; i += nthreads) {
    const int lv = i / 9;
    const int c = i % 9;
    const long long v = v0 + lv;
    if (v >= V) continue;
    const int r = ranks[v * 9 + c];
    const int code = sel[v * 9 + c];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int t = (code >> (2 * j)) & 3;
      const long long row = static_cast<long long>(r) + j;
      if (t < 3 && row >= 0 && row < V) {
        src_s[lv][3 * c + t] = static_cast<int>(row);
        any_s[3 * c + t] = 1;
      }
    }
  }
  __syncthreads();

  float acc[kRows][NM];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int m = 0; m < NM; ++m) acc[r][m] = 0.f;

  for (int k = 0; k < 27; ++k) {
    if (!any_s[k]) continue;  // uniform across the CTA
    const T* wk = weight + static_cast<size_t>(mirror ? 26 - k : k) * cin * cout;
    for (int k0 = 0; k0 < cin; k0 += kChunk) {
      const int kc = min(kChunk, cin - k0);
      for (int i = tid; i < kTileV * kChunk; i += nthreads) {
        const int lv = i / kChunk;
        const int kk = i % kChunk;
        const int row = src_s[lv][k];
        float val = 0.f;
        if (row >= 0 && kk < kc)
          val = to_f32(feats[static_cast<size_t>(row) * cin + k0 + kk]);
        a_s[lv][kk] = val;
      }
      if (mirror) {  // wk is (cout, cin): walk kk fastest for coalesced reads
        for (int i = tid; i < kc * cout; i += nthreads) {
          const int kk = i % kc;
          const int co = i / kc;
          w_s[kk][co] = to_f32(wk[static_cast<size_t>(co) * cin + k0 + kk]);
        }
      } else {
        for (int i = tid; i < kc * cout; i += nthreads) {
          const int kk = i / cout;
          const int co = i % cout;
          w_s[kk][co] = to_f32(wk[static_cast<size_t>(k0 + kk) * cout + co]);
        }
      }
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk) {
        float w[NM];
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          const int co = tx + kThreadsX * m;
          w[m] = co < cout ? w_s[kk][co] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float a = a_s[ty + kThreadsY * r][kk];
#pragma unroll
          for (int m = 0; m < NM; ++m) acc[r][m] = fmaf(a, w[m], acc[r][m]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long v = v0 + ty + kThreadsY * r;
    if (v >= V) continue;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int co = tx + kThreadsX * m;
      if (co < cout) out[v * cout + co] = from_f32<T>(acc[r][m]);
    }
  }
}

template <typename T>
void launch(int nm, const void* feats, const void* ranks, const void* sel,
            const void* weight, void* out, int V, int cin, int cout,
            int mirror, cudaStream_t stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((V + kTileV - 1) / kTileV);
  const T* f = static_cast<const T*>(feats);
  const int* r = static_cast<const int*>(ranks);
  const int* s = static_cast<const int*>(sel);
  const T* w = static_cast<const T*>(weight);
  T* o = static_cast<T*>(out);
  switch (nm) {
#define MOPA_CASE(N)                                                       \
    case N:                                                                \
      subm_conv_fwd_kernel<T, N><<<grid, block, 0, stream>>>(              \
          f, r, s, w, o, V, cin, cout, mirror);                            \
      break;
    MOPA_CASE(1) MOPA_CASE(2) MOPA_CASE(3) MOPA_CASE(4) MOPA_CASE(5)
    default: MOPA_CASE(6)
#undef MOPA_CASE
  }
}

int run(const void* feats, const void* ranks, const void* sel,
        const void* weight, void* out, int V, int cin, int cout, int is_bf16,
        int mirror, void* stream) {
  if (V <= 0) return 0;
  if (cin < 1 || cout < 1 || cout > kCoutMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nm = (cout + kThreadsX - 1) / kThreadsX;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(nm, feats, ranks, sel, weight, out, V, cin, cout,
                          mirror, st);
  else
    launch<float>(nm, feats, ranks, sel, weight, out, V, cin, cout, mirror,
                  st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. feats (V, cin), weight (27, cin, cout) and out (V, cout) are float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1), contiguous; ranks and sel are
// int32 (V*9). Launches on `stream` and returns cudaGetLastError().
extern "C" int mopa_subm_conv_fwd(const void* feats, const void* ranks,
                                  const void* sel, const void* weight,
                                  void* out, int V, int cin, int cout,
                                  int is_bf16, void* stream) {
  return run(feats, ranks, sel, weight, out, V, cin, cout, is_bf16, 0,
             stream);
}

// K2, d_feats half: d_feats (V, cin) = the windowed conv of g (V, cout) with
// W'[k] = weight[26 - k]^T, where weight is the FORWARD weight (27, cin,
// cout). Types and layout as mopa_subm_conv_fwd.
extern "C" int mopa_subm_conv_bwd_dfeats(const void* g, const void* ranks,
                                         const void* sel, const void* weight,
                                         void* d_feats, int V, int cin,
                                         int cout, int is_bf16, void* stream) {
  return run(g, ranks, sel, weight, d_feats, V, cout, cin, is_bf16, 1,
             stream);
}

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
// sum is split into ranges (of voxels on the bfloat16 route, of each
// offset's neighbour pairs on the float32 route; the wrapper picks their
// length from V alone): each CTA writes the partial sum of its range, and a
// second kernel adds the ranges in a fixed order. No floating-point atomics:
// two runs give the same bits.
//
// What it computes (JAX's mirror form, _bwd_kernel's `dw_ref +=` line): the
// column-c block (Cin x 3*Cout) is
//   P_c = sum over voxels v of feats[v]^T (x) aligned_g_c[v],
// where aligned_g_c[v] is column c's dz-aligned window of the cotangent g
// (slot t holds g[row] for the row of v's column c with dz code t, zeros
// where there is none; rows are resolved from the plan exactly as K1
// resolves them, and rows outside [0, V) never count). Then
// d_w[26 - (3c + t)][ci][co] = P_c[ci][t*Cout + co]. Neither g nor feats is
// masked: padding slots have all-miss codes, so they take part in no pair.
// d_w is float32.
//
// Two routes, chosen by the wrapper from the dtype:
//
// * bfloat16 (the train step): subm_conv_dw_tc_kernel, tensor cores. What
//   bounds it: 2*Cin*Cout FLOPs per existing neighbour pair against
//   (Cin + Cout) * 2 + 72 bytes per voxel, so memory bounds it; in practice
//   the gather of g's z-runs (its L2 latency) and the partial sums' traffic.
//   Design:
//   - A CTA owns (a voxel range, a column c, a block of 16*wm input
//     channels) and its (16*wm) x (3*Cout padded) block of P_c, in float32
//     registers: 8 warps as wm (channel rows) x 8/wm (output columns), each
//     warp 16 x 16*NT.
//   - It resolves the column's 3 slot rows for up to kSeg voxels of its
//     range at once into shared memory, and lists the kKV-voxel chunks in
//     which column c has any pair; only those are staged (padding costs one
//     pass over its plan entries).
//   - Per chunk, A is the chunk's feats rows: dense and contiguous, one
//     cp.async per 16 bytes. B is the chunk's aligned g windows, gathered by
//     cp.async from the resolved rows (zero-filled where a slot is empty).
//     g is staged once per (range, column) and channel block, where a
//     per-offset kernel would stage it 27 * ceil(Cin / 32) times.
//   - A kDwStages-deep ring of cp.async groups keeps the next chunks'
//     copies in flight while the current one multiplies, one barrier per
//     chunk. The product runs on mma.sync m16n8k16 (bf16 -> f32), both
//     operands by ldmatrix.trans: A^T = feats^T from voxel-major rows, B
//     from voxel-major windows.
//   - The partial block goes to a (ranges, 9, Cin, 3*Cout) float32 scratch;
//     subm_conv_dw_reduce adds the ranges in order and writes the
//     mirrored (27, Cin, Cout) layout.
//   - The stem (Cin = 1: rows below cp.async's 16 bytes) stages its feats
//     with plain loads into the same layout.
//
// * float32 (the checking paths, the convergence run and SPVCNN's float32
//   decoder): pair-compacted and weight-stationary, on the tensor cores in
//   3xTF32 (tensor_core.cuh), so float32 stays within 1e-4 of the plain
//   twin. d_w needs no window and no scatter: offset k's block is a plain
//   GEMM over the neighbour pairs that exist at k,
//     d_w[k] = sum over pairs (i, o) of offset k of feats[i]^T (x) g[o],
//   (i, o) = (v, the row of v's column c in slot t), k = 26 - (3c + t).
//   SPVCNN's decoder levels hold 1.9 to 13 of the 27 pairs a voxel could
//   have, so a zero-filled 27-slot window is mostly zeros. What bounds it:
//   3 * 2 * pairs * Cin * Cout TF32 MMA operations (three MMAs a product)
//   against the gathered bytes, a feats row and a g row per pair and
//   (Cin, Cout) tile: 4 * pairs * (Cin * Cout/Nc + Cout * Cin/Mc), 96
//   operations a byte at a 128 x 128 tile, so the MMAs and the
//   instructions around them, not the bytes. Design:
//   - Pair lists, built on the device from the plan alone:
//     subm_conv_dw_pairs_count counts each offset's pairs in blocks of
//     kPairVoxels voxels; subm_conv_dw_pairs_write writes each block's
//     pairs, ascending by voxel, after the earlier blocks' (warp ballots,
//     then a scan over the warps), into a list of capacity V per offset,
//     and the last block writes the counts. Every grid is sized from V:
//     no host wait. The same lists feed K1 and d_feats on this route
//     (submanifold_conv.cu): for them the write kernel also records where
//     each span of output voxels begins in each list (a span starts at
//     some warp's first voxel, whose slot the scan already gives), and a
//     backward builds one set for d_feats and d_w together.
//   - A CTA owns (offset k, a range of k's pairs, a 32*wm block of Cin, a
//     32*wn block of Cout), the grid sized from V and the shapes alone;
//     CTAs past the offset's count exit at once. It is weight-stationary:
//     its block of d_w[k] stays in float32 registers while the range's
//     pairs stream through, wm x wn warps of 32 x 32, so nothing is
//     scattered and each pair is staged once per channel tile.
//   - The range's pair entries go to shared memory kPairSeg at a time;
//     per stage, kKP pairs' feats rows (A^T) and g rows (B) are gathered
//     by cp.async into a kPairStages-deep ring, zero past the range and
//     past Cin / Cout. Rows narrower than 16 bytes (the stem's Cin = 1) or
//     not 16-byte aligned take plain loads into the same layout.
//   - Fragments come by 128-bit shared loads: the MMA's rows and columns
//     are permuted so that lane g's four channels 4g..4g+3 of a warp's
//     32 feed it (m-tile u, row g + 8h is channel 4g + 2u + h; n-block j,
//     column n is channel 4n + j; the epilogue undoes it). Rows are padded
//     by 8 floats, so a quarter warp's loads hit distinct banks. Four
//     loads feed 24 MMAs per 8 pairs.
//   - Each fragment is split into its TF32 high and low parts in
//     registers by the warp that reads it (cp.async stages the floats as
//     they are, so there is no staging pass to split them once), and each
//     product accumulates lo*hi + hi*lo + hi*hi.
//   - Each MMA's three products sum from zero and join the float32
//     accumulator by an add: the MMA's own accumulation drops low bits,
//     and chained over a range it drifts past float32's rounding
//     (submanifold_conv.cu says how far).
//   - The partial block goes to a (ranges, 27, Cin, Cout) float32 scratch
//     (the size of the bfloat16 route's); subm_conv_dw_pairs_reduce adds
//     each offset's ranges that hold pairs in order. No floating-point
//     atomics: the same inputs give the same bits.

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kCoutMax = 192;  // widest Cout either route holds

// ---------------------------------------------------------------- bfloat16

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKV = 32;          // voxels (the GEMM's K) per pipeline stage
constexpr int kSeg = 2048;       // voxels whose rows a CTA resolves at once
constexpr int kChunks = kSeg / kKV;
constexpr int kDwStages = 3;     // cp.async ring depth

// Dynamic shared memory for a (16*wm) x np_cta CTA tile: 3 slot rows per
// voxel of a segment, the chunk flags and list, then the (A, B) ring.
constexpr int dw_smem_bytes(int wm, int np_cta) {
  return (3 * kSeg + 2 * kChunks + 16) * 4
         + kDwStages * kKV * ((16 * wm + 8) + (np_cta + 8)) * 2;
}

// NT: 16-wide output blocks per warp; wm: warps along the channel rows (1,
// 2 or 4), so the CTA tile is (16*wm) x (16*NT*(8/wm)) of P_c. partial is
// (ranges, 9, cin, 3*cout) float32.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 6 ? 2 : 1)
subm_conv_dw_tc_kernel(const bf16* __restrict__ feats,
                       const bf16* __restrict__ g,
                       const int* __restrict__ ranks,
                       const int* __restrict__ sel,
                       float* __restrict__ partial, int V, int cin, int cout,
                       int range_rows, int wm) {
  using namespace mopa_tc;
  extern __shared__ __align__(16) unsigned char smem[];
  int* src_s = reinterpret_cast<int*>(smem);  // [3][kSeg] slot rows
  int* flag_s = src_s + 3 * kSeg;             // [kChunks] chunk has a pair
  int* list_s = flag_s + kChunks;             // [kChunks] chunks to stage
  int* count_s = list_s + kChunks;            // [16]: the list's length
  bf16* ring = reinterpret_cast<bf16*>(count_s + 16);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int range = blockIdx.x;
  const int c = blockIdx.y;
  const int mp = 16 * wm;                 // channel rows of the CTA tile
  const int ci0 = blockIdx.z * mp;
  const int wn = kWarps / wm;
  const int np_cta = 16 * NT * wn;        // output columns of the CTA tile
  const int apitch = mp + 8;
  const int bpitch = np_cta + 8;
  const int a_stage = kKV * apitch;
  const int stage = a_stage + kKV * bpitch;
  const int m0 = 16 * (warp % wm);        // this warp's rows and columns
  const int n0 = 16 * NT * (warp / wm);
  const int ncol = 3 * cout;
  const bool warp_on = ci0 + m0 < cin;    // uniform per warp
  const bool vec_f = (cin % 8) == 0;
  const bool vec_g = (cout % 8) == 0;
  const long long v_begin = static_cast<long long>(range) * range_rows;
  const long long v_end =
      min(static_cast<long long>(V), v_begin + range_rows);
  // Each thread stages one fixed 16-byte column of A and of B and walks
  // the chunk's rows (no division per copy): A column ca of row ra (the
  // kKV x mp/8 pieces fit one pass), B column nb (slot tb, channel cob) of
  // rows rb, rb + b_rows, ... (threads past whole rows of pieces idle).
  const int segs_a = mp / 8;
  const int ra = tid / segs_a;
  const int ca = ci0 + 8 * (tid % segs_a);
  const int segs_b = np_cta / 8;
  const int b_rows = kThreads / segs_b;
  const int rb = tid < b_rows * segs_b ? tid / segs_b : kKV;
  const int nb = 8 * (tid % segs_b);
  const int tb = nb < ncol ? nb / cout : 0;
  const int cob = nb - tb * cout;

  float acc[NT][2][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][h][e] = 0.f;

  for (long long seg0 = v_begin; seg0 < v_end; seg0 += kSeg) {
    const long long left = v_end - seg0;
    const int seg_n = left < kSeg ? static_cast<int>(left) : kSeg;
    __syncthreads();  // the previous segment's readers are done
    for (int i = tid; i < kChunks; i += kThreads) flag_s[i] = 0;
    __syncthreads();
    for (int i = tid; i < kSeg; i += kThreads) {
      int rows[3] = {-1, -1, -1};
      if (i < seg_n) {
        const long long v = seg0 + i;
        const int r = ranks[v * 9 + c];
        const int code = sel[v * 9 + c];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int t = (code >> (2 * j)) & 3;
          const long long row = static_cast<long long>(r) + j;
          if (t < 3 && row >= 0 && row < V) rows[t] = static_cast<int>(row);
        }
      }
#pragma unroll
      for (int t = 0; t < 3; ++t) src_s[t * kSeg + i] = rows[t];
      if (rows[0] >= 0 || rows[1] >= 0 || rows[2] >= 0)
        flag_s[i / kKV] = 1;
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int ch = 0; ch < kChunks; ++ch)
        if (flag_s[ch]) list_s[n++] = ch;
      count_s[0] = n;
    }
    __syncthreads();
    const int n_items = count_s[0];

    // Stage chunk list[item] (segment voxels [vb, vb + kKV)) into ring slot
    // `slot`.
    auto load = [&](int item, int slot) {
      const int vb = list_s[item] * kKV;
      bf16* a_s = ring + slot * stage;
      bf16* b_s = a_s + a_stage;
      if (vec_f) {
        if (ra < kKV) {
          const bool ok = vb + ra < seg_n && ca < cin;
          const bf16* src =
              ok ? feats + static_cast<size_t>(seg0 + vb + ra) * cin + ca
                 : feats;
          cp_async16(smem_u32(a_s + ra * apitch + ca - ci0), src, ok);
        }
      } else {  // rows narrower than 16 bytes (the stem): plain loads,
                // voxels across the threads
        for (int i = tid; i < kKV * mp; i += kThreads) {
          const int r = i % kKV;
          const int ci = ci0 + i / kKV;
          bf16 val = __float2bfloat16(0.f);
          if (vb + r < seg_n && ci < cin)
            val = feats[static_cast<size_t>(seg0 + vb + r) * cin + ci];
          a_s[r * apitch + ci - ci0] = val;
        }
      }
      if (vec_g) {
        for (int r = rb; r < kKV; r += b_rows) {
          const int row = nb < ncol ? src_s[tb * kSeg + vb + r] : -1;
          const bf16* src =
              row >= 0 ? g + static_cast<size_t>(row) * cout + cob : g;
          cp_async16(smem_u32(b_s + r * bpitch + nb), src, row >= 0);
        }
      } else {
        for (int i = tid; i < kKV * np_cta; i += kThreads) {
          const int r = i / np_cta;
          const int n = i % np_cta;
          bf16 val = __float2bfloat16(0.f);
          if (n < ncol) {
            const int t = n / cout;
            const int row = src_s[t * kSeg + vb + r];
            if (row >= 0)
              val = g[static_cast<size_t>(row) * cout + (n - t * cout)];
          }
          b_s[r * bpitch + n] = val;
        }
      }
    };

#pragma unroll
    for (int s = 0; s < kDwStages - 1; ++s) {
      if (s < n_items) load(s, s);
      cp_async_commit();
    }
    for (int it = 0; it < n_items; ++it) {
      cp_async_wait<kDwStages - 2>();
      __syncthreads();  // chunk `it` landed; slot of it - 1 is free
      const int next = it + kDwStages - 1;
      if (next < n_items) load(next, next % kDwStages);
      cp_async_commit();
      if (!warp_on) continue;
      const bf16* a_s = ring + (it % kDwStages) * stage;
      const bf16* b_s = a_s + a_stage;
#pragma unroll
      for (int ks = 0; ks < kKV / 16; ++ks) {
        // A = feats^T: matrix i of the x4 is (voxels +8*(i/2), channels
        // +8*(i%2)) of the voxel-major tile, transposed
        const int mi = lane >> 3;
        uint32_t a[4];
        ldsm_x4_trans(smem_u32(a_s + (ks * 16 + (lane & 7) + (mi >> 1) * 8)
                                         * apitch
                               + m0 + (mi & 1) * 8),
                      a);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (n0 + 16 * j >= ncol) break;  // uniform per warp
          uint32_t b[4];
          ldsm_x4_trans(smem_u32(b_s + (ks * 16 + (lane & 15)) * bpitch
                                 + n0 + j * 16 + (lane >> 4) * 8),
                        b);
          mma_bf16(acc[j][0], a, b[0], b[1]);
          mma_bf16(acc[j][1], a, b[2], b[3]);
        }
      }
    }
    cp_async_wait<0>();
  }

  if (!warp_on) return;
  float* p = partial + (static_cast<size_t>(range) * 9 + c) * cin * ncol;
  const int gr = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + j * 16 + h * 8 + 2 * q;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = ci0 + m0 + gr + (e >> 1) * 8;
        const int nn = n + (e & 1);
        if (ci < cin && nn < ncol)
          p[static_cast<size_t>(ci) * ncol + nn] = acc[j][h][e];
      }
    }
}

// d_w[k][ci][co] = sum over r = 0 .. ranges-1, in that order, of
// partial[r][c][ci][t*cout + co], with 3c + t = 26 - k.
__global__ void subm_conv_dw_reduce(const float* __restrict__ partial,
                                    float* __restrict__ dw, int ranges,
                                    int cin, int cout) {
  const long long n = 27LL * cin * cout;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
      + threadIdx.x;
  if (i >= n) return;
  const int k = static_cast<int>(i / (static_cast<long long>(cin) * cout));
  const int rem = static_cast<int>(i - static_cast<long long>(k) * cin * cout);
  const int ci = rem / cout;
  const int co = rem - ci * cout;
  const int c = (26 - k) / 3;
  const int t = (26 - k) % 3;
  const size_t stride = static_cast<size_t>(9) * cin * 3 * cout;
  const float* src = partial + (static_cast<size_t>(c) * cin + ci) * 3 * cout
      + t * cout + co;
  float s = 0.f;
  for (int r = 0; r < ranges; ++r) s += src[r * stride];
  dw[i] = s;
}

// ---------------------------------------------------------------- float32

constexpr int kPairVoxels = 2048;    // voxels per pair-list block
constexpr int kPairThreads = 256;    // threads of the list kernels
constexpr int kOffsets = 27;
constexpr int kKP = 32;              // pairs (the GEMM's K) per stage
constexpr int kPairSeg = 2048;       // pair entries a CTA holds at once
constexpr int kPairStages = 3;       // cp.async ring depth
constexpr int kPairMaxThreads = 512; // 4 x 4 warps of 32 x 32

// Rows of voxel v's column c by dz slot (-1: none), resolved as the
// bfloat16 kernel resolves them.
__device__ __forceinline__ void column_rows(const int* __restrict__ ranks,
                                            const int* __restrict__ sel,
                                            long long v, int c, int V,
                                            int (&rows)[3]) {
  const int r = ranks[v * 9 + c];
  const int code = sel[v * 9 + c];
  rows[0] = rows[1] = rows[2] = -1;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int t = (code >> (2 * j)) & 3;
    const long long row = static_cast<long long>(r) + j;
    const bool ok = row >= 0 && row < V;
#pragma unroll
    for (int s = 0; s < 3; ++s)
      if (ok && t == s) rows[s] = static_cast<int>(row);
  }
}

// block_counts[b][k]: offset k's pairs among voxels [b, b + 1) * kPairVoxels.
__global__ void __launch_bounds__(kPairThreads)
subm_conv_dw_pairs_count(const int* __restrict__ ranks,
                         const int* __restrict__ sel,
                         int* __restrict__ block_counts, int V) {
  __shared__ int count_s[kOffsets];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < kOffsets) count_s[tid] = 0;
  __syncthreads();
  const long long v0 = static_cast<long long>(blockIdx.x) * kPairVoxels;
  const long long v1 = min(static_cast<long long>(V), v0 + kPairVoxels);
  int n[kOffsets];  // this warp's counts (lane 0)
#pragma unroll
  for (int k = 0; k < kOffsets; ++k) n[k] = 0;
  for (long long base = v0; base < v1; base += kPairThreads) {
    const long long v = base + tid;
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      int rows[3] = {-1, -1, -1};
      if (v < v1) column_rows(ranks, sel, v, c, V, rows);
#pragma unroll
      for (int t = 0; t < 3; ++t)
        n[26 - 3 * c - t] +=
            __popc(__ballot_sync(0xffffffffu, rows[t] >= 0));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kOffsets; ++k) atomicAdd(&count_s[k], n[k]);
  }
  __syncthreads();
  if (tid < kOffsets)
    block_counts[static_cast<size_t>(blockIdx.x) * kOffsets + tid] =
        count_s[tid];
}

// pairs[k][p] = (input row, cotangent row) of offset k's p-th pair in
// voxel order; the last block writes counts[k]. With span > 0 (a multiple
// of 32), starts[s][k] = the pairs of offset k among voxels below s * span,
// for s = 0 .. ceil(V / span) (the last row: counts[k]).
__global__ void __launch_bounds__(kPairThreads)
subm_conv_dw_pairs_write(const int* __restrict__ ranks,
                         const int* __restrict__ sel,
                         const int* __restrict__ block_counts,
                         int2* __restrict__ pairs, int* __restrict__ counts,
                         int* __restrict__ starts, int V, int span) {
  constexpr int kW = kPairThreads / 32;
  __shared__ int base_s[kOffsets];       // offset k's next free slot
  __shared__ int warp_s[kW][kOffsets];   // per warp: count, then its slot
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  // the earlier blocks' counts: 8 threads an offset, their sums added by
  // shuffles (every lane takes part; offsets past 26 sum nothing)
  static_assert(kPairThreads >= 8 * kOffsets, "8 threads an offset");
  {
    const int k = tid >> 3;
    int s = 0;
    if (k < kOffsets)
      for (int e = tid & 7; e < b; e += 8)
        s += block_counts[static_cast<size_t>(e) * kOffsets + k];
#pragma unroll
    for (int d = 4; d > 0; d >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, d, 8);
    if (k < kOffsets && (tid & 7) == 0) {
      base_s[k] = s;
      if (b == gridDim.x - 1) {
        const int total =
            s + block_counts[static_cast<size_t>(b) * kOffsets + k];
        counts[k] = total;
        if (span > 0)
          starts[static_cast<size_t>((V + span - 1) / span) * kOffsets + k] =
              total;
      }
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  const long long v0 = static_cast<long long>(b) * kPairVoxels;
  const long long v1 = min(static_cast<long long>(V), v0 + kPairVoxels);
  for (long long base = v0; base < v1; base += kPairThreads) {
    const long long v = base + tid;
    int rows[kOffsets];
    unsigned bal[kOffsets];
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      int cr[3] = {-1, -1, -1};
      if (v < v1) column_rows(ranks, sel, v, c, V, cr);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int k = 26 - 3 * c - t;
        rows[k] = cr[t];
        bal[k] = __ballot_sync(0xffffffffu, cr[t] >= 0);
        if (lane == 0) warp_s[warp][k] = __popc(bal[k]);
      }
    }
    __syncthreads();
    if (tid < kOffsets) {
      int s = base_s[tid];
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const int nw = warp_s[w][tid];
        warp_s[w][tid] = s;
        s += nw;
      }
      base_s[tid] = s;
    }
    __syncthreads();
    // a span begins at some warp's first voxel: that warp's first slot at
    // k counts the pairs of k below it
    if (span > 0 && tid < kW * kOffsets) {
      const long long vw = base + 32 * (tid / kOffsets);
      if (vw < v1 && vw % span == 0)
        starts[(vw / span) * kOffsets + tid % kOffsets] =
            warp_s[tid / kOffsets][tid % kOffsets];
    }
#pragma unroll
    for (int k = 0; k < kOffsets; ++k)
      if (rows[k] >= 0)
        pairs[static_cast<size_t>(k) * V + warp_s[warp][k]
              + __popc(bal[k] & below)] =
            make_int2(static_cast<int>(v), rows[k]);
    __syncthreads();  // warp_s is rewritten by the next round
  }
}

// Dynamic shared memory of the pair GEMM for a (32*wm) x (32*wn) tile:
// a segment's pair entries, then the (A, B) ring.
constexpr int dw_pairs_smem_bytes(int wm, int wn) {
  return 2 * kPairSeg * 4
         + kPairStages * kKP * ((32 * wm + 8) + (32 * wn + 8)) * 4;
}

// partial[range][k] (cin x cout) = the range's pairs of offset k in
// 3xTF32; blockIdx = (range, k, Cin block + cin_blocks * Cout block).
__global__ void __launch_bounds__(kPairMaxThreads)
subm_conv_dw_pairs_f32_tc_kernel(const float* __restrict__ feats,
                                 const float* __restrict__ g,
                                 const int2* __restrict__ pairs,
                                 const int* __restrict__ counts,
                                 float* __restrict__ partial, int V, int cin,
                                 int cout, int range_rows, int wm, int wn,
                                 int cin_blocks) {
  using namespace mopa_tc;
  extern __shared__ __align__(16) unsigned char smem[];
  int* i_s = reinterpret_cast<int*>(smem);  // [kPairSeg] feats rows
  int* o_s = i_s + kPairSeg;                // [kPairSeg] g rows
  float* ring = reinterpret_cast<float*>(o_s + kPairSeg);

  const int k = blockIdx.y;
  const int count = counts[k];
  const long long p_begin = static_cast<long long>(blockIdx.x) * range_rows;
  if (p_begin >= count) return;  // uniform per CTA
  const long long p_end = min(static_cast<long long>(count),
                              p_begin + range_rows);

  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;
  const int q = lane & 3;
  const int mc = 32 * wm;                 // the CTA tile
  const int nc = 32 * wn;
  const int ci0 = (blockIdx.z % cin_blocks) * mc;
  const int co0 = (blockIdx.z / cin_blocks) * nc;
  const int m0 = 32 * (warp % wm);        // this warp's 32 x 32
  const int n0 = 32 * (warp / wm);
  const bool warp_on = ci0 + m0 < cin && co0 + n0 < cout;  // per warp
  const int apitch = mc + 8;
  const int bpitch = nc + 8;
  const int a_stage = kKP * apitch;
  const int stage = a_stage + kKP * bpitch;
  const bool vec_f = cin % 4 == 0
      && (reinterpret_cast<uintptr_t>(feats) & 15) == 0;
  const bool vec_g = cout % 4 == 0
      && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  // Each thread stages one fixed 16-byte column of A and of B and walks
  // the stage's rows: mc/4 pieces a row of A, so threads / (mc/4) = 4*wn
  // rows a pass; B likewise, 4*wm rows a pass.
  const int ca = 4 * (tid % (8 * wm));
  const int ra = tid / (8 * wm);
  const int cb = 4 * (tid % (8 * wn));
  const int rb = tid / (8 * wn);
  const int2* list = pairs + static_cast<size_t>(k) * V;

  float acc[2][4][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;

  for (long long seg0 = p_begin; seg0 < p_end; seg0 += kPairSeg) {
    const long long left = p_end - seg0;
    const int seg_n = left < kPairSeg ? static_cast<int>(left) : kPairSeg;
    __syncthreads();  // the previous segment's readers are done
    for (int i = tid; i < seg_n; i += threads) {
      const int2 pr = list[seg0 + i];
      i_s[i] = pr.x;
      o_s[i] = pr.y;
    }
    __syncthreads();
    const int n_items = (seg_n + kKP - 1) / kKP;

    // Stage pairs [item * kKP, + kKP) of the segment into ring slot `slot`.
    auto load = [&](int item, int slot) {
      const int pb = item * kKP;
      float* a_s = ring + slot * stage;
      float* b_s = a_s + a_stage;
      if (vec_f) {
        for (int r = ra; r < kKP; r += 4 * wn) {
          const bool ok = pb + r < seg_n && ci0 + ca < cin;
          const float* src =
              ok ? feats + static_cast<size_t>(i_s[pb + r]) * cin + ci0 + ca
                 : feats;
          cp_async16(smem_u32(a_s + r * apitch + ca), src, ok);
        }
      } else {
        for (int i = tid; i < kKP * mc; i += threads) {
          const int r = i / mc;
          const int ci = ci0 + i % mc;
          float val = 0.f;
          if (pb + r < seg_n && ci < cin)
            val = feats[static_cast<size_t>(i_s[pb + r]) * cin + ci];
          a_s[r * apitch + ci - ci0] = val;
        }
      }
      if (vec_g) {
        for (int r = rb; r < kKP; r += 4 * wm) {
          const bool ok = pb + r < seg_n && co0 + cb < cout;
          const float* src =
              ok ? g + static_cast<size_t>(o_s[pb + r]) * cout + co0 + cb
                 : g;
          cp_async16(smem_u32(b_s + r * bpitch + cb), src, ok);
        }
      } else {
        for (int i = tid; i < kKP * nc; i += threads) {
          const int r = i / nc;
          const int co = co0 + i % nc;
          float val = 0.f;
          if (pb + r < seg_n && co < cout)
            val = g[static_cast<size_t>(o_s[pb + r]) * cout + co];
          b_s[r * bpitch + co - co0] = val;
        }
      }
    };

#pragma unroll
    for (int s = 0; s < kPairStages - 1; ++s) {
      if (s < n_items) load(s, s);
      cp_async_commit();
    }
    for (int it = 0; it < n_items; ++it) {
      cp_async_wait<kPairStages - 2>();
      __syncthreads();  // stage `it` landed; the slot of it - 1 is free
      const int next = it + kPairStages - 1;
      if (next < n_items) load(next, next % kPairStages);
      cp_async_commit();
      if (!warp_on) continue;
      const float* a_s = ring + (it % kPairStages) * stage;
      const float* b_s = a_s + a_stage;
#pragma unroll 1
      for (int ks = 0; ks < kKP / 8; ++ks) {
        // pair rows q and q + 4 of these 8; lane gr's channels 4gr..4gr+3
        const float* ap = a_s + (ks * 8 + q) * apitch + m0 + 4 * gr;
        const float* bp = b_s + (ks * 8 + q) * bpitch + n0 + 4 * gr;
        const float4 x0 = *reinterpret_cast<const float4*>(ap);
        const float4 x1 = *reinterpret_cast<const float4*>(ap + 4 * apitch);
        const float4 y0 = *reinterpret_cast<const float4*>(bp);
        const float4 y1 = *reinterpret_cast<const float4*>(bp + 4 * bpitch);
        // A of m-tile u: (row gr, row gr + 8) x (pair q, pair q + 4) =
        // channels 4gr + 2u + (0, 1)
        const float av[2][4] = {{x0.x, x0.y, x1.x, x1.y},
                                {x0.z, x0.w, x1.z, x1.w}};
        // B of n-block j: pairs q, q + 4 at column gr = channel 4gr + j
        const float bv[4][2] = {{y0.x, y1.x}, {y0.y, y1.y}, {y0.z, y1.z},
                                {y0.w, y1.w}};
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) tf32_split(av[u][e], a_hi[u][e],
                                                 a_lo[u][e]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b_hi[2], b_lo[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) tf32_split(bv[j][e], b_hi[e], b_lo[e]);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            // from zero, then a float32 add (see the header)
            float part[4] = {};
            mma_3xtf32(part, a_hi[u], a_lo[u], b_hi[0], b_hi[1], b_lo[0],
                       b_lo[1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[u][j][e] += part[e];
          }
        }
      }
    }
    cp_async_wait<0>();
  }

  if (!warp_on) return;
  // C of (u, j): rows gr (+8), columns 2q (+1) = channel ci0 + m0 + 4gr +
  // 2u (+1), co0 + n0 + 4 * (2q (+1)) + j
  float* p = partial
      + (static_cast<size_t>(blockIdx.x) * kOffsets + k) * cin * cout;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = ci0 + m0 + 4 * gr + 2 * u + (e >> 1);
      const int co = co0 + n0 + 4 * (2 * q + (e & 1));
      if (ci >= cin) continue;
      float* dst = p + static_cast<size_t>(ci) * cout + co;
      if (cout % 4 == 0 && co + 3 < cout) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            acc[u][0][e], acc[u][1][e], acc[u][2][e], acc[u][3][e]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (co + j < cout) dst[j] = acc[u][j][e];
      }
    }
}

// dw[k][ci][co] = sum over the ranges r of offset k that hold pairs
// (r < ceil(counts[k] / range_rows)), in that order, of
// partial[r][k][ci][co]; zero where k has no pair.
__global__ void subm_conv_dw_pairs_reduce(const float* __restrict__ partial,
                                          const int* __restrict__ counts,
                                          float* __restrict__ dw,
                                          int range_rows, int cin,
                                          int cout) {
  const long long block = static_cast<long long>(cin) * cout;
  const long long n = kOffsets * block;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
      + threadIdx.x;
  if (i >= n) return;
  const int k = static_cast<int>(i / block);
  const int ranges = (counts[k] + range_rows - 1) / range_rows;
  const size_t stride = static_cast<size_t>(kOffsets) * block;
  float s = 0.f;
  for (int r = 0; r < ranges; ++r) s += partial[r * stride + i];
  dw[i] = s;
}

template <int NT>
int launch_dw_tc(const bf16* f, const bf16* g, const int* r, const int* s,
                 float* partial, int V, int cin, int cout, int ranges,
                 int range_rows, int wm, cudaStream_t st) {
  static int granted = 0;  // per instance: shared memory allowed so far
  const int smem = dw_smem_bytes(wm, 16 * NT * (kWarps / wm));
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        subm_conv_dw_tc_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  const dim3 grid(ranges, 9, (cin + 16 * wm - 1) / (16 * wm));
  subm_conv_dw_tc_kernel<NT><<<grid, kThreads, smem, st>>>(
      f, g, r, s, partial, V, cin, cout, range_rows, wm);
  return static_cast<int>(cudaGetLastError());
}

int reduce(const float* partial, float* dw, int ranges, int cin, int cout,
           cudaStream_t st) {
  const long long n = 27LL * cin * cout;
  const int threads = 256;
  subm_conv_dw_reduce<<<static_cast<unsigned>((n + threads - 1) / threads),
                        threads, 0, st>>>(partial, dw, ranges, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The float32 route's pair lists, shared by K1, K2 d_feats and d_w. ranks
// and sel int32 (V*9); block_counts an int32 (ceil(V / 2048), 27) scratch;
// pairs (27, V) int2 and counts (27,) int32 out: pairs[k][0 .. counts[k])
// are offset k's (voxel, neighbour row) pairs, ascending by voxel; the rest
// is not written. span 0, or a multiple of 32 for the conv kernels' table:
// starts (ceil(V / span) + 1, 27) int32 out (subm_conv_dw_pairs_write).
// Launches both kernels on `stream` and returns cudaGetLastError().
extern "C" int mopa_subm_conv_pairs(const void* ranks, const void* sel,
                                    void* block_counts, void* pairs,
                                    void* counts, void* starts, int V,
                                    int span, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V < 0 || span < 0 || span % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (V == 0)
    return static_cast<int>(cudaMemsetAsync(counts, 0, kOffsets * 4, st));
  const int* r = static_cast<const int*>(ranks);
  const int* s = static_cast<const int*>(sel);
  int* bc = static_cast<int*>(block_counts);
  const int blocks = (V + kPairVoxels - 1) / kPairVoxels;
  subm_conv_dw_pairs_count<<<blocks, kPairThreads, 0, st>>>(r, s, bc, V);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  subm_conv_dw_pairs_write<<<blocks, kPairThreads, 0, st>>>(
      r, s, bc, static_cast<int2*>(pairs), static_cast<int*>(counts),
      static_cast<int*>(starts), V, span);
  return static_cast<int>(cudaGetLastError());
}

// float32 route (3xTF32 tensor cores) over the pair lists of
// mopa_subm_conv_pairs. feats (V, cin) and g (V, cout) float32,
// contiguous; offset k's pairs split into ranges of range_rows, at most
// `ranges` of them (ranges * range_rows >= V); wm and wn (1 to 4) warps of
// 32 channels along Cin and Cout, the CTA tile (32*wm) x (32*wn); partial
// a (ranges, 27, cin, cout) float32 scratch; dw (27, cin, cout) float32.
// Launches both kernels on `stream` and returns cudaGetLastError().
extern "C" int mopa_subm_conv_dw_f32(const void* feats, const void* g,
                                     const void* pairs, const void* counts,
                                     void* partial, void* dw, int V, int cin,
                                     int cout, int ranges, int range_rows,
                                     int wm, int wn, void* stream) {
  if (cin < 1 || cout < 1 || cout > kCoutMax || ranges < 1
      || range_rows < 1
      || static_cast<long long>(ranges) * range_rows < V
      || wm < 1 || wm > 4 || wn < 1 || wn > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = 27LL * cin * cout;
  if (V <= 0) return static_cast<int>(cudaMemsetAsync(dw, 0, n * 4, st));
  static int granted = 0;  // shared memory allowed so far
  const int smem = dw_pairs_smem_bytes(wm, wn);
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        subm_conv_dw_pairs_f32_tc_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  const int cin_blocks = (cin + 32 * wm - 1) / (32 * wm);
  const int cout_blocks = (cout + 32 * wn - 1) / (32 * wn);
  const dim3 grid(ranges, kOffsets, cin_blocks * cout_blocks);
  subm_conv_dw_pairs_f32_tc_kernel<<<grid, 32 * wm * wn, smem, st>>>(
      static_cast<const float*>(feats), static_cast<const float*>(g),
      static_cast<const int2*>(pairs), static_cast<const int*>(counts),
      static_cast<float*>(partial), V, cin, cout, range_rows, wm, wn,
      cin_blocks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  subm_conv_dw_pairs_reduce<<<static_cast<unsigned>((n + threads - 1)
                                                    / threads),
                              threads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const int*>(counts),
      static_cast<float*>(dw),
      range_rows, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 tensor-core route. feats (V, cin) and g (V, cout) bfloat16,
// contiguous; ranks, sel, ranges and range_rows as on the float32 route;
// wm (1, 2 or 4)
// warps along the channel rows and nt (1, 2, 3, 4, 6, 8 or 12) 16-wide
// output blocks per warp, with 16 * nt * (8 / wm) >= 3 * cout; partial is a
// (ranges, 9, cin, 3 * cout) float32 scratch; dw (27, cin, cout) float32.
extern "C" int mopa_subm_conv_dw_tc(const void* feats, const void* g,
                                    const void* ranks, const void* sel,
                                    void* partial, void* dw, int V, int cin,
                                    int cout, int ranges, int range_rows,
                                    int wm, int nt, void* stream) {
  if (cin < 1 || cout < 1 || cout > kCoutMax || ranges < 1
      || range_rows % kKV != 0
      || static_cast<long long>(ranges) * range_rows < V
      || (wm != 1 && wm != 2 && wm != 4)
      || 16 * nt * (kWarps / wm) < 3 * cout)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = 27LL * cin * cout;
  if (V <= 0) return static_cast<int>(cudaMemsetAsync(dw, 0, n * 4, st));
  const bf16* f = static_cast<const bf16*>(feats);
  const bf16* gg = static_cast<const bf16*>(g);
  const int* r = static_cast<const int*>(ranks);
  const int* s = static_cast<const int*>(sel);
  float* p = static_cast<float*>(partial);
  int err;
  switch (nt) {
#define MOPA_CASE(NT)                                                      \
    case NT:                                                               \
      err = launch_dw_tc<NT>(f, gg, r, s, p, V, cin, cout, ranges,         \
                             range_rows, wm, st);                          \
      break;
    MOPA_CASE(1) MOPA_CASE(2) MOPA_CASE(3) MOPA_CASE(4) MOPA_CASE(6)
    MOPA_CASE(8) MOPA_CASE(12)
#undef MOPA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return reduce(p, static_cast<float*>(dw), ranges, cin, cout, st);
}

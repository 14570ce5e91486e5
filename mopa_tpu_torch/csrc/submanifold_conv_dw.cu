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
// sum over voxels is split into voxel ranges (the wrapper picks them from V
// alone): each CTA writes the partial sum of its range, and a second kernel
// adds the ranges in a fixed order. No floating-point atomics: two runs give
// the same bits.
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
//   decoder): subm_conv_dw_f32_tc_kernel, tensor cores in 3xTF32
//   (tensor_core.cuh), so float32 stays within 1e-4 of the plain twin. The
//   design is the bf16 kernel's: the same CTA ownership and tiling (the
//   wrapper's dw_tiling), g's aligned windows staged once per (range,
//   column) and channel block, feats rows by cp.async, the same partial
//   sums and the same fixed-order reduction. The differences:
//   - A stage is kKV32 = 16 voxels deep (one 16-byte piece is 4 channels),
//     so that three stages of a 32 x 768 tile fit the shared memory.
//   - Both operands are read transposed (A^T = feats^T from voxel-major
//     rows; B from voxel-major windows), and ldmatrix cannot transpose
//     32-bit elements: the fragments come by plain 32-bit shared loads.
//     Rows are padded by 8 floats, so the 32 lanes of a fragment load (4
//     voxel rows x 8 channels) hit 32 distinct banks.
//   - Each fragment is split into its TF32 high and low parts in registers
//     (neither operand is a weight that could be packed once), and each
//     product accumulates lo*hi + hi*lo + hi*hi.
//   - Each MMA's three products sum from zero and join the float32
//     accumulator by an add: the MMA's own accumulation drops low bits,
//     and chained over a voxel range it drifts past float32's rounding
//     (submanifold_conv.cu says how far).

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

constexpr int kKV32 = 16;            // voxels (the GEMM's K) per f32 stage
constexpr int kChunks32 = kSeg / kKV32;
constexpr int kDwStages32 = 3;       // cp.async ring depth

// Dynamic shared memory of the float32 kernel for a (16*wm) x np_cta CTA
// tile: 3 slot rows per voxel of a segment, the chunk flags and list, then
// the (A, B) ring in floats.
constexpr int dw_f32_smem_bytes(int wm, int np_cta) {
  return (3 * kSeg + 2 * kChunks32 + 16) * 4
         + kDwStages32 * kKV32 * ((16 * wm + 8) + (np_cta + 8)) * 4;
}

// As subm_conv_dw_tc_kernel, on float32 rows in 3xTF32. partial is
// (ranges, 9, cin, 3*cout) float32.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 6 ? 2 : 1)
subm_conv_dw_f32_tc_kernel(const float* __restrict__ feats,
                           const float* __restrict__ g,
                           const int* __restrict__ ranks,
                           const int* __restrict__ sel,
                           float* __restrict__ partial, int V, int cin,
                           int cout, int range_rows, int wm) {
  using namespace mopa_tc;
  extern __shared__ __align__(16) unsigned char smem[];
  int* src_s = reinterpret_cast<int*>(smem);  // [3][kSeg] slot rows
  int* flag_s = src_s + 3 * kSeg;             // [kChunks32] chunk has a pair
  int* list_s = flag_s + kChunks32;           // [kChunks32] chunks to stage
  int* count_s = list_s + kChunks32;          // [16]: the list's length
  float* ring = reinterpret_cast<float*>(count_s + 16);

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
  const int a_stage = kKV32 * apitch;
  const int stage = a_stage + kKV32 * bpitch;
  const int m0 = 16 * (warp % wm);        // this warp's rows and columns
  const int n0 = 16 * NT * (warp / wm);
  const int ncol = 3 * cout;
  const bool warp_on = ci0 + m0 < cin;    // uniform per warp
  const bool vec_f = (cin % 4) == 0;
  const bool vec_g = (cout % 4) == 0;
  const long long v_begin = static_cast<long long>(range) * range_rows;
  const long long v_end =
      min(static_cast<long long>(V), v_begin + range_rows);
  // Each thread stages one fixed 16-byte column of A and of B and walks
  // the chunk's rows: A column ca of row ra (the kKV32 x mp/4 pieces fit
  // one pass), B column nb (slot tb, channel cob) of rows rb, rb + b_rows,
  // ... (threads past whole rows of pieces idle).
  const int segs_a = mp / 4;
  const int ra = tid / segs_a;
  const int ca = ci0 + 4 * (tid % segs_a);
  const int segs_b = np_cta / 4;
  const int b_rows = kThreads / segs_b;
  const int rb = tid < b_rows * segs_b ? tid / segs_b : kKV32;
  const int nb = 4 * (tid % segs_b);
  const int tb = nb < ncol ? nb / cout : 0;
  const int cob = nb - tb * cout;
  const int gr = lane >> 2;
  const int q = lane & 3;

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
    for (int i = tid; i < kChunks32; i += kThreads) flag_s[i] = 0;
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
        flag_s[i / kKV32] = 1;
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int ch = 0; ch < kChunks32; ++ch)
        if (flag_s[ch]) list_s[n++] = ch;
      count_s[0] = n;
    }
    __syncthreads();
    const int n_items = count_s[0];

    // Stage chunk list[item] (segment voxels [vb, vb + kKV32)) into ring
    // slot `slot`.
    auto load = [&](int item, int slot) {
      const int vb = list_s[item] * kKV32;
      float* a_s = ring + slot * stage;
      float* b_s = a_s + a_stage;
      if (vec_f) {
        if (ra < kKV32) {
          const bool ok = vb + ra < seg_n && ca < cin;
          const float* src =
              ok ? feats + static_cast<size_t>(seg0 + vb + ra) * cin + ca
                 : feats;
          cp_async16(smem_u32(a_s + ra * apitch + ca - ci0), src, ok);
        }
      } else {  // rows narrower than 16 bytes (the stem): plain loads,
                // voxels across the threads
        for (int i = tid; i < kKV32 * mp; i += kThreads) {
          const int r = i % kKV32;
          const int ci = ci0 + i / kKV32;
          float val = 0.f;
          if (vb + r < seg_n && ci < cin)
            val = feats[static_cast<size_t>(seg0 + vb + r) * cin + ci];
          a_s[r * apitch + ci - ci0] = val;
        }
      }
      if (vec_g) {
        for (int r = rb; r < kKV32; r += b_rows) {
          const int row = nb < ncol ? src_s[tb * kSeg + vb + r] : -1;
          const float* src =
              row >= 0 ? g + static_cast<size_t>(row) * cout + cob : g;
          cp_async16(smem_u32(b_s + r * bpitch + nb), src, row >= 0);
        }
      } else {
        for (int i = tid; i < kKV32 * np_cta; i += kThreads) {
          const int r = i / np_cta;
          const int n = i % np_cta;
          float val = 0.f;
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
    for (int s = 0; s < kDwStages32 - 1; ++s) {
      if (s < n_items) load(s, s);
      cp_async_commit();
    }
    for (int it = 0; it < n_items; ++it) {
      cp_async_wait<kDwStages32 - 2>();
      __syncthreads();  // chunk `it` landed; slot of it - 1 is free
      const int next = it + kDwStages32 - 1;
      if (next < n_items) load(next, next % kDwStages32);
      cp_async_commit();
      if (!warp_on) continue;
      const float* a_s = ring + (it % kDwStages32) * stage;
      const float* b_s = a_s + a_stage;
#pragma unroll
      for (int ks = 0; ks < kKV32 / 8; ++ks) {
        // A = feats^T: a0..a3 = A[m0 + gr (+8)][voxel q (+4)], i.e. the
        // voxel-major tile at (voxel, channel)
        const float* ap = a_s + (ks * 8 + q) * apitch + m0 + gr;
        const float ax[4] = {ap[0], ap[8], ap[4 * apitch],
                             ap[4 * apitch + 8]};
        uint32_t a_hi[4], a_lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(ax[e], a_hi[e], a_lo[e]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (n0 + 16 * j >= ncol) break;  // uniform per warp
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // b0, b1 = B[voxel q (+4)][column gr] of this 8-wide block
            const float* bp =
                b_s + (ks * 8 + q) * bpitch + n0 + 16 * j + 8 * h + gr;
            uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
            tf32_split(bp[0], b0_hi, b0_lo);
            tf32_split(bp[4 * bpitch], b1_hi, b1_lo);
            // from zero, then a float32 add (see the header)
            float part[4] = {};
            mma_3xtf32(part, a_hi, a_lo, b0_hi, b1_hi, b0_lo, b1_lo);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][h][e] += part[e];
          }
        }
      }
    }
    cp_async_wait<0>();
  }

  if (!warp_on) return;
  float* p = partial + (static_cast<size_t>(range) * 9 + c) * cin * ncol;
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

template <int NT>
int launch_dw_f32_tc(const float* f, const float* g, const int* r,
                     const int* s, float* partial, int V, int cin, int cout,
                     int ranges, int range_rows, int wm, cudaStream_t st) {
  static int granted = 0;  // per instance: shared memory allowed so far
  const int smem = dw_f32_smem_bytes(wm, 16 * NT * (kWarps / wm));
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        subm_conv_dw_f32_tc_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  const dim3 grid(ranges, 9, (cin + 16 * wm - 1) / (16 * wm));
  subm_conv_dw_f32_tc_kernel<NT><<<grid, kThreads, smem, st>>>(
      f, g, r, s, partial, V, cin, cout, range_rows, wm);
  return static_cast<int>(cudaGetLastError());
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

// float32 route (3xTF32 tensor cores). feats (V, cin) and g (V, cout)
// float32, contiguous; ranks and sel int32 (V*9); the sum is split into
// `ranges` voxel ranges of `range_rows` rows (a multiple of 32); wm and nt
// the CTA tile as on the bfloat16 route (mopa_subm_conv_dw_tc), with at
// most 1024 output columns a CTA; partial is a (ranges, 9, cin, 3 * cout)
// float32 scratch; dw (27, cin, cout) float32. Launches both kernels on
// `stream` and returns cudaGetLastError().
extern "C" int mopa_subm_conv_dw_f32(const void* feats, const void* g,
                                     const void* ranks, const void* sel,
                                     void* partial, void* dw, int V, int cin,
                                     int cout, int ranges, int range_rows,
                                     int wm, int nt, void* stream) {
  if (cin < 1 || cout < 1 || cout > kCoutMax || ranges < 1
      || range_rows % kKV != 0
      || static_cast<long long>(ranges) * range_rows < V
      || (wm != 1 && wm != 2 && wm != 4)
      || 16 * nt * (kWarps / wm) < 3 * cout
      || 16 * nt * (kWarps / wm) > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = 27LL * cin * cout;
  if (V <= 0) return static_cast<int>(cudaMemsetAsync(dw, 0, n * 4, st));
  const float* f = static_cast<const float*>(feats);
  const float* gg = static_cast<const float*>(g);
  const int* r = static_cast<const int*>(ranks);
  const int* s = static_cast<const int*>(sel);
  float* p = static_cast<float*>(partial);
  int err;
  switch (nt) {
#define MOPA_CASE(NT)                                                      \
    case NT:                                                               \
      err = launch_dw_f32_tc<NT>(f, gg, r, s, p, V, cin, cout, ranges,     \
                                 range_rows, wm, st);                      \
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

// K1: submanifold 3x3x3 sparse convolution, forward, over a flat wide-column
// plan, and the d_feats half of its backward (K2). Hand-written for Hopper
// (sm_90a); built by nvcc into a shared library with a plain C interface and
// called through ctypes (mopa_tpu_torch/ops/sparse_conv_cuda.py).
//
// Replaces the Pallas TPU kernel mopa_tpu/ops/sparse_conv_pallas.py::
// _conv_kernel (+ _gather_window), and the d_feats half of _bwd_kernel: the
// backward's d_feats is the SAME windowed conv of the cotangent g with the
// mirrored, transposed weight W'[k] = W[26-k]^T (u is v's neighbour at offset
// o iff v is u's at -o, and the offsets enumerate symmetrically). The Pallas
// kernels kept a whole per-sample feature table in VMEM. A 15,564-row table
// does not fit an SM's shared memory, so these kernels work on the GLOBAL
// flat plan instead: no per-sample localisation.
//
// What it computes, for every voxel v and every (dx, dy) column c (0..8):
// rows ranks[v*9+c] + j, j = 0..2, are the column's consecutive z-run; the
// packed code sel[v*9+c] holds, in bits [2j, 2j+2), the dz slot t (0..2) that
// row j feeds, 3 = none. Slot t of column c multiplies kernel offset k = 3c+t,
// i.e. weight[k] (Cin x Cout). out[v] = sum over c of the column's aligned
// window (3*Cin values: slot t's row, or zeros) @ W_c, W_c = weight[3c..3c+2]
// as a (3*Cin, Cout) block -- _conv_kernel's loop. Rows outside [0, V) never
// contribute: the all-miss sentinel of the last sample points one past the
// table.
//
// Two routes, chosen by the wrapper from the dtype:
//
// * bfloat16 (the train step, the EMA teacher and eval): subm_conv_tc_kernel,
//   tensor cores. What bounds it: 2*Cin*Cout FLOPs per existing neighbour
//   pair (4.8-9.2 pairs per row of 27 on the train plan) against
//   (Cin+Cout)*2 + 72 bytes per voxel, so memory bounds it; but the work
//   arrives as a gather of 3-row z-runs scattered over a level's table (up to
//   48 MB), so the L2 latency of the gather and the tile's dense MMA work are
//   what it really spends. Design:
//   - A CTA (8 warps) owns 128 voxels x all Cout (padded to NP = 16..192),
//     accumulated in float32 registers; warp w holds rows 16w..16w+15.
//     128-row tiles halve the weight traffic from L2 against 64-row ones
//     (every tile reads every active column's weight block).
//   - It resolves its voxels' 27 source rows once into shared memory and
//     skips the columns in which none of its voxels has a pair (a padding
//     tile costs one pass over its plan entries).
//   - It walks K = (active columns) x (3*Cin padded to kKC) in kKC-deep
//     stages. A stage holds the tile's dz-aligned windows of one column (A,
//     128 x kKC: each 16-byte piece of a row is one cp.async of 8 channels of
//     one slot's row, zero-filled where the slot is empty) and the matching
//     rows of the packed weight (B, kKC x NP, dense). A kStages-deep ring of
//     cp.async groups keeps the next stages' gathers in flight while the
//     current one multiplies, one barrier per stage.
//   - ldmatrix feeds mma.sync m16n8k16 (bf16 -> f32); rows are padded by 16
//     bytes so the 8 row addresses of an 8x8 matrix hit 8 distinct bank
//     groups. Why mma.sync and not wgmma: the kernel's time is the gather's
//     latency, not the MMA rate (the dense tile work is < 0.1 ms of tensor
//     core time per conv), and mma.sync's per-warp fragments need no shared-
//     memory descriptors or swizzle modes, which cannot be checked off the
//     card.
//   - The weight comes packed by the wrapper as (9, KP, NP) bf16: column c's
//     (3*Cin, Cout) block, zero-padded to KP (a multiple of kKC) rows and NP
//     columns, so B loads never mask. The mirror mode (d_feats) is the same
//     kernel with the pack of W' = weight[::-1].transpose(1, 2).
//   - The stem (Cin = 1: 2-byte rows, below cp.async's 16) stages its
//     windows with plain loads into the same layout.
//   - Epilogue: float32 -> bf16 through shared memory, written as 16-byte
//     rows.
//
// * float32 (the checking paths: chip_smoke's f32 rows and its float32
//   1 + 1 steps; the convergence run; SPVCNN's decoder, float32 as in the
//   JAX package): subm_conv_pairs_f32_tc_kernel, tensor cores in 3xTF32,
//   so float32 stays within 1e-4 of the plain twin (TF32 alone keeps 11
//   bits of 24 and would not). Each operand is split into a TF32 high and
//   low part, and each product accumulates lo*hi + hi*lo + hi*hi in
//   float32 through mma.sync m16n8k8 (tensor_core.cuh).
//   It runs over the neighbour pairs that exist, as the float32 d_w does
//   (submanifold_conv_dw.cu), and not over dz windows: SPVCNN's decoder
//   levels hold 1.9 to 12.4 of the 27 pairs a voxel could have, and a
//   window stages all 3 dz slots of every (dx, dy) column with any pair,
//   zero-filled: 2.0x (level 3) to 6.9x (level 0) the rows of the pairs,
//   in 16-row groups. What bounds it: 3 * 2 * Cin * Cout TF32 MMA
//   operations a pair (in 16-row groups: 1.12x the pairs at level 3, 1.9x
//   at level 0) against the gathered bytes, 4 * Cin a pair, and the
//   weight's, 8 * Cin * NP per (span, offset) with pairs. On the card the
//   MMAs and the loads overlap poorly: at level 3, 384 -> 128, a launch
//   takes 4.36 ms, and 2.20 ms with the MMAs taken out, against 0.69 ms
//   for its 1.15 M padded rows x 384 x 128 x 6 operations at the TF32
//   peak. Design:
//   - The lists: subm_conv_dw_pairs_count / _write list each offset k's
//     (output voxel, input row) pairs ascending by voxel, from the plan
//     alone, with a span table: starts[s][k], the first of list k's
//     pairs whose voxel lies in span s. Built once per conv call (K1) and
//     once per backward (d_feats and d_w together), shared by the column
//     blocks; no host wait. K1 multiplies list k by weight[26 - k],
//     d_feats by weight[k]^T (the mirror: u is v's neighbour at offset o
//     iff v is u's at -o).
//   - Output-stationary: a CTA owns a span of kSpan = 128 output voxels x
//     one column block (NP <= 192), its float32 sums in shared memory
//     ([128][NP + 4]). For each offset with pairs, in order, it gathers
//     the rows of the span's pairs at that offset by cp.async, in 16-row
//     groups (zero past the pairs), KC channels a stage, with the weight
//     block of the offset beside them; warps split the groups and the
//     output columns. At the offset's last stage each warp adds its sums
//     into the pairs' rows of the span's accumulator: the rows of one
//     offset are distinct, and the barriers between stages order the
//     offsets, so every sum is added in one fixed order. No atomics, no
//     cross-CTA reduction: the same inputs give the same bits.
//   - The weight reckoning: every (span, offset) with pairs reads the
//     offset's Cin x NP block, so at level 3 (~43 pairs a span and offset)
//     the weight bytes are ~3x the gathered bytes at 4 bytes an element.
//     The two levers: a wider span would halve them, but its accumulator
//     does not fit beside the ring; the plain float32 block split once a
//     stage in shared memory (half the bytes of a (hi, lo) pack) measured
//     slower on the card, the split pass and its second barrier costing
//     more than the bytes saved (384 -> 128 at level 3: 4.66 against 4.33
//     ms, and 4.85 with 8 warps in place of 16). So a first kernel
//     (subm_conv_pairs_f32_pack) packs the block n-major and split into a
//     (27, 2, NP, kpc) scratch once per launch (ldmatrix cannot transpose
//     32-bit elements), and the A fragments are split in registers.
//   - Each MMA's three products sum from zero and join the offset's sums
//     by a float32 add: the MMA's own accumulation drops low bits, and
//     chained over a whole column loop it drifted on the card past
//     chip_smoke's float32 gradient check (1e-3 of a gradient's largest
//     value, where gradients cancel). The three MMAs of the 8-wide blocks
//     are issued block-interleaved (all lo*hi, then all hi*lo, then all
//     hi*hi), in mma_3xtf32's order within a block: the same sums.
//   - 8 warps a CTA: one CTA an SM from NP = 96 (the accumulator and the
//     ring fill it), two below.
//   - The stem (Cin = 1: 4-byte rows) gathers with plain loads.
//   - Epilogue: the accumulator written as 16-byte rows.

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- bfloat16

constexpr int kTileM = 128;             // voxels per CTA
constexpr int kWarps = kTileM / 16;     // one 16-row block per warp
constexpr int kThreads = kWarps * 32;
constexpr int kKC = 32;                 // K depth of one pipeline stage
constexpr int kStages = 4;              // cp.async ring depth
constexpr int kApitch = kKC + 8;        // bf16 per A row in shared memory
constexpr int kFlags = 32;              // ints: column flags, list, count

// bf16 elements of one ring stage of the NP-wide kernel: A, then B as
// [kKC][NP + 8] (forward) or as [NP][kKC + 8] (mirror).
__host__ __device__ constexpr int tc_stage_elems(int np) {
  return kTileM * kApitch
         + (kKC * (np + 8) > np * kApitch ? kKC * (np + 8) : np * kApitch);
}

// Dynamic shared memory of the NP-wide kernel: the resolved rows, the
// column list, then the ring of stages (reused by the epilogue).
constexpr int tc_smem_bytes(int np) {
  return (27 * kTileM + kFlags) * 4 + kStages * tc_stage_elems(np) * 2;
}

// NT = NP / 16: 16-wide output blocks per warp. feats (V, cin) and out (V,
// cout) bf16; weight is the FORWARD weight, bf16: (27, cin, cout) when
// !MIRROR, (27, cout, cin) when MIRROR (d_feats: feats is the cotangent
// and column c's slot t multiplies weight[26 - 3c - t]^T). Column c's B
// block is (kp, NP), zero beyond 3*cin rows and cout columns. The two modes
// are instances of one kernel: they differ in how B is staged and loaded.
template <int NT, bool MIRROR>
__global__ void __launch_bounds__(kThreads, NT <= 6 ? 2 : 1)
subm_conv_tc_kernel(const bf16* __restrict__ feats,
                    const int* __restrict__ ranks,
                    const int* __restrict__ sel,
                    const bf16* __restrict__ weight, bf16* __restrict__ out,
                    int V, int cin, int cout, int kp) {
  using namespace mopa_tc;
  constexpr int NP = 16 * NT;
  constexpr int kBpitch = NP + 8;   // forward B: [kKC][kBpitch]
  constexpr int kAStage = kTileM * kApitch;
  constexpr int kStage = tc_stage_elems(NP);
  extern __shared__ __align__(16) unsigned char smem[];
  int* src_s = reinterpret_cast<int*>(smem);  // [27][kTileM] source rows
  int* flag_s = src_s + 27 * kTileM;          // [0, 9) active, [16, 25) list
  bf16* ring = reinterpret_cast<bf16*>(flag_s + kFlags);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long v0 = static_cast<long long>(blockIdx.x) * kTileM;

  for (int i = tid; i < 27 * kTileM; i += kThreads) src_s[i] = -1;
  if (tid < kFlags) flag_s[tid] = 0;
  __syncthreads();
  for (int i = tid; i < kTileM * 9; i += kThreads) {
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
        src_s[(3 * c + t) * kTileM + lv] = static_cast<int>(row);
        flag_s[c] = 1;
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int c = 0; c < 9; ++c)
      if (flag_s[c]) flag_s[16 + n++] = c;
    flag_s[kFlags - 1] = n;
  }
  __syncthreads();

  const int nck = kp / kKC;  // stages per column
  const int n_items = flag_s[kFlags - 1] * nck;
  const int kcol = 3 * cin;
  const bool vec_a = (cin % 8) == 0;
  // 16-byte B pieces run along cout (forward) or along cin (mirror)
  const bool vec_b = ((MIRROR ? cin : cout) % 8) == 0;

  // Stage `item` (column list[item / nck], K rows [k0, k0 + kKC)) into ring
  // slot `slot`.
  auto load = [&](int item, int slot) {
    const int c = flag_s[16 + item / nck];
    const int k0 = (item % nck) * kKC;
    bf16* a_s = ring + slot * kStage;
    bf16* b_s = a_s + kAStage;
    if (vec_a) {
      // thread's 16-byte piece s = tid % 4 of rows tid / 4 + 64 i
      const int k = k0 + 8 * (tid % (kKC / 8));
      const int t = k < kcol ? k / cin : 0;
      const int ci = k - t * cin;
      for (int lv = tid / (kKC / 8); lv < kTileM;
           lv += kThreads / (kKC / 8)) {
        const int row = k < kcol ? src_s[(3 * c + t) * kTileM + lv] : -1;
        const bf16* src =
            row >= 0 ? feats + static_cast<size_t>(row) * cin + ci : feats;
        cp_async16(smem_u32(a_s + lv * kApitch + (k - k0)), src, row >= 0);
      }
    } else {  // rows narrower than 16 bytes (the stem): plain loads,
              // voxels across the threads so the few real K rows spread
      for (int i = tid; i < kTileM * kKC; i += kThreads) {
        const int lv = i % kTileM;
        const int k = k0 + i / kTileM;
        bf16 val = __float2bfloat16(0.f);
        if (k < kcol) {
          const int t = k / cin;
          const int row = src_s[(3 * c + t) * kTileM + lv];
          if (row >= 0)
            val = feats[static_cast<size_t>(row) * cin + (k - t * cin)];
        }
        a_s[lv * kApitch + (k - k0)] = val;
      }
    }
    if (!MIRROR) {
      // B[k][n] = weight[3c + k / cin][k % cin][n]: row 3c*cin + k of the
      // (27*cin, cout) weight
      const bf16* wc = weight + static_cast<size_t>(3 * c * cin) * cout;
      if (vec_b) {
        for (int i = tid; i < kKC * (NP / 8); i += kThreads) {
          const int r = i / (NP / 8);
          const int n = 8 * (i % (NP / 8));
          const bool ok = k0 + r < kcol && n < cout;
          const bf16* src =
              ok ? wc + static_cast<size_t>(k0 + r) * cout + n : weight;
          cp_async16(smem_u32(b_s + r * kBpitch + n), src, ok);
        }
      } else {
        for (int i = tid; i < kKC * NP; i += kThreads) {
          const int r = i / NP;
          const int n = i % NP;
          b_s[r * kBpitch + n] =
              k0 + r < kcol && n < cout
                  ? wc[static_cast<size_t>(k0 + r) * cout + n]
                  : __float2bfloat16(0.f);
        }
      }
    } else {
      // Bt[n][k] = B[k][n] = weight[26 - 3c - t][n][k % cin], t = k / cin:
      // along k the rows of W[26 - 3c - t] are contiguous
      if (vec_b) {
        for (int i = tid; i < NP * (kKC / 8); i += kThreads) {
          const int n = i / (kKC / 8);
          const int kk = 8 * (i % (kKC / 8));
          const int k = k0 + kk;
          const bool ok = k < kcol && n < cout;
          const bf16* src = weight;
          if (ok) {
            const int t = k / cin;
            src = weight
                + (static_cast<size_t>(26 - 3 * c - t) * cout + n) * cin
                + (k - t * cin);
          }
          cp_async16(smem_u32(b_s + n * kApitch + kk), src, ok);
        }
      } else {
        for (int i = tid; i < NP * kKC; i += kThreads) {
          const int n = i / kKC;
          const int k = k0 + i % kKC;
          bf16 val = __float2bfloat16(0.f);
          if (k < kcol && n < cout) {
            const int t = k / cin;
            val = weight[(static_cast<size_t>(26 - 3 * c - t) * cout + n)
                             * cin
                         + (k - t * cin)];
          }
          b_s[n * kApitch + i % kKC] = val;
        }
      }
    }
  };

  float acc[NT][2][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][h][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_items) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed; stage it - 1 is free for reuse
    const int next = it + kStages - 1;
    if (next < n_items) load(next, next % kStages);
    cp_async_commit();
    const bf16* a_s = ring + (it % kStages) * kStage;
    const bf16* b_s = a_s + kAStage;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(smem_u32(a_s + (warp * 16 + (lane & 15)) * kApitch + ks * 16
                       + (lane >> 4) * 8),
              a);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // b[0], b[1]: output columns 16j..16j+7; b[2], b[3]: +8
        uint32_t b[4];
        if (!MIRROR)
          ldsm_x4_trans(smem_u32(b_s + (ks * 16 + (lane & 15)) * kBpitch
                                 + j * 16 + (lane >> 4) * 8),
                        b);
        else  // matrix q of the x4: n + 8 (q / 2), k + 8 (q % 2)
          ldsm_x4(smem_u32(b_s + (j * 16 + (lane & 7) + (lane >> 4) * 8)
                                     * kApitch
                           + ks * 16 + ((lane >> 3) & 1) * 8),
                  b);
        mma_bf16(acc[j][0], a, b[0], b[1]);
        mma_bf16(acc[j][1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the bf16 tile there

  bf16* o_s = ring;  // [kTileM][kBpitch]
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = j * 16 + h * 8 + 2 * q;
      const int row = warp * 16 + g;
      *reinterpret_cast<__nv_bfloat162*>(o_s + row * kBpitch + col) =
          __floats2bfloat162_rn(acc[j][h][0], acc[j][h][1]);
      *reinterpret_cast<__nv_bfloat162*>(o_s + (row + 8) * kBpitch + col) =
          __floats2bfloat162_rn(acc[j][h][2], acc[j][h][3]);
    }
  __syncthreads();
  if (cout % 8 == 0) {
    const int segs = cout / 8;
    for (int i = tid; i < kTileM * segs; i += kThreads) {
      const int lv = i / segs;
      const int s = i % segs;
      const long long v = v0 + lv;
      if (v < V)
        *reinterpret_cast<uint4*>(out + v * cout + 8 * s) =
            *reinterpret_cast<const uint4*>(o_s + lv * kBpitch + 8 * s);
    }
  } else {
    for (int i = tid; i < kTileM * cout; i += kThreads) {
      const int lv = i / cout;
      const int co = i % cout;
      const long long v = v0 + lv;
      if (v < V) out[v * cout + co] = o_s[lv * kBpitch + co];
    }
  }
}

template <int NT, bool MIRROR>
int launch_tc(const bf16* f, const int* r, const int* s, const bf16* w,
              bf16* o, int V, int cin, int cout, int kp, cudaStream_t st) {
  static bool granted = false;  // per instance
  const int smem = tc_smem_bytes(16 * NT);
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        subm_conv_tc_kernel<NT, MIRROR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = true;
  }
  subm_conv_tc_kernel<NT, MIRROR>
      <<<(V + kTileM - 1) / kTileM, kThreads, smem, st>>>(f, r, s, w, o, V,
                                                         cin, cout, kp);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- float32

constexpr int kSpan = 128;            // output voxels per CTA
constexpr int kMaxGroups = kSpan / 16;
constexpr int kOffsets = 27;
constexpr int kPackK = 32;            // the weight pack's K padding

// K depth of one pipeline stage at NP = 16 * NT: 16 where a 32-deep ring
// would not fit (NP = 192; two CTAs an SM up to NP = 64), else 32.
__host__ __device__ constexpr int pair_kc(int np) {
  return np <= 64 || np > 128 ? 16 : 32;
}

// Warps along the output columns at NP = 16 * NT: each holds 8 * N8
// columns, N8 = 2 * NT / WN whole 8-wide MMA blocks; the other 8 / WN warps
// split the pair groups.
__host__ __device__ constexpr int pair_wn(int nt) {
  return nt == 1 || nt == 3 ? 2 : 4;
}

// floats of one ring stage: A [kSpan][kc + 4], then B's high and low
// parts, each [NP][kc + 4] (n-major, as the pack lies).
__host__ __device__ constexpr int pair_stage_floats(int np) {
  return (kSpan + 2 * np) * (pair_kc(np) + 4);
}

// Bytes before the ring: the span's accumulator [kSpan][NP + 4], the
// pair entries (input row, output row in the span) of up to 27 * kSpan
// pairs, the per-offset table.
__host__ __device__ constexpr int pair_head_bytes(int np) {
  return kSpan * (np + 4) * 4 + kOffsets * kSpan * 5 + 4 * 4 * 32;
}

// Ring depth: as many stages (2 to 4) as fit beside the head, within half
// the SM's shared memory up to NP = 64 (two CTAs an SM) and all of it above.
__host__ __device__ constexpr int pair_stages(int np) {
  const int budget = np <= 64 ? 113 * 1024 : 227 * 1024;
  const int free_b = budget - pair_head_bytes(np);
  const int per = pair_stage_floats(np) * 4;
  return free_b >= 4 * per ? 4 : free_b >= 3 * per ? 3 : 2;
}

__host__ __device__ constexpr int pair_smem_bytes(int np) {
  return pair_head_bytes(np) + pair_stages(np) * pair_stage_floats(np) * 4;
}

// The B operand of every list, split: pack (27, 2, np, kpc), pack[k][0]
// and pack[k][1] the TF32 high and low parts of list k's (kpc, np) block
// B, transposed (n-major) so that ldmatrix gives its fragments: forward
// (weight (27, cin, cout)) B[kk][n] = weight[26 - k][kk][n]; mirror
// (weight (27, cout, cin)) B[kk][n] = weight[k][n][kk]; zero past cin rows
// and cout columns. Through a 32 x 32 shared tile, so that reads and
// writes are both coalesced; grid (kpc / 32, np / 32 rounded up, 27),
// block (32, 8).
__global__ void subm_conv_pairs_f32_pack(const float* __restrict__ weight,
                                         float* __restrict__ pack, int cin,
                                         int cout, int kpc, int np,
                                         int mirror) {
  __shared__ float tile[32][33];  // [kk][n]
  const int k = blockIdx.z;
  const int kk0 = blockIdx.x * 32;
  const int n0 = blockIdx.y * 32;
  const int tx = threadIdx.x;
  for (int r = threadIdx.y; r < 32; r += 8) {
    if (!mirror) {  // rows kk, along n
      const int kk = kk0 + r;
      const int n = n0 + tx;
      tile[r][tx] = kk < cin && n < cout
          ? weight[(static_cast<size_t>(26 - k) * cin + kk) * cout + n]
          : 0.f;
    } else {  // rows n, along kk
      const int n = n0 + r;
      const int kk = kk0 + tx;
      tile[tx][r] = n < cout && kk < cin
          ? weight[(static_cast<size_t>(k) * cout + n) * cin + kk]
          : 0.f;
    }
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int n = n0 + r;
    const int kk = kk0 + tx;
    if (n >= np) continue;
    uint32_t hi, lo;
    mopa_tc::tf32_split(tile[tx][r], hi, lo);
    float* p = pack + (static_cast<size_t>(2 * k) * np + n) * kpc + kk;
    p[0] = __uint_as_float(hi);
    p[static_cast<size_t>(np) * kpc] = __uint_as_float(lo);
  }
}

// K1 or K2 d_feats over the pair lists, 3xTF32. feats (V, cin) and out
// (V, cout) float32; pairs (27, V) int2 and starts (ceil(V / kSpan) + 1,
// 27) int32 from mopa_subm_conv_pairs: list k holds (output voxel, input
// row) pairs ascending by voxel, and span s's pairs of offset k are list
// k's entries [starts[s][k], starts[s + 1][k]). pack is
// subm_conv_pairs_f32_pack's (27, 2, NP, kpc): K1 and d_feats differ only
// there. One CTA a span; NT = NP / 16 >= cout / 16.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 4 ? 2 : 1)
subm_conv_pairs_f32_tc_kernel(const float* __restrict__ feats,
                              const int2* __restrict__ pairs,
                              const int* __restrict__ starts,
                              const float* __restrict__ pack,
                              float* __restrict__ out, int V, int cin,
                              int cout, int kpc) {
  using namespace mopa_tc;
  constexpr int NP = 16 * NT;
  constexpr int KC = pair_kc(NP);
  constexpr int kPitch = KC + 4;         // floats per staged A or B row
  constexpr int WN = pair_wn(NT);
  constexpr int WM = kWarps / WN;
  constexpr int N8 = 2 * NT / WN;        // 8-wide blocks a warp holds
  constexpr int MT = kMaxGroups / WM;    // 16-pair groups a warp may hold
  constexpr int kS = pair_stages(NP);
  constexpr int kStage = pair_stage_floats(NP);
  constexpr int kAccPitch = NP + 4;
  static_assert(N8 * WN == 2 * NT && MT * WM == kMaxGroups, "warp tiling");
  static_assert(pair_smem_bytes(NP) <= 227 * 1024, "shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc_s = reinterpret_cast<float*>(smem);   // [kSpan][kAccPitch]
  int* in_s = reinterpret_cast<int*>(acc_s + kSpan * kAccPitch);
  int* tab_s = in_s + kOffsets * kSpan;  // [0,32) count, [32,64) start,
                                         // [64,96) base, [96,128) offsets
  unsigned char* out_s = reinterpret_cast<unsigned char*>(tab_s + 4 * 32);
  float* ring = reinterpret_cast<float*>(smem + pair_head_bytes(NP));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int q = lane & 3;
  const int wr = warp / WN;              // group row of this warp
  const int n0 = (warp % WN) * 8 * N8;   // its first output column
  const int s = blockIdx.x;
  const long long v0 = static_cast<long long>(s) * kSpan;

  for (int i = tid; i < kSpan * kAccPitch / 4; i += kThreads)
    reinterpret_cast<float4*>(acc_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < kOffsets) {
    const int a = starts[static_cast<size_t>(s) * kOffsets + tid];
    tab_s[tid] = starts[static_cast<size_t>(s + 1) * kOffsets + tid] - a;
    tab_s[32 + tid] = a;
  }
  __syncthreads();
  if (tid == 0) {  // the offsets with pairs, in order, and their entries
    int n = 0, base = 0;
    for (int k = 0; k < kOffsets; ++k) {
      if (tab_s[k] == 0) continue;
      tab_s[96 + n] = k;
      tab_s[64 + n++] = base;
      base += tab_s[k];
    }
    tab_s[127] = n;
  }
  __syncthreads();
  const int n_off = tab_s[127];
  // each offset's entries (at most kSpan of them), two offsets a pass
  for (int a = tid / kSpan; a < n_off; a += kThreads / kSpan) {
    const int k = tab_s[96 + a];
    const int i = tid % kSpan;
    if (i < tab_s[k]) {
      const int2 pr =
          pairs[static_cast<size_t>(k) * V + tab_s[32 + k] + i];
      in_s[tab_s[64 + a] + i] = pr.y;
      out_s[tab_s[64 + a] + i] = static_cast<unsigned char>(pr.x - v0);
    }
  }
  __syncthreads();

  const int nck = (cin + KC - 1) / KC;  // stages per offset
  const int n_items = n_off * nck;
  const bool vec_a = cin % 4 == 0
      && (reinterpret_cast<uintptr_t>(feats) & 15) == 0;

  // Stage item `item` (offset list[item / nck], K rows [k0, k0 + KC)) into
  // ring slot `slot`: the gathered rows of the offset's pairs, zero up to
  // whole 16-row groups and past cin, and the pack's block.
  auto load = [&](int item, int slot) {
    const int a = item / nck;
    const int k = tab_s[96 + a];
    const int n = tab_s[k];
    const int base = tab_s[64 + a];
    const int rows = (n + 15) & ~15;
    const int k0 = (item % nck) * KC;
    float* a_s = ring + slot * kStage;
    float* b_s = a_s + kSpan * kPitch;
    if (vec_a) {
      for (int i = tid; i < rows * (KC / 4); i += kThreads) {
        const int r = i / (KC / 4);
        const int c = k0 + 4 * (i % (KC / 4));
        const bool ok = r < n && c < cin;
        const float* src =
            ok ? feats + static_cast<size_t>(in_s[base + r]) * cin + c
               : feats;
        cp_async16(smem_u32(a_s + r * kPitch + c - k0), src, ok);
      }
    } else {  // rows narrower than 16 bytes (the stem): plain loads
      for (int i = tid; i < rows * KC; i += kThreads) {
        const int r = i / KC;
        const int c = k0 + i % KC;
        a_s[r * kPitch + c - k0] =
            r < n && c < cin
                ? feats[static_cast<size_t>(in_s[base + r]) * cin + c]
                : 0.f;
      }
    }
    // B: rows [0, NP) the high part, [NP, 2 NP) the low part of list k,
    // K columns [k0, k0 + KC): dense, padded by the pack
    const float* wk = pack + static_cast<size_t>(2 * k) * NP * kpc + k0;
    for (int i = tid; i < 2 * NP * (KC / 4); i += kThreads) {
      const int r = i / (KC / 4);
      const int kk = 4 * (i % (KC / 4));
      cp_async16(smem_u32(b_s + r * kPitch + kk),
                 wk + static_cast<size_t>(r) * kpc + kk, true);
    }
  };

  // the offset's sums of this warp's groups (m-tile i is group wr + WM i)
  float acc[MT][N8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kS - 1; ++st) {
    if (st < n_items) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<kS - 2>();
    __syncthreads();  // stage `it` landed; stage it - 1 is free for reuse
    const int next = it + kS - 1;
    if (next < n_items) load(next, next % kS);
    cp_async_commit();
    const int a = it / nck;
    const int k = tab_s[96 + a];
    const int n = tab_s[k];
    const int groups = (n + 15) >> 4;
    if (wr >= groups) continue;  // uniform per warp; no scatter either
    const int k0 = (it % nck) * KC;
    const int ksteps = (min(KC, cin - k0) + 7) / 8;
    const float* a_s = ring + (it % kS) * kStage;
    const float* bh_s = a_s + kSpan * kPitch;
    const float* bl_s = bh_s + NP * kPitch;
#pragma unroll 1
    for (int ks = 0; ks < ksteps; ++ks) {
      // B of 8-wide block j: x4 matrix m is columns n0 + 16 (j / 2) +
      // 8 (m / 2), K + 4 (m % 2); an odd last block by x2
      uint32_t bh[N8][2], bl[N8][2];
#pragma unroll
      for (int j = 0; j + 1 < N8; j += 2) {
        const int off = (n0 + 8 * j + (lane & 7) + (lane >> 4) * 8) * kPitch
            + ks * 8 + ((lane >> 3) & 1) * 4;
        uint32_t r[4];
        ldsm_x4(smem_u32(bh_s + off), r);
        bh[j][0] = r[0]; bh[j][1] = r[1]; bh[j + 1][0] = r[2];
        bh[j + 1][1] = r[3];
        ldsm_x4(smem_u32(bl_s + off), r);
        bl[j][0] = r[0]; bl[j][1] = r[1]; bl[j + 1][0] = r[2];
        bl[j + 1][1] = r[3];
      }
      if (N8 % 2) {
        const int off = (n0 + 8 * (N8 - 1) + (lane & 7)) * kPitch + ks * 8
            + ((lane >> 3) & 1) * 4;
        ldsm_x2(smem_u32(bh_s + off), bh[N8 - 1]);
        ldsm_x2(smem_u32(bl_s + off), bl[N8 - 1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int grp = wr + WM * i;
        if (grp >= groups) break;  // uniform per warp
        // matrix m of the x4: rows + 8 (m % 2), K + 4 (m / 2) -> a0..a3
        uint32_t av[4], a_hi[4], a_lo[4];
        ldsm_x4(smem_u32(a_s + (grp * 16 + (lane & 15)) * kPitch + ks * 8
                         + (lane >> 4) * 4),
                av);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32_split(__uint_as_float(av[e]), a_hi[e], a_lo[e]);
        // each block's three products from zero, then a float32 add
        // (header); the blocks' MMAs interleaved so that no MMA waits on
        // the one before it (mma_3xtf32's order within each block)
        float part[N8][4];
#pragma unroll
        for (int j = 0; j < N8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
        for (int j = 0; j < N8; ++j)
          mma_tf32(part[j], a_lo, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < N8; ++j)
          mma_tf32(part[j], a_hi, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < N8; ++j)
          mma_tf32(part[j], a_hi, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < N8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[j][e];
      }
    }
    if (it % nck != nck - 1) continue;
    // the offset's last stage: add its sums into the span's rows (distinct
    // within an offset; the next stage's barrier orders the offsets)
    const int base = tab_s[64 + a];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int grp = wr + WM * i;
      if (grp < groups) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = grp * 16 + gq + 8 * h;
          if (r < n) {
            float* dst = acc_s + out_s[base + r] * kAccPitch + n0 + 2 * q;
#pragma unroll
            for (int j = 0; j < N8; ++j) {
              float2* p = reinterpret_cast<float2*>(dst + 8 * j);
              float2 x = *p;
              x.x += acc[i][j][2 * h];
              x.y += acc[i][j][2 * h + 1];
              *p = x;
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < N8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every offset's sums are in acc_s

  if (cout % 4 == 0) {
    const int segs = cout / 4;
    for (int i = tid; i < kSpan * segs; i += kThreads) {
      const int lv = i / segs;
      const int sg = i % segs;
      const long long v = v0 + lv;
      if (v < V)
        *reinterpret_cast<float4*>(out + v * cout + 4 * sg) =
            *reinterpret_cast<const float4*>(acc_s + lv * kAccPitch + 4 * sg);
    }
  } else {
    for (int i = tid; i < kSpan * cout; i += kThreads) {
      const int lv = i / cout;
      const int co = i % cout;
      const long long v = v0 + lv;
      if (v < V) out[v * cout + co] = acc_s[lv * kAccPitch + co];
    }
  }
}

template <int NT>
int launch_pairs_f32(const float* f, const int2* p, const int* st,
                     const float* pk, float* o, int V, int cin, int cout,
                     int kpc, cudaStream_t stream) {
  static bool granted = false;  // per instance
  const int smem = pair_smem_bytes(16 * NT);
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        subm_conv_pairs_f32_tc_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = true;
  }
  subm_conv_pairs_f32_tc_kernel<NT>
      <<<(V + kSpan - 1) / kSpan, kThreads, smem, stream>>>(f, p, st, pk, o,
                                                           V, cin, cout,
                                                           kpc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 and K2 d_feats on the float32 route (3xTF32 tensor cores), over the
// pair lists of mopa_subm_conv_pairs (submanifold_conv_dw.cu). feats (V,
// cin) and out (V, cout) float32, contiguous; pairs (27, V) int2 and starts
// (ceil(V / span) + 1, 27) int32, written for span = kSpan (128) voxels;
// weight the FORWARD weight in place, float32, as mopa_subm_conv_tc takes
// it (mirror = 1: d_feats, feats the cotangent); pack a (27, 2, np, kpc)
// float32 scratch, kpc = cin rounded up to 32, that the first of the two
// kernels launched fills with the split weight (subm_conv_pairs_f32_pack);
// np one of 16, 32, 48, 64, 96, 128, 192 and >= cout. Launches both on
// `stream` and returns cudaGetLastError().
extern "C" int mopa_subm_conv_f32(const void* feats, const void* pairs,
                                  const void* starts, const void* weight,
                                  void* pack, void* out, int V, int cin,
                                  int cout, int mirror, int np, int span,
                                  void* stream) {
  if (V <= 0) return 0;
  const int kpc = (cin + kPackK - 1) / kPackK * kPackK;
  if (cin < 1 || cout < 1 || cout > np || span != kSpan)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* f = static_cast<const float*>(feats);
  const int2* p = static_cast<const int2*>(pairs);
  const int* st = static_cast<const int*>(starts);
  float* pk = static_cast<float*>(pack);
  float* o = static_cast<float*>(out);
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  subm_conv_pairs_f32_pack<<<dim3(kpc / 32, (np + 31) / 32, kOffsets),
                             dim3(32, 8), 0, stream_>>>(
      static_cast<const float*>(weight), pk, cin, cout, kpc, np, mirror);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  switch (np) {
#define MOPA_CASE(NT)                                                      \
    case 16 * NT:                                                          \
      return launch_pairs_f32<NT>(f, p, st, pk, o, V, cin, cout, kpc,      \
                                  stream_);
    MOPA_CASE(1) MOPA_CASE(2) MOPA_CASE(3) MOPA_CASE(4) MOPA_CASE(6)
    MOPA_CASE(8) MOPA_CASE(12)
#undef MOPA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K1 and K2 d_feats on the bfloat16 tensor-core route. feats (V, cin) and
// out (V, cout) bfloat16, contiguous; weight the FORWARD weight in place,
// bfloat16:
// (27, cin, cout) when mirror = 0 (K1), (27, cout, cin) when mirror = 1
// (d_feats, feats the cotangent); ranks and sel int32 (V*9); the tile
// shape: kp a multiple of 32 and >= 3*cin, np one of 16, 32, 48, 64, 96,
// 128, 192 and >= cout.
extern "C" int mopa_subm_conv_tc(const void* feats, const void* ranks,
                                 const void* sel, const void* weight,
                                 void* out, int V, int cin, int cout,
                                 int mirror, int kp, int np, void* stream) {
  if (V <= 0) return 0;
  if (cin < 1 || cout < 1 || cout > np || kp % kKC != 0 || kp < 3 * cin)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* f = static_cast<const bf16*>(feats);
  const int* r = static_cast<const int*>(ranks);
  const int* s = static_cast<const int*>(sel);
  const bf16* w = static_cast<const bf16*>(weight);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (np) {
#define MOPA_CASE(NT)                                                      \
    case 16 * NT:                                                          \
      return mirror ? launch_tc<NT, true>(f, r, s, w, o, V, cin, cout, kp,  \
                                          st)                              \
                    : launch_tc<NT, false>(f, r, s, w, o, V, cin, cout,    \
                                           kp, st);
    MOPA_CASE(1) MOPA_CASE(2) MOPA_CASE(3) MOPA_CASE(4) MOPA_CASE(6)
    MOPA_CASE(8) MOPA_CASE(12)
#undef MOPA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

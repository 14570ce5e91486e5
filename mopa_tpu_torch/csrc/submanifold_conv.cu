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
//   JAX package): subm_conv_f32_tc_kernel, tensor cores in 3xTF32, so
//   float32 stays within 1e-4 of the plain twin (TF32 alone keeps 11 bits
//   of 24 and would not). Each operand is split into a TF32 high and low
//   part, and each product accumulates lo*hi + hi*lo + hi*hi in float32
//   through mma.sync m16n8k8 (tensor_core.cuh): three MMAs where bf16 has
//   one, on operands twice as wide, so both the staged bytes and the MMA
//   work double or triple against the bf16 route. The design is the bf16
//   kernel's, with these differences:
//   - A stage is kKC = 32 deep, as in bf16 (one 16-byte cp.async piece is
//     4 channels), in a 2-stage ring: twice the bytes a stage, and 2
//     stages of a 192-wide tile fill 161 KB. On the card 32-deep stages
//     were faster over the MoPA shapes than 16-deep ones in a 3-4 deep
//     ring.
//   - Each stage's products sum from zero in registers (a few 16-column
//     blocks at a time) and join the float32 accumulator by an add. The
//     MMA's own accumulation drops low bits: chained over a whole column
//     loop it drifted on the card past chip_smoke's float32 gradient check
//     (1e-3 of a gradient's largest value, where gradients cancel).
//   - ldmatrix.trans moves 16-bit elements and cannot transpose float32.
//     So a first kernel (subm_conv_f32_pack) packs the weight n-major into
//     a (9, 2, NP, KP) scratch: column c's (3*Cin, Cout) block transposed,
//     its TF32 high part, then its low part, zero-padded, once per launch.
//     A plain ldmatrix then gives the B fragments, and B needs no
//     conversion in the loop. The A fragments come from the voxel-major
//     windows by a plain ldmatrix too, and are split in registers.
//   - The mirror mode (d_feats) is the same kernel on the pack of
//     W' = weight[::-1].transpose(1, 2): the pack is where the two differ.
//   - The stem (Cin = 1: 4-byte rows) stages with plain loads; SPVCNN's
//     stem (Cin = 4) is one cp.async a row.
//   - Epilogue: float32 through shared memory, written as 16-byte rows.

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

constexpr int kStages32 = 2;          // cp.async ring depth
constexpr int kPitch32 = kKC + 4;     // floats per staged A / B row

// floats of one ring stage: A [kTileM][kPitch32], then B's high and low
// parts, each [NP][kPitch32].
__host__ __device__ constexpr int f32_stage_floats(int np) {
  return (kTileM + 2 * np) * kPitch32;
}

// Dynamic shared memory of the NP-wide float32 kernel: the resolved rows,
// the column list, then the ring of stages, which the epilogue's
// [kTileM][NP + 8] tile reuses.
constexpr int f32_smem_bytes(int np) {
  return (27 * kTileM + kFlags) * 4
         + 4 * (kStages32 * f32_stage_floats(np) > kTileM * (np + 8)
                    ? kStages32 * f32_stage_floats(np)
                    : kTileM * (np + 8));
}

// The float32 kernel's B operand from the FORWARD weight (as
// subm_conv_tc_kernel reads it: (27, cin, cout) when !mirror, (27, cout,
// cin) when mirror): pack (9, 2, np, kp), pack[c][0][n][k] and
// pack[c][1][n][k] the TF32 high and low parts of column c's B[k][n], zero
// beyond 3*cin rows and cout columns. n-major, so that ldmatrix gives the
// B fragments with no transpose; split once per launch, not per MMA.
__global__ void subm_conv_f32_pack(const float* __restrict__ weight,
                                   float* __restrict__ pack, int cin,
                                   int cout, int kp, int np, int mirror) {
  const long long total = 9LL * np * kp;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(i % kp);
    const int n = static_cast<int>((i / kp) % np);
    const int c = static_cast<int>(i / (static_cast<long long>(kp) * np));
    float b = 0.f;
    if (k < 3 * cin && n < cout) {
      const int t = k / cin;
      const int ci = k - t * cin;
      b = mirror
              ? weight[(static_cast<size_t>(26 - 3 * c - t) * cout + n) * cin
                       + ci]
              : weight[(static_cast<size_t>(3 * c + t) * cin + ci) * cout
                       + n];
    }
    uint32_t hi, lo;
    mopa_tc::tf32_split(b, hi, lo);
    float* p = pack + (static_cast<size_t>(c) * 2 * np + n) * kp + k;
    p[0] = __uint_as_float(hi);
    p[static_cast<size_t>(np) * kp] = __uint_as_float(lo);
  }
}

// NT = NP / 16. feats (V, cin) and out (V, cout) float32; wpack the
// (9, 2, NP, kp) pack of subm_conv_f32_pack. The forward (K1) and the
// mirror (d_feats) differ only in the pack. Two CTAs an SM up to NP = 64:
// at NP = 96 the split fragments do not fit 128 registers a thread (ptxas
// spills).
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 4 ? 2 : 1)
subm_conv_f32_tc_kernel(const float* __restrict__ feats,
                        const int* __restrict__ ranks,
                        const int* __restrict__ sel,
                        const float* __restrict__ wpack,
                        float* __restrict__ out, int V, int cin, int cout,
                        int kp) {
  using namespace mopa_tc;
  constexpr int NP = 16 * NT;
  constexpr int kS = kStages32;
  constexpr int kAStage = kTileM * kPitch32;
  constexpr int kBStage = NP * kPitch32;  // one of the high, low parts
  constexpr int kStage = f32_stage_floats(NP);
  constexpr int kOpitch = NP + 8;
  // 16-column blocks whose stage sums are held at once: half the blocks
  // above 4, so the partial sums fit the registers beside the accumulator
  constexpr int kGroup = NT <= 4 ? NT : NT / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  int* src_s = reinterpret_cast<int*>(smem);  // [27][kTileM] source rows
  int* flag_s = src_s + 27 * kTileM;          // [0, 9) active, [16, 25) list
  float* ring = reinterpret_cast<float*>(flag_s + kFlags);

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
  const bool vec_a = (cin % 4) == 0;

  // Stage `item` (column list[item / nck], K rows [k0, k0 + kKC)) into
  // ring slot `slot`.
  auto load = [&](int item, int slot) {
    const int c = flag_s[16 + item / nck];
    const int k0 = (item % nck) * kKC;
    float* a_s = ring + slot * kStage;
    float* b_s = a_s + kAStage;
    if (vec_a) {
      // thread's 16-byte piece s = tid % 4 of rows tid / 4 + 64 i
      const int k = k0 + 4 * (tid % (kKC / 4));
      const int t = k < kcol ? k / cin : 0;
      const int ci = k - t * cin;
      for (int lv = tid / (kKC / 4); lv < kTileM;
           lv += kThreads / (kKC / 4)) {
        const int row = k < kcol ? src_s[(3 * c + t) * kTileM + lv] : -1;
        const float* src =
            row >= 0 ? feats + static_cast<size_t>(row) * cin + ci : feats;
        cp_async16(smem_u32(a_s + lv * kPitch32 + (k - k0)), src, row >= 0);
      }
    } else {  // rows narrower than 16 bytes (the stem): plain loads,
              // voxels across the threads so the few real K rows spread
      for (int i = tid; i < kTileM * kKC; i += kThreads) {
        const int lv = i % kTileM;
        const int k = k0 + i / kTileM;
        float val = 0.f;
        if (k < kcol) {
          const int t = k / cin;
          const int row = src_s[(3 * c + t) * kTileM + lv];
          if (row >= 0)
            val = feats[static_cast<size_t>(row) * cin + (k - t * cin)];
        }
        a_s[lv * kPitch32 + (k - k0)] = val;
      }
    }
    // B: rows [0, NP) the high part, [NP, 2 NP) the low part of column c,
    // K columns [k0, k0 + kKC): dense, padded by the wrapper
    const float* wc = wpack + static_cast<size_t>(c) * 2 * NP * kp + k0;
    for (int i = tid; i < 2 * NP * (kKC / 4); i += kThreads) {
      const int r = i / (kKC / 4);
      const int kk = 4 * (i % (kKC / 4));
      cp_async16(smem_u32(b_s + r * kPitch32 + kk),
                 wc + static_cast<size_t>(r) * kp + kk, true);
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
  for (int s = 0; s < kS - 1; ++s) {
    if (s < n_items) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<kS - 2>();
    __syncthreads();  // stage `it` landed; stage it - 1 is free for reuse
    const int next = it + kS - 1;
    if (next < n_items) load(next, next % kS);
    cp_async_commit();
    const float* a_s = ring + (it % kS) * kStage;
    const float* bh_s = a_s + kAStage;
    const float* bl_s = bh_s + kBStage;
    // The stage's products sum from zero, kGroup 16-column blocks at a
    // time, and join the accumulator by a float32 add (see the header).
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += kGroup) {
      float part[kGroup][2][4] = {};
      // not unrolled: unrolled, ptxas hoists the next k-steps' loads and
      // spills at NT = 4 and 12
#pragma unroll 1
      for (int ks = 0; ks < kKC / 8; ++ks) {
        // matrix i of the x4: rows + 8 (i % 2), K + 4 (i / 2) -> a0..a3
        uint32_t a[4], a_hi[4], a_lo[4];
        ldsm_x4(smem_u32(a_s + (warp * 16 + (lane & 15)) * kPitch32
                         + ks * 8 + (lane >> 4) * 4),
                a);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32_split(__uint_as_float(a[e]), a_hi[e], a_lo[e]);
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          // matrix i of the x4: columns n + 8 (i / 2), K + 4 (i % 2);
          // b[0], b[1]: output columns 16j..16j+7; b[2], b[3]: +8
          const int off =
              ((j0 + jj) * 16 + (lane & 7) + (lane >> 4) * 8) * kPitch32
              + ks * 8 + ((lane >> 3) & 1) * 4;
          uint32_t bh[4], bl[4];
          ldsm_x4(smem_u32(bh_s + off), bh);
          ldsm_x4(smem_u32(bl_s + off), bl);
          mma_3xtf32(part[jj][0], a_hi, a_lo, bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(part[jj][1], a_hi, a_lo, bh[2], bh[3], bl[2], bl[3]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j0 + jj][h][e] += part[jj][h][e];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the output tile there

  float* o_s = ring;  // [kTileM][kOpitch]
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = j * 16 + h * 8 + 2 * q;
      const int row = warp * 16 + g;
      *reinterpret_cast<float2*>(o_s + row * kOpitch + col) =
          make_float2(acc[j][h][0], acc[j][h][1]);
      *reinterpret_cast<float2*>(o_s + (row + 8) * kOpitch + col) =
          make_float2(acc[j][h][2], acc[j][h][3]);
    }
  __syncthreads();
  if (cout % 4 == 0) {
    const int segs = cout / 4;
    for (int i = tid; i < kTileM * segs; i += kThreads) {
      const int lv = i / segs;
      const int s = i % segs;
      const long long v = v0 + lv;
      if (v < V)
        *reinterpret_cast<float4*>(out + v * cout + 4 * s) =
            *reinterpret_cast<const float4*>(o_s + lv * kOpitch + 4 * s);
    }
  } else {
    for (int i = tid; i < kTileM * cout; i += kThreads) {
      const int lv = i / cout;
      const int co = i % cout;
      const long long v = v0 + lv;
      if (v < V) out[v * cout + co] = o_s[lv * kOpitch + co];
    }
  }
}

template <int NT>
int launch_f32_tc(const float* f, const int* r, const int* s,
                  const float* w, float* o, int V, int cin, int cout, int kp,
                  cudaStream_t st) {
  static bool granted = false;  // per instance
  const int smem = f32_smem_bytes(16 * NT);
  if (!granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        subm_conv_f32_tc_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = true;
  }
  subm_conv_f32_tc_kernel<NT>
      <<<(V + kTileM - 1) / kTileM, kThreads, smem, st>>>(f, r, s, w, o, V,
                                                         cin, cout, kp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 and K2 d_feats on the float32 route (3xTF32 tensor cores); arguments
// as mopa_subm_conv_tc's, in float32, plus `pack`, a (9, 2, np, kp) float32
// scratch that the first of the two kernels launched fills with the split
// weight (subm_conv_f32_pack). Launches both on `stream` and returns
// cudaGetLastError().
extern "C" int mopa_subm_conv_f32(const void* feats, const void* ranks,
                                  const void* sel, const void* weight,
                                  void* pack, void* out, int V, int cin,
                                  int cout, int mirror, int kp, int np,
                                  void* stream) {
  if (V <= 0) return 0;
  if (cin < 1 || cout < 1 || cout > np || kp % kKC != 0 || kp < 3 * cin)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* f = static_cast<const float*>(feats);
  const int* r = static_cast<const int*>(ranks);
  const int* s = static_cast<const int*>(sel);
  float* w = static_cast<float*>(pack);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = 9LL * np * kp;
  const long long blocks = total / 256 + 1;
  subm_conv_f32_pack<<<static_cast<unsigned>(blocks < 1056 ? blocks : 1056),
                       256, 0, st>>>(static_cast<const float*>(weight), w,
                                     cin, cout, kp, np, mirror);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  switch (np) {
#define MOPA_CASE(NT)                                                      \
    case 16 * NT:                                                          \
      return launch_f32_tc<NT>(f, r, s, w, o, V, cin, cout, kp, st);
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

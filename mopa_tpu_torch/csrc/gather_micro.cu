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
// indexes it.) One 16-byte vector per thread; a block is (D/8 chunk lanes) x
// (256 / (D/8) rows), so a warp's loads cover whole rows and its stores are
// one contiguous run of the output, written with streaming stores so the
// table stays in L2.
//
// P2 (mopa_gather_gemm) replaces kern in fused (tools/gather_micro.py:124,
// called at :135): the same gather fused with the wide-column GEMM of the
// level-0 conv,
//   out[s, v, :] = bf16( sum over j < 8 of tab[s, idx[s, 8v+j], :] @ w[jD:(j+1)D, :] ),
// with w (8D, 16) bfloat16, out (S, M, 16) bfloat16, products accumulated in
// float32 on the tensor cores. The reference keeps a sample's whole table in
// VMEM so the (V, 8D) gathered array never reaches HBM.
//
// An index outside [0, V) reads nothing and gives a row of zeros (both).
//
// Bound on this card: bytes. At the probe's shape (24 x 16,384 rows, D 48,
// Cout 16) P2 must read the 37.7 MB table and 12.6 MB of ranks and write 12.6
// MB; its 4.83 GFLOP take 0.005 ms of tensor-core time against 0.019 ms of
// memory time. An SM cannot hold a sample's 1.5 MiB table, but the probe's
// ranks (like a plan's) are sorted per sample, so the 512 ranks of one 64-row
// output tile fall in a window of about 64 consecutive table rows.
//
// P2's design (gather_gemm_tc_kernel<U>, U = D / 8):
// * Persistent CTAs (as many as fit on the SMs) walk 64-row output tiles
//   over (sample, row). The 4 warps split a tile's K: a warp owns 4 taps
//   (2 when D > 48) of 32 (64) output rows x 16 columns and keeps those
//   taps' B fragments in registers, read once per CTA from global memory
//   and zero past D, so no weight traffic remains per tile; the tap groups'
//   float32 sums meet in shared memory at the end of the tile.
// * A tile's 64 x 8 ranks arrive as one coalesced 2 KB cp.async; a min/max
//   reduction over the in-range ones gives the tile's [lo, hi] (the kernel
//   does not assume sorted ranks).
// * Window: when hi - lo < kWindowRows, table rows [lo, hi] are copied, one
//   contiguous run, into shared memory by 16-byte cp.async, at an odd pitch
//   of 16-byte units so eight gathered rows fall on distinct bank groups.
//   The window and the ranks are multi-buffered across tiles: the next
//   tile's window and the tile after's ranks are in flight while this tile
//   multiplies.
// * A fragments straight from the window: each lane gives ldmatrix the
//   address of the window row of its own gathered rank, so the gather costs
//   no staging copy; an out-of-range rank, and the K padding when D is an odd
//   multiple of 8, point at a zero row in shared memory. mma.sync m16n8k16
//   in (tap, k-step) order, the next step's A fragments loaded while this
//   step multiplies; then a quad transpose by shuffles so each lane stores
//   16 bytes of a 32-byte output row.
// * Fallback, right on any ranks: a tile whose span exceeds the window
//   gathers its rows from global memory, two taps at a time, into its
//   window buffer (zero-filled where a rank is out of range) and runs the
//   same MMAs. It is slower; ops/gather.py::tile_windows counts the tiles
//   that take it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kLanes = 8;            // bfloat16 lanes per 16-byte vector
constexpr int kGatherThreads = 256;  // P1 threads per block (at most)

// P2; ops/gather.py mirrors kTileM and kWindowRows (mopa_gather_gemm_tiling
// reports them, and chip_smoke.py holds the two to each other).
constexpr int kTaps = 8;             // wide columns per output row
constexpr int kCout = 16;            // output columns
constexpr int kDMax = 128;           // widest table row (bfloat16 lanes)
constexpr int kTileM = 64;           // output rows per tile
constexpr int kThreads = 128;        // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWindowRows = 128;     // table rows a window buffer holds
constexpr int kRoundTaps = kWindowRows / kTileM;  // fallback taps per round
constexpr int kRankBufs = 3;         // this tile, the next, the one after
constexpr int kRankInts = kTileM * kTaps;
constexpr int kZeroBytes = 2 * kDMax;  // a zero row as wide as any K
static_assert(kRankInts * 4 == kThreads * 16, "one rank piece per thread");
static_assert(kRoundTaps >= 1 && kTaps % kRoundTaps == 0, "fallback rounds");

// The tile shape of the instance for table rows of U 16-byte units. The 4
// warps split the tile's K: a warp owns kTQ taps (their B fragments in its
// registers) of 16 * kMB output rows; kTG tap groups are summed through
// shared memory at the end of a tile.
template <int U>
struct P2Shape {
  static constexpr int kD = 8 * U;
  static constexpr int kKS = (U + 1) / 2;        // 16-deep k-steps per tap
  static constexpr bool kPadK = (U % 2) != 0;    // last k-step's upper half
  static constexpr int kPitch = U | 1;           // window row pitch (units)
  static constexpr int kTQ = kKS <= 3 ? 4 : 2;   // taps per warp
  static constexpr int kTG = kTaps / kTQ;        // tap groups
  static constexpr int kRG = kWarps / kTG;       // row groups
  static constexpr int kMB = kTileM / 16 / kRG;  // m16 blocks per warp
  static constexpr int kWinBytes = kWindowRows * kPitch * 16;
  static constexpr int kPartBytes = (kTG - 1) * kTileM * kCout * 4;
  static constexpr int kRankOff = 2 * kWinBytes;
  static constexpr int kPartOff = kRankOff + kRankBufs * kRankInts * 4;
  static constexpr int kZeroOff = kPartOff + kPartBytes;
  static constexpr int kRedOff = kZeroOff + kZeroBytes;
  static constexpr int kSmem = kRedOff + 2 * kWarps * 4;
  // CTAs per SM the registers are budgeted for (the shared memory's count
  // where it holds fewer)
  static constexpr int kMinBlocks = kSmem <= 50 * 1024 ? 4
                                    : kSmem <= 110 * 1024 ? 2 : 1;
};

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pick4(int i, uint32_t a, uint32_t b,
                                          uint32_t c, uint32_t d) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

template <int U>
__global__ void __launch_bounds__(kThreads, P2Shape<U>::kMinBlocks)
gather_gemm_tc_kernel(const bf16* __restrict__ tab,
                      const int* __restrict__ idx,
                      const bf16* __restrict__ w, bf16* __restrict__ out,
                      int v, int m, long long n_tiles) {
  using namespace mopa_tc;
  using Sh = P2Shape<U>;
  constexpr int D = Sh::kD;
  constexpr int kKS = Sh::kKS;
  constexpr int kTQ = Sh::kTQ;
  constexpr int kMB = Sh::kMB;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t win_s = smem_u32(smem);
  const uint32_t rank_u = win_s + Sh::kRankOff;
  const int* rank_s = reinterpret_cast<const int*>(smem + Sh::kRankOff);
  float2* part_s = reinterpret_cast<float2*>(smem + Sh::kPartOff);
  const uint32_t zero_s = win_s + Sh::kZeroOff;
  int* red_s = reinterpret_cast<int*>(smem + Sh::kRedOff);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp % Sh::kRG;  // rows [16 kMB rg, 16 kMB (rg + 1))
  const int tg = warp / Sh::kRG;  // taps [kTQ tg, kTQ (tg + 1))
  const int g = lane >> 2;
  const int q = lane & 3;
  const int tiles_per_sample = (m + kTileM - 1) / kTileM;
  const long long stride = gridDim.x;

  // (sample, first row, rows) of tile t
  auto tile_of = [&](long long t, int& s, int& r0, int& rows) {
    s = static_cast<int>(t / tiles_per_sample);
    r0 = static_cast<int>(t - static_cast<long long>(s) * tiles_per_sample)
         * kTileM;
    rows = min(kTileM, m - r0);
  };

  // The tile's ranks into rank buffer `buf`: 16 bytes (half a row's 8) per
  // thread, zero-filled past the last row.
  auto load_ranks = [&](long long t, int buf) {
    int s, r0, rows;
    tile_of(t, s, r0, rows);
    const int r = tid >> 1;
    const bool ok = r < rows;
    const int* src =
        ok ? idx + (static_cast<size_t>(s) * m + r0 + r) * kTaps
                 + 4 * (tid & 1)
           : idx;
    cp_async16(rank_u + (buf * kRankInts + 4 * tid) * 4, src, ok);
  };

  // [lo, hi] of the tile's in-range ranks (hi < lo: none), on every thread.
  auto span = [&](long long t, int buf, int& lo, int& hi) {
    int s, r0, rows;
    tile_of(t, s, r0, rows);
    int mn = INT_MAX, mx = INT_MIN;
    if ((tid >> 1) < rows) {
      const int4 r4 =
          *reinterpret_cast<const int4*>(rank_s + buf * kRankInts + 4 * tid);
      const int r[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (r[e] >= 0 && r[e] < v) {
          mn = min(mn, r[e]);
          mx = max(mx, r[e]);
        }
    }
    mn = __reduce_min_sync(0xffffffffu, mn);
    mx = __reduce_max_sync(0xffffffffu, mx);
    if (lane == 0) {
      red_s[warp] = mn;
      red_s[kWarps + warp] = mx;
    }
    __syncthreads();
    lo = red_s[0];
    hi = red_s[kWarps];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) {
      lo = min(lo, red_s[i]);
      hi = max(hi, red_s[kWarps + i]);
    }
  };

  auto fits = [](int lo, int hi) { return hi < lo || hi - lo < kWindowRows; };

  // Table rows [lo, hi] of the tile's sample into window buffer `buf`: one
  // contiguous run of 16-byte pieces, row r at r * kPitch units.
  auto load_window = [&](long long t, int buf, int lo, int hi) {
    int s, r0, rows;
    tile_of(t, s, r0, rows);
    const bf16* base = tab + (static_cast<size_t>(s) * v + lo) * D;
    const uint32_t dst = win_s + buf * Sh::kWinBytes;
    const int n = (hi - lo + 1) * U;
    for (int e = tid; e < n; e += kThreads) {
      const int r = e / U;
      cp_async16(dst + (r * Sh::kPitch + (e - r * U)) * 16, base + 8 * e,
                 true);
    }
  };

  // This warp's B fragments, once: bw[kk][ks][0..1] = columns 0..7 and
  // bw[kk][ks][2..3] = columns 8..15 of tap kTQ tg + kk, k-step ks (rows
  // past D are zero), in mma's layout: b0 = B[2q..2q+1][g], b1 = B[2q+8..][g].
  uint32_t bw[kTQ][kKS][4];
  {
    const unsigned short* wu = reinterpret_cast<const unsigned short*>(w);
#pragma unroll
    for (int kk = 0; kk < kTQ; ++kk)
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 16 * ks + 2 * q + 8 * (e & 1);
          const int n = 8 * (e >> 1) + g;
          const size_t at =
              (static_cast<size_t>(kTQ * tg + kk) * D + k) * kCout + n;
          const uint32_t lo16 = k < D ? __ldg(wu + at) : 0u;
          const uint32_t hi16 = k + 1 < D ? __ldg(wu + at + kCout) : 0u;
          bw[kk][ks][e] = lo16 | (hi16 << 16);
        }
  }

  float acc[kMB][2][4];

  // The A fragment of k-step ks whose rows start at this lane's `row`
  // (shared memory), through ldmatrix; the K padding reads the zero row.
  // mma_step: acc[mb] += A x the B fragments of the warp's tap kk, step ks.
  auto a_frag = [&](uint32_t row, int ks, uint32_t (&a)[4]) {
    uint32_t addr = row + ks * 32 + (lane >> 4) * 16;
    if (Sh::kPadK && ks == kKS - 1 && lane >= 16) addr = zero_s;
    ldsm_x4(addr, a);
  };
  auto mma_step = [&](int kk, int ks, int mb, const uint32_t (&a)[4]) {
    mma_bf16(acc[mb][0], a, bw[kk][ks][0], bw[kk][ks][1]);
    mma_bf16(acc[mb][1], a, bw[kk][ks][2], bw[kk][ks][3]);
  };

  long long t = blockIdx.x;
  if (t >= n_tiles) return;

  // Prologue: the zero row, the first tile's ranks, then its window and the
  // second tile's ranks.
  for (int i = tid; i < kZeroBytes / 4; i += kThreads)
    reinterpret_cast<int*>(smem + Sh::kZeroOff)[i] = 0;
  load_ranks(t, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  int lo, hi;
  span(t, 0, lo, hi);
  if (fits(lo, hi)) load_window(t, 0, lo, hi);
  if (t + stride < n_tiles) load_ranks(t + stride, 1);
  cp_async_commit();

  for (int it = 0; t < n_tiles; ++it, t += stride) {
    cp_async_wait<0>();
    __syncthreads();  // this tile's window and the next tile's ranks landed
    const int wbuf = it & 1;
    const int rbuf = it % kRankBufs;
    const long long tn = t + stride;
    int lo_n = 0, hi_n = -1;
    if (tn < n_tiles) {
      span(tn, (it + 1) % kRankBufs, lo_n, hi_n);
      if (fits(lo_n, hi_n)) load_window(tn, wbuf ^ 1, lo_n, hi_n);
      if (tn + stride < n_tiles) load_ranks(tn + stride, (it + 2) % kRankBufs);
    }
    cp_async_commit();

    int s, r0, rows;
    tile_of(t, s, r0, rows);
    const uint32_t win = win_s + wbuf * Sh::kWinBytes;
    // this lane's ldmatrix row of m16 block mb
    auto row_of = [&](int mb) { return 16 * (kMB * rg + mb) + (lane & 15); };
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mb][h][e] = 0.f;

    if (fits(lo, hi)) {
      // the window rows of this lane's gathered ranks (or the zero row)
      uint32_t at[kTQ][kMB];
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        const int r = row_of(mb);
#pragma unroll
        for (int kk = 0; kk < kTQ; ++kk) {
          const int rank =
              rank_s[rbuf * kRankInts + r * kTaps + kTQ * tg + kk];
          const bool ok = r < rows && rank >= 0 && rank < v;
          at[kk][mb] = ok ? win + (rank - lo) * Sh::kPitch * 16 : zero_s;
        }
      }
      // k-steps in (tap, k-step) order, the next step's A in flight while
      // this one multiplies
      constexpr int kSteps = kTQ * kKS;
      uint32_t a[2][kMB][4];
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) a_frag(at[0][mb], 0, a[0][mb]);
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        if (st + 1 < kSteps)
#pragma unroll
          for (int mb = 0; mb < kMB; ++mb)
            a_frag(at[(st + 1) / kKS][mb], (st + 1) % kKS,
                   a[(st + 1) & 1][mb]);
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
          mma_step(st / kKS, st % kKS, mb, a[st & 1][mb]);
      }
    } else {
      for (int j0 = 0; j0 < kTaps; j0 += kRoundTaps) {
        // slot jj * kTileM + r holds row r's rank of tap j0 + jj
        for (int e = tid; e < kRoundTaps * kTileM * U; e += kThreads) {
          const int slot = e / U;
          const int c = e - slot * U;
          const int jj = slot / kTileM;
          const int r = slot - jj * kTileM;
          const int rank = rank_s[rbuf * kRankInts + r * kTaps + j0 + jj];
          const bool ok = r < rows && rank >= 0 && rank < v;
          const bf16* src =
              ok ? tab + (static_cast<size_t>(s) * v + rank) * D + 8 * c : tab;
          cp_async16(win + (slot * Sh::kPitch + c) * 16, src, ok);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kTQ; ++kk) {
          const int j = kTQ * tg + kk;
          if (j / kRoundTaps != j0 / kRoundTaps) continue;
#pragma unroll
          for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
            for (int mb = 0; mb < kMB; ++mb) {
              uint32_t af[4];
              a_frag(win + ((j % kRoundTaps) * kTileM + row_of(mb))
                               * Sh::kPitch * 16,
                     ks, af);
              mma_step(kk, ks, mb, af);
            }
        }
        __syncthreads();
      }
    }

    // Tap groups 1.. hand their sums to group 0 through shared memory, in
    // the fragment's own layout (lane-major float2s).
    if (tg > 0) {
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part_s[((((tg - 1) * Sh::kRG + rg) * kMB + mb) * 4 + e) * 32
                 + lane] = make_float2(acc[mb][e >> 1][2 * (e & 1)],
                                       acc[mb][e >> 1][2 * (e & 1) + 1]);
    }
    __syncthreads();
    if (tg == 0) {
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        for (int p = 1; p < Sh::kTG; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f =
                part_s[((((p - 1) * Sh::kRG + rg) * kMB + mb) * 4 + e) * 32
                       + lane];
            acc[mb][e >> 1][2 * (e & 1)] += f.x;
            acc[mb][e >> 1][2 * (e & 1) + 1] += f.y;
          }
        // Lane (g, q) holds rows g and g + 8, columns 2q, 2q + 1 of both
        // 8-wide blocks. Word i = block (i & 1) of row g + 8 (i >> 1); lane
        // q collects word q of its quad (16 bytes: row g + 8 (q >> 1),
        // columns 8 (q & 1)..).
        const uint32_t wv0 = pack_bf16(acc[mb][0][0], acc[mb][0][1]);
        const uint32_t wv1 = pack_bf16(acc[mb][1][0], acc[mb][1][1]);
        const uint32_t wv2 = pack_bf16(acc[mb][0][2], acc[mb][0][3]);
        const uint32_t wv3 = pack_bf16(acc[mb][1][2], acc[mb][1][3]);
        uint32_t got[4];  // got[k]: from lane q ^ k, its columns 2 (q ^ k)..
#pragma unroll
        for (int k = 0; k < 4; ++k)
          got[k] = __shfl_xor_sync(0xffffffffu,
                                   pick4(q ^ k, wv0, wv1, wv2, wv3), k);
        const int row = r0 + 16 * (kMB * rg + mb) + g + 8 * (q >> 1);
        if (row < m) {
          uint4 piece;
          piece.x = pick4(q, got[0], got[1], got[2], got[3]);
          piece.y = pick4(q ^ 1, got[0], got[1], got[2], got[3]);
          piece.z = pick4(q ^ 2, got[0], got[1], got[2], got[3]);
          piece.w = pick4(q ^ 3, got[0], got[1], got[2], got[3]);
          *reinterpret_cast<uint4*>(out + (static_cast<size_t>(s) * m + row)
                                              * kCout + 8 * (q & 1)) = piece;
        }
      }
    }
    __syncthreads();  // this tile's buffers are free for the tile after next
    lo = lo_n;
    hi = hi_n;
  }
  cp_async_wait<0>();
}

template <int U>
int launch_gather_gemm(const bf16* tab, const int* idx, const bf16* w,
                       bf16* out, int s, int v, int m, cudaStream_t st) {
  constexpr int smem = P2Shape<U>::kSmem;
  static int ready_dev = -1;  // per instance: attribute set, grid known
  static int grid_max = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != ready_dev) {
    err = cudaFuncSetAttribute(gather_gemm_tc_kernel<U>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_gemm_tc_kernel<U>, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid_max = sms * per_sm;
    ready_dev = dev;
  }
  const long long n_tiles =
      static_cast<long long>(s) * ((m + kTileM - 1) / kTileM);
  const int grid = static_cast<int>(n_tiles < grid_max ? n_tiles : grid_max);
  gather_gemm_tc_kernel<U><<<grid, kThreads, smem, st>>>(tab, idx, w, out, v,
                                                         m, n_tiles);
  return static_cast<int>(cudaGetLastError());
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
// (s, m, 16) bfloat16, all contiguous; tab, idx, w and out 16-byte aligned;
// d a multiple of 8 lanes, at most 128; cout must be 16. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int mopa_gather_gemm(const void* tab, const void* idx,
                                const void* w, void* out, int s, int v, int m,
                                int d, int cout, void* stream) {
  if (s < 1 || v < 1 || m < 0 || d < kLanes || d % kLanes != 0 ||
      d > kDMax || cout != kCout || !aligned16(tab) || !aligned16(idx) ||
      !aligned16(w) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const bf16* t = static_cast<const bf16*>(tab);
  const int* i = static_cast<const int*>(idx);
  const bf16* wt = static_cast<const bf16*>(w);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d / kLanes) {
#define MOPA_CASE(U) \
    case U:          \
      return launch_gather_gemm<U>(t, i, wt, o, s, v, m, st);
    MOPA_CASE(1) MOPA_CASE(2) MOPA_CASE(3) MOPA_CASE(4) MOPA_CASE(5)
    MOPA_CASE(6) MOPA_CASE(7) MOPA_CASE(8) MOPA_CASE(9) MOPA_CASE(10)
    MOPA_CASE(11) MOPA_CASE(12) MOPA_CASE(13) MOPA_CASE(14) MOPA_CASE(15)
    MOPA_CASE(16)
#undef MOPA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// P2's tiling: output rows per tile and table rows a window holds.
extern "C" void mopa_gather_gemm_tiling(int* tile_m, int* window_rows) {
  *tile_m = kTileM;
  *window_rows = kWindowRows;
}

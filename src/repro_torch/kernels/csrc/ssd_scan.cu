// Mamba-2 SSD intra-chunk scan for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_chunk_scan,
// body _ssd_chunk_kernel), whose function the reference model computes
// inline in repro/models/ssm.py::ssd_chunked. Per (batch*chunk, head), with
// cs = cumsum(dA) over the chunk's Q positions:
//   y[l]  = sum_{s<=l} (C[l].B[s]) exp(cs[l] - cs[s]) x[s]     (Q x P)
//   state = sum_s x[s]^T exp(cs[Q-1] - cs[s]) B[s]             (P x N, f32)
//   decay = exp(cs[Q-1]),  state_decay[l] = exp(cs[l])
// Layouts are the reference's: x (chunks, Q, H, P), dA (chunks, Q, H) f32,
// B and C (chunks, Q, N); y (chunks, Q, H, P) in f32 or bf16, state
// (chunks, H, P, N), decay (chunks, H) and state_decay (chunks, Q, H) in
// f32 (state_decay is the reference model's inter-chunk output weight, so
// the model needs no cumsum of its own). Any H; Q up to 256.
//
// The decay exponent is always the difference cs[l] - cs[s], masked before
// the exponential: at full width cs reaches about -180 in a chunk, where
// exp(cs[l]) * exp(-cs[s]) would be 0 * inf.
//
// What bounds it on this card: at mamba2-370m's shapes (Q 256, H 32, P 64,
// N 128, bf16 in) one chunk reads 1.2 MB and writes 3.1 MB (y and the state
// in f32) against ~0.42 GFLOP, so bytes set the floor: 1.3 us per chunk at
// 3.35 TB/s. A prefill of the serving path is 1 or 2 chunks, so what the
// kernel has to beat is latency: the work of one chunk must spread over
// the card, and each task's chain of loads, products and waits must be
// short. Three kernels behind one entry point:
//
// * ssd_wg (bf16, P 64, N 128: the serving path). One launch of two kinds
//   of task, (chunk, head) each, picked by block index, heaviest first. A
//   block is one consumer warpgroup and one producer warp that feeds it by
//   TMA (rank-4 maps, 128-byte swizzle, rows past Q read as zeros) through
//   a ring of B tiles and a ring of x tiles, each stage with a "full" and
//   an "empty" mbarrier, as in flash_fwd_wgmma. 67 KB of shared memory and
//   at most 136 registers a thread: three blocks run on an SM, so one
//   block's loads and waits hide under another's math.
//   - y task (chunk, head, 64-row l-tile): the l-tile's C tile stays
//     resident; for each s-tile s <= l-tile, G = C.B^T (64 x 64, K = N)
//     runs on wgmma from shared memory, M = G o exp(cs[l] - cs[s]) is
//     formed in registers and is the register A operand of M.x (wgmma, x
//     read MN-major), in bf16 hi + lo halves.
//   - state task (chunk, head): x^T B over the chunk (K = Q, all N
//     columns) on wgmma, x^T read from shared memory with ldmatrix.trans,
//     scaled by exp(cs[Q-1] - cs[s]) and split into hi + lo as the A
//     operand; B read MN-major. It also writes the decay and state_decay.
//   At one chunk of mamba2-370m that is 128 y tasks and 32 state tasks,
//   160 blocks on 132 SMs, where one block per (chunk, head) gave 32. G is
//   computed per head, not once per head pair as the Pallas kernel's head
//   block does: sharing it keeps two heads' y accumulators and M operands
//   in registers (168 a thread, two blocks an SM), and that measured slower
//   on the H100 at 1, 2 and 16 chunks than G per head at three blocks an
//   SM. No C++ branch sits between a wgmma and its wait (ptxas would
//   serialise them): every s-tile ends with nothing in flight.
// * ssd_heads (bf16 at the narrower tensor-core shapes (P, N) in {(64, 16),
//   (32, 64), (16, 16)}: the hybrid, reference-test and smoke shapes, whose
//   rows are narrower than a 128-byte swizzle atom). At hymba-1.5b's
//   widths (Q 128, H 50, P 64, N 16) a chunk moves 2.72 MB, 90% of it
//   x in and y out, per head, against ~0.1 GFLOP: bytes bound it (9.75 us
//   at 12 chunks). One block per (chunk, run of heads), the runs sized so
//   that the grid is two blocks an SM: B, C and the dA rows are read once
//   a run, a producer warp streams each head's x through a ring (cp.async
//   on mbarriers), and eight consumer warps take each head's row groups
//   and state rows on mma.sync, drifting across heads so that loads,
//   products and stores overlap (the kernel's own comment has the rest).
// * ssd_simt (f32, and bf16 at other P or N): the same algorithm on the
//   CUDA cores in f32, for the tight check.
//
// Numerics of the two tensor-core kernels: x, B and C are bf16 inputs and
// exact as operands; the two f32 A operands (M and the decayed x) go in as
// a pair of bf16 values, hi = bf16(v) and lo = bf16(v - hi), two products
// each: ~16 significant bits instead of bf16's 8, so the kernel computes
// the Pallas kernel's f32 function to ~1e-5 relative (ssd_heads takes M's
// exponentials from the SFU, off by ~1e-6 where M is large). (With M and
// the decayed x rounded to bf16 once, in the kernel and its plain version
// alike, the two paths' logits of full-width mamba2-370m differed by 8.6%
// of their maximum on an H100: 48 layers amplify the rounding.) No
// atomics: two launches on one input are bit-identical.
//
// Padding: ssd_chunked pads a prompt with zero x and dA = 0, so a padded
// chunk must give its prefix's y rows, state and decays to the bit. Every
// task that needs cs computes it in a lane order that makes the padded
// tail's cs equal to the last real row's (ssd_wg and ssd_simt with
// chunk_cumsum, whose grouping follows pad64(Q); ssd_heads with
// scan_fixed, whose grouping is the same at every Q, so that hymba's Q 128
// chunk padded past a 20-row prefix matches that prefix at Q 20); every
// sum over s walks the same rows in the same tiles (ssd_wg: 64-row tiles
// of pad64(Q) rows; ssd_heads: 16-row k-steps, a row group's up to its
// diagonal, the state's over pad16(Q)), and rows past Q are zeros, whose
// products add exact zeros.
#include <algorithm>
#include <climits>

#include "nk_hopper.cuh"

namespace {

using nk::BOX_BYTES;
using nk::cp_async16;
using nk::cp_async_commit;
using nk::cp_async_wait;
using nk::fence_regs;
using nk::ldsm_x4;
using nk::ldsm_x4_t;
using nk::make_map;
using nk::MAX_DEVICES;
using nk::mbar_arrive;
using nk::mbar_expect_tx;
using nk::mbar_init;
using nk::mbar_wait;
using nk::mma_bf16;
using nk::prefetch_map;
using nk::smem_u32;
using nk::sw128_desc;
using nk::tma_load_4d;
using nk::wg_commit;
using nk::wg_fence;
using nk::wg_wait;
using nk::wgmma_rs_n128;
using nk::wgmma_rs_n64;
using nk::wgmma_ss_n64;

constexpr int NW = 8;          // warps per block
constexpr int NTHR = 32 * NW;  // threads per block
constexpr int MAXQ = 256;

__host__ __device__ constexpr int pad64(int q) { return (q + 63) / 64 * 64; }

// element offset of 16-byte chunk `chunk` of row `row` in a swizzled
// (rows x D) bf16 tile: chunk index XOR (row % min(8, D / 8))
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int MASK = (D / 8 < 8 ? D / 8 : 8) - 1;
  return row * D + ((chunk ^ (row & MASK)) << 3);
}

// cs[s] = dA[0] + ... + dA[s] of head h, for s < pad64(Q) (dA = 0 past Q),
// by one warp: each lane sums its run of positions, then the runs before
// it are added in lane order. That order makes a zero-padded tail give
// cs[pad] == cs[last real row] exactly (a tree scan would round the two
// sums differently), so padding leaves the state and decay bit-identical.
// A lane's loads are all issued before its first add: loaded one by one
// behind the branch on E they cost a trip to memory each, which was half
// of a task's time on the H100.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dA,
                                             int H, int h, int Q,
                                             float* cs, int lane) {
  const int E = pad64(Q) / 32;   // 2..8 positions per lane
  float a[8], v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = lane * E + i;
    a[i] = i < E && s < Q ? dA[(size_t)s * H + h] : 0.f;
  }
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i < E) {
      run += a[i];
      v[i] = run;
    }
  }
  float excl = 0.f, acc = 0.f;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const float r = __shfl_sync(0xffffffffu, run, k);
    if (lane == k) excl = acc;
    acc += r;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < E) cs[lane * E + i] = v[i] + excl;
}

__device__ __forceinline__ void store_pair(void* y, size_t off, float a,
                                           float b, bool out_bf16) {
  if (out_bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) +
                                       off) = __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(y) + off) =
        make_float2(a, b);
}

// (a, b) as bf16 pairs hi + lo: hi = bf16(v), lo = bf16(v - hi); the
// difference is exact in f32, so hi + lo keeps ~16 significant bits of v
__device__ __forceinline__ void split_pack(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---------------------------------------------------------------------------
// wgmma + TMA kernel (bf16, P 64, N 128)
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 128 + 32;   // a consumer warpgroup + a producer
constexpr int WG_P = 64;               // x row: one 128-byte swizzle atom
constexpr int WG_N = 128;              // B and C rows: two atoms
constexpr int WG_NB = WG_N / 64;
constexpr int BST = 2;                 // stages of the B ring
constexpr int XST = 2;                 // stages of the x ring
constexpr int BT = WG_NB * BOX_BYTES;  // a 64-row C or B tile
constexpr int XT = BOX_BYTES;          // a 64-row x tile
// C, the B ring, the x ring, cs and the state's weights; + slack to align
// to 1024 bytes: 67 KB, three blocks an SM
constexpr int WG_SMEM = 1024 + BT + BST * BT + XST * XT +
                        2 * MAXQ * (int)sizeof(float);

// M = G o exp(cs[l] - cs[s]) as wgmma A operands, hi and lo bf16 halves:
// k-step kk takes s-tile columns 16 kk .. 16 kk + 15, which is the
// accumulator's own layout (this thread: rows r0 and r0 + 8, columns
// 8 j + 2 t4 and + 1). The exponent is masked above the diagonal.
__device__ __forceinline__ void form_m(uint32_t (&hi)[4][4],
                                       uint32_t (&lo)[4][4],
                                       const float (&gacc)[32],
                                       const float* cs, const float (&crow)[2],
                                       int s0, int r0, int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 8 * kk + 2 * i;
      const int r = r0 + 8 * (i & 1);
      const int c = s0 + 8 * (2 * kk + i / 2) + 2 * t4;
      const float d0 = c <= r ? crow[i & 1] - cs[c] : nk::NEG_INF;
      const float d1 = c + 1 <= r ? crow[i & 1] - cs[c + 1] : nk::NEG_INF;
      split_pack(gacc[e] * expf(d0), gacc[e + 1] * expf(d1), hi[kk][i],
                 lo[kk][i]);
    }
}

__global__ void __launch_bounds__(WG_THREADS, 3)
ssd_wg(const __grid_constant__ CUtensorMap tm_x,
       const __grid_constant__ CUtensorMap tm_b,
       const __grid_constant__ CUtensorMap tm_c,
       const float* __restrict__ dA, void* __restrict__ y,
       float* __restrict__ st, float* __restrict__ dec,
       float* __restrict__ sd, int nchunks, int Q, int H, int out_bf16) {
  constexpr int P = WG_P, N = WG_N, NB = WG_NB;
  extern __shared__ unsigned char smem_raw[];
  // C; then full and empty barriers of the B ring and of the x ring
  __shared__ __align__(8) uint64_t bars[1 + 2 * BST + 2 * XST];
  const uint32_t c_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_smem = c_smem + BT;            // + BT * stage
  const uint32_t x_smem = b_smem + BST * BT;      // + XT * stage
  float* cs = reinterpret_cast<float*>(
      smem_raw + (x_smem + XST * XT - smem_u32(smem_raw)));
  float* ws = cs + MAXQ;
  const uint32_t bar_c = smem_u32(&bars[0]);
  const uint32_t b_full = smem_u32(&bars[1]);     // + 8 * stage
  const uint32_t b_empty = b_full + 8 * BST;
  const uint32_t x_full = b_empty + 8 * BST;
  const uint32_t x_empty = x_full + 8 * XST;

  // the task, (chunk, head) of a kind: y of the last l-tile, then the
  // state, then y of the earlier l-tiles, last first (heaviest first)
  const int nT = pad64(Q) / 64;
  const int per = nchunks * H;
  int task = blockIdx.x, lt = nT - 1;
  bool state = false;
  if (task >= 2 * per) {
    task -= 2 * per;
    lt = nT - 2 - task / per;
    task %= per;
  } else if (task >= per) {
    task -= per;
    state = true;
  }
  const int ch = task / H, h = task % H;
  const int ns = state ? nT : lt + 1;     // s-tiles this task walks

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  if (tid == 128) {
    prefetch_map(&tm_x);
    prefetch_map(&tm_b);
    prefetch_map(&tm_c);
  }
  if (tid == 0) {
    mbar_init(bar_c, 1);
    for (int s = 0; s < BST; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, 128);   // every consumer thread arrives
    }
    for (int s = 0; s < XST; ++s) {
      mbar_init(x_full + 8 * s, 1);
      mbar_init(x_empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: lane 0 loads C (a y task), then per s-tile the B tile
    // and the head's x tile, each ring as far ahead as its free stages
    // allow ----
    if (lane == 0) {
      if (!state) {
        mbar_expect_tx(bar_c, BT);
        for (int c = 0; c < NB; ++c)
          tma_load_4d(c_smem + c * BOX_BYTES, &tm_c, bar_c, c * 64, 0,
                      lt * 64, ch);
      }
      for (int s = 0; s < ns; ++s) {
        const int bs = s % BST, xs = s % XST;
        if (s >= BST) mbar_wait(b_empty + 8 * bs, (s / BST - 1) & 1);
        mbar_expect_tx(b_full + 8 * bs, BT);
        for (int c = 0; c < NB; ++c)
          tma_load_4d(b_smem + bs * BT + c * BOX_BYTES, &tm_b,
                      b_full + 8 * bs, c * 64, 0, s * 64, ch);
        if (s >= XST) mbar_wait(x_empty + 8 * xs, (s / XST - 1) & 1);
        mbar_expect_tx(x_full + 8 * xs, XT);
        tma_load_4d(x_smem + xs * XT, &tm_x, x_full + 8 * xs, 0, h, s * 64,
                    ch);
      }
    }
    return;
  }

  // ---- the consumer warpgroup ----
  const int g = lane / 4, t4 = lane % 4;   // accumulator fragment coordinates
  if (warp == 0) chunk_cumsum(dA + (size_t)ch * Q * H, H, h, Q, cs, lane);
  nk::bar_sync_first<128>();

  if (state) {
    const float cl = cs[Q - 1];
    for (int s = tid; s < nT * 64; s += 128)
      ws[s] = s < Q ? expf(cl - cs[s]) : 0.f;
    for (int l = tid; l < Q; l += 128)
      sd[((size_t)ch * Q + l) * H + h] = expf(cs[l]);
    if (tid == 0) dec[(size_t)ch * H + h] = expf(cl);
    nk::bar_sync_first<128>();

    // state = sum over s of (x^T scaled by ws)(hi + lo) B, K = Q
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    uint32_t ah[4][4], al[4][4];
    for (int s = 0; s < ns; ++s) {
      const int bs = s % BST, xs = s % XST;
      mbar_wait(x_full + 8 * xs, (s / XST) & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // x^T rows p = 16 warp .. + 15, columns s = 16 kk .. + 15 of the
        // tile: the swizzled x tile read transposed
        const int row = kk * 16 + (lane % 8) + (lane / 16) * 8;
        const int chunk = warp * 2 + (lane / 8) % 2;
        uint32_t r[4];
        nk::ldsm_x4_t(x_smem + xs * XT + row * 128 +
                          ((chunk ^ (row & 7)) << 4),
                      r[0], r[1], r[2], r[3]);
        const int sc = s * 64 + kk * 16 + 2 * t4;
        const float w[4] = {ws[sc], ws[sc + 1], ws[sc + 8], ws[sc + 9]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&r[i]));
          split_pack(f.x * w[(i / 2) * 2], f.y * w[(i / 2) * 2 + 1],
                     ah[kk][i], al[kk][i]);
        }
      }
      mbar_wait(b_full + 8 * bs, (s / BST) & 1);
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // B MN-major: 16 rows a k-step, its two atoms BOX_BYTES apart
        const uint64_t db = sw128_desc(b_smem + bs * BT + kk * 2048,
                                       BOX_BYTES);
        wgmma_rs_n128(acc, ah[kk], db, 1);
        wgmma_rs_n128(acc, al[kk], db, 1);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive(x_empty + 8 * xs);
      mbar_arrive(b_empty + 8 * bs);
    }
    float* sb = st + ((size_t)ch * H + h) * P * N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = warp * 16 + g + 8 * i;
#pragma unroll
      for (int jn = 0; jn < N / 8; ++jn)
        *reinterpret_cast<float2*>(sb + (size_t)p * N + jn * 8 + 2 * t4) =
            make_float2(acc[4 * jn + 2 * i], acc[4 * jn + 2 * i + 1]);
    }
    return;
  }

  // ---- y task ----
  const int r0 = lt * 64 + warp * 16 + g;   // this thread's rows r0, r0 + 8
  const float crow[2] = {cs[r0], cs[r0 + 8]};
  float yacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
  float gacc[32];
  uint32_t mh[4][4], ml[4][4];
  mbar_wait(bar_c, 0);
  for (int s = 0; s < ns; ++s) {
    // G = C B^T of this s-tile: k-steps of 16 through each 64-wide atom,
    // both operands K-major
    const int bs = s % BST, xs = s % XST;
    mbar_wait(b_full + 8 * bs, (s / BST) & 1);
    fence_regs(gacc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(gacc, sw128_desc(c_smem + c * BOX_BYTES + kk * 32, 16),
                     sw128_desc(b_smem + bs * BT + c * BOX_BYTES + kk * 32,
                                16),
                     (c | kk) != 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(gacc);
    mbar_arrive(b_empty + 8 * bs);
    // M in registers, then y += M x with x MN-major
    form_m(mh, ml, gacc, cs, crow, s * 64, r0, t4);
    mbar_wait(x_full + 8 * xs, (s / XST) & 1);
    fence_regs(yacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = sw128_desc(x_smem + xs * XT + kk * 2048,
                                     BOX_BYTES);
      wgmma_rs_n64(yacc, mh[kk], dx, 1);
      wgmma_rs_n64(yacc, ml[kk], dx, 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(yacc);
    mbar_arrive(x_empty + 8 * xs);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= Q) continue;
    const size_t row = (((size_t)ch * Q + r) * H + h) * P + 2 * t4;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
      store_pair(y, row + jn * 8, yacc[4 * jn + 2 * i],
                 yacc[4 * jn + 2 * i + 1], out_bf16);
  }
}

// ---------------------------------------------------------------------------
// mma.sync kernel over a run of heads (bf16, the narrower tensor-core shapes)
// ---------------------------------------------------------------------------

constexpr int HB_MAX = 8;                // heads a block at most: a warp each
constexpr int HD_THREADS = NTHR + 32;    // 8 consumer warps + a producer warp
constexpr int HD_STAGES = 3;             // the x ring's stages at most
constexpr int SCAN_E = MAXQ / 32;        // cumsum positions a lane, fixed

__host__ __device__ constexpr int pad16(int q) { return (q + 15) / 16 * 16; }

// the x ring's stages at a chunk length: three up to Q 128, two above
inline int hd_stages(int Q) { return pad16(Q) <= 128 ? 3 : 2; }

// the ring of x stages, B and C, then each head's cs and its state weights
template <int P, int N>
constexpr size_t hd_smem_bytes(int Q, int stages, int hb) {
  return (size_t)pad16(Q) * (stages * P + 2 * N) * sizeof(__nv_bfloat16) +
         2 * (size_t)hb * pad16(Q) * sizeof(float);
}

// cs[s] = a[0] + ... + a[s] over the pad16(Q) rows of a (zeros past Q), by
// one warp. Lane k sums rows 8k .. 8k + 7, then the runs before it are
// added in lane order: the grouping does not depend on Q, so a chunk
// zero-padded from Q to Q' gives cs[Q' - 1] == cs[Q - 1] and every row's
// cs to the bit (chunk_cumsum's grouping follows pad64(Q) instead).
__device__ __forceinline__ void scan_fixed(const float* a, float* cs, int Q,
                                           int lane) {
  float v[SCAN_E];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < SCAN_E; ++i) {
    const int s = lane * SCAN_E + i;
    run += s < Q ? a[s] : 0.f;
    v[i] = run;
  }
  float excl = 0.f, acc = 0.f;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const float r = __shfl_sync(0xffffffffu, run, k);
    if (lane == k) excl = acc;
    acc += r;
  }
  const int qp = pad16(Q);
#pragma unroll
  for (int i = 0; i < SCAN_E; ++i) {
    const int s = lane * SCAN_E + i;
    if (s < qp) cs[s] = v[i] + excl;
  }
}

// rows ra and ra + 8 of a (16 x P) f32 tile in mma accumulator layout, as
// 16-byte stores: each pair of lanes swaps halves of two 8-column tiles,
// so a lane holds 4 contiguous columns of one of them
template <int P>
__device__ __forceinline__ void store_rows(void* y, size_t row_a,
                                           size_t row_b, bool ok_a, bool ok_b,
                                           const float (&acc)[P / 8][4],
                                           int t4, bool out_bf16) {
  const bool odd = t4 & 1;
#pragma unroll
  for (int m = 0; m < P / 16; ++m) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // selects, not an index by `odd`: that would put acc in local memory
      const float a0 = acc[2 * m][2 * i], a1 = acc[2 * m][2 * i + 1];
      const float b0 = acc[2 * m + 1][2 * i], b1 = acc[2 * m + 1][2 * i + 1];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
      const float4 v = odd ? make_float4(r0, r1, b0, b1)
                           : make_float4(a0, a1, r0, r1);
      if (!(i ? ok_b : ok_a)) continue;
      // column of v[0]: tile 2m + odd, lane pair (t4 & ~1)
      const size_t off = (i ? row_b : row_a) + 16 * m + 8 * odd +
                         2 * (t4 & ~1);
      if (out_bf16) {
        uint2 b;
        b.x = nk::pack_bf16(v.x, v.y);
        b.y = nk::pack_bf16(v.z, v.w);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(y) + off) = b;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(y) + off) = v;
      }
    }
  }
}

// exp(x) for the decay matrix on the SFU: ex2.approx of x log2(e). Off by
// ~2^-22 relative plus the rounding of x log2(e): ~1e-6 near the diagonal,
// where M's values are large, and up to ~1e-5 where exp(x) is ~1e-40
// (x ~ -90); flushes results below 2^-126 to 0, which expf would return
// as denormals. The decays and the state's weights keep expf.
__device__ __forceinline__ float exp_sfu(float x) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(x * 1.44269504f));
  return e;
}

// G = C.B^T of the 16 rows whose C fragments are cf against B rows c0 ..
// c0 + 15: two 8-column accumulator tiles
template <int N>
__device__ __forceinline__ void g_tile(uint32_t b_tile, int c0,
                                       const uint32_t (&cf)[N / 16][4],
                                       float (&g)[2][4], int lane) {
#pragma unroll
  for (int jn = 0; jn < 2; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) g[jn][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4(b_tile + 2 * swz<N>(c0 + (lane % 8) + (lane / 16) * 8,
                                ks * 2 + (lane / 8) % 2),
            b0, b1, b2, b3);
    mma_bf16(g[0], cf[ks], b0, b1);
    mma_bf16(g[1], cf[ks], b2, b3);
  }
}

// M = G o exp(cs[l] - cs[s]) at columns c0 .. c0 + 15, masked above the
// diagonal before the exponential, as the A operand of M.x in bf16 hi + lo
// halves (this lane: rows ra and rb, columns c0 + 8 jn + 2 t4 and + 1)
__device__ __forceinline__ void m_tile(const float (&g)[2][4], const float* cs,
                                       int c0, int ra, int rb, float csa,
                                       float csb, int t4, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
#pragma unroll
  for (int jn = 0; jn < 2; ++jn) {
    const int c = c0 + jn * 8 + 2 * t4;
    const float e0 = cs[c], e1 = cs[c + 1];
    const float m0 = c <= ra ? g[jn][0] * exp_sfu(csa - e0) : 0.f;
    const float m1 = c + 1 <= ra ? g[jn][1] * exp_sfu(csa - e1) : 0.f;
    const float m2 = c <= rb ? g[jn][2] * exp_sfu(csb - e0) : 0.f;
    const float m3 = c + 1 <= rb ? g[jn][3] * exp_sfu(csb - e1) : 0.f;
    split_pack(m0, m1, ah[2 * jn], al[2 * jn]);
    split_pack(m2, m3, ah[2 * jn + 1], al[2 * jn + 1]);
  }
}

// y += M.x over x rows c0 .. c0 + 15 (x read transposed from its stage)
template <int P>
__device__ __forceinline__ void m_times_x(uint32_t x_tile, int c0,
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          float (&acc)[P / 8][4], int lane) {
#pragma unroll
  for (int dp = 0; dp < P / 16; ++dp) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4_t(x_tile + 2 * swz<P>(c0 + (lane % 8) + ((lane / 8) % 2) * 8,
                                  dp * 2 + lane / 16),
              b0, b1, b2, b3);
    mma_bf16(acc[2 * dp], ah, b0, b1);
    mma_bf16(acc[2 * dp], al, b0, b1);
    mma_bf16(acc[2 * dp + 1], ah, b2, b3);
    mma_bf16(acc[2 * dp + 1], al, b2, b3);
  }
}

// y rows 16 rg .. 16 rg + 15 of one head: for each 16-column k-step kt on
// or below the diagonal, G = C.B^T (16 x 16, K = N), M = G o exp(cs[l] -
// cs[s]) masked above the diagonal, y += M.x with M as bf16 hi + lo. The
// k-steps are software-pipelined: k-step kt + 1's G and M are formed while
// k-step kt's products run, so the exponentials and the splits overlap the
// tensor cores' latency instead of waiting on it
template <int P, int N>
__device__ __forceinline__ void y_rows(uint32_t c_tile, uint32_t b_tile,
                                       uint32_t x_tile, const float* cs,
                                       int rg, void* y, size_t y_row, int Q,
                                       int HP, int lane, bool out_bf16) {
  const int t4 = lane % 4;
  const int r0 = rg * 16;
  uint32_t cf[N / 16][4];
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks)
    ldsm_x4(c_tile + 2 * swz<N>(r0 + (lane % 16), ks * 2 + lane / 16),
            cf[ks][0], cf[ks][1], cf[ks][2], cf[ks][3]);
  float acc[P / 8][4];
#pragma unroll
  for (int jn = 0; jn < P / 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
  const int ra = r0 + lane / 4, rb = ra + 8;     // this lane's two rows
  const float csa = cs[ra], csb = cs[rb];
  float g[2][4];
  uint32_t ah[4], al[4];
  g_tile<N>(b_tile, 0, cf, g, lane);
  m_tile(g, cs, 0, ra, rb, csa, csb, t4, ah, al);
  for (int kt = 0; kt < rg; ++kt) {
    g_tile<N>(b_tile, (kt + 1) * 16, cf, g, lane);
    m_times_x<P>(x_tile, kt * 16, ah, al, acc, lane);
    m_tile(g, cs, (kt + 1) * 16, ra, rb, csa, csb, t4, ah, al);
  }
  m_times_x<P>(x_tile, rg * 16, ah, al, acc, lane);
  store_rows<P>(y, y_row + (size_t)ra * HP, y_row + (size_t)rb * HP, ra < Q,
                rb < Q, acc, t4, out_bf16);
}

// state rows p = 16 mt .. 16 mt + 15 of one head, all N columns: the sum
// over the chunk's k-steps of (x^T scaled by ws) (hi + lo) B
template <int P, int N>
__device__ __forceinline__ void state_rows(uint32_t b_tile, uint32_t x_tile,
                                           const float* ws, int mt, int nks,
                                           float* sb, int lane) {
  const int g = lane / 4, t4 = lane % 4;
  float acc[N / 8][4];
#pragma unroll
  for (int jn = 0; jn < N / 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
  for (int ks = 0; ks < nks; ++ks) {
    // x^T rows p, columns s = 16 ks ..: the x stage read transposed
    uint32_t r[4], ah[4], al[4];
    ldsm_x4_t(x_tile + 2 * swz<P>(ks * 16 + (lane % 8) + (lane / 16) * 8,
                                  mt * 2 + (lane / 8) % 2),
              r[0], r[1], r[2], r[3]);
    const int sc = ks * 16 + 2 * t4;
    const float w[4] = {ws[sc], ws[sc + 1], ws[sc + 8], ws[sc + 9]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&r[i]));
      split_pack(f.x * w[(i / 2) * 2], f.y * w[(i / 2) * 2 + 1], ah[i],
                 al[i]);
    }
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(b_tile + 2 * swz<N>(ks * 16 + (lane % 8) +
                                        ((lane / 8) % 2) * 8,
                                    np * 2 + lane / 16),
                b0, b1, b2, b3);
      mma_bf16(acc[2 * np], ah, b0, b1);
      mma_bf16(acc[2 * np], al, b0, b1);
      mma_bf16(acc[2 * np + 1], ah, b2, b3);
      mma_bf16(acc[2 * np + 1], al, b2, b3);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = mt * 16 + g + 8 * i;
#pragma unroll
    for (int jn = 0; jn < N / 8; ++jn)
      *reinterpret_cast<float2*>(sb + (size_t)p * N + jn * 8 + 2 * t4) =
          make_float2(acc[jn][2 * i], acc[jn][2 * i + 1]);
  }
}

// One block per (chunk, run of heads): the chunk's B, C and dA rows are
// read once for the run, every head's cumsum is formed at once (a warp a
// head), state_decay and the decays leave in runs of the block's heads,
// and a producer warp streams each head's x through a ring of stages
// (cp.async, completion on the stage's "full" mbarrier) while the eight
// consumer warps work on the heads before it. A head is R = pad16(Q) / 16
// y units (row groups, heaviest first; row group rg walks rg + 1 k-steps)
// and P / 16 state units; consumer warp w takes the units u with u % 8 ==
// w of an even head and u % 8 == 7 - w of an odd one, so over two heads
// every warp gets the same work at Q 128, P 64. Warps drift apart across
// heads, so one head's y rows and state overlap the next head's, and y
// leaves in 16-byte stores behind the products.
template <int P, int N>
__global__ void __launch_bounds__(HD_THREADS, 2)
ssd_heads(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dA,
          const __nv_bfloat16* __restrict__ Bm,
          const __nv_bfloat16* __restrict__ Cm, void* __restrict__ y,
          float* __restrict__ st, float* __restrict__ dec,
          float* __restrict__ sd, int Q, int H, int ngroups, int stages,
          int out_bf16) {
  constexpr int NCH_N = N / 8;      // 16-byte chunks per row of B, C
  constexpr int NCH_P = P / 8;      // ... and of x
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * HD_STAGES];
  const int Qp = pad16(Q);
  const int R = Qp / 16;
  const uint32_t x_smem = smem_u32(smem_raw);             // + XS * stage
  const uint32_t XS = Qp * P * sizeof(__nv_bfloat16);
  const uint32_t b_smem = x_smem + stages * XS;
  const uint32_t c_smem = b_smem + Qp * N * sizeof(__nv_bfloat16);
  const size_t ch = blockIdx.x / ngroups;
  const int grp = blockIdx.x % ngroups;
  const int h0 = grp * H / ngroups, hb = (grp + 1) * H / ngroups - h0;
  float* cs = reinterpret_cast<float*>(
      smem_raw + (c_smem + Qp * N * sizeof(__nv_bfloat16) - x_smem));
  float* ws = cs + hb * Qp;     // dA rows first, then the state weights
  const uint32_t full = smem_u32(&bars[0]);      // + 8 * stage
  const uint32_t empty = full + 8 * HD_STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 32);      // every producer lane's copies
      mbar_init(empty + 8 * s, NW);     // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NW) {
    // ---- producer: head i's x into stage i % stages, rows past Q zeros,
    // once the consumers have left the head that held the stage ----
    for (int i = 0; i < hb; ++i) {
      const int sg = i % stages;
      if (i >= stages) mbar_wait(empty + 8 * sg, (i / stages - 1) & 1);
      // one head's loads in flight a block: the first heads of every
      // block land first, and the consumers start on them while the rest
      // stream in
      if (i >= 1)
        mbar_wait(full + 8 * ((i - 1) % stages), ((i - 1) / stages) & 1);
      const __nv_bfloat16* xb = x + (ch * Q * H + h0 + i) * P;
      for (int c = lane; c < Qp * NCH_P; c += 32) {
        const int r = c / NCH_P, k = c % NCH_P;
        const bool ok = r < Q;
        cp_async16(x_smem + sg * XS + 2 * swz<P>(r, k),
                   xb + (size_t)(ok ? r : 0) * H * P + k * 8, ok);
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                   ::"r"(full + 8 * sg) : "memory");
    }
    return;
  }

  // ---- consumers: B, C and the heads' dA rows, then every head's cumsum
  // and state weights, a warp a head ----
  const __nv_bfloat16* bb = Bm + ch * Q * N;
  const __nv_bfloat16* cb = Cm + ch * Q * N;
  for (int i = tid; i < Qp * NCH_N; i += NTHR) {
    const int r = i / NCH_N, c = i % NCH_N;
    const bool ok = r < Q;
    const size_t off = (size_t)(ok ? r : 0) * N + c * 8;
    cp_async16(c_smem + 2 * swz<N>(r, c), cb + off, ok);
    cp_async16(b_smem + 2 * swz<N>(r, c), bb + off, ok);
  }
  cp_async_commit();
  for (int i = tid; i < Q * hb; i += NTHR) {
    const int s = i / hb, j = i % hb;
    ws[j * Qp + s] = dA[(ch * Q + s) * H + h0 + j];
  }
  cp_async_wait<0>();
  nk::bar_sync_first<NTHR>();
  if (warp < hb) {
    float* csh = cs + warp * Qp;
    float* wsh = ws + warp * Qp;
    scan_fixed(wsh, csh, Q, lane);
    __syncwarp();
    const float cl = csh[Q - 1];
    for (int s = lane; s < Qp; s += 32)
      wsh[s] = s < Q ? expf(cl - csh[s]) : 0.f;
  }
  nk::bar_sync_first<NTHR>();
  for (int i = tid; i < Q * hb; i += NTHR) {
    const int l = i / hb, j = i % hb;
    sd[(ch * Q + l) * H + h0 + j] = expf(cs[j * Qp + l]);
  }
  if (tid < hb) dec[ch * H + h0 + tid] = expf(cs[tid * Qp + Q - 1]);

  // ---- the heads, through the ring ----
  const int units = R + P / 16;
  for (int i = 0; i < hb; ++i) {
    const int sg = i % stages, h = h0 + i;
    mbar_wait(full + 8 * sg, (i / stages) & 1);
    for (int u = (i & 1) ? NW - 1 - warp : warp; u < units; u += NW) {
      if (u < R)
        y_rows<P, N>(c_smem, b_smem, x_smem + sg * XS, cs + i * Qp,
                     R - 1 - u, y, (ch * Q * H + h) * P, Q, H * P, lane,
                     out_bf16);
      else
        state_rows<P, N>(b_smem, x_smem + sg * XS, ws + i * Qp, u - R, R,
                         st + (ch * H + h) * P * N, lane);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * sg);
  }
}

// ---------------------------------------------------------------------------
// CUDA-core kernel (f32, and bf16 at shapes the tensor-core kernel lacks)
// ---------------------------------------------------------------------------

constexpr int RT = 16;   // output rows per pass

inline size_t simt_smem_bytes(int Q, int P, int N) {
  return sizeof(float) * ((size_t)Q * (N + 1)   // B, padded rows
                          + (size_t)Q * P       // x
                          + (size_t)RT * N      // C, RT rows
                          + (size_t)RT * Q      // M, RT rows
                          + (size_t)pad64(Q));  // cs
}

template <typename T>
__global__ void __launch_bounds__(NTHR)
ssd_simt(const T* __restrict__ x, const float* __restrict__ dA,
         const T* __restrict__ Bm, const T* __restrict__ Cm,
         void* __restrict__ y, float* __restrict__ st,
         float* __restrict__ dec, float* __restrict__ sd, int Q, int H,
         int P, int N, int out_bf16) {
  extern __shared__ float smf[];
  const int NB = N + 1;   // conflict-free reads of B by column
  float* Bs = smf;
  float* Xs = Bs + (size_t)Q * NB;
  float* Cs = Xs + (size_t)Q * P;
  float* Ms = Cs + RT * N;
  float* cs = Ms + (size_t)RT * Q;

  const size_t ch = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const T* bb = Bm + ch * Q * N;
  const T* cb = Cm + ch * Q * N;
  const T* xb = x + (ch * Q * H + h) * P;
  for (int i = tid; i < Q * N; i += NTHR)
    Bs[(i / N) * NB + i % N] = nk::to_f<T>(bb[i]);
  for (int i = tid; i < Q * P; i += NTHR)
    Xs[i] = nk::to_f<T>(xb[(size_t)(i / P) * H * P + i % P]);
  if (tid < 32) chunk_cumsum(dA + ch * Q * H, H, h, Q, cs, tid);
  __syncthreads();
  for (int l = tid; l < Q; l += NTHR)
    sd[(ch * Q + l) * H + h] = expf(cs[l]);

  for (int r0 = 0; r0 < Q; r0 += RT) {
    for (int i = tid; i < RT * N; i += NTHR) {
      const int r = r0 + i / N;
      Cs[i] = r < Q ? nk::to_f<T>(cb[(size_t)r * N + i % N]) : 0.f;
    }
    __syncthreads();
    const int ncol = min(r0 + RT, Q);
    for (int i = tid; i < RT * ncol; i += NTHR) {
      const int ir = i / ncol, c = i % ncol, r = r0 + ir;
      float m = 0.f;
      if (r < Q && c <= r) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n)
          dot = fmaf(Cs[ir * N + n], Bs[c * NB + n], dot);
        m = dot * expf(cs[r] - cs[c]);
      }
      Ms[ir * Q + c] = m;
    }
    __syncthreads();
    {
      const int ir = tid / 16, pg = tid % 16, r = r0 + ir;
      if (r < Q) {
        const size_t row = ((ch * Q + r) * H + h) * P;
        for (int p = pg; p < P; p += 16) {
          float acc = 0.f;
          for (int c = 0; c <= r; ++c)
            acc = fmaf(Ms[ir * Q + c], Xs[c * P + p], acc);
          if (out_bf16)
            static_cast<__nv_bfloat16*>(y)[row + p] = __float2bfloat16(acc);
          else
            static_cast<float*>(y)[row + p] = acc;
        }
      }
    }
    __syncthreads();   // C and M are overwritten by the next pass
  }

  const float cl = cs[Q - 1];
  float* ws = Ms;
  for (int s = tid; s < Q; s += NTHR) ws[s] = expf(cl - cs[s]);
  __syncthreads();
  for (int i = tid; i < Q * P; i += NTHR)
    Xs[i] *= ws[i / P];
  __syncthreads();
  float* sb = st + (ch * H + h) * P * N;
  for (int o = tid; o < P * N; o += NTHR) {
    const int p = o / N, n = o % N;
    float acc = 0.f;
    for (int s = 0; s < Q; ++s) acc = fmaf(Xs[s * P + p], Bs[s * NB + n], acc);
    sb[o] = acc;
  }
  if (tid == 0) dec[ch * H + h] = expf(cl);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// raise `kernel`'s dynamic shared-memory limit to `bytes` on `device`: once
// per instantiation, card and larger size, not on every launch
template <typename K>
int raise_smem(K* kernel, size_t bytes, int device,
               size_t (&raised)[MAX_DEVICES]) {
  if (device < 0 || device >= MAX_DEVICES) return NK_ERR_ARGS;
  if (bytes <= raised[device]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  raised[device] = bytes;
  return 0;
}

int launch_wg(const void* x, const float* dA, const void* B, const void* C,
              void* y, float* st, float* dec, float* sd, int nchunks, int Q,
              int H, int out_bf16, int device, cudaStream_t stream) {
  static size_t raised[MAX_DEVICES] = {};
  int rc = raise_smem(ssd_wg, WG_SMEM, device, raised);
  if (rc) return rc;
  // x as (chunks, Q, H, P); B and C as (chunks, Q, 1, N)
  CUtensorMap tx, tb, tc;
  rc = make_map(&tx, x, nchunks, Q, H, WG_P);
  if (!rc) rc = make_map(&tb, B, nchunks, Q, 1, WG_N);
  if (!rc) rc = make_map(&tc, C, nchunks, Q, 1, WG_N);
  if (rc) return rc;
  // a y task per l-tile and a state task, per (chunk, head)
  const long long blocks = (long long)nchunks * H * (pad64(Q) / 64 + 1);
  if (blocks > INT_MAX) return NK_ERR_ARGS;
  ssd_wg<<<(int)blocks, WG_THREADS, WG_SMEM, stream>>>(
      tx, tb, tc, dA, y, st, dec, sd, nchunks, Q, H, out_bf16);
  return (int)cudaGetLastError();
}

// the card's SM count, read once per device
inline int sm_count(int device) {
  static int sms[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return 0;
  if (!sms[device] &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return 0;
  return sms[device];
}

// head runs a chunk: as many blocks as two a card's SM hold at once (two
// blocks fit an SM), each run at most HB_MAX heads, at least one
inline int head_groups(int nchunks, int H, int sms) {
  const int want = (2 * sms + nchunks / 2) / nchunks;
  return std::min(H, std::max((H + HB_MAX - 1) / HB_MAX, want));
}

template <int P, int N>
int launch_heads(const void* x, const float* dA, const void* B,
                 const void* C, void* y, float* st, float* dec, float* sd,
                 int nchunks, int Q, int H, int out_bf16, int device,
                 cudaStream_t stream) {
  const int sms = sm_count(device);
  if (!sms) return NK_ERR_ARGS;
  const int ng = head_groups(nchunks, H, sms);
  const int stages = hd_stages(Q);
  const size_t smem = hd_smem_bytes<P, N>(Q, stages, (H + ng - 1) / ng);
  static size_t raised[MAX_DEVICES] = {};
  const int rc = raise_smem(ssd_heads<P, N>, smem, device, raised);
  if (rc) return rc;
  const long long blocks = (long long)nchunks * ng;
  if (blocks > INT_MAX) return NK_ERR_ARGS;
  ssd_heads<P, N><<<(int)blocks, HD_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dA,
      static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), y, st, dec, sd, Q, H, ng, stages,
      out_bf16);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_simt(const void* x, const float* dA, const void* B, const void* C,
                void* y, float* st, float* dec, float* sd, int nchunks, int Q,
                int H, int P, int N, int out_bf16, int device,
                cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(Q, P, N);
  static size_t raised[MAX_DEVICES] = {};
  if (raise_smem(ssd_simt<T>, smem, device, raised)) {
    cudaGetLastError();   // the chunk does not fit in shared memory: clear
    return NK_ERR_ARGS;   // the error, so the next launch check is clean
  }
  ssd_simt<T><<<dim3(nchunks, H), NTHR, smem, stream>>>(
      static_cast<const T*>(x), dA, static_cast<const T*>(B),
      static_cast<const T*>(C), y, st, dec, sd, Q, H, P, N, out_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nk_ssd_chunk_scan(const void* x, const void* dA,
                                 const void* B, const void* C, void* y,
                                 void* st, void* dec, void* sd, int nchunks,
                                 int Q, int H, int P, int N, int dtype,
                                 int out_dtype, int device, void* stream) {
  if (nchunks <= 0 || Q <= 0 || Q > MAXQ || H <= 0 || H > 65535 || P <= 0 ||
      N <= 0)
    return NK_ERR_ARGS;
  if (out_dtype != nk::DT_F32 && out_dtype != nk::DT_BF16)
    return NK_ERR_DTYPE;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(dA);
  float* stf = static_cast<float*>(st);
  float* decf = static_cast<float*>(dec);
  float* sdf = static_cast<float*>(sd);
  const int ob = out_dtype == nk::DT_BF16;
  if (dtype == nk::DT_BF16) {
    if (P == WG_P && N == WG_N)   // mamba2-370m
      return launch_wg(x, a, B, C, y, stf, decf, sdf, nchunks, Q, H, ob,
                       device, s);
#define NK_HEADS(PP, NN)                                                  \
  if (P == PP && N == NN)                                                 \
    return launch_heads<PP, NN>(x, a, B, C, y, stf, decf, sdf, nchunks, Q, \
                                H, ob, device, s);
    NK_HEADS(64, 16)    // hymba-1.5b
    NK_HEADS(32, 64)    // the reference's kernel test
    NK_HEADS(16, 16)    // the smoke configs
#undef NK_HEADS
    return launch_simt<__nv_bfloat16>(x, a, B, C, y, stf, decf, sdf, nchunks,
                                      Q, H, P, N, ob, device, s);
  }
  if (dtype == nk::DT_F32)
    return launch_simt<float>(x, a, B, C, y, stf, decf, sdf, nchunks, Q, H, P,
                              N, ob, device, s);
  return NK_ERR_DTYPE;
}

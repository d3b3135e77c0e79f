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
// * ssd_tc (bf16 at the narrower tensor-core shapes (P, N) in {(64, 16),
//   (32, 64), (16, 16)}: the hybrid, reference-test and smoke shapes, whose
//   rows are narrower than a 128-byte swizzle atom). One block of 8 warps
//   per (chunk, head) stages the chunk with cp.async and walks the tiles
//   on or below the diagonal on mma.sync; the state reuses the staged x.
// * ssd_simt (f32, and bf16 at other P or N): the same algorithm on the
//   CUDA cores in f32, for the tight check.
//
// Numerics of the two tensor-core kernels: x, B and C are bf16 inputs and
// exact as operands; the two f32 A operands (M and the decayed x) go in as
// a pair of bf16 values, hi = bf16(v) and lo = bf16(v - hi), two products
// each: ~16 significant bits instead of bf16's 8, so the kernel computes
// the Pallas kernel's f32 function to ~1e-5 relative. (With M and the decayed x
// rounded to bf16 once, in the kernel and its plain version alike, the two
// paths' logits of full-width mamba2-370m differed by 8.6% of their maximum
// on an H100: 48 layers amplify the rounding.) No atomics: two launches on
// one input are bit-identical.
//
// Padding: ssd_chunked pads a prompt with zero x and dA = 0, so a padded
// chunk must give its prefix's y rows, state and decays to the bit. Every
// task that needs cs computes it with chunk_cumsum, whose lane order makes
// the padded tail's cs equal to the last real row's; every sum over s
// walks the same pad64(Q) rows in the same tiles at Q 200 as at Q 256
// (rows past Q are zeros, whose products add exact zeros).
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
constexpr int CT = 64;         // columns per tile of the y product
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
// mma.sync kernel (bf16, the narrower tensor-core shapes)
// ---------------------------------------------------------------------------

// the C tile's region also holds the decayed x's lo half for the state
template <int P, int N>
__host__ __device__ constexpr int c_width() {
  return N > P ? N : P;
}

template <int P, int N>
constexpr size_t tc_smem_bytes(int Q) {
  return (size_t)pad64(Q) * (c_width<P, N>() + N + P) *
             sizeof(__nv_bfloat16) +
         2 * (size_t)pad64(Q) * sizeof(float);
}

template <int P, int N>
__global__ void __launch_bounds__(NTHR)
ssd_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dA,
       const __nv_bfloat16* __restrict__ Bm,
       const __nv_bfloat16* __restrict__ Cm, void* __restrict__ y,
       float* __restrict__ st, float* __restrict__ dec,
       float* __restrict__ sd, int Q, int H, int out_bf16) {
  constexpr int NCH_N = N / 8;      // 16-byte chunks per row of B, C
  constexpr int NCH_P = P / 8;      // ... and of x
  constexpr int KS_N = N / 16;      // k-steps of C.B^T
  constexpr int NT_S = CT / 8;      // 8-wide tiles of a G tile row
  constexpr int NT_P = P / 8;       // 8-wide tiles of a y row
  constexpr int NG = (N + 63) / 64;             // 64-wide state col groups
  constexpr int NT_G = (N < 64 ? N : 64) / 8;   // 8-wide tiles per group
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int Qp = pad64(Q);
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = Cs + Qp * c_width<P, N>();
  __nv_bfloat16* Xs = Bs + Qp * N;
  float* cs = reinterpret_cast<float*>(Xs + Qp * P);
  float* ws = cs + Qp;

  const size_t ch = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;   // mma fragment coordinates
  const __nv_bfloat16* cb = Cm + ch * Q * N;
  const __nv_bfloat16* bb = Bm + ch * Q * N;
  const __nv_bfloat16* xb = x + (ch * Q * H + h) * P;   // row s at s*H*P

  // stage the chunk; rows past Q are zero-filled
  for (int i = tid; i < Qp * NCH_N; i += NTHR) {
    const int r = i / NCH_N, c = i % NCH_N;
    const bool ok = r < Q;
    const size_t off = (size_t)(ok ? r : 0) * N + c * 8;
    cp_async16(smem_u32(Cs + swz<N>(r, c)), cb + off, ok);
    cp_async16(smem_u32(Bs + swz<N>(r, c)), bb + off, ok);
  }
  for (int i = tid; i < Qp * NCH_P; i += NTHR) {
    const int r = i / NCH_P, c = i % NCH_P;
    const bool ok = r < Q;
    cp_async16(smem_u32(Xs + swz<P>(r, c)),
               xb + (size_t)(ok ? r : 0) * H * P + c * 8, ok);
  }
  cp_async_commit();
  if (warp == 0) chunk_cumsum(dA + ch * Q * H, H, h, Q, cs, lane);
  cp_async_wait<0>();
  __syncthreads();
  for (int l = tid; l < Q; l += NTHR)
    sd[(ch * Q + l) * H + h] = expf(cs[l]);

  // ---- y: 16 rows per warp at a time, tiles on or below the diagonal ----
  const int nrg = (Q + 15) / 16;
  for (int j = 0; j * NW < nrg; ++j) {
    const int rg = (j & 1) ? (j + 1) * NW - 1 - warp : j * NW + warp;
    if (rg >= nrg) continue;
    const int r0 = rg * 16;
    uint32_t cf[KS_N][4];
#pragma unroll
    for (int ks = 0; ks < KS_N; ++ks)
      ldsm_x4(smem_u32(Cs + swz<N>(r0 + (lane % 16), ks * 2 + lane / 16)),
              cf[ks][0], cf[ks][1], cf[ks][2], cf[ks][3]);
    float yacc[NT_P][4];
#pragma unroll
    for (int jn = 0; jn < NT_P; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[jn][e] = 0.f;
    const int ra = r0 + g, rb = ra + 8;   // this thread's two rows
    const float csa = cs[ra], csb = cs[rb];
    const int last = (r0 + 15) / CT;
    for (int jt = 0; jt <= last; ++jt) {
      const int c0 = jt * CT;
      float sacc[NT_S][4];
#pragma unroll
      for (int jn = 0; jn < NT_S; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[jn][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS_N; ++ks) {
#pragma unroll
        for (int np = 0; np < NT_S / 2; ++np) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_u32(Bs + swz<N>(c0 + np * 16 + (lane % 8) +
                                           (lane / 16) * 8,
                                       ks * 2 + (lane / 8) % 2)),
                  b0, b1, b2, b3);
          mma_bf16(sacc[2 * np], cf[ks], b0, b1);
          mma_bf16(sacc[2 * np + 1], cf[ks], b2, b3);
        }
      }
      // M = G o L: the decay from the difference, selected away above the
      // diagonal; M enters M.x as its hi and lo bf16 halves
      uint32_t ph[NT_S][2], pl[NT_S][2];
#pragma unroll
      for (int jn = 0; jn < NT_S; ++jn) {
        const int c = c0 + jn * 8 + 2 * t4;
        const float e0 = cs[c], e1 = cs[c + 1];
        const float m0 = c <= ra ? sacc[jn][0] * expf(csa - e0) : 0.f;
        const float m1 = c + 1 <= ra ? sacc[jn][1] * expf(csa - e1) : 0.f;
        const float m2 = c <= rb ? sacc[jn][2] * expf(csb - e0) : 0.f;
        const float m3 = c + 1 <= rb ? sacc[jn][3] * expf(csb - e1) : 0.f;
        split_pack(m0, m1, ph[jn][0], pl[jn][0]);
        split_pack(m2, m3, ph[jn][1], pl[jn][1]);
      }
#pragma unroll
      for (int kk = 0; kk < CT / 16; ++kk) {
        const uint32_t ah[4] = {ph[2 * kk][0], ph[2 * kk][1],
                                ph[2 * kk + 1][0], ph[2 * kk + 1][1]};
        const uint32_t al[4] = {pl[2 * kk][0], pl[2 * kk][1],
                                pl[2 * kk + 1][0], pl[2 * kk + 1][1]};
#pragma unroll
        for (int dp = 0; dp < NT_P / 2; ++dp) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(smem_u32(Xs + swz<P>(c0 + kk * 16 + (lane % 8) +
                                             ((lane / 8) % 2) * 8,
                                         dp * 2 + lane / 16)),
                    b0, b1, b2, b3);
          mma_bf16(yacc[2 * dp], ah, b0, b1);
          mma_bf16(yacc[2 * dp], al, b0, b1);
          mma_bf16(yacc[2 * dp + 1], ah, b2, b3);
          mma_bf16(yacc[2 * dp + 1], al, b2, b3);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ra + 8 * i;
      if (r >= Q) continue;
      const size_t row = ((ch * Q + r) * H + h) * P + 2 * t4;
#pragma unroll
      for (int jn = 0; jn < NT_P; ++jn)
        store_pair(y, row + jn * 8, yacc[jn][2 * i], yacc[jn][2 * i + 1],
                   out_bf16);
    }
  }
  __syncthreads();   // every warp is done reading x and C for y

  // ---- state: xw = x * exp(cs[Q-1] - cs[s]) split into its hi half (in
  // place of x) and lo half (in place of C), then xw^T B ----
  const float cl = cs[Q - 1];
  for (int s = tid; s < Qp; s += NTHR)
    ws[s] = s < Q ? expf(cl - cs[s]) : 0.f;
  __syncthreads();
  __nv_bfloat16* Ls = Cs;
  for (int i = tid; i < Qp * NCH_P; i += NTHR) {
    const int r = i / NCH_P, c = i % NCH_P;
    uint4* xp = reinterpret_cast<uint4*>(Xs + swz<P>(r, c));
    uint4 hi = *xp, lo;
    uint32_t* hw = reinterpret_cast<uint32_t*>(&hi);
    uint32_t* lw = reinterpret_cast<uint32_t*>(&lo);
    const float w = ws[r];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&hw[k]));
      split_pack(f.x * w, f.y * w, hw[k], lw[k]);
    }
    *xp = hi;
    *reinterpret_cast<uint4*>(Ls + swz<P>(r, c)) = lo;
  }
  __syncthreads();
  float* sb = st + (ch * H + h) * P * N;
  for (int u = warp; u < (P / 16) * NG; u += NW) {
    const int mt = u / NG, ng = u % NG;
    float acc[NT_G][4];
#pragma unroll
    for (int jn = 0; jn < NT_G; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
    for (int ks = 0; ks < nrg; ++ks) {
      const int off = swz<P>(ks * 16 + (lane % 8) + (lane / 16) * 8,
                             mt * 2 + (lane / 8) % 2);
      uint32_t ah[4], al[4];
      ldsm_x4_t(smem_u32(Xs + off), ah[0], ah[1], ah[2], ah[3]);
      ldsm_x4_t(smem_u32(Ls + off), al[0], al[1], al[2], al[3]);
#pragma unroll
      for (int np = 0; np < NT_G / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(Bs + swz<N>(ks * 16 + (lane % 8) +
                                           ((lane / 8) % 2) * 8,
                                       ng * 8 + np * 2 + lane / 16)),
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
      for (int jn = 0; jn < NT_G; ++jn)
        *reinterpret_cast<float2*>(sb + (size_t)p * N + ng * 64 + jn * 8 +
                                   2 * t4) =
            make_float2(acc[jn][2 * i], acc[jn][2 * i + 1]);
    }
  }
  if (tid == 0) dec[ch * H + h] = expf(cl);
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

template <int P, int N>
int launch_tc(const void* x, const float* dA, const void* B, const void* C,
              void* y, float* st, float* dec, float* sd, int nchunks, int Q,
              int H, int out_bf16, int device, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<P, N>(Q);
  static size_t raised[MAX_DEVICES] = {};
  const int rc = raise_smem(ssd_tc<P, N>, smem, device, raised);
  if (rc) return rc;
  ssd_tc<P, N><<<dim3(nchunks, H), NTHR, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dA,
      static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), y, st, dec, sd, Q, H, out_bf16);
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
#define NK_TC(PP, NN)                                                      \
  if (P == PP && N == NN)                                                  \
    return launch_tc<PP, NN>(x, a, B, C, y, stf, decf, sdf, nchunks, Q, H, \
                             ob, device, s);
    NK_TC(64, 16)    // hymba-1.5b
    NK_TC(32, 64)    // the reference's kernel test
    NK_TC(16, 16)    // the smoke configs
#undef NK_TC
    return launch_simt<__nv_bfloat16>(x, a, B, C, y, stf, decf, sdf, nchunks,
                                      Q, H, P, N, ob, device, s);
  }
  if (dtype == nk::DT_F32)
    return launch_simt<float>(x, a, B, C, y, stf, decf, sdf, nchunks, Q, H, P,
                              N, ob, device, s);
  return NK_ERR_DTYPE;
}

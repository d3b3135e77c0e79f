// Flash attention forward (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel), which the reference model path
// computes as repro/models/attention.py::blockwise_attention. Same function:
// causal or sliding-window softmax attention with an online softmax whose
// running max m, sum l and accumulator are f32, and kv tiles skipped where
// they lie wholly above the causal diagonal or outside the window (the
// per-q-tile range of attention.py::_block_ranges). Unlike the TPU kernel it
// takes the model's layouts directly: q (B, S, HQ, D), k and v (B, T, KV, D)
// with HQ % KV == 0; q head h reads kv head h / (HQ / KV), so k/v are never
// expanded over heads or transposed. Ragged S and T are masked here, not
// padded by the caller.
//
// What bounds it on this card: at the serving path's prefill shapes (S a
// few hundred to a thousand, HQ 24, D 128) the work is ~2*S^2*HQ*D flops
// (causal) against ~4*S*HQ*D bytes, so the tensor cores, not the bytes, set
// the floor once S passes a few hundred; below that the launch and the
// first tile's latency dominate. Three kernels behind one entry point,
// chosen by dtype and head dim (dispatch_d):
//
// * flash_fwd_wgmma (bf16, D in {64, 128, 192}: the serving path). Built
//   from what Hopper adds. A block is one consumer warpgroup that owns 64 q
//   rows and one producer warp. The producer loads the q tile once and
//   feeds two rings in shared memory by TMA, k tiles and v tiles of 64 rows
//   (2 stages each at D 128, 3 at D 64, see below for D 192), each stage
//   with a "full" mbarrier
//   (TMA bytes landed) and an "empty" one (every consumer thread is done);
//   the consumers issue no load. S = Q K^T runs as wgmma.m64n64k16 with Q
//   and K read from shared memory (K-major, 128-byte swizzle, the layout
//   TMA writes); p goes from the f32 accumulator back into registers as
//   bf16 and is the A operand of the PV wgmma (m64n{D}k16), whose B operand
//   V is read from shared memory MN-major (the instruction's transpose
//   flag). A D 128 row is two 64-wide swizzle atoms and a D 192 row three,
//   so every tile is that many TMA boxes and the descriptors step between
//   them. Per kv tile the
//   warpgroup issues this tile's Q K^T and the previous tile's PV back to
//   back, then runs this tile's softmax on the CUDA cores while the PV is
//   still on the tensor cores. Nothing branches while a wgmma is in
//   flight (ptxas would serialise them): the mbarrier waits spin inside
//   their asm, every consumer thread arrives on "empty", and the tiles
//   that need the mask (the window's edge, the diagonal, ragged T) are
//   walked by loops of their own around the unmasked ones.
//   The tensor maps are rank 4 over (B, L, H, D) with the sequence as its
//   own dimension, so a ragged last tile reads zeros, never the next
//   sequence's rows (the kp < T mask stays: a zero score is not a masked
//   one). Blocks take q tiles heaviest first (the linear block index walks
//   the causal q tiles from the last), so the longest rows start first.
//   The maps are encoded on the host per call (cuTensorMapEncodeTiled,
//   found through cudaGetDriverEntryPoint: no -lcuda link) and passed as
//   __grid_constant__ parameters; the shared-memory attribute is set once
//   per instantiation and device. Two consumer warpgroups sharing each
//   k/v tile (128 q rows a block) measured slower at S 509 and 1024 on
//   the H100 and were dropped.
//   D 192 (nemotron-4-340b's heads; DeepSeek-V2's MLA prefill, dk 128 +
//   64 and v zero-padded from 128) takes 24 KB a tile and a 96-float PV
//   accumulator (wgmma m64n192k16). It runs 2 k stages and 1 v stage
//   (KST_192/VST_192: 99,328 bytes, two blocks an SM; the launch bounds
//   then cap registers at 168 and ptxas spills 124 bytes). On an H100
//   80GB HBM3 at 700 W (tools/attention_ab.py --shapes d192, in turns)
//   that took 0.0517 ms at 96/8 heads and 0.0810 ms at MLA's 128/128,
//   S 509, against 0.0594 / 0.1043 ms with 2 v stages (123,904 bytes, one
//   block an SM) and 0.0634 / 0.1128 ms with these stages and launch
//   bounds of one block (registers uncapped: one block an SM too).
// * flash_fwd_tf32x3 (f32, D 64 and 128: whisper's encoder and
//   cross-attention in training, every f32 parity check at d 64 and 128).
//   At whisper's trained encoder (B 4, S = T 1500, 12/12 heads, d 64) the
//   work is 27.6 GFLOP against 74 MB, so operations bound it: 0.168 ms at
//   the tensor cores' f32 rate, a third of the 495e12 TF32 peak, since an
//   f32-accurate product is three TF32 products; on the CUDA cores'
//   67e12 it would be 0.413 ms, which the SIMT kernel (1.43 ms) and
//   PyTorch's memory-efficient SDPA (0.89 ms, CUTLASS's three-product
//   TF32 on mma.sync) both stay above. The design is flash_fwd_wgmma's:
//   one consumer warpgroup of 64 q rows and a producer warp feeding k and
//   v rings by TMA (f32 boxes of 32 floats, one 128-byte swizzle atom,
//   so a D 64 row is 2 atoms and D 128 4) through full/empty mbarriers;
//   q tiles heaviest first; the shared-memory attribute set once. What
//   differs, and why:
//   - TF32 wgmma (m64nNk8) has no transpose flag: both shared-memory
//     operands must be K-major. Q and K are (their rows are
//     D-contiguous); V is MN-major for P V, so each v stage is
//     transposed by the consumers into a Vt tile (D rows x BN kv, K-major,
//     the 128-byte swizzle written by hand). A thread moves 4 kv rows x 4
//     d (four 16-byte loads, four 16-byte stores) and the quarter warps
//     are laid out so that loads and stores both fall in 8 distinct bank
//     groups. Vt's columns are permuted within each 8 (kv 0 2 4 6 1 3 5
//     7): that is the order a thread's S accumulator holds a row's
//     scores in, so p becomes PV's register A operand with no shuffle.
//     The alternative, O^T = V^T P^T with P staged in shared memory and
//     V^T read as register fragments, writes as much and rescales O by
//     columns; it was not built.
//   - Each f32 operand is split in shared memory as hi = tf32(x), lo =
//     tf32(x - hi), both cvt.rna (nk_hopper.cuh: tf32_split), so the
//     tensor core reads exact TF32 values and the split loses no bits
//     whatever it does with a word's low 13 bits. Q is split once in
//     place (hi) beside a lo tile; each k stage in place beside one k lo
//     tile; each v stage into a Vt hi and a Vt lo tile (two stages, since
//     tile it - 1's P V is issued after tile it is split). Then S =
//     q_hi k_hi + q_hi k_lo + q_lo k_hi and O += p_hi Vt_hi + p_hi Vt_lo +
//     p_lo Vt_hi, p split in registers; p is never rounded coarser
//     (ROADMAP P18). The split runs between the tile's barriers with no
//     product in flight: a barrier after it makes every thread's stores
//     visible to wgmma (fence.proxy.async), one before it holds back the
//     warps until every warp has waited on the products that read the
//     buffers it rewrites.
//   - Tiles of 32 kv rows (wgmma m64n32k8 for S, m64n{D}k8 for P V): at
//     D 64 a block takes 104 KB and two run on an SM, one block's split
//     and softmax under the other's products. On an H100 80GB HBM3 at
//     700 W (tools/flash_tf32_variants.py --set sweep --turns 2, medians
//     of 4) the encoder took 0.4907 ms with 2 k and 2 v stages, 0.4866 ms
//     with 1 v stage (inside two runs' spread), and 0.5433 / 0.5449 ms
//     with tiles of 64 rows (2 / 1 v stages, 181 / 165 KB: one block an
//     SM). D 128 runs the same tiles, one block an SM (214 KB).
//   Where the time goes (--set ablate, each copy wrong on purpose): 0.3111
//   ms without the k and v splits, 0.3258 with one TF32 product in place
//   of three, 0.1981 with both, against 0.4917: the splits and the two
//   extra products each take ~37%, one after the other in the warpgroup.
//   A split off the consumers' path is the next step.
// * flash_fwd_simt (f32 at D 16, 32 and 192, bf16 at D 16 and 32): f32
//   FMAs on the CUDA cores out of shared memory, a 4x4 score block and a
//   4x(D/8) output block per thread (4x24 at D 192). f32 at D 192 stays
//   here: one block's TF32 tiles would take 1024 + 2 x 48 KB (q hi, lo) +
//   9 x 24 KB, past the 227 KB a block can have.
//
// bf16 inputs: scores are scaled into the log2 domain, p is rounded to bf16
// before the PV product, as the TPU kernel's p.astype(v.dtype), and l sums
// the unrounded p. f32 inputs: full f32 on the CUDA cores, three TF32
// products on the tensor cores (~2^-22 of each product lost, against
// FLASH_TOL 2e-4). Masks are in absolute positions (q_offset, window) with
// the finite NEG_INF.
#include <type_traits>

#include "nk_hopper.cuh"

namespace {

using nk::BOX_BYTES;
using nk::fence_regs;
using nk::make_map;
using nk::MAX_DEVICES;
using nk::mbar_arrive;
using nk::mbar_expect_tx;
using nk::mbar_init;
using nk::mbar_wait;
using nk::pack_bf16;
using nk::prefetch_map;
using nk::smem_u32;
using nk::sw128_desc;
using nk::tf32_split;
using nk::tma_load_4d;
using nk::wg_commit;
using nk::wg_fence;
using nk::wg_wait;
using nk::wgmma_rs_n128;
using nk::wgmma_rs_n192;
using nk::wgmma_rs_n64;
using nk::wgmma_ss_n64;
using nk::wgmma_tf32_rs_n128;
using nk::wgmma_tf32_rs_n64;
using nk::wgmma_tf32_ss_n32;
using nk::wgmma_tf32_ss_n64;
using nk::bar_sync_first;
using nk::fence_proxy_async;

// ---------------------------------------------------------------------------
// wgmma + TMA kernel (bf16, D 64, 128 and 192)
// ---------------------------------------------------------------------------

constexpr int WG_BM = 64;    // q rows per block: one consumer warpgroup
constexpr int WG_BN = 64;    // kv rows per tile
constexpr int WG_THREADS = 128 + 32;      // + the producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <int D, int KST, int VST>
struct WgShape {
  static constexpr int NB = D / 64;               // 64-wide atoms per row
  static constexpr int TILE_BYTES = NB * BOX_BYTES;   // q, k or v tile
  // q, the k ring, the v ring; + slack to align to 1024 bytes
  static constexpr int SMEM = 1024 + (1 + KST + VST) * TILE_BYTES;
  // two blocks an SM where two fit the SM's 233,472 bytes (each block
  // also holds its barriers and the 1 KB the system reserves), else one
  static constexpr int MIN_BLOCKS = 2 * (SMEM + 2048) <= 233472 ? 2 : 1;
};

template <int D, int KST, int VST>
__global__ void __launch_bounds__(WG_THREADS,
                                  (WgShape<D, KST, VST>::MIN_BLOCKS))
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int B, int S, int T_len,
                int HQ, int KV, int causal, int window, int q_offset,
                float scale_log2) {
  using W = WgShape<D, KST, VST>;
  constexpr int NB = W::NB, TB = W::TILE_BYTES;
  constexpr int NT_S = WG_BN / 8;   // 8-wide score column groups
  constexpr int NT_O = D / 8;       // 8-wide output column groups
  extern __shared__ unsigned char smem_raw[];
  // q; then full and empty barriers of the k ring and of the v ring
  __shared__ __align__(8) uint64_t bars[1 + 2 * KST + 2 * VST];
  // 128-byte swizzle atoms are 1024-byte aligned
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_smem = q_smem + TB;            // + TB * stage
  const uint32_t v_smem = k_smem + KST * TB;      // + TB * stage
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t k_full = smem_u32(&bars[1]);     // + 8 * stage
  const uint32_t k_empty = k_full + 8 * KST;
  const uint32_t v_full = k_empty + 8 * KST;
  const uint32_t v_empty = v_full + 8 * VST;

  // heaviest q tiles first: block i takes q tile nq - 1 - i / (HQ * B)
  const int nq = (S + WG_BM - 1) / WG_BM;
  const int hb = blockIdx.x % (HQ * B);
  const int q0 = (nq - 1 - (int)blockIdx.x / (HQ * B)) * WG_BM;
  const int h = hb % HQ, b = hb / HQ;
  const int kvh = h / (HQ / KV);
  // live kv tiles of this q tile: _block_ranges in absolute positions
  const int n_kv = (T_len + WG_BN - 1) / WG_BN;
  int hi = n_kv - 1, lo = 0;
  if (causal) hi = min((q_offset + q0 + WG_BM - 1) / WG_BN, n_kv - 1);
  if (window) lo = max(0, (q_offset + q0 - window + 1) / WG_BN);
  const int n = hi - lo + 1;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  if (tid == 128) {   // the producer's first lane, while barriers are set up
    prefetch_map(&tm_q);
    prefetch_map(&tm_k);
    prefetch_map(&tm_v);
  }
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < KST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 128);   // every consumer thread arrives
    }
    for (int s = 0; s < VST; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: lane 0 loads q and feeds the k ring, lane 1 the v
    // ring, each as far ahead as its ring's free stages allow ----
    if (lane == 0) {
      mbar_expect_tx(bar_q, TB);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(q_smem + c * BOX_BYTES, &tm_q, bar_q, c * 64, h, q0, b);
    }
    if (lane < 2) {
      const CUtensorMap* tm = lane ? &tm_v : &tm_k;
      const int st = lane ? VST : KST;
      const uint32_t ring = lane ? v_smem : k_smem;
      const uint32_t full = lane ? v_full : k_full;
      const uint32_t empty = lane ? v_empty : k_empty;
      for (int it = 0; it < n; ++it) {
        const int s = it % st, use = it / st;
        if (use) mbar_wait(empty + 8 * s, (use - 1) & 1);
        mbar_expect_tx(full + 8 * s, TB);
        for (int c = 0; c < NB; ++c)
          tma_load_4d(ring + s * TB + c * BOX_BYTES, tm, full + 8 * s, c * 64,
                      kvh, (lo + it) * WG_BN, b);
      }
    }
    return;
  }

  // ---- the consumer warpgroup ----
  const int g = lane / 4, t4 = lane % 4;   // accumulator fragment coordinates
  const int qp0 = q_offset + q0 + warp * 16 + g;   // absolute position, row g
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  // this thread's two rows: g and g + 8 of the warp's 16
  float m_r[2] = {nk::NEG_INF, nk::NEG_INF};
  float l_r[2] = {0.f, 0.f};
  float corr[2] = {1.f, 1.f};     // O's rescale before the next PV
  float sacc[NT_S * 4];           // scores, then p in place
  uint32_t pf[NT_S / 2][4];       // p in bf16: PV's A operand
#pragma unroll
  for (int i = 0; i < NT_S * 4; ++i) sacc[i] = 0.f;

  // S = Q K^T of tile `it`: k-steps of 16 through each 64-wide atom (32
  // bytes into the swizzled row), both operands K-major
  auto issue_qk = [&](int it) {
    const int s = it % KST;
    mbar_wait(k_full + 8 * s, (it / KST) & 1);
    fence_regs(sacc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(sacc, sw128_desc(q_smem + c * BOX_BYTES + kk * 32, 16),
                     sw128_desc(k_smem + s * TB + c * BOX_BYTES + kk * 32, 16),
                     (c | kk) != 0);
    wg_commit();
  };
  // O = O * corr + P V of tile `it`: V (16 kv rows per k-step, 2048 bytes)
  // is MN-major, its 64-wide atoms BOX_BYTES apart
  auto issue_pv = [&](int it) {
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      oacc[4 * j + 0] *= corr[0];
      oacc[4 * j + 1] *= corr[0];
      oacc[4 * j + 2] *= corr[1];
      oacc[4 * j + 3] *= corr[1];
    }
    const int s = it % VST;
    mbar_wait(v_full + 8 * s, (it / VST) & 1);
    fence_regs(oacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BN / 16; ++kk) {
      const uint64_t dv = sw128_desc(v_smem + s * TB + kk * 2048, BOX_BYTES);
      if constexpr (D == 192)
        wgmma_rs_n192(oacc, pf[kk], dv, 1);
      else if constexpr (D == 128)
        wgmma_rs_n128(oacc, pf[kk], dv, 1);
      else
        wgmma_rs_n64(oacc, pf[kk], dv, 1);
    }
    wg_commit();
  };
  // the online softmax of tile `it`'s scores, in place: scaled into the
  // log2 domain, masked with the finite NEG_INF (MASK: the tile crosses
  // the diagonal, the window edge or T), p = exp(s - m) summed unrounded
  // into l. No branch: it runs while a PV product is in flight
  auto softmax = [&](int it, auto mask) {
    constexpr bool MASK = decltype(mask)::value;
    const int k0 = (lo + it) * WG_BN;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = sacc[4 * j + e] * scale_log2;
        if constexpr (MASK) {
          const int qp = qp0 + (e / 2) * 8;
          const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
          const bool ok = kp < T_len && (!causal || qp >= kp) &&
                          (!window || qp - kp < window);
          sv = ok ? sv : nk::NEG_INF;
        }
        sacc[4 * j + e] = sv;
        mx[e / 2] = fmaxf(mx[e / 2], sv);
      }
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m_r[i] - mx[i]);
      m_r[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[4 * j + e] = exp2f(sacc[4 * j + e] - mx[e / 2]);
        psum[e / 2] += sacc[4 * j + e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l_r[i] = l_r[i] * corr[i] + psum[i];
    }
  };
  // p rounded to bf16 in the A operand's layout, which is the score
  // accumulator's own: k-step kk takes score columns 16 kk .. 16 kk + 15
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < WG_BN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[kk][i] = pack_bf16(sacc[8 * kk + 2 * i], sacc[8 * kk + 2 * i + 1]);
  };
  // tile `it` >= 1: its Q K^T and the previous tile's PV run on the tensor
  // cores while this tile's softmax runs; nothing is in flight at the end,
  // so the loops around it may branch
  auto step = [&](int it, auto mask) {
    issue_qk(it);
    issue_pv(it - 1);
    wg_wait<1>();   // Q K^T done (the older group)
    fence_regs(sacc);
    mbar_arrive(k_empty + 8 * (it % KST));
    softmax(it, mask);
    wg_wait<0>();   // PV done: p's registers and the v stage are free
    fence_regs(oacc);
    mbar_arrive(v_empty + 8 * ((it - 1) % VST));
    pack_p();
  };

  // which tiles need the mask: a prefix (the window's edge) and a suffix
  // (the diagonal, ragged T); the tiles between are taken unmasked
  auto needs_mask = [&](int jt) {
    const int k0 = jt * WG_BN, qmin = q_offset + q0;
    return k0 + WG_BN > T_len || (causal && k0 + WG_BN - 1 > qmin) ||
           (window && qmin + WG_BM - 1 - k0 >= window);
  };
  int a = 1, z = n - 1;           // unmasked tiles: [a, z]
  while (a < n && needs_mask(lo + a)) ++a;
  while (z >= a && needs_mask(lo + z)) --z;

  using Mask = std::true_type;
  using NoMask = std::false_type;
  mbar_wait(bar_q, 0);
  if (n > 0) {
    issue_qk(0);
    wg_wait<0>();
    fence_regs(sacc);
    mbar_arrive(k_empty);
    softmax(0, Mask());
    pack_p();
    int it = 1;
    for (; it < a; ++it) step(it, Mask());
    for (; it <= z; ++it) step(it, NoMask());
    for (; it < n; ++it) step(it, Mask());
    issue_pv(n - 1);
    wg_wait<0>();
    fence_regs(oacc);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / fmaxf(l_r[i], 1e-30f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int srow = q0 + warp * 16 + g + 8 * i;
    if (srow >= S) continue;
    __nv_bfloat16* orow = o + (((size_t)b * S + srow) * HQ + h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < NT_O; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(oacc[4 * j + 2 * i] * inv[i],
                                oacc[4 * j + 2 * i + 1] * inv[i]);
  }
}

// ---------------------------------------------------------------------------
// wgmma + TMA kernel, f32 as three TF32 products (D 64 and 128)
// ---------------------------------------------------------------------------

template <int D, int BN, int KST, int VST>
struct XShape {
  static constexpr int NA = D / 32;               // 32-float atoms a row
  static constexpr int Q_BYTES = WG_BM * D * 4;   // the q tile (hi), q lo
  static constexpr int KV_BYTES = BN * D * 4;     // a k, v, Vt hi or Vt lo
  // q hi and lo; the k ring (hi in place), k lo; the v ring; two stages of
  // Vt hi and lo; + slack to align to 1024 bytes
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + (KST + 1 + VST + 4) * KV_BYTES;
  static constexpr int MIN_BLOCKS = 2 * (SMEM + 2048) <= 233472 ? 2 : 1;
};

template <int D, int BN, int KST, int VST>
__global__ void __launch_bounds__(WG_THREADS,
                                  (XShape<D, BN, KST, VST>::MIN_BLOCKS))
flash_fwd_tf32x3(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 float* __restrict__ o, int B, int S, int T_len, int HQ,
                 int KV, int causal, int window, int q_offset,
                 float scale_log2) {
  using X = XShape<D, BN, KST, VST>;
  constexpr int NA = X::NA, QB = X::Q_BYTES, KVB = X::KV_BYTES;
  constexpr int NT_S = BN / 8;      // 8-wide score column groups = k-steps
  constexpr int NT_O = D / 8;       // 8-wide output column groups
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * KST + 2 * VST];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_smem = (raw + 1023u) & ~1023u;
  unsigned char* const base = smem_raw + (q_smem - raw);  // generic view
  constexpr int QLO = QB, K0 = 2 * QB, KLO = K0 + KST * KVB;
  constexpr int V0 = KLO + KVB, VT0 = V0 + VST * KVB;   // byte offsets
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t k_full = smem_u32(&bars[1]);     // + 8 * stage
  const uint32_t k_empty = k_full + 8 * KST;
  const uint32_t v_full = k_empty + 8 * KST;
  const uint32_t v_empty = v_full + 8 * VST;

  // heaviest q tiles first: block i takes q tile nq - 1 - i / (HQ * B)
  const int nq = (S + WG_BM - 1) / WG_BM;
  const int hb = blockIdx.x % (HQ * B);
  const int q0 = (nq - 1 - (int)blockIdx.x / (HQ * B)) * WG_BM;
  const int h = hb % HQ, b = hb / HQ;
  const int kvh = h / (HQ / KV);
  const int n_kv = (T_len + BN - 1) / BN;
  int hi = n_kv - 1, lo = 0;
  if (causal) hi = min((q_offset + q0 + WG_BM - 1) / BN, n_kv - 1);
  if (window) lo = max(0, (q_offset + q0 - window + 1) / BN);
  const int n = hi - lo + 1;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  if (tid == 128) {
    prefetch_map(&tm_q);
    prefetch_map(&tm_k);
    prefetch_map(&tm_v);
  }
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < KST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 128);
    }
    for (int s = 0; s < VST; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: lane 0 loads q and feeds the k ring, lane 1 the v
    // ring; a row is NA boxes of 32 floats ----
    if (lane == 0) {
      mbar_expect_tx(bar_q, QB);
      for (int c = 0; c < NA; ++c)
        tma_load_4d(q_smem + c * WG_BM * 128, &tm_q, bar_q, c * 32, h, q0,
                    b);
    }
    if (lane < 2) {
      const CUtensorMap* tm = lane ? &tm_v : &tm_k;
      const int st = lane ? VST : KST;
      const uint32_t ring = q_smem + (lane ? V0 : K0);
      const uint32_t full = lane ? v_full : k_full;
      const uint32_t empty = lane ? v_empty : k_empty;
      for (int it = 0; it < n; ++it) {
        const int s = it % st, use = it / st;
        if (use) mbar_wait(empty + 8 * s, (use - 1) & 1);
        mbar_expect_tx(full + 8 * s, KVB);
        for (int c = 0; c < NA; ++c)
          tma_load_4d(ring + s * KVB + c * BN * 128, tm, full + 8 * s,
                      c * 32, kvh, (lo + it) * BN, b);
      }
    }
    return;
  }

  // ---- the consumer warpgroup ----
  const int g = lane / 4, t4 = lane % 4;
  const int qp0 = q_offset + q0 + warp * 16 + g;
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m_r[2] = {nk::NEG_INF, nk::NEG_INF};
  float l_r[2] = {0.f, 0.f};
  float corr[2] = {1.f, 1.f};
  float sacc[NT_S * 4];
  uint32_t ph[NT_S][4], pl[NT_S][4];   // p hi and lo: PV's A operand
#pragma unroll
  for (int i = 0; i < NT_S * 4; ++i) sacc[i] = 0.f;

  // a tile split in place into hi, its lo at the same offsets in `lo_off`
  // (the layout is the TMA's; the split is elementwise)
  auto split_tile = [&](int off, int lo_off, auto bytes) {
#pragma unroll
    for (int j = 0; j < decltype(bytes)::value / (128 * 16); ++j) {
      const int i = tid * 16 + j * 128 * 16;
      float4* x = reinterpret_cast<float4*>(base + off + i);
      float4 v = *x, hv, lv;
      tf32_split(v.x, hv.x, lv.x);
      tf32_split(v.y, hv.y, lv.y);
      tf32_split(v.z, hv.z, lv.z);
      tf32_split(v.w, hv.w, lv.w);
      *x = hv;
      *reinterpret_cast<float4*>(base + lo_off + i) = lv;
    }
  };
  // the v stage (BN kv rows x D, 128-byte swizzled atoms of 32 d) to Vt hi
  // and lo (D rows x BN kv, atoms of 32 kv): K-major, as TF32 PV needs.
  // Vt's column 8j + c holds kv row 8j + pi(c), pi = (0 2 4 6 1 3 5 7): the
  // order in which a thread's score fragment holds its row's columns, so
  // p goes from the S accumulator to the A operand with no shuffle. A
  // thread takes rows 8g + 2i + par (i = 0..3) of a 4-float d chunk dc and
  // writes one 16-byte Vt row chunk per d; the 8 lanes of each quarter
  // warp vary (g % 4, par) and take d chunks 2 apart, so their loads and
  // their stores fall in 8 distinct 16-byte bank groups
  auto split_v = [&](int s, int vs) {
    constexpr int G = BN / 8, C = D / 4, SLOTS = (G / 4) * (C / 8) * 8;
    static_assert(SLOTS % 16 == 0, "every thread takes as many slots");
    const int par = lane & 1, gq = (lane >> 1) & 3;
    const unsigned char* src = base + V0 + s * KVB;
    unsigned char* dst = base + VT0 + vs * 2 * KVB;
#pragma unroll
    for (int j = 0; j < SLOTS / 16; ++j) {
      const int slot = warp * 4 + (lane >> 3) + 16 * j;
      const int c0 = slot & 7, rest = slot >> 3;
      const int gi = 4 * (rest / (C / 8)) + gq;
      const int dc = 8 * (rest % (C / 8)) + ((2 * gq + c0) & 7);
      float4 x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 8 * gi + 2 * i + par;
        x[i] = *reinterpret_cast<const float4*>(
            src + (dc >> 3) * BN * 128 + r * 128 +
            (((dc & 7) ^ (r & 7)) << 4));
      }
      const int jq = 2 * (gi & 3) + par;   // Vt 16-byte chunk in its row
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dd = 4 * dc + e;
        const float c[4] = {(&x[0].x)[e], (&x[1].x)[e], (&x[2].x)[e],
                            (&x[3].x)[e]};
        float4 hv, lv;
        tf32_split(c[0], hv.x, lv.x);
        tf32_split(c[1], hv.y, lv.y);
        tf32_split(c[2], hv.z, lv.z);
        tf32_split(c[3], hv.w, lv.w);
        const int off = (gi >> 2) * D * 128 + dd * 128 + ((jq ^ (dd & 7)) << 4);
        *reinterpret_cast<float4*>(dst + off) = hv;
        *reinterpret_cast<float4*>(dst + KVB + off) = lv;
      }
    }
  };
  // tile `it`'s k and v split for the tensor cores; nothing is in flight.
  // The first barrier: every warp is past its wait on the products that
  // read k lo (tile it - 1) and this Vt stage (tile it - 2); the second:
  // every thread's stores are visible to wgmma
  auto convert = [&](int it) {
    bar_sync_first<128>();
    const int s = it % KST, sv = it % VST;
    mbar_wait(k_full + 8 * s, (it / KST) & 1);
    split_tile(K0 + s * KVB, KLO, std::integral_constant<int, KVB>());
    mbar_wait(v_full + 8 * sv, (it / VST) & 1);
    split_v(sv, it & 1);
    mbar_arrive(v_empty + 8 * sv);
    fence_proxy_async();
    bar_sync_first<128>();
  };
  // S = Q K^T of tile `it`: k-steps of 8 through each 32-float atom (32
  // bytes into the swizzled row), q_hi k_hi + q_hi k_lo + q_lo k_hi
  auto issue_qk = [&](int it) {
    const uint32_t kh = q_smem + K0 + (it % KST) * KVB;
    const uint32_t kl = q_smem + KLO, ql = q_smem + QLO;
    fence_regs(sacc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < NA; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t qo = c * WG_BM * 128 + kk * 32;
        const uint32_t ko = c * BN * 128 + kk * 32;
        const uint64_t dqh = sw128_desc(q_smem + qo, 16);
        const uint64_t dkh = sw128_desc(kh + ko, 16);
        if constexpr (BN == 64) {
          wgmma_tf32_ss_n64(sacc, dqh, dkh, (c | kk) != 0);
          wgmma_tf32_ss_n64(sacc, dqh, sw128_desc(kl + ko, 16), 1);
          wgmma_tf32_ss_n64(sacc, sw128_desc(ql + qo, 16), dkh, 1);
        } else {
          wgmma_tf32_ss_n32(sacc, dqh, dkh, (c | kk) != 0);
          wgmma_tf32_ss_n32(sacc, dqh, sw128_desc(kl + ko, 16), 1);
          wgmma_tf32_ss_n32(sacc, sw128_desc(ql + qo, 16), dkh, 1);
        }
      }
    wg_commit();
  };
  // O = O * corr + P V of tile `it`: k-step kk reads Vt's columns 8 kk ..
  // 8 kk + 7 (atom kk / 4, 32 bytes a step), p_hi Vt_hi + p_hi Vt_lo +
  // p_lo Vt_hi
  auto issue_pv = [&](int it) {
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      oacc[4 * j + 0] *= corr[0];
      oacc[4 * j + 1] *= corr[0];
      oacc[4 * j + 2] *= corr[1];
      oacc[4 * j + 3] *= corr[1];
    }
    const uint32_t vt = q_smem + VT0 + (it & 1) * 2 * KVB;
    fence_regs(oacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NT_S; ++kk) {
      const uint32_t off = (kk >> 2) * D * 128 + (kk & 3) * 32;
      const uint64_t dh = sw128_desc(vt + off, 16);
      const uint64_t dl = sw128_desc(vt + KVB + off, 16);
      if constexpr (D == 128) {
        wgmma_tf32_rs_n128(oacc, ph[kk], dh, 1);
        wgmma_tf32_rs_n128(oacc, ph[kk], dl, 1);
        wgmma_tf32_rs_n128(oacc, pl[kk], dh, 1);
      } else {
        wgmma_tf32_rs_n64(oacc, ph[kk], dh, 1);
        wgmma_tf32_rs_n64(oacc, ph[kk], dl, 1);
        wgmma_tf32_rs_n64(oacc, pl[kk], dh, 1);
      }
    }
    wg_commit();
  };
  // the online softmax of tile `it`'s scores, as in flash_fwd_wgmma
  auto softmax = [&](int it, auto mask) {
    constexpr bool MASK = decltype(mask)::value;
    const int k0 = (lo + it) * BN;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = sacc[4 * j + e] * scale_log2;
        if constexpr (MASK) {
          const int qp = qp0 + (e / 2) * 8;
          const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
          const bool ok = kp < T_len && (!causal || qp >= kp) &&
                          (!window || qp - kp < window);
          sv = ok ? sv : nk::NEG_INF;
        }
        sacc[4 * j + e] = sv;
        mx[e / 2] = fmaxf(mx[e / 2], sv);
      }
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m_r[i] - mx[i]);
      m_r[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[4 * j + e] = exp2f(sacc[4 * j + e] - mx[e / 2]);
        psum[e / 2] += sacc[4 * j + e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l_r[i] = l_r[i] * corr[i] + psum[i];
    }
  };
  // p as the TF32 A operand of k-step kk: (row g, col t4), (g + 8, t4),
  // (g, t4 + 4), (g + 8, t4 + 4), where Vt's column order makes col t4
  // score column 2 t4 and col t4 + 4 score column 2 t4 + 1
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < NT_S; ++kk) {
      const int e[4] = {0, 2, 1, 3};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float hv, lv;
        tf32_split(sacc[4 * kk + e[i]], hv, lv);
        ph[kk][i] = __float_as_uint(hv);
        pl[kk][i] = __float_as_uint(lv);
      }
    }
  };
  auto step = [&](int it, auto mask) {
    convert(it);
    issue_qk(it);
    issue_pv(it - 1);
    wg_wait<1>();   // Q K^T done (the older group)
    fence_regs(sacc);
    mbar_arrive(k_empty + 8 * (it % KST));
    softmax(it, mask);
    wg_wait<0>();   // PV done: p's registers and its Vt stage are free
    fence_regs(oacc);
    pack_p();
  };

  auto needs_mask = [&](int jt) {
    const int k0 = jt * BN, qmin = q_offset + q0;
    return k0 + BN > T_len || (causal && k0 + BN - 1 > qmin) ||
           (window && qmin + WG_BM - 1 - k0 >= window);
  };
  int a = 1, z = n - 1;           // unmasked tiles: [a, z]
  while (a < n && needs_mask(lo + a)) ++a;
  while (z >= a && needs_mask(lo + z)) --z;

  using Mask = std::true_type;
  using NoMask = std::false_type;
  mbar_wait(bar_q, 0);
  if (n > 0) {
    split_tile(0, QLO, std::integral_constant<int, QB>());   // q once;
                                            // convert(0)'s fence covers it
    convert(0);
    issue_qk(0);
    wg_wait<0>();
    fence_regs(sacc);
    mbar_arrive(k_empty);
    softmax(0, Mask());
    pack_p();
    int it = 1;
    for (; it < a; ++it) step(it, Mask());
    for (; it <= z; ++it) step(it, NoMask());
    for (; it < n; ++it) step(it, Mask());
    issue_pv(n - 1);
    wg_wait<0>();
    fence_regs(oacc);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / fmaxf(l_r[i], 1e-30f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int srow = q0 + warp * 16 + g + 8 * i;
    if (srow >= S) continue;
    float* orow = o + (((size_t)b * S + srow) * HQ + h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < NT_O; ++j)
      *reinterpret_cast<float2*>(orow + j * 8) =
          make_float2(oacc[4 * j + 2 * i] * inv[i],
                      oacc[4 * j + 2 * i + 1] * inv[i]);
  }
}

// ---------------------------------------------------------------------------
// CUDA-core kernel (f32 at D 16, 32 and 192, bf16 at D 16 and 32)
// ---------------------------------------------------------------------------

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 32;   // kv rows per tile
constexpr int NT = 128;  // threads per block

template <int D>
constexpr size_t simt_smem_floats() {
  return (size_t)BQ * (D + 1)      // Qs
         + (size_t)BK * (D + 1)    // Ks
         + (size_t)BK * D          // Vs
         + (size_t)BQ * (BK + 1)   // Ps
         + 3 * (size_t)BQ;         // m, l, correction
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int S, int T_len,
               int HQ, int KV, int causal, int window, int q_offset,
               float scale) {
  constexpr int DP = D + 1;   // padded row stride: conflict-free column reads
  constexpr int PP = BK + 1;
  constexpr int CPT = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * D;
  float* m_s = Ps + BQ * PP;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (HQ / KV);
  const int tid = threadIdx.x;
  const size_t q_stride = (size_t)HQ * D;   // between consecutive positions
  const size_t kv_stride = (size_t)KV * D;
  const T* qb = q + ((size_t)b * S * HQ + h) * D;
  const T* kb = k + ((size_t)b * T_len * KV + kvh) * D;
  const T* vb = v + ((size_t)b * T_len * KV + kvh) * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int s = q0 + r;
    Qs[r * DP + c] = s < S ? nk::to_f<T>(qb[(size_t)s * q_stride + c]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = nk::NEG_INF;
    l_s[r] = 0.f;
  }

  // thread -> (4 rows) x (4 score columns | CPT output columns)
  const int rg = tid / 8;   // 0..15
  const int cg = tid % 8;   // 0..7
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // live kv tiles for this q tile: _block_ranges in absolute positions
  const int n_kv = (T_len + BK - 1) / BK;
  int hi = n_kv - 1, lo = 0;
  if (causal) hi = min((q_offset + q0 + BQ - 1) / BK, n_kv - 1);
  if (window) lo = max(0, (q_offset + q0 - window + 1) / BK);

  const int warp = tid / 32, lane = tid % 32;
  for (int jt = lo; jt <= hi; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int t = k0 + r;
      const bool ok = t < T_len;
      Ks[r * DP + c] = ok ? nk::to_f<T>(kb[(size_t)t * kv_stride + c]) : 0.f;
      Vs[r * D + c] = ok ? nk::to_f<T>(vb[(size_t)t * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    // scores s = q k^T * scale, masked with the finite NEG_INF
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(rg * 4 + i) * DP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(cg * 4 + j) * DP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const int qp = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cg * 4 + j;
        const int kp = k0 + col;
        bool ok = kp < T_len;
        if (causal) ok = ok && qp >= kp;
        if (window) ok = ok && (qp - kp) < window;
        Ps[r * PP + col] = ok ? sc[i][j] * scale : nk::NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows [16w, 16w + 16), lane = tile column
    for (int rr = 0; rr < BQ / 4; ++rr) {
      const int r = warp * (BQ / 4) + rr;
      const float s = Ps[r * PP + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, nk::warp_max(s));
      const float p = expf(s - m_new);
      const float psum = nk::warp_sum(p);
      Ps[r * PP + lane] = nk::round_to<T>(p);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[rg * 4 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(rg * 4 + i) * PP + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = Vs[kk * D + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    const int s = q0 + r;
    if (s >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = o + (((size_t)b * S + s) * HQ + h) * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      orow[cg + 8 * j] = nk::from_f<T>(acc[i][j] / l);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D, int KST, int VST>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int T_len, int HQ, int KV, int causal, int window,
                 int q_offset, float scale, int device, cudaStream_t stream) {
  using W = WgShape<D, KST, VST>;
  // the shared-memory limit is raised once per instantiation and device
  static bool raised[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return NK_ERR_ARGS;
  if (!raised[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma<D, KST, VST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM);
    if (err != cudaSuccess) return (int)err;
    raised[device] = true;
  }
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, B, S, HQ, D);
  if (!rc) rc = make_map(&tk, k, B, T_len, KV, D);
  if (!rc) rc = make_map(&tv, v, B, T_len, KV, D);
  if (rc) return rc;
  const int nq = (S + WG_BM - 1) / WG_BM;
  flash_fwd_wgmma<D, KST, VST><<<nq * HQ * B, WG_THREADS, W::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, S, T_len, HQ, KV,
      causal, window, q_offset, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D, int BN, int KST, int VST>
int launch_tf32x3(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int T_len, int HQ, int KV, int causal,
                  int window, int q_offset, float scale, int device,
                  cudaStream_t stream) {
  using X = XShape<D, BN, KST, VST>;
  static bool raised[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return NK_ERR_ARGS;
  if (!raised[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tf32x3<D, BN, KST, VST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, X::SMEM);
    if (err != cudaSuccess) return (int)err;
    raised[device] = true;
  }
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, B, S, HQ, D, true, WG_BM);
  if (!rc) rc = make_map(&tk, k, B, T_len, KV, D, true, BN);
  if (!rc) rc = make_map(&tv, v, B, T_len, KV, D, true, BN);
  if (rc) return rc;
  const int nq = (S + WG_BM - 1) / WG_BM;
  flash_fwd_tf32x3<D, BN, KST, VST>
      <<<nq * HQ * B, WG_THREADS, X::SMEM, stream>>>(
          tq, tk, tv, static_cast<float*>(o), B, S, T_len, HQ, KV, causal,
          window, q_offset, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                int S, int T_len, int HQ, int KV, int causal, int window,
                int q_offset, float scale, int device, cudaStream_t stream) {
  const size_t smem = simt_smem_floats<D>() * sizeof(float);
  static bool raised[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return NK_ERR_ARGS;
  if (!raised[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_simt<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised[device] = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, HQ, B);
  flash_fwd_simt<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, HQ, KV, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

// the rings at D 192, two blocks an SM (timed in the header)
constexpr int KST_192 = 2, VST_192 = 1;
// flash_fwd_tf32x3's kv tile rows and rings (timed in the header): at D 64
// two blocks an SM, at D 128 one
constexpr int XBN_64 = 32, XKST_64 = 2, XVST_64 = 2;
constexpr int XBN_128 = 32, XKST_128 = 2, XVST_128 = 2;

// which kernel takes (dtype, D): bf16 at D 64/128/192 flash_fwd_wgmma, f32
// at D 64/128 flash_fwd_tf32x3, the rest flash_fwd_simt (f32 at D 192:
// one block's TF32 tiles and rings would pass the 227 KB an SM gives a
// block). kernels/flash_attention.py::route mirrors this table
template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int S, int T_len, int HQ, int KV, int causal,
               int window, int q_offset, float scale, int device,
               cudaStream_t stream) {
#define NK_ARGS q, k, v, o, B, S, T_len, HQ, KV, causal, window, q_offset, \
                scale, device, stream
  constexpr bool BF16 = sizeof(T) == 2;
  switch (D) {
    case 16:
      return launch_simt<T, 16>(NK_ARGS);
    case 32:
      return launch_simt<T, 32>(NK_ARGS);
    case 64:
      if constexpr (BF16)
        return launch_wgmma<64, 3, 3>(NK_ARGS);
      else
        return launch_tf32x3<64, XBN_64, XKST_64, XVST_64>(NK_ARGS);
    case 128:
      if constexpr (BF16)
        return launch_wgmma<128, 2, 2>(NK_ARGS);
      else
        return launch_tf32x3<128, XBN_128, XKST_128, XVST_128>(NK_ARGS);
    case 192:
      if constexpr (BF16)
        return launch_wgmma<192, KST_192, VST_192>(NK_ARGS);
      else
        return launch_simt<T, 192>(NK_ARGS);
    default:
      return NK_ERR_ARGS;
  }
#undef NK_ARGS
}

}  // namespace

extern "C" int nk_flash_attention(const void* q, const void* k,
                                  const void* v, void* o, int B, int S,
                                  int T_len, int HQ, int KV, int D, int dtype,
                                  int causal, int window, int q_offset,
                                  float scale, int device, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || KV <= 0 || HQ % KV != 0 ||
      HQ > 65535 || B > 65535 || q_offset < 0 || window < 0)
    return NK_ERR_ARGS;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == nk::DT_BF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, S, T_len, HQ, KV,
                                     causal, window, q_offset, scale, device,
                                     st);
  if (dtype == nk::DT_F32)
    return dispatch_d<float>(D, q, k, v, o, B, S, T_len, HQ, KV, causal,
                             window, q_offset, scale, device, st);
  return NK_ERR_DTYPE;
}

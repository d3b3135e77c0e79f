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
// first tile's latency dominate. Two kernels behind one entry point, chosen
// by dtype and head dim:
//
// * flash_fwd_wgmma (bf16, D in {64, 128}: the serving path). Built from
//   what Hopper adds. A block is one consumer warpgroup that owns 64 q rows
//   and one producer warp. The producer loads the q tile once and feeds
//   two rings in shared memory by TMA, k tiles and v tiles of 64 rows (2
//   stages each at D 128, 3 at D 64), each stage with a "full" mbarrier
//   (TMA bytes landed) and an "empty" one (every consumer thread is done);
//   the consumers issue no load. S = Q K^T runs as wgmma.m64n64k16 with Q
//   and K read from shared memory (K-major, 128-byte swizzle, the layout
//   TMA writes); p goes from the f32 accumulator back into registers as
//   bf16 and is the A operand of the PV wgmma (m64n{D}k16), whose B operand
//   V is read from shared memory MN-major (the instruction's transpose
//   flag). A D 128 row is two 64-wide swizzle atoms, so every tile is two
//   TMA boxes and the descriptors step between them. Per kv tile the
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
// * flash_fwd_simt (f32, and bf16 at head dims 16 and 32): f32 FMAs on the
//   CUDA cores out of shared memory, a 4x4 score block and a 4x(D/8) output
//   block per thread. It is the tight f32 check of the same algorithm.
//
// bf16 inputs: scores are scaled into the log2 domain, p is rounded to bf16
// before the PV product, as the TPU kernel's p.astype(v.dtype), and l sums
// the unrounded p. f32 inputs run in full f32. Masks are in absolute
// positions (q_offset, window) with the finite NEG_INF.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes at run time

#include <type_traits>

#include "nk_common.cuh"

namespace {

using nk::pack_bf16;
using nk::smem_u32;

// ---------------------------------------------------------------------------
// Hopper building blocks: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait until the phase of parity `parity` has completed. The spin loop is
// inside the asm: to the compiler this is straight-line code, so wgmma
// instructions in flight around it need no extra warpgroup syncs
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one TMA box of a rank-4 map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// fetch a tensor map into the cache ahead of its first TMA
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are pending (older ones are done)
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator registers across the
// asynchronous wgmma instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (between 64-wide atoms along M/N of an MN-major operand;
// unused for K-major), stride byte offset 1024 (between 8-row groups)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 64, f32) (+)= A (64 x 16, smem) * B (64 x 16, smem)^T, both
// K-major; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem,
// MN-major: the transposed B operand)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem,
// MN-major: the transposed B operand)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// wgmma + TMA kernel (bf16, D 64 and 128)
// ---------------------------------------------------------------------------

constexpr int WG_BM = 64;    // q rows per block: one consumer warpgroup
constexpr int WG_BN = 64;    // kv rows per tile
constexpr int WG_THREADS = 128 + 32;      // + the producer warp
constexpr int BOX_BYTES = 64 * 64 * 2;   // one TMA box: 64 rows x 64 bf16
constexpr float LOG2E = 1.4426950408889634f;

template <int D, int KST, int VST>
struct WgShape {
  static constexpr int NB = D / 64;               // 64-wide atoms per row
  static constexpr int TILE_BYTES = NB * BOX_BYTES;   // q, k or v tile
  // q, the k ring, the v ring; + slack to align to 1024 bytes
  static constexpr int SMEM = 1024 + (1 + KST + VST) * TILE_BYTES;
};

template <int D, int KST, int VST>
__global__ void __launch_bounds__(WG_THREADS, 2)
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
  // is MN-major, its two 64-wide atoms BOX_BYTES apart
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
      if constexpr (D == 128)
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
// CUDA-core kernel (f32, and bf16 at head dims the tensor-core kernel lacks)
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

// cuTensorMapEncodeTiled, a driver-API function, found once through the
// runtime (cudaGetDriverEntryPoint), so the library needs no -lcuda link
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// rank-4 map over a contiguous bf16 (B, L, H, D) tensor: dims innermost
// first, so the sequence L is a dimension of its own and rows past L read
// as zeros; a box is 64 d x 1 head x 64 rows x 1 sequence, 128-byte swizzle
int make_map(CUtensorMap* map, const void* ptr, int B, int L, int H, int D) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return NK_ERR_DRIVER;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : NK_ERR_DRIVER;
}

constexpr int MAX_DEVICES = 64;

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

template <typename T, int D>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                int S, int T_len, int HQ, int KV, int causal, int window,
                int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = simt_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, HQ, B);
  flash_fwd_simt<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, HQ, KV, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}


template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int S, int T_len, int HQ, int KV, int causal,
               int window, int q_offset, float scale, int device,
               cudaStream_t stream) {
#define NK_ARGS q, k, v, o, B, S, T_len, HQ, KV, causal, window, q_offset, \
                scale
  switch (D) {
    case 16:
      return launch_simt<T, 16>(NK_ARGS, stream);
    case 32:
      return launch_simt<T, 32>(NK_ARGS, stream);
    case 64:
      if constexpr (sizeof(T) == 2)
        return launch_wgmma<64, 3, 3>(NK_ARGS, device, stream);
      else
        return launch_simt<T, 64>(NK_ARGS, stream);
    case 128:
      if constexpr (sizeof(T) == 2)
        return launch_wgmma<128, 2, 2>(NK_ARGS, device, stream);
      else
        return launch_simt<T, 128>(NK_ARGS, stream);
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

// Decode attention (one query token per sequence against a KV cache) for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention, body _decode_kernel), which the reference model path
// computes as repro/models/attention.py::decode_attention (the tp == 1
// branch of decode_attention_cp). Same function and outputs: for each
// sequence b and head h, softmax over cache positions t with
// t <= pos[b] && t < kv_len (and pos[b] - t < window when a window is
// given), returning o in q's dtype plus the f32 partial stats m (running
// max) and l (sum of exp(s - m)), so that shards of a cache can be combined
// by log-sum-exp; a sequence with no live position gets o = 0,
// m = NEG_INF, l = 0. Unlike the TPU kernel it reads the grouped cache
// (B, T, KV, D) directly: a block serves kv head kvh of sequence b and all
// G = HQ / KV query heads that share it, so each cache row is read once
// for the whole group.
//
// What bounds it on this card: bytes. A step must read the live prefix
// t <= pos[b] of the cache (2 * (pos + 1) * KV * D * 2 bytes per sequence
// in bf16) and does ~4 * G flops per cache element, far below the ~295
// flops per byte where the tensor cores would set the pace. The bound is
// met only with megabytes in flight and little work per byte on the SM.
// One launch per call, grid (split, kv head, sequence):
//
// * Work sized by the live prefix, decided on the card. The host splits
//   [0, kv_len) into `nsplit` runs of 64-position chunks (enough blocks for
//   two per SM); pos stays on the card, and a block whose run holds no
//   position of [pos - window + 1, min(pos, kv_len - 1)] exits at once,
//   before any load.
// * Many bytes in flight, little work per byte. decode_mma (bf16 q and
//   cache, D 64, 128 and 192: the serving path) walks its run's live
//   chunks through a cp.async ring of (k, v) chunks in shared memory (32
//   KB a chunk at D 128), two blocks an SM: 3 stages, but 2 at D 192 (48
//   KB a chunk; 3 would leave one block an SM, see MMA_STAGES_192). Each
//   warp owns 16 positions of a chunk and computes their scores for all G
//   heads at once on the tensor cores, mma.sync m16n8k16 with the G query
//   rows padded to 16 (q in registers, k by ldmatrix from a swizzled tile):
//   no shuffle chain per position, one max and one sum over 4 lanes per
//   chunk. A thread keeps the online softmax of row lane / 4 and, where G
//   passes 8 (nemotron-4-340b's 96/8 heads: group 12), of row lane / 4 + 8
//   too, the accumulator's other half. p goes back in as the A operand of
//   the PV product as a bf16 pair, hi = bf16(p) and lo = bf16(p - hi), so
//   p keeps ~16 bits, as the plain version's f32 p. The warps keep their
//   own online softmax and are merged once, at the end of the run.
// * decode_simt (f32 queries, and bf16 at D 16 and 32) does the same per
//   chunk on the CUDA cores: a thread owns one position and half of D for
//   its dot products, then one warp max and one warp sum per head.
// * The combine in the same launch. A run's unnormalised partial
//   (acc, m, l) goes to scratch; __threadfence, then an atomic ticket per
//   (sequence, kv head). The block that draws the last ticket combines the
//   partials by log-sum-exp (fixed order: repeats are bit-identical),
//   writes (o, m, l) and sets the counter back to 0 for the next launch. A
//   sequence whose live positions fit one run skips the scratch.
#include <type_traits>

#include "nk_common.cuh"

namespace {

using nk::cp_async16;
using nk::smem_u32;

constexpr int CHUNK = 64;   // cache positions per chunk
constexpr int NT = 128;     // threads per block
// stages of decode_mma's (k, v) ring: 3, two blocks an SM. At D 192 a
// chunk is 48 KB: 2 stages (98,304 bytes) keep two blocks an SM. At
// 96/8 heads, B 8, T 1024 on an H100 80GB HBM3 at 700 W
// (tools/attention_ab.py --shapes d192, in turns) they took 0.0273 /
// 0.0399 / 0.0252 ms at mixed / full / serve-range positions, against
// 0.0281 / 0.0466 / 0.0230 ms with 3 stages (147,456 bytes, one block an
// SM): faster where the sequences are long
constexpr int MMA_STAGES_192 = 2;
template <int D>
constexpr int mma_stages() {
  return D == 192 ? MMA_STAGES_192 : 3;
}
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// the live chunks [cf, cl] of a sequence, and this block's share of them
struct Live {
  int first, last;     // live positions
  int c_begin, c_end;  // this block's live chunks
  int sf, sl;          // the splits that hold live chunks
};

__device__ __forceinline__ Live live_range(int p, int kv_len, int window,
                                           int split, int cps) {
  Live r;
  r.last = min(p, kv_len - 1);
  r.first = window ? max(0, p - window + 1) : 0;
  const int cf = r.first / CHUNK, cl = r.last / CHUNK;
  r.c_begin = max(cf, split * cps);
  r.c_end = min(cl, split * cps + cps - 1);
  r.sf = cf / cps;
  r.sl = cl / cps;
  return r;
}

// a sequence with no live position: the first split writes the empty row
template <typename QT, int G, int D>
__device__ void write_empty(QT* o, float* m_out, float* l_out, size_t hrow0) {
  for (int i = threadIdx.x; i < G * D; i += NT) {
    o[hrow0 * D + i] = nk::from_f<QT>(0.f);
    if (i % D == 0) {
      m_out[hrow0 + i / D] = nk::NEG_INF;
      l_out[hrow0 + i / D] = 0.f;
    }
  }
}

// This block's result for its run: res_o (G x D, unnormalised), res_m and
// res_l (G each, natural-log domain), all in shared memory. With one live
// split it is the answer; otherwise it becomes a partial, and the last
// block of the (sequence, kv head) to finish combines them all.
template <typename QT, int G, int D>
__device__ void finish(const float* res_o, const float* res_m,
                       const float* res_l, QT* o,
                       float* m_out, float* l_out, float* part, int* counter,
                       size_t hrow0, int bk, int split, int sf, int sl) {
  constexpr int PSTRIDE = G * D + 2 * G;   // floats per partial
  const int tid = threadIdx.x;
  const int nsplit = gridDim.x;
  __shared__ int is_last;
  if (sf == sl) {
    for (int i = tid; i < G * D; i += NT)
      o[hrow0 * D + i] =
          nk::from_f<QT>(res_o[i] / fmaxf(res_l[i / D], 1e-30f));
    if (tid < G) {
      m_out[hrow0 + tid] = res_m[tid];
      l_out[hrow0 + tid] = res_l[tid];
    }
    return;
  }
  float* my_part = part + ((size_t)bk * nsplit + split) * PSTRIDE;
  for (int i = tid; i < G * D; i += NT) my_part[i] = res_o[i];
  if (tid < G) {
    my_part[G * D + tid] = res_m[tid];
    my_part[G * D + G + tid] = res_l[tid];
  }
  // partials visible before the ticket; the last ticket combines
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(counter + bk, 1);
    is_last = ticket == sl - sf;
    if (is_last) counter[bk] = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* parts = part + (size_t)bk * nsplit * PSTRIDE;
  // one pass over the splits in their fixed order, an online softmax per
  // output: every load is independent of the running sums, so eight
  // splits' loads are in flight at a time
  constexpr int OPT = (G * D + NT - 1) / NT;   // outputs per thread
  float mx[OPT], osum[OPT], lsum[OPT];
#pragma unroll
  for (int r = 0; r < OPT; ++r) {
    mx[r] = nk::NEG_INF;
    osum[r] = lsum[r] = 0.f;
  }
#pragma unroll 8
  for (int s = sf; s <= sl; ++s) {
    const float* ps = parts + (size_t)s * PSTRIDE;
#pragma unroll
    for (int r = 0; r < OPT; ++r) {
      const int i = min(tid + r * NT, G * D - 1), g = i / D;
      const float ms = __ldcg(ps + G * D + g);
      const float m_new = fmaxf(mx[r], ms);
      const float w_old = expf(mx[r] - m_new), w_s = expf(ms - m_new);
      osum[r] = osum[r] * w_old + __ldcg(ps + i) * w_s;
      lsum[r] = lsum[r] * w_old + __ldcg(ps + G * D + G + g) * w_s;
      mx[r] = m_new;
    }
  }
#pragma unroll
  for (int r = 0; r < OPT; ++r) {
    const int i = tid + r * NT;
    if (i >= G * D) continue;
    const int g = i / D;
    o[hrow0 * D + i] = nk::from_f<QT>(osum[r] / fmaxf(lsum[r], 1e-30f));
    if (i % D == 0) {
      m_out[hrow0 + g] = mx[r];
      l_out[hrow0 + g] = lsum[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16 q and cache, D 64, 128 and 192)
// ---------------------------------------------------------------------------

// element offset of 16-byte chunk `chunk` of row `row` in a swizzled
// (rows x D) bf16 tile: chunk index XOR (row % 8)
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

template <int D, int G>
struct MmaShape {
  static constexpr int ST = mma_stages<D>();
  static constexpr int STAGE = CHUNK * D;   // bf16 elements of k (or v)
  static constexpr int SMEM = ST * 2 * STAGE * 2;   // the ring
  // after the ring drains it holds the warps' (o, m, l) and the block's
  static constexpr int TAIL_FLOATS = 5 * (G * D + 2 * G);
  static_assert(TAIL_FLOATS * 4 <= SMEM, "the tail must fit the ring");
};

template <int D, int G>
__global__ void __launch_bounds__(NT, 2)
decode_mma(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos,
           __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
           float* __restrict__ l_out, float* __restrict__ part,
           int* __restrict__ counter, int T_len, int HQ, int KV, int window,
           int kv_len, int cps, float scale_log2) {
  using Sh = MmaShape<D, G>;
  constexpr int MMA_ST = Sh::ST;
  constexpr int NCH = D / 8;        // 16-byte pieces per row
  constexpr int KSTEPS = D / 16;
  constexpr int NT_O = D / 8;       // 8-wide output column groups
  constexpr bool HI = G > 8;        // rows g + 8 carry heads too
  static_assert(G <= 16, "the G query rows are padded to mma's 16");
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t hrow0 = (size_t)b * HQ + (size_t)kvh * G;  // first q head
  const Live lv = live_range(pos[b], kv_len, window, split, cps);
  if (lv.first > lv.last) {
    if (split == 0) write_empty<__nv_bfloat16, G, D>(o, m_out, l_out, hrow0);
    return;
  }
  if (lv.c_begin > lv.c_end) return;   // no live chunk here: no load
  const int nc = lv.c_end - lv.c_begin + 1;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const size_t row = (size_t)KV * D;   // between consecutive positions
  const __nv_bfloat16* kb = k + (size_t)b * T_len * row + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * T_len * row + (size_t)kvh * D;
  // chunk c into stage s; rows outside the live range read as zeros
  auto load = [&](int c, int s) {
    __nv_bfloat16* kd = ring + 2 * s * Sh::STAGE;
    __nv_bfloat16* vd = kd + Sh::STAGE;
    for (int i = tid; i < CHUNK * NCH; i += NT) {
      const int r = i / NCH, pc = i % NCH;
      const int t = c * CHUNK + r;
      const bool ok = t >= lv.first && t <= lv.last;
      const size_t off = (size_t)(ok ? t : 0) * row + pc * 8;
      cp_async16(smem_u32(kd + swz<D>(r, pc)), kb + off, ok);
      cp_async16(smem_u32(vd + swz<D>(r, pc)), vb + off, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < MMA_ST - 1; ++i) {
    if (i < nc) load(lv.c_begin + i, i);
    nk::cp_async_commit();
  }

  // q as the A operand: rows g < G of 16 (this thread's rows lane/4 and
  // lane/4 + 8; the second is padding unless G > 8)
  const int g = lane / 4, t4 = lane % 4;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const __nv_bfloat16* qr = q + (hrow0 + g) * D + ks * 16 + 2 * t4;
    qf[ks][0] = g < G ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
    qf[ks][2] = g < G ? *reinterpret_cast<const uint32_t*>(qr + 8) : 0u;
    qf[ks][1] = qf[ks][3] = 0u;
    if constexpr (HI) {
      const __nv_bfloat16* qh = qr + 8 * D;   // row g + 8
      qf[ks][1] = g + 8 < G ? *reinterpret_cast<const uint32_t*>(qh) : 0u;
      qf[ks][3] =
          g + 8 < G ? *reinterpret_cast<const uint32_t*>(qh + 8) : 0u;
    }
  }
  float oacc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  float m2 = nk::NEG_INF, l_r = 0.f;   // row g, log2 domain
  float m2h = nk::NEG_INF, l_rh = 0.f; // row g + 8 (used where G > 8)
  const int wrow = warp * 16;          // this warp's positions in a chunk

  for (int i = 0; i < nc; ++i) {
    nk::cp_async_wait<MMA_ST - 2>();
    __syncthreads();   // chunk i landed; the stage of chunk i - 1 is free
    if (i + MMA_ST - 1 < nc)
      load(lv.c_begin + i + MMA_ST - 1, (i + MMA_ST - 1) % MMA_ST);
    nk::cp_async_commit();
    const __nv_bfloat16* kt = ring + 2 * (i % MMA_ST) * Sh::STAGE;
    const __nv_bfloat16* vt = kt + Sh::STAGE;
    const int c0 = (lv.c_begin + i) * CHUNK;

    // scores (16 padded rows) x (the warp's 16 positions)
    float sacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t b0, b1, b2, b3;
      nk::ldsm_x4(smem_u32(kt + swz<D>(wrow + (lane % 8) + (lane / 16) * 8,
                                       ks * 2 + (lane / 8) % 2)),
                  b0, b1, b2, b3);
      nk::mma_bf16(sacc[0], qf[ks], b0, b1);
      nk::mma_bf16(sacc[1], qf[ks], b2, b3);
    }
    // a row's online softmax over its 4 positions here, 4 lanes a row:
    // row g from the fragments' first half (e 0), row g + 8 from their
    // second (e 2); p in place of the scores, the rescale returned
    bool live[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = c0 + wrow + (u / 2) * 8 + 2 * t4 + (u & 1);
      live[u] = t >= lv.first && t <= lv.last;
    }
    auto softmax = [&](auto half, float& m_run, float& l_run,
                       float (&p)[4]) {
      constexpr int e = decltype(half)::value;
      float mx = m_run;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        p[u] = live[u] ? sacc[u / 2][e + (u & 1)] * scale_log2 : nk::NEG_INF;
        mx = fmaxf(mx, p[u]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp2f(m_run - mx);
      m_run = mx;
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        p[u] = live[u] ? exp2f(p[u] - mx) : 0.f;
        psum += p[u];
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_run = l_run * corr + psum;
      return corr;
    };
    float p[4], ph[4];
    const float corr = softmax(std::integral_constant<int, 0>(), m2, l_r, p);
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      oacc[j][0] *= corr;
      oacc[j][1] *= corr;
    }
    if constexpr (HI) {
      const float corr_h =
          softmax(std::integral_constant<int, 2>(), m2h, l_rh, ph);
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        oacc[j][2] *= corr_h;
        oacc[j][3] *= corr_h;
      }
    }
    // acc += p v with p as a bf16 pair (hi + lo): the score fragments are
    // the A operand as they stand (rows g + 8 are padding, zero, unless
    // G > 8)
    uint32_t a_hi[4], a_lo[4];
    auto hi_lo = [](float x0, float x1, uint32_t& hi_out, uint32_t& lo_out) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hi);
      hi_out = *reinterpret_cast<const uint32_t*>(&hi);
      lo_out = nk::pack_bf16(x0 - hf.x, x1 - hf.y);
    };
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      hi_lo(p[2 * j], p[2 * j + 1], a_hi[2 * j], a_lo[2 * j]);
      if constexpr (HI)
        hi_lo(ph[2 * j], ph[2 * j + 1], a_hi[2 * j + 1], a_lo[2 * j + 1]);
      else
        a_hi[2 * j + 1] = a_lo[2 * j + 1] = 0u;
    }
#pragma unroll
    for (int dp = 0; dp < NT_O / 2; ++dp) {
      uint32_t b0, b1, b2, b3;
      nk::ldsm_x4_t(smem_u32(vt + swz<D>(wrow + (lane % 8) +
                                             ((lane / 8) % 2) * 8,
                                         dp * 2 + lane / 16)),
                    b0, b1, b2, b3);
      nk::mma_bf16(oacc[2 * dp], a_hi, b0, b1);
      nk::mma_bf16(oacc[2 * dp + 1], a_hi, b2, b3);
      nk::mma_bf16(oacc[2 * dp], a_lo, b0, b1);
      nk::mma_bf16(oacc[2 * dp + 1], a_lo, b2, b3);
    }
  }
  nk::cp_async_wait<0>();
  __syncthreads();   // the ring is free: it holds the tail from here on

  // merge the 4 warps' softmax states: (o, m, l) per warp, in the ring
  float* tail = reinterpret_cast<float*>(smem_raw);
  constexpr int WSTRIDE = G * D + 2 * G;
  float* mine = tail + warp * WSTRIDE;
  if (g < G) {
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      mine[g * D + 8 * j + 2 * t4] = oacc[j][0];
      mine[g * D + 8 * j + 2 * t4 + 1] = oacc[j][1];
    }
    if (t4 == 0) {
      mine[G * D + g] = m2;
      mine[G * D + G + g] = l_r;
    }
  }
  if constexpr (HI) {
    const int gh = g + 8;
    if (gh < G) {
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        mine[gh * D + 8 * j + 2 * t4] = oacc[j][2];
        mine[gh * D + 8 * j + 2 * t4 + 1] = oacc[j][3];
      }
      if (t4 == 0) {
        mine[G * D + gh] = m2h;
        mine[G * D + G + gh] = l_rh;
      }
    }
  }
  __syncthreads();
  float* res_o = tail + 4 * WSTRIDE;
  float* res_m = res_o + G * D;
  float* res_l = res_m + G;
  for (int i = tid; i < G * D; i += NT) {
    const int gg = i / D;
    float mx = nk::NEG_INF;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      mx = fmaxf(mx, tail[w * WSTRIDE + G * D + gg]);
    float acc = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = exp2f(tail[w * WSTRIDE + G * D + gg] - mx);
      acc += tail[w * WSTRIDE + i] * wt;
      lsum += tail[w * WSTRIDE + G * D + G + gg] * wt;
    }
    res_o[i] = acc;
    if (i % D == 0) {
      res_m[gg] = mx * LN2;   // back to the natural-log domain
      res_l[gg] = lsum;
    }
  }
  __syncthreads();
  finish<__nv_bfloat16, G, D>(res_o, res_m, res_l, o, m_out, l_out, part,
                              counter, hrow0, b * KV + kvh, split, lv.sf,
                              lv.sl);
}

// ---------------------------------------------------------------------------
// CUDA-core kernel (f32 queries; bf16 at D 16 and 32)
// ---------------------------------------------------------------------------

template <typename KT, int D, int G>
struct SimtShape {
  static constexpr int ROW_BYTES = D * (int)sizeof(KT);
  static constexpr int EP = 16 / (int)sizeof(KT);   // elements per 16 bytes
  static constexpr int NPH = D / 2 / EP;            // 16-byte pieces per half
  static constexpr int PAIRS = D / 2;               // PV column pairs
  static constexpr int PGROUPS = NT / PAIRS;        // position groups in PV
  // at D 192 one group of 96 pairs: threads 96-127 sit the PV product out
  static constexpr bool ALL_IN_PV = NT % PAIRS == 0;
  // shared memory: k and v chunks, then f32 q, half scores, p, PV sums,
  // the chunk's (m, l), the run's (o, m, l), rescale weights
  static constexpr int KV_BYTES = 2 * CHUNK * ROW_BYTES;
  static constexpr int FLOATS = G * D + 2 * G * CHUNK + G * CHUNK +
                                PGROUPS * G * D + 2 * G + G * D + 2 * G +
                                2 * G;
  static constexpr int SMEM = KV_BYTES + FLOATS * 4;
};

__device__ __forceinline__ void load_piece(const __nv_bfloat16* p,
                                           float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_piece(const float* p, float (&out)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename QT, typename KT, int D, int G>
__global__ void __launch_bounds__(NT)
decode_simt(const QT* __restrict__ q, const KT* __restrict__ k,
            const KT* __restrict__ v, const int* __restrict__ pos,
            QT* __restrict__ o, float* __restrict__ m_out,
            float* __restrict__ l_out, float* __restrict__ part,
            int* __restrict__ counter, int T_len, int HQ, int KV, int window,
            int kv_len, int cps, float scale) {
  using Sh = SimtShape<KT, D, G>;
  constexpr int EP = Sh::EP, NPH = Sh::NPH, PAIRS = Sh::PAIRS;
  constexpr int PGROUPS = Sh::PGROUPS;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t hrow0 = (size_t)b * HQ + (size_t)kvh * G;  // first q head
  const Live lv = live_range(pos[b], kv_len, window, split, cps);
  if (lv.first > lv.last) {
    if (split == 0) write_empty<QT, G, D>(o, m_out, l_out, hrow0);
    return;
  }
  if (lv.c_begin > lv.c_end) return;   // no live chunk here: no load

  extern __shared__ __align__(128) unsigned char smem_raw[];
  KT* ks = reinterpret_cast<KT*>(smem_raw);
  KT* vs = ks + CHUNK * D;
  float* q_s = reinterpret_cast<float*>(smem_raw + Sh::KV_BYTES);  // G x D
  float* sc_s = q_s + G * D;            // 2 halves x G x CHUNK
  float* p_s = sc_s + 2 * G * CHUNK;    // G x CHUNK
  float* red_s = p_s + G * CHUNK;       // PGROUPS x G x D
  float* chunk_s = red_s + PGROUPS * G * D;   // the chunk's m[G], l[G]
  float* res_o = chunk_s + 2 * G;       // the run's o, m, l
  float* res_m = res_o + G * D;
  float* res_l = res_m + G;
  float* wt_s = res_l + G;              // rescale weights: run, chunk

  for (int i = tid; i < G * D; i += NT) {
    q_s[i] = nk::to_f<QT>(q[hrow0 * D + i]);
    res_o[i] = 0.f;
  }
  if (tid < G) {
    res_m[tid] = nk::NEG_INF;
    res_l[tid] = 0.f;
  }
  const size_t row = (size_t)KV * D;   // between consecutive positions
  const KT* kb = k + (size_t)b * T_len * row + (size_t)kvh * D;
  const KT* vb = v + (size_t)b * T_len * row + (size_t)kvh * D;
  constexpr int PIECES = Sh::ROW_BYTES / 16;   // per row

  for (int c = lv.c_begin; c <= lv.c_end; ++c) {
    const int c0 = c * CHUNK;
    // the chunk's live rows in one go; the rest (and rows past T) read zero
    for (int i = tid; i < CHUNK * PIECES; i += NT) {
      const int r = i / PIECES, pc = i % PIECES;
      const int t = c0 + r;
      const bool ok = t >= lv.first && t <= lv.last;
      const size_t off = (size_t)(ok ? t : 0) * row + pc * EP;
      cp_async16(smem_u32(ks + r * D + pc * EP), kb + off, ok);
      cp_async16(smem_u32(vs + r * D + pc * EP), vb + off, ok);
    }
    nk::cp_async_commit();
    nk::cp_async_wait<0>();
    __syncthreads();

    // scores: thread -> (position r, half hh of D), all G heads at once;
    // 16-byte reads rotated by the row, so a warp's reads spread over the
    // banks
    {
      const int r = tid % CHUNK, hh = tid / CHUNK;
      float acc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll
      for (int i = 0; i < NPH; ++i) {
        const int col = hh * (D / 2) + ((i + r) % NPH) * EP;
        float kf[EP];
        load_piece(ks + r * D + col, kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int e = 0; e < EP; e += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(q_s + g * D + col + e);
            acc[g] = fmaf(qv.x, kf[e], acc[g]);
            acc[g] = fmaf(qv.y, kf[e + 1], acc[g]);
            acc[g] = fmaf(qv.z, kf[e + 2], acc[g]);
            acc[g] = fmaf(qv.w, kf[e + 3], acc[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) sc_s[(hh * G + g) * CHUNK + r] = acc[g];
    }
    __syncthreads();

    // the chunk's softmax: warp w takes heads w, w + 4; one max and one
    // sum per head
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int g = warp; g < G; g += NT / 32) {
        float s[2];
        bool live[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = lane + 32 * u;
          const int t = c0 + r;
          live[u] = t >= lv.first && t <= lv.last;
          s[u] = live[u] ? (sc_s[g * CHUNK + r] +
                            sc_s[(G + g) * CHUNK + r]) * scale
                         : nk::NEG_INF;
        }
        const float mc = nk::warp_max(fmaxf(s[0], s[1]));
        float p[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          p[u] = live[u] ? expf(s[u] - mc) : 0.f;
          p_s[g * CHUNK + lane + 32 * u] = p[u];
        }
        const float lc = nk::warp_sum(p[0] + p[1]);
        if (lane == 0) {
          chunk_s[g] = mc;
          chunk_s[G + g] = lc;
        }
      }
    }
    __syncthreads();

    // acc = p v: thread -> (column pair, every PGROUPS-th position); the
    // run's state is rescaled to the new max meanwhile
    {
      const int pi = tid % PAIRS, grp = tid / PAIRS;
      if (Sh::ALL_IN_PV || grp < PGROUPS) {
        float acc[G][2];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;
#pragma unroll 4
        for (int r = grp; r < CHUNK; r += PGROUPS) {
          const float2 vv = load_pair(vs + r * D + 2 * pi);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float pg = p_s[g * CHUNK + r];
            acc[g][0] = fmaf(pg, vv.x, acc[g][0]);
            acc[g][1] = fmaf(pg, vv.y, acc[g][1]);
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          red_s[(grp * G + g) * D + 2 * pi] = acc[g][0];
          red_s[(grp * G + g) * D + 2 * pi + 1] = acc[g][1];
        }
      }
      if (tid < G) {
        const float m_new = fmaxf(res_m[tid], chunk_s[tid]);
        wt_s[tid] = expf(res_m[tid] - m_new);
        wt_s[G + tid] = expf(chunk_s[tid] - m_new);
        res_l[tid] =
            res_l[tid] * wt_s[tid] + chunk_s[G + tid] * wt_s[G + tid];
        res_m[tid] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D;
      float a = 0.f;
#pragma unroll
      for (int grp = 0; grp < PGROUPS; ++grp) a += red_s[(grp * G) * D + i];
      res_o[i] = res_o[i] * wt_s[g] + a * wt_s[G + g];
    }
    __syncthreads();   // k, v, red_s and the weights are free again
  }
  finish<QT, G, D>(res_o, res_m, res_l, o, m_out, l_out, part, counter,
                   hrow0, b * KV + kvh, split, lv.sf, lv.sl);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *pos;
  void *o, *m, *l, *part, *counter;
  int B, T_len, HQ, KV, window, kv_len, nsplit, cps, device;
  float scale;
  cudaStream_t stream;
};

constexpr int MAX_DEVICES = 64;

// raise `kernel`'s shared-memory limit, once per device
template <typename K>
int raise_smem(K kernel, int bytes, bool (&raised)[MAX_DEVICES],
               int device) {
  if (device < 0 || device >= MAX_DEVICES) return NK_ERR_ARGS;
  if (!raised[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    raised[device] = true;
  }
  return 0;
}

template <typename QT, typename KT, int D, int G>
int launch(const Args& a) {
  const dim3 grid(a.nsplit, a.KV, a.B);
  if constexpr (sizeof(QT) == 2 && sizeof(KT) == 2 && D >= 64) {
    using Sh = MmaShape<D, G>;
    static bool raised[MAX_DEVICES] = {};
    const int rc = raise_smem(decode_mma<D, G>, Sh::SMEM, raised, a.device);
    if (rc) return rc;
    decode_mma<D, G><<<grid, NT, Sh::SMEM, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v),
        static_cast<const int*>(a.pos), static_cast<__nv_bfloat16*>(a.o),
        static_cast<float*>(a.m), static_cast<float*>(a.l),
        static_cast<float*>(a.part), static_cast<int*>(a.counter), a.T_len,
        a.HQ, a.KV, a.window, a.kv_len, a.cps, a.scale * LOG2E);
  } else {
    using Sh = SimtShape<KT, D, G>;
    static bool raised[MAX_DEVICES] = {};
    const int rc =
        raise_smem(decode_simt<QT, KT, D, G>, Sh::SMEM, raised, a.device);
    if (rc) return rc;
    decode_simt<QT, KT, D, G><<<grid, NT, Sh::SMEM, a.stream>>>(
        static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
        static_cast<const KT*>(a.v), static_cast<const int*>(a.pos),
        static_cast<QT*>(a.o), static_cast<float*>(a.m),
        static_cast<float*>(a.l), static_cast<float*>(a.part),
        static_cast<int*>(a.counter), a.T_len, a.HQ, a.KV, a.window,
        a.kv_len, a.cps, a.scale);
  }
  return (int)cudaGetLastError();
}

template <typename QT, typename KT, int D>
int dispatch_g(int G, const Args& a) {
#define NK_G(g) \
  case g:       \
    return launch<QT, KT, D, g>(a);
  switch (G) {
    NK_G(1)
    NK_G(2)
    NK_G(3)
    NK_G(4)
    NK_G(5)
    NK_G(6)
    NK_G(7)
    NK_G(8)
    default:
      return NK_ERR_ARGS;
  }
#undef NK_G
}

template <typename QT, typename KT>
int dispatch_d(int D, int G, const Args& a) {
#define NK_D(d) \
  case d:       \
    return dispatch_g<QT, KT, d>(G, a);
  switch (D) {
    NK_D(16)
    NK_D(32)
    NK_D(64)
    NK_D(128)
    // head dim 192 only at the group a config serves it with
    // (nemotron-4-340b's 96/8 heads)
    case 192:
      return G == 12 ? launch<QT, KT, 192, 12>(a) : NK_ERR_ARGS;
    default:
      return NK_ERR_ARGS;
  }
#undef NK_D
}

}  // namespace

// The grid covers [0, kv_len) in nsplit runs of `chunk` positions (a
// multiple of 64). part: B * KV * nsplit * (G * D + 2 * G) floats of
// scratch (unused when nsplit is 1); counter: B * KV ints, zero before the
// first launch, which every launch leaves zero again. Launches that share
// a counter must not run concurrently: the wrapper keeps one counter per
// (card, stream), so only launches on one stream, which run in order,
// share one.
extern "C" int nk_decode_attention(const void* q, const void* k,
                                   const void* v, const void* pos, void* o,
                                   void* m, void* l, void* part,
                                   void* counter, int B, int T_len, int HQ,
                                   int KV, int D, int q_dtype, int kv_dtype,
                                   int window, int kv_len, int nsplit,
                                   int chunk, float scale, int device,
                                   void* stream) {
  if (B <= 0 || T_len <= 0 || KV <= 0 || HQ % KV != 0 || B > 65535 ||
      KV > 65535 || kv_len <= 0 || kv_len > T_len || window < 0 ||
      chunk < CHUNK || chunk % CHUNK != 0 || nsplit < 1 ||
      nsplit > 65535 || (long long)(nsplit - 1) * chunk >= kv_len ||
      (long long)nsplit * chunk < kv_len ||
      (nsplit > 1 && (!part || !counter)))
    return NK_ERR_ARGS;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int G = HQ / KV;
  const Args a{q,      k,      v,      pos,    o,       m,      l,
               part,   counter, B,     T_len,  HQ,      KV,     window,
               kv_len, nsplit, chunk / CHUNK, device, scale,
               static_cast<cudaStream_t>(stream)};
  if (q_dtype == nk::DT_BF16 && kv_dtype == nk::DT_BF16)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, G, a);
  if (q_dtype == nk::DT_F32 && kv_dtype == nk::DT_BF16)
    return dispatch_d<float, __nv_bfloat16>(D, G, a);
  if (q_dtype == nk::DT_F32 && kv_dtype == nk::DT_F32)
    return dispatch_d<float, float>(D, G, a);
  return NK_ERR_DTYPE;
}

extern "C" const char* nk_error_string(int code) {
  if (code == NK_ERR_ARGS) return "arguments outside what the kernel supports";
  if (code == NK_ERR_DTYPE) return "dtype (combination) not supported";
  if (code == NK_ERR_DRIVER)
    return "the CUDA driver refused a TMA tensor map (or offers no encoder)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

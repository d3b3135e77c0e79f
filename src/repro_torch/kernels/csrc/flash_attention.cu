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
// (causal) against ~4*S*HQ*D bytes, so operations, not bytes, set the floor
// once S passes a few hundred; below that the launch and the first tile's
// latency dominate. Two kernels behind one entry point:
//
// * flash_fwd_tc (bf16, D in {64, 128}: the serving path). The two products
//   run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 out). A
//   block of 4 warps owns a 64-row q tile; each warp owns 16 rows and keeps
//   its q fragments, its scores, its softmax state and its output
//   accumulator in registers, so the online softmax never touches shared
//   memory. 64-row k/v tiles are double-buffered in shared memory with
//   cp.async (the next tile loads while this one is used), stored with an
//   XOR swizzle of the 16-byte chunks so that ldmatrix reads are free of
//   bank conflicts. wgmma, TMA and warp specialisation are later work.
// * flash_fwd_simt (f32, and bf16 at other head dims): f32 FMAs on the CUDA
//   cores out of shared memory, a 4x4 score block and a 4x(D/8) output
//   block per thread. It is the tight f32 check of the same algorithm.
//
// bf16 inputs: p is rounded to bf16 before the PV product, as the TPU
// kernel's p.astype(v.dtype); l sums the unrounded p. f32 inputs run in
// full f32.
#include "nk_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16)
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 64;   // q rows per block: 4 warps x 16
constexpr int TC_BK = 64;   // kv rows per tile
constexpr int TC_NT = 128;  // threads per block
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t tc_smem_bytes() {
  return (size_t)(TC_BQ + 4 * TC_BK) * D * sizeof(__nv_bfloat16);
}

using nk::cp_async16;
using nk::cp_async_commit;
using nk::cp_async_wait;
using nk::ldsm_x4;
using nk::ldsm_x4_t;
using nk::mma_bf16;
using nk::pack_bf16;
using nk::smem_u32;

// element offset of 16-byte chunk `chunk` of row `row` in a swizzled
// (rows x D) bf16 tile: chunk index XOR (row % 8)
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

template <int D>
__global__ void __launch_bounds__(TC_NT)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ o, int S, int T_len, int HQ, int KV,
             int causal, int window, int q_offset, float scale_log2) {
  constexpr int NCH = D / 8;        // 16-byte chunks per row
  constexpr int KSTEPS = D / 16;    // k-steps of the QK^T product
  constexpr int NT_S = TC_BK / 8;   // 8-wide score tiles per warp
  constexpr int NT_O = D / 8;       // 8-wide output tiles per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + TC_BQ * D;       // two buffers
  __nv_bfloat16* Vs = Ks + 2 * TC_BK * D;   // two buffers

  const int q0 = blockIdx.x * TC_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (HQ / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;   // mma fragment coordinates
  const size_t q_stride = (size_t)HQ * D;  // between consecutive positions
  const size_t kv_stride = (size_t)KV * D;
  const __nv_bfloat16* qb = q + ((size_t)b * S * HQ + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * T_len * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * T_len * KV + kvh) * D;

  for (int i = tid; i < TC_BQ * NCH; i += TC_NT) {
    const int r = i / NCH, c = i % NCH;
    const int s = q0 + r;
    const bool ok = s < S;
    cp_async16(smem_u32(Qs + swz<D>(r, c)),
               qb + (size_t)(ok ? s : 0) * q_stride + c * 8, ok);
  }
  cp_async_commit();

  auto load_kv = [&](int jt, int buf) {
    const int k0 = jt * TC_BK;
    __nv_bfloat16* kd = Ks + buf * TC_BK * D;
    __nv_bfloat16* vd = Vs + buf * TC_BK * D;
    for (int i = tid; i < TC_BK * NCH; i += TC_NT) {
      const int r = i / NCH, c = i % NCH;
      const int t = k0 + r;
      const bool ok = t < T_len;
      const size_t off = (size_t)(ok ? t : 0) * kv_stride + c * 8;
      cp_async16(smem_u32(kd + swz<D>(r, c)), kb + off, ok);
      cp_async16(smem_u32(vd + swz<D>(r, c)), vb + off, ok);
    }
    cp_async_commit();
  };

  // live kv tiles for this q tile: _block_ranges in absolute positions
  const int n_kv = (T_len + TC_BK - 1) / TC_BK;
  int hi = n_kv - 1, lo = 0;
  if (causal) hi = min((q_offset + q0 + TC_BQ - 1) / TC_BK, n_kv - 1);
  if (window) lo = max(0, (q_offset + q0 - window + 1) / TC_BK);
  if (lo <= hi) load_kv(lo, 0);

  uint32_t qf[KSTEPS][4];
  float oacc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  // this thread's two rows: g and g + 8 of the warp's 16
  float m_r[2] = {nk::NEG_INF, nk::NEG_INF};
  float l_r[2] = {0.f, 0.f};
  const int wr = warp * 16;
  const int qp0 = q_offset + q0 + wr + g;   // absolute position of row g

  for (int jt = lo; jt <= hi; ++jt) {
    const int buf = (jt - lo) & 1;
    if (jt < hi) {
      load_kv(jt + 1, buf ^ 1);   // that buffer was released last iteration
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (jt == lo) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldsm_x4(smem_u32(Qs + swz<D>(wr + (lane % 16), ks * 2 + lane / 16)),
                qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3]);
    }
    const __nv_bfloat16* kt = Ks + buf * TC_BK * D;
    const __nv_bfloat16* vt = Vs + buf * TC_BK * D;

    // scores: (16 rows) x (64 kv positions) per warp
    float sacc[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(kt + swz<D>(np * 16 + (lane % 8) + (lane / 16) * 8,
                                     ks * 2 + (lane / 8) % 2)),
                b0, b1, b2, b3);
        mma_bf16(sacc[2 * np], qf[ks], b0, b1);
        mma_bf16(sacc[2 * np + 1], qf[ks], b2, b3);
      }
    }

    // mask with the finite NEG_INF, scale into the log2 domain, row max
    const int k0 = jt * TC_BK;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = qp0 + (e / 2) * 8;
        const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
        bool ok = kp < T_len;
        if (causal) ok = ok && qp >= kp;
        if (window) ok = ok && (qp - kp) < window;
        const float s = ok ? sacc[j][e] * scale_log2 : nk::NEG_INF;
        sacc[j][e] = s;
        mx[e / 2] = fmaxf(mx[e / 2], s);
      }
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m_r[i] - mx[i]);
      m_r[i] = mx[i];
    }
    // p = exp(s - m): summed unrounded into l, rounded to bf16 for PV
    uint32_t pf[NT_S][2];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      const float p0 = exp2f(sacc[j][0] - mx[0]);
      const float p1 = exp2f(sacc[j][1] - mx[0]);
      const float p2 = exp2f(sacc[j][2] - mx[1]);
      const float p3 = exp2f(sacc[j][3] - mx[1]);
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      pf[j][0] = pack_bf16(p0, p1);
      pf[j][1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l_r[i] = l_r[i] * corr[i] + psum[i];
    }
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      oacc[j][0] *= corr[0];
      oacc[j][1] *= corr[0];
      oacc[j][2] *= corr[1];
      oacc[j][3] *= corr[1];
    }

    // acc += p v: the score fragments are the A operand as they stand
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                             pf[2 * kk + 1][1]};
#pragma unroll
      for (int dp = 0; dp < NT_O / 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(vt + swz<D>(kk * 16 + (lane % 8) +
                                           ((lane / 8) % 2) * 8,
                                       dp * 2 + lane / 16)),
                  b0, b1, b2, b3);
        mma_bf16(oacc[2 * dp], a, b0, b1);
        mma_bf16(oacc[2 * dp + 1], a, b2, b3);
      }
    }
    __syncthreads();   // this buffer is free for the load two tiles on
  }
  cp_async_wait<0>();  // no tile at all: the q load is still in flight

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / fmaxf(l_r[i], 1e-30f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + wr + g + 8 * i;
    if (s >= S) continue;
    __nv_bfloat16* orow = o + (((size_t)b * S + s) * HQ + h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < NT_O; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(oacc[j][2 * i] * inv[i],
                                oacc[j][2 * i + 1] * inv[i]);
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

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int T_len, int HQ, int KV, int causal, int window,
              int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + TC_BQ - 1) / TC_BQ, HQ, B);
  flash_fwd_tc<D><<<grid, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, T_len, HQ, KV, causal, window, q_offset, scale * LOG2E);
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
               int window, int q_offset, float scale, cudaStream_t stream) {
#define NK_ARGS q, k, v, o, B, S, T_len, HQ, KV, causal, window, q_offset, \
                scale, stream
  switch (D) {
    case 16:
      return launch_simt<T, 16>(NK_ARGS);
    case 32:
      return launch_simt<T, 32>(NK_ARGS);
    case 64:
      if constexpr (sizeof(T) == 2) return launch_tc<64>(NK_ARGS);
      else return launch_simt<T, 64>(NK_ARGS);
    case 128:
      if constexpr (sizeof(T) == 2) return launch_tc<128>(NK_ARGS);
      else return launch_simt<T, 128>(NK_ARGS);
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
                                     causal, window, q_offset, scale, st);
  if (dtype == nk::DT_F32)
    return dispatch_d<float>(D, q, k, v, o, B, S, T_len, HQ, KV, causal,
                             window, q_offset, scale, st);
  return NK_ERR_DTYPE;
}

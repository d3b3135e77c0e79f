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
// by log-sum-exp. Unlike the TPU kernel it reads the grouped cache
// (B, T, KV, D) directly: one block serves kv head kvh of sequence b and
// all g = HQ / KV query heads that share it, so each cache row is read once
// for the whole group instead of once per query head.
//
// What bounds it on this card: bytes. Per step it must read the live
// prefix t <= pos[b] of the cache (2 * (pos + 1) * KV * D * 2 bytes per
// sequence in bf16) and does ~4 * g flops per cache element, far below the
// ~295 flops per byte where the tensor cores would take over. The design
// streams only the live prefix (the bytes needed, not the padded cache),
// with 16 warps per block each walking every 16th position, four positions
// per iteration so eight row loads are in flight per warp; a lane holds
// D / 32 contiguous elements (one 8-byte load per row in bf16; at D = 16
// half the lanes hold one element and the rest idle). Each warp keeps its
// own online-softmax state in registers; the warps are combined through
// shared memory at the end. KV x B blocks alone would leave most of the
// 132 SMs idle at serving batch sizes (64 blocks at B = 8, KV = 8), so the
// wrapper also splits the sequence into `nsplit` chunks (grid KV x B x
// nsplit): each block writes its chunk's unnormalised partial (acc, m, l)
// and a second, small kernel combines the chunks by log-sum-exp, exactly
// as shards of a cache are combined. A chunk that lies past pos[b] reads
// no cache row.
#include "nk_common.cuh"

namespace {

constexpr int NW = 16;      // warps per block
constexpr int UNROLL = 4;   // positions per warp iteration

// nsplit == gridDim.z. With one split the block writes o, m and l; with
// more it writes its chunk's partial acc (unnormalised), m and l at row
// (b * HQ + h) * nsplit + split of part_acc / part_m / part_l.
template <typename QT, typename KT, int D, int G>
__global__ void __launch_bounds__(NW * 32)
decode_fwd(const QT* __restrict__ q, const KT* __restrict__ k,
           const KT* __restrict__ v, const int* __restrict__ pos,
           QT* __restrict__ o, float* __restrict__ m_out,
           float* __restrict__ l_out, float* __restrict__ part_acc,
           float* __restrict__ part_m, float* __restrict__ part_l, int T_len,
           int HQ, int KV, int window, int kv_len, int chunk, float scale) {
  constexpr int EPL = D >= 32 ? D / 32 : 1;   // elements per lane
  extern __shared__ float smem[];
  float* sm_m = smem;                   // NW x G
  float* sm_l = sm_m + NW * G;          // NW x G
  float* sm_acc = sm_l + NW * G;        // NW x G x D

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool live = lane * EPL < D;   // false only for lanes 16.. at D = 16
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int p = pos[b];
  int last = min(p, kv_len - 1);
  int first = window ? max(0, p - window + 1) : 0;
  if (nsplit > 1) {
    first = max(first, split * chunk);
    last = min(last, split * chunk + chunk - 1);
  }

  float qr[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const QT* qrow = q + ((size_t)b * HQ + kvh * G + j) * D + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[j][e] = live ? nk::to_f<QT>(qrow[e]) : 0.f;
      acc[j][e] = 0.f;
    }
    m[j] = nk::NEG_INF;
    l[j] = 0.f;
  }

  const size_t row = (size_t)KV * D;   // between consecutive positions
  const KT* kb = k + (size_t)b * T_len * row + (size_t)kvh * D + lane * EPL;
  const KT* vb = v + (size_t)b * T_len * row + (size_t)kvh * D + lane * EPL;

  for (int t0 = first + warp * UNROLL; t0 <= last; t0 += NW * UNROLL) {
    float kf[UNROLL][EPL], vf[UNROLL][EPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = min(t0 + u, last);   // clamped rows are skipped below
      if (live) {
        nk::load_row<KT, EPL>(kb + (size_t)t * row, kf[u]);
        nk::load_row<KT, EPL>(vb + (size_t)t * row, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t0 + u > last) break;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qr[j][e], kf[u][e], d);
        const float s = nk::warp_sum(d) * scale;
        const float m_new = fmaxf(m[j], s);
        const float corr = expf(m[j] - m_new);
        const float pj = expf(s - m_new);
        l[j] = l[j] * corr + pj;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[j][e] = fmaf(pj, vf[u][e], acc[j][e] * corr);
        m[j] = m_new;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (lane == 0) {
      sm_m[warp * G + j] = m[j];
      sm_l[warp * G + j] = l[j];
    }
    if (live) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        sm_acc[(warp * G + j) * D + lane * EPL + e] = acc[j][e];
    }
  }
  __syncthreads();

  // log-sum-exp combine of the NW warps' partial stats
  for (int idx = threadIdx.x; idx < G * D; idx += NW * 32) {
    const int j = idx / D, c = idx % D;
    float mx = nk::NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w * G + j]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wt = expf(sm_m[w * G + j] - mx);
      lsum += sm_l[w * G + j] * wt;
      osum += sm_acc[(w * G + j) * D + c] * wt;
    }
    const size_t hrow = (size_t)b * HQ + kvh * G + j;
    if (nsplit == 1) {
      o[hrow * D + c] = nk::from_f<QT>(osum / fmaxf(lsum, 1e-30f));
      if (c == 0) {
        m_out[hrow] = mx;
        l_out[hrow] = lsum;
      }
    } else {
      const size_t prow = hrow * nsplit + split;
      part_acc[prow * D + c] = osum;
      if (c == 0) {
        part_m[prow] = mx;
        part_l[prow] = lsum;
      }
    }
  }
}

// log-sum-exp combine of the nsplit chunk partials: one block per
// (sequence, head) row
template <typename QT>
__global__ void __launch_bounds__(128)
decode_combine(const float* __restrict__ part_acc,
               const float* __restrict__ part_m,
               const float* __restrict__ part_l, QT* __restrict__ o,
               float* __restrict__ m_out, float* __restrict__ l_out, int D,
               int nsplit) {
  const size_t hrow = blockIdx.x;
  const float* pm = part_m + hrow * nsplit;
  const float* pl = part_l + hrow * nsplit;
  float mx = nk::NEG_INF;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pm[s]);
  float lsum = 0.f;
  for (int s = 0; s < nsplit; ++s) lsum += pl[s] * expf(pm[s] - mx);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float osum = 0.f;
    for (int s = 0; s < nsplit; ++s)
      osum += part_acc[(hrow * nsplit + s) * D + c] * expf(pm[s] - mx);
    o[hrow * D + c] = nk::from_f<QT>(osum / fmaxf(lsum, 1e-30f));
  }
  if (threadIdx.x == 0) {
    m_out[hrow] = mx;
    l_out[hrow] = lsum;
  }
}

struct Args {
  const void *q, *k, *v, *pos;
  void *o, *m, *l, *part_acc, *part_m, *part_l;
  int B, T_len, HQ, KV, window, kv_len, nsplit, chunk;
  float scale;
  cudaStream_t stream;
};

template <typename QT, typename KT, int D, int G>
int launch(const Args& a) {
  const size_t smem = (size_t)NW * G * (D + 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_fwd<QT, KT, D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.KV, a.B, a.nsplit);
  decode_fwd<QT, KT, D, G><<<grid, NW * 32, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), static_cast<const int*>(a.pos),
      static_cast<QT*>(a.o), static_cast<float*>(a.m),
      static_cast<float*>(a.l), static_cast<float*>(a.part_acc),
      static_cast<float*>(a.part_m), static_cast<float*>(a.part_l), a.T_len,
      a.HQ, a.KV, a.window, a.kv_len, a.chunk, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return (int)err;
  decode_combine<QT><<<a.B * a.HQ, 128, 0, a.stream>>>(
      static_cast<const float*>(a.part_acc),
      static_cast<const float*>(a.part_m),
      static_cast<const float*>(a.part_l), static_cast<QT*>(a.o),
      static_cast<float*>(a.m), static_cast<float*>(a.l), D, a.nsplit);
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
    NK_G(6)
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
    default:
      return NK_ERR_ARGS;
  }
#undef NK_D
}

}  // namespace

extern "C" int nk_decode_attention(const void* q, const void* k,
                                   const void* v, const void* pos, void* o,
                                   void* m, void* l, void* part_acc,
                                   void* part_m, void* part_l, int B,
                                   int T_len, int HQ, int KV, int D,
                                   int q_dtype, int kv_dtype, int window,
                                   int kv_len, int nsplit, int chunk,
                                   float scale, int device, void* stream) {
  if (B <= 0 || T_len <= 0 || KV <= 0 || HQ % KV != 0 || B > 65535 ||
      KV > 65535 || kv_len <= 0 || kv_len > T_len || window < 0 ||
      nsplit < 1 || nsplit > 65535 || chunk < 1 ||
      (long long)nsplit * chunk < kv_len ||
      (nsplit > 1 && (!part_acc || !part_m || !part_l)))
    return NK_ERR_ARGS;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int G = HQ / KV;
  const Args a{q,      k,      v,      pos,    o,      m,   l,
               part_acc, part_m, part_l, B,    T_len,  HQ,  KV,
               window, kv_len, nsplit, chunk,  scale,
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
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blockwise symmetric int8 codec for Hopper (sm_90a): one f32 scale per
// (row, block of `block` columns), block 128 or 256; f32 or bf16 in and out.
//
// Replaces the Pallas TPU kernels repro/kernels/quant_comm.py
// (quantize_int8, body _quant_kernel; dequantize_int8, body
// _dequant_kernel). Same function, to the bit, as the reference computes it
// under jit:
//   absmax = max |x| over the block, in f32;
//   scale  = fmaxf(absmax, 1e-30) * float32(1/127)   (XLA turns the
//            reference's division by the constant 127 into this multiply;
//            a true division differs in the last bit for ~5% of absmax);
//   q      = clamp(rint(x / scale), -127, 127): IEEE division (__fdiv_rn,
//            not a multiply by 1/scale) and round half to even (rintf, not
//            roundf);
//   x_hat  = (float)q * scale in f32, then rounded to nearest even into the
//            output dtype.
// The reference pads rows up to its row block; nothing here needs padding.
//
// What bounds it on this card: bytes. Each element is read once and its
// code written once; per block one f32 scale: quantize moves
// R*C*(in_bytes + 1) + 4*R*C/block bytes, dequantize
// R*C*(1 + out_bytes) + 4*R*C/block, at 3.35 TB/s; the arithmetic (a few
// operations per element) is far below the card's rate. The design keeps
// each block in registers for one pass: one warp per (row, block), each
// lane holding block/32 consecutive elements loaded with 16-byte (or
// 8-byte) vector loads, so a warp reads one contiguous run of the row; the
// absmax is a warp-shuffle reduction; each lane stores its codes as one 8-
// (or 4-) byte store and lane 0 the scale. No shared memory, no atomics,
// no second pass.
#include "nk_common.cuh"

namespace {

constexpr int WARPS = 8;                     // warps per 256-thread block
constexpr float INV_127 = 0x1.020408p-7f;    // float32(1/127), exactly

// N consecutive elements at p (aligned to their size) widened to float
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* v) {
  if constexpr (sizeof(T) == 2) {
    if constexpr (N == 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(p);
      const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      v[i] = f.x;
      v[i + 1] = f.y;
      v[i + 2] = f.z;
      v[i + 3] = f.w;
    }
  }
}

// N floats rounded into T and stored at p (aligned to their size)
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* v) {
  if constexpr (sizeof(T) == 2) {
    uint32_t w[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      w[i] = nk::pack_bf16(v[2 * i], v[2 * i + 1]);
    if constexpr (N == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// One warp per (row, block): the warp's index w is row * nblk + block, so
// the scales (R, nblk) are written at w and the block's elements start at
// row * cols + block * (32 * EPL).
template <typename T, int EPL>
__global__ void __launch_bounds__(WARPS * 32)
    quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ scales, long n_warps, int cols,
                 int nblk) {
  const long w = static_cast<long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (w >= n_warps) return;  // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  const long off = (w / nblk) * cols + (w % nblk) * (32L * EPL) + lane * EPL;
  float v[EPL];
  load_vec<T, EPL>(x + off, v);
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < EPL; ++i) m = fmaxf(m, fabsf(v[i]));
  m = nk::warp_max(m);
  const float scale = fmaxf(m, 1e-30f) * INV_127;
  uint32_t packed[EPL / 4] = {};
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const float r = rintf(__fdiv_rn(v[i], scale));
    const int code = static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f));
    packed[i / 4] |= (static_cast<uint32_t>(code) & 0xffu) << (8 * (i % 4));
  }
  if constexpr (EPL == 8) {
    *reinterpret_cast<uint2*>(q + off) = make_uint2(packed[0], packed[1]);
  } else {
    *reinterpret_cast<uint32_t*>(q + off) = packed[0];
  }
  if (lane == 0) scales[w] = scale;
}

template <typename T, int EPL>
__global__ void __launch_bounds__(WARPS * 32)
    dequant_kernel(const int8_t* __restrict__ q,
                   const float* __restrict__ scales, T* __restrict__ out,
                   long n_warps, int cols, int nblk) {
  const long w = static_cast<long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (w >= n_warps) return;
  const int lane = threadIdx.x % 32;
  const long off = (w / nblk) * cols + (w % nblk) * (32L * EPL) + lane * EPL;
  uint32_t packed[EPL / 4];
  if constexpr (EPL == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(q + off);
    packed[0] = raw.x;
    packed[1] = raw.y;
  } else {
    packed[0] = *reinterpret_cast<const uint32_t*>(q + off);
  }
  const float scale = scales[w];
  float v[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int8_t code =
        static_cast<int8_t>((packed[i / 4] >> (8 * (i % 4))) & 0xffu);
    v[i] = static_cast<float>(code) * scale;
  }
  store_vec<T, EPL>(out + off, v);
}

template <typename T, int EPL>
int launch_quant(const void* x, void* q, void* s, long rows, int cols,
                 cudaStream_t stream) {
  const int nblk = cols / (32 * EPL);
  const long n_warps = rows * nblk;
  const long grid = (n_warps + WARPS - 1) / WARPS;
  quant_kernel<T, EPL><<<static_cast<unsigned>(grid), WARPS * 32, 0,
                         stream>>>(static_cast<const T*>(x),
                                   static_cast<int8_t*>(q),
                                   static_cast<float*>(s), n_warps, cols,
                                   nblk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int EPL>
int launch_dequant(const void* q, const void* s, void* out, long rows,
                   int cols, cudaStream_t stream) {
  const int nblk = cols / (32 * EPL);
  const long n_warps = rows * nblk;
  const long grid = (n_warps + WARPS - 1) / WARPS;
  dequant_kernel<T, EPL><<<static_cast<unsigned>(grid), WARPS * 32, 0,
                           stream>>>(static_cast<const int8_t*>(q),
                                     static_cast<const float*>(s),
                                     static_cast<T*>(out), n_warps, cols,
                                     nblk);
  return static_cast<int>(cudaGetLastError());
}

// rows * nblk warps must fit the grid: (2^31 - 1) blocks of WARPS warps
bool shape_ok(long rows, int cols, int block) {
  if (rows <= 0 || cols <= 0 || (block != 128 && block != 256) ||
      cols % block)
    return false;
  const long n_warps = rows * (cols / block);
  return (n_warps + WARPS - 1) / WARPS <= 2147483647L;
}

}  // namespace

// x (rows, cols) f32 or bf16 -> q int8 (rows, cols), scales f32
// (rows, cols / block). All pointers 16-byte aligned, contiguous.
extern "C" int nk_quantize_int8(const void* x, void* q, void* scales,
                                long rows, int cols, int block, int dtype,
                                int device, void* stream) {
  if (!x || !q || !scales || !shape_ok(rows, cols, block)) return NK_ERR_ARGS;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == nk::DT_BF16)
    return block == 256 ? launch_quant<__nv_bfloat16, 8>(x, q, scales, rows,
                                                         cols, st)
                        : launch_quant<__nv_bfloat16, 4>(x, q, scales, rows,
                                                         cols, st);
  if (dtype == nk::DT_F32)
    return block == 256
               ? launch_quant<float, 8>(x, q, scales, rows, cols, st)
               : launch_quant<float, 4>(x, q, scales, rows, cols, st);
  return NK_ERR_DTYPE;
}

// q int8 (rows, cols), scales f32 (rows, cols / block) -> out (rows, cols)
// f32 or bf16 (`dtype`). All pointers 16-byte aligned, contiguous.
extern "C" int nk_dequantize_int8(const void* q, const void* scales,
                                  void* out, long rows, int cols, int block,
                                  int dtype, int device, void* stream) {
  if (!q || !scales || !out || !shape_ok(rows, cols, block))
    return NK_ERR_ARGS;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == nk::DT_BF16)
    return block == 256 ? launch_dequant<__nv_bfloat16, 8>(q, scales, out,
                                                           rows, cols, st)
                        : launch_dequant<__nv_bfloat16, 4>(q, scales, out,
                                                           rows, cols, st);
  if (dtype == nk::DT_F32)
    return block == 256
               ? launch_dequant<float, 8>(q, scales, out, rows, cols, st)
               : launch_dequant<float, 4>(q, scales, out, rows, cols, st);
  return NK_ERR_DTYPE;
}

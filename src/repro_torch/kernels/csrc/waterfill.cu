// Weighted max-min water-fill by fixed-iteration bisection, for Hopper
// (sm_90a), in f64 (what the control plane runs) and f32.
//
// Replaces the Pallas TPU kernel repro/kernels/waterfill.py
// (water_fill_pallas, body _waterfill_kernel). Same function: slots with
// d <= 0 or w <= 0 are parked (allocation 0); the rest have ratio
// r = d / w (inf demand = greedy). S(L) = sum w * min(r, L) is bisected
// for `iters` steps on [0, cap / max(min_w, 1e-30)] (lo stays at or under
// the capacity, hi over it); a slot with r <= hi takes its demand d, the
// rest w * hi. Outputs the allocations and the final level hi.
//
// What bounds it on this card: neither bytes nor operations, but latency.
// The least work is reading d and w once and writing the allocations once
// (24 B per slot in f64: 7 us at 1M slots at 3.35 TB/s) and ~3 flops per
// slot per iteration; the 48 iterations, however, are dependent global
// sums, each of which must finish everywhere before the next level is
// known. The design keeps every slot's (r, w) in registers across all
// iterations (K slots per thread, K a compile-time power of two), so an
// iteration reads no memory:
//   * n <= 256 * 32: one block of 256 threads; an iteration is a register
//     pass plus a block reduction (warp shuffles, then the 8 warp sums).
//   * larger n: a cooperative launch of at most one block per SM; each
//     block reduces its slice and writes one partial, grid.sync(), and
//     every block sums all partials itself, in the same fixed order, so
//     all blocks take the same branch. Partials are double-buffered, so
//     one grid barrier per iteration suffices.
//   * n > 132 * 256 * 32 (no register fit): the same cooperative loop, but
//     each iteration streams d and w from memory (L2-resident up to a few
//     million slots).
// No floating-point atomics: the sum's order is fixed by the slot layout,
// so two calls on the same input give bit-identical results.
#include <cooperative_groups.h>

#include "nk_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BLOCK = 256;
constexpr int NWARP = BLOCK / 32;
constexpr int KMAX = 32;   // slots per thread held in registers, at most

template <typename T>
__device__ __forceinline__ T min_of(T a, T b) { return b < a ? b : a; }

template <typename T, bool MIN>
__device__ __forceinline__ T combine(T a, T b) {
  return MIN ? min_of(a, b) : a + b;
}

// Butterfly over the warp: every lane ends with the same, fixed-order
// result (each step combines two identical pairs commutatively).
template <typename T, bool MIN>
__device__ __forceinline__ T warp_reduce(T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = combine<T, MIN>(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Every thread of the block gets the block's reduction of v.
template <typename T, bool MIN>
__device__ T block_reduce(T v, T ident, T* sm) {
  v = warp_reduce<T, MIN>(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) sm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T x = lane < NWARP ? sm[lane] : ident;
    x = warp_reduce<T, MIN>(x);
    if (lane == 0) sm[NWARP] = x;
  }
  __syncthreads();
  const T out = sm[NWARP];
  __syncthreads();
  return out;
}

// After a grid barrier: every block reduces the nb block partials in one
// fixed order (lane l takes l, l + 32, ...; then the butterfly), so every
// block computes the same value. __ldcg reads L2, never a stale L1 line.
template <typename T, bool MIN>
__device__ T grid_reduce(const T* part, int nb, T ident, T* sm) {
  if (threadIdx.x < 32) {
    T x = ident;
    for (int i = threadIdx.x; i < nb; i += 32)
      x = combine<T, MIN>(x, __ldcg(part + i));
    x = warp_reduce<T, MIN>(x);
    if (threadIdx.x == 0) sm[NWARP] = x;
  }
  __syncthreads();
  const T out = sm[NWARP];
  __syncthreads();
  return out;
}

// One slot: parked slots read as (r, w) = (0, 0) and add 0 to every sum.
template <typename T>
__device__ __forceinline__ void load_slot(const T* __restrict__ d,
                                          const T* __restrict__ w, long i,
                                          long n, T& r, T& wa) {
  const T di = i < n ? d[i] : T(0);
  const T wi = i < n ? w[i] : T(0);
  const bool act = di > T(0) && wi > T(0);
  wa = act ? wi : T(0);
  r = act ? di / wi : T(0);
}

// K > 0: block b holds slots [b*K*BLOCK, (b+1)*K*BLOCK) in registers,
// thread t the slots b*K*BLOCK + j*BLOCK + t (coalesced loads). K == 0:
// grid-stride over all n, re-read every iteration. GRID: several blocks,
// cooperative launch, partials in part[0, 2*nb).
template <typename T, int K, bool GRID>
__global__ void __launch_bounds__(BLOCK)
waterfill_kernel(const T* __restrict__ d, const T* __restrict__ w,
                 const T* __restrict__ cap_p, T* __restrict__ alloc,
                 T* __restrict__ level, T* __restrict__ part, long n,
                 int iters) {
  __shared__ T sm[NWARP + 1];
  const T inf = static_cast<T>(INFINITY);
  const int nb = gridDim.x;
  const long stride = (long)nb * BLOCK;
  constexpr int KR = K > 0 ? K : 1;
  T rr[KR], ww[KR];
  const long base = (long)blockIdx.x * KR * BLOCK + threadIdx.x;

  T wmin = inf;
  if constexpr (K > 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      load_slot(d, w, base + (long)j * BLOCK, n, rr[j], ww[j]);
      if (ww[j] > T(0)) wmin = min_of(wmin, ww[j]);
    }
  } else {
    for (long i = (long)blockIdx.x * BLOCK + threadIdx.x; i < n;
         i += stride) {
      T r, wa;
      load_slot(d, w, i, n, r, wa);
      if (wa > T(0)) wmin = min_of(wmin, wa);
    }
  }
  wmin = block_reduce<T, true>(wmin, inf, sm);
  if constexpr (GRID) {
    if (threadIdx.x == 0) part[blockIdx.x] = wmin;
    cg::this_grid().sync();
    wmin = grid_reduce<T, true>(part, nb, inf, sm);
  }
  const T cap = *cap_p;
  // cap / min_w bounds the level from above: a slot with a larger ratio
  // would alone take the whole capacity
  T lo = T(0);
  T hi = wmin < inf ? cap / (wmin > T(1e-30) ? wmin : T(1e-30)) : T(0);

  for (int it = 0; it < iters; ++it) {
    const T mid = T(0.5) * (lo + hi);
    T s = T(0);
    if constexpr (K > 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) s += ww[j] * min_of(rr[j], mid);
    } else {
      for (long i = (long)blockIdx.x * BLOCK + threadIdx.x; i < n;
           i += stride) {
        T r, wa;
        load_slot(d, w, i, n, r, wa);
        s += wa * min_of(r, mid);
      }
    }
    s = block_reduce<T, false>(s, T(0), sm);
    if constexpr (GRID) {
      // iteration k writes buffer (k + 1) & 1; the min above used buffer 0
      T* buf = part + ((it + 1) & 1) * nb;
      if (threadIdx.x == 0) buf[blockIdx.x] = s;
      cg::this_grid().sync();
      s = grid_reduce<T, false>(buf, nb, T(0), sm);
    }
    const bool over = s > cap;
    lo = over ? lo : mid;
    hi = over ? mid : hi;
  }

  if constexpr (K > 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const long i = base + (long)j * BLOCK;
      if (i < n)
        alloc[i] = ww[j] > T(0) ? (rr[j] <= hi ? d[i] : ww[j] * hi) : T(0);
    }
  } else {
    for (long i = (long)blockIdx.x * BLOCK + threadIdx.x; i < n;
         i += stride) {
      T r, wa;
      load_slot(d, w, i, n, r, wa);
      alloc[i] = wa > T(0) ? (r <= hi ? d[i] : wa * hi) : T(0);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *level = hi;
}

struct Args {
  const void* d;
  const void* w;
  const void* cap;
  void* alloc;
  void* level;
  void* part;
  long n;
  int iters;
  long part_len;
  int device;
  cudaStream_t stream;
};

template <typename T, int K>
int launch_single(const Args& a) {
  waterfill_kernel<T, K, false><<<1, BLOCK, 0, a.stream>>>(
      static_cast<const T*>(a.d), static_cast<const T*>(a.w),
      static_cast<const T*>(a.cap), static_cast<T*>(a.alloc),
      static_cast<T*>(a.level), static_cast<T*>(a.part), a.n, a.iters);
  return (int)cudaGetLastError();
}

// Cooperative launch of `blocks` blocks (the caller checked they fit).
template <typename T, int K>
int launch_grid(const Args& a, int blocks) {
  if (2L * blocks > a.part_len) return NK_ERR_ARGS;
  const T* d = static_cast<const T*>(a.d);
  const T* w = static_cast<const T*>(a.w);
  const T* cap = static_cast<const T*>(a.cap);
  T* alloc = static_cast<T*>(a.alloc);
  T* level = static_cast<T*>(a.level);
  T* part = static_cast<T*>(a.part);
  long n = a.n;
  int iters = a.iters;
  void* params[] = {&d, &w, &cap, &alloc, &level, &part, &n, &iters};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)waterfill_kernel<T, K, true>, dim3(blocks), dim3(BLOCK),
      params, 0, a.stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks of waterfill_kernel<T, K, true> that can be resident at once.
template <typename T, int K>
int resident_blocks(int sms) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, waterfill_kernel<T, K, true>, BLOCK, 0) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

// The smallest K whose blocks (at most one per SM) hold all n slots in
// registers; else the streaming variant on every resident block.
template <typename T, int K>
int try_grid(const Args& a, int sms) {
  const long per_block = (long)K * BLOCK;
  const long blocks = (a.n + per_block - 1) / per_block;
  if (blocks <= sms && blocks <= resident_blocks<T, K>(sms))
    return launch_grid<T, K>(a, (int)blocks);
  if constexpr (K < KMAX) {
    return try_grid<T, 2 * K>(a, sms);
  } else {
    const int all = resident_blocks<T, 0>(sms);
    if (all <= 0) return NK_ERR_ARGS;
    return launch_grid<T, 0>(a, all);
  }
}

template <typename T>
int dispatch(const Args& a) {
  if (a.n <= (long)KMAX * BLOCK) {
    const long k = (a.n + BLOCK - 1) / BLOCK;
    if (k <= 1) return launch_single<T, 1>(a);
    if (k <= 2) return launch_single<T, 2>(a);
    if (k <= 4) return launch_single<T, 4>(a);
    if (k <= 8) return launch_single<T, 8>(a);
    if (k <= 16) return launch_single<T, 16>(a);
    return launch_single<T, 32>(a);
  }
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, a.device);
  if (err != cudaSuccess) return (int)err;
  return try_grid<T, 1>(a, sms);
}

}  // namespace

// d, w, alloc: (n,) of one dtype; cap: one element of it on the device;
// level: one element (written); part: part_len elements of scratch.
extern "C" int nk_water_fill(const void* d, const void* w, const void* cap,
                             void* alloc, void* level, void* part, long n,
                             int iters, long part_len, int dtype, int device,
                             void* stream) {
  if (n <= 0 || iters < 0 || !d || !w || !cap || !alloc || !level || !part)
    return NK_ERR_ARGS;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{d, w, cap, alloc, level, part, n, iters, part_len, device,
               static_cast<cudaStream_t>(stream)};
  if (dtype == nk::DT_F64) return dispatch<double>(a);
  if (dtype == nk::DT_F32) return dispatch<float>(a);
  return NK_ERR_DTYPE;
}

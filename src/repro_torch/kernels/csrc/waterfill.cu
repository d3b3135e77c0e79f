// Weighted max-min water-fill by fixed-iteration bisection, for Hopper
// (sm_90a), in f64 (what the control plane runs) and f32.
//
// Replaces the Pallas TPU kernel repro/kernels/waterfill.py
// (water_fill_pallas, body _waterfill_kernel). Same function: slots with
// d <= 0 or w <= 0 are parked (allocation 0); the rest have ratio
// r = d / w (inf demand = greedy). S(L) = sum w * min(r, L) is bisected
// for `iters` steps on [0, cap / max(min_w, 1e-30)]: each step takes
// mid = 0.5 * (lo + hi) and moves hi to mid if S(mid) > cap, else lo. A
// slot with r <= hi then takes its demand d, the rest w * hi. Outputs the
// allocations and the final level hi.
//
// What bounds it on this card: neither bytes nor operations, but latency.
// The least work is reading d and w once and writing the allocations once
// (24 B per slot in f64: 7 us at 1M slots at 3.35 TB/s), yet the steps
// depend on each other: each needs a sum over every slot, finished
// everywhere, before the next mid is known. One reduction per step (a
// block reduction, and above one block a grid barrier too) made the
// parent kernel's time.
//
// The design keeps the function and changes the schedule. From (lo, hi),
// the next B steps can only visit the 2^B - 1 nodes of a binary tree:
// node 0 is the root, node i's children are 2i+1 (S was over the capacity,
// so hi moved) and 2i+2 (it was not). Each node's mid is 0.5 * (lo' + hi')
// of its own bracket, the serial loop's operations on the serial loop's
// values (tree_mids). A pass evaluates S at every node in one sweep over
// the slots held in registers and reduces all 2^B - 1 sums at once; the
// nodes' `over` bits (a ballot) give the path, and the step at its last
// node moves that node's bracket as the serial loop would (take_steps).
// With the same sums this gives, bit for bit, the (lo, hi) of B serial
// steps, so `iters` steps take ceil(iters / B) reductions; the last pass
// takes only the iters mod B steps that remain. The price is 2^B - 1
// times the arithmetic a pass, cheap while the slots sit in registers.
// Every slot's loads are issued before any of its divisions. Launches,
// one a call, by size:
//   * n <= 32: one warp. Every lane holds all n slots and evaluates one
//     node of a depth-5 tree (31 nodes): a pass has no reduction and no
//     barrier, only a ballot.
//   * n <= 256 * 32: one block of 256 threads, K slots a thread (K a
//     compile-time power of two). A pass: every thread sums its slots at
//     every node; a transposed warp reduction leaves lane l with the
//     warp's sum of node l; one __syncthreads, then every warp adds the 8
//     warp sums in the same order and takes the ballot itself. At K >= 16
//     the block is bound by its arithmetic and a pass is one step.
//   * larger n: a cooperative launch of at most one block per SM (only
//     where every block is resident). After one grid barrier for min_w,
//     a pass takes no barrier: each block publishes its node sums in its
//     slots of the pass's buffer (three in turn), and every block polls
//     all blocks' slots until none holds the "empty" pattern, then adds
//     them in one fixed order, so all blocks take the same walk. A
//     block's published value is the whole message, so a wait is one trip
//     to L2 after it lands, not a barrier's arrive, poll and fence.
//   * n > 132 * 256 * 32 (no register fit): the same cooperative loop, but
//     each pass streams d and w from memory (L2-resident up to a few
//     million slots): ceil(iters / B) reads of them, not iters.
// No floating-point atomics: every sum's order is fixed by the slot
// layout, so two calls on the same input give bit-identical results.
#include <cooperative_groups.h>

#include "nk_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BLOCK = 256;
constexpr int NWARP = BLOCK / 32;
constexpr int KMAX = 32;          // slots per thread held in registers
constexpr int WARP_SLOTS = 32;    // n at or under this: the one-warp kernel
constexpr int WARP_DEPTH = 5;     // its tree: 31 nodes, one a lane
constexpr int NODE_PAD = 32;      // node sums a block publishes, at most
constexpr int SMS_HINT = 132;     // an H100's SMs: one batch of partial
                                  // loads covers a grid of that many blocks

// Depth of the tree a pass evaluates, by slots a thread holds (0: the
// streaming variant) and launch kind, as timed on an H100 (PERF.md). A
// deeper tree saves passes (and waits for other blocks) but costs 2^B - 1
// node sums per slot and pass. One block holding 16 or 32 slots a thread
// is bound by that arithmetic on its one SM: there a pass is one step,
// the serial loop's schedule.
__host__ __device__ constexpr int pass_depth(int k, bool grid) {
  if (grid) return k == 0 ? 4 : (k <= 2 ? 5 : (k <= 8 ? 4 : 3));
  return k <= 2 ? 4 : (k <= 8 ? 3 : 1);
}

template <typename T>
__device__ __forceinline__ T min_of(T a, T b) { return b < a ? b : a; }

template <typename T, bool MIN>
__device__ __forceinline__ T combine(T a, T b) {
  return MIN ? min_of(a, b) : a + b;
}

// Slots i0, i0 + step, ... (U of them) as (r, w); parked slots read as
// (0, 0) and add 0 to every sum. Every load is issued before any ratio is
// computed: a division's branches would otherwise hold each load back
// until the previous slot's ratio is done.
template <typename T, int U>
__device__ __forceinline__ void load_slots(const T* __restrict__ d,
                                           const T* __restrict__ w, long i0,
                                           long step, long n, T (&r)[U],
                                           T (&wa)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long i = i0 + u * step;
    r[u] = i < n ? d[i] : T(0);
    wa[u] = i < n ? w[i] : T(0);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool act = r[u] > T(0) && wa[u] > T(0);
    r[u] = act ? r[u] / wa[u] : T(0);
    wa[u] = act ? wa[u] : T(0);
  }
}

// The allocations of the slots load_slots gave: the demand (read again,
// every load first) where r <= hi, else w * hi; parked slots 0.
template <typename T, int U>
__device__ __forceinline__ void store_slots(const T* __restrict__ d,
                                            T* __restrict__ alloc, long i0,
                                            long step, long n,
                                            const T (&r)[U],
                                            const T (&wa)[U], T hi) {
  T dv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long i = i0 + u * step;
    dv[u] = i < n ? d[i] : T(0);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long i = i0 + u * step;
    if (i < n)
      alloc[i] = wa[u] > T(0) ? (r[u] <= hi ? dv[u] : wa[u] * hi) : T(0);
  }
}

template <typename T>
__device__ __forceinline__ T top_level(T wmin, T cap) {
  // cap / min_w bounds the level from above: a slot with a larger ratio
  // would alone take the whole capacity
  const T inf = static_cast<T>(INFINITY);
  return wmin < inf ? cap / (wmin > T(1e-30) ? wmin : T(1e-30)) : T(0);
}

// The mids of the 2^B - 1 nodes under (lo, hi), in heap order, each
// computed as the serial loop computes it on reaching that node.
template <typename T, int B>
__device__ __forceinline__ void tree_mids(T lo, T hi, T (&m)[(1 << B) - 1]) {
  constexpr int NN = (1 << B) - 1;
  T l[NN], h[NN];
#pragma unroll
  for (int i = 0; i < NN; ++i) {
    if (i == 0) {
      l[0] = lo;
      h[0] = hi;
    } else if (i & 1) {         // left child: the parent was over
      l[i] = l[(i - 1) / 2];
      h[i] = m[(i - 1) / 2];
    } else {
      l[i] = m[(i - 1) / 2];
      h[i] = h[(i - 1) / 2];
    }
    m[i] = T(0.5) * (l[i] + h[i]);
  }
}

// The bracket (l, u) the serial loop holds on reaching node `node` (heap
// order, depth < B) of the tree under (lo, hi): the bits of node + 1 under
// its leading one are the path, 0 for a left child.
template <typename T, int B>
__device__ __forceinline__ void node_bracket(T lo, T hi, int node, T& l,
                                             T& u) {
  const int h = node + 1;
  const int depth = 31 - __clz(h);
  l = lo;
  u = hi;
#pragma unroll
  for (int k = B - 2; k >= 0; --k) {
    if (k < depth) {
      const T m = T(0.5) * (l + u);
      if ((h >> k) & 1)
        l = m;
      else
        u = m;
    }
  }
}

// The node at which a walk of `steps` (>= 1) serial steps from the root
// takes its last step, following the nodes' over bits (bit i: node i's sum
// was over the capacity, go left to 2i+1; else right to 2i+2).
__device__ __forceinline__ int last_node(unsigned mask, int steps) {
  int i = 0;
  for (int s = 1; s < steps; ++s) i = 2 * i + 2 - (int)((mask >> i) & 1u);
  return i;
}

// `steps` serial steps at once: lane l < 2^B - 1 holds node l's bracket
// (l_, u_) and over bit; the step at the last node visited moves its
// bracket exactly as the serial loop would, and every lane takes that
// lane's result. Each mid is 0.5 * (lo + hi) of the bracket reached, so
// (lo, hi) is bit for bit the serial loop's with the same sums.
template <typename T>
__device__ __forceinline__ void take_steps(unsigned mask, int steps, T l_,
                                           T u_, bool over, T& lo, T& hi) {
  const T mid = T(0.5) * (l_ + u_);
  const T nlo = over ? l_ : mid;
  const T nhi = over ? mid : u_;
  const int last = last_node(mask, steps);
  lo = __shfl_sync(FULL, nlo, last);
  hi = __shfl_sync(FULL, nhi, last);
}

// Pairwise reduction of u[0..N) in a fixed order.
template <typename T, int N, bool MIN>
__device__ __forceinline__ T tree_reduce(T (&u)[N]) {
#pragma unroll
  for (int w = 1; w < N; w <<= 1)
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w)
      u[i] = combine<T, MIN>(u[i], u[i + w]);
  return u[0];
}

// n <= WARP_SLOTS: one warp, every lane holding all slots (K >= n, the
// rest parked), lane l evaluating node l of a depth-5 tree.
template <typename T, int K>
__global__ void __launch_bounds__(32)
waterfill_warp(const T* __restrict__ d, const T* __restrict__ w,
               const T* __restrict__ cap_p, T* __restrict__ alloc,
               T* __restrict__ level, long n, int iters) {
  constexpr int NN = (1 << WARP_DEPTH) - 1;
  constexpr int ACC = 4;           // independent partial sums, K % 4 == 0
  static_assert(K % ACC == 0, "K is a multiple of the partial sums");
  const int lane = threadIdx.x;
  const T cap = *cap_p;
  T rr[K], ww[K];
  load_slots(d, w, 0, 1, n, rr, ww);
  T r_own[1], w_own[1];            // this lane's own slot, for its output
  load_slots(d, w, lane, 1, n, r_own, w_own);
  T wmin = static_cast<T>(INFINITY);
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (ww[j] > T(0)) wmin = min_of(wmin, ww[j]);
  T lo = T(0);
  T hi = top_level(wmin, cap);
  for (int done = 0; done < iters; done += WARP_DEPTH) {
    T l_, u_;
    node_bracket<T, WARP_DEPTH>(lo, hi, lane, l_, u_);
    const T mid = T(0.5) * (l_ + u_);
    T acc[ACC];
#pragma unroll
    for (int a = 0; a < ACC; ++a) acc[a] = T(0);
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j % ACC] += ww[j] * min_of(rr[j], mid);
    const bool over = tree_reduce<T, ACC, false>(acc) > cap;
    const unsigned mask = __ballot_sync(FULL, lane < NN && over);
    take_steps(mask, min(WARP_DEPTH, iters - done), l_, u_, over, lo, hi);
  }
  store_slots(d, alloc, lane, 1, n, r_own, w_own, hi);
  if (lane == 0) *level = hi;
}

// Steps HALF, HALF/2, ..., 1 of warp_transpose.
template <typename T, int NP, int HALF, bool MIN>
__device__ __forceinline__ void transpose_steps(T (&v)[NP], int lane) {
  if constexpr (HALF >= 1) {
    const bool upper = lane & HALF;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const T keep = upper ? v[i + HALF] : v[i];
      const T send = upper ? v[i] : v[i + HALF];
      v[i] = combine<T, MIN>(keep, __shfl_xor_sync(FULL, send, HALF));
    }
    transpose_steps<T, NP, HALF / 2, MIN>(v, lane);
  }
}

// The butterfly over the lanes that share lane % NP: each pair combines
// the same two values, so both get the same bits.
template <typename T, int NP, bool MIN>
__device__ __forceinline__ T across_groups(T x) {
#pragma unroll
  for (int off = NP; off < 32; off <<= 1)
    x = combine<T, MIN>(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// The warp's reduction of v[0..NP) per item, transposed: lane l ends with
// item l % NP's result (NP - 1 shuffles, then the butterfly over the
// groups of NP lanes). Every step is a fixed pairing, so the order is
// fixed.
template <typename T, int NP, bool MIN>
__device__ __forceinline__ T warp_transpose(T (&v)[NP]) {
  transpose_steps<T, NP, NP / 2, MIN>(v, threadIdx.x & 31);
  return across_groups<T, NP, MIN>(v[0]);
}

// Item `item` of the NWARP rows of NWARP x 32 values at p, in a fixed order.
template <typename T, bool MIN>
__device__ __forceinline__ T sum_rows(const T* p, int item) {
  T u[NWARP];
#pragma unroll
  for (int k = 0; k < NWARP; ++k) u[k] = p[k * 32 + item];
  return tree_reduce<T, NWARP, MIN>(u);
}

// Every thread gets item (lane % NP) of the block's reduction of all its
// threads' v. red: NWARP * 32 elements, used again two calls later, after
// a barrier that every warp passes only once it has read it.
template <typename T, int NP, bool MIN>
__device__ __forceinline__ T block_reduce(T (&v)[NP], T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T x = warp_transpose<T, NP, MIN>(v);
  if (lane < NP) red[warp * 32 + lane] = x;
  __syncthreads();
  return sum_rows<T, MIN>(red, lane % NP);
}

// Relaxed loads and stores at gpu scope: they go to L2, where every SM
// sees them.
__device__ __forceinline__ void st_gpu(double* p, double v) {
  asm volatile("st.relaxed.gpu.global.f64 [%0], %1;" ::"l"(p), "d"(v)
               : "memory");
}
__device__ __forceinline__ void st_gpu(float* p, float v) {
  asm volatile("st.relaxed.gpu.global.f32 [%0], %1;" ::"l"(p), "f"(v)
               : "memory");
}
__device__ __forceinline__ double ld_gpu(const double* p) {
  double v;
  asm volatile("ld.relaxed.gpu.global.f64 %0, [%1];" : "=d"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ float ld_gpu(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];" : "=f"(v) : "l"(p)
               : "memory");
  return v;
}

// "Not published yet": a signalling-NaN pattern, which no arithmetic
// produces (a sum or a minimum here is a number, +inf or a quiet NaN).
__device__ __forceinline__ double empty_slot(double) {
  return __longlong_as_double(0x7ff0deadbeef0001ll);
}
__device__ __forceinline__ float empty_slot(float) {
  return __int_as_float(0x7fa0beef);
}
__device__ __forceinline__ bool is_empty(double v) {
  return __double_as_longlong(v) == 0x7ff0deadbeef0001ll;
}
__device__ __forceinline__ bool is_empty(float v) {
  return __float_as_int(v) == 0x7fa0beef;
}

// Spins before a wait for another block is taken for a fault: every block
// is resident (a cooperative launch), so a published value lands within
// microseconds; seconds of polling mean it never will, and the kernel
// traps rather than hang.
constexpr unsigned SPIN_LIMIT = 1u << 24;

// After the block results are out: every block reduces item (lane % NP)
// of all nb blocks' results, thread t taking blocks g, g + G, ... (g =
// t / NP) a batch of loads at a time, in one fixed order, so all blocks
// get the same bits. Slot (b, i) is at p[b * stride + i]. POLL: reload
// each slot until it is not empty_slot (it is written by its block once
// that block's result is known); else the slots were written before a
// grid barrier. gr: NWARP * 32 elements.
template <typename T, int NP, bool MIN, bool POLL>
__device__ __forceinline__ T grid_gather(const T* p, int stride, T ident,
                                         T* gr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = gridDim.x;
  const int item = lane % NP;
  constexpr int G = BLOCK / NP;
  constexpr int BATCH = (SMS_HINT + G - 1) / G;
  const int g = threadIdx.x / NP;
  T acc = ident;
  for (int b0 = g; b0 < nb; b0 += BATCH * G) {
    T u[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int b = b0 + k * G;
      u[k] = b < nb ? (POLL ? ld_gpu(p + (long)b * stride + item)
                            : __ldcg(p + (long)b * stride + item))
                    : ident;
    }
    if constexpr (POLL) {
      for (unsigned spins = 0;; ++spins) {
        bool missing = false;
#pragma unroll
        for (int k = 0; k < BATCH; ++k) missing |= is_empty(u[k]);
        if (!missing) break;
        if (spins == SPIN_LIMIT) __trap();
#pragma unroll
        for (int k = 0; k < BATCH; ++k)
          if (is_empty(u[k]))
            u[k] = ld_gpu(p + (long)(b0 + k * G) * stride + item);
      }
    }
    acc = combine<T, MIN>(acc, tree_reduce<T, BATCH, MIN>(u));
  }
  acc = across_groups<T, NP, MIN>(acc);
  if (lane < NP) gr[warp * 32 + lane] = acc;
  __syncthreads();
  return sum_rows<T, MIN>(gr, item);
}

// K > 0: block b holds slots [b*K*BLOCK, (b+1)*K*BLOCK) in registers,
// thread t the slots b*K*BLOCK + j*BLOCK + t (coalesced loads). K == 0:
// grid-stride over all n, re-read every pass. GRID: cooperative launch,
// scratch in part[0, part_len), at least (3 * NODE_PAD + 1) * nb.
template <typename T, int K, bool GRID>
__global__ void __launch_bounds__(BLOCK, 1)
waterfill_kernel(const T* __restrict__ d, const T* __restrict__ w,
                 const T* __restrict__ cap_p, T* __restrict__ alloc,
                 T* __restrict__ level, T* __restrict__ part, long n,
                 int iters, long part_len) {
  constexpr int B = pass_depth(K, GRID);
  constexpr int NN = (1 << B) - 1;
  constexpr int NP = 1 << B;
  static_assert(NP <= NODE_PAD, "a pass publishes at most NODE_PAD sums");
  __shared__ T sm[3 * NWARP * 32];
  const T inf = static_cast<T>(INFINITY);
  const int lane = threadIdx.x & 31;
  const long stride = (long)gridDim.x * BLOCK;
  const long first = (long)blockIdx.x * BLOCK + threadIdx.x;
  constexpr int KR = K > 0 ? K : 1;
  constexpr int SU = 4;              // streamed slots a thread loads at once
  T rr[KR], ww[KR];
  const long base = (long)blockIdx.x * KR * BLOCK + threadIdx.x;

  T wv[1] = {inf};
  if constexpr (K > 0) {
    load_slots(d, w, base, BLOCK, n, rr, ww);
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (ww[j] > T(0)) wv[0] = min_of(wv[0], ww[j]);
  } else {
    for (long i0 = first; i0 < n; i0 += SU * stride) {
      T r[SU], wa[SU];
      load_slots(d, w, i0, stride, n, r, wa);
#pragma unroll
      for (int u = 0; u < SU; ++u)
        if (wa[u] > T(0)) wv[0] = min_of(wv[0], wa[u]);
    }
  }
  const T cap = *cap_p;
  // GRID scratch: the nb block minima, then nbuf buffers of nb x NODE_PAD
  // node sums, which the passes take in turn
  const int nb = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int npass = (iters + B - 1) / B;
  T* const mins = part;
  T* const bufs = part + nb;
  const int nbuf = GRID ? (int)((part_len / nb - 1) / NODE_PAD) : 1;
  T wmin = block_reduce<T, 1, true>(wv, sm);
  if constexpr (GRID) {
    if (threadIdx.x == 0) __stcg(mins + blockIdx.x, wmin);
    if (warp == 0) {
      // empty this block's slots of the buffers the passes will take; the
      // fence makes that visible before the barrier
      for (int b = 0; b < nbuf && b < npass; ++b)
        st_gpu(bufs + ((long)b * nb + blockIdx.x) * NODE_PAD + lane,
               empty_slot(T(0)));
      __threadfence();
    }
    cg::this_grid().sync();
    wmin = grid_gather<T, 1, true, false>(mins, 1, inf, sm + 2 * NWARP * 32);
  }
  T lo = T(0);
  T hi = top_level(wmin, cap);

  // Pass p publishes in buffer p % nbuf, which holds empty_slot from the
  // start while p < nbuf: such a pass needs no fence. Past that (iters
  // above about nbuf * B), a block empties its slot of buffer
  // (p + 1) % nbuf (pass p + 1 - nbuf's sums, nbuf >= 3) when pass p
  // starts: every block has read that pass's sums by then (each read them
  // before publishing pass p - 1), and none reads the slot for pass p + 1
  // before this block has published pass p, which the fence orders after
  // the emptying. So a slot read for pass p holds pass p's sum or
  // empty_slot.
  for (int done = 0, pass = 0; done < iters; done += B, ++pass) {
    T* const buf = bufs + (long)(pass % nbuf) * nb * NODE_PAD;
    const bool reuse = pass + 1 >= nbuf;
    if constexpr (GRID) {
      if (warp == 0 && reuse)
        st_gpu(bufs + ((long)((pass + 1) % nbuf) * nb + blockIdx.x) *
                          NODE_PAD + lane,
               empty_slot(T(0)));
    }
    T m[NN];
    tree_mids<T, B>(lo, hi, m);
    T l_, u_;                        // node `lane`'s bracket, for the step
    node_bracket<T, B>(lo, hi, lane, l_, u_);
    T s[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) s[i] = T(0);
    if constexpr (K > 0) {
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int i = 0; i < NN; ++i) s[i] += ww[j] * min_of(rr[j], m[i]);
    } else {
      for (long i0 = first; i0 < n; i0 += SU * stride) {
        T r[SU], wa[SU];
        load_slots(d, w, i0, stride, n, r, wa);
#pragma unroll
        for (int u = 0; u < SU; ++u)
#pragma unroll
          for (int i = 0; i < NN; ++i) s[i] += wa[u] * min_of(r[u], m[i]);
      }
    }
    T tot = block_reduce<T, NP, false>(s, sm + ((pass + 1) & 1) * NWARP * 32);
    if constexpr (GRID) {
      if (warp == 0) {
        if (reuse) __threadfence();
        __syncwarp();
        if (lane < NP) st_gpu(buf + (long)blockIdx.x * NODE_PAD + lane, tot);
      }
      tot = grid_gather<T, NP, false, true>(buf, NODE_PAD, T(0),
                                            sm + 2 * NWARP * 32);
    }
    const bool over = tot > cap;
    const unsigned mask = __ballot_sync(FULL, lane < NN && over);
    take_steps(mask, min(B, iters - done), l_, u_, over, lo, hi);
  }

  if constexpr (K > 0) {
    store_slots(d, alloc, base, BLOCK, n, rr, ww, hi);
  } else {
    for (long i0 = first; i0 < n; i0 += SU * stride) {
      T r[SU], wa[SU];
      load_slots(d, w, i0, stride, n, r, wa);
      store_slots(d, alloc, i0, stride, n, r, wa, hi);
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
int launch_warp(const Args& a) {
  waterfill_warp<T, K><<<1, 32, 0, a.stream>>>(
      static_cast<const T*>(a.d), static_cast<const T*>(a.w),
      static_cast<const T*>(a.cap), static_cast<T*>(a.alloc),
      static_cast<T*>(a.level), a.n, a.iters);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_single(const Args& a) {
  waterfill_kernel<T, K, false><<<1, BLOCK, 0, a.stream>>>(
      static_cast<const T*>(a.d), static_cast<const T*>(a.w),
      static_cast<const T*>(a.cap), static_cast<T*>(a.alloc),
      static_cast<T*>(a.level), static_cast<T*>(a.part), a.n, a.iters,
      a.part_len);
  return (int)cudaGetLastError();
}

// Cooperative launch of `blocks` blocks (the caller checked they fit).
template <typename T, int K>
int launch_grid(const Args& a, int blocks) {
  if ((3L * NODE_PAD + 1) * blocks > a.part_len) return NK_ERR_ARGS;
  const T* d = static_cast<const T*>(a.d);
  const T* w = static_cast<const T*>(a.w);
  const T* cap = static_cast<const T*>(a.cap);
  T* alloc = static_cast<T*>(a.alloc);
  T* level = static_cast<T*>(a.level);
  T* part = static_cast<T*>(a.part);
  long n = a.n;
  int iters = a.iters;
  long part_len = a.part_len;
  void* params[] = {&d, &w, &cap, &alloc, &level, &part, &n, &iters,
                    &part_len};
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
// registers; else the streaming variant on one block per SM (more would
// multiply the partial sums every block reads after each barrier).
template <typename T, int K>
int try_grid(const Args& a, int sms) {
  const long per_block = (long)K * BLOCK;
  const long blocks = (a.n + per_block - 1) / per_block;
  if (blocks <= sms && blocks <= resident_blocks<T, K>(sms))
    return launch_grid<T, K>(a, (int)blocks);
  if constexpr (K < KMAX) {
    return try_grid<T, 2 * K>(a, sms);
  } else {
    const int resident = resident_blocks<T, 0>(sms);
    const int all = resident < sms ? resident : sms;
    if (all <= 0) return NK_ERR_ARGS;
    return launch_grid<T, 0>(a, all);
  }
}

template <typename T>
int dispatch(const Args& a) {
  if (a.n <= WARP_SLOTS) {
    if (a.n <= 4) return launch_warp<T, 4>(a);
    if (a.n <= 8) return launch_warp<T, 8>(a);
    if (a.n <= 16) return launch_warp<T, 16>(a);
    return launch_warp<T, 32>(a);
  }
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
// level: one element (written); part: part_len elements of scratch, at
// least 3 * 32 + 1 per SM for the cooperative launch, and 32 more per SM
// for each pass that should take no fence (no initial value needed: a
// launch writes every slot before it reads it).
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

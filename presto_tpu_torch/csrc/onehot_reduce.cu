// One-hot grouped reduction for Hopper (sm_90a), plain C interface: K
// reductions over one segment id column in a single launch.
//
// Replaces the TPU kernel tools/pallas_groupby.py::pallas_onehot (the
// pl.pallas_call at :96, body `kernel` at :78), the hand-blocked form of
// the engine's presto_tpu/ops/aggregation.py::_onehot_aggregate /
// _onehot_one_agg (:217/:298). The engine builds one (rows, nseg) mask
// `oh` (:252) and hands every aggregate's masked reductions to XLA in one
// program; this kernel does the same in one launch. Request q computes
// out[q, s] = reduce over rows i with gid[i] == s (and valid_q[i]) of
// x_q[i], for s in [0, nseg). gid == nseg marks a dead row; any gid
// outside [0, nseg) contributes nothing.
//
// What bounds it on the card: bytes. Each row costs one select and one
// combine per request, about 1 us of the card's scalar rate for all of
// TPC-H Q1, two orders of magnitude under the byte bound. The bytes a
// launch must move are the gid of every row once (4 B, whatever K is),
// the validity byte of each in-range row of a masked request, and x of
// each counted row. Q1's aggregation at SF1 is K = 8 (the live-row count,
// 4 int64 sums, 3 float64 sums for the averages) over an 8,388,608-row
// bucket of which ~5.9 M rows count: 4 B x 8,388,608 = 33.6 MB of gid
// plus 7 x 8 B x ~5.9 M = ~330 MB of x, ~364 MB, ~0.109 ms at 3.35 TB/s.
// chip_smoke.py computes this bound from its run's data.
//
// No tensor cores: the work is one select-and-add per row and request,
// tensor cores have no int64, and Q1's sums must be exact.
//
// Design:
//  - One launch for all K requests. A persistent grid (as many blocks per
//    SM as fit, at most four) splits the rows into one contiguous span
//    per block. The block walks its span in chunks of kChunkRows rows: it
//    reads the chunk's gid from device memory once (16-byte loads), turns
//    each into a uint16 segment code in shared memory (out of range ->
//    the sink code nseg), then sweeps every request's x over the codes.
//    So gid costs 4 B per row per launch, not per request.
//  - No atomics on the per-row path. For nseg <= kPerThreadMaxSegments
//    every thread owns one slot per segment (and one sink slot) at
//    acc[c * kThreads + tid]: a row is one shared-memory read-modify-write
//    at a runtime index, no compare loop over segments, no branch for
//    dead rows, and no bank conflict, since tid fixes the bank whatever c
//    is. Floating min/max need no compare-and-swap in a slot that only its
//    own thread writes. Above that, up to 256 segments, each warp owns a
//    copy of the slots; the lanes that share a code combine first
//    (__match_any_sync, in ascending lane order) and one lane writes, so
//    a distinct code costs one plain shared-memory update per warp and
//    row position, again without atomics.
//  - x is read with 16-byte loads (__ldcs: read once, evict first), four
//    per thread in flight; a load whose rows are all dead is skipped, so
//    the padding of a capacity bucket costs no x bytes. A scalar head and
//    tail take any element-aligned start (offset views such as x[1:]) and
//    any row count.
//  - At the end of each request's sweep over a chunk the slots fold, in a
//    fixed order, into the block's row of a [grid, K, nseg] scratch in
//    device memory. The last block to finish (a ticket counter at the head
//    of the scratch, after __threadfence) combines the rows in a fixed
//    order into out and resets the ticket for the next launch. Float sums
//    are therefore bit-identical from launch to launch for a given grid.
// Sums and counts accumulate in the input's own type (int64 wraps like
// XLA's, float32 stays float32 like the Pallas kernel). Empty segments
// give the identity: 0 for sums and counts, int64 max/min or +-inf for
// min/max, as _onehot_one_agg fills them; min/max propagate NaN. Every
// result is an 8-byte slot: int64 for counts and int64 requests, the bits
// of a float64 for float requests (a float32 result widened exactly).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

enum Op { OP_COUNT = 0, OP_SUM = 1, OP_MIN = 2, OP_MAX = 3 };
enum XKind { X_NONE = 0, X_I64 = 1, X_F64 = 2, X_F32 = 3 };
enum Layout { PER_THREAD = 0, PER_WARP = 1 };

constexpr int kLogThreads = 8;
constexpr int kThreads = 1 << kLogThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRequests = 16;
constexpr int kMaxSegments = 256;
constexpr int kPerThreadMaxSegments = 32;
constexpr int kChunkRows = 16384;  // its codes: 32 KB of uint16
constexpr int kUnroll = 4;         // 16-byte loads in flight per thread
constexpr unsigned kFull = 0xffffffffu;

struct Request {
  const void* x;      // null for a count
  const bool* valid;  // may be null
  int op;
  int xkind;
};

// Passed by value in the kernel's parameters (16 x 24 B).
struct Requests {
  Request r[kMaxRequests];
};

template <typename A>
__device__ __forceinline__ A plus_inf() {
  if constexpr (std::is_same<A, double>::value) {
    return __longlong_as_double(0x7ff0000000000000LL);
  } else {
    return __int_as_float(0x7f800000);
  }
}

template <typename A, int OP>
__device__ __forceinline__ A identity() {
  if constexpr (OP == OP_MIN) {
    if constexpr (std::is_same<A, long long>::value) {
      return LLONG_MAX;
    } else {
      return plus_inf<A>();
    }
  } else if constexpr (OP == OP_MAX) {
    if constexpr (std::is_same<A, long long>::value) {
      return LLONG_MIN;
    } else {
      return -plus_inf<A>();
    }
  } else {
    return A(0);
  }
}

// NaN-propagating min/max (as jnp.min / jnp.max); wrapping int64 add.
template <typename A, int OP>
__device__ __forceinline__ A combine(A a, A b) {
  if constexpr (OP == OP_MIN || OP == OP_MAX) {
    if constexpr (std::is_floating_point<A>::value) {
      if (a != a) return a;
      if (b != b) return b;
    }
    if constexpr (OP == OP_MIN) {
      return b < a ? b : a;
    } else {
      return b > a ? b : a;
    }
  } else if constexpr (std::is_same<A, long long>::value) {
    return static_cast<long long>(static_cast<unsigned long long>(a) +
                                  static_cast<unsigned long long>(b));
  } else {
    return a + b;
  }
}

// A partial in an 8-byte scratch slot (a float32 in its low word).
template <typename A>
__device__ __forceinline__ unsigned long long to_bits(A v) {
  if constexpr (std::is_same<A, double>::value) {
    return static_cast<unsigned long long>(__double_as_longlong(v));
  } else if constexpr (std::is_same<A, float>::value) {
    return __float_as_uint(v);
  } else {
    return static_cast<unsigned long long>(v);
  }
}

template <typename A>
__device__ __forceinline__ A from_bits(unsigned long long b) {
  if constexpr (std::is_same<A, double>::value) {
    return __longlong_as_double(static_cast<long long>(b));
  } else if constexpr (std::is_same<A, float>::value) {
    return __uint_as_float(static_cast<unsigned>(b));
  } else {
    return static_cast<long long>(b);
  }
}

// A result in its output slot: float results as float64 bits.
template <typename A>
__device__ __forceinline__ unsigned long long out_bits(A v) {
  if constexpr (std::is_floating_point<A>::value) {
    return static_cast<unsigned long long>(
        __double_as_longlong(static_cast<double>(v)));
  } else {
    return static_cast<unsigned long long>(v);
  }
}

__device__ __forceinline__ uint16_t code_of(int g, int nseg) {
  return static_cast<uint16_t>(static_cast<unsigned>(g) <
                                       static_cast<unsigned>(nseg)
                                   ? g
                                   : nseg);
}

// The codes of rows [c0, c0 + rows) of gid, read once with 16-byte loads.
__device__ void load_codes(const int32_t* __restrict__ gid, long long c0,
                           int rows, int nseg, uint16_t* codes) {
  const int32_t* g = gid + c0;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15) / 4;
  const int head = min(mis ? 4 - mis : 0, rows);
  const int nvec = (rows - head) / 4;
  const int tail0 = head + nvec * 4;
  const int tid = threadIdx.x;
  if (tid < head) codes[tid] = code_of(g[tid], nseg);
  if (tid < rows - tail0) codes[tail0 + tid] = code_of(g[tail0 + tid], nseg);
  const int4* gv = reinterpret_cast<const int4*>(g + head);
#pragma unroll 4
  for (int v = tid; v < nvec; v += kThreads) {
    const int4 q = __ldcs(gv + v);
    uint16_t* c = codes + head + 4 * v;
    c[0] = code_of(q.x, nseg);
    c[1] = code_of(q.y, nseg);
    c[2] = code_of(q.z, nseg);
    c[3] = code_of(q.w, nseg);
  }
}

// Add value v at code c (nseg is the sink) to this thread's slots. Every
// lane of the warp calls it together (the per-warp layout needs that).
template <int LAYOUT, typename A, int OP>
__device__ __forceinline__ void update(A* slots, int nseg, int c, A v) {
  if constexpr (LAYOUT == PER_THREAD) {
    A* p = slots + c * kThreads + threadIdx.x;
    *p = combine<A, OP>(*p, v);
  } else {
    const int lane = threadIdx.x & 31;
    A* w = slots + (threadIdx.x >> 5) * (nseg + 1);
    const unsigned grp = __match_any_sync(kFull, c);
    const int rounds = static_cast<int>(
        __reduce_max_sync(kFull, static_cast<unsigned>(__popc(grp))));
    A total = identity<A, OP>();
    unsigned rem = grp;
    for (int i = 0; i < rounds; ++i) {
      const int src = rem ? __ffs(rem) - 1 : lane;
      const A o = __shfl_sync(kFull, v, src);
      if (rem) {
        total = combine<A, OP>(total, o);
        rem &= rem - 1;
      }
    }
    if (lane == __ffs(grp) - 1) w[c] = combine<A, OP>(w[c], total);
    __syncwarp();
  }
}

// One request over the chunk's rows [c0, c0 + rows), folded into the
// block's partial parts[q, :]. `first` marks the block's first chunk.
template <int LAYOUT, typename X, typename A, int OP>
__device__ void sweep(const Request& rq, const uint16_t* codes, long long c0,
                      int rows, int nseg, A* slots,
                      unsigned long long* parts, bool first) {
  constexpr bool kHasX = OP != OP_COUNT;
  constexpr int V = kHasX ? 16 / sizeof(X) : 4;  // rows per 16-byte load
  union Vec {
    int4 raw;
    X e[16 / sizeof(X)];
  };
  const int tid = threadIdx.x;
  const A id = identity<A, OP>();
  const X* x = static_cast<const X*>(rq.x);
  const bool* valid = rq.valid;

  if constexpr (LAYOUT == PER_THREAD) {
    for (int c = 0; c <= nseg; ++c) slots[c * kThreads + tid] = id;
  } else {
    for (int i = tid; i < kWarps * (nseg + 1); i += kThreads) slots[i] = id;
    __syncthreads();
  }

  int head = 0;
  if constexpr (kHasX) {
    const int mis =
        static_cast<int>(reinterpret_cast<uintptr_t>(x + c0) & 15) /
        static_cast<int>(sizeof(X));
    head = min(mis ? V - mis : 0, rows);
  }
  const int nvec = (rows - head) / V;
  const int tail0 = head + nvec * V;

  // scalar head and tail rows, by warp 0 (fewer than 2V of them)
  if (tid < 32) {
    for (int part = 0; part < 2; ++part) {
      const int r = part == 0 ? tid : tail0 + tid;
      const bool in = part == 0 ? tid < head : tid < rows - tail0;
      int c = in ? codes[r] : nseg;
      if (valid != nullptr && c != nseg && !valid[c0 + r]) c = nseg;
      A v = A(1);
      if constexpr (kHasX) v = c != nseg ? static_cast<A>(x[c0 + r]) : id;
      update<LAYOUT, A, OP>(slots, nseg, c, v);
    }
  }

  // the 16-byte-aligned body; the loop is uniform across each warp
  const int4* xv = kHasX ? reinterpret_cast<const int4*>(x + c0 + head)
                         : nullptr;
  for (int base = 0; base < nvec; base += kThreads * kUnroll) {
    Vec vec[kUnroll];
    int cs[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int vi = base + u * kThreads + tid;
      const bool in = vi < nvec;
      bool any = false;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int r = head + vi * V + j;
        int c = in ? codes[r] : nseg;
        if (valid != nullptr && c != nseg && !valid[c0 + r]) c = nseg;
        cs[u][j] = c;
        any |= c != nseg;
      }
      vec[u].raw = make_int4(0, 0, 0, 0);
      if (kHasX && any) vec[u].raw = __ldcs(xv + vi);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        A v = A(1);
        if constexpr (kHasX) v = static_cast<A>(vec[u].e[j]);
        update<LAYOUT, A, OP>(slots, nseg, cs[u][j], v);
      }
    }
  }
  __syncthreads();

  // fold the slots in a fixed order: a tree over the threads' slots of
  // each segment, or the warp copies in warp order
  if constexpr (LAYOUT == PER_THREAD) {
    for (int lg = kLogThreads - 1; lg >= 0; --lg) {
      const int h = 1 << lg;
      for (int i = tid; i < nseg * h; i += kThreads) {
        A* p = slots + (i >> lg) * kThreads + (i & (h - 1));
        *p = combine<A, OP>(*p, p[h]);
      }
      __syncthreads();
    }
  }
  for (int s = tid; s < nseg; s += kThreads) {
    A r;
    if constexpr (LAYOUT == PER_THREAD) {
      r = slots[s * kThreads];
    } else {
      r = id;
      for (int w = 0; w < kWarps; ++w) {
        r = combine<A, OP>(r, slots[w * (nseg + 1) + s]);
      }
    }
    if (!first) r = combine<A, OP>(from_bits<A>(parts[s]), r);
    parts[s] = to_bits<A>(r);
  }
  __syncthreads();
}

// The last block: out[q, s] combines parts[b, q, s] over blocks b in a
// fixed order (lane b mod 32 in block order, then a butterfly).
template <typename A, int OP>
__device__ void combine_blocks(const unsigned long long* parts, int k,
                               int nseg, int q, int s,
                               unsigned long long* out) {
  constexpr int kBatch = 8;  // loads in flight per lane
  const int lane = threadIdx.x & 31;
  const int grid = static_cast<int>(gridDim.x);
  A r = identity<A, OP>();
  for (int b0 = lane; b0 < grid; b0 += 32 * kBatch) {
    A v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int b = b0 + 32 * j;
      const size_t idx = (static_cast<size_t>(b) * k + q) * nseg + s;
      v[j] = b < grid ? from_bits<A>(__ldcg(parts + idx)) : identity<A, OP>();
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) r = combine<A, OP>(r, v[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    r = combine<A, OP>(r, __shfl_xor_sync(kFull, r, off));
  }
  if (lane == 0) out[static_cast<size_t>(q) * nseg + s] = out_bits<A>(r);
}

// Request dispatch: op and x kind are uniform across the block.
template <int LAYOUT>
__device__ void sweep_request(const Request& rq, const uint16_t* codes,
                              long long c0, int rows, int nseg, void* slots,
                              unsigned long long* parts, bool first) {
#define ONEHOT_SWEEP(X, A, OP)                                            \
  sweep<LAYOUT, X, A, OP>(rq, codes, c0, rows, nseg,                     \
                          static_cast<A*>(slots), parts, first)
  switch (rq.op * 4 + rq.xkind) {
    case OP_COUNT * 4 + X_NONE: ONEHOT_SWEEP(long long, long long, OP_COUNT); break;
    case OP_SUM * 4 + X_I64: ONEHOT_SWEEP(long long, long long, OP_SUM); break;
    case OP_SUM * 4 + X_F64: ONEHOT_SWEEP(double, double, OP_SUM); break;
    case OP_SUM * 4 + X_F32: ONEHOT_SWEEP(float, float, OP_SUM); break;
    case OP_MIN * 4 + X_I64: ONEHOT_SWEEP(long long, long long, OP_MIN); break;
    case OP_MIN * 4 + X_F64: ONEHOT_SWEEP(double, double, OP_MIN); break;
    case OP_MIN * 4 + X_F32: ONEHOT_SWEEP(float, float, OP_MIN); break;
    case OP_MAX * 4 + X_I64: ONEHOT_SWEEP(long long, long long, OP_MAX); break;
    case OP_MAX * 4 + X_F64: ONEHOT_SWEEP(double, double, OP_MAX); break;
    case OP_MAX * 4 + X_F32: ONEHOT_SWEEP(float, float, OP_MAX); break;
    default: break;  // refused by the host entry point
  }
#undef ONEHOT_SWEEP
}

__device__ void combine_request(const Request& rq, const unsigned long long* parts,
                                int k, int nseg, int q, int s,
                                unsigned long long* out) {
#define ONEHOT_COMBINE(A, OP) combine_blocks<A, OP>(parts, k, nseg, q, s, out)
  switch (rq.op * 4 + rq.xkind) {
    case OP_COUNT * 4 + X_NONE: ONEHOT_COMBINE(long long, OP_SUM); break;
    case OP_SUM * 4 + X_I64: ONEHOT_COMBINE(long long, OP_SUM); break;
    case OP_SUM * 4 + X_F64: ONEHOT_COMBINE(double, OP_SUM); break;
    case OP_SUM * 4 + X_F32: ONEHOT_COMBINE(float, OP_SUM); break;
    case OP_MIN * 4 + X_I64: ONEHOT_COMBINE(long long, OP_MIN); break;
    case OP_MIN * 4 + X_F64: ONEHOT_COMBINE(double, OP_MIN); break;
    case OP_MIN * 4 + X_F32: ONEHOT_COMBINE(float, OP_MIN); break;
    case OP_MAX * 4 + X_I64: ONEHOT_COMBINE(long long, OP_MAX); break;
    case OP_MAX * 4 + X_F64: ONEHOT_COMBINE(double, OP_MAX); break;
    case OP_MAX * 4 + X_F32: ONEHOT_COMBINE(float, OP_MAX); break;
    default: break;
  }
#undef ONEHOT_COMBINE
}

// scratch: [0] the ticket (zero between launches), then the [grid, k,
// nseg] partials. out: [k, nseg] 8-byte slots.
template <int LAYOUT>
__global__ void __launch_bounds__(kThreads)
    onehot_many(const Requests rqs, int k, const int32_t* __restrict__ gid,
                long long n, int nseg, long long span,
                unsigned long long* scratch, unsigned long long* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  uint16_t* codes = reinterpret_cast<uint16_t*>(smem);
  void* slots = smem + kChunkRows * sizeof(uint16_t);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch);
  unsigned long long* parts = scratch + 1;

  const long long b0 = static_cast<long long>(blockIdx.x) * span;
  const long long b1 = min(n, b0 + span);
  long long c0 = b0;
  bool first = true;
  do {
    const int rows = static_cast<int>(
        max(0LL, min(static_cast<long long>(kChunkRows), b1 - c0)));
    load_codes(gid, c0, rows, nseg, codes);
    __syncthreads();
    for (int q = 0; q < k; ++q) {
      unsigned long long* mine =
          parts + (static_cast<size_t>(blockIdx.x) * k + q) * nseg;
      const Request rq = rqs.r[q];
      sweep_request<LAYOUT>(rq, codes, c0, rows, nseg, slots, mine, first);
    }
    first = false;
    c0 += kChunkRows;
  } while (c0 < b1);

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int p = threadIdx.x >> 5; p < k * nseg; p += kWarps) {
    const Request rq = rqs.r[p / nseg];
    combine_request(rq, parts, k, nseg, p / nseg, p % nseg, out);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// x may be null only where there are no rows (an empty tensor's pointer)
bool valid_request(const Request& r, long long n) {
  if (r.op == OP_COUNT) return r.xkind == X_NONE && r.x == nullptr;
  return (r.op == OP_SUM || r.op == OP_MIN || r.op == OP_MAX) &&
         (r.xkind == X_I64 || r.xkind == X_F64 || r.xkind == X_F32) &&
         (r.x != nullptr || n == 0);
}

// The kernel for nseg segments and its dynamic shared memory: per-thread
// slots up to kPerThreadMaxSegments, per-warp slots above.
using Kernel = void (*)(const Requests, int, const int32_t*, long long, int,
                        long long, unsigned long long*, unsigned long long*);

Kernel kernel_for(int nseg, size_t* smem) {
  const bool per_thread = nseg <= kPerThreadMaxSegments;
  *smem = kChunkRows * sizeof(uint16_t) +
          sizeof(long long) * (nseg + 1) * (per_thread ? kThreads : kWarps);
  return per_thread ? &onehot_many<PER_THREAD> : &onehot_many<PER_WARP>;
}

}  // namespace

extern "C" {

// K (<= 16) reductions over one gid in one launch: request q is (ops[q],
// xkinds[q], xs[q], valids[q]) and its result is row q of out[k, nseg]
// (8-byte slots). scratch is zeroed device memory of at least
// 8 * (1 + grid * k * nseg) bytes that only stream-ordered launches
// share; the launch leaves its first word zero again. Returns the CUDA
// error code of the launch (0 on success); nothing synchronises.
int onehot_reduce_many_launch(int k, const int* ops, const int* xkinds,
                              const void* const* xs,
                              const void* const* valids, const void* gid,
                              long long n, int nseg, void* scratch, int grid,
                              void* out, void* stream) {
  if (k < 1 || k > kMaxRequests || nseg < 1 || nseg > kMaxSegments ||
      grid < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Requests rqs = {};
  for (int q = 0; q < k; ++q) {
    rqs.r[q] = Request{xs[q], static_cast<const bool*>(valids[q]), ops[q],
                       xkinds[q]};
    if (!valid_request(rqs.r[q], n)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long span = (n + grid - 1) / grid;
  size_t smem = 0;
  const auto kernel = kernel_for(nseg, &smem);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rqs, k, static_cast<const int32_t*>(gid), n, nseg, span,
      static_cast<unsigned long long*>(scratch),
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// How many blocks of the kernel for nseg segments fit on one SM of the
// current device (at least 1), or a negative CUDA error code.
int onehot_reduce_many_blocks_per_sm(int nseg) {
  if (nseg < 1 || nseg > kMaxSegments) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = 0;
  const auto kernel = kernel_for(nseg, &smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks < 1 ? 1 : blocks;
}

const char* onehot_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

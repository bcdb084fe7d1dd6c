// One-hot grouped reduction for Hopper (sm_90a), plain C interface: K
// reductions over one segment id column, for one or many lanes, in a
// single launch.
//
// Replaces the TPU kernel tools/pallas_groupby.py::pallas_onehot (the
// pl.pallas_call at :96, body `kernel` at :78), the hand-blocked form of
// the engine's presto_tpu/ops/aggregation.py::_onehot_aggregate /
// _onehot_one_agg (:217/:298). The engine builds one (rows, nseg) mask
// `oh` (:252) and hands every aggregate's masked reductions to XLA in one
// program; this kernel does the same in one launch. Request q computes
// out[q, l, s] = reduce over rows i of lane l with gid[i] == s (and
// valid_q[i]) of x_q[i], for s in [0, nseg). Lane l owns rows
// [l * rows, (l + 1) * rows): a micro-batch stacks its members' pages
// that way (page.tile_lanes), a single GROUP BY is one lane. gid == nseg
// marks a dead row; any gid outside [0, nseg) contributes nothing.
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
// A call of ~100 rows (a merge task's final GROUP BY) moves a few KB:
// there the launch itself is the floor. chip_smoke.py computes both
// bounds and times an empty launch.
//
// No tensor cores: the work is one select-and-add per row and request,
// tensor cores have no int64, and Q1's sums must be exact.
//
// Design, the large form (a lane of more than 4,096 rows):
//  - One launch for all K requests and all lanes. A persistent grid (as
//    many blocks per SM as fit, at most four) is split evenly over the
//    lanes; each block owns one contiguous span of ONE lane's rows, so
//    its per-thread slots hold that lane's nseg + 1 segments whatever the
//    lane count is. The block walks its span in chunks of kChunkRows
//    rows: it reads the chunk's gid from device memory once (16-byte
//    loads), turns each into a uint16 segment code in shared memory (out
//    of range -> the sink code nseg), then sweeps every request's x over
//    the codes. So gid costs 4 B per row per launch, not per request.
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
//    device memory. The last block of each lane to finish (one ticket
//    counter per lane, after __threadfence) combines that lane's rows in
//    a fixed order into out and resets its ticket for the next launch, so
//    the lanes combine in parallel. Float sums are therefore
//    bit-identical from launch to launch for a given grid.
// The direct form (every lane within kDirectMaxRows rows): one block per
// (request, lane) pair, so the requests of a small call run side by side
// instead of one after another in one block. Each thread starts the
// reads of all its rows (gid, validity, x) before it updates a slot, so
// the block waits for memory once; the slots fold straight into out: no
// shared-memory codes, no scratch, no ticket, no second pass. In the
// per-warp layout a dead row's lanes take no combine round.
// The requests travel in the kernel's parameters (kMaxRequests of them,
// 24 B each), so any K up to 64 is one launch.
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
constexpr int kMaxRequests = 64;
constexpr int kMaxSegments = 256;
constexpr int kPerThreadMaxSegments = 32;
constexpr int kChunkRows = 16384;  // its codes: 32 KB of uint16
constexpr int kDirectMaxRows = 4096;
constexpr int kDirectUnroll = 4;  // a direct block's rows per thread in flight
constexpr int kMaxGridY = 65535;
constexpr int kUnroll = 4;         // 16-byte loads in flight per thread
constexpr unsigned kFull = 0xffffffffu;

struct Request {
  const void* x;      // null for a count
  const bool* valid;  // may be null
  int op;
  int xkind;
};

// Passed by value in the kernel's parameters (64 x 24 B = 1,536 B).
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
    // the sink's lanes (dead rows) set no round count and write nothing
    const unsigned grp = __match_any_sync(kFull, c);
    const int rounds = static_cast<int>(__reduce_max_sync(
        kFull, c != nseg ? static_cast<unsigned>(__popc(grp)) : 0u));
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
    if (c != nseg && lane == __ffs(grp) - 1) {
      w[c] = combine<A, OP>(w[c], total);
    }
    __syncwarp();
  }
}

// Every slot of the block at the op's identity.
template <int LAYOUT, typename A, int OP>
__device__ __forceinline__ void init_slots(A* slots, int nseg) {
  const A id = identity<A, OP>();
  if constexpr (LAYOUT == PER_THREAD) {
    for (int c = 0; c <= nseg; ++c) slots[c * kThreads + threadIdx.x] = id;
  } else {
    for (int i = threadIdx.x; i < kWarps * (nseg + 1); i += kThreads) {
      slots[i] = id;
    }
    __syncthreads();
  }
}

// After the rows: the slots fold in a fixed order (a tree over the
// threads' slots of each segment, or the warp copies in warp order) into
// dst. The large form folds into the block's partial dst = parts[b, q, :]
// (`first` marks the block's first chunk); the direct form (DIRECT)
// writes the result straight into its output row dst.
template <int LAYOUT, bool DIRECT, typename A, int OP>
__device__ void finish(A* slots, int nseg, unsigned long long* dst,
                       bool first) {
  const int tid = threadIdx.x;
  __syncthreads();
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
      r = identity<A, OP>();
      for (int w = 0; w < kWarps; ++w) {
        r = combine<A, OP>(r, slots[w * (nseg + 1) + s]);
      }
    }
    if constexpr (DIRECT) {
      dst[s] = out_bits<A>(r);
    } else {
      if (!first) r = combine<A, OP>(from_bits<A>(dst[s]), r);
      dst[s] = to_bits<A>(r);
    }
  }
  __syncthreads();
}

// One request over the chunk's rows [c0, c0 + rows) of the large form,
// their codes in shared memory, folded into the block's partial dst.
template <int LAYOUT, typename X, typename A, int OP>
__device__ void sweep(const Request& rq, const uint16_t* codes, long long c0,
                      int rows, int nseg, A* slots,
                      unsigned long long* dst, bool first) {
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

  init_slots<LAYOUT, A, OP>(slots, nseg);

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
  finish<LAYOUT, false, A, OP>(slots, nseg, dst, first);
}

// One request over rows [c0, c0 + rows) of the direct form (rows <=
// kDirectMaxRows), written straight into its output row dst. Each thread
// takes rows tid, tid + kThreads, ...: it starts the reads of all of
// them (gid, validity, x: independent of each other, no shared-memory
// codes) before it updates a slot, so a small call waits for memory once.
template <int LAYOUT, typename X, typename A, int OP>
__device__ void sweep_direct(const Request& rq,
                             const int32_t* __restrict__ gid, long long c0,
                             int rows, int nseg, A* slots,
                             unsigned long long* dst) {
  constexpr bool kHasX = OP != OP_COUNT;
  constexpr int U = kDirectUnroll;
  const int tid = threadIdx.x;
  const X* x = static_cast<const X*>(rq.x);
  const bool* valid = rq.valid;

  init_slots<LAYOUT, A, OP>(slots, nseg);
  for (int r0 = 0; r0 < rows; r0 += kThreads * U) {
    int cs[U];
    A vs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * kThreads + tid;
      const bool in = r < rows;
      const int g = in ? gid[c0 + r] : nseg;
      const bool ok = in && (valid == nullptr || valid[c0 + r]);
      vs[u] = A(1);
      if constexpr (kHasX) {
        vs[u] = in ? static_cast<A>(x[c0 + r]) : identity<A, OP>();
      }
      cs[u] = ok ? code_of(g, nseg) : nseg;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      update<LAYOUT, A, OP>(slots, nseg, cs[u], vs[u]);
    }
  }
  finish<LAYOUT, true, A, OP>(slots, nseg, dst, true);
}

// The last block of a lane: row[s] combines parts[b, q, s] over that
// lane's `blocks` blocks in a fixed order (lane b mod 32 in block order,
// then a butterfly).
template <typename A, int OP>
__device__ void combine_blocks(const unsigned long long* parts, int blocks,
                               int k, int nseg, int q, int s,
                               unsigned long long* row) {
  constexpr int kBatch = 8;  // loads in flight per lane
  const int lane = threadIdx.x & 31;
  A r = identity<A, OP>();
  for (int b0 = lane; b0 < blocks; b0 += 32 * kBatch) {
    A v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int b = b0 + 32 * j;
      const size_t idx = (static_cast<size_t>(b) * k + q) * nseg + s;
      v[j] = b < blocks ? from_bits<A>(__ldcg(parts + idx))
                        : identity<A, OP>();
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) r = combine<A, OP>(r, v[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    r = combine<A, OP>(r, __shfl_xor_sync(kFull, r, off));
  }
  if (lane == 0) row[s] = out_bits<A>(r);
}

// Request dispatch: op and x kind are uniform across the block. The
// large form reads the chunk's codes, the direct form the gid itself.
template <int LAYOUT, bool DIRECT>
__device__ void sweep_request(const Request& rq, const uint16_t* codes,
                              const int32_t* gid, long long c0, int rows,
                              int nseg, void* slots, unsigned long long* dst,
                              bool first) {
#define ONEHOT_SWEEP(X, A, OP)                                            \
  if constexpr (DIRECT) {                                                 \
    sweep_direct<LAYOUT, X, A, OP>(rq, gid, c0, rows, nseg,              \
                                   static_cast<A*>(slots), dst);         \
  } else {                                                                \
    sweep<LAYOUT, X, A, OP>(rq, codes, c0, rows, nseg,                   \
                            static_cast<A*>(slots), dst, first);         \
  }
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

__device__ void combine_request(const Request& rq,
                                const unsigned long long* parts, int blocks,
                                int k, int nseg, int q, int s,
                                unsigned long long* row) {
#define ONEHOT_COMBINE(A, OP) \
  combine_blocks<A, OP>(parts, blocks, k, nseg, q, s, row)
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

// The large form. gridDim.x = lanes * per_lane; block b takes span rows
// of lane b / per_lane. tickets: one zeroed counter per lane (zero again
// after the launch); parts: the [grid, k, nseg] partials. out: [k,
// lanes, nseg] 8-byte slots.
template <int LAYOUT>
__global__ void __launch_bounds__(kThreads)
    onehot_many(const Requests rqs, int k, const int32_t* __restrict__ gid,
                long long rows, int nseg, int per_lane, long long span,
                unsigned int* tickets, unsigned long long* parts,
                unsigned long long* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  uint16_t* codes = reinterpret_cast<uint16_t*>(smem);
  void* slots = smem + kChunkRows * sizeof(uint16_t);
  const int lanes = static_cast<int>(gridDim.x) / per_lane;
  const int lane = static_cast<int>(blockIdx.x) / per_lane;
  const long long base = static_cast<long long>(lane) * rows;

  const long long b0 =
      base + static_cast<long long>(blockIdx.x % per_lane) * span;
  const long long b1 = min(base + rows, b0 + span);
  long long c0 = b0;
  bool first = true;
  do {
    const int n = static_cast<int>(
        max(0LL, min(static_cast<long long>(kChunkRows), b1 - c0)));
    load_codes(gid, c0, n, nseg, codes);
    __syncthreads();
    for (int q = 0; q < k; ++q) {
      unsigned long long* mine =
          parts + (static_cast<size_t>(blockIdx.x) * k + q) * nseg;
      const Request rq = rqs.r[q];
      sweep_request<LAYOUT, false>(rq, codes, nullptr, c0, n, nseg, slots,
                                   mine, first);
    }
    first = false;
    c0 += kChunkRows;
  } while (c0 < b1);

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + lane, 1u) ==
           static_cast<unsigned>(per_lane - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const unsigned long long* mine =
      parts + static_cast<size_t>(lane) * per_lane * k * nseg;
  for (int p = threadIdx.x >> 5; p < k * nseg; p += kWarps) {
    const int q = p / nseg;
    const Request rq = rqs.r[q];
    combine_request(rq, mine, per_lane, k, nseg, q, p % nseg,
                    out + (static_cast<size_t>(q) * lanes + lane) * nseg);
  }
  if (threadIdx.x == 0) tickets[lane] = 0;
}

// The direct form: block (q, l) sweeps request q over lane l's rows
// (at most kDirectMaxRows) and writes out[q, l, :].
template <int LAYOUT>
__global__ void __launch_bounds__(kThreads)
    onehot_many_direct(const Requests rqs, const int32_t* __restrict__ gid,
                       int rows, int nseg, unsigned long long* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = static_cast<int>(blockIdx.x);
  const int lane = static_cast<int>(blockIdx.y);
  const Request rq = rqs.r[q];
  sweep_request<LAYOUT, true>(
      rq, nullptr, gid, static_cast<long long>(lane) * rows, rows, nseg, smem,
      out + (static_cast<size_t>(q) * gridDim.y + lane) * nseg, false);
}

// x may be null only where there are no rows (an empty tensor's pointer)
bool valid_request(const Request& r, long long n) {
  if (r.op == OP_COUNT) return r.xkind == X_NONE && r.x == nullptr;
  return (r.op == OP_SUM || r.op == OP_MIN || r.op == OP_MAX) &&
         (r.xkind == X_I64 || r.xkind == X_F64 || r.xkind == X_F32) &&
         (r.x != nullptr || n == 0);
}

// The slots' bytes for nseg segments: per-thread slots up to
// kPerThreadMaxSegments, per-warp slots above.
size_t slots_bytes(int nseg) {
  const bool per_thread = nseg <= kPerThreadMaxSegments;
  return sizeof(long long) * (nseg + 1) * (per_thread ? kThreads : kWarps);
}

// The large form's kernel for nseg segments and its dynamic shared memory.
using Kernel = void (*)(const Requests, int, const int32_t*, long long, int,
                        int, long long, unsigned int*, unsigned long long*,
                        unsigned long long*);

Kernel kernel_for(int nseg, size_t* smem) {
  *smem = kChunkRows * sizeof(uint16_t) + slots_bytes(nseg);
  return nseg <= kPerThreadMaxSegments ? &onehot_many<PER_THREAD>
                                       : &onehot_many<PER_WARP>;
}

using DirectKernel = void (*)(const Requests, const int32_t*, int, int,
                              unsigned long long*);

DirectKernel direct_kernel_for(int nseg, size_t* smem) {
  *smem = slots_bytes(nseg);
  return nseg <= kPerThreadMaxSegments ? &onehot_many_direct<PER_THREAD>
                                       : &onehot_many_direct<PER_WARP>;
}

template <typename F>
cudaError_t allow_smem(F kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// K (<= 64) reductions over `lanes` lanes of `rows` rows each in one
// launch: request q is (ops[q], xkinds[q], xs[q], valids[q]) over the
// lanes * rows rows of gid, and its result for lane l is row q, columns
// [l * nseg, (l + 1) * nseg) of out[k, lanes * nseg] (8-byte slots).
// per_lane == 0 takes the direct form (rows <= 4,096, lanes <= 65,535;
// tickets and parts unused); per_lane >= 1 the large form over
// lanes * per_lane blocks, with tickets zeroed device memory of at least
// 4 * lanes bytes (zero again after the launch) and parts device memory
// of at least 8 * lanes * per_lane * k * nseg bytes, both shared only by
// stream-ordered launches. Returns the CUDA error code of the launch (0
// on success); nothing synchronises.
int onehot_reduce_launch(int k, const int* ops, const int* xkinds,
                         const void* const* xs, const void* const* valids,
                         const void* gid, int lanes, long long rows, int nseg,
                         int per_lane, void* tickets, void* parts, void* out,
                         void* stream) {
  if (k < 1 || k > kMaxRequests || nseg < 1 || nseg > kMaxSegments ||
      lanes < 1 || rows < 0 || per_lane < 0 ||
      static_cast<long long>(lanes) * per_lane > INT_MAX ||
      (per_lane == 0 && (rows > kDirectMaxRows || lanes > kMaxGridY))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(lanes) * rows;
  Requests rqs = {};
  for (int q = 0; q < k; ++q) {
    rqs.r[q] = Request{xs[q], static_cast<const bool*>(valids[q]), ops[q],
                       xkinds[q]};
    if (!valid_request(rqs.r[q], n)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const int32_t*>(gid);
  auto* o = static_cast<unsigned long long*>(out);
  size_t smem = 0;
  cudaError_t err;
  if (per_lane == 0) {
    const int r = static_cast<int>(rows);
    const auto kernel = direct_kernel_for(nseg, &smem);
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(k, lanes), kThreads, smem, s>>>(rqs, g, r, nseg, o);
  } else {
    const long long span = (rows + per_lane - 1) / per_lane;
    const auto kernel = kernel_for(nseg, &smem);
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<lanes * per_lane, kThreads, smem, s>>>(
        rqs, k, g, rows, nseg, per_lane, span,
        static_cast<unsigned int*>(tickets),
        static_cast<unsigned long long*>(parts), o);
  }
  return static_cast<int>(cudaGetLastError());
}

// How many blocks of the large form's kernel for nseg segments fit on
// one SM of the current device (at least 1), or a negative CUDA error
// code.
int onehot_reduce_many_blocks_per_sm(int nseg) {
  if (nseg < 1 || nseg > kMaxSegments) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = 0;
  const auto kernel = kernel_for(nseg, &smem);
  cudaError_t err = allow_smem(kernel, smem);
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

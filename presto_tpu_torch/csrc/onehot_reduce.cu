// One-hot grouped reduction for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel tools/pallas_groupby.py::pallas_onehot (the
// pl.pallas_call at :96, body `kernel` at :78), the hand-blocked form of
// the engine's presto_tpu/ops/aggregation.py::_onehot_aggregate /
// _onehot_one_agg: out[s] = reduce over rows i with gid[i] == s (and
// valid[i]) of x[i], for s in [0, nseg). gid == nseg marks a dead row;
// any gid outside [0, nseg) contributes nothing.
//
// What bounds it on the card: bytes. There is one compare and one add
// per row, far below the card's compute rate. The bytes it must move are
// the gid of every row (4 B), the validity byte of each row whose gid is
// in range (when there is a mask), and x (8 B for int64/float64) of each
// row that counts. For one of TPC-H Q1's sums at SF1 (no mask; padding
// and filtered rows dead) that is 4 B x 8,388,608 + 8 B x ~5.9 M rows,
// about 81 MB, so about 24 us at 3.35 TB/s. Reading all three columns
// for every row of the bucket (13 B x 8,388,608 = 109 MB, about 33 us)
// is a looser bound. chip_smoke.py computes the stricter one from its
// run's data and reports it as bound_ms. Both are computed, not measured.
//
// Design. On the TPU the grid ran in order and one (nseg, 128)
// accumulator stayed in VMEM across all grid steps. Blocks here run in
// parallel and in no order, so:
//  - a grid-stride loop takes the place of the sequential grid;
//  - each warp owns a private copy of the nseg (<= 256) partials in
//    shared memory, updated with shared-memory atomics (atomicAdd for
//    sums and counts, atomicMin/atomicMax for int64, a compare-and-swap
//    loop for floating min/max that keeps NaN), so warps never contend;
//  - at the end of the block the warp copies combine in a fixed order
//    into one row of a [grid, nseg] scratch (allocated by the caller);
//  - a second small kernel, one block per segment, reduces that scratch
//    in a fixed order. There are no atomics on global memory.
// Sums and counts accumulate in the input's own type (int64 wraps like
// XLA's, float32 stays float32 like the Pallas kernel). Empty segments
// give the identity: 0 for sums and counts, int64 max/min or +-inf for
// min/max, as _onehot_one_agg fills them. Fusing several aggregates
// into one pass over the rows, TMA loads and wider per-thread loads are
// later work.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

enum Op { OP_COUNT = 0, OP_SUM = 1, OP_MIN = 2, OP_MAX = 3 };
enum XKind { X_NONE = 0, X_I64 = 1, X_F64 = 2, X_F32 = 3 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSegments = 256;

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

__device__ __forceinline__ void atomic_add(long long* p, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}
__device__ __forceinline__ void atomic_add(double* p, double v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void atomic_add(float* p, float v) {
  atomicAdd(p, v);
}

template <int OP>
__device__ void atomic_minmax(double* addr, double v) {
  auto* p = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *p;
  while (true) {
    const double next = combine<double, OP>(__longlong_as_double(old), v);
    const auto bits = static_cast<unsigned long long>(__double_as_longlong(next));
    if (bits == old) return;
    const unsigned long long prev = atomicCAS(p, old, bits);
    if (prev == old) return;
    old = prev;
  }
}

template <int OP>
__device__ void atomic_minmax(float* addr, float v) {
  auto* p = reinterpret_cast<unsigned int*>(addr);
  unsigned int old = *p;
  while (true) {
    const float next = combine<float, OP>(__uint_as_float(old), v);
    const unsigned int bits = __float_as_uint(next);
    if (bits == old) return;
    const unsigned int prev = atomicCAS(p, old, bits);
    if (prev == old) return;
    old = prev;
  }
}

template <typename A, int OP>
__device__ __forceinline__ void atomic_combine(A* p, A v) {
  if constexpr (OP == OP_COUNT || OP == OP_SUM) {
    atomic_add(p, v);
  } else if constexpr (std::is_same<A, long long>::value) {
    if constexpr (OP == OP_MIN) {
      atomicMin(p, v);
    } else {
      atomicMax(p, v);
    }
  } else {
    atomic_minmax<OP>(p, v);
  }
}

// Pass 1: each block reduces its grid-stride share of the rows into one
// row of partials[gridDim.x][nseg].
template <typename X, typename A, int OP>
__global__ void __launch_bounds__(kThreads)
    onehot_partial(const int32_t* __restrict__ gid, const X* __restrict__ x,
                   const bool* __restrict__ valid, long long n, int nseg,
                   A* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  A* acc = reinterpret_cast<A*>(smem);  // [kWarps][nseg]
  const A id = identity<A, OP>();
  for (int i = threadIdx.x; i < kWarps * nseg; i += kThreads) acc[i] = id;
  __syncthreads();

  A* mine = acc + (threadIdx.x / 32) * nseg;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const int g = gid[i];
    if (g < 0 || g >= nseg) continue;
    if (valid != nullptr && !valid[i]) continue;
    A v;
    if constexpr (OP == OP_COUNT) {
      v = A(1);
    } else {
      v = static_cast<A>(x[i]);
    }
    atomic_combine<A, OP>(mine + g, v);
  }
  __syncthreads();

  for (int s = threadIdx.x; s < nseg; s += kThreads) {
    A r = acc[s];
    for (int w = 1; w < kWarps; ++w) r = combine<A, OP>(r, acc[w * nseg + s]);
    partials[static_cast<long long>(blockIdx.x) * nseg + s] = r;
  }
}

// Pass 2: block s reduces column s of partials in a fixed order.
template <typename A, int OP>
__global__ void __launch_bounds__(kThreads)
    onehot_final(const A* __restrict__ partials, int grid, int nseg,
                 A* __restrict__ out) {
  __shared__ A buf[kThreads];
  const int s = blockIdx.x;
  A r = identity<A, OP>();
  for (int b = threadIdx.x; b < grid; b += kThreads) {
    r = combine<A, OP>(r, partials[static_cast<long long>(b) * nseg + s]);
  }
  buf[threadIdx.x] = r;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      buf[threadIdx.x] = combine<A, OP>(buf[threadIdx.x], buf[threadIdx.x + h]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[s] = buf[0];
}

template <typename X, typename A, int OP>
int launch(const void* gid, const void* x, const void* valid, long long n,
           int nseg, void* partials, int grid, void* out, cudaStream_t stream) {
  const size_t smem = sizeof(A) * kWarps * nseg;
  onehot_partial<X, A, OP><<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(gid), static_cast<const X*>(x),
      static_cast<const bool*>(valid), n, nseg, static_cast<A*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  onehot_final<A, OP><<<nseg, kThreads, 0, stream>>>(
      static_cast<const A*>(partials), grid, nseg, static_cast<A*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int OP>
int launch_typed(int xkind, const void* gid, const void* x, const void* valid,
                 long long n, int nseg, void* partials, int grid, void* out,
                 cudaStream_t stream) {
  switch (xkind) {
    case X_I64:
      return launch<long long, long long, OP>(gid, x, valid, n, nseg,
                                              partials, grid, out, stream);
    case X_F64:
      return launch<double, double, OP>(gid, x, valid, n, nseg, partials,
                                        grid, out, stream);
    case X_F32:
      return launch<float, float, OP>(gid, x, valid, n, nseg, partials, grid,
                                      out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Reduce x over the rows of each segment into out[nseg]. x is null for
// op 0 (count); valid may be null. partials is [grid, nseg] scratch of
// the accumulator type (int64 for count). Returns the CUDA error code of
// the launches (0 on success); nothing synchronises.
int onehot_reduce_launch(int op, int xkind, const void* gid, const void* x,
                         const void* valid, long long n, int nseg,
                         void* partials, int grid, void* out, void* stream) {
  if (nseg < 1 || nseg > kMaxSegments || grid < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case OP_COUNT:
      if (xkind != X_NONE) return static_cast<int>(cudaErrorInvalidValue);
      return launch<long long, long long, OP_COUNT>(gid, nullptr, valid, n,
                                                    nseg, partials, grid, out, s);
    case OP_SUM:
      return launch_typed<OP_SUM>(xkind, gid, x, valid, n, nseg, partials,
                                  grid, out, s);
    case OP_MIN:
      return launch_typed<OP_MIN>(xkind, gid, x, valid, n, nseg, partials,
                                  grid, out, s);
    case OP_MAX:
      return launch_typed<OP_MAX>(xkind, gid, x, valid, n, nseg, partials,
                                  grid, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* onehot_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

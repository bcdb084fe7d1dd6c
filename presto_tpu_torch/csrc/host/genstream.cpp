// Native closed-form column generator: the data-loader hot loop.
//
// The port's own copy of the reference's generator loop. The tpch and
// tpcds connectors (presto_tpu_torch/connectors/) generate every column
// as a closed-form function of the row index; their inner loop is a
// splitmix64-style stream keyed by (column tag, row index). numpy runs
// it as 6 vectorized uint64 passes over the array; one fused scalar
// loop avoids the memory round trips. Built with g++ at first use and
// loaded through ctypes by presto_tpu_torch/native.py, bit-exact
// against the numpy path (tests/test_torch_native.py), which stays for
// a host without a compiler.
//
// ABI (C): index sequences are affine (start + step*i) — exactly the
// shapes the generators use (arange rows; returns-table row maps like
// rows*2). For count elements:
//   gen_uniform(tag, start, step, count, val_lo, val_hi, out)
//     out : int64[count]; out[i] = val_lo +
//           mix((start+step*i)*GOLD ^ key(tag)) % (val_hi - val_lo + 1)
//   gen_stream(tag, start, step, count, out)
//     out : uint64[count] raw mixed stream
//   is_affine(idx, count, start, step)
//     1 when idx[i] == start + step*i (mod 2^64) for every i, else 0:
//     the routing check, one pass with no temporary arrays
// The first two match presto_tpu_torch.connectors.tpch._uniform/_stream
// bit for bit.

#include <cstdint>

namespace {

constexpr uint64_t M1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t M2 = 0x94D049BB133111EBull;
constexpr uint64_t GOLD = 0x9E3779B97F4A7C15ull;
constexpr uint64_t KEY_A = 0xD1B54A32D192ED03ull;
constexpr uint64_t KEY_B = 0x632BE59BD9B4E019ull;

inline uint64_t mix(uint64_t x) {
    x = (x ^ (x >> 30)) * M1;
    x = (x ^ (x >> 27)) * M2;
    return x ^ (x >> 31);
}

}  // namespace

extern "C" {

void gen_stream(int64_t tag, int64_t start, int64_t step,
                int64_t count, uint64_t* out) {
    const uint64_t key =
        static_cast<uint64_t>(tag) * KEY_A + KEY_B;
    uint64_t idx = static_cast<uint64_t>(start);
    const uint64_t stp = static_cast<uint64_t>(step);
    for (int64_t i = 0; i < count; ++i, idx += stp) {
        out[i] = mix(idx * GOLD ^ key);
    }
}

void gen_uniform(int64_t tag, int64_t start, int64_t step,
                 int64_t count, int64_t val_lo, int64_t val_hi,
                 int64_t* out) {
    const uint64_t key =
        static_cast<uint64_t>(tag) * KEY_A + KEY_B;
    const uint64_t span =
        static_cast<uint64_t>(val_hi - val_lo + 1);
    uint64_t idx = static_cast<uint64_t>(start);
    const uint64_t stp = static_cast<uint64_t>(step);
    for (int64_t i = 0; i < count; ++i, idx += stp) {
        const uint64_t s = mix(idx * GOLD ^ key);
        out[i] = val_lo + static_cast<int64_t>(s % span);
    }
}

int64_t is_affine(const int64_t* idx, int64_t count, int64_t start,
                  int64_t step) {
    uint64_t want = static_cast<uint64_t>(start);
    const uint64_t stp = static_cast<uint64_t>(step);
    for (int64_t i = 0; i < count; ++i, want += stp) {
        if (static_cast<uint64_t>(idx[i]) != want) return 0;
    }
    return 1;
}

}  // extern "C"

// Host codec: varlen string -> order-preserving dictionary-id encoding.
//
// The port's own copy of the reference's codec. The device only ever
// sees int32 dictionary ids; producing those ids from raw strings is
// pure host work and the hottest Python-side staging loop. Built with
// g++ at first use and loaded through ctypes by
// presto_tpu_torch/native.py; presto_tpu_torch.page.encode_strings
// routes columns of 4096 rows or more here, and keeps its numpy path
// for a host without a compiler.
//
// ABI (C, ctypes-friendly):
//   dict_encode(blob, offsets, n, valid, ids_out, uniq_repr_out)
//     blob      : concatenated utf-8 bytes of all n strings
//     offsets   : int64[n+1], string i = blob[offsets[i], offsets[i+1])
//     valid     : uint8[n] or NULL; 0 = SQL NULL (gets id -1)
//     ids_out   : int32[n]  (sorted-dictionary ids, -1 for NULL)
//     uniq_repr : int64[n]  (first-occurrence row index per unique
//                 value, in SORTED value order; first n_unique filled)
//   returns n_unique (>= 0) or -1 on error.
//
// Ids are assigned in sorted order of the distinct values, so integer
// id comparison equals lexicographic comparison — the same invariant
// as presto_tpu_torch.page.Dictionary (byte-wise compare of utf-8
// matches Python str comparison for the code points it stores).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <vector>

extern "C" {

int64_t dict_encode(const char* blob, const int64_t* offsets, int64_t n,
                    const uint8_t* valid, int32_t* ids_out,
                    int64_t* uniq_repr_out) {
    if (n < 0 || !blob || !offsets || !ids_out || !uniq_repr_out)
        return -1;
    std::unordered_map<std::string_view, int64_t> first;  // value -> slot
    // modest initial sizing: cardinality is usually far below the row
    // count (reserving ~n buckets would allocate tens of MB per call)
    first.reserve(static_cast<size_t>(std::min<int64_t>(n, 1 << 16)));
    std::vector<std::string_view> uniq;
    std::vector<int64_t> repr_row;
    std::vector<int64_t> slot_of_row(static_cast<size_t>(n), -1);
    for (int64_t i = 0; i < n; ++i) {
        if (valid && !valid[i]) continue;
        std::string_view s(blob + offsets[i],
                           static_cast<size_t>(offsets[i + 1] - offsets[i]));
        auto it = first.find(s);
        if (it == first.end()) {
            int64_t slot = static_cast<int64_t>(uniq.size());
            first.emplace(s, slot);
            uniq.push_back(s);
            repr_row.push_back(i);
            slot_of_row[static_cast<size_t>(i)] = slot;
        } else {
            slot_of_row[static_cast<size_t>(i)] = it->second;
        }
    }
    const int64_t n_unique = static_cast<int64_t>(uniq.size());
    // sorted permutation of the unique values (byte-wise lexicographic)
    std::vector<int64_t> order(static_cast<size_t>(n_unique));
    for (int64_t i = 0; i < n_unique; ++i) order[static_cast<size_t>(i)] = i;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return uniq[static_cast<size_t>(a)] < uniq[static_cast<size_t>(b)];
    });
    std::vector<int32_t> rank(static_cast<size_t>(n_unique));
    for (int64_t r = 0; r < n_unique; ++r) {
        rank[static_cast<size_t>(order[static_cast<size_t>(r)])] =
            static_cast<int32_t>(r);
        uniq_repr_out[r] = repr_row[static_cast<size_t>(order[static_cast<size_t>(r)])];
    }
    for (int64_t i = 0; i < n; ++i) {
        int64_t slot = slot_of_row[static_cast<size_t>(i)];
        ids_out[i] = slot < 0 ? -1 : rank[static_cast<size_t>(slot)];
    }
    return n_unique;
}

}  // extern "C"

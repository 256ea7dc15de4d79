// The native packing plane: the greedy knapsack and the packed-row
// assembly of iadr1_tpu_torch/data/packing.py in C++, run once an epoch over
// the whole corpus (the Python twin is that module's use_native=False path).
//
// Built by the host C++ compiler into build/native/libdataplane.so at first
// use and loaded with ctypes (iadr1_tpu_torch/data/native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Greedy knapsack: partition `lengths[n]` into bins of capacity `capacity`,
// repeatedly stuffing each bin with the largest remaining length that fits
// (binary search over the sorted pool).  Outputs, per packed item in bin
// order: the original item index (`out_indices`), and per bin the item
// count (`out_bin_sizes`).  Returns the number of bins.
//
// out_indices must hold n entries; out_bin_sizes up to n entries.
int64_t greedy_knapsack(const int64_t* lengths, int64_t n, int64_t capacity,
                        int64_t* out_indices, int64_t* out_bin_sizes) {
  // sort (length, original_index) ascending by length, stable on index
  std::vector<std::pair<int64_t, int64_t>> pool(n);
  for (int64_t i = 0; i < n; ++i) pool[i] = {lengths[i], i};
  std::stable_sort(pool.begin(), pool.end(),
                   [](const auto& a, const auto& b) { return a.first < b.first; });

  // "alive" pool as a vector we shrink from; binary search on prefix
  int64_t n_bins = 0;
  int64_t out_pos = 0;
  std::vector<std::pair<int64_t, int64_t>> alive(pool);
  while (!alive.empty()) {
    int64_t remaining = capacity;
    int64_t count = 0;
    while (true) {
      // largest element with length <= remaining: upper_bound - 1
      auto it = std::upper_bound(
          alive.begin(), alive.end(), remaining,
          [](int64_t cap, const auto& p) { return cap < p.first; });
      if (it == alive.begin()) break;
      --it;
      remaining -= it->first;
      out_indices[out_pos++] = it->second;
      ++count;
      alive.erase(it);  // O(n) shift; pools are small relative to tokens
    }
    out_bin_sizes[n_bins++] = count;
  }
  return n_bins;
}

// Assemble packed rows: given the flat token/label streams (`tokens`,
// `labels` with per-example offsets `offsets[n+1]`), the pack order
// (`indices` from greedy_knapsack) and `bin_sizes[n_bins]`, fill the
// [n_bins, cutoff] int32 outputs: input_ids (pad_id-padded), labels
// (ignore_index-padded), segment_ids (1-based per segment, 0 pad) and
// position_ids (restarting per segment).
void pack_rows(const int32_t* tokens, const int32_t* labels,
               const int64_t* offsets, const int64_t* indices,
               const int64_t* bin_sizes, int64_t n_bins, int64_t cutoff,
               int32_t pad_id, int32_t ignore_index,
               int32_t* out_ids, int32_t* out_labels, int32_t* out_segments,
               int32_t* out_positions) {
  int64_t item = 0;
  for (int64_t b = 0; b < n_bins; ++b) {
    int32_t* row_ids = out_ids + b * cutoff;
    int32_t* row_labels = out_labels + b * cutoff;
    int32_t* row_segs = out_segments + b * cutoff;
    int32_t* row_pos = out_positions + b * cutoff;
    int64_t col = 0;
    for (int64_t s = 0; s < bin_sizes[b]; ++s, ++item) {
      const int64_t idx = indices[item];
      const int64_t start = offsets[idx];
      const int64_t len = offsets[idx + 1] - start;
      std::memcpy(row_ids + col, tokens + start, len * sizeof(int32_t));
      std::memcpy(row_labels + col, labels + start, len * sizeof(int32_t));
      for (int64_t t = 0; t < len; ++t) {
        row_segs[col + t] = static_cast<int32_t>(s + 1);
        row_pos[col + t] = static_cast<int32_t>(t);
      }
      col += len;
    }
    for (int64_t t = col; t < cutoff; ++t) {
      row_ids[t] = pad_id;
      row_labels[t] = ignore_index;
      row_segs[t] = 0;
      row_pos[t] = 0;
    }
  }
}

}  // extern "C"

// sbr-rs-tpu native data-layer backend.
//
// Native counterpart of the reference's Rust data layer
// (reference src/data.rs, src/datasets.rs): the device computes, the host
// feeds it — this library makes the host side native. It implements the
// hot host-path operations behind a plain C ABI consumed via ctypes
// (sbr_rs_tpu/_native.py):
//
//   * CSV interaction parsing (user_id,item_id,rating,timestamp; rating
//     ignored — implicit feedback, reference src/data.rs:16-51),
//   * stable (user_id, timestamp) ordering for CSR-by-user compression
//     (reference src/data.rs:236-265),
//   * first-chunk-smallest window extraction into padded [N, T] int32
//     next-item-prediction batches (reference src/data.rs:406-432 chunking;
//     windows of length > 2 kept, src/models/sequence_model.rs:76-83).
//
// All functions are allocation-free on the C side: callers (numpy) own the
// buffers. Two-phase count/fill where output sizes are data-dependent.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <vector>

// The library is built with -fvisibility=hidden; only the C ABI below is
// exported.
#define SBR_EXPORT __attribute__((visibility("default")))

extern "C" {

// ---------------------------------------------------------------------------
// CSV parsing
// ---------------------------------------------------------------------------

// Count data rows (excluding the header) in a CSV file. Returns -1 on IO
// error. The first line is always the header; a data row is any later line
// containing at least one digit.
SBR_EXPORT int64_t sbr_csv_count_rows(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t rows = 0;
  std::vector<char> buf(1 << 20);
  bool in_header = true;
  bool line_has_data = false;
  size_t got;
  while ((got = std::fread(buf.data(), 1, buf.size(), f)) > 0) {
    for (size_t i = 0; i < got; ++i) {
      char c = buf[i];
      if (c == '\n') {
        if (!in_header && line_has_data) ++rows;
        in_header = false;
        line_has_data = false;
      } else if (c >= '0' && c <= '9') {
        line_has_data = true;
      }
    }
  }
  if (!in_header && line_has_data) ++rows;
  std::fclose(f);
  return rows;
}

// Parse up to `cap` rows of `user_id,item_id,rating,timestamp` (header
// skipped, rating ignored). Returns rows written, or -1 on error.
SBR_EXPORT int64_t sbr_csv_parse(const char* path, int64_t* users, int64_t* items,
                      int64_t* timestamps, int64_t cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::vector<char> data;
  {
    std::vector<char> buf(1 << 20);
    size_t got;
    while ((got = std::fread(buf.data(), 1, buf.size(), f)) > 0)
      data.insert(data.end(), buf.data(), buf.data() + got);
    std::fclose(f);
  }
  const char* p = data.data();
  const char* end = p + data.size();
  // Skip header line.
  while (p < end && *p != '\n') ++p;
  if (p < end) ++p;

  int64_t n = 0;
  while (p < end && n < cap) {
    // Parse one line: up to 4 comma-separated integer fields.
    int64_t fields[4] = {0, 0, 0, 0};
    int nf = 0;
    bool any_digit = false;
    while (p < end && *p != '\n') {
      if (*p >= '0' && *p <= '9') {
        int64_t v = 0;
        while (p < end && *p >= '0' && *p <= '9') {
          v = v * 10 + (*p - '0');
          ++p;
        }
        if (nf < 4) fields[nf] = v;
        any_digit = true;
      } else {
        if (*p == ',') ++nf;
        ++p;
      }
    }
    if (p < end) ++p;  // consume '\n'
    if (!any_digit) continue;
    // A data line must have all 4 comma-separated fields (3 commas). The
    // numpy loadtxt fallback raises on short rows; silently zero-filling a
    // missing timestamp here would diverge from it.
    if (nf < 3) return -1;
    users[n] = fields[0];
    items[n] = fields[1];
    timestamps[n] = fields[3];  // rating (fields[2]) ignored
    ++n;
  }
  return n;
}

// ---------------------------------------------------------------------------
// CSR compression ordering
// ---------------------------------------------------------------------------

// Write into `order` the stable argsort of rows by (user_id, timestamp) —
// equal keys keep input order, matching Rust's stable sort_by
// (reference src/data.rs:236-265).
SBR_EXPORT void sbr_stable_order_by_user_ts(int64_t n, const int64_t* users,
                                 const int64_t* timestamps, int64_t* order) {
  std::iota(order, order + n, int64_t{0});
  std::stable_sort(order, order + n, [&](int64_t a, int64_t b) {
    if (users[a] != users[b]) return users[a] < users[b];
    return timestamps[a] < timestamps[b];
  });
}

// ---------------------------------------------------------------------------
// Window extraction
// ---------------------------------------------------------------------------

// Number of first-chunk-smallest windows of max length T and min length
// `min_len` over the CSR user histories.
SBR_EXPORT int64_t sbr_count_windows(int64_t num_users, const int64_t* user_pointers,
                          int64_t T, int64_t min_len) {
  int64_t count = 0;
  for (int64_t u = 0; u < num_users; ++u) {
    int64_t len = user_pointers[u + 1] - user_pointers[u];
    if (len <= 0) continue;
    int64_t k = (len + T - 1) / T;     // windows for this user
    int64_t first = len - (k - 1) * T;  // first (smallest) window length
    // Every chunk must individually pass the min_len filter (the fill pass
    // rejects per chunk): the k-1 trailing chunks are exactly T long.
    count += (T >= min_len ? k - 1 : 0) + (first >= min_len ? 1 : 0);
  }
  return count;
}

// Fill padded [N, T] next-item-prediction batches from CSR histories.
// inputs[n,t] = w[t], targets[n,t] = w[t+1], mask[n,t] = 1 for supervised
// timesteps t < len(w)-1; zero elsewhere. lengths[n] = len(w)-1 supervised
// steps (the reference's per-sequence example count,
// src/models/sequence_model.rs:158). Returns rows written.
SBR_EXPORT int64_t sbr_fill_windows(int64_t num_users, const int64_t* user_pointers,
                         const int64_t* item_ids, int64_t T, int64_t min_len,
                         int32_t* inputs, int32_t* targets, float* mask,
                         int32_t* lengths, int64_t cap) {
  int64_t n = 0;
  for (int64_t u = 0; u < num_users; ++u) {
    int64_t start = user_pointers[u];
    int64_t stop = user_pointers[u + 1];
    int64_t idx = start;
    while (idx < stop && n < cap) {
      int64_t rem = (stop - idx) % T;
      int64_t size = rem == 0 ? T : rem;  // first chunk smallest
      if (size >= min_len) {
        int32_t* in_row = inputs + n * T;
        int32_t* tg_row = targets + n * T;
        float* mk_row = mask + n * T;
        int64_t sup = size - 1;  // supervised timesteps
        for (int64_t t = 0; t < sup; ++t) {
          in_row[t] = static_cast<int32_t>(item_ids[idx + t]);
          tg_row[t] = static_cast<int32_t>(item_ids[idx + t + 1]);
          mk_row[t] = 1.0f;
        }
        std::memset(in_row + sup, 0, sizeof(int32_t) * (T - sup));
        std::memset(tg_row + sup, 0, sizeof(int32_t) * (T - sup));
        std::memset(mk_row + sup, 0, sizeof(float) * (T - sup));
        lengths[n] = static_cast<int32_t>(sup);
        ++n;
      }
      idx += size;
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// Window packing (first-fit decreasing)
// ---------------------------------------------------------------------------

// Plan the packing of items of `lengths[n]` slots into bins of capacity T
// using first-fit decreasing with newest-bin-first probing (the exact
// algorithm of sbr_rs_tpu.data._pack_plan_numpy; pack_streams calls it with
// slot sizes = supervised steps + 1 and capacity T + 1). Items of size < 1
// are skipped (bin_of = -1). Writes bin_of[n] and offset_of[n]; returns the
// number of bins.
SBR_EXPORT int64_t sbr_pack_plan(int64_t n, const int32_t* lengths, int64_t T,
                                 int64_t* bin_of, int64_t* offset_of) {
  // Stable descending sort of window indices by length.
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), int64_t{0});
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return lengths[a] > lengths[b];
  });

  std::vector<int64_t> bin_fill;
  bin_fill.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t w = order[i];
    int64_t L = lengths[w];
    if (L < 1) {
      bin_of[w] = -1;
      offset_of[w] = 0;
      continue;
    }
    bool placed = false;
    for (int64_t b = static_cast<int64_t>(bin_fill.size()) - 1; b >= 0; --b) {
      if (bin_fill[b] + L <= T) {
        bin_of[w] = b;
        offset_of[w] = bin_fill[b];
        bin_fill[b] += L;
        placed = true;
        break;
      }
    }
    if (!placed) {
      bin_of[w] = static_cast<int64_t>(bin_fill.size());
      offset_of[w] = 0;
      bin_fill.push_back(L);
    }
  }
  return static_cast<int64_t>(bin_fill.size());
}

// ---------------------------------------------------------------------------
// Version / self-check
// ---------------------------------------------------------------------------

SBR_EXPORT int sbr_native_abi_version() { return 3; }

}  // extern "C"

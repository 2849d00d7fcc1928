// hsrans_tpu native host runtime.
//
// TPU-native replacement for the reference's host-side native layer: the
// compute path lives in JAX/Pallas on the TPU, but the framework keeps a
// C++ runtime for the host work that surrounds it — histogram observation,
// exact float32 histogram normalization (hist.cpp semantics), the greedy
// block-segmentation cost model, wire-format mux/demux and a thread pool
// for overlapping host prep with device execution.
//
// Exposed as a plain C ABI consumed via ctypes (hsrans_tpu/runtime/native.py).
// Build: make -C native   ->  native/libhsrans_native.so

#include <atomic>
#include <condition_variable>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Hashing (used by tests for golden-blob identity) --------------------------

uint64_t hsr_fnv1a(const uint8_t *data, uint64_t size) {
  uint64_t h = 1469598103934665603ull;
  for (uint64_t i = 0; i < size; i++) {
    h ^= data[i];
    h *= 1099511628211ull;
  }
  return h;
}

// ---------------------------------------------------------------------------
// Histogram -----------------------------------------------------------------

// Byte-frequency count with 4 split accumulators to break the store-to-load
// dependency chain (same optimization class as the reference's hot loops;
// semantics of observe_hist, /root/reference/src/hist.cpp:8-14).
void hsr_observe_hist(const uint8_t *data, uint64_t size, uint32_t hist[256]) {
  uint32_t h0[256] = {}, h1[256] = {}, h2[256] = {}, h3[256] = {};
  uint64_t i = 0;
  for (; i + 4 <= size; i += 4) {
    h0[data[i]]++;
    h1[data[i + 1]]++;
    h2[data[i + 2]]++;
    h3[data[i + 3]]++;
  }
  for (; i < size; i++)
    h0[data[i]]++;
  for (int j = 0; j < 256; j++)
    hist[j] = h0[j] + h1[j] + h2[j] + h3[j];
}

// Normalize counts to sum exactly 2^bits.  Bit-identical to the reference's
// float32 scale + heap-sorted steal/charity rebalance (hist.cpp:16-215);
// the heap-sort tie-break order is wire-visible so it must match exactly.
static void heapify(uint8_t *idx, const uint16_t *val, int64_t n, int64_t i) {
  for (;;) {
    const int64_t left = 2 * i + 1, right = 2 * i + 2;
    int64_t largest = i;
    if (left < n && val[idx[left]] > val[idx[largest]]) largest = left;
    if (right < n && val[idx[right]] > val[idx[largest]]) largest = right;
    if (largest == i) return;
    const uint8_t t = idx[i]; idx[i] = idx[largest]; idx[largest] = t;
    i = largest;
  }
}

void hsr_normalize_hist(const uint32_t *hist, uint64_t data_bytes, uint32_t bits,
                        uint16_t out_freq[256], uint16_t out_cumul[256]) {
  const uint32_t total = 1u << bits;
  const float mul = (float)total / (float)data_bytes;

  uint16_t capped[256];
  uint64_t capped_sum = 0;
  for (int i = 0; i < 256; i++) {
    capped[i] = (uint16_t)(hist[i] * mul + 0.5f);
    if (capped[i] == 0 && hist[i]) capped[i] = 1;
    capped_sum += capped[i];
  }

  if (capped_sum != total) {
    uint8_t idx[256];
    for (int i = 0; i < 256; i++) idx[i] = (uint8_t)i;
    for (int64_t i = 127; i >= 0; i--) heapify(idx, capped, 256, i);
    for (int64_t i = 255; i >= 0; i--) {
      const uint8_t t = idx[0]; idx[0] = idx[i]; idx[i] = t;
      heapify(idx, capped, i, 0);
    }

    int64_t min_two = 0;
    for (int64_t i = 0; i < 256; i++)
      if (capped[idx[i]] >= 2) { min_two = i; break; }

    while (capped_sum > total) {
      bool done = false;
      for (int64_t i = min_two; i < 256; i++) {
        capped[idx[i]]--;
        if (--capped_sum == total) { done = true; break; }
      }
      if (done) break;
      for (int64_t i = min_two; i < 256; i++)
        if (capped[idx[i]] >= 2) { min_two = i; break; }
    }

    while (capped_sum < total) {
      bool done = false;
      for (int64_t i = 255; i >= min_two; i--) {
        capped[idx[i]]++;
        if (++capped_sum == total) { done = true; break; }
      }
      if (done) break;
      for (int64_t i = min_two; i < 256; i++)
        if (capped[idx[i]] >= 2) { min_two = i; break; }
    }
  }

  uint32_t counter = 0;
  for (int i = 0; i < 256; i++) {
    out_cumul[i] = (uint16_t)counter;
    out_freq[i] = capped[i];
    counter += capped[i];
  }
}

// ---------------------------------------------------------------------------
// Batched uniform-block histograms (threaded) --------------------------------
//
// observe + normalize for B consecutive uniform blocks in one call — the
// host prep for the device block encoders (kernels/mt64_encode.py,
// kernels/tpx_encode.py).  The final (remainder) block is included; an
// empty tail block gets the 1-symbol histogram.

struct HistBlocksJob {
  const uint8_t *data;
  uint64_t block_size, length;
  uint32_t bits;
  uint16_t *out_freq;   // [n_blocks][256]
  uint16_t *out_cumul;  // [n_blocks][256]
  std::atomic<int64_t> next{0};
  int64_t n_blocks;
};

static void hist_blocks_worker(void *arg) {
  auto *j = (HistBlocksJob *)arg;
  uint32_t counts[256];
  for (;;) {
    const int64_t k = j->next.fetch_add(1);
    if (k >= j->n_blocks) return;
    const uint64_t start = (uint64_t)k * j->block_size;
    const uint64_t end = start + j->block_size < j->length ? start + j->block_size : j->length;
    memset(counts, 0, sizeof(counts));
    if (end > start) {
      hsr_observe_hist(j->data + start, end - start, counts);
      hsr_normalize_hist(counts, end - start, j->bits, j->out_freq + 256 * k,
                         j->out_cumul + 256 * k);
    } else {
      counts[0] = 1;
      hsr_normalize_hist(counts, 1, j->bits, j->out_freq + 256 * k, j->out_cumul + 256 * k);
    }
  }
}

void hsr_hist_blocks(const uint8_t *data, uint64_t length, uint64_t block_size,
                     uint32_t bits, int64_t n_blocks, uint16_t *out_freq,
                     uint16_t *out_cumul, int32_t threads) {
  HistBlocksJob job;
  job.data = data;
  job.block_size = block_size;
  job.length = length;
  job.bits = bits;
  job.out_freq = out_freq;
  job.out_cumul = out_cumul;
  job.n_blocks = n_blocks;
  if (threads <= 0) threads = (int32_t)std::thread::hardware_concurrency();
  if (threads <= 1 || n_blocks < 4) {
    hist_blocks_worker(&job);
    return;
  }
  std::vector<std::thread> ws;
  for (int32_t t = 0; t < threads; t++) ws.emplace_back(hist_blocks_worker, &job);
  for (auto &w : ws) w.join();
}

// ---------------------------------------------------------------------------
// Greedy block segmentation (the block/mt codec planner) ---------------------
//
// Reproduces the backward greedy segmentation of block_rANS32x64_16w_encode
// (/root/reference/src/block_rANS32x64_16w_encode.cpp:137-349) — including
// its single-symbol RLE detection and _CanExtendHist log2 cost model — but
// as a *planner only*: it emits (block_start, block_size, is_single, sym,
// freq[256]) rows.  The actual entropy coding runs on the TPU.
//
// mode: 0 = block codec constants, 1 = mt codec constants (different
// HistReplaceMul tables and a header-amortization term, mt_...enc.cpp:21-26,102).

// Tuning tables, bits 10..15.  The 64- and 32-state block codecs were tuned
// separately in the reference (block_rANS32x64_16w_encode.cpp:21-39 vs
// block_rANS32x32_16w_encode.cpp:21-39); the mt codecs share one table.
static const uint16_t kHistReplaceMulBlock64[6] = {4000, 7730, 5600, 2500, 1500, 850};
static const uint16_t kHistReplaceMulBlock32[6] = {4000, 7730, 5600, 3120, 2087, 822};
static const uint16_t kHistReplaceMulMt[6] = {500, 500, 500, 500, 500, 50};
static const uint8_t kMinBlockBitsBlock64[6] = {20, 19, 16, 17, 17, 16};
static const uint8_t kMinBlockBitsBlock32[6] = {20, 19, 15, 17, 17, 18};
static const uint8_t kMinBlockBitsMt[6] = {16, 16, 16, 16, 16, 16};

struct SegPlanRow {
  uint64_t start, size;
  uint32_t is_single, symbol;
  uint16_t freq[256];
};

// _CanExtendHist (block_rANS32x64_16w_encode.cpp:58-133, mt variant :62-136).
// With the reference's SafeHistBitMax=0, IsSafeHist is always true: the
// "before" cost is weighted (count-1), and new symbols are rejected through
// the resulting NaN/inf in log2f(0) — old_freq entries are >= 1 here anyway
// because the provisional histogram injects 1s for absent symbols.
static bool can_extend_hist(const uint8_t *data, uint64_t next_off, uint64_t next_size,
                            const uint16_t *old_freq, uint32_t bits, uint32_t replace_mul,
                            uint64_t min_block_size, float header_bias, uint32_t *scratch) {
  memset(scratch, 0, sizeof(uint32_t) * 256);
  hsr_observe_hist(data + next_off, next_size, scratch);

  uint16_t new_freq[256], new_cumul[256];
  hsr_normalize_hist(scratch, min_block_size, bits, new_freq, new_cumul);

  const uint64_t total = 1ull << bits;
  const uint64_t replace_point = (total * replace_mul) >> 12;

  float cost_before = 0, cost_after = header_bias;
  for (int j = 0; j < 256; j++) {
    if (scratch[j] == 0) continue;
    cost_before -= (scratch[j] - 1) * log2f(old_freq[j] / (float)total);
    cost_after -= scratch[j] * log2f(new_freq[j] / (float)total);
  }
  return (cost_before - cost_after) < (float)replace_point;
}

// Greedy backward segmentation planner; returns rows in processing order
// (last input block first), or 0 on error.
//
// The reference's `blockBackPoint` is only advanced after the next block's
// final histogram has been observed, so each block's *final* histogram spans
// its own bytes plus the following block's (one-block look-ahead); the
// provisional histogram (used by the cost model) spans only the initial
// window.  Both quirks are wire-visible and reproduced here.
int64_t hsr_plan_blocks(const uint8_t *data, uint64_t length, uint32_t bits,
                        uint32_t mode, uint64_t state_count,
                        SegPlanRow *rows, int64_t max_rows) {
  if (length == 0 || bits < 10 || bits > 15) return 0;
  const uint32_t replace_mul =
      (mode == 1 ? kHistReplaceMulMt
                 : (state_count == 32 ? kHistReplaceMulBlock32 : kHistReplaceMulBlock64))[bits - 10];
  const uint64_t min_block =
      1ull << (mode == 1 ? kMinBlockBitsMt
                         : (state_count == 32 ? kMinBlockBitsBlock32 : kMinBlockBitsBlock64))[bits - 10];
  const bool has_max_block = mode == 1;
  const uint64_t max_block = 1ull << 25;
  const uint64_t sc_mask = state_count - 1;
  // mt cost model amortizes the per-block header (mt_...encode.cpp:102).
  const float header_bias =
      mode == 1 ? (float)(512 + state_count * 4 + 16) * 0.5f : 0.0f;

  uint32_t sym_count[256], scratch[256];
  uint16_t freq[256], cumul[256];
  int64_t n_rows = 0;

  uint64_t target = ((length - 1) & ~sc_mask) & ~(min_block - 1);
  if (target > min_block) target -= min_block;
  uint64_t block_end = length;      // end of the block being planned
  uint64_t lookahead_end = length;  // reference's blockBackPoint at plan time

  hsr_observe_hist(data + target, block_end - target, sym_count);
  bool first = true;

  for (;;) {
    uint64_t num_symbols = 0;
    uint32_t selected = 0;
    for (int j = 0; j < 256; j++)
      if (sym_count[j]) { num_symbols++; selected = (uint32_t)j; }

    if (num_symbols == 1) {
      int64_t idx = (int64_t)target - 1;
      while (idx >= 0 && data[idx] == (uint8_t)selected) idx--;
      target = (uint64_t)(idx + 1);
      target = (target + state_count - 1) & ~sc_mask;
    } else {
      // Provisional hist: inject 1 for absent symbols (safe-hist), divisor =
      // real span (+injected) for the first block, min_block afterwards
      // (block_...encode.cpp:187-201 vs :327-332).
      uint64_t extra = 0;
      for (int j = 0; j < 256; j++)
        if (sym_count[j] == 0) { sym_count[j] = 1; extra++; }
      const uint64_t divisor = first ? (block_end - target + extra) : min_block;
      hsr_normalize_hist(sym_count, divisor, bits, freq, cumul);

      while (target > 0 &&
             (!has_max_block || lookahead_end - target < max_block)) {
        if (!can_extend_hist(data, target - min_block, min_block, freq, bits,
                             replace_mul, min_block, header_bias, scratch))
          break;
        target -= min_block;
      }

      // Final hist: re-observed over [target, blockBackPoint) where
      // blockBackPoint still points one block ahead (the look-ahead quirk).
      hsr_observe_hist(data + target, lookahead_end - target, sym_count);
      hsr_normalize_hist(sym_count, lookahead_end - target, bits, freq, cumul);
    }

    if (n_rows >= max_rows) return 0;
    SegPlanRow &row = rows[n_rows++];
    row.start = target;
    row.size = block_end - target;
    row.is_single = num_symbols == 1;
    row.symbol = selected;
    if (num_symbols != 1)
      memcpy(row.freq, freq, sizeof(freq));
    else
      memset(row.freq, 0, sizeof(row.freq));

    if (target == 0) break;

    // Window for the previous-in-input block (block_...encode.cpp:291-301).
    const uint64_t prev_end = target;
    lookahead_end = block_end;  // NOT yet advanced past the block just planned
    target = (target - 1) & ~(min_block - 1);
    if (target > 0 && prev_end - target < min_block * 2 / 3)
      target -= min_block;
    hsr_observe_hist(data + target, prev_end - target, sym_count);
    block_end = prev_end;
    first = false;
  }

  return n_rows;
}

// ---------------------------------------------------------------------------
// Thread pool (reference: thread_pool.cpp) -----------------------------------
//
// Retained for CPU-side pipelining (chunked file IO + hashing + host
// histogramming overlap).  Device parallelism is jax.sharding, not threads.

struct ThreadPool {
  std::vector<std::thread> workers;
  std::queue<std::function<void()>> tasks;
  std::mutex m;
  std::condition_variable cv;
  std::atomic<int64_t> inflight{0};
  bool stop = false;
};

void *hsr_pool_new(int32_t threads) {
  auto *p = new ThreadPool();
  if (threads <= 0) threads = (int32_t)std::thread::hardware_concurrency();
  for (int32_t i = 0; i < threads; i++) {
    p->workers.emplace_back([p] {
      for (;;) {
        std::function<void()> task;
        {
          std::unique_lock<std::mutex> lk(p->m);
          p->cv.wait(lk, [p] { return p->stop || !p->tasks.empty(); });
          if (p->stop && p->tasks.empty()) return;
          task = std::move(p->tasks.front());
          p->tasks.pop();
        }
        task();
        p->inflight.fetch_sub(1);
      }
    });
  }
  return p;
}

void hsr_pool_destroy(void *pool) {
  auto *p = (ThreadPool *)pool;
  {
    std::lock_guard<std::mutex> lk(p->m);
    p->stop = true;
  }
  p->cv.notify_all();
  for (auto &w : p->workers) w.join();
  delete p;
}

typedef void (*hsr_task_fn)(void *arg);

void hsr_pool_add(void *pool, hsr_task_fn fn, void *arg) {
  auto *p = (ThreadPool *)pool;
  p->inflight.fetch_add(1);
  {
    std::lock_guard<std::mutex> lk(p->m);
    p->tasks.emplace([fn, arg] { fn(arg); });
  }
  p->cv.notify_one();
}

void hsr_pool_await(void *pool) {
  auto *p = (ThreadPool *)pool;
  for (;;) {
    std::function<void()> task;
    {
      std::lock_guard<std::mutex> lk(p->m);
      if (!p->tasks.empty()) {
        task = std::move(p->tasks.front());
        p->tasks.pop();
      }
    }
    if (task) {
      task();
      p->inflight.fetch_sub(1);
      continue;
    }
    if (p->inflight.load() == 0) return;
    std::this_thread::yield();
  }
}

}  // extern "C"

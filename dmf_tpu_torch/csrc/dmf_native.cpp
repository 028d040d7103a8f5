// dmf_native: host-side native runtime of the PyTorch port (dmf_tpu_torch).
//
// A copy of the JAX package's native/dmf_native.cpp with the same C
// interface, built by dmf_tpu_torch/utils/native.py with g++ on first use.
// The reference's host hot loops are the Nyul percentile fit (pure-Python
// numpy over every pixel of every training image, preprocess_helpers.py:65-83)
// and the per-sample DataLoader worker pool (num_workers=11,
// prepare_single_model.py:141).  This library provides:
//   * nyul_fit      — exact per-sample/per-channel landmark percentiles via
//                     nth_element (O(P) per landmark, no full sort),
//                     multithreaded over (sample, channel) pairs, averaged
//                     into the (C, L) landmark matrix;
//   * percentiles   — the same kernel for a single array;
//   * gather_rows   — parallel strided row gather (batch assembly from a
//                     memory-mapped or in-memory tensor store);
//   * loader_*      — a threaded prefetching batch loader (below).
//
// Exposed with a plain C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// np.percentile 'linear' interpolation on a scratch copy of the data.
// Percentiles q in [0, 100]; results written to out[0..L).
void percentiles_of(const float* data, int64_t n, const double* q, int L,
                    double* out, std::vector<float>& scratch) {
  scratch.assign(data, data + n);
  for (int l = 0; l < L; ++l) {
    const double rank = q[l] / 100.0 * static_cast<double>(n - 1);
    const int64_t lo = static_cast<int64_t>(std::floor(rank));
    const int64_t hi = std::min<int64_t>(lo + 1, n - 1);
    const double frac = rank - static_cast<double>(lo);
    std::nth_element(scratch.begin(), scratch.begin() + lo, scratch.end());
    const float v_lo = scratch[lo];
    float v_hi = v_lo;
    if (hi != lo) {
      // hi-th order statistic is the min of the upper partition
      v_hi = *std::min_element(scratch.begin() + lo + 1, scratch.end());
    }
    out[l] = static_cast<double>(v_lo) +
             frac * (static_cast<double>(v_hi) - static_cast<double>(v_lo));
  }
}

void parallel_for(int64_t count, int n_threads,
                  const std::function<void(int64_t)>& fn) {
  if (n_threads <= 1 || count <= 1) {
    for (int64_t i = 0; i < count; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  const int workers = std::min<int64_t>(n_threads, count);
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        const int64_t i = next.fetch_add(1);
        if (i >= count) return;
        fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// images: (N, H, W, C) float32 channels-last.
// landmarks: L percentiles in [0, 100].
// out: (C, L) float64 — per-channel landmark averages over the N samples.
int nyul_fit(const float* images, int64_t n, int64_t h, int64_t w, int64_t c,
             const double* landmarks, int L, double* out, int n_threads) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || L <= 0) return -1;
  const int64_t pix = h * w;
  std::vector<double> per_sample(n * c * L);

  parallel_for(n * c, n_threads, [&](int64_t job) {
    const int64_t s = job / c;
    const int64_t ch = job % c;
    // gather one channel (strided by c in the NHWC layout)
    thread_local std::vector<float> chan;
    thread_local std::vector<float> scratch;
    chan.resize(pix);
    const float* base = images + s * pix * c + ch;
    for (int64_t p = 0; p < pix; ++p) chan[p] = base[p * c];
    percentiles_of(chan.data(), pix, landmarks, L,
                   per_sample.data() + job * L, scratch);
  });

  for (int64_t ch = 0; ch < c; ++ch) {
    for (int l = 0; l < L; ++l) {
      double acc = 0.0;
      for (int64_t s = 0; s < n; ++s) acc += per_sample[(s * c + ch) * L + l];
      out[ch * L + l] = acc / static_cast<double>(n);
    }
  }
  return 0;
}

// data: contiguous float32; percentiles over all n elements.
int percentiles(const float* data, int64_t n, const double* q, int L,
                double* out) {
  if (n <= 0 || L <= 0) return -1;
  std::vector<float> scratch;
  percentiles_of(data, n, q, L, out, scratch);
  return 0;
}

// Parallel batch gather: dst[i] = src[indices[i]] where each row has
// row_elems float32 elements.
int gather_rows(const float* src, const int64_t* indices, int64_t n_idx,
                int64_t row_elems, float* dst, int n_threads) {
  if (n_idx < 0 || row_elems <= 0) return -1;
  const size_t row_bytes = static_cast<size_t>(row_elems) * sizeof(float);
  parallel_for(n_idx, n_threads, [&](int64_t i) {
    std::memcpy(dst + i * row_elems, src + indices[i] * row_elems, row_bytes);
  });
  return 0;
}

// ABI/version probe for the ctypes loader.
int dmf_native_version() { return 1; }

}  // extern "C"


// ---------------------------------------------------------------------------
// Threaded prefetching batch loader — the native equivalent of the
// reference's DataLoader worker pool (num_workers=11,
// prepare_single_model.py:140-141): worker threads gather shuffled batches
// from K aligned float32 arrays (+ optional int32 labels) into a ring of
// pre-allocated slots ahead of the consumer; delivery is in batch order.
// ---------------------------------------------------------------------------

#include <condition_variable>
#include <mutex>
#include <random>

namespace {

struct LoaderSlot {
  std::vector<std::vector<float>> arrs;  // one buffer per float array
  std::vector<int32_t> labels;
  int64_t ordinal = -1;  // which batch this slot holds; -1 = free
  int64_t size = 0;      // rows filled (last batch may be short)
  bool ready = false;
};

struct Loader {
  std::vector<const float*> arrs;
  std::vector<int64_t> elems;  // per-row element count per array
  const int32_t* labels = nullptr;
  int64_t n_samples = 0, batch = 0, n_batches = 0;
  bool shuffle = false, drop_last = false;

  std::vector<int64_t> order;
  std::vector<LoaderSlot> slots;

  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for next ordinal
  std::condition_variable cv_free;    // workers wait for a slot in-window
  std::atomic<int64_t> next_fill{0};  // next batch ordinal to assemble
  int64_t next_consume = 0;           // next ordinal the consumer takes
  std::atomic<bool> stop{false};
  int n_threads = 1;
  std::vector<std::thread> workers;

  void fill(int64_t ordinal) {
    const int64_t start = ordinal * batch;
    const int64_t size = std::min(batch, n_samples - start);
    LoaderSlot* slot = nullptr;
    {
      std::unique_lock<std::mutex> lk(mu);
      // Only fill within the consume window: with more workers than slots,
      // high ordinals must not occupy every slot while the consumer waits
      // for the lowest one (classic reorder deadlock).
      cv_free.wait(lk, [&] {
        if (stop) return true;
        if (ordinal >= next_consume + static_cast<int64_t>(slots.size()))
          return false;
        for (auto& s : slots)
          if (s.ordinal < 0) { slot = &s; return true; }
        return false;
      });
      if (stop) return;
      slot->ordinal = ordinal;
      slot->ready = false;
    }
    for (int64_t i = 0; i < size; ++i) {
      const int64_t src = order[start + i];
      for (size_t a = 0; a < arrs.size(); ++a) {
        std::memcpy(slot->arrs[a].data() + i * elems[a],
                    arrs[a] + src * elems[a],
                    static_cast<size_t>(elems[a]) * sizeof(float));
      }
      if (labels) slot->labels[i] = labels[src];
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      slot->size = size;
      slot->ready = true;
    }
    cv_ready.notify_all();
  }

  void worker_loop() {
    for (;;) {
      const int64_t ordinal = next_fill.fetch_add(1);
      if (ordinal >= n_batches || stop) return;
      fill(ordinal);
    }
  }

  void start_epoch(uint64_t seed) {
    if (shuffle) {
      std::mt19937_64 rng(seed);
      std::shuffle(order.begin(), order.end(), rng);
    }
    next_fill.store(0);
    next_consume = 0;
    for (auto& s : slots) { s.ordinal = -1; s.ready = false; }
    workers.clear();
    for (int t = 0; t < n_threads; ++t)
      workers.emplace_back([this] { worker_loop(); });
  }

  void join_workers() {
    {
      // must hold the mutex while setting stop: a worker between its
      // wait-predicate check and blocking would otherwise miss the notify
      // (lost wakeup) and join() would hang forever
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_free.notify_all();
    for (auto& th : workers)
      if (th.joinable()) th.join();
    workers.clear();
    stop = false;
  }
};

}  // namespace

extern "C" {

// arrs: K base pointers to aligned (n_samples, elems[k]) float32 arrays.
// labels: optional (n_samples,) int32.  ring_slots batches are buffered;
// n_threads workers fill them ahead of the consumer.
void* loader_create(const float** arrs, const int64_t* elems, int n_arrs,
                    const int32_t* labels, int64_t n_samples, int64_t batch,
                    int shuffle, uint64_t seed, int drop_last, int ring_slots,
                    int n_threads) {
  if (!arrs || n_arrs <= 0 || n_samples <= 0 || batch <= 0) return nullptr;
  auto* L = new Loader();
  for (int a = 0; a < n_arrs; ++a) {
    if (!arrs[a] || elems[a] <= 0) { delete L; return nullptr; }
    L->arrs.push_back(arrs[a]);
    L->elems.push_back(elems[a]);
  }
  L->labels = labels;
  L->n_samples = n_samples;
  L->batch = batch;
  L->shuffle = shuffle != 0;
  L->drop_last = drop_last != 0;
  L->n_batches = drop_last ? n_samples / batch
                           : (n_samples + batch - 1) / batch;
  L->order.resize(n_samples);
  for (int64_t i = 0; i < n_samples; ++i) L->order[i] = i;
  L->slots.resize(std::max(2, ring_slots));
  for (auto& s : L->slots) {
    s.arrs.resize(n_arrs);
    for (int a = 0; a < n_arrs; ++a) s.arrs[a].resize(batch * elems[a]);
    if (labels) s.labels.resize(batch);
  }
  L->n_threads = std::max(1, n_threads);
  L->workers.reserve(L->n_threads);
  L->start_epoch(seed);
  return L;
}

// Blocks until the next in-order batch is ready.  Returns its row count
// (0 at epoch end); fills arrs_out[0..K) and labels_out, and the slot id
// to release once the buffers have been consumed.
int64_t loader_next(void* loader, float** arrs_out, int32_t** labels_out,
                    int64_t* slot_id) {
  auto* L = static_cast<Loader*>(loader);
  if (L->next_consume >= L->n_batches) return 0;
  LoaderSlot* slot = nullptr;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] {
      for (size_t i = 0; i < L->slots.size(); ++i) {
        auto& s = L->slots[i];
        if (s.ready && s.ordinal == L->next_consume) {
          slot = &s;
          *slot_id = static_cast<int64_t>(i);
          return true;
        }
      }
      return false;
    });
    L->next_consume += 1;
  }
  L->cv_free.notify_all();  // the consume window advanced
  for (size_t a = 0; a < L->arrs.size(); ++a)
    arrs_out[a] = slot->arrs[a].data();
  if (labels_out)
    *labels_out = L->labels ? slot->labels.data() : nullptr;
  return slot->size;
}

// Returns the slot to the free pool (call after copying/uploading).
void loader_release(void* loader, int64_t slot_id) {
  auto* L = static_cast<Loader*>(loader);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->slots[slot_id].ordinal = -1;
    L->slots[slot_id].ready = false;
  }
  L->cv_free.notify_all();
}

// Reshuffles (if enabled) and restarts the prefetch threads for a new epoch.
void loader_new_epoch(void* loader, uint64_t seed) {
  auto* L = static_cast<Loader*>(loader);
  L->join_workers();
  L->start_epoch(seed);
}

void loader_destroy(void* loader) {
  auto* L = static_cast<Loader*>(loader);
  L->join_workers();
  delete L;
}

}  // extern "C"

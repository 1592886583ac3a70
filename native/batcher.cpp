// Native host-side batch assembler for the input pipeline.
//
// The reference's secondary hot path is Python-side batch assembly: per-step
// list indexing + np.array construction + normalize (reference
// src/bigacgan/data_utils.py:62-84; SURVEY.md §3.1 "the secondary hot path").
// This library replaces it with a multithreaded gather + uint8->[-1,1] float
// conversion into a caller-owned buffer, so the host keeps the GPU fed while
// the step runs.
//
// Build: make -C native   (produces libbatcher.so)
// ABI: plain C, consumed via ctypes from scrabblegan/data/native.py.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void gather_range(const uint8_t* imgs, const int64_t* indices, int64_t start,
                  int64_t end, int64_t sample_elems, float* out) {
  for (int64_t i = start; i < end; ++i) {
    const uint8_t* src = imgs + indices[i] * sample_elems;
    float* dst = out + i * sample_elems;
    for (int64_t j = 0; j < sample_elems; ++j) {
      // exact division (not reciprocal multiply): x=255 must map to exactly
      // +1.0 so downstream [-1, 1] range checks hold bit-for-bit vs numpy
      dst[j] = (static_cast<float>(src[j]) - 127.5f) / 127.5f;
    }
  }
}

}  // namespace

extern "C" {

// imgs: (num_samples, sample_elems) uint8, C-contiguous.
// indices: (batch,) int64 rows to gather.
// out: (batch, sample_elems) float32, caller-allocated.
// Normalization: (x - 127.5) / 127.5 == x/127.5 - 1 (data_utils.py:82).
void sg_assemble_batch(const uint8_t* imgs, const int64_t* indices,
                       int64_t batch, int64_t sample_elems, float* out,
                       int num_threads) {
  if (num_threads <= 1 || batch < 4) {
    gather_range(imgs, indices, 0, batch, sample_elems, out);
    return;
  }
  if (num_threads > batch) num_threads = static_cast<int>(batch);
  std::vector<std::thread> workers;
  workers.reserve(num_threads);
  const int64_t chunk = (batch + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int64_t start = t * chunk;
    const int64_t end = std::min(batch, start + chunk);
    if (start >= end) break;
    workers.emplace_back(gather_range, imgs, indices, start, end, sample_elems,
                         out);
  }
  for (auto& w : workers) w.join();
}

// Gather int32 label rows: labels (num_samples, label_len) -> out (batch, label_len).
void sg_gather_labels(const int32_t* labels, const int64_t* indices,
                      int64_t batch, int64_t label_len, int32_t* out) {
  for (int64_t i = 0; i < batch; ++i) {
    std::memcpy(out + i * label_len, labels + indices[i] * label_len,
                label_len * sizeof(int32_t));
  }
}

int sg_abi_version() { return 1; }

}  // extern "C"

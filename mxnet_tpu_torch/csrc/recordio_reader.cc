// Native RecordIO reader with a threaded prefetcher: host code of the
// port's data path (counterpart of mxnet_tpu/native/recordio_reader.cc,
// the same algorithm, so both give the same record order).
//
// MXNet 1.x's C++ data-input layer: dmlc::RecordIOReader's magic + length
// framing, the shard-partitioned parser of src/io/iter_image_recordio_2.cc
// and dmlc::ThreadedIter's double buffering.  This library owns file IO,
// record scanning, num_parts/part_index sharding, the per-epoch shuffle
// (std::mt19937_64 seeded with seed + epoch) and a background thread that
// fills a bounded batch queue; decode and augmentation stay in Python,
// where the GIL-free IO overlaps them.
//
// Built with the host compiler (g++, not nvcc) by mxnet_tpu_torch/_kernels.py
// into _build/ and bound with ctypes through its C ABI.
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

struct RecordRef {
  uint64_t offset;  // payload start
  uint32_t length;  // payload bytes
};

struct Batch {
  std::vector<uint8_t> data;      // concatenated payloads
  std::vector<uint64_t> lengths;  // per-record lengths
};

class Reader {
 public:
  Reader(const char* path, int batch_size, int num_parts, int part_index,
         int shuffle, uint64_t seed, int queue_depth)
      : path_(path),
        batch_size_(batch_size),
        shuffle_(shuffle),
        seed_(seed),
        queue_depth_(queue_depth < 1 ? 2 : queue_depth) {
    ScanOffsets();
    // shard: contiguous range per part (reference: num_parts/part_index)
    size_t n = records_.size();
    size_t per = (n + num_parts - 1) / num_parts;
    size_t begin = per * part_index;
    size_t end = begin + per < n ? begin + per : n;
    if (begin > n) begin = n;
    shard_.assign(records_.begin() + begin, records_.begin() + end);
    order_.resize(shard_.size());
    for (size_t i = 0; i < shard_.size(); ++i) order_[i] = i;
    StartEpoch(0);
    worker_ = std::thread([this] { this->WorkerLoop(); });
  }

  ~Reader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    cv_data_.notify_all();
    if (worker_.joinable()) worker_.join();
  }

  int64_t num_records() const { return static_cast<int64_t>(shard_.size()); }
  int64_t read_errors() const {
    return read_errors_.load(std::memory_order_relaxed);
  }

  bool open_ok() const { return open_ok_; }

  void Reset(uint64_t epoch) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      pending_reset_ = true;
      reset_epoch_ = epoch;
      queue_.clear();
      // clear immediately so a next_batch racing the worker blocks for the
      // new epoch instead of reporting a stale end-of-epoch
      epoch_done_in_queue_ = false;
    }
    cv_space_.notify_all();
  }

  // Returns 0 on success, 1 on end-of-epoch. Caller frees nothing; the
  // returned pointers are valid until the next NextBatch/Reset call on the
  // SAME handle (data is moved into current_).
  int NextBatch(const uint8_t** data, const uint64_t** lengths,
                uint64_t* n_records, uint64_t* total_bytes) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_data_.wait(lk, [this] {
      return stop_ || !queue_.empty() || epoch_done_in_queue_;
    });
    if (queue_.empty()) {
      // epoch exhausted; flag stays set until Reset so repeated calls
      // keep returning end-of-epoch instead of blocking
      return 1;
    }
    current_ = std::move(queue_.front());
    queue_.pop_front();
    lk.unlock();
    cv_space_.notify_one();
    *data = current_.data.data();
    *lengths = current_.lengths.data();
    *n_records = current_.lengths.size();
    *total_bytes = current_.data.size();
    return 0;
  }

 private:
  void ScanOffsets() {
    FILE* f = std::fopen(path_.c_str(), "rb");
    if (!f) return;
    open_ok_ = true;
    uint32_t header[2];
    uint64_t pos = 0;
    while (std::fread(header, sizeof(uint32_t), 2, f) == 2) {
      pos += 8;
      if (header[0] != kMagic) break;  // corrupt / unsupported framing
      uint32_t len = header[1] & ((1u << 29) - 1);
      // cflag (upper 3 bits) nonzero = multi-chunk; single-chunk records
      // only (what our writer and the common im2rec output produce)
      records_.push_back({pos, len});
      uint64_t padded = (len + 3u) & ~3u;
      if (std::fseek(f, static_cast<long>(padded), SEEK_CUR) != 0) break;
      pos += padded;
    }
    std::fclose(f);
  }

  void StartEpoch(uint64_t epoch) {
    cursor_ = 0;
    if (shuffle_) {
      std::mt19937_64 rng(seed_ + epoch);
      for (size_t i = order_.size(); i > 1; --i) {
        std::swap(order_[i - 1], order_[rng() % i]);
      }
    }
  }

  void WorkerLoop() {
    FILE* f = std::fopen(path_.c_str(), "rb");
    if (!f) return;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [this] {
          return stop_ || pending_reset_ ||
                 queue_.size() < static_cast<size_t>(queue_depth_);
        });
        if (stop_) break;
        if (pending_reset_) {
          pending_reset_ = false;
          epoch_done_in_queue_ = false;
          StartEpoch(reset_epoch_);
        }
        if (cursor_ >= order_.size()) {
          // nothing left this epoch; signal and wait for reset
          epoch_done_in_queue_ = true;
          cv_data_.notify_all();
          cv_space_.wait(lk, [this] { return stop_ || pending_reset_; });
          continue;
        }
      }
      // assemble one batch outside the lock
      Batch b;
      size_t take;
      std::vector<RecordRef> refs;
      {
        std::lock_guard<std::mutex> lk(mu_);
        take = std::min<size_t>(batch_size_, order_.size() - cursor_);
        for (size_t i = 0; i < take; ++i) {
          refs.push_back(shard_[order_[cursor_ + i]]);
        }
        cursor_ += take;
      }
      for (const auto& r : refs) {
        size_t old = b.data.size();
        b.data.resize(old + r.length);
        if (std::fseek(f, static_cast<long>(r.offset), SEEK_SET) != 0 ||
            std::fread(b.data.data() + old, 1, r.length, f) != r.length) {
          // truncated/unreadable record: drop the partial bytes so the
          // batch stays self-consistent, and count the error so the Python
          // side can surface it instead of silently losing records
          b.data.resize(old);
          read_errors_.fetch_add(1, std::memory_order_relaxed);
          break;
        }
        b.lengths.push_back(r.length);
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        if (stop_) break;
        // a Reset may have raced the assembly above: this batch belongs to
        // the old epoch — drop it rather than leak it into the new one
        if (pending_reset_) continue;
        queue_.push_back(std::move(b));
      }
      cv_data_.notify_one();
    }
    std::fclose(f);
  }

  std::string path_;
  size_t batch_size_;
  int shuffle_;
  uint64_t seed_;
  int queue_depth_;
  bool open_ok_ = false;
  std::vector<RecordRef> records_;
  std::vector<RecordRef> shard_;
  std::vector<size_t> order_;
  size_t cursor_ = 0;

  std::atomic<int64_t> read_errors_{0};

  std::mutex mu_;
  std::condition_variable cv_data_, cv_space_;
  std::deque<Batch> queue_;
  Batch current_;
  bool stop_ = false;
  bool pending_reset_ = false;
  bool epoch_done_in_queue_ = false;
  uint64_t reset_epoch_ = 0;
  std::thread worker_;
};

}  // namespace

extern "C" {

void* mxtpu_reader_create(const char* path, int batch_size, int num_parts,
                          int part_index, int shuffle, uint64_t seed,
                          int queue_depth) {
  Reader* r = new Reader(path, batch_size, num_parts, part_index, shuffle,
                         seed, queue_depth);
  if (!r->open_ok()) {
    delete r;
    return nullptr;
  }
  return r;
}

void mxtpu_reader_free(void* handle) { delete static_cast<Reader*>(handle); }

int64_t mxtpu_reader_num_records(void* handle) {
  return static_cast<Reader*>(handle)->num_records();
}

void mxtpu_reader_reset(void* handle, uint64_t epoch) {
  static_cast<Reader*>(handle)->Reset(epoch);
}

int mxtpu_reader_next_batch(void* handle, const uint8_t** data,
                            const uint64_t** lengths, uint64_t* n_records,
                            uint64_t* total_bytes) {
  return static_cast<Reader*>(handle)->NextBatch(data, lengths, n_records,
                                                 total_bytes);
}

int64_t mxtpu_reader_read_errors(void* handle) {
  return static_cast<Reader*>(handle)->read_errors();
}

}  // extern "C"

// shardstore — memory-mapped column store with multithreaded row gather
// and double-buffered batch prefetch.
//
// Native replacement for the reference's host-side data path
// (torch DataLoader with num_workers=8 + per-sample .npy sidecar reads,
// nusc_train.py:169-187 / nusc_dataset.py:202-232): fixed-shape scene
// tensors live in flat binary column files, batches are assembled by a
// thread pool directly out of the page cache into pinned contiguous
// buffers the device client can donate.
//
// Layout on disk:  <dir>/meta.json        (written by python)
//                  <dir>/<column>.bin     (C-order, rows x row_bytes)
//
// C ABI (ctypes-friendly). All functions return 0 on success, <0 on error.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Column {
  std::string name;
  const uint8_t* data = nullptr;   // mmap'd
  size_t row_bytes = 0;
  size_t file_bytes = 0;
  int fd = -1;
};

struct Store {
  std::vector<Column> cols;
  int64_t n_rows = 0;
  int n_threads = 4;

  // prefetch state
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<int64_t> pending_idx;       // indices for the in-flight batch
  std::vector<std::vector<uint8_t>> slots[2];  // double buffers per column
  int ready_slot = -1;
  bool job_active = false;
  bool stop = false;
};

void gather_rows(const Column& c, const int64_t* idx, int64_t n,
                 uint8_t* out, int n_threads) {
  auto body = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(out + i * c.row_bytes, c.data + idx[i] * c.row_bytes,
                  c.row_bytes);
    }
  };
  if (n < 64 || n_threads <= 1) {
    body(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(body, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Open a store directory. Column names/row_bytes are passed in from python
// (which parses meta.json) to keep the C side JSON-free.
void* ss_open(const char* dir, const char** col_names,
              const int64_t* row_bytes, int n_cols, int64_t n_rows,
              int n_threads) {
  auto* s = new Store();
  s->n_rows = n_rows;
  s->n_threads = n_threads > 0 ? n_threads : 4;
  for (int i = 0; i < n_cols; ++i) {
    Column c;
    c.name = col_names[i];
    c.row_bytes = static_cast<size_t>(row_bytes[i]);
    std::string path = std::string(dir) + "/" + c.name + ".bin";
    c.fd = ::open(path.c_str(), O_RDONLY);
    if (c.fd < 0) { delete s; return nullptr; }
    struct stat st;
    if (fstat(c.fd, &st) != 0 ||
        st.st_size < static_cast<off_t>(c.row_bytes * n_rows)) {
      ::close(c.fd); delete s; return nullptr;
    }
    c.file_bytes = st.st_size;
    void* p = mmap(nullptr, c.file_bytes, PROT_READ, MAP_PRIVATE, c.fd, 0);
    if (p == MAP_FAILED) { ::close(c.fd); delete s; return nullptr; }
    madvise(p, c.file_bytes, MADV_WILLNEED);
    c.data = static_cast<const uint8_t*>(p);
    s->cols.push_back(c);
  }
  return s;
}

int ss_gather(void* handle, int col, const int64_t* idx, int64_t n,
              void* out) {
  auto* s = static_cast<Store*>(handle);
  if (!s || col < 0 || col >= static_cast<int>(s->cols.size())) return -1;
  for (int64_t i = 0; i < n; ++i)
    if (idx[i] < 0 || idx[i] >= s->n_rows) return -2;
  gather_rows(s->cols[col], idx, n, static_cast<uint8_t*>(out),
              s->n_threads);
  return 0;
}

// ---- double-buffered prefetch ------------------------------------------
// Python submits the NEXT batch's indices; the worker thread assembles all
// columns into an internal slot while the caller consumes the previous one.

int ss_prefetch_submit(void* handle, const int64_t* idx, int64_t n) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return -1;
  std::unique_lock<std::mutex> lk(s->mu);
  if (s->job_active) return -3;   // previous job not collected
  s->pending_idx.assign(idx, idx + n);
  s->job_active = true;
  if (!s->worker.joinable()) {
    s->worker = std::thread([s]() {
      int slot = 0;
      for (;;) {
        std::unique_lock<std::mutex> lk(s->mu);
        s->cv.wait(lk, [s] { return s->job_active || s->stop; });
        if (s->stop) return;
        std::vector<int64_t> idx = s->pending_idx;
        lk.unlock();
        auto& bufs = s->slots[slot];
        bufs.resize(s->cols.size());
        for (size_t c = 0; c < s->cols.size(); ++c) {
          bufs[c].resize(idx.size() * s->cols[c].row_bytes);
          gather_rows(s->cols[c], idx.data(),
                      static_cast<int64_t>(idx.size()), bufs[c].data(),
                      s->n_threads);
        }
        lk.lock();
        s->ready_slot = slot;
        s->job_active = false;
        slot ^= 1;
        lk.unlock();
        s->cv.notify_all();
      }
    });
  }
  s->cv.notify_all();
  return 0;
}

// Block until the submitted batch is ready, then copy column `col` out.
int ss_prefetch_collect(void* handle, int col, void* out, int64_t out_bytes) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return -1;
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv.wait(lk, [s] { return s->ready_slot >= 0 || s->stop; });
  if (s->stop) return -4;
  auto& buf = s->slots[s->ready_slot][col];
  if (static_cast<int64_t>(buf.size()) != out_bytes) return -5;
  std::memcpy(out, buf.data(), buf.size());
  return 0;
}

int ss_prefetch_done(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return -1;
  std::unique_lock<std::mutex> lk(s->mu);
  s->ready_slot = -1;
  return 0;
}

void ss_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->stop = true;
  }
  s->cv.notify_all();
  if (s->worker.joinable()) s->worker.join();
  for (auto& c : s->cols) {
    if (c.data) munmap(const_cast<uint8_t*>(c.data), c.file_bytes);
    if (c.fd >= 0) ::close(c.fd);
  }
  delete s;
}

}  // extern "C"

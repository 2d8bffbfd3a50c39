// Threaded reader of Raw (RawAsync) files: the port's copy of the JAX
// package's native/raw_reader.cpp, the counterpart of the reference's
// MultiHot::AsyncDataReader IO core
// (HugeCTR/src/data_readers/multi_hot/detail/data_reader_impl.cpp).
// N threads pread fixed-stride rows into a ring of batch buffers; the
// consumer (Python, through ctypes: hugectr_tpu_torch/data/native_reader.py)
// takes the buffers in batch order. Built with g++ at first use.
//
// C API:
//   rr_open(path, row_bytes, batch_rows, global_batch_rows, offset_rows,
//           n_threads, queue_depth, repeat, limit_batches) -> handle
//   (batch b covers file rows [b*global_batch_rows + offset_rows,
//    +batch_rows): each of several processes reads a disjoint block of every
//    global batch; limit_batches>0 caps the epoch, repeat mode included;
//    the rows past the last whole global batch are never read)
//   rr_num_batches(handle)                             -> batches per epoch
//   rr_next(handle, dst)  [blocking]                   -> rows copied, 0=EOF
//   rr_reset(handle)  -- rewind to batch 0 and restart the fill threads
//   rr_close(handle)
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Batch {
  std::vector<char> data;
  long rows = 0;
  long index = -1;  // batch index within the epoch
};

struct Reader {
  int fd = -1;
  long row_bytes = 0;
  long batch_rows = 0;
  long global_batch_rows = 0;
  long offset_rows = 0;
  long total_rows = 0;
  long num_batches = 0;
  bool repeat = false;
  int queue_depth = 4;
  int n_threads = 2;

  std::vector<std::thread> threads;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::deque<Batch*> ready;   // filled, ordered by batch index
  std::deque<Batch*> free_q;  // available for filling
  std::vector<Batch> pool;
  std::atomic<long> next_to_fill{0};  // global batch cursor (monotonic)
  long next_to_consume = 0;           // batch cursor the consumer wants
  std::atomic<bool> stop{false};
  bool eof = false;
  long filled_count = 0;
  int done_threads = 0;

  void stop_threads() {
    stop.store(true);
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& t : threads)
      if (t.joinable()) t.join();
    threads.clear();
  }

  ~Reader() {
    stop_threads();
    if (fd >= 0) close(fd);
  }
};

void fill_loop(Reader* r) {
  while (!r->stop.load()) {
    // Acquire a buffer BEFORE claiming a batch id: every claimed id then has
    // a buffer and will be filled, so the in-order consumer always makes
    // progress (claiming first can deadlock with all buffers parked on
    // higher ids).
    Batch* buf = nullptr;
    {
      std::unique_lock<std::mutex> lk(r->mu);
      r->cv_free.wait(lk, [&] { return r->stop.load() || !r->free_q.empty(); });
      if (r->stop.load()) return;
      buf = r->free_q.front();
      r->free_q.pop_front();
    }
    long b = r->next_to_fill.fetch_add(1);
    if (!r->repeat && b >= r->num_batches) {
      std::unique_lock<std::mutex> lk(r->mu);
      r->free_q.push_back(buf);
      break;
    }
    long epoch_b = r->repeat ? (b % r->num_batches) : b;

    long row0 = epoch_b * r->global_batch_rows + r->offset_rows;
    long rows = std::min(r->batch_rows, r->total_rows - row0);
    long bytes = rows * r->row_bytes;
    long off = row0 * r->row_bytes;
    long done = 0;
    while (done < bytes) {
      ssize_t n = pread(r->fd, buf->data.data() + done, bytes - done, off + done);
      if (n <= 0) break;
      done += n;
    }
    buf->rows = done / r->row_bytes;
    buf->index = b;

    {
      std::unique_lock<std::mutex> lk(r->mu);
      // keep ready ordered by batch index so the consumer sees a
      // deterministic stream regardless of thread interleaving
      auto it = r->ready.begin();
      while (it != r->ready.end() && (*it)->index < b) ++it;
      r->ready.insert(it, buf);
      r->filled_count++;
    }
    r->cv_ready.notify_all();
  }
  {
    std::unique_lock<std::mutex> lk(r->mu);
    r->done_threads++;
    if (r->done_threads == r->n_threads) r->eof = true;
  }
  r->cv_ready.notify_all();
}

}  // namespace

extern "C" {

void* rr_open(const char* path, long row_bytes, long batch_rows,
              long global_batch_rows, long offset_rows, int n_threads,
              int queue_depth, int repeat, long limit_batches) {
  auto* r = new Reader();
  r->fd = open(path, O_RDONLY);
  if (r->fd < 0) {
    delete r;
    return nullptr;
  }
  struct stat st;
  fstat(r->fd, &st);
  r->row_bytes = row_bytes;
  r->batch_rows = batch_rows;
  r->global_batch_rows =
      global_batch_rows > 0 ? global_batch_rows : batch_rows;
  r->offset_rows = offset_rows;
  r->total_rows = st.st_size / row_bytes;
  r->num_batches = r->total_rows / r->global_batch_rows;  // drop tail
  if (limit_batches > 0 && limit_batches < r->num_batches)
    r->num_batches = limit_batches;  // num_samples cap, honored in repeat too
  r->repeat = repeat != 0;
  r->n_threads = n_threads > 0 ? n_threads : 2;
  r->queue_depth = queue_depth > 1 ? queue_depth : 2;
  if (r->num_batches == 0) {
    delete r;
    return nullptr;
  }
  posix_fadvise(r->fd, 0, 0, POSIX_FADV_SEQUENTIAL);
  r->pool.resize(r->queue_depth);
  for (auto& b : r->pool) {
    b.data.resize((size_t)batch_rows * row_bytes);
    r->free_q.push_back(&b);
  }
  for (int i = 0; i < r->n_threads; i++)
    r->threads.emplace_back(fill_loop, r);
  return r;
}

long rr_num_batches(void* h) { return static_cast<Reader*>(h)->num_batches; }

long rr_next(void* h, void* dst) {
  auto* r = static_cast<Reader*>(h);
  Batch* buf = nullptr;
  {
    std::unique_lock<std::mutex> lk(r->mu);
    long want = r->next_to_consume;
    r->cv_ready.wait(lk, [&] {
      if (r->stop.load()) return true;
      for (auto* b : r->ready)
        if (b->index == want) return true;
      return r->eof && r->ready.empty();
    });
    if (r->stop.load()) return 0;
    for (auto it = r->ready.begin(); it != r->ready.end(); ++it) {
      if ((*it)->index == want) {
        buf = *it;
        r->ready.erase(it);
        break;
      }
    }
    if (!buf) return 0;  // EOF
    r->next_to_consume++;
  }
  long rows = buf->rows;
  memcpy(dst, buf->data.data(), (size_t)rows * r->row_bytes);
  {
    std::unique_lock<std::mutex> lk(r->mu);
    r->free_q.push_back(buf);
  }
  r->cv_free.notify_one();
  return rows;
}

void rr_reset(void* h) {
  auto* r = static_cast<Reader*>(h);
  r->stop_threads();
  // drain queues back into the free pool and rewind all cursors
  r->ready.clear();
  r->free_q.clear();
  for (auto& b : r->pool) {
    b.rows = 0;
    b.index = -1;
    r->free_q.push_back(&b);
  }
  r->next_to_fill.store(0);
  r->next_to_consume = 0;
  r->eof = false;
  r->filled_count = 0;
  r->done_threads = 0;
  r->stop.store(false);
  for (int i = 0; i < r->n_threads; i++) r->threads.emplace_back(fill_loop, r);
}

void rr_close(void* h) { delete static_cast<Reader*>(h); }

}  // extern "C"

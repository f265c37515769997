// dstpu_aio: a thread pool of asynchronous file reads and writes for the
// host offload tier. The port's own copy of the JAX package's csrc/aio/aio.cpp
// (the same C ABI and behaviour), the analogue of the reference DeepNVMe stack
// (csrc/aio/common/*, csrc/aio/py_lib/*): POSIX pread/pwrite with optional
// O_DIRECT; a large request is striped across the worker threads in
// block_size chunks so that a multi-queue SSD sees several requests at once.
// It replaces no TPU kernel; it is bound by the drive's bandwidth.
//
// C ABI (bound with ctypes by deepspeed_tpu_torch/ops/aio):
//   dstpu_aio_create(num_threads, block_size, use_o_direct) -> handle*
//   dstpu_aio_submit(h, path, buf, nbytes, offset, is_read) -> req_id
//   dstpu_aio_wait(h, req_id) -> bytes transferred or -errno
//   dstpu_aio_wait_all(h) -> 0 or first error
//   dstpu_aio_pending(h), dstpu_aio_destroy(h)

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Ticket;

struct Chunk {
  std::string path;
  char* buf;
  int64_t nbytes;
  int64_t offset;
  bool is_read;
  // shared ownership: the ticket must outlive the last worker's completion
  // notification even if the waiter erases it from the handle map first
  std::shared_ptr<Ticket> ticket;
};

struct Ticket {
  std::atomic<int> remaining{0};
  std::atomic<int64_t> transferred{0};
  std::atomic<int64_t> error{0};  // first -errno
  std::mutex m;
  std::condition_variable cv;
  bool done() const { return remaining.load() == 0; }
};

class AioHandle {
 public:
  AioHandle(int num_threads, int64_t block_size, bool o_direct)
      : block_size_(block_size), o_direct_(o_direct) {
    if (num_threads < 1) num_threads = 1;
    for (int i = 0; i < num_threads; ++i)
      workers_.emplace_back([this] { Run(); });
  }

  ~AioHandle() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  int64_t Submit(const char* path, void* buf, int64_t nbytes, int64_t offset,
                 bool is_read) {
    auto ticket = std::make_shared<Ticket>();
    std::vector<Chunk> chunks;
    int64_t pos = 0;
    while (pos < nbytes) {
      int64_t len = std::min(block_size_, nbytes - pos);
      chunks.push_back(Chunk{path, static_cast<char*>(buf) + pos, len,
                             offset + pos, is_read, ticket});
      pos += len;
    }
    if (chunks.empty())  // zero-byte request completes immediately
      chunks.push_back(Chunk{path, static_cast<char*>(buf), 0, offset, is_read,
                             ticket});
    ticket->remaining.store(static_cast<int>(chunks.size()));
    int64_t id;
    {
      std::lock_guard<std::mutex> lk(m_);
      id = next_id_++;
      tickets_[id] = ticket;
      for (auto& c : chunks) queue_.push_back(std::move(c));
      pending_ += 1;
    }
    cv_.notify_all();
    return id;
  }

  int64_t Wait(int64_t id) {
    std::shared_ptr<Ticket> t;
    {
      std::lock_guard<std::mutex> lk(m_);
      auto it = tickets_.find(id);
      if (it == tickets_.end()) return -EINVAL;
      t = it->second;
    }
    {
      std::unique_lock<std::mutex> lk(t->m);
      t->cv.wait(lk, [&] { return t->done(); });
    }
    {
      std::lock_guard<std::mutex> lk(m_);
      tickets_.erase(id);
      pending_ -= 1;
    }
    int64_t err = t->error.load();
    return err != 0 ? err : t->transferred.load();
  }

  int64_t WaitAll() {
    std::vector<int64_t> ids;
    {
      std::lock_guard<std::mutex> lk(m_);
      for (auto& kv : tickets_) ids.push_back(kv.first);
    }
    int64_t first_err = 0;
    for (int64_t id : ids) {
      int64_t r = Wait(id);
      if (r < 0 && first_err == 0) first_err = r;
    }
    return first_err;
  }

  int Pending() {
    std::lock_guard<std::mutex> lk(m_);
    return pending_;
  }

 private:
  void Run() {
    for (;;) {
      Chunk c;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        c = std::move(queue_.front());
        queue_.pop_front();
      }
      Execute(c);
    }
  }

  void Execute(const Chunk& c) {
    int64_t result = DoIO(c);
    const std::shared_ptr<Ticket>& t = c.ticket;
    if (result < 0) {
      int64_t expected = 0;
      t->error.compare_exchange_strong(expected, result);
    } else {
      t->transferred.fetch_add(result);
    }
    if (t->remaining.fetch_sub(1) == 1) {
      std::lock_guard<std::mutex> lk(t->m);
      t->cv.notify_all();
    }
  }

  int64_t DoIO(const Chunk& c) {
    int flags = c.is_read ? O_RDONLY : (O_WRONLY | O_CREAT);
    int fd = -1;
    if (o_direct_) {
      fd = open(c.path.c_str(), flags | O_DIRECT, 0644);
      // O_DIRECT needs aligned buffers/offsets; fall back to buffered IO
      // when the filesystem refuses or alignment doesn't hold.
      if (fd >= 0 && (reinterpret_cast<uintptr_t>(c.buf) % 512 != 0 ||
                      c.offset % 512 != 0 || c.nbytes % 512 != 0)) {
        close(fd);
        fd = -1;
      }
    }
    if (fd < 0) fd = open(c.path.c_str(), flags, 0644);
    if (fd < 0) return -static_cast<int64_t>(errno);
    int64_t done = 0;
    while (done < c.nbytes) {
      ssize_t n = c.is_read
                      ? pread(fd, c.buf + done, c.nbytes - done, c.offset + done)
                      : pwrite(fd, c.buf + done, c.nbytes - done, c.offset + done);
      if (n < 0) {
        if (errno == EINTR) continue;
        int64_t e = -static_cast<int64_t>(errno);
        close(fd);
        return e;
      }
      if (n == 0) break;  // EOF on read
      done += n;
    }
    close(fd);
    return done;
  }

  const int64_t block_size_;
  const bool o_direct_;
  std::mutex m_;
  std::condition_variable cv_;
  std::deque<Chunk> queue_;
  std::map<int64_t, std::shared_ptr<Ticket>> tickets_;
  std::vector<std::thread> workers_;
  int64_t next_id_ = 1;
  int pending_ = 0;
  bool stop_ = false;
};

}  // namespace

extern "C" {

void* dstpu_aio_create(int num_threads, int64_t block_size, int use_o_direct) {
  if (block_size < 4096) block_size = 4096;  // mirrored by the Python handle
  return new AioHandle(num_threads, block_size, use_o_direct != 0);
}

void dstpu_aio_destroy(void* h) { delete static_cast<AioHandle*>(h); }

int64_t dstpu_aio_submit(void* h, const char* path, void* buf, int64_t nbytes,
                         int64_t offset, int is_read) {
  return static_cast<AioHandle*>(h)->Submit(path, buf, nbytes, offset,
                                            is_read != 0);
}

int64_t dstpu_aio_wait(void* h, int64_t req_id) {
  return static_cast<AioHandle*>(h)->Wait(req_id);
}

int64_t dstpu_aio_wait_all(void* h) {
  return static_cast<AioHandle*>(h)->WaitAll();
}

int dstpu_aio_pending(void* h) { return static_cast<AioHandle*>(h)->Pending(); }

int dstpu_aio_version() { return 1; }

}  // extern "C"

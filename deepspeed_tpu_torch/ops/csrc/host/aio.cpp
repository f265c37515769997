// dstpu_aio: a thread pool of asynchronous file reads and writes for the
// host offload tier. The port's own version of the JAX package's
// csrc/aio/aio.cpp (the same C ABI, the same bytes on disk and the same
// results), the analogue of the reference DeepNVMe stack (csrc/aio/common/*,
// csrc/aio/py_lib/*): POSIX pread/pwrite with optional O_DIRECT. It
// replaces no TPU kernel; it is bound by the drive's bandwidth, or the page
// cache's.
//
// A request opens its file once. Its bytes are cut into at most one stripe
// per worker, each a whole number of block_size blocks (the last one
// shorter), so a multi-queue SSD sees several requests at once; the stripes
// share the descriptor, and the last stripe to finish closes it. Before a
// striped write the file is extended once to offset + nbytes where it is
// shorter (fallocate, or ftruncate where the file system has no fallocate),
// so the stripes do not extend it out of order; a file is never shrunk, so a
// write into the middle of a longer file keeps the bytes on either side.
// O_DIRECT is taken where the buffer, the offset, the length and the stripes
// align to 512 bytes and the file system accepts it; else buffered I/O.
//
// C ABI (bound with ctypes by deepspeed_tpu_torch/ops/aio):
//   dstpu_aio_create(num_threads, block_size, use_o_direct) -> handle*
//   dstpu_aio_submit(h, path, buf, nbytes, offset, is_read) -> req_id
//   dstpu_aio_wait(h, req_id) -> bytes transferred or -errno
//   dstpu_aio_wait_all(h) -> 0 or first error
//   dstpu_aio_pending(h), dstpu_aio_destroy(h)

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Request {
  int fd = -1;
  std::atomic<int> remaining{0};  // stripes not yet done
  std::atomic<int64_t> transferred{0};
  std::atomic<int64_t> error{0};  // first -errno
  std::mutex m;
  std::condition_variable cv;
  bool finished = false;  // under m: every stripe done and the file closed

  void Fail(int64_t e) {
    int64_t expected = 0;
    error.compare_exchange_strong(expected, e);
  }

  void Finish() {
    if (fd >= 0) close(fd);
    std::lock_guard<std::mutex> lk(m);
    finished = true;
    cv.notify_all();
  }
};

struct Stripe {
  char* buf;
  int64_t nbytes;
  int64_t offset;
  bool is_read;
  // shared ownership: the request must outlive its last stripe's completion
  // even if the waiter erases it from the handle's map first
  std::shared_ptr<Request> req;
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
    auto req = std::make_shared<Request>();
    char* base = static_cast<char*>(buf);
    const int64_t blocks = (nbytes + block_size_ - 1) / block_size_;
    const int64_t ways = std::max<int64_t>(
        1, std::min<int64_t>(static_cast<int64_t>(workers_.size()), blocks));
    const int64_t stripe = (blocks + ways - 1) / ways * block_size_;
    std::vector<Stripe> stripes;
    req->fd = Open(path, is_read, base, nbytes, offset, stripe);
    if (req->fd < 0) {
      req->Fail(-static_cast<int64_t>(errno));
    } else if (!is_read && nbytes > 0) {
      int64_t e = Extend(req->fd, offset + nbytes);
      if (e < 0) req->Fail(e);
    }
    if (req->error.load() == 0)
      for (int64_t pos = 0; pos < nbytes; pos += stripe)
        stripes.push_back(Stripe{base + pos, std::min(stripe, nbytes - pos),
                                 offset + pos, is_read, req});
    req->remaining.store(static_cast<int>(stripes.size()));
    if (stripes.empty()) req->Finish();  // an error, or zero bytes
    int64_t id;
    {
      std::lock_guard<std::mutex> lk(m_);
      id = next_id_++;
      requests_[id] = req;
      for (auto& s : stripes) queue_.push_back(std::move(s));
      pending_ += 1;
    }
    if (!stripes.empty()) cv_.notify_all();
    return id;
  }

  int64_t Wait(int64_t id) {
    std::shared_ptr<Request> r;
    {
      std::lock_guard<std::mutex> lk(m_);
      auto it = requests_.find(id);
      if (it == requests_.end()) return -EINVAL;
      r = it->second;
    }
    {
      std::unique_lock<std::mutex> lk(r->m);
      r->cv.wait(lk, [&] { return r->finished; });
    }
    {
      std::lock_guard<std::mutex> lk(m_);
      requests_.erase(id);
      pending_ -= 1;
    }
    int64_t err = r->error.load();
    return err != 0 ? err : r->transferred.load();
  }

  int64_t WaitAll() {
    std::vector<int64_t> ids;
    {
      std::lock_guard<std::mutex> lk(m_);
      for (auto& kv : requests_) ids.push_back(kv.first);
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
  int Open(const char* path, bool is_read, const char* buf, int64_t nbytes,
           int64_t offset, int64_t stripe) {
    const int flags = is_read ? O_RDONLY : (O_WRONLY | O_CREAT);
    if (o_direct_ && reinterpret_cast<uintptr_t>(buf) % 512 == 0 && offset % 512 == 0 &&
        nbytes % 512 == 0 && stripe % 512 == 0) {
      int fd = open(path, flags | O_DIRECT, 0644);
      if (fd >= 0) return fd;  // else the file system refuses O_DIRECT
    }
    return open(path, flags, 0644);
  }

  // Grow the file to `end` bytes if it is shorter; never shrink it. One
  // handle's requests extend one at a time.
  int64_t Extend(int fd, int64_t end) {
    std::lock_guard<std::mutex> lk(extend_m_);
    struct stat st;
    if (fstat(fd, &st) != 0) return -static_cast<int64_t>(errno);
    if (st.st_size >= end) return 0;
    if (fallocate(fd, 0, st.st_size, end - st.st_size) == 0) return 0;
    if (errno != EOPNOTSUPP && errno != ENOSYS) return -static_cast<int64_t>(errno);
    return ftruncate(fd, end) == 0 ? 0 : -static_cast<int64_t>(errno);
  }

  void Run() {
    for (;;) {
      Stripe s;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        s = std::move(queue_.front());
        queue_.pop_front();
      }
      Execute(s);
    }
  }

  void Execute(const Stripe& s) {
    Request& r = *s.req;
    int64_t result = DoIO(r.fd, s);
    if (result < 0)
      r.Fail(result);
    else
      r.transferred.fetch_add(result);
    if (r.remaining.fetch_sub(1) == 1) r.Finish();
  }

  static int64_t DoIO(int fd, const Stripe& s) {
    int64_t done = 0;
    while (done < s.nbytes) {
      ssize_t n = s.is_read
                      ? pread(fd, s.buf + done, s.nbytes - done, s.offset + done)
                      : pwrite(fd, s.buf + done, s.nbytes - done, s.offset + done);
      if (n < 0) {
        if (errno == EINTR) continue;
        return -static_cast<int64_t>(errno);
      }
      if (n == 0) break;  // EOF on read
      done += n;
    }
    return done;
  }

  const int64_t block_size_;
  const bool o_direct_;
  std::mutex m_, extend_m_;
  std::condition_variable cv_;
  std::deque<Stripe> queue_;
  std::map<int64_t, std::shared_ptr<Request>> requests_;
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

// Dynamic batching runtime for external (host-process) actors.
//
// The learner's side of the remote-actor runtime of seed_rl_torch (a copy
// of the JAX package's batcher, kept here so the port builds nothing of
// that package). It stands in for the reference's C++ gRPC server batcher
// (grpc/ops/grpc.cc, DynamicFn :591-861): concurrent env threads submit
// fixed-size requests; each request is copied into a slot of a
// pre-allocated contiguous batch buffer (CopyElementToSlice semantics,
// grpc.cc:667-676); when a batch fills it is handed to a runner (the Python
// side runs the policy on it, round-robin across inference shards); results
// are sliced back to the blocked callers (grpc.cc:714-756). Shutdown
// cancels blocked callers and runners (cancellation cascade,
// grpc.cc:381-397, 451-461).
//
// Differences from the reference: transport is in-process shared memory
// or the socket server below instead of gRPC streams, and an optional
// flush timeout fires partial batches (the reference only fires full
// batches and relies on inference_batch_size <= num_envs; partial firing
// makes draining robust).
//
// Exposed as a plain C API for ctypes; no Python.h dependency. Built with
// g++ (host code only) by seed_rl_torch/runtime/inference_server.py.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <errno.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

namespace {

struct Batch {
  std::vector<char> request_data;   // [batch_size * request_bytes]
  std::vector<char> result_data;    // [batch_size * result_bytes]
  std::vector<int64_t> env_ids;     // [batch_size]
  size_t fill = 0;                  // slots filled by submitters
  size_t done_waiters = 0;          // submitters that consumed their result
  uint64_t generation = 0;          // batch sequence number for this buffer
  bool queued = false;              // full (or flushed) and awaiting runner
  bool completed = false;           // results written by the runner
  bool failed = false;              // runner reported a handler error
  bool taken = false;               // handed to a runner, not yet recycled
  bool held = false;                // test hook: waiters wait to recycle
};

}  // namespace

struct Batcher {
  size_t batch_size;
  size_t request_bytes;
  size_t result_bytes;
  size_t num_buffers;

  std::mutex mu;
  std::condition_variable submit_cv;   // space available / result ready
  std::condition_variable runner_cv;   // batch ready to run
  std::vector<Batch> buffers;
  size_t fill_index = 0;   // buffer currently accepting submissions
  // Generations grow in fill order: a buffer takes a new one each time it
  // becomes the filling buffer, and the runner takes the queued batch of
  // the smallest.
  uint64_t next_generation = 1;
  bool shutdown = false;

  // Stats (reference exposes none; useful for perf work).
  std::atomic<uint64_t> total_requests{0};
  std::atomic<uint64_t> total_batches{0};

  Batcher(size_t bs, size_t req, size_t res, size_t nbuf)
      : batch_size(bs), request_bytes(req), result_bytes(res),
        num_buffers(nbuf), buffers(nbuf) {
    for (auto& b : buffers) {
      b.request_data.resize(bs * req);
      b.result_data.resize(bs * res);
      b.env_ids.resize(bs);
    }
    buffers[0].generation = next_generation++;
  }
};

extern "C" {

Batcher* batcher_create(size_t batch_size, size_t request_bytes,
                        size_t result_bytes, size_t num_buffers) {
  if (batch_size == 0 || num_buffers < 2) return nullptr;
  return new Batcher(batch_size, request_bytes, result_bytes, num_buffers);
}

void batcher_destroy(Batcher* b) { delete b; }

// Blocking submit from an env/actor thread. Copies `request` into a batch
// slot, waits for the batch's results, copies this slot's result out.
// Returns 0 on success, 1 on shutdown, 2 if the runner reported a handler
// failure for this batch (result_out is not written).
int batcher_submit(Batcher* b, int64_t env_id, const char* request,
                   char* result_out) {
  std::unique_lock<std::mutex> lock(b->mu);

  // Wait for a slot in the filling buffer.
  Batch* batch;
  size_t slot;
  uint64_t generation;
  size_t buffer_idx;
  while (true) {
    if (b->shutdown) return 1;
    batch = &b->buffers[b->fill_index];
    if (!batch->queued && batch->fill < b->batch_size) {
      slot = batch->fill++;
      generation = batch->generation;
      buffer_idx = b->fill_index;
      break;
    }
    // Current buffer is busy (queued or its results are being drained);
    // wait for space.
    b->submit_cv.wait(lock);
  }

  std::memcpy(batch->request_data.data() + slot * b->request_bytes, request,
              b->request_bytes);
  batch->env_ids[slot] = env_id;
  b->total_requests.fetch_add(1, std::memory_order_relaxed);

  if (batch->fill == b->batch_size) {
    // Full: queue for a runner and advance the fill pointer to the next
    // buffer if it is free.
    batch->queued = true;
    b->runner_cv.notify_all();
    size_t next = (b->fill_index + 1) % b->num_buffers;
    Batch* nb = &b->buffers[next];
    if (!nb->queued && nb->fill == 0 && !nb->completed) {
      nb->generation = b->next_generation++;
      b->fill_index = next;
      b->submit_cv.notify_all();
    }
  }

  // Wait for our batch's results.
  while (true) {
    Batch* cur = &b->buffers[buffer_idx];
    if (b->shutdown) return 1;
    if (cur->generation == generation && cur->completed) break;
    b->submit_cv.wait(lock);
  }

  Batch* cur = &b->buffers[buffer_idx];
  const bool failed = cur->failed;
  if (!failed) {
    std::memcpy(result_out, cur->result_data.data() + slot * b->result_bytes,
                b->result_bytes);
  }
  while (cur->held && !b->shutdown) b->submit_cv.wait(lock);
  cur->done_waiters++;
  if (cur->done_waiters == cur->fill) {
    // Last waiter recycles the buffer.
    cur->fill = 0;
    cur->done_waiters = 0;
    cur->queued = false;
    cur->completed = false;
    cur->failed = false;
    cur->taken = false;
    Batch* fb = &b->buffers[b->fill_index];
    if (fb == cur || fb->queued || fb->completed) {
      // The filling pointer is on this buffer, or stuck on a busy one
      // (take over): either way this buffer fills next, as a new batch.
      cur->generation = b->next_generation++;
      b->fill_index = buffer_idx;
    }
    b->submit_cv.notify_all();
  }
  return failed ? 2 : 0;
}

// Test hook: while `hold` is set, the waiters of buffer `buffer` keep
// their results and do not recycle the buffer (a batch's callers slow to
// take the lock back). Clearing it releases them. Returns 1 for a buffer
// index out of range.
int batcher_test_hold(Batcher* b, size_t buffer, int hold) {
  std::unique_lock<std::mutex> lock(b->mu);
  if (buffer >= b->num_buffers) return 1;
  b->buffers[buffer].held = hold != 0;
  b->submit_cv.notify_all();
  return 0;
}

// Runner side: wait for a queued batch (or flush a partial one after
// flush_timeout_ms; pass -1 to wait for full batches only). Queued batches
// are handed out in fill order, oldest first, whichever buffers they are
// in; the partial batch flushed is the filling buffer's. On success
// returns 0 and sets *request_data / *env_ids / *count / *ticket.
// Returns 1 on shutdown, 2 on timeout with nothing to run.
int batcher_get_batch(Batcher* b, char** request_data, int64_t** env_ids,
                      size_t* count, uint64_t* ticket,
                      int flush_timeout_ms) {
  std::unique_lock<std::mutex> lock(b->mu);
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(
                      flush_timeout_ms < 0 ? 3600 * 1000 : flush_timeout_ms);
  while (true) {
    if (b->shutdown) return 1;
    size_t oldest = b->num_buffers;
    for (size_t i = 0; i < b->num_buffers; ++i) {
      const Batch& c = b->buffers[i];
      if (c.queued && !c.completed && !c.taken &&
          (oldest == b->num_buffers ||
           c.generation < b->buffers[oldest].generation))
        oldest = i;
    }
    if (oldest < b->num_buffers) {
      Batch* batch = &b->buffers[oldest];
      batch->taken = true;
      *request_data = batch->request_data.data();
      *env_ids = batch->env_ids.data();
      *count = batch->fill;
      *ticket = oldest;
      b->total_batches.fetch_add(1, std::memory_order_relaxed);
      return 0;
    }
    if (b->runner_cv.wait_until(lock, deadline) ==
        std::cv_status::timeout) {
      Batch* batch = &b->buffers[b->fill_index];
      if (flush_timeout_ms >= 0 && batch->fill > 0 && !batch->queued) {
        // Flush the partial batch.
        batch->queued = true;
        size_t next = (b->fill_index + 1) % b->num_buffers;
        Batch* nb = &b->buffers[next];
        if (!nb->queued && nb->fill == 0 && !nb->completed) {
          nb->generation = b->next_generation++;
          b->fill_index = next;
          b->submit_cv.notify_all();
        }
        continue;  // loop picks it up
      }
      return 2;
    }
  }
}

// Runner side: publish results for a batch obtained via batcher_get_batch.
// `results` must hold count * result_bytes bytes.
int batcher_complete_batch(Batcher* b, uint64_t ticket, const char* results,
                           size_t count) {
  std::unique_lock<std::mutex> lock(b->mu);
  if (ticket >= b->num_buffers) return 1;
  Batch* batch = &b->buffers[ticket];
  if (!batch->queued || batch->completed || batch->fill != count) return 1;
  std::memcpy(batch->result_data.data(), results, count * b->result_bytes);
  batch->completed = true;
  b->submit_cv.notify_all();
  return 0;
}

// Runner side: mark a batch as failed (handler raised). Every submitter
// blocked on it gets return code 2 from batcher_submit instead of a result
// — the error-propagation counterpart of the reference's server
// cancellation on handler errors (grpc.cc:381-397).
int batcher_fail_batch(Batcher* b, uint64_t ticket) {
  std::unique_lock<std::mutex> lock(b->mu);
  if (ticket >= b->num_buffers) return 1;
  Batch* batch = &b->buffers[ticket];
  if (!batch->queued || batch->completed) return 1;
  batch->completed = true;
  batch->failed = true;
  b->submit_cv.notify_all();
  return 0;
}

void batcher_shutdown(Batcher* b) {
  std::unique_lock<std::mutex> lock(b->mu);
  b->shutdown = true;
  b->submit_cv.notify_all();
  b->runner_cv.notify_all();
}

uint64_t batcher_total_requests(Batcher* b) {
  return b->total_requests.load(std::memory_order_relaxed);
}

uint64_t batcher_total_batches(Batcher* b) {
  return b->total_batches.load(std::memory_order_relaxed);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Unix-domain-socket transport: the wire front-end for external actor
// processes, the native-transport counterpart of the reference's streaming
// gRPC server (grpc/ops/grpc.cc:591-861; unix sockets per grpc/README.md:8-9).
//
// Protocol (all little-endian, fixed-size payloads — the codec contract of
// the in-process batcher):
//   on connect, server sends:  "SRL1" + u64 spec_len + spec blob
//                              (pickled request/result signatures — the
//                              equivalent of the reference's Init RPC
//                              signature discovery, grpc.cc:145-153)
//   client replies:            u64 request_bytes + u64 result_bytes
//   server replies:            u8 status (0 ok, 1 size mismatch -> close)
//   per call, client sends:    i64 env_id + request blob
//   server replies:            u8 status + result blob
//                              (status: 0 ok, 1 shutting down -> close,
//                               2 handler failed for this batch)
//
// One connection per env (the reference holds one stream per actor env
// batch; here batching happens server-side in the Batcher). Each connection
// gets a thread that blocks in batcher_submit — the same thread discipline
// as the reference's completion-queue pollers parked in DynamicFn.

namespace {

bool ReadFull(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool WriteFull(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    // MSG_NOSIGNAL: an actor that died mid-call makes this fail with
    // EPIPE instead of raising SIGPIPE in the learner.
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

}  // namespace

struct TransportServer {
  Batcher* batcher;
  int listen_fd = -1;
  bool is_tcp = false;
  std::string spec_blob;
  std::thread accept_thread;
  std::mutex mu;
  std::vector<int> conn_fds;
  std::vector<std::thread> conn_threads;
  std::atomic<bool> shutting_down{false};
  std::atomic<uint64_t> connections{0};

  void ServeConnection(int fd) {
    // Handshake.
    uint64_t spec_len = spec_blob.size();
    if (!WriteFull(fd, "SRL1", 4) ||
        !WriteFull(fd, &spec_len, sizeof(spec_len)) ||
        (spec_len && !WriteFull(fd, spec_blob.data(), spec_len))) {
      ::close(fd);
      return;
    }
    uint64_t sizes[2];
    if (!ReadFull(fd, sizes, sizeof(sizes))) {
      ::close(fd);
      return;
    }
    uint8_t ok = (sizes[0] == batcher->request_bytes &&
                  sizes[1] == batcher->result_bytes)
                     ? 0
                     : 1;
    if (!WriteFull(fd, &ok, 1) || ok != 0) {
      ::close(fd);
      return;
    }

    std::vector<char> request(batcher->request_bytes);
    std::vector<char> response(1 + batcher->result_bytes);
    while (!shutting_down.load(std::memory_order_relaxed)) {
      int64_t env_id;
      if (!ReadFull(fd, &env_id, sizeof(env_id))) break;
      if (!request.empty() &&
          !ReadFull(fd, request.data(), request.size()))
        break;
      int rc = batcher_submit(batcher, env_id, request.data(),
                              response.data() + 1);
      response[0] = static_cast<char>(rc);
      if (rc != 0 && rc != 2) {  // shutdown
        uint8_t status = 1;
        WriteFull(fd, &status, 1);
        break;
      }
      if (rc == 2) std::memset(response.data() + 1, 0, batcher->result_bytes);
      if (!WriteFull(fd, response.data(), response.size())) break;
    }
    ::close(fd);
  }

  void AcceptLoop() {
    while (!shutting_down.load(std::memory_order_relaxed)) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (errno == EINTR) continue;
        return;  // listen fd closed (shutdown)
      }
      if (is_tcp) {
        // One small request/response pair per env transition: Nagle
        // batching would add RTT-scale latency to every inference call.
        int one = 1;
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      }
      connections.fetch_add(1, std::memory_order_relaxed);
      std::lock_guard<std::mutex> lock(mu);
      if (shutting_down.load(std::memory_order_relaxed)) {
        ::close(fd);
        return;
      }
      conn_fds.push_back(fd);
      conn_threads.emplace_back([this, fd] { ServeConnection(fd); });
    }
  }
};

extern "C" {

// Starts a socket server for `batcher` at `address` — either a unix-domain
// path or "host:port" / "tcp://host:port" for cross-machine actor fleets
// (the reference's server binds TCP the same way, grpc.cc:591-861; port 0
// picks an ephemeral port, readable via transport_server_port). `spec_blob`
// (may be null) is sent to every client at connect time (signature
// discovery). Returns null on bind/listen failure.
TransportServer* transport_server_create(Batcher* batcher,
                                         const char* address,
                                         const char* spec_blob,
                                         size_t spec_len) {
  std::string addr_str(address);
  if (addr_str.rfind("tcp://", 0) == 0) addr_str = addr_str.substr(6);
  int fd = -1;
  size_t colon = addr_str.rfind(':');
  bool is_tcp = colon != std::string::npos &&
                addr_str.find('/') == std::string::npos;
  if (is_tcp) {
    // Hostname / IPv4 / bracketed-IPv6 ("[::1]:9000") resolution via
    // getaddrinfo, with AI_PASSIVE wildcard binds for empty hosts.
    std::string host, port_s;
    if (!addr_str.empty() && addr_str[0] == '[') {
      size_t close_b = addr_str.find(']');
      if (close_b == std::string::npos ||
          close_b + 1 >= addr_str.size() || addr_str[close_b + 1] != ':')
        return nullptr;
      host = addr_str.substr(1, close_b - 1);
      port_s = addr_str.substr(close_b + 2);
    } else {
      host = addr_str.substr(0, colon);
      port_s = addr_str.substr(colon + 1);
    }
    addrinfo hints;
    std::memset(&hints, 0, sizeof(hints));
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    hints.ai_flags = AI_PASSIVE;
    addrinfo* res = nullptr;
    if (::getaddrinfo(host.empty() ? nullptr : host.c_str(),
                      port_s.c_str(), &hints, &res) != 0 ||
        res == nullptr)
      return nullptr;
    for (addrinfo* ai = res; ai != nullptr; ai = ai->ai_next) {
      fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
      if (fd < 0) continue;
      int one = 1;
      ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
      if (::bind(fd, ai->ai_addr, ai->ai_addrlen) == 0 &&
          ::listen(fd, 128) == 0)
        break;
      ::close(fd);
      fd = -1;
    }
    ::freeaddrinfo(res);
    if (fd < 0) return nullptr;
  } else {
    sockaddr_un addr;
    if (addr_str.size() >= sizeof(addr.sun_path)) return nullptr;
    fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
    std::memset(&addr, 0, sizeof(addr));
    addr.sun_family = AF_UNIX;
    std::strncpy(addr.sun_path, addr_str.c_str(),
                 sizeof(addr.sun_path) - 1);
    ::unlink(addr_str.c_str());
    if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
        ::listen(fd, 128) < 0) {
      ::close(fd);
      return nullptr;
    }
  }
  auto* server = new TransportServer;
  server->batcher = batcher;
  server->listen_fd = fd;
  server->is_tcp = is_tcp;
  if (spec_blob && spec_len) server->spec_blob.assign(spec_blob, spec_len);
  server->accept_thread = std::thread([server] { server->AcceptLoop(); });
  return server;
}

// Bound TCP port (for port-0 ephemeral binds); 0 for unix-domain servers.
int transport_server_port(TransportServer* s) {
  if (!s->is_tcp) return 0;
  sockaddr_storage addr;
  socklen_t len = sizeof(addr);
  if (::getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr),
                    &len) != 0)
    return 0;
  if (addr.ss_family == AF_INET6)
    return static_cast<int>(
        ntohs(reinterpret_cast<sockaddr_in6*>(&addr)->sin6_port));
  return static_cast<int>(
      ntohs(reinterpret_cast<sockaddr_in*>(&addr)->sin_port));
}

uint64_t transport_server_connections(TransportServer* s) {
  return s->connections.load(std::memory_order_relaxed);
}

// Stops accepting, unblocks per-connection readers, joins all threads.
// Blocked batcher_submit calls are released by batcher_shutdown (call it
// first, as the Python front-end does).
void transport_server_shutdown(TransportServer* s) {
  s->shutting_down.store(true, std::memory_order_relaxed);
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  {
    std::lock_guard<std::mutex> lock(s->mu);
    for (int fd : s->conn_fds) ::shutdown(fd, SHUT_RDWR);
  }
  if (s->accept_thread.joinable()) s->accept_thread.join();
  std::vector<std::thread> threads;
  {
    std::lock_guard<std::mutex> lock(s->mu);
    threads.swap(s->conn_threads);
  }
  for (auto& t : threads)
    if (t.joinable()) t.join();
}

void transport_server_destroy(TransportServer* s) { delete s; }

}  // extern "C"

// Tensor RPC transport of the PyTorch port: a framed TCP protocol that
// moves one named tensor per frame, host side only.
//
// A copy of paddle_tpu/native/csrc/tensor_rpc.cc (the reference's
// transport, itself after the reference framework's
// paddle/fluid/operators/distributed/ grpc_client.cc / grpc_server.cc and
// the variable_response.cc wire format): the frame format is kept byte
// for byte, so a client of either package talks to a server of either.
// The server is transport + tensor store + event queue; what the frames
// mean (serving/server.py, serving/codec.py) is Python's.  A GET parks in
// the server until its var is published.
//
// Wire frame: [u8 type][u32 name_len][name][u8 dtype][u8 ndim][i64 dims...]
//             [u64 payload_len][payload]
// types: 1=SEND_VAR 2=GET_VAR 3=BARRIER 4=COMPLETE 5=REPLY_VAR 6=ACK
//
// C ABI (ctypes): rpcs_* = server, rpcc_* = client.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint8_t kSendVar = 1, kGetVar = 2, kBarrier = 3, kComplete = 4,
                  kReplyVar = 5, kAck = 6;

struct Tensor {
  uint8_t dtype = 0;  // opaque to the transport (numpy dtype enum on the py side)
  std::vector<int64_t> dims;
  std::string data;
};

struct Event {  // delivered to the Python poll loop
  uint8_t type;  // kSendVar | kBarrier | kComplete
  std::string name;
  Tensor tensor;  // valid for kSendVar
};

// ``moved`` (may be null) counts the bytes that crossed the socket.
bool read_full(int fd, void* buf, size_t n,
               std::atomic<uint64_t>* moved = nullptr) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    if (moved) *moved += static_cast<uint64_t>(r);
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n,
                std::atomic<uint64_t>* moved = nullptr) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    if (moved) *moved += static_cast<uint64_t>(r);
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

struct Frame {
  uint8_t type = 0;
  std::string name;
  Tensor tensor;
};

bool read_frame(int fd, Frame* f, std::atomic<uint64_t>* moved = nullptr) {
  uint8_t type;
  if (!read_full(fd, &type, 1, moved)) return false;
  uint32_t name_len;
  if (!read_full(fd, &name_len, 4, moved)) return false;
  if (name_len > (1u << 20)) return false;
  f->name.resize(name_len);
  if (name_len && !read_full(fd, f->name.data(), name_len, moved))
    return false;
  uint8_t dtype, ndim;
  if (!read_full(fd, &dtype, 1, moved) || !read_full(fd, &ndim, 1, moved))
    return false;
  f->tensor.dtype = dtype;
  f->tensor.dims.resize(ndim);
  if (ndim && !read_full(fd, f->tensor.dims.data(), 8ull * ndim, moved))
    return false;
  uint64_t payload;
  if (!read_full(fd, &payload, 8, moved)) return false;
  if (payload > (1ull << 33)) return false;
  f->tensor.data.resize(payload);
  if (payload && !read_full(fd, f->tensor.data.data(), payload, moved))
    return false;
  f->type = type;
  return true;
}

bool write_frame(int fd, uint8_t type, const std::string& name,
                 const Tensor* t, std::atomic<uint64_t>* moved = nullptr) {
  std::string head;
  head.push_back(static_cast<char>(type));
  uint32_t name_len = static_cast<uint32_t>(name.size());
  head.append(reinterpret_cast<char*>(&name_len), 4);
  head += name;
  uint8_t dtype = t ? t->dtype : 0;
  uint8_t ndim = t ? static_cast<uint8_t>(t->dims.size()) : 0;
  head.push_back(static_cast<char>(dtype));
  head.push_back(static_cast<char>(ndim));
  if (t && ndim)
    head.append(reinterpret_cast<const char*>(t->dims.data()), 8ull * ndim);
  uint64_t payload = t ? t->data.size() : 0;
  head.append(reinterpret_cast<char*>(&payload), 8);
  if (!write_full(fd, head.data(), head.size(), moved)) return false;
  if (t && payload) return write_full(fd, t->data.data(), payload, moved);
  return true;
}

struct Server {
  int listen_fd = -1;
  int port = 0;
  std::thread accept_thread;
  std::vector<std::thread> conns;
  std::vector<int> conn_fds;  // so destroy can unblock idle recv()s
  std::mutex mu;
  std::condition_variable events_cv;   // Python waits for inbound events
  std::condition_variable store_cv;    // GET handlers wait for published vars
  std::deque<Event> events;
  std::map<std::string, Tensor> store;
  bool serving = false;  // GETs blocked until Python publishes + enables
  bool stop = false;
  std::atomic<uint64_t> bytes_in{0}, bytes_out{0};  // every connection's

  void forget_fd(int fd) {
    std::lock_guard<std::mutex> lk(mu);
    for (auto it = conn_fds.begin(); it != conn_fds.end(); ++it) {
      if (*it == fd) {
        conn_fds.erase(it);
        break;
      }
    }
  }

  void handle_conn(int fd) {
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    Frame f;
    while (read_frame(fd, &f, &bytes_in)) {
      if (f.type == kSendVar || f.type == kBarrier || f.type == kComplete) {
        {
          std::lock_guard<std::mutex> lk(mu);
          events.push_back({f.type, f.name, std::move(f.tensor)});
        }
        events_cv.notify_all();
        if (!write_frame(fd, kAck, "", nullptr, &bytes_out)) break;
      } else if (f.type == kGetVar) {
        Tensor t;
        {
          std::unique_lock<std::mutex> lk(mu);
          store_cv.wait(lk, [&] {
            return stop || (serving && store.count(f.name));
          });
          if (stop) break;
          t = store[f.name];
        }
        if (!write_frame(fd, kReplyVar, f.name, &t, &bytes_out)) break;
      }
    }
    // drop from conn_fds BEFORE closing: destroy() must never shutdown()
    // a number the OS may have already reassigned to an unrelated socket
    forget_fd(fd);
    ::close(fd);
  }

  void accept_loop() {
    while (true) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        std::lock_guard<std::mutex> lk(mu);
        if (stop) return;
        continue;
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        if (stop) {
          ::close(fd);
          return;
        }
        conn_fds.push_back(fd);
        conns.emplace_back(&Server::handle_conn, this, fd);
      }
    }
  }
};

struct Client {
  int fd = -1;
};

}  // namespace

extern "C" {

// -- server ------------------------------------------------------------------

void* rpcs_create(int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(fd, 64) != 0) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Server();
  s->listen_fd = fd;
  if (port == 0) {
    socklen_t len = sizeof(addr);
    ::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len);
  }
  s->port = ntohs(addr.sin_port);
  s->accept_thread = std::thread(&Server::accept_loop, s);
  return s;
}

int rpcs_port(void* h) { return static_cast<Server*>(h)->port; }

// Blocking poll for the next inbound event.  Returns the event type (0 on
// shutdown).  Name is copied into name_buf; SEND_VAR tensors are held until
// the next rpcs_poll call via *data/*dims outputs.
int rpcs_poll(void* h, char* name_buf, int name_cap, unsigned char* dtype,
              long long* dims, int dims_cap, int* ndim,
              const void** data, long long* data_len) {
  auto* s = static_cast<Server*>(h);
  static thread_local Event current;  // keeps tensor alive for the caller
  std::unique_lock<std::mutex> lk(s->mu);
  s->events_cv.wait(lk, [&] { return s->stop || !s->events.empty(); });
  if (s->stop && s->events.empty()) return 0;
  current = std::move(s->events.front());
  s->events.pop_front();
  lk.unlock();
  std::snprintf(name_buf, name_cap, "%s", current.name.c_str());
  *dtype = current.tensor.dtype;
  *ndim = static_cast<int>(current.tensor.dims.size());
  for (int i = 0; i < *ndim && i < dims_cap; ++i)
    dims[i] = current.tensor.dims[i];
  *data = current.tensor.data.data();
  *data_len = static_cast<long long>(current.tensor.data.size());
  return current.type;
}

void rpcs_set_var(void* h, const char* name, unsigned char dtype,
                  const long long* dims, int ndim, const void* data,
                  long long len) {
  auto* s = static_cast<Server*>(h);
  Tensor t;
  t.dtype = dtype;
  t.dims.assign(dims, dims + ndim);
  t.data.assign(static_cast<const char*>(data), static_cast<size_t>(len));
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->store[name] = std::move(t);
  }
  s->store_cv.notify_all();
}

void rpcs_del_var(void* h, const char* name) {
  auto* s = static_cast<Server*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  s->store.erase(name);
}

void rpcs_serve(void* h, int enable) {
  auto* s = static_cast<Server*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->serving = enable != 0;
  }
  s->store_cv.notify_all();
}

// Bytes every connection has read and written so far, frames whole.
void rpcs_bytes(void* h, long long* in, long long* out) {
  auto* s = static_cast<Server*>(h);
  *in = static_cast<long long>(s->bytes_in.load());
  *out = static_cast<long long>(s->bytes_out.load());
}

void rpcs_destroy(void* h) {
  auto* s = static_cast<Server*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->stop = true;
    // unblock handler threads parked in recv() on idle connections —
    // joining without this deadlocks when a client is mid-compute
    for (int fd : s->conn_fds) ::shutdown(fd, SHUT_RDWR);
  }
  s->store_cv.notify_all();
  s->events_cv.notify_all();
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  if (s->accept_thread.joinable()) s->accept_thread.join();
  for (auto& t : s->conns)
    if (t.joinable()) t.join();
  delete s;
}

// -- client ------------------------------------------------------------------

void* rpcc_connect(const char* host, int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return nullptr;
  }
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return nullptr;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new Client();
  c->fd = fd;
  return c;
}

// Per-request deadline (reference FLAGS_rpc_deadline,
// paddle/fluid/operators/distributed/grpc/grpc_client.cc): a pserver that
// hangs mid-round must surface as an error on the trainer, not block its
// recv() forever.  seconds <= 0 restores fully-blocking behavior.
void rpcc_set_deadline(void* h, double seconds) {
  auto* c = static_cast<Client*>(h);
  timeval tv{};
  if (seconds > 0) {
    tv.tv_sec = static_cast<time_t>(seconds);
    tv.tv_usec =
        static_cast<suseconds_t>((seconds - static_cast<double>(tv.tv_sec)) * 1e6);
  }
  ::setsockopt(c->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(c->fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

int rpcc_send_var(void* h, const char* name, unsigned char dtype,
                  const long long* dims, int ndim, const void* data,
                  long long len) {
  auto* c = static_cast<Client*>(h);
  Tensor t;
  t.dtype = dtype;
  t.dims.assign(dims, dims + ndim);
  t.data.assign(static_cast<const char*>(data), static_cast<size_t>(len));
  if (!write_frame(c->fd, kSendVar, name, &t)) return -1;
  Frame ack;
  if (!read_frame(c->fd, &ack) || ack.type != kAck) return -1;
  return 0;
}

int rpcc_barrier(void* h, const char* kind) {
  auto* c = static_cast<Client*>(h);
  if (!write_frame(c->fd, kBarrier, kind, nullptr)) return -1;
  Frame ack;
  if (!read_frame(c->fd, &ack) || ack.type != kAck) return -1;
  return 0;
}

int rpcc_complete(void* h) {
  auto* c = static_cast<Client*>(h);
  if (!write_frame(c->fd, kComplete, "", nullptr)) return -1;
  Frame ack;
  if (!read_frame(c->fd, &ack) || ack.type != kAck) return -1;
  return 0;
}

// Blocking GET: fills dtype/dims/ndim, returns a malloc'd payload pointer in
// *data (caller frees with rpc_free) and the byte length (<0 on error).
long long rpcc_get_var(void* h, const char* name, unsigned char* dtype,
                       long long* dims, int dims_cap, int* ndim,
                       void** data) {
  auto* c = static_cast<Client*>(h);
  if (!write_frame(c->fd, kGetVar, name, nullptr)) return -1;
  Frame f;
  if (!read_frame(c->fd, &f) || f.type != kReplyVar) return -1;
  *dtype = f.tensor.dtype;
  *ndim = static_cast<int>(f.tensor.dims.size());
  for (int i = 0; i < *ndim && i < dims_cap; ++i) dims[i] = f.tensor.dims[i];
  void* buf = ::malloc(f.tensor.data.size() ? f.tensor.data.size() : 1);
  std::memcpy(buf, f.tensor.data.data(), f.tensor.data.size());
  *data = buf;
  return static_cast<long long>(f.tensor.data.size());
}

void rpc_free(void* p) { ::free(p); }

void rpcc_close(void* h) {
  auto* c = static_cast<Client*>(h);
  ::close(c->fd);
  delete c;
}

}  // extern "C"

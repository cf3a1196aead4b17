// Bounded blocking queue of byte buffers: the DataLoader's hand-off between
// a Python producer thread and the consumer that feeds the card.
//
// The port's own copy of the reference package's queue
// (paddle_tpu/native/csrc/dataqueue.cc), itself modelled on Fluid's
// LoDTensorBlockingQueue (operators/reader/lod_tensor_blocking_queue.h).
// Buffers are opaque byte blobs (queue.py packs a batch of ndarrays with a
// small header); the queue owns copies, so producers can reuse their memory
// at once.  Plain C ABI, loaded with ctypes.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>

namespace {

struct Buffer {
  char* data;
  int64_t len;
};

struct Queue {
  explicit Queue(int capacity) : cap(capacity) {}
  ~Queue() {
    for (auto& b : items) delete[] b.data;
  }

  std::mutex mu;
  std::condition_variable not_full;
  std::condition_variable not_empty;
  std::deque<Buffer> items;
  int cap;
  bool closed = false;   // no more pushes; pops drain whatever remains
  bool killed = false;   // immediate shutdown, pending items dropped
};

}  // namespace

extern "C" {

void* dq_create(int capacity) { return new Queue(capacity > 0 ? capacity : 1); }

void dq_destroy(void* q) { delete static_cast<Queue*>(q); }

// 0 = ok, -1 = closed/killed, -2 = timeout. timeout_ms < 0 means block forever.
int dq_push(void* qp, const void* data, int64_t len, int timeout_ms) {
  Queue* q = static_cast<Queue*>(qp);
  std::unique_lock<std::mutex> lk(q->mu);
  auto ready = [q] {
    return q->closed || q->killed || static_cast<int>(q->items.size()) < q->cap;
  };
  if (timeout_ms < 0) {
    q->not_full.wait(lk, ready);
  } else if (!q->not_full.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                   ready)) {
    return -2;
  }
  if (q->closed || q->killed) return -1;
  Buffer b;
  b.len = len;
  b.data = new char[len > 0 ? len : 1];
  std::memcpy(b.data, data, static_cast<size_t>(len));
  q->items.push_back(b);
  q->not_empty.notify_one();
  return 0;
}

// >= 0: buffer length, *out set to a malloc'd buffer the caller must free
// with dq_free. -1 = closed-and-drained/killed, -2 = timeout.
int64_t dq_pop(void* qp, void** out, int timeout_ms) {
  Queue* q = static_cast<Queue*>(qp);
  std::unique_lock<std::mutex> lk(q->mu);
  auto ready = [q] { return q->killed || q->closed || !q->items.empty(); };
  if (timeout_ms < 0) {
    q->not_empty.wait(lk, ready);
  } else if (!q->not_empty.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                    ready)) {
    return -2;
  }
  if (q->killed || (q->items.empty() && q->closed)) return -1;
  if (q->items.empty()) return -2;
  Buffer b = q->items.front();
  q->items.pop_front();
  q->not_full.notify_one();
  *out = b.data;
  return b.len;
}

void dq_free(void* buf) { delete[] static_cast<char*>(buf); }

// Graceful close: producers stop, consumers drain what is left.
void dq_close(void* qp) {
  Queue* q = static_cast<Queue*>(qp);
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->not_full.notify_all();
  q->not_empty.notify_all();
}

// Immediate shutdown, dropping pending items (DataLoader reset()).
void dq_kill(void* qp) {
  Queue* q = static_cast<Queue*>(qp);
  std::lock_guard<std::mutex> lk(q->mu);
  q->killed = true;
  for (auto& b : q->items) delete[] b.data;
  q->items.clear();
  q->not_full.notify_all();
  q->not_empty.notify_all();
}

// Reopen after kill/close (queue reuse across epochs).
void dq_reopen(void* qp) {
  Queue* q = static_cast<Queue*>(qp);
  std::lock_guard<std::mutex> lk(q->mu);
  for (auto& b : q->items) delete[] b.data;
  q->items.clear();
  q->closed = false;
  q->killed = false;
}

int dq_size(void* qp) {
  Queue* q = static_cast<Queue*>(qp);
  std::lock_guard<std::mutex> lk(q->mu);
  return static_cast<int>(q->items.size());
}

int dq_is_closed(void* qp) {
  Queue* q = static_cast<Queue*>(qp);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->closed || q->killed;
}

}  // extern "C"

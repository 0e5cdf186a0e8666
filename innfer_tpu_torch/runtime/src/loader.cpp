// Async prefetch image loader: a background thread pool decodes upcoming
// images into a bounded queue while the GPU computes the current one.
// The port's copy of the JAX package's runtime/src/loader.cpp.
//
// The reference reads images synchronously inside the per-image loop
// (its run.py:404-412), serializing host decode with device compute.
// Here decode runs off-thread, and the consumer's wait in loader_next
// holds no Python lock (ctypes releases the GIL around the call), so the
// encode threads run meanwhile.
//
// C ABI (ctypes):
//   loader_create(paths, n, capacity, threads) -> handle
//   loader_next(handle, &data, &h, &w, &c, &index) -> status
//       (blocks until the next image in submission order is ready;
//        data ownership transfers to the caller -> free_image)
//   loader_destroy(handle)

#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int decode_png(const char* path, uint8_t** out, int* h, int* w, int* c);
int decode_jpeg(const char* path, uint8_t** out, int* h, int* w, int* c);
void free_image(uint8_t* p);
}

namespace {

struct Decoded {
  uint8_t* data = nullptr;
  int h = 0, w = 0, c = 0;
  int status = 0;
};

bool ends_with(const std::string& s, const char* suf) {
  size_t n = strlen(suf);
  if (s.size() < n) return false;
  for (size_t i = 0; i < n; ++i) {
    char a = s[s.size() - n + i];
    char b = suf[i];
    if (tolower(a) != tolower(b)) return false;
  }
  return true;
}

Decoded decode_any(const std::string& path) {
  Decoded d;
  if (ends_with(path, ".png")) {
    d.status = decode_png(path.c_str(), &d.data, &d.h, &d.w, &d.c);
  } else if (ends_with(path, ".jpg") || ends_with(path, ".jpeg")) {
    d.status = decode_jpeg(path.c_str(), &d.data, &d.h, &d.w, &d.c);
  } else {
    d.status = -3;  // unsupported container: Python falls back to cv2
  }
  return d;
}

struct Loader {
  std::vector<std::string> paths;
  size_t capacity;
  size_t next_submit = 0;   // next index a worker should take
  size_t next_emit = 0;     // next index the consumer will receive
  std::map<size_t, Decoded> ready;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_space;
  std::vector<std::thread> workers;
  bool stop = false;

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        // bounded prefetch: stay within `capacity` of the consumer
        cv_space.wait(lk, [&] {
          return stop || (next_submit < paths.size() &&
                          next_submit < next_emit + capacity);
        });
        if (stop || next_submit >= paths.size()) return;
        idx = next_submit++;
      }
      Decoded d = decode_any(paths[idx]);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready[idx] = d;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n, int capacity, int threads) {
  Loader* L = new Loader();
  for (int i = 0; i < n; ++i) L->paths.emplace_back(paths[i]);
  L->capacity = capacity > 0 ? capacity : 4;
  int nt = threads > 0 ? threads : 1;
  for (int i = 0; i < nt; ++i) L->workers.emplace_back(&Loader::worker, L);
  return L;
}

int loader_next(void* handle, uint8_t** data, int* h, int* w, int* c,
                int* index) {
  Loader* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_emit >= L->paths.size()) return 1;  // exhausted
  size_t idx = L->next_emit;
  L->cv_ready.wait(lk, [&] { return L->ready.count(idx) > 0; });
  Decoded d = L->ready[idx];
  L->ready.erase(idx);
  L->next_emit++;
  L->cv_space.notify_all();
  lk.unlock();

  *data = d.data;
  *h = d.h;
  *w = d.w;
  *c = d.c;
  *index = (int)idx;
  return d.status;  // 0 ok; <0 caller should cv2-fallback on paths[idx]
}

void loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
    L->next_submit = L->paths.size();
  }
  L->cv_space.notify_all();
  for (auto& t : L->workers) t.join();
  for (auto& kv : L->ready) free_image(kv.second.data);
  delete L;
}

}  // extern "C"

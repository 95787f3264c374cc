// Multi-threaded image-sequence prefetcher.
//
// The native data-loader of the framework: worker threads read + decode
// frames (PNG via png_decode.cpp, PGM natively) ahead of the consumer into
// a bounded ring of reusable float32 buffers, so host-side decode overlaps
// device compute. This is the accelerator-side counterpart of the reference's
// synchronous `cap >> image` in the hot loop (reference src/vslam.cpp:54),
// which stalled the pipeline on every frame.
//
// C API for ctypes; completion is strictly in submission order.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int png_decode_gray_f32(const uint8_t* data, int64_t size, float* out,
                        int32_t out_capacity);
int pgm_decode_gray_f32(const uint8_t* data, int64_t size, float* out,
                        int32_t out_capacity, int32_t* w, int32_t* h);
}

namespace {

struct Slot {
  std::vector<float> pixels;
  int32_t status = 0;  // 0 = pending, 1 = ready, <0 = error code
};

struct Prefetcher {
  std::vector<std::string> paths;
  int32_t width, height;
  std::vector<Slot> slots;           // one per frame index
  std::atomic<int64_t> next_job{0};
  int64_t next_consume = 0;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  int32_t lookahead;

  void worker_loop() {
    for (;;) {
      if (stop.load()) return;
      int64_t job = next_job.fetch_add(1);
      if (job >= (int64_t)paths.size()) return;
      // bounded lookahead: don't run more than `lookahead` frames past the
      // consumer (keeps memory bounded on long sequences)
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return stop.load() || job < next_consume + lookahead;
        });
        if (stop.load()) return;
      }
      int rc = decode(job);
      {
        // status is published under the mutex so the consumer's wait
        // predicate never sees a torn/early value
        std::lock_guard<std::mutex> lk(mu);
        slots[job].status = rc == 0 ? 1 : rc;
        cv.notify_all();
      }
    }
  }

  int decode(int64_t job) {
    Slot& s = slots[job];
    s.pixels.resize((size_t)width * height);
    FILE* f = fopen(paths[job].c_str(), "rb");
    if (!f) return -100;
    fseek(f, 0, SEEK_END);
    int64_t size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> buf(size);
    if ((int64_t)fread(buf.data(), 1, size, f) != size) {
      fclose(f);
      return -101;
    }
    fclose(f);
    int rc;
    if (size >= 2 && buf[0] == 'P' && buf[1] == '5') {
      int32_t w, h;
      rc = pgm_decode_gray_f32(buf.data(), size, s.pixels.data(),
                               width * height, &w, &h);
      if (rc == 0 && (w != width || h != height)) rc = -102;
    } else {
      rc = png_decode_gray_f32(buf.data(), size, s.pixels.data(),
                               width * height);
    }
    return rc;
  }
};

}  // namespace

extern "C" {

// paths: '\n'-joined file list. All frames must decode to (width, height).
void* prefetcher_create(const char* paths_joined, int32_t width,
                        int32_t height, int32_t n_workers,
                        int32_t lookahead) {
  Prefetcher* p = new Prefetcher();
  p->width = width;
  p->height = height;
  p->lookahead = lookahead > 0 ? lookahead : 8;
  const char* s = paths_joined;
  while (*s) {
    const char* e = strchr(s, '\n');
    if (!e) e = s + strlen(s);
    if (e > s) p->paths.emplace_back(s, e - s);
    s = *e ? e + 1 : e;
  }
  p->slots.resize(p->paths.size());
  int32_t nw = n_workers > 0 ? n_workers : 2;
  for (int32_t i = 0; i < nw; ++i)
    p->workers.emplace_back([p] { p->worker_loop(); });
  return p;
}

int64_t prefetcher_count(void* h) {
  return (int64_t)((Prefetcher*)h)->paths.size();
}

// Blocks until frame `idx` is decoded; copies into out (width*height floats).
// Returns 0 on success. Frames must be consumed roughly in order (the
// lookahead window advances with the highest index fetched).
int32_t prefetcher_get(void* h, int64_t idx, float* out) {
  Prefetcher* p = (Prefetcher*)h;
  if (idx < 0 || idx >= (int64_t)p->paths.size()) return -1;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    if (idx + 1 > p->next_consume) {
      p->next_consume = idx + 1;
      p->cv.notify_all();
    }
    p->cv.wait(lk, [&] { return p->slots[idx].status != 0 || p->stop.load(); });
  }
  Slot& s = p->slots[idx];
  if (s.status != 1) return s.status;
  memcpy(out, s.pixels.data(), sizeof(float) * p->width * p->height);
  // release memory of consumed frame
  std::vector<float>().swap(s.pixels);
  return 0;
}

void prefetcher_destroy(void* h) {
  Prefetcher* p = (Prefetcher*)h;
  p->stop.store(true);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->cv.notify_all();
  }
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"

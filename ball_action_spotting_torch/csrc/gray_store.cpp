// gray_store: memory-mapped grayscale frame store and a threaded clip gather,
// the host library behind ball_action_spotting_torch/data/gray_store.py.
//
// The port's copy of the JAX package's native/gray_store.cpp: videos are
// transcoded once into a raw uint8 store, after which training and
// inference read frames at page-cache memcpy speed instead of decoding
// H.264 around every sampled window. No CUDA: the frames go to the card
// through the loader's pinned copy.
//
// File layout (little-endian):
//   [0:8)   magic "GRAYSTR1"
//   [8:12)  uint32 height
//   [12:16) uint32 width
//   [16:24) uint64 frame_count
//   [24:..) frame_count * height * width bytes, frame-major
//
// Differences from the JAX library:
//   - gray_store_gather takes the output's clip, frame and row strides in
//     bytes, so it writes a padded view of a batch buffer (720 stored rows
//     into 736, a narrower width into a wider one) directly, one memcpy per
//     row; a C-contiguous output still takes one memcpy per frame.
//
// C API (ctypes); every function returns 0 on success, negative on error.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <vector>

namespace {

constexpr char kMagic[8] = {'G', 'R', 'A', 'Y', 'S', 'T', 'R', '1'};
constexpr int64_t kHeaderSize = 24;

struct Store {
  int fd = -1;
  const uint8_t* data = nullptr;  // mmap base
  size_t size = 0;
  uint32_t height = 0;
  uint32_t width = 0;
  uint64_t frame_count = 0;

  const uint8_t* frame(uint64_t idx) const {
    return data + kHeaderSize + idx * (size_t)height * width;
  }
};

struct GatherTask {
  const Store* store;
  const int64_t* indexes;  // flattened (num_clips, frames_per_clip)
  uint8_t* out;            // element (c, f, y, x) at c*clip + f*frame + y*row + x
  int64_t num_clips;
  int64_t frames_per_clip;
  int64_t clip_stride;
  int64_t frame_stride;
  int64_t row_stride;
  std::atomic<int64_t>* next;
};

void copy_frame(const Store& s, const uint8_t* src, uint8_t* dst, int64_t row_stride) {
  const size_t w = s.width;
  if (row_stride == (int64_t)w) {
    memcpy(dst, src, (size_t)s.height * w);
    return;
  }
  for (uint32_t y = 0; y < s.height; ++y) memcpy(dst + y * row_stride, src + y * w, w);
}

void* gather_worker(void* arg) {
  auto* task = static_cast<GatherTask*>(arg);
  const Store& s = *task->store;
  for (;;) {
    const int64_t clip = task->next->fetch_add(1);
    if (clip >= task->num_clips) break;
    const int64_t* idx = task->indexes + clip * task->frames_per_clip;
    uint8_t* dst = task->out + clip * task->clip_stride;
    for (int64_t f = 0; f < task->frames_per_clip; ++f) {
      int64_t i = idx[f];
      if (i < 0) i = 0;
      if ((uint64_t)i >= s.frame_count) i = (int64_t)s.frame_count - 1;
      copy_frame(s, s.frame((uint64_t)i), dst + f * task->frame_stride, task->row_stride);
    }
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Opens a store; returns a handle pointer via *out_handle.
int gray_store_open(const char* path, void** out_handle) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -2;
  }
  if ((size_t)st.st_size < (size_t)kHeaderSize) {
    close(fd);
    return -4;
  }
  void* base = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return -3;
  }
  auto* s = new Store();
  s->fd = fd;
  s->data = static_cast<const uint8_t*>(base);
  s->size = (size_t)st.st_size;
  if (memcmp(s->data, kMagic, sizeof(kMagic)) != 0) {
    munmap(base, s->size);
    close(fd);
    delete s;
    return -4;
  }
  memcpy(&s->height, s->data + 8, 4);
  memcpy(&s->width, s->data + 12, 4);
  memcpy(&s->frame_count, s->data + 16, 8);
  const size_t expected = kHeaderSize + (size_t)s->frame_count * s->height * s->width;
  if (s->size < expected) {
    munmap(base, s->size);
    close(fd);
    delete s;
    return -5;
  }
  *out_handle = s;
  return 0;
}

int gray_store_info(void* handle, uint32_t* height, uint32_t* width, uint64_t* frame_count) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return -1;
  *height = s->height;
  *width = s->width;
  *frame_count = s->frame_count;
  return 0;
}

// Copy frames [start, start + count) into out (count * H * W bytes).
int gray_store_read(void* handle, int64_t start, int64_t count, uint8_t* out) {
  auto* s = static_cast<Store*>(handle);
  if (!s || start < 0 || count < 0 || (uint64_t)(start + count) > s->frame_count) return -1;
  memcpy(out, s->frame((uint64_t)start), (size_t)count * s->height * s->width);
  return 0;
}

// Gather clips: indexes is (num_clips * frames_per_clip) flattened frame
// indexes, out-of-range ones clamped to the store; frame f of clip c goes to
// out + c * clip_stride + f * frame_stride, its rows row_stride bytes apart
// (row_stride >= width). The threads take whole clips; num_threads <= 1, or
// a single clip, gathers on the calling thread.
int gray_store_gather(void* handle, const int64_t* indexes, int64_t num_clips,
                      int64_t frames_per_clip, uint8_t* out, int64_t clip_stride,
                      int64_t frame_stride, int64_t row_stride, int num_threads) {
  auto* s = static_cast<Store*>(handle);
  if (!s || num_clips < 0 || frames_per_clip < 0 || row_stride < (int64_t)s->width) return -1;
  if (num_clips * frames_per_clip > 0 && s->frame_count == 0) return -2;  // nothing to clamp to
  std::atomic<int64_t> next(0);
  GatherTask task{s, indexes, out, num_clips, frames_per_clip,
                  clip_stride, frame_stride, row_stride, &next};
  if (num_threads <= 1 || num_clips <= 1) {
    gather_worker(&task);
    return 0;
  }
  const int n = num_threads < num_clips ? num_threads : (int)num_clips;
  std::vector<pthread_t> threads((size_t)n);
  int started = 0;
  for (; started < n; ++started) {
    if (pthread_create(&threads[(size_t)started], nullptr, gather_worker, &task) != 0) break;
  }
  if (started == 0) gather_worker(&task);  // no thread could start: gather here
  for (int i = 0; i < started; ++i) pthread_join(threads[(size_t)i], nullptr);
  return 0;
}

int gray_store_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return -1;
  munmap(const_cast<uint8_t*>(s->data), s->size);
  close(s->fd);
  delete s;
  return 0;
}

}  // extern "C"

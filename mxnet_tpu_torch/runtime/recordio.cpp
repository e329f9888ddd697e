// Native IO runtime — RecordIO scanning + batch assembly.
//
// TPU-native replacement for the reference's C++ input stack
// (src/io/iter_image_recordio_2.cc + dmlc/recordio.h): the file is mmapped
// and scanned once for record boundaries (magic 0xced7230a framing), giving
// O(1) random access without a .idx sidecar; batch assembly (uint8 HWC ->
// float CHW with mean/scale/mirror/crop) runs multi-threaded with OpenMP,
// replacing the reference's per-thread decode loop feeding mshadow tensors.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint32_t kLenMask = 0x1fffffff;

struct RecordFile {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  std::vector<size_t> offsets;  // payload offsets
  std::vector<size_t> lengths;  // payload lengths
};

}  // namespace

extern "C" {

// Open + scan a RecordIO file; returns an opaque handle (nullptr on error).
void* ri_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 8) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* rf = new RecordFile();
  rf->fd = fd;
  rf->data = static_cast<const uint8_t*>(mem);
  rf->size = static_cast<size_t>(st.st_size);
  // sequential scan over the framing: [magic][lrec][payload][pad to 4]
  size_t pos = 0;
  while (pos + 8 <= rf->size) {
    uint32_t magic, lrec;
    std::memcpy(&magic, rf->data + pos, 4);
    std::memcpy(&lrec, rf->data + pos + 4, 4);
    if (magic != kMagic) break;  // corrupt or end
    const size_t len = lrec & kLenMask;
    if (pos + 8 + len > rf->size) break;
    rf->offsets.push_back(pos + 8);
    rf->lengths.push_back(len);
    size_t padded = (len + 3u) & ~size_t(3);
    pos += 8 + padded;
  }
  return rf;
}

int64_t ri_count(void* handle) {
  if (!handle) return -1;
  return static_cast<RecordFile*>(handle)->offsets.size();
}

// Pointer+length of record i (zero-copy into the mmap).
const uint8_t* ri_get(void* handle, int64_t i, int64_t* len) {
  auto* rf = static_cast<RecordFile*>(handle);
  if (!rf || i < 0 || static_cast<size_t>(i) >= rf->offsets.size()) {
    if (len) *len = 0;
    return nullptr;
  }
  if (len) *len = static_cast<int64_t>(rf->lengths[i]);
  return rf->data + rf->offsets[i];
}

void ri_close(void* handle) {
  auto* rf = static_cast<RecordFile*>(handle);
  if (!rf) return;
  munmap(const_cast<uint8_t*>(rf->data), rf->size);
  ::close(rf->fd);
  delete rf;
}

// Assemble a training batch: n uint8 HWC images (contiguous, same size) ->
// float32 NCHW with per-channel mean/std, optional horizontal mirror per
// sample, optional top-left crop offsets. Parallel over samples.
void assemble_batch(const uint8_t* src, int64_t n, int64_t h, int64_t w,
                    int64_t c, const float* mean, const float* std_inv,
                    const uint8_t* mirror, const int32_t* crop_y,
                    const int32_t* crop_x, int64_t out_h, int64_t out_w,
                    float* dst) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* img = src + i * h * w * c;
    float* out = dst + i * c * out_h * out_w;
    const int64_t cy = crop_y ? crop_y[i] : 0;
    const int64_t cx = crop_x ? crop_x[i] : 0;
    const bool flip = mirror && mirror[i];
    for (int64_t ch = 0; ch < c; ++ch) {
      const float m = mean ? mean[ch] : 0.f;
      const float s = std_inv ? std_inv[ch] : 1.f;
      float* oc = out + ch * out_h * out_w;
      for (int64_t y = 0; y < out_h; ++y) {
        const uint8_t* row = img + ((y + cy) * w + cx) * c + ch;
        float* orow = oc + y * out_w;
        if (flip) {
          for (int64_t x = 0; x < out_w; ++x)
            orow[x] = (static_cast<float>(row[(out_w - 1 - x) * c]) - m) * s;
        } else {
          for (int64_t x = 0; x < out_w; ++x)
            orow[x] = (static_cast<float>(row[x * c]) - m) * s;
        }
      }
    }
  }
}

// Write-side framing helper: frame n records (lengths[i] bytes each,
// concatenated in src) into dst; returns total bytes written.
int64_t ri_frame(const uint8_t* src, const int64_t* lengths, int64_t n,
                 uint8_t* dst) {
  size_t pos = 0, spos = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t magic = kMagic;
    const uint32_t lrec = static_cast<uint32_t>(lengths[i]) & kLenMask;
    std::memcpy(dst + pos, &magic, 4);
    std::memcpy(dst + pos + 4, &lrec, 4);
    std::memcpy(dst + pos + 8, src + spos, lengths[i]);
    size_t padded = (static_cast<size_t>(lengths[i]) + 3u) & ~size_t(3);
    std::memset(dst + pos + 8 + lengths[i], 0, padded - lengths[i]);
    pos += 8 + padded;
    spos += lengths[i];
  }
  return static_cast<int64_t>(pos);
}

}  // extern "C"

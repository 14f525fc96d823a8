// libzstd's one-shot calls (include/zstd.h) on the port's own codec:
// ZSTD_compress on zstd_enc.cpp's encoder, ZSTD_decompress on zstd.cpp's
// decoder.  Errors are libzstd's codes, returned as (size_t)-code: the
// encoder's short capacity is dstSize_tooSmall, and every decoder error
// one code, corruption_detected.
// Linked into fastio's library (native/__init__.py), so fastio.cpp, a
// copy of the JAX package's, builds where libzstd's headers are missing.

#include <cstdint>

#include <zstd.h>

extern "C" {
int64_t zstd_encode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                    int32_t level);
int64_t zstd_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                    char* err, int32_t errlen);
}

namespace {

// libzstd's error codes (zstd_errors.h) used here.
enum : size_t {
  kCorruption = 20,
  kMemory = 64,
  kDstTooSmall = 70,
  kMaxCode = 120,
};

inline size_t error(size_t code) { return size_t(0) - code; }

}  // namespace

extern "C" {

size_t ZSTD_compressBound(size_t n) {
  return n + (n >> 8) + (n < (size_t(128) << 10)
                             ? ((size_t(128) << 10) - n) >> 11
                             : 0);
}

size_t ZSTD_compress(void* dst, size_t cap, const void* src, size_t n,
                     int level) {
  const int64_t got =
      zstd_encode(static_cast<const uint8_t*>(src), int64_t(n),
                  static_cast<uint8_t*>(dst), int64_t(cap), level);
  if (got == -1) return error(kDstTooSmall);
  if (got < 0) return error(kMemory);
  return size_t(got);
}

size_t ZSTD_decompress(void* dst, size_t cap, const void* src, size_t n) {
  const int64_t got =
      zstd_decode(static_cast<const uint8_t*>(src), int64_t(n),
                  static_cast<uint8_t*>(dst), int64_t(cap), nullptr, 0);
  if (got < 0) return error(kCorruption);
  return size_t(got);
}

unsigned ZSTD_isError(size_t code) { return code > error(kMaxCode); }

}  // extern "C"

/* The four functions of libzstd's zstd.h that native/fastio.cpp calls,
 * with libzstd's signatures, implemented without libzstd by
 * native/zstd_api.cpp (decoder native/zstd.cpp, encoder
 * native/zstd_enc.cpp).  fastio's build puts this directory first on the
 * include path, so `#include <zstd.h>` finds this file on every host. */
#ifndef IPP_TPU_TORCH_ZSTD_H
#define IPP_TPU_TORCH_ZSTD_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

/* The largest frame ZSTD_compress writes for srcSize bytes (libzstd's
 * formula). */
size_t ZSTD_compressBound(size_t srcSize);

/* One frame of src at compressionLevel (clamped to [-5, 22]; 0 means 3)
 * into dst; its size, or an error code when dstCapacity is short. */
size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src,
                     size_t srcSize, int compressionLevel);

/* The frames of src decoded into dst; the bytes written, or an error
 * code. */
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);

/* Whether a return value above is an error code, (size_t)-code as libzstd
 * returns it. */
unsigned ZSTD_isError(size_t code);

#ifdef __cplusplus
}
#endif

#endif /* IPP_TPU_TORCH_ZSTD_H */

// HDF5 chunk filters that are sequential by nature, for io/hdf5_filters.py
// (loaded through ctypes, so the reader's inflate threads run them outside
// the GIL).  Built with g++ at first use into build/ipp_tpu_torch/.
//
// lzf: the LZF format of Marc Lehmann's liblzf 3.x, as h5py's lzf filter
// (filter 32000) stores a chunk.  A stream is a run of blocks, each led by a
// control byte c:
//   c < 32:  a literal run of c + 1 bytes follows;
//   c >= 32: a back reference: length (c >> 5) + 2, or 7 + the next byte
//            + 2 when c >> 5 is 7; distance ((c & 31) << 8 | the next byte)
//            + 1 back from the output's end (the copy may overlap itself).

#include <cstdint>
#include <cstring>

extern "C" {

int h5filters_abi_version() { return 1; }

// Decode in[0:n] into out[0:cap]: the bytes written, -1 when the stream
// is not valid LZF, -2 when out is too small (the caller grows it).
int64_t h5filters_lzf_decompress(const uint8_t* in, int64_t n, uint8_t* out,
                                 int64_t cap) {
  const uint8_t* ip = in;
  const uint8_t* const in_end = in + n;
  uint8_t* op = out;
  uint8_t* const out_end = out + cap;
  while (ip < in_end) {
    unsigned ctrl = *ip++;
    if (ctrl < 32) {
      int64_t len = ctrl + 1;
      if (op + len > out_end) return -2;
      if (ip + len > in_end) return -1;
      std::memcpy(op, ip, static_cast<size_t>(len));
      op += len;
      ip += len;
    } else {
      int64_t len = ctrl >> 5;
      if (len == 7) {
        if (ip >= in_end) return -1;
        len += *ip++;
      }
      if (ip >= in_end) return -1;
      const uint8_t* ref = op - ((ctrl & 31) << 8) - 1 - *ip++;
      len += 2;
      if (op + len > out_end) return -2;
      if (ref < out) return -1;
      for (int64_t i = 0; i < len; ++i) op[i] = ref[i];
      op += len;
    }
  }
  return op - out;
}

}  // extern "C"

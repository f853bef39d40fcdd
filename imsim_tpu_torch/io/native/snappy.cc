// Snappy raw-block decompression (the format parquet's SNAPPY codec
// stores a page in): a varint of the uncompressed length, then literal
// and copy elements.  Every length and offset comes from the file, so
// each literal and copy is bounds-checked against the input and the
// output; a corrupt stream returns a negative code and never reads or
// writes outside the buffers.
//
// Also the RLE / bit-packed hybrid decoder of parquet's definition and
// repetition levels and dictionary indices.
//
// Built with: g++ -O3 -shared -fPIC snappy.cc
#include <cstdint>
#include <cstring>

namespace {

// varint at src[*pos]; -1 on overrun or more than 5 bytes (> 32 bits)
long read_varint32(const uint8_t* src, long n, long* pos) {
  uint64_t v = 0;
  for (int shift = 0; shift <= 28; shift += 7) {
    if (*pos >= n) return -1;
    uint8_t b = src[(*pos)++];
    v |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) return v > 0xffffffffULL ? -1 : static_cast<long>(v);
  }
  return -1;
}

}  // namespace

extern "C" {

// The uncompressed length the stream declares, or -1.
long snappy_uncompressed_length(const uint8_t* src, long n) {
  long pos = 0;
  return read_varint32(src, n, &pos);
}

// Decompress src[0:n] into dst[0:cap]; returns the bytes written (equal
// to the declared length) or a negative code: -1 bad header, -2 literal
// past the input, -3 literal past the output, -4 copy offset 0 or before
// the output's start, -5 copy past the output, -6 truncated element,
// -7 length differs from the declared one.
long snappy_decompress(const uint8_t* src, long n, uint8_t* dst, long cap) {
  long pos = 0;
  long want = read_varint32(src, n, &pos);
  if (want < 0 || want > cap) return -1;
  long out = 0;
  while (pos < n) {
    uint8_t tag = src[pos++];
    long len, off;
    switch (tag & 3) {
      case 0: {  // literal
        len = (tag >> 2) + 1;
        if (len > 60) {
          int nb = static_cast<int>(len - 60);  // 1..4 length bytes
          if (pos + nb > n) return -6;
          uint32_t v = 0;
          for (int i = 0; i < nb; ++i)
            v |= static_cast<uint32_t>(src[pos + i]) << (8 * i);
          pos += nb;
          len = static_cast<long>(v) + 1;
        }
        if (len > n - pos) return -2;
        if (len > want - out) return -3;
        std::memcpy(dst + out, src + pos, len);
        pos += len;
        out += len;
        continue;
      }
      case 1:  // copy, 1-byte offset
        if (pos + 1 > n) return -6;
        len = ((tag >> 2) & 7) + 4;
        off = (static_cast<long>(tag >> 5) << 8) | src[pos];
        pos += 1;
        break;
      case 2:  // copy, 2-byte offset
        if (pos + 2 > n) return -6;
        len = (tag >> 2) + 1;
        off = src[pos] | (static_cast<long>(src[pos + 1]) << 8);
        pos += 2;
        break;
      default:  // copy, 4-byte offset
        if (pos + 4 > n) return -6;
        len = (tag >> 2) + 1;
        off = static_cast<long>(src[pos] | (src[pos + 1] << 8) |
                                (src[pos + 2] << 16) |
                                (static_cast<uint32_t>(src[pos + 3]) << 24));
        pos += 4;
        break;
    }
    if (off <= 0 || off > out) return -4;
    if (len > want - out) return -5;
    // byte by byte: a copy may overlap the bytes it writes
    const uint8_t* from = dst + out - off;
    for (long i = 0; i < len; ++i) dst[out + i] = from[i];
    out += len;
  }
  return out == want ? out : -7;
}

// Parquet's RLE / bit-packed hybrid: decode `count` values of
// `bit_width` bits (0..32) from src[0:n] into dst.  Runs: a varint
// header; odd = (header >> 1) groups of 8 bit-packed values, LSB first;
// even = a run of (header >> 1) copies of one value in
// ceil(bit_width / 8) little-endian bytes.  The last bit-packed group may
// hold more values than asked for (padding).  Returns the bytes read, or
// -1 on a truncated or malformed stream.
long rle_hybrid_decode(const uint8_t* src, long n, int bit_width,
                       uint32_t* dst, long count) {
  if (bit_width < 0 || bit_width > 32) return -1;
  long pos = 0, got = 0;
  const int vbytes = (bit_width + 7) / 8;
  const uint64_t mask =
      bit_width == 32 ? 0xffffffffULL : ((1ULL << bit_width) - 1);
  while (got < count) {
    long header = read_varint32(src, n, &pos);
    if (header < 0) return -1;
    if (header & 1) {
      long groups = header >> 1;
      long nvals = groups * 8;
      long nbytes = groups * bit_width;
      if (nbytes > n - pos) return -1;
      long take = nvals < count - got ? nvals : count - got;
      for (long i = 0; i < take; ++i) {
        long bit = i * bit_width;
        uint64_t v = 0;
        long byte = bit >> 3;
        int shift = static_cast<int>(bit & 7);
        // up to 5 bytes hold one value of <= 32 bits at any shift
        for (int k = 0; k < 5 && byte + k < nbytes; ++k)
          v |= static_cast<uint64_t>(src[pos + byte + k]) << (8 * k);
        dst[got + i] = static_cast<uint32_t>((v >> shift) & mask);
      }
      got += take;
      pos += nbytes;
    } else {
      long run = header >> 1;
      if (vbytes > n - pos) return -1;
      uint32_t v = 0;
      for (int k = 0; k < vbytes; ++k)
        v |= static_cast<uint32_t>(src[pos + k]) << (8 * k);
      pos += vbytes;
      long take = run < count - got ? run : count - got;
      for (long i = 0; i < take; ++i) dst[got + i] = v;
      got += take;
      if (run == 0 && take == 0) return -1;  // a run that never ends
    }
  }
  return pos;
}

}  // extern "C"

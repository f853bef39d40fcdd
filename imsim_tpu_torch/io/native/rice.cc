// RICE_1 tile codec for FITS tiled-image compression.
//
// The reference writes per-amp RICE_1-compressed int32 HDUs through
// astropy/cfitsio (imsim/readout.py:479-526).  This is a from-scratch
// implementation of the interchange format defined by the FITS 4.0
// standard (section "Rice compression") and Rice/Yeh/Miller 1993, as
// produced/consumed by cfitsio's fits_rcomp/fits_rdecomp:
//   stream := first_pixel (bbits big-endian) , blocks*
//     blocks cover ALL nx pixels from index 0 (the first encoded
//     difference is therefore always a[0]-a[0] = 0)
//   block  := fs_code(5 bits) , payload    (fs = fs_code - 1)
//     fs_code = 0          -> 32 zero diffs (pixels repeat lastpix)
//     fs_code = fsmax+1=26 -> 32 mapped diffs raw at bbits each
//     else per pixel: (mapped>>fs) zero bits + '1', then fs low bits
//   mapped = zigzag(diff):  d>=0 -> 2d,  d<0 -> 2|d|-1
// The fs choice follows cfitsio's statistic (mean-based, computed in
// double) so the emitted bitstream is what cfitsio itself would write;
// tests/test_rice_interop.py pins this against an independent
// pure-Python transcription of the published algorithm.
//
// Build: g++ -O3 -shared -fPIC rice.cc (io/rice.py builds it at first
// use into imsim_tpu_torch/_build/, named by a hash of this source).
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int NBLOCK = 32;
constexpr int FSBITS = 5;
constexpr int FSMAX = 25;   // int32
constexpr int BBITS = 32;

struct BitWriter {
  // 64-bit accumulator writing straight into a caller-owned buffer:
  // ~20x faster than the byte-at-a-time vector version.
  uint8_t* out;
  size_t pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  explicit BitWriter(uint8_t* o) : out(o) {}
  inline void drain() {
    while (nbits >= 8) {
      out[pos++] = uint8_t((acc >> (nbits - 8)) & 0xFF);
      nbits -= 8;
    }
    acc &= (nbits ? ((1ull << nbits) - 1ull) : 0ull);
  }
  inline void put(uint32_t val, int n) {
    // n <= 32, acc holds < 8 bits on entry -> fits in 64
    acc = (acc << n) | (n == 32 ? uint64_t(val)
                                : uint64_t(val & ((1u << n) - 1u)));
    nbits += n;
    drain();
  }
  inline void put_zeros(int n) {
    while (n >= 32) { put(0, 32); n -= 32; }
    if (n) put(0, n);
  }
  void flush() {
    if (nbits) {
      out[pos++] = uint8_t((acc << (8 - nbits)) & 0xFF);
      nbits = 0;
      acc = 0;
    }
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t acc = 0;
  int nbits = 0;
  BitReader(const uint8_t* data, size_t n) : p(data), end(data + n) {}
  inline uint32_t get(int n) {
    uint32_t v = 0;
    while (n > 0) {
      if (nbits == 0) {
        acc = (p < end) ? *p++ : 0;
        nbits = 8;
      }
      int take = n < nbits ? n : nbits;
      v = (v << take) | ((acc >> (nbits - take)) & ((1u << take) - 1u));
      nbits -= take;
      n -= take;
    }
    return v;
  }
  inline int count_zeros_until_one() {
    int n = 0;
    for (;;) {
      if (nbits == 0) {
        acc = (p < end) ? *p++ : 1;  // fail-safe: fabricate terminator
        nbits = 8;
      }
      uint32_t window = acc & ((1u << nbits) - 1u);
      if (window == 0) { n += nbits; nbits = 0; continue; }
      // leading zeros within the nbits window
      int lead = 0;
      while (!((window >> (nbits - 1 - lead)) & 1u)) ++lead;
      n += lead;
      nbits -= lead + 1;  // consume zeros + the terminating 1
      return n;
    }
  }
};

}  // namespace

extern "C" {

// Compress n int32 pixels; out must have room for 8 + 5*n bytes
// (the cfitsio fs statistic bounds the unary spend at < 2 bits/pixel
// above the 1+fs budget, and raw blocks cost 32.16 bits/pixel).
// Returns compressed size in bytes.
long rice_encode_i32(const int32_t* a, long n, uint8_t* out_buf) {
  if (n <= 0) return 0;
  int32_t lastpix = a[0];
  uint32_t u = uint32_t(lastpix);
  out_buf[0] = uint8_t(u >> 24);
  out_buf[1] = uint8_t(u >> 16);
  out_buf[2] = uint8_t(u >> 8);
  out_buf[3] = uint8_t(u);
  BitWriter bw(out_buf + 4);
  std::vector<uint32_t> mapped(NBLOCK);
  // Blocks cover ALL n pixels from index 0 (cfitsio fits_rcomp layout:
  // the first mapped difference is a[0]-lastpix = 0).
  for (long start = 0; start < n; start += NBLOCK) {
    long m = (start + NBLOCK <= n) ? NBLOCK : (n - start);
    double pixelsum = 0.0;
    for (long i = 0; i < m; ++i) {
      // wraparound difference + 32-bit zigzag: bijective for ALL int32
      int32_t diff = int32_t(uint32_t(a[start + i]) - uint32_t(lastpix));
      lastpix = a[start + i];
      uint32_t mv = (uint32_t(diff) << 1) ^ uint32_t(diff >> 31);
      mapped[i] = mv;
      pixelsum += double(mv);
    }
    if (pixelsum == 0.0) {
      bw.put(0, FSBITS);
      continue;
    }
    // cfitsio's bit-width statistic: fs = position of the highest set
    // bit of half the (slightly debiased) mean mapped difference.
    double dpsum = (pixelsum - double(m / 2) - 1.0) / double(m);
    if (dpsum < 0) dpsum = 0.0;
    uint64_t psum = uint64_t(dpsum) >> 1;
    int fs = 0;
    while (psum > 0) { ++fs; psum >>= 1; }
    if (fs >= FSMAX) {
      // high entropy: mapped diffs raw at full width, marker fsmax+1
      bw.put(uint32_t(FSMAX + 1), FSBITS);
      for (long i = 0; i < m; ++i) bw.put(mapped[i], BBITS);
    } else {
      bw.put(uint32_t(fs + 1), FSBITS);
      for (long i = 0; i < m; ++i) {
        uint32_t top = mapped[i] >> fs;
        bw.put_zeros(int(top));
        bw.put(1, 1);
        if (fs) bw.put(mapped[i] & ((1u << fs) - 1u), fs);
      }
    }
  }
  bw.flush();
  return long(4 + bw.pos);
}

// Decompress into n int32 pixels.  Returns n on success, -1 on error.
long rice_decode_i32(const uint8_t* buf, long nbytes, int32_t* a, long n) {
  if (n <= 0) return 0;
  if (nbytes < 4) return -1;
  uint32_t u = (uint32_t(buf[0]) << 24) | (uint32_t(buf[1]) << 16) |
               (uint32_t(buf[2]) << 8) | uint32_t(buf[3]);
  int32_t lastpix = int32_t(u);
  BitReader br(buf + 4, size_t(nbytes - 4));
  // Blocks cover ALL n pixels from index 0 (cfitsio fits_rdecomp
  // layout); a[0] decodes as lastpix + 0.
  for (long start = 0; start < n; start += NBLOCK) {
    long m = (start + NBLOCK <= n) ? NBLOCK : (n - start);
    uint32_t fsf = br.get(FSBITS);
    if (fsf == 0) {
      for (long i = 0; i < m; ++i) a[start + i] = lastpix;
    } else if (fsf == uint32_t(FSMAX + 1)) {
      for (long i = 0; i < m; ++i) {
        uint32_t mv = br.get(BBITS);
        int32_t diff = int32_t((mv >> 1) ^ (~(mv & 1u) + 1u));
        lastpix = int32_t(uint32_t(lastpix) + uint32_t(diff));
        a[start + i] = lastpix;
      }
    } else {
      int fs = int(fsf) - 1;
      for (long i = 0; i < m; ++i) {
        uint32_t top = uint32_t(br.count_zeros_until_one());
        uint32_t low = fs ? br.get(fs) : 0u;
        uint32_t mv = (top << fs) | low;
        int32_t diff = int32_t((mv >> 1) ^ (~(mv & 1u) + 1u));
        lastpix = int32_t(uint32_t(lastpix) + uint32_t(diff));
        a[start + i] = lastpix;
      }
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// Fast phoSim instance-catalog scanner: the byte offsets of the lines
// that start with 'object'; returns their count (at most max_lines).
long instcat_scan(const char* buf, long n, long* line_starts, long max_lines) {
  long count = 0;
  long i = 0;
  while (i < n && count < max_lines) {
    if (n - i >= 6 && std::memcmp(buf + i, "object", 6) == 0) {
      line_starts[count++] = i;
    }
    while (i < n && buf[i] != '\n') ++i;
    ++i;
  }
  return count;
}

}  // extern "C"

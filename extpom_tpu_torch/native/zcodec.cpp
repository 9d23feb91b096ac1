// Decoder of the blosc1 frames that Zarr v2 stores hold as chunks
// (``extpom_tpu_torch/io/zarr.py``): LZ4 blocks and byte unshuffle.
//
// A frame is a 16-byte header (version, LZ4 version, flags, typesize,
// nbytes, blocksize, cbytes; little-endian u32s), then either the raw bytes
// (flag 0x02, memcpyed) or one u32 start offset per block and the blocks.
// A block is compressed as `typesize` streams, one per byte of the type,
// unless flag 0x10 says it was not split or it is the short last block;
// each stream is a u32 compressed size and an LZ4 block (the raw bytes
// where that size equals the stream's).  Flag 0x01 byte-shuffles each
// block: byte j of element i lies at j * (block / typesize) + i.  Flags
// 0xe0 hold the codec (1: LZ4); 0x04 is bitshuffle.  The Python side
// refuses every other codec and bitshuffle before calling here.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared zcodec.cpp -o libzcodec.so

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr size_t kHeader = 16;
constexpr uint8_t kShuffle = 0x01, kMemcpyed = 0x02, kBitShuffle = 0x04,
                  kNoSplit = 0x10;

uint32_t u32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

// One LZ4 block of n bytes into dst (cap bytes): the bytes written, or -1
// where the stream is malformed or does not fit.
int64_t lz4_block(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  uint8_t* op = dst;
  uint8_t* const oend = dst + cap;
  while (ip < iend) {
    const unsigned token = *ip++;
    size_t lit = token >> 4;
    if (lit == 15) {
      unsigned b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (size_t(iend - ip) < lit || size_t(oend - op) < lit) return -1;
    std::memcpy(op, ip, lit);
    ip += lit;
    op += lit;
    if (ip == iend) break;  // the last sequence holds literals only
    if (iend - ip < 2) return -1;
    const size_t off = size_t(ip[0]) | size_t(ip[1]) << 8;
    ip += 2;
    if (off == 0 || off > size_t(op - dst)) return -1;
    size_t len = token & 15;
    if (len == 15) {
      unsigned b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        len += b;
      } while (b == 255);
    }
    len += 4;
    if (size_t(oend - op) < len) return -1;
    // a match may overlap its own output (off < len): it repeats the last
    // off bytes, so copy at most off bytes at a time
    for (size_t k = 0; k < len;) {
      const size_t c = std::min(off, len - k);
      std::memcpy(op + k, op + k - off, c);
      k += c;
    }
    op += len;
  }
  return op - dst;
}

void unshuffle(const uint8_t* src, uint8_t* dst, size_t size, size_t ts) {
  const size_t n = size / ts;
  for (size_t j = 0; j < ts; ++j) {
    const uint8_t* s = src + j * n;
    for (size_t i = 0; i < n; ++i) dst[i * ts + j] = s[i];
  }
  const size_t tail = n * ts;
  std::memcpy(dst + tail, src + tail, size - tail);
}

}  // namespace

extern "C" {

// Decode the blosc1 frame src (srclen bytes) into dest (destlen bytes, the
// frame's nbytes).  Returns the bytes written, or -1 for a malformed or
// truncated frame, -2 for a size that is not destlen, -3 for a flag or
// codec this decoder does not implement.
int64_t zc_blosc_decode(const uint8_t* src, size_t srclen, uint8_t* dest,
                        size_t destlen) {
  if (srclen < kHeader) return -1;
  const uint8_t flags = src[2];
  const size_t ts = src[3] ? src[3] : 1;
  const size_t nbytes = u32(src + 4), blocksize = u32(src + 8),
               cbytes = u32(src + 12);
  if (nbytes != destlen) return -2;
  if (cbytes > srclen) return -1;
  if ((flags & kBitShuffle) || (flags >> 5) != 1) {
    if (!(flags & kMemcpyed)) return -3;
  }
  if (flags & kMemcpyed) {
    if (cbytes < kHeader + nbytes) return -1;
    std::memcpy(dest, src + kHeader, nbytes);
    return int64_t(nbytes);
  }
  if (nbytes == 0) return 0;
  if (blocksize == 0) return -1;
  const size_t nblocks = (nbytes + blocksize - 1) / blocksize;
  const size_t leftover = nbytes % blocksize;
  if (kHeader + 4 * nblocks > cbytes) return -1;
  const bool shuffled = (flags & kShuffle) && ts > 1;
  std::vector<uint8_t> tmp(shuffled ? blocksize : 0);
  for (size_t b = 0; b < nblocks; ++b) {
    const bool last_short = leftover && b == nblocks - 1;
    const size_t bsize = last_short ? leftover : blocksize;
    const size_t nsplits =
        (!(flags & kNoSplit) && !last_short) ? ts : size_t(1);
    if (bsize % nsplits) return -1;
    const size_t neblock = bsize / nsplits;
    uint8_t* out = shuffled ? tmp.data() : dest + b * blocksize;
    size_t pos = u32(src + kHeader + 4 * b);
    for (size_t s = 0; s < nsplits; ++s) {
      if (pos + 4 > cbytes) return -1;
      const size_t cs = u32(src + pos);
      pos += 4;
      if (pos + cs > cbytes) return -1;
      if (cs == neblock) {
        std::memcpy(out + s * neblock, src + pos, neblock);
      } else if (lz4_block(src + pos, cs, out + s * neblock, neblock) !=
                 int64_t(neblock)) {
        return -1;
      }
      pos += cs;
    }
    if (shuffled) unshuffle(tmp.data(), dest + b * blocksize, bsize, ts);
  }
  return int64_t(nbytes);
}

}  // extern "C"

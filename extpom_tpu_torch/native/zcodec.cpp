// Codec of the blosc1 frames that Zarr v2 stores hold as chunks
// (``extpom_tpu_torch/io/zarr.py``): LZ4 blocks and byte shuffle, encoded
// and decoded.
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
// The encoder writes what c-blosc 1.x writes for cname lz4 at clevel 5
// (tensorstore's default compressor; byte shuffle for types wider than a
// byte): its block size and split rule, one greedy single-probe LZ4 match
// search per stream (LZ4's fast level), a raw stream where LZ4 does not
// shrink it, and the memcpyed frame where the frame would exceed nbytes +
// 16.  Blocks are encoded on several threads.
//
// Build: g++ -O3 -std=c++17 -fPIC -pthread -shared zcodec.cpp -o libzcodec.so

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>
#include <system_error>
#include <thread>
#include <vector>

namespace {

constexpr size_t kHeader = 16;
constexpr uint8_t kShuffle = 0x01, kMemcpyed = 0x02, kBitShuffle = 0x04,
                  kNoSplit = 0x10, kLZ4 = 1 << 5;
constexpr uint8_t kVersion = 2, kLZ4Version = 1;

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

// One pass over the elements: each is read once and its bytes go to the ts
// streams, each written in order (TS fixed for the common widths).
template <size_t TS>
void shuffle_n(const uint8_t* src, uint8_t* dst, size_t n, size_t ts) {
  const size_t w = TS ? TS : ts;
  for (size_t i = 0; i < n; ++i, src += w)
    for (size_t j = 0; j < w; ++j) dst[j * n + i] = src[j];
}

void shuffle(const uint8_t* src, uint8_t* dst, size_t size, size_t ts) {
  const size_t n = size / ts;
  if (ts == 4) {
    shuffle_n<4>(src, dst, n, ts);
  } else if (ts == 8) {
    shuffle_n<8>(src, dst, n, ts);
  } else {
    shuffle_n<0>(src, dst, n, ts);
  }
  const size_t tail = n * ts;
  std::memcpy(dst + tail, src + tail, size - tail);
}

void put_u32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v);
  p[1] = uint8_t(v >> 8);
  p[2] = uint8_t(v >> 16);
  p[3] = uint8_t(v >> 24);
}

// -- LZ4 block encoder ------------------------------------------------------
//
// The block format's end rules, which LZ4's and c-blosc's decoders enforce:
// a match is at least 4 bytes at an offset of 1 to 65,535; no match starts
// within the last 12 bytes of the block (kMfLimit), and the last 5 bytes are
// literals (kLastLiterals); so an input under 13 bytes is all literals.

constexpr size_t kMinMatch = 4, kLastLiterals = 5, kMfLimit = 12,
                 kMaxOffset = 65535;
constexpr int kHashLog = 12;  // LZ4's default table: 4,096 positions
constexpr unsigned kSkipTrigger = 6;

uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

uint32_t hash4(uint32_t v) { return (v * 2654435761u) >> (32 - kHashLog); }

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "common() finds the first differing byte as the lowest one");

// The bytes from p and q that agree, up to p reaching `limit`.
size_t common(const uint8_t* p, const uint8_t* q, const uint8_t* limit) {
  const uint8_t* const start = p;
  while (p + 8 <= limit) {
    uint64_t a, b;
    std::memcpy(&a, p, 8);
    std::memcpy(&b, q, 8);
    if (a != b) return size_t(p - start) + (__builtin_ctzll(a ^ b) >> 3);
    p += 8;
    q += 8;
  }
  while (p < limit && *p == *q) {
    ++p;
    ++q;
  }
  return size_t(p - start);
}

// A length of 15 or more: its token nibble is 15, then 255s and the rest.
uint8_t* put_length(uint8_t* op, size_t len) {
  for (len -= 15; len >= 255; len -= 255) *op++ = 255;
  *op++ = uint8_t(len);
  return op;
}

size_t length_bytes(size_t len) { return len < 15 ? 0 : (len - 15) / 255 + 1; }

// One sequence: `nlit` literals from `lit`, then a match of `mlen` bytes at
// `off` back, or none where mlen is 0 (the last sequence).  nullptr where it
// would pass `oend`.
uint8_t* put_sequence(uint8_t* op, const uint8_t* oend, const uint8_t* lit,
                      size_t nlit, size_t off, size_t mlen) {
  const size_t need = 1 + length_bytes(nlit) + nlit +
                      (mlen ? 2 + length_bytes(mlen - kMinMatch) : 0);
  if (size_t(oend - op) < need) return nullptr;
  uint8_t* token = op++;
  *token = uint8_t(std::min<size_t>(nlit, 15) << 4);
  if (nlit >= 15) op = put_length(op, nlit);
  std::memcpy(op, lit, nlit);
  op += nlit;
  if (mlen) {
    *op++ = uint8_t(off);
    *op++ = uint8_t(off >> 8);
    const size_t ml = mlen - kMinMatch;
    *token |= uint8_t(std::min<size_t>(ml, 15));
    if (ml >= 15) op = put_length(op, ml);
  }
  return op;
}

// src[0, n) as one LZ4 block into dst: the bytes written, or 0 where they
// would exceed cap.  `table` holds 1 << kHashLog positions.
size_t lz4_compress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                    uint32_t* table) {
  uint8_t* op = dst;
  const uint8_t* const oend = dst + cap;
  size_t anchor = 0;
  if (n > kMfLimit) {
    const size_t last_start = n - kMfLimit;     // a match starts at or before
    const size_t end_limit = n - kLastLiterals;  // and ends at or before
    std::fill(table, table + (size_t(1) << kHashLog), 0u);
    size_t ip = 1;  // position 0 is the table's initial entry
    unsigned attempts = 1u << kSkipTrigger;
    while (ip <= last_start) {
      const uint32_t seq = load32(src + ip);
      const uint32_t h = hash4(seq);
      const size_t ref = table[h];  // below ip: the table holds past positions
      table[h] = uint32_t(ip);
      if (ip - ref > kMaxOffset || load32(src + ref) != seq) {
        ip += attempts++ >> kSkipTrigger;  // skip faster through misses
        continue;
      }
      size_t start = ip, from = ref;
      while (start > anchor && from > 0 && src[start - 1] == src[from - 1]) {
        --start;
        --from;
      }
      const size_t end = ip + kMinMatch +
                         common(src + ip + kMinMatch, src + ref + kMinMatch,
                                src + end_limit);
      op = put_sequence(op, oend, src + anchor, start - anchor, start - from,
                        end - start);
      if (op == nullptr) return 0;
      anchor = ip = end;
      table[hash4(load32(src + end - 2))] = uint32_t(end - 2);
      attempts = 1u << kSkipTrigger;
    }
  }
  op = put_sequence(op, oend, src + anchor, n - anchor, 0, 0);
  return op == nullptr ? 0 : size_t(op - dst);
}

// -- blosc1 frames ----------------------------------------------------------

constexpr size_t kL1 = 32 * 1024, kMaxSplits = 16, kMinBuffer = 128;

// c-blosc's rule (FORWARD_COMPAT_SPLIT, its default): a block is split into
// one stream per byte of the type when the type is at most 16 bytes and the
// block holds at least 128 elements.
bool split_block(size_t ts, size_t blocksize) {
  return ts <= kMaxSplits && blocksize / ts >= kMinBuffer;
}

// c-blosc's compute_blocksize for lz4 at clevel 5, no forced block size.
size_t blocksize_for(size_t nbytes, size_t ts) {
  if (nbytes < ts) return 1;
  size_t bs = nbytes >= 4 * kL1 ? 4 * kL1 : nbytes;
  if (split_block(ts, bs)) {
    bs = std::min(bs, size_t(1) << 18) * ts;
    bs = std::min(std::max(bs, size_t(1) << 16), size_t(1) << 20);
  }
  bs = std::min(bs, nbytes);
  if (bs > ts) bs = bs / ts * ts;
  return bs;
}

void put_header(uint8_t* dest, uint8_t flags, size_t ts, size_t nbytes,
                size_t blocksize, size_t cbytes) {
  dest[0] = kVersion;
  dest[1] = kLZ4Version;
  dest[2] = flags;
  dest[3] = uint8_t(ts);
  put_u32(dest + 4, uint32_t(nbytes));
  put_u32(dest + 8, uint32_t(blocksize));
  put_u32(dest + 12, uint32_t(cbytes));
}

// A frame's layout: its block size, blocks, the short last block's bytes
// (0 where there is none), whether full blocks are split, and the slot in
// which the encoder writes each block before it is moved into place (a
// block's streams are at most its bytes plus a u32 size per stream).
struct Layout {
  size_t blocksize = 0, nblocks = 0, leftover = 0, slot = 0;
  bool split = false;
  Layout(size_t nbytes, size_t ts) {
    if (nbytes == 0) return;
    blocksize = blocksize_for(nbytes, ts);
    nblocks = (nbytes + blocksize - 1) / blocksize;
    leftover = nbytes % blocksize;
    split = split_block(ts, blocksize);
    slot = blocksize + 4 * ts;
  }
  size_t bound(size_t nbytes) const {
    if (nbytes == 0) return kHeader;
    const size_t last = leftover ? leftover + 4 : slot;  // one stream
    return kHeader + std::max(nbytes, 4 * nblocks + (nblocks - 1) * slot + last);
  }
};

// One block of bsize bytes (shuffled into `tmp` where `shuf`) as its
// streams into `out`; the bytes written.
size_t encode_block(const uint8_t* src, size_t bsize, size_t ts, bool shuf,
                    size_t nsplits, uint8_t* tmp, uint32_t* table,
                    uint8_t* out) {
  const uint8_t* data = src;
  if (shuf) {
    shuffle(src, tmp, bsize, ts);
    data = tmp;
  }
  const size_t neblock = bsize / nsplits;
  size_t pos = 0;
  for (size_t s = 0; s < nsplits; ++s) {
    const uint8_t* stream = data + s * neblock;
    // a stream LZ4 does not shrink is stored raw, under its own size
    size_t cs = neblock > 1 ? lz4_compress(stream, neblock, out + pos + 4,
                                           neblock - 1, table)
                            : 0;
    if (cs == 0) {
      std::memcpy(out + pos + 4, stream, neblock);
      cs = neblock;
    }
    put_u32(out + pos, uint32_t(cs));
    pos += 4 + cs;
  }
  return pos;
}

}  // namespace

extern "C" {

// The bytes that zc_blosc_encode needs in dest for nbytes of elements of
// typesize bytes: the frame's slots, and at least nbytes + 16.
size_t zc_blosc_bound(size_t nbytes, size_t typesize) {
  return Layout(nbytes, typesize ? typesize : 1).bound(nbytes);
}

// Encode src (nbytes bytes of elements of `typesize` bytes) as one blosc1
// frame into dest (destcap >= zc_blosc_bound bytes), byte-shuffled where
// typesize > 1, its blocks on up to `nthreads` threads.  Each
// block is written to its slot of dest and then moved down into place, so
// no thread allocates more than its shuffle buffer and hash table.
// Returns the frame's bytes, or -1 for a size out of range, -2 for a dest
// too small, -4 where memory could not be had.
int64_t zc_blosc_encode(const uint8_t* src, size_t nbytes, size_t typesize,
                        uint8_t* dest, size_t destcap, int nthreads) {
  if (typesize < 1 || typesize > 255 || nbytes > 0x7fffffffu - kHeader)
    return -1;
  const size_t ts = typesize;
  const Layout L(nbytes, ts);
  if (destcap < L.bound(nbytes)) return -2;
  const bool shuf = ts > 1;
  const uint8_t nosplit = L.split ? 0 : kNoSplit;
  const size_t first = kHeader + 4 * L.nblocks;  // the first block's offset
  const size_t nt = std::max<size_t>(
      1, std::min<size_t>(L.nblocks, size_t(std::max(nthreads, 1))));
  const size_t table_n = size_t(1) << kHashLog;
  std::vector<size_t> sizes(L.nblocks);
  std::vector<uint8_t> tmp;
  std::vector<uint32_t> tables;
  try {
    tmp.resize(shuf ? nt * L.blocksize : 0);
    tables.resize(nt * table_n);
  } catch (const std::bad_alloc&) {
    return -4;
  }
  std::atomic<size_t> next{0};
  auto work = [&](size_t t) {
    for (size_t b; (b = next++) < L.nblocks;) {
      const bool last_short = L.leftover && b == L.nblocks - 1;
      sizes[b] = encode_block(
          src + b * L.blocksize, last_short ? L.leftover : L.blocksize, ts,
          shuf, L.split && !last_short ? ts : 1,
          shuf ? tmp.data() + t * L.blocksize : nullptr,
          tables.data() + t * table_n, dest + first + b * L.slot);
    }
  };
  std::vector<std::thread> pool;
  try {
    for (size_t t = 1; t < nt; ++t) pool.emplace_back(work, t);
  } catch (const std::system_error&) {
    // no more threads: those started, and this one, do the blocks
  }
  work(0);
  for (auto& th : pool) th.join();
  size_t cbytes = first;
  for (size_t n : sizes) cbytes += n;
  if (nbytes == 0 || cbytes > nbytes + kHeader) {
    put_header(dest, kMemcpyed | kLZ4 | nosplit, ts, nbytes, L.blocksize,
               nbytes + kHeader);
    std::memcpy(dest + kHeader, src, nbytes);
    return int64_t(nbytes + kHeader);
  }
  put_header(dest, (shuf ? kShuffle : 0) | nosplit | kLZ4, ts, nbytes,
             L.blocksize, cbytes);
  // each block moves down (its offset is at most its slot's), in order, so
  // none overwrites a block not yet moved
  size_t pos = first;
  for (size_t b = 0; b < L.nblocks; ++b) {
    put_u32(dest + kHeader + 4 * b, uint32_t(pos));
    std::memmove(dest + pos, dest + first + b * L.slot, sizes[b]);
    pos += sizes[b];
  }
  return int64_t(cbytes);
}

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

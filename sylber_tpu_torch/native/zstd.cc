// Zstandard frame decoder (C++) to RFC 8878, and the CRC-32C of OCDBT files.
//
// The port reads the JAX trainer's Orbax checkpoints without JAX, orbax,
// tensorstore or the zstandard module (io/ocdbt.py, io/orbax.py). Their
// B-tree nodes, manifests and zarr chunks are zstd frames; this file decodes
// them. It handles:
//
// - raw, RLE and compressed blocks;
// - raw, RLE, compressed and treeless literals, in 1 and 4 streams (Huffman
//   trees given directly or as FSE-compressed weights);
// - the sequences' FSE tables in predefined, RLE, compressed and repeat
//   modes, and the repeat offsets;
// - the window descriptor, the single-segment flag and the frame content
//   size (checked against what was decoded);
// - several concatenated frames, and skippable frames;
// - the optional XXH64 content checksum, which it verifies.
//
// There is no dictionary support: a frame that names a dictionary is
// refused. Any input outside that list, or malformed, fails with a message
// that says what is wrong; nothing is skipped silently.
//
// Built by g++ at first use (sylber_tpu_torch/utils/native.py) and bound
// through ctypes in sylber_tpu_torch/io/zstd.py. Held byte for byte against
// libzstd in tests/test_torch_zstd.py.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string what;
};

[[noreturn]] void fail(const char* fmt, ...) __attribute__((format(printf, 1, 2)));

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Error{buf};
}

constexpr size_t kBlockMax = 128 * 1024;

int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

uint64_t load_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// ---- bit readers ----------------------------------------------------------

// Forward reader (FSE table descriptions): bits from the low end of each byte.
struct ForwardBits {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;  // bit position

  uint32_t read(int n) {
    if (pos + n > size * 8) fail("FSE table description runs past its section");
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++pos) v |= uint32_t((data[pos >> 3] >> (pos & 7)) & 1) << i;
    return v;
  }
  size_t bytes_used() const { return (pos + 7) / 8; }
};

// Backward reader (Huffman streams, FSE-coded weights, sequences): read from
// the end of the stream towards its start, after the final byte's padding
// marker. `pos` counts the bits not yet read; reading past the start yields
// zeros and drives `pos` negative, which the callers check.
struct BackwardBits {
  const uint8_t* data;
  size_t size;
  int64_t pos;

  BackwardBits(const uint8_t* d, size_t n, const char* what) : data(d), size(n) {
    if (n == 0) fail("empty %s bitstream", what);
    const uint8_t last = d[n - 1];
    if (last == 0) fail("%s bitstream lacks its end marker", what);
    pos = int64_t(n) * 8 - (8 - highbit(last));
  }

  uint64_t bits_at(int64_t lo, int n) const {  // bits [lo, lo + n), lo >= 0, n <= 56
    if (n == 0) return 0;
    const size_t byte = size_t(lo >> 3);
    uint64_t w = 0;
    if (byte + 8 <= size) {
      memcpy(&w, data + byte, 8);  // little-endian host (x86-64, aarch64)
    } else {
      for (int i = 0; byte + i < size; ++i) w |= uint64_t(data[byte + i]) << (8 * i);
    }
    return (w >> (lo & 7)) & ((uint64_t(1) << n) - 1);
  }

  uint64_t peek(int n) const {  // the next n bits, zeros past the start
    const int64_t lo = pos - n;
    if (lo >= 0) return bits_at(lo, n);
    if (pos <= 0) return 0;
    return bits_at(0, int(pos)) << (n - pos);
  }

  uint64_t read(int n) {
    const uint64_t v = peek(n);
    pos -= n;
    return v;
  }

  uint64_t read_long(int n) {  // n up to 64 (offset codes reach 31 bits; be general)
    if (n <= 56) return read(n);
    const uint64_t hi = read(n - 32);
    return (hi << 32) | read(32);
  }
};

// ---- FSE ------------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

// RFC 8878 4.1.1: a table description -> normalized counts; returns bytes read.
size_t read_fse_counts(const uint8_t* src, size_t n, int max_log, int max_symbol,
                       std::vector<int>& norm, int& log) {
  ForwardBits br{src, n};
  log = int(br.read(4)) + 5;
  if (log > max_log) fail("FSE accuracy log %d exceeds %d", log, max_log);
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nbits = log + 1;
  norm.assign(max_symbol + 1, 0);
  int symbol = 0;
  bool prev0 = false;
  while (remaining > 1) {
    if (prev0) {
      while (true) {
        const uint32_t r = br.read(2);
        symbol += int(r);
        if (symbol > max_symbol + 1) fail("FSE zero run passes the last symbol");
        if (r != 3) break;
      }
    }
    if (symbol > max_symbol) fail("FSE table describes symbol %d > %d", symbol, max_symbol);
    const int max = (2 * threshold - 1) - remaining;
    int count;
    const uint32_t low = br.read(nbits - 1);
    if (int(low) < max) {
      count = int(low);
    } else {
      const uint32_t hi = br.read(1);
      count = int(low | (hi << (nbits - 1)));
      if (count >= threshold) count -= max;
    }
    count -= 1;  // -1: the "less than 1" probability
    remaining -= count < 0 ? -count : count;
    if (remaining < 1) fail("FSE counts exceed the table size");
    norm[symbol++] = count;
    prev0 = count == 0;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("FSE counts do not sum to the table size");
  norm.resize(symbol);
  if (br.bytes_used() > n) fail("FSE table description runs past its section");
  return br.bytes_used();
}

void build_fse(const std::vector<int>& norm, int log, FseTable& out) {
  const int size = 1 << log;
  out.log = log;
  out.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail("FSE table overfull");
      out.t[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  const int mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      out.t[pos].symbol = uint16_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("FSE counts do not spread over the table");
  for (int u = 0; u < size; ++u) {
    const uint16_t s = out.t[u].symbol;
    const uint32_t ns = next[s]++;
    const int nb = log - highbit(ns);
    out.t[u].nbits = uint8_t(nb);
    out.t[u].base = uint16_t((ns << nb) - size);
  }
}

void rle_fse(int symbol, FseTable& out) {
  out.log = 0;
  out.t.assign(1, FseEntry{uint16_t(symbol), 0, 0});
}

// ---- Huffman literals -----------------------------------------------------

struct HufEntry {
  uint8_t symbol;
  uint8_t nbits;
};

struct HufTable {
  int max_bits = 0;
  std::vector<HufEntry> t;
};

// RFC 8878 4.2.1: the tree description -> table; returns bytes read.
size_t read_huffman(const uint8_t* src, size_t n, HufTable& out) {
  if (n < 1) fail("Huffman tree description missing");
  const int header = src[0];
  std::vector<int> w;
  size_t used;
  if (header < 128) {  // FSE-compressed weights
    const size_t csize = size_t(header);
    if (csize == 0 || 1 + csize > n) fail("Huffman weights (%zu bytes) run past the literals", csize);
    std::vector<int> norm;
    int log;
    const size_t head = read_fse_counts(src + 1, csize, 6, 255, norm, log);
    FseTable table;
    build_fse(norm, log, table);
    if (head >= csize) fail("Huffman weights lack their bitstream");
    BackwardBits br(src + 1 + head, csize - head, "Huffman weights");
    uint32_t s1 = uint32_t(br.read(log)), s2 = uint32_t(br.read(log));
    while (true) {
      if (w.size() >= 255) fail("more than 255 Huffman weights");
      w.push_back(table.t[s1].symbol);
      s1 = table.t[s1].base + uint32_t(br.read(table.t[s1].nbits));
      if (br.pos < 0) {
        w.push_back(table.t[s2].symbol);
        break;
      }
      if (w.size() >= 255) fail("more than 255 Huffman weights");
      w.push_back(table.t[s2].symbol);
      s2 = table.t[s2].base + uint32_t(br.read(table.t[s2].nbits));
      if (br.pos < 0) {
        w.push_back(table.t[s1].symbol);
        break;
      }
    }
    if (w.size() > 255) fail("more than 255 Huffman weights");
    used = 1 + csize;
  } else {  // 4-bit weights
    const size_t count = size_t(header - 127);
    const size_t bytes = (count + 1) / 2;
    if (1 + bytes > n) fail("Huffman weights run past the literals");
    for (size_t i = 0; i < count; ++i) {
      const uint8_t b = src[1 + i / 2];
      w.push_back(i % 2 == 0 ? b >> 4 : b & 15);
    }
    used = 1 + bytes;
  }
  uint32_t total = 0;
  for (int x : w) {
    if (x > 11) fail("Huffman weight %d > 11", x);
    if (x) total += 1u << (x - 1);
  }
  if (total == 0) fail("Huffman weights are all zero");
  const int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail("Huffman code longer than 11 bits");
  const uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights do not complete a tree");
  w.push_back(highbit(rest) + 1);  // the last symbol's implicit weight
  if (w.size() > 256) fail("Huffman tree has more than 256 symbols");
  out.max_bits = max_bits;
  out.t.assign(size_t(1) << max_bits, HufEntry{0, 0});
  uint32_t pos = 0;
  for (int weight = 1; weight <= max_bits; ++weight) {
    for (size_t s = 0; s < w.size(); ++s) {
      if (w[s] != weight) continue;
      const uint32_t span = 1u << (weight - 1);
      for (uint32_t i = 0; i < span; ++i)
        out.t[pos + i] = HufEntry{uint8_t(s), uint8_t(max_bits + 1 - weight)};
      pos += span;
    }
  }
  if (pos != (1u << max_bits)) fail("Huffman table not filled");
  return used;
}

void decode_huffman_stream(const uint8_t* src, size_t n, const HufTable& h, uint8_t* out,
                           size_t count) {
  BackwardBits br(src, n, "Huffman literal");
  for (size_t i = 0; i < count; ++i) {
    const HufEntry e = h.t[br.peek(h.max_bits)];
    out[i] = e.symbol;
    br.pos -= e.nbits;
  }
  if (br.pos != 0) fail("Huffman literal stream not consumed exactly (%lld bits left)",
                        (long long)br.pos);
}

// ---- sequences ------------------------------------------------------------

const int kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                         2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                         1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                         1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                         1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  uint64_t window = 0;
  HufTable huf;
  bool have_huf = false;
  FseTable fse[3];  // literal lengths, offsets, match lengths
  bool have_fse[3] = {false, false, false};
  uint64_t rep[3] = {1, 4, 8};
};

const char* const kSeqNames[3] = {"literal length", "offset", "match length"};

size_t read_seq_table(int kind, int mode, const uint8_t* src, size_t n, FrameState& fs) {
  static const int max_log[3] = {9, 8, 9};
  static const int max_sym[3] = {35, 31, 52};
  FseTable& table = fs.fse[kind];
  switch (mode) {
    case 0: {  // predefined
      const int* norm = kind == 0 ? kLLNorm : kind == 1 ? kOFNorm : kMLNorm;
      const int count = kind == 0 ? 36 : kind == 1 ? 29 : 53;
      build_fse(std::vector<int>(norm, norm + count), kind == 1 ? 5 : 6, table);
      fs.have_fse[kind] = true;
      return 0;
    }
    case 1: {  // RLE
      if (n < 1) fail("%s RLE symbol missing", kSeqNames[kind]);
      if (src[0] > max_sym[kind]) fail("%s RLE symbol %d out of range", kSeqNames[kind], src[0]);
      rle_fse(src[0], table);
      fs.have_fse[kind] = true;
      return 1;
    }
    case 2: {  // FSE compressed
      std::vector<int> norm;
      int log;
      const size_t used = read_fse_counts(src, n, max_log[kind], max_sym[kind], norm, log);
      build_fse(norm, log, table);
      fs.have_fse[kind] = true;
      return used;
    }
    default:  // repeat
      if (!fs.have_fse[kind]) fail("%s table repeated with none before", kSeqNames[kind]);
      return 0;
  }
}

// ---- blocks ---------------------------------------------------------------

void decode_compressed_block(const uint8_t* src, size_t n, FrameState& fs,
                             std::vector<uint8_t>& out, size_t frame_start) {
  if (n < 1) fail("empty compressed block");
  // literals section
  const int ltype = src[0] & 3;
  const int sfmt = (src[0] >> 2) & 3;
  size_t regen, csize = 0, hsize;
  int streams = 1;
  if (ltype < 2) {
    if (sfmt == 0 || sfmt == 2) {
      hsize = 1;
      regen = src[0] >> 3;
    } else if (sfmt == 1) {
      hsize = 2;
      if (n < 2) fail("literals header truncated");
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      hsize = 3;
      if (n < 3) fail("literals header truncated");
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
  } else {
    int bits;
    if (sfmt == 0) {
      hsize = 3, bits = 10, streams = 1;
    } else if (sfmt == 1) {
      hsize = 3, bits = 10, streams = 4;
    } else if (sfmt == 2) {
      hsize = 4, bits = 14, streams = 4;
    } else {
      hsize = 5, bits = 18, streams = 4;
    }
    if (n < hsize) fail("literals header truncated");
    const uint64_t h = load_le(src, int(hsize));
    regen = size_t((h >> 4) & ((1u << bits) - 1));
    csize = size_t((h >> (4 + bits)) & ((1u << bits) - 1));
  }
  if (regen > kBlockMax) fail("literals of %zu bytes exceed a block", regen);
  std::vector<uint8_t> lit(regen);
  size_t p = hsize;
  if (ltype == 0) {
    if (p + regen > n) fail("raw literals run past the block");
    if (regen) memcpy(lit.data(), src + p, regen);
    p += regen;
  } else if (ltype == 1) {
    if (p + 1 > n) fail("RLE literal byte missing");
    memset(lit.data(), src[p], regen);
    p += 1;
  } else {
    if (p + csize > n) fail("compressed literals run past the block");
    const uint8_t* c = src + p;
    size_t cn = csize;
    if (ltype == 2) {
      const size_t used = read_huffman(c, cn, fs.huf);
      fs.have_huf = true;
      c += used;
      cn -= used;
    } else if (!fs.have_huf) {
      fail("treeless literals with no Huffman tree before");
    }
    if (streams == 1) {
      decode_huffman_stream(c, cn, fs.huf, lit.data(), regen);
    } else {
      if (cn < 6) fail("4-stream literals lack their jump table");
      const size_t s1 = load_le(c, 2), s2 = load_le(c + 2, 2), s3 = load_le(c + 4, 2);
      if (6 + s1 + s2 + s3 > cn) fail("literal jump table runs past the literals");
      const size_t s4 = cn - 6 - s1 - s2 - s3;
      const size_t part = (regen + 3) / 4;
      if (3 * part > regen) fail("4-stream literals shorter than their split");
      const size_t sizes[4] = {s1, s2, s3, s4};
      const uint8_t* q = c + 6;
      for (int i = 0; i < 4; ++i) {
        const size_t count = i < 3 ? part : regen - 3 * part;
        decode_huffman_stream(q, sizes[i], fs.huf, lit.data() + i * part, count);
        q += sizes[i];
      }
    }
    p += csize;
  }
  // sequences section
  if (p >= n) fail("sequences section missing");
  size_t nseq = src[p];
  if (nseq == 0) {
    if (p + 1 != n) fail("bytes after an empty sequences section");
    out.insert(out.end(), lit.begin(), lit.end());
    return;
  }
  if (nseq < 128) {
    p += 1;
  } else if (nseq < 255) {
    if (p + 2 > n) fail("sequence count truncated");
    nseq = ((nseq - 128) << 8) + src[p + 1];
    p += 2;
  } else {
    if (p + 3 > n) fail("sequence count truncated");
    nseq = src[p + 1] + (size_t(src[p + 2]) << 8) + 0x7F00;
    p += 3;
  }
  if (p >= n) fail("symbol compression modes missing");
  const uint8_t modes = src[p++];
  if (modes & 3) fail("reserved bits set in the symbol compression modes");
  const int mode[3] = {modes >> 6, (modes >> 4) & 3, (modes >> 2) & 3};
  for (int k = 0; k < 3; ++k) p += read_seq_table(k, mode[k], src + p, n - p, fs);
  if (p > n) fail("sequence tables run past the block");
  BackwardBits br(src + p, n - p, "sequences");
  const FseTable &ll_t = fs.fse[0], &of_t = fs.fse[1], &ml_t = fs.fse[2];
  uint32_t ll_s = uint32_t(br.read(ll_t.log));
  uint32_t of_s = uint32_t(br.read(of_t.log));
  uint32_t ml_s = uint32_t(br.read(ml_t.log));
  size_t lit_pos = 0;
  const size_t block_start = out.size();
  for (size_t i = 0; i < nseq; ++i) {
    const int of_code = of_t.t[of_s].symbol;
    const int ml_code = ml_t.t[ml_s].symbol;
    const int ll_code = ll_t.t[ll_s].symbol;
    if (of_code > 31) fail("offset code %d > 31", of_code);
    const uint64_t of_value = (uint64_t(1) << of_code) + br.read_long(of_code);
    const uint64_t ml = kMLBase[ml_code] + br.read(kMLBits[ml_code]);
    const uint64_t ll = kLLBase[ll_code] + br.read(kLLBits[ll_code]);
    uint64_t offset;
    if (of_value > 3) {
      offset = of_value - 3;
      fs.rep[2] = fs.rep[1];
      fs.rep[1] = fs.rep[0];
      fs.rep[0] = offset;
    } else {
      const int idx = int(of_value) - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = fs.rep[0];
      } else {
        offset = idx == 3 ? fs.rep[0] - 1 : fs.rep[idx];
        if (offset == 0) fail("repeat offset of 0");
        if (idx != 1) fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      ll_s = ll_t.t[ll_s].base + uint32_t(br.read(ll_t.t[ll_s].nbits));
      ml_s = ml_t.t[ml_s].base + uint32_t(br.read(ml_t.t[ml_s].nbits));
      of_s = of_t.t[of_s].base + uint32_t(br.read(of_t.t[of_s].nbits));
    }
    if (br.pos < 0) fail("sequences bitstream overrun");
    if (ll > regen - lit_pos) fail("sequence takes more literals than the block holds");
    out.insert(out.end(), lit.begin() + lit_pos, lit.begin() + lit_pos + ll);
    lit_pos += ll;
    const size_t have = out.size() - frame_start;
    if (offset > have) fail("match offset %llu reaches before the frame's start",
                            (unsigned long long)offset);
    if (offset > fs.window) fail("match offset %llu exceeds the window of %llu",
                                 (unsigned long long)offset, (unsigned long long)fs.window);
    if (out.size() - block_start + ml > kBlockMax) fail("block decodes past 128 KiB");
    const size_t at = out.size();
    out.resize(at + ml);  // grows geometrically
    uint8_t* d = out.data();
    for (uint64_t j = 0; j < ml; ++j) d[at + j] = d[at - offset + j];  // may overlap
  }
  if (br.pos != 0) fail("sequences bitstream not consumed exactly (%lld bits left)",
                        (long long)br.pos);
  out.insert(out.end(), lit.begin() + lit_pos, lit.end());
  if (out.size() - block_start > kBlockMax) fail("block decodes past 128 KiB");
}

// ---- XXH64 ----------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, load_le(p, 8));
      v2 = xround(v2, load_le(p + 8, 8));
      v3 = xround(v3, load_le(p + 16, 8));
      v4 = xround(v4, load_le(p + 24, 8));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, load_le(p, 8)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (load_le(p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- frames ---------------------------------------------------------------

size_t decode_frame(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  // src points just past the magic number
  if (n < 1) fail("frame header truncated");
  const uint8_t fhd = src[0];
  const int fcs_flag = fhd >> 6;
  const bool single = (fhd >> 5) & 1;
  if (fhd & 8) fail("reserved bit set in the frame header");
  const bool checksum = (fhd >> 2) & 1;
  const int did_flag = fhd & 3;
  const int did_size = did_flag == 0 ? 0 : did_flag == 1 ? 1 : did_flag == 2 ? 2 : 4;
  const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  const size_t hsize = 1 + (single ? 0 : 1) + did_size + fcs_size;
  if (n < hsize) fail("frame header truncated");
  size_t p = 1;
  FrameState fs;
  if (!single) {
    const uint8_t wd = src[p++];
    const int log = 10 + (wd >> 3);
    if (log > 41) fail("window log %d out of range", log);
    const uint64_t base = uint64_t(1) << log;
    fs.window = base + (base / 8) * (wd & 7);
  }
  if (did_size) {
    const uint64_t did = load_le(src + p, did_size);
    p += did_size;
    if (did) fail("frame names dictionary %llu: dictionaries are not supported",
                  (unsigned long long)did);
  }
  bool have_fcs = fcs_size > 0;
  uint64_t fcs = 0;
  if (have_fcs) {
    fcs = load_le(src + p, fcs_size) + (fcs_size == 2 ? 256 : 0);
    p += fcs_size;
  }
  if (single) fs.window = fcs;
  const size_t frame_start = out.size();
  if (have_fcs && fcs < (uint64_t(1) << 32)) out.reserve(out.size() + size_t(fcs));
  const uint64_t block_max = fs.window < kBlockMax ? fs.window : kBlockMax;
  while (true) {
    if (p + 3 > n) fail("block header truncated");
    const uint32_t bh = uint32_t(load_le(src + p, 3));
    p += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (type == 1) {  // RLE: one byte, repeated bsize times
      if (bsize > kBlockMax) fail("RLE block of %zu bytes exceeds 128 KiB", bsize);
      if (p + 1 > n) fail("RLE block truncated");
      out.insert(out.end(), bsize, src[p]);
      p += 1;
    } else {
      if (bsize > block_max) fail("block of %zu bytes exceeds the block maximum", bsize);
      if (p + bsize > n) fail("block of %zu bytes truncated", bsize);
      if (type == 0) out.insert(out.end(), src + p, src + p + bsize);
      else decode_compressed_block(src + p, bsize, fs, out, frame_start);
      p += bsize;
    }
    if (last) break;
  }
  const size_t produced = out.size() - frame_start;
  if (have_fcs && produced != fcs)
    fail("frame declares %llu bytes but decodes to %zu", (unsigned long long)fcs, produced);
  if (checksum) {
    if (p + 4 > n) fail("content checksum truncated");
    const uint32_t want = uint32_t(load_le(src + p, 4));
    const uint32_t got = uint32_t(xxh64(out.data() + frame_start, produced));
    if (want != got) fail("content checksum mismatch (stored %08x, computed %08x)", want, got);
    p += 4;
  }
  return p;
}

void decompress(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  if (n == 0) fail("no zstd frame in an empty input");
  size_t p = 0;
  while (p < n) {
    if (n - p < 4) fail("%zu trailing bytes after the last frame", n - p);
    const uint32_t magic = uint32_t(load_le(src + p, 4));
    p += 4;
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
      if (n - p < 4) fail("skippable frame header truncated");
      const uint64_t size = load_le(src + p, 4);
      p += 4;
      if (size > n - p) fail("skippable frame truncated");
      p += size_t(size);
    } else if (magic == 0xFD2FB528u) {
      p += decode_frame(src + p, n - p, out);
    } else {
      fail("not a zstd frame (magic %08x at byte %zu)", magic, p - 4);
    }
  }
}

uint32_t crc32c_table[256];

void init_crc32c() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
    crc32c_table[i] = c;
  }
}

}  // namespace

extern "C" {

// Decode every frame of src[0:n) into a malloc'ed buffer (*out, *out_n;
// release with sylber_zstd_free). Returns 0, or -1 with a message in err.
int sylber_zstd_decompress(const uint8_t* src, size_t n, uint8_t** out, size_t* out_n,
                           char* err, size_t err_cap) {
  *out = nullptr;
  *out_n = 0;
  try {
    std::vector<uint8_t> buf;
    decompress(src, n, buf);
    uint8_t* mem = static_cast<uint8_t*>(malloc(buf.size() ? buf.size() : 1));
    if (!mem) fail("out of memory for %zu bytes", buf.size());
    if (!buf.empty()) memcpy(mem, buf.data(), buf.size());
    *out = mem;
    *out_n = buf.size();
    return 0;
  } catch (const Error& e) {
    snprintf(err, err_cap, "%s", e.what.c_str());
  } catch (const std::bad_alloc&) {
    snprintf(err, err_cap, "out of memory");
  }
  return -1;
}

void sylber_zstd_free(uint8_t* p) { free(p); }

uint32_t sylber_crc32c(const uint8_t* p, size_t n) {
  static bool ready = (init_crc32c(), true);
  (void)ready;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = crc32c_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"

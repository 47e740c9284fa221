// FLAC decoder (C++) for corpus ingestion on the host.
//
// A copy of the JAX package's native decoder, with the same C entry points.
// It decodes the same RFC 9639 subset as the port's pure-Python decoder
// (sylber_tpu_torch/utils/flac.py, whose docstring lists the supported
// profile: 8/16/24-bit PCM, <=2 channels, CONSTANT/VERBATIM/FIXED/LPC
// subframes, Rice methods 0/1, all stereo decorrelations). Both are held bit
// for bit against libFLAC-encoded files in tests/test_torch_native.py. A
// Python-loop decoder reads about 20x real time on one core, so a FLAC
// corpus would be held to that rate by its reader.
//
// Built by g++ at first use (sylber_tpu_torch/utils/native.py) and bound
// through ctypes there.

#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t nbytes;
  size_t pos = 0;  // bit position
  bool error = false;

  uint64_t read(int n) {
    if (pos + n > nbytes * 8) {
      error = true;
      return 0;
    }
    uint64_t v = 0;
    int need = n;
    while (need > 0) {
      const size_t byte_i = pos >> 3;
      const int avail = 8 - int(pos & 7);
      const int take = need < avail ? need : avail;
      const uint8_t b = data[byte_i];
      const uint8_t chunk = (b >> (avail - take)) & ((1u << take) - 1);
      v = (v << take) | chunk;
      pos += take;
      need -= take;
    }
    return v;
  }

  int64_t read_signed(int n) {
    const uint64_t v = read(n);
    if (n < 64 && (v >> (n - 1)))
      return int64_t(v) - (int64_t(1) << n);
    return int64_t(v);
  }

  int unary() {
    int count = 0;
    while (true) {
      const size_t byte_i = pos >> 3;
      if (byte_i >= nbytes) {
        error = true;
        return 0;
      }
      const uint8_t b = data[byte_i] & (0xFFu >> (pos & 7));
      if (b) {
        // position of the highest set bit (MSB-first index within byte)
        int hi = 31 - __builtin_clz(unsigned(b));  // bit index from LSB
        const size_t one_pos = (byte_i << 3) + (7 - hi);
        count += int(one_pos - pos);
        pos = one_pos + 1;
        return count;
      }
      count += 8 - int(pos & 7);
      pos = (byte_i + 1) << 3;
    }
  }

  void align() { pos = (pos + 7) & ~size_t(7); }
};

struct StreamInfo {
  int sample_rate = 0;
  int channels = 0;
  int bps = 0;
  int64_t total_samples = 0;
  size_t frame_start_bit = 0;
};

bool parse_streaminfo(const uint8_t* data, size_t n, StreamInfo* out) {
  if (n < 42 || std::memcmp(data, "fLaC", 4) != 0) return false;
  BitReader br{data, n, 32};
  bool have = false;
  while (!br.error) {
    const int last = int(br.read(1));
    const int btype = int(br.read(7));
    const size_t length = size_t(br.read(24));
    if (btype == 0) {
      if (length < 34) return false;
      BitReader sub{data, n, br.pos};
      sub.read(16);  // min blocksize
      sub.read(16);  // max blocksize
      sub.read(24);  // min framesize
      sub.read(24);  // max framesize
      out->sample_rate = int(sub.read(20));
      out->channels = int(sub.read(3)) + 1;
      out->bps = int(sub.read(5)) + 1;
      out->total_samples = int64_t(sub.read(36));
      if (sub.error) return false;
      have = true;
    }
    br.pos += 8 * length;
    if (last) break;
  }
  if (br.error || !have || br.pos > 8 * n) return false;
  out->frame_start_bit = br.pos;
  return true;
}

bool read_utf8_number(BitReader* br) {
  const int b0 = int(br->read(8));
  if (b0 < 0x80) return !br->error;
  int extra = 0;
  int mask = 0x40;
  while (b0 & mask) {
    ++extra;
    mask >>= 1;
  }
  if (extra < 1 || extra > 6) return false;
  for (int i = 0; i < extra; ++i) {
    const int c = int(br->read(8));
    if ((c & 0xC0) != 0x80) return false;
  }
  return !br->error;
}

bool decode_residual(BitReader* br, int blocksize, int order, int64_t* out) {
  const int method = int(br->read(2));
  if (method > 1) return false;
  const int plen = 4 + method;
  const uint32_t escape = (1u << plen) - 1;
  const int porder = int(br->read(4));
  const int nparts = 1 << porder;
  if ((blocksize >> porder) << porder != blocksize) return false;
  int w = 0;
  for (int part = 0; part < nparts; ++part) {
    int cnt = (blocksize >> porder) - (part == 0 ? order : 0);
    if (cnt < 0) return false;
    const uint32_t k = uint32_t(br->read(plen));
    if (k == escape) {
      const int raw = int(br->read(5));
      if (raw == 0) {
        for (int i = 0; i < cnt; ++i) out[w + i] = 0;
      } else {
        for (int i = 0; i < cnt; ++i) out[w + i] = br->read_signed(raw);
      }
    } else {
      for (int i = 0; i < cnt; ++i) {
        const uint64_t q = uint64_t(br->unary());
        const uint64_t v = (q << k) | br->read(int(k));
        out[w + i] = int64_t(v >> 1) ^ -int64_t(v & 1);
      }
    }
    w += cnt;
    if (br->error) return false;
  }
  return true;
}

const int kFixedCoefs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool decode_subframe(BitReader* br, int blocksize, int bps,
                     std::vector<int64_t>* out) {
  out->resize(blocksize);
  if (br->read(1)) return false;  // padding bit
  const int stype = int(br->read(6));
  int wasted = 0;
  if (br->read(1)) {
    wasted = 1 + br->unary();
    bps -= wasted;
    if (bps <= 0) return false;
  }
  int64_t* o = out->data();

  if (stype == 0) {  // CONSTANT
    const int64_t v = br->read_signed(bps);
    for (int i = 0; i < blocksize; ++i) o[i] = v;
  } else if (stype == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i) o[i] = br->read_signed(bps);
  } else if (stype >= 8 && stype <= 12) {  // FIXED
    const int order = stype - 8;
    for (int i = 0; i < order; ++i) o[i] = br->read_signed(bps);
    std::vector<int64_t> res(blocksize - order);
    if (!decode_residual(br, blocksize, order, res.data())) return false;
    const int* c = kFixedCoefs[order];
    for (int i = order; i < blocksize; ++i) {
      int64_t p = 0;
      for (int j = 0; j < order; ++j) p += c[j] * o[i - 1 - j];
      o[i] = res[i - order] + p;
    }
  } else if (stype >= 32) {  // LPC
    const int order = (stype & 31) + 1;
    for (int i = 0; i < order; ++i) o[i] = br->read_signed(bps);
    const int prec = int(br->read(4)) + 1;
    if (prec == 16) return false;
    const int shift = int(br->read_signed(5));
    if (shift < 0) return false;
    int64_t coefs[32];
    for (int j = 0; j < order; ++j) coefs[j] = br->read_signed(prec);
    std::vector<int64_t> res(blocksize - order);
    if (!decode_residual(br, blocksize, order, res.data())) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coefs[j] * o[i - 1 - j];
      o[i] = res[i - order] + (acc >> shift);
    }
  } else {
    return false;  // reserved
  }
  if (wasted)
    for (int i = 0; i < blocksize; ++i) o[i] <<= wasted;
  return !br->error;
}

const int kBlocksizeCode[16] = {-1,  192,  576,  1152, 2304, 4608, -8, -16,
                                256, 512,  1024, 2048, 4096, 8192, 16384,
                                32768};

struct Decoded {
  StreamInfo info;
  std::vector<int32_t> pcm;  // interleaved (frame-major: L samples x C)
  int64_t frames = 0;        // samples per channel
};

Decoded* decode_stream(const uint8_t* data, size_t n) {
  auto d = std::make_unique<Decoded>();
  if (!parse_streaminfo(data, n, &d->info)) return nullptr;
  const int channels = d->info.channels;
  if (channels < 1 || channels > 2 || d->info.bps > 26) return nullptr;
  BitReader br{data, n, d->info.frame_start_bit};
  const int64_t total = d->info.total_samples;
  if (total > 0) d->pcm.reserve(size_t(total) * channels);

  std::vector<int64_t> ch0, ch1;
  while (br.pos + 32 <= 8 * n && (total == 0 || d->frames < total)) {
    if (br.read(14) != 0x3FFE) return nullptr;
    if (br.read(1)) return nullptr;
    br.read(1);  // blocking strategy
    const int bs_code = int(br.read(4));
    const int sr_code = int(br.read(4));
    const int ch_code = int(br.read(4));
    const int ss_code = int(br.read(3));
    if (br.read(1)) return nullptr;
    if (!read_utf8_number(&br)) return nullptr;
    int blocksize;
    if (bs_code == 0) return nullptr;
    else if (bs_code == 6) blocksize = int(br.read(8)) + 1;
    else if (bs_code == 7) blocksize = int(br.read(16)) + 1;
    else blocksize = kBlocksizeCode[bs_code];
    if (sr_code == 12) br.read(8);
    else if (sr_code == 13 || sr_code == 14) br.read(16);
    else if (sr_code == 15) return nullptr;
    br.read(8);  // header CRC-8

    static const int kBps[8] = {0, 8, 12, -1, 16, 20, 24, 32};
    int bps = ss_code == 0 ? d->info.bps : kBps[ss_code];
    if (bps <= 0) return nullptr;

    if (ch_code < 8) {
      if (ch_code + 1 != channels) return nullptr;
      if (!decode_subframe(&br, blocksize, bps, &ch0)) return nullptr;
      if (channels == 2 && !decode_subframe(&br, blocksize, bps, &ch1))
        return nullptr;
    } else if (ch_code <= 10) {
      if (channels != 2) return nullptr;
      const int e0 = ch_code == 9 ? 1 : 0;
      const int e1 = (ch_code == 8 || ch_code == 10) ? 1 : 0;
      if (!decode_subframe(&br, blocksize, bps + e0, &ch0)) return nullptr;
      if (!decode_subframe(&br, blocksize, bps + e1, &ch1)) return nullptr;
      if (ch_code == 8) {  // left/side
        for (int i = 0; i < blocksize; ++i) ch1[i] = ch0[i] - ch1[i];
      } else if (ch_code == 9) {  // side, right
        for (int i = 0; i < blocksize; ++i) ch0[i] = ch0[i] + ch1[i];
      } else {  // mid/side
        for (int i = 0; i < blocksize; ++i) {
          const int64_t side = ch1[i];
          const int64_t mid = (ch0[i] << 1) | (side & 1);
          ch0[i] = (mid + side) >> 1;
          ch1[i] = (mid - side) >> 1;
        }
      }
    } else {
      return nullptr;
    }

    br.align();
    br.read(16);  // frame CRC-16
    if (br.error) return nullptr;

    int64_t take = blocksize;
    if (total > 0 && d->frames + take > total) take = total - d->frames;
    const size_t base = d->pcm.size();
    d->pcm.resize(base + size_t(take) * channels);
    int32_t* w = d->pcm.data() + base;
    if (channels == 1) {
      for (int64_t i = 0; i < take; ++i) w[i] = int32_t(ch0[i]);
    } else {
      for (int64_t i = 0; i < take; ++i) {
        w[2 * i] = int32_t(ch0[i]);
        w[2 * i + 1] = int32_t(ch1[i]);
      }
    }
    d->frames += take;
  }
  if (d->frames == 0) return nullptr;
  return d.release();
}

}  // namespace

extern "C" {

// Decode a complete in-memory FLAC stream. Returns an opaque handle
// (nullptr on unsupported/corrupt input).
void* sylber_flac_open(const uint8_t* data, int64_t n) {
  if (n <= 0) return nullptr;
  return decode_stream(data, size_t(n));
}

void sylber_flac_info(void* handle, int32_t* sample_rate, int32_t* channels,
                      int32_t* bps, int64_t* frames) {
  auto* d = static_cast<Decoded*>(handle);
  *sample_rate = d->info.sample_rate;
  *channels = d->info.channels;
  *bps = d->info.bps;
  *frames = d->frames;
}

// Copies frame-major interleaved int32 PCM; out must hold frames*channels.
void sylber_flac_read(void* handle, int32_t* out) {
  auto* d = static_cast<Decoded*>(handle);
  std::memcpy(out, d->pcm.data(), d->pcm.size() * sizeof(int32_t));
}

void sylber_flac_free(void* handle) {
  delete static_cast<Decoded*>(handle);
}

}  // extern "C"

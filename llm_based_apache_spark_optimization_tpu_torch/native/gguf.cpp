// GGUF model-file reader + dequantizer, bound with ctypes by native/__init__.py.
//
// A copy of the JAX package's native GGUF reader. GGUF is the weight format
// of the reference's model zoo: Ollama stores duckdb-nsql / llama3.2 /
// mistral as GGUF blobs executed by llama.cpp. This reader parses the v2/v3
// header + metadata KVs + tensor directory and dequantizes F32/F16/Q8_0/Q4_0
// and the K-quants Q4_K/Q5_K/Q6_K into float32 buffers that Python wraps as
// numpy arrays (checkpoint/gguf.py maps llama.cpp tensor names onto the
// param tree and un-permutes Q/K).
//
// Layout (little-endian): magic "GGUF", u32 version, u64 n_tensors, u64 n_kv,
// then KVs (string key, u32 type, value), then tensor infos (string name,
// u32 ndim, u64 dims[ndim] innermost-first, u32 dtype, u64 offset relative to
// the aligned data section), then padding to `general.alignment` (default
// 32), then tensor data.
//
// K-quants (Q4_K/Q5_K/Q6_K) use 256-element super-blocks with 6-bit (Q4_K/
// Q5_K) or 8-bit (Q6_K) sub-block scales. Layouts follow the public
// ggml/GGUF quantization spec.

#include "gguf.h"

#include <cstdio>
#include <cstring>
#include <exception>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

thread_local std::string g_err;

// 64-bit-clean seek/tell: plain fseek takes a long, which truncates offsets
// past 2 GiB on LLP64 platforms — real 7B GGUF blobs are larger than that.
bool seek_abs(FILE *f, uint64_t off) {
#if defined(_WIN32)
  return _fseeki64(f, static_cast<long long>(off), SEEK_SET) == 0;
#else
  return fseeko(f, static_cast<off_t>(off), SEEK_SET) == 0;
#endif
}

bool seek_rel(FILE *f, uint64_t delta) {
#if defined(_WIN32)
  return _fseeki64(f, static_cast<long long>(delta), SEEK_CUR) == 0;
#else
  return fseeko(f, static_cast<off_t>(delta), SEEK_CUR) == 0;
#endif
}

int64_t tell64(FILE *f) {
#if defined(_WIN32)
  return _ftelli64(f);
#else
  return static_cast<int64_t>(ftello(f));
#endif
}

bool seek_end(FILE *f) {
#if defined(_WIN32)
  return _fseeki64(f, 0, SEEK_END) == 0;
#else
  return fseeko(f, 0, SEEK_END) == 0;
#endif
}

// GGUF metadata value type ids.
enum : uint32_t {
  KV_U8 = 0, KV_I8 = 1, KV_U16 = 2, KV_I16 = 3, KV_U32 = 4, KV_I32 = 5,
  KV_F32 = 6, KV_BOOL = 7, KV_STRING = 8, KV_ARRAY = 9, KV_U64 = 10,
  KV_I64 = 11, KV_F64 = 12,
};

struct TensorInfo {
  std::string name;
  uint32_t ndim = 0;
  uint64_t dims[4] = {1, 1, 1, 1};
  uint32_t dtype = 0;
  uint64_t offset = 0; // relative to data section start
};

struct Gguf {
  FILE *f = nullptr;
  std::vector<TensorInfo> tensors;
  std::unordered_map<std::string, std::string> str_kv;
  std::unordered_map<std::string, double> num_kv;
  uint64_t data_start = 0;
  ~Gguf() {
    if (f) fclose(f);
  }
};

bool read_exact(FILE *f, void *dst, size_t n) {
  return fread(dst, 1, n, f) == n;
}

template <typename T> bool read_pod(FILE *f, T *v) {
  return read_exact(f, v, sizeof(T));
}

bool read_str(FILE *f, std::string *s) {
  uint64_t len;
  if (!read_pod(f, &len)) return false;
  // Keys/names/values in real models are tens of bytes; 1 MiB is a generous
  // sanity cap that keeps a corrupt length from driving a multi-GiB resize
  // (whose bad_alloc would otherwise unwind into the ctypes boundary).
  if (len > (1ull << 20)) return false; // corrupt
  s->resize(len);
  return len == 0 || read_exact(f, &(*s)[0], len);
}

size_t kv_scalar_size(uint32_t type) {
  switch (type) {
  case KV_U8: case KV_I8: case KV_BOOL: return 1;
  case KV_U16: case KV_I16: return 2;
  case KV_U32: case KV_I32: case KV_F32: return 4;
  case KV_U64: case KV_I64: case KV_F64: return 8;
  default: return 0;
  }
}

bool read_num(FILE *f, uint32_t type, double *out) {
  unsigned char buf[8];
  size_t sz = kv_scalar_size(type);
  if (!sz || !read_exact(f, buf, sz)) return false;
  switch (type) {
  case KV_U8: *out = *reinterpret_cast<uint8_t *>(buf); break;
  case KV_I8: *out = *reinterpret_cast<int8_t *>(buf); break;
  case KV_BOOL: *out = buf[0] != 0; break;
  case KV_U16: *out = *reinterpret_cast<uint16_t *>(buf); break;
  case KV_I16: *out = *reinterpret_cast<int16_t *>(buf); break;
  case KV_U32: *out = *reinterpret_cast<uint32_t *>(buf); break;
  case KV_I32: *out = *reinterpret_cast<int32_t *>(buf); break;
  case KV_F32: *out = *reinterpret_cast<float *>(buf); break;
  case KV_U64: *out = static_cast<double>(*reinterpret_cast<uint64_t *>(buf)); break;
  case KV_I64: *out = static_cast<double>(*reinterpret_cast<int64_t *>(buf)); break;
  case KV_F64: *out = *reinterpret_cast<double *>(buf); break;
  default: return false;
  }
  return true;
}

// Skip a value of the given type (used for arrays, which we index past but
// do not surface through the C API).
bool skip_value(FILE *f, uint32_t type) {
  if (type == KV_STRING) {
    std::string s;
    return read_str(f, &s);
  }
  if (type == KV_ARRAY) {
    uint32_t elem_type;
    uint64_t count;
    if (!read_pod(f, &elem_type) || !read_pod(f, &count)) return false;
    for (uint64_t i = 0; i < count; ++i)
      if (!skip_value(f, elem_type)) return false;
    return true;
  }
  size_t sz = kv_scalar_size(type);
  return sz && seek_rel(f, sz);
}

inline float f16_to_f32(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else { // subnormal: normalize
      exp = 127 - 15 + 1;
      while (!(mant & 0x400)) {
        mant <<= 1;
        --exp;
      }
      mant &= 0x3ff;
      bits = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

// 0 on overflow — a corrupt dims product must not wrap to a small "valid"
// element count (the bypass would defeat the file-extent validation below).
uint64_t tensor_nelems(const TensorInfo &t) {
  uint64_t n = 1;
  for (uint32_t d = 0; d < t.ndim; ++d) {
    if (t.dims[d] != 0 && n > UINT64_MAX / t.dims[d]) return 0;
    n *= t.dims[d];
  }
  return n;
}

// Byte size of a tensor's data on disk.
bool tensor_nbytes(const TensorInfo &t, uint64_t *out) {
  uint64_t n = tensor_nelems(t);
  if (n == 0 && t.ndim > 0) {
    bool any_zero = false;
    for (uint32_t d = 0; d < t.ndim; ++d) any_zero |= t.dims[d] == 0;
    if (!any_zero) return false; // nelems overflowed
  }
  if (n > UINT64_MAX / 4) return false; // n*4 below must not wrap
  switch (t.dtype) {
  case LSOT_GGUF_F32: *out = n * 4; return true;
  case LSOT_GGUF_F16: *out = n * 2; return true;
  case LSOT_GGUF_Q8_0: // blocks of 32: fp16 scale + 32 * i8
    if (n % 32) return false;
    *out = (n / 32) * 34;
    return true;
  case LSOT_GGUF_Q4_0: // blocks of 32: fp16 scale + 16 packed bytes
    if (n % 32) return false;
    *out = (n / 32) * 18;
    return true;
  case LSOT_GGUF_Q4_K: // 256-elem super-block: d + dmin + 12B scales + 128B qs
    if (n % 256) return false;
    *out = (n / 256) * 144;
    return true;
  case LSOT_GGUF_Q5_K: // Q4_K + 32B of fifth bits
    if (n % 256) return false;
    *out = (n / 256) * 176;
    return true;
  case LSOT_GGUF_Q6_K: // 128B ql + 64B qh + 16 i8 scales + d
    if (n % 256) return false;
    *out = (n / 256) * 210;
    return true;
  default: return false;
  }
}

// Unpack the j-th 6-bit (scale, min) pair from Q4_K/Q5_K's 12-byte scales
// field: pairs 0-3 live in the low 6 bits of bytes j / j+4; pairs 4-7 pack
// their low nibbles in bytes j+4 and their high 2 bits in the top bits of
// bytes j-4 / j.
inline void k_scale_min(int j, const unsigned char *s, float *sc, float *mn) {
  if (j < 4) {
    *sc = static_cast<float>(s[j] & 63);
    *mn = static_cast<float>(s[j + 4] & 63);
  } else {
    *sc = static_cast<float>((s[j + 4] & 0x0f) | ((s[j - 4] >> 6) << 4));
    *mn = static_cast<float>((s[j + 4] >> 4) | ((s[j] >> 6) << 4));
  }
}

} // namespace

extern "C" {

const char *lsot_gguf_last_error(void) { return g_err.c_str(); }

// Parse body; may throw std::bad_alloc on corrupt sizes — the extern "C"
// wrapper below converts that to the error-code path (an exception must
// never unwind across the ctypes boundary: that is UB/process abort).
static void *gguf_open_impl(const char *path) {
  // unique_ptr: the ~14 error returns and any bad_alloc thrown mid-parse
  // must all close the FILE* and free the struct (the extern "C" wrapper
  // catches the exception but could not reach a raw `g`).
  auto owned = std::make_unique<Gguf>();
  Gguf *g = owned.get();
  g->f = fopen(path, "rb");
  if (!g->f) {
    g_err = std::string("cannot open ") + path;
    return nullptr;
  }
  char magic[4];
  uint32_t version;
  uint64_t n_tensors, n_kv;
  if (!read_exact(g->f, magic, 4) || std::memcmp(magic, "GGUF", 4) != 0) {
    g_err = "bad magic (not a GGUF file)";
    return nullptr;
  }
  if (!read_pod(g->f, &version) || (version != 2 && version != 3)) {
    g_err = "unsupported GGUF version";
    return nullptr;
  }
  if (!read_pod(g->f, &n_tensors) || !read_pod(g->f, &n_kv) ||
      n_tensors > (1u << 20) || n_kv > (1u << 20)) {
    g_err = "corrupt header";
    return nullptr;
  }

  for (uint64_t i = 0; i < n_kv; ++i) {
    std::string key;
    uint32_t type;
    if (!read_str(g->f, &key) || !read_pod(g->f, &type)) {
      g_err = "truncated metadata";
      return nullptr;
    }
    if (type == KV_STRING) {
      std::string val;
      if (!read_str(g->f, &val)) {
        g_err = "truncated string value";
        return nullptr;
      }
      g->str_kv[key] = std::move(val);
    } else if (type == KV_ARRAY) {
      if (!skip_value(g->f, type)) {
        g_err = "truncated array value";
        return nullptr;
      }
    } else {
      double v;
      if (!read_num(g->f, type, &v)) {
        g_err = "bad scalar value for key " + key;
        return nullptr;
      }
      g->num_kv[key] = v;
    }
  }

  g->tensors.reserve(n_tensors);
  for (uint64_t i = 0; i < n_tensors; ++i) {
    TensorInfo t;
    if (!read_str(g->f, &t.name) || !read_pod(g->f, &t.ndim) || t.ndim > 4) {
      g_err = "truncated tensor info";
      return nullptr;
    }
    for (uint32_t d = 0; d < t.ndim; ++d)
      if (!read_pod(g->f, &t.dims[d])) {
        g_err = "truncated tensor dims";
        return nullptr;
      }
    if (!read_pod(g->f, &t.dtype) || !read_pod(g->f, &t.offset)) {
      g_err = "truncated tensor dtype/offset";
      return nullptr;
    }
    g->tensors.push_back(std::move(t));
  }

  uint64_t align = 32;
  auto it = g->num_kv.find("general.alignment");
  if (it != g->num_kv.end() && it->second >= 1) {
    align = static_cast<uint64_t>(it->second);
  }
  int64_t pos = tell64(g->f);
  if (pos < 0) {
    g_err = "ftell failed";
    return nullptr;
  }
  g->data_start = (static_cast<uint64_t>(pos) + align - 1) / align * align;

  // Validate every tensor's extent against the real file size now, so a
  // corrupt dims/offset can never drive a huge allocation or short read in
  // the data path.
  if (!seek_end(g->f)) {
    g_err = "seek-to-end failed";
    return nullptr;
  }
  int64_t fsize_s = tell64(g->f);
  if (fsize_s < 0) {
    g_err = "ftell-at-end failed"; // unchecked, UINT64_MAX would vacuously
    return nullptr;                // pass every extent check below
  }
  uint64_t fsize = static_cast<uint64_t>(fsize_s);
  for (const TensorInfo &t : g->tensors) {
    uint64_t nbytes;
    if (!tensor_nbytes(t, &nbytes)) {
      g_err = "unsupported dtype or overflowing dims for tensor " + t.name +
              " (dtype " + std::to_string(t.dtype) + ")";
      return nullptr;
    }
    // Term-by-term comparisons: a summed bound could wrap uint64 and pass.
    if (g->data_start > fsize || t.offset > fsize - g->data_start ||
        nbytes > fsize - g->data_start - t.offset) {
      g_err = "tensor " + t.name + " extends past end of file (corrupt dims "
              "or offset)";
      return nullptr;
    }
  }
  return owned.release();
}

void *lsot_gguf_open(const char *path) {
  try {
    return gguf_open_impl(path);
  } catch (const std::exception &e) {
    g_err = std::string("gguf open failed: ") + e.what();
    return nullptr;
  }
}

void lsot_gguf_close(void *h) { delete static_cast<Gguf *>(h); }

int32_t lsot_gguf_n_tensors(void *h) {
  return static_cast<int32_t>(static_cast<Gguf *>(h)->tensors.size());
}

const char *lsot_gguf_tensor_name(void *h, int32_t i) {
  auto *g = static_cast<Gguf *>(h);
  if (i < 0 || i >= static_cast<int32_t>(g->tensors.size())) return nullptr;
  return g->tensors[i].name.c_str();
}

int32_t lsot_gguf_tensor_ndim(void *h, int32_t i) {
  auto *g = static_cast<Gguf *>(h);
  if (i < 0 || i >= static_cast<int32_t>(g->tensors.size())) return -1;
  return static_cast<int32_t>(g->tensors[i].ndim);
}

uint64_t lsot_gguf_tensor_dim(void *h, int32_t i, int32_t d) {
  auto *g = static_cast<Gguf *>(h);
  if (i < 0 || i >= static_cast<int32_t>(g->tensors.size()) || d < 0 || d > 3)
    return 0;
  return g->tensors[i].dims[d];
}

int32_t lsot_gguf_tensor_dtype(void *h, int32_t i) {
  auto *g = static_cast<Gguf *>(h);
  if (i < 0 || i >= static_cast<int32_t>(g->tensors.size())) return -1;
  return static_cast<int32_t>(g->tensors[i].dtype);
}

uint64_t lsot_gguf_tensor_nelems(void *h, int32_t i) {
  auto *g = static_cast<Gguf *>(h);
  if (i < 0 || i >= static_cast<int32_t>(g->tensors.size())) return 0;
  return tensor_nelems(g->tensors[i]);
}

static int32_t gguf_read_f32_impl(void *h, int32_t i, float *out, uint64_t cap) {
  auto *g = static_cast<Gguf *>(h);
  if (i < 0 || i >= static_cast<int32_t>(g->tensors.size())) {
    g_err = "tensor index out of range";
    return 1;
  }
  const TensorInfo &t = g->tensors[i];
  uint64_t n = tensor_nelems(t);
  if (cap < n) {
    g_err = "output buffer too small";
    return 2;
  }
  uint64_t nbytes;
  if (!tensor_nbytes(t, &nbytes)) {
    g_err = "unsupported tensor dtype " + std::to_string(t.dtype) +
            " for tensor " + t.name;
    return 3;
  }
  if (!seek_abs(g->f, g->data_start + t.offset)) {
    g_err = "seek failed";
    return 4;
  }
  std::vector<unsigned char> raw(nbytes);
  if (!read_exact(g->f, raw.data(), nbytes)) {
    g_err = "truncated tensor data for " + t.name;
    return 5;
  }
  const unsigned char *p = raw.data();
  switch (t.dtype) {
  case LSOT_GGUF_F32:
    std::memcpy(out, p, n * 4);
    break;
  case LSOT_GGUF_F16:
    for (uint64_t k = 0; k < n; ++k)
      out[k] = f16_to_f32(reinterpret_cast<const uint16_t *>(p)[k]);
    break;
  case LSOT_GGUF_Q8_0:
    for (uint64_t blk = 0; blk < n / 32; ++blk) {
      const unsigned char *b = p + blk * 34;
      float scale = f16_to_f32(*reinterpret_cast<const uint16_t *>(b));
      const int8_t *q = reinterpret_cast<const int8_t *>(b + 2);
      for (int k = 0; k < 32; ++k) out[blk * 32 + k] = scale * q[k];
    }
    break;
  case LSOT_GGUF_Q4_0:
    for (uint64_t blk = 0; blk < n / 32; ++blk) {
      const unsigned char *b = p + blk * 18;
      float scale = f16_to_f32(*reinterpret_cast<const uint16_t *>(b));
      const unsigned char *q = b + 2;
      // llama.cpp layout: low nibbles are elements 0..15, high nibbles 16..31.
      for (int k = 0; k < 16; ++k) {
        out[blk * 32 + k] = scale * (static_cast<int>(q[k] & 0x0f) - 8);
        out[blk * 32 + 16 + k] = scale * (static_cast<int>(q[k] >> 4) - 8);
      }
    }
    break;
  case LSOT_GGUF_Q4_K:
    // Super-block: f16 d, f16 dmin, scales[12], qs[128]. Eight 32-element
    // sub-blocks; element = d*sc*q - dmin*mn. qs nibble order: bytes
    // [j*32, j*32+32) for 64-element pair j hold low nibbles of the first
    // 32 elements and high nibbles of the second 32.
    for (uint64_t blk = 0; blk < n / 256; ++blk) {
      const unsigned char *b = p + blk * 144;
      float d = f16_to_f32(*reinterpret_cast<const uint16_t *>(b));
      float dmin = f16_to_f32(*reinterpret_cast<const uint16_t *>(b + 2));
      const unsigned char *scales = b + 4;
      const unsigned char *q = b + 16;
      float *y = out + blk * 256;
      for (int j = 0, is = 0; j < 256; j += 64, q += 32, is += 2) {
        float sc, mn;
        k_scale_min(is + 0, scales, &sc, &mn);
        float d1 = d * sc, m1 = dmin * mn;
        k_scale_min(is + 1, scales, &sc, &mn);
        float d2 = d * sc, m2 = dmin * mn;
        for (int l = 0; l < 32; ++l)
          y[j + l] = d1 * static_cast<float>(q[l] & 0x0f) - m1;
        for (int l = 0; l < 32; ++l)
          y[j + 32 + l] = d2 * static_cast<float>(q[l] >> 4) - m2;
      }
    }
    break;
  case LSOT_GGUF_Q5_K:
    // Q4_K plus qh[32]: per 64-element pair, bits u1/u2 of qh[l] extend the
    // two nibbles of qs[l] to 5 bits (+16).
    for (uint64_t blk = 0; blk < n / 256; ++blk) {
      const unsigned char *b = p + blk * 176;
      float d = f16_to_f32(*reinterpret_cast<const uint16_t *>(b));
      float dmin = f16_to_f32(*reinterpret_cast<const uint16_t *>(b + 2));
      const unsigned char *scales = b + 4;
      const unsigned char *qh = b + 16;
      const unsigned char *q = b + 48;
      float *y = out + blk * 256;
      unsigned u1 = 1, u2 = 2;
      for (int j = 0, is = 0; j < 256; j += 64, q += 32, is += 2) {
        float sc, mn;
        k_scale_min(is + 0, scales, &sc, &mn);
        float d1 = d * sc, m1 = dmin * mn;
        k_scale_min(is + 1, scales, &sc, &mn);
        float d2 = d * sc, m2 = dmin * mn;
        for (int l = 0; l < 32; ++l)
          y[j + l] = d1 * static_cast<float>((q[l] & 0x0f) +
                                             ((qh[l] & u1) ? 16 : 0)) - m1;
        for (int l = 0; l < 32; ++l)
          y[j + 32 + l] = d2 * static_cast<float>((q[l] >> 4) +
                                                  ((qh[l] & u2) ? 16 : 0)) - m2;
        u1 <<= 2;
        u2 <<= 2;
      }
    }
    break;
  case LSOT_GGUF_Q6_K:
    // ql[128] (low 4 bits), qh[64] (high 2 bits), 16 i8 sub-block scales,
    // f16 d. Element = d * scales[sub] * (6-bit value - 32); two 128-element
    // halves each interleave four 32-element runs over ql/qh bit positions.
    for (uint64_t blk = 0; blk < n / 256; ++blk) {
      const unsigned char *b = p + blk * 210;
      const unsigned char *ql = b;
      const unsigned char *qh = b + 128;
      const signed char *sc8 = reinterpret_cast<const signed char *>(b + 192);
      float d = f16_to_f32(*reinterpret_cast<const uint16_t *>(b + 208));
      float *y = out + blk * 256;
      for (int half = 0; half < 2; ++half, y += 128, ql += 64, qh += 32,
               sc8 += 8) {
        for (int l = 0; l < 32; ++l) {
          int is = l / 16;
          int q1 = static_cast<int>((ql[l] & 0x0f) | ((qh[l] & 3) << 4)) - 32;
          int q2 = static_cast<int>((ql[l + 32] & 0x0f) |
                                    (((qh[l] >> 2) & 3) << 4)) - 32;
          int q3 = static_cast<int>((ql[l] >> 4) |
                                    (((qh[l] >> 4) & 3) << 4)) - 32;
          int q4 = static_cast<int>((ql[l + 32] >> 4) |
                                    (((qh[l] >> 6) & 3) << 4)) - 32;
          y[l + 0] = d * sc8[is + 0] * q1;
          y[l + 32] = d * sc8[is + 2] * q2;
          y[l + 64] = d * sc8[is + 4] * q3;
          y[l + 96] = d * sc8[is + 6] * q4;
        }
      }
    }
    break;
  default:
    g_err = "unsupported dtype";
    return 3;
  }
  return 0;
}

int32_t lsot_gguf_read_f32(void *h, int32_t i, float *out, uint64_t cap) {
  try {
    return gguf_read_f32_impl(h, i, out, cap);
  } catch (const std::exception &e) {
    g_err = std::string("gguf read failed: ") + e.what();
    return 6;
  }
}

const char *lsot_gguf_meta_str(void *h, const char *key) {
  auto *g = static_cast<Gguf *>(h);
  auto it = g->str_kv.find(key);
  return it == g->str_kv.end() ? nullptr : it->second.c_str();
}

int32_t lsot_gguf_meta_f64(void *h, const char *key, double *out) {
  auto *g = static_cast<Gguf *>(h);
  auto it = g->num_kv.find(key);
  if (it == g->num_kv.end()) return 0;
  *out = it->second;
  return 1;
}

} // extern "C"

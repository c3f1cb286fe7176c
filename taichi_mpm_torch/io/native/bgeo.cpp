// Native BGEO (classic Houdini geo v5) particle writer.
//
// The port's copy of taichi_mpm_tpu/io/native/bgeo.cpp (the two write
// the same bytes): a replacement for the reference's partio dependency
// (partio's io/BGEO.cpp — format studied from there; independent
// implementation). The hot path is a single
// big-endian byte-swizzled buffer write, so a 10M-particle frame dump
// does not serialize through Python.
//
// Build: g++ -O2 -shared -fPIC -o libtmtio.so bgeo.cpp
// (taichi_mpm_torch/io/bgeo.py builds it at first use into
// taichi_mpm_torch/_build/.)
// ABI (ctypes):
//   int tmt_write_bgeo(const char* path, int n,
//                      const float* pos,            // (n, 3) row-major
//                      int n_attrs,
//                      const char** names,          // extra attributes
//                      const int* counts,           // components each
//                      const int* types,            // 0 float, 1 int, 5 vector
//                      const float** data)          // (n, counts[k]) each
// Returns 0 on success, nonzero errno-style code on failure.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
inline uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }

struct Out {
  FILE* f;
  bool ok = true;
  explicit Out(FILE* f) : f(f) {}
  void bytes(const void* p, size_t nb) {
    if (ok && fwrite(p, 1, nb, f) != nb) ok = false;
  }
  void i32(int32_t v) {
    uint32_t b = bswap32((uint32_t)v);
    bytes(&b, 4);
  }
  void u16(uint16_t v) {
    uint16_t b = bswap16(v);
    bytes(&b, 2);
  }
  void f32(float v) {
    uint32_t u;
    memcpy(&u, &v, 4);
    u = bswap32(u);
    bytes(&u, 4);
  }
  void ch(char c) { bytes(&c, 1); }
  void hstr(const char* s) {  // Houdini string: u16 length + bytes
    uint16_t len = (uint16_t)strlen(s);
    u16(len);
    bytes(s, len);
  }
};

}  // namespace

extern "C" int tmt_write_bgeo(const char* path, int n, const float* pos,
                              int n_attrs, const char** names,
                              const int* counts, const int* types,
                              const float** data) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  Out o(f);

  const int32_t magic = ((((('B' << 8) | 'g') << 8) | 'e') << 8) | 'o';
  o.i32(magic);
  o.ch('V');
  o.i32(5);          // version
  o.i32(n);          // nPoints
  o.i32(1);          // nPrims (one particle-system primitive)
  o.i32(0);          // nPointGroups
  o.i32(0);          // nPrimGroups
  o.i32(n_attrs);    // nPointAttrib (excluding position)
  o.i32(0);          // nVertexAttrib
  o.i32(1);          // nPrimAttrib ("generator")
  o.i32(0);          // nAttrib

  // attribute definitions (defaults all zero)
  int particle_size = 4;  // x y z w
  std::vector<int> offsets(n_attrs);
  for (int k = 0; k < n_attrs; k++) {
    o.hstr(names[k]);
    o.u16((uint16_t)counts[k]);
    o.i32(types[k]);
    for (int c = 0; c < counts[k]; c++) o.i32(0);
    offsets[k] = particle_size;
    particle_size += counts[k];
  }

  // particle records: byte-swizzle into one buffer per row
  std::vector<uint32_t> row(particle_size);
  const uint32_t one_be = [] {
    float w = 1.0f;
    uint32_t u;
    memcpy(&u, &w, 4);
    return bswap32(u);
  }();
  for (int i = 0; i < n; i++) {
    for (int c = 0; c < 3; c++) {
      uint32_t u;
      memcpy(&u, &pos[3 * i + c], 4);
      row[c] = bswap32(u);
    }
    row[3] = one_be;
    for (int k = 0; k < n_attrs; k++) {
      const float* src = data[k] + (size_t)i * counts[k];
      for (int c = 0; c < counts[k]; c++) {
        uint32_t u;
        memcpy(&u, &src[c], 4);
        row[offsets[k] + c] = bswap32(u);
      }
    }
    o.bytes(row.data(), (size_t)particle_size * 4);
  }

  // primitive attribute "generator" -> indexed string "papi"
  o.hstr("generator");
  o.u16(1);
  o.i32(4);
  o.i32(1);
  o.hstr("papi");

  // the particle-system primitive referencing all points
  o.i32(0x8000);
  o.i32(n);
  if (n > (1 << 16)) {
    for (int i = 0; i < n; i++) o.i32(i);
  } else {
    for (int i = 0; i < n; i++) o.u16((uint16_t)i);
  }
  o.i32(0);  // generator index

  // extras terminator
  o.ch((char)0x00);
  o.ch((char)0xff);

  int rc = o.ok ? 0 : 2;
  if (fclose(f) != 0) rc = rc ? rc : 3;
  return rc;
}

// Native JPEG entropy codec: baseline Huffman scan decode + encode.
//
// The port's copy of imaginary_tpu/native/entropy.cpp, built as the module
// _itpu_torch_entropy. It is the host-side hot loop of the DCT transport
// (imaginary_tpu_torch/codecs/jpeg_dct.py): the serial, un-vectorizable
// part of JPEG decode is the entropy scan, a bit-serial Huffman walk. This
// module runs the same walk as the pure-Python arm in C++ with the GIL
// released, writing dezigzagged int16 coefficients straight into the
// caller's numpy planes, and the inverse walk for the egress path
// (device-quantized coefficients -> entropy-coded scan bytes).
//
// Deliberately dependency-free (CPython C API only, no libjpeg, no numpy
// headers — arrays cross the boundary as plain buffers), so it compiles
// on any host with a C++ toolchain. Marker parsing, Huffman LUT
// construction, quant handling, and all geometry stay in Python: this
// file sees only de-zigzag, bit I/O, and run-length state.
//
// Interface (module _itpu_torch_entropy, ABI 1):
//   decode_segments(data, hdr, comp, bounds, luts, p0[, p1, p2]) -> None
//     data:   the full JPEG byte buffer (still byte-stuffed)
//     hdr:    int64[6 + 2*ncomp]: ncomp, restart, mcu_start, total_mcus,
//             mcus_x, nluts, then (rows, cols) per plane
//     comp:   int32[ncomp*4]: h, v, dc_lut_index, ac_lut_index
//     bounds: int64[nseg*2]: (lo, hi) byte ranges of the restart segments
//     luts:   int32[nluts*65536]: 16-bit-peek tables,
//             lut[peek16] = (code_length << 8) | symbol, 0 = bad prefix
//     pN:     writable int16[rows, cols, 64] coefficient planes,
//             natural (row-major) order — the _decode contract
//   encode_segments(hdr, comp, codes, p0[, p1, p2]) -> bytes
//     hdr:    int64[4 + 2*ncomp]: ncomp, restart, total_mcus, mcus_x,
//             then (rows, cols) per plane
//     comp:   int32[ncomp*4]: h, v, dc_code_table, ac_code_table
//     codes:  int32[ntab*512]: (code, bitlength) pairs per symbol
//     pN:     int16[rows, cols, 64] quantized planes, natural order
//     Returns the byte-stuffed entropy-coded scan, RSTn markers included.
//
// Segment calls are row-disjoint on the output planes: each call drops
// the GIL for its whole MCU run.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag scan position -> natural (row-major) index, JPEG Annex K
const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ---------------------------------------------------------- bit reader ------
// MSB-first reader over byte-stuffed scan data; 0xFF 0x00 collapses to a
// literal 0xFF (a bare trailing 0xFF stays literal), reads past the end
// see zeros — all exactly the Python _Bits + .replace(b"\xff\x00", ...)
// semantics, so the native and oracle decoders fail identically on
// truncated streams (an invalid LUT prefix, never an overrun).
struct BitReader {
  const uint8_t* d;
  Py_ssize_t n;
  Py_ssize_t i = 0;
  uint64_t acc = 0;
  int cnt = 0;

  BitReader(const uint8_t* data, Py_ssize_t len) : d(data), n(len) {}

  inline uint8_t next_byte() {
    if (i >= n) return 0;
    uint8_t b = d[i++];
    if (b == 0xFF && i < n && d[i] == 0x00) i++;  // stuffed literal 0xFF
    return b;
  }

  inline int peek16() {
    while (cnt < 16) {
      acc = (acc << 8) | next_byte();
      cnt += 8;
    }
    return (int)((acc >> (cnt - 16)) & 0xFFFF);
  }

  inline void drop(int k) {
    cnt -= k;
    acc &= (((uint64_t)1) << cnt) - 1;
  }

  inline int take(int k) {
    while (cnt < k) {
      acc = (acc << 8) | next_byte();
      cnt += 8;
    }
    cnt -= k;
    int v = (int)(acc >> cnt);
    acc &= (((uint64_t)1) << cnt) - 1;
    return v;
  }
};

// JPEG F.2.2.1 sign extension of a t-bit magnitude
inline int extend(int v, int t) {
  return (v < (1 << (t - 1))) ? v - (1 << t) + 1 : v;
}

struct PlaneView {
  int16_t* p;
  int64_t rows;
  int64_t cols;
};

// One restart segment's worth of MCUs. Returns nullptr on success, else a
// static error string (mapped to ValueError with the GIL re-held).
const char* decode_one_segment(const uint8_t* data, int64_t lo, int64_t hi,
                               int64_t mcu_lo, int64_t mcu_hi, int64_t mcus_x,
                               int ncomp, const int32_t* comp,
                               const int32_t* luts, int64_t nluts,
                               PlaneView* planes) {
  BitReader bits(data + lo, hi - lo);
  int pred[4] = {0, 0, 0, 0};
  for (int64_t m = mcu_lo; m < mcu_hi; m++) {
    const int64_t my = m / mcus_x;
    const int64_t mx = m % mcus_x;
    for (int ci = 0; ci < ncomp; ci++) {
      const int ch = comp[ci * 4 + 0];
      const int cv = comp[ci * 4 + 1];
      const int32_t* dc_lut = luts + (int64_t)comp[ci * 4 + 2] * 65536;
      const int32_t* ac_lut = luts + (int64_t)comp[ci * 4 + 3] * 65536;
      for (int by = 0; by < cv; by++) {
        for (int bx = 0; bx < ch; bx++) {
          const int64_t row = my * cv + by;
          const int64_t col = mx * ch + bx;
          if (row >= planes[ci].rows || col >= planes[ci].cols)
            return "block index out of plane bounds";
          int16_t* out = planes[ci].p + (row * planes[ci].cols + col) * 64;
          int32_t code = dc_lut[bits.peek16()];
          int ln = code >> 8;
          if (ln == 0) return "bad DC code";
          bits.drop(ln);
          int t = code & 0xFF;
          if (t) {
            if (t > 16) return "bad DC category";
            pred[ci] += extend(bits.take(t), t);
          }
          out[0] = (int16_t)pred[ci];
          int kk = 1;
          while (kk < 64) {
            code = ac_lut[bits.peek16()];
            ln = code >> 8;
            if (ln == 0) return "bad AC code";
            bits.drop(ln);
            const int rs = code & 0xFF;
            const int s = rs & 0x0F;
            if (s == 0) {
              if (rs != 0xF0) break;  // EOB
              kk += 16;
              continue;
            }
            kk += rs >> 4;
            if (kk > 63) return "AC run overflow";
            out[kZigzag[kk]] = (int16_t)extend(bits.take(s), s);
            kk++;
          }
        }
      }
    }
  }
  return nullptr;
}

// ---------------------------------------------------------- bit writer ------
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int cnt = 0;

  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}

  inline void put(uint32_t code, int len) {
    acc = (acc << len) | (code & ((len >= 32) ? 0xFFFFFFFFu
                                              : ((1u << len) - 1u)));
    cnt += len;
    while (cnt >= 8) {
      uint8_t b = (uint8_t)((acc >> (cnt - 8)) & 0xFF);
      out.push_back(b);
      if (b == 0xFF) out.push_back(0x00);  // byte stuffing
      cnt -= 8;
    }
    acc &= (((uint64_t)1) << cnt) - 1;
  }

  // pad the partial byte with 1-bits (F.1.2.3) and emit it
  inline void flush() {
    if (cnt > 0) {
      int pad = 8 - cnt;
      uint8_t b = (uint8_t)(((acc << pad) | ((1u << pad) - 1u)) & 0xFF);
      out.push_back(b);
      if (b == 0xFF) out.push_back(0x00);
      cnt = 0;
      acc = 0;
    }
  }
};

// magnitude category: bits needed for |v| (0 for 0)
inline int category(int v) {
  int a = v < 0 ? -v : v;
  int t = 0;
  while (a) {
    a >>= 1;
    t++;
  }
  return t;
}

const char* encode_scan(int ncomp, int64_t restart, int64_t total_mcus,
                        int64_t mcus_x, const int32_t* comp,
                        const int32_t* codes, int64_t ncodes,
                        PlaneView* planes, std::vector<uint8_t>& out) {
  BitWriter bw(out);
  int pred[4] = {0, 0, 0, 0};
  for (int64_t m = 0; m < total_mcus; m++) {
    if (restart && m && m % restart == 0) {
      bw.flush();
      out.push_back(0xFF);
      out.push_back((uint8_t)(0xD0 + ((m / restart - 1) & 7)));
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
    }
    const int64_t my = m / mcus_x;
    const int64_t mx = m % mcus_x;
    for (int ci = 0; ci < ncomp; ci++) {
      const int ch = comp[ci * 4 + 0];
      const int cv = comp[ci * 4 + 1];
      const int32_t* dc_tab = codes + (int64_t)comp[ci * 4 + 2] * 512;
      const int32_t* ac_tab = codes + (int64_t)comp[ci * 4 + 3] * 512;
      if ((comp[ci * 4 + 2] + 1) * 512 > ncodes ||
          (comp[ci * 4 + 3] + 1) * 512 > ncodes)
        return "code table index out of range";
      for (int by = 0; by < cv; by++) {
        for (int bx = 0; bx < ch; bx++) {
          const int64_t row = my * cv + by;
          const int64_t col = mx * ch + bx;
          if (row >= planes[ci].rows || col >= planes[ci].cols)
            return "block index out of plane bounds";
          const int16_t* blk =
              planes[ci].p + (row * planes[ci].cols + col) * 64;
          // DC: difference, category code, then magnitude bits
          const int dc = blk[0];
          int diff = dc - pred[ci];
          pred[ci] = dc;
          int t = category(diff);
          if (t > 11) return "DC difference out of baseline range";
          if (dc_tab[t * 2 + 1] == 0) return "missing DC code";
          bw.put((uint32_t)dc_tab[t * 2], dc_tab[t * 2 + 1]);
          if (t) bw.put((uint32_t)(diff < 0 ? diff + (1 << t) - 1 : diff), t);
          // AC: run-length in zigzag order with ZRL and EOB
          int run = 0;
          for (int kk = 1; kk < 64; kk++) {
            const int v = blk[kZigzag[kk]];
            if (v == 0) {
              run++;
              continue;
            }
            while (run > 15) {
              if (ac_tab[0xF0 * 2 + 1] == 0) return "missing ZRL code";
              bw.put((uint32_t)ac_tab[0xF0 * 2], ac_tab[0xF0 * 2 + 1]);
              run -= 16;
            }
            const int s = category(v);
            if (s > 10) return "AC coefficient out of baseline range";
            const int rs = (run << 4) | s;
            if (ac_tab[rs * 2 + 1] == 0) return "missing AC code";
            bw.put((uint32_t)ac_tab[rs * 2], ac_tab[rs * 2 + 1]);
            bw.put((uint32_t)(v < 0 ? v + (1 << s) - 1 : v), s);
            run = 0;
          }
          if (run) {
            if (ac_tab[0 * 2 + 1] == 0) return "missing EOB code";
            bw.put((uint32_t)ac_tab[0], ac_tab[1]);
          }
        }
      }
    }
  }
  bw.flush();
  return nullptr;
}

// ------------------------------------------------------------ bindings ------

bool check_div(Py_ssize_t len, Py_ssize_t unit, const char* what) {
  if (len % unit != 0) {
    PyErr_Format(PyExc_ValueError, "entropy: %s buffer not a multiple of %zd",
                 what, (Py_ssize_t)unit);
    return false;
  }
  return true;
}

PyObject* py_decode_segments(PyObject*, PyObject* args) {
  Py_buffer data, hdr, comp, bounds, luts;
  Py_buffer p0, p1, p2;
  p1.buf = nullptr;
  p2.buf = nullptr;
  p1.obj = nullptr;
  p2.obj = nullptr;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*w*|w*w*", &data, &hdr, &comp,
                        &bounds, &luts, &p0, &p1, &p2))
    return nullptr;
  struct Release {
    Py_buffer *a, *b, *c, *d, *e, *f, *g, *h;
    ~Release() {
      PyBuffer_Release(a);
      PyBuffer_Release(b);
      PyBuffer_Release(c);
      PyBuffer_Release(d);
      PyBuffer_Release(e);
      PyBuffer_Release(f);
      if (g->obj) PyBuffer_Release(g);
      if (h->obj) PyBuffer_Release(h);
    }
  } rel{&data, &hdr, &comp, &bounds, &luts, &p0, &p1, &p2};

  if (!check_div(hdr.len, 8, "hdr") || !check_div(comp.len, 4, "comp") ||
      !check_div(bounds.len, 16, "bounds") ||
      !check_div(luts.len, 65536 * 4, "luts"))
    return nullptr;
  const int64_t* H = (const int64_t*)hdr.buf;
  const Py_ssize_t nh = hdr.len / 8;
  if (nh < 6) {
    PyErr_SetString(PyExc_ValueError, "entropy: short hdr");
    return nullptr;
  }
  const int ncomp = (int)H[0];
  const int64_t restart = H[1];
  const int64_t mcu_start = H[2];
  const int64_t total_mcus = H[3];
  const int64_t mcus_x = H[4];
  const int64_t nluts = H[5];
  if (ncomp < 1 || ncomp > 3 || nh < 6 + 2 * ncomp ||
      comp.len / 4 < ncomp * 4 || mcus_x <= 0 || total_mcus <= 0 ||
      nluts * 65536 * 4 != (int64_t)luts.len) {
    PyErr_SetString(PyExc_ValueError, "entropy: bad decode header");
    return nullptr;
  }
  const int32_t* C = (const int32_t*)comp.buf;
  for (int ci = 0; ci < ncomp; ci++) {
    if (C[ci * 4 + 2] < 0 || C[ci * 4 + 2] >= nluts || C[ci * 4 + 3] < 0 ||
        C[ci * 4 + 3] >= nluts || C[ci * 4] < 1 || C[ci * 4] > 4 ||
        C[ci * 4 + 1] < 1 || C[ci * 4 + 1] > 4) {
      PyErr_SetString(PyExc_ValueError, "entropy: bad component descriptor");
      return nullptr;
    }
  }
  PlaneView planes[3];
  Py_buffer* pb[3] = {&p0, &p1, &p2};
  for (int ci = 0; ci < ncomp; ci++) {
    if (pb[ci]->buf == nullptr) {
      PyErr_SetString(PyExc_ValueError, "entropy: missing plane buffer");
      return nullptr;
    }
    planes[ci].p = (int16_t*)pb[ci]->buf;
    planes[ci].rows = H[6 + ci * 2];
    planes[ci].cols = H[7 + ci * 2];
    if (planes[ci].rows <= 0 || planes[ci].cols <= 0 ||
        planes[ci].rows * planes[ci].cols * 64 * 2 != (int64_t)pb[ci]->len) {
      PyErr_SetString(PyExc_ValueError, "entropy: plane shape mismatch");
      return nullptr;
    }
  }
  const int64_t nseg = bounds.len / 16;
  const int64_t* B = (const int64_t*)bounds.buf;
  for (int64_t s = 0; s < nseg; s++) {
    if (B[s * 2] < 0 || B[s * 2 + 1] < B[s * 2] ||
        B[s * 2 + 1] > (int64_t)data.len) {
      PyErr_SetString(PyExc_ValueError, "entropy: segment bounds out of range");
      return nullptr;
    }
  }
  const int64_t per_seg = restart > 0 ? restart : total_mcus;
  const char* err = nullptr;
  Py_BEGIN_ALLOW_THREADS;
  for (int64_t s = 0; s < nseg && !err; s++) {
    const int64_t mcu_lo = mcu_start + s * per_seg;
    int64_t mcu_hi = mcu_lo + per_seg;
    if (mcu_hi > total_mcus) mcu_hi = total_mcus;
    if (mcu_lo >= total_mcus) break;
    err = decode_one_segment((const uint8_t*)data.buf, B[s * 2], B[s * 2 + 1],
                             mcu_lo, mcu_hi, mcus_x, ncomp, C,
                             (const int32_t*)luts.buf, nluts, planes);
  }
  Py_END_ALLOW_THREADS;
  if (err) {
    PyErr_Format(PyExc_ValueError, "entropy: %s", err);
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* py_encode_segments(PyObject*, PyObject* args) {
  Py_buffer hdr, comp, codes;
  Py_buffer p0, p1, p2;
  p1.buf = nullptr;
  p2.buf = nullptr;
  p1.obj = nullptr;
  p2.obj = nullptr;
  if (!PyArg_ParseTuple(args, "y*y*y*y*|y*y*", &hdr, &comp, &codes, &p0, &p1,
                        &p2))
    return nullptr;
  struct Release {
    Py_buffer *a, *b, *c, *d, *e, *f;
    ~Release() {
      PyBuffer_Release(a);
      PyBuffer_Release(b);
      PyBuffer_Release(c);
      PyBuffer_Release(d);
      if (e->obj) PyBuffer_Release(e);
      if (f->obj) PyBuffer_Release(f);
    }
  } rel{&hdr, &comp, &codes, &p0, &p1, &p2};

  if (!check_div(hdr.len, 8, "hdr") || !check_div(comp.len, 4, "comp") ||
      !check_div(codes.len, 512 * 4, "codes"))
    return nullptr;
  const int64_t* H = (const int64_t*)hdr.buf;
  const Py_ssize_t nh = hdr.len / 8;
  if (nh < 4) {
    PyErr_SetString(PyExc_ValueError, "entropy: short hdr");
    return nullptr;
  }
  const int ncomp = (int)H[0];
  const int64_t restart = H[1];
  const int64_t total_mcus = H[2];
  const int64_t mcus_x = H[3];
  if (ncomp < 1 || ncomp > 3 || nh < 4 + 2 * ncomp ||
      comp.len / 4 < ncomp * 4 || mcus_x <= 0 || total_mcus <= 0) {
    PyErr_SetString(PyExc_ValueError, "entropy: bad encode header");
    return nullptr;
  }
  const int32_t* C = (const int32_t*)comp.buf;
  PlaneView planes[3];
  Py_buffer* pb[3] = {&p0, &p1, &p2};
  for (int ci = 0; ci < ncomp; ci++) {
    if (pb[ci]->buf == nullptr) {
      PyErr_SetString(PyExc_ValueError, "entropy: missing plane buffer");
      return nullptr;
    }
    planes[ci].p = (int16_t*)pb[ci]->buf;
    planes[ci].rows = H[4 + ci * 2];
    planes[ci].cols = H[5 + ci * 2];
    if (planes[ci].rows <= 0 || planes[ci].cols <= 0 ||
        planes[ci].rows * planes[ci].cols * 64 * 2 != (int64_t)pb[ci]->len) {
      PyErr_SetString(PyExc_ValueError, "entropy: plane shape mismatch");
      return nullptr;
    }
  }
  std::vector<uint8_t> out;
  out.reserve((size_t)(total_mcus * 24 + 64));
  const char* err = nullptr;
  Py_BEGIN_ALLOW_THREADS;
  err = encode_scan(ncomp, restart, total_mcus, mcus_x, C,
                    (const int32_t*)codes.buf, (int64_t)(codes.len / 4),
                    planes, out);
  Py_END_ALLOW_THREADS;
  if (err) {
    PyErr_Format(PyExc_ValueError, "entropy: %s", err);
    return nullptr;
  }
  return PyBytes_FromStringAndSize((const char*)out.data(),
                                   (Py_ssize_t)out.size());
}

PyMethodDef methods[] = {
    {"decode_segments", py_decode_segments, METH_VARARGS,
     "decode_segments(data, hdr, comp, bounds, luts, p0[, p1, p2]): Huffman-"
     "decode restart segments into int16 coefficient planes (GIL released)"},
    {"encode_segments", py_encode_segments, METH_VARARGS,
     "encode_segments(hdr, comp, codes, p0[, p1, p2]) -> bytes: entropy-"
     "code quantized planes into a byte-stuffed scan (GIL released)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_itpu_torch_entropy",
    "baseline JPEG entropy scan decode/encode (dependency-free)", -1,
    methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__itpu_torch_entropy(void) {
  PyObject* m = PyModule_Create(&moduledef);
  if (m) PyModule_AddIntConstant(m, "ABI", 1);
  return m;
}

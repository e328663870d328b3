// Native host codec layer of the PyTorch/CUDA port: JPEG decode/encode,
// EXIF orientation and the packed-YUV420 transport entry points.
//
// The port's own copy of imaginary_tpu/native/codecs.cpp, trimmed to JPEG
// (the only format the /resize and /crop slice serves); the other formats,
// the palette quantizer and the host resampler wait for later slices.
// Built directly on the CPython C API; all codec work runs with the GIL
// RELEASED, so server threads decode/encode on real cores concurrently.
//
// Interface (module _itpu_torch_codecs):
//   decode(bytes, fmt: str[, scale_denom]) -> (pixels: bytes, h, w, c, orientation, has_alpha)
//   encode(buffer, h, w, c, fmt: str, quality, progressive) -> bytes
//   probe(bytes, fmt: str)   -> (w, h, c, has_alpha, orientation, subsampling)
//   decode_yuv420(bytes, scale_denom, hb, wb) -> (packed, h, w, orientation)
//   encode_yuv420(y, u, v, h, w, quality, progressive) -> bytes
//   arena_stats() -> {reuses, misses, evictions, bytes, cap_bytes}
//   set_arena_cap(mb)        per-thread scratch budget, 0 = unlimited
// The Python shim (codecs/native_backend.py) wraps pixels in numpy arrays.
//
// The YUV420 entry points are the wire format of the device transport
// path: JPEG is natively YCbCr 4:2:0, so the decoder hands back raw
// subsampled planes (skipping libjpeg's chroma upsampling and color
// conversion) packed into one (hb + hb/2, wb) buffer — Y on top, U | V side
// by side below — and the encoder consumes raw planes the same way. Half
// the bytes of RGB in both directions across the host<->device link, and
// less host CPU per request (the color math runs on the card).
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <string>
#include <vector>

#include <jpeglib.h>

namespace {

// ------------------------------------------------ codec scratch arena -------
//
// The reference's codec arena (imaginary_tpu/native/codecs.cpp), kept to
// libjpeg's raw-mode staging planes (shared by decode and encode, which
// never interleave within one call). Each worker thread serves one image at
// a time, so one arena per thread with one slot per purpose: after the
// first few requests a thread's buffers sit at their high-water size and
// later calls reuse them. The counters are process-wide (relaxed atomics:
// monotone telemetry, not synchronization); the cap is per thread, checked
// after each top-level call: an over-cap arena drops all its capacity (an
// eviction) and the next call rebuilds only what it touches. Cap 0 =
// unlimited.

std::atomic<uint64_t> g_arena_reuses{0};
std::atomic<uint64_t> g_arena_misses{0};
std::atomic<uint64_t> g_arena_evictions{0};
std::atomic<uint64_t> g_arena_bytes{0};  // live capacity, summed over threads
std::atomic<uint64_t> g_arena_cap{0};    // per-thread byte budget, 0 = off

struct CodecArena {
  std::vector<uint8_t> ystage, ustage, vstage;

  size_t footprint() const {
    return ystage.capacity() + ustage.capacity() + vstage.capacity();
  }
  ~CodecArena() {
    g_arena_bytes.fetch_sub(footprint(), std::memory_order_relaxed);
  }
};

thread_local CodecArena t_arena;

// Size a slot for this call. Capacity (not size) decides reuse vs miss: a
// smaller request that fits the existing allocation is a reuse.
std::vector<uint8_t>& arena_slot(std::vector<uint8_t>& slot, size_t n) {
  const size_t before = slot.capacity();
  if (before >= n)
    g_arena_reuses.fetch_add(1, std::memory_order_relaxed);
  else
    g_arena_misses.fetch_add(1, std::memory_order_relaxed);
  slot.resize(n);
  const size_t after = slot.capacity();
  if (after > before)
    g_arena_bytes.fetch_add(after - before, std::memory_order_relaxed);
  return slot;
}

void arena_trim() {
  const uint64_t cap = g_arena_cap.load(std::memory_order_relaxed);
  if (cap == 0) return;
  const size_t fp = t_arena.footprint();
  if ((uint64_t)fp <= cap) return;
  std::vector<uint8_t>().swap(t_arena.ystage);
  std::vector<uint8_t>().swap(t_arena.ustage);
  std::vector<uint8_t>().swap(t_arena.vstage);
  g_arena_bytes.fetch_sub(fp, std::memory_order_relaxed);
  g_arena_evictions.fetch_add(1, std::memory_order_relaxed);
}

// ---------------------------------------------------------------- EXIF ------

// Minimal EXIF Orientation (tag 0x0112) scan over a JPEG APP1 segment.
uint32_t rd16(const uint8_t* p, bool le) {
  return le ? (p[0] | (p[1] << 8)) : ((p[0] << 8) | p[1]);
}
uint32_t rd32(const uint8_t* p, bool le) {
  return le ? (p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24))
            : (((uint32_t)p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3]);
}

int exif_orientation(const uint8_t* buf, size_t len) {
  if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return 0;
  size_t i = 2;
  while (i + 4 <= len) {
    if (buf[i] != 0xFF) break;
    // skip 0xFF fill bytes before the marker (ISO 10918-1 B.1.1.2)
    while (i + 4 <= len && buf[i + 1] == 0xFF) i++;
    if (i + 4 > len) break;
    uint8_t marker = buf[i + 1];
    if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD9)) { i += 2; continue; }
    size_t seglen = ((size_t)buf[i + 2] << 8) | buf[i + 3];
    if (seglen < 2 || i + 2 + seglen > len) break;
    if (marker == 0xE1 && seglen >= 10 &&
        std::memcmp(buf + i + 4, "Exif\0\0", 6) == 0) {
      const uint8_t* t = buf + i + 10;       // TIFF header
      size_t tlen = seglen - 8;
      if (tlen < 8) return 0;
      bool le;
      if (t[0] == 'I' && t[1] == 'I') le = true;
      else if (t[0] == 'M' && t[1] == 'M') le = false;
      else return 0;
      uint32_t ifd = rd32(t + 4, le);
      if (ifd + 2 > tlen) return 0;
      uint32_t n = rd16(t + ifd, le);
      for (uint32_t e = 0; e < n; e++) {
        size_t off = ifd + 2 + 12 * (size_t)e;
        if (off + 12 > tlen) return 0;
        if (rd16(t + off, le) == 0x0112) {
          uint32_t v = rd16(t + off + 8, le);
          return (v <= 8) ? (int)v : 0;
        }
      }
      return 0;
    }
    if (marker == 0xDA) break;  // start of scan: no EXIF past here
    i += 2 + seglen;
  }
  return 0;
}

// ---------------------------------------------------------------- JPEG ------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
  char msg[JMSG_LENGTH_MAX];
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, e->msg);
  longjmp(e->jb, 1);
}

bool jpeg_decode(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                 int* w, int* h, int* c, std::string* err, int scale_denom) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    *err = jerr.msg;
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (scale_denom == 2 || scale_denom == 4 || scale_denom == 8) {
    // shrink-on-load: decode at 1/N directly off the DCT (libvips does the
    // same before its resample stage) — 1/N^2 the pixels to move and resample
    cinfo.scale_num = 1;
    cinfo.scale_denom = (unsigned int)scale_denom;
  }
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  *c = 3;
  out->resize((size_t)(*w) * (*h) * 3);
  size_t stride = (size_t)(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Chroma subsampling fingerprint ("420"/"422"/"444"/"gray"/"" for other).
void jpeg_subsampling(jpeg_decompress_struct* cinfo, char out[8]) {
  out[0] = '\0';
  if (cinfo->num_components == 1) {
    std::snprintf(out, 8, "gray");
    return;
  }
  if (cinfo->num_components != 3) return;
  int h0 = cinfo->comp_info[0].h_samp_factor, v0 = cinfo->comp_info[0].v_samp_factor;
  int h1 = cinfo->comp_info[1].h_samp_factor, v1 = cinfo->comp_info[1].v_samp_factor;
  int h2 = cinfo->comp_info[2].h_samp_factor, v2 = cinfo->comp_info[2].v_samp_factor;
  if (h1 != 1 || v1 != 1 || h2 != 1 || v2 != 1) return;
  if (h0 == 2 && v0 == 2) std::snprintf(out, 8, "420");
  else if (h0 == 2 && v0 == 1) std::snprintf(out, 8, "422");
  else if (h0 == 1 && v0 == 1) std::snprintf(out, 8, "444");
}

bool jpeg_probe(const uint8_t* buf, size_t len, int* w, int* h, int* c,
                char subsampling[8]) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  *c = cinfo.num_components;
  jpeg_subsampling(&cinfo, subsampling);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------- JPEG raw (YUV420) ----

// Decode a YCbCr 4:2:0 JPEG into the packed-plane transport layout:
// a ((hb + hb/2) * wb) byte buffer with Y in rows [0, hb), U in the bottom
// block's columns [0, wb/2) and V in [wb/2, wb). hb/wb are the (even) bucket
// dims the caller padded to; actual luma dims return via h/w and chroma
// valid dims are ceil(h/2) x ceil(w/2). With IDCT scaling libjpeg emits
// chroma at LUMA resolution (DCT_scaled_size compensates the subsampling),
// so the scaled path box-averages 2x2 back down to 4:2:0.
bool jpeg_decode_yuv420(const uint8_t* buf, size_t len, int scale_denom,
                        int hb, int wb, std::vector<uint8_t>* packed,
                        int* h, int* w, std::string* err) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    *err = jerr.msg;
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  char sub[8];
  jpeg_subsampling(&cinfo, sub);
  if (std::strcmp(sub, "420") != 0 || cinfo.jpeg_color_space != JCS_YCbCr) {
    *err = "not-420";
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.raw_data_out = TRUE;
  cinfo.out_color_space = JCS_YCbCr;
  if (scale_denom == 2 || scale_denom == 4 || scale_denom == 8) {
    cinfo.scale_num = 1;
    cinfo.scale_denom = (unsigned int)scale_denom;
  }
  jpeg_start_decompress(&cinfo);
  const int lw = cinfo.comp_info[0].downsampled_width;
  const int lh = cinfo.comp_info[0].downsampled_height;
  const int cw0 = cinfo.comp_info[1].downsampled_width;
  const int ch0 = cinfo.comp_info[1].downsampled_height;
  const int ct_w = (lw + 1) / 2, ct_h = (lh + 1) / 2;
  if (lh > hb || lw > wb || (hb % 2) || (wb % 2)) {
    *err = "bucket too small for decoded dims";
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  const bool chroma_full = (ch0 == lh && cw0 == lw);
  if (!chroma_full && !(ch0 == ct_h && cw0 == ct_w)) {
    *err = "not-420";  // unexpected raw geometry: let the RGB path serve it
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  // Decode into generously-strided temp planes (libjpeg writes iMCU-padded
  // row widths in raw mode, which could overrun tight packed rows), then
  // memcpy into the packed layout. The extra copy is ~0.1 ms per image.
  const size_t lstride = ((size_t)lw + 63) / 64 * 64;
  const size_t cstride = ((size_t)cw0 + 63) / 64 * 64;
  std::vector<uint8_t>& Y = arena_slot(t_arena.ystage, lstride * (lh + 32));
  std::vector<uint8_t>& U = arena_slot(t_arena.ustage, cstride * (ch0 + 32));
  std::vector<uint8_t>& V = arena_slot(t_arena.vstage, cstride * (ch0 + 32));
  const int rg0 = cinfo.comp_info[0].v_samp_factor * cinfo.comp_info[0].DCT_scaled_size;
  const int rg1 = cinfo.comp_info[1].v_samp_factor * cinfo.comp_info[1].DCT_scaled_size;
  const int mcu_rows = cinfo.max_v_samp_factor * cinfo.min_DCT_scaled_size;
  if (rg0 > 64 || rg1 > 64) {
    *err = "unexpected raw row-group size";
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  JSAMPROW yrows[64], urows[64], vrows[64];
  JSAMPARRAY planes[3] = {yrows, urows, vrows};
  int yrow = 0, crow = 0;
  while (cinfo.output_scanline < cinfo.output_height) {
    for (int i = 0; i < rg0; i++)
      yrows[i] = Y.data() + lstride * (size_t)(yrow + i);
    for (int i = 0; i < rg1; i++) {
      urows[i] = U.data() + cstride * (size_t)(crow + i);
      vrows[i] = V.data() + cstride * (size_t)(crow + i);
    }
    if (!jpeg_read_raw_data(&cinfo, planes, (JDIMENSION)mcu_rows)) {
      *err = "jpeg_read_raw_data failed";
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    yrow += rg0;
    crow += rg1;
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  packed->assign((size_t)(hb + hb / 2) * wb, 0);
  uint8_t* p = packed->data();
  for (int r = 0; r < lh; r++)
    std::memcpy(p + (size_t)r * wb, Y.data() + lstride * (size_t)r, lw);
  uint8_t* uc = p + (size_t)hb * wb;          // chroma block top-left (U)
  uint8_t* vc = uc + wb / 2;                  // V half
  if (!chroma_full) {
    for (int r = 0; r < ct_h; r++) {
      std::memcpy(uc + (size_t)r * wb, U.data() + cstride * (size_t)r, ct_w);
      std::memcpy(vc + (size_t)r * wb, V.data() + cstride * (size_t)r, ct_w);
    }
  } else {
    // 2x2 box average with edge replication for odd trailing row/col
    for (int r = 0; r < ct_h; r++) {
      const int r0 = 2 * r, r1 = (2 * r + 1 < lh) ? 2 * r + 1 : r0;
      const uint8_t* u0 = U.data() + cstride * (size_t)r0;
      const uint8_t* u1 = U.data() + cstride * (size_t)r1;
      const uint8_t* v0 = V.data() + cstride * (size_t)r0;
      const uint8_t* v1 = V.data() + cstride * (size_t)r1;
      uint8_t* ur = uc + (size_t)r * wb;
      uint8_t* vr = vc + (size_t)r * wb;
      for (int x = 0; x < ct_w; x++) {
        const int x0 = 2 * x, x1 = (2 * x + 1 < lw) ? 2 * x + 1 : x0;
        ur[x] = (uint8_t)((u0[x0] + u0[x1] + u1[x0] + u1[x1] + 2) / 4);
        vr[x] = (uint8_t)((v0[x0] + v0[x1] + v1[x0] + v1[x1] + 2) / 4);
      }
    }
  }
  *h = lh;
  *w = lw;
  return true;
}

// Encode raw 4:2:0 planes (Y: h x w, U/V: ceil(h/2) x ceil(w/2), each
// contiguous) without libjpeg's color-convert/downsample stages.
bool jpeg_encode_yuv420(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                        int h, int w, int quality, bool progressive,
                        std::vector<uint8_t>* out, std::string* err) {
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  // iMCU-padded planes with edge replication (encoder reads 16-row groups)
  const int pw = (w + 15) / 16 * 16, ph = (h + 15) / 16 * 16;
  const int pcw = pw / 2, pch = ph / 2;
  std::vector<uint8_t>& Y = arena_slot(t_arena.ystage, (size_t)pw * ph);
  std::vector<uint8_t>& U = arena_slot(t_arena.ustage, (size_t)pcw * pch);
  std::vector<uint8_t>& V = arena_slot(t_arena.vstage, (size_t)pcw * pch);
  for (int r = 0; r < ph; r++) {
    const uint8_t* src = y + (size_t)w * ((r < h) ? r : h - 1);
    uint8_t* dst = Y.data() + (size_t)pw * r;
    std::memcpy(dst, src, w);
    std::memset(dst + w, src[w - 1], pw - w);
  }
  for (int r = 0; r < pch; r++) {
    const int sr = (r < ch) ? r : ch - 1;
    const uint8_t* su = u + (size_t)cw * sr;
    const uint8_t* sv = v + (size_t)cw * sr;
    uint8_t* du = U.data() + (size_t)pcw * r;
    uint8_t* dv = V.data() + (size_t)pcw * r;
    std::memcpy(du, su, cw);
    std::memset(du + cw, su[cw - 1], pcw - cw);
    std::memcpy(dv, sv, cw);
    std::memset(dv + cw, sv[cw - 1], pcw - cw);
  }

  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  unsigned char* mem = nullptr;
  unsigned long memlen = 0;
  if (setjmp(jerr.jb)) {
    *err = jerr.msg;
    jpeg_destroy_compress(&cinfo);
    if (mem) free(mem);
    return false;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &memlen);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_YCbCr;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  if (progressive) jpeg_simple_progression(&cinfo);
  cinfo.raw_data_in = TRUE;
  cinfo.comp_info[0].h_samp_factor = 2;
  cinfo.comp_info[0].v_samp_factor = 2;
  cinfo.comp_info[1].h_samp_factor = 1;
  cinfo.comp_info[1].v_samp_factor = 1;
  cinfo.comp_info[2].h_samp_factor = 1;
  cinfo.comp_info[2].v_samp_factor = 1;
  jpeg_start_compress(&cinfo, TRUE);
  JSAMPROW yrows[16], urows[8], vrows[8];
  JSAMPARRAY planes[3] = {yrows, urows, vrows};
  while (cinfo.next_scanline < cinfo.image_height) {
    const int base = (int)cinfo.next_scanline;
    for (int i = 0; i < 16; i++) {
      int r = base + i;
      if (r >= ph) r = ph - 1;
      yrows[i] = Y.data() + (size_t)pw * r;
    }
    for (int i = 0; i < 8; i++) {
      int r = base / 2 + i;
      if (r >= pch) r = pch - 1;
      urows[i] = U.data() + (size_t)pcw * r;
      vrows[i] = V.data() + (size_t)pcw * r;
    }
    jpeg_write_raw_data(&cinfo, planes, 16);
  }
  jpeg_finish_compress(&cinfo);
  out->assign(mem, mem + memlen);
  jpeg_destroy_compress(&cinfo);
  free(mem);
  return true;
}

bool jpeg_encode(const uint8_t* pix, int w, int h, int c, int quality,
                 bool progressive, std::vector<uint8_t>* out, std::string* err) {
  // c must be 1 or 3 (alpha pre-flattened by caller)
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  unsigned char* mem = nullptr;
  unsigned long memlen = 0;
  if (setjmp(jerr.jb)) {
    *err = jerr.msg;
    jpeg_destroy_compress(&cinfo);
    if (mem) free(mem);
    return false;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &memlen);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = c;
  cinfo.in_color_space = (c == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  if (progressive) jpeg_simple_progression(&cinfo);
  jpeg_start_compress(&cinfo, TRUE);
  size_t stride = (size_t)w * c;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(pix) + stride * cinfo.next_scanline;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  out->assign(mem, mem + memlen);
  jpeg_destroy_compress(&cinfo);
  free(mem);
  return true;
}


// ------------------------------------------------------------ bindings ------

bool is_jpeg(const char* fmt) { return std::strcmp(fmt, "jpeg") == 0; }

PyObject* py_decode(PyObject*, PyObject* args) {
  Py_buffer view;
  const char* fmt;
  int scale_denom = 1;
  if (!PyArg_ParseTuple(args, "y*s|i", &view, &fmt, &scale_denom)) return nullptr;
  if (!is_jpeg(fmt)) {
    PyBuffer_Release(&view);
    PyErr_Format(PyExc_ValueError, "unsupported format: %s", fmt);
    return nullptr;
  }
  const uint8_t* buf = static_cast<const uint8_t*>(view.buf);
  size_t len = view.len;
  std::vector<uint8_t> out;
  int w = 0, h = 0, c = 0, orientation = 0;
  std::string err;
  bool ok;
  Py_BEGIN_ALLOW_THREADS
  ok = jpeg_decode(buf, len, &out, &w, &h, &c, &err, scale_denom);
  if (ok) orientation = exif_orientation(buf, len);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&view);
  if (!ok) {
    PyErr_SetString(PyExc_ValueError, err.empty() ? "decode failed" : err.c_str());
    return nullptr;
  }
  PyObject* bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(out.data()), (Py_ssize_t)out.size());
  if (!bytes) return nullptr;
  return Py_BuildValue("(Niiiii)", bytes, h, w, c, orientation, 0);
}

PyObject* py_encode(PyObject*, PyObject* args) {
  Py_buffer view;
  int w, h, c, quality, progressive;
  const char* fmt;
  if (!PyArg_ParseTuple(args, "y*iiisii", &view, &h, &w, &c, &fmt, &quality,
                        &progressive))
    return nullptr;
  if (!is_jpeg(fmt)) {
    PyBuffer_Release(&view);
    PyErr_Format(PyExc_ValueError, "unsupported format: %s", fmt);
    return nullptr;
  }
  if (h <= 0 || w <= 0 || (c != 1 && c != 3 && c != 4) ||
      (Py_ssize_t)((size_t)w * h * c) != view.len) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "buffer size does not match h*w*c");
    return nullptr;
  }
  const uint8_t* pix = static_cast<const uint8_t*>(view.buf);
  std::vector<uint8_t> out;
  std::vector<uint8_t> flat;
  std::string err;
  bool ok;
  Py_BEGIN_ALLOW_THREADS
  const uint8_t* src = pix;
  int cc = c;
  if (c == 4) {  // flatten alpha onto black (libvips JPEG behavior)
    flat.resize((size_t)w * h * 3);
    for (size_t i = 0, n = (size_t)w * h; i < n; i++) {
      uint32_t a = pix[i * 4 + 3];
      flat[i * 3 + 0] = (uint8_t)((pix[i * 4 + 0] * a + 127) / 255);
      flat[i * 3 + 1] = (uint8_t)((pix[i * 4 + 1] * a + 127) / 255);
      flat[i * 3 + 2] = (uint8_t)((pix[i * 4 + 2] * a + 127) / 255);
    }
    src = flat.data();
    cc = 3;
  }
  ok = jpeg_encode(src, w, h, cc, quality, progressive != 0, &out, &err);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&view);
  if (!ok) {
    PyErr_SetString(PyExc_ValueError, err.empty() ? "encode failed" : err.c_str());
    return nullptr;
  }
  return PyBytes_FromStringAndSize(reinterpret_cast<const char*>(out.data()),
                                   (Py_ssize_t)out.size());
}

PyObject* py_probe(PyObject*, PyObject* args) {
  Py_buffer view;
  const char* fmt;
  if (!PyArg_ParseTuple(args, "y*s", &view, &fmt)) return nullptr;
  const uint8_t* buf = static_cast<const uint8_t*>(view.buf);
  size_t len = view.len;
  int w = 0, h = 0, c = 0, orientation = 0;
  char subsampling[8] = {0};
  bool ok = false;
  const bool jpeg = is_jpeg(fmt);
  Py_BEGIN_ALLOW_THREADS
  if (jpeg) {
    ok = jpeg_probe(buf, len, &w, &h, &c, subsampling);
    if (ok) orientation = exif_orientation(buf, len);
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&view);
  if (!ok) {
    PyErr_SetString(PyExc_ValueError, "probe failed");
    return nullptr;
  }
  return Py_BuildValue("(iiiiis)", w, h, c, 0, orientation, subsampling);
}

PyObject* py_decode_yuv420(PyObject*, PyObject* args) {
  Py_buffer view;
  int scale_denom, hb, wb;
  if (!PyArg_ParseTuple(args, "y*iii", &view, &scale_denom, &hb, &wb))
    return nullptr;
  const uint8_t* buf = static_cast<const uint8_t*>(view.buf);
  size_t len = view.len;
  std::vector<uint8_t> packed;
  int h = 0, w = 0, orientation = 0;
  std::string err;
  bool ok;
  Py_BEGIN_ALLOW_THREADS
  ok = jpeg_decode_yuv420(buf, len, scale_denom, hb, wb, &packed, &h, &w, &err);
  if (ok) orientation = exif_orientation(buf, len);
  arena_trim();
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&view);
  if (!ok) {
    PyErr_SetString(PyExc_ValueError, err.empty() ? "decode failed" : err.c_str());
    return nullptr;
  }
  PyObject* bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(packed.data()), (Py_ssize_t)packed.size());
  if (!bytes) return nullptr;
  return Py_BuildValue("(Niii)", bytes, h, w, orientation);
}

PyObject* py_encode_yuv420(PyObject*, PyObject* args) {
  Py_buffer yv, uv, vv;
  int h, w, quality, progressive;
  if (!PyArg_ParseTuple(args, "y*y*y*iiii", &yv, &uv, &vv, &h, &w, &quality,
                        &progressive))
    return nullptr;
  const int ch = (h + 1) / 2, cw = (w + 1) / 2;
  if (h <= 0 || w <= 0 || yv.len != (Py_ssize_t)((size_t)h * w) ||
      uv.len != (Py_ssize_t)((size_t)ch * cw) ||
      vv.len != (Py_ssize_t)((size_t)ch * cw)) {
    PyBuffer_Release(&yv);
    PyBuffer_Release(&uv);
    PyBuffer_Release(&vv);
    PyErr_SetString(PyExc_ValueError, "plane sizes do not match h/w");
    return nullptr;
  }
  std::vector<uint8_t> out;
  std::string err;
  bool ok;
  Py_BEGIN_ALLOW_THREADS
  ok = jpeg_encode_yuv420(static_cast<const uint8_t*>(yv.buf),
                          static_cast<const uint8_t*>(uv.buf),
                          static_cast<const uint8_t*>(vv.buf), h, w, quality,
                          progressive != 0, &out, &err);
  arena_trim();
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&yv);
  PyBuffer_Release(&uv);
  PyBuffer_Release(&vv);
  if (!ok) {
    PyErr_SetString(PyExc_ValueError, err.empty() ? "encode failed" : err.c_str());
    return nullptr;
  }
  return PyBytes_FromStringAndSize(reinterpret_cast<const char*>(out.data()),
                                   (Py_ssize_t)out.size());
}

PyObject* py_arena_stats(PyObject*, PyObject*) {
  return Py_BuildValue(
      "{s:K,s:K,s:K,s:K,s:K}",
      "reuses", (unsigned long long)g_arena_reuses.load(std::memory_order_relaxed),
      "misses", (unsigned long long)g_arena_misses.load(std::memory_order_relaxed),
      "evictions", (unsigned long long)g_arena_evictions.load(std::memory_order_relaxed),
      "bytes", (unsigned long long)g_arena_bytes.load(std::memory_order_relaxed),
      "cap_bytes", (unsigned long long)g_arena_cap.load(std::memory_order_relaxed));
}

PyObject* py_set_arena_cap(PyObject*, PyObject* args) {
  double mb;
  if (!PyArg_ParseTuple(args, "d", &mb)) return nullptr;
  if (mb < 0.0) mb = 0.0;
  g_arena_cap.store((uint64_t)(mb * 1024.0 * 1024.0), std::memory_order_relaxed);
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"decode", py_decode, METH_VARARGS,
     "decode(bytes, fmt[, scale_denom]) -> (pixels, h, w, c, orientation, has_alpha)"},
    {"encode", py_encode, METH_VARARGS,
     "encode(buf, h, w, c, fmt, quality, progressive) -> bytes"},
    {"probe", py_probe, METH_VARARGS,
     "probe(bytes, fmt) -> (w, h, c, has_alpha, orientation, subsampling)"},
    {"decode_yuv420", py_decode_yuv420, METH_VARARGS,
     "decode_yuv420(bytes, scale_denom, hb, wb) -> (packed, h, w, orientation)"},
    {"encode_yuv420", py_encode_yuv420, METH_VARARGS,
     "encode_yuv420(y, u, v, h, w, quality, progressive) -> bytes"},
    {"arena_stats", py_arena_stats, METH_NOARGS,
     "arena_stats() -> {reuses, misses, evictions, bytes, cap_bytes}"},
    {"set_arena_cap", py_set_arena_cap, METH_VARARGS,
     "set_arena_cap(mb): per-thread scratch-arena budget (0 = unlimited)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_itpu_torch_codecs",
    "Native JPEG codec of the PyTorch/CUDA port (GIL-released)", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__itpu_torch_codecs(void) {
  PyObject* m = PyModule_Create(&moduledef);
  if (m) PyModule_AddStringConstant(m, "FORMATS", "jpeg");
  return m;
}

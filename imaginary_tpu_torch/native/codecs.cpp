// Native host codec layer of the PyTorch/CUDA port: JPEG, PNG, WEBP, GIF
// and TIFF decode/encode, EXIF orientation, the median-cut palette and the
// packed-YUV420 transport entry points.
//
// The port's own copy of imaginary_tpu/native/codecs.cpp without its host
// resampler (native/resample.cpp holds that): libjpeg, libpng (the
// simplified API for decode and plain encode, the low-level writer for
// interlace, palette and speed), libwebp, libtiff (its ABI declared by hand
// below) and an in-tree GIF codec. native/build.py links each library from
// the system or from Pillow's wheel. Built directly on the CPython C API;
// all codec work runs with the GIL RELEASED, so server threads
// decode/encode on real cores concurrently.
//
// Interface (module _itpu_torch_codecs):
//   decode(bytes, fmt: str[, scale_denom]) -> (pixels: bytes, h, w, c, orientation, has_alpha)
//   encode(buffer, h, w, c, fmt: str, quality, compression, progressive[, palette, speed]) -> bytes
//   probe(bytes, fmt: str)   -> (w, h, c, has_alpha, orientation, subsampling)
//   decode_yuv420(bytes, scale_denom, hb, wb) -> (packed, h, w, orientation)
//   encode_yuv420(y, u, v, h, w, quality, progressive) -> bytes
//   arena_stats() -> {reuses, misses, evictions, bytes, cap_bytes}
//   set_arena_cap(mb)        per-thread scratch budget, 0 = unlimited
//   FORMATS                  "jpeg,png,webp,gif,tiff"
//   LINKED                   the library each format links, as built
//   LIBPNG                   the linked libpng's version number
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
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <string>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <webp/decode.h>
#include <webp/encode.h>

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

// ----------------------------------------------------------------- PNG ------

bool png_decode_buf(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                    int* w, int* h, int* c, std::string* err) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, buf, len)) {
    *err = img.message;
    return false;
  }
  bool alpha = (img.format & PNG_FORMAT_FLAG_ALPHA) != 0;
  img.format = alpha ? PNG_FORMAT_RGBA : PNG_FORMAT_RGB;
  *c = alpha ? 4 : 3;
  *w = img.width;
  *h = img.height;
  out->resize(PNG_IMAGE_SIZE(img));
  if (!png_image_finish_read(&img, nullptr, out->data(), 0, nullptr)) {
    *err = img.message;
    return false;
  }
  return true;
}

bool png_probe_buf(const uint8_t* buf, size_t len, int* w, int* h, int* c) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, buf, len)) return false;
  *w = img.width;
  *h = img.height;
  *c = (img.format & PNG_FORMAT_FLAG_ALPHA) ? 4 : 3;
  png_image_free(&img);
  return true;
}

bool png_encode_buf(const uint8_t* pix, int w, int h, int c,
                    std::vector<uint8_t>* out, std::string* err) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  img.width = w;
  img.height = h;
  img.format = (c == 4) ? PNG_FORMAT_RGBA : (c == 1 ? PNG_FORMAT_GRAY : PNG_FORMAT_RGB);
  png_alloc_size_t size = 0;
  if (!png_image_write_to_memory(&img, nullptr, &size, 0, pix, 0, nullptr)) {
    *err = img.message;
    return false;
  }
  out->resize(size);
  if (!png_image_write_to_memory(&img, out->data(), &size, 0, pix, 0, nullptr)) {
    *err = img.message;
    return false;
  }
  out->resize(size);
  return true;
}

// ---------------------------------------------------------------- WEBP ------

bool webp_decode_buf(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                     int* w, int* h, int* c, std::string* err) {
  WebPBitstreamFeatures feat;
  if (WebPGetFeatures(buf, len, &feat) != VP8_STATUS_OK) {
    *err = "invalid webp";
    return false;
  }
  *w = feat.width;
  *h = feat.height;
  *c = feat.has_alpha ? 4 : 3;
  size_t stride = (size_t)(*w) * (*c);
  out->resize(stride * (*h));
  uint8_t* res = feat.has_alpha
      ? WebPDecodeRGBAInto(buf, len, out->data(), out->size(), (int)stride)
      : WebPDecodeRGBInto(buf, len, out->data(), out->size(), (int)stride);
  if (!res) {
    *err = "webp decode failed";
    return false;
  }
  return true;
}

bool webp_encode_buf(const uint8_t* pix, int w, int h, int c, int quality,
                     std::vector<uint8_t>* out, std::string* err) {
  uint8_t* mem = nullptr;
  size_t n = (c == 4)
      ? WebPEncodeRGBA(pix, w, h, w * 4, (float)quality, &mem)
      : WebPEncodeRGB(pix, w, h, w * 3, (float)quality, &mem);
  if (!n || !mem) {
    *err = "webp encode failed";
    return false;
  }
  out->assign(mem, mem + n);
  WebPFree(mem);
  return true;
}

// ---------------------------------------------------- palette quantizer -----
//
// Median-cut + Floyd-Steinberg, shared by palette-PNG output and the GIF
// encoder: the JAX package's in-tree quantizer, so both packages answer a
// palette request with the same colours.

struct Box {
  int lo[3], hi[3];
  std::vector<uint32_t> colors;  // packed 0x00RRGGBB, sampled
};

void box_bounds(Box* b) {
  for (int k = 0; k < 3; k++) { b->lo[k] = 255; b->hi[k] = 0; }
  for (uint32_t cc : b->colors) {
    int v[3] = {(int)(cc >> 16) & 255, (int)(cc >> 8) & 255, (int)cc & 255};
    for (int k = 0; k < 3; k++) {
      if (v[k] < b->lo[k]) b->lo[k] = v[k];
      if (v[k] > b->hi[k]) b->hi[k] = v[k];
    }
  }
}

// Quantize RGB(A) pixels to <= max_colors palette entries (RGB). Pixels with
// alpha < 128 are excluded from the statistics (they map to a reserved
// transparent index when the caller asks for one).
void median_cut(const uint8_t* pix, size_t n, int c, int max_colors,
                std::vector<uint8_t>* palette) {
  // bounded sample: quantizer cost must not scale with megapixels
  const size_t kMaxSample = 1 << 16;
  size_t stride = (n > kMaxSample) ? n / kMaxSample : 1;
  std::vector<Box> boxes(1);
  boxes[0].colors.reserve(n / stride + 1);
  for (size_t i = 0; i < n; i += stride) {
    const uint8_t* p = pix + i * c;
    if (c == 4 && p[3] < 128) continue;
    boxes[0].colors.push_back(((uint32_t)p[0] << 16) | ((uint32_t)p[1] << 8) | p[2]);
  }
  if (boxes[0].colors.empty()) boxes[0].colors.push_back(0);
  box_bounds(&boxes[0]);
  while ((int)boxes.size() < max_colors) {
    // widest-range box with >1 color
    int bi = -1, best = -1;
    for (size_t i = 0; i < boxes.size(); i++) {
      if (boxes[i].colors.size() < 2) continue;
      int r = 0;
      for (int k = 0; k < 3; k++) r = std::max(r, boxes[i].hi[k] - boxes[i].lo[k]);
      if (r > best) { best = r; bi = (int)i; }
    }
    if (bi < 0) break;
    Box& b = boxes[bi];
    int axis = 0;
    for (int k = 1; k < 3; k++)
      if (b.hi[k] - b.lo[k] > b.hi[axis] - b.lo[axis]) axis = k;
    const int shift = (axis == 0) ? 16 : (axis == 1) ? 8 : 0;
    std::sort(b.colors.begin(), b.colors.end(),
              [shift](uint32_t a, uint32_t bb) {
                return ((a >> shift) & 255) < ((bb >> shift) & 255);
              });
    Box nb;
    size_t mid = b.colors.size() / 2;
    nb.colors.assign(b.colors.begin() + mid, b.colors.end());
    b.colors.resize(mid);
    box_bounds(&b);
    box_bounds(&nb);
    boxes.push_back(std::move(nb));
  }
  palette->clear();
  for (Box& b : boxes) {
    uint64_t s[3] = {0, 0, 0};
    for (uint32_t cc : b.colors) {
      s[0] += (cc >> 16) & 255; s[1] += (cc >> 8) & 255; s[2] += cc & 255;
    }
    size_t m = b.colors.size();
    palette->push_back((uint8_t)(s[0] / m));
    palette->push_back((uint8_t)(s[1] / m));
    palette->push_back((uint8_t)(s[2] / m));
  }
}

struct NearestCache {
  // 15-bit RGB -> palette index (+1; 0 = empty)
  std::vector<uint16_t> slot = std::vector<uint16_t>(1 << 15, 0);
  const std::vector<uint8_t>* pal;
  int start = 0;  // first searchable entry: skips a reserved transparent
                  // index, else opaque near-black pixels would map to it
                  // and render fully transparent
  int find(int r, int g, int b) {
    const uint32_t key = ((r >> 3) << 10) | ((g >> 3) << 5) | (b >> 3);
    if (slot[key]) return slot[key] - 1;
    int best = start;
    long bestd = 1L << 40;
    const std::vector<uint8_t>& P = *pal;
    for (size_t i = (size_t)start; i * 3 < P.size(); i++) {
      long dr = r - P[i * 3], dg = g - P[i * 3 + 1], db = b - P[i * 3 + 2];
      long d = dr * dr + dg * dg + db * db;
      if (d < bestd) { bestd = d; best = (int)i; }
    }
    slot[key] = (uint16_t)(best + 1);
    return best;
  }
};

// Map pixels to palette indices with Floyd-Steinberg error diffusion.
// transparent_index >= 0 claims that index for alpha < 128 pixels.
void dither_map(const uint8_t* pix, int w, int h, int c,
                const std::vector<uint8_t>& palette, int transparent_index,
                std::vector<uint8_t>* indices) {
  NearestCache cache;
  cache.pal = &palette;
  cache.start = (transparent_index == 0) ? 1 : 0;
  indices->resize((size_t)w * h);
  // error rows: 3 channels, current + next
  std::vector<int> err((size_t)(w + 2) * 3 * 2, 0);
  int* cur = err.data();
  int* nxt = err.data() + (size_t)(w + 2) * 3;
  for (int y = 0; y < h; y++) {
    std::memset(nxt, 0, sizeof(int) * (size_t)(w + 2) * 3);
    for (int x = 0; x < w; x++) {
      const uint8_t* p = pix + ((size_t)y * w + x) * c;
      if (c == 4 && transparent_index >= 0 && p[3] < 128) {
        (*indices)[(size_t)y * w + x] = (uint8_t)transparent_index;
        continue;
      }
      int v[3];
      for (int k = 0; k < 3; k++) {
        int t = p[k] + cur[(x + 1) * 3 + k] / 16;
        v[k] = t < 0 ? 0 : (t > 255 ? 255 : t);
      }
      int idx = cache.find(v[0], v[1], v[2]);
      (*indices)[(size_t)y * w + x] = (uint8_t)idx;
      for (int k = 0; k < 3; k++) {
        int e = v[k] - palette[idx * 3 + k];
        cur[(x + 2) * 3 + k] += e * 7;
        nxt[(x + 0) * 3 + k] += e * 3;
        nxt[(x + 1) * 3 + k] += e * 5;
        nxt[(x + 2) * 3 + k] += e * 1;
      }
    }
    std::swap(cur, nxt);
  }
}

// ------------------------------------------------------- PNG (full-path) ----
//
// The simplified png_image API cannot write interlaced or palette PNGs; this
// low-level writer covers the Interlace and Palette options (vips pngsave
// interlace/palette in imaginary) plus the Speed -> filter-strategy
// mapping (cheaper filters = faster encode, larger output).

void png_vec_write(png_structp png, png_bytep data, png_size_t len) {
  auto* out = static_cast<std::vector<uint8_t>*>(png_get_io_ptr(png));
  out->insert(out->end(), data, data + len);
}
void png_vec_flush(png_structp) {}

void png_err_fn(png_structp png, png_const_charp msg) {
  auto* err = static_cast<std::string*>(png_get_error_ptr(png));
  if (err) *err = msg;
  longjmp(png_jmpbuf(png), 1);
}
void png_warn_fn(png_structp, png_const_charp) {}

bool png_encode_full(const uint8_t* pix, int w, int h, int c, int compression,
                     bool interlace, bool palette, int speed,
                     std::vector<uint8_t>* out, std::string* err) {
  png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING, err,
                                            png_err_fn, png_warn_fn);
  if (!png) { *err = "png_create_write_struct failed"; return false; }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    *err = "png_create_info_struct failed";
    return false;
  }
  std::vector<uint8_t> indices;          // outlive setjmp
  std::vector<uint8_t> pal;
  std::vector<png_bytep> rows((size_t)h);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    return false;
  }
  out->clear();
  png_set_write_fn(png, out, png_vec_write, png_vec_flush);
  png_set_compression_level(png, compression);
  if (speed > 0) {
    // Speed maps to filter strategy: the filter pass is
    // the CPU-bound part of PNG encode after zlib; high speed drops it.
    int filters = (speed >= 7) ? PNG_FILTER_NONE
                 : (speed >= 4) ? (PNG_FILTER_NONE | PNG_FILTER_SUB)
                                : PNG_ALL_FILTERS;
    png_set_filter(png, 0, filters);
  }
  const int itype = interlace ? PNG_INTERLACE_ADAM7 : PNG_INTERLACE_NONE;
  if (palette && c >= 3) {
    const bool has_alpha = (c == 4);
    // reserve index 0 for transparency when any pixel is see-through
    bool any_transparent = false;
    if (has_alpha) {
      const size_t n = (size_t)w * h;
      for (size_t i = 0; i < n; i++)
        if (pix[i * 4 + 3] < 128) { any_transparent = true; break; }
    }
    const int max_colors = any_transparent ? 255 : 256;
    median_cut(pix, (size_t)w * h, c, max_colors, &pal);
    int transparent_index = -1;
    if (any_transparent) {
      pal.insert(pal.begin(), {0, 0, 0});  // index 0 = fully transparent
      transparent_index = 0;              // opaque search skips it (cache.start)
    }
    const int ncolors = (int)(pal.size() / 3);
    dither_map(pix, w, h, c, pal, transparent_index, &indices);
    png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_PALETTE, itype,
                 PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
    std::vector<png_color> plte((size_t)ncolors);
    for (int i = 0; i < ncolors; i++) {
      plte[i].red = pal[i * 3];
      plte[i].green = pal[i * 3 + 1];
      plte[i].blue = pal[i * 3 + 2];
    }
    png_set_PLTE(png, info, plte.data(), ncolors);
    if (transparent_index == 0) {
      png_byte trans[1] = {0};
      png_set_tRNS(png, info, trans, 1, nullptr);
    }
    for (int y = 0; y < h; y++) rows[y] = indices.data() + (size_t)y * w;
  } else {
    const int color_type = (c == 4) ? PNG_COLOR_TYPE_RGBA
                          : (c == 1) ? PNG_COLOR_TYPE_GRAY
                                     : PNG_COLOR_TYPE_RGB;
    png_set_IHDR(png, info, w, h, 8, color_type, itype,
                 PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
    for (int y = 0; y < h; y++)
      rows[y] = const_cast<uint8_t*>(pix) + (size_t)y * w * c;
  }
  png_write_info(png, info);
  png_write_image(png, rows.data());  // handles Adam7 passes itself
  png_write_end(png, info);
  png_destroy_write_struct(&png, &info);
  return true;
}

// ----------------------------------------------------------------- GIF ------
//
// From-scratch GIF87a/89a codec (LZW both directions), needing no library:
// the format is simple enough that an in-tree implementation is smaller
// than an ABI-by-hand binding of giflib. First frame only, like vips
// gifload's default page.

struct BitReader {
  const uint8_t* data;
  size_t len, pos = 0;
  uint32_t acc = 0;
  int nbits = 0;
  bool get(int width, uint32_t* out) {
    while (nbits < width) {
      if (pos >= len) return false;
      acc |= (uint32_t)data[pos++] << nbits;
      nbits += 8;
    }
    *out = acc & ((1u << width) - 1);
    acc >>= width;
    nbits -= width;
    return true;
  }
};

// LZW-decompress GIF image data (sub-blocks already concatenated) into
// `npix` palette indices.
bool gif_lzw_decode(const uint8_t* data, size_t len, int min_code_size,
                    size_t npix, std::vector<uint8_t>* out) {
  if (min_code_size < 2 || min_code_size > 11) return false;
  const int clear = 1 << min_code_size, eoi = clear + 1;
  int code_size = min_code_size + 1, next_code = eoi + 1, prev = -1;
  std::vector<int> prefix(4096, -1);
  std::vector<uint8_t> suffix(4096, 0), stack(4096);
  for (int i = 0; i < clear; i++) suffix[i] = (uint8_t)i;
  out->clear();
  out->reserve(npix);
  BitReader br{data, len};
  uint32_t code;
  while (out->size() < npix && br.get(code_size, &code)) {
    if ((int)code == clear) {
      code_size = min_code_size + 1;
      next_code = eoi + 1;
      prev = -1;
      continue;
    }
    if ((int)code == eoi) break;
    if ((int)code > next_code || ((int)code == next_code && prev < 0))
      return false;  // corrupt stream
    int cur = (int)code;
    int sp = 0;
    uint8_t first;
    if (cur == next_code) {  // KwKwK: string(prev) + first(prev)
      cur = prev;
      // walk prev first to learn its first char, emit later with extra char
      int t = cur;
      while (prefix[t] >= 0) t = prefix[t];
      stack[sp++] = suffix[t];  // placeholder for trailing char (== first)
    }
    int t = cur;
    while (t >= 0) {
      if (sp >= 4096) return false;
      stack[sp++] = suffix[t];
      t = prefix[t];
    }
    first = stack[sp - 1];
    while (sp > 0 && out->size() < npix) out->push_back(stack[--sp]);
    if (prev >= 0 && next_code < 4096) {
      prefix[next_code] = prev;
      suffix[next_code] = first;
      next_code++;
      if (next_code == (1 << code_size) && code_size < 12) code_size++;
    }
    prev = (int)code;
  }
  return out->size() == npix;
}

struct BitWriter {
  std::vector<uint8_t> bytes;
  uint32_t acc = 0;
  int nbits = 0;
  void put(uint32_t code, int width) {
    acc |= code << nbits;
    nbits += width;
    while (nbits >= 8) {
      bytes.push_back((uint8_t)(acc & 255));
      acc >>= 8;
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) bytes.push_back((uint8_t)(acc & 255));
    acc = 0;
    nbits = 0;
  }
};

void gif_lzw_encode(const uint8_t* indices, size_t n, int min_code_size,
                    BitWriter* bw) {
  const int clear = 1 << min_code_size, eoi = clear + 1;
  int code_size = min_code_size + 1, next_code = eoi + 1;
  // open-addressing hash: key = (prefix << 8) | ch, value = code
  const int HB = 1 << 14;
  std::vector<int> hkey(HB, -1), hval(HB, 0);
  auto reset = [&]() {
    std::fill(hkey.begin(), hkey.end(), -1);
    code_size = min_code_size + 1;
    next_code = eoi + 1;
  };
  bw->put((uint32_t)clear, code_size);
  if (n == 0) {
    bw->put((uint32_t)eoi, code_size);
    bw->flush();
    return;
  }
  // Width-sync invariant: the decoder registers its (j-1)-th entry after
  // reading code j, so it is one entry BEHIND this table. The code-size
  // bump therefore happens after emitting a code but BEFORE registering
  // the new entry (giflib's `free_ent > maxcode` ordering) — bumping
  // after the add desyncs widths one code early on the decoder side.
  auto bump = [&]() {
    if (next_code >= (1 << code_size) && code_size < 12) code_size++;
  };
  int prefix = indices[0];
  for (size_t i = 1; i < n; i++) {
    const int ch = indices[i];
    const int key = (prefix << 8) | ch;
    int slot = (int)(((uint32_t)key * 2654435761u) & (HB - 1));
    int found = -1;
    while (hkey[slot] != -1) {
      if (hkey[slot] == key) { found = hval[slot]; break; }
      slot = (slot + 1) & (HB - 1);
    }
    if (found >= 0) {
      prefix = found;
      continue;
    }
    bw->put((uint32_t)prefix, code_size);
    bump();
    if (next_code < 4096) {
      hkey[slot] = key;
      hval[slot] = next_code;
      next_code++;
    } else {
      bw->put((uint32_t)clear, code_size);
      reset();
    }
    prefix = ch;
  }
  bw->put((uint32_t)prefix, code_size);
  bump();
  bw->put((uint32_t)eoi, code_size);
  bw->flush();
}

uint32_t rd16le(const uint8_t* p) { return p[0] | ((uint32_t)p[1] << 8); }

bool gif_decode_buf(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                    int* w, int* h, int* c, std::string* err) {
  if (len < 13 || std::memcmp(buf, "GIF8", 4) != 0 ||
      (buf[4] != '7' && buf[4] != '9') || buf[5] != 'a') {
    *err = "invalid gif";
    return false;
  }
  const int sw = (int)rd16le(buf + 6), sh = (int)rd16le(buf + 8);
  if (sw <= 0 || sh <= 0 || (int64_t)sw * sh > (int64_t)100 * 1000 * 1000) {
    *err = "invalid gif dimensions";
    return false;
  }
  const uint8_t packed = buf[10];
  const int bg = buf[11];
  const uint8_t* gct = nullptr;
  int gct_n = 0;
  size_t i = 13;
  if (packed & 0x80) {
    gct_n = 2 << (packed & 7);
    if (i + (size_t)gct_n * 3 > len) { *err = "truncated gif"; return false; }
    gct = buf + i;
    i += (size_t)gct_n * 3;
  }
  int transparent = -1;
  while (i < len) {
    const uint8_t b0 = buf[i++];
    if (b0 == 0x3B) break;  // trailer before any image
    if (b0 == 0x21) {       // extension
      if (i >= len) break;
      const uint8_t label = buf[i++];
      if (label == 0xF9 && i + 6 <= len && buf[i] == 4) {
        if (buf[i + 1] & 1) transparent = buf[i + 5];
      }
      // skip sub-blocks
      while (i < len && buf[i] != 0) {
        i += 1 + buf[i];
        if (i > len) { *err = "truncated gif"; return false; }
      }
      i++;  // block terminator
      continue;
    }
    if (b0 != 0x2C) { *err = "invalid gif block"; return false; }
    // image descriptor
    if (i + 9 > len) { *err = "truncated gif"; return false; }
    const int fx = (int)rd16le(buf + i), fy = (int)rd16le(buf + i + 2);
    const int fw = (int)rd16le(buf + i + 4), fh = (int)rd16le(buf + i + 6);
    const uint8_t fpacked = buf[i + 8];
    i += 9;
    const uint8_t* lct = gct;
    int lct_n = gct_n;
    if (fpacked & 0x80) {
      lct_n = 2 << (fpacked & 7);
      if (i + (size_t)lct_n * 3 > len) { *err = "truncated gif"; return false; }
      lct = buf + i;
      i += (size_t)lct_n * 3;
    }
    if (!lct || fw <= 0 || fh <= 0 || fx + fw > sw || fy + fh > sh) {
      *err = "invalid gif frame";
      return false;
    }
    const bool interlaced = (fpacked & 0x40) != 0;
    if (i >= len) { *err = "truncated gif"; return false; }
    const int min_code_size = buf[i++];
    // concatenate data sub-blocks
    std::vector<uint8_t> data;
    while (i < len && buf[i] != 0) {
      const size_t bl = buf[i];
      if (i + 1 + bl > len) { *err = "truncated gif"; return false; }
      data.insert(data.end(), buf + i + 1, buf + i + 1 + bl);
      i += 1 + bl;
    }
    std::vector<uint8_t> idx;
    if (!gif_lzw_decode(data.data(), data.size(), min_code_size,
                        (size_t)fw * fh, &idx)) {
      *err = "gif lzw decode failed";
      return false;
    }
    // compose onto the logical screen
    const bool has_alpha = transparent >= 0;
    *c = has_alpha ? 4 : 3;
    *w = sw;
    *h = sh;
    out->assign((size_t)sw * sh * (*c), 0);
    if (!has_alpha && gct && bg < gct_n) {  // background fill
      for (size_t p = 0, np = (size_t)sw * sh; p < np; p++) {
        (*out)[p * 3 + 0] = gct[bg * 3 + 0];
        (*out)[p * 3 + 1] = gct[bg * 3 + 1];
        (*out)[p * 3 + 2] = gct[bg * 3 + 2];
      }
    }
    // interlace pass order
    std::vector<int> row_of(fh);
    if (interlaced) {
      static const int off[4] = {0, 4, 2, 1}, step[4] = {8, 8, 4, 2};
      int r = 0;
      for (int p = 0; p < 4; p++)
        for (int y = off[p]; y < fh; y += step[p]) row_of[r++] = y;
    } else {
      for (int y = 0; y < fh; y++) row_of[y] = y;
    }
    for (int r = 0; r < fh; r++) {
      const int y = row_of[r];
      for (int x = 0; x < fw; x++) {
        const int v = idx[(size_t)r * fw + x];
        if (v >= lct_n) continue;  // out-of-palette index: leave background
        uint8_t* dst = out->data() + (((size_t)(fy + y) * sw) + fx + x) * (*c);
        if (has_alpha) {
          if (v == transparent) continue;  // stays (0,0,0,0)
          dst[0] = lct[v * 3];
          dst[1] = lct[v * 3 + 1];
          dst[2] = lct[v * 3 + 2];
          dst[3] = 255;
        } else {
          dst[0] = lct[v * 3];
          dst[1] = lct[v * 3 + 1];
          dst[2] = lct[v * 3 + 2];
        }
      }
    }
    return true;  // first frame only
  }
  *err = "gif has no image data";
  return false;
}

bool gif_probe_buf(const uint8_t* buf, size_t len, int* w, int* h, int* c) {
  if (len < 13 || std::memcmp(buf, "GIF8", 4) != 0) return false;
  *w = (int)rd16le(buf + 6);
  *h = (int)rd16le(buf + 8);
  // bounded scan for a GCE transparency flag before the first image
  size_t i = 13;
  if (buf[10] & 0x80) i += (size_t)(2 << (buf[10] & 7)) * 3;
  *c = 3;
  while (i + 1 < len && buf[i] == 0x21) {
    const uint8_t label = buf[i + 1];
    size_t j = i + 2;
    if (label == 0xF9 && j + 5 < len && buf[j] == 4 && (buf[j + 1] & 1)) {
      *c = 4;
      break;
    }
    while (j < len && buf[j] != 0) j += 1 + buf[j];
    i = j + 1;
  }
  return *w > 0 && *h > 0;
}

bool gif_encode_buf(const uint8_t* pix, int w, int h, int c,
                    std::vector<uint8_t>* out, std::string* err) {
  if (c != 3 && c != 4) {
    // expand gray to RGB via caller; guard anyway
    *err = "gif encode expects RGB(A)";
    return false;
  }
  bool any_transparent = false;
  if (c == 4) {
    const size_t n = (size_t)w * h;
    for (size_t i = 0; i < n; i++)
      if (pix[i * 4 + 3] < 128) { any_transparent = true; break; }
  }
  std::vector<uint8_t> pal;
  median_cut(pix, (size_t)w * h, c, any_transparent ? 255 : 256, &pal);
  int transparent_index = -1;
  if (any_transparent) {
    pal.insert(pal.begin(), {0, 0, 0});
    transparent_index = 0;
  }
  const int ncolors = (int)(pal.size() / 3);
  std::vector<uint8_t> indices;
  dither_map(pix, w, h, c, pal, transparent_index, &indices);
  // palette size field: 2^(n+1) >= ncolors (pbits=7 covers the 256 max)
  int pbits = 1;
  while ((2 << pbits) < ncolors && pbits < 7) pbits++;
  const int table_n = 2 << pbits;
  out->clear();
  out->reserve((size_t)w * h / 4 + 1024);
  auto put16 = [&](int v) {
    out->push_back((uint8_t)(v & 255));
    out->push_back((uint8_t)((v >> 8) & 255));
  };
  out->insert(out->end(), {'G', 'I', 'F', '8', '9', 'a'});
  put16(w);
  put16(h);
  out->push_back((uint8_t)(0x80 | (7 << 4) | pbits));  // GCT, 8-bit res
  out->push_back(0);                                    // bg color index
  out->push_back(0);                                    // aspect
  for (int i = 0; i < table_n; i++) {
    if (i < ncolors) {
      out->push_back(pal[i * 3]);
      out->push_back(pal[i * 3 + 1]);
      out->push_back(pal[i * 3 + 2]);
    } else {
      out->push_back(0);
      out->push_back(0);
      out->push_back(0);
    }
  }
  if (transparent_index >= 0) {  // GCE
    out->insert(out->end(), {0x21, 0xF9, 4, 0x01, 0, 0,
                             (uint8_t)transparent_index, 0});
  }
  out->push_back(0x2C);  // image descriptor: full frame, no LCT
  put16(0);
  put16(0);
  put16(w);
  put16(h);
  out->push_back(0);
  int min_code_size = pbits + 1;
  if (min_code_size < 2) min_code_size = 2;
  out->push_back((uint8_t)min_code_size);
  BitWriter bw;
  gif_lzw_encode(indices.data(), indices.size(), min_code_size, &bw);
  for (size_t i = 0; i < bw.bytes.size(); i += 255) {
    const size_t bl = std::min<size_t>(255, bw.bytes.size() - i);
    out->push_back((uint8_t)bl);
    out->insert(out->end(), bw.bytes.begin() + i, bw.bytes.begin() + i + bl);
  }
  out->push_back(0);     // block terminator
  out->push_back(0x3B);  // trailer
  (void)err;
  return true;
}

// ---------------------------------------------------------------- TIFF ------
//
// The needed slice of libtiff's (stable, versioned LIBTIFF_4.0) C ABI is
// declared by hand, so only its runtime .so is needed (the system's or
// Pillow's wheel's): opaque TIFF*, memory-client open, RGBA-oriented read,
// strip write.

extern "C" {
typedef struct tiff TIFF;
typedef int64_t tiff_msize_t;   // tmsize_t: ptrdiff_t on LP64
typedef uint64_t tiff_off_t;    // toff_t
typedef void* tiff_handle_t;    // thandle_t
typedef tiff_msize_t (*TIFFReadWriteProc)(tiff_handle_t, void*, tiff_msize_t);
typedef tiff_off_t (*TIFFSeekProc)(tiff_handle_t, tiff_off_t, int);
typedef int (*TIFFCloseProc)(tiff_handle_t);
typedef tiff_off_t (*TIFFSizeProc)(tiff_handle_t);
typedef int (*TIFFMapFileProc)(tiff_handle_t, void**, tiff_off_t*);
typedef void (*TIFFUnmapFileProc)(tiff_handle_t, void*, tiff_off_t);
typedef void (*TIFFErrorHandler)(const char*, const char*, va_list);
TIFF* TIFFClientOpen(const char*, const char*, tiff_handle_t,
                     TIFFReadWriteProc, TIFFReadWriteProc, TIFFSeekProc,
                     TIFFCloseProc, TIFFSizeProc, TIFFMapFileProc,
                     TIFFUnmapFileProc);
void TIFFClose(TIFF*);
int TIFFGetField(TIFF*, uint32_t, ...);
int TIFFSetField(TIFF*, uint32_t, ...);
int TIFFReadRGBAImageOriented(TIFF*, uint32_t, uint32_t, uint32_t*, int, int);
int TIFFReadScanline(TIFF*, void*, uint32_t, uint16_t);
int TIFFIsTiled(TIFF*);
tiff_msize_t TIFFWriteEncodedStrip(TIFF*, uint32_t, void*, tiff_msize_t);
TIFFErrorHandler TIFFSetErrorHandler(TIFFErrorHandler);
TIFFErrorHandler TIFFSetWarningHandler(TIFFErrorHandler);
}

// tag constants (tiff.h values; the TIFF 6.0 spec, not a private ABI)
enum : uint32_t {
  kTagImageWidth = 256,
  kTagImageLength = 257,
  kTagBitsPerSample = 258,
  kTagCompression = 259,
  kTagPhotometric = 262,
  kTagSamplesPerPixel = 277,
  kTagRowsPerStrip = 278,
  kTagPlanarConfig = 284,
  kTagOrientation = 274,
  kTagExtraSamples = 338,
};
enum : int {
  kCompressionLZW = 5,
  kPhotometricMinIsBlack = 1,
  kPhotometricRGB = 2,
  kPlanarContig = 1,
  kOrientTopLeft = 1,
  kExtraUnassAlpha = 2,
};

struct TiffMemR {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

tiff_msize_t tiffr_read(tiff_handle_t h, void* buf, tiff_msize_t n) {
  auto* m = static_cast<TiffMemR*>(h);
  if (m->pos >= m->size) return 0;
  const size_t take = std::min((size_t)n, m->size - m->pos);
  std::memcpy(buf, m->data + m->pos, take);
  m->pos += take;
  return (tiff_msize_t)take;
}
tiff_msize_t tiffr_write(tiff_handle_t, void*, tiff_msize_t) { return 0; }
tiff_off_t tiffr_seek(tiff_handle_t h, tiff_off_t off, int whence) {
  auto* m = static_cast<TiffMemR*>(h);
  size_t base = (whence == 1) ? m->pos : (whence == 2) ? m->size : 0;
  m->pos = base + (size_t)off;
  return (tiff_off_t)m->pos;
}
int tiffr_close(tiff_handle_t) { return 0; }
tiff_off_t tiffr_size(tiff_handle_t h) {
  return (tiff_off_t)static_cast<TiffMemR*>(h)->size;
}
int tiff_map_none(tiff_handle_t, void**, tiff_off_t*) { return 0; }
void tiff_unmap_none(tiff_handle_t, void*, tiff_off_t) {}

struct TiffMemW {
  std::vector<uint8_t>* out;
  size_t pos;
};

tiff_msize_t tiffw_read(tiff_handle_t h, void* buf, tiff_msize_t n) {
  auto* m = static_cast<TiffMemW*>(h);
  if (m->pos >= m->out->size()) return 0;
  const size_t take = std::min((size_t)n, m->out->size() - m->pos);
  std::memcpy(buf, m->out->data() + m->pos, take);
  m->pos += take;
  return (tiff_msize_t)take;
}
tiff_msize_t tiffw_write(tiff_handle_t h, void* buf, tiff_msize_t n) {
  auto* m = static_cast<TiffMemW*>(h);
  if (m->pos + (size_t)n > m->out->size()) m->out->resize(m->pos + (size_t)n);
  std::memcpy(m->out->data() + m->pos, buf, (size_t)n);
  m->pos += (size_t)n;
  return n;
}
tiff_off_t tiffw_seek(tiff_handle_t h, tiff_off_t off, int whence) {
  auto* m = static_cast<TiffMemW*>(h);
  size_t base = (whence == 1) ? m->pos : (whence == 2) ? m->out->size() : 0;
  m->pos = base + (size_t)off;
  if (m->pos > m->out->size()) m->out->resize(m->pos);
  return (tiff_off_t)m->pos;
}
int tiffw_close(tiff_handle_t) { return 0; }
tiff_off_t tiffw_size(tiff_handle_t h) {
  return (tiff_off_t)static_cast<TiffMemW*>(h)->out->size();
}

void tiff_quiet(const char*, const char*, va_list) {}

bool tiff_decode_buf(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                     int* w, int* h, int* c, std::string* err) {
  TiffMemR m{buf, len, 0};
  TIFF* tif = TIFFClientOpen("mem", "rm", &m, tiffr_read, tiffr_write,
                             tiffr_seek, tiffr_close, tiffr_size,
                             tiff_map_none, tiff_unmap_none);
  if (!tif) {
    *err = "invalid tiff";
    return false;
  }
  uint32_t W = 0, H = 0;
  uint16_t spp = 0, bps = 0, photo = 0, planar = 0;
  TIFFGetField(tif, kTagImageWidth, &W);
  TIFFGetField(tif, kTagImageLength, &H);
  if (!TIFFGetField(tif, kTagSamplesPerPixel, &spp)) spp = 1;
  if (!TIFFGetField(tif, kTagBitsPerSample, &bps)) bps = 1;
  if (!TIFFGetField(tif, kTagPhotometric, &photo)) photo = 0;
  if (!TIFFGetField(tif, kTagPlanarConfig, &planar)) planar = kPlanarContig;
  if (W == 0 || H == 0 || (uint64_t)W * H > (uint64_t)100 * 1000 * 1000) {
    TIFFClose(tif);
    *err = "invalid tiff dimensions";
    return false;
  }
  uint16_t orient = 0;
  if (!TIFFGetField(tif, kTagOrientation, &orient)) orient = kOrientTopLeft;
  // Direct scanline path for the common 8-bit contiguous RGB(A) top-left
  // layout: the RGBA convenience reader PREMULTIPLIES unassociated alpha,
  // which would corrupt straight-alpha pixels on a plain decode->encode
  // trip. Non-top-left orientations fall through to the oriented reader
  // (raw scanlines would come back rotated/flipped).
  // spp==4 additionally requires ExtraSamples to declare UNASSOCIATED
  // alpha: raw scanlines of an associated-alpha (premultiplied) file would
  // ship premultiplied planes as straight alpha — those files take
  // TIFFReadRGBAImageOriented, which un-premultiplies correctly.
  bool straight_alpha = true;
  if (spp == 4) {
    uint16_t nextra = 0;
    uint16_t* extra = nullptr;
    straight_alpha = TIFFGetField(tif, kTagExtraSamples, &nextra, &extra) &&
                     nextra >= 1 && extra != nullptr &&
                     extra[0] == kExtraUnassAlpha;
  }
  if (!TIFFIsTiled(tif) && bps == 8 && planar == kPlanarContig &&
      photo == kPhotometricRGB && (spp == 3 || (spp == 4 && straight_alpha)) &&
      orient == kOrientTopLeft) {
    *w = (int)W;
    *h = (int)H;
    *c = (int)spp;
    out->resize((size_t)W * H * spp);
    for (uint32_t row = 0; row < H; row++) {
      if (TIFFReadScanline(tif, out->data() + (size_t)row * W * spp, row, 0) < 0) {
        TIFFClose(tif);
        *err = "tiff decode failed";
        return false;
      }
    }
    TIFFClose(tif);
    return true;
  }
  std::vector<uint32_t> raster((size_t)W * H);
  if (!TIFFReadRGBAImageOriented(tif, W, H, raster.data(), kOrientTopLeft, 0)) {
    TIFFClose(tif);
    *err = "tiff decode failed";
    return false;
  }
  TIFFClose(tif);
  // raster packs ABGR in host order: R in the low byte
  bool has_alpha = false;
  if (spp >= 4) {
    for (size_t i = 0, n = (size_t)W * H; i < n; i++)
      if ((raster[i] >> 24) != 255) { has_alpha = true; break; }
  }
  *w = (int)W;
  *h = (int)H;
  *c = has_alpha ? 4 : 3;
  out->resize((size_t)W * H * (*c));
  uint8_t* dst = out->data();
  if (has_alpha) {
    for (size_t i = 0, n = (size_t)W * H; i < n; i++) {
      const uint32_t v = raster[i];
      dst[i * 4 + 0] = (uint8_t)(v & 255);
      dst[i * 4 + 1] = (uint8_t)((v >> 8) & 255);
      dst[i * 4 + 2] = (uint8_t)((v >> 16) & 255);
      dst[i * 4 + 3] = (uint8_t)(v >> 24);
    }
  } else {
    for (size_t i = 0, n = (size_t)W * H; i < n; i++) {
      const uint32_t v = raster[i];
      dst[i * 3 + 0] = (uint8_t)(v & 255);
      dst[i * 3 + 1] = (uint8_t)((v >> 8) & 255);
      dst[i * 3 + 2] = (uint8_t)((v >> 16) & 255);
    }
  }
  return true;
}

bool tiff_probe_buf(const uint8_t* buf, size_t len, int* w, int* h, int* c) {
  TiffMemR m{buf, len, 0};
  TIFF* tif = TIFFClientOpen("mem", "rm", &m, tiffr_read, tiffr_write,
                             tiffr_seek, tiffr_close, tiffr_size,
                             tiff_map_none, tiff_unmap_none);
  if (!tif) return false;
  uint32_t W = 0, H = 0;
  uint16_t spp = 0;
  TIFFGetField(tif, kTagImageWidth, &W);
  TIFFGetField(tif, kTagImageLength, &H);
  if (!TIFFGetField(tif, kTagSamplesPerPixel, &spp)) spp = 1;
  TIFFClose(tif);
  if (W == 0 || H == 0) return false;
  *w = (int)W;
  *h = (int)H;
  *c = (spp >= 4) ? 4 : (spp >= 3 ? 3 : 1);
  return true;
}

bool tiff_encode_buf(const uint8_t* pix, int w, int h, int c,
                     std::vector<uint8_t>* out, std::string* err) {
  out->clear();
  TiffMemW m{out, 0};
  TIFF* tif = TIFFClientOpen("mem", "wm", &m, tiffw_read, tiffw_write,
                             tiffw_seek, tiffw_close, tiffw_size,
                             tiff_map_none, tiff_unmap_none);
  if (!tif) {
    *err = "tiff writer open failed";
    return false;
  }
  TIFFSetField(tif, kTagImageWidth, (uint32_t)w);
  TIFFSetField(tif, kTagImageLength, (uint32_t)h);
  TIFFSetField(tif, kTagBitsPerSample, 8);
  TIFFSetField(tif, kTagSamplesPerPixel, c);
  TIFFSetField(tif, kTagRowsPerStrip, (uint32_t)h);  // single strip
  TIFFSetField(tif, kTagCompression, kCompressionLZW);
  TIFFSetField(tif, kTagPhotometric,
               (c == 1) ? kPhotometricMinIsBlack : kPhotometricRGB);
  TIFFSetField(tif, kTagPlanarConfig, kPlanarContig);
  TIFFSetField(tif, kTagOrientation, kOrientTopLeft);
  if (c == 4) {
    uint16_t extra[1] = {kExtraUnassAlpha};
    TIFFSetField(tif, kTagExtraSamples, 1, extra);
  }
  const tiff_msize_t nbytes = (tiff_msize_t)((size_t)w * h * c);
  if (TIFFWriteEncodedStrip(tif, 0, const_cast<uint8_t*>(pix), nbytes) < 0) {
    TIFFClose(tif);
    *err = "tiff encode failed";
    return false;
  }
  TIFFClose(tif);  // writes the directory
  return true;
}


// ------------------------------------------------------------ bindings ------

PyObject* py_decode(PyObject*, PyObject* args) {
  Py_buffer view;
  const char* fmt;
  int scale_denom = 1;
  if (!PyArg_ParseTuple(args, "y*s|i", &view, &fmt, &scale_denom)) return nullptr;
  const uint8_t* buf = static_cast<const uint8_t*>(view.buf);
  size_t len = view.len;
  std::vector<uint8_t> out;
  int w = 0, h = 0, c = 0, orientation = 0;
  std::string err;
  bool ok = false;
  std::string f(fmt);
  Py_BEGIN_ALLOW_THREADS
  if (f == "jpeg") {
    ok = jpeg_decode(buf, len, &out, &w, &h, &c, &err, scale_denom);
    if (ok) orientation = exif_orientation(buf, len);
  } else if (f == "png") {
    ok = png_decode_buf(buf, len, &out, &w, &h, &c, &err);
  } else if (f == "webp") {
    ok = webp_decode_buf(buf, len, &out, &w, &h, &c, &err);
  } else if (f == "gif") {
    ok = gif_decode_buf(buf, len, &out, &w, &h, &c, &err);
  } else if (f == "tiff") {
    ok = tiff_decode_buf(buf, len, &out, &w, &h, &c, &err);
  } else {
    err = "unsupported format: " + f;
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&view);
  if (!ok) {
    PyErr_SetString(PyExc_ValueError, err.empty() ? "decode failed" : err.c_str());
    return nullptr;
  }
  PyObject* bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(out.data()), (Py_ssize_t)out.size());
  if (!bytes) return nullptr;
  return Py_BuildValue("(Niiiii)", bytes, h, w, c, orientation, (c == 4) ? 1 : 0);
}

PyObject* py_encode(PyObject*, PyObject* args) {
  Py_buffer view;
  int w, h, c, quality, compression, progressive;
  int palette = 0, speed = 0;
  const char* fmt;
  if (!PyArg_ParseTuple(args, "y*iiisiii|ii", &view, &h, &w, &c, &fmt,
                        &quality, &compression, &progressive, &palette,
                        &speed))
    return nullptr;
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
  bool ok = false;
  std::string f(fmt);
  Py_BEGIN_ALLOW_THREADS
  if (f == "jpeg") {
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
  } else if (f == "png") {
    if (progressive || palette || speed > 0)
      ok = png_encode_full(pix, w, h, c, compression, progressive != 0,
                           palette != 0, speed, &out, &err);
    else
      ok = png_encode_buf(pix, w, h, c, &out, &err);
  } else if (f == "webp") {
    const uint8_t* src = pix;
    int cc = c;
    if (c == 1) {
      flat.resize((size_t)w * h * 3);
      for (size_t i = 0, n = (size_t)w * h; i < n; i++)
        flat[i * 3] = flat[i * 3 + 1] = flat[i * 3 + 2] = pix[i];
      src = flat.data();
      cc = 3;
    }
    ok = webp_encode_buf(src, w, h, cc, quality, &out, &err);
  } else if (f == "gif") {
    const uint8_t* src = pix;
    int cc = c;
    if (c == 1) {
      flat.resize((size_t)w * h * 3);
      for (size_t i = 0, n = (size_t)w * h; i < n; i++)
        flat[i * 3] = flat[i * 3 + 1] = flat[i * 3 + 2] = pix[i];
      src = flat.data();
      cc = 3;
    }
    ok = gif_encode_buf(src, w, h, cc, &out, &err);
  } else if (f == "tiff") {
    ok = tiff_encode_buf(pix, w, h, c, &out, &err);
  } else {
    err = "unsupported format: " + f;
  }
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
  std::string f(fmt);
  Py_BEGIN_ALLOW_THREADS
  if (f == "jpeg") {
    ok = jpeg_probe(buf, len, &w, &h, &c, subsampling);
    if (ok) orientation = exif_orientation(buf, len);
  } else if (f == "png") {
    ok = png_probe_buf(buf, len, &w, &h, &c);
  } else if (f == "webp") {
    WebPBitstreamFeatures feat;
    if (WebPGetFeatures(buf, len, &feat) == VP8_STATUS_OK) {
      w = feat.width; h = feat.height; c = feat.has_alpha ? 4 : 3;
      ok = true;
    }
  } else if (f == "gif") {
    ok = gif_probe_buf(buf, len, &w, &h, &c);
  } else if (f == "tiff") {
    ok = tiff_probe_buf(buf, len, &w, &h, &c);
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&view);
  if (!ok) {
    PyErr_SetString(PyExc_ValueError, "probe failed");
    return nullptr;
  }
  return Py_BuildValue("(iiiiis)", w, h, c, (c == 4) ? 1 : 0, orientation,
                       subsampling);
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
     "encode(buf, h, w, c, fmt, quality, compression, progressive[, palette, speed]) -> bytes"},
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
    "Native JPEG/PNG/WEBP/GIF/TIFF codecs of the PyTorch/CUDA port (GIL-released)", -1, methods,
};

}  // namespace

// The library each format links, as native/build.py passes it
#ifndef ITPU_LINKED
#define ITPU_LINKED ""
#endif

PyMODINIT_FUNC PyInit__itpu_torch_codecs(void) {
  // silence libtiff's stderr chatter: a malformed input is an expected,
  // gracefully failed case, not something to log
  TIFFSetErrorHandler(tiff_quiet);
  TIFFSetWarningHandler(tiff_quiet);
  PyObject* m = PyModule_Create(&moduledef);
  if (m) PyModule_AddStringConstant(m, "FORMATS", "jpeg,png,webp,gif,tiff");
  if (m) PyModule_AddStringConstant(m, "LINKED", ITPU_LINKED);
  // the linked libpng's version (e.g. 10639 for 1.6.39): its simplified
  // reader's 16-bit linear -> 8-bit sRGB rounding differs across releases
  if (m) PyModule_AddIntConstant(m, "LIBPNG", (long)png_access_version_number());
  return m;
}

// Native host-side data loader of x_detector_tpu_torch.
//
// A copy of the JAX package's loader (the same stream, bit for bit, where
// libjpeg decodes), with a second JPEG decoder for machines without
// libjpeg. A self-contained replacement for a tf.data input pipeline:
//
//   * TFRecord framing: {uint64 length, u32 masked-crc32c(length),
//     bytes data[length], u32 masked-crc32c(data)}.  CRCs are verified with
//     a software CRC32C (Castagnoli).
//   * tf.train.Example parsing: a minimal protobuf wire-format reader for
//     the fixed feature schema written by data/tfrecord.py (bytes_list /
//     packed+unpacked float_list / int64_list).  No protoc codegen needed.
//   * JPEG decode to RGB uint8, bilinear resize to a square canvas. The
//     decoder is chosen at build time: libjpeg (default), or, with
//     -DXDET_NVJPEG, nvJPEG from the CUDA toolkit (Huffman decoding on the
//     host, the IDCT on the GPU, then libjpeg's chroma upsampling and
//     colour conversion on the host; each worker thread keeps its own
//     nvJPEG state and stream on the device that
//     xdet_loader_set_cuda_device names).
//   * A **position-addressable** streaming design: at creation every shard
//     is framing-scanned into a record index {shard, offset, length}; each
//     epoch is a seeded exact permutation of that index; worker thread i
//     decodes global positions ≡ i (mod T) into its own ordered queue and
//     batches are assembled round-robin — so the batch stream is bitwise
//     deterministic regardless of thread timing, and resume is O(1): the
//     loader's state is a single integer (examples consumed), restored by
//     passing ``start_example`` at creation (deterministic data-iterator
//     state for checkpoint/resume).
//
// Built at first use by data/native_loader.py into build/torch_loader/.

#include <csetjmp>
#include <cstddef>
#include <cstdio>

#ifdef XDET_NVJPEG
#include <cuda_runtime.h>
#include <nvjpeg.h>
#else
#include <jpeglib.h>
#endif

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), table-driven; TFRecord "masked" variant.
// ---------------------------------------------------------------------------

uint32_t kCrcTable[256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c >> 1) ^ ((c & 1) ? 0x82f63b78u : 0u);
      kCrcTable[i] = c;
    }
  }
} crc_init;

uint32_t Crc32c(const uint8_t* data, size_t n) {
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; ++i)
    c = kCrcTable[(c ^ data[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

uint32_t MaskedCrc(const uint8_t* data, size_t n) {
  uint32_t crc = Crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// ---------------------------------------------------------------------------
// Protobuf wire-format primitives.
// ---------------------------------------------------------------------------

struct Slice {
  const uint8_t* p;
  size_t n;
};

bool ReadVarint(Slice* s, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (s->n > 0 && shift < 64) {
    uint8_t b = *s->p;
    s->p++; s->n--;
    v |= uint64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) { *out = v; return true; }
    shift += 7;
  }
  return false;
}

// Reads one field header; returns field number, wire type.
bool ReadTag(Slice* s, uint32_t* field, uint32_t* wire) {
  uint64_t tag;
  if (!ReadVarint(s, &tag)) return false;
  *field = uint32_t(tag >> 3);
  *wire = uint32_t(tag & 7);
  return true;
}

bool SkipField(Slice* s, uint32_t wire) {
  uint64_t tmp;
  switch (wire) {
    case 0: return ReadVarint(s, &tmp);                      // varint
    case 1: if (s->n < 8) return false; s->p += 8; s->n -= 8; return true;
    case 2: {                                                // length-delim
      if (!ReadVarint(s, &tmp) || s->n < tmp) return false;
      s->p += tmp; s->n -= tmp; return true;
    }
    case 5: if (s->n < 4) return false; s->p += 4; s->n -= 4; return true;
    default: return false;
  }
}

bool ReadLenDelim(Slice* s, Slice* out) {
  uint64_t len;
  if (!ReadVarint(s, &len) || s->n < len) return false;
  out->p = s->p; out->n = len;
  s->p += len; s->n -= len;
  return true;
}

// ---------------------------------------------------------------------------
// tf.train.Example subset parser.
// ---------------------------------------------------------------------------

struct ParsedExample {
  std::string encoded;          // image/encoded
  std::string image_id;         // image/id
  std::vector<float> ymin, xmin, ymax, xmax;
  std::vector<int64_t> labels, difficult;
};

void ParseFloatList(Slice body, std::vector<float>* out) {
  // FloatList { repeated float value = 1; } — packed or unpacked.
  uint32_t field, wire;
  Slice s = body;
  while (s.n > 0 && ReadTag(&s, &field, &wire)) {
    if (field == 1 && wire == 2) {               // packed
      Slice packed;
      if (!ReadLenDelim(&s, &packed)) return;
      while (packed.n >= 4) {
        float f;
        memcpy(&f, packed.p, 4);
        out->push_back(f);
        packed.p += 4; packed.n -= 4;
      }
    } else if (field == 1 && wire == 5) {        // unpacked
      if (s.n < 4) return;
      float f;
      memcpy(&f, s.p, 4);
      out->push_back(f);
      s.p += 4; s.n -= 4;
    } else if (!SkipField(&s, wire)) {
      return;
    }
  }
}

void ParseInt64List(Slice body, std::vector<int64_t>* out) {
  uint32_t field, wire;
  Slice s = body;
  while (s.n > 0 && ReadTag(&s, &field, &wire)) {
    if (field == 1 && wire == 2) {               // packed
      Slice packed;
      if (!ReadLenDelim(&s, &packed)) return;
      uint64_t v;
      while (packed.n > 0 && ReadVarint(&packed, &v))
        out->push_back(int64_t(v));
    } else if (field == 1 && wire == 0) {
      uint64_t v;
      if (!ReadVarint(&s, &v)) return;
      out->push_back(int64_t(v));
    } else if (!SkipField(&s, wire)) {
      return;
    }
  }
}

void ParseBytesList(Slice body, std::string* out) {
  uint32_t field, wire;
  Slice s = body;
  while (s.n > 0 && ReadTag(&s, &field, &wire)) {
    if (field == 1 && wire == 2) {
      Slice v;
      if (!ReadLenDelim(&s, &v)) return;
      out->assign(reinterpret_cast<const char*>(v.p), v.n);
      return;                                    // first value only
    }
    if (!SkipField(&s, wire)) return;
  }
}

// Feature { oneof kind { BytesList bytes_list=1; FloatList float_list=2;
//                        Int64List int64_list=3; } }
void DispatchFeature(const std::string& key, Slice feat, ParsedExample* ex) {
  uint32_t field, wire;
  Slice s = feat;
  while (s.n > 0 && ReadTag(&s, &field, &wire)) {
    Slice body;
    if (wire != 2 || !ReadLenDelim(&s, &body)) {
      if (!SkipField(&s, wire)) return;
      continue;
    }
    if (field == 1) {                            // bytes_list
      if (key == "image/encoded") ParseBytesList(body, &ex->encoded);
      else if (key == "image/id") ParseBytesList(body, &ex->image_id);
    } else if (field == 2) {                     // float_list
      if (key == "image/object/bbox/ymin") ParseFloatList(body, &ex->ymin);
      else if (key == "image/object/bbox/xmin") ParseFloatList(body, &ex->xmin);
      else if (key == "image/object/bbox/ymax") ParseFloatList(body, &ex->ymax);
      else if (key == "image/object/bbox/xmax") ParseFloatList(body, &ex->xmax);
    } else if (field == 3) {                     // int64_list
      if (key == "image/object/bbox/label") ParseInt64List(body, &ex->labels);
      else if (key == "image/object/bbox/difficult")
        ParseInt64List(body, &ex->difficult);
    }
  }
}

bool ParseExample(const uint8_t* data, size_t n, ParsedExample* ex) {
  // Example { Features features = 1; }
  // Features { map<string, Feature> feature = 1; }  (map entry: key=1, value=2)
  Slice s{data, n};
  uint32_t field, wire;
  while (s.n > 0 && ReadTag(&s, &field, &wire)) {
    if (field == 1 && wire == 2) {               // features
      Slice feats;
      if (!ReadLenDelim(&s, &feats)) return false;
      uint32_t f2, w2;
      while (feats.n > 0 && ReadTag(&feats, &f2, &w2)) {
        if (f2 == 1 && w2 == 2) {                // one map entry
          Slice entry;
          if (!ReadLenDelim(&feats, &entry)) return false;
          std::string key;
          Slice value{nullptr, 0};
          uint32_t f3, w3;
          while (entry.n > 0 && ReadTag(&entry, &f3, &w3)) {
            Slice body;
            if (w3 != 2 || !ReadLenDelim(&entry, &body)) {
              if (!SkipField(&entry, w3)) return false;
              continue;
            }
            if (f3 == 1)
              key.assign(reinterpret_cast<const char*>(body.p), body.n);
            else if (f3 == 2)
              value = body;
          }
          if (!key.empty() && value.p) DispatchFeature(key, value, ex);
        } else if (!SkipField(&feats, w2)) {
          return false;
        }
      }
    } else if (!SkipField(&s, wire)) {
      return false;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// JPEG decode + bilinear resize.
// ---------------------------------------------------------------------------

bool IsJpeg(const std::string& bytes) {
  return bytes.size() >= 4 && uint8_t(bytes[0]) == 0xFF &&
         uint8_t(bytes[1]) == 0xD8;
}

// One decoded component before upsampling: ``width`` x ``height`` samples,
// rows ``pitch`` bytes apart.
struct Plane {
  const uint8_t* p;
  int width, height;
  size_t pitch;
};

// A chroma plane upsampled to w x h as libjpeg's default decode does it
// (jdsample.c, do_fancy_upsampling): full size copied; 2:1 across
// (4:2:2) and 2:1 both ways (4:2:0) by its "fancy" triangle filter, each
// output 3/4 of the nearer sample and 1/4 of the next (9/16, 3/16, 3/16,
// 1/16 in 2D) with its alternating rounding biases, the rows above the
// first and below the last repeating them; a plane 2 samples wide or less
// by replication. ``hx``, ``vx``: the horizontal and vertical factors.
void UpsampleChroma(const Plane& c, int hx, int vx, int w, int h,
                    uint8_t* out) {
  const int cw = c.width;
  auto row = [&c](int r) {
    return c.p + size_t(std::min(std::max(r, 0), c.height - 1)) * c.pitch;
  };
  std::vector<int> sum(cw);
  std::vector<uint8_t> wide(2 * size_t(cw));
  for (int y = 0; y < h; ++y) {
    uint8_t* dst = out + size_t(y) * w;
    const uint8_t* in0 = row(y / vx);
    if (hx == 1) {                                   // 4:4:4
      memcpy(dst, in0, w);
      continue;
    }
    if (cw <= 2) {                                   // plain replication
      for (int x = 0; x < w; ++x) dst[x] = in0[x / 2];
      continue;
    }
    uint8_t* o = wide.data();
    if (vx == 1) {                                   // h2v1
      int v = in0[0];
      o[0] = uint8_t(v);
      o[1] = uint8_t((v * 3 + in0[1] + 2) >> 2);
      for (int i = 1; i < cw - 1; ++i) {
        v = in0[i] * 3;
        o[2 * i] = uint8_t((v + in0[i - 1] + 1) >> 2);
        o[2 * i + 1] = uint8_t((v + in0[i + 1] + 2) >> 2);
      }
      v = in0[cw - 1];
      o[2 * cw - 2] = uint8_t((v * 3 + in0[cw - 2] + 1) >> 2);
      o[2 * cw - 1] = uint8_t(v);
    } else {                                         // h2v2
      const uint8_t* in1 = row(y % 2 ? y / 2 + 1 : y / 2 - 1);
      for (int i = 0; i < cw; ++i) sum[i] = in0[i] * 3 + in1[i];
      o[0] = uint8_t((sum[0] * 4 + 8) >> 4);
      o[1] = uint8_t((sum[0] * 3 + sum[1] + 7) >> 4);
      for (int i = 1; i < cw - 1; ++i) {
        o[2 * i] = uint8_t((sum[i] * 3 + sum[i - 1] + 8) >> 4);
        o[2 * i + 1] = uint8_t((sum[i] * 3 + sum[i + 1] + 7) >> 4);
      }
      o[2 * cw - 2] = uint8_t((sum[cw - 1] * 3 + sum[cw - 2] + 8) >> 4);
      o[2 * cw - 1] = uint8_t((sum[cw - 1] * 4 + 7) >> 4);
    }
    memcpy(dst, o, w);
  }
}

// libjpeg's fixed-point YCbCr -> RGB tables (jdcolor.c, 16 fraction bits):
// R = Y + cr_r[Cr], B = Y + cb_b[Cb], G = Y + ((cb_g[Cb] + cr_g[Cr]) >> 16).
constexpr int kYccBits = 16;
int64_t YccFix(double x) { return int64_t(x * (1 << kYccBits) + 0.5); }
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t half = int64_t(1) << (kYccBits - 1);
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = int((YccFix(1.40200) * x + half) >> kYccBits);
      cb_b[i] = int((YccFix(1.77200) * x + half) >> kYccBits);
      cr_g[i] = -YccFix(0.71414) * x;
      cb_g[i] = -YccFix(0.34414) * x + half;
    }
  }
} ycc_tables;

// Y (and Cb, Cr, each ``hx`` x ``vx`` times smaller) to w x h RGB, as
// libjpeg gives it: the chroma upsampled by UpsampleChroma, then
// ycc_tables, clamped to [0, 255]. One plane is greyscale: R = G = B = Y.
void PlanesToRgb(const Plane* planes, int nplanes, int hx, int vx, int w,
                 int h, uint8_t* rgb) {
  const YccTables& t = ycc_tables;
  auto clamp = [](int v) { return uint8_t(std::min(std::max(v, 0), 255)); };
  if (nplanes == 1) {
    for (int y = 0; y < h; ++y) {
      const uint8_t* yr = planes[0].p + size_t(y) * planes[0].pitch;
      uint8_t* o = rgb + size_t(y) * w * 3;
      for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] =
          yr[x];
    }
    return;
  }
  std::vector<uint8_t> cb(size_t(w) * h), cr(size_t(w) * h);
  UpsampleChroma(planes[1], hx, vx, w, h, cb.data());
  UpsampleChroma(planes[2], hx, vx, w, h, cr.data());
  for (int y = 0; y < h; ++y) {
    const uint8_t* yr = planes[0].p + size_t(y) * planes[0].pitch;
    const uint8_t* b = cb.data() + size_t(y) * w;
    const uint8_t* r = cr.data() + size_t(y) * w;
    uint8_t* o = rgb + size_t(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      const int v = yr[x];
      o[3 * x] = clamp(v + t.cr_r[r[x]]);
      o[3 * x + 1] = clamp(
          v + int((t.cb_g[b[x]] + t.cr_g[r[x]]) >> kYccBits));
      o[3 * x + 2] = clamp(v + t.cb_b[b[x]]);
    }
  }
}

#ifdef XDET_NVJPEG

std::atomic<int> g_cuda_device{0};

// One thread's nvJPEG handle, decode state, stream and device buffer,
// made at the thread's first decode and released when the thread ends.
struct NvjpegContext {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dbuf = nullptr;
  size_t dcap = 0;
  std::vector<uint8_t> planes;   // the decoded planes, on the host
  int status = -1;   // -1 not made yet, 0 ready, else the failing call's code

  void Init() {
    int err = int(cudaSetDevice(g_cuda_device.load()));
    if (!err) err = 1000 + int(nvjpegCreateSimple(&handle));
    if (err == 1000) err = 2000 + int(nvjpegJpegStateCreate(handle, &state));
    if (err == 2000)
      err = 3000 + int(cudaStreamCreateWithFlags(&stream,
                                                 cudaStreamNonBlocking));
    status = err == 3000 ? 0 : err;
  }
  ~NvjpegContext() {
    if (dbuf) cudaFree(dbuf);
    if (stream) cudaStreamDestroy(stream);
    if (state) nvjpegJpegStateDestroy(state);
    if (handle) nvjpegDestroy(handle);
  }
};

NvjpegContext& ThreadContext() {
  thread_local NvjpegContext ctx;
  if (ctx.status < 0) ctx.Init();
  return ctx;
}

bool DecodeJpeg(const std::string& bytes, std::vector<uint8_t>* rgb,
                int* width, int* height) {
  if (!IsJpeg(bytes)) return false;
  NvjpegContext& ctx = ThreadContext();
  if (ctx.status != 0) return false;
  const auto* data = reinterpret_cast<const unsigned char*>(bytes.data());
  int ncomp = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(ctx.handle, data, bytes.size(), &ncomp,
                         &subsampling, widths, heights) !=
      NVJPEG_STATUS_SUCCESS)
    return false;
  const int w = widths[0], h = heights[0];
  if (w <= 0 || h <= 0) return false;
  // Greyscale, 4:4:4, 4:2:2 and 4:2:0 come back as planes, upsampled and
  // converted on the host as libjpeg does it (PlanesToRgb): nvJPEG's own
  // RGB replicates subsampled chroma where libjpeg interpolates it. Other
  // samplings take nvJPEG's RGB.
  int hx = 0, vx = 0, nplanes = 3;
  switch (subsampling) {
    case NVJPEG_CSS_GRAY: hx = vx = nplanes = 1; break;
    case NVJPEG_CSS_444: hx = vx = 1; break;
    case NVJPEG_CSS_422: hx = 2; vx = 1; break;
    case NVJPEG_CSS_420: hx = vx = 2; break;
    default: break;
  }
  bool planar = hx > 0 && ncomp == nplanes;
  for (int c = 1; planar && c < nplanes; ++c)
    planar = widths[c] == (w + hx - 1) / hx &&
             heights[c] == (h + vx - 1) / vx;
  size_t offsets[3] = {0, 0, 0}, size = size_t(w) * h * 3;
  if (planar) {
    size = 0;
    for (int c = 0; c < nplanes; ++c) {
      offsets[c] = size;
      size += size_t(widths[c]) * heights[c];
    }
  }
  if (size > ctx.dcap) {
    if (ctx.dbuf) cudaFree(ctx.dbuf);
    ctx.dbuf = nullptr;
    ctx.dcap = 0;
    if (cudaMalloc(reinterpret_cast<void**>(&ctx.dbuf), size) != cudaSuccess)
      return false;
    ctx.dcap = size;
  }
  nvjpegImage_t out{};
  if (planar) {
    for (int c = 0; c < nplanes; ++c) {
      out.channel[c] = ctx.dbuf + offsets[c];
      out.pitch[c] = size_t(widths[c]);
    }
  } else {
    out.channel[0] = ctx.dbuf;
    out.pitch[0] = size_t(w) * 3;
  }
  const nvjpegOutputFormat_t format = !planar ? NVJPEG_OUTPUT_RGBI
      : nplanes == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV;
  if (nvjpegDecode(ctx.handle, ctx.state, data, bytes.size(), format, &out,
                   ctx.stream) != NVJPEG_STATUS_SUCCESS)
    return false;
  std::vector<uint8_t>& host = planar ? ctx.planes : *rgb;
  host.resize(size);
  if (cudaMemcpyAsync(host.data(), ctx.dbuf, size, cudaMemcpyDeviceToHost,
                      ctx.stream) != cudaSuccess ||
      cudaStreamSynchronize(ctx.stream) != cudaSuccess)
    return false;
  if (planar) {
    Plane planes[3];
    for (int c = 0; c < nplanes; ++c)
      planes[c] = {host.data() + offsets[c], widths[c], heights[c],
                   size_t(widths[c])};
    rgb->resize(size_t(w) * h * 3);
    PlanesToRgb(planes, nplanes, hx, vx, w, h, rgb->data());
  }
  *width = w;
  *height = h;
  return true;
}

#else  // libjpeg

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void JpegErrorExit(j_common_ptr cinfo) {
  // libjpeg's default error_exit calls exit(); longjmp back so one corrupt
  // image is skipped instead of killing the training process.
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

bool DecodeJpeg(const std::string& bytes, std::vector<uint8_t>* rgb,
                int* width, int* height) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = JpegErrorExit;
  if (!IsJpeg(bytes)) return false;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, reinterpret_cast<const unsigned char*>(bytes.data()),
               bytes.size());
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  rgb->resize(size_t(*width) * *height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() + size_t(cinfo.output_scanline) * *width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// libjpeg's own planes (raw_data_out: no upsampling, no colour
// conversion) through PlanesToRgb, for greyscale and YCbCr at 4:4:4, 4:2:2
// and 4:2:0: the route nvJPEG's pixels take, held here to DecodeJpeg's bit
// for bit. False for other images.
bool DecodeJpegPlanes(const std::string& bytes, std::vector<uint8_t>* rgb,
                      int* width, int* height) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  std::vector<uint8_t> bufs[3];
  std::vector<JSAMPROW> rows;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = JpegErrorExit;
  if (!IsJpeg(bytes)) return false;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, reinterpret_cast<const unsigned char*>(bytes.data()),
               bytes.size());
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  const int nc = cinfo.num_components;
  const jpeg_component_info* comp = cinfo.comp_info;
  const int hx = cinfo.max_h_samp_factor / comp[nc - 1].h_samp_factor;
  const int vx = cinfo.max_v_samp_factor / comp[nc - 1].v_samp_factor;
  const bool ok = (nc == 1 && cinfo.jpeg_color_space == JCS_GRAYSCALE) ||
      (nc == 3 && cinfo.jpeg_color_space == JCS_YCbCr &&
       comp[0].h_samp_factor == cinfo.max_h_samp_factor &&
       comp[0].v_samp_factor == cinfo.max_v_samp_factor &&
       comp[1].h_samp_factor == comp[2].h_samp_factor &&
       comp[1].v_samp_factor == comp[2].v_samp_factor &&
       ((hx == 1 && vx == 1) || (hx == 2 && vx <= 2)));
  if (!ok) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.raw_data_out = TRUE;
  jpeg_start_decompress(&cinfo);
  const int lines = cinfo.max_v_samp_factor * DCTSIZE;
  size_t pitch[3];
  for (int c = 0; c < nc; ++c) {
    pitch[c] = size_t(comp[c].width_in_blocks) * DCTSIZE;
    bufs[c].resize(pitch[c] * cinfo.total_iMCU_rows * comp[c].v_samp_factor *
                   DCTSIZE);
  }
  rows.resize(size_t(nc) * lines);
  for (JDIMENSION imcu = 0; cinfo.output_scanline < cinfo.output_height;
       ++imcu) {
    JSAMPARRAY planes[3];
    for (int c = 0; c < nc; ++c) {
      const int n = comp[c].v_samp_factor * DCTSIZE;
      for (int r = 0; r < n; ++r)
        rows[size_t(c) * lines + r] =
            bufs[c].data() + (size_t(imcu) * n + r) * pitch[c];
      planes[c] = rows.data() + size_t(c) * lines;
    }
    jpeg_read_raw_data(&cinfo, planes, lines);
  }
  Plane planes[3];
  for (int c = 0; c < nc; ++c)
    planes[c] = {bufs[c].data(), int(comp[c].downsampled_width),
                 int(comp[c].downsampled_height), pitch[c]};
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  rgb->resize(size_t(*width) * *height * 3);
  PlanesToRgb(planes, nc, hx, vx, *width, *height, rgb->data());
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

#endif  // XDET_NVJPEG

// Resize src (sh x sw) to (dh x dw), writing into dst whose rows are
// ``dst_stride`` pixels wide (dst_stride >= dw; letterbox writes into the
// top-left of a larger zeroed canvas).
void ResizeBilinear(const uint8_t* src, int sh, int sw, float* dst,
                    int dh, int dw, int dst_stride) {
  // float output in [0, 255]; half-pixel-center sampling, clamped.
  // Column taps (offsets in bytes, weights) are precomputed once — the
  // inner loop is then two fused lerps per channel over contiguous rows
  // (the naive per-pixel clamp/index recompute cost ~2x; measured against
  // tf.data's reader on identical records).
  std::vector<int> xo0(dw), xo1(dw);
  std::vector<float> wx(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sw / dw - 0.5f;
    fx = std::max(0.f, std::min(fx, float(sw - 1)));
    int x0 = int(fx);
    xo0[x] = x0 * 3;
    xo1[x] = std::min(x0 + 1, sw - 1) * 3;
    wx[x] = fx - x0;
  }
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sh / dh - 0.5f;
    fy = std::max(0.f, std::min(fy, float(sh - 1)));
    int y0 = int(fy), y1 = std::min(y0 + 1, sh - 1);
    float wy = fy - y0;
    const uint8_t* r0 = src + size_t(y0) * sw * 3;
    const uint8_t* r1 = src + size_t(y1) * sw * 3;
    float* out = dst + size_t(y) * dst_stride * 3;
    for (int x = 0; x < dw; ++x) {
      const uint8_t* p00 = r0 + xo0[x];
      const uint8_t* p01 = r0 + xo1[x];
      const uint8_t* p10 = r1 + xo0[x];
      const uint8_t* p11 = r1 + xo1[x];
      const float w = wx[x];
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] + w * (float(p01[c]) - p00[c]);
        float bot = p10[c] + w * (float(p11[c]) - p10[c]);
        out[x * 3 + c] = top + wy * (bot - top);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Loader: shard reading, worker pool, bounded queue.
// ---------------------------------------------------------------------------

struct DecodedExample {
  std::vector<float> image;       // canvas*canvas*3
  std::vector<float> boxes;       // max_gt*4 (canvas-normalized)
  std::vector<int32_t> labels;    // max_gt
  std::vector<uint8_t> mask;      // max_gt
  std::vector<uint8_t> difficult; // max_gt
  float box_scale[2] = {1.f, 1.f};  // content fraction [fy, fx] (letterbox)
  std::string image_id;
};

// One record's location on disk (the unit of the position index).
struct RecordRef {
  uint32_t shard;
  uint32_t length;
  uint64_t offset;   // of the payload (past the 12-byte frame header)
};

// A single worker's ordered output queue.  Worker i fills it with the
// decoded examples for global positions ≡ i (mod num_threads), in order;
// the consumer pops round-robin, so the assembled stream is deterministic.
struct WorkerQueue {
  std::deque<std::unique_ptr<DecodedExample>> q;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  bool done = false;
  static constexpr size_t kMax = 64;
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<RecordRef> index;      // every validly-framed record
  int canvas, max_gt, batch;
  bool shuffle, repeat, letterbox = false;
  uint64_t seed;
  uint64_t start_example = 0;
  int num_threads;

  std::atomic<uint64_t> consumed{0};  // global examples handed out
  std::vector<std::unique_ptr<WorkerQueue>> queues;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  ~Loader() {
    stop = true;
    for (auto& wq : queues) {
      std::lock_guard<std::mutex> lock(wq->mu);
    }
    for (auto& wq : queues) {
      wq->cv_push.notify_all();
      wq->cv_pop.notify_all();
    }
    for (auto& t : workers)
      if (t.joinable()) t.join();
  }
};

// Framing scan: header-CRC-verified walk of one shard, recording each
// record's payload location without reading the payload (fseek past it).
// Stops at the first corrupt frame (matching TFRecord reader semantics).
void IndexShard(const std::string& path, uint32_t shard_id,
                std::vector<RecordRef>* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return;
  uint8_t header[12];
  uint64_t offset = 0;
  while (fread(header, 1, 12, f) == 12) {
    uint64_t len;
    memcpy(&len, header, 8);
    uint32_t len_crc;
    memcpy(&len_crc, header + 8, 4);
    if (MaskedCrc(header, 8) != len_crc || len > (1ull << 31)) break;
    offset += 12;
    out->push_back(RecordRef{shard_id, uint32_t(len), offset});
    if (fseek(f, long(len) + 4, SEEK_CUR) != 0) {
      out->pop_back();  // truncated record
      break;
    }
    offset += len + 4;
  }
  fclose(f);
}

// Reads + data-CRC-verifies one indexed record.
bool ReadRecordAt(FILE* f, const RecordRef& r, std::vector<uint8_t>* out) {
  if (fseek(f, long(r.offset), SEEK_SET) != 0) return false;
  out->resize(r.length);
  if (fread(out->data(), 1, r.length, f) != r.length) return false;
  uint8_t crc_buf[4];
  if (fread(crc_buf, 1, 4, f) != 4) return false;
  uint32_t data_crc;
  memcpy(&data_crc, crc_buf, 4);
  return MaskedCrc(out->data(), r.length) == data_crc;
}

std::unique_ptr<DecodedExample> DecodeOne(const std::vector<uint8_t>& rec,
                                          int canvas, int max_gt,
                                          bool letterbox) {
  ParsedExample ex;
  if (!ParseExample(rec.data(), rec.size(), &ex) || ex.encoded.empty())
    return nullptr;
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!DecodeJpeg(ex.encoded, &rgb, &w, &h) || w <= 0 || h <= 0)
    return nullptr;

  auto out = std::make_unique<DecodedExample>();
  out->image.assign(size_t(canvas) * canvas * 3, 0.f);
  if (letterbox) {
    float scale = float(canvas) / std::max(h, w);
    int h1 = std::max(1, int(h * scale + 0.5f));
    int w1 = std::max(1, int(w * scale + 0.5f));
    h1 = std::min(h1, canvas);
    w1 = std::min(w1, canvas);
    ResizeBilinear(rgb.data(), h, w, out->image.data(), h1, w1, canvas);
    out->box_scale[0] = float(h1) / canvas;
    out->box_scale[1] = float(w1) / canvas;
  } else {
    ResizeBilinear(rgb.data(), h, w, out->image.data(), canvas, canvas,
                   canvas);
  }
  out->boxes.assign(size_t(max_gt) * 4, 0.f);
  out->labels.assign(max_gt, 0);
  out->mask.assign(max_gt, 0);
  out->difficult.assign(max_gt, 0);
  size_t n = std::min<size_t>(ex.ymin.size(), max_gt);
  const float fy = out->box_scale[0], fx = out->box_scale[1];
  for (size_t i = 0; i < n; ++i) {
    out->boxes[i * 4 + 0] = ex.ymin[i] * fy;
    out->boxes[i * 4 + 1] = ex.xmin[i] * fx;
    out->boxes[i * 4 + 2] = ex.ymax[i] * fy;
    out->boxes[i * 4 + 3] = ex.xmax[i] * fx;
    out->labels[i] = i < ex.labels.size() ? int32_t(ex.labels[i]) : 0;
    out->mask[i] = 1;
    out->difficult[i] = i < ex.difficult.size() && ex.difficult[i] ? 1 : 0;
  }
  out->image_id = ex.image_id;
  return out;
}

void Push(Loader* L, WorkerQueue* wq, std::unique_ptr<DecodedExample> ex) {
  std::unique_lock<std::mutex> lock(wq->mu);
  wq->cv_push.wait(lock, [L, wq] {
    return wq->q.size() < WorkerQueue::kMax || L->stop;
  });
  if (L->stop) return;
  wq->q.push_back(std::move(ex));
  wq->cv_pop.notify_one();
}

// Exact per-epoch permutation: Fisher–Yates with a seeded SplitMix-fed
// mt19937_64 (hand-rolled swap loop so the stream is stable across C++
// standard libraries, unlike std::shuffle).
void EpochPermutation(uint64_t seed, uint64_t epoch, size_t n,
                      std::vector<uint32_t>* perm) {
  perm->resize(n);
  for (size_t i = 0; i < n; ++i) (*perm)[i] = uint32_t(i);
  std::mt19937_64 rng(seed * 0x9e3779b97f4a7c15ull + epoch + 1);
  for (size_t i = n; i > 1; --i) {
    size_t j = rng() % i;
    std::swap((*perm)[i - 1], (*perm)[j]);
  }
}

void WorkerMain(Loader* L, int worker_id) {
  WorkerQueue* wq = L->queues[worker_id].get();
  const uint64_t N = L->index.size();
  const uint64_t T = uint64_t(L->num_threads);
  std::vector<FILE*> handles(L->paths.size(), nullptr);
  std::vector<uint32_t> perm;
  uint64_t perm_epoch = ~0ull;
  std::vector<uint8_t> rec;

  if (N > 0) {
    // First global position >= start_example owned by this worker.
    uint64_t start = L->start_example;
    uint64_t pos = start + (uint64_t(worker_id) + T - start % T) % T;
    for (; !L->stop; pos += T) {
      uint64_t epoch = pos / N;
      if (!L->repeat && epoch > 0) break;
      uint32_t ridx;
      if (L->shuffle) {
        if (epoch != perm_epoch) {
          EpochPermutation(L->seed, epoch, N, &perm);
          perm_epoch = epoch;
        }
        ridx = perm[pos % N];
      } else {
        ridx = uint32_t(pos % N);
      }
      const RecordRef& r = L->index[ridx];
      FILE*& f = handles[r.shard];
      if (!f) f = fopen(L->paths[r.shard].c_str(), "rb");
      std::unique_ptr<DecodedExample> ex;
      if (f && ReadRecordAt(f, r, &rec))
        ex = DecodeOne(rec, L->canvas, L->max_gt, L->letterbox);
      if (!ex) {
        // Corrupt payload: emit a zero example (mask all-false) so the
        // position mapping stays exact — a skip would shift every later
        // position and break resume.
        ex = std::make_unique<DecodedExample>();
        ex->image.assign(size_t(L->canvas) * L->canvas * 3, 0.f);
        ex->boxes.assign(size_t(L->max_gt) * 4, 0.f);
        ex->labels.assign(L->max_gt, 0);
        ex->mask.assign(L->max_gt, 0);
        ex->difficult.assign(L->max_gt, 0);
      }
      Push(L, wq, std::move(ex));
    }
  }
  for (FILE* f : handles)
    if (f) fclose(f);
  {
    std::lock_guard<std::mutex> lock(wq->mu);
    wq->done = true;
  }
  wq->cv_pop.notify_all();
}

}  // namespace

// ---------------------------------------------------------------------------
// C API (consumed via ctypes).
// ---------------------------------------------------------------------------

extern "C" {

// ABI version marker: the Python binding probes this symbol and rebuilds a
// stale .so whose signatures predate the position-addressable design.
uint64_t xdet_loader_abi_version() { return 2; }

void* xdet_loader_create(const char** paths, int num_paths, int canvas,
                         int max_gt, int batch, int shuffle, uint64_t seed,
                         int repeat, int num_threads, int letterbox,
                         uint64_t start_example) {
  auto* L = new Loader();
  for (int i = 0; i < num_paths; ++i) L->paths.emplace_back(paths[i]);
  L->canvas = canvas;
  L->max_gt = max_gt;
  L->batch = batch;
  L->shuffle = shuffle != 0;
  L->repeat = repeat != 0;
  L->letterbox = letterbox != 0;
  L->seed = seed;
  L->start_example = start_example;
  L->consumed = start_example;
  L->num_threads = std::max(1, num_threads);
  for (uint32_t i = 0; i < L->paths.size(); ++i)
    IndexShard(L->paths[i], i, &L->index);
  for (int i = 0; i < L->num_threads; ++i)
    L->queues.emplace_back(new WorkerQueue());
  for (int i = 0; i < L->num_threads; ++i)
    L->workers.emplace_back(WorkerMain, L, i);
  return L;
}

// Total examples handed out so far (== the resume token: pass it back as
// ``start_example`` to continue the exact stream).
uint64_t xdet_loader_position(void* handle) {
  return static_cast<Loader*>(handle)->consumed.load();
}

// Total indexed records (one epoch's worth).
uint64_t xdet_loader_num_examples(void* handle) {
  return static_cast<Loader*>(handle)->index.size();
}

// Fills one batch.  Returns number of examples written (== batch normally,
// < batch on final partial batch, 0 at end of data).
int xdet_loader_next(void* handle, float* images, float* boxes,
                     int32_t* labels, uint8_t* mask, uint8_t* difficult,
                     float* box_scale, char* image_ids, int id_capacity) {
  auto* L = static_cast<Loader*>(handle);
  int count = 0;
  const size_t img_sz = size_t(L->canvas) * L->canvas * 3;
  const uint64_t N = L->index.size();
  const uint64_t T = uint64_t(L->num_threads);
  while (count < L->batch) {
    uint64_t gpos = L->consumed.load();
    if (N == 0 || (!L->repeat && gpos >= N)) break;  // exhausted
    WorkerQueue* wq = L->queues[gpos % T].get();
    std::unique_ptr<DecodedExample> ex;
    {
      std::unique_lock<std::mutex> lock(wq->mu);
      wq->cv_pop.wait(lock, [L, wq] {
        return !wq->q.empty() || wq->done || L->stop;
      });
      if (wq->q.empty()) break;  // done/stopped and drained
      ex = std::move(wq->q.front());
      wq->q.pop_front();
      wq->cv_push.notify_one();
    }
    L->consumed.fetch_add(1);
    memcpy(images + size_t(count) * img_sz, ex->image.data(),
           img_sz * sizeof(float));
    memcpy(boxes + size_t(count) * L->max_gt * 4, ex->boxes.data(),
           size_t(L->max_gt) * 4 * sizeof(float));
    memcpy(labels + size_t(count) * L->max_gt, ex->labels.data(),
           size_t(L->max_gt) * sizeof(int32_t));
    memcpy(mask + size_t(count) * L->max_gt, ex->mask.data(), L->max_gt);
    memcpy(difficult + size_t(count) * L->max_gt, ex->difficult.data(),
           L->max_gt);
    if (box_scale) {
      box_scale[count * 2 + 0] = ex->box_scale[0];
      box_scale[count * 2 + 1] = ex->box_scale[1];
    }
    if (image_ids && id_capacity > 0) {
      char* dst = image_ids + size_t(count) * id_capacity;
      strncpy(dst, ex->image_id.c_str(), id_capacity - 1);
      dst[id_capacity - 1] = 0;
    }
    ++count;
  }
  return count;
}

void xdet_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

// The decoder this library was built with: 0 libjpeg, 1 nvJPEG.
int xdet_loader_decoder() {
#ifdef XDET_NVJPEG
  return 1;
#else
  return 0;
#endif
}

// The CUDA device the nvJPEG decoder of threads started from now on uses
// (no effect with libjpeg).
void xdet_loader_set_cuda_device(int device) {
#ifdef XDET_NVJPEG
  g_cuda_device = device;
#else
  (void)device;
#endif
}

// Makes the decoder's per-thread state on a fresh thread: 0 when it can
// decode, else the code of the call that failed (nvJPEG: cudaSetDevice's
// error; 1000 + nvjpegCreateSimple's status; 2000 + the state's; 3000 + the
// stream's).  libjpeg needs nothing: 0.
int xdet_loader_decoder_check() {
  int status = 0;
#ifdef XDET_NVJPEG
  std::thread([&status] { status = ThreadContext().status; }).join();
#endif
  return status;
}

// Decodes one JPEG to RGB uint8 [height, width, 3] into ``out`` (on a fresh
// thread, as the workers do).  Returns 0 and writes the pixels when they fit
// ``capacity`` bytes, 2 when they do not (the size is still written), 1
// when the bytes do not decode.  With libjpeg, ``planar`` decodes through
// DecodeJpegPlanes, the nvJPEG build's upsampling and colour conversion;
// nvJPEG ignores it.
int xdet_decode_jpeg(const uint8_t* data, uint64_t n, uint8_t* out,
                     uint64_t capacity, int* width, int* height, int planar) {
  int status = 1;
  std::thread([&] {
    std::string bytes(reinterpret_cast<const char*>(data), n);
    std::vector<uint8_t> rgb;
    int w = 0, h = 0;
#ifdef XDET_NVJPEG
    (void)planar;
    if (!DecodeJpeg(bytes, &rgb, &w, &h)) return;
#else
    if (!(planar ? DecodeJpegPlanes : DecodeJpeg)(bytes, &rgb, &w, &h))
      return;
#endif
    *width = w;
    *height = h;
    if (rgb.size() > capacity) {
      status = 2;
      return;
    }
    memcpy(out, rgb.data(), rgb.size());
    status = 0;
  }).join();
  return status;
}

}  // extern "C"

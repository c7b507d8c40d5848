// The port's native video decoder: unite_tpu/native/videodec.cpp, the
// decord replacement (SURVEY §2.2), with one fault fixed (frame_to_rgb:
// unscaled decodes of widths not a multiple of 16).
//
// FFmpeg(libav)-based, exposing a minimal C ABI consumed via ctypes by
// unite_torch/data/video_reader.py (NativeVideoReader):
//
//   void* vd_open(const char* path);
//   int   vd_num_frames(void* h);
//   int   vd_width(void* h); int vd_height(void* h);
//   int   vd_get_batch(void* h, const int64_t* idx, int n, uint8_t* out);
//   void  vd_close(void* h);
//
// get_batch semantics match decord's VideoReader.get_batch: arbitrary frame
// indices, RGB24 output [n, height, width, 3]. Random access = keyframe
// seek + decode-forward; requests are served in sorted order so nearby
// indices share one decode sweep, then scattered back to request order.
//
// Build: unite_torch/native/_build.py (g++, links
// avformat/avcodec/avutil/swscale), at first use.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  int stream_index = -1;
  int width = 0;
  int height = 0;
  int64_t num_frames = 0;
  // decode cursor: index of the next frame that would be produced
  int64_t next_frame = 0;
  bool at_start = true;
  // RGB24 scratch frame for rows swscale may not write in place
  std::vector<uint8_t> rgb;

  ~Decoder() {
    if (sws) sws_freeContext(sws);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (codec) avcodec_free_context(&codec);
    if (fmt) avformat_close_input(&fmt);
  }
};

AVStream* stream_of(Decoder* d) { return d->fmt->streams[d->stream_index]; }

double fps_of(Decoder* d) {
  AVRational r = stream_of(d)->avg_frame_rate;
  if (r.num == 0 || r.den == 0) r = stream_of(d)->r_frame_rate;
  if (r.num == 0 || r.den == 0) return 0.0;
  return av_q2d(r);
}

int64_t count_frames_estimate(Decoder* d) {
  AVStream* st = stream_of(d);
  if (st->nb_frames > 0) return st->nb_frames;
  double fps = fps_of(d);
  if (fps > 0) {
    int64_t dur = st->duration;
    if (dur > 0) {
      double seconds = dur * av_q2d(st->time_base);
      return (int64_t)(seconds * fps + 0.5);
    }
    if (d->fmt->duration > 0) {
      double seconds = d->fmt->duration / (double)AV_TIME_BASE;
      return (int64_t)(seconds * fps + 0.5);
    }
  }
  return 0;
}

// Full-scan frame count (fallback for containers without metadata).
int64_t count_frames_scan(Decoder* d) {
  int64_t n = 0;
  AVPacket* pkt = av_packet_alloc();
  while (av_read_frame(d->fmt, pkt) >= 0) {
    if (pkt->stream_index == d->stream_index) n++;
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  av_seek_frame(d->fmt, d->stream_index, 0,
                AVSEEK_FLAG_BACKWARD | AVSEEK_FLAG_FRAME);
  avcodec_flush_buffers(d->codec);
  d->next_frame = 0;
  d->at_start = true;
  return n;
}

// Seek so the decode cursor lands at or before `target`.
int seek_to(Decoder* d, int64_t target) {
  double fps = fps_of(d);
  AVStream* st = stream_of(d);
  int64_t ts = 0;
  if (fps > 0) {
    double seconds = target / fps;
    ts = (int64_t)(seconds / av_q2d(st->time_base));
  }
  if (av_seek_frame(d->fmt, d->stream_index, ts, AVSEEK_FLAG_BACKWARD) < 0) {
    return -1;
  }
  avcodec_flush_buffers(d->codec);
  // cursor position is unknown until the first decoded frame's pts; we
  // track it from decoded pts below by setting a sentinel
  d->next_frame = -1;
  return 0;
}

// Decode the next frame in presentation order; returns 0 on success,
// AVERROR_EOF at end, <0 on error. Fills d->frame.
int decode_next(Decoder* d) {
  while (true) {
    int ret = avcodec_receive_frame(d->codec, d->frame);
    if (ret == 0) {
      // update cursor from pts when we came from a seek
      if (d->next_frame < 0) {
        int64_t pts = d->frame->best_effort_timestamp;
        double fps = fps_of(d);
        if (pts != AV_NOPTS_VALUE && fps > 0) {
          double seconds = pts * av_q2d(stream_of(d)->time_base);
          d->next_frame = (int64_t)(seconds * fps + 0.5);
        } else {
          d->next_frame = 0;
        }
      }
      d->next_frame++;
      return 0;
    }
    if (ret != AVERROR(EAGAIN) && ret != AVERROR_EOF) return ret;
    if (ret == AVERROR_EOF) return AVERROR_EOF;

    // feed more packets
    while (true) {
      int r = av_read_frame(d->fmt, d->pkt);
      if (r < 0) {
        avcodec_send_packet(d->codec, nullptr);  // flush
        break;
      }
      if (d->pkt->stream_index == d->stream_index) {
        r = avcodec_send_packet(d->codec, d->pkt);
        av_packet_unref(d->pkt);
        if (r < 0 && r != AVERROR(EAGAIN)) return r;
        break;
      }
      av_packet_unref(d->pkt);
    }
  }
}

void frame_to_rgb(Decoder* d, uint8_t* dst) {
  if (!d->sws) {
    d->sws = sws_getContext(
        d->codec->width, d->codec->height, d->codec->pix_fmt, d->width,
        d->height, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr, nullptr);
  }
  // swscale's SIMD converters take whole blocks of pixels and expect
  // aligned destination rows with room past their end; a batch's rows are
  // packed at 3 * width bytes. Where that is not a multiple of 16 (widths
  // not a multiple of 16), the direct write of an unscaled decode gave
  // wrong last columns, different on every call, and ran past the batch
  // buffer: convert into an aligned, padded scratch frame and copy the
  // rows out.
  const int row = 3 * d->width;
  if (row % 16 == 0) {
    uint8_t* planes[1] = {dst};
    int strides[1] = {row};
    sws_scale(d->sws, d->frame->data, d->frame->linesize, 0,
              d->codec->height, planes, strides);
    return;
  }
  const int stride = (row + 63) / 64 * 64 + 64;
  d->rgb.resize((size_t)stride * (d->height + 1) + 64);
  uint8_t* base = d->rgb.data();
  base += (64 - (uintptr_t)base % 64) % 64;
  uint8_t* planes[1] = {base};
  int strides[1] = {stride};
  sws_scale(d->sws, d->frame->data, d->frame->linesize, 0, d->codec->height,
            planes, strides);
  for (int y = 0; y < d->height; ++y) {
    std::memcpy(dst + (size_t)y * row, base + (size_t)y * stride, row);
  }
}

}  // namespace

extern "C" {

void* vd_open(const char* path) {
  av_log_set_level(AV_LOG_ERROR);
  Decoder* d = new Decoder();
  if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) {
    delete d;
    return nullptr;
  }
  if (avformat_find_stream_info(d->fmt, nullptr) < 0) {
    delete d;
    return nullptr;
  }
  d->stream_index =
      av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (d->stream_index < 0) {
    delete d;
    return nullptr;
  }
  AVStream* st = d->fmt->streams[d->stream_index];
  const AVCodec* dec = avcodec_find_decoder(st->codecpar->codec_id);
  if (!dec) {
    delete d;
    return nullptr;
  }
  d->codec = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(d->codec, st->codecpar);
  d->codec->thread_count = 0;  // auto
  if (avcodec_open2(d->codec, dec, nullptr) < 0) {
    delete d;
    return nullptr;
  }
  d->width = d->codec->width;
  d->height = d->codec->height;
  d->pkt = av_packet_alloc();
  d->frame = av_frame_alloc();
  d->num_frames = count_frames_estimate(d);
  if (d->num_frames <= 0) d->num_frames = count_frames_scan(d);
  return d;
}

// Decode-time short-side scaling: same swscale pass that already converts
// pix_fmt→RGB24 also resizes (SWS_BILINEAR), so scaled decode costs ~nothing
// extra and the host pipeline can skip its cv2 resize entirely (the
// --device_eval_transforms input path). Long-side rounding matches
// data/transforms.py::resize_clip (truncating int(size*long/short)).
void* vd_open_scaled(const char* path, int short_side) {
  Decoder* d = (Decoder*)vd_open(path);
  if (!d) return nullptr;
  if (short_side > 0 && d->width > 0 && d->height > 0) {
    if (d->width < d->height) {
      d->height = (int)((int64_t)short_side * d->height / d->width);
      d->width = short_side;
    } else {
      d->width = (int)((int64_t)short_side * d->width / d->height);
      d->height = short_side;
    }
  }
  return d;
}

// Exact-size decode (decord's VideoReader(width=, height=) semantics —
// aspect-squashing): the swscale pass resizes straight to (w, h).
void* vd_open_sized(const char* path, int width, int height) {
  Decoder* d = (Decoder*)vd_open(path);
  if (!d) return nullptr;
  if (width > 0 && height > 0) {
    d->width = width;
    d->height = height;
  }
  return d;
}

int vd_num_frames(void* h) {
  return (int)((Decoder*)h)->num_frames;
}
int vd_width(void* h) { return ((Decoder*)h)->width; }
int vd_height(void* h) { return ((Decoder*)h)->height; }

int vd_get_batch(void* h, const int64_t* idx, int n, uint8_t* out) {
  Decoder* d = (Decoder*)h;
  const size_t frame_bytes = (size_t)d->width * d->height * 3;

  // serve in sorted unique order, scatter to request order afterwards
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(),
            [&](int a, int b) { return idx[a] < idx[b]; });

  int64_t last_decoded = -1;
  std::vector<uint8_t> last_rgb;

  for (int oi = 0; oi < n; ++oi) {
    int64_t target = idx[order[oi]];
    if (target < 0) return -2;
    uint8_t* dst = out + frame_bytes * order[oi];

    if (target == last_decoded && !last_rgb.empty()) {
      std::memcpy(dst, last_rgb.data(), frame_bytes);
      continue;
    }
    // seek backward (or far forward) when the cursor is past/behind
    bool need_seek =
        d->next_frame < 0 || target < d->next_frame ||
        (target > d->next_frame + 256);  // long skip: cheaper to keyseek
    if (need_seek && !(d->at_start && target >= d->next_frame &&
                       target < d->next_frame + 256)) {
      if (seek_to(d, target) != 0) return -3;
    }
    d->at_start = false;

    // decode forward to the target
    while (true) {
      int r = decode_next(d);
      if (r == AVERROR_EOF) {
        // clamp: reuse the last decoded frame if any (decord-style grace)
        if (!last_rgb.empty()) {
          std::memcpy(dst, last_rgb.data(), frame_bytes);
          break;
        }
        return -4;
      }
      if (r < 0) return -5;
      if (d->next_frame - 1 >= target) {
        frame_to_rgb(d, dst);
        last_decoded = target;
        last_rgb.assign(dst, dst + frame_bytes);
        break;
      }
    }
  }
  return 0;
}

void vd_close(void* h) { delete (Decoder*)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG frame decode (raw-frame datasets, ssv2.py img_%05d.jpg folders).
// libavcodec MJPEG decoder + swscale to RGB24 — replaces the cv2/PIL
// per-frame reads on the SSRawFrameClsDataset hot path.
//
//   int jd_dims(const char* path, int* w, int* h);       // header probe
//   int jd_decode(const char* path, uint8_t* out, int w, int h);
//     out: [h, w, 3] RGB24; errors if the file's dims differ.
// ---------------------------------------------------------------------------

namespace {

struct JpegCtx {
  AVCodecContext* codec = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  SwsContext* sws = nullptr;  // memoized on (w, h, fmt)
  int sws_w = 0, sws_h = 0, sws_fmt = -1;
  ~JpegCtx() {
    if (sws) sws_freeContext(sws);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (codec) avcodec_free_context(&codec);
  }
  int open() {
    const AVCodec* c = avcodec_find_decoder(AV_CODEC_ID_MJPEG);
    if (!c) return -1;
    codec = avcodec_alloc_context3(c);
    if (!codec || avcodec_open2(codec, c, nullptr) < 0) return -1;
    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    return (pkt && frame) ? 0 : -1;
  }
  // decode one whole JPEG file into this->frame
  int decode_file(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return -2;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (sz <= 0) { fclose(f); return -2; }
    if (av_new_packet(pkt, (int)sz) < 0) { fclose(f); return -1; }
    size_t rd = fread(pkt->data, 1, (size_t)sz, f);
    fclose(f);
    if (rd != (size_t)sz) { av_packet_unref(pkt); return -2; }
    int r = avcodec_send_packet(codec, pkt);
    av_packet_unref(pkt);
    if (r < 0) return -3;
    r = avcodec_receive_frame(codec, frame);
    return r < 0 ? -3 : 0;
  }
};

}  // namespace

extern "C" {

// handle API: reuse one codec context (and sws context) across a batch —
// per-file avcodec_open2 costs more than the decode itself at 240p
void* jd_new() {
  JpegCtx* c = new JpegCtx();
  if (c->open() != 0) {
    delete c;
    return nullptr;
  }
  return c;
}

void jd_free(void* h) { delete (JpegCtx*)h; }

int jd_dims(const char* path, int* w, int* h) {
  JpegCtx c;
  if (c.open() != 0) return -1;
  int r = c.decode_file(path);
  if (r != 0) return r;
  *w = c.frame->width;
  *h = c.frame->height;
  return 0;
}

// probe/emit split: decode the file once with the SHARED handle and report
// its dims; the decoded frame stays in the handle for jd_emit_with. Replaces
// the jd_dims(first frame) + jd_decode_with(first frame) double decode that
// cost a fresh avcodec_open2 + full IDCT per batch.
int jd_probe_with(void* hctx, const char* path, int* w, int* h) {
  JpegCtx& c = *(JpegCtx*)hctx;
  int r = c.decode_file(path);
  if (r != 0) return r;
  *w = c.frame->width;
  *h = c.frame->height;
  return 0;
}

static int jd_emit_frame(JpegCtx& c, uint8_t* out, int w, int h);

// convert the frame held by the last jd_probe_with on this handle to RGB24
int jd_emit_with(void* hctx, uint8_t* out, int w, int h) {
  JpegCtx& c = *(JpegCtx*)hctx;
  if (!c.frame || c.frame->width != w || c.frame->height != h) return -4;
  return jd_emit_frame(c, out, w, h);
}

int jd_decode_with(void* hctx, const char* path, uint8_t* out, int w, int h) {
  JpegCtx& c = *(JpegCtx*)hctx;
  int r = c.decode_file(path);
  if (r != 0) return r;
  if (c.frame->width != w || c.frame->height != h) return -4;
  return jd_emit_frame(c, out, w, h);
}

static int jd_emit_frame(JpegCtx& c, uint8_t* out, int w, int h) {
  // map deprecated j-formats to their range-neutral twins (the explicit
  // srcRange=1 below carries the full-range information instead)
  AVPixelFormat fmt = (AVPixelFormat)c.frame->format;
  switch (fmt) {
    case AV_PIX_FMT_YUVJ420P: fmt = AV_PIX_FMT_YUV420P; break;
    case AV_PIX_FMT_YUVJ422P: fmt = AV_PIX_FMT_YUV422P; break;
    case AV_PIX_FMT_YUVJ444P: fmt = AV_PIX_FMT_YUV444P; break;
    case AV_PIX_FMT_YUVJ440P: fmt = AV_PIX_FMT_YUV440P; break;
    default: break;
  }
  if (!c.sws || c.sws_w != w || c.sws_h != h || c.sws_fmt != (int)fmt) {
    if (c.sws) sws_freeContext(c.sws);
    c.sws = sws_getContext(
        w, h, fmt, w, h, AV_PIX_FMT_RGB24,
        SWS_BILINEAR | SWS_FULL_CHR_H_INT | SWS_ACCURATE_RND,
        nullptr, nullptr, nullptr);
    if (!c.sws) return -1;
    // JPEG is FULL-range YUV; newer libav reports yuv420p+color_range=JPEG
    // instead of yuvj420p, and sws then assumes limited range (observed
    // +-128 errors in saturated regions). Force full-range input.
    const int* tbl = sws_getCoefficients(SWS_CS_ITU601);
    sws_setColorspaceDetails(c.sws, tbl, /*srcRange=*/1, tbl, /*dstRange=*/1,
                             0, 1 << 16, 1 << 16);
    c.sws_w = w; c.sws_h = h; c.sws_fmt = (int)fmt;
  }
  uint8_t* dst[1] = {out};
  int dst_stride[1] = {3 * w};
  sws_scale(c.sws, c.frame->data, c.frame->linesize, 0, h, dst, dst_stride);
  return 0;
}

}  // extern "C"

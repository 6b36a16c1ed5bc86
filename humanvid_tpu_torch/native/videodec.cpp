// Native host-side video decode/encode core (libavformat/libavcodec/libswscale).
//
// Replaces the reference's external native video dependencies — decord's C++
// random-access decoder (reference src/dataset/*.py:5, DWPose/prepare_videos.py:7)
// and PyAV/ffmpeg encode/decode (reference src/utils/util.py:82-197) — with an
// in-tree C++ library exposed over a C ABI for ctypes (SURVEY §2.10).
//
// Design:
//  - open() scans the container once to build an exact presentation-order
//    frame index (packet pts sorted), like decord's index, so frame counts and
//    random access are exact rather than header-estimated.
//  - read(indices[]) decodes with forward-reuse: sorted unique targets, one
//    backward-keyframe seek only when the target precedes the cursor, frame-
//    threaded decode (thread_count = auto), swscale to packed RGB24 directly
//    into the caller's buffer (no intermediate copies).
//  - encoder: libx264 (crf) when present, else mpeg4 (qscale), yuv420p.
//  - back to the start means opening the file again: a seek to the first
//    frame's pts lands on a later keyframe where the demuxer seeks by dts
//    and a second keyframe's dts is at or before that pts (x264 puts scene
//    cuts in short clips), which lost the leading frames; a seek that lands
//    past its target decodes from the start instead of returning a later
//    frame.
//  - swscale reads and writes packed RGB through frames of its own with
//    aligned row strides, copied row by row from and to the caller's
//    buffer: on rows of 3 * width bytes that are not a multiple of its
//    vector width, its SIMD paths run past the end of the caller's buffer
//    (a 56-pixel-wide clip corrupted the heap).
//
// Error handling: functions return 0/NULL on failure; hvt_last_error() gives a
// thread-local message.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

static thread_local std::string g_err;

static void set_err(const std::string& where, int averr = 0) {
  char buf[256] = {0};
  if (averr != 0) av_strerror(averr, buf, sizeof(buf));
  g_err = where + (averr ? std::string(": ") + buf : std::string());
}

extern "C" const char* hvt_last_error() { return g_err.c_str(); }

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

struct Decoder {
  std::string path;
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  int stream_idx = -1;
  int width = 0, height = 0;
  double fps = 0.0;
  std::vector<int64_t> pts;  // presentation-order timestamps (sorted)
  int64_t cursor = -1;       // index of the next frame the decoder will output
  AVFrame* frame = nullptr;
  AVFrame* rgb = nullptr;    // swscale's output, aligned rows
  AVPacket* pkt = nullptr;
  bool draining = false;
};

// A packed RGB24 frame whose rows swscale may overrun.
static AVFrame* alloc_rgb(int w, int h) {
  AVFrame* f = av_frame_alloc();
  if (!f) return nullptr;
  f->format = AV_PIX_FMT_RGB24;
  f->width = w;
  f->height = h;
  if (av_frame_get_buffer(f, 64) < 0) av_frame_free(&f);
  return f;
}

static int open_input(Decoder* d) {
  // mov/mp4: ignore edit lists so every coded frame is decodable — keeps the
  // packet-count index exactly equal to the decodable frame count (an elst
  // that trims the tail would otherwise silently discard frames).
  AVDictionary* opts = nullptr;
  av_dict_set(&opts, "ignore_editlist", "1", 0);
  int ret = avformat_open_input(&d->fmt, d->path.c_str(), nullptr, &opts);
  av_dict_free(&opts);
  return ret;
}

// Back to the first packet, with the decoder flushed: the file opened again.
static bool rewind_input(Decoder* d) {
  avformat_close_input(&d->fmt);
  int ret = open_input(d);
  if (ret < 0) { set_err("reopen to rewind", ret); return false; }
  avcodec_flush_buffers(d->codec);
  d->cursor = 0;
  d->draining = false;
  return true;
}

static bool build_index(Decoder* d) {
  // One packet-level pass: no decode, just timestamps. Gives the exact frame
  // count and the pts of every frame in presentation order.
  d->pts.clear();
  AVPacket* pkt = av_packet_alloc();
  while (av_read_frame(d->fmt, pkt) >= 0) {
    if (pkt->stream_index == d->stream_idx) {
      int64_t t = pkt->pts != AV_NOPTS_VALUE ? pkt->pts : pkt->dts;
      d->pts.push_back(t);
    }
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  if (d->pts.empty()) { set_err("no video packets in stream"); return false; }
  std::sort(d->pts.begin(), d->pts.end());
  return rewind_input(d);
}

extern "C" void* hvt_vd_open(const char* path) {
  auto* d = new Decoder();
  d->path = path;
  int ret = open_input(d);
  if (ret < 0) { set_err("avformat_open_input", ret); delete d; return nullptr; }
  ret = avformat_find_stream_info(d->fmt, nullptr);
  if (ret < 0) { set_err("find_stream_info", ret); avformat_close_input(&d->fmt); delete d; return nullptr; }

  const AVCodec* dec = nullptr;
  d->stream_idx = av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
  if (d->stream_idx < 0 || !dec) { set_err("no video stream"); avformat_close_input(&d->fmt); delete d; return nullptr; }
  AVStream* st = d->fmt->streams[d->stream_idx];

  d->codec = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(d->codec, st->codecpar);
  d->codec->thread_count = 0;  // auto
  d->codec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
  ret = avcodec_open2(d->codec, dec, nullptr);
  if (ret < 0) { set_err("avcodec_open2", ret); avformat_close_input(&d->fmt); delete d; return nullptr; }

  d->width = d->codec->width;
  d->height = d->codec->height;
  AVRational fr = av_guess_frame_rate(d->fmt, st, nullptr);
  d->fps = fr.den ? (double)fr.num / fr.den : 0.0;
  d->frame = av_frame_alloc();
  d->rgb = alloc_rgb(d->width, d->height);
  d->pkt = av_packet_alloc();

  if (!d->rgb || !build_index(d)) {
    if (!d->rgb) set_err("RGB frame allocation");
    av_frame_free(&d->rgb);
    av_frame_free(&d->frame);
    av_packet_free(&d->pkt);
    avcodec_free_context(&d->codec);
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  return d;
}

extern "C" int hvt_vd_width(void* h) { return ((Decoder*)h)->width; }
extern "C" int hvt_vd_height(void* h) { return ((Decoder*)h)->height; }
extern "C" int64_t hvt_vd_frames(void* h) { return (int64_t)((Decoder*)h)->pts.size(); }
extern "C" double hvt_vd_fps(void* h) { return ((Decoder*)h)->fps; }

// Decode the next frame in presentation order into d->frame. Returns 1 on
// frame, 0 on EOF, <0 on error.
static int decode_next(Decoder* d) {
  while (true) {
    int ret = avcodec_receive_frame(d->codec, d->frame);
    if (ret == 0) return 1;
    if (ret == AVERROR_EOF) return 0;
    if (ret != AVERROR(EAGAIN)) { set_err("receive_frame", ret); return -1; }
    if (d->draining) continue;  // EAGAIN while draining shouldn't happen
    // feed more packets
    while (true) {
      ret = av_read_frame(d->fmt, d->pkt);
      if (ret == AVERROR_EOF) {
        avcodec_send_packet(d->codec, nullptr);
        d->draining = true;
        break;
      }
      if (ret < 0) { set_err("av_read_frame", ret); return -1; }
      if (d->pkt->stream_index != d->stream_idx) { av_packet_unref(d->pkt); continue; }
      ret = avcodec_send_packet(d->codec, d->pkt);
      av_packet_unref(d->pkt);
      if (ret < 0 && ret != AVERROR(EAGAIN)) { set_err("send_packet", ret); return -1; }
      break;
    }
  }
}

static bool seek_to(Decoder* d, int64_t index) {
  int64_t target = d->pts[index];
  int ret = avformat_seek_file(d->fmt, d->stream_idx, INT64_MIN, target,
                               target, AVSEEK_FLAG_BACKWARD);
  if (ret < 0) { set_err("seek", ret); return false; }
  avcodec_flush_buffers(d->codec);
  d->draining = false;
  bool first = true;
  // decode forward until we are AT `index` (cursor = next frame to output)
  while (true) {
    int r = decode_next(d);
    if (r <= 0) { if (r == 0) set_err("EOF before seek target"); return false; }
    int64_t t = d->frame->best_effort_timestamp != AV_NOPTS_VALUE
                    ? d->frame->best_effort_timestamp
                    : d->frame->pts;
    if (first && t > target) {
      // the seek landed past the target: decode from the start instead
      av_frame_unref(d->frame);
      if (!rewind_input(d)) return false;
      first = false;
      continue;
    }
    first = false;
    if (t >= target) {
      // this frame IS index; find its position to set the cursor
      auto it = std::lower_bound(d->pts.begin(), d->pts.end(), t);
      d->cursor = (it - d->pts.begin()) + 1;
      return true;  // caller consumes d->frame as frame `index`
    }
    av_frame_unref(d->frame);
  }
}

static bool frame_to_rgb(Decoder* d, uint8_t* out) {
  d->sws = sws_getCachedContext(d->sws, d->width, d->height,
                                (AVPixelFormat)d->frame->format, d->width,
                                d->height, AV_PIX_FMT_RGB24, SWS_BILINEAR,
                                nullptr, nullptr, nullptr);
  if (!d->sws) { set_err("sws_getCachedContext"); return false; }
  sws_scale(d->sws, d->frame->data, d->frame->linesize, 0, d->height, d->rgb->data,
            d->rgb->linesize);
  const size_t row = (size_t)3 * d->width;
  for (int y = 0; y < d->height; ++y)
    memcpy(out + y * row, d->rgb->data[0] + (size_t)y * d->rgb->linesize[0], row);
  return true;
}

// Read n frames by presentation index into out (n * H * W * 3, RGB24).
// Indices may be unsorted / repeated. Returns 1 on success, 0 on failure.
extern "C" int hvt_vd_read(void* h, const int64_t* indices, int64_t n, uint8_t* out) {
  auto* d = (Decoder*)h;
  const size_t frame_bytes = (size_t)d->width * d->height * 3;
  // process in sorted order, reuse decode position; copy duplicates
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](int64_t a, int64_t b) { return indices[a] < indices[b]; });

  int64_t prev_idx = -1;
  uint8_t* prev_out = nullptr;
  for (int64_t k = 0; k < n; ++k) {
    int64_t idx = indices[order[k]];
    uint8_t* dst = out + (size_t)order[k] * frame_bytes;
    if (idx < 0 || idx >= (int64_t)d->pts.size()) { set_err("frame index out of range"); return 0; }
    if (idx == prev_idx) { memcpy(dst, prev_out, frame_bytes); continue; }

    bool have_frame = false;
    if (idx < d->cursor || idx > d->cursor + 64) {
      // behind the cursor, or far ahead: keyframe seek (64-frame slack avoids
      // seeks when striding forward within a GOP)
      if (!seek_to(d, idx)) return 0;
      have_frame = true;  // seek_to leaves frame `idx` in d->frame
    }
    if (!have_frame) {
      while (d->cursor <= idx) {
        av_frame_unref(d->frame);
        int r = decode_next(d);
        if (r <= 0) { if (r == 0) set_err("EOF before frame"); return 0; }
        d->cursor++;
      }
    }
    if (!frame_to_rgb(d, dst)) return 0;
    av_frame_unref(d->frame);
    prev_idx = idx;
    prev_out = dst;
  }
  return 1;
}

extern "C" void hvt_vd_close(void* h) {
  auto* d = (Decoder*)h;
  if (!d) return;
  if (d->sws) sws_freeContext(d->sws);
  if (d->frame) av_frame_free(&d->frame);
  if (d->rgb) av_frame_free(&d->rgb);
  if (d->pkt) av_packet_free(&d->pkt);
  if (d->codec) avcodec_free_context(&d->codec);
  if (d->fmt) avformat_close_input(&d->fmt);
  delete d;
}

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

struct Encoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  AVStream* stream = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frame = nullptr;
  AVFrame* rgb = nullptr;  // swscale's input, aligned rows
  AVPacket* pkt = nullptr;
  int width = 0, height = 0;
  int64_t next_pts = 0;
  bool header_written = false;
};

static int flush_packets(Encoder* e) {
  while (true) {
    int ret = avcodec_receive_packet(e->codec, e->pkt);
    if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
    if (ret < 0) { set_err("receive_packet", ret); return -1; }
    av_packet_rescale_ts(e->pkt, e->codec->time_base, e->stream->time_base);
    e->pkt->stream_index = e->stream->index;
    ret = av_interleaved_write_frame(e->fmt, e->pkt);
    if (ret < 0) { set_err("write_frame", ret); return -1; }
  }
}

extern "C" void* hvt_ve_open(const char* path, int w, int h, double fps, int crf) {
  auto* e = new Encoder();
  e->width = w; e->height = h;
  int ret = avformat_alloc_output_context2(&e->fmt, nullptr, nullptr, path);
  if (ret < 0 || !e->fmt) { set_err("alloc_output_context", ret); delete e; return nullptr; }

  const AVCodec* enc = avcodec_find_encoder_by_name("libx264");
  if (!enc) enc = avcodec_find_encoder(AV_CODEC_ID_H264);
  if (!enc) enc = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!enc) { set_err("no H.264/MPEG4 encoder available"); delete e; return nullptr; }

  e->stream = avformat_new_stream(e->fmt, nullptr);
  e->codec = avcodec_alloc_context3(enc);
  e->codec->width = w;
  e->codec->height = h;
  e->codec->pix_fmt = AV_PIX_FMT_YUV420P;
  AVRational fr = av_d2q(fps, 100000);
  e->codec->time_base = {fr.den, fr.num};
  e->codec->framerate = fr;
  e->codec->gop_size = 12;
  if (enc->id == AV_CODEC_ID_H264) {
    char crf_s[8];
    snprintf(crf_s, sizeof(crf_s), "%d", crf);
    av_opt_set(e->codec->priv_data, "crf", crf_s, 0);       // parity: crf 19
    av_opt_set(e->codec->priv_data, "preset", "medium", 0); // src/utils/util.py:103
  } else {
    e->codec->flags |= AV_CODEC_FLAG_QSCALE;
    e->codec->global_quality = FF_QP2LAMBDA * 3;
    e->codec->bit_rate = (int64_t)w * h * fps / 2;
  }
  if (e->fmt->oformat->flags & AVFMT_GLOBALHEADER)
    e->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;

  ret = avcodec_open2(e->codec, enc, nullptr);
  if (ret < 0) { set_err("encoder open", ret); delete e; return nullptr; }
  avcodec_parameters_from_context(e->stream->codecpar, e->codec);
  e->stream->time_base = e->codec->time_base;

  if (!(e->fmt->oformat->flags & AVFMT_NOFILE)) {
    ret = avio_open(&e->fmt->pb, path, AVIO_FLAG_WRITE);
    if (ret < 0) { set_err("avio_open", ret); delete e; return nullptr; }
  }
  ret = avformat_write_header(e->fmt, nullptr);
  if (ret < 0) { set_err("write_header", ret); delete e; return nullptr; }
  e->header_written = true;

  e->frame = av_frame_alloc();
  e->frame->format = AV_PIX_FMT_YUV420P;
  e->frame->width = w;
  e->frame->height = h;
  av_frame_get_buffer(e->frame, 0);
  e->rgb = alloc_rgb(w, h);
  if (!e->rgb) { set_err("RGB frame allocation"); return nullptr; }
  e->pkt = av_packet_alloc();
  e->sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, AV_PIX_FMT_YUV420P,
                          SWS_BILINEAR, nullptr, nullptr, nullptr);
  return e;
}

extern "C" int hvt_ve_write(void* h, const uint8_t* rgb, int64_t n) {
  auto* e = (Encoder*)h;
  const size_t frame_bytes = (size_t)e->width * e->height * 3;
  for (int64_t i = 0; i < n; ++i) {
    av_frame_make_writable(e->frame);
    const uint8_t* src = rgb + (size_t)i * frame_bytes;
    const size_t row = (size_t)3 * e->width;
    for (int y = 0; y < e->height; ++y)
      memcpy(e->rgb->data[0] + (size_t)y * e->rgb->linesize[0], src + y * row, row);
    sws_scale(e->sws, e->rgb->data, e->rgb->linesize, 0, e->height, e->frame->data,
              e->frame->linesize);
    e->frame->pts = e->next_pts++;
    e->frame->pkt_duration = 1;  // one tick of codec time_base (1/fps)
    int ret = avcodec_send_frame(e->codec, e->frame);
    if (ret < 0) { set_err("send_frame", ret); return 0; }
    if (flush_packets(e) < 0) return 0;
  }
  return 1;
}

extern "C" int hvt_ve_close(void* h) {
  auto* e = (Encoder*)h;
  if (!e) return 1;
  int ok = 1;
  if (e->codec && e->header_written) {
    avcodec_send_frame(e->codec, nullptr);  // drain
    if (flush_packets(e) < 0) ok = 0;
    if (av_write_trailer(e->fmt) < 0) { set_err("write_trailer"); ok = 0; }
  }
  if (e->sws) sws_freeContext(e->sws);
  if (e->frame) av_frame_free(&e->frame);
  if (e->rgb) av_frame_free(&e->rgb);
  if (e->pkt) av_packet_free(&e->pkt);
  if (e->codec) avcodec_free_context(&e->codec);
  if (e->fmt) {
    if (!(e->fmt->oformat->flags & AVFMT_NOFILE) && e->fmt->pb) avio_closep(&e->fmt->pb);
    avformat_free_context(e->fmt);
  }
  delete e;
  return ok;
}

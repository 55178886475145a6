// geovpr native host-side image decoder.
//
// The reference decodes JPEGs with PIL inside 4 torch DataLoader worker
// processes (swin_attempt_2.py:152-153). On TPU the host must sustain
// thousands of images/sec to keep the chip fed, so this is a C++
// libjpeg + bilinear-resize pipeline with an internal std::thread pool,
// exposed as a flat C ABI consumed via ctypes
// (geovpr/data/decoder.py). No Python objects cross the boundary: the
// caller passes one contiguous blob of concatenated JPEG bytes plus
// offsets, and receives a dense uint8 [n, out_h, out_w, 3] batch.
//
// Build: see native/Makefile (cc -O3 -shared -ljpeg).

#include <cstddef>
#include <cstdio>
#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <memory>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG into an RGB buffer; returns true on success.
//
// min_h/min_w > 0 enable libjpeg-turbo DCT scaling: the IDCT itself emits
// the smallest m/8 scale whose output still covers (min_h, min_w) — a large
// downscale (e.g. 4000px camera frame -> 224) then costs a fraction of the
// full-resolution decode and the DCT low-pass doubles as antialiasing.
bool decode_jpeg(const uint8_t* data, size_t size, std::vector<uint8_t>* out,
                 int* width, int* height, int min_h = 0, int min_w = 0) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  if (min_h > 0 && min_w > 0) {
    const long fh = long(cinfo.image_height), fw = long(cinfo.image_width);
    int num = 8;
    // smallest num/8 with ceil(dim*num/8) >= min_dim for both dims
    for (int m = 1; m <= 8; ++m) {
      if ((fh * m + 7) / 8 >= min_h && (fw * m + 7) / 8 >= min_w) {
        num = m;
        break;
      }
    }
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  // reject absurd headers (crafted/corrupt files): >64M pixels would be a
  // ~200MB allocation per worker and legit campus photos are far smaller
  if (*width <= 0 || *height <= 0 ||
      size_t(*width) * size_t(*height) > (64u << 20)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  try {
    out->resize(size_t(*width) * (*height) * 3);
  } catch (const std::bad_alloc&) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  const size_t stride = size_t(*width) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + size_t(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// 2x2 box downsample (one octave of antialiasing).
void box_halve(std::vector<uint8_t>* buf, int* h, int* w) {
  const int nh = *h / 2, nw = *w / 2;
  std::vector<uint8_t> out(size_t(nh) * nw * 3);
  const uint8_t* s = buf->data();
  for (int y = 0; y < nh; ++y) {
    for (int x = 0; x < nw; ++x) {
      for (int c = 0; c < 3; ++c) {
        const size_t r0 = (size_t(2 * y) * (*w) + 2 * x) * 3 + c;
        const size_t r1 = (size_t(2 * y + 1) * (*w) + 2 * x) * 3 + c;
        out[(size_t(y) * nw + x) * 3 + c] =
            uint8_t((int(s[r0]) + s[r0 + 3] + s[r1] + s[r1 + 3] + 2) / 4);
      }
    }
  }
  buf->swap(out);
  *h = nh;
  *w = nw;
}

// Bilinear resize RGB8 (src_h, src_w) -> (dst_h, dst_w), torch/PIL-style
// half-pixel centers (align_corners=false). Large downscales are handled
// upstream (DCT scaling + per-octave box-halving) so the remaining ratio is
// < 2x, where a 2-tap bilinear is adequate. The x-axis taps/weights are
// precomputed once (vs per-pixel recomputation, which dominated the decode
// at 480p: the row loop then streams with contiguous loads).
void resize_bilinear(const uint8_t* src, int src_h, int src_w, uint8_t* dst,
                     int dst_h, int dst_w) {
  const float sy = float(src_h) / dst_h;
  const float sx = float(src_w) / dst_w;
  std::vector<int> x0s(dst_w), x1s(dst_w);
  std::vector<float> wxs(dst_w);
  for (int x = 0; x < dst_w; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    if (fx < 0) fx = 0;
    const int x0 = int(fx);
    x0s[x] = x0 * 3;
    x1s[x] = (x0 + 1 < src_w ? x0 + 1 : src_w - 1) * 3;
    wxs[x] = fx - x0;
  }
  for (int y = 0; y < dst_h; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    const int y0 = int(fy);
    const int y1 = y0 + 1 < src_h ? y0 + 1 : src_h - 1;
    const float wy = fy - y0;
    const uint8_t* r0 = src + size_t(y0) * src_w * 3;
    const uint8_t* r1 = src + size_t(y1) * src_w * 3;
    uint8_t* drow = dst + size_t(y) * dst_w * 3;
    for (int x = 0; x < dst_w; ++x) {
      const int a = x0s[x], b = x1s[x];
      const float wx = wxs[x];
      for (int c = 0; c < 3; ++c) {
        const float top = r0[a + c] + (r0[b + c] - r0[a + c]) * wx;
        const float bot = r1[a + c] + (r1[b + c] - r1[a + c]) * wx;
        drow[x * 3 + c] = uint8_t(top + (bot - top) * wy + 0.5f);
      }
    }
  }
}

class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lock(mu_);
            cv_.wait(lock, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

// Decode one JPEG and write an (out_h, out_w) RGB crop/resize into dst.
// resize_short == 0: plain square resize to (out_h, out_w).
// resize_short > 0: resize the SHORT side to resize_short keeping aspect,
// then center-crop (out_h, out_w) — the reference's EfficientNet eval
// transform Resize(256)+CenterCrop(224)
// (angle_prediction/efficient_net/validation_script.py:124-129).
bool process_one(const uint8_t* data, size_t size, int out_h, int out_w,
                 int resize_short, uint8_t* dst) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  const int min_h = resize_short > 0 ? resize_short : out_h;
  const int min_w = resize_short > 0 ? resize_short : out_w;
  if (!decode_jpeg(data, size, &rgb, &w, &h, min_h, min_w)) return false;
  if (resize_short <= 0) {
    // DCT scaling already lands within [1, 2) x of the target for any
    // source <= 8x; the octave loop only fires for truly enormous inputs
    while (h >= 2 * out_h && w >= 2 * out_w) box_halve(&rgb, &h, &w);
    resize_bilinear(rgb.data(), h, w, dst, out_h, out_w);
    return true;
  }
  while (h >= 2 * resize_short && w >= 2 * resize_short)
    box_halve(&rgb, &h, &w);
  const int short_side = h < w ? h : w;
  // round-half-away; the PIL path uses Python round() (half-to-even) — the
  // two differ only on exact .5 products, a sub-pixel boundary case
  const int nh = int(std::lround(double(h) * resize_short / short_side));
  const int nw = int(std::lround(double(w) * resize_short / short_side));
  if (nh < out_h || nw < out_w) return false;  // crop larger than resized
  std::vector<uint8_t> resized(size_t(nh) * nw * 3);
  resize_bilinear(rgb.data(), h, w, resized.data(), nh, nw);
  const int top = (nh - out_h) / 2;
  const int left = (nw - out_w) / 2;
  for (int y = 0; y < out_h; ++y) {
    std::memcpy(dst + size_t(y) * out_w * 3,
                resized.data() + (size_t(top + y) * nw + left) * 3,
                size_t(out_w) * 3);
  }
  return true;
}

std::shared_ptr<ThreadPool> pool;
int pool_size = 0;
std::mutex pool_mu;

// Callers hold a shared_ptr for the duration of their batch, so resizing
// the pool can't free it out from under a concurrent geovpr_decode_batch
// (ctypes releases the GIL — concurrent calls are real). The pool only
// grows: shrinking would thrash when two sources alternate thread counts.
std::shared_ptr<ThreadPool> get_pool(int threads) {
  std::lock_guard<std::mutex> lock(pool_mu);
  if (!pool || threads > pool_size) {
    pool = std::make_shared<ThreadPool>(threads);
    pool_size = threads;
  }
  return pool;
}

}  // namespace

extern "C" {

// Decode n JPEGs (concatenated in `blob`, item i spanning
// [offsets[i], offsets[i+1])) and bilinearly resize each to
// (out_h, out_w) RGB, writing into `out` (n * out_h * out_w * 3 bytes).
// ok[i] is set to 1 on success, 0 on decode failure (output slot zeroed —
// mirrors the reference's dummy-sample fallback, test_script.py:108-114).
// Returns the number of successfully decoded images.
int geovpr_decode_batch_ex(const uint8_t* blob, const int64_t* offsets, int n,
                           int out_h, int out_w, int resize_short,
                           uint8_t* out, uint8_t* ok, int threads) {
  // out_h/out_w <= 0 would make the box-halve loop below spin forever
  if (n <= 0 || out_h <= 0 || out_w <= 0) {
    for (int i = 0; i < n; ++i) ok[i] = 0;
    return 0;
  }
  std::shared_ptr<ThreadPool> tp = get_pool(threads > 0 ? threads : 8);
  std::atomic<int> good{0};
  // `done` is mutated and signaled UNDER done_mu: incrementing outside the
  // lock races the waiter's wakeup against this frame's destruction (the
  // last worker could notify a condvar that no longer exists)
  int done = 0;
  std::mutex done_mu;
  std::condition_variable done_cv;

  const size_t out_stride = size_t(out_h) * out_w * 3;
  for (int i = 0; i < n; ++i) {
    tp->submit([&, i] {
      const uint8_t* data = blob + offsets[i];
      const size_t size = size_t(offsets[i + 1] - offsets[i]);
      uint8_t* dst = out + size_t(i) * out_stride;
      bool success = false;
      try {
        success = process_one(data, size, out_h, out_w, resize_short, dst);
      } catch (...) {
        // an escaping exception would std::terminate the process from a
        // pool thread; the contract is ok[i]=0 + zeroed slot
        success = false;
      }
      if (success) {
        ok[i] = 1;
        good.fetch_add(1);
      } else {
        memset(dst, 0, out_stride);
        ok[i] = 0;
      }
      {
        std::lock_guard<std::mutex> lock(done_mu);
        ++done;
        done_cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lock(done_mu);
  done_cv.wait(lock, [&] { return done == n; });
  return good.load();
}

// Back-compatible entry: plain square resize (resize_short = 0).
int geovpr_decode_batch(const uint8_t* blob, const int64_t* offsets, int n,
                        int out_h, int out_w, uint8_t* out, uint8_t* ok,
                        int threads) {
  return geovpr_decode_batch_ex(blob, offsets, n, out_h, out_w, 0, out, ok,
                                threads);
}

// Probe: returns the libjpeg version the library was built against.
int geovpr_decoder_version() { return JPEG_LIB_VERSION; }
}

// Native emission tier: threaded JPEG/PNG encode + file write.
//
// The counterpart of the reference's encode/save stage
// (reference src/common.cpp:48-118 + the thread-3 loop at
// src/denseflow_gpu.cpp:396-477), kept as this package's own copy of the
// JAX package's emitter. The reference encodes and writes one image at a
// time on a single thread; this library fans a batch of already-quantized
// uint8 planes (quantization runs on the GPU) across a worker pool, with
// each worker doing libjpeg/libpng encode + fwrite.
//
// C ABI (used from Python via ctypes, native/__init__.py):
//   df_write_jpg_batch       - gray (n,h,w) planes -> one jpg each
//   df_write_jpg_color_batch - BGR  (n,h,w,3) frames -> one jpg each
//   df_write_png_batch       - BGR  (n,h,w,3) planes -> one png each
//
// File naming (infix/index offset) is decided by the Python layer so the
// grammar lives in exactly one place (io/writer.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegBuf {
    unsigned char* data = nullptr;
    unsigned long size = 0;
    ~JpegBuf() { free(data); }
};

// Encode one 8-bit image (gray: channels==1, BGR: channels==3) to JPEG.
bool encode_jpeg(const uint8_t* img, int h, int w, int channels, int quality,
                 JpegBuf* out) {
    jpeg_compress_struct cinfo;
    jpeg_error_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr);
    jpeg_create_compress(&cinfo);
    jpeg_mem_dest(&cinfo, &out->data, &out->size);
    cinfo.image_width = w;
    cinfo.image_height = h;
    cinfo.input_components = channels;
    cinfo.in_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_EXT_BGR;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    jpeg_start_compress(&cinfo, TRUE);
    const int stride = w * channels;
    while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row =
            const_cast<uint8_t*>(img + cinfo.next_scanline * stride);
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    return true;
}

struct PngMem {
    std::vector<uint8_t> bytes;
};

void png_write_cb(png_structp png, png_bytep data, png_size_t len) {
    auto* mem = static_cast<PngMem*>(png_get_io_ptr(png));
    mem->bytes.insert(mem->bytes.end(), data, data + len);
}

// Encode one 8-bit 3-channel BGR image to PNG (stored as RGB with channels
// swapped to match OpenCV's BGR-on-disk convention for its png writer,
// which writes channel order as-is after internal RGB conversion).
bool encode_png_bgr(const uint8_t* img, int h, int w, PngMem* out) {
    png_structp png =
        png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) return false;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_write_struct(&png, nullptr);
        return false;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_write_struct(&png, &info);
        return false;
    }
    png_set_write_fn(png, out, png_write_cb, nullptr);
    png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_RGB, PNG_INTERLACE_NONE,
                 PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
    png_write_info(png, info);
    png_set_bgr(png);  // input rows are BGR
    std::vector<png_bytep> rows(h);
    for (int y = 0; y < h; ++y)
        rows[y] = const_cast<uint8_t*>(img + y * w * 3);
    png_write_image(png, rows.data());
    png_write_end(png, nullptr);
    png_destroy_write_struct(&png, &info);
    return true;
}

bool write_file(const char* path, const void* data, size_t size) {
    FILE* fp = fopen(path, "wb");
    if (!fp) return false;
    size_t n = fwrite(data, 1, size, fp);
    fclose(fp);
    return n == size;
}

// Fan items [0, n) across a worker pool.
template <typename Fn>
int parallel_for(int n, int n_threads, Fn fn) {
    if (n_threads <= 1 || n <= 1) {
        for (int i = 0; i < n; ++i)
            if (!fn(i)) return i;
        return n;
    }
    std::atomic<int> next(0);
    std::atomic<int> failures(0);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n) return;
            if (!fn(i)) failures.fetch_add(1);
        }
    };
    std::vector<std::thread> pool;
    int k = std::min(n_threads, n);
    pool.reserve(k);
    for (int t = 0; t < k; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
    return failures.load() == 0 ? n : -1;
}

}  // namespace

extern "C" {

// imgs: (n, h, w) uint8 gray planes, C-contiguous.
// paths: n null-terminated file paths, concatenated with '\0' separators.
// Returns n on success, -1 on any failure.
int df_write_jpg_batch(const uint8_t* imgs, int n, int h, int w,
                       const char* paths, int quality, int n_threads) {
    std::vector<const char*> files(n);
    const char* p = paths;
    for (int i = 0; i < n; ++i) {
        files[i] = p;
        p += strlen(p) + 1;
    }
    const size_t plane = static_cast<size_t>(h) * w;
    return parallel_for(n, n_threads, [&](int i) {
        JpegBuf buf;
        if (!encode_jpeg(imgs + i * plane, h, w, 1, quality, &buf)) return false;
        return write_file(files[i], buf.data, buf.size);
    });
}

// imgs: (n, h, w, 3) uint8 BGR planes.
int df_write_png_batch(const uint8_t* imgs, int n, int h, int w,
                       const char* paths, int n_threads) {
    std::vector<const char*> files(n);
    const char* p = paths;
    for (int i = 0; i < n; ++i) {
        files[i] = p;
        p += strlen(p) + 1;
    }
    const size_t plane = static_cast<size_t>(h) * w * 3;
    return parallel_for(n, n_threads, [&](int i) {
        PngMem mem;
        if (!encode_png_bgr(imgs + i * plane, h, w, &mem)) return false;
        return write_file(files[i], mem.bytes.data(), mem.bytes.size());
    });
}

// Color jpg writer for the step=0 frame-extraction path: (n, h, w, 3) BGR.
int df_write_jpg_color_batch(const uint8_t* imgs, int n, int h, int w,
                             const char* paths, int quality, int n_threads) {
    std::vector<const char*> files(n);
    const char* p = paths;
    for (int i = 0; i < n; ++i) {
        files[i] = p;
        p += strlen(p) + 1;
    }
    const size_t plane = static_cast<size_t>(h) * w * 3;
    return parallel_for(n, n_threads, [&](int i) {
        JpegBuf buf;
        if (!encode_jpeg(imgs + i * plane, h, w, 3, quality, &buf)) return false;
        return write_file(files[i], buf.data, buf.size);
    });
}

}  // extern "C"

// Native PNG decode and encode for the SR data path (host IO).
//
// The port's copy of enph459_super_resolution_tpu/native/png_loader.cpp,
// with the same C ABI.  Session ingest is many PNG reads; here decode runs
// in C++ against libpng, with a std::thread worker pool for batch loads,
// and every artifact is written by libpng at a caller-chosen zlib level
// with the Sub filter.  Exposed through a minimal C ABI consumed with
// ctypes (native/png_loader.py); native/build.py compiles it with g++ at
// first use into the package's git-ignored _build_out/.
//
// Build: python -m enph459_super_resolution_tpu_torch.native.build

#include <png.h>

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Decode one PNG. Returns 0 on success; caller frees *data with srpng_free.
// Output is 8-bit (16-bit PNGs are scaled down), (height x width x
// channels) row-major.
int srpng_load(const char* path, int* height, int* width, int* channels,
               unsigned char** data) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;

  unsigned char header[8];
  if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(fp);
    return 2;
  }

  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return 3;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    fclose(fp);
    return 3;
  }
  // volatile: both locals are written between setjmp and a potential
  // longjmp — without volatile their values after the jump are
  // indeterminate (C11) and free()/delete[] would be UB.  Plain arrays
  // (not std::vector) so no non-trivial destructor can be skipped.
  unsigned char* volatile buf = nullptr;
  png_bytep* volatile rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {  // libpng error path
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    free(buf);
    delete[] rows;
    return 4;
  }

  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  // normalize to 8-bit gray / gray+alpha / rgb / rgba
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bit_depth == 16) png_set_scale_16(png);
  png_read_update_info(png, info);

  int ch = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  buf = static_cast<unsigned char*>(malloc(rowbytes * h));
  if (!buf) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 5;
  }
  rows = new png_bytep[h];
  for (png_uint_32 r = 0; r < h; ++r) rows[r] = buf + r * rowbytes;
  png_read_image(png, rows);
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  delete[] rows;

  *height = static_cast<int>(h);
  *width = static_cast<int>(w);
  *channels = ch;
  *data = buf;
  return 0;
}

void srpng_free(unsigned char* data) { free(data); }

// Batch decode with a worker pool.  For each path i, outputs[i] receives
// the pixel buffer (or nullptr on error) and dims go to heights/widths/
// channels.  Returns the number of failures.
int srpng_load_batch(const char** paths, int n, int n_threads, int* heights,
                     int* widths, int* channels, unsigned char** outputs) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);

  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = srpng_load(paths[i], &heights[i], &widths[i], &channels[i],
                          &outputs[i]);
      if (rc != 0) {
        outputs[i] = nullptr;
        heights[i] = widths[i] = channels[i] = 0;
        failures.fetch_add(1);
      }
    }
  };

  std::vector<std::thread> pool;
  int nt = n_threads < n ? n_threads : n;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

// Encode one 8-bit gray/gray+alpha/RGB/RGBA image.  Returns 0 on success.
//
// PIL's default encode is zlib level 6 with adaptive filtering; the
// pipeline writes several 3072x4096 frames per unit, and libpng at zlib
// level 1 with Sub filtering encodes several times faster at a similar
// size on natural images.  Pixel content is identical (PNG is lossless).
int srpng_write(const char* path, const unsigned char* data, int height,
                int width, int channels, int compress_level) {
  int color_type;
  switch (channels) {
    case 1: color_type = PNG_COLOR_TYPE_GRAY; break;
    case 2: color_type = PNG_COLOR_TYPE_GRAY_ALPHA; break;
    case 3: color_type = PNG_COLOR_TYPE_RGB; break;
    case 4: color_type = PNG_COLOR_TYPE_RGBA; break;
    default: return 6;
  }
  FILE* fp = fopen(path, "wb");
  if (!fp) return 1;
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                              nullptr);
  if (!png) {
    fclose(fp);
    return 3;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    fclose(fp);
    return 3;
  }
  // Row-pointer table lives BEFORE setjmp: libpng errors longjmp over
  // everything below, which must not skip a live C++ destructor.
  size_t rowbytes = static_cast<size_t>(width) * channels;
  std::vector<png_bytep> rows(height);
  for (int r = 0; r < height; ++r)
    rows[r] = const_cast<png_bytep>(data + r * rowbytes);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return 4;
  }
  png_init_io(png, fp);
  png_set_compression_level(png, compress_level);
  png_set_filter(png, 0, PNG_FILTER_SUB);
  png_set_IHDR(png, info, width, height, 8, color_type, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  png_write_image(png, rows.data());
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return 0;
}

}  // extern "C"

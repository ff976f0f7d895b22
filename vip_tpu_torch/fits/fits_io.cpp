// FITS data-block codec of vip_tpu_torch.fits (a copy of vip_tpu's
// fits/fits_io.cpp, loaded with ctypes by fits/_native.py).
//
// FITS stores array data big-endian. Decoding a cube is a byteswap and a
// conversion over every element: this file does it from an mmap of the
// file with one thread per core, and encodes (byteswaps) float32/float64
// arrays for the writer the same way. The Python side parses the
// 2880-byte header blocks.
//
// Semantics, which fits/_native.py's plain numpy versions repeat:
// - with BSCALE = 1 and BZERO = 0 each element is converted straight to
//   the output type (a C cast, as numpy's astype);
// - otherwise bscale * v + bzero is computed in double (v converted to
//   double first) and the result converted to the output type. The
//   build passes -ffp-contract=off so that no multiply-add is fused.
//
// Return codes of fits_decode_*: 0 done; -1 the file does not open; -2
// fstat fails; -3 the file is shorter than offset + the data block; -4
// mmap fails; -5 BITPIX is not one of 8, 16, 32, 64, -32, -64.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off
//        -o libfits_io.so fits_io.cpp -lpthread

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

inline uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }
inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
inline uint64_t bswap64(uint64_t v) { return __builtin_bswap64(v); }

// The native value of element i of a big-endian block of type T.
inline uint8_t load_be(const uint8_t *p, int64_t i, uint8_t) { return p[i]; }
inline int16_t load_be(const uint8_t *p, int64_t i, int16_t) {
    uint16_t b;
    std::memcpy(&b, p + 2 * i, 2);
    return static_cast<int16_t>(bswap16(b));
}
inline int32_t load_be(const uint8_t *p, int64_t i, int32_t) {
    uint32_t b;
    std::memcpy(&b, p + 4 * i, 4);
    return static_cast<int32_t>(bswap32(b));
}
inline int64_t load_be(const uint8_t *p, int64_t i, int64_t) {
    uint64_t b;
    std::memcpy(&b, p + 8 * i, 8);
    return static_cast<int64_t>(bswap64(b));
}
inline float load_be(const uint8_t *p, int64_t i, float) {
    uint32_t b;
    std::memcpy(&b, p + 4 * i, 4);
    b = bswap32(b);
    float v;
    std::memcpy(&v, &b, 4);
    return v;
}
inline double load_be(const uint8_t *p, int64_t i, double) {
    uint64_t b;
    std::memcpy(&b, p + 8 * i, 8);
    b = bswap64(b);
    double v;
    std::memcpy(&v, &b, 8);
    return v;
}

template <typename InT, typename OutT>
void decode_typed(const uint8_t *src, OutT *dst, int64_t n, bool scaled,
                  double bscale, double bzero) {
    if (scaled) {
        for (int64_t i = 0; i < n; ++i)
            dst[i] = static_cast<OutT>(
                bscale * static_cast<double>(load_be(src, i, InT())) + bzero);
    } else {
        for (int64_t i = 0; i < n; ++i)
            dst[i] = static_cast<OutT>(load_be(src, i, InT()));
    }
}

template <typename OutT>
void decode_range(const uint8_t *src, OutT *dst, int64_t n, int bitpix,
                  double bscale, double bzero) {
    const bool scaled = !(bscale == 1.0 && bzero == 0.0);
    switch (bitpix) {
    case 8: decode_typed<uint8_t>(src, dst, n, scaled, bscale, bzero); break;
    case 16: decode_typed<int16_t>(src, dst, n, scaled, bscale, bzero); break;
    case 32: decode_typed<int32_t>(src, dst, n, scaled, bscale, bzero); break;
    case 64: decode_typed<int64_t>(src, dst, n, scaled, bscale, bzero); break;
    case -32: decode_typed<float>(src, dst, n, scaled, bscale, bzero); break;
    case -64: decode_typed<double>(src, dst, n, scaled, bscale, bzero); break;
    }
}

// f(lo, hi) over [0, n) on one thread per core, at least 1M elements each.
template <typename F>
void parallel_ranges(int64_t n, F f) {
    unsigned hw = std::thread::hardware_concurrency();
    const int64_t min_per_thread = 1 << 20;
    int nthreads = static_cast<int>(std::max<int64_t>(
        1, std::min<int64_t>(hw ? hw : 1, n / min_per_thread)));
    if (nthreads <= 1) {
        f(int64_t(0), n);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = std::min<int64_t>(n, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back([=]() { f(lo, hi); });
    }
    for (auto &th : threads) th.join();
}

template <typename OutT>
int decode_file(const char *path, int64_t offset, int64_t n, int bitpix,
                double bscale, double bzero, OutT *dst) {
    switch (bitpix) {
    case 8: case 16: case 32: case 64: case -32: case -64:
        break;
    default:
        return -5;
    }
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return -2; }
    const int64_t elsize = std::abs(bitpix) / 8;
    const int64_t nbytes = n * elsize;
    if (offset + nbytes > st.st_size) { close(fd); return -3; }
    if (nbytes == 0) { close(fd); return 0; }

    // map from the page that holds the offset
    const int64_t page = sysconf(_SC_PAGESIZE);
    const int64_t base = offset / page * page;
    const size_t len = static_cast<size_t>(offset - base + nbytes);
    void *map = mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, base);
    if (map == MAP_FAILED) { close(fd); return -4; }
    madvise(map, len, MADV_SEQUENTIAL);
    const uint8_t *src = static_cast<const uint8_t *>(map) + (offset - base);
    parallel_ranges(n, [=](int64_t lo, int64_t hi) {
        decode_range(src + lo * elsize, dst + lo, hi - lo, bitpix, bscale,
                     bzero);
    });
    munmap(map, len);
    close(fd);
    return 0;
}

template <typename W>
void encode_typed(const W *src, W *dst, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        W b = src[i];
        if (sizeof(W) == 4) dst[i] = bswap32(static_cast<uint32_t>(b));
        else dst[i] = bswap64(static_cast<uint64_t>(b));
    }
}

}  // namespace

extern "C" {

int fits_decode_f32(const char *path, int64_t offset, int64_t n, int bitpix,
                    double bscale, double bzero, float *dst) {
    return decode_file(path, offset, n, bitpix, bscale, bzero, dst);
}

int fits_decode_f64(const char *path, int64_t offset, int64_t n, int bitpix,
                    double bscale, double bzero, double *dst) {
    return decode_file(path, offset, n, bitpix, bscale, bzero, dst);
}

// Big-endian bytes of n native float32 (width 4) or float64 (width 8)
// values.
void fits_encode(const void *src, void *dst, int64_t n, int width) {
    parallel_ranges(n, [=](int64_t lo, int64_t hi) {
        if (width == 4)
            encode_typed(static_cast<const uint32_t *>(src) + lo,
                         static_cast<uint32_t *>(dst) + lo, hi - lo);
        else
            encode_typed(static_cast<const uint64_t *>(src) + lo,
                         static_cast<uint64_t *>(dst) + lo, hi - lo);
    });
}

}  // extern "C"

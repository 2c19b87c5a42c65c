// Undo the PNG row filters (PNG spec, section 9) of one non-interlaced image.
//
// src holds `height` scanlines of 1 + row_bytes bytes each: the filter-type
// byte, then the filtered bytes. dst receives height * row_bytes unfiltered
// bytes. bpp is the number of bytes of one whole pixel (at least 1; a 16-bit
// sample counts two), the distance at which Sub, Average and Paeth find the
// byte to the left. Returns 0, or 1 + the index of the first row whose filter
// type is not 0-4.
//
// Built with g++ at first use by slam_framework_torch/io/png.py (ctypes).

#include <cstdint>
#include <cstdlib>
#include <cstring>

static inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

extern "C" int64_t png_unfilter(const uint8_t* src, int64_t height, int64_t row_bytes,
                                int32_t bpp, uint8_t* dst) {
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t* in = src + y * (row_bytes + 1);
        const uint8_t type = in[0];
        ++in;
        uint8_t* out = dst + y * row_bytes;
        // the row above, or none (all zeros) for the first row
        const uint8_t* up = y > 0 ? dst + (y - 1) * row_bytes : nullptr;
        switch (type) {
            case 0:
                std::memcpy(out, in, row_bytes);
                break;
            case 1:
                for (int64_t i = 0; i < row_bytes; ++i)
                    out[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? out[i - bpp] : 0));
                break;
            case 2:
                for (int64_t i = 0; i < row_bytes; ++i)
                    out[i] = static_cast<uint8_t>(in[i] + (up ? up[i] : 0));
                break;
            case 3:
                for (int64_t i = 0; i < row_bytes; ++i) {
                    const int a = i >= bpp ? out[i - bpp] : 0;
                    const int b = up ? up[i] : 0;
                    out[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int64_t i = 0; i < row_bytes; ++i) {
                    const int a = i >= bpp ? out[i - bpp] : 0;
                    const int b = up ? up[i] : 0;
                    const int c = (up && i >= bpp) ? up[i - bpp] : 0;
                    out[i] = static_cast<uint8_t>(in[i] + paeth(a, b, c));
                }
                break;
            default:
                return y + 1;
        }
    }
    return 0;
}

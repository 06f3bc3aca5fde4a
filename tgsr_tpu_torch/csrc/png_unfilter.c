/* PNG row filters undone (PNG specification, section 9) for
 * tgsr_tpu_torch/data/codec.py: host code, compiled by the system's C
 * compiler. Each byte needs the result of the byte `bpp` to its left, so
 * Python would take a step per byte; here the whole image is one call,
 * made through ctypes without the interpreter lock, so that request
 * threads decoding uploads do not hold up the rest of the server.
 *
 * rows: h rows of one filter byte (0-4, checked by the caller) and `stride`
 * bytes; out: the h x stride image bytes. */
#include <stdint.h>
#include <stdlib.h>

static int paeth(int a, int b, int c) {
    int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
    return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

void png_unfilter(const uint8_t *rows, uint8_t *out, long long h, long long stride, int bpp) {
    for (long long y = 0; y < h; ++y) {
        const uint8_t *line = rows + y * (stride + 1) + 1;
        const int kind = line[-1];
        uint8_t *cur = out + y * stride;
        const uint8_t *up = y > 0 ? cur - stride : NULL;
        for (long long i = 0; i < stride; ++i) {
            const int a = i >= bpp ? cur[i - bpp] : 0;
            const int b = up ? up[i] : 0;
            const int c = (up && i >= bpp) ? up[i - bpp] : 0;
            int pred = 0;
            switch (kind) {
                case 1: pred = a; break;
                case 2: pred = b; break;
                case 3: pred = (a + b) >> 1; break;
                case 4: pred = paeth(a, b, c); break;
                default: break;
            }
            cur[i] = (uint8_t)(line[i] + pred);
        }
    }
}

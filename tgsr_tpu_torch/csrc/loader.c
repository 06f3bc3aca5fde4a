/* The host loader's crop for tgsr_tpu_torch/native: a window of PIL's
 * bilinear resize of a uint8 RGB image, bit for bit what
 * `codec.resize_pil(img, (rh, rw), "bilinear")[top:top + oh, left:left + ow]`
 * gives (Pillow's libImaging/Resample.c: the triangle filter, its support
 * widened by the scale when downsampling, weights normalised in double and
 * rounded to 22 fraction bits, the horizontal pass then the vertical, each
 * rounded and clipped to uint8; a dimension whose size does not change is
 * not resampled). Only the window's columns and rows are computed. Host
 * code, compiled by the system's C compiler; ctypes calls it without the
 * interpreter lock, so that loader threads run side by side.
 *
 * Returns 0, or 1 when out of memory. */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define PRECISION_BITS 22

typedef struct {
    int *start, *taps;
    int32_t *k; /* [out][max_taps] */
    int max_taps;
} Coeffs;

static double triangle(double x) {
    if (x < 0.0) x = -x;
    return x < 1.0 ? 1.0 - x : 0.0;
}

/* Pillow's precompute_coeffs + normalize_coeffs_8bpc for outputs
 * [first, first + n) of an in_size -> out_size resize */
static int coeffs(int in_size, int out_size, int first, int n, Coeffs *c) {
    const double scale = (double)in_size / out_size;
    const double filterscale = scale > 1.0 ? scale : 1.0;
    const double support = 1.0 * filterscale, ss = 1.0 / filterscale;
    c->max_taps = (int)(support * 2) + 3;
    c->start = malloc(sizeof(int) * (size_t)n);
    c->taps = malloc(sizeof(int) * (size_t)n);
    c->k = malloc(sizeof(int32_t) * (size_t)n * (size_t)c->max_taps);
    double *w = malloc(sizeof(double) * (size_t)c->max_taps);
    if (!c->start || !c->taps || !c->k || !w) {
        free(w);
        return 1;
    }
    for (int i = 0; i < n; i++) {
        const int xx = first + i;
        const double center = (xx + 0.5) * scale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        if (xmax > c->max_taps) xmax = c->max_taps;
        double ww = 0.0;
        for (int x = 0; x < xmax; x++) {
            w[x] = triangle(((double)(x + xmin) - center + 0.5) * ss);
            ww += w[x];
        }
        for (int x = 0; x < xmax; x++) {
            const double v = ww != 0.0 ? w[x] / ww : w[x];
            const double scaled = v * (double)(1 << PRECISION_BITS);
            c->k[(size_t)i * c->max_taps + x] = (int32_t)(v < 0 ? scaled - 0.5 : scaled + 0.5);
        }
        c->start[i] = xmin;
        c->taps[i] = xmax;
    }
    free(w);
    return 0;
}

static void release(Coeffs *c) {
    free(c->start);
    free(c->taps);
    free(c->k);
}

static inline uint8_t clip8(int64_t ss) {
    ss >>= PRECISION_BITS;
    return (uint8_t)(ss < 0 ? 0 : ss > 255 ? 255 : ss);
}

int resize_crop_bilinear(const uint8_t *src, int h, int w, int rh, int rw, int top, int left,
                         int oh, int ow, uint8_t *out) {
    const int C = 3;
    const int64_t half = (int64_t)1 << (PRECISION_BITS - 1);
    Coeffs cx = {0}, cy = {0};
    /* horizontal pass, the window's columns, over the rows the vertical pass reads */
    int y0 = 0, y1 = h;
    if (rh != h) {
        if (coeffs(h, rh, top, oh, &cy)) goto oom;
        y0 = cy.start[0];
        y1 = cy.start[oh - 1] + cy.taps[oh - 1];
        for (int i = 0; i < oh; i++) { /* the taps need not be monotone */
            if (cy.start[i] < y0) y0 = cy.start[i];
            if (cy.start[i] + cy.taps[i] > y1) y1 = cy.start[i] + cy.taps[i];
        }
    } else {
        y0 = top;
        y1 = top + oh;
    }
    uint8_t *mid = malloc((size_t)(y1 - y0) * ow * C);
    if (!mid) goto oom;
    if (rw != w) {
        if (coeffs(w, rw, left, ow, &cx)) {
            free(mid);
            goto oom;
        }
        for (int y = y0; y < y1; y++) {
            const uint8_t *row = src + (size_t)y * w * C;
            uint8_t *o = mid + (size_t)(y - y0) * ow * C;
            for (int x = 0; x < ow; x++) {
                const int32_t *k = cx.k + (size_t)x * cx.max_taps;
                const uint8_t *p = row + (size_t)cx.start[x] * C;
                for (int c = 0; c < C; c++) {
                    int64_t ss = half;
                    for (int t = 0; t < cx.taps[x]; t++) ss += (int64_t)p[t * C + c] * k[t];
                    o[x * C + c] = clip8(ss);
                }
            }
        }
    } else {
        for (int y = y0; y < y1; y++)
            memcpy(mid + (size_t)(y - y0) * ow * C, src + ((size_t)y * w + left) * C,
                   (size_t)ow * C);
    }
    if (rh != h) {
        for (int i = 0; i < oh; i++) {
            const int32_t *k = cy.k + (size_t)i * cy.max_taps;
            uint8_t *o = out + (size_t)i * ow * C;
            for (int x = 0; x < ow * C; x++) {
                int64_t ss = half;
                for (int t = 0; t < cy.taps[i]; t++)
                    ss += (int64_t)mid[(size_t)(cy.start[i] + t - y0) * ow * C + x] * k[t];
                o[x] = clip8(ss);
            }
        }
    } else {
        memcpy(out, mid, (size_t)oh * ow * C);
    }
    free(mid);
    release(&cx);
    release(&cy);
    return 0;
oom:
    release(&cx);
    release(&cy);
    return 1;
}

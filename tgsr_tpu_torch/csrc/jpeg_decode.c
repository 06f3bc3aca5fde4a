/* JPEG decoder for tgsr_tpu_torch/data/codec.py: host code, compiled by
 * the system's C compiler (no libjpeg). Its output is what PIL's
 * `Image.open(f).convert("RGB")` gives through libjpeg with its defaults,
 * bit for bit:
 *
 * - baseline, extended (SOF1) and progressive (SOF2) Huffman coding, 8-bit
 *   samples, 1, 3 or 4 components, any integral sampling factors, restart
 *   intervals, several scans;
 * - the JDCT_ISLOW integer IDCT (jidctint.c) with libjpeg's post-IDCT
 *   range-limit table (wrapping outside +-512, as the table does);
 * - "fancy" upsampling: the triangle filters of jdsample.c for 2h1v, 1h2v
 *   and 2h2v (with their alternating rounding biases and edge cases),
 *   replication for every other integral factor;
 * - jdcolor.c's fixed-point YCbCr -> RGB tables; the colour space guessed
 *   as jdapimin.c guesses it (JFIF, Adobe transform, component ids);
 * - four components (Adobe CMYK / YCCK) as PIL reads them: YCCK -> CMYK by
 *   libjpeg, the inverted ("CMYK;I") samples, then PIL's cmyk2rgb.
 *
 * Anything libjpeg would only warn about and patch over (entropy data that
 * runs out, a bad Huffman code, a missing restart marker) is an error
 * here: the caller raises rather than return a patched image. Arithmetic
 * coding, lossless and 12-bit samples are refused by name.
 *
 * C interface (ctypes, called without the interpreter lock):
 *   jpeg_info(data, n, &w, &h, &ncomp, err, errlen)
 *   jpeg_decode_rgb(data, n, out, capacity, err, errlen)
 * both return 0 on success, else nonzero with a message in `err`. */
#include <setjmp.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* zig-zag index -> natural index, with libjpeg's 16 extra entries so that
 * a corrupt run past 63 lands on 63 instead of outside the block */
static const int NATURAL[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

typedef struct {
    uint8_t counts[17];
    uint8_t vals[256];
    int32_t maxcode[18], mincode[17], valptr[17];
    uint8_t look_len[256], look_sym[256];
    int defined;
} Huff;

typedef struct {
    int id, h, v, tq;
    int dw, dh;   /* downsampled width and height */
    int wib, hib; /* blocks covering dw x dh */
    int bw, bh;   /* blocks allocated: the MCU grid's */
    int16_t *coef;
    uint8_t *plane; /* bw * 8 x bh * 8 samples after the IDCT */
    int32_t q[64];  /* quantisation table in natural order, latched */
    int latched, dcpred;
} Comp;

typedef struct {
    const uint8_t *d;
    size_t n, pos;
    uint32_t buf;
    int cnt, fake, marker_hit;
    jmp_buf jb;
    char *err;
    int errlen;
    int w, h, ncomp, progressive, hmax, vmax, mcux, mcuy, sof;
    Comp c[4];
    int32_t qt[4][64];
    int qdef[4];
    Huff dc[4], ac[4];
    int ri, eobrun;
    int jfif, adobe, transform;
    uint8_t *tmp;
} J;

static void fail(J *j, const char *msg) {
    snprintf(j->err, (size_t)j->errlen, "%s", msg);
    longjmp(j->jb, 1);
}

/* -- markers ---------------------------------------------------------- */

static int u8(J *j) {
    if (j->pos >= j->n) fail(j, "truncated JPEG (a marker segment runs past the end)");
    return j->d[j->pos++];
}

static int u16(J *j) {
    int hi = u8(j);
    return (hi << 8) | u8(j);
}

/* the next marker code; bytes that are not a marker are skipped, as libjpeg
 * skips them (it warns) */
static int next_marker(J *j) {
    for (;;) {
        while (j->pos < j->n && j->d[j->pos] != 0xFF) j->pos++;
        while (j->pos < j->n && j->d[j->pos] == 0xFF) j->pos++;
        if (j->pos >= j->n) fail(j, "truncated JPEG (no end-of-image marker)");
        int m = j->d[j->pos++];
        if (m != 0) return m;
    }
}

static void read_dqt(J *j) {
    int len = u16(j) - 2;
    while (len > 0) {
        int pq = u8(j), t = pq & 15, p = pq >> 4;
        if (t > 3 || p > 1) fail(j, "corrupt JPEG: bad DQT table");
        for (int k = 0; k < 64; k++) j->qt[t][NATURAL[k]] = p ? u16(j) : u8(j);
        j->qdef[t] = 1;
        len -= 1 + 64 * (p + 1);
    }
    if (len != 0) fail(j, "corrupt JPEG: bad DQT length");
}

static void build_huff(J *j, Huff *h) {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
        h->valptr[l] = k;
        h->mincode[l] = code;
        code += h->counts[l];
        k += h->counts[l];
        if (code >= (1 << l)) fail(j, "corrupt JPEG: bad Huffman table"); /* all-ones code */
        h->maxcode[l] = h->counts[l] ? code - 1 : -1;
        code <<= 1;
    }
    h->maxcode[17] = 0x7fffffff;
    memset(h->look_len, 0, sizeof h->look_len);
    code = 0;
    k = 0;
    for (int l = 1; l <= 8; l++) {
        for (int i = 0; i < h->counts[l]; i++, k++, code++) {
            int lo = code << (8 - l), n = 1 << (8 - l);
            for (int m = 0; m < n; m++) {
                h->look_len[lo + m] = (uint8_t)l;
                h->look_sym[lo + m] = h->vals[k];
            }
        }
        code <<= 1;
    }
    h->defined = 1;
}

static void read_dht(J *j) {
    int len = u16(j) - 2;
    while (len > 16) {
        int tc = u8(j), cls = tc >> 4, t = tc & 15, total = 0;
        if (cls > 1 || t > 3) fail(j, "corrupt JPEG: bad DHT table");
        Huff *h = cls ? &j->ac[t] : &j->dc[t];
        h->counts[0] = 0;
        for (int l = 1; l <= 16; l++) total += h->counts[l] = (uint8_t)u8(j);
        if (total > 256 || 17 + total > len) fail(j, "corrupt JPEG: bad DHT table");
        for (int i = 0; i < total; i++) {
            h->vals[i] = (uint8_t)u8(j);
            if (!cls && h->vals[i] > 15) fail(j, "corrupt JPEG: bad DC Huffman table");
        }
        build_huff(j, h);
        len -= 17 + total;
    }
    if (len != 0) fail(j, "corrupt JPEG: bad DHT length");
}

static void read_sof(J *j, int marker) {
    if (j->sof) fail(j, "corrupt JPEG: two frame headers");
    int len = u16(j), precision = u8(j);
    j->h = u16(j);
    j->w = u16(j);
    j->ncomp = u8(j);
    if (precision != 8) {
        snprintf(j->err, (size_t)j->errlen,
                 "%d-bit JPEG samples are not supported (8-bit only)", precision);
        longjmp(j->jb, 1);
    }
    if (j->h == 0) fail(j, "JPEG height given by a DNL marker is not supported");
    if (j->w == 0) fail(j, "corrupt JPEG: width 0");
    if (j->ncomp != 1 && j->ncomp != 3 && j->ncomp != 4) {
        snprintf(j->err, (size_t)j->errlen, "JPEG with %d components is not supported",
                 j->ncomp);
        longjmp(j->jb, 1);
    }
    if (len != 8 + 3 * j->ncomp) fail(j, "corrupt JPEG: bad SOF length");
    j->progressive = marker == 0xC2;
    j->hmax = j->vmax = 1;
    for (int i = 0; i < j->ncomp; i++) {
        Comp *c = &j->c[i];
        c->id = u8(j);
        int hv = u8(j);
        c->h = hv >> 4;
        c->v = hv & 15;
        c->tq = u8(j);
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3)
            fail(j, "corrupt JPEG: bad component in the frame header");
        if (c->h > j->hmax) j->hmax = c->h;
        if (c->v > j->vmax) j->vmax = c->v;
    }
    j->mcux = (j->w + 8 * j->hmax - 1) / (8 * j->hmax);
    j->mcuy = (j->h + 8 * j->vmax - 1) / (8 * j->vmax);
    j->sof = 1;
}

static void read_app(J *j, int marker) {
    int len = u16(j) - 2;
    if (len < 0 || j->pos + (size_t)len > j->n) fail(j, "truncated JPEG (an APP segment runs past the end)");
    const uint8_t *p = j->d + j->pos;
    if (marker == 0xE0 && len >= 14 && !memcmp(p, "JFIF\0", 5)) j->jfif = 1;
    if (marker == 0xEE && len >= 12 && !memcmp(p, "Adobe", 5)) {
        j->adobe = 1;
        j->transform = p[11];
    }
    j->pos += (size_t)len;
}

static void skip_segment(J *j) {
    int len = u16(j) - 2;
    if (len < 0 || j->pos + (size_t)len > j->n) fail(j, "truncated JPEG (a segment runs past the end)");
    j->pos += (size_t)len;
}

/* -- entropy-coded data ------------------------------------------------- */

/* Keeps at least 25 bits in the buffer. At a marker or the end of the data
 * zero bits are appended (as libjpeg does); consuming one of them means the
 * data ran out, which is an error here. */
static void fill(J *j) {
    while (j->cnt <= 24) {
        int b = 0;
        if (!j->marker_hit && j->pos < j->n) {
            b = j->d[j->pos];
            if (b == 0xFF) {
                size_t p = j->pos + 1;
                while (p < j->n && j->d[p] == 0xFF) p++;
                if (p < j->n && j->d[p] == 0) {
                    j->pos = p + 1;
                } else {
                    j->marker_hit = 1;
                    b = 0;
                }
            } else {
                j->pos++;
            }
        } else {
            j->marker_hit = 1;
        }
        if (j->marker_hit) j->fake += 8;
        j->buf |= (uint32_t)b << (24 - j->cnt);
        j->cnt += 8;
    }
}

static void consume(J *j, int n) {
    j->buf <<= n;
    j->cnt -= n;
    if (j->cnt < j->fake) fail(j, "corrupt or truncated JPEG (entropy-coded data runs out)");
}

static int get_bits(J *j, int n) {
    if (n == 0) return 0;
    fill(j);
    int v = (int)(j->buf >> (32 - n));
    consume(j, n);
    return v;
}

static int get_bit(J *j) { return get_bits(j, 1); }

static int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (int)(-1u << s) + 1 : v; }

static int decode(J *j, const Huff *h) {
    fill(j);
    int look = (int)(j->buf >> 24), l = h->look_len[look];
    if (l) {
        consume(j, l);
        return h->look_sym[look];
    }
    for (l = 9; l <= 16; l++) {
        int32_t code = (int32_t)(j->buf >> (32 - l));
        if (code <= h->maxcode[l]) {
            consume(j, l);
            return h->vals[h->valptr[l] + code - h->mincode[l]];
        }
    }
    fail(j, "corrupt JPEG: bad Huffman code");
    return 0;
}

/* -- scans ---------------------------------------------------------------- */

typedef struct {
    int n, ss, se, ah, al;
    Comp *c[4];
    Huff *dc[4], *ac[4];
} Scan;

static void decode_block(J *j, const Scan *s, int ci, int16_t *blk) {
    Comp *c = s->c[ci];
    if (!j->progressive) {
        int t = decode(j, s->dc[ci]);
        int diff = t ? extend(get_bits(j, t), t) : 0;
        c->dcpred += diff;
        blk[0] = (int16_t)c->dcpred;
        for (int k = 1; k < 64; k++) {
            int rs = decode(j, s->ac[ci]), r = rs >> 4, t2 = rs & 15;
            if (t2) {
                k += r;
                blk[NATURAL[k]] = (int16_t)extend(get_bits(j, t2), t2);
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
        return;
    }
    if (s->ss == 0) { /* DC scans, possibly interleaved */
        if (s->ah == 0) {
            int t = decode(j, s->dc[ci]);
            int diff = t ? extend(get_bits(j, t), t) : 0;
            c->dcpred += diff;
            blk[0] = (int16_t)((unsigned)c->dcpred << s->al);
        } else if (get_bit(j)) {
            blk[0] = (int16_t)(blk[0] | (1 << s->al));
        }
        return;
    }
    if (s->ah == 0) { /* AC first pass */
        if (j->eobrun > 0) {
            j->eobrun--;
            return;
        }
        for (int k = s->ss; k <= s->se; k++) {
            int rs = decode(j, s->ac[ci]), r = rs >> 4, t = rs & 15;
            if (t) {
                k += r;
                blk[NATURAL[k]] = (int16_t)((unsigned)extend(get_bits(j, t), t) << s->al);
            } else if (r == 15) {
                k += 15;
            } else {
                j->eobrun = 1 << r;
                if (r) j->eobrun += get_bits(j, r);
                j->eobrun--;
                break;
            }
        }
        return;
    }
    /* AC refinement (jdphuff.c decode_mcu_AC_refine) */
    int p1 = 1 << s->al, m1 = (int)(-1u << s->al), k = s->ss;
    if (j->eobrun == 0) {
        for (; k <= s->se; k++) {
            int rs = decode(j, s->ac[ci]), r = rs >> 4, t = rs & 15, val = 0;
            if (t) {
                if (t != 1) fail(j, "corrupt JPEG: bad progressive refinement");
                val = get_bit(j) ? p1 : m1;
            } else if (r != 15) {
                j->eobrun = 1 << r;
                if (r) j->eobrun += get_bits(j, r);
                break;
            }
            do {
                int16_t *co = blk + NATURAL[k];
                if (*co != 0) {
                    if (get_bit(j) && (*co & p1) == 0) *co = (int16_t)(*co + (*co >= 0 ? p1 : m1));
                } else if (--r < 0) {
                    break;
                }
                k++;
            } while (k <= s->se);
            if (val) blk[NATURAL[k]] = (int16_t)val;
        }
    }
    if (j->eobrun > 0) {
        for (; k <= s->se; k++) {
            int16_t *co = blk + NATURAL[k];
            if (*co != 0 && get_bit(j) && (*co & p1) == 0)
                *co = (int16_t)(*co + (*co >= 0 ? p1 : m1));
        }
        j->eobrun--;
    }
}

static void reset_bits(J *j) {
    j->buf = 0;
    j->cnt = 0;
    j->fake = 0;
    j->marker_hit = 0;
}

/* at a restart boundary: the bits left over are padding; the next marker
 * must be RST(expect) */
static void restart(J *j, int expect) {
    if (j->cnt < j->fake) fail(j, "corrupt or truncated JPEG (entropy-coded data runs out)");
    reset_bits(j);
    int m = next_marker(j);
    if (m != 0xD0 + expect) fail(j, "corrupt JPEG: a restart marker is missing");
    for (int i = 0; i < j->ncomp; i++) j->c[i].dcpred = 0;
    j->eobrun = 0;
}

static void read_scan(J *j) {
    Scan s;
    int len = u16(j);
    s.n = u8(j);
    if (s.n < 1 || s.n > 4 || len != 6 + 2 * s.n) fail(j, "corrupt JPEG: bad scan header");
    if (!j->sof) fail(j, "corrupt JPEG: a scan before the frame header");
    for (int i = 0; i < s.n; i++) {
        int id = u8(j), tt = u8(j), ci;
        for (ci = 0; ci < j->ncomp; ci++)
            if (j->c[ci].id == id) break;
        if (ci == j->ncomp) fail(j, "corrupt JPEG: a scan names an unknown component");
        s.c[i] = &j->c[ci];
        s.dc[i] = &j->dc[tt >> 4 & 3];
        s.ac[i] = &j->ac[tt & 3];
        if ((tt >> 4) > 3 || (tt & 15) > 3) fail(j, "corrupt JPEG: bad table in a scan header");
    }
    s.ss = u8(j);
    s.se = u8(j);
    int a = u8(j);
    s.ah = a >> 4;
    s.al = a & 15;
    if (s.n > 1) {
        int blocks = 0;
        for (int i = 0; i < s.n; i++) blocks += s.c[i]->h * s.c[i]->v;
        if (blocks > 10) fail(j, "JPEG sampling factors too large for an interleaved scan");
    }
    if (j->progressive) {
        if (s.ss > s.se || s.se > 63 || (s.ss == 0 && s.se != 0) || (s.ss > 0 && s.n != 1) ||
            s.al > 13 || (s.ah && s.ah != s.al + 1))
            fail(j, "corrupt JPEG: bad progressive scan parameters");
    } else {
        s.ss = 0;
        s.se = 63;
    }
    for (int i = 0; i < s.n; i++) {
        Comp *c = s.c[i];
        if (!c->latched) { /* libjpeg latches a component's table at its first scan */
            if (!j->qdef[c->tq]) fail(j, "corrupt JPEG: a quantisation table is missing");
            memcpy(c->q, j->qt[c->tq], sizeof c->q);
            c->latched = 1;
        }
        if ((s.ss == 0 && s.ah == 0 && !s.dc[i]->defined) || (s.se > 0 && !s.ac[i]->defined))
            fail(j, "corrupt JPEG: a Huffman table is missing");
        c->dcpred = 0;
    }
    j->eobrun = 0;
    reset_bits(j);
    int rst = 0, todo = j->ri;
    if (s.n == 1) { /* non-interleaved: one block an MCU, over the component's own blocks */
        Comp *c = s.c[0];
        for (int by = 0; by < c->hib; by++)
            for (int bx = 0; bx < c->wib; bx++) {
                if (j->ri && todo == 0) {
                    restart(j, rst);
                    rst = (rst + 1) & 7;
                    todo = j->ri;
                }
                decode_block(j, &s, 0, c->coef + ((size_t)by * c->bw + bx) * 64);
                todo--;
            }
    } else {
        for (int my = 0; my < j->mcuy; my++)
            for (int mx = 0; mx < j->mcux; mx++) {
                if (j->ri && todo == 0) {
                    restart(j, rst);
                    rst = (rst + 1) & 7;
                    todo = j->ri;
                }
                for (int i = 0; i < s.n; i++) {
                    Comp *c = s.c[i];
                    for (int v = 0; v < c->v; v++)
                        for (int h = 0; h < c->h; h++) {
                            size_t by = (size_t)my * c->v + v, bx = (size_t)mx * c->h + h;
                            decode_block(j, &s, i, c->coef + (by * c->bw + bx) * 64);
                        }
                }
                todo--;
            }
    }
    if (j->cnt < j->fake) fail(j, "corrupt or truncated JPEG (entropy-coded data runs out)");
}

/* -- IDCT (jidctint.c, jpeg_idct_islow) ----------------------------------- */

#define CONST_BITS 13
#define PASS1_BITS 2
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

static uint8_t RANGE[1024]; /* libjpeg's post-IDCT range-limit table */

static void init_range(void) {
    for (int v = 0; v < 1024; v++)
        RANGE[v] = (uint8_t)(v < 128 ? v + 128 : v < 512 ? 255 : v < 896 ? 0 : v - 896);
}

static void idct_islow(const int16_t *in, const int32_t *q, uint8_t *out, int stride) {
    int32_t ws[64];
    for (int col = 0; col < 8; col++) {
        const int16_t *ip = in + col;
        const int32_t *qp = q + col;
        int32_t *wp = ws + col;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
            int32_t dc = (int32_t)((uint32_t)(ip[0] * qp[0]) << PASS1_BITS);
            for (int r = 0; r < 8; r++) wp[8 * r] = dc;
            continue;
        }
        int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = ip[16] * qp[16];
        z3 = ip[48] * qp[48];
        z1 = (z2 + z3) * 4433;
        t2 = z1 + z3 * -15137;
        t3 = z1 + z2 * 6270;
        z2 = ip[0] * qp[0];
        z3 = ip[32] * qp[32];
        t0 = (z2 + z3) * 8192;
        t1 = (z2 - z3) * 8192;
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = ip[56] * qp[56];
        t1 = ip[40] * qp[40];
        t2 = ip[24] * qp[24];
        t3 = ip[8] * qp[8];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * 9633;
        t0 *= 2446;
        t1 *= 16819;
        t2 *= 25172;
        t3 *= 12299;
        z1 *= -7373;
        z2 *= -20995;
        z3 *= -16069;
        z4 *= -3196;
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        wp[0] = (int32_t)DESCALE(t10 + t3, CONST_BITS - PASS1_BITS);
        wp[56] = (int32_t)DESCALE(t10 - t3, CONST_BITS - PASS1_BITS);
        wp[8] = (int32_t)DESCALE(t11 + t2, CONST_BITS - PASS1_BITS);
        wp[48] = (int32_t)DESCALE(t11 - t2, CONST_BITS - PASS1_BITS);
        wp[16] = (int32_t)DESCALE(t12 + t1, CONST_BITS - PASS1_BITS);
        wp[40] = (int32_t)DESCALE(t12 - t1, CONST_BITS - PASS1_BITS);
        wp[24] = (int32_t)DESCALE(t13 + t0, CONST_BITS - PASS1_BITS);
        wp[32] = (int32_t)DESCALE(t13 - t0, CONST_BITS - PASS1_BITS);
    }
    for (int row = 0; row < 8; row++) {
        const int32_t *wp = ws + 8 * row;
        uint8_t *op = out + (size_t)row * stride;
        const int sh = CONST_BITS + PASS1_BITS + 3;
        int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = wp[2];
        z3 = wp[6];
        z1 = (z2 + z3) * 4433;
        t2 = z1 + z3 * -15137;
        t3 = z1 + z2 * 6270;
        t0 = ((int64_t)wp[0] + wp[4]) * 8192;
        t1 = ((int64_t)wp[0] - wp[4]) * 8192;
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = wp[7];
        t1 = wp[5];
        t2 = wp[3];
        t3 = wp[1];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * 9633;
        t0 *= 2446;
        t1 *= 16819;
        t2 *= 25172;
        t3 *= 12299;
        z1 *= -7373;
        z2 *= -20995;
        z3 *= -16069;
        z4 *= -3196;
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        op[0] = RANGE[(int)DESCALE(t10 + t3, sh) & 1023];
        op[7] = RANGE[(int)DESCALE(t10 - t3, sh) & 1023];
        op[1] = RANGE[(int)DESCALE(t11 + t2, sh) & 1023];
        op[6] = RANGE[(int)DESCALE(t11 - t2, sh) & 1023];
        op[2] = RANGE[(int)DESCALE(t12 + t1, sh) & 1023];
        op[5] = RANGE[(int)DESCALE(t12 - t1, sh) & 1023];
        op[3] = RANGE[(int)DESCALE(t13 + t0, sh) & 1023];
        op[4] = RANGE[(int)DESCALE(t13 - t0, sh) & 1023];
    }
}

/* -- upsampling (jdsample.c) --------------------------------------------- */

/* component plane (stride ps, dw x dh valid) -> full-size w x h plane */
static void upsample(J *j, const Comp *c, uint8_t *out) {
    const int he = j->hmax / c->h, ve = j->vmax / c->v, W = j->w, H = j->h;
    const int ps = c->bw * 8, dw = c->dw, dh = c->dh;
    const uint8_t *p = c->plane;
    if (j->hmax % c->h || j->vmax % c->v) fail(j, "JPEG with fractional sampling factors is not supported");
    if (he == 1 && ve == 1) {
        for (int y = 0; y < H; y++) memcpy(out + (size_t)y * W, p + (size_t)y * ps, (size_t)W);
        return;
    }
    uint8_t *row = j->tmp; /* 2 * dw + 2 samples */
    if (he == 2 && ve == 1 && dw > 2) { /* h2v1_fancy_upsample */
        for (int y = 0; y < H; y++) {
            const uint8_t *in = p + (size_t)y * ps;
            uint8_t *o = row;
            int v = in[0];
            *o++ = (uint8_t)v;
            *o++ = (uint8_t)((v * 3 + in[1] + 2) >> 2);
            for (int x = 1; x < dw - 1; x++) {
                v = in[x] * 3;
                *o++ = (uint8_t)((v + in[x - 1] + 1) >> 2);
                *o++ = (uint8_t)((v + in[x + 1] + 2) >> 2);
            }
            v = in[dw - 1];
            *o++ = (uint8_t)((v * 3 + in[dw - 2] + 1) >> 2);
            *o++ = (uint8_t)v;
            memcpy(out + (size_t)y * W, row, (size_t)W);
        }
        return;
    }
    if (he == 1 && ve == 2) { /* h1v2_fancy_upsample */
        for (int y = 0; y < H; y++) {
            int iy = y >> 1, ny = (y & 1) ? iy + 1 : iy - 1, bias = (y & 1) ? 2 : 1;
            if (ny < 0) ny = 0;
            if (ny > dh - 1) ny = dh - 1;
            const uint8_t *i0 = p + (size_t)iy * ps, *i1 = p + (size_t)ny * ps;
            uint8_t *o = out + (size_t)y * W;
            for (int x = 0; x < W; x++) o[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
        }
        return;
    }
    if (he == 2 && ve == 2 && dw > 2) { /* h2v2_fancy_upsample */
        for (int y = 0; y < H; y++) {
            int iy = y >> 1, ny = (y & 1) ? iy + 1 : iy - 1;
            if (ny < 0) ny = 0;
            if (ny > dh - 1) ny = dh - 1;
            const uint8_t *i0 = p + (size_t)iy * ps, *i1 = p + (size_t)ny * ps;
            uint8_t *o = row;
            int this_ = i0[0] * 3 + i1[0], next = i0[1] * 3 + i1[1], last;
            *o++ = (uint8_t)((this_ * 4 + 8) >> 4);
            *o++ = (uint8_t)((this_ * 3 + next + 7) >> 4);
            last = this_;
            this_ = next;
            for (int x = 2; x < dw; x++) {
                next = i0[x] * 3 + i1[x];
                *o++ = (uint8_t)((this_ * 3 + last + 8) >> 4);
                *o++ = (uint8_t)((this_ * 3 + next + 7) >> 4);
                last = this_;
                this_ = next;
            }
            *o++ = (uint8_t)((this_ * 3 + last + 8) >> 4);
            *o++ = (uint8_t)((this_ * 4 + 7) >> 4);
            memcpy(out + (size_t)y * W, row, (size_t)W);
        }
        return;
    }
    for (int y = 0; y < H; y++) { /* h2v1_upsample, h2v2_upsample, int_upsample */
        const uint8_t *in = p + (size_t)(y / ve) * ps;
        uint8_t *o = out + (size_t)y * W;
        for (int x = 0; x < W; x++) o[x] = in[x / he];
    }
}

/* -- colour (jdcolor.c) and PIL's conversions ------------------------------ */

#define SCALEBITS 16
#define ONE_HALF ((int32_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int32_t)((x) * (1L << SCALEBITS) + 0.5))

static int CR_R[256], CB_B[256];
static int32_t CR_G[256], CB_G[256];

static void init_color(void) {
    for (int i = 0, x = -128; i < 256; i++, x++) {
        CR_R[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
        CB_B[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
        CR_G[i] = -FIX(0.71414) * x;
        CB_G[i] = -FIX(0.34414) * x + ONE_HALF;
    }
}

static inline uint8_t clamp8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

/* PIL's cmyk2rgb (Convert.c): MULDIV255 rounding */
static inline uint8_t cmyk_channel(int c, int nk) {
    int t = c * nk + 128;
    return clamp8(nk - (((t >> 8) + t) >> 8));
}

static void ycc(int y, int cb, int cr, int *r, int *g, int *b) {
    *r = y + CR_R[cr];
    *g = y + (int)((CB_G[cb] + CR_G[cr]) >> SCALEBITS);
    *b = y + CB_B[cb];
}

static void color_convert(J *j, uint8_t *const *pl, uint8_t *out) {
    const size_t n = (size_t)j->w * j->h;
    if (j->ncomp == 1) {
        for (size_t i = 0; i < n; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = pl[0][i];
        return;
    }
    if (j->ncomp == 3) {
        int rgb;
        if (j->jfif)
            rgb = 0;
        else if (j->adobe)
            rgb = j->transform == 0;
        else
            rgb = j->c[0].id == 'R' && j->c[1].id == 'G' && j->c[2].id == 'B';
        for (size_t i = 0; i < n; i++) {
            int r, g, b;
            if (rgb) {
                r = pl[0][i];
                g = pl[1][i];
                b = pl[2][i];
            } else {
                ycc(pl[0][i], pl[1][i], pl[2][i], &r, &g, &b);
            }
            out[3 * i] = clamp8(r);
            out[3 * i + 1] = clamp8(g);
            out[3 * i + 2] = clamp8(b);
        }
        return;
    }
    const int ycck = j->adobe && j->transform != 0;
    for (size_t i = 0; i < n; i++) {
        int cmyk[4];
        if (ycck) { /* ycck_cmyk_convert */
            int r, g, b;
            ycc(pl[0][i], pl[1][i], pl[2][i], &r, &g, &b);
            cmyk[0] = clamp8(255 - r);
            cmyk[1] = clamp8(255 - g);
            cmyk[2] = clamp8(255 - b);
        } else {
            cmyk[0] = pl[0][i];
            cmyk[1] = pl[1][i];
            cmyk[2] = pl[2][i];
        }
        cmyk[3] = pl[3][i];
        /* PIL's "CMYK;I" raw mode inverts every sample, then cmyk2rgb */
        int nk = cmyk[3]; /* 255 - (255 - k) */
        for (int c = 0; c < 3; c++) out[3 * i + c] = cmyk_channel(255 - cmyk[c], nk);
    }
}

/* -- entry points --------------------------------------------------------- */

/* the tables are made once, when the library is loaded */
__attribute__((constructor)) static void init_tables(void) {
    init_range();
    init_color();
}

static void parse_to_frame(J *j) {
    if (j->n < 3 || j->d[0] != 0xFF || j->d[1] != 0xD8) fail(j, "not a JPEG image");
    j->pos = 2;
    for (;;) {
        int m = next_marker(j);
        if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
            read_sof(j, m);
            return;
        }
        if (m == 0xC3 || m == 0xC5 || m == 0xC6 || m == 0xC7)
            fail(j, "lossless or hierarchical JPEG is not supported");
        if (m >= 0xC9 && m <= 0xCF && m != 0xCC)
            fail(j, "arithmetic-coded JPEG is not supported");
        if (m == 0xD9 || m == 0xDA) fail(j, "corrupt JPEG: no frame header");
        if (m == 0xDB)
            read_dqt(j);
        else if (m == 0xC4)
            read_dht(j);
        else if (m == 0xDD) {
            u16(j);
            j->ri = u16(j);
        } else if (m >= 0xE0 && m <= 0xEF)
            read_app(j, m);
        else if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01)
            continue;
        else
            skip_segment(j);
    }
}

int jpeg_info(const uint8_t *data, long long n, int *w, int *h, int *ncomp, char *err,
              int errlen) {
    J *j = calloc(1, sizeof(J));
    if (!j) {
        snprintf(err, (size_t)errlen, "out of memory");
        return 1;
    }
    j->d = data;
    j->n = (size_t)n;
    j->err = err;
    j->errlen = errlen;
    int rc = 0;
    if (setjmp(j->jb)) {
        rc = 1;
    } else {
        parse_to_frame(j);
        *w = j->w;
        *h = j->h;
        *ncomp = j->ncomp;
    }
    free(j);
    return rc;
}

static void release(J *j) {
    for (int i = 0; i < 4; i++) {
        free(j->c[i].coef);
        free(j->c[i].plane);
    }
    free(j->tmp);
}

static void run(J *j, uint8_t *out, long long cap) {
    parse_to_frame(j);
    if ((long long)j->w * j->h * 3 > cap) fail(j, "output buffer too small");
    for (int i = 0; i < j->ncomp; i++) {
        Comp *c = &j->c[i];
        c->dw = (int)(((long long)j->w * c->h + j->hmax - 1) / j->hmax);
        c->dh = (int)(((long long)j->h * c->v + j->vmax - 1) / j->vmax);
        c->wib = (c->dw + 7) / 8;
        c->hib = (c->dh + 7) / 8;
        c->bw = j->mcux * c->h;
        c->bh = j->mcuy * c->v;
        c->coef = calloc((size_t)c->bw * c->bh * 64, sizeof(int16_t));
        if (!c->coef) fail(j, "out of memory");
    }
    /* frame -> scans -> end of image */
    for (;;) {
        int m = next_marker(j);
        if (m == 0xD9) break;
        if (m == 0xDA)
            read_scan(j);
        else if (m == 0xDB)
            read_dqt(j);
        else if (m == 0xC4)
            read_dht(j);
        else if (m == 0xDD) {
            u16(j);
            j->ri = u16(j);
        } else if (m >= 0xE0 && m <= 0xEF)
            read_app(j, m);
        else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC)
            fail(j, "corrupt JPEG: a second frame header");
        else if (m == 0xDC)
            fail(j, "JPEG DNL marker is not supported");
        else if ((m >= 0xD0 && m <= 0xD7) || m == 0xD8 || m == 0x01)
            continue;
        else
            skip_segment(j);
    }
    for (int i = 0; i < j->ncomp; i++)
        if (!j->c[i].latched) fail(j, "corrupt JPEG: a component has no scan");
    uint8_t *planes[4] = {0};
    for (int i = 0; i < j->ncomp; i++) {
        Comp *c = &j->c[i];
        const int ps = c->bw * 8;
        c->plane = malloc((size_t)ps * c->bh * 8);
        if (!c->plane) fail(j, "out of memory");
        for (int by = 0; by < c->bh; by++)
            for (int bx = 0; bx < c->bw; bx++)
                idct_islow(c->coef + ((size_t)by * c->bw + bx) * 64, c->q,
                           c->plane + (size_t)by * 8 * ps + (size_t)bx * 8, ps);
        free(c->coef);
        c->coef = NULL;
    }
    size_t n = (size_t)j->w * j->h;
    j->tmp = malloc(2 * (size_t)j->w + 64 + n * (size_t)j->ncomp);
    if (!j->tmp) fail(j, "out of memory");
    for (int i = 0; i < j->ncomp; i++) {
        planes[i] = j->tmp + 2 * (size_t)j->w + 64 + n * (size_t)i;
        upsample(j, &j->c[i], planes[i]);
    }
    color_convert(j, planes, out);
}

int jpeg_decode_rgb(const uint8_t *data, long long n, uint8_t *out, long long cap, char *err,
                    int errlen) {
    J *j = calloc(1, sizeof(J));
    if (!j) {
        snprintf(err, (size_t)errlen, "out of memory");
        return 1;
    }
    j->d = data;
    j->n = (size_t)n;
    j->err = err;
    j->errlen = errlen;
    int rc = 0;
    if (setjmp(j->jb))
        rc = 1;
    else
        run(j, out, cap);
    release(j);
    free(j);
    return rc;
}

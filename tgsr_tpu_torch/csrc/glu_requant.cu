// GLU + requantize to int8, and requantization alone, for Hopper (sm_90a).
//
// Replaces examples/glu_pallas_probe.py `glu_requant_one` (:72, Pallas row 8)
// and `glu_requant_pair` (:96, row 9): h [N, 2c] bfloat16, value half first
// and gate half second for each pixel -> q [N, c] int8 with, per element,
//   s = bf16(sigmoid(float(g)))      (the gate in float32, rounded once)
//   p = bf16(float(v) * float(s))    (the product of two bf16 is exact in f32)
//   q = int8(rint(clamp(float(p) / step, -127, 127)))
// in the order of the probe's `_glu_q`: the pass of
// tgsr_tpu/engine/quant.py:239-241 followed by `quantize_act` (:137-142),
// round half to even. The third instance (C = 0, row X2) is the last line
// alone on a flat bfloat16 tensor: `quantize_act`, which the int8 path runs
// on the input of every int8 conv whose producer is not a GLU (XLA fuses it
// into the producer on the TPU).
//
// Bound: device memory. A GLU output reads 4 bytes and writes 1, a
// requantized element reads 2 and writes 1; a few tens of operations each,
// below the card's operations-per-byte line, but only if the arithmetic
// overlaps the loads. The design:
// - A thread owns units of 8 outputs: 8 channels of one pixel, whose values
//   and gates it loads as two 16-byte words straight from the row (no
//   shuffle; c = 64 takes 8 threads a pixel, c = 32 four), or 8 elements of
//   the flat tensor (one 16-byte word; the ragged tail masked by element).
//   It stores 8 int8 (8 bytes), so a warp writes 256 contiguous bytes.
// - One pass: a block of 256 threads takes 256 x UNROLL consecutive units
//   and ends, so the card overlaps one block's arithmetic with the next
//   blocks' loads. On the H100 at the main path's sizes this beat a grid of
//   resident blocks striding with several units a thread, whose loads and
//   arithmetic took turns (more registers, fewer warps); one unit a thread
//   was the fastest for the GLU, two for the flat pass, which then runs at
//   the speed of a plain copy of its bytes (PERF.md).
// - The common path is cheap (the precise one measured slower in this
//   design) and gives the precise formula's bits:
//   * gate: 1 / (1 + __expf(-g)) by __fdividef. Against the precise
//     __frcp_rn(1 + expf(-g)) it errs by at most 2 + 1.173 |g| ulps of
//     __expf, 2 of expf, 2 of __fdividef and half an ulp per rounding,
//     which is at most 12 + 2.4 |g| float32 ulps of the gate (an ulp of the
//     exponential is up to two of the gate's, one binade apart). Only a
//     float32 gate within that distance of a bfloat16 rounding boundary (its
//     low 16 bits near 0x8000) can round to another bfloat16, so the kernel
//     recomputes the precise formula when the low 16 bits lie within
//     32 + 4 |g| of 0x8000, or when |g| > 64 (outside the bound's range).
//     That is about 0.1 % of gates at |g| ~ 2.
//   * divide: t = p * r with r = 1 / step rounded once, on the host.
//     t and the IEEE quotient fl(p / step) are both within 2^-22 |t| of the
//     exact quotient, so rint(clamp(.)) of the two can differ only where a
//     half-integer lies within that of t. The kernel divides (`__fdiv_rn`)
//     when |t| < 256 and | |t| - floor|t| - 1/2 | <= 2^-20 |t|; beyond 256
//     both clamp to +-127. The test suite holds this rule, in numpy float32,
//     equal to division-then-rint over every finite bfloat16.
//   A warp takes a precise path only if one of its lanes needs it, and then
//   for that element slot alone.
//
// float32 instances (the int8 path with float32 compute, where the JAX
// package's quantized blocks keep their activations in float32): h or x
// float32, the same three passes with nothing rounded to bfloat16:
//   s = 1 / (1 + expf(-g)), p = v * s, q = int8(rint(clamp(p / step, -127, 127))).
// The gate's guard above rests on bfloat16 rounding and does not carry
// over, so the gate takes the precise formula everywhere: expf (the function
// PyTorch's CUDA sigmoid calls) and a correctly rounded reciprocal, each
// rounding written out (_rn), which is PyTorch's `1 / (1 + exp(-g))` in
// float32 bit for bit. The divide keeps the reciprocal and its guard: the
// argument above holds for any float32 p (t = fl(p * fl(1 / step)) and
// fl(p / step) lie within 2^-22 |t| of each other whatever p is; below 2^-126
// both round to 0, above 256 both clamp), so q equals division-then-rint bit
// for bit. A unit of 8 outputs then reads two 16-byte words of values (and
// two of gates) and still writes 8 bytes; the flat pass takes one unit a
// thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// 16-byte words that hold 8 elements of T: 1 of bfloat16, 2 of float32
template <typename T>
constexpr int WORDS = sizeof(T) / 2;

// units of 8 outputs a thread loads before computing: 1 for the GLU (two
// 16-byte loads a unit in bfloat16), 2 for the bfloat16 flat pass (one), 1
// for every float32 instance (its unit is already two or four loads)
template <int C, typename T>
constexpr int UNROLL = (C == 0 && sizeof(T) == 2) ? 2 : 1;

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// the 8 elements of a unit as float32: bfloat16 element 2i in the low half of
// 32-bit word i of one 16-byte word; float32 two words as they are
__device__ __forceinline__ void unpack8(const uint4 (&w)[1], float* f) {
    const uint32_t u[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(u[i] << 16);
        f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
}
__device__ __forceinline__ void unpack8(const uint4 (&w)[2], float* f) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        f[4 * i] = __uint_as_float(w[i].x);
        f[4 * i + 1] = __uint_as_float(w[i].y);
        f[4 * i + 2] = __uint_as_float(w[i].z);
        f[4 * i + 3] = __uint_as_float(w[i].w);
    }
}

// bf16(sigmoid(g)) with the bits of bf16(__frcp_rn(1 + expf(-g)))
__device__ __forceinline__ float gate(float g) {
    const float ag = fabsf(g);
    const float s = __fdividef(1.0f, 1.0f + __expf(-g));
    const float mid = fabsf((float)((int)(__float_as_uint(s) & 0xffffu) - 0x8000));
    if (!(ag <= 64.0f) || mid <= 32.0f + 4.0f * ag)
        return bf16_round(__frcp_rn(__fadd_rn(1.0f, expf(-g))));
    return bf16_round(s);
}

// the GLU product of one element: bf16(v * bf16(sigmoid(g))) in bfloat16,
// v * (1 / (1 + expf(-g))) in float32
template <typename T>
__device__ __forceinline__ float glu(float v, float g) {
    if constexpr (sizeof(T) == 2)
        return bf16_round(__fmul_rn(v, gate(g)));
    else
        return __fmul_rn(v, __frcp_rn(__fadd_rn(1.0f, expf(-g))));
}

// rint(clamp(p / step, -127, 127)) with the bits of IEEE division
__device__ __forceinline__ int quant(float p, float r, float step) {
    float t = __fmul_rn(p, r);
    const float a = fabsf(t);
    if (a < 256.0f && fabsf(__fsub_rn(__fsub_rn(a, floorf(a)), 0.5f)) <= a * 0x1p-20f)
        t = __fdiv_rn(p, step);
    return __float2int_rn(fminf(fmaxf(t, -127.0f), 127.0f));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
    return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
           ((uint32_t)d << 24);
}

// C = 64 or 32: x is h [N, 2C] of T as 16-byte words (C / 4 * WORDS a pixel,
// the values in the first half), `units` = N * C / 8. C = 0: x is the flat
// tensor of `n` elements, `units` = n / 8, the last n % 8 elements done one
// by one.
template <int C, typename T>
__global__ void __launch_bounds__(THREADS)
glu_requant_kernel(const uint4* __restrict__ x, uint2* __restrict__ q, long long units,
                   long long n, float step, float r) {
    constexpr int UPP = C / 8;  // units of one pixel
    constexpr int W = WORDS<T>;
    constexpr int U = UNROLL<C, T>;
    const long long base = (long long)blockIdx.x * THREADS * U + threadIdx.x;
    uint4 vw[U][W], gw[U][W];
#pragma unroll
    for (int k = 0; k < U; ++k) {
        const long long u = base + k * THREADS;
        if (u < units) {
            if constexpr (C == 0) {
#pragma unroll
                for (int j = 0; j < W; ++j) vw[k][j] = __ldg(x + u * W + j);
            } else {
                const uint4* w = x + (u / UPP) * (C / 4 * W) + (u % UPP) * W;
#pragma unroll
                for (int j = 0; j < W; ++j) {
                    vw[k][j] = __ldg(w + j);
                    gw[k][j] = __ldg(w + C / 8 * W + j);
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
        const long long u = base + k * THREADS;
        if (u < units) {
            float v[8];
            int o[8];
            unpack8(vw[k], v);
            if constexpr (C == 0) {
#pragma unroll
                for (int i = 0; i < 8; ++i) o[i] = quant(v[i], r, step);
            } else {
                float g[8];
                unpack8(gw[k], g);
#pragma unroll
                for (int i = 0; i < 8; ++i) o[i] = quant(glu<T>(v[i], g[i]), r, step);
            }
            q[u] = make_uint2(pack4(o[0], o[1], o[2], o[3]), pack4(o[4], o[5], o[6], o[7]));
        }
    }
    if constexpr (C == 0) {
        const long long e = units * 8 + threadIdx.x;
        if (blockIdx.x == 0 && e < n) {
            float v;
            if constexpr (sizeof(T) == 2)
                v = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[e]);
            else
                v = reinterpret_cast<const float*>(x)[e];
            reinterpret_cast<int8_t*>(q)[e] = (int8_t)quant(v, r, step);
        }
    }
}

template <int C, typename T>
int launch(const void* x, void* q, long long units, long long n, float step, cudaStream_t s) {
    constexpr int U = UNROLL<C, T>;
    const long long blocks = (units + THREADS * U - 1) / (THREADS * U);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    glu_requant_kernel<C, T><<<(int)(blocks > 0 ? blocks : 1), THREADS, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint2*>(q), units, n, step, 1.0f / step);
    return (int)cudaGetLastError();
}

template <typename T>
int glu_requant_any(const void* h, void* q, long long n_pixels, int c, float step, void* stream) {
    if ((c != 64 && c != 32) || n_pixels < 0) return (int)cudaErrorInvalidValue;
    if (n_pixels == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long units = n_pixels * c / 8;
    return c == 64 ? launch<64, T>(h, q, units, 0, step, s) : launch<32, T>(h, q, units, 0, step, s);
}

template <typename T>
int requant_any(const void* x, void* q, long long n, float step, void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    return launch<0, T>(x, q, n / 8, n, step, static_cast<cudaStream_t>(stream));
}

}  // namespace

// h: bfloat16 [N, 2c], 16-byte aligned; q: int8 [N, c], c in {64, 32};
// n_pixels = N. Returns a cudaError_t.
extern "C" int glu_requant_launch(const void* h, void* q, long long n_pixels, int c,
                                  float step, void* stream) {
    return glu_requant_any<__nv_bfloat16>(h, q, n_pixels, c, step, stream);
}

// x: bfloat16, n elements, 16-byte aligned; q: int8, n elements, 8-byte
// aligned. q = rint(clamp(x / step, -127, 127)). Returns a cudaError_t.
extern "C" int requant_launch(const void* x, void* q, long long n, float step, void* stream) {
    return requant_any<__nv_bfloat16>(x, q, n, step, stream);
}

// The float32 instances: h float32 [N, 2c], x float32, each 16-byte
// aligned; otherwise as above.
extern "C" int glu_requant_f32_launch(const void* h, void* q, long long n_pixels, int c,
                                      float step, void* stream) {
    return glu_requant_any<float>(h, q, n_pixels, c, step, stream);
}

extern "C" int requant_f32_launch(const void* x, void* q, long long n, float step, void* stream) {
    return requant_any<float>(x, q, n, step, stream);
}

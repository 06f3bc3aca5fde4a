// int8 x int8 -> int32 convolution with a dequantizing epilogue, for Hopper
// (sm_90a).
//
// Replaces the XLA int8 convolutions of the JAX package's int8 serving mode
// (tgsr_tpu/engine/quant.py `quant_conv` and `_int8_seg_fn`: int8 inputs and
// per-output-channel int8 weights, lax.conv_general_dilated with
// preferred_element_type=int32). There is no Pallas kernel for it; on the
// port's path it is every conv of both generators (42 launches a forward).
//
// out[b, y, x, c] = epilogue(sum over taps and input channels of
//                            xq[b, y + ky - p, x + kx - p, ci] * w[ky, kx, ci, c])
// with SAME zero padding, stride 1, k in {3, 5}. With `up2` the conv runs on
// the nearest-x2 upsample of x, read by index (source pixel (y >> 1, x >> 1))
// with the SAME padding on the upsampled grid, as the JAX UpBlock quantizes
// before its upsample. The epilogue, in float32 and in this order:
// acc * scale[c] (scale = x_step * w_step[c]), then * mul[c] + add[c] when a
// folded BN is given, then the cast to float32 or bfloat16; then, for a
// bfloat16 output, + residual (bfloat16), rounded once more, as the JAX block
// adds its skip in the working type. Every multiply and add is written
// with the _rn intrinsics, so nvcc contracts nothing into an FMA and the
// result equals the plain version's bit for bit in float32 (integer sums are
// exact in any order).
//
// Bound: the main path's convs need 2 * k * k * Cin int8 operations an
// output against 2 bytes of bf16 output (plus the input and any residual);
// the 128 px ResBlock conv1 of GSRNetLow at B = 64 does 154.6 GOP (0.08 ms
// at 1979 TOPS) and moves 335 MB (0.10 ms at 3.35 TB/s), so the forward's
// convs sit near the ridge, most of them on the bytes side.
//
// Design: an implicit GEMM on the int8 tensor cores (`mma.sync.m16n8k32`
// s8, int32 sums), the tile of conv_probe.cu's tap9 kernel with a 32-byte k
// step. A block computes BM output pixels (a TH x 32 tile of one image) x
// all output channels (Cout padded to N = 8, 32, 64 or 128), 8 warps of
// WM x WN. A is the int8 input
// halo tile in shared memory, read by ldmatrix at each tap's shift (the K
// position tap * Cin + ci; Cin a multiple of 32); its pixel stride is Cin +
// 16 bytes, so the 8 rows of every ldmatrix fall in distinct banks. For
// Cin = 4 (the two 3-channel image inputs) the taps fold into K instead: a
// patch of k * k words a pixel, zero-padded to a multiple of 32 bytes, built
// in shared memory (9 x 4 = 36 -> 64 bytes), rather than padding each tap's
// K to 32. B is the weight as int8 rows [N][K] with K contiguous
// (`pack_int8_weight`), streamed in K chunks of KC bytes through two cp.async
// buffers (rows padded by 16 bytes), read by ldmatrix, so one chunk loads
// while the last feeds the tensor cores. The epilogue runs on the int32
// accumulators, stages the tile in shared memory in the output type, and
// writes it 16 bytes a thread where a pixel's row is a multiple of 16 bytes
// (element by element for the 3-channel heads), adding the residual there.
//
// Layouts: x int8 NHWC [B, H, W, Cin], Cin 4 or a multiple of 32 (the
// wrapper pads); w int8 [N][Kp], Kp = k * k * Cin rounded up to 32, columns
// tap-major (ky, kx, ci), zero beyond Cout and K; scale, mul, add float32
// [Cout]; residual and out NHWC [B, Ho, Wo, Cout].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int TW = 32;              // output tile width
constexpr int SMEM_LIMIT = 232448;  // the most shared memory a block may opt into

// warps WARPS_M x WARPS_N of WM x WN each over N output channels; KC bytes of K a chunk
template <int N> struct Tile;
template <> struct Tile<128> { static constexpr int WARPS_M = 2, WM = 64, WN = 32, KC = 288; };
template <> struct Tile<64> { static constexpr int WARPS_M = 4, WM = 64, WN = 32, KC = 288; };
template <> struct Tile<32> { static constexpr int WARPS_M = 8, WM = 32, WN = 32, KC = 288; };
template <> struct Tile<8> { static constexpr int WARPS_M = 8, WM = 32, WN = 8, KC = 256; };

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

template <int N>
struct Geometry {
    static constexpr int BM = Tile<N>::WARPS_M * Tile<N>::WM;  // pixels a block
    static constexpr int TH = BM / TW;                         // tile rows
    static constexpr int BS = Tile<N>::KC + 16;                // weight row stride, bytes
    int hh, hw, hs, ps, kp, a_bytes, out_stride;
    long long bytes;
    __host__ __device__ Geometry(int cin, int k, int esize) {
        hh = TH + k - 1;
        hw = TW + k - 1;
        hs = cin + 16;                          // halo pixel stride, bytes
        kp = round_up(k * k * cin, 32);
        ps = kp + 16;                           // folded patch row stride, bytes
        a_bytes = cin == 4 ? BM * ps : hh * hw * hs;
        out_stride = N * esize + 16;            // staging row stride, bytes
        const long long main = 2LL * N * BS + a_bytes;
        const long long staging = (long long)BM * out_stride;
        bytes = main > staging ? main : staging;
    }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int K>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(K)); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r0), "=r"(r1) : "r"(addr));
}
// not volatile: the compiler may interleave independent products with loads
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void put(float* o, float v) { *o = v; }
__device__ __forceinline__ void put(bf16* o, float v) { *o = __float2bfloat16_rn(v); }

// + residual, rounded once more (bfloat16 only)
__device__ __forceinline__ bf16 add_res(bf16 o, bf16 r) {
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(o), __bfloat162float(r)));
}

template <int N, typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ mul,
                 const float* __restrict__ add, const bf16* __restrict__ res,
                 OutT* __restrict__ out, int H, int W, int cin, int cout, int k, int up2) {
    using T = Tile<N>;
    using G = Geometry<N>;
    constexpr int MT = T::WM / 16, NT = T::WN / 8, KC = T::KC, BM = G::BM, TH = G::TH, BS = G::BS;
    extern __shared__ __align__(16) unsigned char smem[];
    const G geo(cin, k, sizeof(OutT));
    const bool fold = cin == 4;
    unsigned char* w_s = smem;                  // [2][N][BS]
    unsigned char* a_s = smem + 2 * N * BS;     // halo [hh][hw][hs] or patch [BM][ps]
    OutT* o_s = reinterpret_cast<OutT*>(smem);  // staging [BM][out_stride], after the products
    const int Ho = up2 ? 2 * H : H, Wo = up2 ? 2 * W : W;
    const int b = blockIdx.z, oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
    const int pad = k / 2, kp = geo.kp;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp % T::WARPS_M, wn = warp / T::WARPS_M;
    const int8_t* xb = x + (size_t)b * H * W * cin;

    auto src_pixel = [&](int iy, int ix, bool& ok) -> size_t {
        ok = iy >= 0 && iy < Ho && ix >= 0 && ix < Wo;
        return ok ? ((size_t)(up2 ? iy >> 1 : iy) * W + (up2 ? ix >> 1 : ix)) * cin : 0;
    };
    // K chunk ch of the weight rows into buffer buf
    auto load_w = [&](int buf, int ch) {
        const int len = min(KC, kp - ch * KC) / 16;
        for (int i = threadIdx.x; i < N * len; i += THREADS) {
            const int n = i / len, c = (i % len) * 16;
            cp_async16(w_s + (buf * N + n) * BS + c, w + (size_t)n * kp + ch * KC + c, true);
        }
    };

    // ---- the A operand in shared memory: halo tile (cp.async) or folded patch ----
    if (!fold) {
        const int per_px = cin / 16;
        for (int i = threadIdx.x; i < geo.hh * geo.hw * per_px; i += THREADS) {
            const int c = (i % per_px) * 16, pix = i / per_px;
            bool ok;
            const size_t s = src_pixel(oy0 - pad + pix / geo.hw, ox0 - pad + pix % geo.hw, ok);
            cp_async16(a_s + pix * geo.hs + c, xb + s + c, ok);
        }
    } else {
        const int words = kp / 4;
        for (int i = threadIdx.x; i < BM * words; i += THREADS) {
            const int m = i / words, tap = i % words;
            int v = 0;
            if (tap < k * k) {
                bool ok;
                const size_t s = src_pixel(oy0 + m / TW + tap / k - pad, ox0 + m % TW + tap % k - pad, ok);
                if (ok) v = *reinterpret_cast<const int*>(xb + s);
            }
            *reinterpret_cast<int*>(a_s + m * geo.ps + 4 * tap) = v;
        }
    }
    load_w(0, 0);
    cp_async_commit();

    // this lane's ldmatrix rows: A (pixel of each m tile), B (weight row of each n-tile pair)
    uint32_t a_row[MT];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
        const int m = wm * T::WM + mi * 16 + (lane & 15);
        const int off = fold ? m * geo.ps : ((m / TW) * geo.hw + m % TW) * geo.hs;
        a_row[mi] = smem_addr(a_s) + off + (lane >> 4) * 16;
    }
    const uint32_t b_row = smem_addr(w_s)
        + (wn * T::WN + (lane & 7) + (NT > 1 ? (lane >> 4) << 3 : 0)) * BS + ((lane >> 3) & 1) * 16;

    int acc[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

    const int nchunks = (kp + KC - 1) / KC;
    for (int ch = 0; ch < nchunks; ++ch) {
        if (ch + 1 < nchunks) {
            load_w((ch + 1) & 1, ch + 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int steps = min(KC, kp - ch * KC) / 32;
        const uint32_t wb = b_row + (ch & 1) * N * BS;
        for (int ks = 0; ks < steps; ++ks) {
            const int kk = ch * KC + ks * 32;  // K position of this k32 step
            int shift = kk;
            if (!fold) {
                const int tap = kk / cin;
                shift = ((tap / k) * geo.hw + tap % k) * geo.hs + kk - tap * cin;
            }
            uint32_t bf[NT][2];
            if constexpr (NT == 1) {
                ldsm_x2(bf[0][0], bf[0][1], wb + ks * 32);
            } else {
#pragma unroll
                for (int nj = 0; nj < NT / 2; ++nj) {
                    uint32_t r[4];
                    ldsm_x4(r, wb + nj * 16 * BS + ks * 32);
                    bf[2 * nj][0] = r[0]; bf[2 * nj][1] = r[1];
                    bf[2 * nj + 1][0] = r[2]; bf[2 * nj + 1][1] = r[3];
                }
            }
            uint32_t af[MT][4];
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) ldsm_x4(af[mi], a_row[mi] + shift);
#pragma unroll
            for (int mi = 0; mi < MT; ++mi)
#pragma unroll
                for (int ni = 0; ni < NT; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
        }
        __syncthreads();
    }

    // ---- epilogue on the int32 sums -> staging tile in the output type ----
    const int g = lane >> 2, t = lane & 3;
    const int os = geo.out_stride / (int)sizeof(OutT);  // staging row stride, elements
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int c = wn * T::WN + ni * 8 + 2 * t + e;
            if (c >= cout) continue;
            const float sc = scale[c];
            const float mu = mul != nullptr ? mul[c] : 0.f, ad = mul != nullptr ? add[c] : 0.f;
#pragma unroll
            for (int mi = 0; mi < MT; ++mi)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int m = wm * T::WM + mi * 16 + g + 8 * half;
                    float v = __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + e]), sc);
                    if (mul != nullptr) v = __fadd_rn(__fmul_rn(v, mu), ad);
                    put(o_s + m * os + c, v);
                }
        }
    }
    __syncthreads();

    // ---- the staged tile to out (+ residual), one tile row of Wo-contiguous pixels at a time ----
    const int nv = min(TW, Wo - ox0);  // valid pixels of a tile row
    if ((cout * (int)sizeof(OutT)) % 16 == 0) {
        constexpr int V = 16 / sizeof(OutT);  // elements a 16-byte piece
        const int per_px = cout / V;
        for (int i = threadIdx.x; i < BM * per_px; i += THREADS) {
            const int m = i / per_px, c = (i % per_px) * V, oy = oy0 + m / TW, px = m % TW;
            if (oy >= Ho || px >= nv) continue;
            const size_t o = ((size_t)(b * Ho + oy) * Wo + ox0 + px) * cout + c;
            int4 v = *reinterpret_cast<const int4*>(o_s + m * os + c);
            if (res != nullptr) {
                const int4 r = *reinterpret_cast<const int4*>(res + o);
                bf16* vo = reinterpret_cast<bf16*>(&v);
                const bf16* vr = reinterpret_cast<const bf16*>(&r);
#pragma unroll
                for (int j = 0; j < 8; ++j) vo[j] = add_res(vo[j], vr[j]);
            }
            *reinterpret_cast<int4*>(out + o) = v;
        }
    } else {
        const int row = TW * cout;
        for (int i = threadIdx.x; i < TH * row; i += THREADS) {
            const int py = i / row, e = i % row, px = e / cout, c = e % cout, oy = oy0 + py;
            if (oy >= Ho || px >= nv) continue;
            const size_t o = ((size_t)(b * Ho + oy) * Wo + ox0 + px) * cout + c;
            OutT v = o_s[(py * TW + px) * os + c];
            if constexpr (sizeof(OutT) == 2) {
                if (res != nullptr) v = add_res(v, res[o]);
            }
            out[o] = v;
        }
    }
}

template <int N, typename OutT>
int launch(const void* x, const void* w, const void* scale, const void* mul, const void* add,
           const void* res, void* out, int B, int H, int W, int cin, int cout, int k, int up2,
           cudaStream_t stream) {
    const Geometry<N> geo(cin, k, sizeof(OutT));
    if (geo.bytes > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    auto kernel = int8_conv_kernel<N, OutT>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.bytes);
    if (err != cudaSuccess) return (int)err;
    const int Ho = up2 ? 2 * H : H, Wo = up2 ? 2 * W : W;
    dim3 grid((Wo + TW - 1) / TW, (Ho + Geometry<N>::TH - 1) / Geometry<N>::TH, B);
    kernel<<<grid, THREADS, geo.bytes, stream>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(scale),
        static_cast<const float*>(mul), static_cast<const float*>(add), static_cast<const bf16*>(res),
        static_cast<OutT*>(out), H, W, cin, cout, k, up2);
    return (int)cudaGetLastError();
}

template <int N>
int launch_dtype(const void* x, const void* w, const void* scale, const void* mul, const void* add,
                 const void* res, void* out, int B, int H, int W, int cin, int cout, int k, int up2,
                 int out_dtype, cudaStream_t s) {
    return out_dtype == 0
        ? launch<N, float>(x, w, scale, mul, add, res, out, B, H, W, cin, cout, k, up2, s)
        : launch<N, bf16>(x, w, scale, mul, add, res, out, B, H, W, cin, cout, k, up2, s);
}

// the weight rows (instance N) for `cout` output channels, as ops/int8_conv.py
// `cout_pad` pads them; 0 = more than 128
int cout_pad(int cout) {
    return cout <= 8 ? 8 : cout <= 32 ? 32 : cout <= 64 ? 64 : cout <= 128 ? 128 : 0;
}

}  // namespace

// out_dtype: 0 float32, 1 bfloat16 (residual only with bfloat16). `cin` is
// x's channel count, 4 or a multiple of 32. Returns a cudaError_t;
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int int8_conv_launch(const void* x, const void* w, const void* scale,
                                const void* mul, const void* add, const void* res, void* out,
                                int B, int H, int W, int cin, int cout, int k, int up2,
                                int out_dtype, void* stream) {
    if ((cin != 4 && (cin < 32 || cin % 32 != 0)) || (k != 3 && k != 5) || cout < 1
        || (mul == nullptr) != (add == nullptr) || (res != nullptr && out_dtype != 1)
        || B < 1 || B > 65535 || H < 1 || W < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (cout_pad(cout)) {
        case 8: return launch_dtype<8>(x, w, scale, mul, add, res, out, B, H, W, cin, cout, k, up2, out_dtype, s);
        case 32: return launch_dtype<32>(x, w, scale, mul, add, res, out, B, H, W, cin, cout, k, up2, out_dtype, s);
        case 64: return launch_dtype<64>(x, w, scale, mul, add, res, out, B, H, W, cin, cout, k, up2, out_dtype, s);
        case 128: return launch_dtype<128>(x, w, scale, mul, add, res, out, B, H, W, cin, cout, k, up2, out_dtype, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

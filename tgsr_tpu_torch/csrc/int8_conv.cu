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
// result equals the plain version's bit for bit in float32.
//
// Bound: at the card's peaks the main path's convs are bound by bytes, the
// bf16 outputs (2 bytes) against 2 * k * k * Cin int8 operations an output:
// the 128 px ResBlock conv1 of GSRNetLow at B = 64 does 154.6 GOP (0.08 ms
// at 1979 TOPS) and moves 335 MB (0.10 ms at 3.35 TB/s). This first kernel
// is far from both: it runs on the CUDA cores with __dp4a (4 int8 products
// a lane and instruction), not on the tensor cores (`mma.sync` s8 or
// `wgmma` are later work). Design: one block per output tile (16 wide, 8-32
// rows as the output width asks), the int8 input halo tile and the whole
// packed weight in shared memory (at most 74 KB of weight, for
// 9 x 64 x 128); each thread item is 4 adjacent pixels x Q output channels
// (32 int32 sums for Q = 8), so 4 input words and Q weight words from
// shared memory feed 4 x Q dp4a. The halo tile's pixel stride is odd in
// words, so the 4 pixel groups a warp reads fall in distinct banks.
//
// Layouts: x int8 NHWC [B, H, W, Cin], Cin a multiple of 4 (the wrapper
// pads 3 to 4); w int32 [k, k, Cin/4, Cout], each word 4 consecutive input
// channels (byte j = channel 4g + j); scale, mul, add float32 [Cout];
// residual and out NHWC [B, Ho, Wo, Cout].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 16;  // output tile width
constexpr int P = 4;    // adjacent pixels of one thread item
constexpr int MAX_THREADS = 256;
constexpr int SMEM_LIMIT = 232448;  // the most shared memory a block may opt into

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// rows of the output tile: enough items for 256 threads, 8 to 32 rows
inline int tile_rows(int coutp, int q) {
    int rows = MAX_THREADS / ((coutp / q) * (TW / P));
    return rows < 8 ? 8 : (rows > 32 ? 32 : rows);
}

inline long long smem_bytes(int cin, int coutp, int k, int th) {
    const int cin4 = cin / 4, cs = cin4 | 1;
    return 4LL * (k * k * cin4 * coutp + (th + k - 1) * (TW + k - 1) * cs);
}

__device__ inline void store(float* out, float v, const __nv_bfloat16*) { *out = v; }

__device__ inline void store(__nv_bfloat16* out, float v, const __nv_bfloat16* res) {
    __nv_bfloat16 o = __float2bfloat16_rn(v);
    if (res != nullptr) o = __float2bfloat16_rn(__fadd_rn(__bfloat162float(o), __bfloat162float(*res)));
    *out = o;
}

template <int Q>
__device__ inline void load_weights(int (&wv)[Q], const int* p) {
#pragma unroll
    for (int j = 0; j < Q; j += 4) {
        const int4 v = *reinterpret_cast<const int4*>(p + j);
        wv[j] = v.x; wv[j + 1] = v.y; wv[j + 2] = v.z; wv[j + 3] = v.w;
    }
}

template <int Q, typename OutT>
__global__ void __launch_bounds__(MAX_THREADS)
int8_conv_kernel(const int* __restrict__ x, const int* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ mul,
                 const float* __restrict__ add, const __nv_bfloat16* __restrict__ res,
                 OutT* __restrict__ out, int H, int W, int cin4, int cout, int k,
                 int up2, int th) {
    extern __shared__ __align__(16) int smem[];
    const int coutp = round_up(cout, Q);
    const int cs = cin4 | 1;  // halo pixel stride in words, odd
    const int kk = k * k;
    int* w_s = smem;                       // [kk][cin4][coutp]
    int* x_s = smem + kk * cin4 * coutp;   // [th + k - 1][TW + k - 1][cs]
    const int Ho = up2 ? 2 * H : H, Wo = up2 ? 2 * W : W;
    const int b = blockIdx.z, oy0 = blockIdx.y * th, ox0 = blockIdx.x * TW;
    const int pad = k / 2, hh = th + k - 1, hw = TW + k - 1;

    for (int i = threadIdx.x; i < kk * cin4 * coutp; i += blockDim.x) {
        const int co = i % coutp, row = i / coutp;  // row = tap * cin4 + g
        w_s[i] = co < cout ? w[(size_t)row * cout + co] : 0;
    }
    for (int i = threadIdx.x; i < hh * hw * cin4; i += blockDim.x) {
        const int g = i % cin4, pix = i / cin4, c = pix % hw, r = pix / hw;
        const int iy = oy0 - pad + r, ix = ox0 - pad + c;
        int v = 0;
        if (iy >= 0 && iy < Ho && ix >= 0 && ix < Wo) {
            const int sy = up2 ? iy >> 1 : iy, sx = up2 ? ix >> 1 : ix;
            v = x[((size_t)(b * H + sy) * W + sx) * cin4 + g];
        }
        x_s[(r * hw + c) * cs + g] = v;
    }
    __syncthreads();

    const int ngroups = coutp / Q;
    const int nitems = ngroups * th * (TW / P);
    for (int item = threadIdx.x; item < nitems; item += blockDim.x) {
        const int cg = item % ngroups, pg = item / ngroups;
        const int py = pg / (TW / P), px0 = (pg % (TW / P)) * P;
        int acc[P][Q];
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
            for (int q = 0; q < Q; ++q) acc[p][q] = 0;
        for (int ky = 0; ky < k; ++ky) {
            for (int kx = 0; kx < k; ++kx) {
                const int* xr = x_s + ((py + ky) * hw + px0 + kx) * cs;
                const int* wt = w_s + (ky * k + kx) * cin4 * coutp + cg * Q;
                for (int g = 0; g < cin4; ++g) {
                    int xv[P], wv[Q];
#pragma unroll
                    for (int p = 0; p < P; ++p) xv[p] = xr[p * cs + g];
                    load_weights<Q>(wv, wt + g * coutp);
#pragma unroll
                    for (int p = 0; p < P; ++p)
#pragma unroll
                        for (int q = 0; q < Q; ++q) acc[p][q] = __dp4a(xv[p], wv[q], acc[p][q]);
                }
            }
        }
        const int oy = oy0 + py;
        if (oy >= Ho) continue;
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int ox = ox0 + px0 + p;
            if (ox >= Wo) continue;
            const size_t o = ((size_t)(b * Ho + oy) * Wo + ox) * cout;
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                const int co = cg * Q + q;
                if (co >= cout) continue;
                float v = __fmul_rn(__int2float_rn(acc[p][q]), scale[co]);
                if (mul != nullptr) v = __fadd_rn(__fmul_rn(v, mul[co]), add[co]);
                store(out + o + co, v, res != nullptr ? res + o + co : nullptr);
            }
        }
    }
}

template <int Q, typename OutT>
int launch(const void* x, const void* w, const void* scale, const void* mul,
           const void* add, const void* res, void* out, int B, int H, int W,
           int cin, int cout, int k, int up2, cudaStream_t stream) {
    const int coutp = round_up(cout, Q);
    const int th = tile_rows(coutp, Q);
    const long long smem = smem_bytes(cin, coutp, k, th);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    auto kernel = int8_conv_kernel<Q, OutT>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int Ho = up2 ? 2 * H : H, Wo = up2 ? 2 * W : W;
    const int items = (coutp / Q) * th * (TW / P);
    const int threads = items < MAX_THREADS ? round_up(items, 32) : MAX_THREADS;
    dim3 grid((Wo + TW - 1) / TW, (Ho + th - 1) / th, B);
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const int*>(x), static_cast<const int*>(w), static_cast<const float*>(scale),
        static_cast<const float*>(mul), static_cast<const float*>(add),
        static_cast<const __nv_bfloat16*>(res), static_cast<OutT*>(out), H, W, cin / 4, cout, k,
        up2, th);
    return (int)cudaGetLastError();
}

}  // namespace

// out_dtype: 0 float32, 1 bfloat16 (residual only with bfloat16). Returns a
// cudaError_t; cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int int8_conv_launch(const void* x, const void* w, const void* scale,
                                const void* mul, const void* add, const void* res, void* out,
                                int B, int H, int W, int cin, int cout, int k, int up2,
                                int out_dtype, void* stream) {
    if (cin % 4 != 0 || (k != 3 && k != 5) || cout < 1 || (mul == nullptr) != (add == nullptr)
        || (res != nullptr && out_dtype != 1) || B > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cout <= 4) {
        return out_dtype == 0
            ? launch<4, float>(x, w, scale, mul, add, res, out, B, H, W, cin, cout, k, up2, s)
            : launch<4, __nv_bfloat16>(x, w, scale, mul, add, res, out, B, H, W, cin, cout, k, up2, s);
    }
    return out_dtype == 0
        ? launch<8, float>(x, w, scale, mul, add, res, out, B, H, W, cin, cout, k, up2, s)
        : launch<8, __nv_bfloat16>(x, w, scale, mul, add, res, out, B, H, W, cin, cout, k, up2, s);
}

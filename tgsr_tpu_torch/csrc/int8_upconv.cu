// The quantized UpBlock by phases: nearest-x2 upsample + int8 conv3x3 + BN +
// GLU as four 2x2 int8 convs at the source resolution, one per output parity
// class, for Hopper (sm_90a).
//
// Replaces the XLA int8 convolutions of the JAX package's fused quantized
// UpBlock (tgsr_tpu/engine/quant.py `_fused_up_int8`, :250-305: one
// lax.conv_general_dilated per phase on int8 operands with int32 sums, then
// the dequantizing BN + GLU epilogue and the depth_to_space). There is no
// Pallas kernel for it; on the port's path it is every UpBlock site named in
// engine/quant.py FUSED_UP_SITES (none by default).
//
// For phase p = 2 di + dj and source pixel (i, j), with the 2x2 kernel made
// from the 3x3 one (ops/fused_upsample.fuse_upconv_weight) and quantized per
// phase and output channel:
//   acc[c] = sum over (ty, tx) in 2x2 and ci of
//            x[i - 1 + di + ty, j - 1 + dj + tx, ci] * w[p][c][(ty, tx, ci)]
// (zero outside the image: the phase padding (1 - di, di) x (1 - dj, dj));
// then, in float32 and in this order: y = acc * scale[p Cout + c] (scale =
// x_step * w_step), y = y * mul[c] + add[c] when a folded BN is given, the
// GLU h = y[c] * (1 / (1 + expf(-y[c + Cout / 2]))) for c < Cout / 2, and
// with an output step s > 0 the requantize-dequantize
// h = rint(clamp(h / s, -127, 127)) * s; h is written in float32 or
// bfloat16 to output pixel (2i + di, 2j + dj), the depth_to_space done by
// the store. Each rounding is written out (_rn), so the result is the plain
// version's (ops/int8_upconv.py) bit for bit: PyTorch's CUDA sigmoid is the
// same 1 / (1 + exp(-g)), correctly rounded.
//
// Design (a simple kernel, right first): a block owns BM = 64 consecutive
// source pixels of one image and one phase (grid z = image, y = phase, so
// one launch runs all four), and every output channel of that phase. The A
// operand, an im2col patch [64][4 Cin] of the four taps, and the phase's
// weight rows [Cout][4 Cin] (K contiguous, tap-major) sit in shared memory;
// 8 warps run `mma.sync.m16n8k32` s8 with int32 sums: warp w takes the m16
// tile w % 4 and the value (w < 4) or the gate half of the channels. The
// float32 epilogue is staged in shared memory so one thread meets a
// channel's value and gate, then stores C2 = Cout / 2 contiguous channels a
// pixel.
//
// Layouts: x int8 NHWC [B, H, W, Cin], Cin a multiple of 32, at most 128;
// w int8 [4][Cout][4 Cin]; scale float32 [4 Cout]; mul, add float32
// [Cout]; out NHWC [B, 2H, 2W, Cout / 2]; Cout a multiple of 16, at most 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int BM = 64;        // source pixels a block
constexpr int MAX_NT = 8;     // n8 tiles a warp: Cout / 16, Cout at most 128
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void put(float* o, float v) { *o = v; }
__device__ __forceinline__ void put(bf16* o, float v) { *o = __float2bfloat16_rn(v); }

// shared memory of one block: A [BM][K + 16] and W [Cout][K + 16] bytes,
// then reused as the float32 staging tile [BM][Cout + 1]
__host__ __device__ inline long long smem_bytes(int cin, int cout) {
    const long long stride = 4LL * cin + 16;
    const long long main = (BM + cout) * stride;
    const long long staging = (long long)BM * (cout + 1) * 4;
    return main > staging ? main : staging;
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
int8_upconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ mul,
                   const float* __restrict__ add, OutT* __restrict__ out,
                   int H, int W, int cin, int cout, float out_step) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int K = 4 * cin, stride = K + 16;
    unsigned char* a_s = smem;                       // [BM][stride]
    unsigned char* w_s = smem + BM * stride;         // [cout][stride]
    float* o_s = reinterpret_cast<float*>(smem);     // [BM][cout + 1], after the products
    const int b = blockIdx.z, ph = blockIdx.y, di = ph >> 1, dj = ph & 1;
    const int p0 = blockIdx.x * BM, HW = H * W;
    const int8_t* xb = x + (size_t)b * HW * cin;

    // ---- A: the four taps of each pixel, 16 bytes a thread-step, zero outside the image ----
    const int chunks = cin / 16;
    for (int i = threadIdx.x; i < BM * 4 * chunks; i += THREADS) {
        const int m = i / (4 * chunks), r = i % (4 * chunks), tap = r / chunks;
        const int c = (r % chunks) * 16, p = p0 + m;
        int4 v = make_int4(0, 0, 0, 0);
        if (p < HW) {
            const int sy = p / W - 1 + di + (tap >> 1), sx = p % W - 1 + dj + (tap & 1);
            if (sy >= 0 && sy < H && sx >= 0 && sx < W)
                v = *reinterpret_cast<const int4*>(xb + ((size_t)sy * W + sx) * cin + c);
        }
        *reinterpret_cast<int4*>(a_s + m * stride + tap * cin + c) = v;
    }
    // ---- W: this phase's rows ----
    const int8_t* wp = w + (size_t)ph * cout * K;
    for (int i = threadIdx.x; i < cout * (K / 16); i += THREADS) {
        const int n = i / (K / 16), k = (i % (K / 16)) * 16;
        *reinterpret_cast<int4*>(w_s + n * stride + k) =
            *reinterpret_cast<const int4*>(wp + (size_t)n * K + k);
    }
    __syncthreads();

    // ---- int32 sums on the tensor cores ----
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int mt = warp & 3, half_c = warp >> 2, c2 = cout / 2, nt = c2 / 8;
    int acc[MAX_NT][4];
#pragma unroll
    for (int j = 0; j < MAX_NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    const unsigned char* a0p = a_s + (mt * 16 + g) * stride + t * 4;
    const unsigned char* a1p = a0p + 8 * stride;
    for (int ks = 0; ks < K; ks += 32) {
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(a0p + ks);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(a1p + ks);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(a0p + ks + 16);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(a1p + ks + 16);
#pragma unroll
        for (int j = 0; j < MAX_NT; ++j) {
            if (j < nt) {
                const unsigned char* bp = w_s + (half_c * c2 + j * 8 + g) * stride + ks + t * 4;
                mma_s8(acc[j], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(bp),
                       *reinterpret_cast<const uint32_t*>(bp + 16));
            }
        }
    }
    __syncthreads();  // every warp is done with A and W: the staging tile reuses them

    // ---- dequantize and BN in float32 into the staging tile ----
    const int os = cout + 1;
#pragma unroll
    for (int j = 0; j < MAX_NT; ++j) {
        if (j >= nt) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int c = half_c * c2 + j * 8 + 2 * t + e;
            const float sc = scale[ph * cout + c];
            const float mu = mul != nullptr ? mul[c] : 0.f, ad = mul != nullptr ? add[c] : 0.f;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                float v = __fmul_rn(__int2float_rn(acc[j][2 * hf + e]), sc);
                if (mul != nullptr) v = __fadd_rn(__fmul_rn(v, mu), ad);
                o_s[(mt * 16 + g + 8 * hf) * os + c] = v;
            }
        }
    }
    __syncthreads();

    // ---- GLU (+ requantize) and the store at (2i + di, 2j + dj) ----
    for (int i = threadIdx.x; i < BM * c2; i += THREADS) {
        const int m = i / c2, c = i % c2, p = p0 + m;
        if (p >= HW) continue;
        const float v = o_s[m * os + c], gt = o_s[m * os + c + c2];
        float h = __fmul_rn(v, __frcp_rn(__fadd_rn(1.0f, expf(-gt))));
        if (out_step > 0.f)
            h = __fmul_rn(rintf(fminf(fmaxf(__fdiv_rn(h, out_step), -127.f), 127.f)), out_step);
        const int oy = 2 * (p / W) + di, ox = 2 * (p % W) + dj;
        put(out + (((size_t)b * 2 * H + oy) * 2 * W + ox) * c2 + c, h);
    }
}

template <typename OutT>
int launch(const void* x, const void* w, const void* scale, const void* mul, const void* add,
           void* out, int B, int H, int W, int cin, int cout, float out_step,
           cudaStream_t stream) {
    const long long bytes = smem_bytes(cin, cout);
    if (bytes > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    auto kernel = int8_upconv_kernel<OutT>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((H * W + BM - 1) / BM, 4, B);
    kernel<<<grid, THREADS, bytes, stream>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(mul),
        static_cast<const float*>(add), static_cast<OutT*>(out), H, W, cin, cout, out_step);
    return (int)cudaGetLastError();
}

}  // namespace

// out_dtype: 0 float32, 1 bfloat16. out_step: the output's requantize step,
// or 0 for none. Returns a cudaError_t; cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int int8_upconv_launch(const void* x, const void* w, const void* scale,
                                  const void* mul, const void* add, void* out, int B, int H,
                                  int W, int cin, int cout, float out_step, int out_dtype,
                                  void* stream) {
    if (cin < 32 || cin > 128 || cin % 32 != 0 || cout < 16 || cout > 128 || cout % 16 != 0
        || (mul == nullptr) != (add == nullptr) || (out_dtype != 0 && out_dtype != 1)
        || B < 1 || B > 65535 || H < 1 || W < 1 || (long long)H * W > (1LL << 30)
        || !(out_step >= 0.f))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return out_dtype == 0
        ? launch<float>(x, w, scale, mul, add, out, B, H, W, cin, cout, out_step, s)
        : launch<bf16>(x, w, scale, mul, add, out, B, H, W, cin, cout, out_step, s);
}

// The four formulations of the bf16 conv3x3 probe as tensor-core kernels for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels of examples/pallas_conv_probe.py, the go/no-go
// probe for a whole-stage fused kernel: can a hand-written conv3x3 match the
// library's at the model's hottest conv, h_net3's ResBlock conv1 ([B, 128,
// 128, 64] -> 128 channels, bf16, float32 sums)?
//
//   conv_tap9_kernel     `tap9`    (:85):  9 shifted K = 64 products
//   conv_im2col_kernel   `im2col`  (:132): a [pixels, 640] patch buffer in
//                                          shared memory, then one K = 640 loop
//   conv_pair5_kernel    `pair5`   (:172): 5 paired K = 128 products, no patch
//   conv_dotceil_kernel  `dotceil` (:196): a plain [M, 640] @ [640, 128] product
//
// out[b, y, x, n] = sum over (dy, dx, c) of x[b, y + dy - 1, x + dx - 1, c] *
// w[dy, dx, c, n], SAME zero padding, Cin 64, Cout 128. The packed weight wp
// [640, 128] (`pack_w`) holds tap 2p in rows 128p .. 128p + 63 and tap 2p + 1
// in the next 64; the last 64 rows (the duplicated tap 8) are zero. Every
// product runs on the tensor cores (`mma.sync.m16n8k16` bf16 with float32
// accumulators, operands from shared memory through `ldmatrix`); each output
// is rounded to bf16 once from its float32 sum.
//
// Bound: at B = 64, 128 x 128 px the conv does 154.6 GFLOP against 402 MB
// (x in, bf16 out), so it is bound by the operations (0.156 ms at 989
// TFLOP/s; bytes 0.120 ms). dotceil reads its 1.34 GB patch tensor and is
// bound by the bytes (0.481 ms at 3.35 TB/s): on this card the "ceiling" it
// measures is memory, not the matrix unit. `mma.sync` reaches only part of
// the card's peak (`wgmma`, TMA and warp specialisation are later work).
//
// Design, shared by the four: a block computes 128 output pixels x all 128
// output channels (8 warps, each 64 pixels x 32 channels: 4 x 4 mma tiles,
// 64 float32 sums a thread). The weight is streamed through shared memory in
// K chunks (64 or 128 rows, two buffers, cp.async), so one chunk loads while
// the last one feeds the tensor cores; the whole packed weight (160 KB) and
// the TPU probe's 2048-pixel tile would not fit in the 227 KB a block may
// have. A conv block's pixels are a 4 x 32 tile of one image; its input is a
// 6 x 34 x 64 halo tile in shared memory (tap9, pair5) or the 128 x 640 patch
// buffer (im2col). Shared rows are padded by 16 bytes (pixel stride 144 B,
// weight row 272 B, patch row 1296 B), so the 8 rows of every ldmatrix fall
// in distinct banks. The 128 x 128 bf16 output tile is staged in shared
// memory and written out 16 bytes a thread, one 256-byte pixel row at a time.
//
// Layouts: x bf16 NHWC [B, H, W, 64], H a multiple of 4 and W of 32; w bf16
// HWIO [3, 3, 64, 128] (tap9: K = 576 rows tap by tap); wp bf16 [640, 128];
// p bf16 [M, 640] (any M); out bf16 [B, H, W, 128] or [M, 128].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int CIN = 64, COUT = 128, KP = 640;
constexpr int BM = 128;               // output pixels (rows of the product) of a block
constexpr int TH = 4, TW = 32;        // a conv block's pixels: TH rows x TW columns
constexpr int THREADS = 256;
constexpr int HW2 = TW + 2;           // halo tile width
constexpr int HALO_PIX = (TH + 2) * HW2;
constexpr int HS = CIN + 8;           // halo pixel stride, bf16 (144 B)
constexpr int WS = COUT + 8;          // weight row stride, bf16 (272 B)
constexpr int PS = KP + 8;            // patch row stride, bf16 (1296 B)
constexpr int AS = 64 + 8;            // dotceil's A chunk row stride, bf16 (144 B)
constexpr int OS = COUT + 8;          // output staging row stride, bf16 (272 B)

__host__ __device__ constexpr int w_bytes(int rows) { return 2 * rows * WS * 2; }  // two weight buffers
constexpr int HALO_BYTES = HALO_PIX * HS * 2;                    // 29,376
constexpr int SMEM_TAP9 = w_bytes(64) + HALO_BYTES;              // 64,192
constexpr int SMEM_PAIR5 = w_bytes(128) + HALO_BYTES;            // 99,008
constexpr int SMEM_IM2COL = w_bytes(64) + BM * PS * 2;           // 200,704
constexpr int SMEM_DOTCEIL = w_bytes(64) + 2 * BM * AS * 2;      // 71,680
// the output tile is staged where the weight buffers were
static_assert(BM * OS * 2 <= w_bytes(64), "output staging must fit the weight buffers");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// What each thread of a warp needs for its 64 x 32 part of the block's tile.
struct Warp {
    int lane, wm, wn;
    __device__ Warp() : lane(threadIdx.x & 31), wm((threadIdx.x >> 5) & 1), wn(threadIdx.x >> 6) {}
    // row of the block's tile whose A address this lane gives ldmatrix for m tile mi
    __device__ int a_row(int mi) const { return wm * 64 + mi * 16 + (lane & 15); }
    // this lane's ldmatrix column offset within a k16 step (A: 0 or 8)
    __device__ int a_col() const { return (lane >> 4) * 8; }
    // this lane's offset (bf16) into a weight chunk at k16 step 0, n tiles 0-1
    __device__ int b_off() const {
        return ((lane & 7) + ((lane >> 3) & 1) * 8) * WS + wn * 32 + (lane >> 4) * 8;
    }
};

// One k16 step of the warp's 64 x 32 tile: A rows at a[mi] (shared byte
// addresses of this lane's ldmatrix row), B from the weight chunk at b.
__device__ __forceinline__ void mma_step(float (&acc)[4][4][4], const uint32_t (&a)[4], uint32_t b) {
    uint32_t af[4][4], bf[4][2], r[4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) ldsm_x4(af[mi], a[mi]);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
        ldsm_x4_t(r, b + nj * 16 * 2);
        bf[2 * nj][0] = r[0]; bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2]; bf[2 * nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
}

// rows [k0, k0 + ROWS) of a [K, 128] weight into a [ROWS][WS] buffer
template <int ROWS>
__device__ __forceinline__ void load_w(bf16* w_s, const bf16* __restrict__ w, int k0) {
    for (int i = threadIdx.x; i < ROWS * 16; i += THREADS) {
        const int r = i >> 4, c = (i & 15) * 8;
        cp_async16(w_s + r * WS + c, w + (size_t)(k0 + r) * COUT + c, true);
    }
}

// the (TH + 2) x (TW + 2) x 64 input halo of the tile at (y0, x0), zero outside the image
__device__ __forceinline__ void load_halo(bf16* h_s, const bf16* __restrict__ x, int b, int y0,
                                          int x0, int H, int W) {
    for (int i = threadIdx.x; i < HALO_PIX * 8; i += THREADS) {
        const int pix = i >> 3, c = (i & 7) * 8;
        const int iy = y0 - 1 + pix / HW2, ix = x0 - 1 + pix % HW2;
        const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
        cp_async16(h_s + pix * HS + c, ok ? x + (((size_t)b * H + iy) * W + ix) * CIN + c : x, ok);
    }
}

// float32 sums -> bf16 (rounded once) in the staging tile o_s [BM][OS]
__device__ __forceinline__ void stage_out(const float (&acc)[4][4][4], bf16* o_s, const Warp& wl) {
    const int g = wl.lane >> 2, t = wl.lane & 3;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int row = wl.wm * 64 + mi * 16 + g, col = wl.wn * 32 + ni * 8 + 2 * t;
            *reinterpret_cast<__nv_bfloat162*>(o_s + row * OS + col) =
                __floats2bfloat162_rn(acc[mi][ni][0], acc[mi][ni][1]);
            *reinterpret_cast<__nv_bfloat162*>(o_s + (row + 8) * OS + col) =
                __floats2bfloat162_rn(acc[mi][ni][2], acc[mi][ni][3]);
        }
}

// the staged tile of a conv block to out NHWC, 16 bytes a thread
__device__ __forceinline__ void write_conv_tile(const bf16* o_s, bf16* __restrict__ out, int b,
                                                int y0, int x0, int H, int W) {
    for (int i = threadIdx.x; i < BM * 16; i += THREADS) {
        const int r = i >> 4, c = (i & 15) * 8;
        const size_t o = (((size_t)b * H + y0 + r / TW) * W + x0 + r % TW) * COUT + c;
        *reinterpret_cast<int4*>(out + o) = *reinterpret_cast<const int4*>(o_s + r * OS + c);
    }
}

// this lane's halo offsets (bf16) of its four A rows at tap (0, 0), channel 0
__device__ __forceinline__ void halo_rows(int (&off)[4], const Warp& wl) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
        const int m = wl.a_row(mi);
        off[mi] = ((m / TW) * HW2 + m % TW) * HS + wl.a_col();
    }
}

__device__ __forceinline__ int tap_off(int tap) { return ((tap / 3) * HW2 + tap % 3) * HS; }

// ---------------------------------------------------------------- tap9 --
// 9 chunks of K = 64, one a tap: A read straight from the halo tile at the
// tap's shift, all 9 accumulated into the same fragments.
__global__ void __launch_bounds__(THREADS, 2)
conv_tap9_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out,
                 int H, int W) {
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* w_s = reinterpret_cast<bf16*>(smem);                 // [2][64][WS]
    bf16* h_s = reinterpret_cast<bf16*>(smem + w_bytes(64));   // [HALO_PIX][HS]
    const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
    const Warp wl;
    int off[4];
    halo_rows(off, wl);
    const uint32_t h_base = smem_addr(h_s), w_base = smem_addr(w_s) + 2 * wl.b_off();
    float acc[4][4][4] = {};

    load_halo(h_s, x, b, y0, x0, H, W);
    load_w<64>(w_s, w, 0);
    cp_async_commit();
    for (int tap = 0; tap < 9; ++tap) {
        if (tap + 1 < 9) {
            load_w<64>(w_s + ((tap + 1) & 1) * 64 * WS, w, (tap + 1) * 64);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int shift = tap_off(tap);
        const uint32_t wb = w_base + (tap & 1) * 64 * WS * 2;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            uint32_t a[4];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) a[mi] = h_base + 2 * (off[mi] + shift + ks * 16);
            mma_step(acc, a, wb + ks * 16 * WS * 2);
        }
        __syncthreads();
    }
    stage_out(acc, w_s, wl);
    __syncthreads();
    write_conv_tile(w_s, out, b, y0, x0, H, W);
}

// --------------------------------------------------------------- pair5 --
// 5 chunks of K = 128 (packed weight): each step's A is two 64-channel
// halves at two tap offsets of the halo tile (taps 2p and 2p + 1; tap 8
// twice in the last, against zero weights), with no patch buffer.
__global__ void __launch_bounds__(THREADS, 2)
conv_pair5_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp_g, bf16* __restrict__ out,
                  int H, int W) {
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* w_s = reinterpret_cast<bf16*>(smem);                  // [2][128][WS]
    bf16* h_s = reinterpret_cast<bf16*>(smem + w_bytes(128));   // [HALO_PIX][HS]
    const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
    const Warp wl;
    int off[4];
    halo_rows(off, wl);
    const uint32_t h_base = smem_addr(h_s), w_base = smem_addr(w_s) + 2 * wl.b_off();
    float acc[4][4][4] = {};

    load_halo(h_s, x, b, y0, x0, H, W);
    load_w<128>(w_s, wp_g, 0);
    cp_async_commit();
    for (int p = 0; p < 5; ++p) {
        if (p + 1 < 5) {
            load_w<128>(w_s + ((p + 1) & 1) * 128 * WS, wp_g, (p + 1) * 128);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int lo = tap_off(2 * p), hi = tap_off(2 * p + 1 < 9 ? 2 * p + 1 : 2 * p);
        const uint32_t wb = w_base + (p & 1) * 128 * WS * 2;
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
            const int shift = (ks < 4 ? lo : hi) + (ks & 3) * 16;
            uint32_t a[4];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) a[mi] = h_base + 2 * (off[mi] + shift);
            mma_step(acc, a, wb + ks * 16 * WS * 2);
        }
        __syncthreads();
    }
    stage_out(acc, w_s, wl);
    __syncthreads();
    write_conv_tile(w_s, out, b, y0, x0, H, W);
}

// -------------------------------------------------------------- im2col --
// The [128, 640] patch buffer is built in shared memory (10 halves of 64
// channels a pixel: taps 0-8, then tap 8 again against zero weights), then
// consumed by one K = 640 loop over 10 weight chunks of 64 rows.
__global__ void __launch_bounds__(THREADS, 1)
conv_im2col_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp_g, bf16* __restrict__ out,
                   int H, int W) {
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* w_s = reinterpret_cast<bf16*>(smem);                 // [2][64][WS]
    bf16* p_s = reinterpret_cast<bf16*>(smem + w_bytes(64));   // [BM][PS]
    const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
    const Warp wl;
    const uint32_t p_base = smem_addr(p_s), w_base = smem_addr(w_s) + 2 * wl.b_off();
    float acc[4][4][4] = {};

    for (int i = threadIdx.x; i < BM * 80; i += THREADS) {
        const int m = i / 80, half = (i % 80) >> 3, c = (i & 7) * 8;
        const int tap = half < 9 ? half : 8;
        const int iy = y0 + m / TW + tap / 3 - 1, ix = x0 + m % TW + tap % 3 - 1;
        const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
        cp_async16(p_s + m * PS + half * 64 + c,
                   ok ? x + (((size_t)b * H + iy) * W + ix) * CIN + c : x, ok);
    }
    load_w<64>(w_s, wp_g, 0);
    cp_async_commit();
    for (int kc = 0; kc < 10; ++kc) {
        if (kc + 1 < 10) {
            load_w<64>(w_s + ((kc + 1) & 1) * 64 * WS, wp_g, (kc + 1) * 64);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const uint32_t wb = w_base + (kc & 1) * 64 * WS * 2;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            uint32_t a[4];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
                a[mi] = p_base + 2 * (wl.a_row(mi) * PS + kc * 64 + ks * 16 + wl.a_col());
            mma_step(acc, a, wb + ks * 16 * WS * 2);
        }
        __syncthreads();
    }
    stage_out(acc, w_s, wl);
    __syncthreads();
    write_conv_tile(w_s, out, b, y0, x0, H, W);
}

// ------------------------------------------------------------- dotceil --
// A plain [M, 640] @ [640, 128] product: A chunks of 128 rows x 64 columns
// of p and weight chunks of 64 rows, both streamed from global memory with
// two buffers each; no conv indexing. Rows past M read as zero and are not
// written.
__global__ void __launch_bounds__(THREADS, 2)
conv_dotceil_kernel(const bf16* __restrict__ p, const bf16* __restrict__ wp_g, bf16* __restrict__ out,
                    long long M) {
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* w_s = reinterpret_cast<bf16*>(smem);                 // [2][64][WS]
    bf16* a_s = reinterpret_cast<bf16*>(smem + w_bytes(64));   // [2][BM][AS]
    const long long m0 = (long long)blockIdx.x * BM;
    const Warp wl;
    const uint32_t a_base = smem_addr(a_s), w_base = smem_addr(w_s) + 2 * wl.b_off();
    float acc[4][4][4] = {};

    auto load_a = [&](int buf, int kc) {
        for (int i = threadIdx.x; i < BM * 8; i += THREADS) {
            const int r = i >> 3, c = (i & 7) * 8;
            const bool ok = m0 + r < M;
            cp_async16(a_s + (buf * BM + r) * AS + c,
                       ok ? p + (size_t)(m0 + r) * KP + kc * 64 + c : p, ok);
        }
    };
    load_a(0, 0);
    load_w<64>(w_s, wp_g, 0);
    cp_async_commit();
    for (int kc = 0; kc < 10; ++kc) {
        if (kc + 1 < 10) {
            load_a((kc + 1) & 1, kc + 1);
            load_w<64>(w_s + ((kc + 1) & 1) * 64 * WS, wp_g, (kc + 1) * 64);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const uint32_t wb = w_base + (kc & 1) * 64 * WS * 2;
        const uint32_t ab = a_base + (kc & 1) * BM * AS * 2;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            uint32_t a[4];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) a[mi] = ab + 2 * (wl.a_row(mi) * AS + ks * 16 + wl.a_col());
            mma_step(acc, a, wb + ks * 16 * WS * 2);
        }
        __syncthreads();
    }
    stage_out(acc, w_s, wl);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * 16; i += THREADS) {
        const int r = i >> 4, c = (i & 15) * 8;
        if (m0 + r < M)
            *reinterpret_cast<int4*>(out + (size_t)(m0 + r) * COUT + c) =
                *reinterpret_cast<const int4*>(w_s + r * OS + c);
    }
}

template <typename Kernel>
int launch(Kernel kernel, int smem, dim3 grid, cudaStream_t stream, const void* a, const void* w,
           void* out, int H, int W) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, smem, stream>>>(static_cast<const bf16*>(a), static_cast<const bf16*>(w),
                                            static_cast<bf16*>(out), H, W);
    return (int)cudaGetLastError();
}

bool conv_shape_ok(int B, int H, int W) {
    return B >= 1 && B <= 65535 && H >= TH && W >= TW && H % TH == 0 && W % TW == 0
        && H / TH <= 65535;
}

}  // namespace

// Each returns a cudaError_t; cudaErrorInvalidValue for a shape the kernel
// does not take (B, H, W with H a multiple of 4 and W of 32; M >= 1).
extern "C" int conv_tap9_launch(const void* x, const void* w, void* out, int B, int H, int W,
                                void* stream) {
    if (!conv_shape_ok(B, H, W)) return (int)cudaErrorInvalidValue;
    return launch(conv_tap9_kernel, SMEM_TAP9, dim3(W / TW, H / TH, B),
                  static_cast<cudaStream_t>(stream), x, w, out, H, W);
}

extern "C" int conv_im2col_launch(const void* x, const void* wp, void* out, int B, int H, int W,
                                  void* stream) {
    if (!conv_shape_ok(B, H, W)) return (int)cudaErrorInvalidValue;
    return launch(conv_im2col_kernel, SMEM_IM2COL, dim3(W / TW, H / TH, B),
                  static_cast<cudaStream_t>(stream), x, wp, out, H, W);
}

extern "C" int conv_pair5_launch(const void* x, const void* wp, void* out, int B, int H, int W,
                                 void* stream) {
    if (!conv_shape_ok(B, H, W)) return (int)cudaErrorInvalidValue;
    return launch(conv_pair5_kernel, SMEM_PAIR5, dim3(W / TW, H / TH, B),
                  static_cast<cudaStream_t>(stream), x, wp, out, H, W);
}

extern "C" int conv_dotceil_launch(const void* p, const void* wp, void* out, long long M,
                                   void* stream) {
    const long long blocks = (M + BM - 1) / BM;
    if (M < 1 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(conv_dotceil_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DOTCEIL);
    if (err != cudaSuccess) return (int)err;
    conv_dotceil_kernel<<<dim3((unsigned)blocks), THREADS, SMEM_DOTCEIL,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(p), static_cast<const bf16*>(wp), static_cast<bf16*>(out), M);
    return (int)cudaGetLastError();
}

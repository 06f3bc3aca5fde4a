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
// in the next 64; the last 64 rows (the duplicated tap 8) are zero in
// `pack_w`'s output, but every kernel multiplies them as given. Every
// product runs on the tensor cores with float32 sums; each output is rounded
// to bf16 once from its float32 sum.
//
// Bound: at B = 64, 128 x 128 px the conv does 154.6 GFLOP against 402 MB
// (x in, bf16 out), so it is bound by the operations (0.156 ms at 989
// TFLOP/s; bytes 0.120 ms). dotceil reads its 1.34 GB patch tensor and is
// bound by the bytes (0.481 ms at 3.35 TB/s): on this card the "ceiling" it
// measures is memory, not the matrix unit.
//
// tap9 and dotceil, the first port: `mma.sync.m16n8k16` bf16 with operands
// from shared memory through `ldmatrix`, which reaches only part of the
// card's peak. A block computes 128 output pixels x all 128 output channels
// (8 warps, each 64 pixels x 32 channels: 4 x 4 mma tiles, 64 float32 sums a
// thread). The weight is streamed through shared memory in K chunks of 64
// rows (two buffers, cp.async), so one chunk loads while the last one feeds
// the tensor cores. A tap9 block's pixels are a 4 x 32 tile of one image; its
// input is a 6 x 34 x 64 halo tile in shared memory. Shared rows are padded
// by 16 bytes (pixel stride 144 B, weight row 272 B), so the 8 rows of every
// ldmatrix fall in distinct banks. The 128 x 128 bf16 output tile is staged
// in shared memory and written out 16 bytes a thread.
//
// im2col and pair5 run on `wgmma` with TMA-fed operands in persistent,
// warp-specialised blocks: see their section below.
//
// Layouts: x bf16 NHWC [B, H, W, 64], H a multiple of 4 and W of 32; w bf16
// HWIO [3, 3, 64, 128] (tap9: K = 576 rows tap by tap); wp bf16 [640, 128];
// p bf16 [M, 640] (any M); out bf16 [B, H, W, 128] or [M, 128]; every
// pointer 16-byte aligned (TMA's rule for im2col's and pair5's x and wp).

#include <cuda.h>  // CUtensorMap and its enums; the driver function is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int CIN = 64, COUT = 128, KP = 640;
constexpr int BM = 128;               // output pixels (rows of the product) of a block
constexpr int TH = 4, TW = 32;        // a conv block's pixels: TH rows x TW columns
constexpr int THREADS = 256;           // tap9 and dotceil
constexpr int HW2 = TW + 2;           // halo tile width
constexpr int HALO_PIX = (TH + 2) * HW2;
constexpr int HS = CIN + 8;           // halo pixel stride, bf16 (144 B)
constexpr int WS = COUT + 8;          // weight row stride, bf16 (272 B)
constexpr int AS = 64 + 8;            // dotceil's A chunk row stride, bf16 (144 B)
constexpr int OS = COUT + 8;          // output staging row stride, bf16 (272 B)

__host__ __device__ constexpr int w_bytes(int rows) { return 2 * rows * WS * 2; }  // two weight buffers
constexpr int HALO_BYTES = HALO_PIX * HS * 2;                    // 29,376
constexpr int SMEM_TAP9 = w_bytes(64) + HALO_BYTES;              // 64,192
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

// ---------------------------------------------- im2col and pair5 on wgmma --
// Both run on `wgmma.mma_async` m64n128k16 (bf16 operands, float32 sums) in
// persistent blocks, one a streaming multiprocessor, that walk the output
// tiles (32 pixels wide, of one image) from blockIdx.x in steps of
// gridDim.x. A block has three roles, split once at the top and never joined
// again: two consumer warpgroups (`setmaxnreg` 232), each computing 64
// pixels x all 128 output channels at a time (64 float32 sums a thread, in
// registers), and a producer warpgroup (`setmaxnreg` 40) of which one thread
// works. It loads the whole packed weight once a block, then each tile's
// input halo, both by TMA (`cp.async.bulk.tensor`, 128-byte swizzle) on
// mbarriers. The halo's tensor map spans x as {64, W, H, B} and each load
// starts at (0, x0 - 1, y0 - 1, b): the zeros TMA fills in outside the
// tensor are the SAME padding. B, the weight, is read by `wgmma` from shared
// memory through descriptors: wp is N-contiguous, so each 64-column half
// lands as a [640][128 B] swizzled block and `wgmma` reads it MN-major (its
// transpose bit for 16-bit B; LBO the distance of the two halves, SBO 1024
// B, eight K rows). In a 128-byte-swizzled buffer (1024-byte aligned) the
// 16-byte chunk c of 128-byte line l sits at chunk c ^ (l & 7) of that line,
// so one pixel's 64 channels are one line, and the 8 rows any ldmatrix or
// patch copy touches fall in 8 distinct bank groups.
//
// pair5 (`pair5`, examples/pallas_conv_probe.py:172): A comes from registers,
// loaded by ldmatrix straight from the halo at each tap's shift (a shifted
// pixel is just another line; a descriptor would need the regular layout a
// one-pixel shift breaks). Per tap pair, 8 k16 products on one A set while
// the next pair's A loads into the other set (wgmma.wait_group 1 keeps one
// group in flight). A tile is 2 x 32 pixels, one warpgroup's; the two
// warpgroups take alternate tiles from a ring of three halo stages and take
// turns on the tensor cores (a turn barrier each: a warpgroup issues its
// tile's products after the other has issued its own), so one's epilogue
// runs under the other's products.
//   shared memory: weight 163,840 + 3 x 17,408 halo + barriers + 1,024 for
//   alignment = 217,216 B of 232,448.
// im2col (`im2col`, :132): every A operand comes from a patch matrix built
// in shared memory and read through a descriptor. A tile is 4 x 32 pixels,
// 64 rows a warpgroup. Each warpgroup builds its 64 rows x one 64-channel
// half (a tap; the 10th half is tap 8 again) at a time from the halo, 16
// bytes a thread, into a ring of two 8 KB stages in the canonical K-major
// 128-byte-swizzled layout, while the tensor cores run the 4 products of the
// half before it; `fence.proxy.async` and a warpgroup barrier stand between
// a stage's stores and the `wgmma` that reads it. The weight stays
// resident; that leaves room for one halo stage, which the producer refills
// once both warpgroups have built their last half, under the tile's last
// products and its epilogue (a weight streamed in 32 KB chunks instead
// would read the 160 KB weight from L2 per tile, 1.34 GB at B = 64, 128 x
// 128). The patch copy and `wgmma`'s operand reads share the shared
// memory's bandwidth, which pair5 does not spend on a copy.
//   shared memory: weight 163,840 + 26,624 halo + 4 x 8,192 patch +
//   barriers + 1,024 = 224,384 B of 232,448.
// Both multiply all 640 rows of wp as given (rows 576-639 too), as the TPU
// kernels do, and round each float32 sum to bf16 once; the epilogue
// transposes the bf16 pairs within each quad of lanes by shuffles and
// writes 16 bytes a lane, a quarter of the store instructions. Bound (B = 64, 128 x 128): 154.6 GFLOP of the
// conv at 989 TFLOP/s = 0.156 ms (both issue 640/576 of it); bytes 0.120 ms.

constexpr int WG_THREADS = 128;
// two consumer warpgroups and a producer warpgroup, of which one thread works
constexpr int HOP_THREADS = 3 * WG_THREADS;
constexpr int LINE = 128;                          // bytes: one pixel's 64 channels, one swizzle row
constexpr int HALO_BOX = HALO_PIX * LINE;          // 26,112 B: one TMA halo load
constexpr int HALO_STAGE = 26624;                  // the same, rounded up to 1024 B
constexpr int W_HALF = KP * LINE;                  // 81,920 B: one 64-column half of wp
constexpr int W_BYTES = 2 * W_HALF;                // 163,840 B
constexpr int PATCH_STAGE = 64 * LINE;             // 8,192 B: a warpgroup's 64 rows x K 64
constexpr int P_TH = 2;                            // pair5's tiles: 2 x 32 pixels, one warpgroup's
constexpr int P_HALO = (P_TH + 2) * HW2 * LINE;    // 17,408 B: one pair5 halo load and stage
constexpr int P_STAGES = 3;
constexpr int BARS = 128;                          // the mbarriers
constexpr int SMEM_PAIR5 = 1024 + W_BYTES + P_STAGES * P_HALO + BARS;                // 217,216
constexpr int SMEM_IM2COL = 1024 + W_BYTES + HALO_STAGE + 4 * PATCH_STAGE + BARS;     // 224,384
static_assert(HALO_BOX <= HALO_STAGE && HALO_STAGE % 1024 == 0 && P_HALO % 1024 == 0,
              "halo stages must stay aligned");
static_assert(SMEM_PAIR5 <= 232448 && SMEM_IM2COL <= 232448, "over the 227 KB a block may have");

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// until the phase of parity `parity` has completed; a wait that never ends
// (a lost TMA load) traps after 2^26 polls, seconds, rather than hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    for (uint32_t polls = 0; !done; ++polls) {
        if (polls == (1u << 26)) __trap();
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c1, int c2,
                                            int c3, uint32_t bar) {
    asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
                 :: "r"(dst), "l"(map), "r"(0), "r"(c1), "r"(c2), "r"(c3), "r"(bar) : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%2, %3}], [%4];\n"
                 :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(bar) : "memory");
}
__device__ __forceinline__ uint4 lds128(uint32_t a) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a) : "memory");
    return v;
}
__device__ __forceinline__ void sts128(uint32_t a, uint4 v) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
// generic-proxy stores to shared memory made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the 128 threads of consumer warpgroup wg (barriers 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_barrier(int wg) {
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accesses of these registers across a wgmma
// fence or wait (the products read and write them asynchronously)
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[8][4]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// shared address of 16-byte chunk c of 128-byte line l in a swizzled buffer
__device__ __forceinline__ uint32_t swz(uint32_t base, int l, int c) {
    return base + l * LINE + ((c ^ (l & 7)) << 4);
}
// wgmma descriptor of a 128-byte-swizzled operand at `addr` (byte offsets)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16
         | (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}
// B for K rows [r, r + 16) of the resident weight (MN-major)
__device__ __forceinline__ uint64_t w_desc(uint32_t w_s, int r) {
    return sw128_desc(w_s + r * LINE, W_HALF, 1024);
}

#define WG_D64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_D64_OPS(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
    "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
    "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
    "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
    "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
    "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
    "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), \
    "+f"(d[63])

// d (+)= A [64 x 16] (descriptor, K-major) * B [16 x 128] (descriptor, MN-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
                 ", %64, %65, p, 1, 1, 0, 1;\n}\n"
                 : WG_D64_OPS(d) : "l"(a), "l"(b), "r"(accumulate));
}
// d (+)= A [64 x 16] (registers: this warp's 16 rows, the m16n8k16 A fragment) * B
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
                 : WG_D64_OPS(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

struct Tile { int b, y0, x0; };
template <int ROWS>
__device__ __forceinline__ Tile tile_at(int t, int H, int W) {
    const int nx = W / TW, ny = H / ROWS;
    return {t / (nx * ny), t / nx % ny * ROWS, t % nx * TW};
}

// Barriers at `bars`: the weight's, then full[STAGES] (the producer's
// expect_tx), then empty[STAGES] (`readers` consumer threads each), then
// pair5's two turns (a warpgroup's 128 threads each).
template <int STAGES>
__device__ __forceinline__ void init_barriers(uint32_t bars, int readers) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
        mbar_init(bars + 8 + 8 * s, 1);
        mbar_init(bars + 8 + 8 * (STAGES + s), readers);
    }
    mbar_init(bars + 8 + 16 * STAGES, WG_THREADS);
    mbar_init(bars + 16 + 16 * STAGES, WG_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer (one thread): the packed weight, each 64-column half as five
// 128-row boxes, then the halo (ROWS + 2 lines of 34 pixels) of every tile
// of this block, in order, into a ring of STAGES stages of `stage` bytes.
template <int STAGES, int ROWS>
__device__ __forceinline__ void produce(const CUtensorMap* tm_x, const CUtensorMap* tm_w,
                                        uint32_t w_s, uint32_t h_s, uint32_t bars, int tiles,
                                        int H, int W, int stage) {
    const uint32_t full = bars + 8, empty = bars + 8 + 8 * STAGES;
    mbar_expect_tx(bars, W_BYTES);
    for (int h = 0; h < 2; ++h)
        for (int r = 0; r < KP; r += 128) tma_load_2d(w_s + h * W_HALF + r * LINE, tm_w, 64 * h, r, bars);
    int i = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        const int s = i % STAGES;
        mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, (ROWS + 2) * HW2 * LINE);
        const Tile tl = tile_at<ROWS>(t, H, W);
        tma_load_4d(h_s + s * stage, tm_x, tl.x0 - 1, tl.y0 - 1, tl.b, full + 8 * s);
    }
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
    return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// A consumer's 64 x 128 float32 sums, each rounded once to bf16, to out NHWC.
// Warp w's accumulators hold rows 16 w + g and + 8, columns 8 j + 2 t (+ 1)
// (g = lane / 4, t = lane % 4). A transpose within each quad by shuffles
// gives lane t the 8 columns of block j = 4 q + t, written as 16 bytes: a
// quarter of the stores of writing the pairs as they lie.
__device__ __forceinline__ void store_tile(const float (&d)[64], bf16* __restrict__ out, Tile tl,
                                           int wg, int H, int W) {
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int m = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // m and m + 8: one row
    bf16* o = out + (((size_t)tl.b * H + tl.y0 + m / TW) * W + tl.x0 + m % TW) * COUT;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            uint32_t v[4], r[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
                v[k] = pack_bf16x2(d[16 * q + 4 * k + 2 * h], d[16 * q + 4 * k + 2 * h + 1]);
            // r[x]: from lane t ^ x, its columns of block 4 q + t
#pragma unroll
            for (int x = 0; x < 4; ++x) r[x] = __shfl_xor_sync(0xffffffffu, pick4(v, t ^ x), x);
            *reinterpret_cast<uint4*>(o + h * 8 * COUT + 8 * (4 * q + t)) =
                make_uint4(pick4(r, t), pick4(r, t ^ 1), pick4(r, t ^ 2), pick4(r, t ^ 3));
        }
}

// this lane's A fragments of tap pair p (taps 2p and 2p + 1, tap 8 twice in
// the last): 8 k16 steps, ldmatrix at the tap's shifted halo line
__device__ __forceinline__ void load_pair(uint32_t (&a)[8][4], uint32_t halo, int line0, int hi,
                                          int p) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int tap = 2 * p + half < 9 ? 2 * p + half : 8;
        const int line = line0 + (tap / 3) * HW2 + tap % 3;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[4 * half + kk], swz(halo, line, 2 * kk + hi));
    }
}

__global__ void __launch_bounds__(HOP_THREADS, 1)
conv_pair5_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                  bf16* __restrict__ out, int H, int W, int tiles) {
    extern __shared__ unsigned char smem[];
    const uint32_t w_s = (smem_addr(smem) + 1023) & ~1023u;
    const uint32_t h_s = w_s + W_BYTES, bars = h_s + P_STAGES * P_HALO;
    if (threadIdx.x == 0) init_barriers<P_STAGES>(bars, WG_THREADS);
    __syncthreads();

    if (threadIdx.x >= 2 * WG_THREADS) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (threadIdx.x == 2 * WG_THREADS)
            produce<P_STAGES, P_TH>(&tm_x, &tm_w, w_s, h_s, bars, tiles, H, W, P_HALO);
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
        const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
        // this lane's ldmatrix row: pixel m of the tile, its halo line at tap (0, 0)
        const int m = 16 * ((threadIdx.x >> 5) & 3) + (lane & 15);
        const int line0 = (m / TW) * HW2 + m % TW, hi = lane >> 4;
        const uint32_t full = bars + 8, empty = full + 8 * P_STAGES, turn = empty + 8 * P_STAGES;
        float d[64] = {};
        uint32_t a[2][8][4];
        mbar_wait(bars, 0);
        // warpgroup wg takes every other tile of the block's walk (i = wg, wg + 2, ...)
        int k = 0;
        for (int i = wg, t = blockIdx.x + wg * gridDim.x; t < tiles;
             i += 2, t += 2 * gridDim.x, ++k) {
            const int s = i % P_STAGES;
            const uint32_t halo = h_s + s * P_HALO;
            mbar_wait(full + 8 * s, (i / P_STAGES) & 1);
            load_pair(a[0], halo, line0, hi, 0);
            // its turn: the other warpgroup has issued all its products of the tile before
            if (wg == 1 || k > 0) mbar_wait(turn + 8 * wg, (wg == 1 ? k : k - 1) & 1);
#pragma unroll
            for (int p = 0; p < 5; ++p) {
                wg_fence();
                fence_regs(d);
#pragma unroll
                for (int ks = 0; ks < 8; ++ks)
                    wgmma_rs(d, a[p & 1][ks], w_desc(w_s, 128 * p + 16 * ks), p + ks > 0);
                wg_commit();
                if (p < 4) {
                    wg_wait<1>();  // pair p - 1 done: its A set is free
                    fence_regs(a[(p + 1) & 1]);
                    load_pair(a[(p + 1) & 1], halo, line0, hi, p + 1);
                }
            }
            mbar_arrive(turn + 8 * (1 - wg));  // the other's turn, under this one's epilogue
            mbar_arrive(empty + 8 * s);        // this thread's last halo read is done
            wg_wait<0>();
            fence_regs(d);
            store_tile(d, out, tile_at<P_TH>(t, H, W), 0, H, W);
        }
    }
}

// Half j of this warpgroup's patch rows (tap min(j, 8)) from the halo into a
// swizzled 64 x 128 B stage: each warp copies its own 16 rows, 16 bytes a
// lane, four at a time.
__device__ __forceinline__ void build_half(uint32_t stage, uint32_t halo, int wg, int j) {
    const int tap = j < 9 ? j : 8, lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int shift = (tap / 3) * HW2 + tap % 3;
    uint4 v[4];
    int row[4], c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int idx = lane + 32 * q;
        row[q] = 16 * warp + (idx >> 3);
        c[q] = idx & 7;
        const int m = 64 * wg + row[q];
        v[q] = lds128(swz(halo, (m / TW) * HW2 + m % TW + shift, c[q]));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) sts128(swz(stage, row[q], c[q]), v[q]);
}

__global__ void __launch_bounds__(HOP_THREADS, 1)
conv_im2col_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                   bf16* __restrict__ out, int H, int W, int tiles) {
    extern __shared__ unsigned char smem[];
    const uint32_t w_s = (smem_addr(smem) + 1023) & ~1023u;
    const uint32_t h_s = w_s + W_BYTES, p_s = h_s + HALO_STAGE, bars = p_s + 4 * PATCH_STAGE;
    if (threadIdx.x == 0) init_barriers<1>(bars, 2 * WG_THREADS);
    __syncthreads();

    if (threadIdx.x >= 2 * WG_THREADS) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (threadIdx.x == 2 * WG_THREADS)
            produce<1, TH>(&tm_x, &tm_w, w_s, h_s, bars, tiles, H, W, HALO_STAGE);
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
        const int wg = threadIdx.x >> 7;
        const uint32_t patch = p_s + wg * 2 * PATCH_STAGE, full = bars + 8, empty = bars + 16;
        float d[64] = {};
        mbar_wait(bars, 0);
        int i = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
            mbar_wait(full, i & 1);
            build_half(patch, h_s, wg, 0);
            fence_proxy_async();
            wg_barrier(wg);
            for (int j = 0; j < 10; ++j) {
                const uint32_t stage = patch + (j & 1) * PATCH_STAGE;
                wg_fence();
                fence_regs(d);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss(d, sw128_desc(stage + 32 * kk, 16, 1024), w_desc(w_s, 64 * j + 16 * kk),
                             j + kk > 0);
                wg_commit();
                if (j < 9) {
                    wg_wait<1>();       // half j - 1 done in this warp ...
                    wg_barrier(wg);     // ... and in the others: its stage is free
                    build_half(patch + ((j + 1) & 1) * PATCH_STAGE, h_s, wg, j + 1);
                    if (j == 8) mbar_arrive(empty);  // this thread's last halo read is done
                    fence_proxy_async();
                    wg_barrier(wg);
                }
            }
            wg_wait<0>();
            fence_regs(d);
            store_tile(d, out, tile_at<TH>(t, H, W), wg, H, W);
        }
    }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (no
// -lcuda); null if the driver has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                                 cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                        cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// The halo map over x {64, W, H, B} (box 64 x 34 x (rows + 2) x 1) and the
// weight map over wp {128, 640} (box 64 x 128), both 128-byte swizzled.
int encode_maps(CUtensorMap* tm_x, CUtensorMap* tm_w, const void* x, const void* wp, int B, int H,
                int W, int rows) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
    const cuuint64_t x_dim[4] = {CIN, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t x_stride[3] = {CIN * 2, (cuuint64_t)W * CIN * 2, (cuuint64_t)H * W * CIN * 2};
    const cuuint32_t x_box[4] = {CIN, HW2, (cuuint32_t)rows + 2, 1}, ones[4] = {1, 1, 1, 1};
    const cuuint64_t w_dim[2] = {COUT, KP}, w_stride[1] = {COUT * 2};
    const cuuint32_t w_box[2] = {64, 128};
    if (encode(tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), x_dim, x_stride,
               x_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS
        || encode(tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wp), w_dim, w_stride,
                  w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    return 0;
}

// a persistent launch over tiles of `rows` x 32 pixels: one block a
// streaming multiprocessor, or one a tile if fewer
template <typename Kernel>
int launch_persistent(Kernel kernel, int smem, int rows, cudaStream_t stream, const void* x,
                      const void* wp, void* out, int B, int H, int W) {
    const long long tiles = (long long)B * (H / rows) * (W / TW);
    if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
    CUtensorMap tm_x, tm_w;
    int err = encode_maps(&tm_x, &tm_w, x, wp, B, H, W, rows);
    if (err) return err;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const int grid = tiles < sms ? (int)tiles : sms;
    kernel<<<grid, HOP_THREADS, smem, stream>>>(tm_x, tm_w, static_cast<bf16*>(out), H, W, (int)tiles);
    return (int)cudaGetLastError();
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
// does not take (B, H, W with H a multiple of 4 and W of 32; M >= 1) or, for
// im2col and pair5, a tensor map the driver refuses to encode;
// cudaErrorSymbolNotFound when the driver has no cuTensorMapEncodeTiled.
extern "C" int conv_tap9_launch(const void* x, const void* w, void* out, int B, int H, int W,
                                void* stream) {
    if (!conv_shape_ok(B, H, W)) return (int)cudaErrorInvalidValue;
    return launch(conv_tap9_kernel, SMEM_TAP9, dim3(W / TW, H / TH, B),
                  static_cast<cudaStream_t>(stream), x, w, out, H, W);
}

extern "C" int conv_im2col_launch(const void* x, const void* wp, void* out, int B, int H, int W,
                                  void* stream) {
    if (!conv_shape_ok(B, H, W)) return (int)cudaErrorInvalidValue;
    return launch_persistent(conv_im2col_kernel, SMEM_IM2COL, TH, static_cast<cudaStream_t>(stream),
                             x, wp, out, B, H, W);
}

extern "C" int conv_pair5_launch(const void* x, const void* wp, void* out, int B, int H, int W,
                                 void* stream) {
    if (!conv_shape_ok(B, H, W)) return (int)cudaErrorInvalidValue;
    return launch_persistent(conv_pair5_kernel, SMEM_PAIR5, P_TH, static_cast<cudaStream_t>(stream),
                             x, wp, out, B, H, W);
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

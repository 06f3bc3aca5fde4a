// The four formulations of the bf16 conv3x3 probe as tensor-core kernels for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels of examples/pallas_conv_probe.py, the go/no-go
// probe for a whole-stage fused kernel: can a hand-written conv3x3 match the
// library's at the model's hottest conv, h_net3's ResBlock conv1 ([B, 128,
// 128, 64] -> 128 channels, bf16, float32 sums)?
//
//   conv_tap9_kernel     `tap9`    (:85):  9 shifted K = 64 products
//   conv_im2col_kernel   `im2col`  (:132): a [pixels, 640] patch matrix, then
//                                          one K = 640 loop
//   conv_pair5_kernel    `pair5`   (:172): 5 paired K = 128 products, no patch
//   conv_dotceil_kernel  `dotceil` (:196): a plain [M, 640] @ [640, 128] product
//
// out[b, y, x, n] = sum over (dy, dx, c) of x[b, y + dy - 1, x + dx - 1, c] *
// w[dy, dx, c, n], SAME zero padding, Cin 64, Cout 128. The packed weight wp
// [640, 128] (`pack_w`) holds tap 2p in rows 128p .. 128p + 63 and tap 2p + 1
// in the next 64, so tap j is in rows 64j .. 64j + 63 exactly as in the HWIO
// weight seen as [576, 128]; the last 64 rows (the duplicated tap 8) are zero
// in `pack_w`'s output, but im2col, pair5 and dotceil multiply them as given.
// Every product runs on the tensor cores with float32 sums; each output is
// rounded to bf16 once from its float32 sum.
//
// Bound: at B = 64, 128 x 128 px the conv does 154.6 GFLOP against 402 MB
// (x in, bf16 out), so tap9, im2col and pair5 are bound by the operations
// (0.156 ms at 989 TFLOP/s; bytes 0.120 ms). dotceil reads its 1.34 GB patch
// tensor and is bound by the bytes (0.481 ms at 3.35 TB/s): on this card the
// "ceiling" it measures is memory, not the matrix unit.
//
// All four run on `wgmma` m64n128k16 with TMA-fed operands in persistent,
// warp-specialised blocks (see the section below). The weight is loaded once
// a block and stays resident, so device memory sees each input about once
// (a weight streamed per tile would read the 160 KB from L2 per 128 rows,
// 1.34 GB at B = 64). What each does about its bound:
//   tap9 and pair5 (operations): A by ldmatrix from the TMA halo at each
//     tap's shift into registers, no patch copy, two warpgroups on alternate
//     tiles so that one's epilogue runs under the other's products. tap9 is
//     pair5's walk over the nine 64-row halves of the HWIO weight instead of
//     the ten of wp.
//   im2col (operations): the patch matrix built from the halo in shared
//     memory and read through descriptors, at the cost of shared memory's
//     bandwidth.
//   dotceil (bytes): p streams through a ring of four TMA stages that runs
//     across tiles, so the loads never wait on an epilogue; p and the output
//     are its only device-memory traffic.
//
// Layouts: x bf16 NHWC [B, H, W, 64], H a multiple of 4 and W of 32; w bf16
// HWIO [3, 3, 64, 128] (tap9: K = 576 rows tap by tap); wp bf16 [640, 128];
// p bf16 [M, 640] (1 <= M < 2^31); out bf16 [B, H, W, 128] or [M, 128];
// every input 16-byte aligned (TMA's rule).

#include <cuda.h>  // CUtensorMap and its enums; the driver function is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int CIN = 64, COUT = 128, KP = 640;
constexpr int TH = 4, TW = 32;        // im2col's tile: TH rows x TW columns of one image
constexpr int HW2 = TW + 2;           // halo tile width
constexpr int HALO_PIX = (TH + 2) * HW2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// ---------------------------------------------------------------- wgmma --
// All four run on `wgmma.mma_async` m64n128k16 (bf16 operands, float32 sums)
// in persistent blocks, one a streaming multiprocessor, that walk the output
// tiles from blockIdx.x in steps of gridDim.x. A block has three roles, split
// once at the top and never joined again: two consumer warpgroups
// (`setmaxnreg` 232), each computing 64 rows x all 128 output channels at a
// time (64 float32 sums a thread, in registers), and a producer warpgroup
// (`setmaxnreg` 40) of which one thread works. It loads the whole weight once
// a block, then each tile's A operand (a conv's input halo, dotceil's chunks
// of p), both by TMA (`cp.async.bulk.tensor`, 128-byte swizzle) on
// mbarriers. The halo's tensor map spans x as {64, W, H, B} and each load
// starts at (0, x0 - 1, y0 - 1, b): the zeros TMA fills in outside the
// tensor are the SAME padding. B, the weight, is read by `wgmma` from shared
// memory through descriptors: it is N-contiguous, so each 64-column half
// lands as a [rows][128 B] swizzled block (64-row boxes; the halves 81,920 B
// apart whatever the rows) and `wgmma` reads it MN-major (its transpose bit
// for 16-bit B; LBO the distance of the two halves, SBO 1024 B, eight K
// rows). In a 128-byte-swizzled buffer (1024-byte aligned) the 16-byte chunk
// c of 128-byte line l sits at chunk c ^ (l & 7) of that line, so one
// pixel's 64 channels are one line, and the 8 rows any ldmatrix or patch
// copy touches fall in 8 distinct bank groups.
//
// pair5 (`pair5`, examples/pallas_conv_probe.py:172) and tap9 (`tap9`, :85):
// A comes from registers, loaded by ldmatrix straight from the halo at each
// tap's shift (a shifted pixel is just another line; a descriptor would need
// the regular layout a one-pixel shift breaks). Half j of the K walk is tap
// min(j, 8) against weight rows 64j .. 64j + 63: ten halves of wp for pair5,
// the nine of the HWIO weight for tap9. Per pair of halves, 8 k16 products
// (4 for tap9's last, single half) on one A set while the next pair's A
// loads into the other set (wgmma.wait_group 1 keeps one group in flight). A
// tile is 2 x 32 pixels, one warpgroup's; the two warpgroups take alternate
// tiles from a ring of three halo stages and take turns on the tensor cores
// (a turn barrier each: a warpgroup issues its tile's products after the
// other has issued its own), so one's epilogue runs under the other's
// products.
//   shared memory: weight 163,840 (tap9 fills 147,456 of it) + 3 x 17,408
//   halo + barriers + 1,024 for alignment = 217,216 B of 232,448.
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
// products and its epilogue. The patch copy and `wgmma`'s operand reads
// share the shared memory's bandwidth, which pair5 does not spend on a copy.
//   shared memory: weight 163,840 + 26,624 halo + 4 x 8,192 patch +
//   barriers + 1,024 = 224,384 B of 232,448.
// dotceil (`dotceil`, :196): im2col's consumer fed straight from p. A tile is
// 128 rows of p; the producer streams it as ten {64 K, 128 rows} chunks (16
// KB, the canonical K-major swizzled layout as TMA writes it) through a ring
// of four stages on full and empty mbarriers, across tiles; each warpgroup
// multiplies its 64 rows of a chunk. Rows past M are zero-filled by TMA and
// not stored.
//   shared memory: weight 163,840 + 4 x 16,384 + barriers + 1,024 = 230,528 B.
// im2col, pair5 and dotceil multiply all 640 rows of wp as given (rows
// 576-639 too), as the TPU kernels do, and each rounds its float32 sums to
// bf16 once; the epilogue transposes the bf16 pairs within each quad of
// lanes by shuffles and writes 16 bytes a lane, a quarter of the store
// instructions.

constexpr int WG_THREADS = 128;
// two consumer warpgroups and a producer warpgroup, of which one thread works
constexpr int HOP_THREADS = 3 * WG_THREADS;
constexpr int LINE = 128;                          // bytes: one pixel's 64 channels, one swizzle row
constexpr int HALO_BOX = HALO_PIX * LINE;          // 26,112 B: one TMA halo load
constexpr int HALO_STAGE = 26624;                  // the same, rounded up to 1024 B
constexpr int W_HALF = KP * LINE;                  // 81,920 B: one 64-column half of the weight
constexpr int W_BYTES = 2 * W_HALF;                // 163,840 B
constexpr int W_BOX = 64;                          // weight rows a TMA load
constexpr int PATCH_STAGE = 64 * LINE;             // 8,192 B: a warpgroup's 64 rows x K 64
constexpr int P_TH = 2;                            // pair5's and tap9's tiles: 2 x 32 pixels
constexpr int P_HALO = (P_TH + 2) * HW2 * LINE;    // 17,408 B: one pair5 halo load and stage
constexpr int P_STAGES = 3;
constexpr int D_ROWS = 128;                        // dotceil's tile: rows of p, 64 a warpgroup
constexpr int D_CHUNK = D_ROWS * LINE;             // 16,384 B: one TMA load of p, 64 K x 128 rows
constexpr int D_STAGES = 4;
constexpr int BARS = 128;                          // the mbarriers
constexpr int SMEM_PAIR5 = 1024 + W_BYTES + P_STAGES * P_HALO + BARS;                // 217,216
constexpr int SMEM_IM2COL = 1024 + W_BYTES + HALO_STAGE + 4 * PATCH_STAGE + BARS;     // 224,384
constexpr int SMEM_DOTCEIL = 1024 + W_BYTES + D_STAGES * D_CHUNK + BARS;             // 230,528
static_assert(HALO_BOX <= HALO_STAGE && HALO_STAGE % 1024 == 0 && P_HALO % 1024 == 0,
              "halo stages must stay aligned");
static_assert(SMEM_PAIR5 <= 232448 && SMEM_IM2COL <= 232448 && SMEM_DOTCEIL <= 232448,
              "over the 227 KB a block may have");
static_assert(8 + 16 * D_STAGES + 16 <= BARS, "the barriers must fit their room");

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
// pair5's and tap9's two turns (a warpgroup's 128 threads each).
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

// The weight's `rows` x 128 (N-contiguous) into its two resident 64-column
// halves, W_BOX rows a load, on barrier `bar`.
__device__ __forceinline__ void load_weight(const CUtensorMap* tm_w, uint32_t w_s, uint32_t bar,
                                            int rows) {
    mbar_expect_tx(bar, 2 * rows * LINE);
    for (int h = 0; h < 2; ++h)
        for (int r = 0; r < rows; r += W_BOX) tma_load_2d(w_s + h * W_HALF + r * LINE, tm_w, 64 * h, r, bar);
}

// The producer of a conv (one thread): the weight, then the halo (ROWS + 2
// lines of 34 pixels) of every tile of this block, in order, into a ring of
// STAGES stages of `stage` bytes.
template <int STAGES, int ROWS>
__device__ __forceinline__ void produce(const CUtensorMap* tm_x, const CUtensorMap* tm_w,
                                        uint32_t w_s, uint32_t h_s, uint32_t bars, int tiles,
                                        int H, int W, int stage, int w_rows) {
    const uint32_t full = bars + 8, empty = bars + 8 + 8 * STAGES;
    load_weight(tm_w, w_s, bars, w_rows);
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

// The row of a consumer warpgroup's 64 whose sums this thread holds with
// those of the row 8 below: 64 wg + 16 w + g (warp w, g = lane / 4).
__device__ __forceinline__ int quad_row(int wg) {
    return 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
}

// A consumer's 64 x 128 float32 sums, each rounded once to bf16: this
// thread's rows (quad_row) to o and o + 8 rows of 128, the first `rows` of
// the two. Warp w's accumulators hold rows 16 w + g and + 8, columns 8 j + 2
// t (+ 1) (t = lane % 4). A transpose within each quad by shuffles gives
// lane t the 8 columns of block j = 4 q + t, written as 16 bytes: a quarter
// of the stores of writing the pairs as they lie.
__device__ __forceinline__ void store_rows(const float (&d)[64], bf16* __restrict__ o, int rows) {
    const int t = threadIdx.x & 3;
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
            if (h < rows)
                *reinterpret_cast<uint4*>(o + h * 8 * COUT + 8 * (4 * q + t)) =
                    make_uint4(pick4(r, t), pick4(r, t ^ 1), pick4(r, t ^ 2), pick4(r, t ^ 3));
        }
}

// ... of a conv tile's 64 pixels (wg's of the tile) to out NHWC
__device__ __forceinline__ void store_tile(const float (&d)[64], bf16* __restrict__ out, Tile tl,
                                           int wg, int H, int W) {
    const int m = quad_row(wg);  // m and m + 8: one image row
    store_rows(d, out + (((size_t)tl.b * H + tl.y0 + m / TW) * W + tl.x0 + m % TW) * COUT, 2);
}

// this lane's A fragments of halves 2p and 2p + 1 (tap min(j, 8) for half j;
// a half past NH is not loaded): 4 k16 steps each, ldmatrix at the tap's
// shifted halo line
template <int NH>
__device__ __forceinline__ void load_pair(uint32_t (&a)[8][4], uint32_t halo, int line0, int hi,
                                          int p) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int j = 2 * p + half, tap = j < 9 ? j : 8;
        const int line = line0 + (tap / 3) * HW2 + tap % 3;
        if (j < NH) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[4 * half + kk], swz(halo, line, 2 * kk + hi));
        }
    }
}

// pair5 (NH 10, wp) and tap9 (NH 9, the HWIO weight): a conv tile's K walk
// over NH 64-row halves of the resident weight, by pairs of halves
template <int NH>
__device__ __forceinline__ void conv_halves(const CUtensorMap* tm_x, const CUtensorMap* tm_w,
                                            bf16* __restrict__ out, int H, int W, int tiles) {
    constexpr int NP = (NH + 1) / 2;
    extern __shared__ unsigned char smem[];
    const uint32_t w_s = (smem_addr(smem) + 1023) & ~1023u;
    const uint32_t h_s = w_s + W_BYTES, bars = h_s + P_STAGES * P_HALO;
    if (threadIdx.x == 0) init_barriers<P_STAGES>(bars, WG_THREADS);
    __syncthreads();

    if (threadIdx.x >= 2 * WG_THREADS) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (threadIdx.x == 2 * WG_THREADS)
            produce<P_STAGES, P_TH>(tm_x, tm_w, w_s, h_s, bars, tiles, H, W, P_HALO, 64 * NH);
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
            load_pair<NH>(a[0], halo, line0, hi, 0);
            // its turn: the other warpgroup has issued all its products of the tile before
            if (wg == 1 || k > 0) mbar_wait(turn + 8 * wg, (wg == 1 ? k : k - 1) & 1);
#pragma unroll
            for (int p = 0; p < NP; ++p) {
                const int steps = 2 * p + 1 < NH ? 8 : 4;
                wg_fence();
                fence_regs(d);
#pragma unroll
                for (int ks = 0; ks < steps; ++ks)
                    wgmma_rs(d, a[p & 1][ks], w_desc(w_s, 128 * p + 16 * ks), p + ks > 0);
                wg_commit();
                if (p + 1 < NP) {
                    wg_wait<1>();  // pair p - 1 done: its A set is free
                    fence_regs(a[(p + 1) & 1]);
                    load_pair<NH>(a[(p + 1) & 1], halo, line0, hi, p + 1);
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

__global__ void __launch_bounds__(HOP_THREADS, 1)
conv_tap9_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                 bf16* __restrict__ out, int H, int W, int tiles) {
    conv_halves<9>(&tm_x, &tm_w, out, H, W, tiles);
}

__global__ void __launch_bounds__(HOP_THREADS, 1)
conv_pair5_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                  bf16* __restrict__ out, int H, int W, int tiles) {
    conv_halves<10>(&tm_x, &tm_w, out, H, W, tiles);
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
            produce<1, TH>(&tm_x, &tm_w, w_s, h_s, bars, tiles, H, W, HALO_STAGE, KP);
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

// A [M, 640] @ [640, 128] product, 128 rows of p a tile: the producer loads
// the weight once, then streams every tile's ten chunks of p through the
// ring; each consumer warpgroup multiplies its 64 rows of each chunk and
// frees the chunk's stage once its products are done.
__global__ void __launch_bounds__(HOP_THREADS, 1)
conv_dotceil_kernel(const __grid_constant__ CUtensorMap tm_p, const __grid_constant__ CUtensorMap tm_w,
                    bf16* __restrict__ out, int M, int tiles) {
    extern __shared__ unsigned char smem[];
    const uint32_t w_s = (smem_addr(smem) + 1023) & ~1023u;
    const uint32_t a_s = w_s + W_BYTES, bars = a_s + D_STAGES * D_CHUNK;
    const uint32_t full = bars + 8, empty = full + 8 * D_STAGES;
    if (threadIdx.x == 0) init_barriers<D_STAGES>(bars, 2 * WG_THREADS);
    __syncthreads();

    if (threadIdx.x >= 2 * WG_THREADS) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (threadIdx.x == 2 * WG_THREADS) {
            load_weight(&tm_w, w_s, bars, KP);
            int i = 0;
            for (int t = blockIdx.x; t < tiles; t += gridDim.x)
                for (int c = 0; c < KP / 64; ++c, ++i) {
                    const int s = i % D_STAGES;
                    mbar_wait(empty + 8 * s, ((i / D_STAGES) & 1) ^ 1);
                    mbar_expect_tx(full + 8 * s, D_CHUNK);
                    tma_load_2d(a_s + s * D_CHUNK, &tm_p, 64 * c, D_ROWS * t, full + 8 * s);
                }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
        const int wg = threadIdx.x >> 7;
        float d[64] = {};
        mbar_wait(bars, 0);
        int i = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
#pragma unroll
            for (int c = 0; c < KP / 64; ++c, ++i) {
                const int s = i % D_STAGES;
                const uint32_t a = a_s + s * D_CHUNK + wg * (D_CHUNK / 2);
                mbar_wait(full + 8 * s, (i / D_STAGES) & 1);
                wg_fence();
                fence_regs(d);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss(d, sw128_desc(a + 32 * kk, 16, 1024), w_desc(w_s, 64 * c + 16 * kk),
                             c + kk > 0);
                wg_commit();
                wg_wait<1>();  // chunk i - 1 done: its stage is free
                if (c > 0) mbar_arrive(empty + 8 * ((i - 1) % D_STAGES));
            }
            wg_wait<0>();
            mbar_arrive(empty + 8 * ((i - 1) % D_STAGES));
            fence_regs(d);
            const long long r = (long long)t * D_ROWS + quad_row(wg);
            store_rows(d, out + r * COUT, r >= M ? 0 : r + 8 >= M ? 1 : 2);
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

// A 128-byte-swizzled bf16 map of `rank` dims (dim[0] contiguous).
int encode(CUtensorMap* tm, const void* base, int rank, const cuuint64_t* dim,
           const cuuint64_t* stride, const cuuint32_t* box, CUtensorMapL2promotion l2) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    return fn(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dim, stride, box,
              ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, l2,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the halo map over x {64, W, H, B}, box 64 x 34 x (rows + 2) x 1
int encode_halo(CUtensorMap* tm, const void* x, int B, int H, int W, int rows) {
    const cuuint64_t dim[4] = {CIN, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t stride[3] = {CIN * 2, (cuuint64_t)W * CIN * 2, (cuuint64_t)H * W * CIN * 2};
    const cuuint32_t box[4] = {CIN, HW2, (cuuint32_t)rows + 2, 1};
    return encode(tm, x, 4, dim, stride, box, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

// a map over a row-major [rows][cols] bf16 matrix, box 64 columns x box_rows
int encode_rows(CUtensorMap* tm, const void* a, int cols, long long rows, int box_rows) {
    const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows}, stride[1] = {(cuuint64_t)cols * 2};
    const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
    return encode(tm, a, 2, dim, stride, box, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

// a persistent launch over `tiles` tiles: one block a streaming
// multiprocessor, or one a tile if fewer; the kernel takes args..., tiles
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, int smem, long long tiles, cudaStream_t stream, Args... args) {
    if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const int grid = tiles < sms ? (int)tiles : sms;
    kernel<<<grid, HOP_THREADS, smem, stream>>>(args..., (int)tiles);
    return (int)cudaGetLastError();
}

// a conv over tiles of `rows` x 32 pixels, its weight's `w_rows` x 128 resident
template <typename Kernel>
int launch_conv(Kernel kernel, int smem, int rows, int w_rows, void* stream, const void* x,
                const void* w, void* out, int B, int H, int W) {
    if (B < 1 || H < TH || W < TW || H % TH || W % TW) return (int)cudaErrorInvalidValue;
    CUtensorMap tm_x, tm_w;
    int err = encode_halo(&tm_x, x, B, H, W, rows);
    if (!err) err = encode_rows(&tm_w, w, COUT, w_rows, W_BOX);
    if (err) return err;
    return launch_persistent(kernel, smem, (long long)B * (H / rows) * (W / TW),
                             static_cast<cudaStream_t>(stream), tm_x, tm_w, static_cast<bf16*>(out),
                             H, W);
}

}  // namespace

// Each returns a cudaError_t; cudaErrorInvalidValue for a shape the kernel
// does not take (B, H, W with H a multiple of 4 and W of 32; 1 <= M < 2^31)
// or a tensor map the driver refuses to encode; cudaErrorSymbolNotFound when
// the driver has no cuTensorMapEncodeTiled.
extern "C" int conv_tap9_launch(const void* x, const void* w, void* out, int B, int H, int W,
                                void* stream) {
    return launch_conv(conv_tap9_kernel, SMEM_PAIR5, P_TH, 9 * CIN, stream, x, w, out, B, H, W);
}

extern "C" int conv_im2col_launch(const void* x, const void* wp, void* out, int B, int H, int W,
                                  void* stream) {
    return launch_conv(conv_im2col_kernel, SMEM_IM2COL, TH, KP, stream, x, wp, out, B, H, W);
}

extern "C" int conv_pair5_launch(const void* x, const void* wp, void* out, int B, int H, int W,
                                 void* stream) {
    return launch_conv(conv_pair5_kernel, SMEM_PAIR5, P_TH, KP, stream, x, wp, out, B, H, W);
}

extern "C" int conv_dotceil_launch(const void* p, const void* wp, void* out, long long M,
                                   void* stream) {
    if (M < 1 || M > 2147483647LL) return (int)cudaErrorInvalidValue;
    CUtensorMap tm_p, tm_w;
    int err = encode_rows(&tm_p, p, KP, M, D_ROWS);
    if (!err) err = encode_rows(&tm_w, wp, COUT, KP, W_BOX);
    if (err) return err;
    return launch_persistent(conv_dotceil_kernel, SMEM_DOTCEIL, (M + D_ROWS - 1) / D_ROWS,
                             static_cast<cudaStream_t>(stream), tm_p, tm_w, static_cast<bf16*>(out),
                             (int)M);
}

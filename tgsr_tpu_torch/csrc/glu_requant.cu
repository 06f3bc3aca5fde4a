// GLU + requantize to int8, for Hopper (sm_90a).
//
// Replaces examples/glu_pallas_probe.py `glu_requant_one` (:72, Pallas row 8)
// and `glu_requant_pair` (:96, row 9): h [N, 2c] bfloat16, value half first
// and gate half second for each pixel -> q [N, c] int8 with, per element,
//   s = bf16(sigmoid(float(g)))      (the gate in float32, rounded once)
//   v = bf16(float(v) * float(s))    (the product of two bf16 is exact in f32)
//   q = int8(rint(clamp(float(v) / step, -127, 127)))
// in the order of the probe's `_glu_q`: the pass of
// tgsr_tpu/engine/quant.py:239-241 followed by `quantize_act` (:137-142),
// with the gate computed in float32 and rounded once; division by the step
// (no reciprocal), round half to even.
// sigmoid is 1 / (1 + expf(-g)) with the precise expf: the build has no
// --use_fast_math.
//
// One source, two instances, as the probe's two layouts: a row is 128 bf16
// (256 contiguous bytes) and one warp reads one row, 8 bytes a lane.
//   C = 64 (`glu_requant_one`): one pixel a row, lanes 0-15 hold its values
//     and lanes 16-31 its gates;
//   C = 32 (`glu_requant_pair`): two pixels a row ([N/2, 4c]), lanes 0-7 and
//     16-23 values, 8-15 and 24-31 gates.
// Each value lane takes its gates from the lane C/4 above it by a shuffle
// and writes 4 int8 (one 32-bit store); a row gives 64 contiguous bytes.
// A ragged last row (N odd in the pair layout) is masked by element.
//
// Bound: device memory. A pixel reads 4c bytes and writes c (5 bytes an
// output); about 10 operations per output element, far below the card's
// operations-per-byte line. The design reads each byte once, coalesced, with
// grid-stride warps and no shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW = 128;  // bf16 elements of one row read by one warp

__device__ inline float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ inline int8_t requant(float v, float g, float step) {
    const float s = bf16_round(__frcp_rn(__fadd_rn(1.0f, expf(-g))));
    const float h = bf16_round(__fmul_rn(v, s));
    const float r = rintf(fminf(fmaxf(__fdiv_rn(h, step), -127.0f), 127.0f));
    return static_cast<int8_t>(static_cast<int>(r));
}

template <int C>
__global__ void __launch_bounds__(256)
glu_requant_kernel(const __nv_bfloat16* __restrict__ h, int8_t* __restrict__ q,
                   long long n_in, float step) {
    constexpr int LANES = C / 4;  // lanes of one half of one pixel
    const int lane = threadIdx.x & 31;
    const int seg = lane / LANES;  // even: values, odd: gates
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    const long long rows = (n_in + ROW - 1) / ROW;
    for (long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; row < rows;
         row += warps) {
        const long long e = row * ROW + lane * 4;  // first element of this lane
        uint2 raw = make_uint2(0u, 0u);
        if (e < n_in) raw = *reinterpret_cast<const uint2*>(h + e);
        uint2 gate;
        gate.x = __shfl_down_sync(0xffffffffu, raw.x, LANES);
        gate.y = __shfl_down_sync(0xffffffffu, raw.y, LANES);
        if ((seg & 1) || e >= n_in) continue;
        const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(&raw);
        const __nv_bfloat16* gb = reinterpret_cast<const __nv_bfloat16*>(&gate);
        char4 out;
        out.x = requant(__bfloat162float(vb[0]), __bfloat162float(gb[0]), step);
        out.y = requant(__bfloat162float(vb[1]), __bfloat162float(gb[1]), step);
        out.z = requant(__bfloat162float(vb[2]), __bfloat162float(gb[2]), step);
        out.w = requant(__bfloat162float(vb[3]), __bfloat162float(gb[3]), step);
        // a row of 128 inputs gives 64 outputs: pixel seg / 2 of the row
        const long long o = row * (ROW / 2) + (seg / 2) * C + (lane % LANES) * 4;
        *reinterpret_cast<char4*>(q + o) = out;
    }
}

}  // namespace

// h: bfloat16 [N, 2c], q: int8 [N, c], c in {64, 32}; n_pixels = N.
// Returns a cudaError_t.
extern "C" int glu_requant_launch(const void* h, void* q, long long n_pixels, int c,
                                  float step, void* stream) {
    if ((c != 64 && c != 32) || n_pixels < 0) return (int)cudaErrorInvalidValue;
    if (n_pixels == 0) return 0;
    const long long n_in = n_pixels * 2 * c;
    const long long rows = (n_in + ROW - 1) / ROW;
    const int threads = 256;
    long long blocks = (rows + threads / 32 - 1) / (threads / 32);
    if (blocks > 132 * 32) blocks = 132 * 32;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (c == 64)
        glu_requant_kernel<64><<<(int)blocks, threads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(h), static_cast<int8_t*>(q), n_in, step);
    else
        glu_requant_kernel<32><<<(int)blocks, threads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(h), static_cast<int8_t*>(q), n_in, step);
    return (int)cudaGetLastError();
}

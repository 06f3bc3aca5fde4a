// Word -> pixel cross-attention for the generator stages, float32.
//
// Replaces the TPU kernel tgsr_tpu/ops/pallas_attention.py `_attn_kernel`
// (entered through `_attention_flat` / `word_pixel_attention_pallas`):
//   logits[p, t] = <pixels[b, p, :], words[b, t, :]>
//   attn[p, :]   = softmax_t(where(mask[b, t], -1e9, logits[p, t]))
//   ctx[b, p, :] = sum_t attn[p, t] * words[b, t, :]
// On the x8 face-SR path C = 32, T = 18 and HW = 32^2, 64^2, 128^2.
//
// What bounds it on an H100: memory. Per pixel it reads C floats and writes
// C floats (plus T when the attention map is asked for) and does about
// 4*T*C flops, i.e. ~9 flop per byte moved -- far below the card's f32
// ridge (67 TFLOP/s over 3.35 TB/s = 20 flop per byte, even further below
// the tensor-core one). The least time is the pixel read plus the ctx write
// at full memory rate.
//
// What the design does about it: each pixel is read once and each output
// written once, with coalesced loads and stores. A block takes a tile of
// TILE pixels of one sample: it stages words[b] (T x C) and the mask in
// shared memory, copies the pixel tile in with consecutive threads on
// consecutive addresses into a row-padded (C + 1) shared tile (so that the
// per-pixel reads below hit distinct banks), then each thread owns one
// pixel: T logits in registers, the where-filled softmax in registers, the
// ctx row back into its own row of the shared tile, and a coalesced store.
// The attention map is written as [B, T, H, W] directly (consecutive
// threads -> consecutive pixels) and only when the caller passes a buffer;
// serving passes none.
//
// Why CUDA C++ and not a tensor-core tile: the work is a reduction over
// tiny T and C per pixel, a few dozen FMAs per loaded float, so a plain
// loop over a register array is as fast as the memory allows and keeps the
// masked softmax exact in float32.
//
// The mask is a where-fill (-1e9 replaces the logit), as in the JAX XLA
// path tgsr_tpu/ops/attention.py `masked_softmax`, and not the Pallas
// kernel's additive `mask * -1e9`: the two differ for a caption whose every
// token is padding, where the where-fill gives a uniform 1/T.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 128;   // pixels per block = threads per block
constexpr int TMAX = 32;    // largest caption length the kernel takes
constexpr float NEG_FILL = -1e9f;

__global__ void __launch_bounds__(TILE)
word_pixel_attention_kernel(const float* __restrict__ pixels,   // [B, HW, C]
                            const float* __restrict__ words,    // [B, T, C]
                            const unsigned char* __restrict__ mask,  // [B, T] or null
                            float* __restrict__ ctx,            // [B, HW, C]
                            float* __restrict__ attn,           // [B, T, HW] or null
                            int hw, int c, int t) {
  extern __shared__ float smem[];
  float* w_s = smem;                  // [T, C]
  float* p_s = smem + t * c;          // [TILE, C + 1]
  __shared__ int m_s[TMAX];

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const int npix = min(TILE, hw - p0);
  const int cs = c + 1;

  const float* wb = words + (size_t)b * t * c;
  for (int i = tid; i < t * c; i += TILE) w_s[i] = wb[i];
  if (tid < t) m_s[tid] = mask ? (int)mask[(size_t)b * t + tid] : 0;
  const float* pb = pixels + ((size_t)b * hw + p0) * c;
  for (int i = tid; i < npix * c; i += TILE) p_s[(i / c) * cs + i % c] = pb[i];
  __syncthreads();

  if (tid < npix) {
    float* row = p_s + tid * cs;
    float l[TMAX];
#pragma unroll
    for (int k = 0; k < TMAX; ++k) l[k] = 0.f;
    for (int ci = 0; ci < c; ++ci) {
      const float v = row[ci];
#pragma unroll
      for (int k = 0; k < TMAX; ++k)
        if (k < t) l[k] = fmaf(v, w_s[k * c + ci], l[k]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < TMAX; ++k)
      if (k < t) {
        if (m_s[k]) l[k] = NEG_FILL;
        mx = fmaxf(mx, l[k]);
      }
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < TMAX; ++k)
      if (k < t) {
        l[k] = expf(l[k] - mx);
        sum += l[k];
      }
    const float inv = 1.f / sum;
#pragma unroll
    for (int k = 0; k < TMAX; ++k)
      if (k < t) l[k] *= inv;
    if (attn) {
      float* ab = attn + (size_t)b * t * hw + p0 + tid;
#pragma unroll
      for (int k = 0; k < TMAX; ++k)
        if (k < t) ab[(size_t)k * hw] = l[k];
    }
    // the thread's own row is free again: overwrite it with the ctx row
    for (int ci = 0; ci < c; ++ci) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < TMAX; ++k)
        if (k < t) s = fmaf(l[k], w_s[k * c + ci], s);
      row[ci] = s;
    }
  }
  __syncthreads();
  float* cb = ctx + ((size_t)b * hw + p0) * c;
  for (int i = tid; i < npix * c; i += TILE) cb[i] = p_s[(i / c) * cs + i % c];
}

}  // namespace

// Returns the CUDA error code of the launch (0 = success). The launch is
// asynchronous on `stream`; nothing is allocated and nothing synchronises.
extern "C" int word_pixel_attention_launch(
    const float* pixels, const float* words, const unsigned char* mask,
    float* ctx, float* attn, int b, int hw, int c, int t, void* stream) {
  if (t < 1 || t > TMAX || c < 1 || hw < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)t * c + (size_t)TILE * (c + 1));
  cudaError_t err = cudaFuncSetAttribute(
      word_pixel_attention_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((hw + TILE - 1) / TILE, b);
  word_pixel_attention_kernel<<<grid, TILE, smem, (cudaStream_t)stream>>>(
      pixels, words, mask, ctx, attn, hw, c, t);
  return (int)cudaGetLastError();
}

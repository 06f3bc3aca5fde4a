// Word -> pixel cross-attention for the generator stages, float32 or
// bfloat16 in and out (pixels, words, ctx and attn in one element type),
// float32 inside: logits, softmax and sums.
//
// Replaces the TPU kernel tgsr_tpu/ops/pallas_attention.py `_attn_kernel`
// (entered through `_attention_flat` / `word_pixel_attention_pallas`):
//   logits[p, t] = <pixels[b, p, :], words[b, t, :]>
//   attn[p, :]   = softmax_t(where(mask[b, t], -1e9, logits[p, t]))
//   ctx[b, p, :] = sum_t attn[p, t] * words[b, t, :]
// On the x8 face-SR path C = 32, T = 18 and HW = 32^2, 64^2, 128^2.
//
// What bounds it on an H100: memory. Per pixel it reads C values and writes
// C (plus T when the attention map is asked for) and does about 4*T*C
// flops, i.e. ~9 flop per byte moved in float32 -- below the card's float32
// ridge (67 TFLOP/s over 3.35 TB/s = 20 flop per byte). The least time is
// the pixel read plus the ctx write at full memory rate. In bfloat16 the
// bytes halve and the flops do not, so there the CUDA cores' rate is about
// as near as the memory's.
//
// What the design does about it: the flops must be fed from registers, not
// shared memory. A block of 64 threads takes a tile of 128 pixels of one
// sample; each thread owns 2 of them (pixels tid and tid + 64), so that
// every 16-byte broadcast read of a word's 4 channels from shared memory
// feeds 8 FMAs, and every 16-byte read of a pixel's 4 channels feeds 4 T.
// Pixels come in with 16-byte loads, consecutive threads on consecutive
// addresses, 8 loads in flight a thread, are widened to float32 in a shared
// tile (row stride C + 4 floats, so that 8 threads' 16-byte reads of 8 rows
// fall in distinct banks), and ctx goes back through the same rows and out
// with 16-byte stores. The staging loops index by shift and mask (C / the
// 16-byte piece is a power of two), not by division. 128 pixels x 144 bytes
// = 18 KB a block at C = 32: ten blocks (twenty warps) an SM, whose staging
// and arithmetic overlap. The logits of a thread's 2 pixels (2 x TB, TB the
// caption length rounded up to 8, a template parameter) and the softmax stay
// in registers. Four pixels a thread read the words half as often but held
// 139 registers at T = 18, half the warps an SM, and ran slower on the
// card: latency, not the shared-memory reads, sets the pace. The sums run
// over the channels and then the words in the order of the first port, so
// the float32 instance gives the same bits.
// The attention map is written as [B, T, H, W] directly (consecutive
// threads -> consecutive pixels) and only when the caller passes a buffer;
// serving passes none.
//
// Why not the tensor cores: both products have T <= 32 and C = 32, the
// float32 instance has to stay within 1e-4 of float32 (one TF32 product does
// not), and the arithmetic at the CUDA cores' peak is about 0.05 ms a
// forward, a third of what the kernel takes.
//
// bfloat16: the same kernel, instantiated for __nv_bfloat16. Each element is
// widened to float32 as it is staged and rounded to bfloat16 once, as it is
// stored, so the bfloat16 instance moves half the bytes and computes what the
// float32 one computes on the widened inputs.
//
// The mask is a where-fill (-1e9 replaces the logit), as in the JAX XLA
// path tgsr_tpu/ops/attention.py `masked_softmax`, and not the Pallas
// kernel's additive `mask * -1e9`: the two differ for a caption whose every
// token is padding, where the where-fill gives a uniform 1/T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;          // two warps
constexpr int PX = 2;                // pixels a thread
constexpr int TILE = THREADS * PX;   // pixels a block
constexpr int UNROLL = 8;            // 16-byte loads a thread keeps in flight while staging
constexpr int TMAX = 32;             // largest caption length the kernel takes
constexpr int MIN_BLOCKS = 10;       // blocks an SM at C = 32 (shared memory)
constexpr float NEG_FILL = -1e9f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a 16-byte piece of global memory (4 float32 or 8 bfloat16), widened to
// float32 into shared memory at d, and back from shared memory at s
__device__ __forceinline__ void widen(uint4 v, float* d, const float*) {
  *reinterpret_cast<float4*>(d) =
      make_float4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                  __uint_as_float(v.w));
}
__device__ __forceinline__ void widen(uint4 v, float* d, const __nv_bfloat16*) {
  // a bfloat16 is the upper half of the float32 with the same value
  *reinterpret_cast<float4*>(d) =
      make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                  __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  *reinterpret_cast<float4*>(d + 4) =
      make_float4(__uint_as_float(v.z << 16), __uint_as_float(v.z & 0xffff0000u),
                  __uint_as_float(v.w << 16), __uint_as_float(v.w & 0xffff0000u));
}
__device__ __forceinline__ uint4 narrow(const float* s, const float*) {
  const float4 f = *reinterpret_cast<const float4*>(s);
  return make_uint4(__float_as_uint(f.x), __float_as_uint(f.y), __float_as_uint(f.z),
                    __float_as_uint(f.w));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint4 narrow(const float* s, const __nv_bfloat16*) {
  const float4 f = *reinterpret_cast<const float4*>(s);
  const float4 g = *reinterpret_cast<const float4*>(s + 4);
  return make_uint4(pack_bf16(f.x, f.y), pack_bf16(f.z, f.w), pack_bf16(g.x, g.y),
                    pack_bf16(g.z, g.w));
}

template <typename T, int TB>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
word_pixel_attention_kernel(const T* __restrict__ pixels,   // [B, HW, C]
                            const T* __restrict__ words,    // [B, T, C]
                            const unsigned char* __restrict__ mask,  // [B, T] or null
                            T* __restrict__ ctx,            // [B, HW, C]
                            T* __restrict__ attn,           // [B, T, HW] or null
                            int hw, int c, int t, int shift) {
  constexpr int PER = 16 / sizeof(T);  // elements of a 16-byte piece
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [T, C]
  float* p_s = w_s + t * c;                      // [TILE, C + 4]
  __shared__ int m_s[TMAX];

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const int npix = min(TILE, hw - p0);
  const int cs = c + 4;
  const int n16 = npix << shift, piece = (1 << shift) - 1;  // 16-byte pieces; a pixel has 2^shift

  const T* wb = words + (size_t)b * t * c;
  for (int i = tid; i < t * c; i += THREADS) w_s[i] = to_f(wb[i]);
  if (tid < t) m_s[tid] = mask ? (int)mask[(size_t)b * t + tid] : 0;
  const uint4* src = reinterpret_cast<const uint4*>(pixels + ((size_t)b * hw + p0) * c);
  for (int i0 = tid; i0 < n16; i0 += THREADS * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i0 + u * THREADS < n16) v[u] = __ldg(src + i0 + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n16) widen(v[u], p_s + (i >> shift) * cs + (i & piece) * PER, pixels);
    }
  }
  __syncthreads();

  // rows past npix hold stale shared memory: computed, never stored
  float l[PX][TB];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < TB; ++k) l[j][k] = 0.f;
  for (int c4 = 0; c4 < c; c4 += 4) {
    float4 pv[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j)
      pv[j] = *reinterpret_cast<const float4*>(p_s + (tid + THREADS * j) * cs + c4);
#pragma unroll
    for (int k = 0; k < TB; ++k) {
      if (k >= t) break;
      const float4 wv = *reinterpret_cast<const float4*>(w_s + k * c + c4);
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        l[j][k] = fmaf(pv[j].x, wv.x, l[j][k]);
        l[j][k] = fmaf(pv[j].y, wv.y, l[j][k]);
        l[j][k] = fmaf(pv[j].z, wv.z, l[j][k]);
        l[j][k] = fmaf(pv[j].w, wv.w, l[j][k]);
      }
    }
  }
  unsigned padded = 0;
#pragma unroll
  for (int k = 0; k < TB; ++k)
    if (k < t && m_s[k]) padded |= 1u << k;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < TB; ++k)
      if (k < t) {
        if (padded >> k & 1u) l[j][k] = NEG_FILL;
        mx = fmaxf(mx, l[j][k]);
      }
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < TB; ++k)
      if (k < t) {
        l[j][k] = expf(l[j][k] - mx);
        sum += l[j][k];
      }
    const float inv = 1.f / sum;
#pragma unroll
    for (int k = 0; k < TB; ++k)
      if (k < t) l[j][k] *= inv;
  }
  if (attn) {
    T* ab = attn + (size_t)b * t * hw + p0;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int pix = tid + THREADS * j;
      if (pix >= npix) continue;
#pragma unroll
      for (int k = 0; k < TB; ++k)
        if (k < t) ab[(size_t)k * hw + pix] = from_f<T>(l[j][k]);
    }
  }
  // each thread's own rows are free again: overwrite them with ctx
  for (int c4 = 0; c4 < c; c4 += 4) {
    float4 s[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) s[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < TB; ++k) {
      if (k >= t) break;
      const float4 wv = *reinterpret_cast<const float4*>(w_s + k * c + c4);
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        s[j].x = fmaf(l[j][k], wv.x, s[j].x);
        s[j].y = fmaf(l[j][k], wv.y, s[j].y);
        s[j].z = fmaf(l[j][k], wv.z, s[j].z);
        s[j].w = fmaf(l[j][k], wv.w, s[j].w);
      }
    }
#pragma unroll
    for (int j = 0; j < PX; ++j)
      *reinterpret_cast<float4*>(p_s + (tid + THREADS * j) * cs + c4) = s[j];
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(ctx + ((size_t)b * hw + p0) * c);
  for (int i = tid; i < n16; i += THREADS)
    dst[i] = narrow(p_s + (i >> shift) * cs + (i & piece) * PER, pixels);
}

size_t smem_bytes(int c, int t) { return sizeof(float) * ((size_t)t * c + (size_t)TILE * (c + 4)); }

template <typename T, int TB>
int launch_tb(const void* pixels, const void* words, const unsigned char* mask, void* ctx,
              void* attn, int b, int hw, int c, int t, int shift, cudaStream_t stream) {
  const size_t smem = smem_bytes(c, t);
  cudaError_t err = cudaFuncSetAttribute(
      word_pixel_attention_kernel<T, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((hw + TILE - 1) / TILE, b);
  word_pixel_attention_kernel<T, TB><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(pixels), static_cast<const T*>(words), mask, static_cast<T*>(ctx),
      static_cast<T*>(attn), hw, c, t, shift);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* pixels, const void* words, const unsigned char* mask, void* ctx,
           void* attn, int b, int hw, int c, int t, cudaStream_t stream) {
  // C of 16-byte pieces a pixel, a power of two
  const int per = 16 / (int)sizeof(T);
  if (c % per) return (int)cudaErrorInvalidValue;
  int shift = 0;
  while ((per << shift) < c) ++shift;
  if ((per << shift) != c || smem_bytes(c, t) > 232448) return (int)cudaErrorInvalidValue;
  if (t <= 8) return launch_tb<T, 8>(pixels, words, mask, ctx, attn, b, hw, c, t, shift, stream);
  if (t <= 16) return launch_tb<T, 16>(pixels, words, mask, ctx, attn, b, hw, c, t, shift, stream);
  if (t <= 24) return launch_tb<T, 24>(pixels, words, mask, ctx, attn, b, hw, c, t, shift, stream);
  return launch_tb<T, 32>(pixels, words, mask, ctx, attn, b, hw, c, t, shift, stream);
}


// ---------------------------------------------------------------------------
// Backward (training). No TPU kernel has one: the JAX package differentiates
// XLA's einsum path (tgsr_tpu/ops/attention.py:86, `jax.grad`), and its
// Pallas kernel has no custom_vjp. On the card the port's wrapper must launch
// a kernel or raise, so the generator trains through this one.
//
// Per sample b, pixel p and word t, with s = P W^T, a = masked softmax over
// t, ctx = a W, g = dL/dctx and (optionally) ga = dL/dattn [B, T, HW]:
//   dA[p, t] = g_p . W_t + ga[t, p]
//   dS[p, t] = a[p, t] (dA[p, t] - sum_t' a[p, t'] dA[p, t']), 0 at padded t
//              (the where-fill passes no gradient; an all-padded row is
//              uniform and gets dS = 0, as JAX's masked_softmax)
//   dP_p     = sum_t dS[p, t] W_t
//   dW_t     = sum_p a[p, t] g_p + dS[p, t] P_p
//
// What bounds it: memory, as the forward. Per pixel it reads P and g (2C)
// and writes dP (C), about 8 T C flops: ~11 flop per byte in float32, below
// the card's float32 ridge (20 flop per byte).
//
// Design, simple and right first: nothing is saved from the forward but its
// inputs. A block of 128 threads takes a tile of 128 pixels of one sample,
// one pixel a thread, stages P and g (16-byte loads, widened to float32) and
// W in shared memory, and recomputes the logits and the softmax of its pixel
// in registers (T <= 32), with the forward's sums in the forward's order, so
// that a is the forward's a. dS goes to shared memory beside a; the block's
// partial dW over its tile, a [T, C] float32 sum over its pixels in pixel
// order, goes to a workspace [B, tiles, T, C]; then dP overwrites the
// thread's own g row and goes out with 16-byte stores. A second launch sums
// the tiles' partials in tile order. No float atomics: the backward gives the
// same bits on every run, as the forward does.
// ---------------------------------------------------------------------------

constexpr int BWD_THREADS = 128;        // one pixel a thread
constexpr int BWD_TILE = BWD_THREADS;   // pixels a block
constexpr int BWD_MIN_BLOCKS = 3;       // blocks an SM at C = 32 (shared memory)
constexpr int RED_THREADS = 256;

size_t bwd_smem_bytes(int c, int t) {
  const size_t cs = c + 4, ts = t | 1;
  return sizeof(float) * ((size_t)t * c + 2 * BWD_TILE * cs + 2 * BWD_TILE * ts);
}

template <typename T, int TB>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
word_pixel_attention_bwd_kernel(const T* __restrict__ pixels,   // [B, HW, C]
                                const T* __restrict__ words,    // [B, T, C]
                                const unsigned char* __restrict__ mask,  // [B, T] or null
                                const T* __restrict__ gctx,     // [B, HW, C]
                                const T* __restrict__ gattn,    // [B, T, HW] or null
                                T* __restrict__ dpixels,        // [B, HW, C]
                                float* __restrict__ ws,         // [B, tiles, T, C]
                                int hw, int c, int t, int shift) {
  constexpr int PER = 16 / sizeof(T);
  extern __shared__ float4 smem4[];
  const int cs = c + 4, ts = t | 1;  // row strides: 16-byte rows; odd, for the a / dS rows
  float* w_s = reinterpret_cast<float*>(smem4);  // [T, C]
  float* p_s = w_s + t * c;                      // [TILE, cs]
  float* g_s = p_s + BWD_TILE * cs;              // [TILE, cs], then dP
  float* a_s = g_s + BWD_TILE * cs;              // [TILE, ts]
  float* d_s = a_s + BWD_TILE * ts;              // [TILE, ts]
  __shared__ int m_s[TMAX];

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * BWD_TILE;
  const int tid = threadIdx.x;
  const int npix = min(BWD_TILE, hw - p0);
  const int n16 = npix << shift, piece = (1 << shift) - 1;

  const T* wb = words + (size_t)b * t * c;
  for (int i = tid; i < t * c; i += BWD_THREADS) w_s[i] = to_f(wb[i]);
  if (tid < t) m_s[tid] = mask ? (int)mask[(size_t)b * t + tid] : 0;
  const size_t base = ((size_t)b * hw + p0) * c;
  const uint4* psrc = reinterpret_cast<const uint4*>(pixels + base);
  const uint4* gsrc = reinterpret_cast<const uint4*>(gctx + base);
  for (int i0 = tid; i0 < n16; i0 += BWD_THREADS * UNROLL) {
    uint4 v[UNROLL], u[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      if (i0 + k * BWD_THREADS < n16) {
        v[k] = __ldg(psrc + i0 + k * BWD_THREADS);
        u[k] = __ldg(gsrc + i0 + k * BWD_THREADS);
      }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = i0 + k * BWD_THREADS;
      if (i < n16) {
        const int off = (i >> shift) * cs + (i & piece) * PER;
        widen(v[k], p_s + off, pixels);
        widen(u[k], g_s + off, pixels);
      }
    }
  }
  __syncthreads();

  // the thread's pixel: logits as the forward sums them, and g . W_t; rows
  // past npix hold stale shared memory and are never stored or summed
  float l[TB], d[TB];
#pragma unroll
  for (int k = 0; k < TB; ++k) l[k] = d[k] = 0.f;
  for (int c4 = 0; c4 < c; c4 += 4) {
    const float4 pv = *reinterpret_cast<const float4*>(p_s + tid * cs + c4);
    const float4 gv = *reinterpret_cast<const float4*>(g_s + tid * cs + c4);
#pragma unroll
    for (int k = 0; k < TB; ++k) {
      if (k >= t) break;
      const float4 wv = *reinterpret_cast<const float4*>(w_s + k * c + c4);
      l[k] = fmaf(pv.x, wv.x, l[k]);
      l[k] = fmaf(pv.y, wv.y, l[k]);
      l[k] = fmaf(pv.z, wv.z, l[k]);
      l[k] = fmaf(pv.w, wv.w, l[k]);
      d[k] = fmaf(gv.x, wv.x, d[k]);
      d[k] = fmaf(gv.y, wv.y, d[k]);
      d[k] = fmaf(gv.z, wv.z, d[k]);
      d[k] = fmaf(gv.w, wv.w, d[k]);
    }
  }
  unsigned padded = 0;
#pragma unroll
  for (int k = 0; k < TB; ++k)
    if (k < t && m_s[k]) padded |= 1u << k;
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < TB; ++k)
    if (k < t) {
      if (padded >> k & 1u) l[k] = NEG_FILL;
      mx = fmaxf(mx, l[k]);
    }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < TB; ++k)
    if (k < t) {
      l[k] = expf(l[k] - mx);
      sum += l[k];
    }
  const float inv = 1.f / sum;
#pragma unroll
  for (int k = 0; k < TB; ++k)
    if (k < t) l[k] *= inv;
  if (gattn && tid < npix) {
    const T* gab = gattn + (size_t)b * t * hw + p0 + tid;
#pragma unroll
    for (int k = 0; k < TB; ++k)
      if (k < t) d[k] += to_f(gab[(size_t)k * hw]);
  }
  float dot = 0.f;
#pragma unroll
  for (int k = 0; k < TB; ++k)
    if (k < t) dot = fmaf(l[k], d[k], dot);
#pragma unroll
  for (int k = 0; k < TB; ++k)
    if (k < t) {
      d[k] = (padded >> k & 1u) ? 0.f : l[k] * (d[k] - dot);
      a_s[tid * ts + k] = l[k];
      d_s[tid * ts + k] = d[k];
    }
  __syncthreads();

  // the tile's partial dW, in pixel order: consecutive threads on consecutive
  // channels of one word (a and dS broadcast, g and P conflict-free)
  float* wsb = ws + ((size_t)b * gridDim.x + blockIdx.x) * t * c;
  for (int o = tid; o < t * c; o += BWD_THREADS) {
    const int k = o / c, ch = o - k * c;
    float acc = 0.f;
    for (int p = 0; p < npix; ++p)
      acc = fmaf(a_s[p * ts + k], g_s[p * cs + ch], fmaf(d_s[p * ts + k], p_s[p * cs + ch], acc));
    wsb[o] = acc;
  }
  __syncthreads();

  // dP of the thread's pixel over its own g row, then out
  for (int c4 = 0; c4 < c; c4 += 4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < TB; ++k) {
      if (k >= t) break;
      const float4 wv = *reinterpret_cast<const float4*>(w_s + k * c + c4);
      s.x = fmaf(d[k], wv.x, s.x);
      s.y = fmaf(d[k], wv.y, s.y);
      s.z = fmaf(d[k], wv.z, s.z);
      s.w = fmaf(d[k], wv.w, s.w);
    }
    *reinterpret_cast<float4*>(g_s + tid * cs + c4) = s;
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(dpixels + base);
  for (int i = tid; i < n16; i += BWD_THREADS)
    dst[i] = narrow(g_s + (i >> shift) * cs + (i & piece) * PER, pixels);
}

// dW[b, o] = sum over the tiles, in tile order, of the partials
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
word_pixel_attention_bwd_reduce(const float* __restrict__ ws, T* __restrict__ dwords,
                                int tiles, int tc) {
  const int b = blockIdx.y;
  const int o = blockIdx.x * RED_THREADS + threadIdx.x;
  if (o >= tc) return;
  const float* src = ws + (size_t)b * tiles * tc + o;
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < tiles; ++i) acc += src[(size_t)i * tc];
  dwords[(size_t)b * tc + o] = from_f<T>(acc);
}

template <typename T, int TB>
int bwd_tb(const void* pixels, const void* words, const unsigned char* mask, const void* gctx,
           const void* gattn, void* dpixels, void* dwords, float* ws, int b, int hw, int c,
           int t, int shift, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(c, t);
  cudaError_t err = cudaFuncSetAttribute(word_pixel_attention_bwd_kernel<T, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (hw + BWD_TILE - 1) / BWD_TILE;
  word_pixel_attention_bwd_kernel<T, TB><<<dim3(tiles, b), BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(pixels), static_cast<const T*>(words), mask,
      static_cast<const T*>(gctx), static_cast<const T*>(gattn), static_cast<T*>(dpixels), ws,
      hw, c, t, shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  word_pixel_attention_bwd_reduce<T><<<dim3((t * c + RED_THREADS - 1) / RED_THREADS, b),
                                       RED_THREADS, 0, stream>>>(ws, static_cast<T*>(dwords),
                                                                 tiles, t * c);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* pixels, const void* words, const unsigned char* mask, const void* gctx,
        const void* gattn, void* dpixels, void* dwords, float* ws, int b, int hw, int c, int t,
        cudaStream_t stream) {
  const int per = 16 / (int)sizeof(T);
  if (c % per) return (int)cudaErrorInvalidValue;
  int shift = 0;
  while ((per << shift) < c) ++shift;
  if ((per << shift) != c || bwd_smem_bytes(c, t) > 232448) return (int)cudaErrorInvalidValue;
  if (t <= 8)
    return bwd_tb<T, 8>(pixels, words, mask, gctx, gattn, dpixels, dwords, ws, b, hw, c, t,
                        shift, stream);
  if (t <= 16)
    return bwd_tb<T, 16>(pixels, words, mask, gctx, gattn, dpixels, dwords, ws, b, hw, c, t,
                         shift, stream);
  if (t <= 24)
    return bwd_tb<T, 24>(pixels, words, mask, gctx, gattn, dpixels, dwords, ws, b, hw, c, t,
                         shift, stream);
  return bwd_tb<T, 32>(pixels, words, mask, gctx, gattn, dpixels, dwords, ws, b, hw, c, t,
                       shift, stream);
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (pixels, words, ctx and attn alike). C * the
// element size must be 16 bytes times a power of two, pixels and ctx
// 16-byte aligned. Returns the CUDA error code of the launch (0 = success).
// The launch is asynchronous on `stream`; nothing is allocated and nothing
// synchronises.
extern "C" int word_pixel_attention_launch(
    const void* pixels, const void* words, const unsigned char* mask,
    void* ctx, void* attn, int b, int hw, int c, int t, int dtype, void* stream) {
  if (t < 1 || t > TMAX || c < 1 || hw < 1 || b < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(pixels, words, mask, ctx, attn, b, hw, c, t, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(pixels, words, mask, ctx, attn, b, hw, c, t, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's float32 workspace, in bytes: [B, tiles of 128 pixels, T, C].
extern "C" long long word_pixel_attention_bwd_workspace(int b, int hw, int c, int t) {
  return (long long)b * ((hw + BWD_TILE - 1) / BWD_TILE) * t * c * (long long)sizeof(float);
}

// dtype as the forward's; gctx, dpixels as pixels (16-byte aligned), gattn
// [B, T, HW] or null, dwords [B, T, C], ws word_pixel_attention_bwd_workspace
// bytes of float32. Two launches on `stream` (the tiles, then their sum);
// returns the CUDA error code (0 = success).
extern "C" int word_pixel_attention_bwd_launch(
    const void* pixels, const void* words, const unsigned char* mask, const void* gctx,
    const void* gattn, void* dpixels, void* dwords, void* ws, int b, int hw, int c, int t,
    int dtype, void* stream) {
  if (t < 1 || t > TMAX || c < 1 || hw < 1 || b < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return bwd<float>(pixels, words, mask, gctx, gattn, dpixels, dwords, w, b, hw, c, t, s);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(pixels, words, mask, gctx, gattn, dpixels, dwords, w, b, hw, c,
                              t, s);
  return (int)cudaErrorInvalidValue;
}

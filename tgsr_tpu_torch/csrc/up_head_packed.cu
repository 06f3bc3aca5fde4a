// Fused final-stage tail of the generators in the parity-packed domain,
// float32 or bfloat16 in, float32 out:
//   out = head_k(GLU(BN(conv3x3(up2(x))))) [-> tanh] [+ a * srb]
// computed at the source resolution: up2 + conv3x3 is a 2x2 conv to 4
// parity classes of C2 channels, BN and GLU act per class, and the k x k
// head (k in {3, 5}) is a 3x3 conv on the packed grid whose class-remapped
// weights sum the 4 classes into 12 = 4 output pixels x 3 channels.
//
// Replaces the TPU kernel tgsr_tpu/ops/pallas_up_head.py
// `fused_up_head_packed` (kernel closure and pallas_call there). On the
// bfloat16 x8 face-SR path it runs at two sites, both 128 -> 256 px:
//   h_net3.upsample + img_net3      Cin 64, C2 64, 3x3 head
//   upscale8x + conv_output + a*srb Cin 32, C2 64, 5x5 head, tanh, blend
// Inputs come packed by tgsr_tpu_torch/ops/packed_tail.py `pack_up_head`:
// w_up [2, 2, Cin, 4*C2] (class-major channels), w_head [3, 3, 4*C, 12]
// (C = C2/2), both in the element type; BN folded to float32 (mul, add).
//
// What bounds it on an H100: arithmetic. Per output pixel the function
// needs 4*Cin*C2 multiply-adds for the up-conv and k*k*C*3 for the head,
// against 4*Cin (float32) or 2*Cin (bfloat16) bytes of input and 12 bytes
// of output: hundreds of flops per byte. In float32 the least time is those
// flops at the card's float32 rate outside the tensor cores; in bfloat16 it
// is those flops at the bfloat16 tensor-core rate. This kernel multiplies
// on the CUDA cores in float32 in both types, so in bfloat16 it cannot come
// near its bound: the 2x2 conv is an implicit GEMM [pixels x 4*Cin] x
// [4*Cin x C2] for mma.sync or wgmma, a later step.
//
// What the design does about it: a block owns one sample and a TR x TC
// tile of packed pixels (8 x 16, i.e. 16 x 32 output pixels). It stages
// the zero-padded source tile (2 pixels of halo) once, then walks over the
// 4 parity classes p of the GLU. For each it stages class p's [2,2,Cin,C2]
// slice of the fused up-conv only (64 KB in float32, 32 KB in bfloat16 at
// Cin 64; all 4*C2 outputs would be 256 KB in float32), computes
// GLU(BN(conv2x2)) for the tile plus a 1-pixel packed halo into a shared
// tile, zero wherever the packed position is outside [0,H) x [0,W) (the
// SAME padding of both convs: GLU(bn_add) is not 0), rounds it to the
// element type as the Pallas kernel does, then stages class p's head slice
// in the space of the up-conv slice and adds class p's share of the head
// into 12 float32 registers per packed pixel. Each conv work item holds 6
// neighbouring GLU positions x 4 GLU channels (value and gate: 48
// accumulators), so one weight read from shared memory feeds 6 FMAs and one
// input read 8. Two threads share a packed pixel in the head (each half of
// the channels, summed by a shuffle); after the 4 classes each writes one
// of the pixel's two output rows straight into [B, 2H, 2W, 3] (the
// depth_to_space happens in the store), with tanh and a*srb in float32.
// Shared memory per block at Cin 64: 77 KB in bfloat16 (two blocks per
// SM), 149 KB in float32 (one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TR = 8, TC = 16;             // packed tile: rows, columns
constexpr int GR = TR + 2, GC = TC + 2;    // GLU tile: the head's 1-pixel halo
constexpr int XR = TR + 4, XC = TC + 4;    // source tile: the 2x2 conv's halo
constexpr int PX = 6;                      // GLU positions of a conv item
constexpr int CG = 4;                      // GLU channels of a conv item
constexpr int THREADS = 2 * TR * TC;       // two per packed pixel in the head
constexpr int MAX_SMEM = 232448;           // bytes a block may use on sm_90
static_assert(GC == 3 * PX, "a GLU tile row is three conv items");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four consecutive elements of shared memory, widened to float32
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  // a bfloat16 is the upper half of the float32 with the same value
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(v.x << 16); o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16); o[3] = __uint_as_float(v.y & 0xffff0000u);
}

struct Geometry {
  int cin_s, c_s;  // padded pixel strides (elements) of the source and GLU tiles
  size_t w_off, g_off, bn_off, bytes;  // byte offsets; the source tile is at 0
};

// n elements of `esize` bytes padded to an odd number of 32-bit words, so
// that neighbouring pixels fall in distinct banks
__host__ __device__ inline int odd_words(int n, int esize) {
  int words = (n * esize + 3) / 4;
  if (words % 2 == 0) words += 1;
  return words * 4 / esize;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

__host__ __device__ inline Geometry geometry(int cin, int c2, int esize) {
  Geometry g;
  const int c = c2 / 2;
  g.cin_s = odd_words(cin, esize);
  g.c_s = odd_words(c, esize);
  const size_t conv_w = (size_t)4 * cin * c2, head_w = (size_t)9 * c * 12;
  g.w_off = align16((size_t)XR * XC * g.cin_s * esize);
  g.g_off = align16(g.w_off + (conv_w > head_w ? conv_w : head_w) * esize);
  g.bn_off = align16(g.g_off + (size_t)GR * GC * g.c_s * esize);
  g.bytes = g.bn_off + 2 * (size_t)c2 * sizeof(float);
  return g;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
up_head_packed_kernel(const T* __restrict__ x,           // [B, H, W, Cin]
                      const T* __restrict__ w_up,        // [2, 2, Cin, 4*C2]
                      const float* __restrict__ bn_mul,  // [C2]
                      const float* __restrict__ bn_add,  // [C2]
                      const T* __restrict__ w_head,      // [3, 3, 4*C, 12]
                      const T* __restrict__ srb,         // [B, 2H, 2W, 3] or null
                      const T* __restrict__ a,           // scalar or null
                      float* __restrict__ out,           // [B, 2H, 2W, 3]
                      int h, int w, int cin, int c2, int use_tanh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry geo = geometry(cin, c2, sizeof(T));
  const int c = c2 / 2, cin_s = geo.cin_s, c_s = geo.c_s;
  T* x_s = reinterpret_cast<T*>(smem);
  T* w_s = reinterpret_cast<T*>(smem + geo.w_off);
  T* g_s = reinterpret_cast<T*>(smem + geo.g_off);
  float* mul_s = reinterpret_cast<float*>(smem + geo.bn_off);
  float* add_s = mul_s + c2;

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TR, j0 = blockIdx.x * TC;  // packed tile origin
  const int tid = threadIdx.x;

  // ---- source tile, rows i0-2 .. i0+TR+1, zero outside the image ----
  const T* xb = x + (size_t)b * h * w * cin;
  for (int i = tid; i < XR * XC * cin; i += THREADS) {
    const int ci = i % cin, pix = i / cin;
    const int r = i0 - 2 + pix / XC, col = j0 - 2 + pix % XC;
    T v = from_f<T>(0.f);
    if (r >= 0 && r < h && col >= 0 && col < w) v = xb[((size_t)r * w + col) * cin + ci];
    x_s[pix * cin_s + ci] = v;
  }
  for (int i = tid; i < c2; i += THREADS) {
    mul_s[i] = bn_mul[i];
    add_s[i] = bn_add[i];
  }

  // head: this thread's packed pixel of the tile and half of the channels
  const int hr = (tid >> 1) / TC, hc = (tid >> 1) % TC, half = tid & 1;
  const int ch = c / 2;
  float y[12];
#pragma unroll
  for (int o = 0; o < 12; ++o) y[o] = 0.f;

  const int ng = c / CG;
  const int n_items = GR * 3 * ng;
  for (int p = 0; p < 4; ++p) {
    const int di = p >> 1, dj = p & 1;
    __syncthreads();  // the source tile is in; class p-1's head is done
    // class p's slice [2][2][Cin][C2] of the fused up-conv
    for (int i = tid; i < 4 * cin * c2; i += THREADS) {
      const int row = i / c2, co = i % c2;
      w_s[i] = w_up[(size_t)row * 4 * c2 + p * c2 + co];
    }
    __syncthreads();

    // ---- GLU(BN(conv2x2)) of class p at the tile and its halo ----
    for (int item = tid; item < n_items; item += THREADS) {
      const int grp = item % ng, rc = item / ng;
      const int gr = rc / 3, gc0 = (rc % 3) * PX;  // GLU tile row, first column
      float av[PX][CG], ag[PX][CG];
#pragma unroll
      for (int k = 0; k < PX; ++k)
#pragma unroll
        for (int j = 0; j < CG; ++j) av[k][j] = ag[k][j] = 0.f;
      // GLU position (gr, gc) is packed pixel (i0-1+gr, j0-1+gc); class p
      // reads source (I + m - 1 + di, J + n - 1 + dj): tile (gr+m+di, gc+n+dj)
      for (int m = 0; m < 2; ++m)
        for (int n = 0; n < 2; ++n) {
          const T* xp = x_s + ((gr + m + di) * XC + gc0 + n + dj) * cin_s;
          const T* wp = w_s + (size_t)(m * 2 + n) * cin * c2 + grp * CG;
          for (int ci = 0; ci < cin; ++ci) {
            float wv[CG], wg[CG];
            load4(wp + ci * c2, wv);
            load4(wp + ci * c2 + c, wg);
#pragma unroll
            for (int k = 0; k < PX; ++k) {
              const float xv = to_f(xp[k * cin_s + ci]);
#pragma unroll
              for (int j = 0; j < CG; ++j) {
                av[k][j] = fmaf(xv, wv[j], av[k][j]);
                ag[k][j] = fmaf(xv, wg[j], ag[k][j]);
              }
            }
          }
        }
      const int gi = i0 - 1 + gr;
      const bool row_in = gi >= 0 && gi < h;
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        const int gj = j0 - 1 + gc0 + k;
        const bool in = row_in && gj >= 0 && gj < w;
        T* gp = g_s + (gr * GC + gc0 + k) * c_s + grp * CG;
#pragma unroll
        for (int j = 0; j < CG; ++j) {
          const int cv = grp * CG + j;
          const float v = fmaf(av[k][j], mul_s[cv], add_s[cv]);
          const float q = fmaf(ag[k][j], mul_s[c + cv], add_s[c + cv]);
          gp[j] = from_f<T>(in ? v / (1.f + expf(-q)) : 0.f);
        }
      }
    }
    __syncthreads();
    // class p's head slice [3][3][C][12]: rows p*C .. p*C+C-1 of each tap
    for (int i = tid; i < 9 * c * 12; i += THREADS) {
      const int tap = i / (c * 12), rest = i % (c * 12);
      w_s[i] = w_head[((size_t)tap * 4 * c + p * c) * 12 + rest];
    }
    __syncthreads();

    // ---- class p's share of the 3x3 packed head ----
    for (int u = 0; u < 3; ++u)
      for (int v = 0; v < 3; ++v) {
        const T* gp = g_s + ((hr + u) * GC + hc + v) * c_s + half * ch;
        const T* wp = w_s + ((size_t)(u * 3 + v) * c + half * ch) * 12;
        for (int ci = 0; ci < ch; ++ci) {
          const float gv = to_f(gp[ci]);
          float wv[12];
          load4(wp + ci * 12, wv);
          load4(wp + ci * 12 + 4, wv + 4);
          load4(wp + ci * 12 + 8, wv + 8);
#pragma unroll
          for (int o = 0; o < 12; ++o) y[o] = fmaf(gv, wv[o], y[o]);
        }
      }
  }

  // ---- the two halves' sums; each writes one output row of the pixel ----
#pragma unroll
  for (int o = 0; o < 12; ++o) y[o] += __shfl_xor_sync(0xffffffffu, y[o], 1);
  const int pi = i0 + hr, pj = j0 + hc;
  if (pi >= h || pj >= w) return;
  const int oh = 2 * h, ow = 2 * w, dy = half;
  const float blend_a = (srb && a) ? to_f(*a) : 0.f;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const size_t o = (((size_t)b * oh + 2 * pi + dy) * ow + 2 * pj + dx) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      // constant indices keep y in registers
      float r = dy ? y[(2 + dx) * 3 + k] : y[dx * 3 + k];
      if (use_tanh) r = tanhf(r);
      if (srb) r = fmaf(blend_a, to_f(srb[o + k]), r);
      out[o + k] = r;
    }
  }
}

long long smem_bytes(int cin, int c2, int esize) {
  if (cin < 1 || c2 < 2 * CG || c2 % (2 * CG)) return 0;
  const Geometry g = geometry(cin, c2, esize);
  return g.bytes <= (size_t)MAX_SMEM ? (long long)g.bytes : 0;
}

template <typename T>
int launch(const void* x, const void* w_up, const float* bn_mul,
           const float* bn_add, const void* w_head, const void* srb,
           const void* a, float* out, int b, int h, int w, int cin, int c2,
           int use_tanh, cudaStream_t stream) {
  const long long smem = smem_bytes(cin, c2, sizeof(T));
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      up_head_packed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + TC - 1) / TC, (h + TR - 1) / TR, b);
  up_head_packed_kernel<T><<<grid, THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_up), bn_mul, bn_add,
      static_cast<const T*>(w_head), static_cast<const T*>(srb),
      static_cast<const T*>(a), out, h, w, cin, c2, use_tanh);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes one block needs (0 = shape not supported);
// dtype 0: float32, 1: bfloat16.
extern "C" long long up_head_packed_smem_bytes(int cin, int c2, int dtype) {
  if (dtype != 0 && dtype != 1) return 0;
  return smem_bytes(cin, c2, dtype == 0 ? 4 : 2);
}

// dtype 0: float32, 1: bfloat16 (x, w_up, w_head, srb and a alike; BN and
// out are float32). Returns the CUDA error code of the launch (0 = success).
// The launch is asynchronous on `stream`; nothing is allocated and nothing
// synchronises.
extern "C" int up_head_packed_launch(const void* x, const void* w_up,
                                     const float* bn_mul, const float* bn_add,
                                     const void* w_head, const void* srb,
                                     const void* a, float* out, int b, int h,
                                     int w, int cin, int c2, int use_tanh,
                                     int dtype, void* stream) {
  if (b < 1 || h < 1 || w < 1 || (srb && !a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, w_up, bn_mul, bn_add, w_head, srb, a, out, b, h, w,
                         cin, c2, use_tanh, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w_up, bn_mul, bn_add, w_head, srb, a, out,
                                 b, h, w, cin, c2, use_tanh, s);
  return (int)cudaErrorInvalidValue;
}

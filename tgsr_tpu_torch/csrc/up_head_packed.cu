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
// (C = C2/2); BN folded to float32 (mul, add). The bfloat16 kernel takes both
// weights in mma fragment order instead (ops/up_head_packed.py
// `pack_upconv_frag`, `pack_head_frag`, made once when the weights are
// packed).
//
// What bounds it on an H100: arithmetic. Per packed pixel the function
// needs 4*Cin*4*C2 multiply-adds for the up-conv and 9*4*C*12 for the packed
// head, against 2*Cin (bfloat16) bytes of input and 48 bytes of output:
// hundreds of flops per byte. In bfloat16 the least time is those flops at
// the bfloat16 tensor-core rate; in float32 at the rate of the CUDA cores.
//
// bfloat16, `up_head_packed_tc_kernel`: both convs are implicit GEMMs on the
// tensor cores (`mma.sync.m16n8k16` bf16, float32 sums, operands from
// shared memory by ldmatrix or by 16-byte loads of fragment-ordered
// weights). A block of 8 warps (4 below C2 64) owns one sample and an 8 x 16
// tile of packed pixels (16 x 32 output pixels). It stages the zero-padded
// source tile (2 pixels of halo; Cin padded with zeros to a multiple of 16)
// and the whole head weight once, then walks over the 4 parity classes p of
// the GLU:
// - Up-conv of class p: [the class's GLU positions of the tile plus a
//   1-pixel packed halo, 10 x 18 = 180 rows in 12 m16 tiles] x [4 taps x
//   Cin] x [C2]. 4 warps share the rows, 3 m16 tiles each; at C2 64 two
//   warps share the columns, each with half of the value channels and the
//   gates of the same half, so a value channel and its gate still meet in
//   one thread. A rows are read by ldmatrix straight from the source tile at
//   each tap's shift. BN and GLU run on the accumulators, GLU rounded to
//   bfloat16 (as the Pallas kernel does) into a shared GLU tile, zero
//   wherever the packed position is outside [0,H) x [0,W) -- the head's
//   SAME padding, since GLU(bn_add) is not 0.
// - Head of class p: [the tile's 128 packed pixels, one packed row an m16
//   tile, one a warp (two below C2 64)] x [9 taps x C] x [12 outputs padded
//   to 16: two n8 tiles]; A by ldmatrix from the GLU tile at each tap's
//   shift. The 4 classes sum in the same float32 registers.
// Splitting the columns halved the accumulators a thread holds (199 -> 124
// registers at C2 64), so two blocks of 8 warps fit an SM, not of 4: the
// kernel waits on latency (chunk loads, barriers, the GLU between the
// products), and twice the warps hide more of it.
// The up-conv weight is streamed in chunks of up to 64 rows of K (one tap at
// Cin 64, two taps of one class at Cin 32: 8 KB of bf16) through a ring of
// three cp.async buffers, two chunks ahead of the tensor cores: the chunks
// come from L2, and one chunk's products at Cin 32 take less time than its
// load. Why streamed and not resident: the whole fused weight is 128 KB at
// Cin 64, and a block holding it could not share its SM with a second block,
// which is what hides each block's serial phases (staging, GLU, head) behind
// another block's products. The head weight (36 KB) stays resident. Shared
// memory per block: 108 KB at Cin 64, 93 KB at Cin 32 (two blocks an SM).
// BN + GLU use `__expf` and `__fdividef`, a few float32 ulps from `expf`
// and a division, far below the bf16 rounding of the GLU that follows.
// Epilogue: the 16 x 32 x 3 image
// tile is staged in shared memory (where the source tile was), then tanh and
// a*srb in float32 and the store, the depth_to_space happening in the store.
// Shared strides are padded by 16 bytes (source pixel Cin + 8, GLU position
// C + 8 bf16), so the 8 rows of every ldmatrix fall in distinct banks.
//
// float32, `up_head_packed_f32_kernel` (the first port, kept: no serving path
// runs it, float32 serving runs `fused_up_head`): the same tiles on the CUDA
// cores in float32. It stages class p's [2,2,Cin,C2] slice of the fused
// up-conv (64 KB at Cin 64), computes GLU(BN(conv2x2)) of the tile and its
// halo into a shared tile (6 GLU positions x 4 channels a work item), then
// class p's share of the head, two threads a packed pixel (each half of the
// channels, summed by a shuffle). 149 KB of shared memory (one block an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr int TR = 8, TC = 16;    // packed tile: rows, columns (both kernels)
constexpr int GR = TR + 2, GC = TC + 2;  // GLU tile: the head's 1-pixel halo
constexpr int XR = TR + 4, XC = TC + 4;  // source tile: the 2x2 conv's halo

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// ============================== float32: CUDA cores ==============================

namespace f32 {

constexpr int PX = 6;                      // GLU positions of a conv item
constexpr int CG = 4;                      // GLU channels of a conv item
constexpr int THREADS = 2 * TR * TC;       // two per packed pixel in the head
static_assert(GC == 3 * PX, "a GLU tile row is three conv items");

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

struct Geometry {
  int cin_s, c_s;  // padded pixel strides (floats) of the source and GLU tiles
  size_t w_off, g_off, bn_off, bytes;  // byte offsets; the source tile is at 0
};

// n floats padded to an odd number, so that neighbouring pixels fall in
// distinct banks
__host__ __device__ inline int odd_words(int n) { return n % 2 ? n : n + 1; }

__host__ __device__ inline Geometry geometry(int cin, int c2) {
  Geometry g;
  const int c = c2 / 2;
  g.cin_s = odd_words(cin);
  g.c_s = odd_words(c);
  const size_t conv_w = (size_t)4 * cin * c2, head_w = (size_t)9 * c * 12;
  g.w_off = align16((size_t)XR * XC * g.cin_s * 4);
  g.g_off = align16(g.w_off + (conv_w > head_w ? conv_w : head_w) * 4);
  g.bn_off = align16(g.g_off + (size_t)GR * GC * g.c_s * 4);
  g.bytes = g.bn_off + 2 * (size_t)c2 * sizeof(float);
  return g;
}

__global__ void __launch_bounds__(THREADS, 2)
up_head_packed_f32_kernel(const float* __restrict__ x,       // [B, H, W, Cin]
                          const float* __restrict__ w_up,    // [2, 2, Cin, 4*C2]
                          const float* __restrict__ bn_mul,  // [C2]
                          const float* __restrict__ bn_add,  // [C2]
                          const float* __restrict__ w_head,  // [3, 3, 4*C, 12]
                          const float* __restrict__ srb,     // [B, 2H, 2W, 3] or null
                          const float* __restrict__ a,       // scalar or null
                          float* __restrict__ out,           // [B, 2H, 2W, 3]
                          int h, int w, int cin, int c2, int use_tanh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry geo = geometry(cin, c2);
  const int c = c2 / 2, cin_s = geo.cin_s, c_s = geo.c_s;
  float* x_s = reinterpret_cast<float*>(smem);
  float* w_s = reinterpret_cast<float*>(smem + geo.w_off);
  float* g_s = reinterpret_cast<float*>(smem + geo.g_off);
  float* mul_s = reinterpret_cast<float*>(smem + geo.bn_off);
  float* add_s = mul_s + c2;

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TR, j0 = blockIdx.x * TC;  // packed tile origin
  const int tid = threadIdx.x;

  // ---- source tile, rows i0-2 .. i0+TR+1, zero outside the image ----
  const float* xb = x + (size_t)b * h * w * cin;
  for (int i = tid; i < XR * XC * cin; i += THREADS) {
    const int ci = i % cin, pix = i / cin;
    const int r = i0 - 2 + pix / XC, col = j0 - 2 + pix % XC;
    float v = 0.f;
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
          const float* xp = x_s + ((gr + m + di) * XC + gc0 + n + dj) * cin_s;
          const float* wp = w_s + (size_t)(m * 2 + n) * cin * c2 + grp * CG;
          for (int ci = 0; ci < cin; ++ci) {
            float wv[CG], wg[CG];
            load4(wp + ci * c2, wv);
            load4(wp + ci * c2 + c, wg);
#pragma unroll
            for (int k = 0; k < PX; ++k) {
              const float xv = xp[k * cin_s + ci];
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
        float* gp = g_s + (gr * GC + gc0 + k) * c_s + grp * CG;
#pragma unroll
        for (int j = 0; j < CG; ++j) {
          const int cv = grp * CG + j;
          const float v = fmaf(av[k][j], mul_s[cv], add_s[cv]);
          const float q = fmaf(ag[k][j], mul_s[c + cv], add_s[c + cv]);
          gp[j] = in ? v / (1.f + expf(-q)) : 0.f;
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
        const float* gp = g_s + ((hr + u) * GC + hc + v) * c_s + half * ch;
        const float* wp = w_s + ((size_t)(u * 3 + v) * c + half * ch) * 12;
        for (int ci = 0; ci < ch; ++ci) {
          const float gv = gp[ci];
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
  const float blend_a = (srb && a) ? *a : 0.f;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const size_t o = (((size_t)b * oh + 2 * pi + dy) * ow + 2 * pj + dx) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      // constant indices keep y in registers
      float r = dy ? y[(2 + dx) * 3 + k] : y[dx * 3 + k];
      if (use_tanh) r = tanhf(r);
      if (srb) r = fmaf(blend_a, srb[o + k], r);
      out[o + k] = r;
    }
  }
}

long long smem_bytes(int cin, int c2) {
  if (cin < 1 || c2 < 2 * CG || c2 % (2 * CG)) return 0;
  const Geometry g = geometry(cin, c2);
  return g.bytes <= (size_t)MAX_SMEM ? (long long)g.bytes : 0;
}

int launch(const float* x, const float* w_up, const float* bn_mul, const float* bn_add,
           const float* w_head, const float* srb, const float* a, float* out, int b, int h,
           int w, int cin, int c2, int use_tanh, cudaStream_t stream) {
  const long long smem = smem_bytes(cin, c2);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      up_head_packed_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + TC - 1) / TC, (h + TR - 1) / TR, b);
  up_head_packed_f32_kernel<<<grid, THREADS, (size_t)smem, stream>>>(
      x, w_up, bn_mul, bn_add, w_head, srb, a, out, h, w, cin, c2, use_tanh);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ========================== bfloat16: tensor cores ==========================

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int M_GLU = GR * GC;           // GLU positions of one class: the up-conv's rows
constexpr int WM = 4;                    // warps along the up-conv's rows
constexpr int MT = 3;                    // up-conv m16 tiles a warp
constexpr int NBUF = 3;                  // up-conv weight chunks in flight: a ring of buffers
static_assert(WM * MT * 16 >= M_GLU && (WM * MT - 1) * 16 < M_GLU,
              "the warps' up-conv m tiles cover the GLU tile, none empty");
// warps along the up-conv's C2 columns: at C2 64 two, each with half of the
// value channels and the matching gates (C2 / 16 pairs of n8 tiles, the
// first half values, the second gates, split evenly)
template <int C2> __host__ __device__ constexpr int warps_n() { return C2 == 64 ? 2 : 1; }
template <int C2> __host__ __device__ constexpr int threads() { return 32 * WM * warps_n<C2>(); }

__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }

struct Geometry {
  int cinp, cp, xs, gs;   // padded K of a tap and GLU channels; pixel strides (bf16)
  int tpc;                // taps a weight chunk: up to 64 rows of K, within one class
  int w_off, h_off, g_off, bn_off, bytes;  // byte offsets; the source tile is at 0
};

__host__ __device__ inline Geometry geometry(int cin, int c2) {
  Geometry g;
  g.cinp = pad16(cin);
  g.cp = pad16(c2 / 2);
  g.xs = g.cinp + 8;  // 16 bytes past a multiple of 32: ldmatrix rows in distinct banks
  g.gs = g.cp + 8;
  g.tpc = g.cinp <= 16 ? 4 : g.cinp <= 32 ? 2 : 1;
  g.w_off = XR * XC * g.xs * 2;
  g.h_off = g.w_off + NBUF * g.tpc * g.cinp * c2 * 2;  // the ring of weight chunks
  g.g_off = g.h_off + 4 * 9 * g.cp * 16 * 2;   // head weight, 4 classes x 9 taps
  g.bn_off = g.g_off + M_GLU * g.gs * 2;
  g.bytes = g.bn_off + 2 * c2 * 4;
  return g;
}
static_assert(XR * XC * 24 * 2 >= 2 * TR * 2 * TC * 3 * 4,
              "the image tile is staged where the source tile was");

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

// not volatile: the compiler may interleave independent products with loads
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// chunk `c` (taps c * tpc .. c * tpc + tpc - 1 of class-major order) of the
// fragment-ordered up-conv weight into w_s
template <int THREADS>
__device__ __forceinline__ void load_chunk(bf16* w_s, const uint4* __restrict__ wf, int c,
                                           int n16) {
  const uint4* src = wf + (size_t)c * n16;
  for (int i = threadIdx.x; i < n16; i += THREADS) cp_async16(w_s + 8 * i, src + i, true);
}

template <int C2>
__global__ void __launch_bounds__(threads<C2>(), 2)
up_head_packed_tc_kernel(const bf16* __restrict__ x,        // [B, H, W, Cin]
                         const uint4* __restrict__ wf_up,   // [4][4][Kp/16][C2/16][32][8] bf16
                         const float* __restrict__ bn_mul,  // [C2]
                         const float* __restrict__ bn_add,  // [C2]
                         const uint4* __restrict__ wf_head, // [4][9][Cp/16][32][8] bf16
                         const bf16* __restrict__ srb,      // [B, 2H, 2W, 3] or null
                         const bf16* __restrict__ a,        // scalar or null
                         float* __restrict__ out,           // [B, 2H, 2W, 3]
                         int h, int w, int cin, int use_tanh) {
  constexpr int C = C2 / 2, NT = C2 / 8, NP = C2 / 16;
  constexpr int CP = (C + 15) & ~15, KSH = CP / 16;
  constexpr int WN = warps_n<C2>(), THREADS = threads<C2>(), WARPS = WM * WN;
  constexpr int NTL = NT / WN, NPL = NP / WN;  // n8 tiles and tile pairs a warp holds
  constexpr int HT = TR / WARPS;               // head m16 tiles a warp, one packed row each
  static_assert(TC == 16 && TR % WARPS == 0, "a head m tile is one packed row");
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry geo = geometry(cin, C2);
  const int cinp = geo.cinp, xs = geo.xs, gs = geo.gs, ks_up = cinp / 16, tpc = geo.tpc;
  const int n_chunks = 16 / tpc, chunk_elems = tpc * cinp * C2;
  bf16* x_s = reinterpret_cast<bf16*>(smem);
  bf16* w_s = reinterpret_cast<bf16*>(smem + geo.w_off);
  const uint4* h_s = reinterpret_cast<const uint4*>(smem + geo.h_off);
  bf16* g_s = reinterpret_cast<bf16*>(smem + geo.g_off);
  float* mul_s = reinterpret_cast<float*>(smem + geo.bn_off);
  float* add_s = mul_s + C2;

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TR, j0 = blockIdx.x * TC;  // packed tile origin
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, t4 = lane & 3;
  const int chunk16 = chunk_elems / 8;  // 16-byte pieces of a weight chunk

  // ---- stage (cp.async): the source tile, rows i0-2 .. i0+TR+1, zero
  // outside the image and in the K padding, and the head weight with chunk
  // 0; then chunks 1 .. NBUF-2, a commit group each ----
  {
    const bf16* xb = x + (size_t)b * h * w * cin;
    const int per_px = cinp / 8;
    for (int i = tid; i < XR * XC * per_px; i += THREADS) {
      const int q = i % per_px, pix = i / per_px;
      const int r = i0 - 2 + pix / XC, col = j0 - 2 + pix % XC;
      const bool ok = r >= 0 && r < h && col >= 0 && col < w && 8 * q < cin;
      cp_async16(x_s + pix * xs + 8 * q, ok ? xb + ((size_t)r * w + col) * cin + 8 * q : x, ok);
    }
    uint4* hd = reinterpret_cast<uint4*>(smem + geo.h_off);
    for (int i = tid; i < 4 * 9 * KSH * 32; i += THREADS) cp_async16(hd + i, wf_head + i, true);
  }
  for (int j = 0; j < NBUF - 1; ++j) {
    if (j < n_chunks) load_chunk<THREADS>(w_s + j * chunk_elems, wf_up, j, chunk16);
    cp_async_commit();
  }
  for (int i = tid; i < C2; i += THREADS) {
    mul_s[i] = bn_mul[i];
    add_s[i] = bn_add[i];
  }
  if (C < CP)  // the GLU tile's channel padding stays zero
    for (int i = tid; i < M_GLU * gs; i += THREADS) g_s[i] = __float2bfloat16_rn(0.f);

  // this lane's ldmatrix row of each up-conv m tile, as a source-tile pixel
  // at class (0, 0) and tap (0, 0): GLU position (gr, gc) reads source
  // pixel (gr + di + m, gc + dj + n) for class (di, dj) and tap (m, n)
  int a_pix[MT];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    int row = (wm + WM * mi) * 16 + (lane & 15);
    if (row >= M_GLU) row = 0;  // padding rows: computed, never stored
    a_pix[mi] = (row / GC) * XC + row % GC;
  }
  const uint32_t x_base = smem_addr(x_s) + (lane >> 4) * 16;  // k columns 8-15: 16 bytes on
  const uint32_t g_base = smem_addr(g_s) + (lane >> 4) * 16;
  // the fragment-ordered pairs of n8 tiles this warp holds: its share of the
  // value pairs, then the matching gate pairs
  int pair[NPL];
#pragma unroll
  for (int lp = 0; lp < NPL; ++lp)
    pair[lp] = lp < NPL / 2 ? wn * (NPL / 2) + lp : NP / 2 + wn * (NPL / 2) + lp - NPL / 2;

  float acc[MT][NTL][4];
  float hacc[HT][2][4];
#pragma unroll
  for (int hi = 0; hi < HT; ++hi)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) hacc[hi][nj][0] = hacc[hi][nj][1] = hacc[hi][nj][2] = hacc[hi][nj][3] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<NBUF - 2>();  // chunk c (at c = 0 also the source tile and head weight)
    __syncthreads();            // ... from every thread; chunk c-1's buffer is free
    if (c + NBUF - 1 < n_chunks)
      load_chunk<THREADS>(w_s + ((c + NBUF - 1) % NBUF) * chunk_elems, wf_up, c + NBUF - 1,
                          chunk16);
    cp_async_commit();  // possibly empty: one group an iteration keeps the count
    const bf16* w_c = w_s + (c % NBUF) * chunk_elems;
    for (int tt = 0; tt < tpc; ++tt) {
      const int p = (c * tpc + tt) >> 2, tap = (c * tpc + tt) & 3;
      if (tap == 0) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int nj = 0; nj < NTL; ++nj) acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;
      }
      // ---- up-conv of class p, tap (m, n) = (tap >> 1, tap & 1) ----
      {
        const int shift = ((p >> 1) + (tap >> 1)) * XC + (p & 1) + (tap & 1);
        uint32_t a_addr[MT];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) a_addr[mi] = x_base + (a_pix[mi] + shift) * xs * 2;
        const uint4* wb = reinterpret_cast<const uint4*>(w_c + tt * cinp * C2) + lane;
#pragma unroll 4
        for (int s = 0; s < ks_up; ++s) {
          uint4 bq[NPL];
#pragma unroll
          for (int lp = 0; lp < NPL; ++lp) bq[lp] = wb[(s * NP + pair[lp]) * 32];
          uint32_t af[MT][4];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) ldsm_x4(af[mi], a_addr[mi] + 32 * s);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int lp = 0; lp < NPL; ++lp) {
              mma_bf16(acc[mi][2 * lp], af[mi], bq[lp].x, bq[lp].y);
              mma_bf16(acc[mi][2 * lp + 1], af[mi], bq[lp].z, bq[lp].w);
            }
        }
      }
      if (tap != 3) continue;

      // ---- BN + GLU on the accumulators into the GLU tile, rounded to bf16;
      // zero outside the image. No warp reads the tile any more: all passed
      // this chunk's barrier after class p-1's head (a chunk holds taps of one
      // class, so tap 3 is its last). ----
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = (wm + WM * mi) * 16 + g + 8 * half;
          if (row >= M_GLU) continue;
          const int gi = i0 - 1 + row / GC, gj = j0 - 1 + row % GC;
          const bool inside = gi >= 0 && gi < h && gj >= 0 && gj < w;
          bf16* gp = g_s + row * gs;
#pragma unroll
          for (int nj = 0; nj < NTL / 2; ++nj) {
            const int n = (wn * (NTL / 2) + nj) * 8 + 2 * t4;
            float r[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = fmaf(acc[mi][nj][2 * half + e], mul_s[n + e], add_s[n + e]);
              const float q = fmaf(acc[mi][nj + NTL / 2][2 * half + e], mul_s[C + n + e], add_s[C + n + e]);
              r[e] = inside ? __fdividef(v, 1.f + __expf(-q)) : 0.f;
            }
            *reinterpret_cast<__nv_bfloat162*>(gp + n) = __floats2bfloat162_rn(r[0], r[1]);
          }
        }
      }
      __syncthreads();  // the GLU tile of class p is complete

      // ---- class p's share of the packed head: A from the GLU tile at each
      // tap's shift, B resident in fragment order ----
      const uint4* hb = h_s + p * 9 * KSH * 32 + lane;
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v)
#pragma unroll
          for (int ks = 0; ks < KSH; ++ks) {
            const uint4 bv = hb[((u * 3 + v) * KSH + ks) * 32];
#pragma unroll
            for (int hi = 0; hi < HT; ++hi) {
              const int pos = (warp + WARPS * hi + u) * GC + (lane & 15) + v;
              uint32_t af[4];
              ldsm_x4(af, g_base + pos * gs * 2 + 32 * ks);
              mma_bf16(hacc[hi][0], af, bv.x, bv.y);
              mma_bf16(hacc[hi][1], af, bv.z, bv.w);
            }
          }
    }
  }
  __syncthreads();  // every warp is past its last read of the source tile

  // ---- the image tile [2TR][2TC][3] in shared memory, depth_to_space on
  // the way: packed output o = (dy * 2 + dx) * 3 + k ----
  float* y_s = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int hi = 0; hi < HT; ++hi) {
    const int hr = warp + WARPS * hi;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int hc = g + 8 * half;
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = nj * 8 + 2 * t4 + e;
          if (o >= 12) continue;
          const int qd = o / 3, k = o % 3;
          y_s[((2 * hr + (qd >> 1)) * (2 * TC) + 2 * hc + (qd & 1)) * 3 + k] = hacc[hi][nj][2 * half + e];
        }
    }
  }
  __syncthreads();

  // ---- tanh, + a * srb, store: consecutive threads on consecutive floats ----
  const int oh = 2 * h, ow = 2 * w, y0 = 2 * i0, x0 = 2 * j0;
  const float blend_a = (srb && a) ? __bfloat162float(*a) : 0.f;
  for (int i = tid; i < 2 * TR * 2 * TC * 3; i += THREADS) {
    const int row = i / (2 * TC * 3), col = i % (2 * TC * 3);
    if (y0 + row >= oh || x0 + col / 3 >= ow) continue;
    const size_t o = (((size_t)b * oh + y0 + row) * ow + x0) * 3 + col;
    float r = y_s[i];
    if (use_tanh) r = tanhf(r);
    if (srb) r = fmaf(blend_a, __bfloat162float(srb[o]), r);
    out[o] = r;
  }
}

long long smem_bytes(int cin, int c2) {
  if (cin < 8 || cin % 8 || (c2 != 16 && c2 != 32 && c2 != 64)) return 0;
  const Geometry g = geometry(cin, c2);
  return g.bytes <= MAX_SMEM ? (long long)g.bytes : 0;
}

int launch(const void* x, const void* wf_up, const float* bn_mul, const float* bn_add,
           const void* wf_head, const void* srb, const void* a, float* out, int b, int h,
           int w, int cin, int c2, int use_tanh, cudaStream_t stream) {
  const long long smem = smem_bytes(cin, c2);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  auto kernel = c2 == 64 ? up_head_packed_tc_kernel<64>
              : c2 == 32 ? up_head_packed_tc_kernel<32> : up_head_packed_tc_kernel<16>;
  const int nthreads = c2 == 64 ? threads<64>() : c2 == 32 ? threads<32>() : threads<16>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + TC - 1) / TC, (h + TR - 1) / TR, b);
  kernel<<<grid, nthreads, (size_t)smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint4*>(wf_up), bn_mul, bn_add,
      static_cast<const uint4*>(wf_head), static_cast<const bf16*>(srb),
      static_cast<const bf16*>(a), out, h, w, cin, use_tanh);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Shared-memory bytes one block needs (0 = shape not supported); dtype 0:
// float32 (C2 % 8), 1: bfloat16 (Cin % 8, C2 16, 32 or 64).
extern "C" long long up_head_packed_smem_bytes(int cin, int c2, int dtype) {
  if (dtype == 0) return f32::smem_bytes(cin, c2);
  if (dtype == 1) return tc::smem_bytes(cin, c2);
  return 0;
}

// dtype 0: float32, x, w_up [2, 2, Cin, 4*C2], w_head [3, 3, 4*C, 12], srb
// and a in float32; 1: bfloat16, x, srb and a in bfloat16, w_up and w_head
// the fragment-ordered weights (16-byte aligned, as x). BN and out are
// float32. Returns the CUDA error code of the launch (0 = success). The
// launch is asynchronous on `stream`; nothing is allocated and nothing
// synchronises.
extern "C" int up_head_packed_launch(const void* x, const void* w_up,
                                     const float* bn_mul, const float* bn_add,
                                     const void* w_head, const void* srb,
                                     const void* a, float* out, int b, int h,
                                     int w, int cin, int c2, int use_tanh,
                                     int dtype, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || w < 1 || (srb && !a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return f32::launch(static_cast<const float*>(x), static_cast<const float*>(w_up), bn_mul,
                       bn_add, static_cast<const float*>(w_head),
                       static_cast<const float*>(srb), static_cast<const float*>(a), out, b,
                       h, w, cin, c2, use_tanh, s);
  if (dtype == 1)
    return tc::launch(x, w_up, bn_mul, bn_add, w_head, srb, a, out, b, h, w, cin, c2,
                      use_tanh, s);
  return (int)cudaErrorInvalidValue;
}

// Fused final-stage tail of the generators, float32:
//   out = head_k(GLU(BN(conv3x3(up2(x))))) [-> tanh] [+ a * srb]
// with SAME zero padding for both convs; only the 3-channel image is written.
//
// Replaces the TPU kernel tgsr_tpu/ops/pallas_up_head.py `fused_up_head`
// (kernel closure and pallas_call there). On the x8 face-SR path it runs at
// two sites, both 128 -> 256 px:
//   h_net3.upsample + img_net3      Cin 64, C2 64, 3x3 head
//   upscale8x + conv_output + a*srb Cin 32, C2 64, 5x5 head, tanh, blend
// The blend weight a is one scalar, or with EVAL.WEIGHTMAP a [2H, 2W] map
// (a3 at x8, a4 at x16) read at each output pixel, broadcast over batch and
// channel.
//
// What bounds it on an H100: arithmetic. After a nearest x2 upsample each
// output parity class (di, dj) sees only 2 x 2 distinct source pixels, so per
// class the up-conv is an implicit GEMM [GLU positions of the class x 4 Cin]
// x [4 Cin x C2] on combined weights (`fuse_upconv_kernel`), against 4 Cin
// bytes of input and 12 bytes of output per output pixel. At float32
// accuracy the least time is that GEMM as three TF32 products at 495 TFLOP/s
// plus the k x k head, BN and GLU at the 67 TFLOP/s of the CUDA cores.
//
// What the design does about it: the up-conv runs on the tensor cores in
// 3xTF32 (`mma.sync.m16n8k8` tf32, float32 sums). Each operand v is split
// into big = rna_tf32(v) and small = rna_tf32(v - big) (the rounding of
// cvt.rna.tf32.f32, done as two integer operations), and small*big,
// big*small and big*big go into the same float32 accumulators, so the sums
// keep float32 accuracy (one TF32 product alone keeps about three digits).
// The activations are split in registers right after each ldmatrix; the
// combined weight is split once, when it is packed (`pack_upconv_weight`),
// not by every warp of every block. A block owns one batch sample and one
// 16 x 32 output tile. It stages the source-resolution input halo tile once
// (zero outside the image: that is the up-conv's SAME padding, since
// nearest-up maps out-of-image rows to out-of-image source rows), the folded
// BN and the head weight, then walks 16 weight chunks (4 classes x 4 taps of
// Cin rows, big and small parts), streamed through two cp.async buffers so
// one chunk loads while the last feeds the tensor cores. The weight comes in
// mma fragment order, so a lane reads its B fragments with 16-byte loads; A
// fragments come from the halo tile by ldmatrix (the b16 form, which loads
// tf32 fragments) at each tap's shift. The halo's pixel stride is Cin + 4
// floats (16 bytes mod 128), so the 8 rows of every ldmatrix fall in
// distinct banks. The class GEMM's rows are the class's positions of the GLU
// tile (16 + 2hh) x (32 + 2hh), hh = k / 2, in m16 tiles dealt round robin
// to the 8 warps; each warp holds all C2 columns, so a value channel and its
// gate sit in one thread and BN + GLU run on the accumulators. The products
// are issued in three rounds over all of a warp's accumulators, so that no
// product waits on the one before it (the mma asm is not volatile, for the
// same reason). The GLU tile stays in shared memory; its positions outside
// the true image are set to zero, because the head conv's SAME padding pads
// the GLU output with zeros and GLU(bn_add) is not zero -- the
// absolute-position mask of the Pallas kernel. The k x k head (3 output
// channels: no tensor-core tile fits it), tanh and the blend then run on the
// CUDA cores, a thread per two output pixels of one column.
//
// Layouts: x [B, H, W, Cin] with Cin % 8 == 0; wf the split combined weight
// in fragment order [4 class][4 tap][Cin / 8][C2 / 16][2 part][32 lane][4];
// BN [C2]; w_head [k, k, C2 / 2, 3]; srb and out [B, 2H, 2W, 3]; a one float
// (a_ld 0) or a [2H, 2W] map of row stride a_ld = 2W.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TOH = 16;           // output tile rows
constexpr int TOW = 32;           // output tile columns
constexpr int THREADS = 256;      // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MT = 2;             // m16 tiles a warp holds at most
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

__host__ __device__ inline int floor2(int v) { return v >> 1; }  // arithmetic shift: floor(v / 2)
__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

struct Geometry {
  int hh, gh, gw, ch, cw, m_cls, n_mt, ir, ic, hs, gs;
  int wb_off, halo_off, glu_off, head_off, bn_off;  // floats
  long long bytes;
};

// halo row (or column) of a class position's tap 0 relative to the tile's
// source origin, for GLU tile row gy of parity class d
__host__ __device__ inline int halo_pos(int gy, int d, int hh) {
  return floor2(gy - hh) + d - floor2(-hh);
}

__host__ __device__ inline Geometry geometry(int cin, int c2, int k) {
  Geometry g;
  g.hh = k / 2;
  g.gh = TOH + 2 * g.hh;  // GLU tile, even sides
  g.gw = TOW + 2 * g.hh;
  g.ch = g.gh / 2;        // one class's positions
  g.cw = g.gw / 2;
  g.m_cls = g.ch * g.cw;
  g.n_mt = (g.m_cls + 15) / 16;
  int ir = 0, ic = 0;
  for (int d = 0; d < 2; ++d) {
    const int e = (d + g.hh) & 1;
    const int r = halo_pos(2 * (g.ch - 1) + e, d, g.hh) + 2;
    const int c = halo_pos(2 * (g.cw - 1) + e, d, g.hh) + 2;
    ir = r > ir ? r : ir;
    ic = c > ic ? c : ic;
  }
  g.ir = ir;
  g.ic = ic;
  g.hs = cin + 4;       // halo pixel stride: 16 bytes mod 128, ldmatrix rows in distinct banks
  g.gs = c2 / 2 + 1;    // GLU position stride, odd: the head's column reads in distinct banks
  g.wb_off = 0;
  g.halo_off = g.wb_off + 4 * cin * c2;  // two chunks of big and small
  g.glu_off = g.halo_off + g.ir * g.ic * g.hs;
  g.head_off = round4(g.glu_off + g.gh * g.gw * g.gs);
  g.bn_off = g.head_off + k * k * (c2 / 2) * 4;
  g.bytes = 4LL * (g.bn_off + 2 * c2);
  return g;
}

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

// float32 bits -> the nearest TF32 value, ties away from zero: the rounding
// of cvt.rna.tf32.f32, as two integer operations on the full-rate ALU
// (half a TF32 ulp added to the magnitude, the 13 low bits cleared)
__device__ __forceinline__ uint32_t rna_tf32(uint32_t v) { return (v + 0x1000u) & 0xFFFFE000u; }

// v -> (big, small), both TF32: big = rna(v), small = rna(v - big)
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& big, uint32_t& small) {
  big = rna_tf32(v);
  small = rna_tf32(__float_as_uint(__fsub_rn(__uint_as_float(v), __uint_as_float(big))));
}

// not volatile: the compiler may interleave independent products with loads
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// chunk c = class * 4 + tap of the fragment-ordered weight into buffer w_s
__device__ __forceinline__ void load_chunk(float* w_s, const float* __restrict__ wf, int c,
                                           int n4) {
  const float* src = wf + (size_t)c * n4 * 4;
  for (int i = threadIdx.x; i < n4; i += THREADS) cp_async16(w_s + 4 * i, src + 4 * i, true);
}

template <int C2>
__global__ void __launch_bounds__(THREADS, 1)
up_head_kernel(const float* __restrict__ x,       // [B, H, W, Cin]
               const float* __restrict__ wf,      // fragment order, see above
               const float* __restrict__ bn_mul,  // [C2]
               const float* __restrict__ bn_add,  // [C2]
               const float* __restrict__ w_head,  // [k, k, C2/2, 3]
               const float* __restrict__ srb,     // [B, 2H, 2W, 3] or null
               const float* __restrict__ a,       // scalar, [2H, 2W] map or null
               float* __restrict__ out,           // [B, 2H, 2W, 3]
               int h, int w, int cin, int k, int use_tanh, int a_ld) {
  constexpr int C = C2 / 2, NT = C2 / 8;
  extern __shared__ __align__(16) float smem[];
  const Geometry geo = geometry(cin, C2, k);
  const int hh = geo.hh, gw = geo.gw, cw = geo.cw, ic = geo.ic, hs = geo.hs, gs = geo.gs;
  float* w_s = smem + geo.wb_off;
  float* halo_s = smem + geo.halo_off;
  float* glu_s = smem + geo.glu_off;
  float* head_s = smem + geo.head_off;
  float* mul_s = smem + geo.bn_off;
  float* add_s = mul_s + C2;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TOH, x0 = blockIdx.x * TOW;  // output tile origin, even
  const int oh = 2 * h, ow = 2 * w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n4 = cin * C2 / 2;  // 16-byte pieces of one weight chunk (big and small)

  // ---- stage the source halo tile and weight chunk 0 (cp.async), BN and head ----
  {
    const int sr0 = y0 / 2 + floor2(-hh) - 1, sc0 = x0 / 2 + floor2(-hh) - 1;
    const float* xb = x + (size_t)b * h * w * cin;
    const int per_px = cin / 4;
    for (int i = tid; i < geo.ir * ic * per_px; i += THREADS) {
      const int q = i % per_px, pix = i / per_px;
      const int r = sr0 + pix / ic, col = sc0 + pix % ic;
      const bool ok = r >= 0 && r < h && col >= 0 && col < w;
      cp_async16(halo_s + pix * hs + 4 * q, ok ? xb + ((size_t)r * w + col) * cin + 4 * q : x, ok);
    }
  }
  load_chunk(w_s, wf, 0, n4);
  cp_async_commit();
  for (int i = tid; i < k * k * C; i += THREADS) {
    head_s[4 * i] = w_head[3 * i];
    head_s[4 * i + 1] = w_head[3 * i + 1];
    head_s[4 * i + 2] = w_head[3 * i + 2];
    head_s[4 * i + 3] = 0.f;
  }
  for (int i = tid; i < C2; i += THREADS) {
    mul_s[i] = bn_mul[i];
    add_s[i] = bn_add[i];
  }

  // ---- up-conv per parity class on the tensor cores, then BN + GLU ----
  const uint32_t halo_base = smem_addr(halo_s);
  float acc[MT][NT][4];
  uint32_t a_base[MT];
  for (int c = 0; c < 16; ++c) {
    const int cls = c >> 2, tap = c & 3, di = cls >> 1, dj = cls & 1;
    if (c + 1 < 16) {
      load_chunk(w_s + ((c + 1) & 1) * 2 * cin * C2, wf, c + 1, n4);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tap == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;
        // this lane's ldmatrix row of m tile warp + 8 mi: a class position
        int row = (warp + WARPS * mi) * 16 + (lane & 15);
        if (row >= geo.m_cls) row = 0;  // padding rows: computed, never stored
        const int p = row / cw, q = row % cw;
        const int hr = halo_pos(2 * p + ((di + hh) & 1), di, hh);
        const int hc = halo_pos(2 * q + ((dj + hh) & 1), dj, hh);
        a_base[mi] = halo_base + 4 * ((hr * ic + hc) * hs + (lane >> 4) * 4);
      }
    }
    const uint32_t shift = 4 * (((tap >> 1) * ic + (tap & 1)) * hs);
    const float4* wb = reinterpret_cast<const float4*>(w_s + (c & 1) * 2 * cin * C2) + lane;
    const bool two = warp + WARPS < geo.n_mt;  // warp-uniform: a second m tile
    for (int s = 0; s < cin / 8; ++s) {
      // B fragments, split when the weight was packed: big, then small
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int qq = 0; qq < NT / 2; ++qq) {
        const float4 v = wb[((s * (NT / 2) + qq) * 2) * 32];
        const float4 u = wb[((s * (NT / 2) + qq) * 2 + 1) * 32];
        bb[2 * qq][0] = __float_as_uint(v.x); bb[2 * qq][1] = __float_as_uint(v.y);
        bb[2 * qq + 1][0] = __float_as_uint(v.z); bb[2 * qq + 1][1] = __float_as_uint(v.w);
        bs[2 * qq][0] = __float_as_uint(u.x); bs[2 * qq][1] = __float_as_uint(u.y);
        bs[2 * qq + 1][0] = __float_as_uint(u.z); bs[2 * qq + 1][1] = __float_as_uint(u.w);
      }
      // A fragments of both m tiles, split in registers right after the load
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (mi > 0 && !two) break;
        uint32_t raw[4];
        ldsm_x4(raw, a_base[mi] + shift + 32 * s);
#pragma unroll
        for (int j = 0; j < 4; ++j) split_tf32(raw[j], ab[mi][j], as[mi][j]);
      }
      // small*big, big*small, big*big: each round over every accumulator, so
      // that back-to-back products never wait on each other
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (mi > 0 && !two) break;
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) mma_tf32(acc[mi][nj], as[mi], bb[nj][0], bb[nj][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (mi > 0 && !two) break;
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) mma_tf32(acc[mi][nj], ab[mi], bs[nj][0], bs[nj][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (mi > 0 && !two) break;
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) mma_tf32(acc[mi][nj], ab[mi], bb[nj][0], bb[nj][1]);
      }
    }
    __syncthreads();  // buffer c & 1 is refilled next iteration
    if (tap != 3) continue;
    // BN + GLU on the accumulators into the GLU tile; zero outside the image
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (warp + WARPS * mi >= geo.n_mt) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = (warp + WARPS * mi) * 16 + g + 8 * half;
        if (row >= geo.m_cls) continue;
        const int gy = 2 * (row / cw) + ((di + hh) & 1), gx = 2 * (row % cw) + ((dj + hh) & 1);
        const int yabs = y0 - hh + gy, xabs = x0 - hh + gx;
        const bool inside = yabs >= 0 && yabs < oh && xabs >= 0 && xabs < ow;
        float* gp = glu_s + (gy * gw + gx) * gs;
#pragma unroll
        for (int nj = 0; nj < NT / 2; ++nj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = nj * 8 + 2 * t + e;
            const float v = fmaf(acc[mi][nj][2 * half + e], mul_s[n], add_s[n]);
            const float q = fmaf(acc[mi][nj + NT / 2][2 * half + e], mul_s[C + n], add_s[C + n]);
            gp[n] = inside ? v / (1.f + expf(-q)) : 0.f;
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- k x k head -> [tanh] -> [+ a * srb], P output pixels of one column a thread;
  // a_ld 0: one scalar a, else a is a [2H, 2W] map of row stride a_ld, read at
  // the output pixel ----
  constexpr int P = TOH * TOW / THREADS;
  const int ox = tid % TOW, oy = (tid / TOW) * P;
  float y[P][3] = {};
  const float4* hw4 = reinterpret_cast<const float4*>(head_s);
  for (int u = 0; u < k; ++u)
    for (int v = 0; v < k; ++v) {
      const float* gp = glu_s + ((oy + u) * gw + (ox + v)) * gs;
      const float4* wp = hw4 + (u * k + v) * C;
      for (int ci = 0; ci < C; ++ci) {
        const float4 wv = wp[ci];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float gv = gp[p * gw * gs + ci];
          y[p][0] = fmaf(gv, wv.x, y[p][0]);
          y[p][1] = fmaf(gv, wv.y, y[p][1]);
          y[p][2] = fmaf(gv, wv.z, y[p][2]);
        }
      }
    }
  const float av = (srb && a && !a_ld) ? *a : 0.f;
  const int xo = x0 + ox;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int yo = y0 + oy + p;
    if (yo >= oh || xo >= ow) continue;
    const size_t o = (((size_t)b * oh + yo) * ow + xo) * 3;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float r = use_tanh ? tanhf(y[p][j]) : y[p][j];
      if (srb) r = fmaf(a_ld ? a[(size_t)yo * a_ld + xo] : av, srb[o + j], r);
      out[o + j] = r;
    }
  }
}

}  // namespace

// Shared-memory bytes one block needs (0 = shape not supported: Cin % 8,
// C2 16, 32 or 64, odd k whose GLU tile the 8 warps' m tiles cover).
extern "C" long long up_head_smem_bytes(int cin, int c2, int k) {
  if (cin < 8 || cin % 8 || (c2 != 16 && c2 != 32 && c2 != 64) || k < 1 || k % 2 == 0) return 0;
  const Geometry g = geometry(cin, c2, k);
  if (g.n_mt > WARPS * MT) return 0;
  return g.bytes <= (long long)MAX_SMEM ? g.bytes : 0;
}

// Returns the CUDA error code of the launch (0 = success). The launch is
// asynchronous on `stream`; nothing is allocated and nothing synchronises.
extern "C" int up_head_launch(const float* x, const float* wf, const float* bn_mul,
                              const float* bn_add, const float* w_head, const float* srb,
                              const float* a, float* out, int b, int h, int w, int cin, int c2,
                              int k, int use_tanh, int a_ld, void* stream) {
  const long long smem = up_head_smem_bytes(cin, c2, k);
  if (smem == 0 || b < 1 || b > 65535 || h < 1 || w < 1 || (srb && !a)
      || (a_ld != 0 && a_ld != 2 * w))
    return (int)cudaErrorInvalidValue;
  auto kernel = c2 == 64 ? up_head_kernel<64> : c2 == 32 ? up_head_kernel<32> : up_head_kernel<16>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((2 * w + TOW - 1) / TOW, (2 * h + TOH - 1) / TOH, b);
  kernel<<<grid, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      x, wf, bn_mul, bn_add, w_head, srb, a, out, h, w, cin, k, use_tanh, a_ld);
  return (int)cudaGetLastError();
}

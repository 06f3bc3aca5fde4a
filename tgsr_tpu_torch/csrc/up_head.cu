// Fused final-stage tail of the generators, float32:
//   out = head_k(GLU(BN(conv3x3(up2(x))))) [-> tanh] [+ a * srb]
// with SAME zero padding for both convs; only the 3-channel image is written.
//
// Replaces the TPU kernel tgsr_tpu/ops/pallas_up_head.py `fused_up_head`
// (kernel closure and pallas_call there). On the x8 face-SR path it runs at
// two sites, both 128 -> 256 px:
//   h_net3.upsample + img_net3      Cin 64, C2 64, 3x3 head
//   upscale8x + conv_output + a*srb Cin 32, C2 64, 5x5 head, tanh, blend
//
// What bounds it on an H100: arithmetic. After a nearest x2 upsample each
// output parity class sees only 2 x 2 distinct source pixels, so the
// function needs 4*Cin*C2 multiply-adds of combined weights per output
// pixel for the up-conv (1.1 GFLOP per 256 px image at Cin 32, 2.1 at
// Cin 64) and k*k*C2/2*3 for the head, against 4*Cin bytes of input
// and 12 bytes of output per output pixel -- hundreds of flops per byte,
// far above the f32 ridge. The least time is those flops at the card's f32
// (non-tensor-core) peak. This kernel is the simple form: it runs all 9
// taps (2.25x the up-conv work the function needs) and keeps float32
// throughout; the 2 x 2 parity-collapsed form is the next step.
//
// What the design does about it: a block owns one batch sample and one
// TO x TO output tile (TO = 16). It stages in shared memory the whole
// up-conv weight (HWIO = [tap][ci][co], the layout of the inner loop), the
// source-resolution input halo tile (zero outside the image: that is the
// up-conv's SAME padding, since nearest-up maps out-of-image rows to
// out-of-image source rows), the folded BN and the head weight. The up-conv
// never materialises the upsampled input: each GLU position reads the
// source pixel its tap lands on. Each thread computes two neighbouring GLU
// positions x 8 GLU channels (8 value + 8 gate conv outputs each, 32
// register accumulators), so every weight read from shared memory feeds two
// FMAs and every input read feeds sixteen. The GLU tile of (TO + 2*hh)^2 x
// C2/2 floats (hh = k/2) stays in shared memory; its positions outside the
// true image are set to zero, because the head conv's SAME padding pads the
// GLU output with zeros and GLU(bn_add) is not zero -- the absolute-position
// mask of the Pallas kernel. Then one thread per output pixel applies the
// k x k head, tanh and the blend and writes 3 floats. A 256-px-wide row
// tile, as the Pallas kernel uses, would not fit in 227 KB of shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TO = 16;            // output tile side
constexpr int THREADS = TO * TO;  // one thread per output pixel in the head
constexpr int CG = 8;             // GLU channels per conv work item
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

struct Geometry {
  int hh, gr, ir, par, cin_s, c_s;
  size_t w_off, in_off, g_off, wh_off, bn_off, bytes;
};

__host__ __device__ inline Geometry geometry(int cin, int c2, int k) {
  Geometry g;
  g.hh = k / 2;
  g.gr = TO + 2 * g.hh;                 // GLU tile side
  g.par = (g.hh + 1) & 1;
  g.ir = ((TO + 2 * g.hh + 1 + g.par) >> 1) + 1;  // input tile side
  g.cin_s = cin + 1;                    // padded pixel strides: distinct banks
  g.c_s = c2 / 2 + 1;
  g.w_off = 0;
  g.in_off = g.w_off + (size_t)9 * cin * c2;
  g.g_off = g.in_off + (size_t)g.ir * g.ir * g.cin_s;
  g.wh_off = g.g_off + (size_t)g.gr * g.gr * g.c_s;
  g.bn_off = g.wh_off + (size_t)k * k * (c2 / 2) * 3;
  g.bytes = sizeof(float) * (g.bn_off + 2 * (size_t)c2);
  return g;
}

__global__ void __launch_bounds__(THREADS)
up_head_kernel(const float* __restrict__ x,       // [B, H, W, Cin]
               const float* __restrict__ w_up,    // [3, 3, Cin, C2]
               const float* __restrict__ bn_mul,  // [C2]
               const float* __restrict__ bn_add,  // [C2]
               const float* __restrict__ w_head,  // [k, k, C2/2, 3]
               const float* __restrict__ srb,     // [B, 2H, 2W, 3] or null
               const float* __restrict__ a,       // scalar or null
               float* __restrict__ out,           // [B, 2H, 2W, 3]
               int h, int w, int cin, int c2, int k, int use_tanh) {
  extern __shared__ __align__(16) float smem[];
  const Geometry geo = geometry(cin, c2, k);
  const int c = c2 / 2;
  const int hh = geo.hh, gr = geo.gr, ir = geo.ir, par = geo.par;
  const int cin_s = geo.cin_s, c_s = geo.c_s;
  float* w_s = smem + geo.w_off;
  float* in_s = smem + geo.in_off;
  float* g_s = smem + geo.g_off;
  float* wh_s = smem + geo.wh_off;
  float* mul_s = smem + geo.bn_off;
  float* add_s = mul_s + c2;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TO, x0 = blockIdx.x * TO;  // output tile origin
  const int oh = 2 * h, ow = 2 * w;
  const int tid = threadIdx.x;

  // ---- stage weights, BN and the zero-padded source halo tile ----
  {
    const float4* src = reinterpret_cast<const float4*>(w_up);
    float4* dst = reinterpret_cast<float4*>(w_s);
    const int n4 = 9 * cin * c2 / 4;
    for (int i = tid; i < n4; i += THREADS) dst[i] = src[i];
  }
  for (int i = tid; i < k * k * c * 3; i += THREADS) wh_s[i] = w_head[i];
  for (int i = tid; i < c2; i += THREADS) {
    mul_s[i] = bn_mul[i];
    add_s[i] = bn_add[i];
  }
  const int sr0 = y0 / 2 - ((hh + 2) >> 1);
  const int sc0 = x0 / 2 - ((hh + 2) >> 1);
  const float* xb = x + (size_t)b * h * w * cin;
  for (int i = tid; i < ir * ir * cin; i += THREADS) {
    const int ci = i % cin, pix = i / cin;
    const int r = sr0 + pix / ir, col = sc0 + pix % ir;
    float v = 0.f;
    if (r >= 0 && r < h && col >= 0 && col < w)
      v = xb[((size_t)r * w + col) * cin + ci];
    in_s[pix * cin_s + ci] = v;
  }
  __syncthreads();

  // ---- up-conv + folded BN + GLU into the GLU tile ----
  const int pairs = gr * gr / 2;  // gr is even
  const int n_items = pairs * (c / CG);
  for (int item = tid; item < n_items; item += THREADS) {
    const int grp = item / pairs;
    const int p = 2 * (item % pairs);
    const int gy = p / gr, gx = p % gr;  // gx and gx + 1 share the row
    float av0[CG], ag0[CG], av1[CG], ag1[CG];
#pragma unroll
    for (int j = 0; j < CG; ++j) av0[j] = ag0[j] = av1[j] = ag1[j] = 0.f;
    for (int dy = 0; dy < 3; ++dy) {
      const int r = (gy + dy + par) >> 1;
      for (int dx = 0; dx < 3; ++dx) {
        const float* x0p = in_s + (r * ir + ((gx + dx + par) >> 1)) * cin_s;
        const float* x1p = in_s + (r * ir + ((gx + 1 + dx + par) >> 1)) * cin_s;
        const float* wt = w_s + (size_t)(dy * 3 + dx) * cin * c2 + grp * CG;
        for (int ci = 0; ci < cin; ++ci) {
          const float xa = x0p[ci], xb1 = x1p[ci];
          const float4* wv = reinterpret_cast<const float4*>(wt + ci * c2);
          const float4* wg = reinterpret_cast<const float4*>(wt + ci * c2 + c);
          const float4 v0 = wv[0], v1 = wv[1], q0 = wg[0], q1 = wg[1];
          const float vv[CG] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
          const float qq[CG] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
          for (int j = 0; j < CG; ++j) {
            av0[j] = fmaf(xa, vv[j], av0[j]);
            ag0[j] = fmaf(xa, qq[j], ag0[j]);
            av1[j] = fmaf(xb1, vv[j], av1[j]);
            ag1[j] = fmaf(xb1, qq[j], ag1[j]);
          }
        }
      }
    }
    const int yabs = y0 - hh + gy, xabs = x0 - hh + gx;
    const bool row_in = yabs >= 0 && yabs < oh;
    const bool in0 = row_in && xabs >= 0 && xabs < ow;
    const bool in1 = row_in && xabs + 1 >= 0 && xabs + 1 < ow;
    float* g0 = g_s + (gy * gr + gx) * c_s + grp * CG;
    float* g1 = g0 + c_s;
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int cv = grp * CG + j;
      const float m = mul_s[cv], ad = add_s[cv];
      const float mg = mul_s[c + cv], adg = add_s[c + cv];
      const float v0 = fmaf(av0[j], m, ad), q0 = fmaf(ag0[j], mg, adg);
      const float v1 = fmaf(av1[j], m, ad), q1 = fmaf(ag1[j], mg, adg);
      g0[j] = in0 ? v0 / (1.f + expf(-q0)) : 0.f;
      g1[j] = in1 ? v1 / (1.f + expf(-q1)) : 0.f;
    }
  }
  __syncthreads();

  // ---- k x k head -> [tanh] -> [+ a * srb], one output pixel per thread ----
  const int oy = tid / TO, ox = tid % TO;
  const int yo = y0 + oy, xo = x0 + ox;
  if (yo >= oh || xo >= ow) return;
  float y[3] = {0.f, 0.f, 0.f};
  for (int u = 0; u < k; ++u)
    for (int v = 0; v < k; ++v) {
      const float* gp = g_s + ((oy + u) * gr + (ox + v)) * c_s;
      const float* wp = wh_s + (u * k + v) * c * 3;
      for (int ci = 0; ci < c; ++ci) {
        const float gv = gp[ci];
        y[0] = fmaf(gv, wp[ci * 3 + 0], y[0]);
        y[1] = fmaf(gv, wp[ci * 3 + 1], y[1]);
        y[2] = fmaf(gv, wp[ci * 3 + 2], y[2]);
      }
    }
  const size_t o = (((size_t)b * oh + yo) * ow + xo) * 3;
  const float av = (srb && a) ? *a : 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float r = use_tanh ? tanhf(y[j]) : y[j];
    if (srb) r = fmaf(av, srb[o + j], r);
    out[o + j] = r;
  }
}

}  // namespace

// Shared-memory bytes one block needs (0 = shape not supported).
extern "C" long long up_head_smem_bytes(int cin, int c2, int k) {
  if (cin < 1 || c2 < 2 * CG || c2 % (2 * CG) || k < 1 || k % 2 == 0) return 0;
  const Geometry g = geometry(cin, c2, k);
  return g.bytes <= (size_t)MAX_SMEM ? (long long)g.bytes : 0;
}

// Returns the CUDA error code of the launch (0 = success). The launch is
// asynchronous on `stream`; nothing is allocated and nothing synchronises.
extern "C" int up_head_launch(const float* x, const float* w_up,
                              const float* bn_mul, const float* bn_add,
                              const float* w_head, const float* srb,
                              const float* a, float* out, int b, int h, int w,
                              int cin, int c2, int k, int use_tanh,
                              void* stream) {
  const long long smem = up_head_smem_bytes(cin, c2, k);
  if (smem == 0 || b < 1 || h < 1 || w < 1 || (srb && !a))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      up_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((2 * w + TO - 1) / TO, (2 * h + TO - 1) / TO, b);
  up_head_kernel<<<grid, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      x, w_up, bn_mul, bn_add, w_head, srb, a, out, h, w, cin, c2, k, use_tanh);
  return (int)cudaGetLastError();
}

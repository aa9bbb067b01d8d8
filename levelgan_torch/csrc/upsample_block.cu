// K1: fused ConvTranspose(4x4, s2, SAME) + GroupNorm + LeakyReLU, forward
// and backward.
//
// The forward replaces levelgan/kernels/upsample_block.py:_forward (the
// Pallas call at :304), the monolithic-spatial stage kernel of the JAX
// package; the backward replaces _backward (the Pallas call at :462).
//
// One block owns one (sample, GroupNorm group): every output position of
// the sample for the group's channels.  The whole (2H x 2W x gs) f32 tile
// lives in the block's registers as mma accumulators, so the GroupNorm
// statistics are a block reduction and the normalise + affine + LeakyReLU
// epilogue runs before the single bf16 store: the pre-norm tile never
// touches device memory.  The input sample and the group's 16 taps stream
// through shared memory in chunks of KC input channels.
//
// What bounds it on an H100: at the gumbel_64 stages it serves (B = 1024)
// the conv is 68.7 GFLOP per stage against 50-200 MB of traffic, i.e. the
// tensor cores (989 TF/s bf16) bound it, not memory.  This first version
// uses mma.sync with single-buffered staging (no TMA, no wgmma); each
// group's block re-reads the sample's input, which L2 serves.
//
// Fits when 4 * H * W / 16 (parity, M-tile) tasks fit 8 warps x 8 tasks,
// i.e. the f32 tile 4HW x gs is at most 64 KB for gs = 16 (H * W <= 256).

#include "stage_common.cuh"

namespace {

constexpr int MAXT = 8;     // (parity, M tile) tasks per warp
constexpr int MAXW = 8;     // warps per block

__global__ void __launch_bounds__(MAXW * 32)
upsample_block_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ wt,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          __nv_bfloat16* __restrict__ y,
                          __nv_bfloat16* __restrict__ ypre,
                          float* __restrict__ mu_out,
                          float* __restrict__ rstd_out, int H, int W, int Ci,
                          int Co, int gs, float slope, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + (H + 2) * (W + 2) * lgt::LDK;
  float* red = reinterpret_cast<float*>(ws + 16 * gs * lgt::LDK);

  const int grp = blockIdx.x, b = blockIdx.y, n0 = grp * gs, nq = gs / 8;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mtiles = H * W / 16, ntask = 4 * mtiles;

  float acc[MAXT][2][4];
#pragma unroll
  for (int i = 0; i < MAXT; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;

  for (int k0 = 0; k0 < Ci; k0 += lgt::KC) {
    __syncthreads();
    lgt::stage_input(xs, x, b, 0, H, H, W, Ci, k0);
    lgt::stage_taps(ws, wt, n0, gs, Co, Ci, k0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAXT; ++i) {
      const int task = warp + i * nw;
      if (task < ntask)
        lgt::parity_tile_chunk<2>(acc[i], xs, ws, task / mtiles,
                                  (task % mtiles) * 16, W, gs, nq);
    }
  }

  // ---- GroupNorm statistics of the (sample, group) tile, in f32 ----------
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < MAXT; ++i) {
    if (warp + i * nw < ntask) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q < nq) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s1 += acc[i][q][e];
            s2 += acc[i][q][e] * acc[i][q][e];
          }
        }
      }
    }
  }
  s1 = lgt::warp_sum(s1);
  s2 = lgt::warp_sum(s2);
  if (lane == 0) {
    red[warp] = s1;
    red[MAXW + warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a1 = 0.f, a2 = 0.f;
    for (int i = 0; i < nw; ++i) {
      a1 += red[i];
      a2 += red[MAXW + i];
    }
    const float cnt = 4.f * H * W * gs;
    const float mean = a1 / cnt;
    const float var = fmaxf(a2 / cnt - mean * mean, 0.f);
    red[2 * MAXW] = mean;
    red[2 * MAXW + 1] = rsqrtf(var + eps);
  }
  __syncthreads();
  const float mean = red[2 * MAXW], rstd = red[2 * MAXW + 1];
  if (mu_out != nullptr && threadIdx.x < gs) {
    mu_out[static_cast<size_t>(b) * Co + n0 + threadIdx.x] = mean;
    rstd_out[static_cast<size_t>(b) * Co + n0 + threadIdx.x] = rstd;
  }

  // ---- normalise + affine + LeakyReLU, interleave parities, store bf16 ----
  const int H2 = 2 * H, W2 = 2 * W;
#pragma unroll
  for (int i = 0; i < MAXT; ++i) {
    const int task = warp + i * nw;
    if (task < ntask) {
      const int par = task / mtiles, m0 = (task % mtiles) * 16;
      const int pa = par >> 1, pb = par & 1;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q < nq) {
          const int c = n0 + q * 8 + 2 * t;
          const float ga = gamma[c] * rstd, gb = gamma[c + 1] * rstd;
          const float ba = beta[c] - mean * ga, bb = beta[c + 1] - mean * gb;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + g + 8 * h;
            const int oy = 2 * (m / W) + pa, ox = 2 * (m % W) + pb;
            const size_t o = ((static_cast<size_t>(b) * H2 + oy) * W2 + ox) *
                                 Co + c;
            float v0 = acc[i][q][2 * h] * ga + ba;
            float v1 = acc[i][q][2 * h + 1] * gb + bb;
            v0 = v0 >= 0.f ? v0 : slope * v0;
            v1 = v1 >= 0.f ? v1 : slope * v1;
            *reinterpret_cast<__nv_bfloat162*>(y + o) =
                __floats2bfloat162_rn(v0, v1);
            if (ypre != nullptr)
              *reinterpret_cast<__nv_bfloat162*>(ypre + o) =
                  __floats2bfloat162_rn(acc[i][q][2 * h],
                                        acc[i][q][2 * h + 1]);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" size_t upsample_block_fwd_smem(int H, int W, int gs) {
  return (static_cast<size_t>(H + 2) * (W + 2) + 16 * gs) * lgt::LDK *
             sizeof(__nv_bfloat16) +
         (2 * MAXW + 2) * sizeof(float);
}

// x [B,H,W,Ci] bf16, wt [16,Co,Ci] bf16 (tap = kh*4 + kw of the HWIO
// weight), gamma/beta [Co] f32 -> y [B,2H,2W,Co] bf16.  With residuals
// (ypre non-null) also the pre-norm conv output ypre [B,2H,2W,Co] bf16 and
// the per-(sample, channel) GroupNorm mean / rstd mu, rstd [B,Co] f32, as
// _forward(..., residuals=True) emits them.  The caller checks the shape
// rules: Ci % 64 == 0, gs in {8, 16}, Co % gs == 0, H * W % 16 == 0 and
// H * W <= 256.  Returns cudaGetLastError().
extern "C" int upsample_block_fwd(const void* x, const void* wt,
                                  const void* gamma, const void* beta, void* y,
                                  void* ypre, void* mu, void* rstd, int B,
                                  int H, int W, int Ci, int Co, int gs,
                                  float slope, float eps, void* stream) {
  const size_t smem = upsample_block_fwd_smem(H, W, gs);
  cudaError_t err = cudaFuncSetAttribute(
      upsample_block_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntask = 4 * (H * W / 16);
  const int nw = ntask < MAXW ? ntask : MAXW;
  dim3 grid(Co / gs, B);
  upsample_block_fwd_kernel<<<grid, nw * 32, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wt), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(y),
      static_cast<__nv_bfloat16*>(ypre), static_cast<float*>(mu),
      static_cast<float*>(rstd), H, W, Ci, Co, gs, slope, eps);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K1 backward: LeakyReLU bwd -> GroupNorm bwd -> dx, plus dgamma / dbeta and
// the pre-norm cotangent dy (from which the caller forms dw).
//
// The dx contraction runs over all Co, across GroupNorm groups, so K1 fwd's
// (sample, group) ownership cannot carry the whole op.  Three launches on
// one stream, counted as one call:
//   (a) one block per (sample, group): recompute xn, the affine output and
//       the LeakyReLU mask from ypre / mu / rstd; reduce per channel
//       s1 = sum dout and s2 = sum dout * xn (fixed order, no atomics);
//       then dy = rstd * (dout * gamma - mean_g(dout * gamma)
//       - xn * mean_g(dout * gamma * xn)) stored bf16, s1 / s2 [B, Co];
//   (a') dgamma = sum_b s2, dbeta = sum_b s1, one thread per channel;
//   (b) dx as the gather GEMM of stage_common.cuh over the merged dy.
// All sums are deterministic.  What bounds it on an H100 at gumbel_64
// training (B = 64): 32*B*H*W*Ci*Co = 4.29 GFLOP per stage for dx, so the
// tensor cores at up0, and the g, ypre, dy and dx traffic at up1 (~16 MB)
// and up2 (~29 MB).
// ---------------------------------------------------------------------------

namespace {

constexpr int BWD_THREADS = 256;

__global__ void __launch_bounds__(BWD_THREADS)
k1_bwd_gn_kernel(const __nv_bfloat16* __restrict__ g,
                 const __nv_bfloat16* __restrict__ ypre,
                 const float* __restrict__ mu, const float* __restrict__ rstd,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta,
                 __nv_bfloat16* __restrict__ dy, float* __restrict__ s1o,
                 float* __restrict__ s2o, int P, int Co, int gs,
                 float slope) {
  __shared__ float r1[BWD_THREADS], r2[BWD_THREADS];
  __shared__ float gm[2];
  const int n0 = blockIdx.x * gs, b = blockIdx.y;
  const int lc = threadIdx.x % gs, lp = threadIdx.x / gs;
  const int np = blockDim.x / gs, c = n0 + lc;
  const size_t bc = static_cast<size_t>(b) * Co + c;
  const float m = mu[bc], rs = rstd[bc], ga = gamma[c], be = beta[c];
  const size_t base = static_cast<size_t>(b) * P * Co + c;

  float s1 = 0.f, s2 = 0.f;
  for (int p = lp; p < P; p += np) {
    const size_t i = base + static_cast<size_t>(p) * Co;
    const float xn = (__bfloat162float(ypre[i]) - m) * rs;
    const float gg = __bfloat162float(g[i]);
    const float dout = xn * ga + be >= 0.f ? gg : slope * gg;
    s1 += dout;
    s2 += dout * xn;
  }
  r1[threadIdx.x] = s1;
  r2[threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.x < gs) {
    float a1 = 0.f, a2 = 0.f;
    for (int k = 0; k < np; ++k) {
      a1 += r1[k * gs + threadIdx.x];
      a2 += r2[k * gs + threadIdx.x];
    }
    s1o[bc] = a1;
    s2o[bc] = a2;
    r1[threadIdx.x] = a1 * ga;   // lanes < gs own channel lc == threadIdx.x
    r2[threadIdx.x] = a2 * ga;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a1 = 0.f, a2 = 0.f;
    for (int k = 0; k < gs; ++k) {
      a1 += r1[k];
      a2 += r2[k];
    }
    const float cnt = static_cast<float>(P) * gs;
    gm[0] = a1 / cnt;
    gm[1] = a2 / cnt;
  }
  __syncthreads();
  const float m1 = gm[0], m2 = gm[1];
  for (int p = lp; p < P; p += np) {
    const size_t i = base + static_cast<size_t>(p) * Co;
    const float xn = (__bfloat162float(ypre[i]) - m) * rs;
    const float gg = __bfloat162float(g[i]);
    const float dout = xn * ga + be >= 0.f ? gg : slope * gg;
    dy[i] = __float2bfloat16_rn(rs * (dout * ga - m1 - xn * m2));
  }
}

__global__ void k1_bwd_affine_kernel(const float* __restrict__ s1,
                                     const float* __restrict__ s2,
                                     float* __restrict__ dgamma,
                                     float* __restrict__ dbeta, int B,
                                     int Co) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Co) return;
  float a1 = 0.f, a2 = 0.f;
  for (int b = 0; b < B; ++b) {
    a1 += s1[static_cast<size_t>(b) * Co + c];
    a2 += s2[static_cast<size_t>(b) * Co + c];
  }
  dbeta[c] = a1;
  dgamma[c] = a2;
}

}  // namespace

// g, ypre [B,2H,2W,Co] bf16, mu / rstd [B,Co] f32, gamma / beta [Co] f32,
// wb [16,Ci,Co] bf16 (the HWIO weight flattened) -> dy [B,2H,2W,Co] bf16,
// dx [B,H,W,Ci] bf16, dgamma / dbeta [Co] f32; s1 / s2 [B,Co] f32 scratch.
// The caller checks the shape rules: gs in {8, 16}, Co % gs == 0,
// Co % 32 == 0, Ci % 32 == 0 and the dx tiling rule of stage_common.cuh.
// Returns the first launch error.
extern "C" int upsample_block_bwd(const void* g, const void* ypre,
                                  const void* mu, const void* rstd,
                                  const void* gamma, const void* beta,
                                  const void* wb, void* dy, void* s1,
                                  void* s2, void* dgamma, void* dbeta,
                                  void* dx, int B, int H, int W, int Ci,
                                  int Co, int gs, float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k1_bwd_gn_kernel<<<dim3(Co / gs, B), BWD_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(ypre), static_cast<const float*>(mu),
      static_cast<const float*>(rstd), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(dy),
      static_cast<float*>(s1), static_cast<float*>(s2), 4 * H * W, Co, gs,
      slope);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_bwd_affine_kernel<<<(Co + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(s1), static_cast<const float*>(s2),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), B, Co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      lgt::launch_dx_gather<false>(dy, wb, dx, B, H, W, Ci, Co, st));
}

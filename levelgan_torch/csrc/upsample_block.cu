// K1 forward: fused ConvTranspose(4x4, s2, SAME) + GroupNorm + LeakyReLU.
//
// Replaces levelgan/kernels/upsample_block.py:_forward (the Pallas call at
// :304), the monolithic-spatial stage kernel of the JAX package.
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
                          __nv_bfloat16* __restrict__ y, int H, int W, int Ci,
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
            float v0 = acc[i][q][2 * h] * ga + ba;
            float v1 = acc[i][q][2 * h + 1] * gb + bb;
            v0 = v0 >= 0.f ? v0 : slope * v0;
            v1 = v1 >= 0.f ? v1 : slope * v1;
            *reinterpret_cast<__nv_bfloat162*>(
                y + ((static_cast<size_t>(b) * H2 + oy) * W2 + ox) * Co + c) =
                __floats2bfloat162_rn(v0, v1);
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
// weight), gamma/beta [Co] f32 -> y [B,2H,2W,Co] bf16.  The caller checks
// the shape rules: Ci % 64 == 0, gs in {8, 16}, Co % gs == 0,
// H * W % 16 == 0 and H * W <= 256.  Returns cudaGetLastError().
extern "C" int upsample_block_fwd(const void* x, const void* wt,
                                  const void* gamma, const void* beta, void* y,
                                  int B, int H, int W, int Ci, int Co, int gs,
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
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(y), H, W,
      Ci, Co, gs, slope, eps);
  return static_cast<int>(cudaGetLastError());
}

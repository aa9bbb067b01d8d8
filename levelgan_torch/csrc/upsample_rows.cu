// K1L forward, pass 1: row-tiled ConvTranspose(4x4, s2, SAME) emitted in
// the folded parity layout, plus per-(sample, channel) GroupNorm sums; and
// K1L backward: the input gradient from the folded cotangent.
//
// The forward replaces levelgan/kernels/upsample_rows.py:_conv_fwd (the
// Pallas call at :253), the kernel of the JAX package's late-stage path
// (upsample_block_rows_sm); the backward replaces _conv_bwd (:323).  Output yf [B, H, W, 4Co] bf16: channel block
// p = 2a + b holds output parity (a, b), so the kernel writes its
// accumulator tile as it stands.  s1/s2 [B, Co] f32 receive the channel sums
// of the f32 (pre-rounding) conv output over all positions and parities,
// by atomicAdd into buffers the caller zeroed: the order of the adds varies
// from run to run, so the sums agree with a sequential sum to f32 rounding
// (relative ~1e-6), far below the bf16 tolerance the stage is held to.
// Pass 2 (GroupNorm finish, LeakyReLU, depth-to-space unfold) runs outside
// the kernel, as the JAX package runs it outside Pallas.
//
// Used for stages whose (sample, group) tile does not fit K1's registers
// (gumbel_64 up3: 64 x 64 x 16 f32 = 256 KB).  A block owns RT = 128 / W
// input rows of one sample and 32 output channels, all four parities: 8
// warps x 4 (parity, M tile) tasks x 4 n8 tiles.
//
// What bounds it on an H100: at up3 (B = 1024) the conv is 68.7 GFLOP
// against ~400 MB of traffic (x in, yf out), 171 FLOP/byte, under the
// card's 295: memory bounds it.  This first version (mma.sync,
// single-buffered staging, taps re-staged by every block) is held back by
// its own staging, not by either roof.  Unlike the TPU kernel it
// multiplies no structured zeros: each parity takes only its own 4 taps.

#include "stage_common.cuh"

namespace {

constexpr int NC = 32;      // output channels per block
constexpr int NQ = NC / 8;  // n8 tiles
constexpr int MAXT = 4;     // (parity, M tile) tasks per warp
constexpr int NW = 8;       // warps per block
constexpr int MROWS = 128;  // positions per parity per block (RT * W)

__global__ void __launch_bounds__(NW * 32)
upsample_rows_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ wt,
                         __nv_bfloat16* __restrict__ yf,
                         float* __restrict__ s1g, float* __restrict__ s2g,
                         int H, int W, int Ci, int Co) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rt = MROWS / W;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + (rt + 2) * (W + 2) * lgt::LDK;
  float* sred = reinterpret_cast<float*>(ws + 16 * NC * lgt::LDK);

  const int row0 = blockIdx.x * rt, n0 = blockIdx.y * NC, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int mtiles = MROWS / 16;

  if (threadIdx.x < 2 * NC) sred[threadIdx.x] = 0.f;

  float acc[MAXT][NQ][4];
#pragma unroll
  for (int i = 0; i < MAXT; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;

  for (int k0 = 0; k0 < Ci; k0 += lgt::KC) {
    __syncthreads();
    lgt::stage_input(xs, x, b, row0, rt, H, W, Ci, k0);
    lgt::stage_taps(ws, wt, n0, NC, Co, Ci, k0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAXT; ++i) {
      const int task = warp + i * NW;
      lgt::parity_tile_chunk<NQ>(acc[i], xs, ws, task / mtiles,
                                 (task % mtiles) * 16, W, NC, NQ);
    }
  }

  // ---- folded store + per-lane channel sums --------------------------------
  float p1[NQ][2], p2[NQ][2];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) p1[q][e] = p2[q][e] = 0.f;

#pragma unroll
  for (int i = 0; i < MAXT; ++i) {
    const int task = warp + i * NW;
    const int par = task / mtiles, m0 = (task % mtiles) * 16;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = par * Co + n0 + q * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + g + 8 * h;
        const float v0 = acc[i][q][2 * h], v1 = acc[i][q][2 * h + 1];
        p1[q][0] += v0;
        p1[q][1] += v1;
        p2[q][0] += v0 * v0;
        p2[q][1] += v1 * v1;
        *reinterpret_cast<__nv_bfloat162*>(
            yf + ((static_cast<size_t>(b) * H + row0 + m / W) * W + m % W) *
                     (4 * Co) + c) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }

  // reduce over the 8 row groups g (lane bits 2..4), then across warps
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        p1[q][e] += __shfl_xor_sync(0xffffffffu, p1[q][e], o);
        p2[q][e] += __shfl_xor_sync(0xffffffffu, p2[q][e], o);
      }
  if (g == 0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        atomicAdd(&sred[q * 8 + 2 * t + e], p1[q][e]);
        atomicAdd(&sred[NC + q * 8 + 2 * t + e], p2[q][e]);
      }
  }
  __syncthreads();
  if (threadIdx.x < NC) {
    atomicAdd(&s1g[static_cast<size_t>(b) * Co + n0 + threadIdx.x],
              sred[threadIdx.x]);
    atomicAdd(&s2g[static_cast<size_t>(b) * Co + n0 + threadIdx.x],
              sred[NC + threadIdx.x]);
  }
}

}  // namespace

extern "C" size_t upsample_rows_fwd_smem(int W) {
  const int rt = MROWS / W;
  return (static_cast<size_t>(rt + 2) * (W + 2) + 16 * NC) * lgt::LDK *
             sizeof(__nv_bfloat16) +
         2 * NC * sizeof(float);
}

// x [B,H,W,Ci] bf16, wt [16,Co,Ci] bf16 -> yf [B,H,W,4Co] bf16; s1/s2
// [B,Co] f32 must be zeroed by the caller.  The caller checks the shape
// rules: Ci % 64 == 0, Co % 32 == 0, 128 % W == 0 (W >= 16) and
// H % (128 / W) == 0.  Returns cudaGetLastError().
extern "C" int upsample_rows_fwd(const void* x, const void* wt, void* yf,
                                 void* s1, void* s2, int B, int H, int W,
                                 int Ci, int Co, void* stream) {
  const size_t smem = upsample_rows_fwd_smem(W);
  cudaError_t err = cudaFuncSetAttribute(
      upsample_rows_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H / (MROWS / W), Co / NC, B);
  upsample_rows_fwd_kernel<<<grid, NW * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wt), static_cast<__nv_bfloat16*>(yf),
      static_cast<float*>(s1), static_cast<float*>(s2), H, W, Ci, Co);
  return static_cast<int>(cudaGetLastError());
}

// K1L backward: dyf [B,H,W,4Co] bf16 (the folded pre-norm cotangent, channel
// block 2a+b = parity (a, b)), wpk (the weight packed by dx steps,
// [Ci/32][parity][Co/32][tap][32][32] bf16) -> dx [B,H,W,Ci] bf16, by the
// gather GEMM of stage_common.cuh read straight from the folded layout: no
// zero-padded copy of dyf and no 9-shift packed weights with structured
// zeros (the TPU kernel's _pack_w_bwd); each parity multiplies only its own
// 4 taps.  What bounds it on an H100 at gumbel_64 up3 (B = 64): 4.29 GFLOP
// against 25 MB of dyf in and dx out, so the bytes.  A block takes nsd whole
// samples or rt rows of one; the caller checks the shape rules of
// launch_dx_gather.  Returns cudaGetLastError().
extern "C" int upsample_rows_bwd(const void* dyf, const void* wpk, void* dx,
                                 int B, int H, int W, int Ci, int Co, int nsd,
                                 int rt, void* stream) {
  return static_cast<int>(lgt::launch_dx_gather<true>(
      dyf, wpk, dx, nullptr, nullptr, nullptr, nullptr, B, H, W, Ci, Co, nsd,
      rt, static_cast<cudaStream_t>(stream)));
}

// K2 core: the WGAN-GP gradient-norm penalty, forward and backward.
//
// Replaces levelgan/kernels/gp_penalty.py:_pallas_fwd (the Pallas call at
// :81) and _pallas_bwd (:99):
//
//   forward:  norm_b = sqrt(sum_f g[b, f]^2 + 1e-12), pen_b = (norm_b - 1)^2
//   backward: dg[b, f] = ct_b * 2 (norm_b - 1) / norm_b * g[b, f]
//
// g2 is the critic's per-sample input gradient, flattened to [B, F] f32
// (F = 64 * 64 * 8 = 32768 at gumbel_64).  The TPU kernel tiles the batch
// to fit VMEM; on the card the forward is one block per sample (a row
// reduction: float4 loads, f32 sums in a fixed order, a warp-shuffle
// tree), the backward a float4 scaled copy over a (chunk, sample) grid.
// What bounds both on an H100: the bytes (8.4 MB read forward; 8.4 MB read
// and 8.4 MB written backward, at B = 64), i.e. ~2.5 and ~5 us at
// 3.35 TB/s; at that size the launch itself is of the same order.

#include <cuda_runtime.h>

namespace {

constexpr int FWD_THREADS = 512;
constexpr int BWD_THREADS = 256;
constexpr float EPS = 1e-12f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(FWD_THREADS)
norm_penalty_fwd_kernel(const float* __restrict__ g, float* __restrict__ pen,
                        float* __restrict__ norm, int F) {
  __shared__ float red[FWD_THREADS / 32];
  const int b = blockIdx.x;
  const float4* row =
      reinterpret_cast<const float4*>(g + static_cast<size_t>(b) * F);
  const int n4 = F / 4;
  float s = 0.f;
  for (int i = threadIdx.x; i < n4; i += FWD_THREADS) {
    const float4 v = row[i];
    s += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = threadIdx.x < FWD_THREADS / 32 ? red[threadIdx.x] : 0.f;
    s = warp_sum(s);
    if (threadIdx.x == 0) {
      const float nrm = sqrtf(s + EPS);
      norm[b] = nrm;
      pen[b] = (nrm - 1.f) * (nrm - 1.f);
    }
  }
}

__global__ void __launch_bounds__(BWD_THREADS)
norm_penalty_bwd_kernel(const float* __restrict__ g,
                        const float* __restrict__ norm,
                        const float* __restrict__ ct, float* __restrict__ dg,
                        int F) {
  const int b = blockIdx.y;
  const float nrm = norm[b];
  const float scale = ct[b] * 2.f * (nrm - 1.f) / nrm;
  const size_t off = static_cast<size_t>(b) * F;
  const float4* src = reinterpret_cast<const float4*>(g + off);
  float4* dst = reinterpret_cast<float4*>(dg + off);
  const int n4 = F / 4;
  for (int i = blockIdx.x * BWD_THREADS + threadIdx.x; i < n4;
       i += gridDim.x * BWD_THREADS) {
    const float4 v = src[i];
    dst[i] = make_float4(scale * v.x, scale * v.y, scale * v.z, scale * v.w);
  }
}

}  // namespace

// g2 [B,F] f32 -> pen, norm [B] f32.  The caller checks F % 4 == 0 and
// contiguity.  Returns cudaGetLastError().
extern "C" int norm_penalty_fwd(const void* g2, void* pen, void* norm, int B,
                                int F, void* stream) {
  norm_penalty_fwd_kernel<<<B, FWD_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g2), static_cast<float*>(pen),
      static_cast<float*>(norm), F);
  return static_cast<int>(cudaGetLastError());
}

// g2 [B,F], norm [B], ct [B] f32 -> dg [B,F] f32.  Returns
// cudaGetLastError().
extern "C" int norm_penalty_bwd(const void* g2, const void* norm,
                                const void* ct, void* dg, int B, int F,
                                void* stream) {
  const int n4 = F / 4;
  int chunks = (n4 + 4 * BWD_THREADS - 1) / (4 * BWD_THREADS);
  if (chunks < 1) chunks = 1;
  norm_penalty_bwd_kernel<<<dim3(chunks, B), BWD_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g2), static_cast<const float*>(norm),
      static_cast<const float*>(ct), static_cast<float*>(dg), F);
  return static_cast<int>(cudaGetLastError());
}

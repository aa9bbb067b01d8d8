// K2 core: the WGAN-GP gradient-norm penalty, forward and backward.
//
// Replaces levelgan/kernels/gp_penalty.py:_pallas_fwd (the Pallas call at
// :81) and _pallas_bwd (:99):
//
//   forward:  norm_b = sqrt(sum_f g[b, f]^2 + 1e-12), pen_b = (norm_b - 1)^2
//   backward: dg[b, f] = ct_b * 2 (norm_b - 1) / norm_b * g[b, f]
//
// g2 is the critic's per-sample input gradient, flattened to [B, F] f32
// (F = 64 * 64 * 8 = 32768 at gumbel_64, 8192 at wgan_gp_32, 2048 at the
// 16x16 presets; B = 64; any F % 4 == 0, as model.level_size and
// model.n_tiles allow).  The TPU kernel tiles the batch to fit VMEM.
//
// What bounds them on an H100.  Both move bytes and do next to no
// arithmetic: 8.4 MB read forward, 8.4 MB read and 8.4 MB written
// backward at [64, 32768] (2.5 and 5.0 us at 3.35 TB/s), a quarter and a
// sixteenth of that at the smaller widths.  In the training step g2 has
// just been written by the kernel before, so it sits in the 50 MB L2.  At
// these sizes the launch is most of the time: 20 launches of a one-cycle
// kernel back to back read 0.0020-0.0022 ms each (the floor of chip_smoke's
// queued_ms), against 0.0025-0.0050 ms for these kernels.  So the design
// keeps many bytes in flight and adds as little as it can to the launch.
//
// Forward.  One block a sample (kernels/gp_penalty.py:fwd_plan gives its
// threads T and V).  The row is read in chunks of V * T float4s; thread t
// loads the float4s c + j * T + t of chunk c for j = 0 .. V - 1, all V
// loads issued before their first sum (V is a template parameter).  The
// sums run in a fixed order: each thread in four chains (x, y, z, w) over
// its float4s in chunk then j order, then (x + y) + (z + w); a warp-shuffle
// butterfly; the warps' partials by a second butterfly in warp 0.  No
// atomics: two calls give the same bits.  Splitting a row over a cluster
// of blocks was measured and dropped: at B = 64 its exchange cost what the
// shorter slice saved; it paid only at small batches that no preset runs.
//
// Backward.  A scaled copy over a (chunk, sample) grid of 256-thread
// blocks, 1024 float4s a block (kernels/gp_penalty.py:bwd_plan).  A thread
// issues its 4 16-byte loads, then computes the sample's scale from two
// broadcast loads while they are in flight, then stores 4 float4s.  The
// cotangent is read with its stride: the broadcast of a scalar (stride 0)
// needs no copy.  Plain stores: dg goes straight into the critic's double
// backward, which reads it from L2.

#include <cuda_runtime.h>

namespace {

constexpr float EPS = 1e-12f;
constexpr int FWD_MAX_THREADS = 512;
constexpr int BWD_MAX_THREADS = 256;
constexpr int BWD_VEC = 4;            // float4 loads a backward thread

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct BwdArgs {
  const float4* g;
  const float* norm;
  const float* ct;
  long long ct_stride;
  float4* dg;
  int n4, p4;
};

// A thread's V float4s p[0], p[stride], ..., all issued before any is
// used; those at or past `left` float4s are zeros, unless the slice is
// `full` (the common case: no test on the loads).
template <int V>
__device__ __forceinline__ void load_slice(float4 (&v)[V], const float4* p,
                                           int stride, int left, bool full) {
  if (full) {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __ldg(p + j * stride);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      v[j] = j * stride < left ? __ldg(p + j * stride)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int V>
__global__ void __launch_bounds__(FWD_MAX_THREADS)
norm_penalty_fwd_kernel(const float4* __restrict__ g, float* __restrict__ pen,
                        float* __restrict__ norm, int n4) {
  __shared__ float red[FWD_MAX_THREADS / 32];
  const int b = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int chunk = V * nthr;
  const float4* p = g + static_cast<size_t>(b) * n4 + tid;
  // four independent chains (the x, y, z and w of the float4s, in chunk
  // then j order), then (x + y) + (z + w)
  float sx = 0.f, sy = 0.f, sz = 0.f, sw = 0.f;
  for (int lo = 0; lo < n4; lo += chunk) {
    float4 v[V];
    load_slice<V>(v, p + lo, nthr, n4 - lo - tid, chunk <= n4 - lo);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sx = fmaf(v[j].x, v[j].x, sx);
      sy = fmaf(v[j].y, v[j].y, sy);
      sz = fmaf(v[j].z, v[j].z, sz);
      sw = fmaf(v[j].w, v[j].w, sw);
    }
  }
  float s = warp_sum((sx + sy) + (sz + sw));
  if ((tid & 31) == 0) red[tid >> 5] = s;
  __syncthreads();
  if (tid < 32) {
    s = warp_sum(tid < nthr / 32 ? red[tid] : 0.f);
    if (tid == 0) {
      const float nrm = sqrtf(s + EPS);
      norm[b] = nrm;
      pen[b] = (nrm - 1.f) * (nrm - 1.f);
    }
  }
}

__global__ void __launch_bounds__(BWD_MAX_THREADS)
norm_penalty_bwd_kernel(const BwdArgs a) {
  constexpr int U = BWD_VEC;
  const int b = blockIdx.y, tid = threadIdx.x, nthr = blockDim.x;
  const size_t off = static_cast<size_t>(b) * a.n4;
  const int lo = blockIdx.x * a.p4, len = min(a.p4, a.n4 - lo);
  const bool full = U * nthr <= len;
  const float4* p = a.g + off + lo + tid;
  float4 v[U];
  load_slice<U>(v, p, nthr, len - tid, full);
  const float nrm = a.norm[b];
  const float scale = a.ct[b * a.ct_stride] * 2.f * (nrm - 1.f) / nrm;
  float4* q = a.dg + off + lo + tid;
#pragma unroll
  for (int j = 0; j < U; ++j)
    if (full || j * nthr < len - tid)
      q[j * nthr] = make_float4(scale * v[j].x, scale * v[j].y,
                                scale * v[j].z, scale * v[j].w);
}

bool valid_threads(int threads, int most) {
  return threads >= 32 && threads <= most && threads % 32 == 0;
}

}  // namespace

// g2 [B,F] f32 -> pen, norm [B] f32, by the plan (threads, vec) of
// kernels/gp_penalty.py:fwd_plan: one block of `threads` threads a sample,
// each issuing `vec` 16-byte loads at a time.  The caller checks F % 4 ==
// 0, contiguity and 16-byte alignment.  A plan the kernel does not take
// returns cudaErrorInvalidValue without launching.
extern "C" int norm_penalty_fwd(const void* g2, void* pen, void* norm, int B,
                                int F, int threads, int vec, void* stream) {
  if (B < 1 || F < 0 || F % 4 || !valid_threads(threads, FWD_MAX_THREADS))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto g = static_cast<const float4*>(g2);
  const auto p = static_cast<float*>(pen), n = static_cast<float*>(norm);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4: norm_penalty_fwd_kernel<4><<<B, threads, 0, st>>>(g, p, n, F / 4);
            break;
    case 16: norm_penalty_fwd_kernel<16><<<B, threads, 0, st>>>(g, p, n,
                                                                 F / 4);
             break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// g2 [B,F], norm [B] f32, ct f32 with element stride ct_stride (0 for a
// broadcast scalar) -> dg [B,F] f32, by the plan (chunks, threads) of
// kernels/gp_penalty.py:bwd_plan: `chunks` blocks a sample, each of
// `threads` threads issuing BWD_VEC 16-byte loads.  The caller checks
// shapes, contiguity and 16-byte alignment.  A plan that does not cover the
// row returns cudaErrorInvalidValue without launching.
extern "C" int norm_penalty_bwd(const void* g2, const void* norm,
                                const void* ct, long long ct_stride, void* dg,
                                int B, int F, int chunks, int threads,
                                void* stream) {
  const int n4 = F / 4, p4 = BWD_VEC * threads;
  if (B < 1 || B > 65535 || F % 4 || chunks < 1 ||
      !valid_threads(threads, BWD_MAX_THREADS) ||
      static_cast<long long>(p4) * chunks < n4)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{static_cast<const float4*>(g2),
                  static_cast<const float*>(norm),
                  static_cast<const float*>(ct), ct_stride,
                  static_cast<float4*>(dg), n4, p4};
  norm_penalty_bwd_kernel<<<dim3(chunks, B), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

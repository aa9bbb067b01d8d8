// The export's Gumbel sampling head, ids only: f32 logits and f32 uniforms
// in, uint8 tile ids out.
//
// Replaces no TPU kernel: the JAX package samples with XLA operations
// (levelgan/ops/gumbel.py, levelgan/models/heads.py), and the port did the
// same with about 16 PyTorch operations, decode(sample_head(logits,
// "gumbel", tau)) in export.py.  It was added because those operations took
// 44% of the export's device time on an H100: 2.03 of 4.58 ms of a
// 1024-level gumbel_64 batch (PERF.md section 5).
//
// What it computes.  For each pixel's T logits l and uniforms u (drawn by
// torch.rand, as ops/gumbel.py:gumbel_noise draws them), the id that
// decode(gumbel_softmax(l, tau, hard=True)) gives on the card, bit for bit:
//
//   g = -logf(-logf(max(u, FLT_MIN)))        gumbel_noise
//   v = (l + g) * inv_tau                    PyTorch divides a CUDA tensor by
//                                            a CPU scalar as a product with
//                                            1.0f / (float)tau, and so does
//                                            the wrapper
//   m = max v,  e = expf(v - m)              PyTorch's persistent warp softmax
//   s = the sum of e in that kernel's butterfly order: xor offsets W/2 .. 1
//       over W = next_pow2(T) lanes, lanes past T holding 0; for T = 8,
//       ((e0 + e4) + (e2 + e6)) + ((e1 + e5) + (e3 + e7))
//   y = e / s,  id = the first index of the largest y      torch.argmax
//       (found without dividing every e: see pixel_id)
//
// Precise logf, expf and division only (built without fast-math), and no
// product feeds a sum, so no FMA forms that PyTorch's kernels lack.  The
// softmax is computed at all because ties among the rounded y decide the
// id (two v one ulp apart can give the same e).  Where a v is NaN or
// infinite, s is NaN, every y is NaN and both sides give id 0.
//
// What bounds it: bytes.  At gumbel_64's batch (N = 1024 * 64 * 64 pixels,
// T = 8) it reads 134,217,728 B of logits and as many of uniforms and writes
// 4,194,304 B of ids: 0.0814 ms at 3.35 TB/s.  Its arithmetic (two logf and
// one expf an element) takes nearly as many issue slots, so the two have to
// overlap.  On an H100 at 700 W it takes about 0.106 ms there; the same
// loads and stores with the arithmetic taken out take 0.093 ms.  Dividing
// every e by s, as the argmax over the softmax's output does, took 0.12 ms,
// and up to 0.28 ms on wide logits: the division's slow path runs for every
// denormal e.
//
// Design.  A warp takes a tile of 128 pixels, 4 a lane.
//   1. Loads in the inputs' own order: the tile's 32 * T float4s of each
//      input, float4 j * 32 + lane to lane, so every warp load reads 512
//      contiguous bytes; streaming (evict-first) loads, since each byte is
//      read once; in the source a lane's 8 float4s of each input come
//      before their arithmetic (the compiler spreads them among it).  The
//      perturbed logit v is elementwise, so it is computed here and stored
//      to shared memory, pixel rows of S = T | 1 floats (odd: the next
//      phase reads one channel of 32 pixels from 32 banks).
//   2. Lane L takes the pixels L, L + 32, L + 64, L + 96 of the tile: its
//      row from shared memory, the softmax and the argmax; the id goes to a
//      shared byte array in pixel order.
//   3. Lane L stores the word of pixels 4L .. 4L + 3: one 32-bit store.
// A tile past the end of the N pixels (N not a multiple of 128), or inputs
// that are not 16-byte aligned, load and store element by element under a
// mask.  The launch takes PyTorch's current stream, synchronises nothing
// and allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

#include "gumbel.cuh"

namespace {

constexpr int MAX_TILES = 32;
constexpr int TILE = 128;     // pixels a warp, 4 a lane
constexpr int CHUNK = 8;      // float4 loads of each input in flight a lane

constexpr int next_pow2(int t) {
  int w = 1;
  while (w < t) w *= 2;
  return w;
}

template <int T>
struct Plan {
  static constexpr int S = T | 1;                     // shared row stride
  static constexpr int W = next_pow2(T);              // the softmax's lanes
  static constexpr int WARP_BYTES = TILE * S * 4 + TILE;
  // four warps a block where their shared memory fits the static 48 KB
  static constexpr int WARPS = 4 * WARP_BYTES <= 48 * 1024 ? 4 : 2;
};

__device__ __forceinline__ float perturbed(float l, float u, float inv_tau) {
  return (l + gumbel::gumbel_noise(u)) * inv_tau;
}

// element x of the tile's [128, T] v, in its padded shared row
template <int T>
__device__ __forceinline__ void put(float* v, int x, float val) {
  v[x + (x / T) * (Plan<T>::S - T)] = val;
}

// The first j of `ties` (channels before jb whose e lies within 2^-20 of
// eb) whose y = e / s rounds to eb / s; jb where none does.  Out of line, so
// that the compiler does not hoist its divisions into the common path.
__device__ __noinline__ int first_tie(const float* row, float m, float s,
                                      float eb, uint32_t ties, int jb) {
  const float yb = eb / s;
  for (; ties; ties &= ties - 1) {
    const int j = __ffs(ties) - 1;
    if (expf(row[j] - m) / s == yb) return j;
  }
  return jb;
}

template <int T>
__device__ __forceinline__ uint32_t pixel_id(const float* row) {
  constexpr int W = Plan<T>::W;
  float x[T], e[T], a[W];
#pragma unroll
  for (int j = 0; j < T; ++j) x[j] = row[j];
  // the largest v, in any order (PyTorch's Max, a < b ? b : a, differs only
  // where a v is NaN, and then s is NaN whatever m is)
  float m = x[0];
#pragma unroll
  for (int j = 1; j < T; ++j) m = fmaxf(m, x[j]);
#pragma unroll
  for (int j = 0; j < T; ++j) a[j] = e[j] = expf(x[j] - m);
#pragma unroll
  for (int j = T; j < W; ++j) a[j] = 0.f;      // the softmax's idle lanes
  // lane 0's sum after the butterfly (every lane holds the same)
#pragma unroll
  for (int h = W / 2; h > 0; h /= 2) {
#pragma unroll
    for (int i = 0; i < h; ++i) a[i] = a[i] + a[i + h];
  }
  const float s = a[0];
  if (s != s) return 0;           // a NaN or infinite v: every y is NaN
  // The largest y = e / s is that of the largest e (a division by s > 0 never
  // reverses an order), first at jb.  An earlier j can still round to the
  // same y only if e[j] lies within 2^-20 of e[jb]: e[jb] = expf(0) = 1 and
  // s <= 32, so e[jb] / s is normal, and any e[j] below that threshold gives
  // a quotient more than an ulp smaller.  So only those few are divided.
  float eb = e[0];
  int jb = 0;
#pragma unroll
  for (int j = 1; j < T; ++j) {
    if (e[j] > eb) {
      eb = e[j];
      jb = j;
    }
  }
  const float near = eb * (1.f - 0x1p-20f);
  uint32_t ties = 0;
#pragma unroll
  for (int j = 0; j < T - 1; ++j) ties |= e[j] >= near ? 1u << j : 0u;
  ties &= (1u << jb) - 1;
  return ties ? first_tie(row, m, s, eb, ties, jb) : jb;
}

template <int T>
__global__ void __launch_bounds__(32 * Plan<T>::WARPS)
sample_ids_kernel(const float* __restrict__ logits, const float* __restrict__ u,
                  float inv_tau, uint8_t* __restrict__ ids, long long n,
                  bool aligned) {
  using P = Plan<T>;
  __shared__ float sv[P::WARPS][TILE * P::S];
  __shared__ uint32_t sid[P::WARPS][TILE / 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long p0 =
      (static_cast<long long>(blockIdx.x) * P::WARPS + warp) * TILE;
  if (p0 >= n) return;
  const int left = n - p0 < TILE ? static_cast<int>(n - p0) : TILE;
  float* v = sv[warp];
  const float* lt = logits + p0 * T;
  const float* ut = u + p0 * T;

  if (left == TILE && aligned) {
    const auto l4 = reinterpret_cast<const float4*>(lt);
    const auto u4 = reinterpret_cast<const float4*>(ut);
#pragma unroll
    for (int j0 = 0; j0 < T; j0 += CHUNK) {
      float4 a[CHUNK], b[CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        if (j0 + c < T) {
          a[c] = __ldcs(l4 + (j0 + c) * 32 + lane);
          b[c] = __ldcs(u4 + (j0 + c) * 32 + lane);
        }
      }
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        if (j0 + c < T) {
          const int x = ((j0 + c) * 32 + lane) * 4;
          put<T>(v, x, perturbed(a[c].x, b[c].x, inv_tau));
          put<T>(v, x + 1, perturbed(a[c].y, b[c].y, inv_tau));
          put<T>(v, x + 2, perturbed(a[c].z, b[c].z, inv_tau));
          put<T>(v, x + 3, perturbed(a[c].w, b[c].w, inv_tau));
        }
      }
    }
  } else {
    for (int x = lane; x < left * T; x += 32)
      put<T>(v, x, perturbed(__ldcs(lt + x), __ldcs(ut + x), inv_tau));
  }
  __syncwarp();

  auto sb = reinterpret_cast<uint8_t*>(sid[warp]);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int q = lane + 32 * p;
    sb[q] = q < left ? static_cast<uint8_t>(pixel_id<T>(v + q * P::S)) : 0;
  }
  __syncwarp();

  uint8_t* out = ids + p0;
  if (left == TILE) {
    reinterpret_cast<uint32_t*>(out)[lane] = sid[warp][lane];
  } else {
    for (int k = 4 * lane; k < 4 * lane + 4 && k < left; ++k) out[k] = sb[k];
  }
}

template <int T>
int launch(int t, const float* logits, const float* u, float inv_tau,
           uint8_t* ids, long long n, cudaStream_t st) {
  if constexpr (T > MAX_TILES) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (t != T) return launch<T + 1>(t, logits, u, inv_tau, ids, n, st);
    constexpr int WARPS = Plan<T>::WARPS;
    const long long blocks = ((n + TILE - 1) / TILE + WARPS - 1) / WARPS;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const bool aligned =
        (reinterpret_cast<uintptr_t>(logits) | reinterpret_cast<uintptr_t>(u))
            % 16 == 0;
    sample_ids_kernel<T><<<static_cast<unsigned>(blocks), 32 * WARPS, 0, st>>>(
        logits, u, inv_tau, ids, n, aligned);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

// logits, u: contiguous f32 [n, t] (not 16-byte aligned: every tile loads
// element by element); ids: uint8 [n], 4-byte aligned; 1 <= t <= 32;
// inv_tau = 1.0f / (float)tau.  The caller checks shapes, types and
// contiguity and allocates ids (kernels/sample_ids.py).  Any
// other t returns cudaErrorInvalidValue without launching; n = 0 launches
// nothing.
extern "C" int sample_ids(const void* logits, const void* u, float inv_tau,
                          void* ids, long long n, int t, void* stream) {
  if (n < 0 || t < 1 || t > MAX_TILES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  return launch<1>(t, static_cast<const float*>(logits),
                   static_cast<const float*>(u), inv_tau,
                   static_cast<uint8_t*>(ids), n,
                   static_cast<cudaStream_t>(stream));
}

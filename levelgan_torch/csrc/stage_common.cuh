// Shared pieces of the upsample-stage kernels (upsample_block.cu,
// upsample_rows.cu): the bf16 tensor-core product, the smem staging of an
// input chunk with its zero halo, and the staging of the 16 conv taps.
//
// The transposed conv is computed in parity form (no multiplies against
// inserted zeros).  For output parity (a, b) and taps (r, s) in {0,1}^2,
// with xp the input zero-padded by one on each side:
//
//     y[2i+a, 2j+b, c] = sum_{r,s,ci} xp[i+a+r, j+b+s, ci] * w[a+2r, b+2s, ci, c]
//
// Per parity this is a GEMM with M = positions, N = channels and
// K = 4 taps x Ci; each K step of 16 is one mma.sync.m16n8k16 per 8
// channels.  The A operand is gathered straight from the staged input
// (row = position, k contiguous), the B operand from the staged taps
// (row = channel, k contiguous), so both fragments are plain 32-bit smem
// loads.  Rows are padded by 8 bf16 (LDK = KC + 8) so that the 8 rows x 4
// words a fragment load touches fall in 32 distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lgt {

constexpr int KC = 64;        // input channels staged per chunk
constexpr int LDK = KC + 8;   // smem row pitch in bf16

// d += a * b for one m16n8k16 bf16 tile with f32 accumulation.
// a: rows g / g+8, k 2t..2t+1 / 2t+8..2t+9; b: k 2t.. / 2t+8.., col g;
// d: rows g / g+8, cols 2t, 2t+1 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage x[b, row0-1 .. row0+rows, -1 .. W, k0 .. k0+KC) into xs
// [(rows+2) x (W+2)][LDK], zeros outside the input.  x is NHWC bf16.
__device__ __forceinline__ void stage_input(
    __nv_bfloat16* xs, const __nv_bfloat16* __restrict__ x, int b, int row0,
    int rows, int H, int W, int Ci, int k0) {
  const int wp = W + 2, vec = KC / 8;
  const int n = (rows + 2) * wp * vec;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int p = idx / vec, v = idx - p * vec;
    const int ir = row0 + p / wp - 1, ic = p % wp - 1;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (ir >= 0 && ir < H && ic >= 0 && ic < W)
      val = *reinterpret_cast<const uint4*>(
          x + ((static_cast<size_t>(b) * H + ir) * W + ic) * Ci + k0 + v * 8);
    *reinterpret_cast<uint4*>(xs + p * LDK + v * 8) = val;
  }
}

// Stage the 16 taps of channels n0 .. n0+nc, input channels k0 .. k0+KC,
// from wt [16][Co][Ci] (tap = kh*4 + kw) into ws [16 * nc][LDK].
__device__ __forceinline__ void stage_taps(
    __nv_bfloat16* ws, const __nv_bfloat16* __restrict__ wt, int n0, int nc,
    int Co, int Ci, int k0) {
  const int vec = KC / 8;
  const int n = 16 * nc * vec;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int row = idx / vec, v = idx - row * vec;
    const int tap = row / nc, c = row - tap * nc;
    *reinterpret_cast<uint4*>(ws + row * LDK + v * 8) =
        *reinterpret_cast<const uint4*>(
            wt + (static_cast<size_t>(tap) * Co + n0 + c) * Ci + k0 + v * 8);
  }
}

// One K chunk of one (parity, 16-row M tile) task against NQ n8 tiles.
// Row m of the tile is position (m / W, m % W) relative to the staged
// block; xs holds the block with a one-position zero halo.
template <int NQ>
__device__ __forceinline__ void parity_tile_chunk(
    float (&acc)[NQ][4], const __nv_bfloat16* xs, const __nv_bfloat16* ws,
    int par, int m0, int W, int nc, int nq) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int pa = par >> 1, pb = par & 1, wp = W + 2;
  const int ma = m0 + g, mb = m0 + g + 8;
  const int pos_a = (ma / W + pa) * wp + (ma % W + pb);
  const int pos_b = (mb / W + pa) * wp + (mb % W + pb);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int sh = r * wp + s;
      const __nv_bfloat16* xa = xs + (pos_a + sh) * LDK + 2 * t;
      const __nv_bfloat16* xb = xs + (pos_b + sh) * LDK + 2 * t;
      const int tap = (pa + 2 * r) * 4 + (pb + 2 * s);
      const __nv_bfloat16* wrow = ws + (tap * nc + g) * LDK + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[4];
        a[0] = lds32(xa + kk);
        a[1] = lds32(xb + kk);
        a[2] = lds32(xa + kk + 8);
        a[3] = lds32(xb + kk + 8);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (q < nq) {
            const __nv_bfloat16* wq = wrow + q * 8 * LDK + kk;
            mma16816(acc[q], a, lds32(wq), lds32(wq + 8));
          }
        }
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Backward input gradient of the transposed conv (K1 bwd phase (b), K1L bwd)
//
// The exact transpose of the parity form above: with dy_(a,b)[u, v] =
// dy[2u+a, 2v+b] the pre-norm cotangent of output parity (a, b),
//
//     dx[i, j, ci] = sum_{(a,b),r,s,c} dy_(a,b)[i+1-a-r, j+1-b-s, c]
//                                      * w[a+2r, b+2s, ci, c]
//
// (zero outside the plane).  A GEMM with M = positions of x, N = Ci and
// K = 16 taps x Co.  A block owns MROWS_DX positions (whole rows of x) of
// one sample and NB_DX input channels; per (parity, Co chunk) it stages the
// parity plane with a one-position zero halo and the parity's 4 taps, and
// each warp runs one 16-row M tile against NB_DX / 8 n8 tiles.  The plane
// is read through element strides, so the same routine serves K1's merged
// dy [B, 2H, 2W, Co] and K1L's folded dyf [B, H, W, 4Co].
// ---------------------------------------------------------------------------

constexpr int KCB = 32;            // cotangent channels per smem chunk
constexpr int LDB = KCB + 8;       // smem row pitch (20 words: bank-free)
constexpr int NB_DX = 32;          // input channels (N) per block
constexpr int MROWS_DX = 128;      // positions (M) per block, at most

// Stage rows row0-1 .. row0+rows of a strided [H, W, KCB] bf16 plane into
// dst [(rows+2) x (W+2)][LDB], zeros outside.  src points at (row 0,
// col 0, first channel); rs / cs are the element strides of a row / col.
__device__ __forceinline__ void stage_plane(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, size_t rs,
    size_t cs, int row0, int rows, int H, int W) {
  const int wp = W + 2, vec = KCB / 8;
  const int n = (rows + 2) * wp * vec;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int p = idx / vec, v = idx - p * vec;
    const int ir = row0 + p / wp - 1, ic = p % wp - 1;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (ir >= 0 && ir < H && ic >= 0 && ic < W)
      val = *reinterpret_cast<const uint4*>(src + ir * rs + ic * cs + v * 8);
    *reinterpret_cast<uint4*>(dst + p * LDB + v * 8) = val;
  }
}

// Stage the 4 taps (a+2r, b+2s) of parity (a, b) for input channels
// n0 .. n0+NB_DX and cotangent channels c0 .. c0+KCB from wb [16][Ci][Co]
// (the HWIO weight flattened, tap = kh*4 + kw) into ws [4 * NB_DX][LDB],
// row = (r*2 + s) * NB_DX + ci.
__device__ __forceinline__ void stage_taps_bwd(
    __nv_bfloat16* ws, const __nv_bfloat16* __restrict__ wb, int pa, int pb,
    int n0, int Ci, int Co, int c0) {
  const int vec = KCB / 8;
  const int n = 4 * NB_DX * vec;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int row = idx / vec, v = idx - row * vec;
    const int q = row / NB_DX, c = row - q * NB_DX;
    const int tap = (pa + 2 * (q >> 1)) * 4 + (pb + 2 * (q & 1));
    *reinterpret_cast<uint4*>(ws + row * LDB + v * 8) =
        *reinterpret_cast<const uint4*>(
            wb + (static_cast<size_t>(tap) * Ci + n0 + c) * Co + c0 + v * 8);
  }
}

// One (parity, chunk) step of one 16-row M tile against NB_DX / 8 n8 tiles.
__device__ __forceinline__ void dx_tile_chunk(
    float (&acc)[NB_DX / 8][4], const __nv_bfloat16* ps,
    const __nv_bfloat16* ws, int pa, int pb, int m0, int W) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wp = W + 2;
  const int ma = m0 + g, mb = m0 + g + 8;
  const int pos_a = (ma / W + 2 - pa) * wp + (ma % W + 2 - pb);
  const int pos_b = (mb / W + 2 - pa) * wp + (mb % W + 2 - pb);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int sh = r * wp + s;
      const __nv_bfloat16* xa = ps + (pos_a - sh) * LDB + 2 * t;
      const __nv_bfloat16* xb = ps + (pos_b - sh) * LDB + 2 * t;
      const __nv_bfloat16* wrow = ws + ((r * 2 + s) * NB_DX + g) * LDB + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KCB; kk += 16) {
        uint32_t a[4];
        a[0] = lds32(xa + kk);
        a[1] = lds32(xb + kk);
        a[2] = lds32(xa + kk + 8);
        a[3] = lds32(xb + kk + 8);
#pragma unroll
        for (int q = 0; q < NB_DX / 8; ++q) {
          const __nv_bfloat16* wq = wrow + q * 8 * LDB + kk;
          mma16816(acc[q], a, lds32(wq), lds32(wq + 8));
        }
      }
    }
  }
}

// Rows of x per dx block at input width W.
__host__ __device__ __forceinline__ int dx_rows(int H, int W) {
  const int rt = MROWS_DX / W;
  return rt < H ? rt : H;
}

// dx [B, H, W, Ci] bf16 from the cotangent (FOLDED: dyf [B, H, W, 4Co],
// channel block 2a+b = parity (a, b); else merged dy [B, 2H, 2W, Co]) and
// wb [16][Ci][Co] bf16.  grid (H / rt, Ci / NB_DX, B), rt * W / 16 warps.
template <bool FOLDED>
__global__ void __launch_bounds__(MROWS_DX / 16 * 32)
dx_gather_kernel(const __nv_bfloat16* __restrict__ dy,
                 const __nv_bfloat16* __restrict__ wb,
                 __nv_bfloat16* __restrict__ dx, int H, int W, int Ci,
                 int Co) {
  extern __shared__ __align__(16) unsigned char smem_dx[];
  const int rt = dx_rows(H, W);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem_dx);
  __nv_bfloat16* ws = ps + (rt + 2) * (W + 2) * LDB;

  const int row0 = blockIdx.x * rt, n0 = blockIdx.y * NB_DX, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  float acc[NB_DX / 8][4];
#pragma unroll
  for (int q = 0; q < NB_DX / 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;

  for (int par = 0; par < 4; ++par) {
    const int pa = par >> 1, pb = par & 1;
    const __nv_bfloat16* plane;
    size_t rs, cs;
    if (FOLDED) {
      plane = dy + static_cast<size_t>(b) * H * W * 4 * Co + par * Co;
      rs = static_cast<size_t>(W) * 4 * Co;
      cs = 4 * Co;
    } else {
      plane = dy + ((static_cast<size_t>(b) * 2 * H + pa) * 2 * W + pb) * Co;
      rs = static_cast<size_t>(4) * W * Co;
      cs = 2 * Co;
    }
    for (int c0 = 0; c0 < Co; c0 += KCB) {
      __syncthreads();
      stage_plane(ps, plane + c0, rs, cs, row0, rt, H, W);
      stage_taps_bwd(ws, wb, pa, pb, n0, Ci, Co, c0);
      __syncthreads();
      dx_tile_chunk(acc, ps, ws, pa, pb, warp * 16, W);
    }
  }

#pragma unroll
  for (int q = 0; q < NB_DX / 8; ++q) {
    const int c = n0 + q * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = warp * 16 + g + 8 * h;
      const int i = row0 + m / W, j = m % W;
      *reinterpret_cast<__nv_bfloat162*>(
          dx + ((static_cast<size_t>(b) * H + i) * W + j) * Ci + c) =
          __floats2bfloat162_rn(acc[q][2 * h], acc[q][2 * h + 1]);
    }
  }
}

// Launch dx_gather_kernel on `stream`.  The caller checks the shape rules:
// Ci % NB_DX == 0, Co % KCB == 0, W <= MROWS_DX, rt * W % 16 == 0 and
// H % rt == 0 with rt = dx_rows(H, W).  Returns the launch's error.
template <bool FOLDED>
cudaError_t launch_dx_gather(const void* dy, const void* wb, void* dx, int B,
                             int H, int W, int Ci, int Co,
                             cudaStream_t stream) {
  const int rt = dx_rows(H, W);
  const size_t smem = (static_cast<size_t>(rt + 2) * (W + 2) + 4 * NB_DX) *
                      LDB * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      dx_gather_kernel<FOLDED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(H / rt, Ci / NB_DX, B);
  dx_gather_kernel<FOLDED><<<grid, rt * W / 16 * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(wb), static_cast<__nv_bfloat16*>(dx),
      H, W, Ci, Co);
  return cudaGetLastError();
}

}  // namespace lgt

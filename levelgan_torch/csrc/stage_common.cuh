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

}  // namespace lgt

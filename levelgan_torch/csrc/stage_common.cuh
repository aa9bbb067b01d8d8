// Shared pieces of the port's kernels (upsample_block.cu, upsample_rows.cu,
// critic_grad.cu): the bf16 tensor-core product and its fragments, the
// asynchronous copies of the staging rings, and mbarriers, bulk copies and
// stores into another block's shared memory.
//
// The transposed conv is computed in parity form (no multiplies against
// inserted zeros).  For output parity (a, b) and taps (r, s) in {0,1}^2,
// with xp the input zero-padded by one on each side:
//
//     y[2i+a, 2j+b, c] = sum_{r,s,ci} xp[i+a+r, j+b+s, ci] * w[a+2r, b+2s, ci, c]
//
// Per parity this is a GEMM with M = positions, N = channels and
// K = 4 taps x Ci; each K step of 16 is one mma.sync.m16n8k16 per 8
// channels.  The A operand is gathered from the staged input (row =
// position, k contiguous): a tap only shifts the row, so a fragment is
// either four 32-bit loads (K1L fwd, parity_tile_chunk) or one ldmatrix.x4
// whose 32 lanes each name one gathered row (K1 fwd, the dx GEMM).  The B
// operand comes from the staged taps (row = channel, k contiguous) the same
// way.  Staged rows are padded by 8 bf16 so that the rows one fragment load
// touches fall in distinct banks: pitch LDK = 72 for 64-channel chunks,
// LD32 = 40 for 32-channel chunks (80 bytes: eight consecutive rows start
// in eight distinct 16-byte bank groups, which is what ldmatrix needs).
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
// Rings of staged chunks (K1 fwd, the dx GEMM): cp.async copies of 16 bytes,
// committed one group per chunk, and ldmatrix fragments.
// ---------------------------------------------------------------------------

constexpr int KC32 = 32;            // channels per staged chunk
constexpr int LD32 = KC32 + 8;      // smem row pitch in bf16
constexpr int ROWB = LD32 * 2;      // ... and in bytes
constexpr int NB32 = 32;            // channels (N) per block
constexpr int MAX_STAGES = 3;       // buffers of a ring, at most

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0 .. MAX_STAGES - 2) committed groups are
// still in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four 8x8 bf16 matrices; lane l names the 16-byte row l % 8 of matrix
// l / 8, and thread (g, t) receives row g, columns 2t, 2t+1 of each.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Byte offsets of a lane's row in the two fragment loads.  A (m16k16): lane
// l names row l % 16 at k offset 8 * (l / 16), so the four matrices land as
// a0..a3 of mma16816.  B (two n8k16 tiles from rows = channels): lane l
// names channel l % 8 + 8 * (l / 16) at k offset 8 * ((l / 8) % 2), so the
// registers are b0, b1 of the first tile and b0, b1 of the second.
__device__ __forceinline__ int frag_a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int frag_a_koff(int lane) {
  return (lane >> 4) * 16;
}
__device__ __forceinline__ int frag_b_off(int lane) {
  return ((lane & 7) + 8 * (lane >> 4)) * ROWB + ((lane >> 3) & 1) * 16;
}

// Row m of a block's M -> (sample slot, row, column) where every slot holds
// `per` = rows * W positions.  At a 4x4 plane the 16 rows of an M tile are
// taken as image rows 0, 2, 1, 3: the eight rows one ldmatrix matrix reads
// then sit 0..3 and 12..15 positions apart in the haloed grid (width 6)
// and fall in eight distinct bank groups; in raster order rows 0, 1 would
// collide two by two.
struct RowPos {
  int s, i, j;
};

__device__ __forceinline__ RowPos row_pos(int m, int per, int W) {
  RowPos rp;
  rp.s = m / per;
  const int p = m - rp.s * per;
  if (per == 16 && W == 4) {
    rp.i = ((p >> 2) & 1) * 2 + (p >> 3);
    rp.j = p & 3;
  } else {
    rp.i = p / W;
    rp.j = p - rp.i * W;
  }
  return rp;
}

// Phase time stamp i of the grid's first block (nanoseconds of the card's
// global timer): the profiling tools that split a kernel's time do not run
// everywhere.
__device__ __forceinline__ void stamp(unsigned long long* probe, int i) {
  if (probe != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    probe[i] = now;
  }
}

// ---- 16-byte stores from the accumulator layout ---------------------------
// A thread of an mma tile holds channels 2t, 2t+1 of each of 4 n8 tiles; the
// 4 lanes of a quad exchange them so that lane t holds the 8 channels of
// tile t and stores them as one 16-byte word: a row's four stores then fill
// whole 32-byte sectors, where sixteen 4-byte stores straight from the
// accumulators took three times as long in K1 fwd.

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int k) {
  return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
}

// A 4x4 transpose of 32-bit words across the 4 lanes of a quad: lane t
// gives v[q] and gets v[k] = lane k's v[t].  Every lane of the warp takes
// part.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  uint32_t out[4] = {v[0], v[1], v[2], v[3]};      // out[t] = v[t] stays
#pragma unroll
  for (int d = 1; d < 4; ++d) {
    const uint32_t got = __shfl_xor_sync(0xffffffffu, pick4(v, t ^ d), d);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k == (t ^ d)) out[k] = got;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = out[k];
}

// Zero the first `rows` rows of every stage of a ring (the halos, the rows
// of samples beyond the batch and the rows the dummy M rows read stay zero:
// the copies only ever write positions inside the input).
__device__ __forceinline__ void zero_ring(unsigned char* smem, int stages,
                                          int stage_bytes, int rows) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int s = 0; s < stages; ++s) {
    uint4* p = reinterpret_cast<uint4*>(smem + s * stage_bytes);
    for (int idx = threadIdx.x; idx < rows * (ROWB / 16); idx += blockDim.x)
      p[idx] = z;
  }
}

// ---------------------------------------------------------------------------
// mbarriers, bulk copies and stores into another block's shared memory
// (K2 fused, K1L bwd)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The wait that acquires what the peer block released at cluster scope.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// Arrive on the barrier at the same offset in block `rank` of the cluster,
// releasing this thread's earlier writes (to that block's shared memory
// too) at cluster scope.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, int rank) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The shared::cluster address of shared::cta address `addr` in block `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// 8 bytes to a block's shared memory, counted (complete_tx) on that block's
// mbarrier when they land.
__device__ __forceinline__ void st_async8(uint32_t dst, float a, float b,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}

// 16 bytes to another block's shared memory, counted (complete_tx) on that
// block's mbarrier when they land.
__device__ __forceinline__ void st_async16(uint32_t dst, const uint4& v,
                                           uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

}  // namespace lgt

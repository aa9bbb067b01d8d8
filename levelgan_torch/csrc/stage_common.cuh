// Shared pieces of the upsample-stage kernels (upsample_block.cu,
// upsample_rows.cu): the bf16 tensor-core product and its fragments, the
// asynchronous copies of the staging rings, and the input-gradient GEMM
// that K1 bwd and K1L bwd share.
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
// Backward input gradient of the transposed conv (K1 bwd's second launch,
// K1L bwd)
//
// The exact transpose of the parity form above: with dy_(a,b)[u, v] =
// dy[2u+a, 2v+b] the pre-norm cotangent of output parity (a, b),
//
//     dx[i, j, ci] = sum_{(a,b),r,s,c} dy_(a,b)[i+1-a-r, j+1-b-s, c]
//                                      * w[a+2r, b+2s, ci, c]
//
// (zero outside the plane).  A GEMM with M = B*H*W positions of x, N = Ci
// and K = 16 taps x Co.  A block of 8 warps owns up to MROWS_DX = 128
// positions and NB32 input channels: `nsd` whole samples where a sample has
// at most 128 positions (8 at a 4x4 input, so that the block still has 8
// warps of work and the card as many blocks as B*H*W/128 x Ci/32), else
// `rt` rows of one sample.  Each sample slot has its own parity plane with a
// one-position zero halo in shared memory, so a shifted window never reads
// the neighbouring sample.  Per step (one parity, one chunk of KC32
// cotangent channels) the block needs the plane and the parity's 4 taps;
// steps stream through two buffers filled by cp.async, so the copies of
// step t + 1 run under the products of step t, with one barrier per step
// (on an H100 no shape gained from a deeper ring).  The taps come
// pre-packed (one step of one block is one contiguous 8 KB run), the plane
// through element strides, so the same
// routine serves K1's merged dy [B, 2H, 2W, Co] and K1L's folded dyf
// [B, H, W, 4Co].  Each warp runs one 16-row M tile against 4 n8 tiles with
// ldmatrix fragments (3 ldmatrix.x4 per 4 mma).  With `dgamma` non-null the
// grid's first blocks (one per 256 channels) sum K1's per-sample partials
// s1 / s2 [B, Co] over the batch in index order (dbeta, dgamma) beside the
// GEMM blocks.
// ---------------------------------------------------------------------------

constexpr int MROWS_DX = 128;      // positions (M) per block, at most
constexpr int DX_THREADS = MROWS_DX / 16 * 32;
constexpr int DX_MAXE = 3;         // plane positions a thread copies per step
constexpr int DX_STAGES = 2;       // buffers of the ring

// Rows of the plane ring of one dx block: the haloed sample slots and, where
// the block's M has dummy rows (fewer than MROWS_DX positions), the zero
// rows those read.
__host__ __device__ __forceinline__ int dx_plane_rows(int W, int nsd, int rt) {
  const int zero = nsd * rt * W < MROWS_DX ? 2 * (W + 2) + 3 : 0;
  return nsd * (rt + 2) * (W + 2) + zero;
}

template <bool FOLDED>
__global__ void __launch_bounds__(DX_THREADS)
dx_gather_kernel(const __nv_bfloat16* __restrict__ dy,
                 const __nv_bfloat16* __restrict__ wpk,
                 __nv_bfloat16* __restrict__ dx, const float* __restrict__ s1,
                 const float* __restrict__ s2, float* __restrict__ dgamma,
                 float* __restrict__ dbeta, int B, int H, int W, int Ci,
                 int Co, int nsd, int rt, int nmb, int naff) {
  extern __shared__ __align__(16) unsigned char smem_dx[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // a 1-D grid: first the naff blocks of the batch sums, then the GEMM
  // blocks, M fastest
  if (static_cast<int>(blockIdx.x) < naff) {
    // dbeta = sum_b s1, dgamma = sum_b s2, one thread per channel
    const int c = blockIdx.x * DX_THREADS + tid;
    if (c < Co) {
      float a1 = 0.f, a2 = 0.f;
      for (int b = 0; b < B; ++b) {
        a1 += s1[static_cast<size_t>(b) * Co + c];
        a2 += s2[static_cast<size_t>(b) * Co + c];
      }
      dbeta[c] = a1;
      dgamma[c] = a2;
    }
    return;
  }
  const int gid = blockIdx.x - naff;
  const int by = gid / nmb, bx = gid - by * nmb;

  const int wp = W + 2, per = rt * W, psd = (rt + 2) * wp;
  const int prows = dx_plane_rows(W, nsd, rt);
  const int stage_bytes = (prows + 4 * NB32) * ROWB;
  const int hb = H / rt;
  const int sblk = bx / hb, row0 = (bx - sblk * hb) * rt;
  const int b0 = sblk * nsd, n0 = by * NB32;
  const int mrows = nsd * per;
  const int kcn = Co / KC32, nsteps = 4 * kcn;
  const uint32_t sbase = smem_addr(smem_dx);

  zero_ring(smem_dx, DX_STAGES, stage_bytes, prows);

  // what this thread copies per step: half a channel chunk (32 bytes) of up
  // to DX_MAXE plane positions, and 32 bytes of the taps
  const int crows = rt == H ? H : rt + 2;      // plane rows that hold data
  const int cfirst = rt == H ? 0 : row0 - 1;
  const int ncopy = nsd * crows * W;
  size_t src[DX_MAXE];
  int dst[DX_MAXE];
#pragma unroll
  for (int e = 0; e < DX_MAXE; ++e) {
    const int pidx = (tid >> 1) + e * (DX_THREADS / 2);
    dst[e] = -1;
    src[e] = 0;
    if (pidx < ncopy) {
      const int s = pidx / (crows * W), p = pidx - s * crows * W;
      const int lr = p / W, ic = p - lr * W, ir = cfirst + lr, b = b0 + s;
      if (b < B && ir >= 0 && ir < H) {
        dst[e] = ((s * psd + (ir - row0 + 1) * wp + ic + 1) * LD32 +
                  (tid & 1) * 16) * 2;
        src[e] = FOLDED ? ((static_cast<size_t>(b) * H + ir) * W + ic) * 4 * Co
                        : ((static_cast<size_t>(b) * 2 * H + 2 * ir) * 2 * W +
                           2 * ic) * Co;
        src[e] += (tid & 1) * 16;
      }
    }
  }
  const __nv_bfloat16* wsrc =
      wpk + static_cast<size_t>(by) * nsteps * (4 * NB32 * KC32) + tid * 16;
  const int wdst = prows * ROWB + (tid >> 1) * ROWB + (tid & 1) * 32;

  int it_par = 0, it_kc = 0, it_slot = 0;
  auto queue_next = [&]() {
    if (it_par < 4) {
      const uint32_t base = sbase + it_slot * stage_bytes;
      const int poff = (FOLDED ? it_par * Co
                               : ((it_par >> 1) * 2 * W + (it_par & 1)) * Co) +
                       it_kc * KC32;
#pragma unroll
      for (int e = 0; e < DX_MAXE; ++e) {
        if (dst[e] >= 0) {
          cp_async16(base + dst[e], dy + src[e] + poff);
          cp_async16(base + dst[e] + 16, dy + src[e] + poff + 8);
        }
      }
      const __nv_bfloat16* wc =
          wsrc + static_cast<size_t>(it_par * kcn + it_kc) * (4 * NB32 * KC32);
      cp_async16(base + wdst, wc);
      cp_async16(base + wdst + 16, wc + 8);
      if (++it_kc == kcn) {
        it_kc = 0;
        ++it_par;
      }
    }
    cp_async_commit();   // an empty group keeps the wait's count uniform
    if (++it_slot == DX_STAGES) it_slot = 0;
  };

  __syncthreads();       // the zeros are down before any copy lands
  for (int s = 0; s < DX_STAGES - 1; ++s) queue_next();

  const bool active = warp * 16 < mrows;
  const int m = warp * 16 + frag_a_row(lane);
  int a_off = nsd * psd * ROWB + frag_a_koff(lane);
  if (m < mrows) {
    const RowPos rp = row_pos(m, per, W);
    a_off = (rp.s * psd + rp.i * wp + rp.j) * ROWB + frag_a_koff(lane);
  }
  const int b_off = prows * ROWB + frag_b_off(lane);

  float acc[NB32 / 8][4];
#pragma unroll
  for (int q = 0; q < NB32 / 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;

  int slot = 0, par = 0, kc = 0;
  for (int st = 0; st < nsteps; ++st) {
    // this step's chunk has landed, and every warp is done with the step
    // before it, whose buffer the next copies go into
    cp_async_wait(DX_STAGES - 2);
    __syncthreads();
    queue_next();
    const uint32_t base = sbase + slot * stage_bytes;
    if (++slot == DX_STAGES) slot = 0;
    if (active) {
      const int pa = par >> 1, pb = par & 1;
      const uint32_t xa = base + a_off + ((2 - pa) * wp + 2 - pb) * ROWB;
      const uint32_t wb = base + b_off;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int kk = 0; kk < KC32 * 2; kk += 32) {
            uint32_t a[4], b0r[4], b1r[4];
            ldsm4(a, xa - (r * wp + s) * ROWB + kk);
            ldsm4(b0r, wb + (r * 2 + s) * NB32 * ROWB + kk);
            ldsm4(b1r, wb + ((r * 2 + s) * NB32 + 16) * ROWB + kk);
            mma16816(acc[0], a, b0r[0], b0r[1]);
            mma16816(acc[1], a, b0r[2], b0r[3]);
            mma16816(acc[2], a, b1r[0], b1r[1]);
            mma16816(acc[3], a, b1r[2], b1r[3]);
          }
        }
      }
    }
    if (++kc == kcn) {
      kc = 0;
      ++par;
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int mo = warp * 16 + g + 8 * h;
    const RowPos rp = row_pos(mo, per, W);
    uint32_t v[NB32 / 8];
#pragma unroll
    for (int q = 0; q < NB32 / 8; ++q)
      v[q] = pack_bf16x2(acc[q][2 * h], acc[q][2 * h + 1]);
    quad_transpose(v, t);
    if (mo < mrows && b0 + rp.s < B)
      *reinterpret_cast<uint4*>(
          dx + ((static_cast<size_t>(b0 + rp.s) * H + row0 + rp.i) * W +
                rp.j) * Ci + n0 + 8 * t) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

inline size_t dx_gather_smem(int W, int nsd, int rt) {
  return static_cast<size_t>(DX_STAGES) *
         (dx_plane_rows(W, nsd, rt) + 4 * NB32) * ROWB;
}

// Launch dx_gather_kernel on `stream`.  wpk is the weight packed by steps
// ([Ci/32][parity][Co/32][tap (r, s)][32 ci][32 co] bf16).  The caller
// checks the shape rules: Ci % 32 == 0, Co % 32 == 0, nsd * rt * W <=
// MROWS_DX, H % rt == 0, nsd == 1 unless rt == H, and the shared memory of
// dx_gather_smem within the card's limit.  s1, s2, dgamma, dbeta may all be
// null.  Returns the launch's error.
template <bool FOLDED>
cudaError_t launch_dx_gather(const void* dy, const void* wpk, void* dx,
                             const void* s1, const void* s2, void* dgamma,
                             void* dbeta, int B, int H, int W, int Ci, int Co,
                             int nsd, int rt, cudaStream_t stream) {
  const size_t smem = dx_gather_smem(W, nsd, rt);
  cudaError_t err = cudaFuncSetAttribute(
      dx_gather_kernel<FOLDED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nmb = ((B + nsd - 1) / nsd) * (H / rt);
  const int naff = dgamma != nullptr ? (Co + DX_THREADS - 1) / DX_THREADS : 0;
  dx_gather_kernel<FOLDED><<<naff + nmb * (Ci / NB32), DX_THREADS, smem,
                             stream>>>(
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(wpk), static_cast<__nv_bfloat16*>(dx),
      static_cast<const float*>(s1), static_cast<const float*>(s2),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), B, H, W, Ci,
      Co, nsd, rt, nmb, naff);
  return cudaGetLastError();
}

}  // namespace lgt

// K1: fused ConvTranspose(4x4, s2, SAME) + GroupNorm + LeakyReLU, forward
// and backward.
//
// The forward replaces levelgan/kernels/upsample_block.py:_forward (the
// Pallas call at :304), the monolithic-spatial stage kernel of the JAX
// package; the backward replaces _backward (the Pallas call at :462).
//
// Forward.  A block owns NS samples x NB32 = 32 output channels (NG = 32 /
// gs GroupNorm groups), every output position of those samples: per parity
// a GEMM with M = NS*H*W (at most 256), N = 32, K = 4 taps x Ci.  Each of
// its 4 * M / 64 warps holds one (parity, 64-row, 32-channel) tile as 64 f32
// mma.sync accumulators, so the whole pre-norm tile of the (sample, group)s
// stays in registers, the GroupNorm statistics are a reduction inside the
// block and the normalise + affine + LeakyReLU epilogue runs before the one
// bf16 store: the pre-norm tile never touches device memory.
//
// What bounds it on an H100: at the gumbel_64 export stages (B = 1024) the
// conv is 68.7 GFLOP per stage against 50-200 MB of traffic, so the tensor
// cores (989 TF/s bf16) bound it, not device memory.  What held the first
// version (one block per (sample, group), 16x16 warp tiles, single-buffered
// staging) was inside the SM: every block re-staged its group's 16 taps, so
// a 4 MB weight cost 4.3 GB of L2 -> shared traffic per call at the 4x4
// stage, the copies and the products took turns, and a 16x16 warp tile
// reads 512 bytes of fragments per mma.  This design:
//  - shares the staged taps across the block's NS samples (16 at 4x4, 4 at
//    8x8): the L2 -> shared traffic falls by NS;
//  - streams chunks of KC32 = 32 input channels through a ring of 2 or 3
//    buffers filled by cp.async, one barrier per chunk, so the copies of
//    chunk c + stages - 1 run under the products of chunk c; the wrapper
//    pre-packs the taps so that one chunk of one block is one contiguous
//    32 KB run;
//  - uses 64x32 warp tiles fed by ldmatrix: 6 ldmatrix.x4 per 16 mma, 192
//    bytes of shared memory per mma instead of 512.
// Each sample keeps its own zero halo in shared memory ((H+2)(W+2) positions
// per sample), samples beyond a ragged batch stay zero and are never
// stored.  The statistics are reduced registers -> warp -> a per-(parity, M
// tile, group) slot in shared memory -> per (sample, group) in a fixed
// order: no atomics, so two calls give the same bits.  The epilogue
// exchanges channels inside each quad of lanes so that every store is 16
// bytes and a row's four stores fill whole sectors: with 4-byte stores
// straight from the accumulator layout the stores took as long as half the
// products at the 4x4 stage and twice the products at 16x16.
//
// Fits when H * W <= 256 and H * W % 16 == 0: then at least one whole
// sample fits the 256-row M of a block.

#include "stage_common.cuh"

namespace lgt {

// ---------------------------------------------------------------------------
// Backward input gradient of the transposed conv (K1 bwd's second launch)
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
// through element strides from the merged dy [B, 2H, 2W, Co].  Each warp
// runs one 16-row M tile against 4 n8 tiles with
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
        src[e] = ((static_cast<size_t>(b) * 2 * H + 2 * ir) * 2 * W + 2 * ic) *
                     Co + (tid & 1) * 16;
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
      const int poff =
          ((it_par >> 1) * 2 * W + (it_par & 1)) * Co + it_kc * KC32;
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
inline cudaError_t launch_dx_gather(const void* dy, const void* wpk, void* dx,
                             const void* s1, const void* s2, void* dgamma,
                             void* dbeta, int B, int H, int W, int Ci, int Co,
                             int nsd, int rt, cudaStream_t stream) {
  const size_t smem = dx_gather_smem(W, nsd, rt);
  cudaError_t err = cudaFuncSetAttribute(
      dx_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nmb = ((B + nsd - 1) / nsd) * (H / rt);
  const int naff = dgamma != nullptr ? (Co + DX_THREADS - 1) / DX_THREADS : 0;
  dx_gather_kernel<<<naff + nmb * (Ci / NB32), DX_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(wpk), static_cast<__nv_bfloat16*>(dx),
      static_cast<const float*>(s1), static_cast<const float*>(s2),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), B, H, W, Ci,
      Co, nsd, rt, nmb, naff);
  return cudaGetLastError();
}

}  // namespace lgt

namespace {

using lgt::KC32;
using lgt::LD32;
using lgt::NB32;
using lgt::ROWB;

constexpr int FWD_WM = 64;       // rows of a warp tile (4 m16 tiles)
constexpr int FWD_MAXM = 256;    // rows per parity per block, at most
constexpr int FWD_MAXW = 4 * FWD_MAXM / FWD_WM;   // warps per block, at most
constexpr int FWD_MAXMT = FWD_MAXM / 16;          // m16 tiles per parity
constexpr int FWD_MAXS = 16;     // samples per block, at most
constexpr int FWD_MAXG = 4;      // GroupNorm groups per block (gs = 8)
constexpr int FWD_TAIL = (2 * 4 * FWD_MAXMT * 4 + FWD_MAXS * FWD_MAXG * 2) *
                         static_cast<int>(sizeof(float));

// Rows of the input ring of one block, the zero rows that dummy M rows read
// included.
__host__ __device__ inline int fwd_x_rows(int H, int W, int NS) {
  return NS * (H + 2) * (W + 2) + 2 * (W + 2) + 3;
}

__global__ void __launch_bounds__(FWD_MAXW * 32, 1)
upsample_block_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ wpk,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          __nv_bfloat16* __restrict__ y,
                          __nv_bfloat16* __restrict__ ypre,
                          float* __restrict__ mu_out,
                          float* __restrict__ rstd_out, int B, int H, int W,
                          int Ci, int Co, int gs, int NS, int MP, int stages,
                          float slope, float eps,
                          unsigned long long* probe) {
  extern __shared__ __align__(16) unsigned char smem[];
  lgt::stamp(probe, 0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HW = H * W, wp = W + 2, PS = (H + 2) * wp;
  const int xrows = fwd_x_rows(H, W, NS);
  const int stage_bytes = (xrows + 16 * NB32) * ROWB;
  float* red1 = reinterpret_cast<float*>(smem + stages * stage_bytes);
  float* red2 = red1 + 4 * FWD_MAXMT * 4;
  float* stat = red2 + 4 * FWD_MAXMT * 4;      // [sample][group] mean, rstd
  const int n0 = blockIdx.x * NB32, b0 = blockIdx.y * NS;
  const int nchunks = Ci / KC32, mrows = NS * HW;
  const uint32_t sbase = lgt::smem_addr(smem);

  lgt::zero_ring(smem, stages, stage_bytes, xrows);

  // what this thread copies per chunk: half a channel chunk (32 bytes) of
  // input position tid / 2 (raster order), and its share of the 32 KB of taps
  int xdst = -1;
  const __nv_bfloat16* xsrc = x;
  {
    const int mc = tid >> 1, s = mc / HW, p = mc - s * HW;
    if (mc < mrows && b0 + s < B) {
      const int i = p / W, j = p - i * W;
      xdst = ((s * PS + (i + 1) * wp + j + 1) * LD32 + (tid & 1) * 16) * 2;
      xsrc = x + (static_cast<size_t>(b0 + s) * HW + p) * Ci + (tid & 1) * 16;
    }
  }
  const __nv_bfloat16* wsrc =
      wpk + static_cast<size_t>(blockIdx.x) * nchunks * (16 * NB32 * KC32);
  const int wdst = xrows * ROWB;

  int it_c = 0, it_slot = 0;
  auto queue_next = [&]() {
    if (it_c < nchunks) {
      const uint32_t base = sbase + it_slot * stage_bytes;
      if (xdst >= 0) {
        lgt::cp_async16(base + xdst, xsrc + it_c * KC32);
        lgt::cp_async16(base + xdst + 16, xsrc + it_c * KC32 + 8);
      }
      const __nv_bfloat16* wc =
          wsrc + static_cast<size_t>(it_c) * (16 * NB32 * KC32);
      for (int idx = tid; idx < 16 * NB32 * (KC32 / 8); idx += blockDim.x)
        lgt::cp_async16(base + wdst + (idx >> 2) * ROWB + (idx & 3) * 16,
                        wc + idx * 8);
    }
    ++it_c;
    lgt::cp_async_commit();   // an empty group keeps the wait's count uniform
    if (++it_slot == stages) it_slot = 0;
  };

  __syncthreads();            // the zeros are down before any copy lands
  for (int s = 0; s < stages - 1; ++s) queue_next();

  // this warp's tile: parity par, rows mt * 64 .. + 64 of the parity's M
  const int mtn = MP / FWD_WM;
  const int par = warp / mtn, mt = warp - par * mtn;
  const int pa = par >> 1, pb = par & 1;
  int a_off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = mt * FWD_WM + 16 * i + lgt::frag_a_row(lane);
    int pos = NS * PS;                        // a dummy row reads zeros
    if (m < mrows) {
      const lgt::RowPos rp = lgt::row_pos(m, HW, W);
      pos = rp.s * PS + (rp.i + pa) * wp + rp.j + pb;
    }
    a_off[i] = pos * ROWB + lgt::frag_a_koff(lane);
  }
  const int b_off = wdst + lgt::frag_b_off(lane);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;

  int slot = 0;
  lgt::stamp(probe, 1);
  for (int c = 0; c < nchunks; ++c) {
    // this chunk has landed, and every warp is done with the chunk before
    // it, whose buffer the next copies go into
    lgt::cp_async_wait(stages - 2);
    __syncthreads();
    queue_next();
    const uint32_t base = sbase + slot * stage_bytes;
    if (++slot == stages) slot = 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t xa = base + (r * wp + s) * ROWB;
        const uint32_t wb =
            base + b_off + ((pa + 2 * r) * 4 + pb + 2 * s) * NB32 * ROWB;
#pragma unroll
        for (int kk = 0; kk < KC32 * 2; kk += 32) {
          uint32_t a[4][4], b[2][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) lgt::ldsm4(a[i], xa + a_off[i] + kk);
          lgt::ldsm4(b[0], wb + kk);
          lgt::ldsm4(b[1], wb + 16 * ROWB + kk);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              lgt::mma16816(acc[i][q], a[i], b[q >> 1][(q & 1) * 2],
                            b[q >> 1][(q & 1) * 2 + 1]);
        }
      }
    }
  }

  lgt::stamp(probe, 2);
  // ---- GroupNorm statistics per (sample, group), in f32, fixed order ------
  // registers -> warp -> one slot per (parity, m16 tile, group) -> a few
  // lanes per (sample, group) that sum their slots in index order
  const int ngb = NB32 / gs, nq = gs / 8, tps = HW / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int gq = 0; gq < FWD_MAXG; ++gq) {
      if (gq < ngb) {
        float v1 = 0.f, v2 = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if ((q >> (nq - 1)) == gq) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              v1 += acc[i][q][e];
              v2 += acc[i][q][e] * acc[i][q][e];
            }
          }
        }
        v1 = lgt::warp_sum(v1);
        v2 = lgt::warp_sum(v2);
        if (lane == 0) {
          const int slot_i = (par * FWD_MAXMT + mt * 4 + i) * FWD_MAXG + gq;
          red1[slot_i] = v1;
          red2[slot_i] = v2;
        }
      }
    }
  }
  __syncthreads();
  {
    const int nsg = NS * ngb;               // (sample, group)s of the block
    int lpg = 32;                           // lanes per (sample, group)
    while (lpg * nsg > static_cast<int>(blockDim.x)) lpg >>= 1;
    const int sg = tid / lpg, l = tid - sg * lpg;
    const int s = sg / ngb, gq = sg - s * ngb;
    float a1 = 0.f, a2 = 0.f;
    if (sg < nsg) {
      for (int idx = l; idx < 4 * tps; idx += lpg) {
        const int p = idx / tps, k = idx - p * tps;
        const int slot_i = (p * FWD_MAXMT + s * tps + k) * FWD_MAXG + gq;
        a1 += red1[slot_i];
        a2 += red2[slot_i];
      }
    }
    for (int o = lpg >> 1; o > 0; o >>= 1) {
      a1 += __shfl_xor_sync(0xffffffffu, a1, o);
      a2 += __shfl_xor_sync(0xffffffffu, a2, o);
    }
    if (sg < nsg && l == 0) {
      const float cnt = 4.f * HW * gs;
      const float mean = a1 / cnt;
      const float var = fmaxf(a2 / cnt - mean * mean, 0.f);
      stat[(s * FWD_MAXG + gq) * 2] = mean;
      stat[(s * FWD_MAXG + gq) * 2 + 1] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  if (mu_out != nullptr) {
    for (int idx = tid; idx < NS * NB32; idx += blockDim.x) {
      const int s = idx >> 5, cc = idx & 31;
      if (b0 + s < B && n0 + cc < Co) {
        const size_t o = static_cast<size_t>(b0 + s) * Co + n0 + cc;
        mu_out[o] = stat[(s * FWD_MAXG + cc / gs) * 2];
        rstd_out[o] = stat[(s * FWD_MAXG + cc / gs) * 2 + 1];
      }
    }
  }

  lgt::stamp(probe, 3);
  // ---- normalise + affine + LeakyReLU, interleave parities, store bf16 ----
  // A thread holds channels 2t, 2t+1 of each of the 4 n8 tiles; the 4 lanes
  // of a quad exchange them so that lane t holds the 8 channels of tile t
  // and stores them as one 16-byte word: a row of the block is then four
  // such stores side by side (whole 32-byte sectors), not sixteen 4-byte
  // ones.
  const int g = lane >> 2, t = lane & 3;
  const int H2 = 2 * H, W2 = 2 * W;
  float ga[4][2], be[4][2];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n0 + q * 8 + 2 * t + e;
      ga[q][e] = c < Co ? gamma[c] : 0.f;
      be[q][e] = c < Co ? beta[c] : 0.f;
    }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * FWD_WM + 16 * i + g + 8 * h;
      const lgt::RowPos rp = lgt::row_pos(m, HW, W);
      uint32_t vy[4], vp[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* st = stat + (rp.s * FWD_MAXG + q * 8 / gs) * 2;
        const float mean = st[0], rstd = st[1];
        const float s0 = ga[q][0] * rstd, s1 = ga[q][1] * rstd;
        float v0 = acc[i][q][2 * h] * s0 + (be[q][0] - mean * s0);
        float v1 = acc[i][q][2 * h + 1] * s1 + (be[q][1] - mean * s1);
        v0 = v0 >= 0.f ? v0 : slope * v0;
        v1 = v1 >= 0.f ? v1 : slope * v1;
        vy[q] = lgt::pack_bf16x2(v0, v1);
        vp[q] = lgt::pack_bf16x2(acc[i][q][2 * h], acc[i][q][2 * h + 1]);
      }
      lgt::quad_transpose(vy, t);
      if (ypre != nullptr) lgt::quad_transpose(vp, t);
      if (m < mrows && b0 + rp.s < B && n0 + 8 * t < Co) {
        const size_t o = ((static_cast<size_t>(b0 + rp.s) * H2 + 2 * rp.i +
                           pa) * W2 + 2 * rp.j + pb) * Co + n0 + 8 * t;
        *reinterpret_cast<uint4*>(y + o) =
            make_uint4(vy[0], vy[1], vy[2], vy[3]);
        if (ypre != nullptr)
          *reinterpret_cast<uint4*>(ypre + o) =
              make_uint4(vp[0], vp[1], vp[2], vp[3]);
      }
    }
  }
  lgt::stamp(probe, 4);
}

}  // namespace

// Dynamic shared memory of one forward block.
extern "C" size_t upsample_block_fwd_smem(int H, int W, int NS, int stages) {
  return static_cast<size_t>(stages) * (fwd_x_rows(H, W, NS) + 16 * NB32) *
             ROWB + FWD_TAIL;
}

// x [B,H,W,Ci] bf16, wpk [ceil(Co/32)][Ci/32][16][32][32] bf16 (tap = kh*4 +
// kw of the HWIO weight, channels beyond Co zero), gamma/beta [Co] f32 -> y
// [B,2H,2W,Co] bf16.  With residuals (ypre non-null) also the pre-norm conv
// output ypre [B,2H,2W,Co] bf16 and the per-(sample, channel) GroupNorm mean
// / rstd mu, rstd [B,Co] f32, as _forward(..., residuals=True) emits them.
// A block takes NS samples, MP = NS * H * W rounded up to 64 rows per parity
// and a ring of `stages` chunks.  The caller checks the shape rules: Ci %
// 32 == 0, gs in {8, 16}, Co % gs == 0, H * W % 16 == 0, MP <= 256, NS <=
// 16, 2 <= stages <= 3 and the shared memory of upsample_block_fwd_smem
// within the card's limit.  `probe`, where not null, receives 5 time stamps
// of the first block's first thread: start, before and after the main loop,
// after the statistics, after its stores.  Returns cudaGetLastError().
extern "C" int upsample_block_fwd(const void* x, const void* wpk,
                                  const void* gamma, const void* beta, void* y,
                                  void* ypre, void* mu, void* rstd, int B,
                                  int H, int W, int Ci, int Co, int gs, int NS,
                                  int stages, float slope, float eps,
                                  void* probe, void* stream) {
  const int MP = (NS * H * W + FWD_WM - 1) / FWD_WM * FWD_WM;
  const size_t smem = upsample_block_fwd_smem(H, W, NS, stages);
  cudaError_t err = cudaFuncSetAttribute(
      upsample_block_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Co + NB32 - 1) / NB32, (B + NS - 1) / NS);
  upsample_block_fwd_kernel<<<grid, 4 * MP / FWD_WM * 32, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wpk),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(ypre),
      static_cast<float*>(mu), static_cast<float*>(rstd), B, H, W, Ci, Co, gs,
      NS, MP, stages, slope, eps, static_cast<unsigned long long*>(probe));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K1 backward: LeakyReLU bwd -> GroupNorm bwd -> dx, plus dgamma / dbeta and
// the pre-norm cotangent dy (from which the caller forms dw).
//
// The dx contraction runs over all Co, across GroupNorm groups, so the
// forward's (samples, groups) ownership cannot carry the whole op.  Two
// launches on one stream, each its own C function so that each can be timed:
//   (a) upsample_block_bwd_gn, one block per (sample, group): the slab of g
//       and ypre (4HW positions x gs channels) is read once (16-byte loads,
//       8 channels a thread, at the large slabs) and kept in registers; from
//       ypre / mu /
//       rstd the block recomputes xn, the affine output and the LeakyReLU
//       mask, reduces per channel s1 = sum dout and s2 = sum dout * xn
//       (registers -> warp shuffles -> shared memory, fixed order, no
//       atomics), then writes dy = rstd * (dout * gamma - mean_g(dout *
//       gamma) - xn * mean_g(dout * gamma * xn)) in bf16 and s1 / s2 [B, Co];
//   (b) upsample_block_bwd_dx: dx as the gather GEMM above
//       (dx_gather_kernel) over the merged dy, M running over B*H*W so that
//       a 4x4 input still gives blocks of 8 warps; the grid's first
//       block(s) sum dgamma = sum_b s2 and dbeta = sum_b s1 in index order
//       beside the GEMM.
// All sums are deterministic.  What bounds it on an H100 at gumbel_64
// training (B = 64): 32*B*H*W*Ci*Co = 4.29 GFLOP per stage for dx, so the
// tensor cores at up0, and the g, ypre, dy and dx traffic at up1 (~16 MB)
// and up2 (~29 MB).  The first version tiled the dx GEMM's M inside one
// sample: one warp per block at a 4x4 input, 32 single-buffered steps with
// two barriers each, and 92% of the call's time.
// ---------------------------------------------------------------------------

namespace {

constexpr int GN_THREADS = 512;  // at most

// CH bf16 values (8 or 16 bytes) as floats.
template <int CH>
struct GnVec;
template <>
struct GnVec<8> {
  using type = uint4;
};
template <>
struct GnVec<4> {
  using type = uint2;
};

template <int CH>
__device__ __forceinline__ void unpack(const typename GnVec<CH>::type& v,
                                       float (&f)[CH]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < CH / 2; ++k) {
    const float2 p = __bfloat1622float2(h[k]);
    f[2 * k] = p.x;
    f[2 * k + 1] = p.y;
  }
}

// A thread owns CH channels of up to V positions.  <8, 4> (16-byte loads)
// takes the large slabs; <4, 2> keeps a thread under 64 registers, so the
// many small blocks of a 4x4 or 8x8 stage fill the SMs.
template <int CH, int V>
__global__ void __launch_bounds__(GN_THREADS, CH == 4 ? 2 : 1)
k1_bwd_gn_kernel(const __nv_bfloat16* __restrict__ g,
                 const __nv_bfloat16* __restrict__ ypre,
                 const float* __restrict__ mu, const float* __restrict__ rstd,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta,
                 __nv_bfloat16* __restrict__ dy, float* __restrict__ s1o,
                 float* __restrict__ s2o, int P, int Co, int gs,
                 float slope) {
  using Vec = typename GnVec<CH>::type;
  __shared__ float r1[GN_THREADS / 32][16], r2[GN_THREADS / 32][16];
  __shared__ float ag[2][16];
  __shared__ float gm[2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarp = blockDim.x >> 5;
  const int vpr = gs / CH;                // vectors per position: 1, 2 or 4
  const int cv = tid & (vpr - 1);         // this thread's CH channels
  const int n0 = blockIdx.x * gs + cv * CH, b = blockIdx.y;
  const int nvec = P * vpr;
  const size_t bc = static_cast<size_t>(b) * Co + n0;
  const size_t base = static_cast<size_t>(b) * P * Co + n0;

  float rs[CH], mrs[CH], ga[CH], be[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    rs[k] = rstd[bc + k];
    mrs[k] = mu[bc + k] * rs[k];
    ga[k] = gamma[n0 + k];
    be[k] = beta[n0 + k];
  }

  Vec gv[V], yv[V];
  float s1[CH], s2[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) s1[k] = s2[k] = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int idx = tid + v * blockDim.x;
    gv[v] = yv[v] = Vec{};
    if (idx < nvec) {
      const size_t o = base + static_cast<size_t>(idx / vpr) * Co;
      gv[v] = *reinterpret_cast<const Vec*>(g + o);
      yv[v] = *reinterpret_cast<const Vec*>(ypre + o);
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (tid + v * blockDim.x < nvec) {
      float gf[CH], yf[CH];
      unpack<CH>(gv[v], gf);
      unpack<CH>(yv[v], yf);
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const float xn = yf[k] * rs[k] - mrs[k];
        const float dout = xn * ga[k] + be[k] >= 0.f ? gf[k] : slope * gf[k];
        s1[k] += dout;
        s2[k] += dout * xn;
      }
    }
  }
  // lanes with the same channels: every vpr-th lane
#pragma unroll
  for (int k = 0; k < CH; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o >= vpr) {
        s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], o);
        s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], o);
      }
    }
  }
  if (lane < vpr) {
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      r1[warp][lane * CH + k] = s1[k];
      r2[warp][lane * CH + k] = s2[k];
    }
  }
  __syncthreads();
  if (tid < gs) {
    float a1 = 0.f, a2 = 0.f;
    for (int w = 0; w < nwarp; ++w) {
      a1 += r1[w][tid];
      a2 += r2[w][tid];
    }
    const int c = blockIdx.x * gs + tid;
    s1o[static_cast<size_t>(b) * Co + c] = a1;
    s2o[static_cast<size_t>(b) * Co + c] = a2;
    ag[0][tid] = a1 * gamma[c];
    ag[1][tid] = a2 * gamma[c];
  }
  __syncthreads();
  if (tid == 0) {
    float a1 = 0.f, a2 = 0.f;
    for (int k = 0; k < gs; ++k) {
      a1 += ag[0][k];
      a2 += ag[1][k];
    }
    const float cnt = static_cast<float>(P) * gs;
    gm[0] = a1 / cnt;
    gm[1] = a2 / cnt;
  }
  __syncthreads();
  const float m1 = gm[0], m2 = gm[1];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int idx = tid + v * blockDim.x;
    if (idx < nvec) {
      float gf[CH], yf[CH];
      unpack<CH>(gv[v], gf);
      unpack<CH>(yv[v], yf);
      Vec out;
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int k = 0; k < CH; k += 2) {
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xn = yf[k + e] * rs[k + e] - mrs[k + e];
          const float dout = xn * ga[k + e] + be[k + e] >= 0.f
                                 ? gf[k + e] : slope * gf[k + e];
          d[e] = rs[k + e] * (dout * ga[k + e] - m1 - xn * m2);
        }
        oh[k / 2] = __floats2bfloat162_rn(d[0], d[1]);
      }
      *reinterpret_cast<Vec*>(dy + base +
                              static_cast<size_t>(idx / vpr) * Co) = out;
    }
  }
}

template <int CH, int V>
cudaError_t launch_gn(const void* g, const void* ypre, const void* mu,
                      const void* rstd, const void* gamma, const void* beta,
                      void* dy, void* s1, void* s2, int B, int P, int Co,
                      int gs, float slope, cudaStream_t stream) {
  const int nvec = P * gs / CH;
  if (nvec > V * GN_THREADS) return cudaErrorInvalidValue;
  int threads = (nvec + 31) / 32 * 32;   // one vector a thread where it fits
  if (threads > GN_THREADS) threads = GN_THREADS;
  k1_bwd_gn_kernel<CH, V><<<dim3(Co / gs, B), threads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(ypre), static_cast<const float*>(mu),
      static_cast<const float*>(rstd), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(dy),
      static_cast<float*>(s1), static_cast<float*>(s2), P, Co, gs, slope);
  return cudaGetLastError();
}

}  // namespace

// (a) g, ypre [B,2H,2W,Co] bf16, mu / rstd [B,Co] f32, gamma / beta [Co] f32
// -> dy [B,2H,2W,Co] bf16, s1 / s2 [B,Co] f32.  The caller checks the shape
// rules: gs in {8, 16}, Co % gs == 0, Co % 8 == 0 and 4 * H * W * gs <=
// 16384.  Returns cudaGetLastError().
extern "C" int upsample_block_bwd_gn(const void* g, const void* ypre,
                                     const void* mu, const void* rstd,
                                     const void* gamma, const void* beta,
                                     void* dy, void* s1, void* s2, int B,
                                     int H, int W, int Co, int gs,
                                     float slope, void* stream) {
  const int P = 4 * H * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P * gs <= 4 * 2 * GN_THREADS)
    return static_cast<int>(launch_gn<4, 2>(g, ypre, mu, rstd, gamma, beta,
                                            dy, s1, s2, B, P, Co, gs, slope,
                                            st));
  return static_cast<int>(launch_gn<8, 4>(g, ypre, mu, rstd, gamma, beta, dy,
                                          s1, s2, B, P, Co, gs, slope, st));
}

// (b) dy [B,2H,2W,Co] bf16, wpk (pack_taps_dx) bf16, s1 / s2 [B,Co] f32 ->
// dx [B,H,W,Ci] bf16, dgamma / dbeta [Co] f32.  The caller checks the shape
// rules of launch_dx_gather.  Returns cudaGetLastError().
extern "C" int upsample_block_bwd_dx(const void* dy, const void* wpk,
                                     const void* s1, const void* s2,
                                     void* dgamma, void* dbeta, void* dx,
                                     int B, int H, int W, int Ci, int Co,
                                     int nsd, int rt, void* stream) {
  return static_cast<int>(lgt::launch_dx_gather(
      dy, wpk, dx, s1, s2, dgamma, dbeta, B, H, W, Ci, Co, nsd, rt,
      static_cast<cudaStream_t>(stream)));
}

// K1L: the whole late upsample stage in one launch (ConvTranspose 4x4 / s2
// SAME, GroupNorm, affine, LeakyReLU, depth-to-space), and K1L backward:
// the input gradient from the folded cotangent.
//
// The forward replaces levelgan/kernels/upsample_rows.py:_conv_fwd (the
// Pallas call at :253) together with the XLA pass that follows it in
// _forward_rows (:382-395: GroupNorm from the kernel's sums, affine,
// LeakyReLU, unfold); the backward replaces _conv_bwd (:323).
//
// Forward design.  A block owns rt = 128 / W input rows of one sample and
// 32 output channels, all four parities: per parity a GEMM with M = 128
// positions, N = 32, K = 4 taps x Ci, each of its 8 warps one (parity, 64
// rows, 32 channels) tile of mma.sync accumulators fed by ldmatrix (as K1
// fwd).  GroupNorm needs the whole sample's sums, which a block does not
// have: the H / rt blocks of one (sample, channel block) form a thread-block
// cluster (8 at gumbel_64 up3).  Each block reduces its partial channel sums
// in a fixed order (registers -> warp shuffle -> one slot per warp, summed
// in warp order), publishes them in its shared memory and meets the others
// at a cluster barrier; then every block reads all ranks' partials through
// distributed shared memory in rank order 0..n-1, so every block and every
// run gets the same mean / rstd bits (no atomics, no zeroed buffers).  The
// block normalises its accumulators still in registers, applies the affine
// and LeakyReLU, stages the bf16 tile in the unfolded order through shared
// memory and stores it with 16-byte lanes: with 32 output channels a
// block's output is one contiguous 32 KB run.  The folded pre-norm conv
// output never reaches device memory, except in training (residual mode),
// where yf [B, H, W, 4Co] bf16 and mu / rstd [B, Co] f32 are stored for
// the backward, as _forward_rows returns them.
//
// The clusters are persistent: the grid holds as many as can be resident
// (cudaOccupancyMaxActiveClusters), each walks over samples, and a block
// stages its 16 taps x 32 channels x Ci once for the whole call instead of
// once per sample.  The input rows stream through a ring of chunks of 32
// input channels filled by cp.async, so the next sample's rows arrive under
// the current sample's epilogue.  The partials are double-buffered by
// sample, so one cluster barrier per sample suffices, and one more before
// exit keeps every block's shared memory alive while others read it.
//
// What bounds it on an H100 at gumbel_64 up3 (B = 1024): 68.7 GFLOP (69 us
// at 989 TF/s) against 134 MB of x in and 268 MB of y out (120 us at 3.35
// TB/s): the bytes.  Unlike the TPU kernel it multiplies no structured
// zeros: each parity takes only its own 4 taps.

#include <cooperative_groups.h>

#include "stage_common.cuh"

namespace cg = cooperative_groups;

namespace {

using lgt::KC32;
using lgt::NB32;
using lgt::ROWB;

constexpr int NW = 8;                    // warps per block
constexpr int THREADS = NW * 32;
constexpr int MROWS = 128;               // positions per parity per block
constexpr int TAP_ROWS = 16 * NB32;      // staged rows of one chunk of taps
constexpr int YS_BYTES = 4 * MROWS * NB32 * 2;   // the block's bf16 tile
constexpr int MAX_CLUSTER = 8;           // portable cluster size
// warp partials [NW][2][32], cluster partials [2 buffers][2][32], the
// sample's mean / rstd [2][32]
constexpr int TAIL = (NW * 2 + 4 + 2) * NB32 * static_cast<int>(sizeof(float));

__host__ __device__ inline int x_rows(int W) {
  return (MROWS / W + 2) * (W + 2);
}

__global__ void __launch_bounds__(THREADS, 1)
upsample_rows_stage_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ wpk,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           __nv_bfloat16* __restrict__ y,
                           __nv_bfloat16* __restrict__ yf,
                           float* __restrict__ mu_out,
                           float* __restrict__ rstd_out, int B, int H, int W,
                           int Ci, int Co, int gs, int stages, float slope,
                           float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rt = MROWS / W, wp = W + 2, row0 = rank * rt;
  const int nchunks = Ci / KC32, ncb = Co / NB32;
  const int stage_bytes = x_rows(W) * ROWB;
  unsigned char* ring = smem + nchunks * TAP_ROWS * ROWB;
  unsigned char* ys = ring + stages * stage_bytes;
  float* red = reinterpret_cast<float*>(ys + YS_BYTES);   // [NW][2][32]
  float* cpart = red + NW * 2 * NB32;                      // [2][2][32]
  float* stat = cpart + 4 * NB32;                          // [2][32]
  const uint32_t tbase = lgt::smem_addr(smem);
  const uint32_t rbase = lgt::smem_addr(ring);

  // this cluster's channel block and samples first, first + cpc, ...
  const int cid = blockIdx.x / csize, cpc = gridDim.x / csize / ncb;
  const int nb = cid % ncb, n0 = nb * NB32, first = cid / ncb;
  const int nsamp = first < B ? (B - 1 - first) / cpc + 1 : 0;

  lgt::zero_ring(ring, stages, stage_bytes, x_rows(W));
  __syncthreads();            // the zeros are down before any copy lands

  // the taps of this channel block, all Ci, staged once: one group older
  // than every input chunk, so the first chunk's wait covers them
  {
    const __nv_bfloat16* wsrc =
        wpk + static_cast<size_t>(nb) * nchunks * (TAP_ROWS * KC32);
    for (int idx = tid; idx < nchunks * TAP_ROWS * (KC32 / 8);
         idx += THREADS)
      lgt::cp_async16(tbase + (idx >> 2) * ROWB + (idx & 3) * 16,
                      wsrc + idx * 8);
    lgt::cp_async_commit();
  }

  // input rows inside the image: the halo rows outside it and the halo
  // columns are never written and stay zero
  const int rfirst = max(row0 - 1, 0);
  const int ncopy = (min(row0 + rt, H - 1) - rfirst + 1) * W * (KC32 / 8);
  int it_k = 0, it_c = 0, it_slot = 0;
  auto queue_next = [&]() {
    if (it_k < nsamp) {
      const uint32_t base = rbase + it_slot * stage_bytes;
      const __nv_bfloat16* xs =
          x + static_cast<size_t>(first + it_k * cpc) * H * W * Ci +
          it_c * KC32;
      for (int idx = tid; idx < ncopy; idx += THREADS) {
        const int p = idx >> 2, v = idx & 3;
        const int lr = p / W, ic = p - lr * W, ir = rfirst + lr;
        lgt::cp_async16(
            base + ((ir - row0 + 1) * wp + ic + 1) * ROWB + v * 16,
            xs + (static_cast<size_t>(ir) * W + ic) * Ci + v * 8);
      }
      if (++it_c == nchunks) {
        it_c = 0;
        ++it_k;
      }
    }
    lgt::cp_async_commit();   // an empty group keeps the wait's count uniform
    if (++it_slot == stages) it_slot = 0;
  };
  for (int s = 0; s < stages - 1; ++s) queue_next();

  // this warp's tile: parity par, rows mt * 64 .. + 64 of the parity's M
  const int par = warp >> 1, mt = warp & 1;
  const int pa = par >> 1, pb = par & 1;
  int a_off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = mt * 64 + 16 * i + lgt::frag_a_row(lane);
    const int il = m / W, j = m - il * W;
    a_off[i] = ((il + pa) * wp + j + pb) * ROWB + lgt::frag_a_koff(lane);
  }
  const uint32_t b_off = tbase + lgt::frag_b_off(lane);

  const int g = lane >> 2, t = lane & 3;
  float ga[4][2], be[4][2];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ga[q][e] = gamma[n0 + q * 8 + 2 * t + e];
      be[q][e] = beta[n0 + q * 8 + 2 * t + e];
    }
  const float cnt = 4.f * H * W * gs;

  int slot = 0;
  for (int k = 0; k < nsamp; ++k) {
    const int b = first + k * cpc;
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;

    for (int c = 0; c < nchunks; ++c) {
      // this chunk has landed, and every warp is done with the step before
      // it, whose buffer the next copies go into
      lgt::cp_async_wait(stages - 2);
      __syncthreads();
      queue_next();
      const uint32_t base = rbase + slot * stage_bytes;
      if (++slot == stages) slot = 0;
      const uint32_t tb = b_off + c * TAP_ROWS * ROWB;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint32_t xa = base + (r * wp + s) * ROWB;
          const uint32_t wb = tb + ((pa + 2 * r) * 4 + pb + 2 * s) * NB32 * ROWB;
#pragma unroll
          for (int kk = 0; kk < KC32 * 2; kk += 32) {
            uint32_t a[4][4], bf[2][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) lgt::ldsm4(a[i], xa + a_off[i] + kk);
            lgt::ldsm4(bf[0], wb + kk);
            lgt::ldsm4(bf[1], wb + 16 * ROWB + kk);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                lgt::mma16816(acc[i][q], a[i], bf[q >> 1][(q & 1) * 2],
                              bf[q >> 1][(q & 1) * 2 + 1]);
          }
        }
      }
    }

    // ---- channel sums, fixed order: (i, h) in registers -> the 8 row
    // lanes by butterfly -> warps 0..7 -> cluster ranks 0..n-1 -------------
    float p1[4][2], p2[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = acc[i][q][2 * h + e];
            s1 += v;
            s2 += v * v;
          }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        p1[q][e] = s1;
        p2[q][e] = s2;
      }
    if (g == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[(warp * 2) * NB32 + q * 8 + 2 * t + e] = p1[q][e];
          red[(warp * 2 + 1) * NB32 + q * 8 + 2 * t + e] = p2[q][e];
        }
    }
    __syncthreads();
    const int buf = k & 1;
    if (tid < NB32) {
      float a1 = 0.f, a2 = 0.f;
      for (int w = 0; w < NW; ++w) {
        a1 += red[(w * 2) * NB32 + tid];
        a2 += red[(w * 2 + 1) * NB32 + tid];
      }
      cpart[(buf * 2) * NB32 + tid] = a1;
      cpart[(buf * 2 + 1) * NB32 + tid] = a2;
    }
    // every rank's partials of sample k are published; the other buffer
    // (sample k - 1) has been read by every rank before it arrived here
    cluster.sync();
    if (tid < NB32) {
      float v1[MAX_CLUSTER], v2[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) {
        if (r < csize) {
          const float* rp = cluster.map_shared_rank(cpart, r);
          v1[r] = rp[(buf * 2) * NB32 + tid];
          v2[r] = rp[(buf * 2 + 1) * NB32 + tid];
        }
      }
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) {
        if (r < csize) {
          s1 += v1[r];
          s2 += v2[r];
        }
      }
      // the group's channels in index order (lanes g0 .. g0 + gs - 1)
      const int g0 = tid / gs * gs;
      float gs1 = 0.f, gs2 = 0.f;
      for (int jj = 0; jj < gs; ++jj) {
        gs1 += __shfl_sync(0xffffffffu, s1, g0 + jj);
        gs2 += __shfl_sync(0xffffffffu, s2, g0 + jj);
      }
      const float mean = gs1 / cnt;
      const float rstd = rsqrtf(gs2 / cnt - mean * mean + eps);
      stat[tid] = mean;
      stat[NB32 + tid] = rstd;
      if (mu_out != nullptr && rank == 0) {
        mu_out[static_cast<size_t>(b) * Co + n0 + tid] = mean;
        rstd_out[static_cast<size_t>(b) * Co + n0 + tid] = rstd;
      }
    }
    __syncthreads();

    // ---- normalise + affine + LeakyReLU into the unfolded tile -----------
    // Output pixel p (local row 2 * il + pa, column 2 * j + pb) of 2 * 2W
    // per local row pair; pixel pair P = p >> 1 takes 128 bytes, its two
    // pixels' 64-byte halves swapped where P is odd, so that the eight
    // pixels one store instruction writes (2 columns apart) spread over all
    // 32 banks.  The quad exchange gives each lane 8 channels (16 bytes).
    float sc[4][2], sh[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = q * 8 + 2 * t + e;
        sc[q][e] = ga[q][e] * stat[NB32 + cc];
        sh[q][e] = be[q][e] - stat[cc] * sc[q][e];
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 64 + 16 * i + g + 8 * h;
        const int il = m / W, j = m - il * W;
        uint32_t vy[4], vp[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v0 = acc[i][q][2 * h] * sc[q][0] + sh[q][0];
          float v1 = acc[i][q][2 * h + 1] * sc[q][1] + sh[q][1];
          v0 = v0 >= 0.f ? v0 : slope * v0;
          v1 = v1 >= 0.f ? v1 : slope * v1;
          vy[q] = lgt::pack_bf16x2(v0, v1);
          vp[q] = lgt::pack_bf16x2(acc[i][q][2 * h], acc[i][q][2 * h + 1]);
        }
        lgt::quad_transpose(vy, t);
        const int P = (2 * il + pa) * W + j;
        *reinterpret_cast<uint4*>(ys + P * 128 + ((pb ^ (P & 1)) << 6) +
                                  t * 16) = make_uint4(vy[0], vy[1], vy[2],
                                                       vy[3]);
        if (yf != nullptr) {
          lgt::quad_transpose(vp, t);
          *reinterpret_cast<uint4*>(
              yf + ((static_cast<size_t>(b) * H + row0 + il) * W + j) *
                       (4 * Co) + par * Co + n0 + 8 * t) =
              make_uint4(vp[0], vp[1], vp[2], vp[3]);
        }
      }
    }
    __syncthreads();

    // ---- the tile to y: output rows 2 * row0 .. + 2 * rt, 16 bytes a lane
    const int w2 = 2 * W;
    __nv_bfloat16* yb =
        y + (static_cast<size_t>(b) * 2 * H + 2 * row0) * w2 * Co + n0;
    for (int idx = tid; idx < YS_BYTES / 16; idx += THREADS) {
      const int p = idx >> 2, ch = idx & 3, P = p >> 1;
      *reinterpret_cast<uint4*>(yb + static_cast<size_t>(p) * Co + ch * 8) =
          *reinterpret_cast<const uint4*>(
              ys + P * 128 + (((p & 1) ^ (P & 1)) << 6) + ch * 16);
    }
  }
  // no copy in flight at exit, and no block leaves while another may still
  // read its partials
  lgt::cp_async_wait(0);
  cluster.sync();
}

}  // namespace

// Dynamic shared memory of one block: the taps of one channel block (all
// Ci), `stages` haloed input chunks, the bf16 output tile, the sums.
extern "C" size_t upsample_rows_stage_smem(int W, int Ci, int stages) {
  return static_cast<size_t>(Ci / KC32) * TAP_ROWS * ROWB +
         static_cast<size_t>(stages) * x_rows(W) * ROWB + YS_BYTES + TAIL;
}

namespace {

// An error of a set-up call is not sticky, but it stays the runtime's last
// error: clear it, or the next launch's cudaGetLastError reports it.
int failed(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

cudaError_t stage_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                         int csize, int nclusters, int W, int Ci, int stages,
                         cudaStream_t stream) {
  const size_t smem = upsample_rows_stage_smem(W, Ci, stages);
  cudaError_t err = cudaFuncSetAttribute(
      upsample_rows_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(nclusters * csize);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// How many clusters of `csize` blocks, each with the shared memory of
// upsample_rows_stage_smem(W, Ci, stages), the card can hold at once: into
// *out.  Returns the query's error.
extern "C" int upsample_rows_stage_max_clusters(int csize, int W, int Ci,
                                                int stages, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = stage_config(cfg, attr, csize, 1, W, Ci, stages, nullptr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(out, upsample_rows_stage_kernel,
                                         &cfg);
  return err == cudaSuccess ? 0 : failed(err);
}

// x [B,H,W,Ci] bf16, wpk [Co/32][Ci/32][16][32][32] bf16 (pack_taps_chunks),
// gamma / beta [Co] f32 -> y [B,2H,2W,Co] bf16; where yf is not null (the
// residual mode) also yf [B,H,W,4Co] bf16 (the pre-norm conv, channel block
// 2a+b = parity (a, b)) and mu / rstd [B,Co] f32.  The grid is `nclusters`
// clusters of H / (128 / W) blocks; nclusters is a multiple of Co / 32.
// The caller checks the shape rules: 128 % W == 0, W >= 16, H % (128 / W)
// == 0, H / (128 / W) <= 8, Ci % 32 == 0, Co % 32 == 0, 32 % gs == 0 and
// the shared memory within the card's limit.  Returns the launch's error.
extern "C" int upsample_rows_stage(const void* x, const void* wpk,
                                   const void* gamma, const void* beta,
                                   void* y, void* yf, void* mu, void* rstd,
                                   int B, int H, int W, int Ci, int Co, int gs,
                                   int stages, int nclusters, float slope,
                                   float eps, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      stage_config(cfg, attr, H / (MROWS / W), nclusters, W, Ci, stages,
                   static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return failed(err);
  err = cudaLaunchKernelEx(
      &cfg, upsample_rows_stage_kernel, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wpk),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(yf),
      static_cast<float*>(mu), static_cast<float*>(rstd), B, H, W, Ci, Co, gs,
      stages, slope, eps);
  if (err != cudaSuccess) return failed(err);
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

// K1L: the whole late upsample stage in one launch (ConvTranspose 4x4 / s2
// SAME, GroupNorm, affine, LeakyReLU, depth-to-space), and its whole
// backward in one launch (LeakyReLU + GroupNorm backward, the per-cluster
// sums of dgamma / dbeta, and the input gradient).
//
// The forward replaces levelgan/kernels/upsample_rows.py:_conv_fwd (the
// Pallas call at :253) together with the XLA pass that follows it in
// _forward_rows (:382-395: GroupNorm from the kernel's sums, affine,
// LeakyReLU, unfold); the backward replaces _conv_bwd (the Pallas call at
// :323) together with the XLA pass before it in _make_rows_op's bwd
// (:453-479, named scope K1L_gn_act_bwd).
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

// Backward design.  What bounds it on an H100 at gumbel_64 up3 (B = 64): the
// output cotangent g and the residual yf in (16.8 MB each), dyf (kept for
// dw) and dx out (16.8 + 8.4 MB): 58.7 MB, 17.5 us at 3.35 TB/s, against
// 4.29 GFLOP of dx products (4.3 us at 989 TF/s): the bytes.  So nothing of
// yf's size goes through device memory in f32, and g and yf are read once.
// The H / rt blocks of one sample form a cluster (rt rows of the folded
// plane a block, rt * W <= 128 positions: 8 blocks of 4 rows at up3); the
// clusters are persistent and walk over samples.  Per sample a block
// bulk-copies its g rows, its yf rows (one contiguous run each) and the
// sample's mean / rstd behind an mbarrier, queued under the previous
// sample's GEMM.  Pass 1 forms xn, the LeakyReLU mask and dout and sums
// s1 = sum dout and s2 = sum dout * xn per channel in a fixed order (a
// thread's words -> butterfly over the lanes of one channel chunk -> warps
// in order); the block pushes its partials into every rank's shared memory
// by st.async, counted in bytes on that rank's mbarrier, and each rank
// adds them in rank order: no atomics, so two calls give the same bits.
// Every block then forms the group means of gamma * s1 and gamma * s2, and
// pass 2 writes dyf = rstd (dout gamma - m1 - xn m2) in bf16 (where the JAX
// package rounds it) into a haloed tile in shared memory; its first and
// last rows go by st.async into the halo rows of ranks r - 1 and r + 1
// (zeros stay at the sample's edges), dyf goes to device memory 16 bytes a
// lane, and the block waits for its own halo rows.  Pushing (partials,
// halo rows) replaces the cluster barriers and the remote reads of a first
// version (0.081 ms at this shape on an H100 at 700 W, against 0.065-0.069
// ms now).  The dx GEMM runs
// from the tile: per parity only its own 4 taps (no 9-shift packed weights
// with structured zeros), mma.sync with ldmatrix fragments, each warp a 32 x
// 32 tile, dx out 16 bytes a lane.  The weight (pack_taps_dx, 4 taps x Ci x
// 32 channels a step) stays resident where all its steps fit (up3: 80 KB)
// and streams through a cp.async ring otherwise.  Each cluster sums its
// samples' s1 and s2 in sample order into part [clusters][2][Co]; the
// caller adds the clusters' (one .sum(0)) into dbeta / dgamma.
//
// The staged kernel holds a block's g and yf rows, the dyf tile of all 4Co
// channels and one warp per 32 x 32 dx tile, so it takes only the shapes
// where those fit (kernels/upsample_rows.py:bwd_tile).  The general kernel
// takes every shape the stage kernel takes (rt = 128 / W, clusters of
// H / rt <= 8 blocks, Ci <= 128, any Co a multiple of 32): it reads g and yf
// from device memory, works through the cotangent channels 32 at a time
// (pass 1 per chunk; then per chunk the group means, pass 2 into a tile of
// that chunk's 4 x 32 channels and the chunk's 4 GEMM steps), computes the
// tile's halo rows itself instead of receiving them, exchanges the
// partial sums through device memory behind one cluster barrier a sample,
// and gives each warp up to two 32 x 32 dx tiles.  Its shared memory does
// not grow with Co.  The same fixed orders, so it too gives the same bits
// in two calls.
//
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

// ===========================================================================
// K1L backward: LeakyReLU + GroupNorm backward and the input gradient in one
// cluster kernel (the design note is at the top of this file).
// ===========================================================================

namespace {

constexpr int BWD_MAXW = 8;           // warps of a backward block, at most

using lgt::bulk_copy;
using lgt::map_rank;
using lgt::mbar_expect_tx;
using lgt::mbar_init;
using lgt::mbar_wait;
using lgt::mbar_wait_cluster;
using lgt::st_async16;
using lgt::st_async8;

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Warps of a block: one 32-position x 32-input-channel dx tile each.
__host__ __device__ inline int bwd_warps(int W, int rt, int Ci) {
  return (rt * W / 32) * (Ci / 32);
}

// Byte offsets of a backward block's shared memory.  g and yf: the block's
// rows as stored (2rt output rows; rt folded rows), 8 M Co bytes each; the
// dyf tile: (rt + 2) x (W + 2) positions of 4Co bf16 plus 16 bytes (so the
// eight rows an ldmatrix reads start in eight distinct bank groups), zero
// halo columns, halo rows from the neighbouring ranks; the weight ring:
// `slots` steps of 4 taps x Ci rows of 32 cotangent channels (ROWB each);
// then the sums (warp partials; every rank's partials of two samples, as
// the ranks push them), the sample's mean / rstd (copied with the rows),
// the group means, and the mbarriers of the rows, the halo rows and the
// partials of even and odd samples.
struct BwdLayout {
  int pitch, wstep, g, yf, tile, wring, red, cpart, stat, mm, bar, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int W, int rt, int Ci, int Co,
                                                int slots) {
  BwdLayout l;
  const int m = rt * W;
  l.pitch = 8 * Co + 16;
  l.wstep = 4 * Ci * ROWB;
  l.g = 0;
  l.yf = 8 * m * Co;
  l.tile = 16 * m * Co;
  l.wring = l.tile + (rt + 2) * (W + 2) * l.pitch;
  l.red = l.wring + slots * l.wstep;
  l.cpart = l.red + bwd_warps(W, rt, Ci) * 2 * Co * 4;
  l.stat = l.cpart + 2 * MAX_CLUSTER * Co * 8;
  l.mm = l.stat + 2 * Co * 4;
  l.bar = l.mm + 2 * Co * 4;
  l.total = l.bar + 32;            // four mbarriers
  return l;
}

__global__ void __launch_bounds__(BWD_MAXW * 32, 1)
upsample_rows_bwd_kernel(const __nv_bfloat16* __restrict__ g,
                         const __nv_bfloat16* __restrict__ yf,
                         const float* __restrict__ mu,
                         const float* __restrict__ rstd,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         const __nv_bfloat16* __restrict__ wpk,
                         __nv_bfloat16* __restrict__ dx,
                         __nv_bfloat16* __restrict__ dyf,
                         float* __restrict__ part,
                         unsigned long long* __restrict__ probe, int B, int H,
                         int W, int Ci, int Co, int gs, int rt, int slots,
                         float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  // with a probe, thread 0 of block 0 adds each phase's time to probe[ph]
  unsigned long long t_last = 0;
  auto mark = [&](int ph) {
    if (probe != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (ph >= 0) probe[ph] += now - t_last;
      t_last = now;
    }
  };
  mark(-1);
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, nthr = blockDim.x, nw = nthr >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int m_blk = rt * W, wp = W + 2, row0 = rank * rt;
  const BwdLayout lay = bwd_layout(W, rt, Ci, Co, slots);
  unsigned char* tile = smem + lay.tile;
  float* red = reinterpret_cast<float*>(smem + lay.red);     // [nw][2][Co]
  // [sample parity][rank][Co][s1, s2]
  const float* inbox = reinterpret_cast<const float*>(smem + lay.cpart);
  float* stat = reinterpret_cast<float*>(smem + lay.stat);   // [2][Co]
  float* mm = reinterpret_cast<float*>(smem + lay.mm);       // [2][Co]
  const uint32_t sbase = lgt::smem_addr(smem);
  const uint32_t bar = sbase + lay.bar;          // the rows have landed
  const uint32_t hbar = bar + 8;                 // the halo rows are in
  const uint32_t sbar = bar + 16;                // + 8 (k & 1): partials
  const int nneigh = (rank > 0) + (rank + 1 < csize);
  const int hbytes = nneigh * W * 8 * Co;        // ... nneigh rows of them
  const int sbytes = csize * Co * 8;             // ... every rank's

  // this cluster's samples: cid, cid + ncl, ...
  const int cid = blockIdx.x / csize, ncl = gridDim.x / csize;
  const int nsamp = cid < B ? (B - 1 - cid) / ncl + 1 : 0;
  const int kcn = Co / KC32, nsteps = 4 * kcn;
  const bool resident = slots >= nsteps;
  const int rbytes = 8 * m_blk * Co;     // the block's g rows, and its yf rows

  {  // zero the tile's halo: the columns stay zero, and so do the rows
     // outside the sample (the others take the neighbours' rows)
    const int pw = lay.pitch / 16, rw = wp * pw;   // 16-byte words
    for (int i = tid; i < 2 * rw + 2 * rt * pw; i += nthr) {
      int word;
      if (i < 2 * rw) {
        word = i < rw ? i : (rt + 1) * rw + i - rw;
      } else {
        const int e = i - 2 * rw, side = e / (rt * pw), rest = e % (rt * pw);
        word = (rest / pw + 1) * rw + (side ? W + 1 : 0) * pw + rest % pw;
      }
      reinterpret_cast<uint4*>(tile)[word] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // thread 0 queues the g and yf rows of the cluster's k-th sample (one
  // contiguous run each) and its mean / rstd
  auto load_rows = [&](int k) {
    const size_t b = cid + static_cast<size_t>(k) * ncl;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, 2 * rbytes + 8 * Co);
    bulk_copy(sbase + lay.g, g + (b * 2 * H + 2 * row0) * 2 * W * Co, rbytes,
              bar);
    bulk_copy(sbase + lay.yf, yf + (b * H + row0) * W * 4 * Co, rbytes, bar);
    bulk_copy(sbase + lay.stat, mu + b * Co, 4 * Co, bar);
    bulk_copy(sbase + lay.stat + 4 * Co, rstd + b * Co, 4 * Co, bar);
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    // the halo rows arrive by st.async from the neighbours, counted in
    // bytes against this thread's expectation, one phase a sample
    if (nneigh > 0) mbar_init(hbar, 1);
    // every rank's partials arrive by st.async too, those of even and odd
    // samples on two barriers
    mbar_init(sbar, 1);
    mbar_init(sbar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (nsamp > 0) {
      load_rows(0);
      if (nneigh > 0) mbar_expect_tx(hbar, hbytes);
      mbar_expect_tx(sbar, sbytes);
      if (nsamp > 1) mbar_expect_tx(sbar + 8, sbytes);
    }
  }

  // weight step st = parity * kcn + kc: the parity's 4 taps x Ci rows of 32
  // cotangent channels, from pack_taps_dx's [Ci/32][parity][kc][tap][32][32]
  auto copy_step = [&](int st, int slot) {
    const int p = st / kcn, kc = st - p * kcn;
    const uint32_t dst = sbase + lay.wring + slot * lay.wstep;
    for (int idx = tid; idx < 16 * Ci; idx += nthr) {
      const int q = idx & 3, n = (idx >> 2) & 31, tap = (idx >> 7) & 3,
                nb = idx >> 9;
      lgt::cp_async16(
          dst + (tap * Ci + nb * 32 + n) * ROWB + q * 16,
          wpk + ((((static_cast<size_t>(nb) * 4 + p) * kcn + kc) * 4 + tap) *
                     32 + n) * 32 + q * 8);
    }
  };
  // where the steps do not all fit, they stream through the ring for every
  // sample, one cp.async group a step
  const int wtotal = nsamp * nsteps;
  int wq = 0;
  auto queue_step = [&]() {
    if (wq < wtotal) copy_step(wq % nsteps, wq % slots);
    lgt::cp_async_commit();   // an empty group keeps the wait's count uniform
    ++wq;
  };
  if (resident) {
    if (nsamp > 0)
      for (int st = 0; st < nsteps; ++st) copy_step(st, st);
    lgt::cp_async_commit();
  } else {
    for (int s = 0; s < slots - 1; ++s) queue_step();
  }

  // the per-element passes: a thread takes 8 channels (chunk cq) of one
  // parity pp at positions pos0, pos0 + pstep, ...: 16-byte words of the
  // block's folded rows, read from the staged g and yf rows (the thread
  // count is a multiple of Co / 2)
  const int cqn = Co / 8, cq = tid % cqn, pp = (tid / cqn) & 3;
  const int pos0 = tid / (4 * cqn), pstep = nthr / (4 * cqn);
  const int lw = __ffs(W) - 1;
  const int choff = (pp * Co + cq * 8) * 2;        // bytes into a position
  float gm[8], bt[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    gm[e] = gamma[cq * 8 + e];
    bt[e] = beta[cq * 8 + e];
  }
  const float cnt = 4.f * gs * H * W;
  const float gam_c = tid < Co ? gamma[tid] : 0.f;   // the sums' channel
  auto yf_word = [&](int pos) {
    return *reinterpret_cast<const uint4*>(smem + lay.yf + pos * 8 * Co +
                                           choff);
  };
  // folded (il, j, parity (a, b)) -> g at (2 il + a, 2 j + b) of the rows
  auto g_word = [&](int pos) {
    const int il = pos >> lw, j = pos & (W - 1);
    return *reinterpret_cast<const uint4*>(
        smem + lay.g +
        (((il * 4 * W + (pp >> 1) * 2 * W + 2 * j + (pp & 1)) * Co + cq * 8)
         << 1));
  };
  constexpr int UNR = 4;      // words a thread loads before it computes
                              // (twice as many in pass 1)

  // the dx GEMM: warp (wm, wn) owns positions wm * 32 .. + 32 and input
  // channels wn * 32 .. + 32; row m reads the tile at (il + 2 - a - r,
  // j + 2 - b - s) for parity (a, b), tap (r, s)
  const int wms = m_blk / 32, wm = warp % wms, wn = warp / wms;
  uint32_t a_base[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int m = wm * 32 + mi * 16 + lgt::frag_a_row(lane);
    const int il = m / W, j = m - il * W;
    a_base[mi] = sbase + lay.tile + ((il + 2) * wp + j + 2) * lay.pitch +
                 lgt::frag_a_koff(lane);
  }
  const uint32_t b_base =
      sbase + lay.wring + wn * 32 * ROWB + lgt::frag_b_off(lane);
  // the zeros are down and every block's barriers are set up before any
  // block pushes into another
  cluster.sync();
  mark(0);
  int wt = 0;                 // weight steps consumed
  float bs1 = 0.f, bs2 = 0.f; // thread c < Co: its channel's batch sums
  for (int k = 0; k < nsamp; ++k) {
    const int b = cid + k * ncl;
    mbar_wait(bar, k & 1);    // this sample's rows have landed
    mark(1);
    float mu8[8], rs8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      mu8[e] = stat[cq * 8 + e];
      rs8[e] = stat[Co + cq * 8 + e];
    }

    // ---- pass 1: s1 = sum dout, s2 = sum dout * xn per channel, parities
    // collapsed; fixed order: a thread's words in order -> the lanes of one
    // chunk by butterfly -> warps 0..nw-1 -> cluster ranks 0..n-1 --------
    float s1[8], s2[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.f;
    for (int pos = pos0; pos < m_blk; pos += 2 * UNR * pstep) {
      uint4 yw[2 * UNR], gw[2 * UNR];
#pragma unroll
      for (int u = 0; u < 2 * UNR; ++u)
        if (pos + u * pstep < m_blk) {
          yw[u] = yf_word(pos + u * pstep);
          gw[u] = g_word(pos + u * pstep);
        }
#pragma unroll
      for (int u = 0; u < 2 * UNR; ++u)
        if (pos + u * pstep < m_blk) {
          float yv[8], gv[8];
          unpack8(yw[u], yv);
          unpack8(gw[u], gv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float xn = (yv[e] - mu8[e]) * rs8[e];
            const float d = xn * gm[e] + bt[e] >= 0.f ? gv[e] : slope * gv[e];
            s1[e] += d;
            s2[e] += d * xn;
          }
        }
    }
    for (int o = cqn; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], o);
        s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], o);
      }
    mark(2);
    if (lane < cqn)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        red[(warp * 2) * Co + lane * 8 + e] = s1[e];
        red[(warp * 2 + 1) * Co + lane * 8 + e] = s2[e];
      }
    __syncthreads();
    // the block's partials to every rank's inbox (its own too), slot
    // [k & 1][rank]: a rank reads sample k's before it pushes sample
    // k + 1's, the last anyone needs before pushing sample k + 2's.  That
    // push also tells each neighbour this block's GEMM of the previous
    // sample is done, before the neighbour pushes halo rows into the tile
    const int par = k & 1;
    if (tid < Co) {
      const int c = tid;
      float a1 = 0.f, a2 = 0.f;
      for (int w = 0; w < nw; ++w) {
        a1 += red[(w * 2) * Co + c];
        a2 += red[(w * 2 + 1) * Co + c];
      }
      const uint32_t slot =
          sbase + lay.cpart + ((par * MAX_CLUSTER + rank) * Co + c) * 8;
      for (int r = 0; r < csize; ++r)
        st_async8(map_rank(slot, r), a1, a2, map_rank(sbar + 8 * par, r));
    }
    mark(3);
    mbar_wait_cluster(sbar + 8 * par, (k >> 1) & 1);   // every rank's are in
    if (tid == 0 && k + 2 < nsamp) mbar_expect_tx(sbar + 8 * par, sbytes);
    mark(4);
    if (tid < Co) {
      // the sample's sums in rank order, then the group means of gamma * s:
      // the group's channels in index order, lanes of this warp (a group
      // divides 32 channels)
      const int c = tid;
      float t1 = 0.f, t2 = 0.f;
      for (int r = 0; r < csize; ++r) {
        const float2 v = *reinterpret_cast<const float2*>(
            inbox + ((par * MAX_CLUSTER + r) * Co + c) * 2);
        t1 += v.x;
        t2 += v.y;
      }
      bs1 += t1;              // this cluster's sums over its samples
      bs2 += t2;
      const float w1 = t1 * gam_c, w2 = t2 * gam_c;
      const int g0 = lane / gs * gs;
      float m1 = 0.f, m2 = 0.f;
      for (int jj = 0; jj < gs; ++jj) {
        m1 += __shfl_sync(0xffffffffu, w1, g0 + jj);
        m2 += __shfl_sync(0xffffffffu, w2, g0 + jj);
      }
      mm[c] = m1 / cnt;
      mm[Co + c] = m2 / cnt;
    }
    __syncthreads();
    mark(5);

    // ---- pass 2: dyf = rstd (dout gamma - m1 - xn m2), in bf16 to the
    // tile's interior (the GEMM's A) --------------------------------------
    // rstd (dout gamma - m1 - xn m2) = (rstd gamma or rstd gamma slope) g
    // + (-rstd m2) xn + (-rstd m1), by the sign of xn gamma + beta
    float ap[8], an[8], bx[8], cx[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ap[e] = rs8[e] * gm[e];
      an[e] = ap[e] * slope;
      bx[e] = -rs8[e] * mm[Co + cq * 8 + e];
      cx[e] = -rs8[e] * mm[cq * 8 + e];
    }
    for (int pos = pos0; pos < m_blk; pos += UNR * pstep) {
      uint4 yw[UNR], gw[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u)
        if (pos + u * pstep < m_blk) {
          yw[u] = yf_word(pos + u * pstep);
          gw[u] = g_word(pos + u * pstep);
        }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int ps = pos + u * pstep;
        if (ps < m_blk) {
          float yv[8], gv[8];
          unpack8(yw[u], yv);
          unpack8(gw[u], gv);
          uint32_t out[4];
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            float o[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = e + h;
              const float xn = (yv[i] - mu8[i]) * rs8[i];
              const float a = xn * gm[i] + bt[i] >= 0.f ? ap[i] : an[i];
              o[h] = a * gv[i] + (bx[i] * xn + cx[i]);
            }
            out[e >> 1] = lgt::pack_bf16x2(o[0], o[1]);
          }
          *reinterpret_cast<uint4*>(tile + ((ps >> lw) + 1) * wp * lay.pitch +
                                    ((ps & (W - 1)) + 1) * lay.pitch +
                                    choff) =
              make_uint4(out[0], out[1], out[2], out[3]);
        }
      }
    }
    __syncthreads();          // g and yf are read, the interior is written
    mark(6);

    // the first interior row to rank r - 1's halo row rt + 1, the last to
    // rank r + 1's halo row 0 (each finished its GEMM of the previous
    // sample before it pushed this sample's partials), by st.async, which
    // counts the bytes on that block's halo mbarrier; then dyf from the
    // tile to device memory (for dw), 16 bytes a lane
    const int rwords = W * Co / 2;                 // 16-byte words a row
    for (int idx = tid; idx < 2 * rwords; idx += nthr) {
      const int side = idx >= rwords, e = idx - side * rwords;
      if (side ? rank + 1 == csize : rank == 0) continue;
      const int off = ((e / (Co / 2)) + 1) * lay.pitch + (e % (Co / 2)) * 16;
      const int peer = side ? rank + 1 : rank - 1;
      st_async16(map_rank(sbase + lay.tile +
                              (side ? 0 : rt + 1) * wp * lay.pitch + off,
                          peer),
                 *reinterpret_cast<const uint4*>(
                     tile + (side ? rt : 1) * wp * lay.pitch + off),
                 map_rank(hbar, peer));
    }
    mark(7);
    __nv_bfloat16* dyb = dyf + (static_cast<size_t>(b) * H + row0) * W * 4 * Co;
    for (int idx = tid; idx < rt * rwords; idx += nthr) {
      const int pos = idx / (Co / 2), q = idx - pos * (Co / 2);
      *reinterpret_cast<uint4*>(dyb + static_cast<size_t>(idx) * 8) =
          *reinterpret_cast<const uint4*>(
              tile + ((pos >> lw) + 1) * wp * lay.pitch +
              ((pos & (W - 1)) + 1) * lay.pitch + q * 16);
    }
    mark(8);
    if (tid == 0 && k + 1 < nsamp) load_rows(k + 1);   // g and yf are free
    if (nneigh > 0) {
      mbar_wait_cluster(hbar, k & 1);   // this tile's halo rows are in
      if (tid == 0 && k + 1 < nsamp) mbar_expect_tx(hbar, hbytes);
    }
    if (resident && k == 0) lgt::cp_async_wait(0);    // the weights are in
    __syncthreads();
    mark(9);

    // ---- dx: per (parity, 32-channel chunk) step, the parity's 4 taps ----
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][q][e] = 0.f;
    for (int st = 0; st < nsteps; ++st, ++wt) {
      if (!resident) {
        // this step's weights have landed, and every warp is done with the
        // step before it, whose slot the next copies go into
        lgt::cp_async_wait(slots - 2);
        __syncthreads();
        queue_step();
      }
      const int p = st / kcn, kc = st - p * kcn, pa = p >> 1, pb = p & 1;
      const uint32_t wsl = b_base + (resident ? st : wt % slots) * lay.wstep;
      const int coff = (p * Co + kc * KC32) * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int aoff = coff - ((pa + r) * wp + pb + s) * lay.pitch;
          const uint32_t wb = wsl + (2 * r + s) * Ci * ROWB;
#pragma unroll
          for (int kk = 0; kk < KC32 * 2; kk += 32) {
            uint32_t a0[4], a1[4], b0[4], b1[4];
            lgt::ldsm4(a0, a_base[0] + aoff + kk);
            lgt::ldsm4(a1, a_base[1] + aoff + kk);
            lgt::ldsm4(b0, wb + kk);
            lgt::ldsm4(b1, wb + 16 * ROWB + kk);
            lgt::mma16816(acc[0][0], a0, b0[0], b0[1]);
            lgt::mma16816(acc[0][1], a0, b0[2], b0[3]);
            lgt::mma16816(acc[0][2], a0, b1[0], b1[1]);
            lgt::mma16816(acc[0][3], a0, b1[2], b1[3]);
            lgt::mma16816(acc[1][0], a1, b0[0], b0[1]);
            lgt::mma16816(acc[1][1], a1, b0[2], b0[3]);
            lgt::mma16816(acc[1][2], a1, b1[0], b1[1]);
            lgt::mma16816(acc[1][3], a1, b1[2], b1[3]);
          }
        }
      }
    }
    mark(10);
    // 16 bytes a lane: the quad exchange gives lane t the 8 channels of n8
    // tile t
    const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm * 32 + mi * 16 + g8 + 8 * h;
        const int il = m / W, j = m - il * W;
        uint32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = lgt::pack_bf16x2(acc[mi][q][2 * h], acc[mi][q][2 * h + 1]);
        lgt::quad_transpose(v, t4);
        *reinterpret_cast<uint4*>(
            dx + ((static_cast<size_t>(b) * H + row0 + il) * W + j) * Ci +
            wn * 32 + 8 * t4) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    mark(11);
  }
  // no copy in flight at exit (a block reads no other block's shared
  // memory, and it waited for everything pushed into its own)
  lgt::cp_async_wait(0);

  // ---- this cluster's sums over its samples (rank 0's), for dbeta = sum
  // s1 and dgamma = sum s2 over the batch ----------------------------------
  if (rank == 0 && tid < Co) {
    part[(cid * 2) * Co + tid] = bs1;
    part[(cid * 2 + 1) * Co + tid] = bs2;
  }
  mark(12);
}

// ---------------------------------------------------------------------------
// The general backward kernel: every shape the stage kernel takes (design
// note at the top of this file).  A block owns rt = 128 / W folded rows of
// one sample (M = 128), the H / rt blocks of a sample form a cluster, the
// clusters are persistent over samples.
// ---------------------------------------------------------------------------

constexpr int GEN_PITCH = 4 * KC32 * 2 + 16;   // a tile position's bytes
constexpr int GEN_MAXT = 2;                    // dx warp tiles of a warp
constexpr int GEN_ITERS = MROWS / (BWD_MAXW * 32 / 16);   // pass-1 words

// Byte offsets of a general block's shared memory: the dyf tile of one
// chunk ((rt + 2) x (W + 2) positions of 4 parities x 32 channels bf16 + 16
// bytes), the weight ring (`slots` steps of 4 taps x Ci rows), the warps'
// partials of one chunk [8][2][32] and the chunk's group means [2][32].
struct GenLayout {
  int wstep, wring, red, mm, total;
};

__host__ __device__ inline GenLayout gen_layout(int W, int rt, int Ci,
                                                int slots) {
  GenLayout l;
  l.wstep = 4 * Ci * ROWB;
  l.wring = (rt + 2) * (W + 2) * GEN_PITCH;
  l.red = l.wring + slots * l.wstep;
  l.mm = l.red + BWD_MAXW * 2 * KC32 * 4;
  l.total = l.mm + 2 * KC32 * 4;
  return l;
}

__global__ void __launch_bounds__(BWD_MAXW * 32, 1)
upsample_rows_bwd_general_kernel(const __nv_bfloat16* __restrict__ g,
                                 const __nv_bfloat16* __restrict__ yf,
                                 const float* __restrict__ mu,
                                 const float* __restrict__ rstd,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta,
                                 const __nv_bfloat16* __restrict__ wpk,
                                 __nv_bfloat16* __restrict__ dx,
                                 __nv_bfloat16* __restrict__ dyf,
                                 float* __restrict__ xch,
                                 float* __restrict__ part, int B, int H,
                                 int W, int Ci, int Co, int gs, int rt,
                                 int slots, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, nthr = blockDim.x, nw = nthr >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int m_blk = rt * W, wp = W + 2, row0 = rank * rt;
  const int lw = __ffs(W) - 1;
  const GenLayout lay = gen_layout(W, rt, Ci, slots);
  unsigned char* tile = smem;
  float* red = reinterpret_cast<float*>(smem + lay.red);   // [nw][2][32]
  float* mm = reinterpret_cast<float*>(smem + lay.mm);     // [2][32]
  const uint32_t sbase = lgt::smem_addr(smem);

  const int cid = blockIdx.x / csize, ncl = gridDim.x / csize;
  const int nsamp = cid < B ? (B - 1 - cid) / ncl + 1 : 0;
  const int kcn = Co / KC32, nsteps = 4 * kcn;
  const bool resident = slots >= nsteps;
  // this cluster's exchange: [sample parity][rank][s1, s2][Co]
  float* xs = xch + static_cast<size_t>(cid) * 2 * csize * 2 * Co;

  // zero the tile once: its halo columns and the rows outside the sample
  // are never written
  for (int i = tid; i < lay.wring / 16; i += nthr)
    reinterpret_cast<uint4*>(tile)[i] = make_uint4(0u, 0u, 0u, 0u);

  // weight step st = kc * 4 + parity: the parity's 4 taps x Ci rows of 32
  // cotangent channels, from pack_taps_dx's [Ci/32][parity][kc][tap][32][32]
  auto copy_step = [&](int st, int slot) {
    const int kc = st >> 2, p = st & 3;
    const uint32_t dst = sbase + lay.wring + slot * lay.wstep;
    for (int idx = tid; idx < 16 * Ci; idx += nthr) {
      const int q = idx & 3, n = (idx >> 2) & 31, tap = (idx >> 7) & 3,
                nb = idx >> 9;
      lgt::cp_async16(
          dst + (tap * Ci + nb * 32 + n) * ROWB + q * 16,
          wpk + ((((static_cast<size_t>(nb) * 4 + p) * kcn + kc) * 4 + tap) *
                     32 + n) * 32 + q * 8);
    }
  };
  const int wtotal = nsamp * nsteps;
  int wq = 0;
  auto queue_step = [&]() {
    if (wq < wtotal) copy_step(wq % nsteps, wq % slots);
    lgt::cp_async_commit();   // an empty group keeps the wait's count uniform
    ++wq;
  };
  if (resident) {
    if (nsamp > 0)
      for (int st = 0; st < nsteps; ++st) copy_step(st, st);
    lgt::cp_async_commit();
  } else {
    for (int s = 0; s < slots - 1; ++s) queue_step();
  }

  // the per-element passes: a thread takes 8 channels (cqq) of one parity
  // pp of the chunk at positions pos0, pos0 + 16, ...
  const int cqq = tid & 3, pp = (tid >> 2) & 3, pos0 = tid >> 4;
  const int pstep = nthr >> 4;
  const float cnt = 4.f * gs * H * W;
  // the 16-byte words at folded (il, j), parity pp, channel c of sample b
  auto yf_at = [&](size_t b, int il, int j, int c) {
    return __ldg(reinterpret_cast<const uint4*>(
        yf + ((b * H + il) * W + j) * 4 * Co + pp * Co + c));
  };
  auto g_at = [&](size_t b, int il, int j, int c) {
    return __ldg(reinterpret_cast<const uint4*>(
        g + ((b * 2 * H + 2 * il + (pp >> 1)) * 2 * W + 2 * j + (pp & 1)) *
                Co + c));
  };

  // the dx GEMM: warp tile tl = warp + t nw (t < GEN_MAXT) owns positions
  // wm * 32 .. + 32 and input channels wn * 32 .. + 32
  const int wms = m_blk / 32, nwt = wms * (Ci / 32);
  uint32_t a_base[GEN_MAXT][2], b_base[GEN_MAXT];
  int wm[GEN_MAXT], wn[GEN_MAXT];
#pragma unroll
  for (int t = 0; t < GEN_MAXT; ++t) {
    const int tl = min(warp + t * nw, nwt - 1);
    wm[t] = tl % wms;
    wn[t] = tl / wms;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m = wm[t] * 32 + mi * 16 + lgt::frag_a_row(lane);
      const int il = m >> lw, j = m & (W - 1);
      a_base[t][mi] = sbase + ((il + 2) * wp + j + 2) * GEN_PITCH +
                      lgt::frag_a_koff(lane);
    }
    b_base[t] = sbase + lay.wring + wn[t] * 32 * ROWB + lgt::frag_b_off(lane);
  }
  const int ntl = (nwt - warp + nw - 1) / nw;   // this warp's tiles

  int wt = 0;                 // weight steps consumed
  for (int k = 0; k < nsamp; ++k) {
    const size_t b = cid + static_cast<size_t>(k) * ncl;
    float* xk = xs + static_cast<size_t>(k & 1) * csize * 2 * Co;

    // ---- pass 1, a chunk at a time: the block's s1 = sum dout and s2 =
    // sum dout * xn; fixed order: a thread's words -> the lanes of one
    // chunk by butterfly -> warps 0..nw-1 -> (below) ranks 0..n-1 ---------
    for (int kc = 0; kc < kcn; ++kc) {
      const int c0 = kc * KC32 + cqq * 8;
      float mu8[8], rs8[8], gm[8], bt[8], s1[8], s2[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        mu8[e] = mu[b * Co + c0 + e];
        rs8[e] = rstd[b * Co + c0 + e];
        gm[e] = gamma[c0 + e];
        bt[e] = beta[c0 + e];
        s1[e] = s2[e] = 0.f;
      }
      uint4 yw[GEN_ITERS], gw[GEN_ITERS];
#pragma unroll
      for (int u = 0; u < GEN_ITERS; ++u) {
        const int pos = pos0 + u * pstep;
        const int il = row0 + (pos >> lw), j = pos & (W - 1);
        yw[u] = yf_at(b, il, j, c0);
        gw[u] = g_at(b, il, j, c0);
      }
#pragma unroll
      for (int u = 0; u < GEN_ITERS; ++u) {
        float yv[8], gv[8];
        unpack8(yw[u], yv);
        unpack8(gw[u], gv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xn = (yv[e] - mu8[e]) * rs8[e];
          const float d = xn * gm[e] + bt[e] >= 0.f ? gv[e] : slope * gv[e];
          s1[e] += d;
          s2[e] += d * xn;
        }
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], o);
          s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], o);
        }
      if (lane < 4)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          red[(warp * 2) * KC32 + lane * 8 + e] = s1[e];
          red[(warp * 2 + 1) * KC32 + lane * 8 + e] = s2[e];
        }
      __syncthreads();
      if (tid < KC32) {
        float a1 = 0.f, a2 = 0.f;
        for (int w = 0; w < nw; ++w) {
          a1 += red[(w * 2) * KC32 + tid];
          a2 += red[(w * 2 + 1) * KC32 + tid];
        }
        xk[(rank * 2) * Co + kc * KC32 + tid] = a1;
        xk[(rank * 2 + 1) * Co + kc * KC32 + tid] = a2;
      }
      __syncthreads();
    }
    // every rank's partials of this sample are in device memory (the
    // barrier releases and acquires them at cluster scope); slot k & 1 is
    // rewritten at sample k + 2, after every rank has passed this barrier
    // of sample k + 1, so after its reads of sample k
    cluster.sync();

    float acc[GEN_MAXT][2][4][4];
#pragma unroll
    for (int t = 0; t < GEN_MAXT; ++t)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][mi][q][e] = 0.f;
    for (int kc = 0; kc < kcn; ++kc) {
      if (tid < KC32) {
        // the chunk's sums in rank order; rank 0 adds them to this
        // cluster's sums over its samples; the group means of gamma * s
        // (a group divides 32 channels: lanes of this warp)
        const int c = kc * KC32 + tid;
        float t1 = 0.f, t2 = 0.f;
        for (int r = 0; r < csize; ++r) {
          t1 += __ldcg(xk + (r * 2) * Co + c);
          t2 += __ldcg(xk + (r * 2 + 1) * Co + c);
        }
        if (rank == 0) {
          float* pc = part + static_cast<size_t>(cid) * 2 * Co;
          pc[c] = k ? pc[c] + t1 : t1;
          pc[Co + c] = k ? pc[Co + c] + t2 : t2;
        }
        const float w1 = t1 * gamma[c], w2 = t2 * gamma[c];
        const int g0 = lane / gs * gs;
        float m1 = 0.f, m2 = 0.f;
        for (int jj = 0; jj < gs; ++jj) {
          m1 += __shfl_sync(0xffffffffu, w1, g0 + jj);
          m2 += __shfl_sync(0xffffffffu, w2, g0 + jj);
        }
        mm[tid] = m1 / cnt;
        mm[KC32 + tid] = m2 / cnt;
      }
      // the group means are in, and every warp is done with the previous
      // chunk's tile
      __syncthreads();

      // ---- pass 2: dyf = rstd (dout gamma - m1 - xn m2) of the chunk in
      // bf16, rows row0 - 1 .. row0 + rt inside the sample: the block's own
      // rows to the tile and to device memory, the halo rows to the tile
      const int c0 = kc * KC32 + cqq * 8;
      float mu8[8], rs8[8], gm[8], bt[8], ap[8], an[8], bx[8], cx[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        mu8[e] = mu[b * Co + c0 + e];
        rs8[e] = rstd[b * Co + c0 + e];
        gm[e] = gamma[c0 + e];
        bt[e] = beta[c0 + e];
        ap[e] = rs8[e] * gm[e];
        an[e] = ap[e] * slope;
        bx[e] = -rs8[e] * mm[KC32 + cqq * 8 + e];
        cx[e] = -rs8[e] * mm[cqq * 8 + e];
      }
      constexpr int UNR = 4;
      const int npos = (rt + 2) * W;
      for (int q0 = pos0; q0 < npos; q0 += UNR * pstep) {
        uint4 yw[UNR], gw[UNR];
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int q = q0 + u * pstep, il = row0 + (q >> lw) - 1;
          if (q < npos && il >= 0 && il < H) {
            yw[u] = yf_at(b, il, q & (W - 1), c0);
            gw[u] = g_at(b, il, q & (W - 1), c0);
          }
        }
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const int q = q0 + u * pstep, tr = q >> lw, j = q & (W - 1);
          const int il = row0 + tr - 1;
          if (q < npos && il >= 0 && il < H) {
            float yv[8], gv[8];
            unpack8(yw[u], yv);
            unpack8(gw[u], gv);
            uint32_t out[4];
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
              float o[2];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int i = e + h;
                const float xn = (yv[i] - mu8[i]) * rs8[i];
                const float a = xn * gm[i] + bt[i] >= 0.f ? ap[i] : an[i];
                o[h] = a * gv[i] + (bx[i] * xn + cx[i]);
              }
              out[e >> 1] = lgt::pack_bf16x2(o[0], o[1]);
            }
            const uint4 v = make_uint4(out[0], out[1], out[2], out[3]);
            *reinterpret_cast<uint4*>(tile + (tr * wp + j + 1) * GEN_PITCH +
                                      (pp * KC32 + cqq * 8) * 2) = v;
            if (tr >= 1 && tr <= rt)
              *reinterpret_cast<uint4*>(
                  dyf + ((b * H + il) * W + j) * 4 * Co + pp * Co + c0) = v;
          }
        }
      }
      if (resident && k == 0 && kc == 0) lgt::cp_async_wait(0);
      __syncthreads();        // the chunk's tile (and the weights) are in

      // ---- the chunk's 4 GEMM steps, one a parity, its 4 taps ----------
      for (int p = 0; p < 4; ++p, ++wt) {
        if (!resident) {
          // this step's weights have landed, and every warp is done with
          // the step before it, whose slot the next copies go into
          lgt::cp_async_wait(slots - 2);
          __syncthreads();
          queue_step();
        }
        const int pa = p >> 1, pb = p & 1;
        const int wsl = (resident ? kc * 4 + p : wt % slots) * lay.wstep;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int aoff =
                p * KC32 * 2 - ((pa + r) * wp + pb + s) * GEN_PITCH;
            const int wb = wsl + (2 * r + s) * Ci * ROWB;
#pragma unroll
            for (int kk = 0; kk < KC32 * 2; kk += 32) {
#pragma unroll
              for (int t = 0; t < GEN_MAXT; ++t) {
                if (t < ntl) {
                  uint32_t a0[4], a1[4], b0[4], b1[4];
                  lgt::ldsm4(a0, a_base[t][0] + aoff + kk);
                  lgt::ldsm4(a1, a_base[t][1] + aoff + kk);
                  lgt::ldsm4(b0, b_base[t] + wb + kk);
                  lgt::ldsm4(b1, b_base[t] + wb + 16 * ROWB + kk);
                  lgt::mma16816(acc[t][0][0], a0, b0[0], b0[1]);
                  lgt::mma16816(acc[t][0][1], a0, b0[2], b0[3]);
                  lgt::mma16816(acc[t][0][2], a0, b1[0], b1[1]);
                  lgt::mma16816(acc[t][0][3], a0, b1[2], b1[3]);
                  lgt::mma16816(acc[t][1][0], a1, b0[0], b0[1]);
                  lgt::mma16816(acc[t][1][1], a1, b0[2], b0[3]);
                  lgt::mma16816(acc[t][1][2], a1, b1[0], b1[1]);
                  lgt::mma16816(acc[t][1][3], a1, b1[2], b1[3]);
                }
              }
            }
          }
        }
      }
    }
    // dx, 16 bytes a lane: the quad exchange gives lane t the 8 channels of
    // n8 tile t
    const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int t = 0; t < GEN_MAXT; ++t) {
      if (t < ntl) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = wm[t] * 32 + mi * 16 + g8 + 8 * h;
            const int il = m >> lw, j = m & (W - 1);
            uint32_t v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              v[q] = lgt::pack_bf16x2(acc[t][mi][q][2 * h],
                                      acc[t][mi][q][2 * h + 1]);
            lgt::quad_transpose(v, t4);
            *reinterpret_cast<uint4*>(
                dx + ((b * H + row0 + il) * W + j) * Ci + wn[t] * 32 +
                8 * t4) = make_uint4(v[0], v[1], v[2], v[3]);
          }
      }
    }
  }
  lgt::cp_async_wait(0);      // no copy in flight at exit
}

// The launch of either backward kernel: `general` picks the kernel, its
// shared memory (bwd_layout or gen_layout) and its threads.
cudaError_t bwd_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                       bool general, int csize, int nclusters, int W, int rt,
                       int Ci, int Co, int slots, cudaStream_t stream) {
  const size_t smem = general ? gen_layout(W, rt, Ci, slots).total
                              : bwd_layout(W, rt, Ci, Co, slots).total;
  const void* fn =
      general ? reinterpret_cast<const void*>(upsample_rows_bwd_general_kernel)
              : reinterpret_cast<const void*>(upsample_rows_bwd_kernel);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(nclusters * csize);
  cfg.blockDim = dim3(general ? BWD_MAXW * 32 : 32 * bwd_warps(W, rt, Ci));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Dynamic shared memory of one staged backward block (bwd_layout).
extern "C" size_t upsample_rows_bwd_smem(int W, int rt, int Ci, int Co,
                                         int slots) {
  return static_cast<size_t>(bwd_layout(W, rt, Ci, Co, slots).total);
}

// Dynamic shared memory of one general backward block (gen_layout).
extern "C" size_t upsample_rows_bwd_general_smem(int W, int rt, int Ci,
                                                 int slots) {
  return static_cast<size_t>(gen_layout(W, rt, Ci, slots).total);
}

// How many backward clusters of H / rt blocks the card holds at once: into
// *out.  Returns the query's error.
extern "C" int upsample_rows_bwd_max_clusters(int H, int W, int rt, int Ci,
                                              int Co, int slots, int general,
                                              int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = bwd_config(cfg, attr, general != 0, H / rt, 1, W, rt, Ci,
                               Co, slots, nullptr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(
        out,
        general
            ? reinterpret_cast<const void*>(upsample_rows_bwd_general_kernel)
            : reinterpret_cast<const void*>(upsample_rows_bwd_kernel),
        &cfg);
  return err == cudaSuccess ? 0 : failed(err);
}

// K1L backward.  g [B,2H,2W,Co] bf16 (the output cotangent), yf [B,H,W,4Co]
// bf16 and mu / rstd [B,Co] f32 (the forward's residuals; these four start
// on 16 bytes, for the bulk copies and 16-byte loads), gamma / beta [Co]
// f32, wpk (pack_taps_dx: [Ci/32][parity][Co/32][tap][32][32] bf16) -> dx
// [B,H,W,Ci] bf16, dyf [B,H,W,4Co] bf16 (the pre-norm cotangent, rounded
// where _make_rows_op rounds it) and part [nclusters][2][Co] f32 (each
// cluster's sum dout, sum dout * xn over its samples).  `general` launches
// the general kernel, which also takes xch [nclusters][2][H / rt][2][Co]
// f32 (the partial sums' exchange; not read before it is written); the
// staged kernel takes probe: null, or BWD_PHASES zeroed int64 that the
// first block's thread 0 adds its phases' nanoseconds to.  The grid is
// `nclusters` clusters of H / rt blocks.  The caller checks the shape rules
// (kernels/upsample_rows.py: bwd_tile for the staged kernel, bwd_general_tile
// for the general one) and the shared memory within the card's limit.
// Returns the launch's error.
extern "C" int upsample_rows_bwd(const void* g, const void* yf, const void* mu,
                                 const void* rstd, const void* gamma,
                                 const void* beta, const void* wpk, void* dx,
                                 void* dyf, void* part, void* xch, void* probe,
                                 int B, int H, int W, int Ci, int Co, int gs,
                                 int rt, int slots, int general, int nclusters,
                                 float slope, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      bwd_config(cfg, attr, general != 0, H / rt, nclusters, W, rt, Ci, Co,
                 slots, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return failed(err);
  const auto* g16 = static_cast<const __nv_bfloat16*>(g);
  const auto* yf16 = static_cast<const __nv_bfloat16*>(yf);
  const auto* w16 = static_cast<const __nv_bfloat16*>(wpk);
  if (general)
    err = cudaLaunchKernelEx(
        &cfg, upsample_rows_bwd_general_kernel, g16, yf16,
        static_cast<const float*>(mu), static_cast<const float*>(rstd),
        static_cast<const float*>(gamma), static_cast<const float*>(beta), w16,
        static_cast<__nv_bfloat16*>(dx), static_cast<__nv_bfloat16*>(dyf),
        static_cast<float*>(xch), static_cast<float*>(part), B, H, W, Ci, Co,
        gs, rt, slots, slope);
  else
    err = cudaLaunchKernelEx(
        &cfg, upsample_rows_bwd_kernel, g16, yf16,
        static_cast<const float*>(mu), static_cast<const float*>(rstd),
        static_cast<const float*>(gamma), static_cast<const float*>(beta), w16,
        static_cast<__nv_bfloat16*>(dx), static_cast<__nv_bfloat16*>(dyf),
        static_cast<float*>(part),
        static_cast<unsigned long long*>(probe), B, H, W, Ci, Co, gs, rt,
        slots, slope);
  if (err != cudaSuccess) return failed(err);
  return static_cast<int>(cudaGetLastError());
}

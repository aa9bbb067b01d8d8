// K2 fused: the critic trunk's forward and its exact input gradient, one
// cluster of two blocks per sample.
//
// Replaces levelgan/kernels/critic_grad.py:_make_fused.run (the Pallas call
// at :290, body _kernel).  From the critic's layer-0 activation a0 it returns
// dy0, the gradient of sum_b D(x)_b at layer 0's pre-activation:
//
//   forward, trunk layer l = 1..L:  y_l = conv4x4s2(a_{l-1}) (f32 accumulate)
//       rounded to bf16, + bias in bf16; GroupNorm in f32 (var = E[y^2] -
//       mean^2); a_l = LeakyReLU rounded to bf16;
//   the head:  d(sum score)/d(a_L) = head weights [4, 4, C_L];
//   reverse, l = L..1:  LeakyReLU backward from the sign of the GroupNorm
//       output, GroupNorm backward in f32, cotangent rounded to bf16, the
//       conv's input gradient (f32 accumulate) rounded to bf16;
//   layer 0:  LeakyReLU backward from the sign of a0.
//
// What bounds it.  At the 32x32 critic (64 -> 128 -> 256), B = 64: 4.29
// GFLOP, about 4.3 us at the tensor cores' peak, against 5.5 MB of inputs and
// outputs (1.6 us): the operations.  Every sample needs all the weights
// (1.25 MiB of bf16 per direction, 168 MB from L2 a call), but on an H100 a
// cluster alone takes as long as 64 of them (PERF.md section 6): what bounds it
// is each block's chain of dependent steps -- the latency of a chunk's
// fragment loads and products, four passes each waiting on the grid the
// one before it wrote, the epilogues and the exchanges between them -- not
// the card's L2 or its tensor-core rate.
//
// Ownership.  GroupNorm statistics are per (sample, group), so a sample's
// chain is independent of the others.  A sample is split over the two blocks
// of a cluster by output channels: in every GEMM pass block r computes the
// columns of its half (C_l forward, C_{l-1} backward).  Groups are 8 or 16
// channels and halves multiples of 32, so a group never straddles the
// blocks: every statistic and GroupNorm-backward sum is local to a block,
// in a fixed order, with no atomics.  After each layer's epilogue a block
// writes its half of the next bf16 grid (a_l forward, the cotangent of y_l
// backward) into its own shared memory and its peer's (distributed shared
// memory), then arrives on the peer's exchange mbarrier with release
// semantics at cluster scope; the peer waits on it before its next pass.
// Per block: a zero-haloed bf16 grid [(M_l+2)^2][C_l+8] per layer boundary
// (all channels: the next pass's K runs over them), its half of each y_l in
// bf16 (exact: y is rounded to bf16 before the bias is added; the reverse
// recomputes xn = (y - mean) * rstd), partial sums and the statistics.
//
// Weights.  A pack kernel (critic_trunk_pack) turns the f32 HWIO weights
// into one bf16 stream per block, in the order the block consumes it: per
// pass, per K step (tap, 64-channel chunk), per plane, 32-row sub-units of
// [32 GEMM columns][64 K], each row's 16-byte units XOR-swizzled by the row
// (u ^ (n % 8)) so that ldmatrix reads eight rows of one unit from eight
// bank groups without padding.  One producer warp walks the stream in 32 KB
// chunks (a 1-D bulk copy costs about the same per copy up to that size, so
// larger chunks stream faster): one thread issues cp.async.bulk, one
// contiguous copy a chunk, into a ring of 2-8 slots behind "full" mbarriers
// (transaction bytes); the 8 consumer warps wait on "full" and arrive on
// "empty", and no block-wide barrier runs inside a pass.  The producer
// queues the first round before a0 is staged and runs ahead across passes,
// so a pass's first chunks land during the previous epilogue.  Bias, gamma,
// beta and the block's half of the head sit in shared memory.
//
// Products.  mma.sync.m16n8k16 on ldmatrix.x4 fragments; a warp task is a
// 16-row x 32-column output tile (one A fragment feeds 4 mma, 3 ldmatrix per
// 4 mma), all 12 fragments of a sub-unit loaded before its 16 products, and
// the products spread over up to 4 independent accumulator sets (an mma's
// result reaches the next one on the same registers only after a long
// latency).  The passes are short in M: forward layer 2 has 16 output
// positions, and each reverse pass runs 4 parity planes of 16 or 64
// positions with 4 taps each, so a wgmma tile of 64 rows would idle 3/4 of
// itself on the M = 16 passes.  The reverse runs the 4 planes at once (each
// sub-unit belongs to one plane).  Where a pass has fewer tiles than
// consumer warps, 2-8 warps share a tile, each taking every ksplit-th K step,
// and their partial tiles are summed in a fixed order.  The A operand is
// gathered straight from the haloed grid (forward: at stride 2; reverse:
// one parity plane, at a 4x4 plane with rows taken as 0, 2, 1, 3).

#include <cooperative_groups.h>

#include "stage_common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int CS = 2;                       // blocks per sample (cluster)
constexpr int NCW = 8;                      // consumer warps
constexpr int CONSUMERS = NCW * 32;
constexpr int THREADS = CONSUMERS + 32;     // + the producer warp
constexpr int MAXL = 2;                     // trunk layers
constexpr int KC = 64;                      // K values of a sub-unit row
constexpr int SUB_ROWS = 32;                // rows (GEMM columns) a sub-unit
constexpr int SUB_BYTES = SUB_ROWS * KC * 2;
constexpr int CHUNK_SUBS = 8;               // sub-units a chunk
constexpr int CHUNK = CHUNK_SUBS * SUB_BYTES;
constexpr int PAD = 8;                      // grid row pitch = C + PAD (bf16)
constexpr int MAXT = 4;                     // warp tasks of a pass, at most
constexpr int GMAX = 32;                    // groups of a block's half

struct TrunkArgs {
  const bf16* a0;            // [B, M0, M0, C0]
  bf16* dy0;                 // [B, M0, M0, C0]
  const bf16* wpk;           // [CS][rank_elems], critic_trunk_pack
  long long rank_elems;
  const float* bias[MAXL];   // [Co]
  const float* gamma[MAXL];  // [Co], null without GroupNorm
  const float* beta[MAXL];
  const float* head;         // [16][C_L]
  int L, M0, C[MAXL + 1];
  int gs;                    // GroupNorm group size, 0 = no GroupNorm
  float slope, eps;
  int depth;                 // ring slots
  unsigned long long* probe; // null, or 2 + 4L phase time stamps
};

__host__ __device__ inline int ilog2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

// One GEMM pass of a block (kernels/critic_grad.py: passes).
struct Pass {
  int fwd, l, mo, kch, steps, planes, ng, mt, ntiles, ksplit, chunks;
};

__host__ __device__ inline Pass make_pass(int L, int M0, const int* C,
                                          int i) {
  Pass p;
  p.fwd = i < L;
  p.l = p.fwd ? i + 1 : 2 * L - i;
  const int ci = C[p.l - 1], co = C[p.l];
  p.mo = M0 >> p.l;
  p.kch = (p.fwd ? ci : co) / KC;
  p.planes = p.fwd ? 1 : 4;
  p.ng = (p.fwd ? co : ci) / CS / SUB_ROWS;
  p.mt = p.mo * p.mo / 16;
  p.ntiles = p.planes * p.mt * p.ng;
  p.ksplit = 1;
  while (p.ntiles * p.ksplit * 2 <= NCW) p.ksplit *= 2;
  p.steps = (p.fwd ? 16 : 4) * p.kch;
  p.chunks = p.steps * p.planes * p.ng / CHUNK_SUBS;
  return p;
}

// Byte offsets of a block's shared memory (kernels/critic_grad.py:
// smem_layout).
struct Layout {
  int ring, grid[MAXL + 1], y[MAXL + 1], part, red, stats, par, bars, total;
};

__host__ __device__ inline Layout make_layout(int L, int M0, const int* C,
                                              int depth) {
  Layout lay;
  int off = 0;
  lay.ring = 0;
  off += depth * CHUNK;
  for (int l = 0; l <= MAXL; ++l) {
    const int m = M0 >> l;
    lay.grid[l] = off;
    if (l <= L) off += (m + 2) * (m + 2) * (C[l] + PAD) * 2;
  }
  lay.y[0] = 0;
  int pn = 0;
  for (int l = 1; l <= MAXL; ++l) {
    const int m = M0 >> l;
    lay.y[l] = off;
    if (l <= L) {
      off += m * m * (C[l] / CS) * 2;
      const int rows = m * m / 16 * (C[l] / CS);
      pn = rows > pn ? rows : pn;
    }
  }
  lay.part = off;
  off += 2 * pn * 4;
  int rn = 0;
  for (int i = 0; i < 2 * L; ++i) {
    const Pass ps = make_pass(L, M0, C, i);
    const int r = ps.ntiles * (ps.ksplit - 1);
    rn = r > rn ? r : rn;
  }
  lay.red = off;
  off += rn * 512 * 4;
  lay.stats = off;
  off += (2 * MAXL + 2) * GMAX * 4;
  // bias, gamma, beta of each trunk layer, then the block's half of the head
  lay.par = off;
  for (int l = 1; l <= L; ++l) off += 3 * C[l] * 4;
  off += 16 * (C[L] / CS) * 4;
  lay.bars = off;
  off += (2 * depth + 1) * 8;
  lay.total = off;
  return lay;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

using lgt::bulk_copy;
using lgt::mbar_arrive;
using lgt::mbar_arrive_remote;
using lgt::mbar_expect_tx;
using lgt::mbar_init;
using lgt::mbar_wait;
using lgt::mbar_wait_cluster;

// The consumer warps' own barrier (the producer warp takes no part).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void stamp(unsigned long long* probe, int i) {
  if (probe != nullptr) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    probe[i] = now;
  }
}

// Row m of a pass's M -> (i, j) of its mo x mo output or plane.  At mo = 4
// the 16 rows are taken as image rows 0, 2, 1, 3, so that the eight rows
// one ldmatrix matrix reads from a reverse plane fall in eight bank groups
// (stage_common.cuh: row_pos).
__device__ __forceinline__ void pos_of(int m, int mo_log2, int& i, int& j) {
  if (mo_log2 == 2) {
    i = ((m >> 2) & 1) * 2 + ((m >> 3) & 1);
    j = m & 3;
  } else {
    i = m >> mo_log2;
    j = m & ((1 << mo_log2) - 1);
  }
}

// GroupNorm's output, written once for the forward and the reverse so that
// the LeakyReLU masks agree bit for bit.
__device__ __forceinline__ float gn_xn(float y, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(y, mean), rstd);
}

__device__ __forceinline__ float gn_out(float xn, float gamma, float beta) {
  return __fmaf_rn(xn, gamma, beta);
}

// A warp's tasks in a pass: task tau = warp + i * NCW of ntiles * ksplit is
// K group tau / ntiles of tile tau % ntiles = (mtile, plane, ng), M tile
// slowest.  abase: the byte offset in the A grid of the lane's ldmatrix row
// at step 0, its k half included.
struct Tasks {
  int n;
  int plane[MAXT], ng[MAXT], kg[MAXT], mtile[MAXT];
  int abase[MAXT];
};

__device__ __forceinline__ Tasks make_tasks(const Pass& ps, int warp,
                                            int lane, int lda, int wp,
                                            int mo_log2) {
  Tasks tk;
  tk.n = 0;
  const int per = ps.planes * ps.ng;
#pragma unroll
  for (int i = 0; i < MAXT; ++i) {
    const int tau = warp + i * NCW;
    const int tile = tau % ps.ntiles;
    tk.kg[i] = tau / ps.ntiles;
    tk.mtile[i] = tile / per;
    tk.plane[i] = (tile % per) / ps.ng;
    tk.ng[i] = tile % ps.ng;
    if (tau < ps.ntiles * ps.ksplit) tk.n = i + 1;
    int pi, pj;
    pos_of(tk.mtile[i] * 16 + (lane & 15), mo_log2, pi, pj);
    const int base =
        ps.fwd ? 2 * pi * wp + 2 * pj
               : (pi + 1 + (tk.plane[i] >> 1)) * wp + pj + 1 + (tk.plane[i] & 1);
    tk.abase[i] = base * lda + (lane >> 4) * 16;
  }
  return tk;
}

// The byte offset that K step (tap index, kc) adds to a row's A address:
// forward, tap (ky, kx) reads the haloed input at (2i + ky, 2j + kx);
// reverse, tap index tt = (ry, rx) of plane (cy, cx) reads the haloed
// cotangent at (u + 1 + cy - ry, v + 1 + cx - rx) through tap (1 - cy + 2ry,
// 1 - cx + 2rx) (the pack puts that tap there).
__device__ __forceinline__ int step_offset(bool fwd, int tap, int kc, int wp,
                                           int lda) {
  return (fwd ? ((tap >> 2) * wp + (tap & 3)) * lda
              : -((tap >> 1) * wp + (tap & 1)) * lda) +
         kc * KC * 2;
}

// One GEMM pass: acc[task] = its tile over the pass's K, chunk by chunk from
// the ring.  Every consumer warp waits on every chunk and releases it, those
// without a task in it too, so the producer never refills a slot early.
// An mma's result feeds the next one on the same accumulator only after a
// long latency, so task i sums into SETS independent accumulator sets (k16
// step kk into set kk % SETS: 4 sets where a warp has one task), folded in
// a fixed order at the end into acc[i].
template <int SETS>
__device__ __forceinline__ void gemm_pass(
    float (&acc)[MAXT][4][4], const Pass& ps, const Tasks& tk, uint32_t agrid,
    int lda, int wp, uint32_t ring, uint32_t full0, uint32_t empty0,
    int depth, int& slot, int& phase, const uint32_t (&boff)[4], int lane) {
  constexpr int NT = MAXT / SETS;     // tasks a warp can hold
#pragma unroll
  for (int i = 0; i < MAXT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;
  int step = 0, tap = 0, kc = 0, plane = 0, ng = 0;
  int soff = step_offset(ps.fwd, 0, 0, wp, lda);
  const int kmask = ps.ksplit - 1;
  for (int c = 0; c < ps.chunks; ++c) {
    mbar_wait(full0 + 8 * slot, phase);
    const uint32_t sb = ring + slot * CHUNK;
#pragma unroll 1
    for (int j = 0; j < CHUNK_SUBS; ++j) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (i < tk.n && tk.plane[i] == plane && tk.ng[i] == ng &&
            (step & kmask) == tk.kg[i]) {
          const uint32_t a = agrid + tk.abase[i] + soff;
          const uint32_t bs = sb + j * SUB_BYTES;
          // all fragments of the sub-unit first, then its 16 products: the
          // loads' latency is paid once, not once per k16 step
          uint32_t af[KC / 16][4], b0[KC / 16][4], b1[KC / 16][4];
#pragma unroll
          for (int kk = 0; kk < KC / 16; ++kk) {
            lgt::ldsm4(af[kk], a + kk * 32);
            lgt::ldsm4(b0[kk], bs + boff[kk]);
            lgt::ldsm4(b1[kk], bs + boff[kk] + 16 * KC * 2);
          }
#pragma unroll
          for (int kk = 0; kk < KC / 16; ++kk) {
            float (&d)[4][4] = acc[i * SETS + kk % SETS];
            lgt::mma16816(d[0], af[kk], b0[kk][0], b0[kk][1]);
            lgt::mma16816(d[1], af[kk], b0[kk][2], b0[kk][3]);
            lgt::mma16816(d[2], af[kk], b1[kk][0], b1[kk][1]);
            lgt::mma16816(d[3], af[kk], b1[kk][2], b1[kk][3]);
          }
        }
      }
      if (++ng == ps.ng) {
        ng = 0;
        if (++plane == ps.planes) {
          plane = 0;
          ++step;
          if (++kc == ps.kch) {
            kc = 0;
            ++tap;
          }
          soff = step_offset(ps.fwd, tap, kc, wp, lda);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
    if (++slot == depth) {
      slot = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int st = 0; st < SETS; ++st)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][q][e] = st == 0 ? acc[i * SETS][q][e]
                                 : acc[i][q][e] + acc[i * SETS + st][q][e];
}

// Sums of v over the 8 rows g of a warp's accumulator layout (lanes with
// the same t); every lane gets the sum.
__device__ __forceinline__ float sum_rows(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// The two sums of each GroupNorm group of a block's half from the partials
// part[r][c] (rows x nh, then the second sum's rows x nh): one consumer warp
// a group, lanes over (row, channel) in a fixed order, then a butterfly;
// lane 0 hands them to out(group, sum 1, sum 2).
template <typename F>
__device__ __forceinline__ void group_sums(const float* part, int rows,
                                           int nh, int gs, int gsl, F out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int gr = warp; gr < (nh >> gsl); gr += NCW) {
    float a1 = 0.f, a2 = 0.f;
    for (int e = lane; e < (rows << gsl); e += 32) {
      const int at = (e >> gsl) * nh + (gr << gsl) + (e & (gs - 1));
      a1 += part[at];
      a2 += part[rows * nh + at];
    }
    a1 = lgt::warp_sum(a1);
    a2 = lgt::warp_sum(a2);
    if (lane == 0) out(gr, a1, a2);
  }
}

// Row of the haloed grid (width wp) that accumulator row m of a pass
// writes: position (st i + cy, st j + cx) for (i, j) = pos_of(m), plus the
// halo (forward: st = 1, no parity; reverse: st = 2, the plane's parity).
__device__ __forceinline__ int grid_row(int m, int mo_log2, int cy, int cx,
                                        int st, int wp) {
  int i, j;
  pos_of(m, mo_log2, i, j);
  return (st * i + cy + 1) * wp + st * j + cx + 1;
}

// A quad holds channels 2t, 2t+1 of the four n8 tiles of one row (w[q]):
// transposed across the quad, lane t stores tile t's 8 channels as one
// 16-byte word, here and in the peer block (`at`: the row's first channel).
__device__ __forceinline__ void store_row(bf16* here, bf16* peer,
                                          uint32_t (&w)[4], int t, int at) {
  lgt::quad_transpose(w, t);
  const uint4 u = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(here + at + 8 * t) = u;
  *reinterpret_cast<uint4*>(peer + at + 8 * t) = u;
}

__global__ void __launch_bounds__(THREADS, 1)
critic_trunk_grad_kernel(const TrunkArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int peer = rank ^ 1;
  const int b = blockIdx.x / CS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int L = p.L, depth = p.depth;
  const Layout lay = make_layout(L, p.M0, p.C, depth);
  const uint32_t sbase = lgt::smem_addr(smem);
  const uint32_t full0 = sbase + lay.bars, empty0 = full0 + 8 * depth;
  const uint32_t xch = full0 + 16 * depth;
  unsigned long long* probe =
      (b == 0 && rank == 0 && tid == 0) ? p.probe : nullptr;
  int ns = 0;                // stamps: entry, staged, then per phase
  stamp(probe, ns++);

  // the producer: its thread sets up the barriers and queues the first
  // `depth` chunks at once, under the staging of a0
  const bool producer = warp == NCW && lane == 0;
  const unsigned char* wsrc =
      reinterpret_cast<const unsigned char*>(p.wpk + rank * p.rank_elems);
  int total = 0;
  if (producer) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NCW);
    }
    mbar_init(xch, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < 2 * L; ++i) total += make_pass(L, p.M0, p.C, i).chunks;
    for (int c = 0; c < depth && c < total; ++c) {
      mbar_expect_tx(full0 + 8 * c, CHUNK);
      bulk_copy(sbase + lay.ring + c * CHUNK,
                wsrc + static_cast<size_t>(c) * CHUNK, CHUNK, full0 + 8 * c);
    }
  }

  // ---- zero the halos of grids 1..L (the passes write every interior
  // position before it is read), stage a0 with its halo and the parameters
  {
    for (int l = 1; l <= L; ++l) {
      const int m = p.M0 >> l, wp = m + 2, vec = p.C[l] / 8;
      bf16* gl = reinterpret_cast<bf16*>(smem + lay.grid[l]);
      for (int idx = tid; idx < 4 * (m + 1) * vec; idx += THREADS) {
        const int e = idx / vec, v = idx - e * vec;
        const int f = e - 2 * wp;       // left / right columns, rows 1..m
        const int i = e < wp ? 0 : e < 2 * wp ? wp - 1 : 1 + (f >> 1);
        const int j = e < wp ? e : e < 2 * wp ? e - wp : (f & 1) * (wp - 1);
        *reinterpret_cast<uint4*>(gl + (i * wp + j) * (p.C[l] + PAD) + v * 8) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float* par = reinterpret_cast<float*>(smem + lay.par);
    int off = 0;
    for (int l = 1; l <= L; ++l) {
      const int q4 = p.C[l] / 4;
      const float* src[3] = {p.bias[l - 1], p.gamma[l - 1], p.beta[l - 1]};
      for (int idx = tid; idx < 3 * q4; idx += THREADS) {
        const int which = idx / q4, v = idx - which * q4;
        if (src[which] != nullptr)
          lgt::cp_async16(lgt::smem_addr(par + off + which * p.C[l] + v * 4),
                          src[which] + v * 4);
      }
      off += 3 * p.C[l];
    }
    const int nhl = p.C[L] / CS;
    for (int idx = tid; idx < 16 * nhl / 4; idx += THREADS) {
      const int q = idx / (nhl / 4), v = idx - q * (nhl / 4);
      lgt::cp_async16(lgt::smem_addr(par + off + q * nhl + v * 4),
                      p.head + q * p.C[L] + rank * nhl + v * 4);
    }
    const int M = p.M0, wp = M + 2, C = p.C[0], vec = C / 8, ld = C + PAD;
    bf16* g0 = reinterpret_cast<bf16*>(smem + lay.grid[0]);
    for (int idx = tid; idx < wp * wp * vec; idx += THREADS) {
      const int pos = idx / vec, v = idx - pos * vec;
      const int i = pos / wp, j = pos - i * wp;
      bf16* dst = g0 + pos * ld + v * 8;
      if (i >= 1 && i <= M && j >= 1 && j <= M)
        lgt::cp_async16(
            lgt::smem_addr(dst),
            p.a0 + ((static_cast<size_t>(b) * M + i - 1) * M + j - 1) * C +
                v * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    lgt::cp_async_commit();
    lgt::cp_async_wait(0);
  }
  // the barriers are initialised and the grids zeroed in both blocks before
  // either writes into the other
  cluster.sync();
  stamp(probe, ns++);

  if (warp == NCW) {
    // ---- the producer: the block's whole weight stream, chunk by chunk ---
    if (producer) {
      int s = 0, ph = 1;             // the first round went out above
      for (int c = depth; c < total; ++c) {
        mbar_wait(empty0 + 8 * s, ph ^ 1);
        mbar_expect_tx(full0 + 8 * s, CHUNK);
        bulk_copy(sbase + lay.ring + s * CHUNK,
                  wsrc + static_cast<size_t>(c) * CHUNK, CHUNK, full0 + 8 * s);
        if (++s == depth) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- the consumers --------------------------------------------------------
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* stats = reinterpret_cast<float*>(smem + lay.stats);
  float* m1 = stats + 2 * MAXL * GMAX;
  float* m2 = m1 + GMAX;
  // bias, gamma, beta of trunk layer l (smem copies)
  const float* par = reinterpret_cast<const float*>(smem + lay.par);
  auto lpar = [&](int l) { return par + (l == 1 ? 0 : 3 * p.C[1]); };
  const float* headp = par + 3 * (p.C[1] + (L == 2 ? p.C[2] : 0));
  const bool gn = p.gs > 0;
  const int gs = p.gs, gsl = gn ? ilog2(p.gs) : 0;
  const float slope = p.slope;
  // B fragment offsets in a sub-unit: lane names row (lane & 7) + 8 * (lane
  // >> 4), 16-byte unit 2 kk + (lane >> 3) % 2, swizzled by the row
  uint32_t boff[4];
  {
    const int brow = (lane & 7) + 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      boff[kk] = brow * KC * 2 +
                 (((2 * kk + ((lane >> 3) & 1)) ^ (brow & 7)) * 16);
  }
  int slot = 0, phase = 0, xph = 0;
  float acc[MAXT][4][4];

  // waits until the peer's half of the grid just written has landed here
  auto exchange = [&]() {
    mbar_arrive_remote(xch, peer);
    consumer_sync();
    mbar_wait_cluster(xch, xph);
    xph ^= 1;
  };

  for (int pi = 0; pi < 2 * L; ++pi) {
    const Pass ps = make_pass(L, p.M0, p.C, pi);
    const int l = ps.l, mo = ps.mo, mo_log2 = ilog2(mo);
    const int ga = ps.fwd ? l - 1 : l;     // the A grid
    const int wp = (ps.fwd ? 2 * mo : mo) + 2;
    const int lda = (p.C[ga] + PAD) * 2;
    const Tasks tk = make_tasks(ps, warp, lane, lda, wp, mo_log2);
    const int per_warp = (ps.ntiles * ps.ksplit + NCW - 1) / NCW;
    if (per_warp == 1)
      gemm_pass<4>(acc, ps, tk, sbase + lay.grid[ga], lda, wp,
                   sbase + lay.ring, full0, empty0, depth, slot, phase, boff,
                   lane);
    else if (per_warp == 2)
      gemm_pass<2>(acc, ps, tk, sbase + lay.grid[ga], lda, wp,
                   sbase + lay.ring, full0, empty0, depth, slot, phase, boff,
                   lane);
    else
      gemm_pass<1>(acc, ps, tk, sbase + lay.grid[ga], lda, wp,
                   sbase + lay.ring, full0, empty0, depth, slot, phase, boff,
                   lane);
    if (ps.fwd || l > 1) stamp(probe, ns++);

    // split K: the tile's owner adds the other groups' partial tiles
    int nout = tk.n;
    if (ps.ksplit > 1) {
      nout = tk.n > 0 && tk.kg[0] == 0 ? 1 : 0;
      if (tk.n > 0 && tk.kg[0] > 0) {
        float4* r = reinterpret_cast<float4*>(red) +
                    (warp - ps.ntiles) * 4 * 32 + lane;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          r[q * 32] = make_float4(acc[0][q][0], acc[0][q][1], acc[0][q][2],
                                  acc[0][q][3]);
      }
      consumer_sync();
      if (nout) {
        for (int k = 1; k < ps.ksplit; ++k) {
          const float4* r = reinterpret_cast<const float4*>(red) +
                            (k * ps.ntiles + warp - ps.ntiles) * 4 * 32 +
                            lane;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = r[q * 32];
            acc[0][q][0] += v.x;
            acc[0][q][1] += v.y;
            acc[0][q][2] += v.z;
            acc[0][q][3] += v.w;
          }
        }
      }
    }

    if (ps.fwd) {
      // ---- forward epilogue: y, statistics, a_l to both blocks ------------
      const int co = p.C[l], nh = co / CS, c0 = rank * nh, P = mo * mo;
      bf16* ybuf = reinterpret_cast<bf16*>(smem + lay.y[l]);
      float* mean = stats + (l - 1) * GMAX;
      float* rstd = stats + (MAXL + l - 1) * GMAX;
      const float* bias = lpar(l);
      const float* gamma = bias + co;
      const float* beta = gamma + co;
      const int rows = ps.mt;
#pragma unroll
      for (int i = 0; i < MAXT; ++i) {
        if (i < nout) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int cl = tk.ng[i] * 32 + q * 8 + 2 * t;
            const float b0 = bf16r(bias[c0 + cl]), b1 = bf16r(bias[c0 + cl + 1]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              int yi, yj;
              pos_of(tk.mtile[i] * 16 + g + 8 * h, mo_log2, yi, yj);
              const float v0 = bf16r(bf16r(acc[i][q][2 * h]) + b0);
              const float v1 = bf16r(bf16r(acc[i][q][2 * h + 1]) + b1);
              acc[i][q][2 * h] = v0;
              acc[i][q][2 * h + 1] = v1;
              *reinterpret_cast<__nv_bfloat162*>(
                  ybuf + (yi * mo + yj) * nh + cl) =
                  __floats2bfloat162_rn(v0, v1);
            }
            if (gn) {
#pragma unroll
              for (int col = 0; col < 2; ++col) {
                const float u0 = acc[i][q][col], u1 = acc[i][q][2 + col];
                const float s1 = sum_rows(u0 + u1);
                const float s2 = sum_rows(u0 * u0 + u1 * u1);
                if (g == 0) {
                  part[tk.mtile[i] * nh + cl + col] = s1;
                  part[(rows + tk.mtile[i]) * nh + cl + col] = s2;
                }
              }
            }
          }
        }
      }
      if (gn) {
        consumer_sync();
        const float cnt = static_cast<float>(gs * P);
        group_sums(part, rows, nh, gs, gsl, [&](int gr, float a1, float a2) {
          const float mu = a1 / cnt;
          mean[gr] = mu;
          rstd[gr] = rsqrtf(a2 / cnt - mu * mu + p.eps);
        });
        consumer_sync();
      }
      if (l < L) {
        const int ld = co + PAD;
        bf16* gl = reinterpret_cast<bf16*>(smem + lay.grid[l]);
        bf16* gp = cluster.map_shared_rank(gl, peer);
#pragma unroll
        for (int i = 0; i < MAXT; ++i) {
          if (i < nout) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t w[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int cl = tk.ng[i] * 32 + q * 8 + 2 * t, c = c0 + cl;
                float o[2];
#pragma unroll
                for (int col = 0; col < 2; ++col) {
                  o[col] = acc[i][q][2 * h + col];
                  if (gn) {
                    const int gr = (cl + col) >> gsl;
                    o[col] = gn_out(gn_xn(o[col], mean[gr], rstd[gr]),
                                    gamma[c + col], beta[c + col]);
                  }
                  o[col] = o[col] >= 0.f ? o[col] : slope * o[col];
                }
                w[q] = lgt::pack_bf16x2(o[0], o[1]);
              }
              store_row(gl, gp, w, t,
                        grid_row(tk.mtile[i] * 16 + g + 8 * h, mo_log2, 0, 0,
                                 1, mo + 2) * ld + c0 + tk.ng[i] * 32);
            }
          }
        }
        exchange();
        stamp(probe, ns++);
      } else {
        stamp(probe, ns++);
        // ---- the head: cotangent of y_L from the head's weights ----------
        if (!gn) consumer_sync();          // every warp's y_L is in ybuf
        const int ld = co + PAD;
        auto dxhat = [&](int q, int c, float& xn) {
          const float y = __bfloat162float(ybuf[q * nh + c]);
          float d = headp[q * nh + c], o = y;
          xn = y;
          if (gn) {
            const int gr = c >> gsl;
            xn = gn_xn(y, mean[gr], rstd[gr]);
            o = gn_out(xn, gamma[c0 + c], beta[c0 + c]);
          }
          d = o >= 0.f ? d : slope * d;
          return gn ? d * gamma[c0 + c] : d;
        };
        if (gn) {
          for (int c = tid; c < nh; c += CONSUMERS) {
            float a1 = 0.f, a2 = 0.f;
#pragma unroll
            for (int q = 0; q < 16; ++q) {     // P = 16: the head is 4 x 4
              float xn;
              const float d = dxhat(q, c, xn);
              a1 += d;
              a2 += d * xn;
            }
            part[c] = a1;
            part[nh + c] = a2;
          }
          consumer_sync();
          const float cnt = static_cast<float>(gs * P);
          group_sums(part, 1, nh, gs, gsl, [&](int gr, float a1, float a2) {
            m1[gr] = a1 / cnt;
            m2[gr] = a2 / cnt;
          });
          consumer_sync();
        }
        bf16* gl = reinterpret_cast<bf16*>(smem + lay.grid[L]);
        bf16* gp = cluster.map_shared_rank(gl, peer);
        for (int idx = tid; idx < P * nh / 8; idx += CONSUMERS) {
          const int q = idx / (nh / 8), c = 8 * (idx - q * (nh / 8));
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v[2];
#pragma unroll
            for (int col = 0; col < 2; ++col) {
              float xn;
              v[col] = dxhat(q, c + 2 * e + col, xn);
              if (gn) {
                const int gr = (c + 2 * e + col) >> gsl;
                v[col] = rstd[gr] * (v[col] - m1[gr] - xn * m2[gr]);
              }
            }
            w[e] = lgt::pack_bf16x2(v[0], v[1]);
          }
          const int at = (((q >> 2) + 1) * (mo + 2) + (q & 3) + 1) * ld + c0 + c;
          const uint4 u = make_uint4(w[0], w[1], w[2], w[3]);
          *reinterpret_cast<uint4*>(gl + at) = u;
          *reinterpret_cast<uint4*>(gp + at) = u;
        }
        exchange();
        stamp(probe, ns++);
      }
      continue;
    }

    // ---- reverse epilogue: the cotangent of a_{l-1} ------------------------
    const int k = l - 1, ck = p.C[k], nh = ck / CS, c0 = rank * nh;
    const int mk = 2 * mo;                 // side of layer k's grid
    if (k == 0) {
      // layer 0's LeakyReLU backward from the sign of a0, dy0 out
      const bf16* g0 = reinterpret_cast<const bf16*>(smem + lay.grid[0]);
#pragma unroll
      for (int i = 0; i < MAXT; ++i) {
        if (i < nout) {
          const int cy = tk.plane[i] >> 1, cx = tk.plane[i] & 1;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int u, v;
            pos_of(tk.mtile[i] * 16 + g + 8 * h, mo_log2, u, v);
            const int yy = 2 * u + cy, xx = 2 * v + cx;
            uint32_t w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = c0 + tk.ng[i] * 32 + q * 8 + 2 * t;
              const float2 a = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      g0 + ((yy + 1) * (mk + 2) + xx + 1) * (ck + PAD) + c));
              float v0 = bf16r(acc[i][q][2 * h]);
              float v1 = bf16r(acc[i][q][2 * h + 1]);
              v0 = a.x >= 0.f ? v0 : slope * v0;
              v1 = a.y >= 0.f ? v1 : slope * v1;
              w[q] = lgt::pack_bf16x2(v0, v1);
            }
            lgt::quad_transpose(w, t);
            *reinterpret_cast<uint4*>(
                p.dy0 + ((static_cast<size_t>(b) * mk + yy) * mk + xx) * ck +
                c0 + tk.ng[i] * 32 + 8 * t) = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      }
      stamp(probe, ns++);
      continue;
    }

    // LeakyReLU and GroupNorm backward of layer k, its cotangent of y_k to
    // both blocks
    const bf16* ybuf = reinterpret_cast<const bf16*>(smem + lay.y[k]);
    const float* mean = stats + (k - 1) * GMAX;
    const float* rstd = stats + (MAXL + k - 1) * GMAX;
    const float* gamma = lpar(k) + ck;
    const float* beta = gamma + ck;
    const int rows = 4 * ps.mt, P = mk * mk;
    // dxhat (and xn) at accumulator (task i, n8 tile q, row half h, col)
    auto dxhat = [&](int i, int q, int h, int col, float& xn) {
      const int cl = tk.ng[i] * 32 + q * 8 + 2 * t + col;
      int u, v;
      pos_of(tk.mtile[i] * 16 + g + 8 * h, mo_log2, u, v);
      const int pos = (2 * u + (tk.plane[i] >> 1)) * mk + 2 * v +
                      (tk.plane[i] & 1);
      const float y = __bfloat162float(ybuf[pos * nh + cl]);
      float d = bf16r(acc[i][q][2 * h + col]), o = y;
      xn = y;
      if (gn) {
        const int gr = cl >> gsl;
        xn = gn_xn(y, mean[gr], rstd[gr]);
        o = gn_out(xn, gamma[c0 + cl], beta[c0 + cl]);
      }
      d = o >= 0.f ? d : slope * d;
      return gn ? d * gamma[c0 + cl] : d;
    };
    if (gn) {
#pragma unroll
      for (int i = 0; i < MAXT; ++i) {
        if (i < nout) {
          const int r = tk.plane[i] * ps.mt + tk.mtile[i];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int col = 0; col < 2; ++col) {
              float s1 = 0.f, s2 = 0.f;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float xn;
                const float d = dxhat(i, q, h, col, xn);
                s1 += d;
                s2 += d * xn;
              }
              s1 = sum_rows(s1);
              s2 = sum_rows(s2);
              if (g == 0) {
                const int cl = tk.ng[i] * 32 + q * 8 + 2 * t + col;
                part[r * nh + cl] = s1;
                part[(rows + r) * nh + cl] = s2;
              }
            }
          }
        }
      }
      consumer_sync();
      const float cnt = static_cast<float>(gs * P);
      group_sums(part, rows, nh, gs, gsl, [&](int gr, float a1, float a2) {
        m1[gr] = a1 / cnt;
        m2[gr] = a2 / cnt;
      });
      consumer_sync();
    }
    {
      const int ld = ck + PAD;
      bf16* gl = reinterpret_cast<bf16*>(smem + lay.grid[k]);
      bf16* gp = cluster.map_shared_rank(gl, peer);
#pragma unroll
      for (int i = 0; i < MAXT; ++i) {
        if (i < nout) {
          const int cy = tk.plane[i] >> 1, cx = tk.plane[i] & 1;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int cl = tk.ng[i] * 32 + q * 8 + 2 * t;
              float v[2];
#pragma unroll
              for (int col = 0; col < 2; ++col) {
                float xn;
                v[col] = dxhat(i, q, h, col, xn);
                if (gn) {
                  const int gr = (cl + col) >> gsl;
                  v[col] = rstd[gr] * (v[col] - m1[gr] - xn * m2[gr]);
                }
              }
              w[q] = lgt::pack_bf16x2(v[0], v[1]);
            }
            store_row(gl, gp, w, t,
                      grid_row(tk.mtile[i] * 16 + g + 8 * h, mo_log2, cy, cx,
                               2, mk + 2) * ld + c0 + tk.ng[i] * 32);
          }
        }
      }
    }
    exchange();
    stamp(probe, ns++);
  }
}

// One thread per 16 bytes of the streams: the unit's pass, sub-unit, row
// and swizzled position, then 8 weights gathered from HWIO f32.
__global__ void __launch_bounds__(256)
critic_trunk_pack_kernel(const float* __restrict__ w1,
                         const float* __restrict__ w2, bf16* __restrict__ out,
                         int L, int C0, int C1, int C2, long long rank_units) {
  const long long u =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= CS * rank_units) return;
  const int r = static_cast<int>(u / rank_units);
  long long v = u - r * rank_units;
  const int C[MAXL + 1] = {C0, C1, C2};
  Pass ps = make_pass(L, 4 << L, C, 0);
  for (int i = 0; i < 2 * L; ++i) {
    ps = make_pass(L, 4 << L, C, i);
    const long long units = static_cast<long long>(ps.chunks) * (CHUNK / 16);
    if (v < units) break;
    v -= units;
  }
  const int sub = static_cast<int>(v / (SUB_BYTES / 16));
  const int rem = static_cast<int>(v % (SUB_BYTES / 16));
  const int n = rem >> 3, unit = (rem & 7) ^ (n & 7);
  const int per = ps.planes * ps.ng;
  const int step = sub / per, plane = (sub % per) / ps.ng, ng = sub % ps.ng;
  const int ci = C[ps.l - 1], co = C[ps.l];
  const float* w = ps.l == 1 ? w1 : w2;
  const int tap = step / ps.kch, kc = step % ps.kch;
  float val[8];
  if (ps.fwd) {
    const int cout = r * (co / CS) + ng * SUB_ROWS + n;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      val[e] = w[(static_cast<size_t>(tap) * ci + kc * KC + unit * 8 + e) * co +
                 cout];
  } else {
    const int cy = plane >> 1, cx = plane & 1, ry = tap >> 1, rx = tap & 1;
    const int kh = 1 - cy + 2 * ry, kw = 1 - cx + 2 * rx;
    const int cin = r * (ci / CS) + ng * SUB_ROWS + n;
    const float* src = w + (static_cast<size_t>(kh * 4 + kw) * ci + cin) * co +
                       kc * KC + unit * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) val[e] = src[e];
  }
  uint4 o;
  o.x = lgt::pack_bf16x2(val[0], val[1]);
  o.y = lgt::pack_bf16x2(val[2], val[3]);
  o.z = lgt::pack_bf16x2(val[4], val[5]);
  o.w = lgt::pack_bf16x2(val[6], val[7]);
  reinterpret_cast<uint4*>(out)[u] = o;
}

// An error of a set-up call is not sticky, but it stays the runtime's last
// error: clear it, or the next launch's cudaGetLastError reports it.
int failed(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// Dynamic shared memory of one block with a ring of `depth` chunks, bytes.
extern "C" int critic_trunk_grad_smem(int L, int M0, int C0, int C1, int C2,
                                      int depth) {
  const int C[MAXL + 1] = {C0, C1, C2};
  return make_layout(L, M0, C, depth).total;
}

// w1 [4,4,C0,C1], w2 [4,4,C1,C2] (L = 2) f32 HWIO -> out [CS][rank_elems]
// bf16, the blocks' weight streams (kernels/critic_grad.py:
// pack_weights_plain).  Returns the launch's error.
extern "C" int critic_trunk_pack(const void* w1, const void* w2, void* out,
                                 int L, int C0, int C1, int C2,
                                 void* stream) {
  const int C[MAXL + 1] = {C0, C1, C2};
  long long units = 0;
  for (int l = 1; l <= L; ++l)
    units += 2LL * 16 * C[l - 1] * C[l] / CS / 8;
  const long long total = CS * units;
  critic_trunk_pack_kernel<<<static_cast<unsigned>((total + 255) / 256), 256,
                             0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<bf16*>(out), L, C0, C1, C2, units);
  return static_cast<int>(cudaGetLastError());
}

// a0 [B,M0,M0,C0] bf16 -> dy0 (same).  wpk: critic_trunk_pack's streams,
// rank_elems bf16 each.  Per trunk layer l = 1..L: bias [Co] f32 and, with
// GroupNorm (gs > 0), gamma / beta [Co] f32; head [4,4,C_L] f32.  The grid
// is B clusters of CS blocks.  The caller checks the shape rules: L in {1,
// 2}, M0 = 4 * 2^L, every C a multiple of 64, gs in {0, 8, 16}, at most 32
// (16-row, 16-column) tiles per GEMM pass, and picks a ring of `depth`
// chunks whose shared memory fits.  `probe`, where not null, receives 2 + 4L
// time stamps of the first block (kernels/critic_grad.py: phase_names).
// Returns the launch's error.
extern "C" int critic_trunk_grad(
    const void* a0, void* dy0, const void* wpk, long long rank_elems,
    const void* bias1, const void* gamma1, const void* beta1,
    const void* bias2, const void* gamma2, const void* beta2,
    const void* head, int B, int L, int M0, int C0, int C1, int C2, int gs,
    float slope, float eps, int depth, void* probe, void* stream) {
  TrunkArgs p;
  p.a0 = static_cast<const bf16*>(a0);
  p.dy0 = static_cast<bf16*>(dy0);
  p.wpk = static_cast<const bf16*>(wpk);
  p.rank_elems = rank_elems;
  p.bias[0] = static_cast<const float*>(bias1);
  p.gamma[0] = static_cast<const float*>(gamma1);
  p.beta[0] = static_cast<const float*>(beta1);
  p.bias[1] = static_cast<const float*>(bias2);
  p.gamma[1] = static_cast<const float*>(gamma2);
  p.beta[1] = static_cast<const float*>(beta2);
  p.head = static_cast<const float*>(head);
  p.L = L;
  p.M0 = M0;
  p.C[0] = C0;
  p.C[1] = C1;
  p.C[2] = C2;
  p.gs = gs;
  p.slope = slope;
  p.eps = eps;
  p.depth = depth;
  p.probe = static_cast<unsigned long long*>(probe);
  const int smem = make_layout(L, M0, p.C, depth).total;
  cudaError_t err = cudaFuncSetAttribute(
      critic_trunk_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return failed(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * CS);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, critic_trunk_grad_kernel, p);
  if (err != cudaSuccess) return failed(err);
  return static_cast<int>(cudaGetLastError());
}

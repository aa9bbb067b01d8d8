// K2 fused: the critic trunk's forward and its exact input gradient, one
// block per sample.
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
// Ownership.  GroupNorm statistics are per (sample, group) and the whole
// chain of a sample depends on that sample only, so one block owns one
// sample: every reduction is local to the block, runs in a fixed order (no
// atomics), and no intermediate reaches device memory.  In shared memory,
// per layer boundary l = 0..L a zero-haloed bf16 grid [(M_l+2)^2][C_l+8]
// that holds a_l on the way forward and the cotangent of y_l on the way
// back (same shape), and per trunk layer the f32 normalised values; at the
// 32x32 critic (64 -> 128 -> 256) about 215 KB, so the launch needs
// cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// The convolutions are gather GEMMs on mma.sync.m16n8k16: rows are output
// positions (forward: M_l^2 of them, each tap reads a0 at stride 2; reverse:
// one parity plane of the input grid at a time, which only 4 of the 16 taps
// reach, the exact transpose of the forward mapping), columns are channels,
// and K runs over taps x channels.  The A operand is read straight from the
// haloed grid; the weights (1.25 MiB of bf16 at the 32x32 critic) stay in
// device memory and are staged tap by tap in chunks of KC channels with
// cp.async into a ring of 2 to 4 buffers (as many as the pass's row count
// lets fit), so chunks load while the chunks before are multiplied.
//
// What bounds it on an H100 at the 32x32 critic, B = 64: 4.29 GFLOP, about
// 4.3 us at the tensor cores' peak, against 5.5 MB (1.6 us).  This version
// is far from that, and a block alone on the card takes as long as 64 of
// them: what a block waits for is inside its SM.  Timed by phase on an
// H100, of about 140 us: the fragment loads from shared memory (a 16 x 16
// warp tile reads 512 bytes per mma, about 58 us), queueing the cp.async
// copies (about 0.2 us per chunk, 144 chunks), the two-deep ring of the
// widest pass (256 rows: its loads' latency shows, about 15 us), the
// barrier and loop bookkeeping of a chunk (about 25 us), and the GroupNorm
// passes (about 16 us).  Larger warp tiles, bulk (TMA) copies of pre-packed
// chunks and a sample shared by the two blocks of a cluster are the next
// steps; the blocks use 64 of the 132 SMs at B = 64.

#include "stage_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int MAXL = 2;          // trunk layers
constexpr int KC = 64;           // K columns per staged weight chunk
constexpr int LDW = KC + 8;      // pitch of a staged weight row (bf16)
constexpr int PAD = 8;           // grid row pitch = C + PAD (bf16)
constexpr int MAXT = 2;          // (M tile, column chunk) tasks per warp
constexpr int NQ = 2;            // n8 tiles per task
constexpr int NT = 8 * NQ;       // columns per task
constexpr int MAXD = 4;          // staged weight chunks in flight, at most
constexpr int SMEM_MAX = 232448; // dynamic shared memory of a block, sm_90

struct TrunkArgs {
  const bf16* a0;            // [B, M0, M0, C0]
  bf16* dy0;                 // [B, M0, M0, C0]
  const bf16* wf[MAXL];      // [16][Co][Ci], tap = kh * 4 + kw
  const bf16* wb[MAXL];      // [16][Ci][Co]
  const float* bias[MAXL];   // [Co]
  const float* gamma[MAXL];  // [Co], null without GroupNorm
  const float* beta[MAXL];
  const float* head;         // [16][C_L]
  int L, M0, C[MAXL + 1];
  int gs;                    // GroupNorm group size, 0 = no GroupNorm
  float slope, eps;
  unsigned long long* probe; // null, or 2 + 4L phase time stamps of block 0
};

// Byte offsets of the block's shared memory.
struct Layout {
  int grid[MAXL + 1];
  int xn[MAXL + 1];          // xn[0] unused
  int ws, ws_rows;           // the weight ring and its rows of LDW bf16
  int s1, s2, gm, rstd, total;
};

__host__ __device__ inline int grid_bytes(int m, int c) {
  return (m + 2) * (m + 2) * (c + PAD) * static_cast<int>(sizeof(bf16));
}

__host__ __device__ inline Layout make_layout(int L, int M0, const int* C) {
  Layout lay;
  int off = 0, cmax = 0;
  for (int l = 0; l <= MAXL; ++l) {
    lay.grid[l] = off;
    lay.xn[l] = 0;
    if (l <= L) {
      off += grid_bytes(M0 >> l, C[l]);
      cmax = C[l] > cmax ? C[l] : cmax;
    }
  }
  for (int l = 1; l <= L; ++l) {
    const int m = M0 >> l;
    lay.xn[l] = off;
    off += m * m * C[l] * 4;
  }
  // the ring holds MAXD chunks of the widest pass where that fits, and at
  // least 2 (narrower passes then get more chunks in flight)
  const int row = LDW * static_cast<int>(sizeof(bf16));
  const int tail = (3 + MAXL) * cmax * 4;
  int depth = MAXD;
  while (depth > 2 && off + depth * cmax * row + tail > SMEM_MAX) --depth;
  lay.ws = off;
  lay.ws_rows = depth * cmax;
  off += lay.ws_rows * row;
  lay.s1 = off;
  off += cmax * 4;
  lay.s2 = off;
  off += cmax * 4;
  lay.gm = off;
  off += cmax * 4;
  lay.rstd = off;
  off += MAXL * cmax * 4;
  lay.total = off;
  return lay;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n (0..MAXD-2) of the committed groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 2;\n" ::);
}

// Queue rows 0..N of tap `tap`, columns k0..k0+KC, of wg [16][N][K] into
// dst [N][LDW].
__device__ __forceinline__ void queue_stage(bf16* dst,
                                            const bf16* __restrict__ wg,
                                            int tap, int N, int K, int k0) {
  const int n = N * (KC / 8);
  for (int idx = threadIdx.x; idx < n; idx += THREADS) {
    const int row = idx >> 3, v = idx & 7;
    cp_async16(dst + row * LDW + v * 8,
               wg + (static_cast<size_t>(tap) * N + row) * K + k0 + v * 8);
  }
  cp_async_commit();
}

// Tap tt of a pass -> its index in the packed weights and the offset, in
// grid rows, that it adds to a position's base row.  Forward (all 16 taps,
// positions at stride 2): output (i, j) reads the haloed input at
// (2i + ky, 2j + kx).  Reverse (the 4 taps that reach parity plane (cy, cx)
// of the input): input (2u + cy, 2v + cx) reads the haloed cotangent at
// (u + 1 + cy - ry, v + 1 + cx - rx) through tap (1 - cy + 2ry,
// 1 - cx + 2rx).
__device__ __forceinline__ void tap_of(bool fwd, int tt, int cy, int cx,
                                       int awp, int& tap, int& aoff) {
  if (fwd) {
    tap = tt;
    aoff = (tt >> 2) * awp + (tt & 3);
  } else {
    const int ry = tt >> 1, rx = tt & 1;
    tap = (1 - cy + 2 * ry) * 4 + (1 - cx + 2 * rx);
    aoff = (1 + cy - ry) * awp + (1 + cx - rx);
  }
}

// Which (M tile, column chunk) each of a warp's tasks covers in a pass with
// nch column chunks: task = warp + i * NWARPS is M tile task / nch, chunk
// task % nch.
struct TaskMap {
  int mt[MAXT], nc[MAXT];
};

__device__ __forceinline__ TaskMap task_map(int nch) {
  TaskMap tm;
  int mt = (threadIdx.x >> 5) / nch, nc = (threadIdx.x >> 5) - mt * nch;
#pragma unroll
  for (int i = 0; i < MAXT; ++i) {
    tm.mt[i] = mt;
    tm.nc[i] = nc;
    nc += NWARPS;
    while (nc >= nch) {
      nc -= nch;
      ++mt;
    }
  }
  return tm;
}

// One gather-GEMM pass of the block: acc[task] = sum over the pass's taps
// and K of A[16 x K] * W_tap[K x NT].  Row m of the pass is position
// (m / mo, m % mo), mo = 1 << mo_log2; its base row in `abuf` (row pitch
// lda, grid width awp) is (m / mo * sp) * awp + m % mo * sp.  `ws` is the
// weight ring of ws_rows rows.  The loops carry their counters along: an
// integer division per chunk would cost more than the chunk's products.
__device__ __forceinline__ void conv_gemm(
    float (&acc)[MAXT][NQ][4], const TaskMap& tm, int ntasks,
    const bf16* abuf, int lda, int awp, int sp, int mo_log2, int N, int K,
    const bf16* __restrict__ wg, bool fwd, int cy, int cx, bf16* ws,
    int ws_rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mo = 1 << mo_log2;
  const int kch = K / KC, ntap = fwd ? 16 : 4;
  int depth = ws_rows / N;
  depth = depth > MAXD ? MAXD : depth;
  const int chunk = N * LDW;

  // per task: the two A rows' offsets (without the tap's) and the B row's
  int rowa[MAXT], rowb[MAXT], wofs[MAXT];
#pragma unroll
  for (int i = 0; i < MAXT; ++i) {
    const int ma = tm.mt[i] * 16 + g, mb = ma + 8;
    rowa[i] = (((ma >> mo_log2) * sp) * awp + (ma & (mo - 1)) * sp) * lda +
              2 * t;
    rowb[i] = (((mb >> mo_log2) * sp) * awp + (mb & (mo - 1)) * sp) * lda +
              2 * t;
    wofs[i] = (tm.nc[i] * NT + g) * LDW + 2 * t;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;
  }

  // the chunk to queue next: tap it_t, K chunk it_k, into ring slot it_b
  int it_t = 0, it_k = 0, it_b = 0;
  auto queue_next = [&]() {
    if (it_t < ntap) {
      int tap, aoff;
      tap_of(fwd, it_t, cy, cx, awp, tap, aoff);
      queue_stage(ws + it_b * chunk, wg, tap, N, K, it_k * KC);
      if (++it_k == kch) {
        it_k = 0;
        ++it_t;
      }
    } else {
      cp_async_commit();   // an empty group keeps the wait's count uniform
    }
    if (++it_b == depth) it_b = 0;
  };
  for (int s = 0; s < depth - 1; ++s) queue_next();

  int slot = 0;
  for (int tt = 0; tt < ntap; ++tt) {
    int tap, aoff;
    tap_of(fwd, tt, cy, cx, awp, tap, aoff);
    for (int kc = 0; kc < kch; ++kc) {
      // this chunk has landed, and every warp is done with the chunk
      // before it, whose slot the next chunk goes into
      cp_async_wait(depth - 2);
      __syncthreads();
      queue_next();
      const int aofs = aoff * lda + kc * KC;
      const bf16* wsb = ws + slot * chunk;
      if (++slot == depth) slot = 0;
#pragma unroll
      for (int i = 0; i < MAXT; ++i) {
        if (warp + i * NWARPS < ntasks) {
          const bf16* xa = abuf + rowa[i] + aofs;
          const bf16* xb = abuf + rowb[i] + aofs;
          const bf16* wrow = wsb + wofs[i];
#pragma unroll
          for (int kk = 0; kk < KC; kk += 16) {
            uint32_t a[4];
            a[0] = lgt::lds32(xa + kk);
            a[1] = lgt::lds32(xb + kk);
            a[2] = lgt::lds32(xa + kk + 8);
            a[3] = lgt::lds32(xb + kk + 8);
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              const bf16* wq = wrow + q * 8 * LDW + kk;
              lgt::mma16816(acc[i][q], a, lgt::lds32(wq),
                            lgt::lds32(wq + 8));
            }
          }
        }
      }
    }
  }
  __syncthreads();   // the ring and the A operand are free again
}

// Row of interior position p of an m x m grid (m = 1 << m_log2) in its
// haloed buffer.
__device__ __forceinline__ int halo_row(int p, int m_log2) {
  const int m = 1 << m_log2;
  return ((p >> m_log2) + 1) * (m + 2) + (p & (m - 1)) + 1;
}

// Calls f(idx, q, c) for idx = q * co + c over [0, P * co), idx strided over
// the block's threads; q and c are carried along without divisions.
template <typename F>
__device__ __forceinline__ void for_each_elem(int P, int co, F f) {
  int q = threadIdx.x / co, c = threadIdx.x - q * co;
  const int dq = THREADS / co, dc = THREADS - dq * co;
  for (int idx = threadIdx.x; idx < P * co; idx += THREADS) {
    f(idx, q, c);
    q += dq;
    c += dc;
    if (c >= co) {
      c -= co;
      ++q;
    }
  }
}

// Phase time stamp i of block 0 (nanoseconds of the card's global timer):
// the profiling tools that split a kernel's time do not run everywhere.
__device__ __forceinline__ void stamp(unsigned long long* probe, int i) {
  if (probe != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    probe[i] = now;
  }
}

__global__ void __launch_bounds__(THREADS)
critic_trunk_grad_kernel(const TrunkArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = make_layout(p.L, p.M0, p.C);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  bf16* ws = reinterpret_cast<bf16*>(smem + lay.ws);
  float* s1 = reinterpret_cast<float*>(smem + lay.s1);
  float* s2 = reinterpret_cast<float*>(smem + lay.s2);
  float* gm = reinterpret_cast<float*>(smem + lay.gm);
  float* rstd_all = reinterpret_cast<float*>(smem + lay.rstd);
  int cmax = 0;
  for (int l = 0; l <= p.L; ++l) cmax = p.C[l] > cmax ? p.C[l] : cmax;
  const bool gn = p.gs > 0;
  const int gs_log2 = gn ? 31 - __clz(p.gs) : 0;
  int ns = 0;                // stamps: entry, a0 staged, then per phase
  stamp(p.probe, ns++);

  // ---- zero the grids 1..L (halo and interior), stage a0 with its halo ---
  {
    uint4* z = reinterpret_cast<uint4*>(smem + lay.grid[1]);
    const int nz = (lay.xn[1] - lay.grid[1]) / 16;
    for (int idx = tid; idx < nz; idx += THREADS)
      z[idx] = make_uint4(0u, 0u, 0u, 0u);
    const int M = p.M0, wp = M + 2, C = p.C[0], vec = C / 8, ld = C + PAD;
    bf16* g0 = reinterpret_cast<bf16*>(smem + lay.grid[0]);
    // uint4 number idx of the haloed grid is vector v of position (i, j)
    const int dpos = THREADS / vec, dv = THREADS - dpos * vec;
    int pos = tid / vec, v = tid - pos * vec;
    int i = pos / wp, j = pos - i * wp;
    while (i < wp) {
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (i >= 1 && i <= M && j >= 1 && j <= M)
        val = *reinterpret_cast<const uint4*>(
            p.a0 + ((static_cast<size_t>(b) * M + i - 1) * M + j - 1) * C +
            v * 8);
      *reinterpret_cast<uint4*>(g0 + (i * wp + j) * ld + v * 8) = val;
      v += dv;
      j += dpos;
      if (v >= vec) {
        v -= vec;
        ++j;
      }
      while (j >= wp) {
        j -= wp;
        ++i;
      }
    }
  }
  __syncthreads();
  stamp(p.probe, ns++);

  float acc[MAXT][NQ][4];

  // ---- forward trunk ------------------------------------------------------
  for (int l = 1; l <= p.L; ++l) {
    const int ci = p.C[l - 1], co = p.C[l];
    const int mi = p.M0 >> (l - 1), mo = mi >> 1, P = mo * mo;
    const bf16* ain = reinterpret_cast<const bf16*>(smem + lay.grid[l - 1]);
    bf16* aout = reinterpret_cast<bf16*>(smem + lay.grid[l]);
    float* xn = reinterpret_cast<float*>(smem + lay.xn[l]);
    float* rstd = rstd_all + (l - 1) * cmax;

    const int mo_log2 = 31 - __clz(mo);
    const int nch = co / NT, ntasks = (P / 16) * nch;
    const TaskMap tm = task_map(nch);
    conv_gemm(acc, tm, ntasks, ain, ci + PAD, mi + 2, 2, mo_log2, co, ci,
              p.wf[l - 1], true, 0, 0, ws, lay.ws_rows);
    stamp(p.probe, ns++);
    // y = bf16(bf16(conv) + bf16(bias)), kept in f32 for the statistics
    const float* bias = p.bias[l - 1];
#pragma unroll
    for (int i = 0; i < MAXT; ++i) {
      if (warp + i * NWARPS < ntasks) {
        const int mt = tm.mt[i], nc = tm.nc[i];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int c = nc * NT + q * 8 + 2 * t;
          const float b0 = bf16r(bias[c]), b1 = bf16r(bias[c + 1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = mt * 16 + g + 8 * h;
            *reinterpret_cast<float2*>(xn + m * co + c) =
                make_float2(bf16r(bf16r(acc[i][q][2 * h]) + b0),
                            bf16r(bf16r(acc[i][q][2 * h + 1]) + b1));
          }
        }
      }
    }
    __syncthreads();

    if (gn) {
      const int gs = p.gs, groups = co >> gs_log2;
      for (int c = tid; c < co; c += THREADS) {
        float a1 = 0.f, a2 = 0.f;
        for (int q = 0; q < P; ++q) {
          const float v = xn[q * co + c];
          a1 += v;
          a2 += v * v;
        }
        s1[c] = a1;
        s2[c] = a2;
      }
      __syncthreads();
      for (int gr = tid; gr < groups; gr += THREADS) {
        float a1 = 0.f, a2 = 0.f;
        for (int k = 0; k < gs; ++k) {
          a1 += s1[gr * gs + k];
          a2 += s2[gr * gs + k];
        }
        const float cnt = static_cast<float>(gs * P);
        const float mean = a1 / cnt;
        gm[gr] = mean;
        rstd[gr] = rsqrtf(a2 / cnt - mean * mean + p.eps);
      }
      __syncthreads();
    }
    const float* gamma = p.gamma[l - 1];
    const float* beta = p.beta[l - 1];
    for_each_elem(P, co, [&](int idx, int q, int c) {
      float o = xn[idx];
      if (gn) {
        const int gr = c >> gs_log2;
        const float v = (o - gm[gr]) * rstd[gr];
        xn[idx] = v;
        o = v * gamma[c] + beta[c];
      }
      if (l < p.L)   // the last activation is not needed: only its sign is
        aout[halo_row(q, mo_log2) * (co + PAD) + c] =
            __float2bfloat16_rn(o >= 0.f ? o : p.slope * o);
    });
    __syncthreads();
    stamp(p.probe, ns++);
  }

  // ---- reverse: head -> trunk layers -> layer 0's LeakyReLU --------------
  for (int l = p.L; l >= 1; --l) {
    const int ci = p.C[l - 1], co = p.C[l];
    const int mi = p.M0 >> (l - 1), mo = mi >> 1, P = mo * mo;
    const int ldo = co + PAD, mo_log2 = 31 - __clz(mo);
    bf16* dgrid = reinterpret_cast<bf16*>(smem + lay.grid[l]);
    const float* xn = reinterpret_cast<const float*>(smem + lay.xn[l]);
    const float* rstd = rstd_all + (l - 1) * cmax;
    const float* gamma = p.gamma[l - 1];
    const float* beta = p.beta[l - 1];
    const bool last = l == p.L;

    // cotangent of the layer's output at (position q, channel c), after the
    // LeakyReLU backward; with GroupNorm, times gamma (dxhat)
    auto dxhat_at = [&](int q, int c, float x) {
      float d = last ? p.head[q * co + c]
                     : __bfloat162float(
                           dgrid[halo_row(q, mo_log2) * ldo + c]);
      const float o = gn ? x * gamma[c] + beta[c] : x;
      d = o >= 0.f ? d : p.slope * d;
      return gn ? d * gamma[c] : d;
    };

    if (gn) {
      const int gs = p.gs, groups = co >> gs_log2;
      for (int c = tid; c < co; c += THREADS) {
        float a1 = 0.f, a2 = 0.f;
        for (int q = 0; q < P; ++q) {
          const float x = xn[q * co + c];
          const float d = dxhat_at(q, c, x);
          a1 += d;
          a2 += d * x;
        }
        s1[c] = a1;
        s2[c] = a2;
      }
      __syncthreads();
      for (int gr = tid; gr < groups; gr += THREADS) {
        float a1 = 0.f, a2 = 0.f;
        for (int k = 0; k < gs; ++k) {
          a1 += s1[gr * gs + k];
          a2 += s2[gr * gs + k];
        }
        const float cnt = static_cast<float>(gs * P);
        gm[gr] = a1 / cnt;
        gm[groups + gr] = a2 / cnt;
      }
      __syncthreads();
    }
    const int groups = gn ? co >> gs_log2 : 0;
    for_each_elem(P, co, [&](int idx, int q, int c) {
      const float x = xn[idx];
      float d = dxhat_at(q, c, x);
      if (gn) {
        const int gr = c >> gs_log2;
        d = rstd[gr] * (d - gm[gr] - x * gm[groups + gr]);
      }
      dgrid[halo_row(q, mo_log2) * ldo + c] = __float2bfloat16_rn(d);
    });
    __syncthreads();
    stamp(p.probe, ns++);

    // the conv's input gradient, one parity plane of the input at a time
    const int nch = ci / NT, ntasks = (P / 16) * nch;
    const TaskMap tm = task_map(nch);
    bf16* dst = reinterpret_cast<bf16*>(smem + lay.grid[l - 1]);
    const int ldi = ci + PAD;
    for (int par = 0; par < 4; ++par) {
      const int cy = par >> 1, cx = par & 1;
      conv_gemm(acc, tm, ntasks, dgrid, ldo, mo + 2, 1, mo_log2, ci, co,
                p.wb[l - 1], false, cy, cx, ws, lay.ws_rows);
#pragma unroll
      for (int i = 0; i < MAXT; ++i) {
        if (warp + i * NWARPS < ntasks) {
          const int mt = tm.mt[i], nc = tm.nc[i];
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const int c = nc * NT + q * 8 + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = mt * 16 + g + 8 * h;
              const int y = 2 * (m >> mo_log2) + cy;
              const int x = 2 * (m & (mo - 1)) + cx;
              float v0 = bf16r(acc[i][q][2 * h]);
              float v1 = bf16r(acc[i][q][2 * h + 1]);
              bf16* at = dst + ((y + 1) * (mi + 2) + x + 1) * ldi + c;
              if (l > 1) {
                *reinterpret_cast<__nv_bfloat162*>(at) =
                    __floats2bfloat162_rn(v0, v1);
              } else {
                // grid 0 still holds a0: layer 0's LeakyReLU backward
                const float2 a = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(at));
                v0 = a.x >= 0.f ? v0 : p.slope * v0;
                v1 = a.y >= 0.f ? v1 : p.slope * v1;
                *reinterpret_cast<__nv_bfloat162*>(
                    p.dy0 + ((static_cast<size_t>(b) * mi + y) * mi + x) * ci +
                    c) = __floats2bfloat162_rn(v0, v1);
              }
            }
          }
        }
      }
    }
    __syncthreads();
    stamp(p.probe, ns++);
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes.
extern "C" int critic_trunk_grad_smem(int L, int M0, int C0, int C1, int C2) {
  const int C[MAXL + 1] = {C0, C1, C2};
  return make_layout(L, M0, C).total;
}

// a0 [B,M0,M0,C0] bf16 -> dy0 (same).  Per trunk layer l = 1..L: wf
// [16,Co,Ci] and wb [16,Ci,Co] bf16 (the HWIO weight packed both ways),
// bias [Co] f32 and, with GroupNorm (gs > 0), gamma / beta [Co] f32; head
// [4,4,C_L] f32.  The caller checks the shape rules: L in {1, 2},
// M0 = 4 * 2^L, every C a multiple of 64, gs in {0, 8, 16}, at most 32
// (16-row, 16-column) tiles per GEMM pass, and the shared memory within the
// block's limit.  `probe`, where not null, receives 2 + 4L time stamps of
// block 0: kernel entry, a0 staged, then after each forward layer's conv
// and GroupNorm and each reverse layer's GroupNorm backward and input
// gradient.  Returns the launch's error.
extern "C" int critic_trunk_grad(
    const void* a0, void* dy0, const void* wf1, const void* wb1,
    const void* bias1, const void* gamma1, const void* beta1, const void* wf2,
    const void* wb2, const void* bias2, const void* gamma2, const void* beta2,
    const void* head, int B, int L, int M0, int C0, int C1, int C2, int gs,
    float slope, float eps, void* probe, void* stream) {
  TrunkArgs p;
  p.a0 = static_cast<const bf16*>(a0);
  p.dy0 = static_cast<bf16*>(dy0);
  p.wf[0] = static_cast<const bf16*>(wf1);
  p.wb[0] = static_cast<const bf16*>(wb1);
  p.bias[0] = static_cast<const float*>(bias1);
  p.gamma[0] = static_cast<const float*>(gamma1);
  p.beta[0] = static_cast<const float*>(beta1);
  p.wf[1] = static_cast<const bf16*>(wf2);
  p.wb[1] = static_cast<const bf16*>(wb2);
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
  p.probe = static_cast<unsigned long long*>(probe);
  const int smem = make_layout(L, M0, p.C).total;
  cudaError_t err = cudaFuncSetAttribute(
      critic_trunk_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  critic_trunk_grad_kernel<<<B, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

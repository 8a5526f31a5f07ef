// The Mamba-2 SSD (state-space duality) chunked scan.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel
// (ssd_scan_pallas). It computes what repro/models/mamba2.py::ssd_reference
// computes, for x [b,l,h,p], dt [b,l,h] f32, A [h] f32, B and C [b,l,g,n]
// (g groups, each shared by h/g heads: head i reads group i / (h/g); the
// reference's Mamba-2 has g = 1) and an optional initial state
// [b,h,n,p] f32: with cum the running sum of dt*A inside a chunk of Q steps
// and B, C those of the head's group,
//   y_i = sum_{j<=i in the chunk} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . S_in,
//   S_out = exp(cum_last) S_in + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T,
// S_in being the state entering the chunk. Outputs y [b,l,h,p] contiguous
// in x's dtype and the final state [b,h,n,p] f32. x, B and C are f32 or
// bf16 and are read through their strides (the last dimension contiguous),
// so the model's views into its conv output need no copy. Any l >= 1: the
// last chunk may be short (the TPU kernel visits only l / Q whole chunks,
// and at l = 384 with Q = 256 leaves NaN in y). Q <= 256.
//
// Bound on an H100 at the serving path's shape, Nemotron-3-Nano's Mamba-2
// layers (b=1, l up to 4096, h=64, p=64, g=8, n=128, Q=128, bf16): bytes.
// The least work is C_i . B_j over the live pairs j <= i of each chunk
// once per batch row and group (2 n g Q(Q+1)/2 a chunk: 0.54 GFLOP at
// l = 4096), and per head the masked product with x over the same pairs
// (2 p h Q(Q+1)/2 a chunk: 2.16 GFLOP), C S_in and the chunk states (2 l n
// p each a head: 8.59 GFLOP): 11.3 GFLOP, 0.0114 ms at the bf16 tensor
// cores' 989 TFLOP/s; x, y (l h p each), dt (l h, f32), B, C (l g n each)
// and the final state (h n p, f32) are 87.0 MB, 0.026 ms at 3.35 TB/s.
// (Mamba-2-2.7B's shape, b=2, l=4096, h=80, p=64, g=1, n=128, Q=256: 32.5
// GFLOP, 180 MB, 0.054 ms.)
//
// bf16 inputs (the serving path): two kernels, wgmma with f32
// accumulation, operands brought by TMA into 128-byte swizzled rings.
//   1. ssd_states_bf16, per (b, head, 64-row n tile, 64-column p tile), one
//      warpgroup: walks the chunks in order with the state in its
//      accumulators, writes the state entering each chunk once (in two
//      bf16 halves, the form the next kernel's tensor cores take) and the
//      chunk's cum and dt, and the final state in f32. The chunk states
//      never make another trip: the TPU kernel keeps the state in VMEM
//      across a sequential grid; here the sequential walk is inside the
//      block.
//   2. ssd_out_bf16, per (b, chunk, 64-row tile, p tile, group of heads;
//      a group of heads lies inside one B/C group),
//      two warpgroups and a producer warp that keeps the TMA ring full
//      (full and empty mbarriers, so the warpgroups meet only at the end
//      of a head): C B^T of its rows once (B and C are exact in bf16),
//      kept in shared memory for every head of the group; per head
//      exp(cum_i) C_i . S_in plus M x, with the masked M = CB exp(cum_i -
//      cum_j) dt_j built in registers as the A operand. The group size
//      gives about four blocks an SM; each group computes its rows' C B^T
//      again (five groups at the path's shape, 2% of the kernel's
//      products), and the four row tiles of a chunk each read its states
//      (adjacent blocks, so mostly from L2).
//   Each f32 operand (M, w x and S_in) goes in as two bf16 halves hi =
//   bf16(v), lo = bf16(v - hi) and is multiplied twice, so the products keep
//   about 16 of f32's 24 bits; x, B and C go in as they are. One bf16
//   operand in place of a pair missed the bf16 gate (atol 1e-3 of max |y|
//   plus rtol 8e-3) by up to 2.1x at the parity cases. The causal mask is
//   applied before the exp (exp(cum_i - cum_j) overflows for j > i), which
//   is one ex2.approx.ftz of the difference times log2 e (the difference is
//   taken first, so its error stays relative to it, not to cum). The
//   scratch is the chunk states' two halves and the chunks' cum and dt
//   (86 MB at the path's shape), kept by the wrapper from call to call.
//   Inputs whose strides TMA does not take are staged element by element.
//   Measured on the card with earlier forms of these kernels: with cp.async
//   staging and mma.sync (16-row warps) both kernels were slower than the
//   four-pass form they replace, their time in issuing copies and reading
//   B tiles from shared memory; TMA and wgmma (a warpgroup reads a B tile
//   once for 64 rows) took them about half of that time off, and a
//   producer warp in place of a barrier a step another 8% (both sides on
//   one card, in one process).
//   What remains is a loop of short dependent steps (a few wgmma and
//   their wait) at one block an SM; building a step's operands while the
//   previous step's products ran, in two register sets, was no faster.
//
// f32 inputs (parity checks only), four passes on the CUDA cores in IEEE
// f32 (TF32 would miss the reference's 5e-5): 1. ssd_cb, C B^T of each
// (b, chunk) into scratch; 2. ssd_state, the chunks' local states; 3.
// ssd_carry, one thread per (b, h, n, p) element walking the chunks; 4.
// ssd_out. 256 threads, 4 x 4 outputs each at a stride of 16 rows and 16
// columns, the reduction staged 32 deep. Scratch b*nc*(Q*Q + h*(Q + 1 +
// n*p)) floats.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kMaxChunk = 256;
constexpr int kThreads = 256;
constexpr int kTile = 64;        // output tile is kTile x kTile
constexpr int kK = 32;           // reduction depth staged per step
constexpr int kLd = kTile + 1;   // padded row of a staged [kK][kTile] tile

enum : int { kErrShape = -1, kErrDtype = -2, kErrNoEncoder = -3,
             kErrTensorMap = -4 };

struct Dims {
  int b, l, h, p, n, Q, nc;
  int g, hpg;              // B/C groups, heads a group
  int64_t sxb, sxl, sxh;   // x [b, l, h, p], p contiguous
  int64_t sdb, sdl;        // dt [b, l, h], h contiguous
  int64_t sbb, sbl, sbg;   // B [b, l, g, n], n contiguous
  int64_t scb, scl, scg;   // C [b, l, g, n], n contiguous
};

// Scratch layout (floats).
struct Scratch {
  float* cb;    // [b, nc, g, Q, Q]
  float* cum;   // [b, nc, h, Q]
  float* dec;   // [b, nc, h]
  float* st;    // [b, nc, h, n, p]
};


__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// acc[r][q] += sum_k a[k][ty + 16 r] * b[k][tx + 16 q] over one staged step
__device__ __forceinline__ void mac_tile(float (&acc)[4][4],
                                         const float (*a)[kLd],
                                         const float (*bm)[kLd], int ty,
                                         int tx) {
#pragma unroll 8
  for (int k = 0; k < kK; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      av[r] = a[k][ty + 16 * r];
      bv[r] = bm[k][tx + 16 * r];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

// Pass 1: CB[b, c, g, i, j] = C_i . B_j of each group for the tiles with
// j-tile <= i-tile.
__global__ void __launch_bounds__(kThreads)
    ssd_cb(const float* __restrict__ B, const float* __restrict__ C,
           Scratch s, Dims d) {
  __shared__ float Cs[kK][kLd];   // [n][i]
  __shared__ float Bs[kK][kLd];   // [n][j]
  const int nt = cdiv(d.Q, kTile);
  int blk = blockIdx.x;
  const int tj = blk % nt; blk /= nt;
  const int ti = blk % nt; blk /= nt;
  const int grp = blk % d.g; blk /= d.g;
  const int c = blk % d.nc, bb = blk / d.nc;
  const int t0 = c * d.Q, qlen = min(d.Q, d.l - t0);
  const int i0 = ti * kTile, j0 = tj * kTile;
  if (tj > ti || i0 >= qlen) return;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* Cb = C + bb * d.scb + grp * d.scg + (int64_t)t0 * d.scl;
  const float* Bb = B + bb * d.sbb + grp * d.sbg + (int64_t)t0 * d.sbl;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < d.n; k0 += kK) {
    #pragma unroll 4
    for (int u = 0; u < kK * kTile / kThreads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int k = e % kK, r = e / kK, nn = k0 + k;
      const bool kin = nn < d.n;
      Cs[k][r] = (kin && i0 + r < qlen) ? Cb[(i0 + r) * d.scl + nn] : 0.f;
      Bs[k][r] = (kin && j0 + r < qlen) ? Bb[(j0 + r) * d.sbl + nn] : 0.f;
    }
    __syncthreads();
    mac_tile(acc, Cs, Bs, ty, tx);
    __syncthreads();
  }
  float* out = s.cb + (((int64_t)bb * d.nc + c) * d.g + grp) * d.Q * d.Q;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * q;
      if (i < qlen && j < qlen) out[(int64_t)i * d.Q + j] = acc[r][q];
    }
}

// The chunk's running log-decay cum_j = sum_{k<=j} dt_k a into cum_s, and
// w_j = exp(cum_last - cum_j) dt_j into w_s, for j < qlen; the block with
// `write` set also stores cum and the chunk's decay exp(cum_last) in the
// scratch for passes 3 and 4. Warp 0 runs the sum 32 steps at a time, the
// same way for both input types. The whole block calls this.
__device__ void chunk_decays(const float* dtb, int64_t sdl, float a,
                             int qlen, float* cum_s, float* w_s,
                             const Scratch& s, int64_t bch, int Q,
                             bool write) {
  for (int j = threadIdx.x; j < qlen; j += blockDim.x) {
    const float dtj = dtb[(int64_t)j * sdl];
    w_s[j] = dtj;
    cum_s[j] = dtj * a;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float carry = 0.f;
    for (int base = 0; base < qlen; base += 32) {
      const int j = base + lane;
      float v = j < qlen ? cum_s[j] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      if (j < qlen) cum_s[j] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const float last = cum_s[qlen - 1];
  for (int j = threadIdx.x; j < qlen; j += blockDim.x) {
    w_s[j] = expf(last - cum_s[j]) * w_s[j];
    if (write) s.cum[bch * Q + j] = cum_s[j];
  }
  if (write && threadIdx.x == 0) s.dec[bch] = expf(last);
  __syncthreads();
}

// Pass 2: per (b, chunk, head, n tile, p tile) the running log-decay and
// the chunk's local state S_c[n, p] = sum_j B_j[n] (w_j x_j[p]).
__global__ void __launch_bounds__(kThreads)
    ssd_state(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ B,
              Scratch s, Dims d) {
  __shared__ float cum_s[kMaxChunk];
  __shared__ float w_s[kMaxChunk];
  __shared__ float Bs[kK][kLd];   // [j][n]
  __shared__ float Xs[kK][kLd];   // [j][p]
  const int ntn = cdiv(d.n, kTile), ntp = cdiv(d.p, kTile);
  int blk = blockIdx.x;
  const int pt = blk % ntp; blk /= ntp;
  const int nt = blk % ntn; blk /= ntn;
  const int hh = blk % d.h; blk /= d.h;
  const int c = blk % d.nc, bb = blk / d.nc;
  const int t0 = c * d.Q, qlen = min(d.Q, d.l - t0);
  const int n0 = nt * kTile, p0 = pt * kTile;
  const int64_t bch = ((int64_t)bb * d.nc + c) * d.h + hh;
  chunk_decays(dt + bb * d.sdb + (int64_t)t0 * d.sdl + hh, d.sdl, A[hh],
               qlen, cum_s, w_s, s, bch, d.Q, nt == 0 && pt == 0);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* Bb = B + bb * d.sbb + (hh / d.hpg) * d.sbg +
                    (int64_t)t0 * d.sbl;
  const float* xb = x + bb * d.sxb + (int64_t)t0 * d.sxl + hh * d.sxh;
  float acc[4][4] = {};
  for (int j0 = 0; j0 < qlen; j0 += kK) {
    #pragma unroll 4
    for (int u = 0; u < kK * kTile / kThreads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int r = e % kTile, k = e / kTile, jj = j0 + k;
      const bool jin = jj < qlen;
      Bs[k][r] = (jin && n0 + r < d.n) ? Bb[jj * d.sbl + n0 + r] : 0.f;
      Xs[k][r] = (jin && p0 + r < d.p)
                     ? w_s[jj] * xb[jj * d.sxl + p0 + r] : 0.f;
    }
    __syncthreads();
    mac_tile(acc, Bs, Xs, ty, tx);
    __syncthreads();
  }
  float* out = s.st + bch * d.n * d.p;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int nn = n0 + ty + 16 * r, pp = p0 + tx + 16 * q;
      if (nn < d.n && pp < d.p) out[(int64_t)nn * d.p + pp] = acc[r][q];
    }
}

// Pass 3: the carry across chunks, one thread per (b, h, n, p) element. The
// chunks' local states and decays are loaded kCarry at a time before any
// is overwritten, so a thread waits on device memory nc / kCarry times.
constexpr int kCarry = 8;

__global__ void __launch_bounds__(kThreads)
    ssd_carry(const float* __restrict__ init, float* __restrict__ final_state,
              Scratch s, Dims d) {
  const int64_t np = (int64_t)d.n * d.p;
  const int64_t total = (int64_t)d.b * d.h * np;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t e = idx % np, bh = idx / np;
  const int hh = (int)(bh % d.h), bb = (int)(bh / d.h);
  float S = init ? init[idx] : 0.f;
  for (int c0 = 0; c0 < d.nc; c0 += kCarry) {
    float local[kCarry], dec[kCarry];
#pragma unroll
    for (int u = 0; u < kCarry; ++u) {
      const int64_t bch = ((int64_t)bb * d.nc + c0 + u) * d.h + hh;
      const bool in = c0 + u < d.nc;
      local[u] = in ? s.st[bch * np + e] : 0.f;
      dec[u] = in ? s.dec[bch] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kCarry; ++u) {
      if (c0 + u < d.nc) {
        const int64_t bch = ((int64_t)bb * d.nc + c0 + u) * d.h + hh;
        s.st[bch * np + e] = S;    // the state entering chunk c0 + u
        S = S * dec[u] + local[u];
      }
    }
  }
  final_state[idx] = S;
}

// Pass 4: y for (b, chunk, 64-row tile, p tile, head).
__global__ void __launch_bounds__(kThreads)
    ssd_out(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ C, float* __restrict__ y, Scratch s,
            Dims d) {
  __shared__ float cum_s[kMaxChunk];
  __shared__ float dt_s[kMaxChunk];
  __shared__ float As[kK][kLd];   // [j][i] of M, then [n][i] of exp(cum) C
  __shared__ float Xs[kK][kLd];   // [j][p] of x, then [n][p] of S_in
  const int nti = cdiv(d.Q, kTile), ntp = cdiv(d.p, kTile);
  int blk = blockIdx.x;
  const int hh = blk % d.h; blk /= d.h;
  const int pt = blk % ntp; blk /= ntp;
  const int it = blk % nti; blk /= nti;
  const int c = blk % d.nc, bb = blk / d.nc;
  const int t0 = c * d.Q, qlen = min(d.Q, d.l - t0);
  const int i0 = it * kTile, p0 = pt * kTile;
  if (i0 >= qlen) return;
  const int64_t bch = ((int64_t)bb * d.nc + c) * d.h + hh;
  const int jmax = min(qlen, i0 + kTile);
  for (int j = threadIdx.x; j < jmax; j += kThreads) {
    cum_s[j] = s.cum[bch * d.Q + j];
    dt_s[j] = dt[bb * d.sdb + (int64_t)(t0 + j) * d.sdl + hh];
  }
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int grp = hh / d.hpg;
  const float* cb =
      s.cb + (((int64_t)bb * d.nc + c) * d.g + grp) * d.Q * d.Q;
  const float* xb = x + bb * d.sxb + (int64_t)t0 * d.sxl + hh * d.sxh;
  float acc[4][4] = {};
  // intra-chunk: M[i, j] = CB[i, j] exp(cum_i - cum_j) dt_j for j <= i
  for (int j0 = 0; j0 < jmax; j0 += kK) {
    #pragma unroll 4
    for (int u = 0; u < kK * kTile / kThreads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int k = e % kK, r = e / kK, i = i0 + r, jj = j0 + k;
      As[k][r] = (jj <= i && i < qlen)
                     ? cb[(int64_t)i * d.Q + jj] *
                           expf(cum_s[i] - cum_s[jj]) * dt_s[jj]
                     : 0.f;
    }
    #pragma unroll 4
    for (int u = 0; u < kK * kTile / kThreads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int r = e % kTile, k = e / kTile, jj = j0 + k;
      Xs[k][r] = (jj < jmax && p0 + r < d.p) ? xb[jj * d.sxl + p0 + r]
                                               : 0.f;
    }
    __syncthreads();
    mac_tile(acc, As, Xs, ty, tx);
    __syncthreads();
  }
  // inter-chunk: exp(cum_i) C_i . S_in
  const float* Cb = C + bb * d.scb + grp * d.scg + (int64_t)t0 * d.scl;
  const float* sin = s.st + bch * d.n * d.p;
  for (int k0 = 0; k0 < d.n; k0 += kK) {
    #pragma unroll 4
    for (int u = 0; u < kK * kTile / kThreads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int k = e % kK, r = e / kK, i = i0 + r, nn = k0 + k;
      As[k][r] = (i < qlen && nn < d.n)
                     ? Cb[i * d.scl + nn] * expf(cum_s[i]) : 0.f;
    }
    #pragma unroll 4
    for (int u = 0; u < kK * kTile / kThreads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int r = e % kTile, k = e / kTile, nn = k0 + k;
      Xs[k][r] = (nn < d.n && p0 + r < d.p)
                     ? sin[(int64_t)nn * d.p + p0 + r] : 0.f;
    }
    __syncthreads();
    mac_tile(acc, As, Xs, ty, tx);
    __syncthreads();
  }
  float* yb = y + (((int64_t)bb * d.l + t0) * d.h + hh) * d.p;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + ty + 16 * r, pp = p0 + tx + 16 * q;
      if (i < qlen && pp < d.p) yb[(int64_t)i * d.h * d.p + pp] = acc[r][q];
    }
}

// ---------------------------------------------------------------------------
// bf16 inputs (the serving path): two kernels on the tensor cores
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
using hopper::ldmatrix_x4_trans;
using hopper::mma_bf16_16816;
using hopper::smem_u32;

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kKs = 32;              // reduction depth of one pipeline step
constexpr int kTileElems = kKs * 64; // a [32][64] bf16 tile, 128-byte swizzle
constexpr int kTileBytes = kTileElems * 2;
constexpr int kStates = 128;         // ssd_states_bf16: one warpgroup
constexpr int kStatesStages = 4;
constexpr int kGroup = 4;            // chunks whose decays it finds at once
constexpr int kOut = 256;            // ssd_out_bf16: two warpgroups
constexpr int kOutThreads = kOut + 32;  // and a producer warp
constexpr int kOutStages = 3;
constexpr int kOutRows = 64;         // rows of a chunk per ssd_out_bf16 block
constexpr int kCbLd = kMaxChunk + 8; // f32 row of C B^T (8 mod 32 words)
constexpr int kRedLd = 64 + 8;       // f32 row of the halves' hand-over
constexpr int kRow = 64 + 8;         // bf16 row of the state staging tile
constexpr int kMaxSharedBytes = 232448;

// The scratch of the bf16 form.
struct Bf16Scratch {
  bf16* sin_hi;   // [b, nc, h, n, pp]: the state entering each chunk, hi
  bf16* sin_lo;   //   and lo halves (pp = p rounded up to 8)
  float* cd;      // [b, nc, h, 2, Qp]: cum, then dt, of each chunk
                  //   (Qp = Q rounded up to 4; zeros past qlen)
  int pp, Qp;
};

__host__ __device__ __forceinline__ int round_up(int a, int m) {
  return cdiv(a, m) * m;
}

// v = hi + lo with hi = bf16(v), lo = bf16(v - hi), each rounded to the
// nearest bf16 (ties away from zero) by adding half a bf16 unit to the
// bits before keeping the top 16: the pair carries about 16 of v's 24 bits
// (within 2^-17 of |v|, without bias), so a product of the pair with an
// exact bf16 operand, summed in f32, keeps about 16 bits. Integer adds,
// masks and byte permutes on the ALU pipe: the packed rounding conversion
// (cvt.rn.bf16x2.f32) cost the output kernel a fifth of its time on the
// card, and a truncating split (biased toward zero) took Mamba-2's
// last-token logits past 5% of the plain branches' after 64 layers.
__device__ __forceinline__ uint32_t bf16_bits_rn(float v) {
  return (__float_as_uint(v) + 0x8000u) & 0xffff0000u;
}

__device__ __forceinline__ void split2(float a, float b, uint32_t* hi,
                                       uint32_t* lo) {
  const uint32_t ha = bf16_bits_rn(a), hb = bf16_bits_rn(b);
  *hi = __byte_perm(ha, hb, 0x7632);
  *lo = __byte_perm(bf16_bits_rn(a - __uint_as_float(ha)),
                    bf16_bits_rn(b - __uint_as_float(hb)), 0x7632);
}

// exp(x) by one SFU instruction, results below 2^-126 flushed to zero
// (__expf, without -ftz, also handles subnormal results: slower where most
// of M's arguments are large and negative)
__device__ __forceinline__ float exp_ftz(float x) {
  return hopper::ex2(x * 1.4426950408889634f);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t pack_rn(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Byte offset of element (r, c) of a [rows][64] bf16 tile in TMA's 128-byte
// swizzle: rows of 128 bytes, the 16-byte piece k of row r at place
// k ^ (r % 8) (the tile 1024-byte aligned).
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

// A [R][64] bf16 tile (rows past rlim and columns past clim zero) into the
// swizzled tile at dst, element by element, by the block's `nthreads`
// threads: the path for inputs whose strides or alignment TMA does not
// take (the serving path's inputs go by TMA).
template <int R>
__device__ __forceinline__ void stage_sw_elems(bf16* dst, const bf16* src,
                                               int64_t rs, int rlim,
                                               int clim, int nthreads) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  unsigned char* base = reinterpret_cast<unsigned char*>(dst);
  for (int e = threadIdx.x; e < R * 64; e += nthreads) {
    const int r = e >> 6, c = e & 63;
    *reinterpret_cast<bf16*>(base + sw_off(r, c)) =
        (r < rlim && c < clim) ? src[r * rs + c] : zero;
  }
}

// The same by one warp.
template <int R>
__device__ __forceinline__ void stage_sw_elems_warp(bf16* dst,
                                                    const bf16* src,
                                                    int64_t rs, int rlim,
                                                    int clim) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  unsigned char* base = reinterpret_cast<unsigned char*>(dst);
  for (int e = threadIdx.x & 31; e < R * 64; e += 32) {
    const int r = e >> 6, c = e & 63;
    *reinterpret_cast<bf16*>(base + sw_off(r, c)) =
        (r < rlim && c < clim) ? src[r * rs + c] : zero;
  }
}

// Rows [kk, kk + 16) of a swizzled [32][64] tile at shared address `tile`
// as an MN-major wgmma B operand (8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, int kk) {
  return hopper::desc_sw128(tile + kk * 128, kTileBytes, 1024);
}

// Warp-wide decays of one chunk of qlen <= 256 steps (lane L owns steps
// [8L, 8L + 8)): the running log-decay cum_j = sum_{k<=j} dt_k a, w_j =
// exp(cum_last - cum_j) dt_j into w_s (0 past qlen); with `cd` set, cum and
// dt go to cd[0, Qp) and cd[Qp, 2 Qp). Returns exp(cum_last).
__device__ float warp_decays(const float* dtb, int64_t sdl, float a,
                             int qlen, float* w_s, float* cd, int Qp) {
  constexpr int E = kMaxChunk / 32;
  const int lane = threadIdx.x & 31;
  float d[E], v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = lane * E + e;
    d[e] = j < qlen ? dtb[(int64_t)j * sdl] : 0.f;
  }
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run += d[e] * a;
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += u;
  }
  float excl = __shfl_up_sync(kFullMask, incl, 1);
  if (lane == 0) excl = 0.f;
  float last = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] += excl;
    if (lane * E + e == qlen - 1) last = v[e];
  }
  last = __shfl_sync(kFullMask, last, (qlen - 1) / E);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = lane * E + e;
    const bool in = j < qlen;
    w_s[j] = in ? expf(last - v[e]) * d[e] : 0.f;
    if (cd && j < Qp) {
      cd[j] = in ? v[e] : 0.f;
      cd[Qp + j] = d[e];
    }
  }
  return expf(last);
}

// Kernel 1: the chunk states and the carry. One warpgroup per (b, head,
// 64-row n tile, 64-column p tile) walks the chunks in order with the
// state S[n, p] in its wgmma accumulators: at each chunk it writes S (the
// state entering the chunk, split into bf16 halves, the operand kernel 2
// feeds the tensor cores) once, scales it by the chunk's decay and adds
// sum_j B_j[n] (w_j x_j[p]) with wgmma: A = (B w)^T in registers (B^T by
// ldmatrix.trans from the swizzled B tile, times w, split into halves), B
// = x from its swizzled tile. B and x come 32 steps at a time by TMA into
// a 4-stage ring that runs across chunk boundaries; the decays of four
// chunks are found at once, one warp each. The final state is written in
// f32.
__global__ void __launch_bounds__(kStates)
    ssd_states_bf16(const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap tx,
                    const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ B,
                    const float* __restrict__ init,
                    float* __restrict__ final_state, Bf16Scratch s, Dims d,
                    bool tma) {
  __shared__ __align__(1024) bf16 ring[kStatesStages][2][kTileElems];
  __shared__ float w_g[kGroup][kMaxChunk];
  __shared__ float dec_g[kGroup];
  __shared__ __align__(16) bf16 out_s[kStates / 32][16][kRow];
  __shared__ __align__(8) uint64_t full[kStatesStages];
  const int ntn = cdiv(d.n, 64), ntp = cdiv(d.p, 64);
  int blk = blockIdx.x;
  const int pt = blk % ntp; blk /= ntp;
  const int nt0 = blk % ntn; blk /= ntn;
  const int hh = blk % d.h, bb = blk / d.h;
  const int n0 = nt0 * 64, p0 = pt * 64;
  const bool writer = nt0 == 0 && pt == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float a = A[hh];
  const int grp = hh / d.hpg;
  const bf16* Bb = B + bb * d.sbb + grp * d.sbg + n0;
  const bf16* xb = x + bb * d.sxb + hh * d.sxh + p0;
  const float* dtb = dt + bb * d.sdb + hh;
  const int64_t np = (int64_t)d.n * s.pp;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStatesStages; ++k)
      hopper::mbar_init(smem_u32(&full[k]), 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();

  float acc[32];                   // wgmma layout: [n8 tile][4]
  const int64_t bh = (int64_t)bb * d.h + hh;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int nn = n0 + 16 * warp + g + 8 * ((e >> 1) & 1);
    const int pp = p0 + (e >> 2) * 8 + 2 * t + (e & 1);
    acc[e] = (init && nn < d.n && pp < d.p)
                 ? init[(bh * d.n + nn) * d.p + pp] : 0.f;
  }

  const int spc = cdiv(d.Q, kKs);
  const int steps = (d.nc - 1) * spc + cdiv(d.l - (d.nc - 1) * d.Q, kKs);
  auto issue = [&](int st) {
    if (st >= steps) return;
    const int c = st / spc, j0 = (st % spc) * kKs;
    const int row = c * d.Q + j0;
    bf16* tB = ring[st % kStatesStages][0];
    bf16* tX = ring[st % kStatesStages][1];
    if (tma) {
      if (threadIdx.x == 0) {
        const uint32_t bar = smem_u32(&full[st % kStatesStages]);
        hopper::mbar_expect_tx(bar, 2 * kTileBytes);
        hopper::tma_load_4d(smem_u32(tB), &tb, bar, n0, grp, row, bb);
        hopper::tma_load_4d(smem_u32(tX), &tx, bar, p0, hh, row, bb);
      }
    } else {
      // rows past the chunk are those of the next one, or past l zeros;
      // either way w is 0 there
      const int rlim = d.l - row;
      stage_sw_elems<kKs>(tB, Bb + (int64_t)row * d.sbl, d.sbl, rlim,
                          d.n - n0, kStates);
      stage_sw_elems<kKs>(tX, xb + (int64_t)row * d.sxl, d.sxl, rlim,
                          d.p - p0, kStates);
    }
  };

  for (int st = 0; st < kStatesStages - 1; ++st) issue(st);
  for (int st = 0; st < steps; ++st) {
    const int c = st / spc, j0 = (st % spc) * kKs, slot = c % kGroup;
    if (j0 == 0) {
      if (slot == 0) {
        __syncthreads();           // the last group's decays are read
        const int cc = c + warp;
        if (cc < d.nc) {
          const int64_t bch = ((int64_t)bb * d.nc + cc) * d.h + hh;
          const float dec = warp_decays(
              dtb + (int64_t)cc * d.Q * d.sdl, d.sdl, a,
              min(d.Q, d.l - cc * d.Q), w_g[warp],
              writer ? s.cd + bch * 2 * s.Qp : nullptr, s.Qp);
          if (lane == 0) dec_g[warp] = dec;
        }
        __syncthreads();
      }
      // the state entering chunk c, once, in halves (each warp's 16 rows
      // through its own staging tile, so that the stores are whole 16-byte
      // pieces of rows); then the chunk's decay
      const int64_t base = (((int64_t)bb * d.nc + c) * d.h + hh) * np +
                           (int64_t)(n0 + 16 * warp) * s.pp + p0;
      const float dec = dec_g[slot];
      uint32_t hi[16], lo[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        split2(acc[2 * k], acc[2 * k + 1], &hi[k], &lo[k]);
        acc[2 * k] *= dec;
        acc[2 * k + 1] *= dec;
      }
      bf16 (*tile)[kRow] = out_s[warp];
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        __syncwarp();
#pragma unroll
        for (int k = 0; k < 16; ++k)   // k = 2 nt + half
          *reinterpret_cast<uint32_t*>(
              &tile[g + 8 * (k & 1)][(k >> 1) * 8 + 2 * t]) =
              part ? lo[k] : hi[k];
        __syncwarp();
        bf16* dst = (part ? s.sin_lo : s.sin_hi) + base;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = lane + 32 * k, r = e >> 3, c8 = (e & 7) * 8;
          if (n0 + 16 * warp + r < d.n && p0 + c8 < s.pp)
            *reinterpret_cast<uint4*>(dst + (int64_t)r * s.pp + c8) =
                *reinterpret_cast<const uint4*>(&tile[r][c8]);
        }
      }
    }
    if (tma)
      hopper::mbar_wait(smem_u32(&full[st % kStatesStages]),
                        (st / kStatesStages) & 1);
    __syncthreads();               // the stage refilled next is read
    if (!tma) hopper::fence_proxy_async();
    issue(st + kStatesStages - 1);

    const uint32_t tB = smem_u32(ring[st % kStatesStages][0]);
    const uint32_t tX = smem_u32(ring[st % kStatesStages][1]);
    const float* w = w_g[slot] + j0;
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      // A = (B w)^T: fragments 0 and 1 hold steps kk + 2t and kk + 2t + 1,
      // fragments 2 and 3 the same plus 8
      const int kk = 16 * k2, mi = lane >> 3;
      const int r = kk + (lane & 7) + 8 * (mi >> 1);
      uint32_t af[4];
      ldmatrix_x4_trans(af, tB + sw_off(r, 16 * warp + 8 * (mi & 1)));
      const float2 w01 = make_float2(w[kk + 2 * t], w[kk + 2 * t + 1]);
      const float2 w23 = make_float2(w[kk + 2 * t + 8], w[kk + 2 * t + 9]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = unpack2(af[q]), wq = q < 2 ? w01 : w23;
        split2(v.x * wq.x, v.y * wq.y, &ahi[k2][q], &alo[k2][q]);
      }
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      hopper::wgmma_rs_n64(acc, ahi[k2], tile_desc(tX, 16 * k2));
      hopper::wgmma_rs_n64(acc, alo[k2], tile_desc(tX, 16 * k2));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<32>(acc);
  }

  float* out = final_state + bh * d.n * d.p;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int nn = n0 + 16 * warp + g + 8 * ((e >> 1) & 1);
    const int pp = p0 + (e >> 2) * 8 + 2 * t + (e & 1);
    if (nn < d.n && pp < d.p) out[(int64_t)nn * d.p + pp] = acc[e];
  }
}

// Dynamic shared memory of ssd_out_bf16 (bytes), and the layout of it.
struct OutSmem {
  int ldc, npad, Qp, ring, cb, cs, cd, red, bar, total;
};

constexpr int kKo = 64;              // ssd_out_bf16's step depth
constexpr int kOTileElems = kKo * 64;        // a [64][64] swizzled tile
constexpr int kOTileBytes = kOTileElems * 2;
constexpr int kPairElems = 4 * kOTileElems;  // a stage: two steps' tiles

__host__ __device__ __forceinline__ OutSmem out_smem(int n, int Q) {
  OutSmem m;
  m.npad = round_up(n, 2 * kKo);
  m.ldc = m.npad + 8;
  m.Qp = round_up(Q, 4);
  const int stages = kOutStages * kPairElems * 2, brows = 64 * m.ldc * 2;
  m.ring = 0;                      // stages, or B [64][ldc]; 1024-aligned
  m.cb = m.ring + round_up(stages > brows ? stages : brows, 1024);
  m.cs = m.cb + kOutRows * kCbLd * 4;              // bf16 [64][ldc]
  m.cd = m.cs + kOutRows * m.ldc * 2;              // f32 [4][2][Qp]
  m.red = m.cd + 4 * 2 * m.Qp * 4;                 // f32 [64][kRedLd]
  m.bar = m.red + kOutRows * kRedLd * 4;           // full, empty
  m.total = m.bar + 16 * kOutStages + 1024;        // + slack to align
  return m;
}

// Kernel 2: the outputs. One block per (b, chunk, 64-row tile, 64-column
// p tile, group of heads); the heaviest row tile of a chunk first. It
// computes C B^T for its rows once (mma.sync, exact bf16 operands, f32
// into shared memory) and keeps it for every head of the group; per head,
// y = exp(cum_i) C_i . S_in plus M x with wgmma: the masked M[i, j] =
// CB[i, j] exp(cum_i - cum_j) dt_j (j <= i) is built in registers as the A
// operand, in two bf16 halves, and so is C; S_in (two halves, from kernel
// 1) and x are the B operands, read by the tensor cores from 128-byte
// swizzled tiles that TMA fills. Two warpgroups split each head's
// reduction (n for C . S_in, j for M x) between them, and at the end of a
// head the second hands its sums to the first through shared memory. A
// ninth warp streams the tiles through a 3-stage ring of steps 128 deep
// (64 a warpgroup), each head's cum and dt beside them (a bulk copy on the
// same barrier), refilling a stage once all eight consumer warps have
// released it.
__global__ void __launch_bounds__(kOutThreads, 1)
    ssd_out_bf16(const __grid_constant__ CUtensorMap tsh,
                 const __grid_constant__ CUtensorMap tsl,
                 const __grid_constant__ CUtensorMap tx,
                 const bf16* __restrict__ x, const bf16* __restrict__ B,
                 const bf16* __restrict__ C, bf16* __restrict__ y,
                 Bf16Scratch s, Dims d, int heads_per_block, bool tma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const OutSmem m = out_smem(d.n, d.Q);
  float* cb = reinterpret_cast<float*>(smem + m.cb);
  bf16* cs = reinterpret_cast<bf16*>(smem + m.cs);
  float* cdr = reinterpret_cast<float*>(smem + m.cd);
  float* red = reinterpret_cast<float*>(smem + m.red);
  bf16* ring = reinterpret_cast<bf16*>(smem + m.ring);
  const uint32_t bars = smem_u32(smem + m.bar);

  const int nti = cdiv(d.Q, kOutRows), ntp = cdiv(d.p, 64);
  // the blocks' groups of heads, cdiv(hpg, heads_per_block) in each B/C
  // group
  const int ngp = cdiv(d.hpg, heads_per_block);
  const int ng = d.g * ngp;
  int blk = blockIdx.x;
  const int it = nti - 1 - blk % nti; blk /= nti;
  const int pt = blk % ntp; blk /= ntp;
  const int hg = blk % ng; blk /= ng;
  const int grp = hg / ngp;
  const int c = blk % d.nc, bb = blk / d.nc;
  const int t0 = c * d.Q, qlen = min(d.Q, d.l - t0);
  const int i0 = it * kOutRows, p0 = pt * 64;
  if (i0 >= qlen) return;
  const int jmax = min(qlen, i0 + kOutRows);
  const int h0 = grp * d.hpg + (hg % ngp) * heads_per_block;
  const int h1 = min((grp + 1) * d.hpg, h0 + heads_per_block);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, kh = warp >> 2;          // warpgroup kh
  const int ra = 16 * rg + g, rb = ra + 8;          // rows in the tile
  // full[k] at bars + 8k (the producer's arrival and the bytes), empty[k]
  // at bars + 8 (kOutStages + k) (one arrival per consumer warp)
  const uint32_t empties = bars + 8 * kOutStages;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kOutStages; ++k) {
      hopper::mbar_init(bars + 8 * k, 1);
      hopper::mbar_init(empties + 8 * k, kOut / 32);
    }
    hopper::fence_mbar_init();
  }

  // C of the tile's rows, whole n (zeros past qlen and n)
  // 16-byte loads of C and B rows: strides of whole pieces and n of them
  const bool vec = tma && d.n % 8 == 0;
  const bf16* Cb =
      C + bb * d.scb + grp * d.scg + (int64_t)(t0 + i0) * d.scl;
  const bf16* Bb = B + bb * d.sbb + grp * d.sbg + (int64_t)t0 * d.sbl;
  auto stage_rows = [&](bf16* dst, const bf16* src, int64_t rs, int rlim) {
    const int cw = m.npad / 8;
    for (int e = threadIdx.x; e < kOutRows * cw; e += kOutThreads) {
      const int r = e / cw, c8 = (e % cw) * 8;
      bf16* to = dst + r * m.ldc + c8;
      if (vec) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < rlim && c8 < d.n)
          v = *reinterpret_cast<const uint4*>(src + r * rs + c8);
        *reinterpret_cast<uint4*>(to) = v;
      } else {
        for (int k = 0; k < 8; ++k)
          to[k] = (r < rlim && c8 + k < d.n) ? src[r * rs + c8 + k]
                                             : __float2bfloat16_rn(0.f);
      }
    }
  };
  stage_rows(cs, Cb, d.scl, qlen - i0);

  // CB[i, j] = C_i . B_j for the tile's rows, j < jmax, 64 columns at a
  // time: warp (rg, kh) the 16 x 32 block of its rows at column j0 + 32 kh,
  // unless the block lies right of the warp's diagonal
  for (int jb = 0; jb < jmax; jb += 64) {
    __syncthreads();                 // the last B block is read
    stage_rows(ring, Bb + (int64_t)jb * d.sbl, d.sbl, jmax - jb);
    __syncthreads();
    const int j0 = jb + 32 * kh;
    if (warp >= kOut / 32 || j0 > i0 + 16 * rg + 15 || j0 >= jmax) continue;
    float a4[4][4] = {};
    for (int k0 = 0; k0 < m.npad; k0 += 16) {
      uint32_t af[4], bf[4][2];
      const bf16* r0 = cs + ra * m.ldc + k0 + 2 * t;
      const bf16* r1 = r0 + 8 * m.ldc;
      af[0] = ld_u32(r0);
      af[1] = ld_u32(r1);
      af[2] = ld_u32(r0 + 8);
      af[3] = ld_u32(r1 + 8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* br = ring + (32 * kh + 8 * nt + g) * m.ldc + k0 + 2 * t;
        bf[nt][0] = ld_u32(br);
        bf[nt][1] = ld_u32(br + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(a4[nt], af, bf[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = j0 + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(cb + ra * kCbLd + j) =
          make_float2(a4[nt][0], a4[nt][1]);
      *reinterpret_cast<float2*>(cb + rb * kCbLd + j) =
          make_float2(a4[nt][2], a4[nt][3]);
    }
  }
  __syncthreads();                   // CB written, the B blocks read
  hopper::fence_proxy_async();       // before TMA writes where B was

  // per head: pairs of 64-deep steps, first over n (C . S_in; npad is a
  // multiple of 128), then over j (M x); warpgroup kh takes step 2u + kh
  // of pair u
  const int pairs_n = m.npad / (2 * kKo);
  const int pairs = pairs_n + cdiv(jmax, 2 * kKo);
  const int iters = (h1 - h0) * pairs;
  const int64_t np = (int64_t)d.n * s.pp;
  const bf16* xb = x + bb * d.sxb + (int64_t)t0 * d.sxl + p0;
  auto issue = [&](int q) {
    if (q >= iters) return;
    const int hl = q / pairs, u = q % pairs, hh = h0 + hl;
    const int bch = (bb * d.nc + c) * d.h + hh;
    bf16* dst = ring + (q % kOutStages) * kPairElems;
    const uint32_t bar = bars + 8 * (q % kOutStages);
    const bool x_tma = u >= pairs_n && tma;
    if (u >= pairs_n && !tma) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j0 = (2 * (u - pairs_n) + half) * kKo;
        stage_sw_elems_warp<kKo>(dst + 2 * half * kOTileElems,
                                 xb + hh * d.sxh + (int64_t)j0 * d.sxl,
                                 d.sxl, jmax - j0, d.p - p0);
      }
      hopper::fence_proxy_async();
      __syncwarp();
    }
    if (lane == 0) {
      // the stage's tiles, and with a head's first stage its cum and dt
      const uint32_t cd_bytes = u == 0 ? 8 * m.Qp : 0;
      const uint32_t tiles = u < pairs_n ? 4 * kOTileBytes
                             : x_tma ? 2 * kOTileBytes : 0;
      hopper::mbar_expect_tx(bar, tiles + cd_bytes);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t to = smem_u32(dst + 2 * half * kOTileElems);
        if (u < pairs_n) {
          const int r0 = (2 * u + half) * kKo;
          hopper::tma_load_3d(to, &tsh, bar, p0, r0, bch);
          hopper::tma_load_3d(to + kOTileBytes, &tsl, bar, p0, r0, bch);
        } else if (x_tma) {
          const int j0 = (2 * (u - pairs_n) + half) * kKo;
          hopper::tma_load_4d(to, &tx, bar, p0, hh, t0 + j0, bb);
        }
      }
      if (cd_bytes)
        hopper::bulk_load(smem_u32(cdr + (hl & 3) * 2 * m.Qp),
                          s.cd + (int64_t)bch * 2 * m.Qp, cd_bytes, bar);
    }
  };

  // One step: this warpgroup's A operands (C, or the masked M in halves),
  // then its products; the warp then releases the stage.
  float acc[32];                   // wgmma layout: [n8 tile][4]
  uint32_t ahi[4][4], alo[4][4];
  const bool in_a = i0 + ra < qlen, in_b = i0 + rb < qlen;
  const int ia = i0 + ra, ib = i0 + rb;
  auto step = [&](int q) {
    const int hl = q / pairs, u = q % pairs;
    hopper::mbar_wait(bars + 8 * (q % kOutStages), (q / kOutStages) & 1);
    const float* cum = cdr + (hl & 3) * 2 * m.Qp;
    const float* dtv = cum + m.Qp;
    const float cum_a = in_a ? cum[ia] : 0.f, cum_b = in_b ? cum[ib] : 0.f;
    const bool sin = u < pairs_n;
    const int j0 = sin ? 0 : (2 * (u - pairs_n) + kh) * kKo;
    const bool mx = !sin && j0 < jmax;
    const int ks = sin ? 4 : min(4, cdiv(jmax - j0, 16));
    if (sin) {
      // C_i over this warpgroup's 64 of n, exact
      const int k0 = (2 * u + kh) * kKo;
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) {
        const bf16* r0 = cs + ra * m.ldc + k0 + 16 * k2 + 2 * t;
        const bf16* r1 = r0 + 8 * m.ldc;
        ahi[k2][0] = ld_u32(r0);
        ahi[k2][1] = ld_u32(r1);
        ahi[k2][2] = ld_u32(r0 + 8);
        ahi[k2][3] = ld_u32(r1 + 8);
      }
    } else if (mx) {
      // M over this warpgroup's 64 of the chunk's columns j, in halves
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2)
#pragma unroll
        for (int q2 = 0; q2 < 2; ++q2) {       // columns 2t(+1), 2t+8(+9)
          const int j = j0 + 16 * k2 + 2 * t + 8 * q2;
          const float2 cj = *reinterpret_cast<const float2*>(cum + j);
          const float2 dj = *reinterpret_cast<const float2*>(dtv + j);
          const float2 ca = *reinterpret_cast<const float2*>(
              cb + ra * kCbLd + j);
          const float2 cbb = *reinterpret_cast<const float2*>(
              cb + rb * kCbLd + j);
          const float m0 = (in_a && j <= ia)
              ? ca.x * exp_ftz(cum_a - cj.x) * dj.x : 0.f;
          const float m1 = (in_a && j + 1 <= ia)
              ? ca.y * exp_ftz(cum_a - cj.y) * dj.y : 0.f;
          const float m2 = (in_b && j <= ib)
              ? cbb.x * exp_ftz(cum_b - cj.x) * dj.x : 0.f;
          const float m3 = (in_b && j + 1 <= ib)
              ? cbb.y * exp_ftz(cum_b - cj.y) * dj.y : 0.f;
          split2(m0, m1, &ahi[k2][2 * q2], &alo[k2][2 * q2]);
          split2(m2, m3, &ahi[k2][2 * q2 + 1], &alo[k2][2 * q2 + 1]);
        }
    }
    if (u == 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    }

    const uint32_t stg = smem_u32(ring + (q % kOutStages) * kPairElems +
                                  2 * kh * kOTileElems);
    if (sin || mx) {
      hopper::wgmma_fence();
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) {
        if (k2 >= ks) break;
        const uint64_t db = tile_desc(stg, 16 * k2);
        if (sin) {                 // S_in's halves against exact C
          hopper::wgmma_rs_n64(acc, ahi[k2], db);
          hopper::wgmma_rs_n64(acc, ahi[k2],
                               tile_desc(stg + kOTileBytes, 16 * k2));
        } else {                   // M's halves against exact x
          hopper::wgmma_rs_n64(acc, ahi[k2], db);
          hopper::wgmma_rs_n64(acc, alo[k2], db);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<32>(acc);
    }
    __syncwarp();                  // this warp is done with the stage
    if (lane == 0) hopper::mbar_arrive(empties + 8 * (q % kOutStages));
    if (sin && u == pairs_n - 1) {
      // C_i . S_in is complete: scale by exp(cum_i)
      const float ea = in_a ? exp_ftz(cum_a) : 0.f;
      const float eb = in_b ? exp_ftz(cum_b) : 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[4 * nt + 0] *= ea;
        acc[4 * nt + 1] *= ea;
        acc[4 * nt + 2] *= eb;
        acc[4 * nt + 3] *= eb;
      }
    }
    if (u == pairs - 1) {
      // the head's sums: warpgroup 1 hands its rows to warpgroup 0, which
      // adds them and writes y
      if (kh == 1) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = 8 * nt + 2 * t;
          *reinterpret_cast<float2*>(red + ra * kRedLd + col) =
              make_float2(acc[4 * nt], acc[4 * nt + 1]);
          *reinterpret_cast<float2*>(red + rb * kRedLd + col) =
              make_float2(acc[4 * nt + 2], acc[4 * nt + 3]);
        }
      }
      asm volatile("bar.sync 1, %0;\n" :: "r"(kOut) : "memory");
      if (kh == 0) {
        const int hh = h0 + hl;
        bf16* yb = y + (((int64_t)bb * d.l + t0 + i0) * d.h + hh) * d.p;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = half ? rb : ra;
            const int col = 8 * nt + 2 * t, pp = p0 + col;
            if (i0 + i >= qlen || pp >= d.p) continue;
            const float2 o = *reinterpret_cast<const float2*>(
                red + i * kRedLd + col);
            const float v0 = acc[4 * nt + 2 * half] + o.x;
            const float v1 = acc[4 * nt + 2 * half + 1] + o.y;
            bf16* dst = yb + (int64_t)i * d.h * d.p + pp;
            if ((d.p & 1) == 0) {  // the pair lies in the row, 4-byte aligned
              *reinterpret_cast<uint32_t*>(dst) = pack_rn(v0, v1);
            } else {
              dst[0] = __float2bfloat16_rn(v0);
              if (pp + 1 < d.p) dst[1] = __float2bfloat16_rn(v1);
            }
          }
      }
      // the hand-over buffer is read before the next head's is written
      asm volatile("bar.sync 1, %0;\n" :: "r"(kOut) : "memory");
    }
  };

  if (warp == kOut / 32) {         // the producer: a stage once both
    for (int q = 0; q < iters; ++q) {     // warpgroups released it
      if (q >= kOutStages)
        hopper::mbar_wait(empties + 8 * (q % kOutStages),
                          ((q / kOutStages) - 1) & 1);
      issue(q);
    }
    return;
  }
  for (int q = 0; q < iters; ++q) step(q);
}

Dims make_dims(int b, int l, int h, int p, int n, int chunk, int g) {
  Dims d{};
  d.b = b; d.l = l; d.h = h; d.p = p; d.n = n;
  d.g = g; d.hpg = h / g;
  d.Q = chunk < l ? chunk : l;
  d.nc = cdiv(l, d.Q);
  return d;
}

Scratch carve(float* base, const Dims& d) {
  const int64_t bnc = (int64_t)d.b * d.nc;
  Scratch s;
  s.st = base;                     // first: 16-byte aligned for float4 loads
  s.cb = s.st + bnc * d.h * d.n * d.p;
  s.cum = s.cb + bnc * d.g * d.Q * d.Q;
  s.dec = s.cum + bnc * d.h * d.Q;
  return s;
}

Bf16Scratch carve_bf16(void* base, const Dims& d) {
  Bf16Scratch s;
  s.pp = round_up(d.p, 8);
  s.Qp = round_up(d.Q, 4);
  const int64_t cells = (int64_t)d.b * d.nc * d.h * d.n * s.pp;
  s.sin_hi = static_cast<bf16*>(base);
  s.sin_lo = s.sin_hi + cells;     // cells is a multiple of 8: 16-byte rows
  s.cd = reinterpret_cast<float*>(s.sin_lo + cells);
  return s;
}

int64_t scratch_bytes(int dtype, const Dims& d) {
  const int64_t bnc = (int64_t)d.b * d.nc;
  if (dtype == 0)
    return 4 * bnc * ((int64_t)d.g * d.Q * d.Q + (int64_t)d.h * (d.Q + 1) +
                      (int64_t)d.h * d.n * d.p);
  return 2 * 2 * bnc * d.h * d.n * round_up(d.p, 8) +
         4 * bnc * d.h * 2 * round_up(d.Q, 4);
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor of `rank` dims (innermost first; strides in elements of
// dims 1..rank-1) whose boxes are [rows][64] tiles in 128-byte swizzle:
// `box` gives the box's extent in each dim.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int rank,
              const int64_t* dims, const int64_t* strides,
              const int* box) {
  cuuint64_t gd[5], gs[4];
  cuuint32_t bx[5], unit[5];
  for (int k = 0; k < rank; ++k) {
    gd[k] = (cuuint64_t)dims[k];
    bx[k] = (cuuint32_t)box[k];
    unit[k] = 1;
    if (k > 0) gs[k - 1] = (cuuint64_t)strides[k - 1] * 2;
  }
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
             const_cast<void*>(ptr), gd, gs, bx, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Bytes of scratch ssd_scan_fwd needs for these sizes and dtype (0 = f32,
// 1 = bf16).
int64_t ssd_scan_scratch_bytes(int dtype, int b, int l, int h, int p, int n,
                               int chunk, int g) {
  if (b < 1 || l < 1 || h < 1 || p < 1 || n < 1 || chunk < 1 || g < 1 ||
      h % g)
    return 0;
  return scratch_bytes(dtype, make_dims(b, l, h, p, n, chunk, g));
}

// The widest state (n) the bf16 form takes: its output kernel holds C of
// 64 rows and 64 rows of B, n wide, in shared memory.
int ssd_scan_bf16_max_state() {
  int n = 2 * kKo;
  while (out_smem(n + 2 * kKo, kMaxChunk).total <= kMaxSharedBytes)
    n += 2 * kKo;
  return n;
}

// dtype: 0 = f32, 1 = bf16 (of x, B, C and y). g B/C groups (h % g == 0),
// B and C [b, l, g, n]. init may be null (zero state). Strides in elements. Returns 0, a CUDA error code,
// kErrShape or kErrDtype.
int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                 const void* B, const void* C, const float* init, void* y,
                 float* final_state, void* scratch, int dtype, int b, int l,
                 int h, int p, int n, int chunk, int g, int64_t sxb,
                 int64_t sxl, int64_t sxh, int64_t sdb, int64_t sdl,
                 int64_t sbb, int64_t sbl, int64_t sbg, int64_t scb,
                 int64_t scl, int64_t scg, void* stream) {
  if (b < 1 || l < 1 || h < 1 || p < 1 || n < 1 || chunk < 1 ||
      chunk > kMaxChunk || g < 1 || h % g)
    return kErrShape;
  Dims d = make_dims(b, l, h, p, n, chunk, g);
  d.sxb = sxb; d.sxl = sxl; d.sxh = sxh;
  d.sdb = sdb; d.sdl = sdl;
  d.sbb = sbb; d.sbl = sbl; d.sbg = sbg;
  d.scb = scb; d.scl = scl; d.scg = scg;
  if (dtype != 0 && dtype != 1) return kErrDtype;
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = cdiv(d.Q, kTile), ntp = cdiv(d.p, kTile);
  const int64_t bnc = (int64_t)d.b * d.nc;
  if (dtype == 0) {
    const Scratch s = carve(static_cast<float*>(scratch), d);
    const unsigned grid_cb = (unsigned)(bnc * d.g * nt * nt);
    const unsigned grid_state =
        (unsigned)(bnc * d.h * cdiv(d.n, kTile) * ntp);
    const unsigned grid_out = (unsigned)(bnc * nt * ntp * d.h);
    const int64_t cells = (int64_t)d.b * d.h * d.n * d.p;
    const unsigned grid_carry = (unsigned)((cells + kThreads - 1) / kThreads);
    const float* xf = static_cast<const float*>(x);
    const float* Bf = static_cast<const float*>(B);
    const float* Cf = static_cast<const float*>(C);
    ssd_cb<<<grid_cb, kThreads, 0, st>>>(Bf, Cf, s, d);
    ssd_state<<<grid_state, kThreads, 0, st>>>(xf, dt, A, Bf, s, d);
    ssd_carry<<<grid_carry, kThreads, 0, st>>>(init, final_state, s, d);
    ssd_out<<<grid_out, kThreads, 0, st>>>(xf, dt, Cf, static_cast<float*>(y),
                                          s, d);
    return (int)cudaGetLastError();
  }
  const OutSmem m = out_smem(d.n, d.Q);
  if (m.total > kMaxSharedBytes) return kErrShape;
  const Bf16Scratch s = carve_bf16(scratch, d);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Bb = static_cast<const bf16*>(B);
  const bf16* Cb = static_cast<const bf16*>(C);
  // TMA takes x and B where their strides are whole 16-byte pieces and the
  // pointers 16-byte aligned (the serving path's views are); else they are
  // staged element by element. The chunk states always go by TMA.
  auto al16 = [](const void* q) { return ((uintptr_t)q & 15) == 0; };
  const bool tma = al16(x) && al16(B) && al16(C) &&
                   (d.sxb | d.sxl | d.sxh | d.sbb | d.sbl | d.sbg | d.scb |
                    d.scl | d.scg) % 8 == 0;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  // boxes of 32 rows (ssd_states_bf16's steps) and 64 (ssd_out_bf16's)
  CUtensorMap mx{}, mx2{}, mb{}, msh{}, msl{};
  {
    const int64_t dims[3] = {s.pp, d.n, (int64_t)d.b * d.nc * d.h};
    const int64_t strides[2] = {s.pp, (int64_t)d.n * s.pp};
    const int box[3] = {64, kKo, 1};
    if (!make_map(enc, &msh, s.sin_hi, 3, dims, strides, box) ||
        !make_map(enc, &msl, s.sin_lo, 3, dims, strides, box))
      return kErrTensorMap;
  }
  if (tma) {
    const int64_t xd[4] = {d.p, d.h, d.l, d.b};
    const int64_t xs[3] = {d.sxh, d.sxl, d.sxb};
    const int xbox[4] = {64, 1, kKs, 1}, xbox2[4] = {64, 1, kKo, 1};
    const int64_t bd[4] = {d.n, d.g, d.l, d.b};
    const int64_t bs[3] = {d.sbg, d.sbl, d.sbb};
    const int bbox[4] = {64, 1, kKs, 1};
    if (!make_map(enc, &mx, x, 4, xd, xs, xbox) ||
        !make_map(enc, &mx2, x, 4, xd, xs, xbox2) ||
        !make_map(enc, &mb, B, 4, bd, bs, bbox))
      return kErrTensorMap;
  }
  const unsigned grid_states =
      (unsigned)((int64_t)d.b * d.h * cdiv(d.n, 64) * ntp);
  ssd_states_bf16<<<grid_states, kStates, 0, st>>>(
      mb, mx, xb, dt, A, Bb, init, final_state, s, d, tma);
  // heads per output block: about four blocks an SM in all, each block's
  // heads inside one B/C group
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t tiles = bnc * cdiv(d.Q, kOutRows) * ntp;
  const int64_t tg = tiles * d.g;
  const int groups =
      (int)std::max<int64_t>(1, std::min<int64_t>(d.hpg, (4 * sms + tg - 1) /
                                                             tg));
  const int hpb = cdiv(d.hpg, groups);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_out_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, m.total);
  if (e != cudaSuccess) return (int)e;
  ssd_out_bf16<<<(unsigned)(tg * cdiv(d.hpg, hpb)), kOutThreads, m.total,
                 st>>>(
      msh, msl, mx2, xb, Bb, Cb, static_cast<bf16*>(y), s, d, hpb, tma);
  return (int)cudaGetLastError();
}

const char* ssd_scan_error_string(int code) {
  if (code == kErrShape)
    return "bad shape (b, l, h, p, n, g >= 1, h a multiple of g, "
           "1 <= chunk <= 256, and for bf16 n at most "
           "ssd_scan_bf16_max_state())";
  if (code == kErrDtype) return "dtype must be 0 (float32) or 1 (bfloat16)";
  if (code == kErrNoEncoder)
    return "the driver has no cuTensorMapEncodeTiled";
  if (code == kErrTensorMap) return "cuTensorMapEncodeTiled refused a map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

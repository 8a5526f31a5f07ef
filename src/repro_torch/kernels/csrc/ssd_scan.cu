// The Mamba-2 SSD (state-space duality) chunked scan, in four passes.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel
// (ssd_scan_pallas). It computes what repro/models/mamba2.py::ssd_reference
// computes, for x [b,l,h,p], dt [b,l,h] f32, A [h] f32, B and C [b,l,n]
// (shared by the heads) and an optional initial state [b,h,n,p] f32: with
// cum the running sum of dt*A inside a chunk of Q steps,
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
// Bound on an H100 at the serving path's shape (b=2, l=4096, h=80, p=64,
// n=128, Q=256, bf16): bytes. The least work is C_i . B_j over the live
// pairs j <= i of each chunk once per batch row (0.27 GFLOP), and per head
// the masked product with x over the same pairs (10.8 GFLOP), C S_in and
// the chunk states (2 l n p each, 21.5 GFLOP): 32.5 GFLOP, 0.033 ms at the
// bf16 tensor cores' 989 TFLOP/s (0.49 ms at the CUDA cores' 67 TFLOP/s);
// x, y, dt, B, C and the final state are 180 MB, 0.054 ms at 3.35 TB/s.
//
// Design. The TPU grid (b, h, chunk) walks the chunks in order and keeps
// the [n, p] state in VMEM; here the chunks are independent but for a
// cheap carry, so every pass runs across all chunks at once:
//   1. ssd_cb: C B^T of each (b, chunk), once for all heads (the TPU
//      kernel recomputed it per head), into scratch [b, nc, Q, Q];
//   2. ssd_state: per (b, chunk, head, n tile, p tile) the running sum of
//      dt*A over the chunk, the chunk's decay exp(cum_last) and its local
//      state sum_j B_j (w_j x_j)^T, w = exp(cum_last - cum) dt, into
//      scratch [b, nc, h, n, p];
//   3. ssd_carry: one thread per (b, h, n, p) element walks the chunks,
//      overwrites each local state with the state entering the chunk and
//      writes the final state;
//   4. ssd_out: per (b, chunk, 64-row tile, p tile, head) C_i . S_in,
//      scaled by exp(cum_i), plus the masked product with x over the
//      tile's causal columns; y written once.
// The causal mask is applied before the exp (exp(cum_i - cum_j) overflows
// for j > i), and rows or columns past the chunk are staged as zeros.
// Passes 2 and 4 produce 64 x 64 output tiles, the reduction staged 32 deep
// in shared memory; pass 1 is the CUDA-core form below for both types.
//   f32 inputs: IEEE f32 on the CUDA cores (TF32 would miss the reference's
//   5e-5). 256 threads, 4 x 4 outputs each at a stride of 16 rows and 16
//   columns, so shared-memory reads are conflict-free or broadcast.
//   bf16 inputs (the serving path): the tensor cores, mma.sync.m16n8k16
//   with f32 accumulation, 4 warps of 16 rows x 64 columns. x, B and C are
//   exact in bf16 and go in as they are (B^T and x through ldmatrix.trans
//   from row-major tiles, rows padded by 8 elements so fragment loads hit
//   32 banks); each f32 operand (the masked M, w x, S_in) is split into
//   two bf16 halves hi = bf16(v), lo = bf16(v - hi) and multiplied twice,
//   so the products keep about 16 of f32's 24 bits.
// The scratch is b*nc*(Q*Q + h*(Q + 1 + n*p)) floats (95 MB at the path's
// shape, mostly the chunk states, which pass 4 reads back).
//
// Not yet done (the next steps toward the bound): C B^T on the tensor
// cores, wgmma and TMA, and fusing passes 2-4 so the chunk states stay on
// chip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 256;
constexpr int kThreads = 256;
constexpr int kTile = 64;        // output tile is kTile x kTile
constexpr int kK = 32;           // reduction depth staged per step
constexpr int kLd = kTile + 1;   // padded row of a staged [kK][kTile] tile

enum : int { kErrShape = -1, kErrDtype = -2 };

struct Dims {
  int b, l, h, p, n, Q, nc;
  int64_t sxb, sxl, sxh;   // x [b, l, h, p], p contiguous
  int64_t sdb, sdl;        // dt [b, l, h], h contiguous
  int64_t sbb, sbl;        // B [b, l, n], n contiguous
  int64_t scb, scl;        // C [b, l, n], n contiguous
};

// Scratch layout (floats).
struct Scratch {
  float* cb;    // [b, nc, Q, Q]
  float* cum;   // [b, nc, h, Q]
  float* dec;   // [b, nc, h]
  float* st;    // [b, nc, h, n, p]
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

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

// Pass 1: CB[b, c, i, j] = C_i . B_j for the tiles with j-tile <= i-tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_cb(const T* __restrict__ B, const T* __restrict__ C,
           Scratch s, Dims d) {
  __shared__ float Cs[kK][kLd];   // [n][i]
  __shared__ float Bs[kK][kLd];   // [n][j]
  const int nt = cdiv(d.Q, kTile);
  int blk = blockIdx.x;
  const int tj = blk % nt; blk /= nt;
  const int ti = blk % nt; blk /= nt;
  const int c = blk % d.nc, bb = blk / d.nc;
  const int t0 = c * d.Q, qlen = min(d.Q, d.l - t0);
  const int i0 = ti * kTile, j0 = tj * kTile;
  if (tj > ti || i0 >= qlen) return;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* Cb = C + bb * d.scb + (int64_t)t0 * d.scl;
  const T* Bb = B + bb * d.sbb + (int64_t)t0 * d.sbl;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < d.n; k0 += kK) {
    #pragma unroll 4
    for (int u = 0; u < kK * kTile / kThreads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int k = e % kK, r = e / kK, nn = k0 + k;
      const bool kin = nn < d.n;
      Cs[k][r] = (kin && i0 + r < qlen) ? ld(Cb + (i0 + r) * d.scl + nn) : 0.f;
      Bs[k][r] = (kin && j0 + r < qlen) ? ld(Bb + (j0 + r) * d.sbl + nn) : 0.f;
    }
    __syncthreads();
    mac_tile(acc, Cs, Bs, ty, tx);
    __syncthreads();
  }
  float* out = s.cb + ((int64_t)bb * d.nc + c) * d.Q * d.Q;
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
  const float* Bb = B + bb * d.sbb + (int64_t)t0 * d.sbl;
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
  const float* cb = s.cb + ((int64_t)bb * d.nc + c) * d.Q * d.Q;
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
  const float* Cb = C + bb * d.scb + (int64_t)t0 * d.scl;
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
// bf16 inputs: passes 2 and 4 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;   // 4 warps, 16 rows of the 64-row tile each
constexpr int kAld = kK + 8;      // A tiles [kTile][kAld] bf16, k contiguous
constexpr int kBld = kTile + 8;   // B tiles [kK][kBld] bf16, n contiguous
constexpr int kNT = kTile / 8;    // n8 tiles of a warp's 16 x 64 output

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// B fragment of a k16 x n8 step from a row-major [k][n] tile: lanes 0-15
// give the addresses of rows k0 .. k0 + 15 at column n0.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const bf16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// A fragment of a m16 x k16 step from a row-major [k][m] tile (the
// transpose of A): lane l gives the address of row k0 + (l & 7) + 8 (l >> 4)
// at column m0 + 8 ((l >> 3) & 1).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of a m16 x k16 step from a row-major [m][k] tile, rows m0..
__device__ __forceinline__ void a_frag(uint32_t* a, const bf16* tile, int m0,
                                       int k0, int g, int t) {
  const bf16* r0 = tile + (m0 + g) * kAld + k0 + 2 * t;
  const bf16* r1 = r0 + 8 * kAld;
  a[0] = ld_u32(r0);
  a[1] = ld_u32(r1);
  a[2] = ld_u32(r0 + 8);
  a[3] = ld_u32(r1 + 8);
}

// v = hi + lo with hi = bf16(v), lo = bf16(v - hi): the pair carries 16 of
// v's 24 bits, so a product of the pair with an exact bf16 operand, summed
// in f32, is within about 2^-17 of v's own (the f32 tiles of passes 2 and
// 4 go through the tensor cores this way).
__device__ __forceinline__ void split_bf16(float v, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - __bfloat162float(h));
}

// acc[nt] += A[16 rows of this warp][k16] B[k16][n8 tile nt] for both halves
// of B, over one staged kK step (A exact in one tile).
__device__ __forceinline__ void mma_step_bsplit(float (&acc)[kNT][4],
                                                const bf16* A, int m0,
                                                const bf16* Bhi,
                                                const bf16* Blo, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kK; kk += 16) {
    uint32_t a[4];
    a_frag(a, A, m0, kk, g, t);
    const int row = (kk + (lane & 15)) * kBld;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      uint32_t bh[2], bl[2];
      ldmatrix_x2_trans(bh, Bhi + row + nt * 8);
      ldmatrix_x2_trans(bl, Blo + row + nt * 8);
      mma_bf16_16816(acc[nt], a, bh);
      mma_bf16_16816(acc[nt], a, bl);
    }
  }
}

// Staging of the tensor-core passes. `vec`: 16-byte loads (8 bf16 or 4
// f32) where the pointers, the row strides and the widths allow them (the
// host checks; the serving path's views do), else one element at a time.
// Rows past rlim and columns past clim are staged as zeros.

// A [R][C] bf16 tile into dst (row stride ld), exact.
template <int R, int C>
__device__ __forceinline__ void tile_bf16(bf16* dst, int ld, const bf16* src,
                                          int64_t rs, int rlim, int clim,
                                          bool vec) {
  if (vec) {
    constexpr int C8 = C / 8, N = R * C8;
#pragma unroll
    for (int u = 0; u < N / kTcThreads; ++u) {
      const int e = threadIdx.x + u * kTcThreads;
      const int r = e / C8, c = (e % C8) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rlim && c < clim)
        v = *reinterpret_cast<const uint4*>(src + r * rs + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll 4
    for (int u = 0; u < R * C / kTcThreads; ++u) {
      const int e = threadIdx.x + u * kTcThreads;
      const int r = e / C, c = e % C;
      dst[r * ld + c] = (r < rlim && c < clim) ? src[r * rs + c] : zero;
    }
  }
}

__device__ __forceinline__ uint32_t pack2(bf16 a, bf16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// Four f32 values, split, into hi[0..3] and lo[0..3] (8-byte stores).
__device__ __forceinline__ void put4_split(bf16* hi, bf16* lo,
                                           const float* v) {
  bf16 h[4], l[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) split_bf16(v[k], &h[k], &l[k]);
  *reinterpret_cast<uint2*>(hi) = make_uint2(pack2(h[0], h[1]),
                                             pack2(h[2], h[3]));
  *reinterpret_cast<uint2*>(lo) = make_uint2(pack2(l[0], l[1]),
                                             pack2(l[2], l[3]));
}

// A [R][C] f32 tile times a per-row factor (scale[r], or 1 if null), split
// into the hi and lo tiles (row stride ld). src rows are f32 (src_f) or
// bf16 (src_b), one of them set.
template <int R, int C>
__device__ __forceinline__ void tile_split(bf16* hi, bf16* lo, int ld,
                                           const float* src_f,
                                           const bf16* src_b, int64_t rs,
                                           const float* scale, int rlim,
                                           int clim, bool vec) {
  constexpr int C4 = C / 4, N = R * C4;
  if (vec) {
#pragma unroll
    for (int u = 0; u < N / kTcThreads; ++u) {
      const int e = threadIdx.x + u * kTcThreads;
      const int r = e / C4, c = (e % C4) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < rlim && c < clim) {
        if (src_f) {
          const float4 q = *reinterpret_cast<const float4*>(src_f + r * rs + c);
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
          const uint2 q = *reinterpret_cast<const uint2*>(src_b + r * rs + c);
          const bf16* b4 = reinterpret_cast<const bf16*>(&q);
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = __bfloat162float(b4[k]);
        }
        const float f = scale ? scale[r] : 1.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] *= f;
      }
      put4_split(hi + r * ld + c, lo + r * ld + c, v);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < R * C / kTcThreads; ++u) {
      const int e = threadIdx.x + u * kTcThreads;
      const int r = e / C, c = e % C;
      float v = 0.f;
      if (r < rlim && c < clim)
        v = (src_f ? src_f[r * rs + c] : __bfloat162float(src_b[r * rs + c])) *
            (scale ? scale[r] : 1.f);
      split_bf16(v, hi + r * ld + c, lo + r * ld + c);
    }
  }
}

// Pass 2 for bf16 inputs: S_c[n, p] = sum_j B_j[n] (w_j x_j[p]); A = B^T
// from the [j][n] tile by ldmatrix.trans (exact), w x split in two halves.
__global__ void __launch_bounds__(kTcThreads)
    ssd_state_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ B,
                 Scratch s, Dims d, bool vec) {
  __shared__ float cum_s[kMaxChunk];
  __shared__ float w_s[kMaxChunk];
  __shared__ __align__(16) bf16 Bs[kK][kBld];    // [j][n]
  __shared__ __align__(16) bf16 Xhi[kK][kBld];   // [j][p] of w x
  __shared__ __align__(16) bf16 Xlo[kK][kBld];
  const int ntn = cdiv(d.n, kTile), ntp = cdiv(d.p, kTile);
  int blk = blockIdx.x;
  const int pt = blk % ntp; blk /= ntp;
  const int nt0 = blk % ntn; blk /= ntn;
  const int hh = blk % d.h; blk /= d.h;
  const int c = blk % d.nc, bb = blk / d.nc;
  const int t0 = c * d.Q, qlen = min(d.Q, d.l - t0);
  const int n0 = nt0 * kTile, p0 = pt * kTile;
  const int64_t bch = ((int64_t)bb * d.nc + c) * d.h + hh;
  chunk_decays(dt + bb * d.sdb + (int64_t)t0 * d.sdl + hh, d.sdl, A[hh],
               qlen, cum_s, w_s, s, bch, d.Q, nt0 == 0 && pt == 0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* Bb = B + bb * d.sbb + (int64_t)t0 * d.sbl + n0;
  const bf16* xb = x + bb * d.sxb + (int64_t)t0 * d.sxl + hh * d.sxh + p0;
  float acc[kNT][4] = {};
  for (int j0 = 0; j0 < qlen; j0 += kK) {
    tile_bf16<kK, kTile>(&Bs[0][0], kBld, Bb + j0 * d.sbl, d.sbl, qlen - j0,
                         d.n - n0, vec);
    tile_split<kK, kTile>(&Xhi[0][0], &Xlo[0][0], kBld, nullptr,
                          xb + j0 * d.sxl, d.sxl, w_s + j0, qlen - j0,
                          d.p - p0, vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kK; kk += 16) {
      uint32_t af[4];
      const int mi = lane >> 3;
      ldmatrix_x4_trans(af, &Bs[kk + (lane & 7) + 8 * (mi >> 1)]
                                [16 * warp + 8 * (mi & 1)]);
      const int row = kk + (lane & 15);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t bh[2], bl[2];
        ldmatrix_x2_trans(bh, &Xhi[row][nt * 8]);
        ldmatrix_x2_trans(bl, &Xlo[row][nt * 8]);
        mma_bf16_16816(acc[nt], af, bh);
        mma_bf16_16816(acc[nt], af, bl);
      }
    }
    __syncthreads();
  }
  const int g = lane >> 2, t = lane & 3;
  float* out = s.st + bch * d.n * d.p;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int nn = n0 + 16 * warp + g + 8 * (e >> 1);
      const int pp = p0 + nt * 8 + 2 * t + (e & 1);
      if (nn < d.n && pp < d.p) out[(int64_t)nn * d.p + pp] = acc[nt][e];
    }
}

// The masked M[i, j] = CB[i, j] exp(cum_i - cum_j) dt_j (j <= i < qlen) of
// rows i0.., columns j0.. into the hi and lo [kTile][kAld] tiles.
__device__ __forceinline__ void tile_m(bf16* hi, bf16* lo, const float* cb,
                                       int Q, const float* cum_s,
                                       const float* dt_s, int i0, int j0,
                                       int qlen, bool vec) {
  constexpr int C4 = kK / 4, N = kTile * C4;
  if (vec) {
#pragma unroll
    for (int u = 0; u < N / kTcThreads; ++u) {
      const int e = threadIdx.x + u * kTcThreads;
      const int r = e / C4, c = (e % C4) * 4, i = i0 + r, j = j0 + c;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (i < qlen && j <= i) {
        const float4 q =
            *reinterpret_cast<const float4*>(cb + (int64_t)i * Q + j);
        const float cv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (j + k <= i)
            v[k] = cv[k] * expf(cum_s[i] - cum_s[j + k]) * dt_s[j + k];
      }
      put4_split(hi + r * kAld + c, lo + r * kAld + c, v);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < kTile * kK / kTcThreads; ++u) {
      const int e = threadIdx.x + u * kTcThreads;
      const int r = e / kK, c = e % kK, i = i0 + r, j = j0 + c;
      const float v = (j <= i && i < qlen)
                          ? cb[(int64_t)i * Q + j] *
                                expf(cum_s[i] - cum_s[j]) * dt_s[j]
                          : 0.f;
      split_bf16(v, hi + r * kAld + c, lo + r * kAld + c);
    }
  }
}

// Pass 4 for bf16 inputs: y = exp(cum_i) C_i . S_in + M x, with C and x
// exact and S_in and M split in two halves. Held to 96 registers so that
// five blocks share an SM (0.42 ms at the path's shape, against 0.59 ms at
// the 136 registers it takes unbounded, with three).
__global__ void __launch_bounds__(kTcThreads, 5)
    ssd_out_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
               const bf16* __restrict__ C, bf16* __restrict__ y, Scratch s,
               Dims d, bool vec) {
  __shared__ float cum_s[kMaxChunk];
  __shared__ float dt_s[kMaxChunk];
  __shared__ __align__(16) bf16 Ahi[kTile][kAld];   // [i][k] of C, then M
  __shared__ __align__(16) bf16 Alo[kTile][kAld];
  __shared__ __align__(16) bf16 Bhi[kK][kBld];      // [k][p] of S_in, then x
  __shared__ __align__(16) bf16 Blo[kK][kBld];
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
  for (int j = threadIdx.x; j < jmax; j += kTcThreads) {
    cum_s[j] = s.cum[bch * d.Q + j];
    dt_s[j] = dt[bb * d.sdb + (int64_t)(t0 + j) * d.sdl + hh];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float acc[kNT][4] = {};
  // inter-chunk first: acc = C_i . S_in, then scaled by exp(cum_i)
  const bf16* Cb = C + bb * d.scb + (int64_t)(t0 + i0) * d.scl;
  const float* sin = s.st + bch * d.n * d.p + p0;
  for (int k0 = 0; k0 < d.n; k0 += kK) {
    tile_bf16<kTile, kK>(&Ahi[0][0], kAld, Cb + k0, d.scl, qlen - i0,
                         d.n - k0, vec);
    tile_split<kK, kTile>(&Bhi[0][0], &Blo[0][0], kBld,
                          sin + (int64_t)k0 * d.p, nullptr, d.p, nullptr,
                          d.n - k0, d.p - p0, vec);
    __syncthreads();
    mma_step_bsplit(acc, &Ahi[0][0], 16 * warp, &Bhi[0][0], &Blo[0][0],
                    lane);
    __syncthreads();
  }
  const int ra = i0 + 16 * warp + g, rb = ra + 8;
  const float ea = ra < qlen ? expf(cum_s[ra]) : 0.f;
  const float eb = rb < qlen ? expf(cum_s[rb]) : 0.f;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    acc[nt][0] *= ea;
    acc[nt][1] *= ea;
    acc[nt][2] *= eb;
    acc[nt][3] *= eb;
  }
  // intra-chunk: M[i, j] = CB[i, j] exp(cum_i - cum_j) dt_j for j <= i
  const float* cb = s.cb + ((int64_t)bb * d.nc + c) * d.Q * d.Q;
  const bf16* xb = x + bb * d.sxb + (int64_t)t0 * d.sxl + hh * d.sxh + p0;
  for (int j0 = 0; j0 < jmax; j0 += kK) {
    tile_m(&Ahi[0][0], &Alo[0][0], cb, d.Q, cum_s, dt_s, i0, j0, qlen, vec);
    tile_bf16<kK, kTile>(&Bhi[0][0], kBld, xb + j0 * d.sxl, d.sxl, jmax - j0,
                         d.p - p0, vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kK; kk += 16) {
      uint32_t ah[4], al[4];
      a_frag(ah, &Ahi[0][0], 16 * warp, kk, g, t);
      a_frag(al, &Alo[0][0], 16 * warp, kk, g, t);
      const int row = kk + (lane & 15);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t bx[2];
        ldmatrix_x2_trans(bx, &Bhi[row][nt * 8]);
        mma_bf16_16816(acc[nt], ah, bx);
        mma_bf16_16816(acc[nt], al, bx);
      }
    }
    __syncthreads();
  }
  bf16* yb = y + (((int64_t)bb * d.l + t0) * d.h + hh) * d.p;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int i = e < 2 ? ra : rb;
      const int pp = p0 + nt * 8 + 2 * t;
      if (i >= qlen || pp >= d.p) continue;
      bf16* dst = yb + (int64_t)i * d.h * d.p + pp;
      if (vec) {          // p even: the pair lies in the row, 4-byte aligned
        *reinterpret_cast<uint32_t*>(dst) =
            pack2(__float2bfloat16_rn(acc[nt][e]),
                  __float2bfloat16_rn(acc[nt][e + 1]));
      } else {
        dst[0] = __float2bfloat16_rn(acc[nt][e]);
        if (pp + 1 < d.p) dst[1] = __float2bfloat16_rn(acc[nt][e + 1]);
      }
    }
}

Dims make_dims(int b, int l, int h, int p, int n, int chunk) {
  Dims d{};
  d.b = b; d.l = l; d.h = h; d.p = p; d.n = n;
  d.Q = chunk < l ? chunk : l;
  d.nc = cdiv(l, d.Q);
  return d;
}

Scratch carve(float* base, const Dims& d) {
  const int64_t bnc = (int64_t)d.b * d.nc;
  Scratch s;
  s.st = base;                     // first: 16-byte aligned for float4 loads
  s.cb = s.st + bnc * d.h * d.n * d.p;
  s.cum = s.cb + bnc * d.Q * d.Q;
  s.dec = s.cum + bnc * d.h * d.Q;
  return s;
}

}  // namespace

extern "C" {

// Floats of scratch ssd_scan_fwd needs for these sizes.
int64_t ssd_scan_scratch_floats(int b, int l, int h, int p, int n,
                                int chunk) {
  if (b < 1 || l < 1 || h < 1 || p < 1 || n < 1 || chunk < 1) return 0;
  const Dims d = make_dims(b, l, h, p, n, chunk);
  const int64_t bnc = (int64_t)d.b * d.nc;
  return bnc * ((int64_t)d.Q * d.Q + (int64_t)d.h * (d.Q + 1) +
                (int64_t)d.h * d.n * d.p);
}

// dtype: 0 = f32, 1 = bf16 (of x, B, C and y). init may be null (zero
// state). Strides in elements. Returns 0, a CUDA error code, kErrShape or
// kErrDtype.
int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                 const void* B, const void* C, const float* init, void* y,
                 float* final_state, float* scratch, int dtype, int b, int l,
                 int h, int p, int n, int chunk, int64_t sxb, int64_t sxl,
                 int64_t sxh, int64_t sdb, int64_t sdl, int64_t sbb,
                 int64_t sbl, int64_t scb, int64_t scl, void* stream) {
  if (b < 1 || l < 1 || h < 1 || p < 1 || n < 1 || chunk < 1 ||
      chunk > kMaxChunk)
    return kErrShape;
  Dims d = make_dims(b, l, h, p, n, chunk);
  d.sxb = sxb; d.sxl = sxl; d.sxh = sxh;
  d.sdb = sdb; d.sdl = sdl;
  d.sbb = sbb; d.sbl = sbl;
  d.scb = scb; d.scl = scl;
  if (dtype != 0 && dtype != 1) return kErrDtype;
  const Scratch s = carve(scratch, d);
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = cdiv(d.Q, kTile), ntp = cdiv(d.p, kTile);
  const int64_t bnc = (int64_t)d.b * d.nc;
  const unsigned grid_cb = (unsigned)(bnc * nt * nt);
  const unsigned grid_state = (unsigned)(bnc * d.h * cdiv(d.n, kTile) * ntp);
  const unsigned grid_out = (unsigned)(bnc * nt * ntp * d.h);
  const int64_t cells = (int64_t)d.b * d.h * d.n * d.p;
  const unsigned grid_carry = (unsigned)((cells + kThreads - 1) / kThreads);
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    const float* Bf = static_cast<const float*>(B);
    const float* Cf = static_cast<const float*>(C);
    ssd_cb<float><<<grid_cb, kThreads, 0, st>>>(Bf, Cf, s, d);
    ssd_state<<<grid_state, kThreads, 0, st>>>(xf, dt, A, Bf, s, d);
    ssd_carry<<<grid_carry, kThreads, 0, st>>>(init, final_state, s, d);
    ssd_out<<<grid_out, kThreads, 0, st>>>(xf, dt, Cf, static_cast<float*>(y),
                                          s, d);
  } else {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* Bb = static_cast<const bf16*>(B);
    const bf16* Cb = static_cast<const bf16*>(C);
    ssd_cb<bf16><<<grid_cb, kThreads, 0, st>>>(Bb, Cb, s, d);
    // 16-byte staging: 8-element rows in x, B and C, aligned pointers and
    // strides, 4-float rows in the chunk states and C B^T
    auto al16 = [](const void* q) { return ((uintptr_t)q & 15) == 0; };
    const bool vec = d.p % 8 == 0 && d.n % 8 == 0 && d.Q % 4 == 0 &&
                     al16(x) && al16(B) && al16(C) && al16(scratch) &&
                     (d.sxb | d.sxl | d.sxh | d.sbb | d.sbl | d.scb |
                      d.scl) % 8 == 0;
    ssd_state_tc<<<grid_state, kTcThreads, 0, st>>>(xb, dt, A, Bb, s, d, vec);
    ssd_carry<<<grid_carry, kThreads, 0, st>>>(init, final_state, s, d);
    ssd_out_tc<<<grid_out, kTcThreads, 0, st>>>(
        xb, dt, Cb, static_cast<bf16*>(y), s, d, vec);
  }
  return (int)cudaGetLastError();
}

const char* ssd_scan_error_string(int code) {
  if (code == kErrShape)
    return "bad shape (b, l, h, p, n >= 1 and 1 <= chunk <= 256)";
  if (code == kErrDtype) return "dtype must be 0 (float32) or 1 (bfloat16)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Causal, optionally local-window attention with GQA/MQA and online softmax.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_attn_kernel
// (flash_attention_bhsd). It computes what the reference's plain path
// repro/models/layers.py::_sdpa computes for self-attention with no cache:
// q is divided by sqrt(D); query i sees keys j <= i and, if window W > 0,
// j > i - W; masked logits are -1e30; q head h reads KV head h / (Hq/Hkv);
// the sums are f32, the denominator at least 1e-30, and the output is in
// q's dtype. Inputs are in the model's layout, q [B,S,Hq,D] and k/v
// [B,S,Hkv,D], read through their strides (the last dimension contiguous),
// so the caller needs no transposes; the output is a contiguous [B,S,Hq,D].
// f32 and bf16 inputs, D up to 256, any S (the TPU kernel visits the keys
// only up to a multiple of its block, and at S=640 misses keys 512-639).
//
// Bound on an H100: operations. At RecurrentGemma's serving shape (B=2,
// S=4096, Hq=10, Hkv=1, D=256, W=2048, bf16) the 6,292,480 live (query,
// key) pairs of each (b, h) cost 4*B*Hq*D*pairs = 1.29e11 operations, 0.130
// ms at the tensor cores' 989 TFLOP/s, against 0.028 ms for the 92 MB of
// q, k, v and the output at 3.35 TB/s; at Qwen2-7B's prefill (B=2, S=4096,
// Hq=28, Hkv=4, D=128, causal) 2.41e11 operations, 0.243 ms.
//
// Three forms; kernels/flash_attention.py::_form picks one from dtype, D
// and strides before the launch (a failed launch raises, it never falls
// back to another form).
//
// Hopper form (bf16, D 64, 128 or 256, strides and pointers TMA-legal: both
// serving paths). One block of two warpgroups per (128-query tile, q head,
// batch row); the grid runs the last query tiles (the most keys under a
// causal mask) first. One thread issues TMA loads: the q tile once, then
// the band's K and V tiles through rings of 2 slots with full and empty
// mbarriers (K and V apart), all in 128-byte swizzle, read through tensor
// maps over the model's [B, S, H, D] layout and strides (rows past S
// arrive as zeros). Each warpgroup (up to 255 registers a thread) owns 64
// query rows: S = q k^T by wgmma (both operands in shared memory, f32
// accumulators), the online softmax in registers with 1/sqrt(D) and
// log2(e) folded into one scale and exp2f, O += P v by wgmma with P
// rounded to bf16 in registers (the A operand) and v as the transposed B
// operand straight from its tile. A warpgroup issues the products of tile
// i+1 (scores) and tile i (P v) together and runs the softmax of tile i+1
// while P v runs; the two warpgroups take turns issuing (ping-pong), so
// one's softmax overlaps the other's products. Only tiles that cross the
// diagonal, the window's lower edge or S are masked; a warpgroup skips
// tiles wholly masked for its rows. D 256: 64-key tiles, O is 128 f32
// registers a thread, 197 KB of shared memory (q 64 KB, 2 x (K 32 KB + V
// 32 KB)); D 128 and 64: 128-key tiles (160 KB at D 128). The scale differs
// from the reference's q / sqrt(D) in f32 by rounding only, inside the bf16
// tolerance; the f32 form keeps the reference's division.
//
// mma.sync form (bf16 otherwise: D 36 or 40, unaligned strides) and the
// f32 form: one block per (64-query tile, q head, batch); the key loop runs
// over [max(0, q0 - W + 1), q0 + 63] only; every visited 64-key tile is
// masked elementwise; the running max and denominator of each row live in
// registers.
//
// mma.sync form: tensor cores through mma.sync.m16n8k16 with f32
// accumulation. 4 warps, 16 query rows each. The q tile and one key tile of
// k and v are staged in shared memory as bf16 (16-byte loads where the
// strides allow), rows padded by 8 elements so that the fragment loads and
// ldmatrix hit 32 distinct banks: 101,376 bytes at D=256, two blocks per
// SM. S = q k^T comes from 32-bit fragment loads of q and k; the scores are
// divided by sqrt(D), masked, exponentiated in f32, rounded to bf16 and fed
// from registers as the A operand of P v (the C layout of two n8 tiles is
// the A layout of one k16 step); v's B fragments come from
// ldmatrix.trans. The output accumulator is D/2 f32 registers a thread.
// The rounding of P to bf16 is the only step that is not f32 (relative
// 2^-9 on each weight, averaged over the keys).
//
// f32: IEEE f32 on the CUDA cores (the 2e-5 tolerance rules out TF32),
// held to the CUDA cores' 67 TFLOP/s. 256 threads; the q tile (pre-divided
// by sqrt(D)) and one key tile of k and v staged in shared memory, rows
// padded to D+1 floats (214,016 bytes at D=256); each thread owns 4 rows x
// 4 keys of the score tile and 4 rows x D/16 columns of the output.
//
// Not yet done in the Hopper form: a persistent grid (each block's q and
// first K/V loads are waited for before its first product).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using hopper::mma_bf16_16816;
using hopper::pack_bf16x2;
using hopper::quad_max;
using hopper::quad_sum;

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 row groups x 16 column lanes
constexpr int kPLD = kBK + 1;    // padded row stride of the probability tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

enum : int {
  kErrHeadDim = -1,
  kErrShape = -2,
  kErrDtype = -3,
  kErrLayout = -4,
  kErrTensorMap = -5,
  kErrNoEncoder = -6,
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// two 8x8 bf16 matrices, transposed: the B fragment of a k16 x n8 step
// from a row-major [k][n] tile (lanes 0-15 give the rows' addresses)
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const void* smem_row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + 64) of one head of src into a [64][DP + 8] bf16 tile;
// rows past S and columns past D are zero. `vec`: D, the strides and the
// pointers allow 16-byte loads.
template <int DP>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int64_t row_stride, int row0,
                                           int S, int D, bool vec) {
  constexpr int LDS = DP + 8;
  if (vec) {
    constexpr int C8 = DP / 8;
    for (int e = threadIdx.x; e < 64 * C8; e += blockDim.x) {
      const int r = e / C8, c = (e % C8) * 8, s = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (s < S && c < D)
        val = *reinterpret_cast<const uint4*>(src + s * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
    }
  } else {
    for (int e = threadIdx.x; e < 64 * DP; e += blockDim.x) {
      const int r = e / DP, c = e % DP, s = row0 + r;
      dst[r * LDS + c] = (s < S && c < D) ? src[s * row_stride + c]
                                          : __float2bfloat16_rn(0.f);
    }
  }
}

template <int DP>
constexpr size_t smem_bytes_bf16() {
  return sizeof(__nv_bfloat16) * (size_t)3 * 64 * (DP + 8);
}

template <int DP>
__global__ void __launch_bounds__(128)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int S, int D,
                            int Hq, int group, int window,
                            int64_t qsb, int64_t qss, int64_t qsh,
                            int64_t ksb, int64_t kss, int64_t ksh,
                            int64_t vsb, int64_t vss, int64_t vsh,
                            float q_div, int vec) {
  constexpr int LDS = DP + 8;     // bf16 row stride of the staged tiles
  constexpr int NT = DP / 8;      // n8 tiles of the output row
  constexpr int KS = DP / 16;     // k16 steps over D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + 64 * LDS;
  __nv_bfloat16* sv = sk + 64 * LDS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;   // fragment row / column pair
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row_a = q0 + warp * 16 + g;     // this thread's two rows
  const int row_b = row_a + 8;

  stage_bf16<DP>(sq, q + b * qsb + h * qsh, qss, q0, S, D, vec);
  const __nv_bfloat16* kb = k + b * ksb + (h / group) * ksh;
  const __nv_bfloat16* vb = v + b * vsb + (h / group) * vsh;

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = min(S, q0 + kBQ);
  const __nv_bfloat16* qw = sq + (warp * 16) * LDS;
  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();             // the previous tile's readers are done
    stage_bf16<DP>(sk, kb, kss, k0, S, D, vec);
    stage_bf16<DP>(sv, vb, vss, k0, S, D, vec);
    __syncthreads();

    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 16 + 2 * t;
      const uint32_t a[4] = {ld_u32(qw + g * LDS + c),
                             ld_u32(qw + (g + 8) * LDS + c),
                             ld_u32(qw + g * LDS + c + 8),
                             ld_u32(qw + (g + 8) * LDS + c + 8)};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kr = sk + (n * 8 + g) * LDS + c;
        const uint32_t bb[2] = {ld_u32(kr), ld_u32(kr + 8)};
        mma_bf16_16816(sc[n], a, bb);
      }
    }

    // scale, mask, row max (rows a and b of this thread, quad-reduced)
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_a : row_b;
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const bool live = key < S && key <= row &&
                          (window <= 0 || key > row - window);
        sc[n][e] = live ? sc[n][e] / q_div : kNegInf;
        if (e < 2) mx_a = fmaxf(mx_a, sc[n][e]);
        else mx_b = fmaxf(mx_b, sc[n][e]);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn_a : mn_b;
        const float p = sc[n][e] > 0.5f * kNegInf ? expf(sc[n][e] - mn) : 0.f;
        sc[n][e] = p;
        if (e < 2) rs_a += p;
        else rs_b += p;
      }
    l_a = l_a * al_a + quad_sum(rs_a);
    l_b = l_b * al_b + quad_sum(rs_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
    }

    // o += P v, P from the score registers, v's fragments by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const __nv_bfloat16* vr = sv + (kk * 16 + (lane & 15)) * LDS;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb[2];
        ldmatrix_x2_trans(bb, vr + n * 8);
        mma_bf16_16816(o[n], a, bb);
      }
    }
  }

  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row_a : row_b;
      const int col = n * 8 + 2 * t + (e & 1);
      if (row < S && col < D)
        out[(((int64_t)b * S + row) * Hq + h) * D + col] =
            __float2bfloat16_rn(o[n][e] / (e < 2 ? den_a : den_b));
    }
}

template <int DP>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (DP + 1) + kBQ * kPLD);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int S,
                       int D, int Hq, int group, int window,
                       int64_t qsb,
                       int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
                       int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
                       float q_div) {
  constexpr int LD = DP + 1;     // padded row stride of the q/k/v tiles
  constexpr int NC = DP / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;              // [kBQ][LD]
  float* sk = sq + kBQ * LD;     // [kBK][LD]
  float* sv = sk + kBK * LD;     // [kBK][LD]
  float* sp = sv + kBK * LD;     // [kBQ][kPLD]

  const int tid = threadIdx.x;
  const int rg = tid >> 4;       // rows rg*4 .. rg*4+3 of the tile
  const int cl = tid & 15;       // keys cl + 16*j, columns cl + 16*c
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / group) * ksh;
  const float* vb = v + b * vsb + (h / group) * vsh;

  // q tile divided by sqrt(D) as the reference does; rows past S and
  // columns past D are zero (they add nothing to any product)
  for (int e = tid; e < kBQ * DP; e += kThreads) {
    const int r = e / DP, c = e % DP, s = q0 + r;
    sq[r * LD + c] = (s < S && c < D) ? qb[s * qss + c] / q_div : 0.f;
  }

  float o[4][NC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }

  // keys of the band: [max(0, q0 - W + 1), min(S, q0 + kBQ))
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = min(S, q0 + kBQ);
  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();             // the previous tile's readers are done
    for (int e = tid; e < kBK * DP; e += kThreads) {
      const int r = e / DP, c = e % DP, s = k0 + r;
      const bool in = s < S && c < D;
      sk[r * LD + c] = in ? kb[s * kss + c] : 0.f;
      sv[r * LD + c] = in ? vb[s * vss + c] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sq[(rg * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sk[(cl + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + cl + 16 * j;
        const bool live = kj < S && kj <= qi &&
                          (window <= 0 || kj > qi - window);
        sc[i][j] = live ? sc[i][j] : kNegInf;
        mt = fmaxf(mt, sc[i][j]);
      }
      const float mn = fmaxf(m[i], half_warp_max(mt));
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = sc[i][j] > 0.5f * kNegInf ? expf(sc[i][j] - mn) : 0.f;
        sp[(rg * 4 + i) * kPLD + cl + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(rg * 4 + i) * kPLD + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sv[j * LD + cl + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(pv[i], vv, o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = out + (((int64_t)b * S + row) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cl + 16 * c;
      if (col < D) orow[col] = o[i][c] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// The Hopper form (bf16, D in {64, 128, 256}, TMA-legal strides)
// ---------------------------------------------------------------------------

namespace h {

constexpr int kBQ = 128;         // query rows per block: two warpgroups of 64
// Two warpgroups and no producer warp: ptxas gives every thread of a kernel
// one register budget, 255 here. A ninth warp (a producer warp) puts three
// warps on one of the SM's four register-file quarters, capping it at 168,
// and the consumers spilled (700 bytes at D 256), with or without
// setmaxnreg, whose larger budget this ptxas did not use when allocating.
constexpr int kThreads = 256;

template <int D>
struct Cfg {
  static constexpr int BK = D == 256 ? 64 : 128;    // keys per tile
  static constexpr int kStages = 2;                 // K and V tiles in flight
  static constexpr int kChunks = D / 64;            // 128-byte column boxes
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = BK * D * 2;     // one K (or V) tile
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kTileBytes;
  static constexpr int kOffBar = kOffV + kStages * kTileBytes;
  // + barriers (q; full and empty of K and of V per stage) + slack to align
  // the tiles to 1024 bytes
  static constexpr int kSmem = kOffBar + 8 * (1 + 4 * kStages) + 1024;
};

// One tile's online-softmax step for this thread's rows ra and rb: masks
// the scores of an EDGE tile (-1e30), updates the running max m and the
// per-thread sum l, and turns the scores into probabilities; returns the
// factors by which O must be rescaled. Accumulator layout: sc[4j + e] is
// row (e < 2 ? ra : rb), key k0 + 8j + 2t + (e & 1).
template <int BK, bool EDGE>
__device__ __forceinline__ void softmax_tile(float* sc, int k0, int t, int ra,
                                             int rb, int S, int window,
                                             float scale_log2, float& m_a,
                                             float& m_b, float& l_a,
                                             float& l_b, float& al_a,
                                             float& al_b) {
  if (EDGE) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? ra : rb;
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const bool live = key < S && key <= row &&
                          (window <= 0 || key > row - window);
        if (!live) sc[4 * j + e] = kNegInf;
      }
  }
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  const float mn_a = fmaxf(m_a, quad_max(mx_a));
  const float mn_b = fmaxf(m_b, quad_max(mx_b));
  al_a = hopper::ex2((m_a - mn_a) * scale_log2);
  al_b = hopper::ex2((m_b - mn_b) * scale_log2);
  const float ms_a = mn_a * scale_log2, ms_b = mn_b * scale_log2;
  m_a = mn_a;
  m_b = mn_b;
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = sc[4 * j + e];
      float p = hopper::ex2(fmaf(x, scale_log2, -(e < 2 ? ms_a : ms_b)));
      // a masked key weighs 0 even in a row with no live key yet
      if (EDGE && !(x > 0.5f * kNegInf)) p = 0.f;
      sc[4 * j + e] = p;
      if (e < 2) rs_a += p;
      else rs_b += p;
    }
  l_a = l_a * al_a + rs_a;          // per thread; summed over the quad at
  l_b = l_b * al_b + rs_b;          // the end
}

// P in bf16 as wgmma's register A operand: the C layout of two n8 blocks
// is the A layout of one k16 step
template <int BK>
__device__ __forceinline__ void to_a_operand(const float* sc,
                                             uint32_t (*pa)[4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const float* c0 = sc + 8 * kk;
    pa[kk][0] = pack_bf16x2(c0[0], c0[1]);
    pa[kk][1] = pack_bf16x2(c0[2], c0[3]);
    pa[kk][2] = pack_bf16x2(c0[4], c0[5]);
    pa[kk][3] = pack_bf16x2(c0[6], c0[7]);
  }
}

// One block: 128 query rows of one (q head, batch row). The K and V tiles
// of the band stream through rings of kStages slots (TMA, 128-byte
// swizzle; K and V have their own full and empty mbarriers, so a K slot is
// free as soon as its scores are computed). Each warpgroup owns 64 rows
// and overlaps its products with its softmax: at tile i it issues S_i =
// q k_i^T and O += P_{i-1} v_{i-1} (wgmma, both asynchronous), waits for
// S_i only, runs the softmax of tile i while the tensor cores still work
// on P_{i-1} v_{i-1}, then waits for that and rescales O.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              __nv_bfloat16* __restrict__ out, int S, int Hq,
                              int group, int window, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, ST = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + C::kOffK, sv = base + C::kOffV;
  const uint32_t bar_q = base + C::kOffBar;
  auto full_k = [&](int i) { return bar_q + 8u * (1 + i % ST); };
  auto full_v = [&](int i) { return bar_q + 8u * (1 + ST + i % ST); };
  auto empty_k = [&](int i) { return bar_q + 8u * (1 + 2 * ST + i % ST); };
  auto empty_v = [&](int i) { return bar_q + 8u * (1 + 3 * ST + i % ST); };
  auto phase = [&](int i) { return (uint32_t)((i / ST) & 1); };

  // the tiles with the most keys first: blockIdx.y 0 is the last q tile
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int kvh = h / group;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = min(S, q0 + kBQ);
  const int t0 = lo / BK;
  const int n_tiles = (hi + BK - 1) / BK - t0;
  const int wg = threadIdx.x / 128;

  // The first thread of warpgroup 1 is the producer: it loads the q tile
  // and the first ST tiles at the start, and refills a slot with tile
  // i + ST as soon as both warpgroups have released tile i. Warpgroup 1
  // runs half a turn behind warpgroup 0 (below), so by then warpgroup 0
  // has released it too and the producer rarely waits.
  const bool producer = threadIdx.x == 128;
  auto load_k = [&](int i) {
    hopper::mbar_expect_tx(full_k(i), C::kTileBytes);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      hopper::tma_load_4d(sk + (i % ST) * C::kTileBytes + c * BK * 128, &tk,
                          full_k(i), c * 64, kvh, (t0 + i) * BK, b);
  };
  auto load_v = [&](int i) {
    hopper::mbar_expect_tx(full_v(i), C::kTileBytes);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      hopper::tma_load_4d(sv + (i % ST) * C::kTileBytes + c * BK * 128, &tv,
                          full_v(i), c * 64, kvh, (t0 + i) * BK, b);
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < 2 * ST; ++s) {
      hopper::mbar_init(bar_q + 8u * (1 + s), 1);           // full K, V
      hopper::mbar_init(bar_q + 8u * (1 + 2 * ST + s), 8);  // empty: one
    }                                          // arrival per consumer warp
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (producer) {
    hopper::mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      hopper::tma_load_4d(sq + c * kBQ * 128, &tq, bar_q, c * 64, h, q0, b);
    for (int i = 0; i < ST && i < n_tiles; ++i) {
      load_k(i);
      load_v(i);
    }
  }

  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int t = lane & 3;
  const int row0 = q0 + wg * 64;              // this warpgroup's first row
  const int ra = row0 + warp * 16 + (lane >> 2), rb = ra + 8;
  const uint32_t qa = sq + wg * 64 * 128;     // its rows in each column box
  auto release_k = [&](int i) {               // K of tile i is used up
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty_k(i));
    if (producer && i + ST < n_tiles) {
      hopper::mbar_wait(empty_k(i), phase(i));
      load_k(i + ST);
    }
  };
  auto release_v = [&](int i) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty_v(i));
    if (producer && i + ST < n_tiles) {
      hopper::mbar_wait(empty_v(i), phase(i));
      load_v(i + ST);
    }
  };
  // Ping-pong: the warpgroups take turns issuing their products (named
  // barriers 1 and 2, 256 threads), one turn a tile, warpgroup 0 first, so
  // that one's softmax runs while the other's products hold the tensor
  // cores.
  auto turn_begin = [&]() {
    asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
  };
  auto turn_end = [&]() {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - wg) : "memory");
  };
  auto scores = [&](float* sc, int i) {       // S_i = q k_i^T, issued
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t in_row = (ks % 4) * 32;
      const uint64_t da = hopper::desc_sw128(
          qa + (ks / 4) * kBQ * 128 + in_row, 16, 1024);
      const uint64_t db = hopper::desc_sw128(
          sk + (i % ST) * C::kTileBytes + (ks / 4) * BK * 128 + in_row, 16,
          1024);
      hopper::wgmma_ss<BK>(sc, da, db, ks > 0);
    }
    hopper::wgmma_commit();
  };
  auto pv = [&](float* o, uint32_t (*pa)[4], int i) {  // O += P_i v_i, issued
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // v [keys][D] is the MN-major B of P v: 8-key groups 1024 bytes
      // apart, 64-column boxes BK * 128 bytes apart
      const uint64_t dv = hopper::desc_sw128(
          sv + (i % ST) * C::kTileBytes + kk * 16 * 128, BK * 128, 1024);
      hopper::wgmma_rs<D>(o, pa[kk], dv);
    }
    hopper::wgmma_commit();
  };
  // tiles wholly masked for these 64 rows (above the diagonal or below the
  // window) are waited for and released only; the rest are [i_lo, i_hi)
  auto skip = [&](int i) {
    const int k0 = (t0 + i) * BK;
    return k0 > row0 + 63 || (window > 0 && k0 + BK - 1 <= row0 - window);
  };
  auto edge = [&](int i) {    // crosses the diagonal, the window or S
    const int k0 = (t0 + i) * BK;
    return k0 + BK - 1 > row0 || (window > 0 && k0 <= row0 + 63 - window) ||
           k0 + BK > S;
  };
  auto pass = [&](int i) {
    hopper::mbar_wait(full_k(i), phase(i));
    hopper::mbar_wait(full_v(i), phase(i));
    turn_begin();
    turn_end();
    release_k(i);
    release_v(i);
  };
  int i_lo = 0, i_hi = n_tiles;
  while (i_lo < n_tiles && skip(i_lo)) ++i_lo;
  while (i_hi > i_lo && skip(i_hi - 1)) --i_hi;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  // the softmax of tile i, with the compares only where it crosses an edge
  auto softmax = [&](float* sc, int i, float& al_a, float& al_b) {
    const int k0 = (t0 + i) * BK;
    if (edge(i))
      softmax_tile<BK, true>(sc, k0, t, ra, rb, S, window, scale_log2, m_a,
                             m_b, l_a, l_b, al_a, al_b);
    else
      softmax_tile<BK, false>(sc, k0, t, ra, rb, S, window, scale_log2, m_a,
                              m_b, l_a, l_b, al_a, al_b);
  };

  if (wg == 1) turn_end();                    // warpgroup 0 goes first
  hopper::mbar_wait(bar_q, 0);
  for (int i = 0; i < i_lo; ++i) pass(i);
  if (i_lo < i_hi) {
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];
    float al_a, al_b;
    hopper::mbar_wait(full_k(i_lo), phase(i_lo));
    turn_begin();
    hopper::wgmma_fence();
    scores(sc, i_lo);
    turn_end();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<BK / 2>(sc);
    release_k(i_lo);
    softmax(sc, i_lo, al_a, al_b);
    to_a_operand<BK>(sc, pa);
    for (int i = i_lo + 1; i < i_hi; ++i) {
      hopper::mbar_wait(full_k(i), phase(i));
      hopper::mbar_wait(full_v(i - 1), phase(i - 1));
      turn_begin();
      hopper::wgmma_fence();
      scores(sc, i);
      pv(o, pa, i - 1);
      turn_end();
      hopper::wgmma_wait<1>();                // S_i is in, P_{i-1} v runs
      hopper::fence_regs<BK / 2>(sc);
      release_k(i);
      softmax(sc, i, al_a, al_b);
      hopper::wgmma_wait<0>();
      hopper::fence_regs<D / 2>(o);
      hopper::fence_regs<BK / 4>(&pa[0][0]);  // pa was read until here
      release_v(i - 1);
      to_a_operand<BK>(sc, pa);
      // O's rows rescaled to the new max; skipped by a warp whose rows'
      // maxima all stayed
      if (__any_sync(0xffffffffu, al_a != 1.f || al_b != 1.f)) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= al_a;
          o[4 * j + 1] *= al_a;
          o[4 * j + 2] *= al_b;
          o[4 * j + 3] *= al_b;
        }
      }
    }
    hopper::mbar_wait(full_v(i_hi - 1), phase(i_hi - 1));
    hopper::wgmma_fence();
    pv(o, pa, i_hi - 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs<D / 2>(o);
    hopper::fence_regs<BK / 4>(&pa[0][0]);
    release_v(i_hi - 1);
  }
  for (int i = i_hi; i < n_tiles; ++i) pass(i);
  if (wg == 0) turn_begin();                  // warpgroup 1's last turn_end

  // Epilogue: normalise, round to bf16 and stage the rows in this
  // warpgroup's q rows (its last q k^T is done), in the q tile's 128-byte
  // swizzle so that the quads' 4-byte writes hit 32 banks; then write them
  // out 16 bytes a thread, whole rows of a warp at a time.
  const float den_a = fmaxf(quad_sum(l_a), 1e-30f);
  const float den_b = fmaxf(quad_sum(l_b), 1e-30f);
  unsigned char* stage = smem_raw + (sq - hopper::smem_u32(smem_raw));
  auto at = [&](int r, int c8) {     // byte of (row r, 8-column group c8)
    return stage + (c8 / 8) * kBQ * 128 + (wg * 64 + r) * 128 +
           (((c8 % 8) ^ (r & 7)) * 16);
  };
  const int la = warp * 16 + (lane >> 2), lb = la + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(at(la, j) + 4 * t) =
        pack_bf16x2(o[4 * j] / den_a, o[4 * j + 1] / den_a);
    *reinterpret_cast<uint32_t*>(at(lb, j) + 4 * t) =
        pack_bf16x2(o[4 * j + 2] / den_b, o[4 * j + 3] / den_b);
  }
  asm volatile("bar.sync %0, 128;\n" :: "r"(3 + wg) : "memory");
  for (int idx = tid; idx < 64 * (D / 8); idx += 128) {
    const int r = idx / (D / 8), c8 = idx % (D / 8), row = row0 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(out + (((int64_t)b * S + row) * Hq + h) * D +
                                8 * c8) =
          *reinterpret_cast<const uint4*>(at(r, c8));
  }
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

// A [B, S, H, D] bf16 tensor read through its strides (elements), as 4-d
// boxes of 64 columns x `rows` rows of one head, 128-byte swizzle; rows
// past S arrive as zeros.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B,
              int S, int H, int D, int64_t sb, int64_t ss, int64_t sh,
              int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Hq, int Hkv, int window, const int64_t* st,
           float scale_log2, cudaStream_t stream) {
  using C = Cfg<D>;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  CUtensorMap mq, mk, mv;
  if (!make_map(enc, &mq, q, B, S, Hq, D, st[0], st[1], st[2], kBQ) ||
      !make_map(enc, &mk, k, B, S, Hkv, D, st[3], st[4], st[5], C::BK) ||
      !make_map(enc, &mv, v, B, S, Hkv, D, st[6], st[7], st[8], C::BK))
    return kErrTensorMap;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_hopper_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + kBQ - 1) / kBQ));
  flash_attention_hopper_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, S, Hq, Hq / Hkv, window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace h

// The kernel's launch: grid (64-query tiles, q heads, batch), the dynamic
// shared memory above 48 KB allowed first.
template <typename Kernel, typename T>
int launch(Kernel kernel, int threads, size_t smem, const void* q,
           const void* k, const void* v, void* out, int B, int S, int Hq,
           int Hkv, int D, int window, const int64_t* st,
           float q_div, cudaStream_t stream, int vec) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)Hq, (unsigned)B);
  if constexpr (std::is_same<T, float>::value) {
    kernel<<<grid, threads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, S, D, Hq, Hq / Hkv,
        window, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
        st[7], st[8], q_div);
  } else {
    kernel<<<grid, threads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, S, D, Hq, Hq / Hkv,
        window, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
        st[7], st[8], q_div, vec);
  }
  return (int)cudaGetLastError();
}

template <int DP>
int dispatch_dp(int dtype, const void* q, const void* k, const void* v,
                void* out, int B, int S, int Hq, int Hkv, int D, int window,
                const int64_t* st, float q_div,
                cudaStream_t stream, int vec) {
  if (dtype == 0)
    return launch<decltype(&flash_attention_f32_kernel<DP>), float>(
        flash_attention_f32_kernel<DP>, kThreads, smem_bytes_f32<DP>(), q, k,
        v, out, B, S, Hq, Hkv, D, window, st, q_div, stream, vec);
  return launch<decltype(&flash_attention_bf16_kernel<DP>), __nv_bfloat16>(
      flash_attention_bf16_kernel<DP>, 128, smem_bytes_bf16<DP>(), q, k, v,
      out, B, S, Hq, Hkv, D, window, st, q_div, stream, vec);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides in elements, in the order
// (q: batch, seq, head), (k: ...), (v: ...). Returns 0, a CUDA error code,
// or one of the negative argument codes above.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int dtype, int B, int S, int Hq, int Hkv,
                        int D, int window, int64_t qsb,
                        int64_t qss,
                        int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                        int64_t vsb, int64_t vss, int64_t vsh, float q_div,
                        void* stream) {
  if (D < 1 || D > 256) return kErrHeadDim;
  if (B < 1 || S < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || B > 65535 ||
      Hq > 65535)
    return kErrShape;
  if (dtype != 0 && dtype != 1) return kErrDtype;
  const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  // 16-byte loads of bf16 rows: D, every stride and every base a multiple
  // of 8 elements
  int vec = D % 8 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
  vec = vec && (uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0 &&
        (uintptr_t)v % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32)
    return dispatch_dp<32>(dtype, q, k, v, out, B, S, Hq, Hkv, D, window,
                           st, q_div, s, vec);
  if (D <= 64)
    return dispatch_dp<64>(dtype, q, k, v, out, B, S, Hq, Hkv, D, window,
                           st, q_div, s, vec);
  if (D <= 128)
    return dispatch_dp<128>(dtype, q, k, v, out, B, S, Hq, Hkv, D, window,
                            st, q_div, s, vec);
  return dispatch_dp<256>(dtype, q, k, v, out, B, S, Hq, Hkv, D, window,
                          st, q_div, s, vec);
}

// The Hopper form: bf16, D in {64, 128, 256}, every stride a multiple of
// 8 elements (16 bytes) and every base 16-byte aligned, as TMA needs.
// scale_log2 = log2(e) / sqrt(D). Returns as flash_attention_fwd.
int flash_attention_hopper_fwd(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int Hq, int Hkv,
                               int D, int window, int64_t qsb, int64_t qss,
                               int64_t qsh, int64_t ksb, int64_t kss,
                               int64_t ksh, int64_t vsb, int64_t vss,
                               int64_t vsh, float scale_log2, void* stream) {
  if (D != 64 && D != 128 && D != 256) return kErrHeadDim;
  if (B < 1 || S < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      (int64_t)B * Hq > 0x7fffffff || (S + h::kBQ - 1) / h::kBQ > 65535)
    return kErrShape;
  const int64_t st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  for (int i = 0; i < 9; ++i)
    if (st[i] % 8 != 0 || st[i] <= 0) return kErrLayout;
  if ((uintptr_t)q % 16 || (uintptr_t)k % 16 || (uintptr_t)v % 16 ||
      (uintptr_t)out % 16)
    return kErrLayout;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return h::launch<64>(q, k, v, out, B, S, Hq, Hkv, window, st, scale_log2,
                         s);
  if (D == 128)
    return h::launch<128>(q, k, v, out, B, S, Hq, Hkv, window, st,
                          scale_log2, s);
  return h::launch<256>(q, k, v, out, B, S, Hq, Hkv, window, st, scale_log2,
                        s);
}

const char* flash_attention_error_string(int code) {
  switch (code) {
    case kErrHeadDim: return "head dim must be in [1, 256] (Hopper form: "
                             "64, 128 or 256)";
    case kErrShape: return "bad shape (B, S, Hq, Hkv; Hq % Hkv == 0)";
    case kErrDtype: return "dtype must be float32 or bfloat16";
    case kErrLayout: return "Hopper form: strides must be positive multiples "
                            "of 8 elements and pointers 16-byte aligned";
    case kErrTensorMap: return "cuTensorMapEncodeTiled refused a tensor map";
    case kErrNoEncoder: return "cuTensorMapEncodeTiled not found in the "
                               "driver";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"

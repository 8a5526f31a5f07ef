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
// Bound on an H100: operations. At the serving path's shape (B=2, S=4096,
// Hq=10, Hkv=1, D=256, W=2048, bf16) the 6,292,480 live (query, key) pairs
// of each (b, h) cost 4*B*Hq*D*pairs = 1.29e11 operations, 0.130 ms at the
// tensor cores' 989 TFLOP/s, against 0.028 ms for the 92 MB of q, k, v and
// the output at 3.35 TB/s.
//
// Both forms: one block per (64-query tile, q head, batch); the key loop
// runs over [max(0, q0 - W + 1), q0 + 63] only, so tiles outside the band
// are never visited (the TPU kernel skipped them with pl.when inside a full
// grid); every visited 64-key tile is masked elementwise, which costs
// little beside its products; the running max and denominator of each row
// live in registers.
//
// bf16 (the serving path): tensor cores through mma.sync.m16n8k16 with f32
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
// Not yet done (the next steps toward the bound): wgmma and TMA, keeping
// the next key tile in flight while this one is computed, and splitting
// D=256's accumulator across two warpgroups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
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

const char* flash_attention_error_string(int code) {
  switch (code) {
    case kErrHeadDim: return "head dim must be in [1, 256]";
    case kErrShape: return "bad shape (B, S, Hq, Hkv; Hq % Hkv == 0)";
    case kErrDtype: return "dtype must be float32 or bfloat16";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"

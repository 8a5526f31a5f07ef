// The MoE layer's experts on the chosen (token, expert) pairs only: the
// one-token decode step of the GShard layer (OLMoE) and of the dropless
// held-expert layer (Nemotron-H).
//
// Replaces no TPU kernel: the JAX package leaves the MoE layer to XLA
// (repro/models/moe.py, dense dispatch and combine einsums over every
// expert). Added because a decode step through those einsums reads every
// expert's weights, where its token needs only the k it chose: 12.9 GB a
// step for OLMoE-1B-7B's 64 experts against 1.61 GB for the 8 chosen.
//
// Computes, for tokens x [T, D], choices ids [T, k] (int64) with combine
// weights w [T, k] (f32), and stacked experts wi, wg [E, D, F], wo [E, F, D]
// (all of x's dtype, f32 or bf16, contiguous):
//   swiglu form:  h[t,j] = round(silu(x[t] wg[e]) * (x[t] wi[e]))
//   relu2 form:   h[t,j] = round(relu(x[t] wi[e])^2)
//   y[t] = round(sum_j w[t,j] * (h[t,j] wo[e])),   e = ids[t,j],
// every product accumulated in f32, h rounded to x's dtype before the down
// product (the plain path's experts round their activation there too), the
// k terms summed in f32 in the order j = 0..k-1 and y rounded once. A pair
// is dead, and its blocks return before they read any weight, where its
// weight is 0 (a choice dropped by capacity, or one of an expert this
// device does not hold) or its id lies outside [0, E).
//
// Bound on an H100: bytes. A live pair reads its expert's matrices once,
// 3 D F elements (swiglu) or 2 D F (relu2); x, h, the partial sums and y
// are kilobytes. OLMoE-1B-7B (D 2,048, F 1,024, bf16, 8 live pairs):
// 100.7 MB a layer call, 30.0 us at 3.35 TB/s. Nemotron-3-Nano (D 2,688,
// F 1,856): 19.96 MB a live pair, 6.0 us.
//
// Design: three launches on the caller's stream, each block a matrix-vector
// tile; no atomics, and every partial sum combined in a fixed order, so
// every run and every CUDA-graph replay gives the same bits.
//   * up: a block per (tile of F, split of D, pair) multiplies the token's
//     rows of its split by the tile of wi (and wg) and writes f32 partial
//     sums [pair, split, matrix, F].
//   * down: a block per (tile of D, split of F, pair) sums the up partials
//     of its F rows in split order, applies the activation, rounds h, and
//     multiplies by its tile of wo, writing f32 partials [pair, split, D].
//   * combine: a block per (32 outputs, token) sums each live pair's down
//     partials in split order, a pair lane each, and the k weighted terms
//     in choice order.
// A tile is 8 threads across (16 bytes each: 64 bf16 or 32 f32 columns) by
// 32 row slots. Each thread walks its slot's rows through a private ring
// of kStages 16-byte cp.async slots a matrix in shared memory, so that
// kStages - 1 loads stay in flight while it multiplies the oldest (no
// barrier: a thread reads only what it copied); the 32 slots' sums are then
// added in slot order. The splits (chosen by the wrapper from the shapes
// and the SM count) give one live pair's blocks a block an SM: liveness is
// read on the card only, and a dead pair's blocks return at once, so the
// grid is sized for a lone live pair (Nemotron's usual case: about 0.75 of
// its top 6 fall on the 16 held experts). OLMoE: the up pass 16 tiles x 8
// splits of 256 rows x 8 pairs, the down pass 32 x 4 x 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                    // threads across a row's tile
constexpr int kSlots = kThreads / kLanes;    // row slots a block: 32
constexpr int kStages = 8;                   // ring depth a thread a matrix
constexpr int kCombineThreads = 256;
constexpr int kCombineD = 32;                // outputs a combine block
constexpr int kCombinePairs = kCombineThreads / kCombineD;   // pair lanes
constexpr int kCombineLoads = 8;             // a pair's partials in flight
constexpr int kRingBytes = kStages * kThreads * 16;   // a matrix's ring
constexpr int kMaxSmem = 227 * 1024;

enum : int { kErrShape = -1, kErrForm = -2 };

template <typename T>
struct Tile {
  static constexpr int kN = 16 / (int)sizeof(T);   // elements a 16-byte load
  static constexpr int kCols = kLanes * kN;        // columns a block tile
  // the slots' sums of a matrix, kept where its ring was
  static_assert(kSlots * kCols * 4 <= kRingBytes, "reduction outgrows ring");
};

__device__ __forceinline__ void unpack(const uint4& v, float (&out)[4]) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}

// eight bf16, element 0 in the low half of the first word
__device__ __forceinline__ void unpack(const uint4& v, float (&out)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(u[i] << 16);
    out[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// pair p's expert, or -1 where the pair is dead (weight 0, id out of range)
__device__ __forceinline__ int64_t live_expert(const int64_t* __restrict__ ids,
                                               const float* __restrict__ w,
                                               int p, int E) {
  const int64_t e = ids[p];
  return (w[p] != 0.f && e >= 0 && e < E) ? e : -1;
}

// acc[m][c] += v[r] * mat[m][r * ld + lane * kN + c] over this thread's
// rows r = slot, slot + 32, ... < n, each mat[m] pointing at the tile's
// first row and column; columns past the matrix (col_ok false) read zeros.
template <typename T, int kMats>
__device__ __forceinline__ void stream_rows(const T* const (&mat)[kMats],
                                            int64_t ld, int n, bool col_ok,
                                            const float* __restrict__ v,
                                            uint4* ring,
                                            float (&acc)[kMats][Tile<T>::kN]) {
  constexpr int kN = Tile<T>::kN;
  const int slot = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int iters = n > slot ? (n - slot + kSlots - 1) / kSlots : 0;
  auto issue = [&](int i) {
    if (i < iters) {
      const int64_t off = (int64_t)(slot + i * kSlots) * ld + lane * kN;
#pragma unroll
      for (int m = 0; m < kMats; ++m) {
        uint4* dst = ring + ((i % kStages) * kMats + m) * kThreads +
                     threadIdx.x;
        hopper::cp_async_16(hopper::smem_u32(dst),
                            col_ok ? mat[m] + off : mat[m], col_ok);
      }
    }
    hopper::cp_async_commit();   // an empty group past the last row
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < iters; ++i) {
    issue(i + kStages - 1);
    hopper::cp_async_wait<kStages - 1>();   // row i has landed
    const float vr = v[slot + i * kSlots];
#pragma unroll
    for (int m = 0; m < kMats; ++m) {
      float f[kN];
      unpack(ring[((i % kStages) * kMats + m) * kThreads + threadIdx.x], f);
#pragma unroll
      for (int c = 0; c < kN; ++c) acc[m][c] = fmaf(vr, f[c], acc[m][c]);
    }
  }
  hopper::cp_async_wait<0>();
}

// The 32 slots' sums of each column, added in slot order, into
// out[m * out_stride + c] for the tile's columns c < cols; red is the
// block's shared memory (the rings, no longer read after the barrier).
template <typename T, int kMats>
__device__ __forceinline__ void reduce_slots(
    const float (&acc)[kMats][Tile<T>::kN], float* red,
    float* __restrict__ out, int64_t out_stride, int cols) {
  constexpr int kN = Tile<T>::kN, kCols = Tile<T>::kCols;
  const int slot = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int c = 0; c < kN; ++c)
      red[(m * kSlots + slot) * kCols + lane * kN + c] = acc[m][c];
  __syncthreads();
  for (int i = threadIdx.x; i < kMats * kCols; i += kThreads) {
    const int m = i / kCols, c = i % kCols;
    if (c >= cols) continue;
    float s = 0.f;
    for (int sl = 0; sl < kSlots; ++sl) s += red[(m * kSlots + sl) * kCols + c];
    out[m * out_stride + c] = s;
  }
}

// up_part[((p * splits + split) * kMats + m) * F + f] = sum over the
// split's rows d of x[t, d] * mat_m[e, d, f]; mat 0 is wi, mat 1 wg.
template <typename T, int kMats>
__global__ void __launch_bounds__(kThreads)
expert_up_kernel(const T* __restrict__ x, const int64_t* __restrict__ ids,
                 const float* __restrict__ w, const T* __restrict__ wi,
                 const T* __restrict__ wg, float* __restrict__ up_part, int k,
                 int E, int D, int F, int rows) {
  constexpr int kN = Tile<T>::kN, kCols = Tile<T>::kCols;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  float* v = reinterpret_cast<float*>(smem + kMats * kRingBytes);
  const int p = blockIdx.z, split = blockIdx.y, c0 = blockIdx.x * kCols;
  const int64_t e = live_expert(ids, w, p, E);
  if (e < 0) return;
  const int r0 = split * rows, n = max(0, min(D - r0, rows));
  const T* xt = x + (int64_t)(p / k) * D + r0;
  for (int i = threadIdx.x; i < n; i += kThreads) v[i] = to_f(xt[i]);
  __syncthreads();
  const int64_t base = e * (int64_t)D * F + (int64_t)r0 * F + c0;
  const T* mat[kMats];
  mat[0] = wi + base;
  if constexpr (kMats == 2) mat[1] = wg + base;
  float acc[kMats][kN] = {};
  const bool col_ok = c0 + (int)(threadIdx.x % kLanes) * kN < F;
  stream_rows<T, kMats>(mat, F, n, col_ok, v, ring, acc);
  reduce_slots<T, kMats>(
      acc, reinterpret_cast<float*>(smem),
      up_part + ((int64_t)p * gridDim.y + split) * kMats * F + c0, F,
      min(kCols, F - c0));
}

// dn_part[(p * splits + split) * D + d] = sum over the split's rows f of
// h[f] * wo[e, f, d], h from the up partials (kMats of them a row).
template <typename T, int kMats>
__global__ void __launch_bounds__(kThreads)
expert_down_kernel(const int64_t* __restrict__ ids,
                   const float* __restrict__ w, const T* __restrict__ wo,
                   const float* __restrict__ up_part,
                   float* __restrict__ dn_part, int E, int D, int F,
                   int up_splits, int rows) {
  constexpr int kN = Tile<T>::kN, kCols = Tile<T>::kCols;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  float* v = reinterpret_cast<float*>(smem + kRingBytes);
  const int p = blockIdx.z, split = blockIdx.y, c0 = blockIdx.x * kCols;
  const int64_t e = live_expert(ids, w, p, E);
  if (e < 0) return;
  const int r0 = split * rows, n = max(0, min(F - r0, rows));
  const float* up = up_part + (int64_t)p * up_splits * kMats * F + r0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float a[kMats] = {};
    for (int s = 0; s < up_splits; ++s)
#pragma unroll
      for (int m = 0; m < kMats; ++m) a[m] += up[(s * kMats + m) * (int64_t)F + i];
    float h;
    if constexpr (kMats == 2) {
      h = a[1] / (1.f + expf(-a[1])) * a[0];     // silu(x wg) * (x wi)
    } else {
      const float r = fmaxf(a[0], 0.f);
      h = r * r;                                  // relu(x wi)^2
    }
    v[i] = to_f(from_f<T>(h));
  }
  __syncthreads();
  const T* mat[1] = {wo + e * (int64_t)F * D + (int64_t)r0 * D + c0};
  float acc[1][kN] = {};
  const bool col_ok = c0 + (int)(threadIdx.x % kLanes) * kN < D;
  stream_rows<T, 1>(mat, D, n, col_ok, v, ring, acc);
  reduce_slots<T, 1>(acc, reinterpret_cast<float*>(smem),
                     dn_part + ((int64_t)p * gridDim.y + split) * D + c0, D,
                     min(kCols, D - c0));
}

// y[t, d] = sum_j w[t, j] * (sum_s dn_part[t k + j, s, d]) over live j.
// A block takes kCombineD outputs of a token with kCombinePairs pair lanes:
// the token's k weights (0 for a dead pair) are read once into shared
// memory, each lane sums one pair's split partials in split order (their
// loads kCombineLoads at a time, in flight together), and lane 0 adds the
// pairs' weighted sums in pair order, kCombinePairs at a time, so that no
// thread walks the k pairs' loads one L2 trip after another.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
expert_combine_kernel(const int64_t* __restrict__ ids,
                      const float* __restrict__ w,
                      const float* __restrict__ dn_part, T* __restrict__ y,
                      int k, int E, int D, int dn_splits) {
  __shared__ float s_w[kCombineThreads];
  __shared__ float s_sum[kCombinePairs][kCombineD];
  const int t = blockIdx.y;
  if (threadIdx.x < k) {
    const int p = t * k + threadIdx.x;
    s_w[threadIdx.x] = live_expert(ids, w, p, E) < 0 ? 0.f : w[p];
  }
  __syncthreads();
  const int dl = threadIdx.x % kCombineD, lane = threadIdx.x / kCombineD;
  const int d = blockIdx.x * kCombineD + dl;
  float acc = 0.f;
  for (int j0 = 0; j0 < k; j0 += kCombinePairs) {
    const int j = j0 + lane;
    float s = 0.f;
    if (j < k && d < D && s_w[j] != 0.f) {
      const float* pj = dn_part + ((int64_t)(t * k + j) * dn_splits) * D + d;
      for (int i0 = 0; i0 < dn_splits; i0 += kCombineLoads) {
        float v[kCombineLoads];
#pragma unroll
        for (int i = 0; i < kCombineLoads; ++i)
          v[i] = i0 + i < dn_splits ? pj[(int64_t)(i0 + i) * D] : 0.f;
#pragma unroll
        for (int i = 0; i < kCombineLoads; ++i)
          if (i0 + i < dn_splits) s += v[i];
      }
    }
    s_sum[lane][dl] = s;
    __syncthreads();
    if (lane == 0)
      for (int q = 0; q < kCombinePairs && j0 + q < k; ++q)
        if (s_w[j0 + q] != 0.f) acc = fmaf(s_w[j0 + q], s_sum[q][dl], acc);
    __syncthreads();
  }
  if (lane == 0 && d < D) y[(int64_t)t * D + d] = from_f<T>(acc);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, int kMats>
int launch(const void* x, const int64_t* ids, const float* w, const void* wi,
           const void* wg, const void* wo, void* y, float* up_part,
           float* dn_part, int T_, int k, int E, int D, int F, int up_splits,
           int dn_splits, cudaStream_t stream) {
  constexpr int kCols = Tile<T>::kCols;
  const int P = T_ * k;
  const int up_rows = cdiv(D, up_splits), dn_rows = cdiv(F, dn_splits);
  const int up_smem = kMats * kRingBytes + 4 * up_rows;
  const int dn_smem = kRingBytes + 4 * dn_rows;
  if (up_smem > kMaxSmem || dn_smem > kMaxSmem) return kErrShape;
  cudaError_t err = cudaFuncSetAttribute(
      expert_up_kernel<T, kMats>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      up_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(expert_down_kernel<T, kMats>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dn_smem);
  if (err != cudaSuccess) return (int)err;
  expert_up_kernel<T, kMats>
      <<<dim3((unsigned)cdiv(F, kCols), (unsigned)up_splits, (unsigned)P),
         kThreads, up_smem, stream>>>(
          static_cast<const T*>(x), ids, w, static_cast<const T*>(wi),
          static_cast<const T*>(wg), up_part, k, E, D, F, up_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  expert_down_kernel<T, kMats>
      <<<dim3((unsigned)cdiv(D, kCols), (unsigned)dn_splits, (unsigned)P),
         kThreads, dn_smem, stream>>>(ids, w, static_cast<const T*>(wo),
                                      up_part, dn_part, E, D, F, up_splits,
                                      dn_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  expert_combine_kernel<T>
      <<<dim3((unsigned)cdiv(D, kCombineD), (unsigned)T_),
         kCombineThreads, 0, stream>>>(ids, w, dn_part, static_cast<T*>(y),
                                       k, E, D, dn_splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Three launches on `stream`. dtype 0 float32, 1 bfloat16 (x, the weights
// and y); form 0 swiglu (wg given), 1 relu2 (wg unused). up_part holds T k
// up_splits (2 or 1) F floats, dn_part T k dn_splits D floats. D and F
// must be multiples of 16 bytes' elements and every pointer 16-byte
// aligned (the wrapper checks both). Returns 0, a CUDA error code,
// kErrShape or kErrForm.
int expert_gather_fwd(const void* x, const void* ids, const void* w,
                      const void* wi, const void* wg, const void* wo, void* y,
                      void* up_part, void* dn_part, int T, int k, int E,
                      int D, int F, int up_splits, int dn_splits, int dtype,
                      int form, void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if (T < 1 || k < 1 || k > kCombineThreads || (int64_t)T * k > 65535 ||
      T > 65535 || E < 1 ||
      D < 1 || F < 1 || D % vec || F % vec || up_splits < 1 ||
      dn_splits < 1 || up_splits > 65535 || dn_splits > 65535)
    return kErrShape;
  if ((dtype != 0 && dtype != 1) || (form != 0 && form != 1) ||
      (form == 0 && wg == nullptr))
    return kErrForm;
  auto s = (cudaStream_t)stream;
  auto i64 = static_cast<const int64_t*>(ids);
  auto f32 = static_cast<const float*>(w);
  auto up = static_cast<float*>(up_part);
  auto dn = static_cast<float*>(dn_part);
  if (dtype == 1)
    return form == 0
               ? launch<__nv_bfloat16, 2>(x, i64, f32, wi, wg, wo, y, up, dn,
                                          T, k, E, D, F, up_splits, dn_splits,
                                          s)
               : launch<__nv_bfloat16, 1>(x, i64, f32, wi, wg, wo, y, up, dn,
                                          T, k, E, D, F, up_splits, dn_splits,
                                          s);
  return form == 0 ? launch<float, 2>(x, i64, f32, wi, wg, wo, y, up, dn, T,
                                      k, E, D, F, up_splits, dn_splits, s)
                   : launch<float, 1>(x, i64, f32, wi, wg, wo, y, up, dn, T,
                                      k, E, D, F, up_splits, dn_splits, s);
}

const char* expert_gather_error_string(int code) {
  if (code == kErrShape)
    return "bad shape (T, k, E, D, F >= 1; k <= 256; T k <= 65535; D and F "
           "multiples of 8 bf16 or 4 f32; splits in [1, 65535]; a split's "
           "rows must fit shared memory)";
  if (code == kErrForm)
    return "bad dtype or form (dtype 0 f32 or 1 bf16; form 0 swiglu with "
           "wg, 1 relu2)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// GQA flash-decode: one query token per sequence against a KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel
// (flash_decode). It computes what repro/kernels/ref.py::decode_attention_ref
// computes: the `group = Hq / Hkv` q heads of each KV head attend over the
// keys [0, kv_len) of the cache, q divided by sqrt(D), softmax in f32, the
// output in q's dtype. q is [B,1,Hq,D]; the caches k, v are read in the
// model's layout [B,Skv,Hkv,D] through their strides (the last dimension
// contiguous), so the caller copies nothing (the JAX wrapper's moveaxis
// would copy each layer's whole cache every step). kv_len is a launch
// argument: one build serves every fill level, and any Skv and kv_len in
// [1, Skv] is taken (the TPU kernel visits keys only up to a multiple of
// its block and at Skv = 4,112 misses the last 16).
//
// Bound on an H100: bytes. At the serving path's shape (B=2, Hq=28, Hkv=4,
// D=128, kv_len=4,112, bf16) a call must read K and V up to kv_len, 16.8 MB,
// 5.0 us at 3.35 TB/s; its 1.2e8 operations take 1.8 us even at the CUDA
// cores' f32 rate.
//
// Design: split-KV. The TPU grid (B, Hkv, nk) walks the KV blocks of one
// (b, kv head) in order; here that would be 8 blocks for 132 SMs. So the
// keys are cut into splits of `split_len` keys (128 from the wrapper: 33
// splits x 8 = 264 blocks at the serving shape), and one block per (split,
// kv head, group chunk of up to 8 q heads, batch row) computes the partial
// softmax state (max, sum, unnormalised output) of its keys; a second small
// kernel merges the splits of each q head. Only splits that start below
// kv_len are launched, so a split never lies wholly past kv_len; inside the
// last split the keys at or past kv_len are masked to -1e30 before the max
// and their V rows are staged as zeros, so exp(-1e30 - max) = 0 multiplies
// a finite value. In the split kernel (128 threads) a tile of 32 keys of K
// and V is loaded into registers (16-byte loads where the strides and D
// allow) while the previous tile is computed, then staged in shared memory
// as f32 (K rows padded by one float, so the 32 lanes reading 32 rows hit
// 32 banks); each lane scores one key for two q heads (warp w: heads w and
// w + 4, which covers Qwen2's group of 7 with one head of padding); the
// warps update the running max and sum of their heads with shuffles, and
// every thread rescales and accumulates the output columns it owns. CUDA
// cores only: the whole call is 1.2e8 operations. Not done yet: merging in
// the last block of each head (one launch instead of two).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;    // four warps
constexpr int kKT = 32;          // keys per tile: one per lane
constexpr int kG = 8;            // q heads per block: two per warp
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

enum : int {
  kErrHeadDim = -1,
  kErrShape = -2,
  kErrDtype = -3,
  kErrKvLen = -4,
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <class V> __device__ __forceinline__ V zero_of();
template <> __device__ __forceinline__ uint4 zero_of<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}
template <> __device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// One thread's share of a 32-key tile of K and V, held in registers: loaded
// while the previous tile is computed, then stored to shared memory as f32.
// VEC: 16-byte loads (D and every stride a multiple of 16 bytes' worth of
// elements); else one element a load.
template <typename T, int DP, bool VEC>
struct TileLoads {
  static constexpr int kV = VEC ? 16 / (int)sizeof(T) : 1;  // elements
  static constexpr int kRowLoads = DP / kV;                  // per key row
  static constexpr int kPer = kKT * kRowLoads / kThreads;    // per thread
  static_assert(kPer >= 1 && kKT * kRowLoads % kThreads == 0, "tiling");
  using Vec = typename std::conditional<VEC, uint4, T>::type;
  Vec k[kPer], v[kPer];

  __device__ __forceinline__ void load(const T* kb, const T* vb,
                                       int64_t kss, int64_t vss, int t0,
                                       int k_end, int D, int tid) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads;
      const int j = idx / kRowLoads, d = (idx - j * kRowLoads) * kV;
      const int key = t0 + j;
      if (key < k_end && d < D) {
        k[i] = *reinterpret_cast<const Vec*>(kb + key * kss + d);
        v[i] = *reinterpret_cast<const Vec*>(vb + key * vss + d);
      } else {
        k[i] = zero_of<Vec>();
        v[i] = zero_of<Vec>();
      }
    }
  }

  __device__ __forceinline__ void store(float* ks, float* vs,
                                        int tid) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads;
      const int j = idx / kRowLoads, d = (idx - j * kRowLoads) * kV;
      const T* kp = reinterpret_cast<const T*>(&k[i]);
      const T* vp = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        ks[j * (DP + 1) + d + e] = to_f(kp[e]);
        vs[j * DP + d + e] = to_f(vp[e]);
      }
    }
  }
};

template <int DP>
constexpr int split_smem_bytes() {
  return (int)sizeof(float) *
         (kG * DP + kKT * (DP + 1) + kKT * DP + kG * kKT + kG);
}

// One block: (split, kv head x group chunk, batch row). Writes the split's
// running max, sum and unnormalised output of each of its q heads.
template <typename T, int DP, bool VEC>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, float* __restrict__ m_part,
    float* __restrict__ l_part, float* __restrict__ acc_part, int Hq,
    int group, int D, int kv_len, int split_len, int n_splits,
    int n_gchunks, int64_t qsb, int64_t qsh, int64_t ksb, int64_t kss,
    int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, float q_div) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [kG][DP], q / sqrt(D)
  float* ks = qs + kG * DP;                  // [kKT][DP + 1]
  float* vs = ks + kKT * (DP + 1);           // [kKT][DP]
  float* ps = vs + kKT * DP;                 // [kG][kKT]
  float* alpha = ps + kG * kKT;              // [kG]

  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_gchunks;
  const int g0 = (blockIdx.y % n_gchunks) * kG;
  const int b = blockIdx.z;
  const int ng = min(kG, group - g0);        // live q heads of this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = kvh * group + g0;           // first q head of this block

  for (int i = tid; i < kG * DP; i += kThreads) {
    const int g = i / DP, d = i - g * DP;
    float x = 0.0f;
    if (g < ng && d < D)
      x = __fdiv_rn(to_f(q[b * qsb + (int64_t)(h0 + g) * qsh + d]), q_div);
    qs[i] = x;
  }

  const int k_begin = split * split_len;
  const int k_end = min(k_begin + split_len, kv_len);
  constexpr int kC = (DP + kThreads - 1) / kThreads;   // columns a thread
  float acc[kG][kC];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[g][c] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  TileLoads<T, DP, VEC> tile;
  tile.load(kb, vb, kss, vss, k_begin, k_end, D, tid);
  for (int t0 = k_begin; t0 < k_end; t0 += kKT) {
    __syncthreads();                         // the last tile is used up
    tile.store(ks, vs, tid);
    __syncthreads();
    if (t0 + kKT < k_end)                    // the next tile, in flight
      tile.load(kb, vb, kss, vss, t0 + kKT, k_end, D, tid);

    // scores of key t0 + lane for heads warp and warp + 4
    const float* qa = qs + warp * DP;
    const float* qb = qs + (warp + 4) * DP;
    const float* kr = ks + lane * (DP + 1);
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float kk = kr[d];
      s0 += qa[d] * kk;
      s1 += qb[d] * kk;
    }
    const bool live = t0 + lane < k_end;
    s0 = live ? s0 : kNegInf;
    s1 = live ? s1 : kNegInf;
    const float mn0 = fmaxf(m0, warp_max(s0));
    const float mn1 = fmaxf(m1, warp_max(s1));
    const float p0 = expf(s0 - mn0), p1 = expf(s1 - mn1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    l0 = l0 * a0 + warp_sum(p0);
    l1 = l1 * a1 + warp_sum(p1);
    m0 = mn0;
    m1 = mn1;
    ps[warp * kKT + lane] = p0;
    ps[(warp + 4) * kKT + lane] = p1;
    if (lane == 0) {
      alpha[warp] = a0;
      alpha[warp + 4] = a1;
    }
    __syncthreads();

    // rescale and accumulate P V for the columns this thread owns
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = tid + c * kThreads;
      if (d >= DP) break;
      float a[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) a[g] = acc[g][c] * alpha[g];
#pragma unroll 4
      for (int j = 0; j < kKT; ++j) {
        const float vv = vs[j * DP + d];
#pragma unroll
        for (int g = 0; g < kG; ++g) a[g] += ps[g * kKT + j] * vv;
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) acc[g][c] = a[g];
    }
  }

  const int64_t row0 = (int64_t)b * Hq + h0;  // (b, first q head) row
  if (lane == 0) {
    if (warp < ng) {
      m_part[(row0 + warp) * n_splits + split] = m0;
      l_part[(row0 + warp) * n_splits + split] = l0;
    }
    if (warp + 4 < ng) {
      m_part[(row0 + warp + 4) * n_splits + split] = m1;
      l_part[(row0 + warp + 4) * n_splits + split] = l1;
    }
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int d = tid + c * kThreads;
    if (d >= D) break;
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (g < ng)
        acc_part[((row0 + g) * n_splits + split) * D + d] = acc[g][c];
  }
}

// One block per (q head, batch row): out = sum_s e^(m_s - m) acc_s /
// max(sum_s e^(m_s - m) l_s, 1e-30), m the largest m_s.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_merge_kernel(const float* __restrict__ m_part,
                              const float* __restrict__ l_part,
                              const float* __restrict__ acc_part,
                              T* __restrict__ out, int Hq, int D,
                              int n_splits) {
  const int64_t row = (int64_t)blockIdx.y * Hq + blockIdx.x;
  const float* mr = m_part + row * n_splits;
  const float* lr = l_part + row * n_splits;
  float m = kNegInf;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, mr[s]);
  float l = 0.0f;
  for (int s = 0; s < n_splits; ++s) l += lr[s] * expf(mr[s] - m);
  const float denom = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.0f;
    for (int s = 0; s < n_splits; ++s)
      a += acc_part[(row * n_splits + s) * D + d] * expf(mr[s] - m);
    store(out + row * D + d, a / denom);
  }
}

template <typename T, int DP, bool VEC>
int launch(const void* q, const void* k, const void* v, void* out,
           float* m_part, float* l_part, float* acc_part, int B, int Hq,
           int Hkv, int D, int kv_len, int split_len, int n_splits,
           const int64_t* st, float q_div, cudaStream_t stream) {
  constexpr int smem = split_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      decode_attention_split_kernel<T, DP, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int group = Hq / Hkv;
  const int n_gchunks = (group + kG - 1) / kG;
  const dim3 grid(n_splits, Hkv * n_gchunks, B);
  decode_attention_split_kernel<T, DP, VEC>
      <<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, m_part, l_part, acc_part, Hq,
      group, D, kv_len, split_len, n_splits, n_gchunks, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], q_div);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_attention_merge_kernel<T><<<dim3(Hq, B), kThreads, 0, stream>>>(
      m_part, l_part, acc_part, (T*)out, Hq, D, n_splits);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int dispatch_vec(bool vec, const void* q, const void* k, const void* v,
                 void* out, float* m_part, float* l_part, float* acc_part,
                 int B, int Hq, int Hkv, int D, int kv_len, int split_len,
                 int n_splits, const int64_t* st, float q_div,
                 cudaStream_t s) {
  if (vec)
    return launch<T, DP, true>(q, k, v, out, m_part, l_part, acc_part, B, Hq,
                               Hkv, D, kv_len, split_len, n_splits, st, q_div,
                               s);
  return launch<T, DP, false>(q, k, v, out, m_part, l_part, acc_part, B, Hq,
                              Hkv, D, kv_len, split_len, n_splits, st, q_div,
                              s);
}

template <int DP>
int dispatch_dtype(int dtype, const void* q, const void* k, const void* v,
                   void* out, float* m_part, float* l_part, float* acc_part,
                   int B, int Hq, int Hkv, int D, int kv_len, int split_len,
                   int n_splits, const int64_t* st, float q_div,
                   cudaStream_t s) {
  // 16-byte loads of K and V: D, the cache strides and the bases a
  // multiple of 16 bytes' worth of elements
  const int kV = dtype == 0 ? 4 : 8;
  bool vec = D % kV == 0 && (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  for (int i = 2; i < 8; ++i) vec = vec && st[i] % kV == 0;
  if (dtype == 0)
    return dispatch_vec<float, DP>(vec, q, k, v, out, m_part, l_part,
                                   acc_part, B, Hq, Hkv, D, kv_len,
                                   split_len, n_splits, st, q_div, s);
  return dispatch_vec<__nv_bfloat16, DP>(vec, q, k, v, out, m_part, l_part,
                                         acc_part, B, Hq, Hkv, D, kv_len,
                                         split_len, n_splits, st, q_div, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides in elements: q (batch, head),
// k (batch, seq, head), v (batch, seq, head). m_part, l_part [B, Hq,
// n_splits] and acc_part [B, Hq, n_splits, D] are f32 scratch; out is a
// contiguous [B, 1, Hq, D]. n_splits must be ceil(kv_len / split_len), and
// split_len a multiple of 32. Returns 0, a CUDA error code, or one of the
// negative argument codes above.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         void* out, void* m_part, void* l_part,
                         void* acc_part, int dtype, int B, int Hq, int Hkv,
                         int D, int Skv, int kv_len, int split_len,
                         int n_splits, int64_t qsb, int64_t qsh, int64_t ksb,
                         int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                         int64_t vsh, float q_div, void* stream) {
  if (D < 1 || D > 256) return kErrHeadDim;
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || B > 65535 ||
      Skv < 1 || split_len < kKT || split_len % kKT != 0)
    return kErrShape;
  if (kv_len < 1 || kv_len > Skv) return kErrKvLen;
  if (n_splits != (kv_len + split_len - 1) / split_len) return kErrShape;
  if ((int64_t)Hkv * ((Hq / Hkv + kG - 1) / kG) > 65535) return kErrShape;
  if (dtype != 0 && dtype != 1) return kErrDtype;
  const int64_t st[8] = {qsb, qsh, ksb, kss, ksh, vsb, vss, vsh};
  float* mp = (float*)m_part;
  float* lp = (float*)l_part;
  float* ap = (float*)acc_part;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32)
    return dispatch_dtype<32>(dtype, q, k, v, out, mp, lp, ap, B, Hq, Hkv, D,
                              kv_len, split_len, n_splits, st, q_div, s);
  if (D <= 64)
    return dispatch_dtype<64>(dtype, q, k, v, out, mp, lp, ap, B, Hq, Hkv, D,
                              kv_len, split_len, n_splits, st, q_div, s);
  if (D <= 128)
    return dispatch_dtype<128>(dtype, q, k, v, out, mp, lp, ap, B, Hq, Hkv,
                               D, kv_len, split_len, n_splits, st, q_div, s);
  return dispatch_dtype<256>(dtype, q, k, v, out, mp, lp, ap, B, Hq, Hkv, D,
                             kv_len, split_len, n_splits, st, q_div, s);
}

const char* decode_attention_error_string(int code) {
  switch (code) {
    case kErrHeadDim: return "head dim must be in [1, 256]";
    case kErrShape: return "unsupported shape";
    case kErrDtype: return "dtype must be float32 or bfloat16";
    case kErrKvLen: return "kv_len must be in [1, Skv]";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"

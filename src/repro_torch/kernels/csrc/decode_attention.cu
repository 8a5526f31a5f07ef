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
// its block and at Skv = 4,112 misses the last 16). kv_len is either a
// launch argument or, for a CUDA graph that replays one launch at every fill
// level (the serve engine's captured decode step), an int64 in device
// memory that each block reads (clamped to [0, Skv]); the grid then covers
// the whole cache, ceil(Skv / split_len) splits, the size of the scratch.
//
// Bound on an H100: bytes. At the serving path's shape (B=2, Hq=28, Hkv=4,
// D=128, kv_len=4,112, bf16) a call must read K and V up to kv_len, 16.8 MB,
// 5.0 us at 3.35 TB/s; its 1.2e8 operations take 0.12 us on the tensor
// cores.
//
// Split-KV in one launch. The TPU grid (B, Hkv, nk) walks the KV blocks of
// one (b, kv head) in order; here that would be 8 blocks for 132 SMs. So
// the keys are cut into splits of `split_len` keys (384 from the wrapper),
// and one block per (split, kv head x group chunk, batch row) computes the
// partial softmax state (max, sum, unnormalised output) of its keys and
// writes it to f32 scratch. The last block of each (batch row, kv head,
// group chunk) to finish, found by a __threadfence and an atomicAdd on an
// int32 counter, merges the splits and writes the output; it resets the
// counter to 0, so the next call and every CUDA-graph replay find it
// zeroed. With kv_len a launch argument only the splits that start below it
// are launched; with kv_len in device memory a block whose split starts at
// or past it writes no partial and only counts itself in, and the merge
// reads the ceil(kv_len / split_len) live splits, so every launched block
// arrives at the counter once and the counter is reset on every replay.
// Keys at or past kv_len are masked (their rows staged as zeros).
//
// Bytes in flight: at the serving shape 11 splits x 8 (b, kv head) = 88
// blocks, one an SM. Each block issues all of its split at once: 8 warps x
// 3 slots x 16 keys = 384 keys x 128 x 2 bytes x (K, V) = 192 KB, so the
// whole 16.8 MB is requested before any product waits; covering ~1 us of
// memory latency at 3.35 TB/s needs ~3.4 MB. Fewer, larger splits than
// two blocks an SM (33 splits of 128 keys, 264 blocks) leave less for the
// merge: its partials, and the one block that reads them all, are what
// this kernel spends beyond its loads (chip_smoke.py's times_decode times
// the split lengths).
//
// Tensor-core form (bf16, D 64, 128 or 256, 16-byte strides and pointers:
// the serving path). 8 warps; warp w takes keys [16w, 16w + 16) of each
// 128-key step of the split, so no block barrier runs inside the key loop.
// Each warp stages its K and V rows as bf16 in its own ring of up to three
// slots (cp.async, 16 bytes a thread, zero-fill past kv_len; rows padded by
// 8 elements so ldmatrix hits 32 banks); at the serving shape the ring is
// the warp's whole share of the split. Products by mma.sync.m16n8k16 with
// the group's q heads on the n8 axis (Qwen2's 7 heads fill 7 of 8, where
// 16-row M tiles would leave 9 of 16 empty): scores S^T = K q^T (M = keys,
// A by ldmatrix from the K rows, q's fragments held in registers), output
// O^T = V^T P^T (M = D, A by ldmatrix.trans from the V rows, P^T's B
// fragments transposed in registers by movmatrix). Each weight goes in as
// two bf16 parts (high and low, two products), so P v keeps about 16 bits
// of it and a bf16 output stays within one rounding step of the f32
// version; the scores are exact (bf16 q and k, f32 sums). Groups above 8
// take a second n8 tile (up to 16 heads a block; D 256 keeps one), larger
// groups more blocks. 1/sqrt(D) and log2(e) are one scale on the f32
// scores (exp2).
// The warps' states merge in shared memory into the block's partial. At
// most 128 registers a thread (__launch_bounds__(256, 2)); the
// instantiations with 256 output columns (D 256, or D 128 with two head
// tiles; not on the serving path) may take 255 (one block an SM). The
// merge of the splits is one pass of 256 threads, each over its outputs'
// splits with twelve splits of loads in flight.
//
// CUDA-core form (f32, and bf16 with other D or strides): one 32-key tile
// at a time staged in shared memory as f32 (K rows padded by one float);
// each lane scores one key for two q heads (warp w: heads w and w + 4, up
// to 8 heads a block), the warps update the running max and sum of their
// heads with shuffles, and every thread rescales and accumulates the
// output columns it owns; IEEE f32 with q divided by sqrt(D) as the
// reference does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;    // four warps
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

enum : int {
  kErrHeadDim = -1,
  kErrShape = -2,
  kErrDtype = -3,
  kErrKvLen = -4,
  kErrLayout = -5,
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

// kv_len of this launch: `kv_cap`, or the int64 at `kv_len_dev` clamped to
// [0, kv_cap] (kv_cap is Skv then: no key past the cache is read, whatever
// the device holds).
__device__ __forceinline__ int live_len(int kv_cap,
                                        const int64_t* kv_len_dev) {
  if (kv_len_dev == nullptr) return kv_cap;
  const int64_t n = *kv_len_dev;
  return (int)(n < 0 ? 0 : n > kv_cap ? kv_cap : n);
}

// ---------------------------------------------------------------------------
// The merge of the splits, by the last block of each (b, kv head, chunk)
// ---------------------------------------------------------------------------

// True in the last block of `counter`'s n_splits to get here, which also
// resets the counter to 0. The block's partial writes are ordered before
// the count by the barrier and one thread's fence (cumulative over the
// block), and the last block's reads after it by that thread's fence and
// the barrier.
__device__ bool last_block(int* counter, int n_splits) {
  __shared__ int s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(counter, 1) == n_splits - 1;
    if (s_last) {
      *counter = 0;
      __threadfence();
    }
  }
  __syncthreads();
  return s_last;
}

// out[row0 + h] = sum_s e(m_s - M) acc_s / max(sum_s e(m_s - M) l_s, 1e-30)
// over the first n_live splits (row stride n_splits) for the nh heads from
// row0 (rows of [B * Hq]), M the largest m_s; e is
// 2^x (LOG2: m in log2 units) or e^x. The partials were written by other
// blocks: read from L2 (__ldcg). One pass: each of the NTHREADS threads
// owns (head, V-column) outputs and merges the splits into a running max,
// sum and output, loading twelve splits at a time before merging them (the
// loads are independent; the merge is a chain). V = 4 (float4 loads) needs
// D % 4 == 0.
template <int V>
struct Running {
  float m = kNegInf, l = 0.0f, a[V] = {};

  template <bool LOG2>
  __device__ __forceinline__ void add(float ms, float ls, const float* x) {
    auto ex = [](float y) { return LOG2 ? exp2f(y) : expf(y); };
    const float mn = fmaxf(m, ms);
    const float keep = ex(m - mn), w = ex(ms - mn);
    l = l * keep + ls * w;
#pragma unroll
    for (int e = 0; e < V; ++e) a[e] = a[e] * keep + x[e] * w;
    m = mn;
  }
};

template <int V>
__device__ __forceinline__ void load_split(const float* mr, const float* lr,
                                           const float* ar, int s, int D,
                                           float& ms, float& ls, float* x) {
  ms = __ldcg(mr + s);
  ls = __ldcg(lr + s);
  if constexpr (V == 4) {
    const float4 x4 =
        __ldcg(reinterpret_cast<const float4*>(ar + (int64_t)s * D));
    x[0] = x4.x;
    x[1] = x4.y;
    x[2] = x4.z;
    x[3] = x4.w;
  } else {
    x[0] = __ldcg(ar + (int64_t)s * D);
  }
}

template <typename T, bool LOG2, int V, int NTHREADS>
__device__ void merge_splits(const float* m_part, const float* l_part,
                             const float* acc_part, T* out, int64_t row0,
                             int nh, int D, int n_splits, int n_live) {
  constexpr int kBatch = 12;        // splits of loads in flight a thread
  const int per_row = D / V;
  for (int p = threadIdx.x; p < nh * per_row; p += NTHREADS) {
    const int h = p / per_row, c = (p - h * per_row) * V;
    const int64_t row = row0 + h;
    const float* mr = m_part + row * n_splits;
    const float* lr = l_part + row * n_splits;
    const float* ar = acc_part + row * n_splits * D + c;
    Running<V> run;
    for (int s0 = 0; s0 < n_live; s0 += kBatch) {
      float ms[kBatch], ls[kBatch], x[kBatch][V];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (s0 + j < n_live) {
          load_split<V>(mr, lr, ar, s0 + j, D, ms[j], ls[j], x[j]);
        } else {
          ms[j] = kNegInf;
          ls[j] = 0.0f;
#pragma unroll
          for (int e = 0; e < V; ++e) x[j][e] = 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        run.template add<LOG2>(ms[j], ls[j], x[j]);
    }
    const float den = fmaxf(run.l, 1e-30f);
#pragma unroll
    for (int e = 0; e < V; ++e) store(out + row * D + c + e, run.a[e] / den);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core form
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kKeysPerWarp = 16;                    // one m16 tile
constexpr int kTileKeys = kMmaWarps * kKeysPerWarp;  // keys per block step

template <int DP, int RING>
constexpr int mma_smem_bytes() {
  // 8 warps x RING slots x (K, V) x 16 rows x (DP + 8) bf16
  return kMmaWarps * RING * 2 * kKeysPerWarp * (DP + 8) * 2;
}

// One block: (split, kv head x group chunk, batch row), up to 8 * NT q
// heads. Writes the block's partial (m in log2 units) and, in the last
// block, the merged output.
template <int DP, int NT, int RING>
__global__ void __launch_bounds__(kMmaThreads, DP * NT > 128 ? 1 : 2)
decode_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ m_part, float* __restrict__ l_part,
    float* __restrict__ acc_part, int* __restrict__ counters, int Hq,
    int group, int kv_cap, const int64_t* __restrict__ kv_len_dev,
    int split_len, int n_splits, int n_gchunks, int64_t qsb, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
    int64_t vsh, float scale_log2) {
  constexpr int LDS = DP + 8;                    // padded row, elements
  constexpr int kRows = kKeysPerWarp * LDS;      // one warp's K (or V) slot
  constexpr int kChunksPerLane = kKeysPerWarp * DP / 8 / 32;
  constexpr int NH = 8 * NT;                     // head slots of a block
  constexpr int KS = DP / 16;                    // k16 steps over D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_gchunks;
  const int g0 = (blockIdx.y % n_gchunks) * NH;
  const int b = blockIdx.z;
  const int ng = min(NH, group - g0);            // live q heads
  const int h0 = kvh * group + g0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv_len = live_len(kv_cap, kv_len_dev);
  const int n_live = (kv_len + split_len - 1) / split_len;
  const int64_t row0 = (int64_t)b * Hq + h0;
  int* counter = counters + ((int64_t)b * gridDim.y + blockIdx.y);
  if (split >= n_live) {             // no live key: no partial, count in
    if (last_block(counter, n_splits))
      merge_splits<__nv_bfloat16, true, 4, kMmaThreads>(
          m_part, l_part, acc_part, out, row0, ng, DP, n_splits, n_live);
    return;
  }

  // q^T's B fragments (k = d, n = head), held for the whole loop
  uint32_t qf[NT][KS][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const bool live = n * 8 + g < ng;
    const __nv_bfloat16* qr = q + b * qsb + (int64_t)(h0 + n * 8 + g) * qsh;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 16 + 2 * t;
      qf[n][ks][0] = live ? *reinterpret_cast<const uint32_t*>(qr + c) : 0u;
      qf[n][ks][1] =
          live ? *reinterpret_cast<const uint32_t*>(qr + c + 8) : 0u;
    }
  }

  const int k_begin = split * split_len;
  const int k_end = min(k_begin + split_len, kv_len);
  const int first = k_begin + kKeysPerWarp * warp;   // this warp's first key
  const int n_tiles =
      first < k_end ? (k_end - first + kTileKeys - 1) / kTileKeys : 0;
  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;
  // this warp's ring: RING slots of 16 rows of K and of V
  __nv_bfloat16* slots = ring + warp * RING * 2 * kRows;

  // this warp's 16 rows of K and V of tile j into slot j % RING, 16 bytes
  // a lane a copy; one commit group a tile (empty past the last tile)
  auto issue = [&](int j) {
    __nv_bfloat16* ks_ = slots + (j % RING) * 2 * kRows;
    __nv_bfloat16* vs_ = ks_ + kRows;
    const int key0 = first + j * kTileKeys;
#pragma unroll
    for (int i = 0; i < kChunksPerLane; ++i) {
      const int c = lane + 32 * i;
      const int r = c / (DP / 8), col = (c % (DP / 8)) * 8;
      const int key = key0 + r;
      const bool ok = key < k_end;
      const int64_t kk = ok ? key : 0;
      hopper::cp_async_16(hopper::smem_u32(ks_ + r * LDS + col),
                          kb + kk * kss + col, ok);
      hopper::cp_async_16(hopper::smem_u32(vs_ + r * LDS + col),
                          vb + kk * vss + col, ok);
    }
  };
#pragma unroll
  for (int j = 0; j < RING; ++j) {
    if (j < n_tiles) issue(j);
    hopper::cp_async_commit();
  }

  float o[NT][KS][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][mt][e] = 0.0f;
  // this thread's heads n * 8 + 2t and n * 8 + 2t + 1 (raw score units)
  float m[NT][2], l[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    m[n][0] = m[n][1] = kNegInf;
    l[n][0] = l[n][1] = 0.0f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    hopper::cp_async_wait<RING - 1>();
    __syncwarp();
    const __nv_bfloat16* ks_ = slots + (j % RING) * 2 * kRows;
    const __nv_bfloat16* vs_ = ks_ + kRows;
    const int key0 = first + j * kTileKeys;

    // S^T [16 keys x 8 heads]: c0 (key g, head 2t), c1 (key g, head 2t+1),
    // c2 and c3 the same for key g + 8
    // two accumulators (even and odd k16 steps) halve the chain of
    // dependent products
    float sc[NT][4], sc2[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = sc2[n][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      hopper::ldmatrix_x4(
          a, hopper::smem_u32(ks_ + (lane & 15) * LDS + ks * 16 +
                              (lane >> 4) * 8));
#pragma unroll
      for (int n = 0; n < NT; ++n)
        hopper::mma_bf16_16816(ks & 1 ? sc2[n] : sc[n], a, qf[n][ks]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] += sc2[n][e];

    const bool live_a = key0 + g < k_end, live_b = key0 + g + 8 < k_end;
    uint32_t pb[NT][2], pl[NT][2];      // P^T in bf16: high and low parts
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (!live_a) sc[n][0] = sc[n][1] = kNegInf;
      if (!live_b) sc[n][2] = sc[n][3] = kNegInf;
      float p[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = fmaxf(sc[n][hh], sc[n][hh + 2]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float mn = fmaxf(m[n][hh], mx);
        const float al = exp2f((m[n][hh] - mn) * scale_log2);
        const float ms = mn * scale_log2;
        m[n][hh] = mn;
        // a masked key weighs 0 even before any live key was seen
        p[hh] = live_a ? exp2f(fmaf(sc[n][hh], scale_log2, -ms)) : 0.0f;
        p[hh + 2] =
            live_b ? exp2f(fmaf(sc[n][hh + 2], scale_log2, -ms)) : 0.0f;
        l[n][hh] = l[n][hh] * al + p[hh] + p[hh + 2];
#pragma unroll
        for (int mt = 0; mt < KS; ++mt) {
          o[n][mt][hh] *= al;
          o[n][mt][hh + 2] *= al;
        }
      }
      // P^T's B fragments: (keys 2t, 2t+1 | 2t+8, 2t+9; head g), each
      // weight as the sum of two bf16 values (p = hi + lo to about 2^-16),
      // so that P v loses no more than the f32 version does
      float lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        lo[e] = p[e] - __bfloat162float(__float2bfloat16_rn(p[e]));
      pb[n][0] = hopper::movmatrix_trans(hopper::pack_bf16x2(p[0], p[1]));
      pb[n][1] = hopper::movmatrix_trans(hopper::pack_bf16x2(p[2], p[3]));
      pl[n][0] = hopper::movmatrix_trans(hopper::pack_bf16x2(lo[0], lo[1]));
      pl[n][1] = hopper::movmatrix_trans(hopper::pack_bf16x2(lo[2], lo[3]));
    }

    // O^T [D x heads] += V^T [D x 16 keys] P^T [16 keys x heads]
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      uint32_t a[4];
      hopper::ldmatrix_x4_trans(
          a, hopper::smem_u32(vs_ + ((lane & 7) + (lane >> 4) * 8) * LDS +
                              mt * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        hopper::mma_bf16_16816(o[n][mt], a, pb[n]);
        hopper::mma_bf16_16816(o[n][mt], a, pl[n]);
      }
    }
    __syncwarp();
    if (j + RING < n_tiles) issue(j + RING);
    hopper::cp_async_commit();
  }
  hopper::cp_async_wait<0>();

  // the block's partial: the warps' states merged in shared memory (the
  // K and V rows are free now); sums over the 8 key rows g of each thread
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l[n][hh] += __shfl_xor_sync(kFull, l[n][hh], off);
  __syncthreads();
  constexpr int LDO = DP + 1;        // padded: the 4 lanes of a quad write
  float* wm = reinterpret_cast<float*>(smem_raw);   // [warp][NH]
  float* wl = wm + kMmaWarps * NH;                  // [warp][NH]
  float* ww = wl + kMmaWarps * NH;                  // [warp][NH] weights
  float* wo = ww + kMmaWarps * NH;                  // [warp][NH][LDO]
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (g == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        wm[warp * NH + n * 8 + 2 * t + hh] = m[n][hh];
        wl[warp * NH + n * 8 + 2 * t + hh] = l[n][hh];
      }
    }
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hd = n * 8 + 2 * t + (e & 1);
        const int d = mt * 16 + g + (e >> 1) * 8;
        wo[(warp * NH + hd) * LDO + d] = o[n][mt][e];
      }
  }
  __syncthreads();
  // each head's largest max and each warp's weight, e^(m_w - max)
  if (tid < NH) {
    float mx = kNegInf, ll = 0.0f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) mx = fmaxf(mx, wm[w * NH + tid]);
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float wt = exp2f((wm[w * NH + tid] - mx) * scale_log2);
      ww[w * NH + tid] = wt;
      ll += wt * wl[w * NH + tid];
    }
    wm[tid] = mx;                    // warp 0's entries are read no more
    wl[tid] = ll;
  }
  __syncthreads();
  for (int i = tid; i < ng * DP; i += kMmaThreads) {
    const int hd = i / DP, d = i - hd * DP;
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w)
      a += ww[w * NH + hd] * wo[(w * NH + hd) * LDO + d];
    const int64_t row = row0 + hd;
    acc_part[(row * n_splits + split) * DP + d] = a;
    if (d == 0) {
      m_part[row * n_splits + split] = wm[hd] * scale_log2;
      l_part[row * n_splits + split] = wl[hd];
    }
  }
  if (!last_block(counter, n_splits)) return;
  merge_splits<__nv_bfloat16, true, 4, kMmaThreads>(
      m_part, l_part, acc_part, out, row0, ng, DP, n_splits, n_live);
}

// ---------------------------------------------------------------------------
// CUDA-core form
// ---------------------------------------------------------------------------

constexpr int kKT = 32;          // keys per tile: one per lane
constexpr int kG = 8;            // q heads per block: two per warp

template <int DP>
constexpr int core_smem_bytes() {
  return (int)sizeof(float) *
         (kG * DP + kKT * (DP + 1) + kKT * DP + kG * kKT + kG);
}

// The CUDA-core form's merge: float4 loads where D allows them.
template <typename T>
__device__ void merge_core(const float* m_part, const float* l_part,
                           const float* acc_part, T* out, int64_t row0,
                           int nh, int D, int n_splits, int n_live) {
  if (D % 4 == 0)
    merge_splits<T, false, 4, kThreads>(m_part, l_part, acc_part, out, row0,
                                        nh, D, n_splits, n_live);
  else
    merge_splits<T, false, 1, kThreads>(m_part, l_part, acc_part, out, row0,
                                        nh, D, n_splits, n_live);
}

// One block: (split, kv head x group chunk, batch row). Writes the split's
// running max (natural units), sum and unnormalised output of each of its
// q heads and, in the last block, the merged output.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
decode_attention_core_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ m_part,
    float* __restrict__ l_part, float* __restrict__ acc_part,
    int* __restrict__ counters, int Hq, int group, int D, int kv_cap,
    const int64_t* __restrict__ kv_len_dev, int split_len, int n_splits,
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
  const int64_t row0 = (int64_t)b * Hq + h0;  // (b, first q head) row
  const int kv_len = live_len(kv_cap, kv_len_dev);
  const int n_live = (kv_len + split_len - 1) / split_len;
  int* counter = counters + ((int64_t)b * gridDim.y + blockIdx.y);
  if (split >= n_live) {                     // no live key: count in only
    if (last_block(counter, n_splits)) merge_core(m_part, l_part, acc_part,
                                                  out, row0, ng, D, n_splits,
                                                  n_live);
    return;
  }

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

  for (int t0 = k_begin; t0 < k_end; t0 += kKT) {
    __syncthreads();                         // the last tile is used up
    for (int i = tid; i < kKT * DP; i += kThreads) {
      const int j = i / DP, d = i - j * DP, key = t0 + j;
      const bool in = key < k_end && d < D;
      ks[j * (DP + 1) + d] = in ? to_f(kb[key * kss + d]) : 0.0f;
      vs[j * DP + d] = in ? to_f(vb[key * vss + d]) : 0.0f;
    }
    __syncthreads();

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
  if (!last_block(counter, n_splits)) return;
  merge_core(m_part, l_part, acc_part, out, row0, ng, D, n_splits, n_live);
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* m_part;
  float* l_part;
  float* acc_part;
  int* counters;
  int B, Hq, Hkv, D, kv_len;
  const int64_t* kv_len_dev;
  int split_len, n_splits;
  const int64_t* st;
};

template <int DP, int NT, int RING>
int launch_mma(const Args& a, float scale_log2, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<DP, RING>();
  cudaError_t e = cudaFuncSetAttribute(
      decode_attention_mma_kernel<DP, NT, RING>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int group = a.Hq / a.Hkv;
  const int n_gchunks = (group + 8 * NT - 1) / (8 * NT);
  const dim3 grid(a.n_splits, a.Hkv * n_gchunks, a.B);
  decode_attention_mma_kernel<DP, NT, RING>
      <<<grid, kMmaThreads, smem, stream>>>(
      (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
      (const __nv_bfloat16*)a.v, (__nv_bfloat16*)a.out, a.m_part, a.l_part,
      a.acc_part, a.counters, a.Hq, group, a.kv_len, a.kv_len_dev,
      a.split_len, a.n_splits, n_gchunks, a.st[0], a.st[1], a.st[2], a.st[3],
      a.st[4], a.st[5], a.st[6], a.st[7], scale_log2);
  return (int)cudaGetLastError();
}

template <int DP>
int dispatch_mma(const Args& a, float scale_log2, cudaStream_t s) {
  // a second n8 tile of heads for groups above 8 (D 256 keeps one: its
  // output fragments would pass 128 registers)
  if constexpr (DP < 256) {
    if (a.Hq / a.Hkv > 8) return launch_mma<DP, 2, 1>(a, scale_log2, s);
    // each warp's whole share of a split in flight at once, up to three
    // 16-key tiles (three slots of 8 warps: 209 KB at D 128)
    const int tiles = (a.split_len + kTileKeys - 1) / kTileKeys;
    if (tiles >= 3) return launch_mma<DP, 1, 3>(a, scale_log2, s);
    if (tiles == 2) return launch_mma<DP, 1, 2>(a, scale_log2, s);
  }
  return launch_mma<DP, 1, 1>(a, scale_log2, s);
}

template <typename T, int DP>
int launch_core(const Args& a, float q_div, cudaStream_t stream) {
  constexpr int smem = core_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      decode_attention_core_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int group = a.Hq / a.Hkv;
  const int n_gchunks = (group + kG - 1) / kG;
  const dim3 grid(a.n_splits, a.Hkv * n_gchunks, a.B);
  decode_attention_core_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out, a.m_part,
      a.l_part, a.acc_part, a.counters, a.Hq, group, a.D, a.kv_len,
      a.kv_len_dev, a.split_len, a.n_splits, n_gchunks, a.st[0], a.st[1],
      a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7], q_div);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_core(const Args& a, float q_div, cudaStream_t s) {
  if (a.D <= 32) return launch_core<T, 32>(a, q_div, s);
  if (a.D <= 64) return launch_core<T, 64>(a, q_div, s);
  if (a.D <= 128) return launch_core<T, 128>(a, q_div, s);
  return launch_core<T, 256>(a, q_div, s);
}

}  // namespace

extern "C" {

// form: 0 = CUDA cores (f32 or bf16), 1 = tensor cores (bf16, D 64, 128 or
// 256, every stride a multiple of 8 elements and every base 16-byte
// aligned). dtype: 0 = float32, 1 = bfloat16. Strides in elements: q
// (batch, head), k (batch, seq, head), v (batch, seq, head). m_part,
// l_part [B, Hq, n_splits] and acc_part [B, Hq, n_splits, D] are f32
// scratch; counters holds at least B * Hq int32 zeros (left zeroed); out is
// a contiguous [B, 1, Hq, D]. kv_len_dev null: kv_len keys are live. Else
// kv_len must be Skv and the int64 at kv_len_dev (device memory, read by the
// kernel, clamped to [0, Skv]) gives the live keys. n_splits must be
// ceil(kv_len / split_len), split_len a multiple of 32. q_div = sqrt(D)
// (CUDA cores), scale_log2 = log2(e) / sqrt(D) (tensor cores). Returns 0, a
// CUDA error code, or one of the negative argument codes above.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         void* out, void* m_part, void* l_part,
                         void* acc_part, void* counters, int form, int dtype,
                         int B, int Hq, int Hkv, int D, int Skv, int kv_len,
                         const void* kv_len_dev, int split_len, int n_splits,
                         int64_t qsb,
                         int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                         int64_t vsb, int64_t vss, int64_t vsh, float q_div,
                         float scale_log2, void* stream) {
  if (D < 1 || D > 256) return kErrHeadDim;
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || B > 65535 ||
      Skv < 1 || split_len < kKT || split_len % kKT != 0)
    return kErrShape;
  if (kv_len < 1 || kv_len > Skv || (kv_len_dev && kv_len != Skv))
    return kErrKvLen;
  if (n_splits != (kv_len + split_len - 1) / split_len) return kErrShape;
  if ((int64_t)Hkv * ((Hq / Hkv + kG - 1) / kG) > 65535) return kErrShape;
  if (dtype != 0 && dtype != 1) return kErrDtype;
  const int64_t st[8] = {qsb, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const Args a{q, k, v, out, (float*)m_part, (float*)l_part,
               (float*)acc_part, (int*)counters, B, Hq, Hkv, D, kv_len,
               (const int64_t*)kv_len_dev, split_len, n_splits, st};
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 1) {
    if (dtype != 1) return kErrDtype;
    if (D != 64 && D != 128 && D != 256) return kErrHeadDim;
    for (int i = 0; i < 8; ++i)
      if (st[i] % 8 != 0) return kErrLayout;
    if ((uintptr_t)q % 16 || (uintptr_t)k % 16 || (uintptr_t)v % 16)
      return kErrLayout;
    if (D == 64) return dispatch_mma<64>(a, scale_log2, s);
    if (D == 128) return dispatch_mma<128>(a, scale_log2, s);
    return dispatch_mma<256>(a, scale_log2, s);
  }
  if (dtype == 0) return dispatch_core<float>(a, q_div, s);
  return dispatch_core<__nv_bfloat16>(a, q_div, s);
}

const char* decode_attention_error_string(int code) {
  switch (code) {
    case kErrHeadDim: return "head dim must be in [1, 256] (tensor-core "
                             "form: 64, 128 or 256)";
    case kErrShape: return "unsupported shape";
    case kErrDtype: return "dtype must be float32 or bfloat16 (tensor-core "
                           "form: bfloat16)";
    case kErrKvLen: return "kv_len must be in [1, Skv] (Skv with a device "
                           "kv_len)";
    case kErrLayout: return "tensor-core form: strides must be multiples of "
                            "8 elements and pointers 16-byte aligned";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"

// Rotary embedding of a step's queries and keys and the append of its keys
// and values to the layer's KV cache, in one launch per attention layer.
//
// Replaces no TPU kernel: the JAX package leaves RoPE and the cache write
// to XLA (repro/models/layers.py: rope, and the cache update of
// attention_apply), which fuses them into the step's program. Added
// because the port's plain chain launches 17 kernels a rope() call (the
// frequencies, the angles, cos and sin, four products, a difference, a
// sum, two casts, a concatenation) and 3 a cache write at a device
// position: 40 launches an attention layer a decode step, more than half
// of a batch-1 decode step's launches for OLMoE-1B-7B and Qwen2-7B.
//
// Computes, for q [B, S, Hq, hd], k and v [B, S, Hkv, hd], the layer's
// caches ck and cv [B, L, Hkv, hd] (all contiguous and of one dtype, f32
// or bf16), positions [B, S] (int64, any strides) and the first cache row
// `start` (an int64 on the device, read by every block, or a host value):
//   half = hd / 2, i < half, inv = 1 / half (rounded to f32)
//   freq[i]  = powf(theta, -i * inv)
//   a        = float(positions[b, s]) * freq[i]
//   y1 = x1 cos a - x2 sin a,   y2 = x2 cos a + x1 sin a
//   (x1, x2 the first and second half of a head; each product rounded to
//   f32 before the sum, no multiply-add contraction), rounded to the dtype:
//   q[b, s, h]               <- y of q[b, s, h]      (in place)
//   ck[b, start + s, h]      <- y of k[b, s, h]
//   cv[b, start + s, h]      <- v[b, s, h]
// With rotate 0 there is no rotation: q is left as it is and k and v are
// appended. A row outside [0, L) is not written (the wrapper refuses a
// host start that would reach one; a device start is the caller's to keep
// in range, as for the plain chain's index_copy_).
//
// Those are the operations of the plain chain (layers.rope, then
// layers.write_rows) in its order, as PyTorch's CUDA kernels compute them:
// a division by a host scalar is the product with its f32 reciprocal
// (ATen's div_true_kernel_cuda; for a power-of-two half the two are the
// same), pow, cos and sin are the CUDA math library's powf, cosf and sinf
// (no fast math), a bf16 value widens exactly and rounds back to nearest
// even. So on the card the outputs equal the plain chain's bit for bit.
//
// Bound on an H100: bytes (a few operations an element). q is read and
// written once, k and v read once and written once into the caches. A
// Qwen2-7B prefill of 4,096 tokens (28/4 heads of 128, bf16): 75.5 MB,
// 22.5 us at 3.35 TB/s; a decode step reads and writes 18 KB, so there
// the launch itself is the cost.
//
// Design: a block per (token, group of heads), 128 threads. The block
// computes cos and sin of its token's `half` angles once into shared
// memory (a thread a pair index), shared by every q and k head of the
// group; then each thread takes (head, column chunk) items: a chunk is N
// elements of the first half and the N at the same place in the second
// (16-byte loads where hd and the pointers allow, narrower otherwise), so
// a rotation reads both halves it needs in two loads and writes two. The
// wrapper sizes the groups so that a step of few tokens (decode) still
// spreads over the SMs: a head a block at batch 1, every head of a token
// in one block for a prefill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHalf = 128;                // hd <= 256

enum : int { kErrShape = -1, kErrForm = -2 };

// An element's storage bits, widened to f32 and rounded back.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Bits = unsigned int;
  static __device__ __forceinline__ float widen(Bits b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ Bits narrow(float f) {
    return __float_as_uint(f);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  using Bits = unsigned short;
  static __device__ __forceinline__ float widen(Bits b) {
    return __uint_as_float((unsigned int)b << 16);
  }
  static __device__ __forceinline__ Bits narrow(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

template <int Bytes>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = unsigned int; };
template <>
struct Raw<2> { using type = unsigned short; };

// N elements' bits, moved as one load or store of N * sizeof(Bits) bytes.
template <typename Bits, int N>
struct Chunk {
  Bits b[N];
  using R = typename Raw<N * (int)sizeof(Bits)>::type;
  __device__ __forceinline__ void load(const Bits* p) {
    const R r = *reinterpret_cast<const R*>(p);
    memcpy(b, &r, sizeof(R));
  }
  __device__ __forceinline__ void store(Bits* p) const {
    R r;
    memcpy(&r, b, sizeof(R));
    *reinterpret_cast<R*>(p) = r;
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
rope_append_kernel(T* q, const T* k, const T* v, T* ck, T* cv,
                   const int64_t* positions, const int64_t* start_dev,
                   int64_t start_host, int S, int Hq, int Hkv, int hd,
                   int64_t L, int64_t pos_sb, int64_t pos_ss, float theta,
                   int rotate, int heads_per_block) {
  using E = Elem<T>;
  using Bits = typename E::Bits;
  __shared__ float cos_s[kMaxHalf];
  __shared__ float sin_s[kMaxHalf];

  const int token = blockIdx.x;                 // b * S + s
  const int b = token / S;
  const int s = token - b * S;
  const int half = hd / 2;
  // the heads in turn: q (rotated only), k, v
  const int first = rotate ? 0 : Hq;
  const int n_heads = Hq + 2 * Hkv - first;
  const int h0 = first + blockIdx.y * heads_per_block;
  const int h1 = min(first + n_heads, h0 + heads_per_block);
  if (h0 >= h1) return;
  const bool rotates = rotate && h0 < Hq + Hkv;   // the same for the block
  if (rotates) {
    const float p = (float)positions[b * pos_sb + s * pos_ss];
    const float inv = __fdiv_rn(1.0f, (float)half);
    for (int i = threadIdx.x; i < half; i += kThreads) {
      const float freq = powf(theta, __fmul_rn(-(float)i, inv));
      const float a = __fmul_rn(p, freq);
      cos_s[i] = cosf(a);
      sin_s[i] = sinf(a);
    }
    __syncthreads();
  }
  const int64_t row = (start_dev != nullptr ? *start_dev : start_host) + s;
  const bool row_in = row >= 0 && row < L;
  const int per_head = half / N;
  const int items = (h1 - h0) * per_head;
  const Bits* qb = reinterpret_cast<const Bits*>(q);
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int hl = it / per_head;
    const int c = (it - hl * per_head) * N;      // column of the first half
    const int h = h0 + hl;
    const Bits* src;
    Bits* dst;
    bool rot = rotate != 0;
    if (h < Hq) {
      const int64_t off = ((int64_t)token * Hq + h) * hd;
      src = qb + off;
      dst = reinterpret_cast<Bits*>(q) + off;
    } else {
      const bool is_k = h < Hq + Hkv;
      const int hk = is_k ? h - Hq : h - Hq - Hkv;
      if (!row_in) continue;
      src = reinterpret_cast<const Bits*>(is_k ? k : v) +
            ((int64_t)token * Hkv + hk) * hd;
      dst = reinterpret_cast<Bits*>(is_k ? ck : cv) +
            (((int64_t)b * L + row) * Hkv + hk) * hd;
      rot = rot && is_k;
    }
    Chunk<Bits, N> x1, x2;
    x1.load(src + c);
    x2.load(src + half + c);
    if (rot) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float a = E::widen(x1.b[j]);
        const float e = E::widen(x2.b[j]);
        const float co = cos_s[c + j];
        const float si = sin_s[c + j];
        const float y1 = __fsub_rn(__fmul_rn(a, co), __fmul_rn(e, si));
        const float y2 = __fadd_rn(__fmul_rn(e, co), __fmul_rn(a, si));
        x1.b[j] = E::narrow(y1);
        x2.b[j] = E::narrow(y2);
      }
    }
    x1.store(dst + c);
    x2.store(dst + half + c);
  }
}

template <typename T, int N>
int launch(void* q, const void* k, const void* v, void* ck, void* cv,
           const int64_t* positions, const int64_t* start_dev,
           int64_t start_host, int B, int S, int Hq, int Hkv, int hd,
           int64_t L, int64_t pos_sb, int64_t pos_ss, float theta,
           int rotate, int groups, cudaStream_t stream) {
  const int n_heads = Hq + 2 * Hkv - (rotate ? 0 : Hq);
  const int per_block = (n_heads + groups - 1) / groups;
  const dim3 grid((unsigned)B * (unsigned)S, (unsigned)groups);
  rope_append_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(ck), static_cast<T*>(cv),
      positions, start_dev, start_host, S, Hq, Hkv, hd, L, pos_sb, pos_ss,
      theta, rotate, per_block);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(int vec, void* q, const void* k, const void* v, void* ck,
               void* cv, const int64_t* positions, const int64_t* start_dev,
               int64_t start_host, int B, int S, int Hq, int Hkv, int hd,
               int64_t L, int64_t pos_sb, int64_t pos_ss, float theta,
               int rotate, int groups, cudaStream_t stream) {
// (an f32 chunk is at most 4 elements: 8 is never asked of it)
#define ROPE_APPEND_LAUNCH(n)                                              \
  return launch<T, (n * (int)sizeof(T) <= 16 ? n : 1)>(                    \
      q, k, v, ck, cv, positions, start_dev, start_host, B, S, Hq, Hkv,    \
      hd, L, pos_sb, pos_ss, theta, rotate, groups, stream)
  switch (vec) {
    case 8: ROPE_APPEND_LAUNCH(8);
    case 4: ROPE_APPEND_LAUNCH(4);
    case 2: ROPE_APPEND_LAUNCH(2);
    default: ROPE_APPEND_LAUNCH(1);
  }
#undef ROPE_APPEND_LAUNCH
}

}  // namespace

extern "C" {

// One launch on `stream`. dtype 0 float32, 1 bfloat16 (q, k, v and the
// caches); vec the elements a load (1, 2, 4 or 8 for bf16, up to 4 for
// f32), which must divide hd / 2 and whose bytes must divide every
// pointer's alignment (the wrapper picks it). start, where not null, is a
// device int64 holding the first row, else start_host is; positions is
// read at b * pos_sb + s * pos_ss. groups splits each token's heads over
// that many blocks. Returns 0, a CUDA error code, kErrShape or kErrForm.
int rope_append_fwd(void* q, const void* k, const void* v, void* ck,
                    void* cv, const void* positions, const void* start,
                    int64_t start_host, int B, int S, int Hq, int Hkv,
                    int hd, int64_t L, int64_t pos_sb, int64_t pos_ss,
                    float theta, int rotate, int groups, int vec, int dtype,
                    void* stream) {
  const int max_vec = dtype == 1 ? 8 : 4;
  const int n_heads = Hq + 2 * Hkv - (rotate ? 0 : Hq);
  if (B < 1 || S < 1 || (int64_t)B * S > 0x7fffffff || Hq < 1 ||
      Hkv < 1 || hd < 2 || hd % 2 || hd / 2 > kMaxHalf || L < 1 ||
      groups < 1 || groups > 65535 || groups > n_heads)
    return kErrShape;
  if ((dtype != 0 && dtype != 1) ||
      (vec != 1 && vec != 2 && vec != 4 && vec != 8) || vec > max_vec ||
      (hd / 2) % vec)
    return kErrForm;
  auto s = (cudaStream_t)stream;
  auto pos = static_cast<const int64_t*>(positions);
  auto first = static_cast<const int64_t*>(start);
  if (dtype == 1)
    return launch_vec<__nv_bfloat16>(vec, q, k, v, ck, cv, pos, first,
                                     start_host, B, S, Hq, Hkv, hd, L,
                                     pos_sb, pos_ss, theta, rotate, groups,
                                     s);
  return launch_vec<float>(vec, q, k, v, ck, cv, pos, first, start_host, B,
                           S, Hq, Hkv, hd, L, pos_sb, pos_ss, theta, rotate,
                           groups, s);
}

const char* rope_append_error_string(int code) {
  if (code == kErrShape)
    return "bad shape (B, S, Hq, Hkv, L >= 1; B S < 2^31; hd even, 2 to "
           "256; groups in [1, 65535] and at most the heads processed)";
  if (code == kErrForm)
    return "bad dtype or vector width (dtype 0 f32 or 1 bf16; vec 1, 2, 4 "
           "or 8 elements, at most 16 bytes, dividing hd / 2)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

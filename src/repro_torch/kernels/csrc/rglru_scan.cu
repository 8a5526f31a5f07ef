// The RG-LRU linear recurrence over time, in one pass over the inputs.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py::_rglru_kernel
// (rglru_scan_pallas, with its in-block doubling _scan_block). It computes
// what repro/models/rglru.py::rglru_scan_ref computes:
//   b_t = sqrt(max(1 - a_t * a_t, 0)) * b_in_t,   h_t = a_t * h_{t-1} + b_t,
// with h_{-1} = 0, for b_in and a [B, L, D] f32, contiguous; outputs h
// [B, L, D] f32 and h_last = h[:, L-1] [B, D]. Any L >= 1 (the TPU kernel
// is right only for L a multiple of its 256-step block).
//
// Bound on an H100: bytes. a and b_in are read and h is written once:
// 12*B*L*D bytes, 252 MB at the serving path's shape (B=2, L=4096,
// D=2560), 0.075 ms at 3.35 TB/s; about 6 operations per element are
// negligible.
//
// Design: as the reference's sequential grid over time blocks, a block
// owns (b, 32 d) and walks the whole of L, carrying the state from one
// tile of kTile steps to the next; a, b_in and h each cross device memory
// once (252 MB at the path's shape), in one launch with no scratch.
//   * A tile is cut into time segments: a thread holds kVec d (a 16-byte
//     load and store along d where D % 4 == 0 and the tensors are 16-byte
//     aligned, the vec4 form; one float otherwise, the scalar form) over
//     kSeg consecutive steps, in registers, loaded through the read-only
//     path (a and b_in are never written here). The next tile's loads
//     are issued before the current tile is scanned (a register double
//     buffer: 32 KB in flight a block).
//   * Each thread walks its segment from h = 0 (the product of its a and
//     its local end state); a shuffle scan across the warp's segments and
//     the warps' aggregates in shared memory give the state entering each
//     segment and the carry into the next tile; each thread then replays
//     its segment from its entering state and writes h. The thread of step
//     L-1 writes h_last, so h_last equals h[:, L-1] bit for bit.
//   * Steps past L read a = 1, b_in = 0 (the identity) and are not stored.
// At the path's shape that is 160 blocks of 256 threads, all resident at
// two blocks an SM, so there is no partial last wave. Probed on the card
// and slower: 16 d a block (320 blocks), 64-step tiles (at two or three
// blocks an SM), streaming loads (__ldcs), streaming or L2-only stores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDTile = 32;               // d a block owns
constexpr int kTile = 128;               // time steps a tile (CHUNK)
constexpr unsigned kFull = 0xffffffffu;

enum : int { kErrShape = -1 };

__device__ __forceinline__ float gated(float a, float x) {
  return sqrtf(fmaxf(1.f - a * a, 0.f)) * x;
}

template <int kVec>
struct Layout {
  static constexpr int kGroups = kDTile / kVec;     // threads across d
  static constexpr int kRows = kThreads / kGroups;  // segments a tile
  static constexpr int kSeg = kTile / kRows;        // steps a segment
  static constexpr int kRowsPerWarp = 32 / kGroups;
};

// kSeg steps from t0 of kVec d at off (a and b_in); steps past L read the
// identity (a 1, b_in 0), as do d past D (live false).
template <int kVec, int kSeg = Layout<kVec>::kSeg>
__device__ __forceinline__ void load_seg(const float* __restrict__ a,
                                         const float* __restrict__ b_in,
                                         int64_t off, int t0, int L, int D,
                                         bool live, float (&av)[kSeg][kVec],
                                         float (&bv)[kSeg][kVec]) {
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    const bool in = live && t0 + k < L;
    const int64_t j = off + (int64_t)(t0 + k) * D;
    if constexpr (kVec == 4) {
      float4 x = make_float4(1.f, 1.f, 1.f, 1.f);
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in) {
        x = __ldg(reinterpret_cast<const float4*>(a + j));
        y = __ldg(reinterpret_cast<const float4*>(b_in + j));
      }
      av[k][0] = x.x; av[k][1] = x.y; av[k][2] = x.z; av[k][3] = x.w;
      bv[k][0] = y.x; bv[k][1] = y.y; bv[k][2] = y.z; bv[k][3] = y.w;
    } else {
      av[k][0] = in ? __ldg(a + j) : 1.f;
      bv[k][0] = in ? __ldg(b_in + j) : 0.f;
    }
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    p[0] = v[0];
}

template <int kVec>
__global__ void __launch_bounds__(kThreads, 2)
rglru_scan_kernel(const float* __restrict__ b_in, const float* __restrict__ a,
                  float* __restrict__ h, float* __restrict__ h_last, int L,
                  int D) {
  using Lay = Layout<kVec>;
  constexpr int kSeg = Lay::kSeg, kGroups = Lay::kGroups;
  constexpr int kRowsPerWarp = Lay::kRowsPerWarp;
  constexpr int kWarps = kThreads / 32;
  // each warp's aggregate (product of a, local end state) by tile parity
  __shared__ float2 agg[2][kWarps][kDTile];

  const int g = threadIdx.x % kGroups, r = threadIdx.x / kGroups;
  const int warp = threadIdx.x / 32, wr = r % kRowsPerWarp;
  const int d0 = blockIdx.x * kDTile + g * kVec;
  const bool live = d0 < D;              // kVec 4: D % 4 == 0, all 4 live
  const int64_t off = (int64_t)blockIdx.y * L * D + d0;
  const int ntiles = (L + kTile - 1) / kTile;

  float av[kSeg][kVec], bv[kSeg][kVec], an[kSeg][kVec], bn[kSeg][kVec];
  load_seg<kVec>(a, b_in, off, r * kSeg, L, D, live, av, bv);
  float carry[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) carry[v] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int par = tile & 1;
    const int t0 = tile * kTile + r * kSeg;
    if (tile + 1 < ntiles)
      load_seg<kVec>(a, b_in, off, t0 + kTile, L, D, live, an, bn);

    // the segment from h = 0: its product of a and its end state
    float A[kVec], H[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      A[v] = 1.f;
      H[v] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        bv[k][v] = gated(av[k][v], bv[k][v]);
        H[v] = av[k][v] * H[v] + bv[k][v];
        A[v] *= av[k][v];
      }
    }
    // inclusive scan over the warp's segments (kGroups lanes apart):
    // (A', H') then (A, H) is (A' A, A H' + H)
#pragma unroll
    for (int s = 1; s < kRowsPerWarp; s <<= 1) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float Ap = __shfl_up_sync(kFull, A[v], s * kGroups);
        const float Hp = __shfl_up_sync(kFull, H[v], s * kGroups);
        if (wr >= s) {
          H[v] = A[v] * Hp + H[v];
          A[v] *= Ap;
        }
      }
    }
    // exclusive: the segments before this one in the warp
    float Ae[kVec], He[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      Ae[v] = 1.f;
      He[v] = 0.f;
      if (kRowsPerWarp > 1) {
        const float Ap = __shfl_up_sync(kFull, A[v], kGroups);
        const float Hp = __shfl_up_sync(kFull, H[v], kGroups);
        if (wr > 0) {
          Ae[v] = Ap;
          He[v] = Hp;
        }
      }
    }
    if (wr == kRowsPerWarp - 1) {
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        agg[par][warp][g * kVec + v] = make_float2(A[v], H[v]);
    }
    __syncthreads();
    // the state entering this warp's segments, and the next tile's carry
    float hin[kVec];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        if (w == warp) hin[v] = carry[v];
        const float2 x = agg[par][w][g * kVec + v];
        carry[v] = x.x * carry[v] + x.y;
      }
    }
    // replay the segment from its entering state and write h
    float hv[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) hv[v] = Ae[v] * hin[v] + He[v];
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) hv[v] = av[k][v] * hv[v] + bv[k][v];
      const int t = t0 + k;
      if (live && t < L) {
        store_vec<kVec>(h + off + (int64_t)t * D, hv);
        if (t == L - 1)
          store_vec<kVec>(h_last + (int64_t)blockIdx.y * D + d0, hv);
      }
    }
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        av[k][v] = an[k][v];
        bv[k][v] = bn[k][v];
      }
    }
  }
}

}  // namespace

extern "C" {

// One launch on `stream`. vec 4 takes the vec4 form (D % 4 == 0 and every
// pointer 16-byte aligned, which the caller checks), vec 1 the scalar
// form. Returns 0, a CUDA error code, or kErrShape.
int rglru_scan_fwd(const float* b_in, const float* a, float* h,
                   float* h_last, int B, int L, int D, int vec,
                   void* stream) {
  if (B < 1 || L < 1 || D < 1 || B > 65535 || (vec != 1 && vec != 4) ||
      (vec == 4 && D % 4 != 0))
    return kErrShape;
  const dim3 grid((unsigned)((D + kDTile - 1) / kDTile), (unsigned)B);
  auto kernel = vec == 4 ? rglru_scan_kernel<4> : rglru_scan_kernel<1>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(b_in, a, h, h_last, L,
                                                      D);
  return (int)cudaGetLastError();
}

const char* rglru_scan_error_string(int code) {
  if (code == kErrShape)
    return "bad shape (B in [1, 65535], L and D >= 1; vec 1, or 4 with "
           "D % 4 == 0)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

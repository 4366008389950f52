// Sliding-window decode attention over a ring, for Hopper (sm_90a).
//
// Replaces the TPU kernel `swa_decode_kernel`
// (src/repro/kernels/swa_decode.py:69, body `_kernel` :34-66), reached
// through `ops.swa_decode_attention`.
//
// One new token per batch row attends, GQA style, to that row's ring:
//   q       f32 or bf16 [B, H, hd], H = KV * G (head h reads KV head h / G)
//   k/v     same dtype  [B, W, KV, hd] -- the reference's ring layout, read
//           in place (the TPU wrapper's swapaxes and pad copies of the whole
//           ring are not repeated)
//   pos     i32 [B, W]  position held by each slot, -1 = empty
//   cur     i32 [] or [B] (cur_per_row), the query's position, read on the
//           device (no host sync)
//   out     q's dtype [B, H, hd]
// Slot w of row b takes part iff pos >= 0 and cur - window < pos <= cur;
// a row with no such slot gives 0, as the TPU kernel does.
//
// What bounds it: bytes. Each valid K/V row is read once and used for
// 2 * G * hd multiply-adds per matrix, far below the card's ridge point. At
// the serving shape (B = 4, W = 8192, 16 KV heads x 64, f32) full rings are
// 268 MB, 0.080 ms at the H100 SXM's 3.35 TB/s; the positions add 131 KB.
//
// What the design does about it:
//   * the ring is split along W across blocks (flash-decoding): one block
//     per (KV head, row, split), so 64 (row, head) pairs still fill 132 SMs
//     (the paged kernel, one block per pair, was starved of blocks at long
//     context); the wrapper picks the split count from the SM count;
//   * a slot's position is read first and an invalid slot's K/V row is never
//     loaded, so empty and stale slots cost 4 bytes each;
//   * the G query heads of a KV head share every K/V row a lane loads;
//   * each warp walks its own slots, kRows at a time, with every row's loads
//     issued before any of them is used, lanes on consecutive elements of a
//     row (coalesced);
//   * an fp32 online softmax per (warp, head), merged across warps in warp
//     order through shared memory, then across splits in split order by a
//     second kernel: no atomics, the same bits every run. A warp or split
//     that saw no valid slot has max -inf and weight exactly 0 in a merge.
// It leaves: 4- or 2-byte loads per lane, no TMA, no cp.async pipelining.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // warps per block, each walking its own slots
constexpr int kRows = 4;    // slots a warp loads before it uses them

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Pass 1: block (kvh, b, split) reduces slots [split * chunk, +chunk) of row
// b to one unnormalised (max, sum, acc[hd]) per query head of KV head kvh.
// E: elements of a row per lane (hd <= 32 * E); MAXG: query heads per KV
// head the registers hold (G <= MAXG).
template <typename T, int E, int MAXG>
__global__ void __launch_bounds__(kWarps * 32)
swa_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ pos,
                 const int* __restrict__ cur_pos, int cur_per_row,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc, int W, int KV, int G, int hd,
                 int window, int splits, int chunk, float scale) {
  __shared__ float sm_m[kWarps][MAXG];
  __shared__ float sm_l[kWarps][MAXG];
  __shared__ float sm_acc[kWarps][MAXG][E * 32];

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = KV * G;
  const long long cur = cur_pos[cur_per_row ? b : 0];
  const long long lo = cur - static_cast<long long>(window);
  const int s0 = split * chunk;
  const int s1 = min(W, s0 + chunk);
  const long row_stride = static_cast<long>(KV) * hd;     // slot -> slot
  const long ring = static_cast<long>(b) * W * row_stride + static_cast<long>(kvh) * hd;
  const T* kb = k + ring;
  const T* vb = v + ring;
  const int* pb = pos + static_cast<long>(b) * W;

  float qr[MAXG][E], acc[MAXG][E], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      qr[g][e] = (g < G && d < hd)
                     ? to_float(q[(static_cast<long>(b) * H + kvh * G + g) * hd + d])
                     : 0.f;
      acc[g][e] = 0.f;
    }
  }

  for (int base = s0 + warp * kRows; base < s1; base += kWarps * kRows) {
    float kf[kRows][E], vf[kRows][E];
    bool ok[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int s = base + r;
      ok[r] = false;
#pragma unroll
      for (int e = 0; e < E; ++e) kf[r][e] = vf[r][e] = 0.f;
      if (s < s1) {
        const long long p = pb[s];            // the same for every lane
        ok[r] = p >= 0 && p > lo && p <= cur;
      }
      if (ok[r]) {
        const long off = static_cast<long>(s) * row_stride;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane + 32 * e;
          if (d < hd) {
            kf[r][e] = to_float(kb[off + d]);
            vf[r][e] = to_float(vb[off + d]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!ok[r]) continue;                   // warp-uniform
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot += qr[g][e] * kf[r][e];
        const float sc = warp_sum(dot) * scale;
        const float m_new = fmaxf(m[g], sc);
        const float alpha = expf(m[g] - m_new);   // 0 while m[g] is -inf
        const float p = expf(sc - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = acc[g][e] * alpha + p * vf[r][e];
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][lane + 32 * e] = acc[g][e];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i % hd;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w][g];
      const float f = mw == -INFINITY ? 0.f : expf(mw - mx);
      L += f * sm_l[w][g];
      A += f * sm_acc[w][g][d];
    }
    const long hrow = (static_cast<long>(b) * H + kvh * G + g) * splits + split;
    part_acc[hrow * hd + d] = A;
    if (d == 0) {
      part_m[hrow] = mx;
      part_l[hrow] = L;
    }
  }
}

// Pass 2: out[b, h, :] = the splits' partials merged in split order.
template <typename T>
__global__ void swa_combine_kernel(const float* __restrict__ part_m,
                                   const float* __restrict__ part_l,
                                   const float* __restrict__ part_acc,
                                   T* __restrict__ out, int splits, int hd) {
  const long bh = blockIdx.x;
  const float* pm = part_m + bh * splits;
  const float* pl = part_l + bh * splits;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, pm[s]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float L = 0.f, A = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float ms = pm[s];
      const float f = ms == -INFINITY ? 0.f : expf(ms - mx);
      L += f * pl[s];
      A += f * part_acc[(bh * splits + s) * hd + d];
    }
    out[bh * hd + d] = from_float<T>(A / fmaxf(L, 1e-30f));
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  const int* cur;
  float* part_ml;
  float* part_acc;
  void* out;
  int cur_per_row, B, W, KV, G, hd, window, splits;
  float scale;
  cudaStream_t stream;
};

template <typename T, int E, int MAXG>
int launch_one(const Args& a) {
  const int chunk = (a.W + a.splits - 1) / a.splits;
  const long n_part = static_cast<long>(a.B) * a.KV * a.G * a.splits;
  const dim3 grid(a.KV, a.B, a.splits);
  swa_split_kernel<T, E, MAXG><<<grid, kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.pos, a.cur, a.cur_per_row, a.part_ml,
      a.part_ml + n_part, a.part_acc, a.W, a.KV, a.G, a.hd, a.window,
      a.splits, chunk, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_combine_kernel<T><<<a.B * a.KV * a.G, 128, 0, a.stream>>>(
      a.part_ml, a.part_ml + n_part, a.part_acc, static_cast<T*>(a.out),
      a.splits, a.hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
int launch_e(const Args& a) {
  if (a.G <= 1) return launch_one<T, E, 1>(a);
  if (a.G <= 2) return launch_one<T, E, 2>(a);
  if (a.G <= 4) return launch_one<T, E, 4>(a);
  // MAXG * E <= 32 keeps the registers and the 32 KB merge buffer bounded
  if constexpr (E <= 4) {
    if (a.G <= 8) return launch_one<T, E, 8>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_t(const Args& a) {
  if (a.hd <= 32) return launch_e<T, 1>(a);
  if (a.hd <= 64) return launch_e<T, 2>(a);
  if (a.hd <= 128) return launch_e<T, 4>(a);
  if (a.hd <= 256) return launch_e<T, 8>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry point for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. `part_ml` is caller-allocated f32 scratch [2, B, H, splits]
// (maxima, then sums) and `part_acc` f32 [B, H, splits, hd]. `dtype` 0 =
// float32, 1 = bfloat16 (q, k, v and out alike). `cur_per_row` 1 reads
// cur_pos[b] for row b, 0 reads cur_pos[0] for every row. Returns the CUDA
// error code of the launches (0 = success); cudaErrorInvalidValue for a
// geometry the kernel does not take (hd > 256, G > 8, or G > 4 with
// hd > 128) or an unknown dtype.
extern "C" int swa_decode_launch(const void* q, const void* k, const void* v,
                                 const int* pos, const int* cur_pos,
                                 float* part_ml, float* part_acc, void* out,
                                 int cur_per_row, int B, int W, int KV, int G,
                                 int hd, int window, int splits, int dtype,
                                 float scale, void* stream) {
  const Args a{q,  k,  v,  pos, cur_pos, part_ml, part_acc, out, cur_per_row,
               B,  W,  KV, G,   hd,      window,  splits,   scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_t<float>(a);
  if (dtype == 1) return launch_t<__nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

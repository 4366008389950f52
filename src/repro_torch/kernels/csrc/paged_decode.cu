// Paged-KV decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_kernel`
// (src/repro/kernels/swa_decode.py:149, body `_paged_core`), reached
// through `ops.paged_decode_attention`.
//
// One new token per batch row attends, GQA style, to that row's KV rows in a
// page arena:
//   q            f32  [B, H, hd], H = KV * G (head h reads KV head h / G)
//   k/v pages    f32 or int8 [P + 1, page_size, KV, hd] -- the PUBLIC
//                layout, read in place (the TPU wrapper's swapaxes copy of
//                the whole arena is not repeated); page P is the null page
//   k/v scales   bf16 [P + 1, page_size, KV] (int8 arenas only)
//   page_tables  i32  [B, max_pages], cur_pos i32 [B], both read on the
//                device (no host sync)
//   out          f32  [B, H, hd]
// Logical slot s of row b lives at page page_tables[b, s / page_size],
// offset s % page_size, and holds position s. It takes part iff s <= cur_pos[b]
// (causal), as in the reference; a row whose table is all null page reads
// the null page like any other, so an inactive slot stays finite.
//
// What bounds it: bytes. Each valid K/V row is read once and used for
// 2 * G * hd multiply-adds per matrix, far below the card's ridge point;
// at 4096 positions, B = 4 and f32 K/V of 16 x 64 or 8 x 128 per row the
// function must move about 134 MB, 0.040 ms at the H100 SXM's 3.35 TB/s.
//
// What the design does about it:
//   * rows past cur_pos[b] are never read: a block stops at page
//     cur_pos[b] / page_size, where the TPU grid visits every one of the
//     max_pages pages and masks;
//   * one block per (KV head, batch row); the G query heads of that KV head
//     share every K/V row a lane loads, so K/V is read once, not G times;
//   * each warp walks its own rows, kRows at a time, with every row's loads
//     issued before any of them is used (memory-level parallelism), lanes
//     on consecutive elements of a row (coalesced); int8 rows are
//     dequantised in registers with their bf16 scale;
//   * an fp32 online softmax per (warp, head), merged across warps in warp
//     order through shared memory at the end: no atomics, the same bits
//     every run. A warp that saw no row has max -inf and weight exactly 0
//     in the merge (the reference's exp(-inf - -inf) = 0 rule).
// It leaves: fewer than 132 blocks at B * KV < 132 (a split of the pages
// across blocks, flash-decoding, is later work), 4- or 1-byte loads per lane,
// no TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // warps per block, each walking its own rows
constexpr int kRows = 4;    // rows a warp loads before it uses them

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// E: elements of a row per lane (hd <= 32 * E); MAXG: query heads per KV
// head the registers hold (G <= MAXG).
template <typename T, int E, int MAXG>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ page_tables,
                    const int* __restrict__ cur_pos, float* __restrict__ out,
                    int KV, int G, int hd, int page_size, int max_pages,
                    int n_pages, float scale) {
  __shared__ float sm_m[kWarps][MAXG];
  __shared__ float sm_l[kWarps][MAXG];
  __shared__ float sm_acc[kWarps][MAXG][E * 32];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = KV * G;
  const long row_stride = static_cast<long>(KV) * hd;     // offset -> offset
  const long page_stride = row_stride * page_size;        // page -> page
  const int* table = page_tables + static_cast<long>(b) * max_pages;
  // slots 0..cur (inclusive) are valid, up to the table's span
  const int n_rows = min(cur_pos[b] + 1, max_pages * page_size);

  float qr[MAXG][E], acc[MAXG][E], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      qr[g][e] = (g < G && d < hd)
                     ? q[(static_cast<long>(b) * H + kvh * G + g) * hd + d]
                     : 0.f;
      acc[g][e] = 0.f;
    }
  }

  for (int base = warp * kRows; base < n_rows; base += kWarps * kRows) {
    float kf[kRows][E], vf[kRows][E];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int s = base + r;
#pragma unroll
      for (int e = 0; e < E; ++e) kf[r][e] = vf[r][e] = 0.f;
      if (s < n_rows) {
        const int phys = table[s / page_size];
        if (phys < 0 || phys >= n_pages) __trap();  // a corrupt page table
        const int off = s % page_size;
        const long row = phys * page_stride + off * row_stride +
                         static_cast<long>(kvh) * hd;
        float ks = 1.f, vs = 1.f;
        if (k_scale != nullptr) {
          const long si = (static_cast<long>(phys) * page_size + off) * KV + kvh;
          ks = __bfloat162float(k_scale[si]);
          vs = __bfloat162float(v_scale[si]);
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane + 32 * e;
          if (d < hd) {
            kf[r][e] = to_float(k_pages[row + d]) * ks;
            vf[r][e] = to_float(v_pages[row + d]) * vs;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (base + r >= n_rows) break;
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
    out[(static_cast<long>(b) * H + kvh * G + g) * hd + d] = A / fmaxf(L, 1e-30f);
  }
}

template <typename T, int E, int MAXG>
void launch_one(const float* q, const void* k, const void* v, const void* ks,
                const void* vs, const int* pt, const int* cur, float* out,
                int B, int KV, int G, int hd, int page_size, int max_pages,
                int n_pages, float scale, cudaStream_t stream) {
  const dim3 grid(KV, B);
  paged_decode_kernel<T, E, MAXG><<<grid, kWarps * 32, 0, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), pt, cur, out, KV, G, hd,
      page_size, max_pages, n_pages, scale);
}

template <typename T, int E>
int launch_e(const float* q, const void* k, const void* v, const void* ks,
             const void* vs, const int* pt, const int* cur, float* out, int B,
             int KV, int G, int hd, int page_size, int max_pages, int n_pages,
             float scale, cudaStream_t stream) {
#define PAGED_DECODE_LAUNCH(MAXG)                                             \
  launch_one<T, E, MAXG>(q, k, v, ks, vs, pt, cur, out, B, KV, G, hd,          \
                         page_size, max_pages, n_pages, scale, stream)
  if (G <= 1) {
    PAGED_DECODE_LAUNCH(1);
  } else if (G <= 2) {
    PAGED_DECODE_LAUNCH(2);
  } else if (G <= 4) {
    PAGED_DECODE_LAUNCH(4);
  } else {
    // MAXG * E <= 32 keeps the registers and the 32 KB merge buffer bounded
    if constexpr (E <= 4) {
      if (G > 8) return static_cast<int>(cudaErrorInvalidValue);
      PAGED_DECODE_LAUNCH(8);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef PAGED_DECODE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const float* q, const void* k, const void* v, const void* ks,
             const void* vs, const int* pt, const int* cur, float* out, int B,
             int KV, int G, int hd, int page_size, int max_pages, int n_pages,
             float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch_e<T, 1>(q, k, v, ks, vs, pt, cur, out, B, KV, G, hd,
                          page_size, max_pages, n_pages, scale, stream);
  if (hd <= 64)
    return launch_e<T, 2>(q, k, v, ks, vs, pt, cur, out, B, KV, G, hd,
                          page_size, max_pages, n_pages, scale, stream);
  if (hd <= 128)
    return launch_e<T, 4>(q, k, v, ks, vs, pt, cur, out, B, KV, G, hd,
                          page_size, max_pages, n_pages, scale, stream);
  if (hd <= 256)
    return launch_e<T, 8>(q, k, v, ks, vs, pt, cur, out, B, KV, G, hd,
                          page_size, max_pages, n_pages, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry point for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. `quant` = 1 for int8 arenas with bf16 scales, 0 for f32
// arenas (scales null). `n_pages` counts the arena's pages, null page
// included. Returns the CUDA error code of the launch (0 = success);
// cudaErrorInvalidValue for a geometry the kernel does not take
// (hd > 256, G > 8, or G > 4 with hd > 128).
extern "C" int paged_decode_launch(const float* q, const void* k_pages,
                                   const void* v_pages, const void* k_scale,
                                   const void* v_scale, const int* page_tables,
                                   const int* cur_pos, float* out, int B,
                                   int KV, int G, int hd, int page_size,
                                   int max_pages, int n_pages, float scale,
                                   int quant, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quant)
    return launch_t<int8_t>(q, k_pages, v_pages, k_scale, v_scale, page_tables,
                            cur_pos, out, B, KV, G, hd, page_size, max_pages,
                            n_pages, scale, s);
  return launch_t<float>(q, k_pages, v_pages, nullptr, nullptr, page_tables,
                         cur_pos, out, B, KV, G, hd, page_size, max_pages,
                         n_pages, scale, s);
}

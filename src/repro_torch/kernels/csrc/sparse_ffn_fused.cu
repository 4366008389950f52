// Fused segment-gather sparse FFN for Hopper (sm_90a).
//
// Replaces the TPU kernel `sparse_ffn_segments_fused_kernel`
// (src/repro/kernels/sparse_ffn.py, bodies `_kernel_fused` and
// `_kernel_fused_gated`), reached through `ops.sparse_ffn_segments_fused`.
//
//   y[B, D] = sum_s act(x . (W_up[seg_s] o sv_s)^T) [* x . (W_gate[seg_s] o sv_s)^T]
//                   . (W_down[seg_s] o sv_s)
//
// x is f32 [B, D]; W_* are [N, D] raw storage rows (f32 or int8); seg_ids
// int32 [S] names seg-row blocks of W (-1 = padding); scale_tiles f32
// [S, seg] is the per-neuron dequant scale x activated-union membership, so
// a 0 entry removes a neuron exactly (act(0) == 0 for every activation).
//
// What bounds it: at decode batch sizes (B <= 8) it is a weight stream. Each
// non-zero neuron row is read once per matrix, S*seg*D*n_mats*itemsize bytes
// when every row is live (33.5 MB for the full-cover opt-350m layer: S=32,
// seg=128, D=1024, f32, 2 mats; ~10 us at the H100 SXM's 3.35 TB/s), against
// 2*B flops per weight element, far below the card's ridge point.
//
// What the design does about it:
//   * pass 1 (one warp per gathered neuron row) streams the up (and gate)
//     rows with 16-byte loads (float4, or char4 for int8), dequantizes and
//     masks them in registers, and reduces x . w over D with warp shuffles.
//     Rows whose multiplier is 0, and padded segments, are never read: their
//     activation is exactly 0.
//   * pass 2 (one block per (128-column tile, segment)) streams the down
//     rows of one segment, again skipping zero-multiplier rows; the warps of
//     a block split the segment's rows and are reduced in a fixed order
//     through shared memory, giving a partial sum per segment.
//   * pass 3 adds the per-segment partials in segment order.
// No atomics anywhere: the result is deterministic run to run. The TPU
// kernel's sequential grid carried the sum across segments in VMEM; blocks
// on Hopper run in no order, hence the explicit partials. wgmma/TMA
// pipelining and a fused reduction are left for later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxB = 8;         // batch rows held in registers per pass
constexpr int kRowWarps = 8;     // pass 1: neuron rows (warps) per block
constexpr int kDownWarps = 8;    // pass 2: warps splitting a segment's rows
constexpr int kTile = 128;       // pass 2: output columns per block (32 lanes x 4)

enum Activation { kRelu = 0, kRelu2 = 1, kGelu = 2, kSilu = 3 };

__device__ __forceinline__ float activate(float p, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(p, 0.f);
    case kRelu2: {
      const float r = fmaxf(p, 0.f);
      return r * r;
    }
    case kGelu: {  // tanh approximation, the reference's jax.nn.gelu default
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * p * (1.f + tanhf(c * (p + 0.044715f * p * p * p)));
    }
    default:       // silu
      return p / (1.f + expf(-p));
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = __ldg(reinterpret_cast<const char4*>(p));
  return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w));
}

__device__ __forceinline__ float4 scale4(float4 w, float s) {
  return make_float4(w.x * s, w.y * s, w.z * s, w.w * s);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool live_segment(int id, int n_seg) {
  return id >= 0 && id < n_seg;
}

// Pass 1: act[s, b, j] = act(x_b . (W_up[row] * sv)) [* x_b . (W_gate[row] * sv)]
// for row = seg_ids[s] * seg + j. One warp per (s, j).
template <typename W, bool kGated>
__global__ void __launch_bounds__(kRowWarps * 32)
up_act_kernel(const float* __restrict__ x, const W* __restrict__ w_up,
              const W* __restrict__ w_gate, const int* __restrict__ seg_ids,
              const float* __restrict__ scale_tiles, float* __restrict__ act,
              int B, int D, int S, int seg, int n_seg, int activation) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowWarps + warp;     // row of the [S * seg] tile
  if (r >= S * seg) return;
  const int s = r / seg, j = r - s * seg;
  const int id = seg_ids[s];
  const float sv = scale_tiles[r];
  float* out = act + static_cast<size_t>(s) * B * seg + j;
  if (!live_segment(id, n_seg) || sv == 0.f) {
    for (int b = lane; b < B; b += 32) out[static_cast<size_t>(b) * seg] = 0.f;
    return;
  }
  const size_t row = (static_cast<size_t>(id) * seg + j) * D;
  const W* up = w_up + row;
  const W* gate = kGated ? w_gate + row : nullptr;
  for (int b0 = 0; b0 < B; b0 += kMaxB) {
    const int nb = min(kMaxB, B - b0);
    float acc_u[kMaxB], acc_g[kMaxB];
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) acc_u[i] = acc_g[i] = 0.f;
    for (int d = lane * 4; d < D; d += 128) {
      const float4 u = scale4(load4(up + d), sv);
      float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kGated) g = scale4(load4(gate + d), sv);
#pragma unroll
      for (int i = 0; i < kMaxB; ++i) {
        if (i < nb) {
          const float4 xv = load4(x + static_cast<size_t>(b0 + i) * D + d);
          acc_u[i] += dot4(xv, u);
          if (kGated) acc_g[i] += dot4(xv, g);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) {
      if (i < nb) {
        const float pre = warp_sum(acc_u[i]);
        float a = activate(pre, activation);
        if (kGated) a *= warp_sum(acc_g[i]);
        if (lane == 0) out[static_cast<size_t>(b0 + i) * seg] = a;
      }
    }
  }
}

// Pass 2: partial[s, b, c] = sum_j act[s, b, j] * W_down[row_j, c] * sv[s, j]
// for one 128-column tile (blockIdx.x) and one segment (blockIdx.y).
template <typename W>
__global__ void __launch_bounds__(kDownWarps * 32)
down_kernel(const W* __restrict__ w_down, const int* __restrict__ seg_ids,
            const float* __restrict__ scale_tiles, const float* __restrict__ act,
            float* __restrict__ partial, int B, int D, int seg, int n_seg) {
  __shared__ float4 red[kDownWarps][kMaxB][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.y;
  const int c = blockIdx.x * kTile + lane * 4;     // first of 4 columns
  const bool in_range = c < D;
  const int id = seg_ids[s];
  const bool live = live_segment(id, n_seg);
  const float* a = act + static_cast<size_t>(s) * B * seg;
  float* p = partial + static_cast<size_t>(s) * B * D;
  const int rows_per_warp = (seg + kDownWarps - 1) / kDownWarps;
  const int j0 = warp * rows_per_warp, j1 = min(seg, j0 + rows_per_warp);
  for (int b0 = 0; b0 < B; b0 += kMaxB) {
    const int nb = min(kMaxB, B - b0);
    float4 acc[kMaxB];
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live && in_range) {
      for (int j = j0; j < j1; ++j) {
        const float sv = scale_tiles[s * seg + j];
        if (sv == 0.f) continue;
        const float4 w = scale4(
            load4(w_down + (static_cast<size_t>(id) * seg + j) * D + c), sv);
#pragma unroll
        for (int i = 0; i < kMaxB; ++i) {
          if (i < nb) {
            const float av = a[static_cast<size_t>(b0 + i) * seg + j];
            acc[i].x += av * w.x;
            acc[i].y += av * w.y;
            acc[i].z += av * w.z;
            acc[i].w += av * w.w;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) red[warp][i][lane] = acc[i];
    __syncthreads();
    // fixed-order reduction over the warps: thread (i, lane) sums one float4
    for (int t = threadIdx.x; t < nb * 32; t += blockDim.x) {
      const int i = t / 32, l = t - i * 32;
      float4 sum = red[0][i][l];
      for (int w = 1; w < kDownWarps; ++w) {
        const float4 v = red[w][i][l];
        sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
      }
      const int col = blockIdx.x * kTile + l * 4;
      if (col < D)
        *reinterpret_cast<float4*>(p + static_cast<size_t>(b0 + i) * D + col) = sum;
    }
    __syncthreads();
  }
}

// Pass 3: out[b, c] = sum_s partial[s, b, c], segments in order.
__global__ void sum_segments_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int S, int BD) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= BD) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += partial[static_cast<size_t>(s) * BD + t];
  out[t] = acc;
}

template <typename W>
int launch(const float* x, const void* w_up, const void* w_gate,
           const void* w_down, const int* seg_ids, const float* scale_tiles,
           float* act, float* partial, float* out, int B, int D, int N, int S,
           int seg, int activation, cudaStream_t stream) {
  const int n_seg = N / seg;
  const int rows = S * seg;
  const dim3 grid1((rows + kRowWarps - 1) / kRowWarps);
  if (w_gate != nullptr) {
    up_act_kernel<W, true><<<grid1, kRowWarps * 32, 0, stream>>>(
        x, static_cast<const W*>(w_up), static_cast<const W*>(w_gate), seg_ids,
        scale_tiles, act, B, D, S, seg, n_seg, activation);
  } else {
    up_act_kernel<W, false><<<grid1, kRowWarps * 32, 0, stream>>>(
        x, static_cast<const W*>(w_up), nullptr, seg_ids, scale_tiles, act, B,
        D, S, seg, n_seg, activation);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((D + kTile - 1) / kTile, S);
  down_kernel<W><<<grid2, kDownWarps * 32, 0, stream>>>(
      static_cast<const W*>(w_down), seg_ids, scale_tiles, act, partial, B, D,
      seg, n_seg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int BD = B * D;
  sum_segments_kernel<<<(BD + 255) / 256, 256, 0, stream>>>(partial, out, S, BD);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (loaded with ctypes). Pointers are device pointers; `act`
// ([S, B, seg] f32) and `partial` ([S, B, D] f32) are caller-allocated
// scratch. Preconditions checked by the Python wrapper: D % 4 == 0,
// N % seg == 0, S >= 1, 16-byte aligned rows. Segment ids outside
// [0, N / seg) are treated as padding (never read). Returns the CUDA error
// code of the launches (0 = success).
extern "C" int sparse_ffn_segments_fused_launch(
    const float* x, const void* w_up, const void* w_gate, const void* w_down,
    const int* seg_ids, const float* scale_tiles, float* act, float* partial,
    float* out, int B, int D, int N, int S, int seg, int int8_weights,
    int activation, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8_weights)
    return launch<int8_t>(x, w_up, w_gate, w_down, seg_ids, scale_tiles, act,
                          partial, out, B, D, N, S, seg, activation, st);
  return launch<float>(x, w_up, w_gate, w_down, seg_ids, scale_tiles, act,
                       partial, out, B, D, N, S, seg, activation, st);
}

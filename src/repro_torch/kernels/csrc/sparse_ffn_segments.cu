// Segment-gather sparse FFN (float weights, no scales) for Hopper (sm_90a).
//
// Replaces the TPU kernel `sparse_ffn_segments_kernel`
// (src/repro/kernels/sparse_ffn.py:173, bodies `_kernel` :67 and
// `_kernel_gated` :81), reached through `ops.sparse_ffn_segments`.
//
//   y[B, D] = sum_s act(x . W_up[seg_s]^T) [* x . W_gate[seg_s]^T] . W_down[seg_s]
//
// x is f32 [B, D]; W_* are [N, D] operands of f32 or bf16 given by element
// strides (sn, sd), so a transposed view of a [D, N] weight is read in place;
// seg_ids int32 [S] names blocks of `seg` neurons (a negative id is the
// zero padding segment and contributes 0; a repeated id counts twice).
//
// What bounds it: at decode batch sizes it is a weight stream. Each gathered
// neuron's row is read once per matrix: S*seg*D*n_mats*itemsize bytes (4.2
// MB at the serve_sparse opt-350m shape S=4, seg=128, D=1024, f32, 2 mats:
// 1.3 us at the H100 SXM's 3.35 TB/s), against 2*B flops per weight
// element, far below the card's ridge point. At that size the four launches
// cost more than the bytes.
//
// What the design does about it:
//   * every weight tile goes through shared memory, loaded with the lanes on
//     whichever of the operand's two axes has the smaller stride, so both
//     the model's [d, f] up/gate weights seen as [f, d] views and its [f, d]
//     down weight are read coalesced, with no per-step copy or transpose;
//     the tiles are padded so the transposed reads hit distinct banks;
//   * pass 1 (one block per (32 gathered neurons, 256 columns of D, matrix))
//     issues its whole 32 KB tile's loads before using any of them and
//     writes a partial dot product per column chunk; pass 2 sums the chunks
//     in order and applies the activation (and gate); pass 3 (one block per
//     (32 output columns, segment)) streams the down rows of one segment and
//     pass 4 adds the per-segment partials in segment order.
// No atomics: the result is deterministic run to run. The TPU kernel's
// sequential grid carried the output in VMEM from segment to segment;
// blocks on Hopper run in no order, hence the explicit partials. wgmma,
// cp.async/TMA pipelining and fewer launches are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 8;     // batch rows held in registers per pass
constexpr int kNT = 32;      // pass 1: gathered neurons per block
constexpr int kDC = 256;     // pass 1: columns of D per block
constexpr int kJ = 128;      // pass 3: neurons per shared-memory tile
constexpr int kCT = 32;      // pass 3: output columns per block
static_assert(kMaxB * kDC == kWarps * kMaxB * kNT,
              "pass 1 reuses the x buffer for its cross-warp reduction");

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The physical neuron id * seg + j of segment slot s; a negative id is
// padding (-1 returned), an id past the weight's segments a caller bug.
__device__ __forceinline__ int segment_id(const int* seg_ids, int s, int n_seg) {
  const int id = seg_ids[s];
  if (id >= n_seg) __trap();
  return id < 0 ? -1 : id;
}

// Pass 1: part[mat, dc, b, k] = sum_{d in chunk dc} x[b, d] * W_mat[n_k, d]
// for the 32 gathered neurons k of block x. mat 0 = up, 1 = gate.
template <typename W>
__global__ void __launch_bounds__(kThreads)
seg_up_partial_kernel(const float* __restrict__ x, const W* __restrict__ w_up,
                      const W* __restrict__ w_gate,
                      const int* __restrict__ seg_ids, float* __restrict__ part,
                      int B, int D, int seg, int n_seg, int SK, long long sn_up,
                      long long sd_up, long long sn_gate, long long sd_gate) {
  __shared__ float tile[kNT][kDC + 1];
  __shared__ float xs[kMaxB * kDC];          // x chunk, then the reduction
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kNT;           // first gathered neuron
  const int dc = blockIdx.y, n_dc = gridDim.y, mat = blockIdx.z;
  const int d0 = dc * kDC;
  const int s = k0 / seg;
  const int id = segment_id(seg_ids, s, n_seg);
  if (id < 0) return;                        // padding: pass 2 never reads it
  const W* w = mat == 0 ? w_up : w_gate;
  const long long sn = mat == 0 ? sn_up : sn_gate;
  const long long sd = mat == 0 ? sd_up : sd_gate;
  const long long n0 = static_cast<long long>(id) * seg + (k0 - s * seg);
  const bool n_fast = sn < sd;               // lanes along the unit-stride axis

  constexpr int kPer = kNT * kDC / kThreads;
  float buf[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + kThreads * i;
    const int j = n_fast ? e % kNT : e / kDC;
    const int dd = n_fast ? e / kNT : e % kDC;
    buf[i] = d0 + dd < D ? to_float(w[(n0 + j) * sn + static_cast<long long>(d0 + dd) * sd])
                         : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + kThreads * i;
    const int j = n_fast ? e % kNT : e / kDC;
    const int dd = n_fast ? e / kNT : e % kDC;
    tile[j][dd] = buf[i];
  }

  for (int b0 = 0; b0 < B; b0 += kMaxB) {
    const int nb = min(kMaxB, B - b0);
    __syncthreads();                         // tile stored; xs free
    for (int t = threadIdx.x; t < kMaxB * kDC; t += kThreads) {
      const int b = t / kDC, dd = t % kDC;
      xs[t] = (b < nb && d0 + dd < D)
                  ? x[static_cast<long long>(b0 + b) * D + d0 + dd] : 0.f;
    }
    __syncthreads();
    float acc[kMaxB];
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) acc[b] = 0.f;
#pragma unroll 8
    for (int i = 0; i < 32; ++i) {           // warp w takes columns w*32..+31
      const int dd = warp * 32 + i;
      const float t = tile[lane][dd];
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) acc[b] += xs[b * kDC + dd] * t;
    }
    __syncthreads();                         // done reading xs
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) xs[(warp * kMaxB + b) * kNT + lane] = acc[b];
    __syncthreads();
    if (threadIdx.x < nb * kNT) {            // fixed-order sum over the warps
      const int b = threadIdx.x / kNT, j = threadIdx.x % kNT;
      float sum = 0.f;
      for (int v = 0; v < kWarps; ++v) sum += xs[(v * kMaxB + b) * kNT + j];
      part[((static_cast<long long>(mat) * n_dc + dc) * B + b0 + b) * SK + k0 + j] = sum;
    }
  }
}

// Pass 2: act[b, k] = act(sum_dc part[0, dc, b, k]) [* sum_dc part[1, dc, b, k]].
__global__ void seg_act_kernel(const float* __restrict__ part,
                               const int* __restrict__ seg_ids,
                               float* __restrict__ act, int B, int seg,
                               int n_seg, int SK, int n_dc, int gated,
                               int activation) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(B) * SK) return;
  const int b = static_cast<int>(t / SK), k = static_cast<int>(t % SK);
  if (segment_id(seg_ids, k / seg, n_seg) < 0) {
    act[t] = 0.f;
    return;
  }
  const long long mat_stride = static_cast<long long>(n_dc) * B * SK;
  float pre = 0.f, gate = 0.f;
  for (int dc = 0; dc < n_dc; ++dc) {
    const long long i = (static_cast<long long>(dc) * B + b) * SK + k;
    pre += part[i];
    if (gated) gate += part[mat_stride + i];
  }
  float a = activate(pre, activation);
  if (gated) a *= gate;
  act[t] = a;
}

// Pass 3: pout[s, b, c] = sum_j act[b, s*seg + j] * W_down[id*seg + j, c]
// for one 32-column tile (block x) and one segment (block y).
template <typename W>
__global__ void __launch_bounds__(kThreads)
seg_down_kernel(const W* __restrict__ w_down, const int* __restrict__ seg_ids,
                const float* __restrict__ act, float* __restrict__ pout, int B,
                int D, int seg, int n_seg, int SK, long long sn, long long sd) {
  __shared__ float tile[kJ][kCT + 1];
  __shared__ float as[kMaxB][kJ];
  __shared__ float red[kWarps][kMaxB][kCT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kCT, s = blockIdx.y;
  const int id = segment_id(seg_ids, s, n_seg);
  const bool c_fast = sd < sn;
  constexpr int kPer = kJ * kCT / kThreads;
  constexpr int kRowsPerWarp = kJ / kWarps;
  for (int b0 = 0; b0 < B; b0 += kMaxB) {
    const int nb = min(kMaxB, B - b0);
    float acc[kMaxB];
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) acc[b] = 0.f;
    for (int j0 = 0; id >= 0 && j0 < seg; j0 += kJ) {
      const int jn = min(kJ, seg - j0);
      const long long n0 = static_cast<long long>(id) * seg + j0;
      float buf[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = threadIdx.x + kThreads * i;
        const int cc = c_fast ? e % kCT : e / kJ;
        const int jj = c_fast ? e / kCT : e % kJ;
        buf[i] = (jj < jn && c0 + cc < D)
                     ? to_float(w_down[(n0 + jj) * sn + static_cast<long long>(c0 + cc) * sd])
                     : 0.f;
      }
      __syncthreads();                       // the previous tile is consumed
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = threadIdx.x + kThreads * i;
        const int cc = c_fast ? e % kCT : e / kJ;
        const int jj = c_fast ? e / kCT : e % kJ;
        tile[jj][cc] = buf[i];
      }
      for (int t = threadIdx.x; t < kMaxB * kJ; t += kThreads) {
        const int b = t / kJ, jj = t % kJ;
        as[b][jj] = (b < nb && jj < jn)
                        ? act[static_cast<long long>(b0 + b) * SK + s * seg + j0 + jj]
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kRowsPerWarp; ++i) {   // warp w takes rows w*16..+15
        const int jj = warp * kRowsPerWarp + i;
        const float t = tile[jj][lane];
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) acc[b] += as[b][jj] * t;
      }
    }
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) red[warp][b][lane] = acc[b];
    __syncthreads();
    if (threadIdx.x < nb * kCT) {            // fixed-order sum over the warps
      const int b = threadIdx.x / kCT, cc = threadIdx.x % kCT;
      float sum = 0.f;
      for (int v = 0; v < kWarps; ++v) sum += red[v][b][cc];
      if (c0 + cc < D)
        pout[(static_cast<long long>(s) * B + b0 + b) * D + c0 + cc] = sum;
    }
    __syncthreads();                         // red and the tiles are free
  }
}

// Pass 4: out[b, c] = sum_s pout[s, b, c], segments in order.
__global__ void seg_sum_kernel(const float* __restrict__ pout,
                               float* __restrict__ out, int S, int BD) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= BD) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += pout[static_cast<long long>(s) * BD + t];
  out[t] = acc;
}

struct Args {
  const float* x;
  const void* w_up;
  const void* w_gate;
  const void* w_down;
  const int* seg_ids;
  float* part;
  float* act;
  float* pout;
  float* out;
  int B, D, N, S, seg;
  long long sn_up, sd_up, sn_gate, sd_gate, sn_down, sd_down;
  int activation;
  cudaStream_t stream;
};

template <typename W>
int launch(const Args& a) {
  const int n_seg = a.N / a.seg;
  const int SK = a.S * a.seg;
  const int n_dc = (a.D + kDC - 1) / kDC;
  const int gated = a.w_gate != nullptr;
  const dim3 grid1(SK / kNT, n_dc, 1 + gated);
  seg_up_partial_kernel<W><<<grid1, kThreads, 0, a.stream>>>(
      a.x, static_cast<const W*>(a.w_up), static_cast<const W*>(a.w_gate),
      a.seg_ids, a.part, a.B, a.D, a.seg, n_seg, SK, a.sn_up, a.sd_up,
      a.sn_gate, a.sd_gate);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_act = static_cast<long long>(a.B) * SK;
  seg_act_kernel<<<static_cast<unsigned>((n_act + 255) / 256), 256, 0, a.stream>>>(
      a.part, a.seg_ids, a.act, a.B, a.seg, n_seg, SK, n_dc, gated,
      a.activation);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid3((a.D + kCT - 1) / kCT, a.S);
  seg_down_kernel<W><<<grid3, kThreads, 0, a.stream>>>(
      static_cast<const W*>(a.w_down), a.seg_ids, a.act, a.pout, a.B, a.D,
      a.seg, n_seg, SK, a.sn_down, a.sd_down);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int BD = a.B * a.D;
  seg_sum_kernel<<<(BD + 255) / 256, 256, 0, a.stream>>>(a.pout, a.out,
                                                               a.S, BD);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (loaded with ctypes). Pointers are device pointers; `part`
// (f32 [1 + gated, ceil(D / 256), B, S * seg]), `act` (f32 [B, S * seg])
// and `pout` (f32 [S, B, D]) are caller-allocated scratch. Each weight is
// an [N, D] operand given by its element strides (sn, sd); w_gate may be
// null. `dtype` 0 = float32, 1 = bfloat16 weights. Preconditions checked by
// the Python wrapper: seg % 32 == 0, N % seg == 0, S >= 1, B >= 1. A
// segment id >= N / seg traps. Returns the CUDA error code of the launches
// (0 = success); cudaErrorInvalidValue for an unknown dtype.
extern "C" int sparse_ffn_segments_launch(
    const float* x, const void* w_up, const void* w_gate, const void* w_down,
    const int* seg_ids, float* part, float* act, float* pout, float* out,
    int B, int D, int N, int S, int seg, long long sn_up, long long sd_up,
    long long sn_gate, long long sd_gate, long long sn_down,
    long long sd_down, int dtype, int activation, void* stream) {
  const Args a{x,       w_up,    w_gate,  w_down,  seg_ids, part,
               act,     pout,    out,     B,       D,       N,
               S,       seg,     sn_up,   sd_up,   sn_gate, sd_gate,
               sn_down, sd_down, activation, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch<float>(a);
  if (dtype == 1) return launch<__nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

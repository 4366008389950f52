// Co-activation counts A = M^T M for Hopper (sm_90a), exact.
//
// Replaces the TPU kernel `coact_accumulate_kernel`
// (src/repro/kernels/coact.py:39), reached through `ops.coact_accumulate`:
// the offline pattern-extraction hot spot (paper section 4.1, Eq. 2).
//   masks  u8  [T, N]  activation mask of T tokens over N neurons (bool
//                      masks are passed as their 0/1 bytes), row-major
//   out    f32 [N, N]  out[i, j] = sum_t masks[t, i] * masks[t, j]
//
// Exactness is the contract: the products run on the tensor cores in
// unsigned 8-bit integers with 32-bit integer sums (mma.sync m16n8k32
// u8 x u8 -> s32), and each sum is converted to float once, at the end.
// For 0/1 masks every entry is a count <= T, so the result is exact, and
// equal to a float32 product, for T < 2^24; the wrapper refuses larger T.
//
// What bounds it: at the offline stage's shape (T = 512 tokens,
// N = 4096 neurons) bytes -- the 67 MB float32 output dwarfs the 2 MB of
// masks, 0.021 ms at 3.35 TB/s against 0.009 ms of int8 tensor work at
// 1,979 TOPS. At T = 4096, N = 14336 (mistral-7b-relu's d_ff) operations:
// 2 * N^2 * T = 1.68e12, 0.85 ms.
//
// What the design does about it:
//   * pass 1 (`coact_transpose_kernel`) copies the masks once into a
//     scratch Mt [Np, Tp] (neuron-major, tokens contiguous, zero-padded to
//     Np = 128-multiple neurons and Tp = 64-multiple tokens). Both operands
//     of M^T M then read 4 consecutive tokens of one neuron as one 32-bit
//     word, which is exactly an mma.sync u8 fragment register, and the
//     ragged edges of T and N are zeros that add nothing (the TPU wrapper
//     pads the same way, to 256);
//   * pass 2 (`coact_mma_kernel`): one block of 4 warps per 128 x 128 output
//     tile, each warp a 64 x 64 sub-tile (4 x 8 m16n8k32 products per 32
//     tokens, 128 int32 accumulators a lane). Tiles of 64 tokens of both
//     operands are staged in shared memory with rows padded to 80 bytes,
//     so the fragment loads of a warp hit 32 different banks;
//   * the epilogue converts each int32 sum to float and writes it straight
//     to the output (a quad of lanes writes 32 contiguous bytes); the whole
//     matrix is written once, diagonal and both triangles, as the TPU
//     kernel does.
// It leaves: no pipelining of the shared-memory tiles (cp.async / TMA),
// mma.sync instead of wgmma, and both triangles computed (symmetry would
// halve the products and the reads).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;         // output tile edge (neurons) per block
constexpr int kWarpTile = 64;      // output sub-tile edge per warp
constexpr int kChunk = 64;         // tokens staged in shared memory per step
constexpr int kRowBytes = kChunk + 16;   // padded shared-memory row
constexpr int kThreads = 128;      // 4 warps, 2 x 2 over the block tile
constexpr int kPad = 64;           // transpose tile edge (bytes)

// masks [T, N] -> mt [Np, Tp], mt[n, t] = masks[t, n], zero outside T x N.
__global__ void __launch_bounds__(256)
coact_transpose_kernel(const uint8_t* __restrict__ masks,
                       uint8_t* __restrict__ mt, int T, int N, int Tp) {
  __shared__ uint8_t tile[kPad][kPad + 4];
  const int t0 = blockIdx.y * kPad;
  const int n0 = blockIdx.x * kPad;
  for (int idx = threadIdx.x; idx < kPad * kPad; idx += blockDim.x) {
    const int r = idx / kPad, c = idx % kPad;   // r: token, c: neuron
    const int t = t0 + r, n = n0 + c;
    tile[r][c] = (t < T && n < N) ? masks[(size_t)t * N + n] : 0;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kPad * kPad; idx += blockDim.x) {
    const int r = idx / kPad, c = idx % kPad;   // r: neuron, c: token
    mt[(size_t)(n0 + r) * Tp + t0 + c] = tile[c][r];
  }
}

__device__ __forceinline__ void mma_u8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// out[i, j] = sum_t mt[i, t] * mt[j, t] over the block's 128 x 128 tile.
__global__ void __launch_bounds__(kThreads)
coact_mma_kernel(const uint8_t* __restrict__ mt, float* __restrict__ out,
                 int N, int Tp) {
  __shared__ __align__(16) uint8_t sa[kTile * kRowBytes];   // rows i
  __shared__ __align__(16) uint8_t sb[kTile * kRowBytes];   // rows j
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wi = (warp / 2) * kWarpTile, wj = (warp % 2) * kWarpTile;
  const int g = lane / 4, q = lane % 4;   // mma groupID, thread in group

  int acc[4][8][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][n][r] = 0;

  for (int k0 = 0; k0 < Tp; k0 += kChunk) {
    __syncthreads();   // the previous chunk's fragments are all read
    // 128 rows x 64 bytes per operand = 512 16-byte pieces each
    for (int idx = threadIdx.x; idx < kTile * (kChunk / 16); idx += kThreads) {
      const int r = idx / (kChunk / 16), piece = idx % (kChunk / 16);
      const size_t off = (size_t)k0 + piece * 16;
      *reinterpret_cast<uint4*>(sa + r * kRowBytes + piece * 16) =
          *reinterpret_cast<const uint4*>(mt + (size_t)(i0 + r) * Tp + off);
      *reinterpret_cast<uint4*>(sb + r * kRowBytes + piece * 16) =
          *reinterpret_cast<const uint4*>(mt + (size_t)(j0 + r) * Tp + off);
    }
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < kChunk; kb += 32) {
      uint32_t a[4][4], b[8][2];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint8_t* row = sa + (wi + m * 16 + g) * kRowBytes + kb + q * 4;
        a[m][0] = lds32(row);                       // row g,     k 0..15
        a[m][1] = lds32(row + 8 * kRowBytes);       // row g + 8, k 0..15
        a[m][2] = lds32(row + 16);                  // row g,     k 16..31
        a[m][3] = lds32(row + 8 * kRowBytes + 16);  // row g + 8, k 16..31
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint8_t* col = sb + (wj + n * 8 + g) * kRowBytes + kb + q * 4;
        b[n][0] = lds32(col);         // k 0..15 of column g
        b[n][1] = lds32(col + 16);    // k 16..31
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) mma_u8(acc[m][n], a[m], b[n][0], b[n][1]);
    }
  }

  // c0, c1: row g, columns 2q, 2q + 1; c2, c3: row g + 8, the same columns
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + wi + m * 16 + g + h * 8;
      if (i >= N) continue;
      float* orow = out + (size_t)i * N;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int j = j0 + wj + n * 8 + q * 2;
        const float v0 = static_cast<float>(acc[m][n][2 * h]);
        const float v1 = static_cast<float>(acc[m][n][2 * h + 1]);
        if (pairs && j + 1 < N) {
          *reinterpret_cast<float2*>(orow + j) = make_float2(v0, v1);
        } else {
          if (j < N) orow[j] = v0;
          if (j + 1 < N) orow[j + 1] = v1;
        }
      }
    }
  }
}

}  // namespace

// C entry point for ctypes. `masks` (u8 [T, N]), `scratch` (u8 [Np, Tp],
// Np = N rounded up to 128, Tp = T rounded up to 64) and `out` (f32 [N, N])
// are device pointers; `stream` is a cudaStream_t. Launches the transpose,
// then the product, on the stream. Returns the CUDA error code of the
// launches (0 = success); cudaErrorInvalidValue for a padding the kernels
// do not take.
extern "C" int coact_launch(const uint8_t* masks, uint8_t* scratch, float* out,
                            int T, int N, int Tp, int Np, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || N <= 0 || Tp % kChunk != 0 || Np % kTile != 0 || Tp < T ||
      Np < N)
    return static_cast<int>(cudaErrorInvalidValue);
  coact_transpose_kernel<<<dim3(Np / kPad, Tp / kPad), 256, 0, s>>>(
      masks, scratch, T, N, Tp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  coact_mma_kernel<<<dim3(Np / kTile, Np / kTile), kThreads, 0, s>>>(
      scratch, out, N, Tp);
  return static_cast<int>(cudaGetLastError());
}

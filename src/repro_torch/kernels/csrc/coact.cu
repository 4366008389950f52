// Co-activation counts A = M^T M (or A += M^T M) for Hopper (sm_90a), exact.
//
// Replaces the TPU kernel `coact_accumulate_kernel`
// (src/repro/kernels/coact.py:29, `pl.pallas_call` at :39), reached through
// `ops.coact_accumulate`: the offline pattern-extraction hot spot (paper
// section 4.1, Eq. 2).
//   masks  u8  [T, N]  activation mask of T tokens over N neurons (bool
//                      masks are passed as their 0/1 bytes), row-major
//   out    f32 [N, N]  out[i, j] = sum_t masks[t, i] * masks[t, j], or, in
//                      accumulate mode, out[i, j] += that sum
//
// Exactness is the contract: the products run on the tensor cores in
// unsigned 8-bit integers with 32-bit integer sums (wgmma u8 x u8 -> s32),
// and each sum is converted to float once, at the end. For 0/1 masks every
// entry is a count <= T, so the result is exact, and equal to a float32
// product, for T < 2^24; the wrapper refuses larger T, and byte values whose
// int32 sums could pass 2^31 - 1 (T * max^2, from T = 33,026 at 255). In
// accumulate mode the copy engine adds the float tile into `out` (one
// round-to-nearest float add an entry, as `out += fresh`); every entry is
// touched once a launch, so no two adds race and the bits are those of the
// separate `+=`.
//
// What bounds it (H100 SXM: 3.35 TB/s, 1,979 int8 TOPS dense): the least
// work is the triangle's products, N (N + 1) T operations, and the bytes
// T N of masks read plus 4 N^2 of output written (8 N^2 read and written in
// accumulate mode). At the offline stage's shape (T = 512 tokens,
// N = 4096 neurons) bytes: 69 MB, 0.0207 ms (accumulate 136 MB, 0.0407 ms)
// against 0.0043 ms of products. At T = 4096, N = 14336 (mistral-7b-relu's
// d_ff) operations: 8.4e11, 0.425 ms (bytes 0.263 ms).
//
// What the design does about it:
//   * pass 1 (`coact_transpose_kernel`) copies the masks once into a
//     scratch Mt [Np, Tp] (neuron-major, tokens contiguous, zero-padded to
//     Np = 128-multiple neurons and Tp = 128-multiple tokens), 32-bit words
//     in and out: both operands of M^T M are then K-major, the only layout
//     wgmma takes for 8-bit types, and the ragged edges of T and N are zeros
//     that add nothing (2 MB each way at the offline shape);
//   * pass 2 (`coact_wgmma_kernel`): a persistent grid, one block an SM,
//     walks the 128 x 128 output tiles with i0 <= j0 only (528 of 1,024 at
//     N = 4096: half the products and mask reads), in super-tiles of 8 x 8
//     tiles so that the tiles in flight at once share their row and column
//     panels in L2. A producer thread has the copy engine (TMA) bring
//     128-token boxes of both operands' rows (one box on a diagonal tile,
//     whose two operands are the same rows) through a 3-slot mbarrier ring,
//     128-byte swizzled; two consumer warpgroups each multiply 64 rows by the
//     128 columns (wgmma m64n128k32 u8, both operands from shared memory, 64
//     int32 accumulators a thread) with one wgmma group in flight while the
//     slot of the one before is handed back;
//   * the epilogue converts each sum to float and stages each warpgroup's
//     64 x 128 half in shared memory twice, as itself and transposed (the
//     mirror tile at (j0, i0); diagonal tiles once), 128-byte swizzled so
//     that neither staging write conflicts on banks, and one thread hands the
//     boxes to the copy engine (`cp.async.bulk.tensor` store, or
//     `cp.reduce.async.bulk.tensor ... add.f32` in accumulate mode), which
//     clips the ragged edge of N. The stores drain while the warpgroup
//     multiplies its next tile; it waits for them to have read the staging
//     only before it stages again. The whole N x N matrix is written, as the
//     TPU kernel writes it;
//   * N % 4 != 0 (a row pitch the copy engine cannot take) or an output not
//     16-byte aligned: the same kernel's threads store (or add) each entry
//     and its mirror from registers.
// What holds it back (PERF.md, section 6, on the H100): at the offline
// shape the stores (the product pass without its loads takes 0.026 ms
// against 0.0207) and beside them the operand rows each tile loads from L2,
// 256 bytes a token for 128 x 128 outputs (67 MB beside the 67 MB stored);
// at the mistral shape the product pipeline itself (0.81 ms without loads)
// and the same loads (6.6 GB).
// Tried and not kept (slower, or no faster, at every shape): clusters of 2
// or 4 blocks sharing a tile row's A rows by multicast (the shared ring
// steps the blocks together, so one block's epilogue stalls the others'
// loads); items of two tiles side by side, a warpgroup a tile (a 2-slot
// ring of 48 KB stages leaves one stage of loads in flight); a transpose of
// 16-byte pieces (faster at the mistral shape only, by 1% of its time).
// It leaves: a deeper ring beside the 128 KB of staging (smaller stages, or
// stores from registers), and the transpose pass as a separate launch.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;          // output tile edge (neurons)
constexpr int kK = 128;             // tokens (bytes) of a ring stage
constexpr int kStages = 3;          // ring slots
constexpr int kConsumers = 2;       // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);   // + the producer's group
constexpr int kGroup = 8;           // super-tile edge, in tiles (walk order)
constexpr int kOpBytes = kTile * kK;               // one operand's stage
constexpr int kRingBytes = kStages * 2 * kOpBytes;  // 96 KB
constexpr int kHalfBytes = 64 * kTile * 4;          // a warpgroup's f32 half
constexpr int kDirBox = 64 * 32 * 4;    // direct box: 64 rows x 32 columns
constexpr int kMirBox = 128 * 32 * 4;   // mirror box: 128 rows x 32 columns
constexpr int kSmemBytes =
    1024 + kRingBytes + kConsumers * 2 * kHalfBytes + 2 * kStages * 8;
constexpr int kPad = 64;            // transpose tile edge (bytes)
constexpr int kMaxDevices = 64;

// masks [T, N] -> mt [Np, Tp], mt[n, t] = masks[t, n], zero outside T x N.
// A block transposes 64 tokens x 64 neurons in 32-bit words: it reads 4
// neurons of a token a word (`vec`: N % 4 == 0 and the masks 4-byte
// aligned; else byte by byte), and each thread turns a 4 x 4 block of bytes
// (4 tokens x 4 neurons) around with byte permutes and writes 4 tokens of a
// neuron a word.
__global__ void __launch_bounds__(256)
coact_transpose_kernel(const uint8_t* __restrict__ masks,
                       uint8_t* __restrict__ mt, int T, int N, int Tp,
                       int vec) {
  __shared__ uint32_t tile[kPad][kPad / 4 + 1];   // [token][neuron word]
  const int t0 = blockIdx.y * kPad;
  const int n0 = blockIdx.x * kPad;
  for (int idx = threadIdx.x; idx < kPad * kPad / 4; idx += blockDim.x) {
    const int r = idx / (kPad / 4), c = idx % (kPad / 4);  // token, word
    const int t = t0 + r, n = n0 + 4 * c;
    uint32_t v = 0;
    if (t < T) {
      const uint8_t* row = masks + (size_t)t * N;
      if (vec && n < N) {
        v = *reinterpret_cast<const uint32_t*>(row + n);
      } else {
        for (int k = 0; k < 4; ++k)
          if (n + k < N) v |= static_cast<uint32_t>(row[n + k]) << (8 * k);
      }
    }
    tile[r][c] = v;
  }
  __syncthreads();
  const int w = threadIdx.x % (kPad / 4);   // tokens 4w .. 4w + 3
  const int c = threadIdx.x / (kPad / 4);   // neurons 4c .. 4c + 3
  const uint32_t a = tile[4 * w][c], b = tile[4 * w + 1][c];
  const uint32_t d = tile[4 * w + 2][c], e = tile[4 * w + 3][c];
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140);   // a0 b0 a1 b1
  const uint32_t ab_hi = __byte_perm(a, b, 0x7362);   // a2 b2 a3 b3
  const uint32_t de_lo = __byte_perm(d, e, 0x5140);
  const uint32_t de_hi = __byte_perm(d, e, 0x7362);
  const uint32_t out[4] = {__byte_perm(ab_lo, de_lo, 0x5410),   // neuron 0
                           __byte_perm(ab_lo, de_lo, 0x7632),   // neuron 1
                           __byte_perm(ab_hi, de_hi, 0x5410),
                           __byte_perm(ab_hi, de_hi, 0x7632)};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<uint32_t*>(mt + (size_t)(n0 + 4 * c + k) * Tp + t0 +
                                 4 * w) = out[k];
}

struct Params {
  CUtensorMap mt_map;    // Mt [Np, Tp] u8: boxes of 128 tokens x 128 rows
  CUtensorMap dir_map;   // out [N, N] f32: boxes of 32 columns x 64 rows
  CUtensorMap mir_map;   // out [N, N] f32: boxes of 32 columns x 128 rows
  float* out;
  int N;
  int kstages;           // Tp / kK
  int nt;                // Np / kTile
  int n_tiles;           // nt (nt + 1) / 2
  int tma_out;           // 1: the copy engine stores; 0: the threads
  int accumulate;        // 1: out += M^T M
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}
// Spin until the barrier's phase of `parity` completes; a copy that never
// lands traps after about 10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
// the box of `map` at (c0, c1) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar)) : "memory");
}
// the box in shared memory to `map` at (c0, c1): stored, or added (f32)
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             bool add) {
  if (add)
    asm volatile(
        "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group"
        " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_addr(src)), "r"(c0), "r"(c1) : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
        " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_addr(src)), "r"(c0), "r"(c1) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// orders this thread's shared-memory writes before the copy engine's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma shared-memory descriptor of a K-major operand whose rows are 128
// bytes, 128-byte swizzled in 1024-byte groups of 8 rows (as the copy
// engine lays out a box of 128-byte rows with SWIZZLE_128B)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |            // leading (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |    // 8-row group stride
         (static_cast<uint64_t>(1) << 62);             // 128-byte swizzle
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d[64 x 128] (+)= a[64 x 32] . b[128 x 32]^T, u8 operands, s32 sums
__device__ __forceinline__ void wgmma_u8(int (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Tile t of the walk -> (bi, bj), bi <= bj: super-tiles of kGroup x kGroup
// tiles (si <= sj) row by row, inside each its tiles row by row.
__device__ __forceinline__ void tile_of(int t, int nt, int& bi, int& bj) {
  const int ns = (nt + kGroup - 1) / kGroup;
  for (int si = 0; si < ns; ++si) {
    const int hi = min(kGroup, nt - si * kGroup);
    for (int sj = si; sj < ns; ++sj) {
      const int wj = min(kGroup, nt - sj * kGroup);
      const int count = si == sj ? hi * (hi + 1) / 2 : hi * wj;
      if (t < count) {
        if (si != sj) {
          bi = si * kGroup + t / wj;
          bj = sj * kGroup + t % wj;
        } else {
          int r = 0;
          while (t >= hi - r) t -= hi - r++;
          bi = si * kGroup + r;
          bj = bi + t;
        }
        return;
      }
      t -= count;
    }
  }
  bi = bj = 0;   // not reached for t < n_tiles
}

// byte offset of f32 element (r, c) in a box of 32-float (128-byte) rows,
// 128-byte swizzled: the 16-byte chunk index XOR the row's low 3 bits
__device__ __forceinline__ int sw_off(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2);
}

// out (+)= Mt Mt^T over the tiles with i0 <= j0, each written with its
// mirror; see the note at the top.
__global__ void __launch_bounds__(kThreads, 1)
coact_wgmma_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;                              // slot s: A, then B
  uint8_t* staging = smem + kRingBytes;              // per consumer: dir, mir
  uint64_t* full = reinterpret_cast<uint64_t*>(
      staging + kConsumers * 2 * kHalfBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);   // each consumer warp's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {            // the producer's warpgroup
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
      int bi, bj;
      tile_of(t, p.nt, bi, bj);
      for (int k = 0; k < p.kstages; ++k, ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        uint8_t* a = ring + s * 2 * kOpBytes;
        mbar_expect_tx(&full[s], bi == bj ? kOpBytes : 2 * kOpBytes);
        tma_load_2d(a, &p.mt_map, k * kK, bi * kTile, &full[s]);
        if (bi != bj)
          tma_load_2d(a + kOpBytes, &p.mt_map, k * kK, bj * kTile, &full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128 - 1;      // consumer 0 or 1: rows 64 wg..
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  uint8_t* dir = staging + wg * 2 * kHalfBytes;   // 4 boxes of 64 x 32
  uint8_t* mir = dir + kHalfBytes;                // 2 boxes of 128 x 32
  const bool add = p.accumulate != 0;
  int acc[64];
#pragma unroll
  for (int v = 0; v < 64; ++v) acc[v] = 0;
  int it = 0;
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    int bi, bj;
    tile_of(t, p.nt, bi, bj);
    const bool diag = bi == bj;
    for (int k = 0; k < p.kstages; ++k, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint8_t* a = ring + s * 2 * kOpBytes + wg * 64 * kK;
      const uint8_t* b = ring + s * 2 * kOpBytes + (diag ? 0 : kOpBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK / 32; ++kk)
        wgmma_u8(acc, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk),
                 (k > 0 || kk > 0) ? 1 : 0);
      wgmma_commit();
      if (k > 0) {               // the stage before is done: hand it back
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);

    // epilogue: d[4 n8 + v] is row 16 warp + g + 8 (v / 2), column
    // 8 n8 + 2 q + v % 2 of this warpgroup's 64 x 128 half
    const int i0 = bi * kTile + 64 * wg, j0 = bj * kTile;
    if (p.tma_out) {
      if (tid == 0) bulk_wait_read();   // the last tile's stores have read
      named_barrier(1 + wg);
#pragma unroll
      for (int n8 = 0; n8 < 16; ++n8) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * warp + g + 8 * h, c = 8 * n8 + 2 * q;
          const float v0 = __int2float_rn(acc[4 * n8 + 2 * h]);
          const float v1 = __int2float_rn(acc[4 * n8 + 2 * h + 1]);
          *reinterpret_cast<float2*>(dir + (c / 32) * kDirBox +
                                     sw_off(r, c % 32)) = make_float2(v0, v1);
          if (!diag) {                  // mirror: row c (and c + 1), col r
            uint8_t* box = mir + (r / 32) * kMirBox;
            *reinterpret_cast<float*>(box + sw_off(c, r % 32)) = v0;
            *reinterpret_cast<float*>(box + sw_off(c + 1, r % 32)) = v1;
          }
        }
      }
      fence_proxy_async();
      named_barrier(1 + wg);
      if (tid == 0) {
        if (i0 < p.N) {
#pragma unroll
          for (int bx = 0; bx < 4; ++bx)
            if (j0 + 32 * bx < p.N)
              tma_store_2d(&p.dir_map, dir + bx * kDirBox, j0 + 32 * bx, i0,
                           add);
          if (!diag) {
#pragma unroll
            for (int bx = 0; bx < 2; ++bx)
              if (i0 + 32 * bx < p.N)
                tma_store_2d(&p.mir_map, mir + bx * kMirBox, i0 + 32 * bx, j0,
                             add);
          }
        }
        bulk_commit();
      }
    } else {                           // the threads store, bounds-checked
#pragma unroll
      for (int n8 = 0; n8 < 16; ++n8) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = i0 + 16 * warp + g + 8 * (v / 2);
          const int j = j0 + 8 * n8 + 2 * q + v % 2;
          if (i >= p.N || j >= p.N) continue;
          const float x = __int2float_rn(acc[4 * n8 + v]);
          float* o = p.out + (size_t)i * p.N + j;
          *o = add ? *o + x : x;
          if (!diag) {
            float* m = p.out + (size_t)j * p.N + i;
            *m = add ? *m + x : x;
          }
        }
      }
    }
  }
  if (p.tma_out && tid == 0) bulk_wait_all();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// the driver library).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A 2-D tensor map of a row-major [rows, cols] matrix (row pitch `pitch`
// bytes), boxes of box_c x box_r elements, 128-byte swizzled.
int encode(CUtensorMap* map, void* base, CUtensorMapDataType type, int rows,
           int cols, size_t pitch, int box_c, int box_r) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_c),
                             static_cast<cuuint32_t>(box_r)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = fn(map, type, 2, base, dims, strides, box, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry point for ctypes. `masks` (u8 [T, N]), `scratch` (u8 [Np, Tp],
// Np = N rounded up to 128, Tp = T rounded up to 128) and `out` (f32
// [N, N], contiguous) are device pointers; `stream` is a cudaStream_t.
// `accumulate` 0 writes out = M^T M, 1 adds out += M^T M. Launches the
// transpose, then the product, on the stream. Returns the CUDA error code
// of the launches (0 = success); cudaErrorInvalidValue for a padding the
// kernels do not take.
extern "C" int coact_launch(const uint8_t* masks, uint8_t* scratch, float* out,
                            int T, int N, int Tp, int Np, int accumulate,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || N <= 0 || Tp % kK != 0 || Np % kTile != 0 || Tp < T ||
      Np < N)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.out = out;
  p.N = N;
  p.kstages = Tp / kK;
  p.nt = Np / kTile;
  p.n_tiles = p.nt * (p.nt + 1) / 2;
  p.accumulate = accumulate != 0;
  p.tma_out = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  int err = encode(&p.mt_map, scratch, CU_TENSOR_MAP_DATA_TYPE_UINT8, Np, Tp,
                   static_cast<size_t>(Tp), kK, kTile);
  if (err == 0 && p.tma_out)
    err = encode(&p.dir_map, out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, N, N,
                 static_cast<size_t>(N) * 4, 32, 64);
  if (err == 0 && p.tma_out)
    err = encode(&p.mir_map, out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, N, N,
                 static_cast<size_t>(N) * 4, 32, 128);
  if (err != 0) return err;

  // per device: the SM count and the function's shared-memory attribute
  static int sms_of[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = device < kMaxDevices ? sms_of[device] : 0;
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(coact_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < kMaxDevices) sms_of[device] = sms;
  }

  const int vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(masks) % 4 == 0;
  coact_transpose_kernel<<<dim3(Np / kPad, Tp / kPad), 256, 0, s>>>(
      masks, scratch, T, N, Tp, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = p.n_tiles < sms ? p.n_tiles : sms;
  coact_wgmma_kernel<<<grid, kThreads, kSmemBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

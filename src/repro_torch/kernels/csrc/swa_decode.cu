// Sliding-window decode attention over a ring, for Hopper (sm_90a).
//
// Replaces the TPU kernel `swa_decode_kernel`
// (src/repro/kernels/swa_decode.py:69, body `_kernel` :34-66), reached
// through `ops.swa_decode_attention`.
//
// One new token per batch row attends, GQA style, to that row's ring:
//   q       f32 or bf16 [B, H, hd], H = KV * G (head h reads KV head h / G)
//   k/v     q's dtype, or bf16 under a f32 q (a bf16 model's rings once
//           the offloaded FFN has made its residual stream f32)
//           [B, W, KV, hd] -- the reference's ring layout, read
//           in place (the TPU wrapper's swapaxes and pad copies of the whole
//           ring are not repeated)
//   pos     i32 [B, W]  position held by each slot, -1 = empty
//   cur     i32 [] or [B] (cur_per_row), the query's position, read on the
//           device (no host sync)
//   out     q's dtype [B, H, hd]
// A f32 q over bf16 rings gives float32 scores of the unrounded q and the
// keys upcast, P as bf16 rings take it below (rounded to bf16 for P.V on
// the tensor cores), and a f32 result: the reference's promotion
// (`gqa_attend`, src/repro/models/layers.py:104, 114). On the tensor cores
// q enters as two bf16 terms, hi = bf16(q) and lo = bf16(q - hi), two
// products a k-step: what q loses there is below 2^-17 of |q| an element.
// Slot w of row b takes part iff pos >= 0 and cur - window < pos <= cur;
// a row with no such slot gives 0, as the TPU kernel does.
//
// What bounds it: bytes. Each valid K/V row is read once and used for
// 2 * G * hd multiply-adds per matrix: G to 2G flops a byte, far below the
// card's ridge point for the tensor cores, but at G = 4 to 8 in bf16 up to
// 80% of the CUDA cores' float32 rate at full memory speed. At mistral-7b's
// heads (8 KV x 128, G = 4) one row's two full 8192-slot bf16 rings are
// 33.6 MB, 0.010 ms at the H100 SXM's 3.35 TB/s; the positions add 32 KB.
//
// What held the first version (one warp per slot, online softmax per slot)
// back, read from its source and its SASS: a serial chain per slot and
// head (a 5-step shuffle sum, two expf and a rescale of the accumulator),
// 2- or 4-byte loads per lane (LDG.E.U16 in bf16), and at most 4 slots in
// flight per warp. The chain, not the bytes, set its time, so bf16 (half
// the bytes) was no faster than float32.
//
// What this design does (flash-decoding in tiles):
//   * the ring is split along W across blocks: one block per (KV head, row,
//     split), the split count from the SM count, each split a whole number
//     of tiles of at most kMaxChunk slots (the wrapper's `plan`);
//   * a block first reads its split's positions, all loads in flight at
//     once, into a flag per slot and one per tile; a tile with no valid
//     slot is never copied nor computed;
//   * it walks the other tiles (T slots, 16 KB of K and of V on the fast
//     path) through a ring of kStages tiles in shared memory, filled with
//     16-byte `cp.async` (neighbouring lanes on neighbouring 16 bytes of a
//     row); an invalid slot's rows are zero-filled without reading device
//     memory;
//   * scores for the whole tile at once, then one max and one rescale of
//     the accumulators per head per tile (not per slot):
//       - bf16 with hd a multiple of 16: on the tensor cores, `mma.sync`
//         m16n8k16 with the G query heads as rows of a 16-row tile, K and
//         V fed by `ldmatrix` (V transposed) and P rounded to bf16 for
//         P.V as the TPU kernel does (`p.astype(v.dtype)`), its sum taken
//         from the rounded values; each warp owns 16 columns of hd;
//       - otherwise on the CUDA cores: `lanes` threads share a slot's row,
//         each dots its 16-byte chunks with the query heads in registers
//         and a short shuffle sum joins them; P.V by threads that own 4
//         elements of hd for every head, float32 throughout;
//   * slot groups are summed in group order at the end of the block; the
//     last split of a (row, KV head) to finish (an atomic ticket, the only
//     atomic) merges the splits in split order: the sums do not depend on
//     which block comes last, so every run gives the same bits. A split
//     that saw no valid slot has max -inf and weight exactly 0.
// A row whose bytes are not a multiple of 16, or a ring whose base is not
// 16-byte aligned, takes the narrow instantiation of the same kernel: one
// element per chunk, loaded and stored by the threads (no `cp.async`).
// It leaves: the float32 path's shuffle sums on the CUDA cores, no TMA, 256-byte pieces of rows 2 to 4 KB
// apart (one KV head per block), so device memory runs well below its
// peak, and one block per (row, KV head, split), so the splits of a short
// row only read positions.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPasses = 4;      // slot passes per tile: T = kPasses * slots a pass
constexpr int kStages = 3;      // tiles in flight in the shared-memory ring
constexpr int kMaxHeads = 8;
constexpr int kMaxChunk = 2048; // slots a split takes at most (positions in smem)
constexpr int kMaxDevices = 64; // devices whose shared-memory limit is kept
static_assert(kMaxHeads <= kWarps, "the softmax gives each head a warp");

// The geometry the host, the wrapper's `plan` and the kernel agree on.
struct Geom {
  int ve;      // elements per copied chunk (16 bytes, or 1 when narrow)
  int cpr;     // chunks per row
  int lanes;   // threads sharing a slot's row in the score pass
  int tile;    // slots per tile
  int pitch;   // bytes between rows in shared memory
  int vp;      // elements per P.V chunk
  int dc;      // P.V chunks per row
  int groups;  // slot groups of the P.V pass
};

__host__ __device__ inline Geom geometry(int hd, int elt, bool narrow) {
  Geom g;
  g.ve = narrow ? 1 : 16 / elt;
  g.cpr = hd / g.ve;
  int lanes = 4;
  while (lanes < g.cpr && lanes < 32) lanes <<= 1;
  g.lanes = lanes;
  g.tile = kPasses * kThreads / lanes;
  g.pitch = (hd * elt + 15) / 16 * 16 + 16;   // +16: rows in other banks
  g.vp = narrow ? 1 : 4;
  g.dc = hd / g.vp;
  g.groups = kThreads / g.dc;
  return g;
}

// Shared memory: the ring of K/V tiles (reused for the end-of-block merge),
// then the scores [T][MAXG], alpha, max and sum per head, the bf16
// probabilities of the tensor-core path, a valid flag per slot of the split
// and an any-valid flag per tile.
// bytes between the rows of the bf16 probabilities P [8 heads][T]
__host__ __device__ inline int p_pitch(const Geom& g) {
  return g.tile * 2 + 16;
}

__host__ __device__ inline int ring_bytes(const Geom& g, int G, int hd) {
  const int stages = kStages * 2 * g.tile * g.pitch;
  const int merge = (g.groups * G * hd * 4 + 15) / 16 * 16;
  return stages > merge ? stages : merge;
}

inline size_t smem_bytes(const Geom& g, int G, int hd, int maxg) {
  return static_cast<size_t>(ring_bytes(g, G, hd)) + g.tile * maxg * 4 +
         3 * kMaxHeads * 4 + kMaxHeads * p_pitch(g) + kMaxChunk +
         kMaxChunk / 4;
}

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

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// n elements of type T at shared address p (16-, 8-byte or element
// aligned as n says) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_smem(const unsigned char* p, float* f) {
  if constexpr (N == 1) {
    f[0] = to_float(*reinterpret_cast<const T*>(p));
  } else if constexpr (sizeof(T) == 4 && N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  } else if constexpr (sizeof(T) == 2 && N == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    f[0] = bf16_lo(x.x); f[1] = bf16_hi(x.x); f[2] = bf16_lo(x.y);
    f[3] = bf16_hi(x.y); f[4] = bf16_lo(x.z); f[5] = bf16_hi(x.z);
    f[6] = bf16_lo(x.w); f[7] = bf16_hi(x.w);
  } else {
    static_assert(sizeof(T) == 2 && N == 4, "unsupported chunk");
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    f[0] = bf16_lo(x.x); f[1] = bf16_hi(x.x); f[2] = bf16_lo(x.y);
    f[3] = bf16_hi(x.y);
  }
}

// 16 bytes from global to shared memory without passing through registers;
// src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool read) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(read ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tensor-core pieces (bf16 in, f32 out): ldmatrix of 8x8 b16 tiles from
// shared memory and mma.sync m16n8k16, the fragments as the PTX ISA lays
// them out (row = lane / 4, column pair = 2 * (lane % 4)).
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
// c += A[16 x 16] B[16 x 8]; rows 8-15 of A are zero (G <= 8 query heads)
__device__ __forceinline__ void mma_rows8(float (&c)[4], uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Sums each of the MAXG partial dots over the `lanes` lanes of a slot
// group (a power of two, 4 to 32, aligned in the warp). Up to two halving
// steps first: the group's upper half keeps the upper half of the heads,
// the lower half the lower, each adding its partner's copy, so the heads
// share those levels' shuffles; then a butterfly on the MAXG / 4 (at
// least 1) heads left. Leaves in v[0..) the totals of heads h0.., h0 the
// return value; every lane of a group holds them, lanes / (MAXG / R) lanes
// per head set.
template <int MAXG>
__device__ __forceinline__ int sum_over_lanes(float (&v)[MAXG], int lanes,
                                              int part) {
  int h0 = 0, o = lanes >> 1;
#pragma unroll
  for (int half = MAXG / 2; half >= (MAXG >= 4 ? MAXG / 4 : 1) && half >= 1;
       half /= 2) {
    const bool upper = (part & o) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float give = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, give, o);
    }
    if (upper) h0 += half;
    o >>= 1;
  }
  constexpr int R = MAXG >= 4 ? MAXG / 4 : 1;
  for (; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
  return h0;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Pass 1: block (kvh, b, split) reduces slots [split * chunk, +chunk) of row
// b to one unnormalised (max, sum, acc[hd]) per query head of KV head kvh.
// NARROW: one element per chunk (any row width and base alignment). MMA
// (bf16, hd a multiple of 16): scores and P.V on the tensor cores, the G
// query heads as rows 0..G-1 of a 16-row tile; NCH is then hd / 128
// rounded up. Otherwise on the CUDA cores: NCH chunks of a row a thread
// holds in the score pass (>= cpr / lanes), MAXG query heads per KV head
// in registers (G <= MAXG).
// T is the rings' type, TQ q's and the output's (T, or float over bf16).
template <typename T, typename TQ, bool NARROW, bool MMA, int NCH, int MAXG>
__global__ void __launch_bounds__(kThreads)
swa_split_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ pos,
                 const int* __restrict__ cur_pos, int cur_per_row,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc, TQ* __restrict__ out,
                 int* __restrict__ counters, int W, int KV, int G, int hd,
                 int window, int splits, int chunk, float scale) {
  constexpr int VE = NARROW ? 1 : 16 / static_cast<int>(sizeof(T));
  constexpr int VP = NARROW ? 1 : 4;
  constexpr int CB = VE * static_cast<int>(sizeof(T));   // chunk bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom gm = geometry(hd, sizeof(T), NARROW);
  const int tile = gm.tile, pitch = gm.pitch, lanes = gm.lanes;
  const int stage_bytes = 2 * tile * pitch;
  float* sc = reinterpret_cast<float*>(smem + ring_bytes(gm, G, hd));
  float* alpha_s = sc + tile * MAXG;
  float* m_s = alpha_s + kMaxHeads;
  float* l_s = m_s + kMaxHeads;
  unsigned char* p_s = reinterpret_cast<unsigned char*>(l_s + kMaxHeads);
  const int pp = p_pitch(gm);
  unsigned char* valid_s = p_s + kMaxHeads * pp;
  unsigned char* tile_any = valid_s + kMaxChunk;    // [ntiles <= kMaxChunk / 4]

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = KV * G;
  const long long cur = cur_pos[cur_per_row ? b : 0];
  const long long lo = cur - static_cast<long long>(window);
  const int s0 = split * chunk;
  const int s1 = min(W, s0 + chunk);
  const int ntiles = (s1 - s0 + tile - 1) / tile;
  const long row_stride = static_cast<long>(KV) * hd;     // slot -> slot
  const long ring = static_cast<long>(b) * W * row_stride +
                    static_cast<long>(kvh) * hd;
  const T* kb = k + ring;
  const T* vb = v + ring;
  const int* pb = pos + static_cast<long>(b) * W;
  const int spp = kThreads / lanes;          // slots per pass
  const int myslot = tid / lanes, part = tid % lanes;

  // MMA: the query rows as A fragments, rows 0..7 (row lane / 4 here); a
  // f32 q as hi + lo bf16 terms (ql the lo ones)
  constexpr int KS = MMA ? 8 * NCH : 1;   // 16-wide k-steps over hd
  constexpr bool kSplitQ = MMA && sizeof(TQ) == 4;
  uint32_t qa[KS][2];
  uint32_t ql[kSplitQ ? KS : 1][2];
  if constexpr (MMA) {
    const int g = lane >> 2;
    const TQ* qg = q + (static_cast<long>(b) * H + kvh * G + g) * hd;
#pragma unroll
    for (int st = 0; st < KS; ++st)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = st * 16 + h * 8 + (lane & 3) * 2;
        const bool ok = g < G && d < hd;
        if constexpr (kSplitQ) {
          const float a0 = ok ? to_float(qg[d]) : 0.f;
          const float a1 = ok ? to_float(qg[d + 1]) : 0.f;
          const __nv_bfloat16 h0 = __float2bfloat16(a0);
          const __nv_bfloat16 h1 = __float2bfloat16(a1);
          qa[st][h] = bf16_pair(h0, h1);
          ql[st][h] = bf16_pair(__float2bfloat16(a0 - __bfloat162float(h0)),
                                __float2bfloat16(a1 - __bfloat162float(h1)));
        } else {
          qa[st][h] = ok ? bf16_pair(qg[d], qg[d + 1]) : 0u;
        }
      }
  }
  // CUDA cores: this thread's chunks of the G query rows
  float qr[MMA ? 1 : MAXG][NCH][VE];
#pragma unroll
  for (int g = 0; g < (MMA ? 0 : MAXG); ++g)
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int ch = part + c * lanes;
#pragma unroll
      for (int e = 0; e < VE; ++e)
        qr[g][c][e] = (g < G && ch < gm.cpr)
            ? to_float(q[(static_cast<long>(b) * H + kvh * G + g) * hd +
                         ch * VE + e])
            : 0.f;
    }

  // The split's positions, all loads in flight at once: a flag per slot
  // and one per tile that holds a valid slot. Empty tiles are then skipped
  // without another trip to device memory.
  const int n = s1 - s0;
  for (int t = tid; t < ntiles; t += kThreads) tile_any[t] = 0;
  int pr[kMaxChunk / kThreads];
#pragma unroll
  for (int j = 0; j < kMaxChunk / kThreads; ++j) {
    const int i = tid + j * kThreads;
    pr[j] = i < n ? pb[s0 + i] : -1;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMaxChunk / kThreads; ++j) {
    const int i = tid + j * kThreads;
    if (i < ntiles * tile) {
      const long long pp = pr[j];
      const bool ok = pp >= 0 && pp > lo && pp <= cur;
      valid_s[i] = ok;
      if (ok) tile_any[i / tile] = 1;      // every writer writes 1
    }
  }
  __syncthreads();

  // Copy this thread's chunks of tile ti into its stage; an invalid slot's
  // rows are zero-filled, an empty tile is not copied at all.
  auto issue = [&](int ti) {
    if (ti < ntiles && tile_any[ti]) {
      unsigned char* ks = smem + (ti % kStages) * stage_bytes;
      unsigned char* vs = ks + tile * pitch;
#pragma unroll
      for (int j = 0; j < kPasses; ++j) {
        const int row = j * spp + myslot;
        const bool ok = valid_s[ti * tile + row];
        const long off = static_cast<long>(s0 + ti * tile + row) * row_stride;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int ch = part + c * lanes;
          if (ch < gm.cpr) {
            unsigned char* kd = ks + row * pitch + ch * CB;
            unsigned char* vd = vs + row * pitch + ch * CB;
            if constexpr (NARROW) {
              *reinterpret_cast<T*>(kd) = ok ? kb[off + ch] : from_float<T>(0.f);
              *reinterpret_cast<T*>(vd) = ok ? vb[off + ch] : from_float<T>(0.f);
            } else {
              cp_async16(kd, ok ? kb + off + ch * VE : kb, ok);
              cp_async16(vd, ok ? vb + off + ch * VE : vb, ok);
            }
          }
        }
      }
    }
    if constexpr (!NARROW) cp_async_commit();   // one group per tile, even empty
  };
#pragma unroll
  for (int ti = 0; ti < kStages - 1; ++ti) issue(ti);

  float m_run = -INFINITY, l_run = 0.f;       // head `warp`'s, in warp `warp`
  // MMA: warp w owns the 16-column pairs of n-tiles w, w + 8 of hd
  constexpr int NPW = MMA ? 2 * NCH : 1;
  float accm[NPW][2][4];
#pragma unroll
  for (int a = 0; a < NPW; ++a)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accm[a][j][e] = 0.f;
  float acc[MAXG][VP];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < VP; ++e) acc[g][e] = 0.f;
  const int r = tid / gm.dc, dchunk = tid % gm.dc;   // P.V: group, chunk
  const bool pv = tid < gm.groups * gm.dc;

  for (int i = 0; i < ntiles; ++i) {
    issue(i + kStages - 1);                  // into the stage tile i - 1 freed
    if constexpr (!NARROW) cp_async_wait<kStages - 1>();   // tile i is here
    if (tile_any[i]) {                       // the same for every thread
      __syncthreads();                       // every thread's copies landed
      const unsigned char* ks = smem + (i % kStages) * stage_bytes;
      const unsigned char* vs = ks + tile * pitch;
      // scores of the tile's slots, all heads
      if constexpr (MMA) {
        // warp: n-tiles of 8 slots; S[g][t] = sum over hd of Q[g] K[t]
        for (int nt = warp; nt < tile / 8; nt += kWarps) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          const unsigned char* kr =
              ks + (nt * 8 + (lane & 7)) * pitch + ((lane >> 3) & 1) * 16;
#pragma unroll
          for (int st = 0; st < KS; ++st) {
            if (st * 16 < hd) {
              uint32_t b0, b1;
              ldmatrix_x2(b0, b1, kr + st * 32);
              mma_rows8(c, qa[st][0], qa[st][1], b0, b1);
              if constexpr (kSplitQ) mma_rows8(c, ql[st][0], ql[st][1], b0, b1);
            }
          }
          const int g = lane >> 2, t = nt * 8 + (lane & 3) * 2;
          if (g < G) {
            sc[t * MAXG + g] = valid_s[i * tile + t] ? c[0] * scale : -INFINITY;
            sc[(t + 1) * MAXG + g] =
                valid_s[i * tile + t + 1] ? c[1] * scale : -INFINITY;
          }
        }
      } else {
#pragma unroll
      for (int j = 0; j < kPasses; ++j) {
        const int row = j * spp + myslot;
        float dot[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int ch = part + c * lanes;
          if (ch < gm.cpr) {
            float kf[VE];
            load_smem<T, VE>(ks + row * pitch + ch * CB, kf);
#pragma unroll
            for (int g = 0; g < MAXG; ++g)
#pragma unroll
              for (int e = 0; e < VE; ++e) dot[g] += qr[g][c][e] * kf[e];
          }
        }
        constexpr int R = MAXG >= 4 ? MAXG / 4 : 1;   // heads a lane ends with
        const int h0 = sum_over_lanes<MAXG>(dot, lanes, part);
        if (part % (lanes / (MAXG / R)) == 0) {
          const bool ok = valid_s[i * tile + row];
#pragma unroll
          for (int j = 0; j < R; ++j)
            sc[row * MAXG + h0 + j] = ok ? dot[j] * scale : -INFINITY;
        }
      }
      }
      __syncthreads();
      // one max and one rescale per head: warp g owns head g
      if (warp < G) {
        float* s = sc + warp;
        float tmax = -INFINITY;
        for (int t = lane; t < tile; t += 32) tmax = fmaxf(tmax, s[t * MAXG]);
        const float m_new = fmaxf(m_run, warp_max(tmax));
        const float alpha = m_run == -INFINITY ? 0.f : expf(m_run - m_new);
        float sum = 0.f;
        for (int t = lane; t < tile; t += 32) {
          const float x = s[t * MAXG];
          const float p = x == -INFINITY ? 0.f : expf(x - m_new);
          if constexpr (MMA) {   // P.V reads P in bf16: sum what it reads
            const __nv_bfloat16 pb = __float2bfloat16(p);
            reinterpret_cast<__nv_bfloat16*>(p_s + warp * pp)[t] = pb;
            sum += __bfloat162float(pb);
          } else {
            s[t * MAXG] = p;
            sum += p;
          }
        }
        l_run = l_run * alpha + warp_sum(sum);
        m_run = m_new;
        if (lane == 0) alpha_s[warp] = alpha;
      }
      __syncthreads();
      // P.V: this thread's VP elements of every head, its group's slots
      if constexpr (MMA) {
        const int g = lane >> 2;
        const float a = g < G ? alpha_s[g] : 0.f;
#pragma unroll
        for (int pi = 0; pi < NPW; ++pi) {
          const int pr = warp + pi * kWarps;          // hd columns 16 pr..
          if (pr * 16 < hd) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              accm[pi][j][0] *= a;
              accm[pi][j][1] *= a;
            }
            const unsigned char* pa =
                p_s + (lane & 7) * pp + ((lane >> 3) & 1) * 16;
            const unsigned char* vb0 =
                vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * pitch +
                (pr * 16 + (lane >> 4) * 8) * 2;
            for (int kt = 0; kt < tile / 16; ++kt) {
              uint32_t a0, a2, bv[4];
              ldmatrix_x2(a0, a2, pa + kt * 32);
              ldmatrix_x4_trans(bv, vb0 + kt * 16 * pitch);
              mma_rows8(accm[pi][0], a0, a2, bv[0], bv[1]);
              mma_rows8(accm[pi][1], a0, a2, bv[2], bv[3]);
            }
          }
        }
      } else if (pv) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          const float a = g < G ? alpha_s[g] : 0.f;
#pragma unroll
          for (int e = 0; e < VP; ++e) acc[g][e] *= a;
        }
        for (int t = r; t < tile; t += gm.groups) {
          float vf[VP];
          load_smem<T, VP>(vs + t * pitch + dchunk * VP * sizeof(T), vf);
          float p[MAXG];
          if constexpr (MAXG % 4 == 0) {
#pragma unroll
            for (int g = 0; g < MAXG; g += 4) {
              const float4 x = *reinterpret_cast<const float4*>(sc + t * MAXG + g);
              p[g] = x.x; p[g + 1] = x.y; p[g + 2] = x.z; p[g + 3] = x.w;
            }
          } else {
#pragma unroll
            for (int g = 0; g < MAXG; ++g) p[g] = sc[t * MAXG + g];
          }
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
#pragma unroll
            for (int e = 0; e < VP; ++e) acc[g][e] += p[g] * vf[e];
        }
      }
      __syncthreads();                       // stage i % kStages is free
    }
  }
  if constexpr (!NARROW) cp_async_wait<0>();
  __syncthreads();

  if constexpr (MMA) {   // each warp owns its columns: no merge in the block
    const int g = lane >> 2;
    const long hrow = (static_cast<long>(b) * H + kvh * G + g) * splits + split;
    if (g < G) {
#pragma unroll
      for (int pi = 0; pi < NPW; ++pi) {
        const int pr = warp + pi * kWarps;
        if (pr * 16 < hd) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int d = pr * 16 + j * 8 + (lane & 3) * 2;
            part_acc[hrow * hd + d] = accm[pi][j][0];
            part_acc[hrow * hd + d + 1] = accm[pi][j][1];
          }
        }
      }
    }
    if (warp < G && lane == 0) {
      const long h = (static_cast<long>(b) * H + kvh * G + warp) * splits + split;
      part_m[h] = m_run;
      part_l[h] = l_run;
    }
  } else {
  // slot groups, then the block's (max, sum, acc) per head
  float* red = reinterpret_cast<float*>(smem);   // [groups][G][hd]
  if (pv) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G)
#pragma unroll
        for (int e = 0; e < VP; ++e)
          red[(r * G + g) * hd + dchunk * VP + e] = acc[g][e];
  }
  if (warp < G && lane == 0) {
    m_s[warp] = m_run;
    l_s[warp] = l_run;
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    float A = 0.f;
    for (int rr = 0; rr < gm.groups; ++rr) A += red[(rr * G + g) * hd + d];
    const long hrow = (static_cast<long>(b) * H + kvh * G + g) * splits + split;
    part_acc[hrow * hd + d] = A;
    if (d == 0) {
      part_m[hrow] = m_s[g];
      part_l[hrow] = l_s[g];
    }
  }
  }

  // The last split of (b, kvh) to finish merges every split's partials in
  // split order into out. The ticket is the only atomic; the sums do not
  // depend on which block comes last.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + b * KV + kvh, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long h0 = (static_cast<long>(b) * H + kvh * G) * splits;   // [G][splits]
  float* w_s = reinterpret_cast<float*>(smem);     // weights [G][splits]
  float* L_s = w_s + G * splits;                   // sums [G]
  for (int i = tid; i < G * splits; i += kThreads) w_s[i] = __ldcg(part_m + h0 + i);
  __syncthreads();
  if (tid < G) {
    float* w = w_s + tid * splits;
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, w[s]);
    float L = 0.f;
    for (int s = 0; s < splits; ++s) {
      w[s] = w[s] == -INFINITY ? 0.f : expf(w[s] - mx);
      L += w[s] * __ldcg(part_l + h0 + tid * splits + s);
    }
    L_s[tid] = L;
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    const float* w = w_s + g * splits;
    const float* a = part_acc + (h0 + static_cast<long>(g) * splits) * hd + d;
    float A = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) A += w[s] * __ldcg(a + static_cast<long>(s) * hd);
    out[(static_cast<long>(b) * H + kvh * G + g) * hd + d] =
        from_float<TQ>(A / fmaxf(L_s[g], 1e-30f));
  }
  if (tid == 0) counters[b * KV + kvh] = 0;        // ready for the next launch
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  const int* cur;
  float* scratch;
  void* out;
  int* counters;
  int cur_per_row, B, W, KV, G, hd, window, splits, chunk, tile, narrow;
  float scale;
  cudaStream_t stream;
  int* blocks_per_sm;   // non-null: report the occupancy, launch nothing
};

template <typename T, typename TQ, bool NARROW, bool MMA, int NCH, int MAXG>
int launch_one(const Args& a) {
  const Geom gm = geometry(a.hd, sizeof(T), NARROW);
  if (gm.tile != a.tile || a.chunk % gm.tile != 0 || a.chunk > kMaxChunk ||
      a.splits < 1 || (a.splits - 1) * a.chunk >= a.W ||
      (a.G * a.splits + kMaxHeads) * 4 > ring_bytes(gm, a.G, a.hd))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(gm, a.G, a.hd, MAXG);
  auto kernel = swa_split_kernel<T, TQ, NARROW, MMA, NCH, MAXG>;
  // the dynamic shared-memory limit is an attribute of the function on each
  // device: raised per device; all of the SM's unified memory as shared
  // memory, so that two blocks of ~105 KB fit
  static size_t smem_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || smem > smem_set[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) smem_set[device] = smem;
  }
  if (a.blocks_per_sm != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.blocks_per_sm, kernel, kThreads, smem));
  const long n_part = static_cast<long>(a.B) * a.KV * a.G * a.splits;
  float* part_m = a.scratch;
  float* part_l = a.scratch + n_part;
  float* part_acc = a.scratch + 2 * n_part;
  const dim3 grid(a.KV, a.B, a.splits);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.pos, a.cur, a.cur_per_row, part_m, part_l,
      part_acc, static_cast<TQ*>(a.out), a.counters, a.W, a.KV, a.G, a.hd,
      a.window, a.splits, a.chunk, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TQ, bool NARROW, int NCH>
int launch_g(const Args& a) {
  if constexpr (!NARROW) {     // the narrow path keeps to two instantiations
    if (a.G <= 1) return launch_one<T, TQ, NARROW, false, NCH, 1>(a);
    if (a.G <= 2) return launch_one<T, TQ, NARROW, false, NCH, 2>(a);
  }
  if (a.G <= 4) return launch_one<T, TQ, NARROW, false, NCH, 4>(a);
  // G > 4 only at hd <= 128, where NCH is 1 (fast) or at most 4 (narrow)
  if constexpr (NCH == 1 || (NARROW && NCH <= 4)) {
    if (a.G <= 8) return launch_one<T, TQ, NARROW, false, NCH, 8>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename TQ>
int launch_t(const Args& a) {
  if (a.hd < 1 || a.hd > 256 || a.G < 1 || a.G > kMaxHeads ||
      (a.G > 4 && a.hd > 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.narrow) {
    if (a.hd <= 32) return launch_g<T, TQ, true, 1>(a);
    if (a.hd <= 64) return launch_g<T, TQ, true, 2>(a);
    if (a.hd <= 128) return launch_g<T, TQ, true, 4>(a);
    return launch_g<T, TQ, true, 8>(a);
  }
  if ((a.hd * static_cast<int>(sizeof(T))) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(T) == 2) {   // bf16 on the tensor cores
    if (a.hd % 16 == 0) {
      if (a.hd <= 128) return launch_one<T, TQ, false, true, 1, kMaxHeads>(a);
      return launch_one<T, TQ, false, true, 2, kMaxHeads>(a);
    }
  }
  const Geom gm = geometry(a.hd, sizeof(T), false);
  if (gm.cpr <= gm.lanes) return launch_g<T, TQ, false, 1>(a);
  if constexpr (sizeof(T) == 4) return launch_g<T, TQ, false, 2>(a);   // hd > 128
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(const Args& a, int dtype) {
  if (dtype == 0) return launch_t<float, float>(a);
  if (dtype == 1) return launch_t<__nv_bfloat16, __nv_bfloat16>(a);
  if (dtype == 2) return launch_t<__nv_bfloat16, float>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry point for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. `scratch` is caller-allocated f32, (2 + hd) * n floats
// with n = B * H * splits: the splits' maxima [B, H, splits], their sums,
// then their accumulators [B, H, splits, hd]. `counters` is int32 [B, KV],
// zero on entry and left zero (the merge tickets, which no launch on
// another stream may share). `dtype` 0 = float32, 1 = bfloat16 (q, k, v and out
// alike), 2 = float32 q and out over bfloat16 rings.
// `cur_per_row` 1 reads cur_pos[b] for row b, 0 reads cur_pos[0] for every
// row. `narrow` 1 takes the element-wise instantiation (rows whose bytes are
// not a multiple of 16, or a ring base not 16-byte aligned). `tile`,
// `chunk` and `splits` are the wrapper's plan: the kernel checks that its
// tile is `tile`, that `chunk` is a whole number of tiles and that no split
// is empty. Returns the CUDA error code of the launch (0 = success);
// cudaErrorInvalidValue for a geometry the kernel does not take (hd > 256,
// G > 8, or G > 4 with hd > 128), a plan it does not share, or an unknown
// dtype.
extern "C" int swa_decode_launch(const void* q, const void* k, const void* v,
                                 const int* pos, const int* cur_pos,
                                 float* scratch, void* out, int* counters,
                                 int cur_per_row,
                                 int B, int W, int KV, int G, int hd,
                                 int window, int splits, int chunk, int tile,
                                 int narrow, int dtype, float scale,
                                 void* stream) {
  const Args a{q,      k,     v,      pos,   cur_pos, scratch, out, counters,
               cur_per_row, B, W,     KV,    G,       hd,      window,
               splits, chunk, tile,   narrow, scale,
               static_cast<cudaStream_t>(stream), nullptr};
  return dispatch(a, dtype);
}

// Blocks of the split kernel one SM holds at once for this geometry (the
// instantiation and shared memory a launch would use), into *blocks.
// Returns the CUDA error code as swa_decode_launch does.
extern "C" int swa_decode_blocks_per_sm(int G, int hd, int W, int chunk,
                                        int tile, int narrow, int dtype,
                                        int* blocks) {
  Args a{};
  a.G = G; a.hd = hd; a.W = W; a.KV = 1; a.B = 1; a.splits = 1;
  a.chunk = chunk; a.tile = tile; a.narrow = narrow; a.blocks_per_sm = blocks;
  return dispatch(a, dtype);
}

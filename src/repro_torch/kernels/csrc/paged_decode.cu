// Paged-KV decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_kernel`
// (src/repro/kernels/swa_decode.py:149, `pl.pallas_call` at :211, body
// `_paged_core` :113-147), reached through `ops.paged_decode_attention`.
//
// One new token per batch row attends, GQA style, to that row's KV rows in a
// page arena:
//   q            f32  [B, H, hd], H = KV * G (head h reads KV head h / G)
//   k/v pages    f32, bf16 or int8 [P + 1, page_size, KV, hd] -- the PUBLIC
//                layout, read in place (the TPU wrapper's swapaxes copy of
//                the whole arena is not repeated); page P is the null page
//   k/v scales   bf16 [P + 1, page_size, KV] (int8 arenas only)
//   page_tables  i32  [B, max_pages], cur_pos i32 [B], both read on the
//                device (no host sync)
//   out          f32  [B, H, hd]
// Logical slot s of row b lives at page page_tables[b, s / page_size],
// offset s % page_size, and holds position s. It takes part iff s <= cur_pos[b]
// (causal), as in the reference; a row whose table is all null page reads
// the null page like any other, so an inactive slot stays finite. A
// page-table entry outside the arena traps.
//
// Arithmetic, as `_paged_core`: float32 scores and P.V. int8 rows are
// dequantised with their bf16 scale (the scale is applied to the row's dot
// product and to its probability, exact up to float32 rounding). For bf16
// arenas q is rounded to bf16 (as the plain version and the TPU kernel's
// bf16 q), K and V enter as they are; P is NOT rounded to bf16: the
// tensor-core P.V takes it as a pair of bf16 terms, hi = bf16(p) and
// lo = bf16(p - hi), so P carries 16 significant bits (relative error below
// 2^-16) and its sum is taken in float32 from p itself.
//
// What bounds it: bytes. Each valid K/V row is read once and used for
// 2 * G * hd multiply-adds per matrix, far below the card's ridge point;
// at 4096 positions, B = 4 and f32 K/V of 16 x 64 or 8 x 128 per row the
// function must move about 134 MB, 0.040 ms at the H100 SXM's 3.35 TB/s
// (bf16 0.020 ms, int8 0.010 ms with its scales).
//
// What held the first version (one block per (KV head, row), a warp per
// row) back: 32 to 64 blocks on 132 SMs, a serial chain per row and head
// (a 5-step shuffle sum, two expf and a rescale of the accumulator) and 4-
// or 1-byte loads per lane.
//
// What this design does (flash-decoding over pages, the tiled design of
// csrc/swa_decode.cu):
//   * the rows are split along the slots across blocks: one block per
//     (KV head, row, split); the wrapper's `plan` sizes the
//     splits so that one wave of blocks fills the card (the occupancy CUDA
//     reports times the SM count) over the table's span max_pages *
//     page_size; a split whose first slot lies past cur_pos[b] reads
//     nothing more than cur_pos and computes nothing, but still takes part
//     in the merge;
//   * a block first loads its split's page-table entries into shared
//     memory (the TPU's scalar prefetch), then walks tiles of T slots
//     through a ring of kStages tiles in shared memory, filled with 16-byte
//     `cp.async`, neighbouring lanes on neighbouring 16 bytes, the page and
//     row arithmetic by multiply-shift division; slots past cur_pos[b] are
//     zero-filled without a read; int8 scales come a tile ahead through
//     registers;
//   * scores for the whole tile at once, then one max and one rescale per
//     head per tile (not per row):
//       - bf16 with hd a multiple of 16: on the tensor cores, `mma.sync`
//         m16n8k16 with a KV head's G query heads as rows of a 16-row tile,
//         K and V fed by `ldmatrix` (V transposed), P as hi + lo (above);
//       - otherwise on the CUDA cores: `lanes` threads share a (slot, head)
//         row, each dots its chunks with the query heads in registers and a
//         short shuffle sum joins them; P.V by threads that own 4 elements
//         of hd of one KV head for every query head, float32 throughout;
//         int8 becomes float by a byte permute and a float bias (exact),
//         not by the conversion unit;
//   * the last split of a (row, head group) to finish (an atomic ticket in
//     scratch the wrapper allocates per stream, reset for the next launch)
//     merges the
//     splits in split order, every split's max and sum loaded at once: the
//     sums do not depend on which block comes last, so every run gives the
//     same bits. A split that saw no valid slot has max -inf and weight
//     exactly 0.
// One KV head a block: blocks over several (up to all) KV heads of a slot
// range read whole slot rows (KV * hd elements, 4 KB at opt-350m's heads in
// f32) instead of one head's piece, but measured 35% to 119% slower on the
// H100 at every 4096-position shape (PERF.md: their tiles hold few slots, so
// the per-tile softmax and barriers cost more, and the merge of all heads
// falls on one block a row), so that layout was not kept.
// A row whose bytes are not a multiple of 16, or an arena whose base is not
// 16-byte aligned, takes the narrow instantiation of the same kernel: one
// element per chunk, loaded and stored by the threads (no `cp.async`).
// It leaves: no TMA; a fixed cost per launch (the page-table load before
// the first copy, the ticket and the merge after the last tile) that shows
// at short rows; int8 dequantised on the CUDA cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;      // tiles in flight in the shared-memory ring
constexpr int kMaxG = 8;        // query heads per KV head
constexpr int kMaxRows = 512;   // slots per tile
constexpr int kMaxEntries = 1024;  // page-table entries a split holds
constexpr int kSR = 2 * kMaxRows / kThreads;   // int8 scales a thread carries
constexpr int kNPW = 2;         // tensor-core P.V units a warp owns (hd <= 256)
constexpr int kMaxDevices = 64; // devices whose shared-memory limit is kept

// n / d for 0 <= n < 2^31 by a multiply and a shift, d >= 1 fixed per
// launch (the magic is computed on the host): the copy loop divides by the
// page size and the row sizes for every chunk it issues.
struct FastDiv {
  uint32_t d, m, s;
  FastDiv() = default;
  explicit FastDiv(uint32_t div) : d(div), m(0), s(0) {
    while ((1u << s) < d) ++s;
    m = static_cast<uint32_t>(((uint64_t{1} << 32) * ((uint64_t{1} << s) - d))
                              / d + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    return static_cast<int>((__umulhi(static_cast<uint32_t>(n), m) +
                             static_cast<uint32_t>(n)) >> s);
  }
};
struct Divs {
  FastDiv page, row;   // page_size, copied chunks per row
};

// The geometry the host, the wrapper's `plan` and the kernel agree on.
struct Geom {
  int sve;     // elements per score-pass chunk (16 bytes, 8 for int8, 1 narrow)
  int scpr;    // score-pass chunks per row
  int lanes;   // threads sharing a (slot, head) row in the score pass
  int groups;  // rows a score pass covers
  int ve;      // elements per copied chunk (16 bytes, or 1 when narrow)
  int cpr;     // copied chunks per row
  int pitch;   // bytes between rows in shared memory
  int vp;      // elements per P.V chunk
  int dc;      // P.V chunks per row
};

__host__ __device__ inline Geom geometry(int hd, int elt, bool narrow,
                                         bool mma) {
  Geom g;
  g.sve = narrow ? 1 : (16 / elt > 8 ? 8 : 16 / elt);
  g.scpr = (hd + g.sve - 1) / g.sve;
  int lanes = 4;
  while (lanes < g.scpr && lanes < 32) lanes <<= 1;
  g.lanes = lanes;
  g.groups = kThreads / lanes;
  g.ve = narrow ? 1 : 16 / elt;
  g.cpr = hd / g.ve;
  g.pitch = (hd * elt + 15) / 16 * 16 + (mma ? 16 : 0);  // +16: ldmatrix banks
  g.vp = narrow ? 1 : 4;
  g.dc = hd / g.vp;
  return g;
}

// Shared memory, in bytes from the base: the ring of K/V tiles (reused for
// the end-of-block reduction and the merge), the scores [T][MAXG],
// max / sum / alpha per query head, the bf16 P pair of the tensor-core
// path [2][8][T], the int8 scales [2][T] and the page-table entries of the
// split.
struct Layout {
  int sc, stat, p, scl, pt, total;   // the ring starts at 0
};

__host__ __device__ inline int p_pitch(int tile) { return tile * 2 + 16; }

__host__ __device__ inline Layout layout(const Geom& g, int tile, int G,
                                         int hd, int splits, int maxg,
                                         bool mma, bool quant) {
  Layout l;
  int ring = kStages * 2 * tile * g.pitch;
  const int pv_groups = kThreads / g.dc;
  const int red = pv_groups * G * hd * 4;
  const int merge = (2 * G * splits + G) * 4;
  if (red > ring) ring = red;
  if (merge > ring) ring = merge;
  l.sc = (ring + 15) / 16 * 16;
  l.stat = l.sc + (tile * maxg * 4 + 15) / 16 * 16;
  l.p = l.stat + 3 * kMaxG * 4;
  l.scl = l.p + (mma ? 2 * 8 * p_pitch(tile) : 0);
  l.pt = l.scl + (quant ? 2 * tile * 4 : 0);
  l.total = l.pt + kMaxEntries * 4;
  return l;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T zero_of() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// Four int8 in a word as floats, exactly, without the conversion unit (a
// quarter of the FP32 rate): byte b + 128 is placed in the mantissa of
// 2^23 and the bias subtracted.
__device__ __forceinline__ void i8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// N elements of type T at shared address p (aligned to their size) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_smem(const unsigned char* p, float* f) {
  if constexpr (N == 1) {
    f[0] = to_float(*reinterpret_cast<const T*>(p));
  } else if constexpr (sizeof(T) == 4) {
    static_assert(N == 4, "f32 chunks are 4 elements");
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  } else if constexpr (sizeof(T) == 2) {
    if constexpr (N == 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      f[0] = bf16_lo(x.x); f[1] = bf16_hi(x.x); f[2] = bf16_lo(x.y);
      f[3] = bf16_hi(x.y); f[4] = bf16_lo(x.z); f[5] = bf16_hi(x.z);
      f[6] = bf16_lo(x.w); f[7] = bf16_hi(x.w);
    } else {
      static_assert(N == 4, "bf16 chunks are 4 or 8 elements");
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      f[0] = bf16_lo(x.x); f[1] = bf16_hi(x.x); f[2] = bf16_lo(x.y);
      f[3] = bf16_hi(x.y);
    }
  } else {
    if constexpr (N == 8) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      i8x4(x.x, f);
      i8x4(x.y, f + 4);
    } else {
      static_assert(N == 4, "int8 chunks are 4 or 8 elements");
      i8x4(*reinterpret_cast<const uint32_t*>(p), f);
    }
  }
}

// 16 bytes from global to shared memory without passing through registers;
// read false writes zeros and reads nothing.
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
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
          << 16);
}

// Sums each of the MAXG partial dots over the `lanes` lanes of a row group
// (a power of two, 4 to 32, aligned in the warp). Up to two halving steps
// first: the group's upper half keeps the upper half of the heads, the
// lower half the lower, each adding its partner's copy, so the heads share
// those levels' shuffles; then a butterfly on the MAXG / 4 (at least 1)
// heads left. Leaves in v[0..) the totals of heads h0.., h0 the return
// value.
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

// Block (kvh, b, split) reduces slots [split * chunk, +chunk) of row b, KV
// head kvh, to one unnormalised (max, sum, acc[hd]) per query head; the
// last split to finish merges them into out. NARROW: one element per chunk
// (any row width and base alignment). MMA (bf16, hd a multiple of 16):
// scores and P.V on the tensor cores; NCH is then the k-steps over hd the
// query fragments hold (hd / 16 rounded up to 4, 8 or 16). Otherwise on the
// CUDA cores: NCH chunks of a row a thread holds in the score pass, MAXG
// query heads in registers (G <= MAXG).
template <typename T, bool NARROW, bool MMA, int NCH, int MAXG>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const float* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v,
                   const __nv_bfloat16* __restrict__ k_scale,
                   const __nv_bfloat16* __restrict__ v_scale,
                   const int* __restrict__ page_tables,
                   const int* __restrict__ cur_pos, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc,
                   float* __restrict__ out, int* __restrict__ counters,
                   Divs dv, int KV, int G, int hd, int page_size,
                   int max_pages, int n_pages, int splits, int chunk,
                   int tile, float scale) {
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int SVE = NARROW ? 1 : (16 / sizeof(T) > 8 ? 8 : 16 / sizeof(T));
  constexpr int VE = NARROW ? 1 : 16 / static_cast<int>(sizeof(T));
  constexpr int VP = NARROW ? 1 : 4;
  constexpr int ELT = static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom gm = geometry(hd, ELT, NARROW, MMA);
  const Layout ly = layout(gm, tile, G, hd, splits, MAXG, MMA, QUANT);
  const int pitch = gm.pitch, lanes = gm.lanes;
  const int stage_bytes = 2 * tile * pitch;
  float* sc = reinterpret_cast<float*>(smem + ly.sc);        // [T][MAXG]
  float* m_s = reinterpret_cast<float*>(smem + ly.stat);
  float* l_s = m_s + kMaxG;
  float* alpha_s = l_s + kMaxG;
  unsigned char* p_hi = smem + ly.p;                         // [8][pp]
  const int pp = p_pitch(tile);
  unsigned char* p_lo = p_hi + 8 * pp;
  float* ksc_s = reinterpret_cast<float*>(smem + ly.scl);    // [T]
  float* vsc_s = ksc_s + tile;
  int* pt_s = reinterpret_cast<int*>(smem + ly.pt);

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = KV * G;
  const int span = max_pages * page_size;
  const int n_valid = min(cur_pos[b] + 1, span);   // slots 0..cur
  const int s0 = split * chunk;
  const int s_end = min(min(s0 + chunk, span), n_valid);
  const int ntiles = s_end > s0 ? (s_end - s0 + tile - 1) / tile : 0;
  const long slot_stride = static_cast<long>(KV) * hd;      // elements
  const int p0 = dv.page.div(s0);

  // the split's page-table entries (the TPU's scalar prefetch)
  const int n_entries = ntiles > 0 ? dv.page.div(s_end - 1) - p0 + 1 : 0;
  const int* table = page_tables + static_cast<long>(b) * max_pages;
  for (int e = tid; e < n_entries; e += kThreads) {
    const int phys = table[p0 + e];
    if (phys < 0 || phys >= n_pages) __trap();   // a corrupt page table
    pt_s[e] = phys;
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // MMA: the query heads as rows 0..G-1 of the A fragments
  constexpr int KS = MMA ? NCH : 1;
  uint32_t qa[KS][2];
  if constexpr (MMA) {
    const int g = lane >> 2;
    const float* qg = q + (static_cast<long>(b) * H + kvh * G + g) * hd;
#pragma unroll
    for (int st = 0; st < KS; ++st)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = st * 16 + h * 8 + (lane & 3) * 2;
        qa[st][h] = (g < G && d < hd) ? bf16_pair(qg[d], qg[d + 1]) : 0u;
      }
  }
  // CUDA cores: row group gi; this thread's chunks of the G query rows
  // (bf16 arenas: q rounded to bf16)
  const int gi = tid / lanes, part = tid % lanes;
  float qr[MMA ? 1 : MAXG][MMA ? 1 : NCH][SVE];
#pragma unroll
  for (int g = 0; g < (MMA ? 0 : MAXG); ++g)
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int ch = part + c * lanes;
#pragma unroll
      for (int e = 0; e < SVE; ++e) {
        const int d = ch * SVE + e;
        float x = (g < G && ch < gm.scpr && d < hd)
            ? q[(static_cast<long>(b) * H + kvh * G + g) * hd + d]
            : 0.f;
        if constexpr (BF16) x = __bfloat162float(__float2bfloat16(x));
        qr[g][c][e] = x;
      }
    }

  // slot s's row of the arena, (physical page, offset), counted in slots
  auto slot_row = [&](int s) -> long {
    const int pg = dv.page.div(s);
    return static_cast<long>(pt_s[pg - p0]) * page_size + (s - pg * page_size);
  };

  // Copy tile ti into its stage, in the arena's order (slot, chunk):
  // neighbouring threads on neighbouring bytes of a slot's row; rows of
  // slots past the split's last valid slot are zero-filled.
  auto issue = [&](int ti) {
    if (ti < ntiles) {
      unsigned char* ks = smem + (ti % kStages) * stage_bytes;
      unsigned char* vs = ks + tile * pitch;
      for (int i = tid; i < tile * gm.cpr; i += kThreads) {
        const int t = dv.row.div(i), ch = i - t * gm.cpr;
        const int s = s0 + ti * tile + t;
        const bool ok = s < s_end;
        const long src = ok ? slot_row(s) * slot_stride
                                  + static_cast<long>(kvh) * hd + ch * VE
                            : 0;
        const int dst = t * pitch + ch * VE * ELT;
        if constexpr (NARROW) {
          *reinterpret_cast<T*>(ks + dst) = ok ? k[src] : zero_of<T>();
          *reinterpret_cast<T*>(vs + dst) = ok ? v[src] : zero_of<T>();
        } else {
          cp_async16(ks + dst, k + src, ok);
          cp_async16(vs + dst, v + src, ok);
        }
      }
    }
    if constexpr (!NARROW) cp_async_commit();   // one group per tile, even empty
  };
  // int8: tile ti's scales into registers, a tile ahead of their use
  float sreg[QUANT ? kSR : 1];
  auto load_scales = [&](int ti) {
#pragma unroll
    for (int r = 0; r < (QUANT ? kSR : 0); ++r) {
      const int idx = tid + r * kThreads;
      const int which = idx >= tile, t = idx - which * tile;
      const int s = s0 + ti * tile + t;
      float x = 0.f;
      if (ti < ntiles && idx < 2 * tile && s < s_end) {
        const long si = slot_row(s) * KV + kvh;
        x = __bfloat162float(which ? v_scale[si] : k_scale[si]);
      }
      sreg[r] = x;
    }
  };
  auto store_scales = [&]() {
#pragma unroll
    for (int r = 0; r < (QUANT ? kSR : 0); ++r) {
      const int idx = tid + r * kThreads;
      if (idx < 2 * tile) {
        const int which = idx >= tile, t = idx - which * tile;
        (which ? vsc_s : ksc_s)[t] = sreg[r];
      }
    }
  };

  __syncthreads();   // page-table entries and running statistics in place
#pragma unroll
  for (int ti = 0; ti < kStages - 1; ++ti) issue(ti);
  load_scales(0);

  // MMA: warp w owns the P.V units (16 columns of hd) w, w + 8, ..
  const int units = MMA ? hd / 16 : 0;
  float accm[MMA ? kNPW : 1][2][4];
#pragma unroll
  for (int a = 0; a < (MMA ? kNPW : 1); ++a)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accm[a][j][e] = 0.f;
  // CUDA cores P.V: this thread's VP elements of hd, its slot group
  const int pv_groups = kThreads / gm.dc;
  const bool pv = !MMA && tid < pv_groups * gm.dc;
  const int dchunk = pv ? tid % gm.dc : 0, r_pv = pv ? tid / gm.dc : 0;
  float acc[MAXG][VP];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < VP; ++e) acc[g][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    issue(i + kStages - 1);                    // into the stage tile i - 1 freed
    if constexpr (!NARROW) cp_async_wait<kStages - 1>();   // tile i is here
    if constexpr (QUANT) {
      store_scales();
      load_scales(i + 1);
    }
    __syncthreads();                           // every thread's copies landed
    const unsigned char* ks = smem + (i % kStages) * stage_bytes;
    const unsigned char* vs = ks + tile * pitch;
    const int t_valid = s_end - (s0 + i * tile);   // valid slots of the tile
    // scores of the tile's slots, all query heads
    if constexpr (MMA) {
      for (int nt = warp; nt < tile / 8; nt += kWarps) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        const unsigned char* kr = ks + (nt * 8 + (lane & 7)) * pitch
                                  + ((lane >> 3) & 1) * 16;
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          if (st * 16 < hd) {
            uint32_t b0, b1;
            ldmatrix_x2(b0, b1, kr + st * 32);
            mma_rows8(c, qa[st][0], qa[st][1], b0, b1);
          }
        }
        const int g = lane >> 2, t = nt * 8 + (lane & 3) * 2;
        float* sr = sc + t * MAXG + g;
        sr[0] = t < t_valid ? c[0] * scale : -INFINITY;
        sr[MAXG] = t + 1 < t_valid ? c[1] * scale : -INFINITY;
      }
    } else {
#pragma unroll 2
      for (int t = gi; t < tile; t += gm.groups) {
        float dot[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int ch = part + c * lanes;
          if (ch < gm.scpr) {
            float kf[SVE];
            load_smem<T, SVE>(ks + t * pitch + ch * SVE * ELT, kf);
#pragma unroll
            for (int g = 0; g < MAXG; ++g)
#pragma unroll
              for (int e = 0; e < SVE; ++e) dot[g] += qr[g][c][e] * kf[e];
          }
        }
        constexpr int R = MAXG >= 4 ? MAXG / 4 : 1;   // heads a lane ends with
        const int h0 = sum_over_lanes<MAXG>(dot, lanes, part);
        if (part % (lanes / (MAXG / R)) == 0) {
          const float f = scale * (QUANT ? ksc_s[t] : 1.f);
#pragma unroll
          for (int jj = 0; jj < R; ++jj)
            sc[t * MAXG + h0 + jj] = t < t_valid ? dot[jj] * f : -INFINITY;
        }
      }
    }
    __syncthreads();
    // one max and one rescale per query head: warp w takes head w
    for (int g = warp; g < G; g += kWarps) {
      float* s = sc + g;
      float tmax = -INFINITY;
#pragma unroll 4
      for (int t = lane; t < tile; t += 32) tmax = fmaxf(tmax, s[t * MAXG]);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(tmax));
      const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      float sum = 0.f;
#pragma unroll 4
      for (int t = lane; t < tile; t += 32) {
        const float x = s[t * MAXG];
        const float p = x == -INFINITY ? 0.f : expf(x - m_new);
        sum += p;
        if constexpr (MMA) {   // P as hi + lo bf16 terms for the tensor cores
          const __nv_bfloat16 hi = __float2bfloat16(p);
          const __nv_bfloat16 lo = __float2bfloat16(p - __bfloat162float(hi));
          reinterpret_cast<__nv_bfloat16*>(p_hi + g * pp)[t] = hi;
          reinterpret_cast<__nv_bfloat16*>(p_lo + g * pp)[t] = lo;
        } else {
          s[t * MAXG] = QUANT ? p * vsc_s[t] : p;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();
    // P.V
    if constexpr (MMA) {
      const int g = lane >> 2;
      const float a = g < G ? alpha_s[g] : 0.f;
      const int poff = (lane & 7) * pp + ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int pi = 0; pi < kNPW; ++pi) {
        const int u = warp + pi * kWarps;
        if (u < units) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            accm[pi][jj][0] *= a;
            accm[pi][jj][1] *= a;
          }
          const unsigned char* vb0 =
              vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * pitch +
              (u * 16 + (lane >> 4) * 8) * 2;
          for (int kt = 0; kt < tile / 16; ++kt) {
            uint32_t h0, h2, l0, l2, bv[4];
            ldmatrix_x2(h0, h2, p_hi + poff + kt * 32);
            ldmatrix_x2(l0, l2, p_lo + poff + kt * 32);
            ldmatrix_x4_trans(bv, vb0 + kt * 16 * pitch);
            mma_rows8(accm[pi][0], h0, h2, bv[0], bv[1]);
            mma_rows8(accm[pi][1], h0, h2, bv[2], bv[3]);
            mma_rows8(accm[pi][0], l0, l2, bv[0], bv[1]);
            mma_rows8(accm[pi][1], l0, l2, bv[2], bv[3]);
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
#pragma unroll 4
      for (int t = r_pv; t < tile; t += pv_groups) {
        float vf[VP];
        load_smem<T, VP>(vs + t * pitch + dchunk * VP * ELT, vf);
        const float* pr = sc + t * MAXG;
        float p[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) p[g] = pr[g];
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
#pragma unroll
          for (int e = 0; e < VP; ++e) acc[g][e] += p[g] * vf[e];
      }
    }
    __syncthreads();                           // stage i % kStages is free
  }
  if constexpr (!NARROW) cp_async_wait<0>();
  __syncthreads();

  // this split's partials: [B, H, splits] max and sum, [B, H, splits, hd]
  auto hrow = [&](int g) -> long {   // g: query head of the KV head
    return (static_cast<long>(b) * H + kvh * G + g) * splits + split;
  };
  if constexpr (MMA) {   // each warp owns its columns: no reduction
    const int g = lane >> 2;
    if (g < G) {
#pragma unroll
      for (int pi = 0; pi < kNPW; ++pi) {
        const int u = warp + pi * kWarps;
        if (u < units) {
          const long base = hrow(g) * hd;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int d = u * 16 + jj * 8 + (lane & 3) * 2;
            part_acc[base + d] = accm[pi][jj][0];
            part_acc[base + d + 1] = accm[pi][jj][1];
          }
        }
      }
    }
    if (tid < G) {
      part_m[hrow(tid)] = m_s[tid];
      part_l[hrow(tid)] = l_s[tid];
    }
  } else {
    // slot groups, then the block's acc per query head
    float* red = reinterpret_cast<float*>(smem);   // [groups][G][hd]
    if (pv) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G)
#pragma unroll
          for (int e = 0; e < VP; ++e)
            red[(r_pv * G + g) * hd + dchunk * VP + e] = acc[g][e];
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i - g * hd;
      float A = 0.f;
      for (int rr = 0; rr < pv_groups; ++rr) A += red[(rr * G + g) * hd + d];
      part_acc[hrow(g) * hd + d] = A;
      if (d == 0) {
        part_m[hrow(g)] = m_s[g];
        part_l[hrow(g)] = l_s[g];
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
  const long m0 = (static_cast<long>(b) * H + kvh * G) * splits;   // [G][splits]
  float* w_s = reinterpret_cast<float*>(smem);   // weights [G][splits]
  float* ls_s = w_s + G * splits;                          // sums [G][splits]
  float* L_s = ls_s + G * splits;                          // totals [G]
  for (int i = tid; i < G * splits; i += kThreads) {       // all loads in flight
    w_s[i] = __ldcg(part_m + m0 + i);
    ls_s[i] = __ldcg(part_l + m0 + i);
  }
  __syncthreads();
  if (tid < G) {
    float* w = w_s + tid * splits;
    const float* ls = ls_s + tid * splits;
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, w[s]);
    float L = 0.f;
    for (int s = 0; s < splits; ++s) {
      w[s] = w[s] == -INFINITY ? 0.f : expf(w[s] - mx);
      L += w[s] * ls[s];
    }
    L_s[tid] = L;
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    const float* w = w_s + g * splits;
    const float* a = part_acc + (m0 + static_cast<long>(g) * splits) * hd + d;
    float A = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) A += w[s] * __ldcg(a + static_cast<long>(s) * hd);
    out[(static_cast<long>(b) * H + kvh * G + g) * hd + d] =
        A / fmaxf(L_s[g], 1e-30f);
  }
  if (tid == 0) counters[b * KV + kvh] = 0;        // ready for the next launch
}

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const void* ks;
  const void* vs;
  const int* pt;
  const int* cur;
  float* scratch;
  float* out;
  int* counters;
  int B, KV, G, hd, page_size, max_pages, n_pages, splits, chunk, tile,
      narrow;
  float scale;
  cudaStream_t stream;
  int* blocks_per_sm;   // non-null: report the occupancy, launch nothing
};

template <typename T, bool NARROW, bool MMA, int NCH, int MAXG>
int launch_one(const Args& a) {
  constexpr bool QUANT = sizeof(T) == 1;
  const Geom gm = geometry(a.hd, sizeof(T), NARROW, MMA);
  // the plan's invariants (the wrapper's `plan` keeps them)
  const bool ok =
      a.tile >= 1 && a.tile <= kMaxRows && a.chunk % a.tile == 0 &&
      a.page_size >= 1 && a.chunk <= (kMaxEntries - 1) * a.page_size &&
      a.splits >= 1 &&
      (a.splits - 1) * a.chunk < a.max_pages * a.page_size &&
      a.splits * a.chunk >= a.max_pages * a.page_size &&
      gm.dc <= kThreads &&
      (MMA ? (a.tile % 16 == 0 && a.hd / 16 <= kNPW * kWarps &&
              a.hd <= 16 * NCH)
           : (a.tile % gm.groups == 0 && gm.scpr <= NCH * gm.lanes &&
              a.G <= MAXG));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Layout ly = layout(gm, a.tile, a.G, a.hd, a.splits, MAXG, MMA, QUANT);
  const size_t smem = static_cast<size_t>(ly.total);
  auto kernel = paged_split_kernel<T, NARROW, MMA, NCH, MAXG>;
  // the dynamic shared-memory limit is an attribute of the function on each
  // device: raised per device as the plans need
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
  const dim3 grid(a.KV, a.B, a.splits);
  Divs dv;
  dv.page = FastDiv(a.page_size);
  dv.row = FastDiv(gm.cpr);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.q, static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const __nv_bfloat16*>(a.ks),
      static_cast<const __nv_bfloat16*>(a.vs), a.pt, a.cur, a.scratch,
      a.scratch + n_part, a.scratch + 2 * n_part, a.out, a.counters, dv, a.KV,
      a.G, a.hd, a.page_size, a.max_pages, a.n_pages, a.splits, a.chunk,
      a.tile, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// CUDA cores: the query heads a thread holds (G <= MAXG)
template <typename T, bool NARROW, int NCH>
int launch_g(const Args& a) {
  if constexpr (!NARROW) {     // the narrow path keeps to two instantiations
    if (a.G <= 1) return launch_one<T, NARROW, false, NCH, 1>(a);
    if (a.G <= 2) return launch_one<T, NARROW, false, NCH, 2>(a);
  }
  if (a.G <= 4) return launch_one<T, NARROW, false, NCH, 4>(a);
  // G > 4 only at hd <= 128, where NCH is 1 (fast) or at most 4 (narrow)
  if constexpr (NCH == 1 || (NARROW && NCH <= 4)) {
    if (a.G <= 8) return launch_one<T, NARROW, false, NCH, 8>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_t(const Args& a) {
  if (a.hd < 1 || a.hd > 256 || a.G < 1 || a.G > kMaxG ||
      (a.G > 4 && a.hd > 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.narrow) {
    if (a.hd <= 32) return launch_g<T, true, 1>(a);
    if (a.hd <= 64) return launch_g<T, true, 2>(a);
    if (a.hd <= 128) return launch_g<T, true, 4>(a);
    return launch_g<T, true, 8>(a);
  }
  if ((a.hd * static_cast<int>(sizeof(T))) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(T) == 2) {   // bf16 on the tensor cores
    if (a.hd % 16 == 0) {
      using B16 = __nv_bfloat16;
      if (a.hd <= 64) return launch_one<B16, false, true, 4, kMaxG>(a);
      if (a.hd <= 128) return launch_one<B16, false, true, 8, kMaxG>(a);
      return launch_one<B16, false, true, 16, kMaxG>(a);
    }
  }
  const Geom gm = geometry(a.hd, sizeof(T), false, false);
  if (gm.scpr <= gm.lanes) return launch_g<T, false, 1>(a);
  if constexpr (sizeof(T) == 4) return launch_g<T, false, 2>(a);   // hd > 128
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(const Args& a, int dtype) {
  if (dtype == 0) return launch_t<float>(a);
  if (dtype == 1) return launch_t<__nv_bfloat16>(a);
  if (dtype == 2) return launch_t<int8_t>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry point for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. `dtype` 0 = float32 arenas, 1 = bfloat16, 2 = int8 with
// bf16 scales (k_scale / v_scale null otherwise); q and out are float32.
// `n_pages` counts the arena's pages, null page included. `scratch` is
// caller-allocated f32, (2 + hd) * n floats with n = B * H * splits: the
// splits' maxima [B, H, splits], their sums, then their accumulators
// [B, H, splits, hd]. `counters` is int32 [B, KV], zero on entry and left
// zero: the merge tickets, which no launch on another stream may share.
// `tile`, `chunk` and `splits` are the wrapper's plan: the kernel checks
// its invariants (chunk a whole number of tiles, the splits covering
// max_pages * page_size with none empty). `narrow` 1 takes the
// element-wise instantiation. Returns the CUDA error code of the launch
// (0 = success); cudaErrorInvalidValue for a geometry the kernel does not
// take (hd > 256, G > 8, or G > 4 with hd > 128), a plan it does not
// share, or an unknown dtype.
extern "C" int paged_decode_launch(const float* q, const void* k_pages,
                                   const void* v_pages, const void* k_scale,
                                   const void* v_scale, const int* page_tables,
                                   const int* cur_pos, float* scratch,
                                   float* out, int* counters, int B, int KV,
                                   int G, int hd, int page_size, int max_pages,
                                   int n_pages, int splits, int chunk,
                                   int tile, int narrow, int dtype,
                                   float scale, void* stream) {
  const Args a{q,        k_pages,   v_pages, k_scale, v_scale,
               page_tables, cur_pos, scratch, out,   counters,
               B,        KV,        G,       hd,      page_size,
               max_pages, n_pages,  splits,  chunk,   tile,
               narrow,   scale,     static_cast<cudaStream_t>(stream),
               nullptr};
  return dispatch(a, dtype);
}

// Blocks of the split kernel one SM holds at once for this geometry (the
// instantiation and shared memory a launch would use), into *blocks.
// Returns the CUDA error code as paged_decode_launch does.
extern "C" int paged_decode_blocks_per_sm(int KV, int G, int hd, int page_size,
                                          int max_pages, int splits, int chunk,
                                          int tile, int narrow, int dtype,
                                          int* blocks) {
  Args a{};
  a.B = 1; a.KV = KV; a.G = G; a.hd = hd; a.page_size = page_size;
  a.max_pages = max_pages; a.splits = splits; a.chunk = chunk; a.tile = tile;
  a.narrow = narrow; a.blocks_per_sm = blocks;
  return dispatch(a, dtype);
}

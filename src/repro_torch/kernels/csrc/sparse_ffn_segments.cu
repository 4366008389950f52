// Segment-gather sparse FFN (float weights, no scales) for Hopper (sm_90a).
//
// Replaces the TPU kernel `sparse_ffn_segments_kernel`
// (src/repro/kernels/sparse_ffn.py:173, `pl.pallas_call` at :203, bodies
// `_kernel` :67 and `_kernel_gated` :81), reached through
// `ops.sparse_ffn_segments`.
//
//   y[B, D] = sum_s rnd(act(x . W_up[seg_s]^T) [* x . W_gate[seg_s]^T]) . W_down[seg_s]
//
// x is f32 or bf16 [B, D] (read as it is, upcast in registers); W_* are
// [N, D] operands of f32 or bf16 given by element strides (sn, sd), so a
// transposed view of a [D, N] weight is read in place; seg_ids int32 [S]
// names blocks of `seg` neurons (a negative id is the zero padding segment
// and contributes 0; a repeated id counts twice). `rnd` rounds the
// activation to the weights' dtype before the down product, as the TPU
// kernel's `act.astype(down_ref.dtype)` does (a no-op for f32). The sums are
// f32 and the result is f32.
//
// What bounds it: at decode batch sizes it is a weight stream. Each gathered
// neuron's weights are read once per matrix: S*seg*D*n_mats*itemsize bytes
// (4.2 MB at the serve_sparse opt-350m shape S = 4, seg = 128, D = 1024,
// f32, 2 matrices: 1.3 us at the H100 SXM's 3.35 TB/s), against 2*B flops
// per weight element, far below the card's ridge point.
//
// What held the first version back (four launches: up partials, act, down,
// sum): a fixed cost a launch and round trips of the partial sums, the
// activations and a [B, D] partial per segment through device memory; each
// block loaded one tile into registers and then computed, nothing in
// flight meanwhile; the down pass read 128-byte pieces of its rows.
// Other ways of streaming the same share were tried on the H100 (PERF.md,
// section 6) and all took about this one's time: a producer warp issuing
// 1-D bulk copies of the 256- or 512-byte up row pieces, or its lanes'
// `cp.async`, or 2-D boxes as here; every thread streaming its own 16-byte
// pieces through a private ring; every thread issuing four `cp.async` of
// each stage. Each streamed far below an SM's share of the memory rate,
// warm or cold alike, and a launch with no live segment takes more than
// half of the serving shape's time: what bounds it is the fixed chain
// (segment ids and x, the cluster barriers and distributed shared-memory
// sums, the ticket) and a per-SM rate that no variant moved, not the
// copies' issue.
//
// What this design does (one launch):
//   * one wave of thread-block clusters of C blocks (the wrapper's
//     `segments_plan` takes C = 16, 8 or 4 from CUDA's occupancy, for the
//     fewest segments on the busiest cluster); cluster k takes segments k,
//     k + clusters, ... in order, and each of its blocks (rank r) a share
//     of every segment: the up (and gate) rows [r * DR, (r + 1) * DR) of
//     its [D, seg] tile (DR = ceil(D / C)), every row's `seg` neurons, and
//     the down rows [r * SR, (r + 1) * SR) (SR = seg / C), whole rows;
//   * the block streams its share in stages of 16 KB through a ring of
//     kSlots slots in shared memory, 5 stages in flight, each slot an
//     mbarrier: an up stage is one 2-D box of a tensor map over the [D, N]
//     up (or gate) storage (16 KB of rows x `seg` neurons, no per-thread
//     address work), a down stage a 1-D bulk copy of each of its whole
//     rows, both by the copy engine; thread 0 issues them, one block
//     barrier a stage;
//   * the up sums: a warp's lanes keep 4 or 8 neurons x NB batch rows of
//     sums each over their rows of the stage (the warps neighbouring
//     neurons, 8 lanes 128 contiguous bytes of a row: no bank conflict),
//     and a butterfly over the lanes that share neurons joins them; the
//     block's partial pre-activations go to shared memory (two buffers,
//     alternating by segment); then a cluster barrier, and each block adds
//     the C ranks' partials of its own SR down rows in rank order through
//     distributed shared memory, applies the activation (and gate) and
//     rounds it to the weights' dtype. The copies of the down rows (and of
//     the next segment) are in flight meanwhile: the ring runs ahead across
//     the barrier;
//   * y for the thread's columns and NB batch rows stays in registers over
//     all the cluster's segments; at the end, as in `sparse_ffn_fused.cu`,
//     the blocks of a cluster add their y in rank order through distributed
//     shared memory (rank r a slice of D / C columns); with one cluster that
//     is the output, else each cluster writes its partial to scratch and the
//     last rank-r block of all clusters to finish (an atomic ticket per
//     slice, in scratch kept per stream, left zero) adds the clusters'
//     partials in cluster order.
// No float atomics: every run gives the same bits.
// Which path a layout takes (the wrapper's `up_fast` / `down_fast`): up and
// gate with unit neuron stride (the model's `w.T` views of its [d, d_ff]
// weights), down with unit column stride (its [d_ff, d] down weight), each
// with 16-byte aligned rows, take the copy engine. Any other strides take
// the general path: the threads load the same stage element by element
// into its slot (the same bits, slower). Not used: the tensor cores
// (mma.sync or wgmma): B <= 8 rows against 16- or 64-row tiles, and at B = 4
// the float32 FMAs (4 a bf16 weight, 2 bytes) need a fifth of the CUDA
// cores' rate at full memory speed.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;        // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = 16 << 10; // a stage's weights (or one down row)
constexpr int kSlots = 6;            // stages in the ring, 5 in flight
constexpr int kMaxSeg = 256;
constexpr int kMaxLive = 1024;       // segments a cluster takes at most
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// the activation as the down product takes it: rounded to W
__device__ __forceinline__ float round_to(float a, float) { return a; }
__device__ __forceinline__ float round_to(float a, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(a));
}

// The V = 16 / sizeof(W) weights of a 16-byte piece, upcast exactly.
__device__ __forceinline__ void unpack(const unsigned char* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void unpack(const unsigned char* p, float (&w)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  w[0] = __uint_as_float(u.x << 16); w[1] = __uint_as_float(u.x & 0xffff0000u);
  w[2] = __uint_as_float(u.y << 16); w[3] = __uint_as_float(u.y & 0xffff0000u);
  w[4] = __uint_as_float(u.z << 16); w[5] = __uint_as_float(u.z & 0xffff0000u);
  w[6] = __uint_as_float(u.w << 16); w[7] = __uint_as_float(u.w & 0xffff0000u);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// mbarriers in shared memory: a slot's copies complete a phase of its
// barrier, which the threads wait on by parity
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
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// this block's shared memory by the copy engine, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}
// the box of tensor map `map` at (c0, c1) into shared memory by the copy
// engine (the tensor memory accelerator), completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar)) : "memory");
}
// orders this thread's earlier shared-memory writes before later copies by
// the copy engine into the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the two halves of a cluster barrier, so that work goes on between them
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// How the 8 warps share an up row of `seg` neurons, seg * itemsize / 16
// pieces of 16 bytes: warp w takes the strip of pieces w % strips (pw <= 8
// pieces, 128 bytes; its lanes take piece lane % pw of rows lane / pw, rgl
// row groups, so that 8 lanes read 128 contiguous bytes), and the wg warps
// of a strip split the rows further.
struct UpLanes {
  int pw, strips, wg, rgl;
};
__host__ __device__ inline UpLanes up_lanes(int seg, int isz) {
  const int pieces = seg * isz / 16;
  UpLanes u;
  u.pw = pieces < 8 ? pieces : 8;
  u.strips = pieces / u.pw;
  u.wg = kWarps / u.strips;
  u.rgl = 32 / u.pw;
  return u;
}

// How a launch cuts one block's share into stages (host and device agree).
struct Geom {
  int dr;      // up rows a block owns: ceil(D / C)
  int sr;      // down rows a block owns: seg / C
  int ru;      // up rows a stage: kStageBytes of them (a 2-D box)
  int pu;      // bytes between an up stage's rows (the box's, dense)
  int rd;      // down rows a stage (whole rows, at least one)
  int pd;      // bytes between a down stage's rows
  int slot;    // bytes of a ring slot
};
__host__ __device__ inline Geom geometry(int D, int seg, int C, int isz) {
  Geom g;
  g.dr = (D + C - 1) / C;
  g.sr = seg / C;
  g.ru = kStageBytes / (seg * isz);
  g.pu = seg * isz;
  g.pd = D * isz;
  g.rd = kStageBytes / g.pd;
  g.rd = g.rd < 1 ? 1 : (g.rd > g.sr ? g.sr : g.rd);
  const int up = g.ru * g.pu, dn = g.rd * g.pd;
  g.slot = static_cast<int>(align128(up > dn ? up : dn));
  return g;
}

// Shared memory: the ring of kSlots stages (also the [NB][D] y of the
// cluster sum) | x [NB][dr] f32 | partial pre-activations
// [2][mats][NB][seg] f32 | the warp groups' up sums [wg][mats][NB][seg] f32
// (wg > 1 only) | activations [NB][sr] f32 | the cluster's live segment ids
// [kMaxLive] | count, flag | the slots' mbarriers.
struct Smem {
  size_t ring, x, pre, red, act, ids, misc, bars, total;
};
__host__ __device__ inline Smem smem_layout(int D, int seg, int C, int isz,
                                            int nb, int mats) {
  Smem m;
  const Geom g = geometry(D, seg, C, isz);
  const UpLanes u = up_lanes(seg, isz);
  const size_t ring = static_cast<size_t>(kSlots) * g.slot;
  const size_t y = static_cast<size_t>(nb) * D * sizeof(float);
  m.ring = 0;
  m.x = align128(ring > y ? ring : y);
  m.pre = m.x + align128(static_cast<size_t>(nb) * g.dr * sizeof(float));
  m.red = m.pre + align128(2ull * mats * nb * seg * sizeof(float));
  m.act = m.red + (u.wg > 1 ? align128(static_cast<size_t>(u.wg) * mats * nb *
                                        seg * sizeof(float)) : 0);
  m.ids = m.act + align128(static_cast<size_t>(nb) * g.sr * sizeof(float));
  m.misc = m.ids + kMaxLive * sizeof(int);
  m.bars = m.misc + 128;
  m.total = m.bars + kSlots * sizeof(uint64_t);
  return m;
}

struct Params {
  CUtensorMap up_map;    // 2-D maps of the [D, N] up / gate storage, boxes of
  CUtensorMap gate_map;  // ru rows x seg neurons (with up_fast only)
  const void* x;       // [B, D] f32 or bf16, contiguous
  const void* w_up;    // [N, D] operands by element strides
  const void* w_gate;  // null: ungated
  const void* w_down;
  const int* seg_ids;  // [S]
  float* part;         // [groups][clusters][NB][D] f32 scratch
  int* tickets;        // [groups][C] int32, zero on entry and exit
  float* out;          // [B, D] f32
  long long sn_up, sd_up, sn_gate, sd_gate, sn_down, sd_down;
  int B, D, S, seg, n_seg, x_bf16, activation, up_fast, down_fast;
};

// The general path: the piece of weights at `src` (V of them, `step`
// elements apart) into the 16 bytes at `dst`, loaded by this thread.
template <typename W>
__device__ __forceinline__ void copy_piece(unsigned char* dst, const W* src,
                                           long long step) {
  constexpr int V = 16 / static_cast<int>(sizeof(W));
  W v[V];
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = src[e * step];
#pragma unroll
  for (int e = 0; e < V; ++e) reinterpret_cast<W*>(dst)[e] = v[e];
}

template <typename W, int KC, int NB, bool GATED>
__global__ void __launch_bounds__(kThreads, 1)
sparse_ffn_segments_kernel(const __grid_constant__ Params p) {
  constexpr int kMats = GATED ? 2 : 1;      // matrices before the activation
  constexpr int kIsz = static_cast<int>(sizeof(W));
  constexpr int V = 16 / kIsz;              // weights a piece
  constexpr int kChunk = kThreads * V;      // down columns a pass of the block
  constexpr int kXr = 16;                   // x values a thread stages
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_clusters = static_cast<int>(gridDim.x) / C;
  const int cl = static_cast<int>(blockIdx.x) / C;
  const int D = p.D, seg = p.seg;
  const Geom gm = geometry(D, seg, C, kIsz);
  const Smem ly = smem_layout(D, seg, C, kIsz, NB, kMats);
  unsigned char* ring = smem + ly.ring;
  float* y_s = reinterpret_cast<float*>(smem + ly.ring);   // once it drains
  float* x_s = reinterpret_cast<float*>(smem + ly.x);
  float* pre_s = reinterpret_cast<float*>(smem + ly.pre);
  float* red_s = reinterpret_cast<float*>(smem + ly.red);
  float* act_s = reinterpret_cast<float*>(smem + ly.act);
  int* ids_s = reinterpret_cast<int*>(smem + ly.ids);
  int* n_live_s = reinterpret_cast<int*>(smem + ly.misc);
  int* flag_s = n_live_s + 1;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ly.bars);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) mbar_init(full + i, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // this block's share of every segment, in stages: up (and gate) rows
  // [d0, d0 + n_up_rows) ru a stage, then down rows [j0, j0 + sr) rd a stage
  const int dr = gm.dr, sr = gm.sr;
  const int d0 = min(rank * dr, D);
  const int n_up_rows = min(dr, D - d0);
  const int j0 = rank * sr;
  const int n_up = (n_up_rows + gm.ru - 1) / gm.ru;   // stages a matrix
  const int n_ups = kMats * n_up;
  const int per_seg = n_ups + (sr + gm.rd - 1) / gm.rd;
  const int pr = seg * kIsz / 16, lg_pr = __ffs(pr) - 1;   // pieces a row
  const int ppr = D / V;                    // pieces a down row
  // the thread's up pieces: `col` of rows rgi, rgi + rgt, ... of a stage
  const UpLanes ul = up_lanes(seg, kIsz);
  const int wgi = warp / ul.strips;
  const int col = (warp % ul.strips) * ul.pw + lane % ul.pw;
  const int rgi = wgi * ul.rgl + lane / ul.pw, rgt = ul.wg * ul.rgl;

  // x of a group's rows at the block's up rows, f32 (zeros past B), into
  // registers first: its loads overlap whatever comes next
  float xr[kXr];
  auto load_x = [&](int b0) {
    const int nb = min(NB, p.B - b0);
#pragma unroll
    for (int i = 0; i < kXr; ++i) {
      const int e = tid + i * kThreads;
      float v = 0.f;
      if (e < NB * dr) {
        const int b = e / dr, r = e - b * dr;
        if (b < nb && r < n_up_rows) {
          const size_t at = static_cast<size_t>(b0 + b) * D + d0 + r;
          v = p.x_bf16 ? to_float(static_cast<const __nv_bfloat16*>(p.x)[at])
                       : static_cast<const float*>(p.x)[at];
        }
      }
      xr[i] = v;
    }
  };
  load_x(0);

  // the cluster's live segments, in order: warp 0 compacts them
  if (warp == 0) {
    int n = 0;
    for (int j = 0; cl + j * n_clusters < p.S; j += 32) {
      const int s = cl + (j + lane) * n_clusters;
      int id = -1;
      if (s < p.S) {
        id = __ldg(p.seg_ids + s);
        if (id >= p.n_seg) __trap();    // a caller bug
      }
      const unsigned m = __ballot_sync(~0u, id >= 0);
      if (id >= 0) ids_s[n + __popc(m & ((1u << lane) - 1u))] = id;
      n += __popc(m);
    }
    if (lane == 0) *n_live_s = n;
  }
  __syncthreads();
  const int n_live = *n_live_s;
  const int total = n_live * per_seg;

  const W* w_up = static_cast<const W*>(p.w_up);
  const W* w_gate = static_cast<const W*>(p.w_gate);
  const W* w_down = static_cast<const W*>(p.w_down);
  // Global stage gs (stage gs - base of the group's stream) into slot
  // gs % kSlots: up rows of the k-th live segment, then its down rows. On
  // the fast paths thread 0 has the copy engine bring the stage (an up
  // stage one 2-D box of the tensor map, a down stage a bulk copy a row)
  // and the others arrive; on the general path every thread loads its
  // pieces and arrives. The slot's barrier completes with all 256 arrivals
  // and the copies' bytes.
  auto issue = [&](int gs, int base) {
    const int s = gs - base;
    if (s >= total) return;
    const int k = s / per_seg, l = s - k * per_seg;
    const long long n_base = static_cast<long long>(ids_s[k]) * seg;
    unsigned char* slot = ring + static_cast<size_t>(gs % kSlots) * gm.slot;
    uint64_t* bar = full + gs % kSlots;
    if (l < n_ups) {
      const int m = l / n_up, r0 = (l - m * n_up) * gm.ru;
      if (p.up_fast) {
        if (tid == 0) {
          mbar_expect_tx(bar, static_cast<unsigned>(gm.ru * gm.pu));
          tma_load_2d(slot, m == 0 ? &p.up_map : &p.gate_map,
                      static_cast<int>(n_base), d0 + r0, bar);
        } else {
          mbar_arrive(bar);
        }
        return;
      }
      const int nr = min(gm.ru, n_up_rows - r0);
      const W* w = m == 0 ? w_up : w_gate;
      const long long sn = m == 0 ? p.sn_up : p.sn_gate;
      const long long sd = m == 0 ? p.sd_up : p.sd_gate;
      for (int pi = tid; pi < nr * pr; pi += kThreads) {
        const int r = pi >> lg_pr, c = pi & (pr - 1);
        copy_piece(slot + r * gm.pu + c * 16,
                   w + (n_base + c * V) * sn + (d0 + r0 + r) * sd, sn);
      }
    } else {
      const int r0 = (l - n_ups) * gm.rd, nr = min(gm.rd, sr - r0);
      const W* rows = w_down + (n_base + j0 + r0) * p.sn_down;
      if (p.down_fast) {
        if (tid == 0) {
          mbar_expect_tx(bar, static_cast<unsigned>(nr * gm.pd));
          for (int r = 0; r < nr; ++r)
            bulk_copy(slot + r * gm.pd, rows + r * p.sn_down,
                      static_cast<unsigned>(gm.pd), bar);
        } else {
          mbar_arrive(bar);
        }
        return;
      }
      for (int r = 0; r < nr; ++r) {
#pragma unroll
        for (int k2 = 0; k2 < KC; ++k2) {
          const int pc = tid + k2 * kThreads;
          if (pc < ppr)
            copy_piece(slot + r * gm.pd + pc * 16,
                       rows + r * p.sn_down +
                           static_cast<long long>(pc) * V * p.sd_down,
                       p.sd_down);
        }
      }
    }
    fence_proxy_async();    // before the copy engine writes the slot again
    mbar_arrive(bar);
  };

  const int n_groups = (p.B + NB - 1) / NB;
  int base = 0;     // stages of the earlier groups: the barriers' phases go on
  for (int g = 0; g < n_groups; ++g) {
    const int b0 = g * NB;
    const int nb = min(NB, p.B - b0);
    if (g > 0) load_x(b0);
    for (int s = 0; s < kSlots - 1; ++s) issue(base + s, base);
#pragma unroll
    for (int i = 0; i < kXr; ++i)
      if (tid + i * kThreads < NB * dr) x_s[tid + i * kThreads] = xr[i];
    float y[KC][NB][V];
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int v = 0; v < V; ++v) y[k][b][v] = 0.f;
    float acc[kMats][NB][V];

    int ks = 0, l = 0;          // the stage's segment, and its stage in it
#pragma unroll 1
    for (int s = 0; s < total; ++s) {
      const int gs = base + s;
      mbar_wait(full + gs % kSlots, (gs / kSlots) & 1);   // stage s is in
      __syncthreads();                 // and stage s - 1 consumed
      issue(gs + kSlots - 1, base);    // into the slot stage s - 1 freed
      const unsigned char* slot =
          ring + static_cast<size_t>(gs % kSlots) * gm.slot;
      if (l == 0) {
#pragma unroll
        for (int m = 0; m < kMats; ++m)
#pragma unroll
          for (int b = 0; b < NB; ++b)
#pragma unroll
            for (int v = 0; v < V; ++v) acc[m][b][v] = 0.f;
      }
      if (l == n_ups) {
        // the segment's up sums are complete: join the lanes of a piece (a
        // butterfly, fixed order), then the warp groups in order, into the
        // block's partials (buffer ks & 1)
        const int par = ks & 1;
        for (int o = ul.pw; o < 32; o <<= 1) {
#pragma unroll
          for (int m = 0; m < kMats; ++m)
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[m][b][v] += __shfl_xor_sync(~0u, acc[m][b][v], o);
        }
        float* sums = ul.wg > 1 ? red_s + wgi * kMats * NB * seg
                                : pre_s + par * kMats * NB * seg;
        if (lane < ul.pw) {
#pragma unroll
          for (int m = 0; m < kMats; ++m)
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
              for (int v = 0; v < V; ++v)
                sums[(m * NB + b) * seg + col * V + v] = acc[m][b][v];
        }
        if (ul.wg > 1) {
          __syncthreads();
          for (int e = tid; e < kMats * NB * seg; e += kThreads) {
            float t = 0.f;
            for (int gi = 0; gi < ul.wg; ++gi)
              t += red_s[gi * kMats * NB * seg + e];
            pre_s[par * kMats * NB * seg + e] = t;
          }
        }
        cluster.sync();   // every rank's partials of this segment are in
        // this block's down rows: the C ranks' partials in rank order
        for (int e = tid; e < NB * sr; e += kThreads) {
          const int b = e / sr, jj = e - b * sr;
          const int at = (par * kMats * NB + b) * seg + j0 + jj;
          float u[16], gt[16];
#pragma unroll
          for (int rr = 0; rr < 16; ++rr) {
            u[rr] = gt[rr] = 0.f;
            if (rr < C) {
              const float* q = cluster.map_shared_rank(pre_s, rr);
              u[rr] = q[at];
              if (GATED) gt[rr] = q[at + NB * seg];
            }
          }
          float su = 0.f, sg = 0.f;
#pragma unroll
          for (int rr = 0; rr < 16; ++rr) {
            su += u[rr];
            if (GATED) sg += gt[rr];
          }
          float a = activate(su, p.activation);
          if (GATED) a *= sg;
          act_s[e] = round_to(a, W());
        }
        __syncthreads();
      }
      if (l < n_ups) {
        // up (and gate) rows: this thread's rows of the stage, V neurons
        const int m = l / n_up, r0 = (l - m * n_up) * gm.ru;
        const int nr = min(gm.ru, n_up_rows - r0);
#pragma unroll
        for (int mm = 0; mm < kMats; ++mm) {
          if (mm == m) {
            for (int r = rgi; r < nr; r += rgt) {
              float w[V];
              unpack(slot + r * gm.pu + col * 16, w);
#pragma unroll
              for (int b = 0; b < NB; ++b) {
                const float xv = x_s[b * dr + r0 + r];
#pragma unroll
                for (int v = 0; v < V; ++v) acc[mm][b][v] += xv * w[v];
              }
            }
          }
        }
      } else {
        // down rows: y += act * row over the thread's columns
        const int r0 = (l - n_ups) * gm.rd, nr = min(gm.rd, sr - r0);
        for (int r = 0; r < nr; ++r) {
          float a[NB];
#pragma unroll
          for (int b = 0; b < NB; ++b) a[b] = act_s[b * sr + r0 + r];
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            const int pc = tid + k * kThreads;
            if (pc < ppr) {
              float w[V];
              unpack(slot + r * gm.pd + pc * 16, w);
#pragma unroll
              for (int b = 0; b < NB; ++b)
#pragma unroll
                for (int v = 0; v < V; ++v) y[k][b][v] += a[b] * w[v];
            }
          }
        }
      }
      if (++l == per_seg) {
        l = 0;
        ++ks;
      }
    }
    base += total;
    __syncthreads();                 // every stage consumed: the ring is free

    // -- the cluster's sum, rank r a slice of columns ------------------------
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = k * kChunk + V * tid;
      if (c < D) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int v = 0; v < V; v += 4)
            *reinterpret_cast<float4*>(y_s + b * D + c + v) =
                make_float4(y[k][b][v], y[k][b][v + 1], y[k][b][v + 2],
                            y[k][b][v + 3]);
      }
    }
    fence_proxy_async();             // y_s before the next group's copies
    cluster.sync();
    const int slice = ((D + 4 * C - 1) / (4 * C)) * 4;   // columns a rank sums
    const int c0 = min(rank * slice, D), c1 = min(c0 + slice, D);
    const int q4 = (c1 - c0) / 4;
    const bool alone = n_clusters == 1;   // the cluster's sum is the output
    float* part = p.part + (static_cast<size_t>(g) * n_clusters + cl) * NB * D;
    for (int i = tid; i < nb * q4; i += kThreads) {
      const int b = i / q4, c = c0 + (i - b * q4) * 4;
      float4 v4[16];
#pragma unroll
      for (int rr = 0; rr < 16; ++rr)
        v4[rr] = rr < C ? *reinterpret_cast<const float4*>(
                              cluster.map_shared_rank(y_s + b * D + c, rr))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 acc4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        acc4.x += v4[rr].x; acc4.y += v4[rr].y;
        acc4.z += v4[rr].z; acc4.w += v4[rr].w;
      }
      float* dst = alone ? p.out + static_cast<size_t>(b0 + b) * D + c
                         : part + b * D + c;
      *reinterpret_cast<float4*>(dst) = acc4;
    }
    // done with the ranks' shared memory: arrive now, wait before this
    // block refills its ring or x_s, or leaves
    cluster_arrive();

    // -- the last cluster of slice r adds the clusters in order ---------------
    if (!alone) {
      int* ticket = p.tickets + g * C + rank;
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        *flag_s = atomicAdd(ticket, 1) == n_clusters - 1;
      }
      __syncthreads();
      if (*flag_s) {
        __threadfence();
        const float* parts =
            p.part + static_cast<size_t>(g) * n_clusters * NB * D;
        for (int i = tid; i < nb * q4; i += kThreads) {
          const int b = i / q4, c = c0 + (i - b * q4) * 4;
          float4 acc4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
          for (int k = 0; k < n_clusters; ++k) {
            const float4 v4 = __ldcg(reinterpret_cast<const float4*>(
                parts + (static_cast<size_t>(k) * NB + b) * D + c));
            acc4.x += v4.x; acc4.y += v4.y; acc4.z += v4.z; acc4.w += v4.w;
          }
          *reinterpret_cast<float4*>(p.out + static_cast<size_t>(b0 + b) * D +
                                     c) = acc4;
        }
        if (tid == 0) *ticket = 0;     // ready for the next launch
      }
    }
    cluster_wait();
  }
}

template <typename W, int KC, int NB, bool GATED>
int launch_one(const Params& p, int blocks, int cluster, cudaStream_t stream,
               int* max_clusters) {
  auto kernel = sparse_ffn_segments_kernel<W, KC, NB, GATED>;
  if (KC * kThreads * (16 / static_cast<int>(sizeof(W))) < p.D)
    return static_cast<int>(cudaErrorInvalidValue);   // y would miss columns
  const size_t smem =
      smem_layout(p.D, p.seg, cluster, sizeof(W), NB, GATED ? 2 : 1).total;
  // the function's attributes are kept per device: raised as the widths
  // need, clusters of 16 (above the portable 8) allowed
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
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) smem_set[device] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg));
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// KC (chunks of kThreads * V columns) and NB from D and the wrapper's group
// size: D <= 1024 takes NB 4 or 8, D <= 4096 NB 4, D <= 8192 NB 2 (y in
// registers: KC * NB * V <= 64 floats).
template <typename W, bool GATED>
int launch_kc(const Params& p, int nb, int blocks, int cluster,
              cudaStream_t stream, int* max_clusters) {
  constexpr int kChunk = kThreads * 16 / static_cast<int>(sizeof(W));
  if (p.D <= 1024 && nb == 4)
    return launch_one<W, 1, 4, GATED>(p, blocks, cluster, stream, max_clusters);
  if (p.D <= 1024 && nb == 8)
    return launch_one<W, 1, 8, GATED>(p, blocks, cluster, stream, max_clusters);
  if (p.D <= 4096 && nb == 4)
    return launch_one<W, 4096 / kChunk, 4, GATED>(p, blocks, cluster, stream,
                                                  max_clusters);
  if (p.D <= 8192 && nb == 2)
    return launch_one<W, 8192 / kChunk, 2, GATED>(p, blocks, cluster, stream,
                                                  max_clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(const Params& p, int dtype, int nb, int blocks, int cluster,
             cudaStream_t stream, int* max_clusters) {
  const int isz = dtype == 0 ? 4 : 2;
  if (cluster < 1 || cluster > 16 || blocks % cluster != 0 ||
      p.D % (16 / isz) != 0 || p.seg < 32 || p.seg > kMaxSeg ||
      (p.seg & (p.seg - 1)) != 0 || p.seg % cluster != 0 ||
      (p.S + blocks / cluster - 1) / (blocks / cluster) > kMaxLive)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool gated = p.w_gate != nullptr;
  if (dtype == 0)
    return gated ? launch_kc<float, true>(p, nb, blocks, cluster, stream, max_clusters)
                 : launch_kc<float, false>(p, nb, blocks, cluster, stream, max_clusters);
  if (dtype == 1)
    return gated
        ? launch_kc<__nv_bfloat16, true>(p, nb, blocks, cluster, stream, max_clusters)
        : launch_kc<__nv_bfloat16, false>(p, nb, blocks, cluster, stream, max_clusters);
  return static_cast<int>(cudaErrorInvalidValue);
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

// The 2-D tensor map of an [N, D] operand with unit neuron stride (a `.T`
// view of [D, N'] storage, rows sd elements apart): boxes of `rows` rows x
// `seg` neurons, dense in shared memory; rows past D read as zeros.
int encode_up(CUtensorMap* map, const void* w, int N, int D, long long sd,
              int isz, int seg, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(D)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(sd) * isz};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(seg),
                             static_cast<cuuint32_t>(rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = fn(
      map, isz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(w), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry point (loaded with ctypes). Pointers are device pointers; `stream`
// is a cudaStream_t. x is [B, D] contiguous, f32 (`x_bf16` 0) or bf16 (1);
// each weight an [N, D] operand by its element strides (sn, sd), `dtype` 0 =
// float32, 1 = bfloat16 (w_gate null for the ungated FFN). `up_fast` /
// `down_fast` 1 take the copy engine (a tensor map of up and gate, encoded
// here each launch; bulk copies of down rows): the wrapper sets them only
// for the layouts the note above names. `nb` batch rows a group (4 or 8 for D <=
// 1024, 4 for D <= 4096, 2 for D <= 8192); `blocks` a multiple of `cluster`
// (16, 8 or 4, dividing seg), with at most kMaxLive segments a cluster.
// `part` is f32 scratch of groups * (blocks / cluster) * nb * D floats
// (unused with one cluster); `tickets` int32 [groups * cluster], zero on
// entry and left zero: the cross-cluster tickets, which no launch on another
// stream may share. D a multiple of 16 / itemsize, seg a power of two from
// 32 to 256; a segment id >= N / seg traps. Returns the CUDA error code of
// the launch (0 = success); cudaErrorInvalidValue for a geometry it does
// not take.
extern "C" int sparse_ffn_segments_launch(
    const void* x, const void* w_up, const void* w_gate, const void* w_down,
    const int* seg_ids, float* part, int* tickets, float* out, int B, int D,
    int N, int S, int seg, long long sn_up, long long sd_up,
    long long sn_gate, long long sd_gate, long long sn_down,
    long long sd_down, int x_bf16, int dtype, int activation, int up_fast,
    int down_fast, int nb, int blocks, int cluster, void* stream) {
  Params p{};
  p.x = x;
  p.w_up = w_up;
  p.w_gate = w_gate;
  p.w_down = w_down;
  p.seg_ids = seg_ids;
  p.part = part;
  p.tickets = tickets;
  p.out = out;
  p.sn_up = sn_up;
  p.sd_up = sd_up;
  p.sn_gate = sn_gate;
  p.sd_gate = sd_gate;
  p.sn_down = sn_down;
  p.sd_down = sd_down;
  p.B = B;
  p.D = D;
  p.S = S;
  p.seg = seg;
  p.n_seg = N / seg;
  p.x_bf16 = x_bf16;
  p.activation = activation;
  p.up_fast = up_fast;
  p.down_fast = down_fast;
  if (up_fast && cluster >= 1 && seg >= 32) {
    const int isz = dtype == 0 ? 4 : 2;
    const int rows = geometry(D, seg, cluster, isz).ru;
    int err = encode_up(&p.up_map, w_up, N, D, sd_up, isz, seg, rows);
    if (err == 0 && w_gate != nullptr)
      err = encode_up(&p.gate_map, w_gate, N, D, sd_gate, isz, seg, rows);
    if (err != 0) return err;
  }
  return dispatch(p, dtype, nb, blocks, cluster,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// Clusters of `cluster` blocks of the instantiation a launch at these widths
// would use that the card holds at once, into *clusters. Returns the CUDA
// error code as the launch does.
extern "C" int sparse_ffn_segments_max_clusters(int D, int seg, int dtype,
                                                int gated, int nb,
                                                int cluster, int* clusters) {
  static const int dummy = 0;
  Params p{};
  p.D = D;
  p.seg = seg;
  p.S = 1;
  p.w_gate = gated ? &dummy : nullptr;
  return dispatch(p, dtype, nb, cluster, cluster, nullptr, clusters);
}

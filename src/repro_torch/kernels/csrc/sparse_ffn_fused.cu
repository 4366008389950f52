// Fused segment-gather sparse FFN for Hopper (sm_90a).
//
// Replaces the TPU kernel `sparse_ffn_segments_fused_kernel`
// (src/repro/kernels/sparse_ffn.py:130, `pl.pallas_call` at :165, bodies
// `_kernel_fused` and `_kernel_fused_gated`), reached through
// `ops.sparse_ffn_segments_fused`.
//
//   y[B, D] = sum_s act(x . (W_up[seg_s] o sv_s)^T) [* x . (W_gate[seg_s] o sv_s)^T]
//                   . (W_down[seg_s] o sv_s)
//
// x is f32 [B, D]; W_* are [N, D] raw storage rows (f32, bf16 or int8, the
// three alike); seg_ids int32 [S] names seg-row blocks of W (an id outside
// [0, N / seg), -1 in practice, is padding); scale_tiles f32 [S, seg] is the
// per-neuron dequant scale x activated-union membership, so a 0 entry
// removes a neuron exactly (act(0) == 0 for every activation). The math is
// float32 on the CUDA cores: int8 and bf16 rows are upcast exactly, the
// multiplier applied to the row's dot products and to its activation.
//
// What bounds it: at decode batch sizes (B <= 8) it is a weight stream. Each
// live neuron row (valid id, non-zero multiplier) is read once per matrix
// and used for 2 * B flops a weight element, far below the card's ridge
// point: about 31 MB for the opt-350m main path's layer (S = 32, seg = 128,
// D = 1024, f32, 2 matrices, 94% live), 0.0094 ms at the H100 SXM's
// 3.35 TB/s.
//
// What held the first version back (three launches): the activations and
// one [B, D] partial per segment made round trips through device memory, a
// warp took one row and re-read x through L1 for every 16 bytes of weight,
// and the down pass read activations and multipliers with scalar loads.
//
// What this design does (one launch):
//   * the grid is one wave of thread-block clusters (the wrapper sizes it
//     from the occupancy CUDA reports); block i takes rows [i * rpb,
//     (i + 1) * rpb) of the flattened [S * seg] tile and compacts its live
//     rows (row index, multiplier) into shared memory in order: rows that
//     are not live are never read;
//   * x comes once per block (groups of NB batch rows; B > NB runs the
//     groups in turn and streams the rows again) and each thread keeps its
//     columns of it in registers;
//   * warp specialisation: one producer warp streams the block's live rows,
//     a tile of R rows at a time (its up rows, [gate rows,] down rows), as
//     whole rows through a ring of kStages slots in shared memory, each
//     slot a pair of mbarriers (full, empty): its lane 0 has the copy
//     engine bring each row in one 1-D bulk copy (`cp.async.bulk`); rows
//     whose bytes are no multiple of 16 come by `cp.async` of 8 or 4 bytes
//     from its 32 lanes instead;
//   * 8 consumer warps own the columns, 4 of each 1024-column chunk a
//     thread: for the up pass a thread dots its columns with x for the
//     tile's R rows and NB batch rows (R * NB * (1 + gated) <= 32 sums in
//     registers), and one butterfly reduce-scatter a warp (31 shuffles for
//     32 sums) and a fixed-order sum over the 8 warps give the tile's
//     pre-activations; the activations go to shared memory; for the down
//     pass the thread keeps y for its columns and the NB batch rows in
//     registers; a warp releases a slot as soon as it is done with it;
//   * the blocks of a cluster add their y in rank order through distributed
//     shared memory, rank r a slice of D / C columns, and write the
//     cluster's partial to scratch (it stays in L2); the last rank-r block
//     of all clusters to finish (an atomic ticket per slice, in scratch the
//     wrapper keeps per stream, left zero for the next launch) adds the
//     clusters' partials in cluster order. No float atomics: every run
//     gives the same bits, whichever block comes last.
// Earlier steps of this design, tried on the H100 (PERF.md, section 6): every
// thread issuing 16-byte `cp.async` with a block barrier a stage, and
// stages of one 1024-column chunk of R rows, left the copies and the
// arithmetic unoverlapped; the producer warp and whole-row copies overlap
// them. What remains: a fixed cost a launch that no row stream hides (the
// compaction and the first copies, then the cluster sum, the ticket and
// the last block's sum), and the float32 arithmetic itself at B = 4.
// Not used: wgmma (M >= 64 against B <= 8 rows, and rounding x to bf16 or
// tf32 would leave the float32 tolerance) and tensor maps (the rows are
// contiguous: 1-D bulk copies need none).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumers = 256;         // 8 warps own the columns
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;   // and one warp issues the copies
constexpr int kChunk = 4 * kConsumers;  // columns a stage row holds
constexpr int kMaxRpb = 2048;           // flattened rows a block may own
constexpr int kRingBytes = 128 << 10;   // the ring's budget of shared memory
constexpr int kMaxDevices = 64;         // devices whose smem limit is kept

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

// 4 consecutive weights of a stage row, upcast exactly to float.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// `unit` bytes (16, 8 or 4) from global to shared memory without passing
// through registers.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int unit) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (unit == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src) : "memory");
  else if (unit == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src) : "memory");
}
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarriers in shared memory: a ring slot's (and x's) copies complete a
// phase of its barrier, which the threads wait on by parity.
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
// a barrier of the consumer warps alone (the producer warp goes on)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
// the barrier's arrival once this thread's earlier cp.async copies land
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
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
// this block's shared memory by the copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}
// orders this thread's earlier shared-memory writes before later copies by
// the copy engine into the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Sum of v[i] over the warp's lanes for all V <= 32 indices at once: lane l
// ends with the sum of index l % V (31 shuffles for V = 32, not 5 a sum).
// Step S: with fewer sums than lanes fold the halves of the warp; with 2S
// sums left keep the half that bit S of the lane names.
template <int S, int V>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float (&v)[V], int lane) {
    if constexpr (S >= V) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] += __shfl_xor_sync(~0u, v[i], S);
    } else {
      const bool upper = lane & S;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const float send = upper ? v[i] : v[i + S];
        const float keep = upper ? v[i + S] : v[i];
        v[i] = keep + __shfl_xor_sync(~0u, send, S);
      }
    }
    ReduceScatter<S / 2, V>::run(v, lane);
  }
};
template <int V>
struct ReduceScatter<0, V> {
  static __device__ __forceinline__ void run(float (&)[V], int) {}
};

template <int V>
__device__ __forceinline__ float reduce_scatter(float (&v)[V], int lane) {
  ReduceScatter<16, V>::run(v, lane);
  return v[0];
}

// The shape of one instantiation: KC chunks of 1024 columns (D <= KC *
// 1024), NB batch rows a group, tiles of R rows.
template <typename W, int KC, int NB, bool GATED>
struct Shape {
  static constexpr int kMats = GATED ? 2 : 1;            // matrices before act
  static constexpr int kR = (32 / (NB * kMats)) < 8 ? 32 / (NB * kMats) : 8;
  static constexpr int kV = kR * NB * kMats;             // sums a thread keeps
  static constexpr int kStageBytes = kR * kChunk * static_cast<int>(sizeof(W));
  static constexpr int kStagesRaw = kRingBytes / kStageBytes;
  static constexpr int kStages =
      kStagesRaw < 3 ? 3 : (kStagesRaw > 8 ? 8 : kStagesRaw);
  static_assert(kV <= 32 && (kV & (kV - 1)) == 0, "sums must fill a warp");
};

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// Shared memory: x [NB][D] f32 | ring (also the [NB][D] y of the cluster
// sum) | live rows [kMaxRpb] int | their multipliers [kMaxRpb] f32 | warp
// sums [kWarps][32] | activations [32] | warp counts [kWarps] + flag |
// mbarriers: full [kStages], empty [kStages] (the ring's slots), x.
struct Smem {
  size_t x, ring, rows, sv, red, act, misc, bars, total;
};
template <typename W, int KC, int NB, bool GATED>
__host__ __device__ inline Smem smem_layout(int D) {
  using Sh = Shape<W, KC, NB, GATED>;
  Smem m;
  const size_t xy = static_cast<size_t>(NB) * D * sizeof(float);
  const size_t ring = static_cast<size_t>(Sh::kStages) * Sh::kStageBytes;
  m.x = 0;
  m.ring = align128(xy);
  m.rows = m.ring + align128(ring > xy ? ring : xy);
  m.sv = m.rows + kMaxRpb * sizeof(int);
  m.red = m.sv + kMaxRpb * sizeof(float);
  m.act = m.red + kWarps * 32 * sizeof(float);
  m.misc = m.act + 32 * sizeof(float);
  m.bars = align128(m.misc + (kWarps + 2) * sizeof(int));
  m.total = m.bars + (2 * Sh::kStages + 1) * sizeof(uint64_t);
  return m;
}

struct Params {
  const float* x;
  const void* w_up;
  const void* w_gate;
  const void* w_down;
  const int* seg_ids;
  const float* scale_tiles;
  float* part;        // [groups][clusters][NB][D] f32 scratch
  int* tickets;       // [groups][cluster size] int32, zero on entry and exit
  float* out;         // [B, D] f32
  int B, D, S, seg, n_seg, rpb, activation, unit;
};

template <typename W, int KC, int NB, bool GATED>
__global__ void __launch_bounds__(kThreads, 1)
sparse_ffn_fused_kernel(const Params p) {
  using Sh = Shape<W, KC, NB, GATED>;
  constexpr int R = Sh::kR, V = Sh::kV, STAGES = Sh::kStages;
  constexpr int SB = Sh::kStageBytes;
  constexpr int kIsz = static_cast<int>(sizeof(W));
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem ly = smem_layout<W, KC, NB, GATED>(p.D);
  float* x_s = reinterpret_cast<float*>(smem + ly.x);
  unsigned char* ring = smem + ly.ring;
  float* y_s = reinterpret_cast<float*>(smem + ly.ring);   // once it drains
  int* rows_s = reinterpret_cast<int*>(smem + ly.rows);
  float* sv_s = reinterpret_cast<float*>(smem + ly.sv);
  float* red_s = reinterpret_cast<float*>(smem + ly.red);
  float* act_s = reinterpret_cast<float*>(smem + ly.act);
  int* wcount_s = reinterpret_cast<int*>(smem + ly.misc);
  int* flag_s = wcount_s + kWarps;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ly.bars);
  uint64_t* empty = full + STAGES;
  uint64_t* x_bar = empty + STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int block = static_cast<int>(blockIdx.x);
  const int n_clusters = static_cast<int>(gridDim.x) / C;
  const int cl = block / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool producer = warp == kWarps;   // the last warp issues the copies
  const int D = p.D;

  // Rows whose bytes are a multiple of 16 come by the copy engine's bulk
  // copies, one a row chunk, issued by the producer's lane 0; others by
  // `cp.async` of p.unit bytes from the producer's 32 lanes, each lane's
  // arrival counted. A slot's `empty` barrier counts the consumer warps.
  const bool bulk = p.unit == 16;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, bulk ? 1 : 32);
      mbar_init(empty + i, kWarps);
    }
    mbar_init(x_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // x of batch rows [b0, b0 + NB) into shared memory (rows past B are
  // zeros, written by the consumers), in flight while the block goes on
  auto stage_x = [&](int b0) {
    const int nb = min(NB, p.B - b0);
    if (tid == kConsumers) {
      mbar_expect_tx(x_bar, static_cast<unsigned>(nb * D * sizeof(float)));
      for (int b = 0; b < nb; ++b)
        bulk_copy(x_s + b * D, p.x + static_cast<size_t>(b0 + b) * D,
                  static_cast<unsigned>(D * sizeof(float)), x_bar);
    } else if (tid < kConsumers) {
      for (int i = nb * D / 4 + tid; i < NB * D / 4; i += kConsumers)
        reinterpret_cast<float4*>(x_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      fence_proxy_async();
    }
  };
  stage_x(0);

  // -- the block's live rows, compacted in order ---------------------------
  const int total_rows = p.S * p.seg;
  const int lo = min(block * p.rpb, total_rows);
  const int hi = min(lo + p.rpb, total_rows);
  int n_live = 0;
  for (int base = lo; base < hi; base += kConsumers) {
    const int f = base + tid;
    bool live = false;
    int row = 0;
    float sv = 0.f;
    if (tid < kConsumers && f < hi) {
      const int s = f / p.seg, j = f - s * p.seg;
      const int id = p.seg_ids[s];
      sv = p.scale_tiles[f];
      live = id >= 0 && id < p.n_seg && sv != 0.f;
      row = id * p.seg + j;
    }
    const unsigned m = __ballot_sync(~0u, live);
    if (lane == 0 && warp < kWarps) wcount_s[warp] = __popc(m);
    __syncthreads();
    int before = n_live, total = n_live;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? wcount_s[w] : 0;
      total += wcount_s[w];
    }
    if (live) {
      const int pos = before + __popc(m & ((1u << lane) - 1u));
      rows_s[pos] = row;
      sv_s[pos] = sv;
    }
    n_live = total;
    __syncthreads();
  }

  const int kce = (D + kChunk - 1) / kChunk;   // chunks that hold columns
  const int n_tiles = (n_live + R - 1) / R;
  constexpr int kMatsAll = Sh::kMats + 1;      // up [, gate], down
  // a stage holds RS whole rows of one matrix (KC chunks each, at a pitch
  // of KC * kChunk elements): a tile's R rows of a matrix are kParts stages
  constexpr int RS = R / KC > 0 ? R / KC : 1;
  constexpr int kParts = R / RS;
  constexpr int kPitch = KC * kChunk;
  static_assert(RS * kPitch * kIsz == SB, "a stage fills its slot");
  const int row_bytes = D * kIsz;
  const W* w_up = static_cast<const W*>(p.w_up);
  const W* w_mid = static_cast<const W*>(GATED ? p.w_gate : p.w_down);
  const W* w_down = static_cast<const W*>(p.w_down);

  // global stage gs (its slot gs % STAGES, once the slot's last use is
  // released): `rows` whole rows of matrix mi from live row `first` on.
  // The producer warp calls it.
  auto issue = [&](int gs, int mi, int first, int rows) {
    const int slot = gs % STAGES, use = gs / STAGES;
    if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
    const W* mat = mi == 0 ? w_up : (mi == 1 ? w_mid : w_down);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(mat);
    unsigned char* dst = ring + slot * SB;
    if (bulk) {
      if (lane == 0) {
        mbar_expect_tx(full + slot, static_cast<unsigned>(rows * row_bytes));
        for (int i = 0; i < rows; ++i)
          bulk_copy(dst + i * (kPitch * kIsz),
                    src + static_cast<size_t>(rows_s[first + i]) * row_bytes,
                    static_cast<unsigned>(row_bytes), full + slot);
      }
      return;
    }
    const int units = row_bytes / p.unit;
    for (int idx = lane; idx < rows * units; idx += 32) {
      const int i = idx / units, j = idx - i * units;
      const size_t off = static_cast<size_t>(rows_s[first + i]) * row_bytes;
      cp_async(dst + i * (kPitch * kIsz) + j * p.unit,
               src + off + static_cast<size_t>(j) * p.unit, p.unit);
    }
    mbar_arrive_cp_async(full + slot);
  };
  // a consumer's wait for global stage gs, and its warp's release
  auto acquire = [&](int gs) {
    mbar_wait(full + gs % STAGES, (gs / STAGES) & 1);
    return reinterpret_cast<const W*>(ring + (gs % STAGES) * SB);
  };
  auto release = [&](int gs) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + gs % STAGES);
  };

  int base = 0;   // stages of the earlier groups: the slots' phases go on
  const int n_groups = (p.B + NB - 1) / NB;
  for (int g = 0; g < n_groups; ++g) {
    const int b0 = g * NB;
    if (g > 0) {
      stage_x(b0);
      __syncthreads();          // the zero rows
    }
    float4 y[KC][NB];
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int b = 0; b < NB; ++b) y[k][b] = make_float4(0.f, 0.f, 0.f, 0.f);

    int gs = base;
    if (producer) {
#pragma unroll 1
      for (int t = 0; t < n_tiles; ++t) {
        const int nr = min(R, n_live - t * R);
        for (int mi = 0; mi < kMatsAll; ++mi)
          for (int j = 0; j * RS < nr; ++j)
            issue(gs++, mi, t * R + j * RS, min(RS, nr - j * RS));
      }
    } else {
      // the thread's x columns, in registers for the whole group
      mbar_wait(x_bar, g & 1);
      float4 xv[KC][NB];
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int c = min(k * kChunk + 4 * tid, D - 4);
#pragma unroll
        for (int b = 0; b < NB; ++b)
          xv[k][b] = *reinterpret_cast<const float4*>(x_s + b * D + c);
      }
#pragma unroll 1
      for (int t = 0; t < n_tiles; ++t) {
        const int nr = min(R, n_live - t * R);
        float v[V];
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = 0.f;
        // up (and gate) rows: dot products over the thread's columns
#pragma unroll
        for (int mi = 0; mi < Sh::kMats; ++mi) {
#pragma unroll
          for (int j = 0; j < kParts; ++j) {
            if (j * RS < nr) {
              const W* st = acquire(gs);
#pragma unroll
              for (int i = 0; i < RS; ++i) {
                if (j * RS + i < nr) {
#pragma unroll
                  for (int k = 0; k < KC; ++k) {
                    const int c = k * kChunk + 4 * tid;
                    if (k < kce && c < D) {
                      const float4 w =
                          load4(st + i * kPitch + k * kChunk + 4 * tid);
#pragma unroll
                      for (int b = 0; b < NB; ++b)
                        v[((j * RS + i) * NB + b) * Sh::kMats + mi] +=
                            dot4(xv[k][b], w);
                    }
                  }
                }
              }
              release(gs++);
            }
          }
        }
        // the tile's pre-activations: warp sums, then the warps in order
        red_s[warp * 32 + lane] = reduce_scatter<V>(v, lane);
        consumer_sync();
        if (tid < R * NB) {
          const int r = tid / NB;
          float a = 0.f;
          if (r < nr) {
            const float sv = sv_s[t * R + r];
            float u = 0.f, gsum = 0.f;
            for (int w = 0; w < kWarps; ++w) {
              u += red_s[w * 32 + tid * Sh::kMats];
              if (GATED) gsum += red_s[w * 32 + tid * Sh::kMats + 1];
            }
            a = activate(u * sv, p.activation);
            if (GATED) a *= gsum * sv;
            a *= sv;   // the down row's multiplier
          }
          act_s[tid] = a;
        }
        consumer_sync();                // act_s; red_s free again
        // down rows: y += act * row over the thread's columns
#pragma unroll
        for (int j = 0; j < kParts; ++j) {
          if (j * RS < nr) {
            const W* st = acquire(gs);
#pragma unroll
            for (int i = 0; i < RS; ++i) {
              if (j * RS + i < nr) {
                const int r = j * RS + i;
#pragma unroll
                for (int k = 0; k < KC; ++k) {
                  const int c = k * kChunk + 4 * tid;
                  if (k < kce && c < D) {
                    const float4 w =
                        load4(st + i * kPitch + k * kChunk + 4 * tid);
#pragma unroll
                    for (int b = 0; b < NB; ++b) {
                      const float a = act_s[r * NB + b];
                      y[k][b].x += a * w.x;
                      y[k][b].y += a * w.y;
                      y[k][b].z += a * w.z;
                      y[k][b].w += a * w.w;
                    }
                  }
                }
              }
            }
            release(gs++);
          }
        }
      }
    }
    base = gs;   // the producer and every consumer counted the same stages
    __syncthreads();                 // every stage consumed: the ring is free

    // -- the cluster's sum, rank r a slice of columns ------------------------
    if (!producer) {
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int c = k * kChunk + 4 * tid;
        if (c < D) {
#pragma unroll
          for (int b = 0; b < NB; ++b)
            *reinterpret_cast<float4*>(y_s + b * D + c) = y[k][b];
        }
      }
      fence_proxy_async();           // y_s before the next group's copies
    }
    cluster.sync();
    const int slice = ((D + 4 * C - 1) / (4 * C)) * 4;   // columns a rank sums
    const int c0 = min(rank * slice, D), c1 = min(c0 + slice, D);
    const int q4 = (c1 - c0) / 4;
    float* part = p.part + (static_cast<size_t>(g) * n_clusters + cl) * NB * D;
    for (int i = tid; i < NB * q4; i += kThreads) {
      const int b = i / q4, c = c0 + (i - b * q4) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int q = 0; q < C; ++q) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(y_s + b * D + c, q));
        acc.x += v4.x; acc.y += v4.y; acc.z += v4.z; acc.w += v4.w;
      }
      *reinterpret_cast<float4*>(part + b * D + c) = acc;
    }

    // -- the last cluster of slice r adds the clusters in order ---------------
    int* ticket = p.tickets + g * C + rank;
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      *flag_s = atomicAdd(ticket, 1) == n_clusters - 1;
    }
    __syncthreads();
    if (*flag_s) {
      __threadfence();
      const int nb = min(NB, p.B - b0);
      const float* parts = p.part + static_cast<size_t>(g) * n_clusters * NB * D;
      for (int i = tid; i < nb * q4; i += kThreads) {
        const int b = i / q4, c = c0 + (i - b * q4) * 4;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int k = 0; k < n_clusters; ++k) {
          const float4 v4 = __ldcg(reinterpret_cast<const float4*>(
              parts + (static_cast<size_t>(k) * NB + b) * D + c));
          acc.x += v4.x; acc.y += v4.y; acc.z += v4.z; acc.w += v4.w;
        }
        *reinterpret_cast<float4*>(p.out + static_cast<size_t>(b0 + b) * D +
                                   c) = acc;
      }
      if (tid == 0) *ticket = 0;     // ready for the next launch
    }
    // no block reuses its y_s, flag_s or x_s, or leaves, while another
    // block of the cluster may still read its y_s
    cluster.sync();
  }
}

template <typename W, int KC, int NB, bool GATED>
int launch_one(const Params& p, int blocks, int cluster, cudaStream_t stream,
               int* max_clusters) {
  auto kernel = sparse_ffn_fused_kernel<W, KC, NB, GATED>;
  const size_t smem = smem_layout<W, KC, NB, GATED>(p.D).total;
  // the dynamic shared-memory limit is an attribute of the function on each
  // device: raised per device as the widths need
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

// KC and NB from D and the wrapper's group size: D <= 1024 takes NB 4 or 8,
// D <= 4096 NB 4, D <= 8192 NB 2 (y in registers: KC * NB * 4 <= 64 floats).
template <typename W, bool GATED>
int launch_kc(const Params& p, int nb, int blocks, int cluster,
              cudaStream_t stream, int* max_clusters) {
  if (p.D <= kChunk && nb == 4)
    return launch_one<W, 1, 4, GATED>(p, blocks, cluster, stream, max_clusters);
  if (p.D <= kChunk && nb == 8)
    return launch_one<W, 1, 8, GATED>(p, blocks, cluster, stream, max_clusters);
  if (p.D <= 4 * kChunk && nb == 4)
    return launch_one<W, 4, 4, GATED>(p, blocks, cluster, stream, max_clusters);
  if (p.D <= 8 * kChunk && nb == 2)
    return launch_one<W, 8, 2, GATED>(p, blocks, cluster, stream, max_clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename W>
int launch_w(const Params& p, int nb, int blocks, int cluster,
             cudaStream_t stream, int* max_clusters) {
  if (p.w_gate != nullptr)
    return launch_kc<W, true>(p, nb, blocks, cluster, stream, max_clusters);
  return launch_kc<W, false>(p, nb, blocks, cluster, stream, max_clusters);
}

int dispatch(const Params& p, int dtype, int nb, int blocks, int cluster,
             cudaStream_t stream, int* max_clusters) {
  if (p.rpb < 1 || p.rpb > kMaxRpb || cluster < 1 || blocks % cluster != 0 ||
      p.D % 4 != 0 || (p.unit != 16 && p.unit != 8 && p.unit != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_w<float>(p, nb, blocks, cluster, stream, max_clusters);
  if (dtype == 1)
    return launch_w<__nv_bfloat16>(p, nb, blocks, cluster, stream, max_clusters);
  if (dtype == 2) return launch_w<int8_t>(p, nb, blocks, cluster, stream, max_clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}

int copy_unit(int D, int dtype) {
  const int bytes = D * (dtype == 0 ? 4 : dtype == 1 ? 2 : 1);
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : 4;
}

}  // namespace

// C entry point (loaded with ctypes). Pointers are device pointers, weights
// 16-byte aligned; `stream` is a cudaStream_t. `dtype` 0 = float32 rows,
// 1 = bfloat16, 2 = int8 (w_gate null for the ungated FFN); x and out are
// f32 [B, D] with D % 4 == 0. `nb` batch rows a group (4 or 8 for D <= 1024,
// 4 for D <= 4096, 2 for D <= 8192); `blocks` a multiple of `cluster`, each
// owning `rpb` (<= 2048) rows of the flattened [S * seg] tile, blocks * rpb
// >= S * seg. `part` is f32 scratch of groups * (blocks / cluster) * nb * D
// floats; `tickets` int32 [groups * cluster], zero on entry and left zero:
// the cross-cluster tickets, which no launch on another stream may share.
// Segment ids outside [0, N / seg) are padding (never read). Returns the
// CUDA error code of the launch (0 = success); cudaErrorInvalidValue for a
// geometry it does not take.
extern "C" int sparse_ffn_segments_fused_launch(
    const float* x, const void* w_up, const void* w_gate, const void* w_down,
    const int* seg_ids, const float* scale_tiles, float* part, int* tickets,
    float* out, int B, int D, int N, int S, int seg, int dtype,
    int activation, int nb, int blocks, int cluster, int rpb, void* stream) {
  const Params p{x, w_up, w_gate, w_down, seg_ids, scale_tiles, part, tickets,
                 out, B, D, S, seg, N / seg, rpb, activation,
                 copy_unit(D, dtype)};
  return dispatch(p, dtype, nb, blocks, cluster,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// Clusters of `cluster` blocks of the instantiation a launch at these widths
// would use that the card holds at once, into *clusters. Returns the CUDA
// error code as the launch does.
extern "C" int sparse_ffn_segments_fused_max_clusters(int D, int dtype,
                                                      int gated, int nb,
                                                      int cluster,
                                                      int* clusters) {
  static const int dummy = 0;
  Params p{};
  p.D = D;
  p.rpb = 1;
  p.unit = copy_unit(D, dtype);
  p.w_gate = gated ? &dummy : nullptr;
  return dispatch(p, dtype, nb, cluster, cluster, nullptr, clusters);
}

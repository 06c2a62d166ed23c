// IVF slab scan (K5, and K4 as its Q = 1 instance) for advanced_rag_tpu_torch.
//
// Replaces advanced_rag_tpu/ops/pallas_ivf.py: the kernel of
// ivf_topk_pallas_batch (K5, pallas_call at :193, kernel at :181) and
// _slab_kernel of ivf_topk_pallas (K4, :36).  Plain C interface, launched
// on the caller's stream, returns cudaGetLastError(); the wrapper is
// ops/ivf_kernels.py.
//
//   out[q, i, r] = sum_d q[q, d] * float(packed[probes[q, i], r, d])      bf16/f32
//   out[q, i, r] = float(sum_d qc[q, d] * codes[probes[q, i], r, d])
//                  * scale[probes[q, i], r]                              SQ8
//
// and 0.0 for every r of a pair whose probe id lies outside [0, nlist).
// The SQ8 query scale is applied by the wrapper afterwards, so the rounding
// order is the Pallas kernel's, (s * row_scale) * q_scale.  The integer dot
// is exact in int32 (|v| <= 127, D * 127^2 < 2^31) and the scale multiply
// rounds once (__fmul_rn), so SQ8 scores equal the plain version's bit for
// bit.  The wrapper gathers packed_rows, masks, and takes the top-k.
//
// Bound on the H100: bytes, each probed slab read once per batch (the
// unique slabs: 155 MB of bf16 at the manager's nlist 312, cap 648, D 384
// when a batch of 32 random probe lists touches nearly every list, 0.046
// ms at 3.35 TB/s), plus the [Q, nprobe, cap] f32 output.  The TPU kernel
// streams a slab per (query, probe) on a sequential (Q, nprobe) grid; that
// is 3.3x the unique bytes there, more than a flat scan of every slab, and
// the 50 MB L2 does not hold the repeats.  Two routes:
//
// - Grouped (art_ivf_grouped), bf16 and SQ8 slabs, where the route model
//   of ops/ivf_kernels.py (ivf_route, route_ms: both routes' bytes over
//   the lists a batch of uniformly drawn probes is expected to share)
//   expects it to be faster.  A plan kernel inverts probes on the
//   device: per list the (q, i) pairs that probe it (offsets, pairs
//   encoded q * nprobe + i, grouped by list; the order inside a group comes
//   from atomics and no score depends on it), the lists with a pair (work
//   entries: list, first pair, end; n_work), zeros for the pairs whose
//   probe id is out of range and, for bf16 slabs, the f32 queries split
//   into bf16 hi / mid / lo parts (as K1's prologue: the parts carry q to
//   2^-24 |q| and a bf16 product is exact in f32).  It needs no host sync
//   and allocates nothing, so a CUDA graph recomputes the plan on every
//   replay.  Then a persistent block a SM takes a contiguous run of the
//   items (list, row tile): a producer warp streams each item's tile of BM
//   rows into a ring of IVF_RING shared-memory slots with 2-D tile copies
//   of the Tensor Memory Accelerator (one per 128 bytes of the rows, with
//   the 128-byte swizzle, so ldmatrix reads are free of bank conflicts),
//   and consumer warps (one per 16 rows) score each tile once against the
//   group's queries, QC at a time, with the chunk's query rows gathered
//   into shared memory (kept while the list stays the same): a list probed
//   by all Q queries costs one tile read and ceil(Q / QC) chunks.  mbarriers
//   hand the slots between the two (full: the tile's bytes have landed;
//   empty: every consumer warp is done).  The product: mma.sync m16n8k16
//   bf16 -> f32 over the three query parts (bf16 slabs), m16n8k32 s8 -> s32
//   (SQ8, exact), with only the chunk's live n8 tiles of queries computed.
//   Scores leave from the fragments: eight lanes write eight consecutive
//   rows of one query, whole 32-byte sectors.  Tiles are 48 KB of slab
//   bytes at D = 384 (BM 64 bf16 rows, 128 int8): three of them (144 KB)
//   stay in flight while the consumers score a fourth's worth of queries
//   (75 KB of bf16 query parts at QC = 32), one block an SM; grouped_plan
//   in ops/ivf_kernels.py mirrors the shared memory, and the launcher opts
//   in above 48 KB.  The route takes slabs whose rows the Tensor Memory
//   Accelerator can copy (16-byte aligned) and whose tiles fit.
//   Where it ends (H100 80GB HBM3, 700 W, chip_smoke.py phase 3; PERF.md
//   § 6): the copies alone run at about 90% of the byte rate; the mma.sync
//   products of a tile take about as long as its bytes, so at 1M rows bf16
//   slabs end near 1.3-1.4x the unique-slab bound and SQ8 near 1.2x, and
//   the plan launch and the ring's fill cost about 0.01-0.02 ms a launch.
// - Streaming (art_ivf_scores, ivf_scores_kernel), for K4, f32 slabs and
//   the launches the route model gives it (few queries, or many lists
//   that a batch seldom shares, as phase 6's nprobe 8 over 1000 lists):
//   one block per (row tile, probe, query), each reading its own probe id,
//   so a one-query search still fills the card (nprobe * cap / IVF_TILE
//   blocks) and pays no plan launch.  Its loads stay coalesced: 8 lanes
//   share one row and read it as consecutive 16-byte vectors, a warp
//   covers 4 rows at a time, and the 8 partial sums of a row are combined
//   with warp shuffles; the query sits in shared memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define IVF_THREADS 256
#define IVF_TILE 128
#define IVF_LANES 8  // lanes sharing one row
#define IVF_SMEM_MAX 232448       // 227 KB, the most a block may opt in to
#define IVF_PLAN_THREADS 1024
#define IVF_PLAN_SMEM_LISTS 8192  // list counters the plan keeps in shared memory
#define IVF_RING 3                // tile buffers of the grouped scan

namespace {

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// MODE 0: f32 rows, 1: bf16 rows, 2: int8 codes with a per-row scale.
template <int MODE>
__global__ void __launch_bounds__(IVF_THREADS)
ivf_scores_kernel(const int* __restrict__ probes, const void* __restrict__ q,
                  const void* __restrict__ packed, const float* __restrict__ scale,
                  float* __restrict__ out, int nprobe, int nlist, int cap, int d,
                  int vec) {
  extern __shared__ float qs[];  // [d] f32 query, or [d / 4] int8x4 words
  const int i = blockIdx.y;
  const int qi = blockIdx.z;
  const int p = probes[qi * nprobe + i];
  if (MODE == 2) {
    int* qw = (int*)qs;
    const int* src = (const int*)((const int8_t*)q + (size_t)qi * d);
    for (int t = threadIdx.x; t < d / 4; t += blockDim.x) qw[t] = src[t];
  } else {
    const float* src = (const float*)q + (size_t)qi * d;
    for (int t = threadIdx.x; t < d; t += blockDim.x) qs[t] = src[t];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int sub = lane & (IVF_LANES - 1);
  const int grp = lane / IVF_LANES;               // 0..3: the warp's row
  const int warp = threadIdx.x >> 5;
  const int rows_per_pass = (blockDim.x >> 5) * (32 / IVF_LANES);
  const int r0 = blockIdx.x * IVF_TILE;
  const int r_end = min(r0 + IVF_TILE, cap);
  const bool probe_ok = p >= 0 && p < nlist;
  float* orow = out + ((size_t)qi * nprobe + i) * cap;

  // the loop bound is warp-uniform, so every lane reaches the shuffles
  for (int base = r0 + warp * (32 / IVF_LANES); base < r_end; base += rows_per_pass) {
    const int r = base + grp;
    const bool live = probe_ok && r < r_end;
    const size_t row_off = ((size_t)(live ? p : 0) * cap + (live ? r : 0)) * d;
    float acc = 0.0f;
    int iacc = 0;
    if (live) {
      if (MODE == 1) {
        const uint16_t* row = (const uint16_t*)packed + row_off;
        if (vec) {  // d % 8 == 0, 16-byte aligned rows
          const uint4* rp = (const uint4*)row;
          for (int v = sub; v < d / 8; v += IVF_LANES) {
            const uint4 w = __ldg(rp + v);
            const float4 qa = *(const float4*)(qs + v * 8);
            const float4 qb = *(const float4*)(qs + v * 8 + 4);
            acc = fmaf(qa.x, bf16_lo(w.x), acc);
            acc = fmaf(qa.y, bf16_hi(w.x), acc);
            acc = fmaf(qa.z, bf16_lo(w.y), acc);
            acc = fmaf(qa.w, bf16_hi(w.y), acc);
            acc = fmaf(qb.x, bf16_lo(w.z), acc);
            acc = fmaf(qb.y, bf16_hi(w.z), acc);
            acc = fmaf(qb.z, bf16_lo(w.w), acc);
            acc = fmaf(qb.w, bf16_hi(w.w), acc);
          }
        } else {
          for (int e = sub; e < d; e += IVF_LANES)
            acc = fmaf(qs[e], __uint_as_float(((uint32_t)__ldg(row + e)) << 16), acc);
        }
      } else if (MODE == 0) {
        const float* row = (const float*)packed + row_off;
        if (vec) {  // d % 4 == 0, 16-byte aligned rows
          const float4* rp = (const float4*)row;
          for (int v = sub; v < d / 4; v += IVF_LANES) {
            const float4 x = __ldg(rp + v);
            const float4 qa = *(const float4*)(qs + v * 4);
            acc = fmaf(qa.x, x.x, acc);
            acc = fmaf(qa.y, x.y, acc);
            acc = fmaf(qa.z, x.z, acc);
            acc = fmaf(qa.w, x.w, acc);
          }
        } else {
          for (int e = sub; e < d; e += IVF_LANES) acc = fmaf(qs[e], __ldg(row + e), acc);
        }
      } else {
        const int8_t* row = (const int8_t*)packed + row_off;
        const int* qw = (const int*)qs;
        if (vec) {  // d % 16 == 0, 16-byte aligned rows
          const int4* rp = (const int4*)row;
          for (int v = sub; v < d / 16; v += IVF_LANES) {
            const int4 w = __ldg(rp + v);
            const int4 qv = *(const int4*)(qw + v * 4);
            iacc = __dp4a(w.x, qv.x, iacc);
            iacc = __dp4a(w.y, qv.y, iacc);
            iacc = __dp4a(w.z, qv.z, iacc);
            iacc = __dp4a(w.w, qv.w, iacc);
          }
        } else {  // d % 4 == 0: 4-byte words
          const int* rp = (const int*)row;
          for (int v = sub; v < d / 4; v += IVF_LANES) iacc = __dp4a(__ldg(rp + v), qw[v], iacc);
        }
      }
    }
#pragma unroll
    for (int off = IVF_LANES / 2; off > 0; off >>= 1) {
      if (MODE == 2)
        iacc += __shfl_xor_sync(0xffffffffu, iacc, off);
      else
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (sub == 0 && r < r_end) {
      float s;
      if (MODE == 2)
        s = live ? __fmul_rn((float)iacc, __ldg(scale + (size_t)p * cap + r)) : 0.0f;
      else
        s = acc;
      orow[r] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// The grouped route: the plan kernel, then the grouped scan.

enum { KIND_F32 = 0, KIND_BF16 = 1, KIND_INT8 = 2 };  // = row_mode

// Per kind: BM rows a tile (one consumer warp per 16 rows), QC queries a
// chunk, NPART query parts, the slab's element.  f32 slabs stream: a
// grouped scan of them on the CUDA cores ran 2-4x slower than streaming at
// every shape measured (PERF.md § 6).
template <int KIND>
struct Grouped;
template <>
struct Grouped<KIND_BF16> {
  static constexpr int BM = 64, QC = 32, NPART = 3;
  using T = uint16_t;
};
template <>
struct Grouped<KIND_INT8> {
  static constexpr int BM = 128, QC = 32, NPART = 1;
  using T = uint8_t;
};

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// A row's bytes padded to the 32-byte k step of one mma.  A query row sits
// in shared memory at a pitch of 16 bytes more (an odd number of 16-byte
// units, so the eight rows an ldmatrix reads fall in distinct banks).
__host__ __device__ __forceinline__ int kpad_bytes(int kind, int d) {
  return round_up(d * (kind == KIND_BF16 ? 2 : 1), 32);
}
// One slot of the tile ring: the tile as boxes of BM rows x 128 bytes (the
// Tensor Memory Accelerator's 128-byte swizzle: 16-byte chunk c of row r
// sits at chunk c ^ (r % 8)), enough boxes for a row.
template <int KIND>
__host__ __device__ __forceinline__ int slot_boxes(int d) {
  return (kpad_bytes(KIND, d) + 127) / 128;
}
template <int KIND>
__host__ __device__ __forceinline__ int slot_bytes(int d) {
  return slot_boxes<KIND>(d) * Grouped<KIND>::BM * 128;
}
// Shared memory: 1 KB to align the ring (the swizzle needs 1024-byte
// aligned boxes), the ring, 128 bytes for the ring's mbarriers and its
// slots' work entries, [QC] pair ids, [NPART][QC] query rows and, for SQ8,
// each slot's [BM] row scales.
template <int KIND>
__host__ __device__ __forceinline__ size_t grouped_smem(int d) {
  using G = Grouped<KIND>;
  const int scales = KIND == KIND_INT8 ? IVF_RING * G::BM * 4 : 0;
  return 1024 + (size_t)IVF_RING * slot_bytes<KIND>(d) + 128 + G::QC * 4 +
         (size_t)G::NPART * G::QC * (kpad_bytes(KIND, d) + 16) + scales;
}

// The workspace of one grouped launch: int32 offsets [nlist + 1], pairs
// [npairs], n_work [1], counters [nlist]; then on 16-byte boundaries the
// work entries int4 [nlist] (list, its first pair, its end) and, for bf16
// slabs, the query parts [3][nq][kpad / 2] bf16.
__host__ __device__ __forceinline__ size_t plan_ints(int nlist, int npairs) {
  return (size_t)2 * nlist + 2 + npairs;
}
__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// mbarriers of the tile ring: full[s] ends its phase when the producer has
// arrived and the bytes of slot s have landed, empty[s] when every consumer
// warp is done with the slot.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Arrive, and expect `bytes` more of bulk copies before the phase ends.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// A 2-D tile copy by the Tensor Memory Accelerator: the box of `tmap` at
// (element x, row y) into shared memory, its bytes completed on `bar`.
__device__ __forceinline__ void tile_copy(void* dst, const CUtensorMap* tmap, int x, int y,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)tmap), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}
// A wait that cannot end is a fault of the kernel: after about ten seconds
// it traps (the launch fails) instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  }
}
// The consumer warps' own barrier (the producer warp never joins it).
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D (+)= A * B for one m16 x n8 tile: c0, c1 at (row g, queries 2t, 2t + 1),
// c2, c3 at row g + 8 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_tile(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tile(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Exclusive prefix sum of v over the block (every thread calls it; returns
// this thread's prefix, *total the block's sum).  buf: 32 ints of shared
// memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total, int* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? buf[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    buf[lane] = s;
  }
  __syncthreads();
  const int ex = x - v + (warp > 0 ? buf[warp - 1] : 0);
  *total = buf[nwarps - 1];
  __syncthreads();  // buf is free for the next call
  return ex;
}

// The plan: block 0 inverts probes; blocks 1.. (bf16 slabs only) split the
// queries into qparts [3][nq][kp], zeros past d.  gcount: the list counters
// in device memory when nlist > IVF_PLAN_SMEM_LISTS (else shared memory).
__global__ void __launch_bounds__(IVF_PLAN_THREADS)
ivf_plan_kernel(const int* __restrict__ probes, int npairs, int nlist, int cap,
                int* __restrict__ offsets, int* __restrict__ pairs, int4* __restrict__ work,
                int* __restrict__ n_work, int* __restrict__ gcount, float* __restrict__ out,
                const float* __restrict__ q, uint16_t* __restrict__ qparts, int nq, int d,
                int kp) {
  extern __shared__ int scount[];
  __shared__ int buf[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  if (blockIdx.x > 0) {
    // hi, mid, lo: each a round-to-nearest bf16 of what the parts before it
    // leave; both differences are exact in f32
    const size_t part = (size_t)nq * kp;
    for (size_t x = (size_t)(blockIdx.x - 1) * nt + tid; x < part;
         x += (size_t)(gridDim.x - 1) * nt) {
      const int j = (int)(x / kp), k = (int)(x % kp);
      const float v = k < d ? q[(size_t)j * d + k] : 0.0f;
      const __nv_bfloat16 hi = __float2bfloat16_rn(v);
      const float r1 = v - __bfloat162float(hi);
      const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
      qparts[x] = __bfloat16_as_ushort(hi);
      qparts[part + x] = __bfloat16_as_ushort(mid);
      qparts[2 * part + x] = __bfloat16_as_ushort(__float2bfloat16_rn(r1 - __bfloat162float(mid)));
    }
    return;
  }
  int* cnt = gcount ? gcount : scount;
  for (int l = tid; l < nlist; l += nt) cnt[l] = 0;
  __syncthreads();
  for (int e = tid; e < npairs; e += nt) {
    const int p = probes[e];
    if (p >= 0 && p < nlist) atomicAdd(&cnt[p], 1);
  }
  __syncthreads();
  // offsets (the counters become each list's write cursor) and the lists
  // with a pair, in list order
  int carry = 0, wcarry = 0;
  for (int base = 0; base < nlist; base += nt) {
    const int l = base + tid;
    const int c = l < nlist ? cnt[l] : 0;
    int tot, wtot;
    const int ex = block_exclusive_scan(c, &tot, buf);
    const int wex = block_exclusive_scan(c > 0, &wtot, buf);
    if (l < nlist) {
      offsets[l] = carry + ex;
      cnt[l] = carry + ex;
      if (c > 0) work[wcarry + wex] = make_int4(l, carry + ex, carry + ex + c, 0);
    }
    carry += tot;
    wcarry += wtot;
  }
  if (tid == 0) {
    offsets[nlist] = carry;
    *n_work = wcarry;
  }
  __syncthreads();
  for (int e = tid; e < npairs; e += nt) {
    const int p = probes[e];
    if (p >= 0 && p < nlist) {
      pairs[atomicAdd(&cnt[p], 1)] = e;
    } else {  // an out-of-range probe id scores 0.0
      for (int r = 0; r < cap; ++r) out[(size_t)e * cap + r] = 0.0f;
    }
  }
}

// Consumer warps: one per row group of 16 tile rows; one producer warp.
template <int KIND>
struct Warps {
  static constexpr int kConsumers = Grouped<KIND>::BM / 16;
  static constexpr int kThreads = (kConsumers + 1) * 32;
};

// One chunk's product on the tensor cores and its scores: consumer warp w
// owns tile rows 16w .. 16w + 15 and the chunk's NTL live n8 tiles of
// queries (a template per count, so no product or load is predicated).
// The tile is in the Tensor Memory Accelerator's 128-byte swizzle (16-byte
// chunk c of row r at c ^ (r % 8)); a k step is 32 bytes (k16 bf16, k32
// int8), four to a box, and the fragments of the next step load while this
// one's products run.
template <int KIND, int NTL>
struct Frags {
  uint32_t a[4];
  uint32_t b[Grouped<KIND>::NPART][NTL][2];
};

template <int KIND, int NTL>
__device__ __forceinline__ void load_frags(Frags<KIND, NTL>& f, uint32_t a_addr, uint32_t b_addr,
                                           int pitch) {
  using G = Grouped<KIND>;
  ldmatrix_x4(f.a, a_addr);
#pragma unroll
  for (int p = 0; p < G::NPART; ++p)
#pragma unroll
    for (int np = 0; np < (NTL + 1) / 2; ++np) {
      uint32_t r[4];
      ldmatrix_x4(r, b_addr + (p * G::QC + np * 16) * pitch);
      f.b[p][2 * np][0] = r[0];
      f.b[p][2 * np][1] = r[1];
      if (2 * np + 1 < NTL) {
        f.b[p][2 * np + 1][0] = r[2];
        f.b[p][2 * np + 1][1] = r[3];
      }
    }
}

template <int KIND, int NTL>
__device__ __forceinline__ void score_chunk_mma(const uint8_t* tile, const uint8_t* qs,
                                                const int* spairs, int nc, int pitch, int kpad,
                                                float* __restrict__ out, const float* sc,
                                                int cap, int r0) {
  using G = Grouped<KIND>;
  using V = typename std::conditional<KIND == KIND_INT8, int, float>::type;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // one accumulator per query part: independent mma chains
  V acc[G::NPART][NTL][4];
#pragma unroll
  for (int p = 0; p < G::NPART; ++p)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0;
  // A rows: tile row 16w + (lane % 16), the 16 bytes at k byte 32 j + 16
  // (lane / 16) of a box at swizzled chunk (2 j + lane / 16) ^ (row % 8)
  const int ar = warp * 16 + (lane & 15);
  const uint32_t a_row = smem_addr(tile) + ar * 128;
  uint32_t a_off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) a_off[j] = ((2 * j + (lane >> 4)) ^ (ar & 7)) << 4;
  // B rows: query n, 16 bytes at k byte offset kb; one x4 covers two n8 tiles
  const uint32_t b_base =
      smem_addr(qs) + ((lane & 7) + ((lane >> 4) << 3)) * pitch + ((lane >> 3) & 1) * 16;
  const int nks = kpad / 32;
  Frags<KIND, NTL> f[2];
  load_frags<KIND, NTL>(f[0], a_row + a_off[0], b_base, pitch);
  for (int ks0 = 0; ks0 < nks; ks0 += 4) {
    const uint32_t a_box = a_row + (ks0 >> 2) * (G::BM * 128);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ks = ks0 + j;
      if (ks >= nks) break;
      if (ks + 1 < nks) {
        load_frags<KIND, NTL>(f[(j + 1) & 1],
                              (j < 3 ? a_box : a_box + G::BM * 128) + a_off[(j + 1) & 3],
                              b_base + (ks + 1) * 32, pitch);
      }
#pragma unroll
      for (int p = 0; p < G::NPART; ++p)
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt)
          mma_tile(acc[p][nt], f[j & 1].a, f[j & 1].b[p][nt][0], f[j & 1].b[p][nt][1]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = warp * 16 + g + 8 * h;
    if (r0 + rr >= cap) continue;
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * t + e;
        if (j >= nc) continue;
        float v;
        if constexpr (KIND == KIND_INT8) {
          v = __fmul_rn((float)acc[0][nt][2 * h + e], sc[rr]);
        } else {  // hi + mid, then + lo
          v = __fadd_rn(__fadd_rn(acc[0][nt][2 * h + e], acc[1][nt][2 * h + e]),
                        acc[2][nt][2 * h + e]);
        }
        out[(size_t)spairs[j] * cap + r0 + rr] = v;
      }
  }
}

// The chunk's product with as many n8 tiles as it has queries.
template <int KIND>
__device__ __forceinline__ void score_chunk_live(const uint8_t* tile, const uint8_t* qs,
                                                 const int* spairs, int nc, int pitch, int kpad,
                                                 float* __restrict__ out, const float* sc,
                                                 int cap, int r0) {
  static_assert(Grouped<KIND>::QC == 32, "four n8 tiles of queries");
  switch ((nc + 7) / 8) {
    case 1:
      score_chunk_mma<KIND, 1>(tile, qs, spairs, nc, pitch, kpad, out, sc, cap, r0);
      break;
    case 2:
      score_chunk_mma<KIND, 2>(tile, qs, spairs, nc, pitch, kpad, out, sc, cap, r0);
      break;
    case 3:
      score_chunk_mma<KIND, 3>(tile, qs, spairs, nc, pitch, kpad, out, sc, cap, r0);
      break;
    default:
      score_chunk_mma<KIND, 4>(tile, qs, spairs, nc, pitch, kpad, out, sc, cap, r0);
  }
}

// The grouped scan: BM / 16 consumer warps and one producer warp.  Block b
// takes a contiguous run of the items (work[u], row tile), u < n_work, so
// consecutive items mostly share a list (and its staged queries).  The
// producer streams each item's tile into a ring of IVF_RING slots with 2-D
// tile copies of the Tensor Memory Accelerator (one per 128 bytes of the
// rows, swizzled so that ldmatrix reads are free of bank conflicts), up to
// IVF_RING items ahead; the consumers score it.  Rows past cap come along
// (zeros past the last list): a row of the product reads only its own row
// of the tile, and their scores are not stored.  Bytes past D are zeros.
// tmap: the slabs as [nlist * cap, D]; qsrc: the query rows the chunks
// gather, q_rows a part (bf16: the plan's parts, rows of kpad bytes; else
// q_in, rows of d elements).
template <int KIND>
__global__ void __launch_bounds__(Warps<KIND>::kThreads)
ivf_grouped_kernel(const __grid_constant__ CUtensorMap tmap, const int4* __restrict__ work,
                   const int* __restrict__ n_work, const int* __restrict__ pairs,
                   const uint8_t* __restrict__ qsrc, int q_rows,
                   const float* __restrict__ scale, float* __restrict__ out, int nprobe,
                   int cap, int d, int vec_q) {
  using G = Grouped<KIND>;
  using T = typename G::T;
  constexpr int kConsumers = Warps<KIND>::kConsumers;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* slots = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const int kpad = kpad_bytes(KIND, d), pitch = kpad + 16;
  const int sbytes = slot_bytes<KIND>(d), nbox = slot_boxes<KIND>(d);
  // after the ring, 128 bytes: the mbarriers, then the slots' work entries
  static_assert(IVF_RING <= 4, "the ring's control block holds 4 slots");
  uint8_t* ctrl = slots + IVF_RING * sbytes;
  uint64_t* full = (uint64_t*)ctrl;
  uint64_t* empty = full + IVF_RING;
  int4* heads = (int4*)(ctrl + 64);
  int* spairs = (int*)(ctrl + 128);
  uint8_t* qs = (uint8_t*)(spairs + G::QC);
  float* scales = (float*)(qs + G::NPART * G::QC * pitch);  // SQ8: [IVF_RING][BM]
  const int row_bytes = d * (int)sizeof(T);
  const int ntiles = (cap + G::BM - 1) / G::BM;
  const int items = *n_work * ntiles;
  const int per = (items + gridDim.x - 1) / gridDim.x;
  const int it0 = blockIdx.x * per, it1 = min(items, it0 + per);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < IVF_RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
  }
  __syncthreads();

  if (warp == kConsumers) {  // the producer
    int u_last = -1;
    int4 w = make_int4(0, 0, 0, 0);
    for (int it = it0; it < it1; ++it) {
      const int k = (it - it0) / IVF_RING, s = (it - it0) % IVF_RING;
      if (k > 0) mbar_wait(&empty[s], (k - 1) & 1);
      const int u = it / ntiles, r0 = (it - u * ntiles) * G::BM;
      if (u != u_last) {
        w = work[u];
        u_last = u;
      }
      if constexpr (KIND == KIND_INT8) {  // the tile's row scales, by plain loads
        const float* src = scale + (long long)w.x * cap + r0;
        for (int j = lane; j < G::BM; j += 32)
          scales[s * G::BM + j] = r0 + j < cap ? __ldg(src + j) : 0.0f;
        __syncwarp();
      }
      if (lane == 0) {
        heads[s] = w;
        mbar_arrive_expect(&full[s], sbytes);
      }
      __syncwarp();
      if (lane < nbox)
        tile_copy(slots + s * sbytes + lane * (G::BM * 128), &tmap,
                  lane * (128 / (int)sizeof(T)), w.x * cap + r0, &full[s]);
    }
    return;
  }

  // the consumers
  constexpr int kThreads = kConsumers * 32;
  const int q_bytes = KIND == KIND_BF16 ? kpad : row_bytes;
  int staged = -1;  // the list whose only chunk sits in spairs and qs
  for (int it = it0; it < it1; ++it) {
    const int k = (it - it0) / IVF_RING, s = (it - it0) % IVF_RING;
    const uint8_t* tile = slots + s * sbytes;
    mbar_wait(&full[s], k & 1);
    const int4 w = heads[s];  // list, its pairs [g0, g1)
    const int r0 = (it % ntiles) * G::BM;
    for (int c0 = w.y; c0 < w.z; c0 += G::QC) {
      const int nc = min(G::QC, w.z - c0);
      if (!(c0 == w.y && w.z - w.y <= G::QC && w.x == staged)) {
        consumer_sync(kThreads);  // the last chunk is done with spairs and the queries
        if (threadIdx.x < G::QC) spairs[threadIdx.x] = threadIdx.x < nc ? pairs[c0 + threadIdx.x] : -1;
        consumer_sync(kThreads);
        // the chunk's nc query rows of each part, a warp a row; rows past
        // nc are never scored into out, so they may hold anything
        for (int jp = warp; jp < G::NPART * nc; jp += kConsumers) {
          const int p = jp / nc, j = jp - p * nc;
          const uint8_t* src = qsrc + ((long long)p * q_rows + spairs[j] / nprobe) * q_bytes;
          uint8_t* dst = qs + (p * G::QC + j) * pitch;
          for (int b0 = lane * 16; b0 < kpad; b0 += 512) {
            if (vec_q) {
              *(uint4*)(dst + b0) = b0 < q_bytes ? __ldg((const uint4*)(src + b0))
                                                 : make_uint4(0, 0, 0, 0);
            } else {
              T* dt = (T*)(dst + b0);
#pragma unroll
              for (int e = 0; e < 16 / (int)sizeof(T); ++e) {
                const int b = b0 + e * (int)sizeof(T);
                dt[e] = b < q_bytes ? ((const T*)src)[b / (int)sizeof(T)] : (T)0;
              }
            }
          }
        }
        consumer_sync(kThreads);
      }
      score_chunk_live<KIND>(tile, qs, spairs, nc, pitch, kpad, out, scales + s * G::BM,
                             cap, r0);
    }
    staged = w.z - w.y <= G::QC ? w.x : -1;
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// cuTensorMapEncodeTiled of libcuda, found through the CUDA runtime (so the
// library needs no link to libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

template <int KIND>
int launch_grouped(const int4* work, const int* n_work, const int* pairs, const void* qsrc,
                   int q_rows, const void* packed, const float* scale, float* out, int nprobe,
                   int nlist, int npairs, int cap, int d, int vec_q, cudaStream_t st) {
  using G = Grouped<KIND>;
  constexpr int kThreads = Warps<KIND>::kThreads;
  const size_t smem = grouped_smem<KIND>(d);
  if (smem > IVF_SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = ivf_grouped_kernel<KIND>;
  // the encoder, the opt-in and the resident-block count of the last
  // (device, smem) this instance launched with, kept per host thread (a
  // ctypes call releases the GIL, so two threads may launch at once); the
  // tensor map is encoded on every call (a host call of microseconds), so
  // no launch can take another's slabs
  static thread_local EncodeTiled encode = nullptr;
  static thread_local int last_dev = -1, resident = 0;
  static thread_local size_t last_smem = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if ((e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                     &found)) != cudaSuccess)
      return (int)e;
    if (found != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorSymbolNotFound;
    encode = (EncodeTiled)fn;
  }
  if (dev != last_dev || smem != last_smem) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem)) !=
        cudaSuccess)
      return (int)e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    last_dev = dev;
    last_smem = smem;
  }
  // the slabs as [nlist * cap, D], in boxes of 128 bytes x BM rows
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)nlist * cap};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(typename G::T)};
  const cuuint32_t box[2] = {128 / (cuuint32_t)sizeof(typename G::T), (cuuint32_t)G::BM};
  const cuuint32_t estrides[2] = {1, 1};
  const CUtensorMapDataType type =
      KIND == KIND_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap tmap;
  if (encode(&tmap, type, 2, const_cast<void*>(packed), dims, strides, box, estrides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  // the most items a batch can have: every probed list, all its row tiles
  const long long most = (long long)(nlist < npairs ? nlist : npairs) * ((cap + G::BM - 1) / G::BM);
  const int grid = most < resident ? (int)most : resident;
  kern<<<grid, kThreads, smem, st>>>(tmap, work, n_work, pairs, (const uint8_t*)qsrc, q_rows,
                                     scale, out, nprobe, cap, d, vec_q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// row_mode: 0 = float32 rows, 1 = bfloat16 rows, 2 = int8 codes (q is int8
// codes, scale the [nlist, cap] row scales).  out is [nq, nprobe, cap] f32.
int art_ivf_scores(const void* probes, const void* q, const void* packed,
                   const void* scale, void* out, int row_mode, int nq, int nprobe,
                   int nlist, int cap, int d, int vec, void* stream) {
  if (nq < 1 || nq > 65535 || nprobe < 1 || nprobe > 65535 || nlist < 1 || cap < 1 ||
      d < 1 || row_mode < 0 || row_mode > 2 || (row_mode == 2 && (d % 4 != 0 || !scale)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((cap + IVF_TILE - 1) / IVF_TILE, nprobe, nq);
  const size_t smem = row_mode == 2 ? (size_t)d : (size_t)d * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* pr = (const int*)probes;
  const float* sc = (const float*)scale;
  float* o = (float*)out;
  if (row_mode == 0)
    ivf_scores_kernel<0><<<grid, IVF_THREADS, smem, st>>>(pr, q, packed, sc, o, nprobe,
                                                          nlist, cap, d, vec);
  else if (row_mode == 1)
    ivf_scores_kernel<1><<<grid, IVF_THREADS, smem, st>>>(pr, q, packed, sc, o, nprobe,
                                                          nlist, cap, d, vec);
  else
    ivf_scores_kernel<2><<<grid, IVF_THREADS, smem, st>>>(pr, q, packed, sc, o, nprobe,
                                                          nlist, cap, d, vec);
  return (int)cudaGetLastError();
}

// The grouped route (see the note at the top), for bf16 and SQ8 slabs.
// Same arguments as art_ivf_scores, plus workspace: plan_ints(nlist, nq * nprobe) int32, then
// on a 16-byte boundary nlist int4 work entries and, for bf16 slabs,
// 3 * nq * kpad_bytes bytes of query parts
// (ops/ivf_kernels.py:grouped_workspace_bytes).  vec: the
// slab rows are 16-byte aligned (d * itemsize % 16 == 0, aligned base); the
// grouped route takes no other.
int art_ivf_grouped(const void* probes, const void* q, const void* packed, const void* scale,
                    void* out, void* workspace, int row_mode, int nq, int nprobe, int nlist,
                    int cap, int d, int vec, void* stream) {
  if (nq < 1 || nprobe < 1 || (long long)nq * nprobe > (1 << 30) || nlist < 1 || cap < 1 ||
      d < 1 || (row_mode != KIND_BF16 && row_mode != KIND_INT8) || !workspace || !vec ||
      (row_mode == KIND_INT8 && (d % 4 != 0 || !scale)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int npairs = nq * nprobe;
  int* offsets = (int*)workspace;
  int* pairs = offsets + nlist + 1;
  int* n_work = pairs + npairs;
  int* counters = n_work + 1;
  int4* work = (int4*)((uint8_t*)workspace + align16(plan_ints(nlist, npairs) * 4));
  uint16_t* qparts = nullptr;
  const int kpad = kpad_bytes(row_mode, d);
  if (row_mode == KIND_BF16) qparts = (uint16_t*)(work + nlist);
  const size_t plan_smem = nlist <= IVF_PLAN_SMEM_LISTS ? (size_t)nlist * 4 : 0;
  const long long split = qparts ? (long long)nq * (kpad / 2) : 0;
  const int split_blocks = (int)((split + IVF_PLAN_THREADS - 1) / IVF_PLAN_THREADS);
  ivf_plan_kernel<<<1 + (split_blocks < 64 ? split_blocks : 64), IVF_PLAN_THREADS, plan_smem,
                    st>>>((const int*)probes, npairs, nlist, cap, offsets, pairs, work, n_work,
                          plan_smem ? nullptr : counters, (float*)out, (const float*)q, qparts,
                          nq, d, kpad / 2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float* sc = (const float*)scale;
  float* o = (float*)out;
  if (row_mode == KIND_BF16)
    return launch_grouped<KIND_BF16>(work, n_work, pairs, qparts, nq, packed, sc, o, nprobe,
                                     nlist, npairs, cap, d, 1, st);
  const int vec_q = ((uintptr_t)q & 15) == 0 && d % 16 == 0;
  return launch_grouped<KIND_INT8>(work, n_work, pairs, q, nq, packed, sc, o, nprobe, nlist,
                                   npairs, cap, d, vec_q, st);
}

}  // extern "C"

// Dense-scan kernels K1 (f32 queries against bf16 or f32 rows) and K2
// (int8 query codes against int8 row codes) of advanced_rag_tpu_torch.
//
// K1 replaces ops/pallas_dense.py:_matmul_kernel and K2
// ops/pallas_dense.py:_matmul_sq8_kernel (both reached through the
// pallas_call at pallas_dense.py:78):
//
//   K1: out[q, r] = sum_d q[q, d] * float(rows[r, d]) + mask[r]
//   K2: out[q, r] = float(sum_d qc[q, d] * codes[r, d]) * scale[r] + mask[r]
//
// Plain C interface, as csrc/kernels.cu: an extern "C" launcher per kernel
// takes raw device pointers and a cudaStream_t and returns
// cudaGetLastError(); the wrappers in ops/dense_kernels.py allocate the
// [Q, N] f32 output, and the top-k runs outside on it.
//
// Bound on the H100: bytes.  Each row is read once (N * D * itemsize: 100
// MB of bf16 rows at N = 131072, D = 384) and the [Q, N] f32 output is
// written once (16.8 MB at Q = 32): 0.035 ms at 3.35 TB/s.  The tensor-core
// work stays below that (three bf16 passes of 2 * Q * N * D at 989 TFLOP/s:
// 0.010 ms; K2's int8 dot at 1,979 TOP/s: 0.002 ms), so the design keeps
// the memory busy and leaves the arithmetic to the tensor cores.  (The
// first port gave each thread one row: uncoalesced 16-byte loads 768 bytes
// apart, the dot as f32 FMAs or dp4a on the CUDA cores, nothing in flight
// during the arithmetic; at Q = 32 its own FMAs took longer than the bytes.)
//
// - Row tiles.  A block owns tiles of BM rows (128; 256 for 32 bf16 or f32
//   queries, see tile_rows) and walks over them as a persistent block
//   (grid = SMs x resident blocks), so the next tile's rows stream in
//   during this tile's epilogue.  One warp per 16 rows: 8 or 16 warps.
// - Async staging.  Every tile is cut into stages of BM rows x 128 bytes
//   (64 bf16, 128 int8 or 32 f32 values of each row), copied into a ring of
//   4 shared-memory stages with cp.async.cg 16-byte copies.  Eight
//   neighbouring threads copy the 128 contiguous bytes of one row, so every
//   warp reads whole 128-byte lines, and all stages but one are in flight
//   while the block computes on the current one.  A stage row's pitch is
//   144 bytes, so the eight rows an ldmatrix reads fall in distinct banks.
// - The query on the tensor cores.  The prologue splits each f32 query into
//   three bf16 parts (hi, mid, lo: hi = bf16(q), mid = bf16(q - hi), lo =
//   bf16(q - hi - mid); each difference is exact in f32) kept in shared
//   memory (74 KB at Q = 32, D = 384, over the 48 KB default, so the
//   launcher opts in).  The three parts carry q to about 2^-24 |q|, and a
//   bf16 x bf16 product is exact in f32, so the kernel computes the f32 dot
//   of dense_scores_plain up to summation order.  (The TPU kernel keeps two
//   parts, 2^-17 |q|.)  ops/dense_kernels.py:split_query_bf16 is its plain
//   version.
// - The product: mma.sync m16n8k16 bf16 -> f32 with rows as A (ldmatrix
//   from the stage) and the query parts as B (n = 8 queries per mma); the
//   three parts accumulate into the same f32 registers, and the fragments
//   of the next 16-value k step load while this one's products run.  K2:
//   mma.sync m16n8k32 s8 -> s32, exact (|sum| <= 127^2 * D < 2^24 for
//   D <= 1024).
// - Epilogue through shared memory: the scores (+ mask[r]; K2 first
//   __fmul_rn by scale[r], then __fadd_rn, so K2 is bit-identical to
//   sq8_scores_plain) go into the tile's consumed stage as [QC][BM], and
//   each query's BM scores leave in 16-byte stores along N.
// - Ragged edges inside the kernel: rows past N and bytes past D are
//   zero-filled in shared memory (cp.async with a source size of 0), and
//   rows whose base or stride is not 16-byte aligned are staged by element
//   copies instead of cp.async.
//
// - Wide rows.  The queries of a launch live in shared memory whole, so
//   past some width (bf16: 8 queries above D = 3264; f32: above 4960) they
//   do not fit next to the ring.  Such a row is scanned in slices of D
//   (ops/dense_kernels.py:scan_width): one launch per slice, each on its
//   columns of the rows and queries (`ld` apart), the first writing its
//   scores plus the mask and the later ones adding theirs into the output
//   (`add`).  The rows are still read once; each later slice reads and
//   writes the [Q, N] output once more (16 MB at Q = 32, N = 131072,
//   against 1 GB of bf16 rows at D = 4096).
//
// f32 rows use the same staged ring and stay on CUDA-core FMAs in f32 (an
// f32 dot at 67 TFLOP/s: 0.037 ms at N = 100k, Q = 32, under its 0.046 ms
// byte time): each thread keeps a TR x 4 (rows x queries) register tile and
// reads 16-byte vectors of its rows and of the transposed queries.
//
// Where it ends (H100 80GB HBM3, 700 W, chip_smoke.py phase 3; PERF.md has
// the numbers): within 1.2-1.5x of the byte bound at Q = 1 and 8; at
// Q = 32 the three mma.sync passes are not all hidden behind the stream,
// and the kernel trails one bf16 torch.matmul (one pass, bf16 output).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define ART_STAGE_ROW 144     // bytes per stage row: 128 of data + 16 pad
#define ART_NSTAGE 4          // stages in the ring
#define ART_SMEM_MAX 232448   // 227 KB, the most a block may opt in to

namespace {

enum { KIND_F32 = 0, KIND_BF16 = 1, KIND_INT8 = 2 };

template <int KIND>
struct Kind;
template <>
struct Kind<KIND_F32> {
  using T = uint32_t;
  static constexpr int kItem = 4;
};
template <>
struct Kind<KIND_BF16> {
  using T = uint16_t;
  static constexpr int kItem = 2;
};
template <>
struct Kind<KIND_INT8> {
  using T = uint8_t;
  static constexpr int kItem = 1;
};

// A block of BM-row tiles: 2 * BM threads (one warp per 16 rows), stages of
// BM rows x ART_STAGE_ROW bytes.
template <int BM>
struct Tile {
  static constexpr int kThreads = 2 * BM;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kStageBytes = BM * ART_STAGE_ROW;
};

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// D (+)= A * B for one m16 x n8 tile: c0, c1 at (row g, queries 2t, 2t + 1),
// c2, c3 at row g + 8 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_tile(float& c0, float& c1, float& c2, float& c3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tile(int& c0, int& c1, int& c2, int& c3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c0), "+r"(c1), "+r"(c2), "+r"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of one launch: the stage ring, then the queries.
//   bf16: [3 parts][QC][2 * round_up(D, 64) + 16 bytes]
//   int8: [QC][round_up(D, 128) + 16 bytes]
//   f32:  [round_up(D, 32)][QC] floats (k-major, for float4 reads of 4 queries)
// The 16 pad bytes put the eight rows of an ldmatrix in distinct banks.
__host__ __device__ __forceinline__ int query_pitch(int kind, int d) {
  return kind == KIND_BF16 ? 2 * round_up(d, 64) + 16 : round_up(d, 128) + 16;
}
__host__ __device__ __forceinline__ size_t query_bytes(int kind, int qc, int d) {
  if (kind == KIND_BF16) return (size_t)3 * qc * query_pitch(kind, d);
  if (kind == KIND_INT8) return (size_t)qc * query_pitch(kind, d);
  return (size_t)round_up(d, 32) * qc * 4;
}
__host__ __device__ __forceinline__ size_t scan_smem_bytes(int kind, int qc, int d, int bm) {
  return (size_t)ART_NSTAGE * bm * ART_STAGE_ROW + query_bytes(kind, qc, d);
}

// Rows per tile.  32 bf16 or f32 queries make the product (or the f32
// FMAs) per row byte large, and their query block leaves room for one
// block an SM: they get 256-row tiles, 16 warps to hide the product's
// latency, where those fit; everything else runs 128-row tiles.
__host__ __device__ __forceinline__ int tile_rows(int kind, int qc, int d) {
  return qc == 32 && kind != KIND_INT8 && scan_smem_bytes(kind, qc, d, 256) <= ART_SMEM_MAX
             ? 256
             : 128;
}

// Stage `i` of this block's sequence: tile blockIdx.x + (i / nk) * gridDim.x,
// bytes [128 * (i % nk), + 128) of each of its BM rows.
template <int KIND, int BM>
__device__ __forceinline__ void load_stage(uint8_t* stage, const uint8_t* rows, int n,
                                           int row_bytes, size_t row_pitch, int nk, int i,
                                           int vec) {
  using T = typename Kind<KIND>::T;
  constexpr int kItem = Kind<KIND>::kItem;
  const size_t tile = (size_t)blockIdx.x + (size_t)(i / nk) * gridDim.x;
  const int b_base = (i % nk) * 128;
  for (int c = threadIdx.x; c < BM * 8; c += Tile<BM>::kThreads) {
    const int r = c >> 3;
    const int b0 = b_base + (c & 7) * 16;
    const size_t row = tile * BM + r;
    uint8_t* dst = stage + r * ART_STAGE_ROW + (c & 7) * 16;
    const bool ok = row < (size_t)n && b0 < row_bytes;
    if (vec) {  // row_bytes % 16 == 0 and a 16-byte aligned base
      cp_async16(smem_addr(dst), ok ? rows + row * row_pitch + b0 : rows, ok ? 16 : 0);
    } else {
      T* dt = (T*)dst;
      const T* src = (const T*)(rows + (ok ? row * row_pitch : 0));
#pragma unroll
      for (int e = 0; e < 16 / kItem; ++e) {
        const int b = b0 + e * kItem;
        dt[e] = (ok && b < row_bytes) ? src[b / kItem] : (T)0;
      }
    }
  }
}

// 16 bytes of query row j (rows ld elements apart) at element k (4 f32 or
// 16 int8 values), zero past nq and D; one vector load when the row is
// 16-byte aligned there.
template <typename T>
__device__ __forceinline__ uint4 load_query_chunk(const T* q, int j, int k, int nq, int d,
                                                  int ld, bool vec) {
  constexpr int kPer = 16 / sizeof(T);
  uint4 v = make_uint4(0, 0, 0, 0);
  if (j >= nq) return v;
  const T* src = q + (size_t)j * ld + k;
  if (vec && k + kPer <= d) return __ldg((const uint4*)src);
  T* e = (T*)&v;
#pragma unroll
  for (int i = 0; i < kPer; ++i) e[i] = k + i < d ? src[i] : (T)0;
  return v;
}

// The block's queries into shared memory (see scan_smem_bytes).  Each
// thread has kBatch independent 16-byte loads in flight before it writes any
// of them, so the prologue costs a few L2 round trips, not one per value;
// the first stages' row copies are in flight meanwhile.
template <int KIND, int QC, int kThreads>
__device__ __forceinline__ void load_queries(uint8_t* qs, const void* q, int nq, int d,
                                             int ld) {
  constexpr int kBatch = 8;
  const int q_item = KIND == KIND_INT8 ? 1 : 4;  // int8 codes or f32 values
  const bool vec = ((uintptr_t)q & 15) == 0 && (ld * q_item) % 16 == 0;
  if (KIND == KIND_INT8) {
    const int dpad = round_up(d, 128), pitch = query_pitch(KIND, d);
    const int per_row = dpad / 16, total = QC * per_row;
    for (int c0 = threadIdx.x; c0 < total; c0 += kBatch * kThreads) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + u * kThreads;
        v[u] = c < total ? load_query_chunk((const int8_t*)q, c / per_row, (c % per_row) * 16,
                                            nq, d, ld, vec)
                         : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + u * kThreads;
        if (c < total) *(uint4*)(qs + (c / per_row) * pitch + (c % per_row) * 16) = v[u];
      }
    }
    return;
  }
  const int dpad = KIND == KIND_BF16 ? round_up(d, 64) : round_up(d, 32);
  const int per_row = dpad / 4, total = QC * per_row;
  for (int c0 = threadIdx.x; c0 < total; c0 += kBatch * kThreads) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads;
      v[u] = c < total ? load_query_chunk((const float*)q, c / per_row, (c % per_row) * 4, nq,
                                          d, ld, vec)
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads;
      if (c >= total) continue;
      const int j = c / per_row, k = (c % per_row) * 4;
      const float* x = (const float*)&v[u];
      if (KIND == KIND_BF16) {
        // hi, mid, lo: each a round-to-nearest bf16 of what the parts
        // before it leave; both differences are exact in f32
        const int pitch = query_pitch(KIND, d) / 2;  // in bf16 elements
        __nv_bfloat16* qb = (__nv_bfloat16*)qs + j * pitch + k;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat16 hi = __float2bfloat16_rn(x[i]);
          const float r1 = x[i] - __bfloat162float(hi);
          const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
          qb[i] = hi;
          qb[QC * pitch + i] = mid;
          qb[2 * QC * pitch + i] = __float2bfloat16_rn(r1 - __bfloat162float(mid));
        }
      } else {  // f32, k-major
        float* qt = (float*)qs + (size_t)k * QC + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) qt[i * QC] = x[i];
      }
    }
  }
}

// Warp layout of the tensor-core kinds: WM x WN warps, each owning MT
// m16 row tiles and NT n8 query tiles of the BM x QC block tile.
template <int QC, int BM>
struct MmaLayout {
  static constexpr int WN = QC >= 16 ? 2 : 1;
  static constexpr int WM = Tile<BM>::kWarps / WN;
  static constexpr int MT = BM / 16 / WM;
  static constexpr int NT = QC / 8 / WN;
};

// f32 layout: a warp owns 16 rows; LQ lanes across the queries (4 each), LR
// across rows; a thread owns rows warp * 16 + lr + LR * i (i < TR),
// consecutive rows in neighbouring lanes, so its float4 row reads fall in
// distinct banks.
template <int QC>
struct FmaLayout {
  static constexpr int LQ = QC / 4;
  static constexpr int LR = 32 / LQ;
  static constexpr int TR = 16 / LR;
};

template <int KIND, int QC, int BM>
struct Acc {
  using V = typename std::conditional<KIND == KIND_INT8, int, float>::type;
  static constexpr int N = KIND == KIND_F32 ? FmaLayout<QC>::TR * 4
                                            : MmaLayout<QC, BM>::MT * MmaLayout<QC, BM>::NT * 4;
  V v[N];
};

// The A (rows) and B (query parts) fragments of one 32-byte k step.
template <int KIND, int QC, int BM>
struct Frags {
  static constexpr int NPART = KIND == KIND_BF16 ? 3 : 1;
  uint32_t a[MmaLayout<QC, BM>::MT][4];
  uint32_t b[NPART][MmaLayout<QC, BM>::NT][2];
};

template <int KIND, int QC, int BM>
__device__ __forceinline__ void load_frags(Frags<KIND, QC, BM>& f, uint32_t a_base,
                                           uint32_t b_base, int pitch, int ks) {
  using L = MmaLayout<QC, BM>;
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt) {
    ldmatrix_x4(f.a[mt], a_base + mt * 16 * ART_STAGE_ROW + ks * 32);
  }
#pragma unroll
  for (int p = 0; p < Frags<KIND, QC, BM>::NPART; ++p) {
    const uint32_t bp = b_base + p * QC * pitch + ks * 32;
    if constexpr (L::NT >= 2) {
#pragma unroll
      for (int np = 0; np < L::NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, bp + np * 16 * pitch);
        f.b[p][2 * np][0] = r[0];
        f.b[p][2 * np][1] = r[1];
        f.b[p][2 * np + 1][0] = r[2];
        f.b[p][2 * np + 1][1] = r[3];
      }
    } else {
      ldmatrix_x2(f.b[p][0][0], f.b[p][0][1], bp);
    }
  }
}

// One stage's product into the accumulators.  kb0: the stage's first byte
// within a row (the queries' k offset, in bytes of the row's type).
template <int KIND, int QC, int BM>
__device__ __forceinline__ void compute_stage(Acc<KIND, QC, BM>& acc, const uint8_t* stage,
                                              const uint8_t* qs, int kb0, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (KIND == KIND_F32) {
    using L = FmaLayout<QC>;
    const int lq = lane % L::LQ, lr = lane / L::LQ;
    const float* qt = (const float*)qs + (size_t)(kb0 / 4) * QC + lq * 4;
#pragma unroll
    for (int k4 = 0; k4 < 8; ++k4) {
      float4 x[L::TR];
#pragma unroll
      for (int i = 0; i < L::TR; ++i) {
        x[i] = *(const float4*)(stage + (warp * 16 + lr + L::LR * i) * ART_STAGE_ROW +
                                k4 * 16);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 qv = *(const float4*)(qt + (k4 * 4 + kk) * QC);
#pragma unroll
        for (int i = 0; i < L::TR; ++i) {
          const float xv = kk == 0 ? x[i].x : kk == 1 ? x[i].y : kk == 2 ? x[i].z : x[i].w;
          acc.v[i * 4 + 0] = fmaf(qv.x, xv, acc.v[i * 4 + 0]);
          acc.v[i * 4 + 1] = fmaf(qv.y, xv, acc.v[i * 4 + 1]);
          acc.v[i * 4 + 2] = fmaf(qv.z, xv, acc.v[i * 4 + 2]);
          acc.v[i * 4 + 3] = fmaf(qv.w, xv, acc.v[i * 4 + 3]);
        }
      }
    }
  } else {
    using L = MmaLayout<QC, BM>;
    const int wm = warp % L::WM, wn = warp / L::WM;
    const int pitch = query_pitch(KIND, d);
    const uint32_t a_base = smem_addr(stage) +
                            (wm * L::MT * 16 + (lane & 15)) * ART_STAGE_ROW + (lane >> 4) * 16;
    // B rows: query n, 16 bytes at k byte offset kb; x4 covers two n8 tiles
    const int b_row = wn * L::NT * 8 + (lane & 7) + (L::NT >= 2 ? (lane >> 4) << 3 : 0);
    const uint32_t b_base = smem_addr(qs) + b_row * pitch + kb0 + ((lane >> 3) & 1) * 16;
    // the fragments of the next k step load while this one's products run
    Frags<KIND, QC, BM> f[2];
    load_frags(f[0], a_base, b_base, pitch, 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // 32 bytes of k per mma: k16 bf16, k32 int8
      if (ks < 3) load_frags(f[(ks + 1) & 1], a_base, b_base, pitch, ks + 1);
      const auto& cur = f[ks & 1];
#pragma unroll
      for (int p = 0; p < Frags<KIND, QC, BM>::NPART; ++p) {
#pragma unroll
        for (int mt = 0; mt < L::MT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt) {
            const int o = (mt * L::NT + nt) * 4;
            mma_tile(acc.v[o], acc.v[o + 1], acc.v[o + 2], acc.v[o + 3], cur.a[mt],
                     cur.b[p][nt][0], cur.b[p][nt][1]);
          }
        }
      }
    }
  }
}

// The tile's scores: each thread writes its accumulators (scaled and
// masked; no mask where `mask` is null) into the tile's consumed stage as
// [QC][BM + 4] f32, then the block writes each query's BM contiguous
// scores with 16-byte stores, so the [Q, N] output goes out in whole
// 128-byte lines, or, with `add`, adds them to what the output holds (a
// later slice of a wide row).  `ot` is the stage
// the tile's last product read; the caller synchronises before and after.
template <int KIND, int QC, int BM>
__device__ __forceinline__ void stage_scores(const Acc<KIND, QC, BM>& acc, float* ot,
                                             size_t base, const float* __restrict__ scale,
                                             const float* __restrict__ mask, int n) {
  constexpr int OTP = BM + 4;  // pitch: fragment writes fall in distinct banks
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (KIND == KIND_F32) {
    using L = FmaLayout<QC>;
    const int lq = lane % L::LQ, lr = lane / L::LQ;
#pragma unroll
    for (int i = 0; i < L::TR; ++i) {
      const int rr = warp * 16 + lr + L::LR * i;
      const float m = mask != nullptr && base + rr < (size_t)n ? __ldg(mask + base + rr) : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) ot[(lq * 4 + j) * OTP + rr] = __fadd_rn(acc.v[i * 4 + j], m);
    }
  } else {
    using L = MmaLayout<QC, BM>;
    const int wm = warp % L::WM, wn = warp / L::WM;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = wm * L::MT * 16 + mt * 16 + g + 8 * h;
        const bool live = base + rr < (size_t)n;
        const float m = live && mask != nullptr ? __ldg(mask + base + rr) : 0.0f;
        const float s = KIND == KIND_INT8 && live ? __ldg(scale + base + rr) : 0.0f;
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qj = (wn * L::NT + nt) * 8 + 2 * t + e;
            const auto v = acc.v[(mt * L::NT + nt) * 4 + 2 * h + e];
            ot[qj * OTP + rr] = KIND == KIND_INT8 ? __fadd_rn(__fmul_rn((float)v, s), m)
                                                  : __fadd_rn((float)v, m);
          }
        }
      }
    }
  }
}

template <int QC, int BM>
__device__ __forceinline__ void write_scores(const float* ot, size_t base,
                                             float* __restrict__ out, int nq, int n, int add) {
  constexpr int OTP = BM + 4;
  const bool vec = (n & 3) == 0 && ((uintptr_t)out & 15) == 0;
  for (int c = threadIdx.x; c < QC * (BM / 4); c += Tile<BM>::kThreads) {
    const int j = c / (BM / 4), r4 = (c % (BM / 4)) * 4;
    if (j >= nq) break;  // c grows with j
    const size_t r = base + r4;
    if (r >= (size_t)n) continue;
    float4 v = *(const float4*)(ot + j * OTP + r4);
    float* dst = out + (size_t)j * n + r;
    if (vec && r + 4 <= (size_t)n) {
      if (add) {
        const float4 o = *(const float4*)dst;
        v = make_float4(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y), __fadd_rn(o.z, v.z),
                        __fadd_rn(o.w, v.w));
      }
      *(float4*)dst = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
      for (int i = 0; i < 4 && r + i < (size_t)n; ++i) dst[i] = add ? __fadd_rn(dst[i], e[i]) : e[i];
    }
  }
}

// The block's whole run: the persistent walk over its tiles.  `d` values
// of each row and query, whose rows lie `ld` elements apart (ld > d: one
// slice of a wide row; `add` then adds into the output).
template <int KIND, int QC, int BM>
__device__ __forceinline__ void scan_block(const void* __restrict__ q,
                                           const uint8_t* __restrict__ rows,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ mask,
                                           float* __restrict__ out, int nq, int n, int d,
                                           int ld, int add, int vec) {
  constexpr int kStage = Tile<BM>::kStageBytes;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* qs = smem + ART_NSTAGE * kStage;
  const int row_bytes = d * Kind<KIND>::kItem;
  const size_t row_pitch = (size_t)ld * Kind<KIND>::kItem;
  const int nk = (row_bytes + 127) / 128;
  const int ntiles = (n + BM - 1) / BM;
  const int total = ((ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * nk;

  // the first stages' copies go out before the queries are staged
#pragma unroll
  for (int s = 0; s < ART_NSTAGE - 1; ++s) {
    if (s < total)
      load_stage<KIND, BM>(smem + s * kStage, rows, n, row_bytes, row_pitch, nk, s, vec);
    cp_async_commit();
  }
  load_queries<KIND, QC, Tile<BM>::kThreads>(qs, q, nq, d, ld);

  Acc<KIND, QC, BM> acc;
#pragma unroll
  for (int i = 0; i < Acc<KIND, QC, BM>::N; ++i) acc.v[i] = 0;

  for (int it = 0; it < total; ++it) {
    cp_async_wait<ART_NSTAGE - 2>();
    __syncthreads();  // stage `it` has landed; stage it - 1 is free again
    const int nx = it + ART_NSTAGE - 1;
    if (nx < total) {
      load_stage<KIND, BM>(smem + (nx % ART_NSTAGE) * kStage, rows, n, row_bytes, row_pitch,
                           nk, nx, vec);
    }
    cp_async_commit();
    const int kc = it % nk;
    uint8_t* stage = smem + (it % ART_NSTAGE) * kStage;
    compute_stage<KIND, QC, BM>(acc, stage, qs, kc * 128, d);
    if (kc == nk - 1) {
      const size_t base = ((size_t)blockIdx.x + (size_t)(it / nk) * gridDim.x) * BM;
      __syncthreads();  // every warp is done with this stage's rows
      stage_scores<KIND, QC, BM>(acc, (float*)stage, base, scale, mask, n);
      __syncthreads();
      write_scores<QC, BM>((const float*)stage, base, out, nq, n, add);
#pragma unroll
      for (int i = 0; i < Acc<KIND, QC, BM>::N; ++i) acc.v[i] = 0;
    }
  }
  cp_async_wait<0>();
}

template <int QC, bool BF16, int BM>
__global__ void __launch_bounds__(2 * BM)
dense_scores_kernel(const void* __restrict__ q, const uint8_t* __restrict__ rows,
                    const float* __restrict__ scale, const float* __restrict__ mask,
                    float* __restrict__ out, int nq, int n, int d, int ld, int add,
                    int vec) {
  scan_block<BF16 ? KIND_BF16 : KIND_F32, QC, BM>(q, rows, scale, mask, out, nq, n, d, ld, add,
                                                   vec);
}

template <int QC, int BM>
__global__ void __launch_bounds__(2 * BM)
sq8_scores_kernel(const void* __restrict__ q, const uint8_t* __restrict__ rows,
                  const float* __restrict__ scale, const float* __restrict__ mask,
                  float* __restrict__ out, int nq, int n, int d, int ld, int add, int vec) {
  scan_block<KIND_INT8, QC, BM>(q, rows, scale, mask, out, nq, n, d, ld, add, vec);
}

template <int KIND, int QC, int BM>
int launch_scan(const void* q, const void* rows, const void* scale, const void* mask,
                void* out, int nq, int n, int d, int ld, int add, int vec, cudaStream_t st) {
  const size_t smem = scan_smem_bytes(KIND, QC, d, BM);
  if (smem > ART_SMEM_MAX) return (int)cudaErrorInvalidValue;
  void (*kern)(const void*, const uint8_t*, const float*, const float*, float*, int, int, int,
               int, int, int);
  if constexpr (KIND == KIND_INT8) {
    kern = sq8_scores_kernel<QC, BM>;
  } else {
    kern = dense_scores_kernel<QC, KIND == KIND_BF16, BM>;
  }
  // the opt-in and the resident-block count of the last (device, smem)
  // this instance launched with on this host thread (a ctypes call
  // releases the GIL), so a steady caller pays neither again
  static thread_local int last_dev = -1, resident = 0;
  static thread_local size_t last_smem = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != last_dev || smem != last_smem) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 2 * BM, smem)) !=
        cudaSuccess)
      return (int)e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    last_dev = dev;
    last_smem = smem;
  }
  const int ntiles = (n + BM - 1) / BM;
  const int grid = ntiles < resident ? ntiles : resident;
  kern<<<grid, 2 * BM, smem, st>>>(q, (const uint8_t*)rows, (const float*)scale,
                                   (const float*)mask, (float*)out, nq, n, d, ld, add, vec);
  return (int)cudaGetLastError();
}

template <int KIND>
int dispatch_scan(const void* q, const void* rows, const void* scale, const void* mask,
                  void* out, int nq, int n, int d, int ld, int add, int vec, cudaStream_t st) {
  if (nq <= 8)
    return launch_scan<KIND, 8, 128>(q, rows, scale, mask, out, nq, n, d, ld, add, vec, st);
  if (nq <= 16)
    return launch_scan<KIND, 16, 128>(q, rows, scale, mask, out, nq, n, d, ld, add, vec, st);
  if (tile_rows(KIND, 32, d) == 256) {
    if constexpr (KIND != KIND_INT8)
      return launch_scan<KIND, 32, 256>(q, rows, scale, mask, out, nq, n, d, ld, add, vec, st);
  }
  return launch_scan<KIND, 32, 128>(q, rows, scale, mask, out, nq, n, d, ld, add, vec, st);
}

}  // namespace

extern "C" {

// K1.  q: f32 [nq, ld]; rows: [n, ld], row_dtype 0 = float32, 1 = bfloat16;
// mask: f32 [n] or null (no mask); out: f32 [nq, n].  The scan takes the
// first d values of each row and query: the whole row where d == ld, one
// slice of a row too wide for the queries' shared memory otherwise (the
// caller offsets q and rows to the slice); add: add the slice's scores to
// out instead of writing them.  vec: d and ld * itemsize % 16 == 0 and a
// 16-byte aligned rows base (else rows are staged by element copies).
int art_dense_scores(const void* q, const void* rows, int row_dtype, const void* mask,
                     void* out, int nq, int n, int d, int ld, int add, int vec,
                     void* stream) {
  if (nq < 1 || nq > 32 || n < 1 || d < 1 || ld < d) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return row_dtype == 1
             ? dispatch_scan<KIND_BF16>(q, rows, nullptr, mask, out, nq, n, d, ld, add, vec, st)
             : dispatch_scan<KIND_F32>(q, rows, nullptr, mask, out, nq, n, d, ld, add, vec, st);
}

// K2.  qcodes: int8 [nq, d], d % 4 == 0; codes: int8 [n, d]; scale, mask:
// f32 [n]; out: f32 [nq, n].  vec as for K1.
int art_sq8_scores(const void* qcodes, const void* codes, const void* scale,
                   const void* mask, void* out, int nq, int n, int d, int vec,
                   void* stream) {
  if (nq < 1 || nq > 32 || n < 1 || d < 4 || d % 4 != 0) return (int)cudaErrorInvalidValue;
  return dispatch_scan<KIND_INT8>(qcodes, codes, scale, mask, out, nq, n, d, d, 0, vec,
                                  (cudaStream_t)stream);
}

}  // extern "C"

// Hand-written Hopper kernel K3 (BM25 scan over a table of the batch's query
// terms) of advanced_rag_tpu_torch; the dense scans K1 and K2 live in
// dense_scan.cu.
//
// Plain C interface: every kernel has an extern "C" launcher that takes raw
// device pointers, sizes and a cudaStream_t, launches on that stream and
// returns cudaGetLastError().  The Python wrapper (ops/sparse_kernels.py)
// binds the launcher with ctypes, allocates every output, checks device,
// dtype, shape and contiguity, and keeps a plain PyTorch version of the
// function beside it.  No PyTorch header is included, so nvcc builds this
// file in seconds.
//
// The kernel writes the full [Q, N] f32 score matrix plus the additive row
// mask (0 for live rows, -1e30 for dead ones), as the TPU kernel does; the
// top-k runs outside, through torch.topk on that matrix.

#include <cuda_runtime.h>
#include <stdint.h>

#define ART_QMAX 32
#define K3_THREADS 512
#define K3_PREFETCH 8         // slots a thread has in flight ahead of its work
#define K3_SMEM_MAX 232448    // 227 KB, the most a block may opt in to

namespace {

__device__ __forceinline__ float bf16_to_float(uint16_t h) {
  return __uint_as_float(((uint32_t)h) << 16);
}

// ---------------------------------------------------------------------------
// K3 and K3-ip: BM25 over the [P, N] slot mirror.  Replaces
// ops/pallas_sparse.py:_bm25_kernel and _ip_kernel (reached from
// sparse_topk_pallas, pallas_call at :164).
//
//   tfw[p, r] = tf*(k1+1) / max(tf + k1*(1 - b + b*dl[r]/max(avg_len, 1)), 1e-6)
//               (ip: tfw = tf), 0 where idx[p, r] < 0
//   out[q, r] = sum_p tfw[p, r] * sum_t q_w[q, t] * [idx[p, r] == q_idx[q, t]]
//               + mask[r]
//
// Bound on the H100: bytes.  The [P, N] mirror (i32 ids, bf16 tf, as the
// JAX package stores tf) is read once, N * P * 6 bytes (201 MB at the main
// path's N = 131072, P = 256), plus N * 8 of lengths and mask and the
// [Q, N] f32 output: 0.061-0.065 ms at 3.35 TB/s for Q = 1-32.  The
// function's arithmetic is one FMA per (live slot, query).
//
// What held the first port back: each thread compared every live slot with
// every live term of every query of the chunk (live slots x sum of live
// terms compares a row: ~60 x 600 at Q = 32), so the time grew with Q and
// not with bytes (2.8 ms at Q = 32).  This design:
//
// - A table of the chunk's distinct query terms, built by each block in
//   shared memory before its scan (no host sync, no second launch):
//     W[u][j] = sum_t q_w[j, t] * [q_idx[j, t] == id_u],
//   summed in t order from 0.0f by the one thread that owns query j, as the
//   compare loop sums its per-slot weight m, so W[u][j] is bit-identical to
//   that m.  The ids sit in an open-addressed hash (linear probing, at most
//   half full: 2 * next_pow2(QC * T) slots of (id, u)); any id >= 0 works,
//   so no vocabulary size is assumed.  W rows have a pitch of QC + 4 floats
//   (QC + 1 below 4 queries): rows are read as float4, and the 4 extra
//   floats put the float4s of different rows of one warp load in different
//   bank groups.  W stays in shared memory, not in device memory, because
//   every hit reads a whole row of it at random: from the L2 that is a round
//   trip per hit, from shared memory a few cycles.
// - The scan: one thread per row (a warp's loads of one slot are 32
//   consecutive elements), K3_PREFETCH slots loaded ahead of the slots being
//   worked on, so each thread keeps loads in flight while it looks up.  For
//   each live slot one lookup; on a hit acc[j] = fmaf(tfw, W[u][j], acc[j])
//   for every query j; a miss does nothing.  Skipping a miss leaves every
//   sum bit-identical to the compare loop's: there m = 0 for every query,
//   and fmaf(tfw, 0, acc) == acc for acc starting at +0 and finite tfw.
//   The work per row falls from live slots x sum of terms compares to live
//   slots lookups plus hits x QC FMAs.
// - Shared memory: the table takes up to 168 KB (QC = 32, T = 32), so the
//   launcher opts in above 48 KB and the wrapper's chunk plan (bm25_chunk
//   in ops/sparse_kernels.py, k3_smem_bytes here) picks the widest chunk
//   whose table fits 227 KB.  Blocks are persistent (as many as are
//   resident), so each builds its table once.
//
// All P slots of a row are read, as the TPU kernel reads them; reading
// fewer than the [P, N] mirror holds would change its layout.  Where it
// ends (H100 80GB HBM3, 700 W, chip_smoke.py phase 3; PERF.md has the
// numbers): 1.5x the byte bound at Q = 1, 2.2x at Q = 32, where the hits'
// whole-row FMAs, divergent across a warp, set the time.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int k3_pitch(int qc) { return qc < 4 ? qc + 1 : qc + 4; }

__host__ __device__ inline int k3_hash_bits(int qc, int t) {
  int bits = 1;
  while ((1 << bits) < 2 * qc * t) ++bits;
  return bits;
}

// W [QC * T][pitch] f32, the hash [2^bits] of (id, u), the staged query ids
// and weights [QC * T] each, and the counter of distinct ids (16 bytes).
__host__ __device__ inline size_t k3_smem_bytes(int qc, int t) {
  const size_t u = (size_t)qc * t;
  return u * k3_pitch(qc) * 4 + ((size_t)1 << k3_hash_bits(qc, t)) * 8 + u * 8 + 16;
}

__device__ __forceinline__ unsigned k3_hash(int id, int bits) {
  return ((unsigned)id * 2654435761u) >> (32 - bits);
}

// u of `id` in the table, or -1.
__device__ __forceinline__ int k3_find(const int2* slots, int id, int bits) {
  const unsigned hmask = (1u << bits) - 1u;
  unsigned h = k3_hash(id, bits);
  while (true) {
    const int2 s = slots[h];
    if (s.x == id) return s.y;
    if (s.x < 0) return -1;
    h = (h + 1u) & hmask;
  }
}

// Slot s of row r: its id (-1 past the last slot) and its tf.
__device__ __forceinline__ void k3_load_slot(const int* __restrict__ idx_t,
                                             const uint16_t* __restrict__ tf_t, int s, int p,
                                             int n, size_t r, int& id, uint16_t& tf) {
  const bool in = s < p;
  id = in ? __ldg(idx_t + (size_t)s * n + r) : -1;
  tf = in ? __ldg(tf_t + (size_t)s * n + r) : (uint16_t)0;
}

template <int QC>
__global__ void __launch_bounds__(K3_THREADS)
bm25_scores_kernel(const int* __restrict__ q_idx, const float* __restrict__ q_w,
                   const int* __restrict__ idx_t, const uint16_t* __restrict__ tf_t,
                   const float* __restrict__ dlen, const float* __restrict__ mask,
                   float* __restrict__ out, int nq, int t, int p, int n,
                   float k1, float b, float avg_len, int ip, int hbits) {
  constexpr int PITCH = k3_pitch(QC);
  extern __shared__ __align__(16) uint8_t smem[];
  const int u_max = QC * t, hsize = 1 << hbits;
  float* w_tab = (float*)smem;                         // [u_max][PITCH]
  int2* slots = (int2*)(w_tab + (size_t)u_max * PITCH);  // [hsize] (id, u)
  int* qi = (int*)(slots + hsize);                     // [QC, t] staged ids
  float* qw = (float*)(qi + u_max);                    // [QC, t] their weights
  int* count = (int*)(qw + u_max);
  const int tid = threadIdx.x;

  // 1. empty table, the chunk's terms staged (padding queries: no terms)
  for (int i = tid; i < u_max * PITCH; i += K3_THREADS) w_tab[i] = 0.0f;
  for (int i = tid; i < hsize; i += K3_THREADS) slots[i] = make_int2(-1, 0);
  for (int i = tid; i < u_max; i += K3_THREADS) {
    const bool live = i / t < nq;
    qi[i] = live ? __ldg(q_idx + i) : -1;
    qw[i] = live ? __ldg(q_w + i) : 0.0f;
  }
  if (tid == 0) *count = 0;
  __syncthreads();
  // 2. the distinct live ids into the hash
  for (int i = tid; i < u_max; i += K3_THREADS) {
    const int id = qi[i];
    if (id < 0) continue;
    unsigned h = k3_hash(id, hbits);
    while (true) {
      const int prev = atomicCAS(&slots[h].x, -1, id);
      if (prev == -1 || prev == id) break;
      h = (h + 1u) & (unsigned)(hsize - 1);
    }
  }
  __syncthreads();
  // 3. a row of W for each distinct id
  for (int h = tid; h < hsize; h += K3_THREADS) {
    if (slots[h].x >= 0) slots[h].y = atomicAdd(count, 1);
  }
  __syncthreads();
  // 4. the weight sums, in t order from 0.0f, one thread per query
  if (tid < nq && tid < QC) {
    for (int u = 0; u < t; ++u) {
      const int id = qi[tid * t + u];
      if (id >= 0) w_tab[k3_find(slots, id, hbits) * PITCH + tid] += qw[tid * t + u];
    }
  }
  __syncthreads();

  const float k1p1 = k1 + 1.0f;
  const size_t stride = (size_t)gridDim.x * K3_THREADS;
  for (size_t r = (size_t)blockIdx.x * K3_THREADS + tid; r < (size_t)n; r += stride) {
    float acc[QC];
#pragma unroll
    for (int j = 0; j < QC; ++j) acc[j] = 0.0f;
    const float norm = k1 * (1.0f - b + b * __ldg(dlen + r) / fmaxf(avg_len, 1.0f));
    int id_n[K3_PREFETCH];
    uint16_t tf_n[K3_PREFETCH];
#pragma unroll
    for (int g = 0; g < K3_PREFETCH; ++g) k3_load_slot(idx_t, tf_t, g, p, n, r, id_n[g], tf_n[g]);
    for (int s0 = 0; s0 < p; s0 += K3_PREFETCH) {
      int id_c[K3_PREFETCH];
      uint16_t tf_c[K3_PREFETCH];
#pragma unroll
      for (int g = 0; g < K3_PREFETCH; ++g) {
        id_c[g] = id_n[g];
        tf_c[g] = tf_n[g];
      }
      // the next slots' loads go out before this group's lookups
#pragma unroll
      for (int g = 0; g < K3_PREFETCH; ++g)
        k3_load_slot(idx_t, tf_t, s0 + K3_PREFETCH + g, p, n, r, id_n[g], tf_n[g]);
#pragma unroll
      for (int g = 0; g < K3_PREFETCH; ++g) {
        if (id_c[g] < 0) continue;
        const int u = k3_find(slots, id_c[g], hbits);
        if (u < 0) continue;
        const float tf = bf16_to_float(tf_c[g]);
        const float tfw = ip ? tf : tf * k1p1 / fmaxf(tf + norm, 1e-6f);
        const float* wr = w_tab + u * PITCH;
        if constexpr (QC >= 4) {
#pragma unroll
          for (int j = 0; j < QC; j += 4) {
            const float4 v = *(const float4*)(wr + j);
            acc[j] = fmaf(tfw, v.x, acc[j]);
            acc[j + 1] = fmaf(tfw, v.y, acc[j + 1]);
            acc[j + 2] = fmaf(tfw, v.z, acc[j + 2]);
            acc[j + 3] = fmaf(tfw, v.w, acc[j + 3]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < QC; ++j) acc[j] = fmaf(tfw, wr[j], acc[j]);
        }
      }
    }

    const float mk = __ldg(mask + r);
#pragma unroll
    for (int j = 0; j < QC; ++j) {
      if (j < nq) out[(size_t)j * n + r] = __fadd_rn(acc[j], mk);
    }
  }
}

template <int QC>
int launch_k3(const void* q_idx, const void* q_w, const void* idx_t, const void* tf_t,
              const void* dlen, const void* mask, void* out, int nq, int t, int p, int n,
              float k1, float b, float avg_len, int ip, cudaStream_t st) {
  const size_t smem = k3_smem_bytes(QC, t);
  if (smem > K3_SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = bm25_scores_kernel<QC>;
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
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, K3_THREADS, smem)) !=
        cudaSuccess)
      return (int)e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    last_dev = dev;
    last_smem = smem;
  }
  const int tiles = (n + K3_THREADS - 1) / K3_THREADS;
  const int grid = tiles < resident ? tiles : resident;
  kern<<<grid, K3_THREADS, smem, st>>>(
      (const int*)q_idx, (const float*)q_w, (const int*)idx_t, (const uint16_t*)tf_t,
      (const float*)dlen, (const float*)mask, (float*)out, nq, t, p, n, k1, b, avg_len, ip,
      k3_hash_bits(QC, t));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q_idx i32 / q_w f32 [nq, t] (-1 pad), idx_t i32 / tf_t bf16 [p, n], dlen
// and mask f32 [n] -> out f32 [nq, n].  nq <= 32 and the table of the
// chunk, QC = next_pow2(nq), must fit K3_SMEM_MAX (k3_smem_bytes).
int art_bm25_scores(const void* q_idx, const void* q_w, const void* idx_t,
                    const void* tf_t, const void* dlen, const void* mask, void* out,
                    int nq, int t, int p, int n, float k1, float b, float avg_len,
                    int ip, void* stream) {
  if (nq < 1 || nq > ART_QMAX || n < 1 || p < 1 || t < 1 || t > 1 << 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define ART_K3(QC)                                                                    \
  return launch_k3<QC>(q_idx, q_w, idx_t, tf_t, dlen, mask, out, nq, t, p, n, k1, b, \
                       avg_len, ip, st)
  if (nq <= 1) ART_K3(1);
  if (nq <= 2) ART_K3(2);
  if (nq <= 4) ART_K3(4);
  if (nq <= 8) ART_K3(8);
  if (nq <= 16) ART_K3(16);
  ART_K3(32);
#undef ART_K3
}

}  // extern "C"

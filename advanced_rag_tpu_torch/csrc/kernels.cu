// Hand-written Hopper kernel K3 (BM25 compare-scan) of advanced_rag_tpu_torch;
// the dense scans K1 and K2 live in dense_scan.cu.
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
//
// Queries are processed in chunks of at most ART_QMAX per launch; QC is the
// chunk's width rounded up to a power of two, a template parameter so that
// the per-row accumulators live in registers.  The wrapper picks the chunk
// so that the chunk's query terms fit 48 KB of shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define ART_QMAX 32
#define ART_THREADS 256

namespace {

__device__ __forceinline__ float bf16_to_float(uint16_t h) {
  return __uint_as_float(((uint32_t)h) << 16);
}

// ---------------------------------------------------------------------------
// K3 and K3-ip: BM25 compare-scan.  Replaces ops/pallas_sparse.py:_bm25_kernel
// and _ip_kernel (reached from sparse_topk_pallas).
//
//   tfw[p, r] = tf*(k1+1) / max(tf + k1*(1 - b + b*dl[r]/max(avg_len, 1)), 1e-6)
//               (ip: tfw = tf), 0 where idx[p, r] < 0
//   out[q, r] = sum_p tfw[p, r] * sum_t q_w[q, t] * [idx[p, r] == q_idx[q, t]]
//               + mask[r]
//
// Layout: the term-slot-major [P, N] mirror (i32 ids, bf16 tf, as the JAX
// package stores tf; upcast after the read), one thread per row, so a
// warp's loads of one slot are 32 consecutive elements.  tfw is computed once
// per slot; padding slots (idx < 0) are skipped, and each query's padding
// terms are compacted away in shared memory, which changes no sum.
//
// Bound on the H100: at the main path's shapes (N = 131072, the store's
// capacity, P = 256, T = 32) the bytes are N * P * 6 (idx and tf) + N * 8
// + 4 * Q * N, about 0.06 ms at 3.35 TB/s; the compare work is
// live slots * Q * T_live, which at Q = 32 and ~100-word chunks exceeds
// the byte time, so the kernel is bound by operations there and by bytes
// at Q = 1.
// ---------------------------------------------------------------------------
template <int QC>
__global__ void __launch_bounds__(ART_THREADS)
bm25_scores_kernel(const int* __restrict__ q_idx, const float* __restrict__ q_w,
                   const int* __restrict__ idx_t, const uint16_t* __restrict__ tf_t,
                   const float* __restrict__ dlen, const float* __restrict__ mask,
                   float* __restrict__ out, int nq, int t, int p, int n,
                   float k1, float b, float avg_len, int ip) {
  extern __shared__ int sm[];
  int* qi_s = sm;                           // [QC, t] compacted term ids
  float* qw_s = (float*)(sm + QC * t);      // [QC, t] their weights
  int* nt_s = sm + 2 * QC * t;              // [QC] live terms per query
  if (threadIdx.x < QC) {
    const int j = threadIdx.x;
    int c = 0;
    if (j < nq) {
      for (int u = 0; u < t; ++u) {
        const int id = q_idx[j * t + u];
        if (id >= 0) {
          qi_s[j * t + c] = id;
          qw_s[j * t + c] = q_w[j * t + u];
          ++c;
        }
      }
    }
    nt_s[j] = c;
  }
  __syncthreads();

  const float k1p1 = k1 + 1.0f;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t r = (size_t)blockIdx.x * blockDim.x + threadIdx.x; r < (size_t)n;
       r += stride) {
    float acc[QC];
#pragma unroll
    for (int j = 0; j < QC; ++j) acc[j] = 0.0f;
    const float norm = k1 * (1.0f - b + b * __ldg(dlen + r) / fmaxf(avg_len, 1.0f));

    for (int s = 0; s < p; ++s) {
      const size_t o = (size_t)s * n + r;
      const int id = __ldg(idx_t + o);
      const float tf = bf16_to_float(__ldg(tf_t + o));
      if (id < 0) continue;
      const float tfw = ip ? tf : tf * k1p1 / fmaxf(tf + norm, 1e-6f);
#pragma unroll
      for (int j = 0; j < QC; ++j) {
        float m = 0.0f;
        const int cnt = nt_s[j];
        for (int u = 0; u < cnt; ++u) {
          if (qi_s[j * t + u] == id) m += qw_s[j * t + u];
        }
        acc[j] = fmaf(tfw, m, acc[j]);
      }
    }

    const float mk = __ldg(mask + r);
#pragma unroll
    for (int j = 0; j < QC; ++j) {
      if (j < nq) out[(size_t)j * n + r] = __fadd_rn(acc[j], mk);
    }
  }
}

int grid_for(int n) {
  const int blocks = (n + ART_THREADS - 1) / ART_THREADS;
  return blocks > 0 ? blocks : 1;
}

}  // namespace

#define ART_DISPATCH_QC(nq, LAUNCH) \
  do {                              \
    if ((nq) <= 1) {                \
      LAUNCH(1);                    \
    } else if ((nq) <= 2) {         \
      LAUNCH(2);                    \
    } else if ((nq) <= 4) {         \
      LAUNCH(4);                    \
    } else if ((nq) <= 8) {         \
      LAUNCH(8);                    \
    } else if ((nq) <= 16) {        \
      LAUNCH(16);                   \
    } else {                        \
      LAUNCH(32);                   \
    }                               \
  } while (0)

static int qc_of(int nq) {
  int qc = 1;
  while (qc < nq) qc *= 2;
  return qc;
}

extern "C" {

int art_bm25_scores(const void* q_idx, const void* q_w, const void* idx_t,
                    const void* tf_t, const void* dlen, const void* mask, void* out,
                    int nq, int t, int p, int n, float k1, float b, float avg_len,
                    int ip, void* stream) {
  if (nq < 1 || nq > ART_QMAX || n < 1 || p < 1 || t < 1)
    return (int)cudaErrorInvalidValue;
  const int qc = qc_of(nq);
  const size_t smem = (size_t)qc * t * 2 * sizeof(int) + (size_t)qc * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
#define ART_K3(QC)                                                                 \
  bm25_scores_kernel<QC><<<grid_for(n), ART_THREADS, smem, st>>>(                  \
      (const int*)q_idx, (const float*)q_w, (const int*)idx_t, (const uint16_t*)tf_t, \
      (const float*)dlen, (const float*)mask, (float*)out, nq, t, p, n, k1, b,     \
      avg_len, ip)
  ART_DISPATCH_QC(nq, ART_K3);
#undef ART_K3
  return (int)cudaGetLastError();
}

}  // extern "C"

// Hand-written Hopper kernels of advanced_rag_tpu_torch.
//
// Plain C interface: every kernel has an extern "C" launcher that takes raw
// device pointers, sizes and a cudaStream_t, launches on that stream and
// returns cudaGetLastError().  The Python wrappers (ops/dense_kernels.py,
// ops/sparse_kernels.py) bind the launchers with ctypes, allocate every
// output, check device, dtype, shape and contiguity, and keep a plain
// PyTorch version of each function beside it.  No PyTorch header is
// included, so nvcc builds this file in seconds.
//
// Each kernel writes the full [Q, N] f32 score matrix plus the additive row
// mask (0 for live rows, -1e30 for dead ones), as the TPU kernels do; the
// top-k runs outside, through torch.topk on that matrix.
//
// Queries are processed in chunks of at most ART_QMAX per launch; QC is the
// chunk's width rounded up to a power of two, a template parameter so that
// the per-row accumulators live in registers.  The wrapper picks the chunk
// so that the chunk's queries fit 48 KB of shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define ART_QMAX 32
#define ART_THREADS 256

namespace {

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// ---------------------------------------------------------------------------
// K1: dense scan.  Replaces ops/pallas_dense.py:_matmul_kernel (reached from
// dense_topk_pallas).
//
//   out[q, r] = sum_d q[q, d] * float(rows[r, d]) + mask[r]
//
// The TPU kernel splits the f32 query into bf16 hi + lo halves so that its
// bf16 matrix unit keeps f32 query precision; here each (row, query) dot is
// an f32 FMA chain on the CUDA cores, which is the f32 dot that split
// approximates (and what the JAX package's exact "scan" rung computes).
//
// Bound on the H100: bytes.  Every row is read once, N * D * itemsize
// bytes over 3.35 TB/s (768 MB, 0.23 ms at N = 1M, D = 384, bf16), and the
// [Q, N] f32 output adds 4 * Q * N bytes (0.27 ms in all at Q = 32).  The
// same work on the bf16 tensor cores, two passes (hi and lo query halves)
// of 2 * N * Q * D at 989 TFLOP/s, is 0.05 ms at Q = 32; f32 rows at
// 67 TFLOP/s stay below their byte time too.  This design runs the dot as
// f32 FMAs on the CUDA cores (67 TFLOP/s: 0.37 ms at N = 1M, Q = 32), so at
// large Q its own arithmetic, not the bound, limits it; a tensor-core
// design is later work.  It keeps the query chunk in shared memory
// (broadcast reads, no bank conflicts) and gives each thread one row, read
// with 16-byte vector loads, with QC accumulators in registers.
// ---------------------------------------------------------------------------
template <int QC, bool BF16>
__global__ void __launch_bounds__(ART_THREADS)
dense_scores_kernel(const float* __restrict__ q, const void* __restrict__ rows_v,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int nq, int n, int d, int vec) {
  extern __shared__ float qs[];  // [QC, d]
  for (int i = threadIdx.x; i < QC * d; i += blockDim.x) {
    qs[i] = (i / d < nq) ? q[i] : 0.0f;
  }
  __syncthreads();

  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t r = (size_t)blockIdx.x * blockDim.x + threadIdx.x; r < (size_t)n;
       r += stride) {
    float acc[QC];
#pragma unroll
    for (int j = 0; j < QC; ++j) acc[j] = 0.0f;

    if (BF16) {
      const uint16_t* row = (const uint16_t*)rows_v + r * (size_t)d;
      if (vec) {  // d % 8 == 0 and 16-byte aligned rows
        const uint4* rp = (const uint4*)row;
        for (int v = 0; v < d / 8; ++v) {
          const uint4 w = __ldg(rp + v);
          float x[8] = {bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y),
                        bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w)};
#pragma unroll
          for (int j = 0; j < QC; ++j) {
            const float4 qa = *(const float4*)(qs + j * d + v * 8);
            const float4 qb = *(const float4*)(qs + j * d + v * 8 + 4);
            float a = acc[j];
            a = fmaf(qa.x, x[0], a);
            a = fmaf(qa.y, x[1], a);
            a = fmaf(qa.z, x[2], a);
            a = fmaf(qa.w, x[3], a);
            a = fmaf(qb.x, x[4], a);
            a = fmaf(qb.y, x[5], a);
            a = fmaf(qb.z, x[6], a);
            a = fmaf(qb.w, x[7], a);
            acc[j] = a;
          }
        }
      } else {
        for (int e = 0; e < d; ++e) {
          const float x = __uint_as_float(((uint32_t)__ldg(row + e)) << 16);
#pragma unroll
          for (int j = 0; j < QC; ++j) acc[j] = fmaf(qs[j * d + e], x, acc[j]);
        }
      }
    } else {
      const float* row = (const float*)rows_v + r * (size_t)d;
      if (vec) {  // d % 4 == 0 and 16-byte aligned rows
        const float4* rp = (const float4*)row;
        for (int v = 0; v < d / 4; ++v) {
          const float4 x = __ldg(rp + v);
#pragma unroll
          for (int j = 0; j < QC; ++j) {
            const float4 qa = *(const float4*)(qs + j * d + v * 4);
            float a = acc[j];
            a = fmaf(qa.x, x.x, a);
            a = fmaf(qa.y, x.y, a);
            a = fmaf(qa.z, x.z, a);
            a = fmaf(qa.w, x.w, a);
            acc[j] = a;
          }
        }
      } else {
        for (int e = 0; e < d; ++e) {
          const float x = __ldg(row + e);
#pragma unroll
          for (int j = 0; j < QC; ++j) acc[j] = fmaf(qs[j * d + e], x, acc[j]);
        }
      }
    }

    const float m = __ldg(mask + r);
#pragma unroll
    for (int j = 0; j < QC; ++j) {
      if (j < nq) out[(size_t)j * n + r] = __fadd_rn(acc[j], m);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: SQ8 scan.  Replaces ops/pallas_dense.py:_matmul_sq8_kernel (reached
// from dense_topk_sq8_pallas).
//
//   out[q, r] = float(sum_d qc[q, d] * codes[r, d]) * scale[r] + mask[r]
//
// The integer dot runs with __dp4a over int8x4 words, exact in int32
// (|v| <= 127, so |dot| <= 127^2 * D).  The query's own scale is applied
// by the wrapper to the k winners only, as the TPU wrapper does.  The
// multiply and the add round separately (__fmul_rn, __fadd_rn), so the
// result is bit-identical to the plain version's two PyTorch ops.
//
// Bound on the H100: bytes, N * D bytes of codes (384 MB at N = 1M,
// D = 384: 0.11 ms at 3.35 TB/s) plus the [Q, N] f32 output.  The int8
// operations (2 * N * Q * D) stay far below the int8 peak even on the
// CUDA cores' dp4a path, so one thread per row with 16-byte loads and the
// query codes in shared memory is enough.
// ---------------------------------------------------------------------------
template <int QC>
__global__ void __launch_bounds__(ART_THREADS)
sq8_scores_kernel(const int8_t* __restrict__ qcodes, const int8_t* __restrict__ codes,
                  const float* __restrict__ scale, const float* __restrict__ mask,
                  float* __restrict__ out, int nq, int n, int d, int vec) {
  extern __shared__ int qw[];  // [QC, d / 4] packed int8x4 words
  const int dw = d / 4;
  const int* qsrc = (const int*)qcodes;
  for (int i = threadIdx.x; i < QC * dw; i += blockDim.x) {
    qw[i] = (i / dw < nq) ? qsrc[i] : 0;
  }
  __syncthreads();

  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t r = (size_t)blockIdx.x * blockDim.x + threadIdx.x; r < (size_t)n;
       r += stride) {
    int acc[QC];
#pragma unroll
    for (int j = 0; j < QC; ++j) acc[j] = 0;

    const int8_t* row = codes + r * (size_t)d;
    if (vec) {  // d % 16 == 0 and 16-byte aligned rows
      const int4* rp = (const int4*)row;
      for (int v = 0; v < d / 16; ++v) {
        const int4 w = __ldg(rp + v);
#pragma unroll
        for (int j = 0; j < QC; ++j) {
          const int4 qv = *(const int4*)(qw + j * dw + v * 4);
          int a = acc[j];
          a = __dp4a(w.x, qv.x, a);
          a = __dp4a(w.y, qv.y, a);
          a = __dp4a(w.z, qv.z, a);
          a = __dp4a(w.w, qv.w, a);
          acc[j] = a;
        }
      }
    } else {  // d % 4 == 0: 4-byte words
      const int* rp = (const int*)row;
      for (int v = 0; v < dw; ++v) {
        const int w = __ldg(rp + v);
#pragma unroll
        for (int j = 0; j < QC; ++j) acc[j] = __dp4a(w, qw[j * dw + v], acc[j]);
      }
    }

    const float s = __ldg(scale + r);
    const float m = __ldg(mask + r);
#pragma unroll
    for (int j = 0; j < QC; ++j) {
      if (j < nq) {
        out[(size_t)j * n + r] = __fadd_rn(__fmul_rn((float)acc[j], s), m);
      }
    }
  }
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
// Layout: the term-slot-major [P, N] mirror, one thread per row, so a
// warp's loads of one slot are 32 consecutive words.  tfw is computed once
// per slot; padding slots (idx < 0) are skipped, and each query's padding
// terms are compacted away in shared memory, which changes no sum.
//
// Bound on the H100: at the main path's shapes (N = 131072, the store's
// capacity, P = 256, T = 32) the bytes are N * P * 8 (idx and tf) + N * 8
// + 4 * Q * N, about 0.08 ms at 3.35 TB/s; the compare work is
// live slots * Q * T_live, which at Q = 32 and ~100-word chunks exceeds
// the byte time, so the kernel is bound by operations there and by bytes
// at Q = 1.
// ---------------------------------------------------------------------------
template <int QC>
__global__ void __launch_bounds__(ART_THREADS)
bm25_scores_kernel(const int* __restrict__ q_idx, const float* __restrict__ q_w,
                   const int* __restrict__ idx_t, const float* __restrict__ tf_t,
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
      const float tf = __ldg(tf_t + o);
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

// row_dtype: 0 = float32 rows, 1 = bfloat16 rows.
int art_dense_scores(const void* q, const void* rows, int row_dtype, const void* mask,
                     void* out, int nq, int n, int d, int vec, void* stream) {
  if (nq < 1 || nq > ART_QMAX || n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)qc_of(nq) * d * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define ART_K1(QC)                                                                  \
  do {                                                                              \
    if (row_dtype == 1)                                                             \
      dense_scores_kernel<QC, true><<<grid_for(n), ART_THREADS, smem, st>>>(        \
          (const float*)q, rows, (const float*)mask, (float*)out, nq, n, d, vec);   \
    else                                                                            \
      dense_scores_kernel<QC, false><<<grid_for(n), ART_THREADS, smem, st>>>(       \
          (const float*)q, rows, (const float*)mask, (float*)out, nq, n, d, vec);   \
  } while (0)
  ART_DISPATCH_QC(nq, ART_K1);
#undef ART_K1
  return (int)cudaGetLastError();
}

int art_sq8_scores(const void* qcodes, const void* codes, const void* scale,
                   const void* mask, void* out, int nq, int n, int d, int vec,
                   void* stream) {
  if (nq < 1 || nq > ART_QMAX || n < 1 || d < 4 || d % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)qc_of(nq) * d;  // int8 codes, packed in words
  cudaStream_t st = (cudaStream_t)stream;
#define ART_K2(QC)                                                                 \
  sq8_scores_kernel<QC><<<grid_for(n), ART_THREADS, smem, st>>>(                   \
      (const int8_t*)qcodes, (const int8_t*)codes, (const float*)scale,            \
      (const float*)mask, (float*)out, nq, n, d, vec)
  ART_DISPATCH_QC(nq, ART_K2);
#undef ART_K2
  return (int)cudaGetLastError();
}

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
      (const int*)q_idx, (const float*)q_w, (const int*)idx_t, (const float*)tf_t, \
      (const float*)dlen, (const float*)mask, (float*)out, nq, t, p, n, k1, b,     \
      avg_len, ip)
  ART_DISPATCH_QC(nq, ART_K3);
#undef ART_K3
  return (int)cudaGetLastError();
}

}  // extern "C"

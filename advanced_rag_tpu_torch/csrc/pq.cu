// PQ asymmetric-distance scan (K6) for advanced_rag_tpu_torch.
//
// Replaces advanced_rag_tpu/ops/pq.py: the kernel of pq_scores_pallas
// (:328, pallas_call at :340).  Plain C interface, launched on the caller's
// stream, returns cudaGetLastError(); the wrapper is ops/pq_kernels.py.
//
//   out[q, r] = sum_m LUT[q, m, codes[r, m]]       (f32 sum, m in order)
//
// The lookup table arrives rounded to bf16, as the TPU kernel rounds it
// before its matmul.  The TPU kernel writes the lookup as a one-hot matmul
// because a TPU punishes gathers; the function is the same, and on Hopper
// the lookup is a shared-memory read.  Codes are stored as int8 and read as
// unsigned values 0..c-1 (c <= 16: bits <= 4).
//
// Bound on the H100: bytes.  The codes are read once (N * m bytes: 96 MB at
// N = 1M, m = 96) and the [Q, N] f32 scores written once (128 MB at Q = 32):
// 0.067 ms at 3.35 TB/s.  The Q * N * m table lookups (3.1e9 at Q = 32) run
// on the SMs' shared-memory ports, which this design does not feed at their
// peak, so at large Q the lookups, not the bytes, limit it.  The design: the
// table of a query chunk (at most 96 KB: Q 32 x m 96 x 16 entries x 2 bytes)
// is staged once per block in shared memory (opted in above 48 KB), each
// thread scores one row at a time with Q accumulators in registers, and the
// grid is sized to the SMs so the table is loaded a few hundred times, not
// once per 256 rows.  A lookup of one (query, subspace) pair stays inside
// 32 bytes of the table, 8 banks, so a warp's 32 lookups never conflict.

#include <cuda_runtime.h>
#include <stdint.h>

#define PQ_THREADS 256
#define PQ_QMAX 32

namespace {

__device__ __forceinline__ float bf16_to_f32(uint16_t h) {
  return __uint_as_float(((uint32_t)h) << 16);
}

template <int QC>
__global__ void __launch_bounds__(PQ_THREADS)
pq_scores_kernel(const uint8_t* __restrict__ codes, const uint16_t* __restrict__ lut,
                 float* __restrict__ out, int nq, int n, int m, int c, int vec) {
  extern __shared__ uint16_t ls[];  // [QC, m, c] bf16 table, zero past nq
  const int per_q = m * c;
  for (int i = threadIdx.x; i < QC * per_q; i += blockDim.x)
    ls[i] = (i / per_q < nq) ? lut[i] : (uint16_t)0;
  __syncthreads();

  const unsigned cmask = (unsigned)c - 1u;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t r = (size_t)blockIdx.x * blockDim.x + threadIdx.x; r < (size_t)n;
       r += stride) {
    float acc[QC];
#pragma unroll
    for (int j = 0; j < QC; ++j) acc[j] = 0.0f;
    const uint8_t* row = codes + r * (size_t)m;
    if (vec) {  // m % 16 == 0, 16-byte aligned rows
      const uint4* rp = (const uint4*)row;
      for (int v = 0; v < m / 16; ++v) {
        const uint4 w = __ldg(rp + v);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const unsigned code = (words[b >> 2] >> (8 * (b & 3))) & cmask;
          const uint16_t* e = ls + (v * 16 + b) * c + code;
#pragma unroll
          for (int j = 0; j < QC; ++j) acc[j] += bf16_to_f32(e[j * per_q]);
        }
      }
    } else {
      for (int mm = 0; mm < m; ++mm) {
        const unsigned code = (unsigned)__ldg(row + mm) & cmask;
        const uint16_t* e = ls + mm * c + code;
#pragma unroll
        for (int j = 0; j < QC; ++j) acc[j] += bf16_to_f32(e[j * per_q]);
      }
    }
#pragma unroll
    for (int j = 0; j < QC; ++j) {
      if (j < nq) out[(size_t)j * n + r] = acc[j];
    }
  }
}

template <int QC>
int launch_pq(const uint8_t* codes, const uint16_t* lut, float* out, int nq, int n,
              int m, int c, int vec, cudaStream_t st) {
  const size_t smem = (size_t)QC * m * c * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      pq_scores_kernel<QC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as fit on the SMs at once (each stages the table once)
  int per_sm = (int)((228 * 1024) / (smem + 1024));
  per_sm = per_sm < 1 ? 1 : (per_sm > 8 ? 8 : per_sm);
  long long blocks = ((long long)n + PQ_THREADS - 1) / PQ_THREADS;
  const long long cap_blocks = (long long)sms * per_sm;
  if (blocks > cap_blocks) blocks = cap_blocks;
  if (blocks < 1) blocks = 1;
  pq_scores_kernel<QC><<<(unsigned)blocks, PQ_THREADS, smem, st>>>(codes, lut, out, nq,
                                                                   n, m, c, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// codes [n, m] int8 (values 0..c-1), lut [nq, m, c] bf16 -> out [nq, n] f32.
int art_pq_scores(const void* codes, const void* lut, void* out, int nq, int n, int m,
                  int c, int vec, void* stream) {
  if (nq < 1 || nq > PQ_QMAX || n < 1 || m < 1 || c < 2 || c > 16 || (c & (c - 1)))
    return (int)cudaErrorInvalidValue;
  int qc = 1;
  while (qc < nq) qc *= 2;
  if ((size_t)qc * m * c * sizeof(uint16_t) > 227 * 1024) return (int)cudaErrorInvalidValue;
  const uint8_t* cd = (const uint8_t*)codes;
  const uint16_t* lt = (const uint16_t*)lut;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (qc) {
    case 1: return launch_pq<1>(cd, lt, o, nq, n, m, c, vec, st);
    case 2: return launch_pq<2>(cd, lt, o, nq, n, m, c, vec, st);
    case 4: return launch_pq<4>(cd, lt, o, nq, n, m, c, vec, st);
    case 8: return launch_pq<8>(cd, lt, o, nq, n, m, c, vec, st);
    case 16: return launch_pq<16>(cd, lt, o, nq, n, m, c, vec, st);
    default: return launch_pq<32>(cd, lt, o, nq, n, m, c, vec, st);
  }
}

}  // extern "C"

// IVF slab scan (K5, and K4 as its Q = 1 instance) for advanced_rag_tpu_torch.
//
// Replaces advanced_rag_tpu/ops/pallas_ivf.py: the kernel of
// ivf_topk_pallas_batch (K5, pallas_call at :193) and _slab_kernel of
// ivf_topk_pallas (K4, :36).  Plain C interface, launched on the caller's
// stream, returns cudaGetLastError(); the wrapper is ops/ivf_kernels.py.
//
//   out[q, i, r] = sum_d q[q, d] * float(packed[probes[q, i], r, d])      bf16/f32
//   out[q, i, r] = float(sum_d qc[q, d] * codes[probes[q, i], r, d])
//                  * scale[probes[q, i], r]                              SQ8
//
// The SQ8 query scale is applied by the wrapper afterwards, so the rounding
// order is the Pallas kernel's, (s * row_scale) * q_scale.  The integer dot
// is exact in int32 (|v| <= 127, D * 127^2 < 2^31) and the scale multiply
// rounds once (__fmul_rn), so SQ8 scores equal the plain version's bit for
// bit.  The wrapper gathers packed_rows, masks, and takes the top-k.
//
// The TPU kernel streams each probed slab HBM->VMEM through a scalar-
// prefetched index map on a sequential (Q, nprobe) grid.  Here blocks run
// in parallel and in no order: block (tile, i, q) reads its own probe id
// probes[q, i] and scores IVF_TILE rows of that partition, so a Q = 1
// search still fills the card (nprobe * cap / IVF_TILE blocks).
//
// Bound on the H100: bytes.  Each (query, probe) pair streams its slab,
// Q * nprobe * cap * D * itemsize bytes (1.57 GB at Q = 32, nprobe 32,
// cap 2000, D 384, bf16: 0.47 ms at 3.35 TB/s) against 2 flops a byte pair
// of work, far under the FMA rate.  Probes shared between the queries of a
// batch can be served from the 50 MB L2, so the unique slabs bound it from
// below.  The design keeps the loads coalesced: 8 lanes share one row and
// read it as consecutive 16-byte vectors (128 contiguous bytes a step), a
// warp covers 4 rows at a time, and the 8 partial sums of a row are
// combined with warp shuffles.  The query sits in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define IVF_THREADS 256
#define IVF_TILE 128
#define IVF_LANES 8  // lanes sharing one row

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

}  // extern "C"

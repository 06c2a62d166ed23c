// PQ asymmetric-distance scan (K6) for advanced_rag_tpu_torch.
//
// Replaces advanced_rag_tpu/ops/pq.py: the kernel of pq_scores_pallas
// (:328, pallas_call at :340).  Plain C interface, launched on the caller's
// stream, returns cudaGetLastError(); the wrapper is ops/pq_kernels.py.
//
//   out[q, r] = sum_m LUT[q, m, codes[r, m]]       (f32 sum)
//
// The lookup table arrives rounded to bf16, as the TPU kernel rounds it
// before its matmul.  Codes are stored as int8 and read as unsigned values
// masked to 0..c-1 (c <= 16: bits <= 4).
//
// Bound on the H100: bytes.  The codes are read once (N * m bytes: 96 MB at
// N = 1M, m = 96) and the [Q, N] f32 scores written once (128 MB at Q = 32):
// 0.067 ms at 3.35 TB/s.  The function's own arithmetic is Q * N * m adds.
//
// Two kernels, chosen by the chunk's query count (pq_kernels.py:pq_kernel_for):
//
// - pq_onehot_kernel, the TPU kernel's own formulation on the tensor cores:
//   the lookup as a product of a one-hot matrix [rows, m * 16] (1.0 where
//   code[r, mm] == k) and the table [m * 16, Q].  With c = 16 codes one
//   subspace is exactly one k16 step of mma.sync m16n8k16 (bf16 -> f32),
//   so no table entry is ever gathered: each lane builds its one-hot A
//   fragment from the code bytes of its two rows (rows g and g + 8 of an
//   m16 tile): one mask-and-xor for four codes (onehot_shifts), then a byte
//   extract and one 64-bit shift a code (onehot_pair; the k order inside a
//   subspace is permuted so that a lane's four k slots hold four
//   consecutive codes), and B is the subspace's 16 x 8 slice of the table,
//   read with ldmatrix from shared memory.  Products are
//   exact (one bf16 entry times 1.0); the tensor cores' f32 accumulation
//   may round otherwise than IEEE addition, so each group of 8 subspaces
//   accumulates from a fresh zero fragment and is added into the running
//   f32 sum with __fadd_rn.  Layout:
//   - the table [m][Q][16] bf16 (laid out by the wrapper, zero past c) is
//     staged once per block as [m8][QC][32 bytes]; the two 16-byte halves of
//     query row q swap places when bit 2 of q is set, so the eight rows one
//     ldmatrix phase reads fall in eight different bank groups;
//   - a block is 16 warps; a warp owns MT m16 tiles of rows (MT = 2 where
//     shared memory allows: BM = 512 rows a tile) and all QC / 8 n8 tiles
//     of queries, so each B fragment load serves MT products;
//   - code tiles are staged with cp.async 16-byte copies into a ring of two
//     stages (row pitch an odd number of 16-byte units, so the eight rows of
//     one code-word load fall in different banks); blocks are persistent and
//     the next tile's codes stream in during this tile's products;
//   - the epilogue goes through the consumed stage, 16 queries at a time,
//     so the scores leave in 16-byte stores along N, as K1's do;
//   - where the table and two code stages of all m subspaces do not fit
//     (m = 384 at D = 1536 needs 303 KB for 8 queries), the wrapper
//     launches the kernel once per group of subspaces (pq_kernels.py:
//     pq_plan): the codes are read ldc bytes a row apart, and each launch
//     after the first adds its f32 partial scores into the output.
//   (The first port gave each thread a row and did one 16-bit shared-memory
//   load per (row, subspace, query): 3.07e9 lane loads at N = 1M, Q = 32,
//   bound by the shared-memory pipe at about 0.4 ms.)
//   Where it ends (H100 80GB HBM3, 700 W, chip_smoke.py phase 3; PERF.md
//   has the numbers): building the one-hot words costs the same at any
//   query count, about 0.15 ms at N = 1M, m = 96, so the kernel is 4x its
//   byte bound at Q = 32 and loses to the lookup kernel below 9 queries.
// - pq_scores_kernel, the lookup kernel, for a few queries, where the
//   one-hot product would leave most of an n8 tile empty: the table of the
//   chunk (m x 16 entries a query) is staged once per block in shared
//   memory, each thread scores one row at a time with the queries'
//   accumulators in registers, one 16-bit load per (row, subspace, query).
//   A lookup of one (query, subspace) pair stays inside 32 bytes of the
//   table, 8 banks, so a warp's 32 lookups never conflict.

#include <cuda_runtime.h>
#include <stdint.h>

#define PQ_THREADS 256       // the lookup kernel's block
#define PQ_MMA_THREADS 512   // the one-hot kernel's block: 16 warps
#define PQ_QMAX 32
#define PQ_SMEM_MAX 232448   // 227 KB, the most a block may opt in to
#define PQ_GROUP 8           // subspaces summed in a fresh fragment

namespace {

__device__ __forceinline__ float bf16_to_f32(uint16_t h) {
  return __uint_as_float(((uint32_t)h) << 16);
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// D (+)= A * B for one m16 x n8 x k16 tile: c0, c1 at (row g, queries 2t,
// 2t + 1), c2, c3 at row g + 8 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The one-hot kernel.

// Subspaces rounded up to the group, the staged code row's pitch (an odd
// number of 16-byte units), a stage (the codes of BM = 256 * MT rows, or the
// epilogue's [min(QC, 16)][BM + 4] f32, whichever is larger) and the whole.
__host__ __device__ inline int pq_m8(int m) { return (m + PQ_GROUP - 1) / PQ_GROUP * PQ_GROUP; }
__host__ __device__ inline int pq_code_pitch(int m) { return 16 * (((m + 15) / 16) | 1); }
__host__ __device__ inline size_t pq_stage_bytes(int qc, int mt, int m) {
  const int bm = 256 * mt;
  const size_t codes = (size_t)bm * pq_code_pitch(m);
  const size_t epi = (size_t)(qc < 16 ? qc : 16) * (bm + 4) * 4;
  return codes > epi ? codes : epi;
}
__host__ __device__ inline size_t pq_onehot_smem(int qc, int mt, int m) {
  return (size_t)pq_m8(m) * qc * 32 + 2 * pq_stage_bytes(qc, mt, m);
}

// The shift of each code of a 4-code word (4 subspaces of one row) for
// lane column t: byte j of the result is 16 * code_j ^ 64 t.  The k order
// inside a subspace is permuted (onehot_table lays the table out the same
// way) so that lane t's four k slots (2t, 2t + 1, 2t + 8, 2t + 9) hold
// codes 4t .. 4t + 3: for those codes the byte is 16 * (code - 4t), one of
// 0, 16, 32, 48, and for every other code it is 64 or more.
__device__ __forceinline__ uint32_t onehot_shifts(uint32_t cw, uint32_t mask16, uint32_t t4) {
  return ((cw << 4) & mask16) ^ t4;
}

// The one-hot A words of byte `bb` of onehot_shifts: {hi, lo} = bf16 1.0
// (0x3F80) shifted left by that byte as one 64-bit value, so lo holds k
// 2t, 2t + 1 and hi k 2t + 8, 2t + 9; PTX clamps a 64-bit shift at 64, so
// another lane's code gives two zero words.
__device__ __forceinline__ void onehot_pair(uint32_t shifts, int bb, uint32_t& lo,
                                            uint32_t& hi) {
  const uint32_t s = __byte_perm(shifts, 0u, 0x4440u + bb);
  uint64_t r;
  asm("shl.b64 %0, %1, %2;" : "=l"(r) : "l"((uint64_t)0x3F80u), "r"(s));
  lo = (uint32_t)r;
  hi = (uint32_t)(r >> 32);
}

// Codes of tile `tile` (BM rows x m bytes, rows ldc bytes apart in global
// memory) into a stage of pitch-byte rows.
template <int BM>
__device__ __forceinline__ void load_codes(uint8_t* dst, const uint8_t* codes, int n, int m,
                                           int ldc, int pitch, size_t tile, int vec) {
  const int nch = (m + 15) / 16;
  for (int i = threadIdx.x; i < BM * nch; i += PQ_MMA_THREADS) {
    const int r = i / nch, ch = i % nch;
    const size_t row = tile * BM + r;
    const bool ok = row < (size_t)n;
    uint8_t* d = dst + r * pitch + ch * 16;
    if (vec) {  // m % 16 == 0, ldc % 16 == 0 and a 16-byte aligned base
      cp_async16(smem_addr(d), ok ? codes + row * ldc + ch * 16 : codes, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int b = ch * 16 + e;
        d[e] = ok && b < m ? codes[row * ldc + b] : (uint8_t)0;
      }
    }
  }
}

template <int QC, int MT>
__global__ void __launch_bounds__(PQ_MMA_THREADS, 1)
pq_onehot_kernel(const uint8_t* __restrict__ codes, const uint16_t* __restrict__ lut,
                 float* __restrict__ out, int nq, int ldq, int n, int m, int ldc, int c,
                 int vec, int accum) {
  constexpr int BM = 256 * MT, NT = QC / 8, EQ = QC < 16 ? QC : 16, OTP = BM + 4;
  extern __shared__ __align__(16) uint8_t smem[];
  const int m8 = pq_m8(m), pitch = pq_code_pitch(m);
  const size_t stage_bytes = pq_stage_bytes(QC, MT, m);
  uint8_t* lut_s = smem;                                  // [m8][QC][32 bytes]
  uint8_t* stages = smem + (size_t)m8 * QC * 32;          // 2 x stage_bytes
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t mask16 = (((uint32_t)c - 1u) << 4) * 0x01010101u, t4 = 0x40404040u * t;
  const int ntiles = (n + BM - 1) / BM;
  const int mine =
      (int)blockIdx.x < ntiles ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;

  // the first tile's codes go out before the table is staged
  if (mine > 0) load_codes<BM>(stages, codes, n, m, ldc, pitch, blockIdx.x, vec);
  cp_async_commit();
  for (int i = tid; i < m8 * QC * 2; i += PQ_MMA_THREADS) {
    const int h = i & 1, q = (i >> 1) % QC, mm = (i >> 1) / QC;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q < nq && mm < m) v = __ldg((const uint4*)(lut + ((size_t)mm * ldq + q) * 16) + h);
    *(uint4*)(lut_s + ((size_t)mm * QC + q) * 32 + ((h ^ ((q >> 2) & 1)) << 4)) = v;
  }
  // ldmatrix rows: lanes 0-7 / 8-15 read the k halves 0-7 / 8-15 of queries
  // 0-7 of an n8 pair, lanes 16-31 the same of queries 8-15 (x2: lanes 0-15)
  const int bq = (lane & 7) + ((lane >> 4) << 3), bh = (lane >> 3) & 1;
  const uint32_t lut_a = smem_addr(lut_s);

  for (int it = 0; it < mine; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` has landed (and the table); the other stage is free
    if (it + 1 < mine) {
      load_codes<BM>(stages + ((it + 1) & 1) * stage_bytes, codes, n, m, ldc, pitch,
                     (size_t)blockIdx.x + (size_t)(it + 1) * gridDim.x, vec);
    }
    cp_async_commit();
    uint8_t* st = stages + (it & 1) * stage_bytes;
    const uint8_t* rows = st + (warp * MT * 16 + g) * pitch;  // row g of the warp's tile 0

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

    for (int grp = 0; grp < m8; grp += PQ_GROUP) {
      float fr[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) fr[mt][nt][e] = 0.0f;
#pragma unroll
      for (int w4 = 0; w4 < PQ_GROUP / 4; ++w4) {
        uint32_t sh[MT][2];  // shifts of subspaces grp + 4 w4 .. + 3, rows g, g + 8
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          sh[mt][0] = onehot_shifts(*(const uint32_t*)(rows + mt * 16 * pitch + grp + 4 * w4),
                                    mask16, t4);
          sh[mt][1] = onehot_shifts(
              *(const uint32_t*)(rows + (mt * 16 + 8) * pitch + grp + 4 * w4), mask16, t4);
        }
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const uint32_t lb = lut_a + (uint32_t)(grp + 4 * w4 + bb) * QC * 32;
          uint32_t bf[NT][2];
          if constexpr (NT >= 2) {
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
              const int q = 16 * np + bq;
              uint32_t r[4];
              ldmatrix_x4(r, lb + q * 32 + ((bh ^ ((q >> 2) & 1)) << 4));
              bf[2 * np][0] = r[0];
              bf[2 * np][1] = r[1];
              bf[2 * np + 1][0] = r[2];
              bf[2 * np + 1][1] = r[3];
            }
          } else {
            const int q = lane & 7;
            ldmatrix_x2(bf[0][0], bf[0][1], lb + q * 32 + ((bh ^ ((q >> 2) & 1)) << 4));
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            onehot_pair(sh[mt][0], bb, a[0], a[2]);
            onehot_pair(sh[mt][1], bb, a[1], a[3]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(fr[mt][nt], a, bf[nt][0], bf[nt][1]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], fr[mt][nt][e]);
    }

    // epilogue through the consumed stage, EQ queries at a time
    __syncthreads();  // every warp has read this stage's codes
    float* ot = (float*)st;
    const size_t base = ((size_t)blockIdx.x + (size_t)it * gridDim.x) * BM;
    const bool vec_out = (n & 3) == 0 && ((uintptr_t)out & 15) == 0;
    for (int q0 = 0; q0 < QC && q0 < nq; q0 += EQ) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = warp * MT * 16 + mt * 16 + g + 8 * h;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int qj = nt * 8 + 2 * t + e - q0;
              if (qj >= 0 && qj < EQ) ot[qj * OTP + rr] = acc[mt][nt][2 * h + e];
            }
        }
      __syncthreads();
      for (int i = tid; i < EQ * (BM / 4); i += PQ_MMA_THREADS) {
        const int j = i / (BM / 4), r4 = (i % (BM / 4)) * 4;
        if (q0 + j >= nq) break;  // i grows with j
        const size_t r = base + r4;
        if (r >= (size_t)n) continue;
        float4 v = *(const float4*)(ot + j * OTP + r4);
        float* dst = out + (size_t)(q0 + j) * n + r;
        if (vec_out && r + 4 <= (size_t)n) {
          if (accum) {  // a later subspace group: add to the earlier groups' sum
            const float4 o = *(const float4*)dst;
            v = make_float4(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y), __fadd_rn(o.z, v.z),
                            __fadd_rn(o.w, v.w));
          }
          *(float4*)dst = v;
        } else {
          const float e4[4] = {v.x, v.y, v.z, v.w};
          for (int k = 0; k < 4 && r + k < (size_t)n; ++k)
            dst[k] = accum ? __fadd_rn(dst[k], e4[k]) : e4[k];
        }
      }
      __syncthreads();
    }
  }
  cp_async_wait_all();
}

// MT of a launch: 2 (512-row tiles) where shared memory allows, else 1.
inline int pq_onehot_mt(int qc, int m) { return pq_onehot_smem(qc, 2, m) <= PQ_SMEM_MAX ? 2 : 1; }

template <int QC, int MT>
int launch_onehot(const uint8_t* codes, const uint16_t* lut, float* out, int nq, int ldq,
                  int n, int m, int ldc, int c, int vec, int accum, cudaStream_t st) {
  const size_t smem = pq_onehot_smem(QC, MT, m);
  if (smem > PQ_SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = pq_onehot_kernel<QC, MT>;
  // the opt-in and the resident-block count of the last (device, smem),
  // per host thread (a ctypes call releases the GIL)
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
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, PQ_MMA_THREADS,
                                                           smem)) != cudaSuccess)
      return (int)e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    last_dev = dev;
    last_smem = smem;
  }
  const int ntiles = (n + 256 * MT - 1) / (256 * MT);
  const int grid = ntiles < resident ? ntiles : resident;
  kern<<<grid, PQ_MMA_THREADS, smem, st>>>(codes, lut, out, nq, ldq, n, m, ldc, c, vec,
                                           accum);
  return (int)cudaGetLastError();
}

template <int QC>
int dispatch_onehot(const uint8_t* codes, const uint16_t* lut, float* out, int nq, int ldq,
                    int n, int m, int ldc, int c, int vec, int accum, cudaStream_t st) {
  return pq_onehot_mt(QC, m) == 2
             ? launch_onehot<QC, 2>(codes, lut, out, nq, ldq, n, m, ldc, c, vec, accum, st)
             : launch_onehot<QC, 1>(codes, lut, out, nq, ldq, n, m, ldc, c, vec, accum, st);
}

// ---------------------------------------------------------------------------
// The lookup kernel.

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

bool pq_shape_ok(int nq, int n, int m, int c) {
  return nq >= 1 && nq <= PQ_QMAX && n >= 1 && m >= 1 && c >= 2 && c <= 16 && !(c & (c - 1));
}

}  // namespace

extern "C" {

// The lookup kernel.  codes [n, m] int8 (values 0..c-1), lut [nq, m, c]
// bf16 -> out [nq, n] f32.  vec: m % 16 == 0 and a 16-byte aligned base.
int art_pq_scores(const void* codes, const void* lut, void* out, int nq, int n, int m,
                  int c, int vec, void* stream) {
  if (!pq_shape_ok(nq, n, m, c)) return (int)cudaErrorInvalidValue;
  int qc = 1;
  while (qc < nq) qc *= 2;
  if ((size_t)qc * m * c * sizeof(uint16_t) > PQ_SMEM_MAX) return (int)cudaErrorInvalidValue;
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

// The one-hot kernel over m subspaces: codes [n, m] int8 (values 0..c-1),
// rows ldc bytes apart (a group of subspaces of wider codes); lut: the
// chunk's first query at the group's first subspace in the [.][ldq][16]
// bf16 table (zero past c); out [nq, n] f32, overwritten, or added to when
// accum is set (the wrapper splits m into groups whose table and code
// stages fit shared memory and sums their partial scores in order).  vec:
// m % 16 == 0, ldc % 16 == 0 and a 16-byte aligned base.
int art_pq_onehot(const void* codes, const void* lut, void* out, int nq, int ldq, int n,
                  int m, int ldc, int c, int vec, int accum, void* stream) {
  if (!pq_shape_ok(nq, n, m, c) || ldq < nq || ldc < m) return (int)cudaErrorInvalidValue;
  const uint8_t* cd = (const uint8_t*)codes;
  const uint16_t* lt = (const uint16_t*)lut;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (nq <= 8) return dispatch_onehot<8>(cd, lt, o, nq, ldq, n, m, ldc, c, vec, accum, st);
  if (nq <= 16) return dispatch_onehot<16>(cd, lt, o, nq, ldq, n, m, ldc, c, vec, accum, st);
  return dispatch_onehot<32>(cd, lt, o, nq, ldq, n, m, ldc, c, vec, accum, st);
}

}  // extern "C"

"""K6's one-hot kernel (csrc/pq.cu: pq_onehot_kernel) emulated in numpy at
the level of its lanes, against the port's plain ADC and the JAX package.

The kernel computes ``sum_m LUT_bf16[q, m, codes[r, m]]`` as a product of a
one-hot matrix [rows, m * 16] and the table [m * 16, Q] on the tensor cores
(``mma.sync`` m16n8k16).  The emulation repeats, for one block walking all
row tiles, what each lane of each warp does: the table staged in shared
memory with its 16-byte halves swapped on bit 2 of the query, the code
tiles staged at their padded pitch (bytes the kernel never writes hold
garbage), the code words a lane reads for its rows g and g + 8, the one-hot
A words it builds, the B words ``ldmatrix`` hands it, the fragment layouts
of A, B and C, the groups of 8 subspaces summed in a fresh fragment, and
the epilogue through shared memory.  Decoding the fragments into matrices
and multiplying them checks the index arithmetic the card runs.

Tolerance: the products are exact (a bf16 entry times 1.0), only the f32
sums run in another order than the plain one-hot matmul, so scores agree to
1e-6 of the largest score (tighter than the card's 1e-5 for the kernel,
which covers the tensor cores' own accumulation).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_rag_tpu.ops import pq as jpq
from advanced_rag_tpu_torch.ops import pq as pq
from advanced_rag_tpu_torch.ops import pq_kernels as pk
from advanced_rag_tpu_torch.ops.dense_kernels import SCAN_SMEM_MAX
from advanced_rag_tpu_torch.ops.pq import pq_scores_xla
from test_torch_parity import to_np

GROUP = pk.GROUP
WARPS = 16                 # a block of the one-hot kernel


def bf16_bits_to_f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def u32_at(buf, offs):
    """Little-endian 32-bit words of a byte buffer at byte offsets ``offs``."""
    offs = np.asarray(offs)
    return (buf[offs].astype(np.uint32) | buf[offs + 1].astype(np.uint32) << 8
            | buf[offs + 2].astype(np.uint32) << 16 | buf[offs + 3].astype(np.uint32) << 24)


def ldmatrix(buf, addr, nmat):
    """ldmatrix.m8n8.x{nmat}: lane L's register j is word L % 4 of the
    16-byte row that lane 8 j + L // 4 addresses."""
    lanes = np.arange(32)
    return [u32_at(buf, addr[8 * j + lanes // 4] + 4 * (lanes % 4)) for j in range(nmat)]


def onehot_shifts(cw, mask16, t4):
    """Byte j: 16 * code_j ^ 64 t (``onehot_shifts`` in pq.cu)."""
    return (((cw.astype(np.uint64) << 4) & mask16) ^ t4).astype(np.uint32)


def onehot_pair(shifts, bb):
    """{hi, lo} = 0x3F80 << byte bb of ``shifts``, one 64-bit shift that
    PTX clamps at 64 (a shift of 64 or more gives 0)."""
    s = ((shifts >> (8 * bb)) & 0xFF).astype(np.uint64)
    r = np.where(s < 64, np.uint64(0x3F80) << np.minimum(s, 63), 0).astype(np.uint64)
    return (r & 0xFFFFFFFF).astype(np.uint32), (r >> 32).astype(np.uint32)


def lo_hi(words):
    return bf16_bits_to_f32(words & 0xFFFF), bf16_bits_to_f32(words >> 16)


def emulate_launch(codes, table, nc, c, qc, mt_n, rng):
    """One launch: codes [n, m] uint8, table [m, >= nc, 16] bf16 bits (the
    chunk's first query at column 0) -> [nc, n] f32."""
    n, m = codes.shape
    m8 = -(-m // GROUP) * GROUP
    pitch = 16 * (-(-m // 16) | 1)
    bm, nt_n, eq = 256 * mt_n, qc // 8, min(qc, 16)
    # the table in shared memory: [m8][qc][32 bytes], halves swapped on q bit 2
    lut_s = np.zeros(m8 * qc * 32, np.uint8)
    for mm in range(m8):
        for q in range(qc):
            row = (table[mm, q] if q < nc and mm < m else np.zeros(16, np.uint16))
            for h in range(2):
                dst = (mm * qc + q) * 32 + ((h ^ ((q >> 2) & 1)) << 4)
                lut_s[dst:dst + 16] = row[8 * h:8 * h + 8].view(np.uint8)
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    t4 = (0x40404040 * t).astype(np.uint32)
    mask16 = ((c - 1) << 4) * 0x01010101
    bq, bh = (lanes & 7) + ((lanes >> 4) << 3), (lanes >> 3) & 1
    out = np.full((nc, n), np.nan, np.float32)
    nch = -(-m // 16)
    for tile in range(-(-n // bm)):
        stage = rng.integers(0, 256, bm * pitch).astype(np.uint8)   # garbage
        for r in range(bm):
            row = tile * bm + r
            chunk = np.zeros(nch * 16, np.uint8)
            if row < n:
                chunk[:m] = codes[row]
            stage[r * pitch:r * pitch + nch * 16] = chunk
        acc = np.zeros((WARPS, mt_n, nt_n, 16, 8), np.float32)
        for grp in range(0, m8, GROUP):
            fr = np.zeros_like(acc)
            for w4 in range(GROUP // 4):
                for bb in range(4):
                    mm = grp + 4 * w4 + bb
                    lb = mm * qc * 32
                    b_words = []
                    if nt_n >= 2:
                        for np_ in range(nt_n // 2):
                            q = 16 * np_ + bq
                            r4 = ldmatrix(lut_s, lb + q * 32 + ((bh ^ ((q >> 2) & 1)) << 4), 4)
                            b_words += [(r4[0], r4[1]), (r4[2], r4[3])]
                    else:
                        q = lanes & 7
                        r2 = ldmatrix(lut_s, lb + q * 32 + ((bh ^ ((q >> 2) & 1)) << 4), 2)
                        b_words = [(r2[0], r2[1])]
                    # B [k16, n8] of each n8 tile from its lane words
                    bmat = np.zeros((nt_n, 16, 8), np.float32)
                    for nt, (b0, b1) in enumerate(b_words):
                        for word, k0 in ((b0, 0), (b1, 8)):
                            lo, hi = lo_hi(word)
                            bmat[nt, k0 + 2 * t, g] = lo
                            bmat[nt, k0 + 2 * t + 1, g] = hi
                    for w in range(WARPS):
                        for mt in range(mt_n):
                            rows = (w * mt_n * 16 + g) * pitch + mt * 16 * pitch
                            sh0 = onehot_shifts(u32_at(stage, rows + grp + 4 * w4),
                                                mask16, t4)
                            sh1 = onehot_shifts(u32_at(stage, rows + 8 * pitch + grp + 4 * w4),
                                                mask16, t4)
                            a0, a2 = onehot_pair(sh0, bb)
                            a1, a3 = onehot_pair(sh1, bb)
                            amat = np.zeros((16, 16), np.float32)
                            for word, r0, k0 in ((a0, 0, 0), (a1, 8, 0), (a2, 0, 8),
                                                 (a3, 8, 8)):
                                lo, hi = lo_hi(word)
                                amat[r0 + g, k0 + 2 * t] = lo
                                amat[r0 + g, k0 + 2 * t + 1] = hi
                            for nt in range(nt_n):
                                fr[w, mt, nt] = (fr[w, mt, nt]
                                                 + amat.astype(np.float64)
                                                 @ bmat[nt].astype(np.float64)
                                                 ).astype(np.float32)
            acc = (acc + fr).astype(np.float32)
        # C fragments: c0, c1 at (g, 2t, 2t + 1), c2, c3 at row g + 8
        base = tile * bm
        for q0 in range(0, min(qc, nc), eq):
            ot = np.zeros((eq, bm + 4), np.float32)
            for w in range(WARPS):
                for mt in range(mt_n):
                    for h in range(2):
                        rr = w * mt_n * 16 + mt * 16 + g + 8 * h
                        for nt in range(nt_n):
                            for e in range(2):
                                qj = nt * 8 + 2 * t + e - q0
                                keep = (qj >= 0) & (qj < eq)
                                ot[qj[keep], rr[keep]] = acc[w, mt, nt, (g + 8 * h)[keep],
                                                             (2 * t + e)[keep]]
            for j in range(min(eq, nc - q0)):
                hi = min(bm, n - base)
                out[q0 + j, base:base + hi] = ot[j, :hi]
    return out


def emulate_onehot(codes, lut, seed=0):
    """The wrapper's one-hot launches (``pq_plan``) through
    ``emulate_launch`` -> [Q, n] f32: a launch over a group of subspaces
    reads its columns of the codes and its rows of the table, and a launch
    after a query chunk's first adds its partial scores to the output."""
    rng = np.random.default_rng(seed)
    nq, m, c = lut.shape
    table = to_np(pk.onehot_table(torch.from_numpy(lut)).view(torch.int16)).view(np.uint16)
    out = np.empty((nq, codes.shape[0]), np.float32)
    for p in pk.pq_plan(nq, m, c, "onehot"):
        qc = 8 if p.nc <= 8 else 16 if p.nc <= 16 else 32
        mg = p.s1 - p.s0
        mt_n = 2 if pk.onehot_smem_bytes(qc, 2, mg) <= SCAN_SMEM_MAX else 1
        part = emulate_launch(np.ascontiguousarray(codes.view(np.uint8)[:, p.s0:p.s1]),
                              table[p.s0:p.s1, p.q0:], p.nc, c, qc, mt_n, rng)
        rows = slice(p.q0, p.q0 + p.nc)
        out[rows] = part if p.s0 == 0 else (out[rows] + part).astype(np.float32)
    return out


def inputs(n, m, c, nq, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, c, size=(n, m)).astype(np.int8)
    lut = (rng.standard_normal((nq, m, c)) * 0.1).astype(np.float32)
    return codes, lut


def assert_close_to_largest(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert not np.isnan(got).any()
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("c", [2, 4, 8, 16])
@pytest.mark.parametrize("m,nq", [(8, 5), (12, 8), (100, 17), (96, 33)])
def test_emulated_fragments_match_the_plain_adc(c, m, nq):
    codes, lut = inputs(40, m, c, nq, c * 100 + m + nq)
    got = emulate_onehot(codes, lut)
    want = to_np(pq_scores_xla(torch.from_numpy(codes), torch.from_numpy(lut)))
    assert_close_to_largest(got, want, 1e-6)


def test_emulated_tiles_of_256_rows_for_wide_m():
    """m = 256: only 8 queries fit with their table, the tiles are 256 rows
    (MT = 1); three launches of 8, 8 and 2 queries, over two tiles, the
    second ragged."""
    codes, lut = inputs(300, 256, 16, 18, 3)
    assert pk.onehot_chunk(256) == 8
    assert pk.onehot_smem_bytes(8, 2, 256) > SCAN_SMEM_MAX
    got = emulate_onehot(codes, lut)
    want = to_np(pq_scores_xla(torch.from_numpy(codes), torch.from_numpy(lut)))
    assert_close_to_largest(got, want, 1e-6)


@pytest.mark.parametrize("nq", [9, 32])
def test_emulated_subspace_groups_at_the_default_width(nq):
    """m = 384 (auto_pq_m of the 1536-wide default embedder): no query chunk
    fits with all subspaces, so the launches split them, two groups of 192
    for 9 queries and three of 128 for 32, each adding into the output."""
    codes, lut = inputs(40, 384, 16, nq, nq)
    plan = pk.pq_plan(nq, 384, 16)
    assert [(p.s0, p.s1) for p in plan] == ([(0, 192), (192, 384)] if nq == 9 else
                                            [(0, 128), (128, 256), (256, 384)])
    got = emulate_onehot(codes, lut)
    want = to_np(pq_scores_xla(torch.from_numpy(codes), torch.from_numpy(lut)))
    assert_close_to_largest(got, want, 1e-6)


@pytest.mark.parametrize("m", [96, 192, 384])
@pytest.mark.parametrize("nq", [1, 8, 32])
@pytest.mark.parametrize("kernel", [None, "lookup", "onehot"])
def test_plan_takes_every_width_auto_pq_m_gives(m, nq, kernel):
    """D = 384, 768, 1536 at bits 4 give m = 96, 192, 384: every launch the
    planner makes fits the shared memory of the kernel it runs, and the
    launches cover each (query, subspace) pair once."""
    assert m in [pq.auto_pq_m(d, 4) for d in (384, 768, 1536)]
    plan = pk.pq_plan(nq, m, 16, kernel)
    cover = np.zeros((nq, m), int)
    for p in plan:
        assert p.kind == (kernel or pk.pq_kernel_for(min(pk.QMAX, nq)))
        if p.kind == "lookup":
            qc = 1 << (p.nc - 1).bit_length()
            assert (p.s0, p.s1) == (0, m) and qc * m * 16 * 2 <= SCAN_SMEM_MAX
        else:
            qc = 8 if p.nc <= 8 else 16 if p.nc <= 16 else 32
            assert pk.onehot_smem_bytes(qc, 1, p.s1 - p.s0) <= SCAN_SMEM_MAX
            assert p.s0 % 16 == 0
        cover[p.q0:p.q0 + p.nc, p.s0:p.s1] += 1
    assert (cover == 1).all()
    # one-hot launches of a chunk come in subspace order, the first at 0
    firsts = [p.s0 for p in plan if p.kind == "onehot"]
    assert not firsts or firsts[0] == 0


@pytest.mark.parametrize("c,nq", [(16, 9), (4, 32)])
def test_emulated_fragments_match_jax_pallas(c, nq):
    """Against the JAX package's pq_scores_pallas (interpret mode), over
    two 512-row tiles."""
    m = 16
    codes, lut = inputs(1024, m, c, nq, c + nq)
    want = np.asarray(jpq.pq_scores_pallas(jnp.asarray(codes), jnp.asarray(lut)))
    assert_close_to_largest(emulate_onehot(codes, lut), want, 1e-6)


def test_onehot_table_layout():
    rng = np.random.default_rng(4)
    lut = torch.from_numpy(rng.standard_normal((5, 7, 4)).astype(np.float32))
    t = pk.onehot_table(lut)
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (7, 5, 16)
    want = torch.zeros((7, 5, 16), dtype=torch.bfloat16)
    want[:, :, :4] = lut.to(torch.bfloat16).transpose(0, 1)
    assert torch.equal(t, want[:, :, pk.ONEHOT_K])
    # codes past c = 4 (12 of the 16 slots) hold zero
    assert int((t == 0).sum()) >= 12 * 7 * 5


def test_plan_matches_the_kernels_shared_memory():
    # m = 96, 32 queries: the table 96 x 32 x 32 bytes, two stages of 512
    # code rows at a 112-byte pitch (7 units of 16 bytes)
    assert pk.onehot_smem_bytes(32, 2, 96) == 96 * 32 * 32 + 2 * 512 * 112
    # m = 8: the epilogue's 8 x 516 f32 outgrow the 512 x 16-byte code rows
    assert pk.onehot_smem_bytes(8, 2, 8) == 8 * 8 * 32 + 2 * 8 * 516 * 4
    # m = 100 rounds to 104 subspaces in the table; 256-row tiles
    assert pk.onehot_smem_bytes(32, 2, 100) == 104 * 32 * 32 + 2 * 512 * 112
    assert pk.onehot_smem_bytes(32, 1, 100) == 104 * 32 * 32 + 2 * 256 * 112
    for m in (8, 96, 100):
        assert pk.onehot_chunk(m) == 32
        assert pk.onehot_smem_bytes(32, 2, m) <= SCAN_SMEM_MAX
    # m = 128: 32 queries fit with 256-row tiles only
    assert pk.onehot_chunk(128) == 32
    assert pk.onehot_smem_bytes(32, 2, 128) > SCAN_SMEM_MAX
    assert pk.onehot_chunk(192) == 16 and pk.onehot_chunk(256) == 8
    with pytest.raises(ValueError, match="shared memory"):
        pk.onehot_chunk(400)
    assert [pk.pq_kernel_for(q) for q in (1, pk.LOOKUP_MAX_Q, pk.LOOKUP_MAX_Q + 1, 32)] \
        == ["lookup", "lookup", "onehot", "onehot"]


def test_onehot_k_order_gives_each_lane_four_consecutive_codes():
    for t in range(4):
        slots = [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
        assert [pk.ONEHOT_K[k] for k in slots] == [4 * t + e for e in range(4)]
    assert sorted(pk.ONEHOT_K) == list(range(16))


def test_cpu_tensors_take_the_plain_adc():
    codes, lut = inputs(30, 8, 16, 6, 1)
    before = (pk.pq_scores.launches, pk.pq_scores.onehot_launches)
    got = pk.pq_scores(torch.from_numpy(codes), torch.from_numpy(lut))
    assert torch.equal(got, pq_scores_xla(torch.from_numpy(codes), torch.from_numpy(lut)))
    assert (pk.pq_scores.launches, pk.pq_scores.onehot_launches) == before
    with pytest.raises(ValueError, match="card"):
        pk.pq_scores_by(torch.from_numpy(codes), torch.from_numpy(lut), "onehot")


def test_onehot_words_select_each_code_in_its_permuted_slot():
    """Every code, through the four lanes' words, gives bf16 1.0 in exactly
    the slot ONEHOT_K names for it, and 0 in the other 15."""
    for c in (2, 4, 8, 16):
        mask16 = ((c - 1) << 4) * 0x01010101
        for code in range(c):
            cw = np.array([code | (code ^ 3) << 8 | 0xA0 << 16], np.uint32)   # byte 0
            row = np.zeros(16, np.float32)
            for t in range(4):
                sh = onehot_shifts(cw, mask16, np.uint32(0x40404040 * t))
                lo, hi = onehot_pair(sh, 0)
                for word, k0 in ((lo, 2 * t), (hi, 2 * t + 8)):
                    a, b = lo_hi(word)
                    row[k0] += a[0]
                    row[k0 + 1] += b[0]
            want = np.zeros(16, np.float32)
            want[pk.ONEHOT_K.index(code)] = 1.0
            np.testing.assert_array_equal(row, want)

"""The CPU-side pieces of K5's grouped route (csrc/ivf.cu: ivf_plan_kernel,
ivf_grouped_kernel), against numpy constructions and the plain K5.

- ``ivf_probe_groups_plain`` (the plan: per list the (q, i) pairs that probe
  it, the lists with a pair) against a numpy construction, on random,
  skewed, all-equal and nprobe = nlist probes and out-of-range ids.
- The work decomposition the grouped scan runs, taken from the launch-plan
  mirror ``grouped_plan``: items (list, row tile) x query chunks of QC,
  ragged cap, Q > QC, a list probed by every query; each (q, i, r) of the
  output is written exactly once (the plan writes the out-of-range pairs).
- The fragments: one item of the scan emulated in numpy at the level of its
  lanes (the tile in the Tensor Memory Accelerator's 128-byte swizzled
  boxes, the chunk's query rows at their padded pitch, pad bytes and the
  query rows past the chunk's count holding garbage; the words ``ldmatrix``
  hands each lane; the A, B and C layouts of ``mma.sync`` m16n8k16 bf16 and
  m16n8k32 s8), decoded into matrices and multiplied.
- The route: ``ivf_route`` streams K4, f32 slabs and what the grouped scan
  cannot take, picks the faster route of ``route_ms``, and agrees with the
  faster route where chip_smoke.py timed both; ``expected_lists`` against
  random draws.
- ``ivf_scores_grouped_plain`` (per list, the slab times its gathered
  queries) against ``ivf_scores_plain``, and through the K5 search against
  the JAX package's ``ivf_topk_pallas_batch`` (interpret mode).

Tolerances: SQ8 integer dots are exact and the row scale rounds once, so
SQ8 scores are bit-identical; f32 and bf16 slabs sum in another order than
the einsum, within 1e-6 of the largest score; the emulated fragments'
products are exact in float64 (1e-12); the search as in test_torch_ivf.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_rag_tpu.ops import ivf as jivf
from advanced_rag_tpu.ops.pallas_ivf import ivf_topk_pallas_batch
from advanced_rag_tpu_torch.models.convert import ivf_partitions_from_numpy
from advanced_rag_tpu_torch.ops import ivf_kernels as ik
from advanced_rag_tpu_torch.ops.dense_kernels import SCAN_SMEM_MAX, split_query_bf16
from advanced_rag_tpu_torch.ops.quant import sq8_quantize

from test_torch_parity import assert_ids_tie_aware, assert_scores_close

DTYPES = [torch.float32, torch.bfloat16, torch.int8]
GROUPED_DTYPES = [torch.bfloat16, torch.int8]     # f32 slabs always stream


def make_probes(pattern, nq, nprobe, nlist, rng):
    """[nq, nprobe] int32 probe lists of one pattern."""
    if pattern == "random":
        return np.stack([rng.choice(nlist, nprobe, replace=False)
                         for _ in range(nq)]).astype(np.int32)
    if pattern == "skewed":          # every query probes the same lists
        return np.tile(rng.choice(nlist, nprobe, replace=False), (nq, 1)).astype(np.int32)
    if pattern == "all_equal":       # every pair probes one list
        return np.full((nq, nprobe), nlist // 2, np.int32)
    if pattern == "every_list":      # nprobe = nlist
        assert nprobe == nlist
        return np.stack([rng.permutation(nlist) for _ in range(nq)]).astype(np.int32)
    if pattern == "clustered":       # half the queries share most of their lists
        p = make_probes("random", nq, nprobe, nlist, rng)
        p[: nq // 2, : nprobe - 2] = p[0, : nprobe - 2]
        return p
    if pattern == "out_of_range":    # some ids outside [0, nlist)
        p = make_probes("random", nq, nprobe, nlist, rng)
        p[0, 0], p[-1, -1], p[nq // 2, 1] = -1, nlist, nlist + 7
        return p
    raise ValueError(pattern)


PATTERNS = [("random", 5, 4, 23), ("skewed", 40, 6, 50), ("all_equal", 9, 3, 12),
            ("every_list", 7, 30, 30), ("clustered", 33, 8, 1500),
            ("out_of_range", 6, 5, 40)]


def groups_numpy(probes, nlist):
    flat = probes.reshape(-1)
    groups = [[e for e in range(flat.size) if flat[e] == lst] for lst in range(nlist)]
    counts = np.array([len(g) for g in groups])
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return offsets, groups, np.flatnonzero(counts)


@pytest.mark.parametrize("pattern,nq,nprobe,nlist", PATTERNS)
def test_probe_groups_plain_matches_numpy(pattern, nq, nprobe, nlist):
    rng = np.random.default_rng(nq * 100 + nlist)
    probes = make_probes(pattern, nq, nprobe, nlist, rng)
    offsets, pairs, work, n_work = ik.ivf_probe_groups_plain(torch.from_numpy(probes), nlist)
    want_off, want_groups, want_work = groups_numpy(probes, nlist)
    assert offsets.dtype == pairs.dtype == work.dtype == torch.int32
    np.testing.assert_array_equal(offsets.numpy(), want_off)
    np.testing.assert_array_equal(work.numpy(), want_work)
    assert n_work == len(want_work)
    for lst in range(nlist):
        assert pairs[offsets[lst]:offsets[lst + 1]].tolist() == want_groups[lst]
    valid = (probes >= 0) & (probes < nlist)
    assert int(offsets[-1]) == pairs.numel() == int(valid.sum())


def written_once(probes, nlist, cap, dtype, d):
    """Counts of the writes of each out[q, i, r] by the plan (out-of-range
    pairs) and by the grouped scan's items (list, row tile) x chunks."""
    bm, qc, _, _ = ik.grouped_plan(dtype, d)
    nq, nprobe = probes.shape
    offsets, pairs, work, n_work = ik.ivf_probe_groups_plain(torch.from_numpy(probes), nlist)
    offsets, pairs, work = offsets.numpy(), pairs.numpy(), work.numpy()
    writes = np.zeros((nq * nprobe, cap), np.int64)
    flat = probes.reshape(-1)
    writes[(flat < 0) | (flat >= nlist)] += 1
    ntiles = -(-cap // bm)
    grid = 7                                  # persistent blocks
    items = n_work * ntiles
    per = -(-items // grid)                   # a contiguous run of items a block
    for block in range(grid):
        for it in range(block * per, min(items, (block + 1) * per)):
            u, r0 = it // ntiles, (it % ntiles) * bm
            lst = work[u]
            for c0 in range(offsets[lst], offsets[lst + 1], qc):
                nc = min(qc, offsets[lst + 1] - c0)
                for j in range(qc):           # the chunk's columns, padding included
                    for rr in range(bm):
                        if j < nc and r0 + rr < cap:
                            writes[pairs[c0 + j], r0 + rr] += 1
    return writes


@pytest.mark.parametrize("dtype", GROUPED_DTYPES)
@pytest.mark.parametrize("pattern,nq,nprobe,nlist,cap", [
    ("random", 5, 4, 23, 100),             # ragged cap: 100 rows past every tile size
    ("skewed", 40, 6, 50, 129),            # Q > QC, every query on the same lists
    ("all_equal", 9, 3, 12, 64),           # one list probed by every pair (27 > QC)
    ("every_list", 7, 30, 30, 33),
    ("out_of_range", 6, 5, 40, 17)])
def test_work_decomposition_writes_each_output_once(dtype, pattern, nq, nprobe, nlist, cap):
    rng = np.random.default_rng(nq + nlist + cap)
    probes = make_probes(pattern, nq, nprobe, nlist, rng)
    writes = written_once(probes, nlist, cap, dtype, 384)
    assert writes.min() == writes.max() == 1


def test_grouped_plan_matches_the_kernels_shared_memory():
    # D = 384: 1 KB of alignment, a ring of three slots of 48 KB of slab rows
    # (6 / 3 boxes of 64 x 128, 128 x 128 bytes), 128 bytes of mbarriers and
    # work entries, the chunk's pair ids, the query rows at a pitch of 784
    # (bf16, three parts), 400 (int8) bytes
    assert ik.RING == 3
    ring = 1024 + 3 * 48 * 1024 + 128
    assert ik.grouped_plan(torch.bfloat16, 384) == (64, 32, 160, ring + 128 + 3 * 32 * 784)
    assert ik.grouped_plan(torch.int8, 384) == (
        128, 32, 288, ring + 128 + 32 * 400 + 3 * 128 * 4)     # and the slots' row scales
    assert sorted(ik.GROUPED, key=str) == sorted(GROUPED_DTYPES, key=str)
    for dtype in GROUPED_DTYPES:
        bm = ik.GROUPED[dtype][0]
        assert bm * 384 * ik._ITEM[dtype] == 48 * 1024
        assert ik.grouped_plan(dtype, 384)[3] <= SCAN_SMEM_MAX
    # ragged D: whole boxes in the ring, the query rows padded to the k step
    assert ik.grouped_plan(torch.bfloat16, 36)[3] == 1024 + 3 * 64 * 128 + 128 + 128 + 96 * 112
    ints = -(-4 * (2 * 312 + 2 + 1024) // 16) * 16     # int32 buffers, to 16 bytes
    assert ik.grouped_workspace_bytes(torch.int8, 32, 32, 312, 384) == ints + 16 * 312
    assert ik.grouped_workspace_bytes(torch.bfloat16, 32, 32, 312, 384) == (
        ints + 16 * 312 + 3 * 32 * 768)


MANAGER, ONE_M = (312, 648), (1000, 2000)       # chip_smoke.py's IVF geometries


def test_route_takes_the_streaming_kernel_for_k4_and_small_batches():
    for dtype in DTYPES:
        for nlist, cap in (MANAGER, ONE_M):
            assert ik.ivf_route(1, 32, nlist, cap, dtype, 384, single=True) == "stream"
            assert ik.ivf_route(1, 32, nlist, cap, dtype, 384) == "stream"
            assert ik.ivf_route(2, 8, nlist, cap, dtype, 384) == "stream"
        # the manager's batch of 32 shares nearly every list; f32 streams
        assert ik.ivf_route(32, 32, *MANAGER, dtype, 384) == (
            "grouped" if dtype in GROUPED_DTYPES else "stream")
    # the route is the model's faster one
    for nq in (4, 12, 16, 32, 64):
        for nprobe in (8, 32):
            for dtype in GROUPED_DTYPES:
                stream, grouped = ik.route_ms(nq, nprobe, *ONE_M, dtype, 384)
                want = "grouped" if grouped < stream else "stream"
                assert ik.ivf_route(nq, nprobe, *ONE_M, dtype, 384) == want
    # a D whose tiles and chunk do not fit a block streams
    assert ik.grouped_plan(torch.bfloat16, 512)[3] > SCAN_SMEM_MAX
    assert ik.ivf_route(32, 32, *MANAGER, torch.bfloat16, 512) == "stream"
    assert ik.ivf_route(32, 32, *MANAGER, torch.int8, 512) == "grouped"
    assert ik.ivf_route(32, 32, *MANAGER, torch.int8, 768) == "stream"
    # rows the Tensor Memory Accelerator cannot copy whole stream
    assert ik.ivf_route(32, 32, *MANAGER, torch.bfloat16, 384, aligned=False) == "stream"


# Both routes timed on an H100 80GB HBM3 (700 W) by chip_smoke.py phase 3
# over random probe lists, D = 384: (slab type, geometry, nprobe, Q, the
# faster route); near-ties (within 3%) left out
MEASURED = [
    ("bf16", MANAGER, 32, 1, "stream"), ("bf16", MANAGER, 32, 4, "stream"),
    ("bf16", MANAGER, 32, 8, "stream"), ("bf16", MANAGER, 32, 12, "stream"),
    ("bf16", MANAGER, 32, 16, "grouped"), ("bf16", MANAGER, 32, 32, "grouped"),
    ("bf16", ONE_M, 32, 8, "stream"), ("bf16", ONE_M, 32, 16, "grouped"),
    ("bf16", ONE_M, 32, 32, "grouped"), ("bf16", ONE_M, 8, 16, "stream"),
    ("bf16", ONE_M, 8, 32, "stream"),
    ("int8", MANAGER, 32, 8, "stream"), ("int8", MANAGER, 32, 12, "grouped"),
    ("int8", MANAGER, 32, 16, "grouped"), ("int8", MANAGER, 32, 32, "grouped"),
    ("int8", ONE_M, 32, 8, "grouped"), ("int8", ONE_M, 32, 16, "grouped"),
    ("int8", ONE_M, 32, 32, "grouped"), ("int8", ONE_M, 8, 32, "grouped"),
    ("int8", ONE_M, 8, 64, "grouped"),
    ("f32", MANAGER, 32, 8, "stream"), ("f32", MANAGER, 32, 32, "stream"),
    ("f32", ONE_M, 32, 32, "stream"), ("f32", ONE_M, 8, 64, "stream")]


@pytest.mark.parametrize("kind,geometry,nprobe,nq,faster", MEASURED)
def test_route_is_the_faster_one_where_measured(kind, geometry, nprobe, nq, faster):
    dtype = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}[kind]
    assert ik.ivf_route(nq, nprobe, *geometry, dtype, 384) == faster


@pytest.mark.parametrize("nq,nprobe,nlist", [(1, 32, 312), (8, 32, 312), (32, 32, 312),
                                             (32, 8, 1000), (64, 8, 1000), (5, 9, 9)])
def test_expected_lists_matches_random_probes(nq, nprobe, nlist):
    """The route model's expected probed-list count against the mean of
    random draws (each query nprobe distinct lists)."""
    rng = np.random.default_rng(nq + nprobe + nlist)
    got = [np.unique(np.concatenate([rng.choice(nlist, nprobe, replace=False)
                                     for _ in range(nq)])).size for _ in range(400)]
    assert abs(np.mean(got) - ik.expected_lists(nq, nprobe, nlist)) < 0.02 * nlist


# -- the fragments -------------------------------------------------------------

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


def word_values(words, kind):
    """[32] words -> [32, 2] bf16 values or [32, 4] int8 values."""
    if kind == "bf16":
        lo = ((words & 0xFFFF).astype(np.uint32) << 16).view(np.float32)
        hi = (words & 0xFFFF0000).astype(np.uint32).view(np.float32)
        return np.stack([lo, hi], 1).astype(np.float64)
    return words.astype(np.uint32).view(np.uint8).reshape(32, 4).view(np.int8).astype(np.float64)


def stage(rows_bytes, pitch, rng):
    """Rows of bytes (kpad each) at ``pitch``; the 16 bytes past kpad are
    garbage (the kernel never writes them)."""
    n, kpad = rows_bytes.shape
    buf = rng.integers(0, 256, n * pitch).astype(np.uint8)
    for r in range(n):
        buf[r * pitch:r * pitch + kpad] = rows_bytes[r]
    return buf


def stage_swizzled(rows_bytes, nbox):
    """The tile as the Tensor Memory Accelerator lays it out with the 128-byte
    swizzle: boxes of [rows][128 bytes], 16-byte chunk c of row r at chunk
    c ^ (r % 8); bytes past the rows' kpad are zeros (past D in the tensor)."""
    n, kpad = rows_bytes.shape
    full = np.zeros((n, nbox * 128), np.uint8)
    full[:, :kpad] = rows_bytes
    buf = np.zeros(nbox * n * 128, np.uint8)
    for r in range(n):
        for c in range(nbox * 8):
            box, cc = c // 8, c % 8
            dst = box * n * 128 + r * 128 + ((cc ^ (r & 7)) << 4)
            buf[dst:dst + 16] = full[r, 16 * c:16 * c + 16]
    return buf


def emulate_chunk_mma(kind, tile_bytes, part_bytes, bm, qc, pitch, kpad, rng):
    """One chunk of score_chunk_mma: warp w's A fragments from the swizzled
    tile, B from each query part, decoded by the mma.sync layouts -> [bm, qc]
    float64."""
    tile = stage_swizzled(tile_bytes, -(-kpad // 128))
    qs = stage(np.concatenate(part_bytes), pitch, rng)
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    kstep = 16 if kind == "bf16" else 32           # values per 32 bytes
    per = kstep // 8                               # values per word: 2 or 4
    acc = np.zeros((bm, qc))
    for w in range(bm // 16):
        ar = w * 16 + (lanes & 15)

        def a_addr(kb):
            return (ar * 128 + (kb >> 7) * (bm * 128)
                    + (((((kb >> 4) & 7) + (lanes >> 4)) ^ (ar & 7)) << 4))

        b_base = ((lanes & 7) + ((lanes >> 4) << 3)) * pitch + ((lanes >> 3) & 1) * 16
        for kb in range(0, kpad, 32):
            a = [word_values(x, kind) for x in ldmatrix(tile, a_addr(kb), 4)]
            amat = np.zeros((16, kstep))
            for x, r0, k0 in ((a[0], 0, 0), (a[1], 8, 0), (a[2], 0, kstep // 2),
                              (a[3], 8, kstep // 2)):
                for v in range(per):
                    amat[r0 + g, k0 + per * t + v] = x[:, v]
            for p in range(len(part_bytes)):
                for np_ in range(qc // 16):
                    r = ldmatrix(qs, b_base + (p * qc + np_ * 16) * pitch + kb, 4)
                    for nt, (b0, b1) in ((2 * np_, (r[0], r[1])), (2 * np_ + 1, (r[2], r[3]))):
                        bmat = np.zeros((kstep, 8))
                        for x, k0 in ((word_values(b0, kind), 0),
                                      (word_values(b1, kind), kstep // 2)):
                            for v in range(per):
                                bmat[k0 + per * t + v, g] = x[:, v]
                        c = amat @ bmat                    # [16, 8]
                        # c0, c1 at (g, 2t, 2t + 1), c2, c3 at row g + 8
                        for h in range(2):
                            for e in range(2):
                                acc[w * 16 + g + 8 * h, nt * 8 + 2 * t + e] += c[g + 8 * h,
                                                                                2 * t + e]
    return acc


def padded_bytes(x, kpad):
    """[n, d] array -> [n, kpad] bytes, zero past its row."""
    b = np.ascontiguousarray(x).view(np.uint8).reshape(x.shape[0], -1)
    out = np.zeros((x.shape[0], kpad), np.uint8)
    out[:, :b.shape[1]] = b
    return out


@pytest.mark.parametrize("kind,d,nc", [("bf16", 384, 32), ("bf16", 36, 5), ("bf16", 384, 11),
                                       ("int8", 384, 32), ("int8", 20, 9)])
def test_emulated_fragments_score_the_tile(kind, d, nc):
    rng = np.random.default_rng(d + nc)
    dtype = torch.bfloat16 if kind == "bf16" else torch.int8
    bm, qc, _, _ = ik.grouped_plan(dtype, d)
    kpad = -(-d * (2 if kind == "bf16" else 1) // 32) * 32
    pitch = kpad + 16
    assert pitch % 32 == 16                 # an odd number of 16-byte units
    q = np.zeros((qc, d), np.float32)
    q[:nc] = rng.standard_normal((nc, d))
    if kind == "bf16":
        rows = torch.from_numpy(rng.standard_normal((bm, d), np.float32)).to(torch.bfloat16)
        tile_bytes = padded_bytes(rows.view(torch.int16).numpy(), kpad)
        parts = split_query_bf16(torch.from_numpy(q))
        part_bytes = [padded_bytes(p.view(torch.int16).numpy(), kpad) for p in parts]
        want = sum(p.double() @ rows.double().T for p in parts).numpy().T
    else:
        rows = rng.integers(-127, 128, (bm, d)).astype(np.int8)
        qc8 = np.zeros((qc, d), np.int8)
        qc8[:nc] = rng.integers(-127, 128, (nc, d))
        tile_bytes = padded_bytes(rows, kpad)
        part_bytes = [padded_bytes(qc8, kpad)]
        want = rows.astype(np.float64) @ qc8.astype(np.float64).T
    for pb in part_bytes:      # the kernel stages nc rows; the rest hold stale bytes
        pb[nc:] = rng.integers(0, 256, pb[nc:].shape)
    with np.errstate(invalid="ignore", over="ignore"):
        got = emulate_chunk_mma(kind, tile_bytes, part_bytes, bm, qc, pitch, kpad, rng)
    np.testing.assert_allclose(got[:, :nc], want[:, :nc], rtol=1e-12, atol=1e-12)
    if kind == "int8":
        assert np.array_equal(got[:, :nc], want[:, :nc])


# -- the grouped scores ---------------------------------------------------------

def slabs(rng, nlist, cap, d, dtype):
    x = rng.standard_normal((nlist, cap, d)).astype(np.float32)
    x[:, cap - cap // 5:] = 0.0
    t = torch.from_numpy(x)
    if dtype == torch.int8:
        codes, scale = sq8_quantize(t.reshape(-1, d))
        return codes.reshape(nlist, cap, d), scale.reshape(nlist, cap)
    return t.to(dtype), None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pattern,nq,nprobe,nlist", [
    ("random", 5, 4, 23), ("skewed", 40, 6, 50), ("all_equal", 9, 3, 12),
    ("every_list", 7, 30, 30), ("clustered", 33, 8, 100)])
def test_grouped_plain_matches_the_plain_scores(dtype, pattern, nq, nprobe, nlist):
    rng = np.random.default_rng(nq * 7 + nlist)
    cap, d = 40, 36
    emb, scale = slabs(rng, nlist, cap, d, dtype)
    probes = torch.from_numpy(make_probes(pattern, nq, nprobe, nlist, rng))
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    q_in = sq8_quantize(q)[0] if dtype == torch.int8 else q
    got = ik.ivf_scores_grouped_plain(probes, q_in, emb, scale)
    want = ik.ivf_scores_plain(probes, q_in, emb, scale)
    assert got.shape == want.shape == (nq, nprobe, cap)
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        err = float((got - want).abs().max())
        assert err <= 1e-6 * float(want.abs().max())


def test_grouped_plain_zeroes_out_of_range_pairs():
    rng = np.random.default_rng(4)
    emb, _ = slabs(rng, 40, 16, 8, torch.float32)
    probes = torch.from_numpy(make_probes("out_of_range", 6, 5, 40, rng))
    q = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
    got = ik.ivf_scores_grouped_plain(probes, q, emb)
    bad = (probes < 0) | (probes >= 40)
    assert int(bad.sum()) == 3
    assert bool((got[bad] == 0).all())
    ok = ~bad
    want = torch.einsum("qd,qpcd->qpc", q, emb[probes.clamp(0, 39).long()])
    err = float((got[ok] - want[ok]).abs().max())
    assert err <= 1e-6 * float(want[ok].abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_grouped_search_matches_pallas_batch(monkeypatch, dtype):
    """The K5 search with the grouped plain scores against the JAX package's
    ivf_topk_pallas_batch, run in interpret mode on the CPU."""
    rng = np.random.default_rng(0)
    n, d, nlist = 1024, 32, 16
    centers = rng.standard_normal((24, d)).astype(np.float32) * 3
    x = centers[rng.integers(0, 24, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.4
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = (x[[3, 99, 700, 1000, 5, 6]] + rng.standard_normal((6, d)).astype(np.float32) * 0.05)
    valid = rng.random(n) > 0.25
    jp = jivf.build_ivf(x, nlist, kmeans_iters=4, seed=0, dtype=dtype, capacity_factor=0.9)
    tp = ivf_partitions_from_numpy(jp, device="cpu")
    calls = []

    def grouped(probes, q_in, emb, scale=None, *, single=False):
        calls.append(probes.shape)
        return ik.ivf_scores_grouped_plain(probes, q_in, emb, scale)

    monkeypatch.setattr(ik, "ivf_scores", grouped)
    js, ji = ivf_topk_pallas_batch(jp, jnp.asarray(q), 16, jnp.asarray(valid), nprobe=6)
    ts, ti = ik.ivf_topk_kernel_batch(tp, torch.from_numpy(q), 16,
                                      torch.from_numpy(valid), nprobe=6)
    assert calls == [(6, 6)]
    assert_scores_close(ts, js, rtol=1e-6, atol=1e-6)
    assert_ids_tie_aware(ti, ji, js, 1e-6)


def test_cpu_tensors_take_the_plain_version_and_the_card_path_refuses_them():
    rng = np.random.default_rng(2)
    emb, _ = slabs(rng, 10, 8, 16, torch.float32)
    probes = torch.from_numpy(make_probes("random", 3, 4, 10, rng))
    q = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    before = (ik.ivf_scores.launches, ik.ivf_scores.grouped_launches)
    assert torch.equal(ik.ivf_scores(probes, q, emb), ik.ivf_scores_plain(probes, q, emb))
    assert (ik.ivf_scores.launches, ik.ivf_scores.grouped_launches) == before
    for route in ("stream", "grouped", None):
        with pytest.raises(ValueError, match="runs on the card"):
            ik.ivf_scores_by(probes, q, emb, None, route)

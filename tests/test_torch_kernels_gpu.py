"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: a fixture skips every test here when no CUDA card is
present.  On a machine with the card (which has no JAX, so the repo's
conftest cannot load), run:

    python -m pytest -o addopts= --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

Tolerances: K1, K3, K5 on bf16/f32 slabs and K6 sum in another order
than the plain version's matmul / reductions, so f32 scores agree to 1e-5
relative to the largest live score of the call (a dot of 384 terms
cancels, so a per-element relative bound would not hold near 0); masked
entries are equal.  K3 reads bf16 term frequencies, as the sparse index
stores them.  K6's one-hot kernel sums on the tensor cores, whose f32
accumulation may round otherwise than IEEE addition; it adds each group
of 8 subspaces into an IEEE f32 sum, and stays within the same 1e-5.
K2's and K5-SQ8's integer dots are exact and their scale and mask round
separately, so their scores are bit-identical to the plain version's.
K5's grouped route sums bf16 slabs on the tensor cores over three bf16
parts of the query (as K1), within the same 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from advanced_rag_tpu_torch.ops import dense_kernels as dk
from advanced_rag_tpu_torch.ops import ivf_kernels as ik
from advanced_rag_tpu_torch.ops import pq_kernels as pk
from advanced_rag_tpu_torch.ops import sparse_kernels as sk
from advanced_rag_tpu_torch.ops.ivf import IVFPartitions, ivf_topk_plain
from advanced_rag_tpu_torch.ops.pq import pq_scores_xla
from advanced_rag_tpu_torch.ops.dense import NEG_INF, mask_additive
from advanced_rag_tpu_torch.ops.quant import sq8_quantize

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the H100 (see module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_rel_close(got, want, tol=1e-5):
    live = want > NEG_INF / 2
    assert torch.equal(got[~live], want[~live])
    if bool(live.any()):
        scale = max(float(want[live].abs().max()), 1e-30)
        err = float((got[live] - want[live]).abs().max())
        assert err <= tol * scale, (err, scale)


def _mask(n, rng, dev, dead=0.3):
    valid = torch.from_numpy(rng.random(n) > dead).to(dev)
    return mask_additive(valid, n, dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq,n,d", [(1, 1000, 384), (3, 4097, 384),
                                    (32, 2000, 384), (40, 777, 384),
                                    (5, 513, 36), (2, 9, 7)])
def test_k1_matches_plain(cuda, dtype, nq, n, d):
    rng = np.random.default_rng(nq * 1000 + n + d)
    rows = torch.from_numpy(rng.standard_normal((n, d), np.float32)).to(cuda).to(dtype)
    q = torch.from_numpy(rng.standard_normal((nq, d), np.float32)).to(cuda)
    m = _mask(n, rng, cuda)
    before = dk.dense_scores.launches
    got = dk.dense_scores(q, rows, m)
    torch.cuda.synchronize()
    assert dk.dense_scores.launches > before
    want = dk.dense_scores_plain(q, rows, m)
    assert_rel_close(got, want)


@pytest.mark.parametrize("nq,n,d", [(1, 1000, 384), (8, 4097, 384),
                                    (32, 2000, 384), (33, 100, 384),
                                    (4, 300, 20)])
def test_k2_is_bit_identical_to_plain(cuda, nq, n, d):
    rng = np.random.default_rng(nq + n + d)
    x = torch.from_numpy(rng.standard_normal((n, d), np.float32)).to(cuda)
    codes, scale = sq8_quantize(x)
    q_codes, _ = sq8_quantize(torch.from_numpy(
        rng.standard_normal((nq, d), np.float32)).to(cuda))
    m = _mask(n, rng, cuda)
    before = dk.sq8_scores.launches
    got = dk.sq8_scores(q_codes, codes, scale, m)
    torch.cuda.synchronize()
    assert dk.sq8_scores.launches > before
    want = dk.sq8_scores_plain(q_codes, codes, scale, m)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq", [1, 8, 9, 32, 40])
@pytest.mark.parametrize("n,d", [(5000, 4096), (1000, 8192), (777, 4100)])
def test_k1_scans_wide_rows_in_slices(cuda, dtype, nq, n, d):
    """Rows too wide for the queries' shared memory (a 7B decoder's 4096,
    8192; 4100 stages by element copies) are scanned slice by slice."""
    rng = np.random.default_rng(nq * 7 + n + d)
    rows = torch.from_numpy(rng.standard_normal((n, d), np.float32)).to(cuda).to(dtype)
    q = torch.from_numpy(rng.standard_normal((nq, d), np.float32)).to(cuda)
    m = _mask(n, rng, cuda)
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    before = dk.dense_scores.launches
    got = dk.dense_scores(q, rows, m)
    torch.cuda.synchronize()
    assert dk.dense_scores.launches - before == len(dk.scan_launches(kind, nq, d))
    assert_rel_close(got, dk.dense_scores_plain(q, rows, m))


@pytest.mark.parametrize("nq", [1, 32, 33])
@pytest.mark.parametrize("d", [4096, 8192])
def test_k2_at_wide_rows_is_bit_identical_to_plain(cuda, nq, d):
    rng = np.random.default_rng(nq + d)
    codes, scale = sq8_quantize(torch.from_numpy(
        rng.standard_normal((3000, d), np.float32)).to(cuda))
    q_codes, _ = sq8_quantize(torch.from_numpy(
        rng.standard_normal((nq, d), np.float32)).to(cuda))
    m = _mask(3000, rng, cuda)
    got = dk.sq8_scores(q_codes, codes, scale, m)
    assert torch.equal(got, dk.sq8_scores_plain(q_codes, codes, scale, m))


EDGE_N = (9, 777, 4097, 131073)            # ragged to the 128-row tile
EDGE_Q = (1, 8, 9, 17, 32, 33, 40)          # across the 8/16/32 query tiles


def _rows(rng, n, d, dtype, dev, offset=0):
    """[n, d] rows of ``dtype`` on ``dev``; ``offset`` elements into their
    buffer, so offset 1 gives a contiguous view whose base is not 16-byte
    aligned."""
    x = rng.standard_normal((n * d + offset,), np.float32)
    if dtype == torch.int8:
        buf = torch.from_numpy(np.clip(np.rint(x * 40), -127, 127).astype(np.int8))
    else:
        buf = torch.from_numpy(x).to(dtype)
    return buf.to(dev)[offset:].view(n, d)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq", EDGE_Q)
@pytest.mark.parametrize("d", [7, 20, 36, 384])
@pytest.mark.parametrize("n", EDGE_N)
def test_k1_edges_match_plain(cuda, dtype, n, d, nq):
    rng = np.random.default_rng(n * 31 + d * 7 + nq)
    rows = _rows(rng, n, d, dtype, cuda)
    q = torch.from_numpy(rng.standard_normal((nq, d), np.float32)).to(cuda)
    m = _mask(n, rng, cuda)
    got = dk.dense_scores(q, rows, m)
    torch.cuda.synchronize()
    assert_rel_close(got, dk.dense_scores_plain(q, rows, m))


@pytest.mark.parametrize("nq", EDGE_Q)
@pytest.mark.parametrize("d", [20, 36, 384])
@pytest.mark.parametrize("n", EDGE_N)
def test_k2_edges_are_bit_identical_to_plain(cuda, n, d, nq):
    rng = np.random.default_rng(n * 31 + d * 7 + nq)
    codes = _rows(rng, n, d, torch.int8, cuda)
    q_codes = _rows(rng, nq, d, torch.int8, cuda)
    scale = torch.from_numpy(rng.random(n, np.float32) * 0.01).to(cuda)
    m = _mask(n, rng, cuda)
    got = dk.sq8_scores(q_codes, codes, scale, m)
    torch.cuda.synchronize()
    assert torch.equal(got, dk.sq8_scores_plain(q_codes, codes, scale, m))


@pytest.mark.parametrize("nq,n,d", [(1, 4097, 384), (32, 131073, 384), (17, 777, 384),
                                    (9, 777, 20)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_dense_scans_on_unaligned_rows(cuda, dtype, nq, n, d):
    """A row view whose base is not 16-byte aligned takes the element-copy
    staging inside the kernel; same results as the plain versions."""
    rng = np.random.default_rng(n + d + nq)
    rows = _rows(rng, n, d, dtype, cuda, offset=1)
    assert rows.is_contiguous() and rows.data_ptr() % 16 != 0
    assert dk.aligned_rows(rows) == 0
    m = _mask(n, rng, cuda)
    if dtype == torch.int8:
        q_codes = _rows(rng, nq, d, torch.int8, cuda)
        scale = torch.from_numpy(rng.random(n, np.float32)).to(cuda)
        got = dk.sq8_scores(q_codes, rows, scale, m)
        assert torch.equal(got, dk.sq8_scores_plain(q_codes, rows, scale, m))
    else:
        q = torch.from_numpy(rng.standard_normal((nq, d), np.float32)).to(cuda)
        got = dk.dense_scores(q, rows, m)
        assert_rel_close(got, dk.dense_scores_plain(q, rows, m))


def test_k2_rejects_d_not_divisible_by_4(cuda):
    codes = torch.zeros((8, 6), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        dk.sq8_scores(codes[:1], codes, torch.ones(8, device=cuda),
                      torch.zeros(8, device=cuda))


def test_k1_rejects_wrong_dtype(cuda):
    rows = torch.zeros((8, 16), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        dk.dense_scores(torch.zeros((1, 16), device=cuda), rows,
                        torch.zeros(8, device=cuda))


def _sparse_inputs(rng, nq, t, p, n, vocab, dev):
    idx = rng.integers(0, vocab, size=(p, n)).astype(np.int32)
    idx[rng.random((p, n)) < 0.5] = -1          # padding slots anywhere
    tf = rng.integers(1, 5, size=(p, n)).astype(np.float32)
    tf[rng.random((p, n)) < 0.01] = 257.0       # stored as 256 in bf16
    q_idx = rng.integers(0, vocab, size=(nq, t)).astype(np.int32)
    q_idx[:, t // 2:] = -1
    q_w = np.where(q_idx >= 0, rng.random((nq, t)), 0.0).astype(np.float32)
    dlen = rng.integers(1, 200, size=n).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return to(q_idx), to(q_w), to(idx), to(tf).to(torch.bfloat16), to(dlen)


@pytest.mark.parametrize("scoring", ["bm25", "ip"])
@pytest.mark.parametrize("nq,t,p,n", [(1, 32, 256, 3000), (32, 32, 64, 1000),
                                      (40, 8, 16, 257), (3, 1, 1, 5)])
def test_k3_matches_plain(cuda, scoring, nq, t, p, n):
    rng = np.random.default_rng(nq + t + p + n)
    q_idx, q_w, idx, tf, dlen = _sparse_inputs(rng, nq, t, p, n, 64, cuda)
    m = _mask(n, rng, cuda)
    before = sk.bm25_scores.launches
    got = sk.bm25_scores(q_idx, q_w, idx, tf, dlen, m, 1.2, 0.75, 73.5, scoring)
    torch.cuda.synchronize()
    assert sk.bm25_scores.launches > before
    want = sk.bm25_scores_plain(q_idx, q_w, idx, tf, dlen, m, 1.2, 0.75,
                                73.5, scoring)
    assert_rel_close(got, want)


def test_topk_wrappers_match_plain_ids(cuda):
    rng = np.random.default_rng(7)
    n, d = 5000, 384
    x = torch.from_numpy(rng.standard_normal((n, d), np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((4, d), np.float32)).to(cuda)
    valid = torch.from_numpy(rng.random(n) > 0.5).to(cuda)
    s, i = dk.dense_topk_kernel(x.to(torch.bfloat16), q, 10, valid)
    ps, pi = dk.dense_topk_kernel(x.to(torch.bfloat16).cpu(), q.cpu(), 10,
                                  valid.cpu())
    assert_rel_close(s.cpu(), ps)
    assert torch.equal(i.cpu(), pi)
    assert bool((s > NEG_INF).all())


def _slabs(rng, nlist, cap, d, dtype, dev):
    x = rng.standard_normal((nlist, cap, d), np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    rows = np.arange(nlist * cap, dtype=np.int32).reshape(nlist, cap)
    rows[:, cap - cap // 5:] = -1                   # padded slots
    x[rows < 0] = 0.0
    t = torch.from_numpy(x).to(dev)
    if dtype == torch.int8:
        codes, scale = sq8_quantize(t.reshape(-1, d))
        live = torch.from_numpy(rows >= 0).to(dev)
        return (codes.reshape(nlist, cap, d).contiguous(),
                (scale.reshape(nlist, cap) * live).contiguous(), rows)
    return t.to(dtype).contiguous(), None, rows


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("nq,nlist,cap,d,nprobe", [
    (1, 64, 136, 384, 16), (8, 312, 648, 384, 32), (32, 100, 200, 384, 32),
    (3, 9, 40, 36, 5), (2, 5, 8, 20, 5),
    # Q > the grouped scan's query chunk; Q either side of the manager
    # geometry's crossover; nprobe = nlist; more lists than the plan counts
    # in shared memory
    (40, 100, 200, 384, 32), (12, 312, 648, 384, 32),
    (16, 312, 648, 384, 32), (8, 24, 100, 384, 24),
    (33, 9000, 8, 64, 4)])
def test_k5_matches_plain(cuda, dtype, nq, nlist, cap, d, nprobe):
    rng = np.random.default_rng(nq * 7 + nlist + cap + d)
    packed, scale, _ = _slabs(rng, nlist, cap, d, dtype, cuda)
    probes = torch.from_numpy(np.stack([
        rng.choice(nlist, nprobe, replace=False) for _ in range(nq)])
        .astype(np.int32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((nq, d), np.float32)).to(cuda)
    q_in = sq8_quantize(q)[0] if dtype == torch.int8 else q
    before = ik.ivf_scores.launches
    got = ik.ivf_scores(probes, q_in.contiguous(), packed, scale)
    torch.cuda.synchronize()
    assert ik.ivf_scores.launches == before + 1
    want = ik.ivf_scores_plain(probes, q_in, packed, scale)
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        assert_rel_close(got, want)


def _k5_inputs(rng, dtype, nq, nlist, cap, d, dev):
    packed, scale, _ = _slabs(rng, nlist, cap, d, dtype, dev)
    q = torch.from_numpy(rng.standard_normal((nq, d), np.float32)).to(dev)
    q_in = sq8_quantize(q)[0].contiguous() if dtype == torch.int8 else q
    return packed, scale, q_in


def _assert_k5(got, want, dtype):
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        assert_rel_close(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("pattern", ["same_lists", "one_list"])
@pytest.mark.parametrize("nq", [2, 9, 32, 40])
def test_k5_skewed_probes_match_plain(cuda, dtype, pattern, nq):
    """Every query probes the same lists (groups of Q), or every pair the
    same list (one group of Q * nprobe, repeated inside each query)."""
    rng = np.random.default_rng(nq + len(pattern))
    nlist, cap, d, nprobe = 50, 300, 384, 12
    packed, scale, q_in = _k5_inputs(rng, dtype, nq, nlist, cap, d, cuda)
    if pattern == "same_lists":
        row = rng.choice(nlist, nprobe, replace=False)
        probes = np.tile(row, (nq, 1))
    else:
        probes = np.full((nq, nprobe), 17)
    probes = torch.from_numpy(probes.astype(np.int32)).to(cuda)
    for route in ("stream", "grouped") if dtype in ik.GROUPED else ("stream",):
        got = ik.ivf_scores_by(probes, q_in, packed, scale, route)
        _assert_k5(got, ik.ivf_scores_plain(probes, q_in, packed, scale), dtype)
    if dtype not in ik.GROUPED:     # f32 slabs stream; a forced grouped launch raises
        with pytest.raises(ValueError, match="bf16 or int8"):
            ik.ivf_scores_by(probes, q_in, packed, scale, "grouped")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_k5_launches_are_bit_identical(cuda, dtype):
    """The grouped plan orders a group's pairs by atomics; no score depends
    on that order."""
    rng = np.random.default_rng(3)
    nq, nlist, cap, d, nprobe = 32, 40, 333, 384, 16
    packed, scale, q_in = _k5_inputs(rng, dtype, nq, nlist, cap, d, cuda)
    probes = torch.from_numpy(np.stack([rng.choice(nlist, nprobe, replace=False)
                                        for _ in range(nq)]).astype(np.int32)).to(cuda)
    first = ik.ivf_scores(probes, q_in, packed, scale)
    for _ in range(3):
        assert torch.equal(ik.ivf_scores(probes, q_in, packed, scale), first)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_k5_grouped_launches_from_two_threads(cuda, dtype):
    """Two host threads launch the grouped scan at once on two slab
    tensors (a ctypes call releases the GIL): each launch scores its own
    slabs, so no launch may take the other's tensor map."""
    import threading

    rng = np.random.default_rng(17)
    jobs = []
    for nlist, cap in ((40, 333), (64, 200)):
        nq, d, nprobe = 32, 384, 16
        packed, scale, q_in = _k5_inputs(rng, dtype, nq, nlist, cap, d, cuda)
        probes = torch.from_numpy(np.stack([rng.choice(nlist, nprobe, replace=False)
                                            for _ in range(nq)]).astype(np.int32)).to(cuda)
        jobs.append((probes, q_in, packed, scale, []))
    start = threading.Barrier(len(jobs))

    def run(probes, q_in, packed, scale, outs):
        start.wait()
        for _ in range(40):
            outs.append(ik.ivf_scores_by(probes, q_in, packed, scale, "grouped"))
        torch.cuda.synchronize()

    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for probes, q_in, packed, scale, outs in jobs:
        assert len(outs) == 40
        want = ik.ivf_scores_plain(probes, q_in, packed, scale)
        for got in outs:
            _assert_k5(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_k5_graph_replay_rebuilds_the_plan(cuda, dtype):
    """A CUDA graph of the grouped route, replayed after probes are
    rewritten in place: each replay scores the new probes."""
    rng = np.random.default_rng(8)
    nq, nlist, cap, d, nprobe = 32, 312, 648, 384, 32
    packed, scale, q_in = _k5_inputs(rng, dtype, nq, nlist, cap, d, cuda)

    def draw(skew):
        p = np.stack([rng.choice(nlist, nprobe, replace=False) for _ in range(nq)])
        p[:skew] = p[0]
        return torch.from_numpy(p.astype(np.int32)).to(cuda)

    probes = draw(0)
    assert ik.ivf_route(nq, nprobe, nlist, cap, dtype, d) == "grouped"
    ik.ivf_scores(probes, q_in, packed, scale)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        out = ik.ivf_scores(probes, q_in, packed, scale)
    for skew in (0, 31, 5, 32):
        probes.copy_(draw(skew))
        g.replay()
        torch.cuda.synchronize()
        _assert_k5(out, ik.ivf_scores_plain(probes, q_in, packed, scale), dtype)


def test_k5_counters_follow_the_route(cuda):
    rng = np.random.default_rng(12)
    nlist, cap, d, nprobe = 312, 648, 384, 32
    packed, _, _ = _k5_inputs(rng, torch.bfloat16, 1, nlist, cap, d, cuda)
    routes = [ik.ivf_route(nq, nprobe, nlist, cap, torch.bfloat16, d) for nq in (1, 32)]
    assert routes == ["stream", "grouped"]
    for nq in (1, 12, 16, 32):
        q = torch.from_numpy(rng.standard_normal((nq, d), np.float32)).to(cuda)
        probes = torch.from_numpy(np.stack([rng.choice(nlist, nprobe, replace=False)
                                            for _ in range(nq)]).astype(np.int32)).to(cuda)
        before = (ik.ivf_scores.launches, ik.ivf_scores.grouped_launches,
                  ik.ivf_scores.k4_launches)
        got = ik.ivf_scores(probes, q, packed)
        grouped = int(ik.ivf_route(nq, nprobe, nlist, cap, torch.bfloat16, d) == "grouped")
        assert (ik.ivf_scores.launches, ik.ivf_scores.grouped_launches,
                ik.ivf_scores.k4_launches) == (before[0] + 1, before[1] + grouped, before[2])
        assert_rel_close(got, ik.ivf_scores_plain(probes, q, packed))
        if nq == 1:
            before = (ik.ivf_scores.grouped_launches, ik.ivf_scores.k4_launches)
            ik.ivf_scores(probes, q, packed, single=True)
            assert (ik.ivf_scores.grouped_launches, ik.ivf_scores.k4_launches) == (
                before[0], before[1] + 1)


@pytest.mark.parametrize("route", ["stream", "grouped"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_k5_out_of_range_probes_score_zero(cuda, route, dtype):
    rng = np.random.default_rng(21)
    nq, nlist, cap, d, nprobe = 6, 40, 100, 384, 5
    packed, scale, q_in = _k5_inputs(rng, dtype, nq, nlist, cap, d, cuda)
    p = np.stack([rng.choice(nlist, nprobe, replace=False) for _ in range(nq)])
    p[0, 0], p[-1, -1], p[2, 1] = -1, nlist, nlist + 7
    probes = torch.from_numpy(p.astype(np.int32)).to(cuda)
    # NaN in the block the caching allocator hands the output next
    junk = torch.full((nq, nprobe, cap), float("nan"), device=cuda)
    del junk
    out = ik.ivf_scores_by(probes, q_in, packed, scale, route)
    bad = (probes < 0) | (probes >= nlist)
    assert bool((out[bad] == 0).all())
    want = ik.ivf_scores_plain(probes.clamp(0, nlist - 1), q_in, packed, scale)
    _assert_k5(out[~bad], want[~bad], dtype)


def test_k5_grouped_route_refuses_rows_it_cannot_copy_whole(cuda):
    """The grouped route copies whole 16-byte aligned rows; other slabs
    stream (and a forced grouped launch raises)."""
    rng = np.random.default_rng(30)
    nq, nlist, cap, d, nprobe = 16, 20, 50, 36, 5     # bf16 rows of 72 bytes
    packed, _, q = _k5_inputs(rng, torch.bfloat16, nq, nlist, cap, d, cuda)
    probes = torch.from_numpy(np.stack([rng.choice(nlist, nprobe, replace=False)
                                        for _ in range(nq)]).astype(np.int32)).to(cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ik.ivf_scores_by(probes, q, packed, None, "grouped")
    before = ik.ivf_scores.grouped_launches
    assert_rel_close(ik.ivf_scores(probes, q, packed), ik.ivf_scores_plain(probes, q, packed))
    assert ik.ivf_scores.grouped_launches == before


def test_k4_and_k5_search_match_the_plain_path(cuda):
    """The K4 and K5 searches on the card against the same searches on CPU
    tensors (the plain scores); f32 slabs, an overflow tail and a mask."""
    rng = np.random.default_rng(5)
    nlist, cap, d = 40, 64, 384
    packed, _, rows = _slabs(rng, nlist, cap, d, torch.float32, cuda)
    n = nlist * cap
    cent = torch.from_numpy(rng.standard_normal((nlist, d), np.float32)).to(cuda)
    tail = torch.from_numpy(rng.standard_normal((7, d), np.float32)).to(cuda)
    tail_rows = torch.arange(n, n + 7, dtype=torch.int32, device=cuda)
    parts = IVFPartitions(cent, packed, torch.from_numpy(rows).to(cuda),
                          tail, tail_rows)
    cpu = IVFPartitions(*[t.cpu() for t in parts[:5]])
    valid = torch.from_numpy(rng.random(n + 7) > 0.3).to(cuda)
    q = torch.from_numpy(rng.standard_normal((4, d), np.float32)).to(cuda)
    s, i = ik.ivf_topk_kernel_batch(parts, q, 20, valid, nprobe=8)
    ps, pi = ik.ivf_topk_kernel_batch(cpu, q.cpu(), 20, valid.cpu(), nprobe=8)
    assert_rel_close(s.cpu(), ps)
    assert torch.equal(i.cpu(), pi)
    before = ik.ivf_scores.k4_launches
    s1, i1 = ik.ivf_topk_kernel(parts, q[0], 20, valid, nprobe=8)
    assert ik.ivf_scores.k4_launches == before + 1
    assert torch.equal(i1.cpu(), pi[0])
    rs, ri = ivf_topk_plain(cpu, q.cpu(), 20, valid.cpu(), nprobe=8)
    assert torch.equal(ri, pi)


@pytest.mark.parametrize("nq,n,m,c", [(1, 5000, 96, 16), (8, 4096, 96, 16),
                                      (32, 131072, 96, 16), (40, 777, 96, 16),
                                      (5, 1025, 8, 16), (3, 300, 12, 4),
                                      (2, 17, 96, 2)])
def test_k6_matches_plain(cuda, nq, n, m, c):
    rng = np.random.default_rng(nq + n + m + c)
    codes = torch.from_numpy(rng.integers(0, c, size=(n, m)).astype(np.int8)).to(cuda)
    lut = torch.from_numpy(rng.standard_normal((nq, m, c), np.float32) * 0.1).to(cuda)
    before = pk.pq_scores.launches
    got = pk.pq_scores(codes, lut)
    torch.cuda.synchronize()
    assert pk.pq_scores.launches > before
    assert_rel_close(got, pq_scores_xla(codes, lut))


def test_k6_rejects_eight_bit_codes(cuda):
    codes = torch.zeros((8, 4), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        pk.pq_scores(codes, torch.zeros((1, 4, 256), device=cuda))


def _k3_case(rng, nq, t, p, n, ids, dev, dead_rows=0.05):
    """Slots drawn from ``ids`` (so most slots hit the batch's terms), live
    slots at the front of each row, some rows all padding; queries with
    repeated terms, padding terms and one all-padding query."""
    live = rng.integers(0, p + 1, size=n)
    live[rng.random(n) < dead_rows] = 0
    idx = rng.choice(ids, size=(p, n)).astype(np.int32)
    idx[np.arange(p)[:, None] >= live[None, :]] = -1
    tf = rng.integers(1, 6, size=(p, n)).astype(np.float32)
    q_idx = rng.choice(ids, size=(nq, t)).astype(np.int32)
    q_idx[:, t - t // 4:] = -1
    q_idx[:, 1] = q_idx[:, 0]
    q_idx[nq // 2] = -1
    q_w = np.where(q_idx >= 0, rng.standard_normal((nq, t)), 0.0).astype(np.float32)
    dlen = rng.integers(1, 200, size=n).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return to(q_idx), to(q_w), to(idx), to(tf).to(torch.bfloat16), to(dlen)


@pytest.mark.parametrize("scoring", ["bm25", "ip"])
@pytest.mark.parametrize("t", [8, 32, 64])
@pytest.mark.parametrize("nq", [1, 3, 17, 32, 33])
def test_k3_table_matches_plain(cuda, scoring, nq, t):
    """Q across the chunk's 1 / 4 / 32 query tables and past one launch
    (33), T across the chunk plan (T = 64 takes 16 queries a launch); N not
    a multiple of the 512-row block."""
    rng = np.random.default_rng(nq * 100 + t)
    n, p = 3001, 64
    q_idx, q_w, idx, tf, dlen = _k3_case(rng, nq, t, p, n, np.arange(300), cuda)
    m = _mask(n, rng, cuda)
    before = sk.bm25_scores.launches
    got = sk.bm25_scores(q_idx, q_w, idx, tf, dlen, m, 1.2, 0.75, 73.5, scoring)
    torch.cuda.synchronize()
    chunk = sk.bm25_chunk(t)
    assert sk.bm25_scores.launches == before + -(-nq // chunk)
    want = sk.bm25_scores_plain(q_idx, q_w, idx, tf, dlen, m, 1.2, 0.75, 73.5, scoring)
    assert_rel_close(got, want)


@pytest.mark.parametrize("t", [32, 33])
def test_k3_table_full_of_distinct_terms(cuda, t):
    """32 queries whose 32 * T terms are all distinct ids spread over a
    large id range: the table and its hash hold as many ids as they can."""
    rng = np.random.default_rng(t)
    nq, n, p = 32, 2048, 96
    terms = rng.choice(10 ** 7, size=nq * t, replace=False).astype(np.int32)
    ids = np.concatenate([terms, rng.integers(0, 10 ** 7, 500)])
    q_idx, q_w, idx, tf, dlen = _k3_case(rng, nq, t, p, n, ids, cuda)
    q_idx = torch.from_numpy(terms.reshape(nq, t)).to(cuda)
    q_w = torch.from_numpy(rng.random((nq, t)).astype(np.float32)).to(cuda)
    assert sk.bm25_chunk(t) == 32
    m = _mask(n, rng, cuda)
    for scoring in ("bm25", "ip"):
        got = sk.bm25_scores(q_idx, q_w, idx, tf, dlen, m, 1.2, 0.75, 50.0, scoring)
        want = sk.bm25_scores_plain(q_idx, q_w, idx, tf, dlen, m, 1.2, 0.75, 50.0,
                                    scoring)
        assert_rel_close(got, want)


def test_k3_all_padding_rows_and_queries(cuda):
    """Rows of padding slots only score their mask, and so does every row
    for a batch with no live term."""
    rng = np.random.default_rng(11)
    n, p, t = 777, 32, 8
    q_idx, q_w, idx, tf, dlen = _k3_case(rng, 5, t, p, n, np.arange(50), cuda,
                                         dead_rows=0.5)
    m = _mask(n, rng, cuda)
    got = sk.bm25_scores(q_idx, q_w, idx, tf, dlen, m, 1.2, 0.75, 40.0)
    dead = (idx < 0).all(dim=0)
    assert bool(dead.any())
    assert torch.equal(got[:, dead], m[dead][None, :].expand(5, -1))
    assert_rel_close(got, sk.bm25_scores_plain(q_idx, q_w, idx, tf, dlen, m, 1.2,
                                               0.75, 40.0))
    none = torch.full_like(q_idx, -1)
    got = sk.bm25_scores(none, torch.zeros_like(q_w), idx, tf, dlen, m, 1.2, 0.75, 40.0)
    assert torch.equal(got, m[None, :].expand(5, -1))


@pytest.mark.parametrize("n", [1, 1023, 262144])
@pytest.mark.parametrize("nq", [1, 5, 8, 17, 32, 33])
@pytest.mark.parametrize("m", [8, 96, 100])
@pytest.mark.parametrize("c", [2, 4, 8, 16])
def test_k6_kernels_match_plain(cuda, c, m, nq, n):
    rng = np.random.default_rng(c * 1000 + m * 10 + nq + n)
    codes = torch.from_numpy(rng.integers(0, c, size=(n, m)).astype(np.int8)).to(cuda)
    lut = torch.from_numpy(rng.standard_normal((nq, m, c), np.float32) * 0.1).to(cuda)
    before = pk.pq_scores.onehot_launches
    got = pk.pq_scores(codes, lut)
    torch.cuda.synchronize()
    chunks = [min(32, nq - q0) for q0 in range(0, nq, 32)]
    assert pk.pq_scores.onehot_launches - before == sum(
        pk.pq_kernel_for(nc) == "onehot" for nc in chunks)
    assert_rel_close(got, pq_scores_xla(codes, lut))


@pytest.mark.parametrize("kernel", [None, "lookup", "onehot"])
@pytest.mark.parametrize("nq", [1, 8, 32])
def test_k6_at_the_default_width(cuda, kernel, nq):
    """m = 384 (auto_pq_m of the 1536-wide default embedder), N = 262144:
    the one-hot kernel runs over groups of subspaces that fit its shared
    memory, each launch after the first adding into the output; every
    launch of pq_plan runs and the sum matches the plain ADC."""
    rng = np.random.default_rng(nq + 384)
    n, m = 262144, 384
    codes = torch.from_numpy(rng.integers(0, 16, size=(n, m)).astype(np.int8)).to(cuda)
    lut = torch.from_numpy(rng.standard_normal((nq, m, 16), np.float32) * 0.05).to(cuda)
    before = pk.pq_scores.launches
    got = pk.pq_scores(codes, lut) if kernel is None else pk.pq_scores_by(codes, lut, kernel)
    torch.cuda.synchronize()
    assert pk.pq_scores.launches - before == len(pk.pq_plan(nq, m, 16, kernel))
    assert_rel_close(got, pq_scores_xla(codes, lut))


@pytest.mark.parametrize("kernel", ["lookup", "onehot"])
@pytest.mark.parametrize("nq", [1, 9, 32])
def test_k6_on_unaligned_codes(cuda, kernel, nq):
    """A codes view whose base is not 16-byte aligned: both kernels stage
    its bytes one by one."""
    rng = np.random.default_rng(nq)
    n, m = 5000, 96
    buf = torch.from_numpy(rng.integers(0, 16, size=n * m + 1).astype(np.int8)).to(cuda)
    codes = buf[1:].view(n, m)
    assert codes.is_contiguous() and codes.data_ptr() % 16 != 0
    lut = torch.from_numpy(rng.standard_normal((nq, m, 16), np.float32)).to(cuda)
    got = pk.pq_scores_by(codes, lut, kernel)
    assert_rel_close(got, pq_scores_xla(codes, lut))


@pytest.mark.parametrize("nq", [pk.LOOKUP_MAX_Q, pk.LOOKUP_MAX_Q + 1])
def test_k6_both_kernels_at_the_crossover(cuda, nq):
    """Either side of the crossover, each kernel matches the plain ADC, and
    pq_scores takes the one pq_kernel_for names."""
    rng = np.random.default_rng(nq + 40)
    codes = torch.from_numpy(rng.integers(0, 16, size=(131072, 96)).astype(np.int8)).to(cuda)
    lut = torch.from_numpy(rng.standard_normal((nq, 96, 16), np.float32)).to(cuda)
    want = pq_scores_xla(codes, lut)
    for kernel in ("lookup", "onehot"):
        assert_rel_close(pk.pq_scores_by(codes, lut, kernel), want)
    before = pk.pq_scores.onehot_launches
    assert_rel_close(pk.pq_scores(codes, lut), want)
    assert pk.pq_scores.onehot_launches - before == int(pk.pq_kernel_for(nq) == "onehot")


def test_k1_and_k3_launch_from_two_threads(cuda):
    """The service launches K1 and K3 from its executor threads at once
    (a ctypes call releases the GIL): two host threads, each launching
    both kernels 40 times on its own tensors, get the plain versions'
    scores every time."""
    import threading

    rng = np.random.default_rng(23)
    jobs = []
    for nq, n in ((1, 131072), (32, 4097)):
        rows = torch.from_numpy(rng.standard_normal((n, 384), np.float32)).to(cuda)
        q = torch.from_numpy(rng.standard_normal((nq, 384), np.float32)).to(cuda)
        m = _mask(n, rng, cuda)
        sparse = _sparse_inputs(rng, nq, 32, 64, n, 512, cuda)
        jobs.append((q, rows.to(torch.bfloat16), m, sparse, []))
    start = threading.Barrier(len(jobs))

    def run(q, rows, m, sparse, outs):
        start.wait()
        for _ in range(40):
            outs.append((dk.dense_scores(q, rows, m),
                         sk.bm25_scores(*sparse, m, 1.2, 0.75, 73.5, "bm25")))
        torch.cuda.synchronize()

    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for q, rows, m, sparse, outs in jobs:
        assert len(outs) == 40
        want_d = dk.dense_scores_plain(q, rows, m)
        want_s = sk.bm25_scores_plain(*sparse, m, 1.2, 0.75, 73.5, "bm25")
        for got_d, got_s in outs:
            assert_rel_close(got_d, want_d)
            assert_rel_close(got_s, want_s)


@pytest.mark.parametrize("fused", [True, False])
def test_pipeline_retrieve_on_the_card_matches_the_cpu_plain_path(cuda, fused):
    """AdvancedRAGPipeline on the card (K1, and K3 in the fused program)
    against the same pipeline on the CPU (the plain versions), with the
    same seeded f32 weights on the f32 tier: top-10 overlap >= 0.9.  The
    unfused pipeline's host rerank key must come from the manager's exact
    rescore on each retrieve, not from the fused-score fallback."""
    from advanced_rag_tpu_torch.config import PipelineConfig
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.models.cross_encoder import CrossEncoderReranker
    from advanced_rag_tpu_torch.models.embedder import NeuralEmbedder
    from advanced_rag_tpu_torch.models.encoder import EncoderConfig
    from advanced_rag_tpu_torch.pipeline import AdvancedRAGPipeline

    words = np.array("dense sparse fusion rank vector token query index shard cache "
                     "filter chunk model score merge tier scan kernel batch recall "
                     "latency corpus embed rerank bucket hash table slot".split())
    rng = np.random.default_rng(3)
    docs = [". ".join(" ".join(rng.choice(words, 9)) for _ in range(6)) + "."
            for _ in range(120)]
    queries = [" ".join(rng.choice(words, 5)) for _ in range(8)]
    geom = dict(vocab_size=4096, hidden_dim=64, num_layers=2, num_heads=4,
                mlp_dim=128, max_len=128, dtype=torch.float32)
    ids = {}
    for dev in ("cuda", "cpu"):
        cfg = PipelineConfig(fused_rerank=fused, semantic_dtype="float32",
                             chunk_base_size=30, chunk_min_size=8, chunk_max_size=60)
        cfg.semantic_dim = 64
        cfg.retrieval.timeout_seconds = 120.0
        emb = NeuralEmbedder(dim=64, config=EncoderConfig(**geom, lexical_pool=True),
                             seed=5, device=dev)
        pipe = AdvancedRAGPipeline(cfg, index_manager=MultiIndexManager(
            cfg, embedder=emb, device=dev), device=dev)
        pipe.retriever.reranker = CrossEncoderReranker(
            config=EncoderConfig(**geom, lexical_match=True), seed=6, device=dev)
        assert pipe._use_fused_path() == fused
        rescores = []
        rescore = pipe.index_manager.rescore_candidates_sync

        def counted(*args, **kwargs):
            rescores.append(len(args[0]))
            return rescore(*args, **kwargs)

        pipe.index_manager.rescore_candidates_sync = counted
        pipe.ingest_documents([{"doc_id": f"d{i}", "content": t}
                               for i, t in enumerate(docs)])
        before = (dk.dense_scores.launches, sk.bm25_scores.launches)
        outs = [pipe.retrieve(q, top_k=10) for q in queries]
        torch.cuda.synchronize()
        if dev == "cuda":
            assert dk.dense_scores.launches > before[0]
            if fused:
                assert sk.bm25_scores.launches > before[1]
        assert all(o["degraded"] is None and o["results"] for o in outs)
        assert len(rescores) == (0 if fused else len(queries))
        ids[dev] = [[r.chunk_id for r in o["results"]] for o in outs]
        pipe.close()
    overlap = sum(len(set(a) & set(b)) for a, b in zip(ids["cuda"], ids["cpu"]))
    assert overlap / sum(len(b) for b in ids["cpu"]) >= 0.9, ids


def _lifecycle_managers(tier, cuda, n=600, **kw):
    """A CPU manager over n short seeded chunks and an empty card manager
    with the same hashing projections (64 wide; domain 32 wide with
    ``enable_domain``)."""
    from advanced_rag_tpu_torch.config import PipelineConfig
    from advanced_rag_tpu_torch.index.corpus import ChunkRecord
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.models.embedder import HashingEmbedder

    rng = np.random.default_rng(31)
    vocab = np.array(["w%d" % i for i in range(400)])
    p = 1.0 / (np.arange(400) + 5.0)
    texts = [" ".join(rng.choice(vocab, size=int(rng.integers(6, 20)), p=p / p.sum()))
             for _ in range(n)]
    domain = kw.get("enable_domain", False)
    mgrs = {}
    for dev in ("cpu", cuda):
        src = mgrs.get("cpu")
        emb = HashingEmbedder(dim=64, seed=2, device=dev,
                              proj=None if src is None else src.embedder._proj.numpy())
        demb = (HashingEmbedder(dim=32, seed=3, device=dev,
                                proj=None if src is None
                                else src.domain_embedder._proj.numpy())
                if domain else None)
        mgrs[str(dev)] = MultiIndexManager(PipelineConfig(semantic_dtype=tier), embedder=emb,
                                           domain_embedder=demb, device=dev, **kw)
    mgrs["cpu"].index_chunks([ChunkRecord(chunk_id=f"c{i}", doc_id=f"d{i // 3}", content=t)
                              for i, t in enumerate(texts)])
    return mgrs["cpu"], mgrs["cuda"], texts


def _overlap(a, b):
    return sum(len({h["chunk_id"] for h in x} & {h["chunk_id"] for h in y})
               for x, y in zip(a, b)) / max(sum(len(y) for y in b), 1)


@pytest.mark.parametrize("tier,counter", [("bfloat16", "dense"), ("int8", "sq8"),
                                          ("pq", "pq")])
def test_restored_tier_searches_through_its_kernel(cuda, tmp_path, tier, counter):
    """A tier saved on the CPU and restored on the card by load_index (flat
    bf16 in one put, SQ8 re-quantized, PQ re-encoded with the saved
    codebooks): its first search launches K1, K2 or K6, and it answers as
    the CPU manager (top-10 overlap >= 0.9)."""
    from advanced_rag_tpu_torch.config import IndexType
    from advanced_rag_tpu_torch.utils.checkpoint import load_index, save_index

    cpu, card, texts = _lifecycle_managers(tier, cuda)
    if tier == "pq":
        cpu.build_semantic(pq=True)
    save_index(cpu, tmp_path)
    load_index(card, tmp_path)
    assert card.semantic.has_pq == (tier == "pq") and card.store.size == len(texts)
    fn = {"dense": dk.dense_scores, "sq8": dk.sq8_scores, "pq": pk.pq_scores}[counter]
    queries = [" ".join(t.split()[1:6]) for t in texts[::60]]
    before = fn.launches
    got = [card.search_sync(IndexType.SEMANTIC, q, 10) for q in queries]
    torch.cuda.synchronize()
    assert fn.launches >= before + len(queries)
    want = [cpu.search_sync(IndexType.SEMANTIC, q, 10) for q in queries]
    assert _overlap(got, want) >= 0.9


def test_maintenance_and_the_domain_rung_on_the_card(cuda, tmp_path, monkeypatch):
    """The domain rung runs K1 once more per batch and answers as the CPU
    plain path (top-10 overlap >= 0.9); maintenance_tick's first IVF build
    probes its recall through K5 against K1's exact scan."""
    import advanced_rag_tpu_torch.utils.constants as tconst
    from advanced_rag_tpu_torch.utils.checkpoint import load_index, save_index

    monkeypatch.setattr(tconst.IndexConstants, "IVF_AUTO_THRESHOLD", 500)
    cpu, card, texts = _lifecycle_managers("bfloat16", cuda, enable_domain=True)
    save_index(cpu, tmp_path)
    load_index(card, tmp_path)
    queries = [" ".join(t.split()[2:8]) for t in texts[::40]]
    before = dk.dense_scores.launches
    got = card.hybrid_search_batch_sync(queries, 10, domain_weight=0.5)
    torch.cuda.synchronize()
    assert dk.dense_scores.launches == before + 2       # semantic and domain scans
    assert _overlap(got, cpu.hybrid_search_batch_sync(queries, 10,
                                                      domain_weight=0.5)) >= 0.9
    before = (dk.dense_scores.launches, ik.ivf_scores.launches)
    actions = card.maintenance_tick()
    torch.cuda.synchronize()
    assert actions["ivf_rebuilt"] is True and card.semantic.has_ivf
    assert dk.dense_scores.launches > before[0] and ik.ivf_scores.launches > before[1]
    assert _overlap(card.hybrid_search_batch_sync(queries, 10),
                    cpu.hybrid_search_batch_sync(queries, 10)) >= 0.8


def _train_small(dev, dtype, steps=2):
    """``steps`` contrastive steps (the first has lr 0) and as many rerank
    steps (dropout off) at a small geometry on ``dev``, from one seeded
    init and one batch -> (metrics of each step, each tensor's gradient in
    the first step (after the clip), parameters after)."""
    from advanced_rag_tpu_torch.models.encoder import (EncoderConfig, init_bi_encoder,
                                                       init_cross_encoder)
    from advanced_rag_tpu_torch.models.tokenizer import HashingTokenizer, TokenizerConfig
    from advanced_rag_tpu_torch.train import contrastive as tc
    from advanced_rag_tpu_torch.train import rerank as tr

    def grads(prefix, module):
        return {f"{prefix}{k}": p.grad.detach().cpu().clone()
                for k, p in module.named_parameters()}

    cfg = EncoderConfig(vocab_size=2048, hidden_dim=64, num_layers=2, num_heads=4,
                        mlp_dim=128, max_len=32, dtype=dtype, lexical_pool=True)
    texts = [f"passage {i} on topic {i % 7} with words w{i} w{i + 3} and more text"
             for i in range(40)]
    tok = HashingTokenizer(TokenizerConfig(vocab_size=2048, max_len=32))
    train = tc.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    model, params = init_bi_encoder(cfg, out_dim=32, seed=0, device=dev)
    step, params, opt = tc.make_train_step(model, tc.make_optimizer(train), train, None,
                                           params, device=dev)
    batch = tc.synthetic_pair_batch(tok, texts, 16, np.random.default_rng(0), device=dev)
    batch["n_ids"], batch["n_mask"] = batch["d_ids"].flip(0), batch["d_mask"].flip(0)
    metrics, first = [], {}
    for i in range(steps):
        params, opt, m = step(params, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first.update(grads("bi.", model))
    out = {f"bi.{k}": v.cpu() for k, v in params.items()}
    ce_cfg = dataclasses.replace(cfg, lexical_pool=False, lexical_match=True)
    student, ce = init_cross_encoder(ce_cfg, seed=1, device=dev)
    rcfg = tr.RerankTrainConfig(queries_per_batch=4, candidates_per_query=4, q_len=8,
                                d_len=20, residual=True, label_smoothing=0.05)
    rstep, reval, ce, ropt = tr.make_rerank_step(student, tc.make_optimizer(train), train,
                                                 None, ce, rcfg, device=dev)
    pairs = [(" ".join(t.split()[2:6]), t) for t in texts]
    rbatch = tr.make_rerank_batch(tok, pairs, [texts[i + 1: i + 5] for i in range(40)],
                                  rcfg, np.random.default_rng(1),
                                  base_scores=[(1.0, [0.5, 0.2, 0.1, 0.0])] * 40, device=dev)
    for i in range(steps):
        ce, ropt, m = rstep(ce, ropt, rbatch, torch.Generator(device=dev).manual_seed(0))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first.update(grads("ce.", student))
    out.update({f"ce.{k}": v.cpu() for k, v in ce.items()})
    return metrics, first, out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_steps_on_the_card_match_the_cpu(cuda, dtype):
    """The card and the CPU from one init and one batch: losses, accuracies
    and gradient norms to rtol 1e-4 in f32 (2e-2 in bf16, whose activations
    round at other places on each device).  Each tensor's gradient in the
    first step: |card - CPU| <= rtol |CPU| + atol |the tower's gradient|
    (norms), rtol 1e-4 and atol 1e-6 in f32; in bf16 1e-1 and 5e-4, as
    bf16's own distance from f32 at this geometry on the CPU is up to
    7.6e-2 and 1.6e-4 (the atol holds the attention key biases and the
    score bias, whose true gradient is zero).  Parameters after the
    second update (the first with lr > 0), where Adam's step is about
    lr * sign(g): at most a fraction 1e-5 of the elements more than lr / 2
    from the CPU's in f32, 1e-2 in bf16 (bf16 against f32: 5.6e-3), and
    the total updates' cosine >= 0.999 in f32 (0.99 in bf16)."""
    got_m, got_g, got = _train_small(cuda, dtype)
    want_m, want_g, want = _train_small(torch.device("cpu"), dtype)
    f32 = dtype == torch.float32
    for g, w in zip(got_m, want_m):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4 if f32 else 2e-2, atol=1e-6,
                                       err_msg=k)
    rtol, atol = (1e-4, 1e-6) if f32 else (1e-1, 5e-4)
    lr = 1e-3
    _, _, init = _train_small(torch.device("cpu"), dtype, steps=0)
    for tower in ("bi.", "ce."):
        keys = [k for k in want if k.startswith(tower)]
        gkeys = [k for k in want_g if k.startswith(tower)]
        total = float(torch.sqrt(sum((want_g[k].double() ** 2).sum() for k in gkeys)))
        for k in gkeys:
            err = float((got_g[k] - want_g[k]).double().norm())
            assert err <= rtol * float(want_g[k].double().norm()) + atol * total, (k, err)
        diff = torch.cat([(got[k] - want[k]).flatten() for k in keys])
        far = int((diff.abs() > lr / 2).sum())
        assert far <= (1e-5 if f32 else 1e-2) * diff.numel(), (tower, far, diff.numel())
        upd = [torch.cat([(d[k] - init[k]).flatten() for k in keys]).double()
               for d in (got, want)]
        cos = float(torch.nn.functional.cosine_similarity(*upd, dim=0))
        assert cos >= (0.999 if f32 else 0.99), (tower, cos)


def test_sharded_hybrid_at_world_size_1_under_nccl(cuda):
    """parallel/: the sharded fused hybrid on a one-rank NCCL process group
    answers as ops/hybrid.py's unsharded program on the same rows (the
    same kernels, K1 and K3; every collective over one rank is the
    identity), with and without MMR."""
    import socket
    from datetime import timedelta

    import torch.distributed as dist

    from advanced_rag_tpu_torch.ops.dense import l2_normalize
    from advanced_rag_tpu_torch.ops.hybrid import hybrid_retrieve
    from advanced_rag_tpu_torch.parallel import build_mesh, sharded_hybrid_retrieve

    gen = torch.Generator(device=cuda).manual_seed(5)
    n, d, p, vocab = 4096, 384, 64, 5000
    emb = l2_normalize(torch.randn(n, d, generator=gen, device=cuda)).to(torch.bfloat16)
    rows = torch.arange(n, device=cuda)[:, None]
    idx_t = ((rows * 7 + torch.arange(p, device=cuda)[None] * 73) % vocab).to(torch.int32)
    idx_t = torch.where(torch.rand(n, p, generator=gen, device=cuda) < 0.4, idx_t, -1)
    tf_t = torch.randint(1, 4, (n, p), generator=gen, device=cuda).to(torch.bfloat16)
    doc_len = (idx_t >= 0).sum(1).float() * 2
    df = torch.randint(1, 50, (vocab,), generator=gen, device=cuda)
    q = l2_normalize(torch.randn(8, d, generator=gen, device=cuda))
    q_idx = idx_t[torch.arange(8, device=cuda) * 97][:, :16].contiguous()
    q_tf = torch.ones(8, 16, device=cuda)
    valid = torch.rand(n, generator=gen, device=cuda) < 0.9
    args = (emb, idx_t.T.contiguous(), tf_t.T.contiguous(), doc_len, df,
            torch.tensor(float(n), device=cuda), q, q_idx, q_tf, valid,
            torch.tensor([0.7, 0.3], device=cuda), torch.tensor(0.8, device=cuda))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        mesh = build_mesh()
        for mmr in (False, True):
            got = sharded_hybrid_retrieve(*args, mesh=mesh, k_cand=64, k_out=16, use_mmr=mmr)
            want = hybrid_retrieve(*args, k_cand=64, k_out=16, use_mmr=mmr)
            assert torch.equal(got[0], want.ids)
            assert torch.equal(got[1], want.scores)
            assert torch.equal(got[2], want.method_counts)
            assert bool((got[0] >= 0).any())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("family", ["big_bird", "albert"])
def test_hf_encoder_forward_on_the_card_matches_the_cpu(cuda, family):
    """models/hf_big_bird.py (block_sparse, 16 blocks of 64, an all-padding
    row and a half-padded one) and models/hf_albert.py (2 groups of 2 inner
    layers over 4 layers, embedding 128 under hidden 256) at f32: the
    card's hidden states against the same module's on the CPU within 1e-4
    absolute (hidden states of scale about 4)."""
    from advanced_rag_tpu_torch.models.hf_checkpoint import HFConfig
    from advanced_rag_tpu_torch.models.hf_embedder import build_trunk

    if family == "big_bird":
        config = HFConfig(vocab_size=1000, hidden_size=256, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=512,
                          max_position_embeddings=1024, hidden_act="gelu_new",
                          model_type="big_bird", attention_type="block_sparse",
                          block_size=64, num_random_blocks=3)
        seq = 1024
    else:
        config = HFConfig(vocab_size=1000, hidden_size=256, num_hidden_layers=4,
                          num_attention_heads=4, intermediate_size=512,
                          max_position_embeddings=512, hidden_act="gelu_new",
                          model_type="albert", embedding_size=128, num_hidden_groups=2,
                          inner_group_num=2)
        seq = 256
    torch.manual_seed(0)
    model = build_trunk(config, torch.float32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_((1.0 + 0.05 * torch.randn_like(p)) if name.endswith("LayerNorm.weight")
                    or name.endswith("layer_norm.weight") else 0.05 * torch.randn_like(p))
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(5, config.vocab_size, (4, seq), generator=gen)
    mask = torch.ones_like(ids)
    mask[1, seq // 2 + 5:] = 0
    mask[3] = 0
    types = torch.zeros_like(ids)
    with torch.inference_mode():
        want, _ = model(ids, mask, types)
        got, _ = model.to(cuda)(ids.to(cuda), mask.to(cuda), types.to(cuda))
    got = got.cpu()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-4, float((got - want).abs().max())


@pytest.mark.parametrize("family", ["bart", "mbart", "pegasus", "marian", "blenderbot",
                                    "blenderbot-small"])
def test_hf_encdec_forward_on_the_card_matches_the_cpu(cuda, family):
    """models/hf_bart.py (3 + 3 layers, 256 wide, each family's switches,
    an all-padding row of id 0 and a half-padded row) at f32: the card's
    decoder states against the same module's on the CPU within 1e-4
    absolute (states of scale about 1)."""
    from advanced_rag_tpu_torch.models.hf_checkpoint import HFConfig
    from advanced_rag_tpu_torch.models.hf_embedder import build_trunk

    config = HFConfig(vocab_size=1000, hidden_size=256, num_hidden_layers=3,
                      num_attention_heads=4, intermediate_size=512,
                      max_position_embeddings=256, layer_norm_eps=1e-5,
                      hidden_act="silu" if family == "marian" else "gelu",
                      model_type=family, pad_token_id=1, decoder_layers=3,
                      decoder_attention_heads=8, decoder_ffn_dim=1024,
                      scale_embedding=family in ("mbart", "pegasus", "marian", "blenderbot"),
                      decoder_start_token_id=None if family == "mbart" else 2)
    torch.manual_seed(0)
    model = build_trunk(config, torch.float32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_((1.0 + 0.05 * torch.randn_like(p)) if "norm" in name and
                    name.endswith("weight") else 0.05 * torch.randn_like(p))
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(5, config.vocab_size, (4, 128), generator=gen)
    mask = torch.ones_like(ids)
    mask[1, 70:] = 0
    ids[1, 70:] = 1
    mask[3] = 0
    ids[3] = 0
    with torch.inference_mode():
        want, _ = model(ids, mask)
        got, _ = model.to(cuda)(ids.to(cuda), mask.to(cuda))
    got = got.cpu()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-4, float((got - want).abs().max())


@pytest.mark.parametrize("family", ["gpt2", "gpt_neo", "gptj", "bloom", "xglm"])
def test_hf_gpt_forward_on_the_card_matches_the_cpu(cuda, family):
    """models/hf_gpt2.py (GPT-2; GPT-Neo with a local layer of window 64;
    GPT-J rotating 32 of 64 head columns), models/hf_bloom.py (ALiBi, the
    residuals after the LayerNorms) and models/hf_xglm.py at 2 layers, 256
    wide, f32, on a left-padded row, a half right-padded one and an
    all-padding row of id 0: the card's last states against the same
    module's on the CPU within 1e-4 absolute (states of scale about 1)."""
    from advanced_rag_tpu_torch.models.hf_checkpoint import HFConfig
    from advanced_rag_tpu_torch.models.hf_embedder import build_trunk

    config = HFConfig(vocab_size=1000, hidden_size=256, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=768,
                      max_position_embeddings=256, layer_norm_eps=1e-5,
                      hidden_act="gelu" if family == "xglm" else "gelu_new",
                      model_type=family, pad_token_id=1,
                      scale_embedding=family == "xglm",
                      rotary_dim=32 if family == "gptj" else None,
                      window_size=64 if family == "gpt_neo" else 0,
                      attention_layers=("global", "local") if family == "gpt_neo" else (),
                      residual_post_ln=family == "bloom")
    torch.manual_seed(0)
    with torch.device("meta"):
        model = build_trunk(config, torch.float32)
    model = model.to_empty(device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_((1.0 + 0.05 * torch.randn_like(p)) if ("ln" in name or "norm" in name)
                    and name.endswith("weight") else 0.05 * torch.randn_like(p))
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(5, config.vocab_size, (4, 128), generator=gen)
    mask = torch.ones_like(ids)
    mask[0, :50] = 0
    mask[1, 70:] = 0
    mask[3] = 0
    ids[3] = 0
    with torch.inference_mode():
        want, _ = model(ids, mask)
        got, _ = model.to(cuda)(ids.to(cuda), mask.to(cuda))
    got = got.cpu()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-4, float((got - want).abs().max())

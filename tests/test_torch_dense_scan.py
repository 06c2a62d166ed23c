"""The CPU-side pieces of the dense scans K1 and K2 (csrc/dense_scan.cu):
the three-part bf16 split of the query that K1's prologue makes for the
tensor cores, and the launch plan the wrappers keep in Python (queries per
launch from the shared memory a launch needs, and the test for rows the
kernels copy with 16-byte cp.async).

Bounds: the split reconstructs each query value to 2^-24 of its magnitude
(three parts of 8 significant bits each, rounded to nearest); the product
of the three parts with bf16 rows, each part's product in f32, matches
dense_scores_plain to 1e-6 of the largest live score (the products are
exact, only the f32 summation order differs).
"""

import numpy as np
import pytest
import torch

from advanced_rag_tpu_torch.ops import dense_kernels as dk
from advanced_rag_tpu_torch.ops.dense import NEG_INF, mask_additive


@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.0, 1e4])
def test_split_reconstructs_the_query(scale):
    rng = np.random.default_rng(int(scale * 1000) % 9973)
    q = torch.from_numpy((rng.standard_normal((9, 384)) * scale).astype(np.float32))
    parts = dk.split_query_bf16(q)
    assert parts.dtype == torch.bfloat16 and tuple(parts.shape) == (3, 9, 384)
    recon = parts.double().sum(0)
    err = (recon - q.double()).abs()
    assert bool((err <= 2.0 ** -24 * q.double().abs()).all()), float(err.max())
    # each part is a bf16 rounding of what the parts before it left
    hi, mid, lo = parts.float()
    assert torch.equal(hi, q.to(torch.bfloat16).float())
    assert torch.equal(mid, (q - hi).to(torch.bfloat16).float())
    assert torch.equal(lo, (q - hi - mid).to(torch.bfloat16).float())


@pytest.mark.parametrize("nq,n,d", [(1, 1000, 384), (32, 777, 384), (17, 300, 36),
                                    (40, 129, 7)])
def test_three_part_product_matches_the_plain_scan(nq, n, d):
    rng = np.random.default_rng(nq * 100 + d)
    rows = torch.from_numpy(rng.standard_normal((n, d), np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((nq, d), np.float32))
    m = mask_additive(torch.from_numpy(rng.random(n) > 0.3), n, torch.device("cpu"))
    want = dk.dense_scores_plain(q, rows, m)
    got = sum(p.float() @ rows.float().T for p in dk.split_query_bf16(q)) + m[None, :]
    live = want > NEG_INF / 2
    assert torch.equal(got[~live], want[~live])
    scale = float(want[live].abs().max())
    assert float((got[live] - want[live]).abs().max()) <= 1e-6 * scale


def test_scan_plan_matches_the_kernels_shared_memory():
    ring = 4 * 144                  # 4 stages of a staged row: 128 bytes + 16 pad
    # D = 384: bf16 parts 3 x 784 bytes a query, int8 400, f32 1536; 32
    # bf16 or f32 queries take 256-row tiles where those fit
    assert dk.scan_plan("bf16", 32, 384) == (256, 256 * ring + 3 * 32 * 784)
    assert dk.scan_plan("f32", 32, 384) == (256, 256 * ring + 384 * 32 * 4)
    assert dk.scan_plan("int8", 32, 384) == (128, 128 * ring + 32 * 400)
    assert dk.scan_plan("bf16", 16, 384) == (128, 128 * ring + 3 * 16 * 784)
    assert dk.scan_plan("bf16", 32, 512) == (128, 128 * ring + 3 * 32 * 1040)
    # ragged D rounds up to the stage's 128 bytes of a row
    assert dk.scan_plan("bf16", 8, 7) == (128, 128 * ring + 3 * 8 * (128 + 16))
    assert dk.scan_plan("int8", 8, 20) == (128, 128 * ring + 8 * (128 + 16))
    assert dk.scan_plan("f32", 16, 36) == (128, 128 * ring + 64 * 16 * 4)
    for kind in ("bf16", "int8", "f32"):
        for d in (7, 20, 36, 384, 768):
            assert dk.scan_chunk(kind, d) == 32
    assert dk.scan_chunk("bf16", 1024) == dk.scan_chunk("bf16", 1536) == 16
    assert dk.scan_chunk("int8", 1024) == dk.scan_chunk("f32", 1024) == 32
    assert dk.scan_chunk("bf16", 2048) == 8
    assert dk.scan_chunk("f32", 2048) == 16
    # bf16 rows past 3264 and f32 rows past 4960 wide take 32 queries a
    # launch, scanned in slices of D (scan_width); SQ8 rows take no slices
    assert dk.scan_chunk("bf16", 4096) == dk.scan_chunk("f32", 8192) == 32
    with pytest.raises(ValueError, match="too wide"):
        dk.scan_chunk("int8", 32768)
    for kind in ("bf16", "int8", "f32"):
        for d in (384, 1536, 2048):
            assert dk.scan_plan(kind, dk.scan_chunk(kind, d), d)[1] <= dk.SCAN_SMEM_MAX
    with pytest.raises(ValueError):
        dk.scan_plan("f16", 8, 384)


def test_rows_take_cp_async_only_when_16_byte_aligned():
    buf = torch.zeros(64 * 384 + 8, dtype=torch.bfloat16)
    base = buf.data_ptr() % 16 // 2            # elements to the next 16 bytes
    aligned = buf[(8 - base) % 8:][: 64 * 384].view(64, 384)
    assert dk.aligned_rows(aligned) == 1
    assert dk.aligned_rows(buf[(9 - base) % 8:][: 64 * 384].view(64, 384)) == 0
    assert dk.aligned_rows(torch.zeros((64, 36), dtype=torch.bfloat16)) == 0
    assert dk.aligned_rows(torch.zeros((64, 20), dtype=torch.int8)) == 0
    assert dk.aligned_rows(torch.zeros((64, 32), dtype=torch.int8)) == 1
    assert dk.aligned_rows(torch.zeros((64, 36), dtype=torch.float32)) == 1


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.standard_normal((50, 16), np.float32))
    q = torch.from_numpy(rng.standard_normal((3, 16), np.float32))
    m = torch.zeros(50)
    k1, k2 = dk.dense_scores.launches, dk.sq8_scores.launches
    assert torch.equal(dk.dense_scores(q, rows, m), dk.dense_scores_plain(q, rows, m))
    codes = torch.from_numpy(rng.integers(-127, 128, (50, 16)).astype(np.int8))
    qc = codes[:3].clone()
    assert torch.equal(dk.sq8_scores(qc, codes, torch.ones(50), m),
                       dk.sq8_scores_plain(qc, codes, torch.ones(50), m))
    assert (dk.dense_scores.launches, dk.sq8_scores.launches) == (k1, k2)


# (rows per tile, shared-memory bytes) of each launch block (8, 16, 32
# queries) at the widths that fitted whole before wide rows were sliced
_PLANS = {
    ("bf16", 384): (32, {8: (128, 92544), 16: (128, 111360), 32: (256, 222720)}),
    ("bf16", 768): (32, {8: (128, 110976), 16: (128, 148224), 32: (128, 222720)}),
    ("bf16", 1536): (16, {8: (128, 147840), 16: (128, 221952)}),
    ("bf16", 3072): (8, {8: (128, 221568)}),
    ("f32", 384): (32, {8: (128, 86016), 16: (128, 98304), 32: (256, 196608)}),
    ("f32", 768): (32, {8: (128, 98304), 16: (128, 122880), 32: (128, 172032)}),
    ("f32", 1536): (16, {8: (128, 122880), 16: (128, 172032)}),
    ("f32", 3072): (8, {8: (128, 172032)}),
    ("f32", 4096): (8, {8: (128, 204800)}),
    ("int8", 384): (32, {8: (128, 76928), 16: (128, 80128), 32: (128, 86528)}),
    ("int8", 4096): (32, {32: (128, 205312)}),
}


@pytest.mark.parametrize("kind,d", sorted(_PLANS))
def test_scan_plans_of_rows_that_fit_whole_are_unchanged(kind, d):
    chunk, plans = _PLANS[(kind, d)]
    assert dk.scan_chunk(kind, d) == chunk
    for qc, plan in plans.items():
        assert dk.scan_plan(kind, qc, d) == plan
        if kind != "int8":
            assert dk.scan_width(kind, qc, d) == d
    for nq in (1, 8, 9, 32, 33):
        launches = dk.scan_launches(kind, nq, d) if kind != "int8" else []
        assert all(k0 == 0 and kw == d for _, _, k0, kw in launches)


@pytest.mark.parametrize("kind,d", [("bf16", 4096), ("bf16", 8192), ("bf16", 4100),
                                    ("f32", 8192), ("f32", 6000)])
@pytest.mark.parametrize("nq", [1, 8, 16, 32, 40])
def test_wide_rows_scan_in_slices_that_fit(kind, d, nq):
    align = 64 if kind == "bf16" else 32
    launches = dk.scan_launches(kind, nq, d)
    seen = {}
    for q0, nc, k0, kw in launches:
        qc = dk.launch_qc(nc)
        assert dk.scan_plan(kind, qc, kw)[1] <= dk.SCAN_SMEM_MAX
        assert k0 % align == 0 and 0 < kw <= d - k0
        seen.setdefault((q0, nc), []).append((k0, kw))
    # every query once, every value of its rows once, slices in order
    assert sorted(q0 for q0, _ in seen) == list(range(0, nq, 32))
    for (q0, nc), slices in seen.items():
        assert nc == min(32, nq - q0)
        assert [k0 for k0, _ in slices] == sorted(k0 for k0, _ in slices)
        assert sum(kw for _, kw in slices) == d
        assert all(a + wa == b for (a, wa), (b, _) in zip(slices, slices[1:]))
    # the slices' plain partial products, the first with the mask, add up
    # to the plain scan
    rng = np.random.default_rng(d + nq)
    rows = torch.from_numpy(rng.standard_normal((64, d), np.float32))
    if kind == "bf16":
        rows = rows.to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((nq, d), np.float32))
    m = mask_additive(torch.from_numpy(rng.random(64) > 0.3), 64, torch.device("cpu"))
    got = torch.empty((nq, 64))
    for q0, nc, k0, kw in launches:
        part = dk.dense_scores_plain(q[q0:q0 + nc, k0:k0 + kw], rows[:, k0:k0 + kw],
                                     m if k0 == 0 else torch.zeros(64))
        got[q0:q0 + nc] = part if k0 == 0 else got[q0:q0 + nc] + part
    want = dk.dense_scores_plain(q, rows, m)
    live = want > NEG_INF / 2
    assert torch.equal(got[~live], want[~live])
    assert float((got[live] - want[live]).abs().max()) <= 1e-5 * float(want[live].abs().max())

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
    for kind, d in (("bf16", 4096), ("f32", 8192)):
        with pytest.raises(ValueError, match="too wide"):
            dk.scan_chunk(kind, d)
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

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (advanced_rag_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds:

1. device: the card's name, the device count and the nvidia-smi name and
   power limit; no CUDA device -> exit with an error, no result printed;
2. build: the one nvcc call that builds csrc/*.cu (plain C ABI, ctypes);
3. kernels: K1 (dense scan, bf16 and f32 rows), K2 (SQ8 scan), K3 (BM25)
   and K3-ip, each against its plain PyTorch version at the main path's
   shapes (N = MAIN_N, Q = 1, 8 and 32; K1 and K2 also at N = 1M): scores (f32, max |err| <= 1e-5 of the largest live score; K2's
   integer dot is exact, <= 1e-6) and tie-aware top-k ids; each kernel's
   time (CUDA events, mean of 20 warmed launches), its bound on the card,
   the plain version's time and, for K1, torch's matmul;
4. main path, once on the bf16 tier and once on the SQ8 tier: a manager
   with fused_rerank at the shipped models' full geometry (6 x 256, 8
   heads, MLP 1024, 384-wide embeddings, random weights from a seeded
   torch.Generator) ingests 100,000 seeded synthetic chunks through
   index_chunks (every 1000th one a short probe chunk), then serves
   batches of Q = 1, 8 and 32 queries through fused_retrieve_batch_sync
   with the repo's measured serving knobs;
   launch counters are zeroed before and read after each tier; then K1
   or K2, and K3, are held against their plain versions once more on the
   tier's own index tensors, row mask and a batch of real queries;
5. reference: a small corpus served on the card and by the plain path on
   the CPU, with f32 weights and the f32 tier, must agree.

Then one JSON line {"kernels": [...]} and, last, the device line
{"ok": true, "device": {...}}.  Any failed check raises, so the run exits
non-zero and prints no result.  The script starts no server and no
background thread.
"""

from __future__ import annotations

import json
import subprocess
import time

T0 = time.perf_counter()

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12       # int8 tensor-core peak

N_CHUNKS = 100_000
#: the store's capacity once N_CHUNKS are ingested (power-of-two growth):
#: the N of every [Q, N] score matrix the main path computes
MAIN_N = 131_072
WORDS_PER_CHUNK = 100
#: every PROBE_EVERY-th chunk is a short one (PROBE_WORDS words, within the
#: 32-token query window), so that a query made of its exact text sees the
#: same tokens the chunk was embedded from, even with random weights
PROBE_EVERY = 1000
PROBE_WORDS = 24
BATCHES = (1, 8, 32)
REPEATS = 12                   # first 2 are warm-up, 10 timed
SERVE = dict(k_final=10, k_rerank=48, dense_weight=0.7, sparse_weight=0.3,
             use_mmr=True, mmr_lambda=0.8, q_max_len=32, rerank_alpha=0.5,
             rerank_mode="residual", rerank_base="exact", rescore_mix=0.65)


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def score_error(got, want, neg_inf):
    """(max |err| over live entries, that / largest live |score|); masked
    entries must be equal."""
    import torch

    live = want > neg_inf / 2
    if not torch.equal(got[~live], want[~live]):
        raise AssertionError("masked scores differ from the plain version")
    if not bool(live.any()):
        return 0.0, 0.0
    err = float((got[live] - want[live]).abs().max())
    return err, err / max(float(want[live].abs().max()), 1e-30)


def check_ids(got_ids, want_ids, want_scores, tol):
    """Tie-aware top-k agreement: where the id lists differ at a position,
    the plain scores of the two ids must be equal within ``tol``."""
    import torch

    diff = got_ids != want_ids
    if not bool(diff.any()):
        return 0
    a = torch.gather(want_scores, 1, got_ids.clamp(min=0).long())
    b = torch.gather(want_scores, 1, want_ids.clamp(min=0).long())
    gap = float((a - b).abs()[diff].max())
    if gap > tol:
        raise AssertionError(f"top-k ids differ beyond ties (score gap {gap})")
    return int(diff.sum())


def compare(got, want, tol, k=64):
    """Scores within ``tol`` of the largest live score, and tie-aware top-k
    ids; returns (max |err|, relative err, ids differing at ties)."""
    from advanced_rag_tpu_torch.ops.dense import NEG_INF, topk_first

    err, rel = score_error(got, want, NEG_INF)
    if rel > tol:
        raise AssertionError(f"scores differ: rel {rel} > {tol}")
    _, gi = topk_first(got, k)
    _, wi = topk_first(want, k)
    scale = max(float(want[want > NEG_INF / 2].abs().max()), 1e-30)
    swaps = check_ids(gi, wi, want, tol * scale)
    return err, rel, swaps


def bound(bytes_moved: float, ops: float, ops_rate: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card")
    import advanced_rag_tpu_torch  # noqa: F401  (fails outside a checkout)

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    log(f"device: {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, count, smi.splitlines()[0]


def phase_build():
    from advanced_rag_tpu_torch import _build

    t = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"build: {' '.join(_build.nvcc_command(_build.find_nvcc(), path))}")
    nvcc_s = _build.last_build_seconds
    log(f"build: nvcc {'not run (library cached)' if nvcc_s is None else f'{nvcc_s:.2f}s'}, "
        f"{time.perf_counter() - t:.2f}s with loading")


def phase_kernels():
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.ops import dense_kernels as dk
    from advanced_rag_tpu_torch.ops import sparse_kernels as sk
    from advanced_rag_tpu_torch.ops.dense import l2_normalize, mask_additive
    from advanced_rag_tpu_torch.ops.quant import sq8_quantize

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    results = {}

    def third_masked(n):
        valid = torch.rand(n, generator=gen, device=dev) >= 1.0 / 3.0
        return mask_additive(valid, n, dev)

    def record(key, case):
        results.setdefault(key, []).append(case)
        log(f"kernels: {key} {case['shape']}: max_abs_err {case['max_abs_err']:.3g} "
            f"(rel {case['rel_err']:.3g}), ids differing at ties "
            f"{case['tie_swaps']}, {case['ms']:.4f} ms, bound {case['bound_ms']:.4f} "
            f"ms ({case['bound_by']}), plain {case['plain_ms']:.4f} ms, library "
            f"{case['library_ms'] if case['library_ms'] is None else round(case['library_ms'], 4)} ms")

    # K1: bf16 rows at the main path's N and at N = 1M, f32 rows at
    # N = 100k; D = 384
    d = 384
    for dtype, n, batches in ((torch.bfloat16, MAIN_N, BATCHES),
                              (torch.bfloat16, 1_000_000, (1, 32)),
                              (torch.float32, 100_000, (1, 32))):
        rows = l2_normalize(torch.randn(n, d, generator=gen, device=dev)).to(dtype)
        m = third_masked(n)
        for nq in batches:
            q = l2_normalize(torch.randn(nq, d, generator=gen, device=dev)).contiguous()
            got = dk.dense_scores(q, rows, m)
            want = dk.dense_scores_plain(q, rows, m)
            err, rel, swaps = compare(got, want, 1e-5)
            ms = cuda_ms(lambda: dk.dense_scores(q, rows, m))
            plain_ms = cuda_ms(lambda: dk.dense_scores_plain(q, rows, m), reps=5)
            if dtype == torch.bfloat16:
                qb = q.to(torch.bfloat16)
                lib_ms = cuda_ms(lambda: torch.matmul(qb, rows.T))
            else:
                lib_ms = cuda_ms(lambda: torch.addmm(m[None, :], q, rows.T))
            if dtype == torch.bfloat16:    # hi + lo query halves: two bf16 passes
                ops, rate = 2 * 2.0 * nq * n * d, BF16_OPS_PER_S
            else:
                ops, rate = 2.0 * nq * n * d, F32_OPS_PER_S
            b_ms, b_by = bound(n * d * rows.element_size() + nq * d * 4 + n * 4
                               + nq * n * 4, ops, rate)
            record("K1", dict(shape=f"{str(dtype)[6:]} rows N={n} D={d} Q={nq}",
                              main=dtype == torch.bfloat16 and (n, nq) == (MAIN_N, 32),
                              max_abs_err=err, rel_err=rel, tie_swaps=swaps,
                              ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by))
        del rows

    # K2: SQ8 codes at the main path's N and at N = 1M, D = 384
    for n, batches in ((MAIN_N, BATCHES), (1_000_000, (1, 32))):
        codes, scale = sq8_quantize(l2_normalize(torch.randn(n, d, generator=gen,
                                                             device=dev)))
        m = third_masked(n)
        for nq in batches:
            q_codes, _ = sq8_quantize(l2_normalize(torch.randn(nq, d, generator=gen,
                                                           device=dev)))
            got = dk.sq8_scores(q_codes, codes, scale, m)
            want = dk.sq8_scores_plain(q_codes, codes, scale, m)
            err, rel, swaps = compare(got, want, 1e-6)
            ms = cuda_ms(lambda: dk.sq8_scores(q_codes, codes, scale, m))
            plain_ms = cuda_ms(lambda: dk.sq8_scores_plain(q_codes, codes, scale, m),
                               reps=5)
            b_ms, b_by = bound(n * d + nq * d + n * 8 + nq * n * 4,
                               2.0 * nq * n * d, INT8_OPS_PER_S)
            record("K2", dict(shape=f"int8 codes N={n} D={d} Q={nq}",
                              main=(n, nq) == (MAIN_N, 32), max_abs_err=err,
                              rel_err=rel, tie_swaps=swaps, ms=ms, plain_ms=plain_ms,
                              library_ms=None, bound_ms=b_ms, bound_by=b_by))
        del codes, scale

    # K3 / K3-ip: the main path's N, P = 256 slots (30-90 live, the rest
    # -1), T = 32 query terms (8-32 live), ids from a Zipf-like vocabulary
    n, p, t, vocab = MAIN_N, 256, 32, 16384
    rng = np.random.default_rng(99)
    zipf = 1.0 / (np.arange(vocab) + 10.0)
    zipf /= zipf.sum()
    live = rng.integers(30, 91, size=n)
    idx = rng.choice(vocab, size=(n, p), p=zipf).astype(np.int32)
    idx[np.arange(p)[None, :] >= live[:, None]] = -1
    tf = np.where(idx >= 0, rng.integers(1, 5, size=(n, p)), 0).astype(np.float32)
    idx_t = torch.from_numpy(np.ascontiguousarray(idx.T)).to(dev)
    tf_t = torch.from_numpy(np.ascontiguousarray(tf.T)).to(dev)
    dlen = torch.from_numpy(tf.sum(1).astype(np.float32)).to(dev)
    avg_len = float(dlen.mean())
    m = third_masked(n)
    live_slots = int((idx >= 0).sum())
    for scoring, key in (("bm25", "K3"), ("ip", "K3-ip")):
        for nq in BATCHES:
            q_idx = rng.choice(vocab, size=(nq, t), p=zipf).astype(np.int32)
            q_live = rng.integers(8, t + 1, size=nq)
            q_idx[np.arange(t)[None, :] >= q_live[:, None]] = -1
            q_w = np.where(q_idx >= 0, rng.random((nq, t)) * 3, 0).astype(np.float32)
            qi = torch.from_numpy(q_idx).to(dev)
            qw = torch.from_numpy(q_w).to(dev)
            args = (qi, qw, idx_t, tf_t, dlen, m, 1.2, 0.75, avg_len, scoring)
            got = sk.bm25_scores(*args)
            want = sk.bm25_scores_plain(*args)
            err, rel, swaps = compare(got, want, 1e-5)
            ms = cuda_ms(lambda: sk.bm25_scores(*args))
            plain_ms = cuda_ms(lambda: sk.bm25_scores_plain(*args), reps=2, warmup=1)
            b_ms, b_by = bound(p * n * 8 + n * 8 + nq * t * 8 + nq * n * 4,
                               2.0 * live_slots * int(q_live.sum()), F32_OPS_PER_S)
            record(key, dict(shape=f"N={n} P={p} T={t} Q={nq}", main=nq == 32,
                             max_abs_err=err,
                             rel_err=rel, tie_swaps=swaps, ms=ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=b_ms, bound_by=b_by))
    del idx_t, tf_t
    torch.cuda.empty_cache()
    return results


def synthetic_corpus(n: int, seed: int):
    """n chunks of WORDS_PER_CHUNK words from a seeded Zipf vocabulary."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab_n = 30_000
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    lens = rng.integers(3, 11, size=vocab_n)
    pool = letters[rng.integers(0, 26, size=(vocab_n, 10))]
    vocab = np.array(["".join(pool[i, :lens[i]]) for i in range(vocab_n)])
    p = 1.0 / (np.arange(vocab_n) + 20.0)
    p /= p.sum()
    words = vocab[rng.choice(vocab_n, size=(n, WORDS_PER_CHUNK), p=p)]
    return [" ".join(row[:PROBE_WORDS] if i % PROBE_EVERY == 0 else row)
            for i, row in enumerate(words)]


def snippet_queries(rng, texts, nq):
    """nq queries of 12 consecutive words from random chunks."""
    queries = []
    for row in rng.integers(0, len(texts), size=nq):
        words = texts[row].split()
        s0 = int(rng.integers(0, max(len(words) - 12, 1)))
        queries.append(" ".join(words[s0:s0 + 12]))
    return queries


KERNEL_GROUPS = (
    ("K1 dense_scores", ("dense_scores_kernel",)),
    ("K2 sq8_scores", ("sq8_scores_kernel",)),
    ("K3 bm25_scores", ("bm25_scores_kernel",)),
    ("matmul", ("gemm", "cutlass", "xmma", "gemv", "sm90_")),
    ("top-k/sort", ("topk", "sort", "radix", "bitonic")),
)


def profile_batch(mgr, reranker, queries):
    """One batch under torch.profiler: wall time, device busy time (the sum
    of the kernels' device time; one stream, so they do not overlap), the
    idle share, device time by kernel group and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        mgr.fused_retrieve_batch_sync(queries, reranker=reranker, **SERVE)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    if not kernels:
        raise AssertionError("the profiler recorded no device kernels")
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for name, ms in kernels.items():
        low = name.lower()
        key = next((g for g, pats in KERNEL_GROUPS if any(p in low for p in pats)),
                   "other")
        groups[key] += ms
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                idle_share=max(0.0, 1.0 - device_ms / wall_ms),
                n_kernels=len(kernels),
                groups_ms={k: round(v, 3) for k, v in groups.items()},
                top_ms={k[:60]: round(v, 3) for k, v in top})


def reset_counters():
    from advanced_rag_tpu_torch.ops import dense_kernels as dk
    from advanced_rag_tpu_torch.ops import sparse_kernels as sk

    dk.dense_scores.launches = 0
    dk.sq8_scores.launches = 0
    sk.bm25_scores.launches = 0
    sk.bm25_scores.ip_launches = 0


def read_counters():
    from advanced_rag_tpu_torch.ops import dense_kernels as dk
    from advanced_rag_tpu_torch.ops import sparse_kernels as sk

    ip = sk.bm25_scores.ip_launches
    return {"K1": dk.dense_scores.launches, "K2": dk.sq8_scores.launches,
            "K3": sk.bm25_scores.launches - ip, "K3-ip": ip}


def check_served_tensors(mgr, queries):
    """K1 or K2, and K3, against their plain versions on the tensors the
    tier serves from: its index, its row mask and a batch of real queries
    embedded by its model.  Returns {kernel: (max |err|, rel err, swaps)}."""
    import torch

    from advanced_rag_tpu_torch.ops import dense_kernels as dk
    from advanced_rag_tpu_torch.ops import sparse_kernels as sk
    from advanced_rag_tpu_torch.ops.dense import mask_additive
    from advanced_rag_tpu_torch.ops.quant import sq8_quantize
    from advanced_rag_tpu_torch.ops.sparse import live_avg_len, query_weights

    dev = mgr.device
    sem, sp = mgr.semantic, mgr.sparse
    valid = mgr._row_mask(None)
    m = mask_additive(valid, sem.capacity, dev)
    q = mgr.embedder.encode_device(queries).float().contiguous()
    out = {}
    if sem._sq8:
        q_codes, _ = sq8_quantize(q)
        args = (q_codes.contiguous(), sem.emb, sem.emb_scale, m)
        out["K2"] = compare(dk.sq8_scores(*args), dk.sq8_scores_plain(*args), 1e-6)
    else:
        args = (q, sem.emb, m)
        out["K1"] = compare(dk.dense_scores(*args), dk.dense_scores_plain(*args), 1e-5)
    q_idx, q_tf = sp.encode_query(queries)
    q_idx = torch.from_numpy(q_idx).to(dev).to(torch.int32).contiguous()
    n_docs = torch.tensor(float(max(sp.n_docs, 1)), device=dev)
    q_w = query_weights(q_idx, torch.from_numpy(q_tf).to(dev), sp.df, n_docs, "bm25")
    args = (q_idx, q_w.contiguous(), sp.idx_t, sp.tf_t, sp.doc_len, m, 1.2, 0.75,
            float(live_avg_len(sp.doc_len, valid)), "bm25")
    out["K3"] = compare(sk.bm25_scores(*args), sk.bm25_scores_plain(*args), 1e-5)
    return out


def phase_main_path(texts):
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.config import PipelineConfig
    from advanced_rag_tpu_torch.index.corpus import ChunkRecord
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.models.cross_encoder import CrossEncoderReranker
    from advanced_rag_tpu_torch.models.embedder import NeuralEmbedder
    from advanced_rag_tpu_torch.models.encoder import (
        SHIPPED_BIENCODER, SHIPPED_BIENCODER_OUT_DIM, SHIPPED_RERANKER)

    dev = "cuda"
    embedder = NeuralEmbedder(dim=SHIPPED_BIENCODER_OUT_DIM, config=SHIPPED_BIENCODER,
                              seed=0, device=dev)
    reranker = CrossEncoderReranker(config=SHIPPED_RERANKER, seed=1, q_len=32,
                                    d_len=216, device=dev)
    rng = np.random.default_rng(7)
    launches = {"K1": 0, "K2": 0, "K3": 0, "K3-ip": 0}
    tiers = {}
    for tier in ("bfloat16", "int8"):
        cfg = PipelineConfig(fused_rerank=True, semantic_dtype=tier)
        cfg.semantic_dim = SHIPPED_BIENCODER_OUT_DIM
        mgr = MultiIndexManager(cfg, embedder=embedder, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t = time.perf_counter()
        for s in range(0, len(texts), 8192):
            recs = [ChunkRecord(chunk_id=f"c{i}", doc_id=f"d{i // 4}", content=texts[i],
                                chunk_index=i % 4,
                                token_count=texts[i].count(" ") + 1)
                    for i in range(s, min(s + 8192, len(texts)))]
            rep = mgr.index_chunks(recs)
            if rep["indexed"] != len(recs) or rep["errors"]:
                raise AssertionError(f"ingest failed: {rep['errors'][:3]}")
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t
        log(f"main[{tier}]: ingested {mgr.store.n_valid()} chunks in {ingest_s:.2f}s "
            f"(capacity {mgr.store.capacity})")
        if mgr.semantic.capacity != MAIN_N or mgr.sparse.idx_t.shape[1] != MAIN_N:
            raise AssertionError(f"index capacity {mgr.semantic.capacity} is not "
                                 f"MAIN_N {MAIN_N}: phase 3 missed the path's shapes")
        per_batch = {}
        for nq in BATCHES:
            times = []
            for r in range(REPEATS):
                queries = snippet_queries(rng, texts, nq)
                t = time.perf_counter()
                out = mgr.fused_retrieve_batch_sync(queries, reranker=reranker, **SERVE)
                times.append((time.perf_counter() - t) * 1e3)
                if len(out) != nq or any(len(h) != SERVE["k_final"] for h in out):
                    raise AssertionError(f"Q={nq}: expected {SERVE['k_final']} hits per query")
                for hits in out:
                    for h in hits:
                        if not (np.isfinite(h["score"]) and np.isfinite(h["rerank_score"])):
                            raise AssertionError("non-finite score in results")
            timed = np.asarray(times[2:])
            per_batch[nq] = dict(p50_ms=float(np.percentile(timed, 50)),
                                 p99_ms=float(np.percentile(timed, 99)),
                                 mean_ms=float(timed.mean()))
            log(f"main[{tier}]: Q={nq}: p50 {per_batch[nq]['p50_ms']:.2f} ms, "
                f"p99 {per_batch[nq]['p99_ms']:.2f} ms per batch over {len(timed)} batches")
        for nq in (1, 32):
            prof = profile_batch(mgr, reranker, snippet_queries(rng, texts, nq))
            per_batch[nq]["profile"] = prof
            log(f"main[{tier}]: Q={nq} profiled: wall {prof['wall_ms']:.2f} ms, device busy "
                f"{prof['device_ms']:.2f} ms (idle share {prof['idle_share']:.3f}); "
                f"by group {prof['groups_ms']}; top {prof['top_ms']}")
        # a query made of a whole ingested chunk returns that chunk
        found = 0
        probes = rng.choice(np.arange(0, len(texts), PROBE_EVERY), size=8,
                            replace=False)
        out = mgr.fused_retrieve_batch_sync([texts[r] for r in probes],
                                            reranker=reranker, **SERVE)
        for r, hits in zip(probes, out):
            found += f"c{r}" in [h["chunk_id"] for h in hits]
        if found != len(probes):
            raise AssertionError(f"exact-chunk queries found {found}/{len(probes)}")
        counts = read_counters()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"main[{tier}]: exact-chunk queries found {found}/{len(probes)}; "
            f"launches {counts}; peak device memory {peak_gb:.2f} GB")
        dense_key = "K2" if tier == "int8" else "K1"
        if counts[dense_key] == 0 or counts["K3"] == 0:
            raise AssertionError(f"{tier} tier did not run {dense_key} and K3: {counts}")
        served = check_served_tensors(mgr, snippet_queries(rng, texts, 8))
        log(f"main[{tier}]: kernels on the served tensors (Q=8) against their plain "
            f"versions: " + ", ".join(f"{k} max_abs_err {e:.3g} (rel {r:.3g}), "
                                      f"ids differing at ties {sw}"
                                      for k, (e, r, sw) in served.items()))
        for k in launches:
            launches[k] += counts[k]
        tiers[tier] = dict(ingest_s=ingest_s, batches=per_batch, peak_gb=peak_gb,
                           launches=counts,
                           served_tensor_max_abs_err={k: v[0] for k, v in served.items()})
        mgr.close()
        del mgr
        torch.cuda.empty_cache()
    return launches, tiers


def phase_reference():
    """The card's fused path against the plain path on the CPU, same seeded
    weights and chunks, f32 model and f32 tier."""
    import dataclasses

    import torch

    from advanced_rag_tpu_torch.config import PipelineConfig
    from advanced_rag_tpu_torch.index.corpus import ChunkRecord
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.models.cross_encoder import CrossEncoderReranker
    from advanced_rag_tpu_torch.models.embedder import NeuralEmbedder
    from advanced_rag_tpu_torch.models.encoder import SHIPPED_BIENCODER, SHIPPED_RERANKER

    bi = dataclasses.replace(SHIPPED_BIENCODER, num_layers=2, dtype=torch.float32)
    ce = dataclasses.replace(SHIPPED_RERANKER, num_layers=2, dtype=torch.float32)
    texts = synthetic_corpus(512, seed=5)
    queries = [" ".join(t.split()[10:22]) for t in texts[:8]]
    ids = {}
    for dev in ("cuda", "cpu"):
        cfg = PipelineConfig(fused_rerank=True, semantic_dtype="float32")
        cfg.semantic_dim = 384
        emb = NeuralEmbedder(dim=384, config=bi, seed=3, device=dev)
        mgr = MultiIndexManager(cfg, embedder=emb, device=dev)
        mgr.index_chunks([ChunkRecord(chunk_id=f"r{i}", doc_id=f"r{i}", content=t)
                          for i, t in enumerate(texts)])
        rr = CrossEncoderReranker(config=ce, seed=4, device=dev)
        out = mgr.fused_retrieve_batch_sync(queries, reranker=rr, **SERVE)
        ids[dev] = [[h["chunk_id"] for h in hits] for hits in out]
    overlap = sum(len(set(a) & set(b)) for a, b in zip(ids["cuda"], ids["cpu"]))
    frac = overlap / sum(len(b) for b in ids["cpu"])
    same_top1 = sum(a[:1] == b[:1] for a, b in zip(ids["cuda"], ids["cpu"]))
    log(f"reference: card vs CPU plain path: top-{SERVE['k_final']} overlap {frac:.3f}, "
        f"top-1 equal {same_top1}/{len(queries)}")
    if frac < 0.9:
        raise AssertionError(f"card and CPU results disagree (overlap {frac:.3f})")


def main() -> None:
    name, count, smi = phase_device()
    phase_build()
    kernel_results = phase_kernels()
    t = time.perf_counter()
    texts = synthetic_corpus(N_CHUNKS, seed=11)
    log(f"corpus: {len(texts)} chunks of {WORDS_PER_CHUNK} words made in "
        f"{time.perf_counter() - t:.2f}s")
    launches, tiers = phase_main_path(texts)
    phase_reference()

    meta = {
        "K1": ("cuda", "advanced_rag_tpu/ops/pallas_dense.py:39"),
        "K2": ("cuda", "advanced_rag_tpu/ops/pallas_dense.py:61"),
        "K3": ("cuda", "advanced_rag_tpu/ops/pallas_sparse.py:43"),
        "K3-ip": ("cuda", "advanced_rag_tpu/ops/pallas_sparse.py:77"),
    }
    kernels = []
    for key, (route, replaces) in meta.items():
        cases = kernel_results[key]
        main = next(c for c in cases if c["main"])   # N = MAIN_N, Q = 32
        kernels.append({
            "name": key, "route": route,
            "source": "advanced_rag_tpu_torch/csrc/kernels.cu",
            "replaces": replaces, "launches": launches[key],
            "on_main_path": key != "K3-ip",   # K3-ip (scoring="ip") is off it
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            "cases": cases,
        })
    print(json.dumps({"kernels": kernels, "main_path": tiers, "nvidia_smi": smi}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()

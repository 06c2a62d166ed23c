#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (advanced_rag_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds:

1. device: the card's name, the device count and the nvidia-smi name and
   power limit; no CUDA device -> exit with an error, no result printed;
2. build: one nvcc compile per csrc/*.cu source, all started together,
   and one link (plain C ABI, ctypes);
3. kernels: K1 (dense scan, bf16 and f32 rows), K2 (SQ8 scan), K3 (BM25)
   and K3-ip, each against its plain PyTorch version at the main path's
   shapes (N = MAIN_N, Q = 1, 8 and 32; K1 and K2 also at N = 1M, and at
   N = MAIN_N with D = 4096, phase 13 (g)'s width, which K1 scans in
   slices of D): scores
   (f32, max |err| <= 1e-5 of the largest live score; K2's integer dot is
   exact, <= 1e-6) and tie-aware top-k ids; each kernel's time (device
   time: CUDA events around one CUDA-graph replay of 20 captured wrapper
   calls; beside it the time of a wrapper call from the host, CUDA events
   around 20 warmed calls), its bound on the card (the function's work:
   each input read once, each output written once, its own operations;
   for K3 one FMA per live slot and query, with the first port's
   compare-loop count beside it), the plain version's time and one
   library call computing the same function: torch.matmul (K1 bf16),
   torch.addmm (K1 f32), torch._int_mm (K2 at Q = 32; it takes more than
   16 query rows), torch.sparse.mm of the CSR tfw matrix [N, V] by the
   dense [V, Q] weight table (K3), torch.matmul of the bf16 table by a
   bf16 one-hot of the codes (K6);
4. main path, once on the bf16 tier and once on the SQ8 tier: a manager
   with fused_rerank at the shipped models' full geometry (6 x 256, 8
   heads, MLP 1024, 384-wide embeddings, random weights from a seeded
   torch.Generator) ingests N_CHUNKS (70,000) seeded synthetic chunks through
   index_chunks (every 1000th one a short probe chunk), then serves
   batches of Q = 1, 8 and 32 queries through fused_retrieve_batch_sync
   with the repo's measured serving knobs;
   launch counters are zeroed before and read after each tier; then K1
   or K2, and K3, are held against their plain versions once more on the
   tier's own index tensors, row mask and a batch of real queries;
5. reference: a small corpus served on the card and by the plain path on
   the CPU, with f32 weights and the f32 tier, must agree;
6. tiers: N_TIER (1M) clustered unit vectors of width 384 bulk-loaded into
   five DenseIndexes (bf16 + build_ivf, int8 + build_ivf with refine 2,
   dtype="pq" + build_pq with m 96, bits 4, refine 32, the same with
   pq_opq, and dtype="pq" + build_ivf, which builds IVF-PQ): build seconds,
   tune_nprobe(0.95) (IVF and IVF-PQ), search p50/p99 at Q = 1, 8, 32,
   recall@10 against the
   exact K1 scan of the f32 rows, peak device memory, memory_bytes, and the
   K5 / K6 launches, which must be > 0;
7. manager tiers: phase 4's bf16 manager after build_semantic(ivf=True)
   (run as soon as that tier's phase-4 numbers are read, so the SQ8 tier
   then runs alone, as before), and a semantic_dtype="pq" manager restored
   from phase 9 (b)'s checkpoint of phase 4's bf16 manager (the same chunks
   and embeddings) after build_semantic(pq=True) (after phase 4), each serving
   search_sync(SEMANTIC) and hybrid_search_batch_sync at Q = 1, 8, 32
   (BM25 from the inverted postings, built at the first call since the
   corpus is over 50k rows); last, the IVF, PQ, PQ-with-OPQ and PQ +
   IVF-PQ tiers on a small corpus, on the card and by the plain path on
   the CPU with the card's tier state, must agree (top-10 overlap >= 0.9);
8. service (after phases 4 and 7, with no other manager alive): the
   port's aiohttp app (create_app over AdvancedRAGPipeline, driven
   in-process through aiohttp's test server and client on a localhost
   socket; the phase fails if aiohttp is not installed) in both
   configurations the service starts in.  Fused: a bf16 manager of its
   own restored from that checkpoint (the same 70k chunks and embedder)
   and phase 4's cross-encoder; POST /ingest of SERVICE_DOCS seeded documents
   (diagnostics, chunking, enrichment, index_chunks, compliance), long
   enough that chunking splits each, then POST /retrieve from 1, 8 and 32
   concurrent clients (the orchestrator micro-batches them into
   fused_retrieve_batch_sync) and 8 probes, each a one-sentence
   document's text, which must come back in its top 10; K1 and K3 must
   run.  Default: a HashingEmbedder manager over the same 70k chunks,
   HybridRetriever micro-batching into hybrid_search_batch_sync; the same
   requests; K1 must run.  Every answer must be a 200 with results.
   Printed: /retrieve p50/p99 per concurrency against the 80 ms SLA,
   requests/s, /perf's stage p50s, ingest documents/s, launches.  Last,
   the pipeline on the card against the CPU plain path on a small corpus
   (fused f32 and int8 tiers, default f32 tier, seeded f32 weights):
   top-10 overlap >= 0.9;
9. the index lifecycle: (a) after phase 4, its bi-encoder and cross-encoder
   saved by the port's save_biencoder / save_reranker and loaded on the
   card: the probe texts' embeddings and CE scores must be bit-identical;
   (b) right after each phase-4 tier's measurements and phase 7's PQ tier,
   the manager saved by save_index and restored by load_index into a fresh
   one: the probes and a 32-query batch must answer with the same ids and
   scores (save / load seconds, the token table's re-tokenization, bytes);
   (d) in phase 8, after the load levels, on both apps: POST
   /admin/index/maintain, POST /admin/index/checkpoint (save) and a fresh
   app booted from RAG_CHECKPOINT_DIR (the fused one with RAG_EMBEDDER=ckpt:
   / RAG_RERANKER=ckpt: of (a)'s files), whose probes must answer with the
   saving app's chunk ids, its launches counted apart from phase 8's;
   (c) last, a default manager (HashingEmbedder,
   1536 wide) with the domain family (768 wide) over 70,000 chunks (phase
   4's and LIFECYCLE_MORE more of its generator; the IVF threshold lowered
   to their count for 9 (c) and (e)): hybrid search with
   domain_weight 0.2 at Q = 1 and 32, maintenance_tick's first IVF build
   with its recall guardrail, LIFECYCLE_TAIL more chunks and the rebuild,
   15% deleted and the postings compaction, each tick's actions and
   seconds; K1 (both families' rows) and K5 (the tier's own slabs, real
   probes) against their plain versions; then the manager saved and loaded
   into a fresh card manager and a CPU manager: the card's domain rung
   against the CPU plain path, top-10 overlap >= 0.9; the restored manager
   (given the original's IVF partitions and compacted postings, which
   checkpoints do not hold) must answer as the original; last the
   restart's own tick; (e) the PQ tier's lifecycle at the default width
   (1536, m = 384; phase_pq_lifecycle): a semantic_dtype="pq" manager and
   a semantic_opq=True one restored from (c)'s checkpoint, each ticked
   (PQ + IVF-PQ behind the guardrail; OPQ codes only), searched at Q = 1
   and 32, appended to and re-packed, saved and restored into a fresh card
   manager that must answer identically;
10. training, at the shipped geometry (phase_training): (a) the contrastive
   bi-encoder (train_biencoder, batch 128 of pre-tokenized pairs over
   20,000 of phase 4's chunks, 40 steps; ms per step, pairs/s, peak
   memory, loss), and two updates of one batch on the card against the
   same on the CPU in f32 and bf16; (b) hard negatives mined for 1,024 of
   the pairs through a bf16 manager over those chunks
   (hybrid_search_batch_sync: K1 and K3, whose launches must be > 0 and
   which are held against their plain versions on its tensors),
   filter_false_negatives, base scores from rescore_candidates_sync; (c)
   20 steps with the mined negatives; (d) the reranker (train_reranker,
   warm-started from (a), residual, label smoothing, early stopping), its
   dropout shown live and seeded; (e) distill_cross_encoder from (a)'s
   model; (f) the trained encoders saved, reloaded and served by a fused
   manager that must answer as one serving the in-memory models, and
   (a)'s model unchanged by (d) and (e).
11. the sharded paths (phase_sharded; run in the work block after phase 8,
   on phase 9 (b)'s bf16 checkpoint of phase 4's manager and (a)'s saved
   encoders in f32): (a) world size 1 under NCCL in this process: the
   mesh, pod mesh and train mesh; the sharded dense top-k (bf16 K1, SQ8
   K2), BM25 (K3), the fused hybrid on the scan, sq8 and pq (m 96, K6)
   rungs and the retrieve + rerank program at Q = 1, 8, 32, each against
   the port's unsharded function with the same knobs (ids exact where
   scores are distinct, sets within ties; scores within 1e-5 of the
   largest), their p50 ms, the merges' share, the projection's anchors,
   and one contrastive step pair on the (1, 1) train mesh against
   mesh=None; (b) SHARD_RANKS ranks on the card over Gloo (spawned), each
   reading its quarter of the checkpoint's rows: the same calls, the pod
   mesh (dcn 2) and tree_merge_topk, rank 0's answers against (a)'s; then
   each rank's quarter of phase 6's 1M rows through build_sharded_ivf
   (bf16, SQ8) and build_sharded_ivfpq (m 96 and SHARD_IVFPQ_M), searched
   at full probe against the exact sharded K1 scan (recall@10 >= 0.95,
   0.9; IVF-PQ's top 10 in depth 40 >= 0.9 at SHARD_IVFPQ_M), K5 and K6
   launched on every rank; (c) two ranks training at the shipped geometry
   in f32 on a (data 2, model 1) mesh and build_train_mesh(2)'s (data 1,
   model 2): two contrastive updates of one batch of TRAIN_BATCH pairs,
   one reranker and one distillation step, against one process on the
   card (PARITY_TOL's f32 bounds).  A rank that fails makes the run fail.
12. the host native code and the timers (phase_host_native, last): (a)
   the C++ text path against the Python rule (ADVANCED_RAG_TPU_NO_NATIVE=1)
   on the card's host: the g++ build's seconds, encode_documents over
   TEXT_PATH_CHUNKS (35,000) of phase 4's chunks and encode_queries at
   Q = 1, 8, 32 (arrays identical),
   the chunker and the diagnostics over phase 8's service documents
   (chunk ids equal, metrics within 1e-9), two fused pipelines ingesting
   them, a U+212A document (the Python rule's terms) and one fused Q = 1
   batch each way (ids and scores identical; encode_queries' share of
   the batch from the annotate ranges of a CPU profile); (b) the HNSW
   baseline (M 16, ef_construction 200, ef 64, every host core; recall 0.85 and
   self-query 0.95 at tests/test_hnsw_baseline.py's 5,000 x 48, a
   cached graph answering identically) against the exact bf16 (K1), SQ8
   (K2) and IVF bf16 (K5, tune_nprobe) tiers on HNSW_N clustered rows of
   scripts/bench_hnsw_parity.py: recall@10 against the f32 oracle (exact
   bf16 >= 0.99), bytes per row, build seconds, ms per query (HNSW single
   queries on the host, the tiers at Q = 8 through timing.fetch_ms and
   timing.scanned_ms); (c) timing.scanned_ms of K1 (bf16, N = MAIN_N,
   Q = 32) within 10% of graph_ms, chained_ms and fetch_ms at least the
   device time, and a profiling.device_trace of a fused Q = 8 batch
   naming the annotate ranges and K1's and K3's kernels.
13. the HF checkpoint models (phase_hf, after phase 12): (a) an embedder
   (BertModel) and a reranker (BertForSequenceClassification, one label)
   at MiniLM-L6's geometry (HF_GEOMETRY: 384 wide, 6 layers, 12 heads,
   FFN 1536, 512 positions, a 30,522-entry vocab.txt of BERT-uncased's
   layout holding phase 4's corpus words) written in HF format from
   seeded generators (config.json, tokenizer_config.json, a
   model.safetensors of this script's own writer); (b) HFEmbedder.encode
   and HFCrossEncoder.score_pairs on the card against the same classes
   with device="cpu" on HF_PARITY_TEXTS texts: f32 within HF_TOL, the
   bf16 distance recorded; (d) encode at HF_BATCH x 128 tokens and rerank
   HF_BATCH pairs at 256 tokens, f32 and bf16, whole call and forward;
   (c) a bf16-tier manager with the HF embedder ingests HF_CHUNKS of
   phase 4's chunks, and the port's app with RAG_RERANKER=hf: answers
   HF_REQUESTS /retrieve requests from 1 and from 8 clients: every answer
   a 200 with finite, reranked scores; then, after /admin/warmup puts the
   latency budgets in force, 8 clients again, the answers shed past the
   budgets counted; K1 and K3 launched (then held against their plain
   versions on the manager's tensors); (e) the other families at
   published geometries (HF_FAMILIES: a RoBERTa embedder with a
   vocab.json + merges.txt made here, an ELECTRA reranker, an XLM-R
   reranker with a 250,002-piece Unigram tokenizer.json, a DistilBERT
   embedder), each on the card against the CPU on HF_FAMILY_TEXTS texts
   or pairs (f32 within HF_TOL) and timed at HF_BATCH rows of each of
   HF_FAMILY_LENGTHS tokens, f32 and bf16; (f) HF_FAMILY_CHUNKS chunks on
   a RoBERTa embedder's bf16-tier manager, and the app with
   RAG_RERANKER=hf: on the ELECTRA reranker answering HF_FAMILY_REQUESTS
   /retrieve requests from 1 client, as (c); peak memory; (g) the
   decoder-only embedders (phase_hf_decoders) at
   e5-mistral-7b-instruct's geometry (HF_DECODER: 4096 wide, FFN 14336,
   32 heads, 8 KV heads, window 4096): (i) a checkpoint of its width at
   HF_DECODER_WRITTEN layers with a 32,000-piece byte-fallback
   tokenizer.json made here, HFEmbedder on the card against the CPU (f32
   within HF_TOL, bf16 recorded); (ii) the 32-layer model built on the
   card from a seeded generator, bf16 (f32 at HF_DECODER_F32_LAYERS
   layers), forward and encode_device at HF_BATCH x 128 tokens and one
   query's encode; (iii) that bf16 embedder's manager ingests
   HF_DECODER_CHUNKS chunks and the app with RAG_RERANKER=hf: on (e)'s
   ELECTRA reranker answers HF_DECODER_REQUESTS /retrieve requests from 1
   client, as (c), K1 at D = 4096 (two slices a query batch) and K3
   launched and held against their plain versions; (iv) gemma-2b's width
   (HF_GEMMA: MQA, head_dim 256, 256,000 pieces) at HF_DECODER_WRITTEN
   layers, card against CPU; (v) the peak memory; (h) the second group
   of encoder families (phase_hf_more) at published widths
   (bigbird-roberta-base: block_sparse, block 64, 3 random blocks, 50,358
   Unigram pieces; albert-base-v2: 12 layers in one shared group, a
   30,000-piece Unigram tokenizer.json with NFKD / StripAccents;
   roformer_chinese_base; efficient_mlm_m0.40's RoBERTa-PreLayerNorm,
   1024 wide): (i) each at its written layers on the card against the
   CPU (f32 within HF_TOL; BigBird at 512 tokens, eight blocks); (ii) the
   12-layer BigBird built on the card, bf16 (f32 at 4 layers), forward and
   encode_device at 32 x 1024 and 8 x 4096 tokens, its share of the bf16
   peak, one bf16 forward profiled by kernel group; (iii) that bf16
   embedder at 1024 tokens behind a bf16-tier manager over 2,000 chunks,
   served with RAG_RERANKER=hf: on the albert-base-v2-width reranker, 32
   /retrieve requests from 1 client, K1 and K3 launched and held against
   their plain versions; (iv) the peak memory; (i) the encoder-decoder
   embedders (phase_hf_encdec) at published widths (HF_ENCDEC: bart-large,
   mbart-large-cc25, pegasus-large, opus-mt-en-de, blenderbot-400M-distill,
   blenderbot_small-90M, each with its tokenizer made here; BART, mBART,
   Pegasus and Blenderbot written at 2 + 2 layers): (i) each on the card
   against the CPU at 128 tokens (f32 within HF_TOL, bf16 recorded); (ii)
   each built on the card at its published depth in bf16 (f32 at 2 + 2
   layers), forward and encode_device at 64 x 128 tokens; (iii) a 12 +
   12-layer bart-large
   embedder in bf16 behind a 1024-wide bf16-tier manager over 5,000
   chunks, served with RAG_RERANKER=hf: on (e)'s ELECTRA reranker, 32
   /retrieve requests from 1 client, every answer a 200, K1 and K3
   launched and held against their plain versions; (iv) the peak memory;
   (j) the GPT-family embedders (phase_hf_gpt) at published widths
   (HF_GPT: gpt2, gpt-sw3-126m, gpt-neo-125m, gpt-j-6b, bloom-560m,
   xglm-564M, each with its tokenizer made here from phase 4's words):
   (i) each written at 2 layers (GPT-Neo one global and one local) on the
   card against the CPU (f32 within HF_TOL, bf16 recorded; GPT-Neo at 512
   tokens on texts past its window of 256); (ii) each built on the card
   at its published depth, f32 (not GPT-J's 28 layers) and bf16, forward
   and encode_device at 64 x 128 tokens, one GPT-J query's encode; (iii)
   the 12-layer bf16 gpt-neo-125m embedder behind a 768-wide bf16-tier
   manager over 5,000 chunks, served with RAG_RERANKER=hf: on (e)'s
   ELECTRA reranker, 32 /retrieve requests from 1 client, every answer a
   200, K1 and K3 launched and held against their plain versions; (iv)
   the peak memory.

Phase 3 also holds K5 (bf16 and SQ8 slabs, Q = 1, 8, 32, at the 1M-row
geometry and the manager's, random probe lists; for the route rule both
routes, streaming and grouped, on the manager's slabs at Q = 1, 2, 4, 8,
12, 16 and 32 (bf16) and 8, 12, 16, 32 (SQ8), and on the 1M geometry's
bf16 and SQ8 slabs at the (nprobe, Q) of CROSS_1M; f32 slabs, which only
stream, at the manager's geometry, Q = 8 and 32;
beside each case its unique probed slabs, the bounds with each slab read
once per batch and once per (query, probe), and the flat superset: one
torch.matmul / torch._int_mm of the queries by every slab row), K4
(Q = 1) and K6 (N = 1M and the PQ manager's N, m 96; at N = 1M also both
of K6's kernels, lookup and one-hot, at Q = 1, 2, 4, 8, 9, 16 and 32 for
the crossover; at phase 9 (e)'s N = 131072, m = 384, where the one-hot
kernel runs in groups of subspaces, Q = 1, 8 and 32 through both kernels)
against their plain versions: K5-SQ8 bit-identical, the others within
1e-5 of the largest score.  Phases 6 and 7 add K5 cases on real probes
through both routes: each IVF tier's own slabs and the probe lists that
32 of its queries get at the tier's nprobe; phases 6 and 9 (e) add K6
cases on the codes of the partitions that real queries probe on the
IVF-PQ tiers.

Then one JSON line {"kernels": [...]} and, last, the device line
{"ok": true, "device": {...}}.  Any failed check raises, so the run exits
non-zero and prints no result.  Phase 8's server listens on localhost
only and stops, with its worker threads, before the phase ends.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

T0 = time.perf_counter()
#: git-ignored scratch space in the checkout: checkpoints, the service's
#: chat databases
BUILD_DIR = Path(os.path.dirname(os.path.abspath(__file__))) / "build"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
L2_BYTES = 50 * 2**20          # H100 SXM L2
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12       # int8 tensor-core peak

#: phase 4's corpus (100,000 until phase 13 (g) came, cut to keep the
#: script within its 1200-second limit; still past 65,536, so MAIN_N holds)
N_CHUNKS = 70_000
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
#: IVF geometry (nlist, cap, nprobe): the 1M-row tier (auto_nlist(1M) = 1000,
#: cap = 2 * N / nlist rounded up to 8) and the manager phase's tier over
#: N_CHUNKS rows (auto_nlist(70,000) = 264)
IVF_1M = (1000, 2000, 32)
IVF_MANAGER = (264, 536, 32)
#: (nprobe, Q) that phase 3 runs through both K5 routes at the 1M geometry,
#: for the route rule: phase 6 serves at its tuned nprobe (8)
CROSS_1M = ((32, 8), (32, 16), (32, 32), (8, 16), (8, 32), (8, 64))
N_TIER = 1_000_000             # phase 6: rows of the 1M-row tiers
N_CENTRES = 2000
PQ_M = 96
#: (N, m) of phase 9 (e)'s PQ codes: the capacity of its 90,000 rows and
#: auto_pq_m(1536), the default embedder's width at bits 4
PQ_WIDE = (131_072, 384)
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


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms per call of ``fn``: one CUDA-graph replay of ``reps``
    captured calls between two events, so the host's launch overhead (the
    wrapper's checks and allocation, ctypes) is not in it; ``cuda_ms`` of
    the same call keeps that overhead."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
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
    compiles, link = _build.nvcc_commands(_build.find_nvcc(), path, path.parent / "obj")
    for cmd in compiles + [link]:
        log(f"build: {' '.join(cmd)}")
    nvcc_s = _build.last_build_seconds
    log(f"build: nvcc {'not run (library cached)' if nvcc_s is None else f'{nvcc_s:.2f}s'}, "
        f"{time.perf_counter() - t:.2f}s with loading")


def log_case(key, case):
    lib, lib_call = case["library_ms"], case.get("library_call_ms")
    log(f"kernels: {key} {case['shape']}: max_abs_err {case['max_abs_err']:.3g} "
        f"(rel {case['rel_err']:.3g}), ids differing at ties "
        f"{case['tie_swaps']}, {case['ms']:.4f} ms ({case['call_ms']:.4f} a wrapper "
        f"call), bound {case['bound_ms']:.4f} ms ({case['bound_by']}), plain "
        + ("-" if case["plain_ms"] is None else f"{case['plain_ms']:.4f} ms")
        + ", library "
        + ("none" if lib is None else f"{lib:.4f} ms ({lib_call:.4f} a call)")
        + ("" if "unique_slabs" not in case else
           f"; {case['probes']} probes, unique slabs {case['unique_slabs']}, streamed "
           f"bound {case['streamed_bound_ms']:.4f} ms, flat superset "
           + ("-" if case["flat_superset_ms"] is None
              else f"{case['flat_superset_ms']:.4f} ms")))


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
        log_case(key, case)

    # K1: bf16 rows at the main path's N and at N = 1M, f32 rows at
    # N = 100k; D = 384; and bf16 rows at the main path's N and D = 4096
    # (a 7B decoder embedder's width, scanned in slices of D)
    for dtype, n, batches, d in ((torch.bfloat16, MAIN_N, BATCHES, 384),
                                 (torch.bfloat16, 1_000_000, (1, 32), 384),
                                 (torch.float32, 100_000, (1, 32), 384),
                                 (torch.bfloat16, MAIN_N, BATCHES, HF_DECODER_D)):
        rows = l2_normalize(torch.randn(n, d, generator=gen, device=dev)).to(dtype)
        m = third_masked(n)
        for nq in batches:
            q = l2_normalize(torch.randn(nq, d, generator=gen, device=dev)).contiguous()
            got = dk.dense_scores(q, rows, m)
            want = dk.dense_scores_plain(q, rows, m)
            err, rel, swaps = compare(got, want, 1e-5)
            ms = graph_ms(lambda: dk.dense_scores(q, rows, m))
            call_ms = cuda_ms(lambda: dk.dense_scores(q, rows, m))
            plain_ms = cuda_ms(lambda: dk.dense_scores_plain(q, rows, m), reps=5)
            if dtype == torch.bfloat16:
                qb = q.to(torch.bfloat16)
                lib = lambda: torch.matmul(qb, rows.T)  # noqa: E731
            else:
                lib = lambda: torch.addmm(m[None, :], q, rows.T)  # noqa: E731
            lib_ms, lib_call_ms = graph_ms(lib), cuda_ms(lib)
            if dtype == torch.bfloat16:    # hi, mid, lo query parts: three bf16 passes
                ops, rate = 3 * 2.0 * nq * n * d, BF16_OPS_PER_S
            else:
                ops, rate = 2.0 * nq * n * d, F32_OPS_PER_S
            b_ms, b_by = bound(n * d * rows.element_size() + nq * d * 4 + n * 4
                               + nq * n * 4, ops, rate)
            record("K1", dict(shape=f"{str(dtype)[6:]} rows N={n} D={d} Q={nq}",
                              main=dtype == torch.bfloat16 and (n, nq, d) == (MAIN_N, 32, 384),
                              launches_per_call=len(dk.scan_launches(
                                  "bf16" if dtype == torch.bfloat16 else "f32", nq, d)),
                              max_abs_err=err, rel_err=rel, tie_swaps=swaps,
                              ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                              library_call_ms=lib_call_ms, bound_ms=b_ms, bound_by=b_by))
        del rows

    # K2: SQ8 codes at the main path's N and at N = 1M, D = 384, and at the
    # main path's N at D = 4096 (32 queries a launch fit whole)
    for n, batches, d in ((MAIN_N, BATCHES, 384), (1_000_000, (1, 32), 384),
                          (MAIN_N, (1, 32), HF_DECODER_D)):
        codes, scale = sq8_quantize(l2_normalize(torch.randn(n, d, generator=gen,
                                                             device=dev)))
        m = third_masked(n)
        for nq in batches:
            q_codes, _ = sq8_quantize(l2_normalize(torch.randn(nq, d, generator=gen,
                                                           device=dev)))
            got = dk.sq8_scores(q_codes, codes, scale, m)
            want = dk.sq8_scores_plain(q_codes, codes, scale, m)
            err, rel, swaps = compare(got, want, 1e-6)
            ms = graph_ms(lambda: dk.sq8_scores(q_codes, codes, scale, m))
            call_ms = cuda_ms(lambda: dk.sq8_scores(q_codes, codes, scale, m))
            plain_ms = cuda_ms(lambda: dk.sq8_scores_plain(q_codes, codes, scale, m),
                               reps=5)
            if nq > 16:     # the int8 x int8 -> int32 product, without scale and mask
                lib = lambda: torch._int_mm(q_codes, codes.T)  # noqa: E731
                lib_ms, lib_call_ms = graph_ms(lib), cuda_ms(lib)
            else:
                lib_ms = lib_call_ms = None
                log(f"kernels: K2 Q={nq}: no library time, torch._int_mm takes "
                    "more than 16 rows")
            b_ms, b_by = bound(n * d + nq * d + n * 8 + nq * n * 4,
                               2.0 * nq * n * d, INT8_OPS_PER_S)
            record("K2", dict(shape=f"int8 codes N={n} D={d} Q={nq}",
                              main=(n, nq, d) == (MAIN_N, 32, 384), max_abs_err=err,
                              rel_err=rel, tie_swaps=swaps, ms=ms, call_ms=call_ms,
                              plain_ms=plain_ms, library_ms=lib_ms,
                              library_call_ms=lib_call_ms, bound_ms=b_ms, bound_by=b_by))
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
    tf_t = torch.from_numpy(np.ascontiguousarray(tf.T)).to(torch.bfloat16).to(dev)
    dlen = torch.from_numpy(tf.sum(1).astype(np.float32)).to(dev)
    avg_len = float(dlen.mean())
    m = third_masked(n)
    live_slots = int((idx >= 0).sum())
    csr_cols = torch.from_numpy(idx.astype(np.int64)).to(dev)           # [N, P]
    for scoring, key in (("bm25", "K3"), ("ip", "K3-ip")):
        # the library's operands, built outside the timed region: the CSR
        # matrix [N, V] of each row's tfw (coalesced: a row's repeated id
        # sums its slots, as the scan does)
        tfw = sk.slot_weights(idx_t, tf_t, dlen, 1.2, 0.75, avg_len, scoring).T  # [N, P]
        live_rc = csr_cols >= 0
        rows_rc = torch.arange(n, device=dev)[:, None].expand(n, p)[live_rc]
        csr = torch.sparse_coo_tensor(
            torch.stack([rows_rc, csr_cols[live_rc]]), tfw[live_rc],
            (n, vocab), check_invariants=False).coalesce().to_sparse_csr()
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
            ms = graph_ms(lambda: sk.bm25_scores(*args))
            call_ms = cuda_ms(lambda: sk.bm25_scores(*args))
            plain_ms = cuda_ms(lambda: sk.bm25_scores_plain(*args), reps=2, warmup=1)
            # the dense [V, Q] table of t-order weight sums; cuSPARSE SpMM
            # gives [N, Q] without the mask: the easier function
            ids, w = sk.bm25_query_table(qi, qw)
            wd = torch.zeros((vocab, nq), dtype=torch.float32, device=dev)
            wd[ids.long()] = w
            lib = lambda: torch.sparse.mm(csr, wd)  # noqa: E731
            lib_ms, lib_call_ms = graph_ms(lib), cuda_ms(lib)
            # the function's work: every input read once, the output written
            # once, one FMA per (live slot, query); the first port's compare
            # loop did live slots x live query terms
            b_ms, b_by = bound(p * n * 6 + n * 8 + nq * t * 8 + nq * n * 4,
                               2.0 * live_slots * nq, F32_OPS_PER_S)
            cmp_ms, cmp_by = bound(p * n * 6 + n * 8 + nq * t * 8 + nq * n * 4,
                                   2.0 * live_slots * int(q_live.sum()), F32_OPS_PER_S)
            record(key, dict(shape=f"N={n} P={p} T={t} Q={nq}", main=nq == 32,
                             max_abs_err=err,
                             rel_err=rel, tie_swaps=swaps, ms=ms, call_ms=call_ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             library_call_ms=lib_call_ms,
                             library="torch.sparse.mm [N, V] CSR x [V, Q]",
                             bound_ms=b_ms, bound_by=b_by,
                             compare_loop_bound_ms=cmp_ms, compare_loop_bound_by=cmp_by))
        del csr
    del idx_t, tf_t, csr_cols
    torch.cuda.empty_cache()
    ivf_pq_kernel_cases(gen, dev, record)
    return results


def k5_case(probes, q_in, packed, scale, route, store=None, kind="random",
            single=False):
    """K5 (K4 when ``single``) through ``route`` against its plain version
    on these inputs: SQ8 bit-identical, bf16 within 1e-5 of the
    largest score.  Device ms (CUDA-graph replay) and a wrapper call's ms,
    the bound with each probed slab read once per batch (unique slabs) and
    streamed once per (query, probe) as the TPU kernel reads them, and, given
    ``store`` (the slabs as one [nlist * cap, D] matrix), the flat superset:
    one torch.matmul of the bf16 queries by every slab row (torch._int_mm of
    the int8 codes, which takes more than 16 query rows), more work than K5
    does, which tells whether the tier's kernel beats scanning everything
    (f32 slabs: an f32 torch.matmul)."""
    import torch

    from advanced_rag_tpu_torch.ops import ivf_kernels as ik

    nq, nprobe = probes.shape
    nlist, cap, d = packed.shape
    sq8 = packed.dtype == torch.int8
    name = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8"}[packed.dtype]

    def fn():
        return ik.ivf_scores_by(probes, q_in, packed, scale, route, single=single)

    got = fn()
    want = ik.ivf_scores_plain(probes, q_in, packed, scale)
    if sq8 and not torch.equal(got, want):
        raise AssertionError(f"K5 ({route}) on SQ8 slabs is not bit-identical")
    err, rel, swaps = compare(got.reshape(nq, -1), want.reshape(nq, -1),
                              1e-6 if sq8 else 1e-5)
    plain_ms = cuda_ms(lambda: ik.ivf_scores_plain(probes, q_in, packed, scale),
                       reps=3, warmup=1)
    item = packed.element_size()
    slab_b = cap * d * item + (cap * 4 if sq8 else 0)
    out_b = nq * nprobe * cap * 4 + nq * d * item + nq * nprobe * 4
    ops = 2.0 * nq * nprobe * cap * d
    ops, rate = ((ops, INT8_OPS_PER_S) if sq8 else (2 * ops, BF16_OPS_PER_S)
                 if packed.dtype == torch.bfloat16 else (ops, F32_OPS_PER_S))
    # each input byte counted once: a slab probed by several queries of the
    # batch is read once; the TPU kernel streams it once per (query, probe)
    uniq = int(torch.unique(probes).numel())
    b_ms, b_by = bound(uniq * slab_b + out_b, ops, rate)
    streamed_ms = (nq * nprobe * slab_b + out_b) / HBM_BYTES_PER_S * 1e3
    flat_ms = None
    if store is not None and (not sq8 or nq > 16):
        if sq8:
            flat = lambda: torch._int_mm(q_in, store.T)  # noqa: E731
        else:
            qb = q_in.to(store.dtype)
            flat = lambda: torch.matmul(qb, store.T)  # noqa: E731
        flat_ms = graph_ms(flat)
    return dict(
        shape=f"{name} nlist={nlist} cap={cap} D={d} "
              f"nprobe={nprobe} Q={nq} ({route})",
        route=route, main=False, max_abs_err=err, rel_err=rel, tie_swaps=swaps,
        ms=graph_ms(fn), call_ms=cuda_ms(fn), plain_ms=plain_ms, library_ms=None,
        library="none: no single PyTorch call gathers each query's own probed slabs",
        bound_ms=b_ms, bound_by=b_by, streamed_bound_ms=streamed_ms, unique_slabs=uniq,
        flat_superset_ms=flat_ms, probes=kind)


def ivf_pq_kernel_cases(gen, dev, record):
    """K5 (bf16 and SQ8 slabs) at the 1M-row IVF geometry and at the manager
    phase's, with random probe lists (``randperm``: they share the least);
    both of K5's routes (for the route rule) on the manager geometry and at
    CROSS_1M on the 1M one; f32 slabs (streaming only) on the manager's; K4
    at Q = 1, K6 at N = 1M and at the PQ manager's N."""
    import torch

    from advanced_rag_tpu_torch.ops import ivf_kernels as ik
    from advanced_rag_tpu_torch.ops import pq_kernels as pk
    from advanced_rag_tpu_torch.ops.dense import l2_normalize
    from advanced_rag_tpu_torch.ops.pq import pq_scores_xla
    from advanced_rag_tpu_torch.ops.quant import sq8_quantize

    d = 384

    def slabs(nlist, cap, dtype):
        """Unit rows, about a fifth of the slots padding (zero rows)."""
        x = l2_normalize(torch.randn(nlist * cap, d, generator=gen, device=dev))
        live = (torch.rand(nlist * cap, generator=gen, device=dev) < 0.8).float()
        x = x * live[:, None]
        if dtype == torch.int8:
            codes, scale = sq8_quantize(x)
            return (codes.reshape(nlist, cap, d).contiguous(),
                    (scale * live).reshape(nlist, cap).contiguous())
        return x.to(dtype).reshape(nlist, cap, d).contiguous(), None

    cases = ((IVF_1M, torch.bfloat16, BATCHES), (IVF_1M, torch.int8, BATCHES),
             (IVF_MANAGER, torch.bfloat16, (1, 2, 4, 8, 12, 16, 32)),
             (IVF_MANAGER, torch.int8, (8, 12, 16, 32)),
             (IVF_MANAGER, torch.float32, (8, 32)))
    for (nlist, cap, nprobe0), dtype, batches in cases:
        packed, scale = slabs(nlist, cap, dtype)
        store = packed.reshape(nlist * cap, d)
        sq8 = dtype == torch.int8
        manager = nlist == IVF_MANAGER[0]
        # (nprobe, Q, both routes): the manager's batches through both, the
        # 1M batches through the route ivf_scores takes, then CROSS_1M
        # through both; f32 slabs have one route, streaming
        runs = [(nprobe0, nq, manager and dtype in ik.GROUPED) for nq in batches]
        if not manager:
            runs += [(npb, nq, True) for npb, nq in CROSS_1M]
        for nprobe, nq, both in runs:
            q = l2_normalize(torch.randn(nq, d, generator=gen, device=dev)).contiguous()
            q_in = sq8_quantize(q)[0].contiguous() if sq8 else q
            probes = torch.stack([torch.randperm(nlist, generator=gen, device=dev)[:nprobe]
                                  for _ in range(nq)]).to(torch.int32).contiguous()
            # the route ivf_scores takes, with the flat superset beside it
            auto = ik.ivf_route(nq, nprobe, nlist, cap, dtype, d)
            for route in ("stream", "grouped") if both else (auto,):
                case = k5_case(probes, q_in, packed, scale, route,
                               store if route == auto else None)
                case["main"] = (manager and dtype == torch.bfloat16 and nq == 32
                                and route == auto)
                record(f"K5-{route}" if both else "K5", case)
            if nq == 1 and dtype == torch.bfloat16 and not manager:
                case = k5_case(probes, q_in, packed, scale, "stream", single=True)
                case["main"] = True
                record("K4", case)
        del packed, scale, store
        torch.cuda.empty_cache()

    c = 16
    for n, m, batches in ((N_TIER, PQ_M, BATCHES), (MAIN_N, PQ_M, (32,)),
                          (*PQ_WIDE, BATCHES)):
        codes = torch.randint(0, c, (n, m), generator=gen, device=dev).to(torch.int8)
        # the library's operand: the bf16 one-hot [m * c, N] of the codes
        onehot = torch.nn.functional.one_hot(codes.long(), c).to(torch.bfloat16)
        onehot = onehot.reshape(n, m * c).T.contiguous()
        for nq in batches:
            lut = torch.randn(nq, m, c, generator=gen, device=dev) * 0.05
            want = pq_scores_xla(codes, lut)
            lut_b = lut.to(torch.bfloat16).reshape(nq, m * c)
            lib = lambda: torch.matmul(lut_b, onehot)  # noqa: E731
            lib_ms, lib_call_ms = graph_ms(lib), cuda_ms(lib)
            plain_ms = cuda_ms(lambda: pq_scores_xla(codes, lut), reps=3, warmup=1)
            b_ms, b_by = bound(n * m + nq * n * 4 + nq * m * c * 2, 1.0 * nq * n * m,
                               F32_OPS_PER_S)
            # pq_scores (the kernel pq_kernel_for picks), and at N = 1M and
            # at the default width both kernels (at m = 384 the one-hot
            # kernel takes its subspaces in groups, one launch a group)
            kernels = [None] + (["lookup", "onehot"] if (n, m) != (MAIN_N, PQ_M) else [])
            for kernel in kernels:
                fn = ((lambda: pk.pq_scores(codes, lut)) if kernel is None else
                      (lambda k=kernel: pk.pq_scores_by(codes, lut, k)))
                err, rel, swaps = compare(fn(), want, 1e-5)
                run = kernel or pk.pq_kernel_for(nq)
                n_launch = len(pk.pq_plan(nq, m, c, kernel))
                record("K6" if kernel is None else "K6-" + kernel, dict(
                    shape=f"N={n} m={m} c={c} Q={nq} ({run}, {n_launch} launches)",
                    kernel=run, launches_per_call=n_launch,
                    main=kernel is None and (n, m, nq) == (MAIN_N, PQ_M, 32),
                    max_abs_err=err,
                    rel_err=rel, tie_swaps=swaps, ms=graph_ms(fn), call_ms=cuda_ms(fn),
                    plain_ms=plain_ms, library_ms=lib_ms, library_call_ms=lib_call_ms,
                    library="torch.matmul bf16 [Q, m*c] x one-hot [m*c, N] -> bf16",
                    bound_ms=b_ms, bound_by=b_by, lookups=nq * n * m))
        if n == N_TIER:     # the crossover: more Q through both kernels
            for nq in (2, 4, pk.LOOKUP_MAX_Q + 1, 16):
                lut = torch.randn(nq, m, c, generator=gen, device=dev) * 0.05
                want = pq_scores_xla(codes, lut)
                b_ms, b_by = bound(n * m + nq * n * 4 + nq * m * c * 2, 1.0 * nq * n * m,
                                   F32_OPS_PER_S)
                for kernel in ("lookup", "onehot"):
                    fn = lambda k=kernel: pk.pq_scores_by(codes, lut, k)  # noqa: E731
                    err, rel, swaps = compare(fn(), want, 1e-5)
                    record("K6-" + kernel, dict(
                        shape=f"N={n} m={m} c={c} Q={nq} ({kernel})", kernel=kernel,
                        main=False, max_abs_err=err, rel_err=rel, tie_swaps=swaps,
                        ms=graph_ms(fn), call_ms=cuda_ms(fn), plain_ms=None,
                        library_ms=None, bound_ms=b_ms, bound_by=b_by))
        del codes, onehot
        torch.cuda.empty_cache()


def zipf_vocab(rng):
    """30,000 random lowercase words and their Zipf weights, from ``rng``."""
    import numpy as np

    vocab_n = 30_000
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    lens = rng.integers(3, 11, size=vocab_n)
    pool = letters[rng.integers(0, 26, size=(vocab_n, 10))]
    vocab = np.array(["".join(pool[i, :lens[i]]) for i in range(vocab_n)])
    p = 1.0 / (np.arange(vocab_n) + 20.0)
    return vocab, p / p.sum()


def synthetic_corpus(n: int, seed: int):
    """n chunks of WORDS_PER_CHUNK words from a seeded Zipf vocabulary."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab, p = zipf_vocab(rng)
    words = vocab[rng.choice(len(vocab), size=(n, WORDS_PER_CHUNK), p=p)]
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


def device_events(prof):
    """The profile's kernels and copies on the card: its CUDA events less the
    GPU spans of ``profiling.annotate`` ranges, which cover kernels rather
    than add to them."""
    import torch

    events = prof.events()
    ranges = {ev.name for ev in events if getattr(ev, "is_user_annotation", False)}
    return [ev for ev in events
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.name not in ranges]


def profile_batch(mgr, reranker, queries):
    """One batch under torch.profiler (profile_call)."""
    return profile_call(lambda: mgr.fused_retrieve_batch_sync(
        queries, reranker=reranker, **SERVE))


def profile_call(fn, kernel_groups=KERNEL_GROUPS):
    """One call of ``fn`` under torch.profiler: wall time, device busy time
    (the sum of the kernels' device time; one stream, so they do not
    overlap), the idle share, device time by kernel group and the top
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = {}
    for ev in device_events(prof):
        kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    if not kernels:
        raise AssertionError("the profiler recorded no device kernels")
    groups = {name: 0.0 for name, _ in kernel_groups}
    groups["other"] = 0.0
    for name, ms in kernels.items():
        low = name.lower()
        key = next((g for g, pats in kernel_groups if any(p in low for p in pats)),
                   "other")
        groups[key] += ms
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                idle_share=max(0.0, 1.0 - device_ms / wall_ms),
                n_kernels=len(kernels),
                groups_ms={k: round(v, 3) for k, v in groups.items()},
                top_ms={k[:60]: round(v, 3) for k, v in top})


KERNEL_KEYS = ("K1", "K2", "K3", "K3-ip", "K4", "K5", "K6")


def reset_counters():
    from advanced_rag_tpu_torch.ops import dense_kernels as dk
    from advanced_rag_tpu_torch.ops import ivf_kernels as ik
    from advanced_rag_tpu_torch.ops import pq_kernels as pk
    from advanced_rag_tpu_torch.ops import sparse_kernels as sk

    dk.dense_scores.launches = 0
    dk.sq8_scores.launches = 0
    sk.bm25_scores.launches = 0
    sk.bm25_scores.ip_launches = 0
    ik.ivf_scores.launches = 0
    ik.ivf_scores.k4_launches = 0
    ik.ivf_scores.grouped_launches = 0
    pk.pq_scores.launches = 0


def read_counters():
    from advanced_rag_tpu_torch.ops import dense_kernels as dk
    from advanced_rag_tpu_torch.ops import ivf_kernels as ik
    from advanced_rag_tpu_torch.ops import pq_kernels as pk
    from advanced_rag_tpu_torch.ops import sparse_kernels as sk

    ip = sk.bm25_scores.ip_launches
    k4 = ik.ivf_scores.k4_launches
    return {"K1": dk.dense_scores.launches, "K2": dk.sq8_scores.launches,
            "K3": sk.bm25_scores.launches - ip, "K3-ip": ip,
            "K4": k4, "K5": ik.ivf_scores.launches - k4,
            "K5-grouped": ik.ivf_scores.grouped_launches,
            "K6": pk.pq_scores.launches}


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


def phase_main_path(texts, after_bf16, work):
    """Phase 4; once a tier's measurements are read, phase 9 (b) saves its
    manager and restores it into a fresh one (``index_round_trip``), then
    ``after_bf16(mgr)`` runs on the bf16 tier's manager (phase 7 builds the
    IVF tier on it); the manager is closed before the SQ8 tier starts, so
    each tier's numbers are taken with no other manager alive.  The bf16
    tier's checkpoint stays under ``work``/index-bf16, where phases 7 and 8
    restore their managers from.  Returns the launches, the tiers' records
    (each with its round trip under "lifecycle"), the embedder and the
    cross-encoder."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.config import PipelineConfig
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
    launches = dict.fromkeys(KERNEL_KEYS, 0)
    tiers = {}
    for tier in ("bfloat16", "int8"):
        cfg = PipelineConfig(fused_rerank=True, semantic_dtype=tier)
        cfg.semantic_dim = SHIPPED_BIENCODER_OUT_DIM
        mgr = MultiIndexManager(cfg, embedder=embedder, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t = time.perf_counter()
        ingest_all(mgr, texts)
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
        tiers[tier]["lifecycle"] = index_round_trip(
            f"index {tier}", mgr, MultiIndexManager(cfg, embedder=embedder, device=dev),
            fused_answers(reranker, lifecycle_queries(np.random.default_rng(47), texts)),
            work / f"index-{tier}", keep=tier == "bfloat16")
        if tier == "bfloat16":
            after_bf16(mgr)
        mgr.close()
        del mgr
        torch.cuda.empty_cache()
    return launches, tiers, embedder, reranker


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


def clustered_vectors(n: int, n_queries: int, seed: int):
    """n unit vectors of width 384 around N_CENTRES Gaussian centres, plus
    n_queries held-out vectors of the same mixture with extra noise (the
    queries), from a seeded numpy generator.  The centres sit in groups of
    ten around N_CENTRES / 10 group centres, closer to each other (offset
    norm 0.15) than the rows to their centre (noise norm ~0.78), so a group
    is one blob of ~5000 rows that k-means splits over several lists and a
    query's neighbours span lists: nprobe has to grow for recall (a plain
    2000-blob mixture puts each blob in one list and is served at nprobe 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = 384
    groups = rng.standard_normal((N_CENTRES // 10, d), dtype=np.float32)
    groups /= np.linalg.norm(groups, axis=1, keepdims=True)
    centres = groups[np.arange(N_CENTRES) // 10] + 0.15 * rng.standard_normal(
        (N_CENTRES, d), dtype=np.float32) / np.sqrt(d)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    x = np.empty((n + n_queries, d), np.float32)
    for s in range(0, n + n_queries, 200_000):
        e = min(s + 200_000, n + n_queries)
        x[s:e] = centres[rng.integers(0, N_CENTRES, e - s)]
        x[s:e] += rng.standard_normal((e - s, d), dtype=np.float32) * 0.04
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[n:] + rng.standard_normal((n_queries, d), dtype=np.float32) * 0.02
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x[:n], q


def time_calls(fn, batches, reps=REPEATS):
    """p50/p99 ms of fn(nq) per batch size, host clock around calls that end
    in a device->host copy or a synchronize; the first 2 calls are warm-up."""
    import numpy as np
    import torch

    out = {}
    for nq in batches:
        times = []
        for r in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(nq, r)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        timed = np.asarray(times[2:])
        out[nq] = dict(p50_ms=float(np.percentile(timed, 50)),
                       p99_ms=float(np.percentile(timed, 99)))
    return out


def phase_tiers_1m():
    """Phase 6: the IVF (bf16), SQ8-IVF, PQ, PQ with OPQ and IVF-PQ tiers of
    DenseIndex over N_TIER clustered rows: build, tune_nprobe (the IVF and
    IVF-PQ tiers), search p50/p99 at Q = 1, 8, 32, recall@10 against the
    exact K1 scan, peak memory, memory_bytes, launches; the IVF-PQ tier's
    search is timed through both of its ADC routes."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.config import IndexConfig, IndexType, Metric
    from advanced_rag_tpu_torch.index.dense_index import DenseIndex
    from advanced_rag_tpu_torch.ops.dense_kernels import dense_topk_kernel

    dev = torch.device("cuda")
    t = time.perf_counter()
    x, q = clustered_vectors(N_TIER, 256, seed=21)
    log(f"tiers: {N_TIER} clustered rows ({N_CENTRES} centres) + 256 queries made in "
        f"{time.perf_counter() - t:.2f}s")
    # the oracle: the exact K1 scan of the f32 rows
    xf = torch.from_numpy(x).to(dev)
    qd = torch.from_numpy(q).to(dev)
    _, oracle = dense_topk_kernel(xf, qd, 10)
    oracle = oracle.cpu().numpy()
    del xf
    torch.cuda.empty_cache()
    out = {}
    for name, dtype, refine, opq in (("ivf-bf16", "bfloat16", 0, False),
                                     ("ivf-sq8", "int8", 2, False), ("pq", "pq", 32, False),
                                     ("pq-opq", "pq", 32, True), ("ivfpq", "pq", 32, False)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        cfg = IndexConfig(index_type=IndexType.SEMANTIC, dim=384, metric=Metric.COSINE,
                          dtype=dtype, refine_factor=refine, pq_m=PQ_M, pq_bits=4,
                          pq_opq=opq)
        idx = DenseIndex(cfg, device=dev)
        t = time.perf_counter()
        idx.bulk_load(x, pre_normalized=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        partitioned = name.startswith("ivf")
        t = time.perf_counter()
        if name.startswith("pq"):
            idx.build_pq()
        else:
            idx.build_ivf()          # on the PQ index: IVF-PQ
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        rec = dict(load_s=load_s, build_s=build_s)
        if partitioned:
            parts = idx._ivfpq if name == "ivfpq" else idx._ivf
            nlist, cap = parts.packed_rows.shape
            if (nlist, cap) != IVF_1M[:2]:
                raise AssertionError(f"IVF geometry {(nlist, cap)} is not {IVF_1M[:2]}: "
                                     "phase 3 missed the tier's shapes")
            t = time.perf_counter()
            npb, got = idx.tune_nprobe(0.95, k=10, queries=q[:64])
            rec.update(nprobe=npb, tune_recall=got, tune_s=time.perf_counter() - t,
                       overflow_rows=int((parts.tail_rows >= 0).sum()))
        hits = []
        for s0 in range(0, len(q), 32):
            _, ids = idx.search(q[s0:s0 + 32], 10)
            ids = ids.cpu().numpy()
            hits += [len(set(a.tolist()) & set(b.tolist())) / 10.0
                     for a, b in zip(ids, oracle[s0:s0 + 32])]
        rec["recall_at_10"] = float(np.mean(hits))

        def search(nq, r):
            idx.search(q[(r * nq) % 224:(r * nq) % 224 + nq], 10)[1].cpu()

        rec["batches"] = time_calls(search, BATCHES)
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["launches"] = read_counters()
        rec["memory_bytes"] = idx.memory_bytes()
        key = "K6" if dtype == "pq" else "K5"
        if rec["launches"][key] == 0:
            raise AssertionError(f"tier {name} did not run {key}: {rec['launches']}")
        if rec["recall_at_10"] < 0.5:
            raise AssertionError(f"tier {name}: recall@10 {rec['recall_at_10']:.3f}")
        if dtype != "pq":   # after the counters are read: a check, not the path
            rec["real_probe_cases"] = real_probe_cases(
                idx._ivf, torch.from_numpy(q[:32]).to(dev), idx.config.nprobe)
        if name == "ivfpq":
            rec["k6_cases"] = ivfpq_k6_cases(idx._ivfpq, torch.from_numpy(q[:32]).to(dev),
                                             idx.config.nprobe, "phase 6")
        times = lambda b: "; ".join(  # noqa: E731
            f"Q={nq} p50 {v['p50_ms']:.2f} / p99 {v['p99_ms']:.2f} ms" for nq, v in b.items())
        log(f"tiers[{name}]: load {load_s:.2f}s, build {build_s:.2f}s, "
            + (f"nprobe {rec['nprobe']} (tune recall {rec['tune_recall']:.3f}, "
               f"{rec['tune_s']:.2f}s), " if partitioned else "")
            + f"recall@10 {rec['recall_at_10']:.4f}; {times(rec['batches'])}"
            + f"; peak {rec['peak_gb']:.2f} GB; memory_bytes {rec['memory_bytes']}; "
              f"launches {rec['launches']}")
        out[name] = rec
        del idx
        torch.cuda.empty_cache()
    return out


def ingest_all(mgr, texts):
    from advanced_rag_tpu_torch.index.corpus import ChunkRecord

    for s in range(0, len(texts), 8192):
        recs = [ChunkRecord(chunk_id=f"c{i}", doc_id=f"d{i // 4}", content=texts[i],
                             chunk_index=i % 4, token_count=texts[i].count(" ") + 1)
                for i in range(s, min(s + 8192, len(texts)))]
        rep = mgr.index_chunks(recs)
        if rep["indexed"] != len(recs) or rep["errors"]:
            raise AssertionError(f"ingest failed: {rep['errors'][:3]}")


def check_hits(out, nq, k):
    import numpy as np

    if len(out) != nq or any(len(h) != k for h in out):
        raise AssertionError(f"Q={nq}: expected {k} hits per query")
    for hits in out:
        for h in hits:
            if not np.isfinite(h["score"]):
                raise AssertionError("non-finite score in results")


def phase_manager_tier(name, mgr, embedder, texts, work=None):
    """Phase 7, one tier: the manager's non-fused entry points over the IVF
    tier (``mgr`` is phase 4's bf16 manager; build_semantic(ivf=True)) or
    the PQ tier (``mgr`` is None: a semantic_dtype="pq" manager restored
    from phase 4's bf16 checkpoint under ``work``, the same chunks and
    embeddings as an ingest gives, then build_semantic(pq=True)), serving
    search_sync(SEMANTIC)
    and hybrid_search_batch_sync at Q = 1, 8, 32 with BM25 from the
    postings (built at the first call: the corpus is over 50k rows)."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.config import IndexType, PipelineConfig
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.utils.checkpoint import load_index

    rng = np.random.default_rng(17)
    k = 10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    rec = {}
    if mgr is None:
        cfg = PipelineConfig(semantic_dtype="pq")
        cfg.semantic_dim = embedder.dim
        mgr = MultiIndexManager(cfg, embedder=embedder, device="cuda")
        t = time.perf_counter()
        load_index(mgr, work / "index-bfloat16")
        torch.cuda.synchronize()
        rec["restore_s"] = time.perf_counter() - t
    t = time.perf_counter()
    built = mgr.build_semantic(ivf=name == "ivf", pq=name == "pq")
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t
    if name == "ivf" and tuple(mgr.semantic._ivf.packed_rows.shape) != IVF_MANAGER[:2]:
        raise AssertionError("the manager's IVF geometry is not IVF_MANAGER: "
                             "phase 3 missed its shapes")
    t = time.perf_counter()
    mgr.hybrid_search_batch_sync(snippet_queries(rng, texts, 1), k)  # builds postings
    torch.cuda.synchronize()
    rec["first_hybrid_s"] = time.perf_counter() - t
    if not mgr.sparse.has_postings:
        raise AssertionError("postings were not built at n_valid >= 50k")
    rec["postings_cap"] = int(mgr.sparse.post_rows.shape[1])

    def hybrid(nq, r):
        check_hits(mgr.hybrid_search_batch_sync(snippet_queries(rng, texts, nq), k),
                   nq, k)

    def semantic(nq, r):
        for qtext in snippet_queries(rng, texts, nq):
            if len(mgr.search_sync(IndexType.SEMANTIC, qtext, k)) != k:
                raise AssertionError("search_sync returned too few hits")

    rec["hybrid"] = time_calls(hybrid, BATCHES)
    rec["search_sync"] = time_calls(semantic, (1,))
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["launches"] = read_counters()
    rec["stats"] = mgr.get_collection_stats()["semantic"]
    rec["built"] = built
    key = "K5" if name == "ivf" else "K6"
    if rec["launches"][key] == 0:
        raise AssertionError(f"manager[{name}] did not run {key}: {rec['launches']}")
    if name == "ivf":   # after the counters are read: a check, not the path
        rec["real_probe_cases"] = real_probe_cases(
            mgr.semantic._ivf, mgr.embedder.encode_device(snippet_queries(rng, texts, 32)),
            mgr.semantic.config.nprobe)
    log(f"manager[{name}]: build {rec['build_s']:.2f}s"
        + (f", restored from phase 4's bf16 checkpoint in {rec['restore_s']:.2f}s"
           if "restore_s" in rec else "")
        + f", first hybrid (builds postings, cap {rec['postings_cap']}) "
          f"{rec['first_hybrid_s']:.2f}s; hybrid "
        + "; ".join(f"Q={nq} p50 {v['p50_ms']:.2f} / p99 {v['p99_ms']:.2f} ms"
                    for nq, v in rec["hybrid"].items())
        + f"; search_sync Q=1 p50 {rec['search_sync'][1]['p50_ms']:.2f} / p99 "
          f"{rec['search_sync'][1]['p99_ms']:.2f} ms; peak {rec['peak_gb']:.2f} GB; "
          f"launches {rec['launches']}")
    if name == "pq":
        rec["lifecycle"] = index_round_trip(
            "index pq", mgr, MultiIndexManager(cfg, embedder=embedder, device="cuda"),
            hybrid_answers(lifecycle_queries(np.random.default_rng(53), texts)),
            work / "index-pq")
        mgr.close()
    return rec


def real_probe_cases(parts, q, nprobe):
    """K5 through both routes on a tier's own slabs with the probe lists
    that a batch of real queries ``q`` gets from ``probe_lists`` over that
    index: real queries cluster, so they share more lists than random ones."""
    from advanced_rag_tpu_torch.ops import ivf_kernels as ik
    from advanced_rag_tpu_torch.ops.dense import l2_normalize
    from advanced_rag_tpu_torch.ops.ivf import probe_lists
    from advanced_rag_tpu_torch.ops.quant import sq8_quantize

    nlist, cap, d = parts.packed_emb.shape
    nprobe = min(nprobe, nlist)
    q = l2_normalize(q.float()).contiguous()
    probes = probe_lists(parts, q, nprobe).contiguous()
    scale = parts.packed_scale
    q_in = q if scale is None else sq8_quantize(q)[0].contiguous()
    auto = ik.ivf_route(len(q), nprobe, nlist, cap, parts.packed_emb.dtype, d)
    cases = []
    for route in ("stream", "grouped"):
        case = k5_case(probes, q_in, parts.packed_emb, scale, route,
                       store=parts.packed_emb.reshape(nlist * cap, d)
                       if route == auto else None, kind="real")
        log_case(f"K5-{route}", case)
        cases.append(case)
    return cases


def ivfpq_k6_cases(parts, q, nprobe, label):
    """K6 against its plain version on the codes the IVF-PQ tier's grouped
    ADC hands it: the distinct partitions that real queries ``q`` probe
    (or all of them), with their residual tables, at Q = 1 and the batch's
    size.  The plain version runs in blocks of 65,536 rows (its f32 one-hot
    operand would not fit whole); the library call is one torch.matmul by
    the bf16 one-hot [m * c, N] of the codes, written a block of rows at a
    time into its buffer so that one_hot's int64 transient stays small."""
    import torch

    from advanced_rag_tpu_torch.ops import pq_kernels as pk
    from advanced_rag_tpu_torch.ops.dense import l2_normalize, topk_first
    from advanced_rag_tpu_torch.ops.ivfpq import ivfpq_codebook
    from advanced_rag_tpu_torch.ops.pq import pq_lut, pq_scores_xla

    nlist, cap, m = parts.packed_codes.shape
    cases = []
    for nq in (1, len(q)):
        qq = l2_normalize(q[:nq].float()).contiguous()
        _, probe = topk_first(qq @ parts.centroids.T, min(nprobe, nlist))
        uniq = torch.unique(probe.long())
        codes = (parts.packed_codes.reshape(-1, m) if len(uniq) == nlist
                 else parts.packed_codes[uniq].reshape(-1, m))
        lut = pq_lut(ivfpq_codebook(parts, bits=4), qq)
        n, c = codes.shape[0], lut.shape[2]
        onehot = torch.empty((m * c, n), dtype=torch.bfloat16, device=q.device)
        for s0 in range(0, n, 16384):
            blk = torch.nn.functional.one_hot(codes[s0:s0 + 16384].long() & (c - 1), c)
            onehot[:, s0:s0 + 16384] = blk.reshape(-1, m * c).T.to(torch.bfloat16)
            del blk
        lut_b = lut.to(torch.bfloat16).reshape(nq, m * c)
        lib = lambda: torch.matmul(lut_b, onehot)  # noqa: E731

        def plain():
            return torch.cat([pq_scores_xla(codes[s0:s0 + 65536], lut)
                              for s0 in range(0, n, 65536)], dim=1)

        fn = lambda: pk.pq_scores(codes, lut)  # noqa: E731
        err, rel, swaps = compare(fn(), plain(), 1e-5)
        b_ms, b_by = bound(n * m + nq * n * 4 + nq * m * c * 2, 1.0 * nq * n * m,
                           F32_OPS_PER_S)
        case = dict(shape=f"{label}: IVF-PQ codes of {len(uniq)} of {nlist} probed "
                          f"partitions x cap {cap} (N={n}), m={m} Q={nq}, real probes at "
                          f"nprobe {nprobe} ({pk.pq_kernel_for(nq)}, "
                          f"{len(pk.pq_plan(nq, m, c))} launches)",
                    main=False, max_abs_err=err, rel_err=rel, tie_swaps=swaps,
                    ms=graph_ms(fn), call_ms=cuda_ms(fn),
                    plain_ms=cuda_ms(plain, reps=2, warmup=1), library_ms=graph_ms(lib),
                    library_call_ms=cuda_ms(lib),
                    library="torch.matmul bf16 [Q, m*c] x one-hot [m*c, N] -> bf16",
                    bound_ms=b_ms, bound_by=b_by)
        log_case("K6", case)
        cases.append(case)
        del onehot
        torch.cuda.empty_cache()
    return cases


def phase_tier_reference():
    """Phase 7's check: a small corpus served on the card and by the plain
    path on the CPU, IVF (bf16 rows), PQ, PQ with OPQ and PQ + IVF-PQ tiers,
    postings above a lowered threshold, f32 weights; the tier state the card
    built is carried to the CPU manager, so the comparison is of the search
    path."""
    import dataclasses

    import torch

    from advanced_rag_tpu_torch.config import IndexType, PipelineConfig
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.index.sparse_index import SparseIndex
    from advanced_rag_tpu_torch.models.embedder import NeuralEmbedder
    from advanced_rag_tpu_torch.models.encoder import SHIPPED_BIENCODER
    from advanced_rag_tpu_torch.ops.ivf import IVFPartitions
    from advanced_rag_tpu_torch.ops.ivfpq import IVFPQIndex
    from advanced_rag_tpu_torch.ops.pq import PQCodebook

    bi = dataclasses.replace(SHIPPED_BIENCODER, num_layers=2, dtype=torch.float32)
    texts = [" ".join(t.split()[:40]) for t in synthetic_corpus(1024, seed=8)]
    queries = [" ".join(t.split()[5:17]) for t in texts[::128]]
    saved = SparseIndex.POSTINGS_AUTO_THRESHOLD
    SparseIndex.POSTINGS_AUTO_THRESHOLD = 512
    try:
        # (tier, OPQ, the tiers built on its managers in turn: IVF-PQ goes
        # on top of the PQ managers' codes)
        for tier, opq, labels in (("bfloat16", False, ("ivf",)), ("pq", False, ("pq", "ivfpq")),
                                  ("pq", True, ("pq-opq",))):
            mgrs = {}
            for dev in ("cuda", "cpu"):
                cfg = PipelineConfig(semantic_dtype=tier, semantic_opq=opq)
                cfg.semantic_dim = 384
                emb = NeuralEmbedder(dim=384, config=bi, seed=3, device=dev)
                mgr = MultiIndexManager(cfg, embedder=emb, device=dev)
                ingest_all(mgr, texts)
                mgrs[dev] = mgr
            card, cpu = mgrs["cuda"].semantic, mgrs["cpu"].semantic
            for label in labels:
                if tier == "pq":
                    built = mgrs["cuda"].build_semantic(pq=True, ivf=label == "ivfpq")
                    if card.has_ivfpq != (label == "ivfpq") or (card._pq_rot is None) == opq:
                        raise AssertionError(f"reference[{label}]: built {built}")
                    cpu._pq = PQCodebook(card._pq.codebooks.cpu(), card._pq.m, card._pq.bits)
                    cpu.emb = card.emb.cpu()
                    cpu._pq_rot = None if card._pq_rot is None else card._pq_rot.cpu()
                    if card.has_ivfpq:
                        cpu._ivfpq = IVFPQIndex(*[t.cpu() for t in card._ivfpq])
                        cpu._ivfpq_size, cpu._ivfpq_fill = card._ivfpq_size, card._ivfpq_fill
                        cpu.config.nprobe = card.config.nprobe
                else:
                    mgrs["cuda"].build_semantic(ivf=True)
                    cpu._ivf = IVFPartitions(*[None if t is None else t.cpu()
                                               for t in card._ivf])
                    cpu._ivf_size = card._ivf_size
                ids = {}
                for dev, mgr in mgrs.items():
                    hyb = mgr.hybrid_search_batch_sync(queries, 10)
                    sem = [mgr.search_sync(IndexType.SEMANTIC, qt, 10) for qt in queries]
                    ids[dev] = [[h["chunk_id"] for h in hits] for hits in hyb + sem]
                    if not mgr.sparse.has_postings:
                        raise AssertionError("reference: postings were not built")
                overlap = sum(len(set(a) & set(b)) for a, b in zip(ids["cuda"], ids["cpu"]))
                frac = overlap / max(sum(len(b) for b in ids["cpu"]), 1)
                log(f"reference[{label}]: card vs CPU plain path, hybrid + search_sync "
                    f"top-10 overlap {frac:.3f} over {len(queries)} queries")
                if frac < 0.9:
                    raise AssertionError(f"card and CPU disagree on the {label} tier "
                                         f"({frac:.3f})")
    finally:
        SparseIndex.POSTINGS_AUTO_THRESHOLD = saved


#: phase 8 (the service): documents POSTed to /ingest (600-1500 words,
#: which the default chunking splits into two to four chunks each; its
#: target is about 500 tokens), the probe documents among them (one
#: sentence of PROBE_WORDS words: a query made of it sees the tokens the
#: chunk was embedded from), /retrieve requests from one client, and
#: rounds per client at 8 and 32 concurrent clients
SERVICE_DOCS = 256
SERVICE_SEQUENTIAL = 100      # 200 until phase 13 (j) came
SERVICE_ROUNDS = {8: 12, 32: 6}
SERVICE_TOP_K = 10
SLA_MS = 80.0                  # PerformanceConstants.TARGET_LATENCY_MS
#: the service's per-client rate limits (10 ingests, 60 retrieves a
#: minute) would refuse a load test from one address; RAG_*_RPM raise
#: them, as a deployment does for a bulk load.  Everything else stands
#: at the service's defaults: the 300 ms degrade budget, 64 requests in
#: flight, micro-batches of up to 16 queries.
SERVICE_ENV = {"RAG_RETRIEVE_RPM": "1000000000", "RAG_INGEST_RPM": "1000000000"}


def service_documents(seed: int, n: int):
    """n documents of 600-1500 words in sentences of 8-24 words, then
    SERVICE_PROBES one-sentence probe documents; returns (docs, probes)
    with probes = [(doc_id, query)], the query being the probe's text."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab, p = zipf_vocab(rng)
    docs = []
    for i in range(n):
        sents, total = [], int(rng.integers(600, 1501))
        while total > 0:
            k = min(total, int(rng.integers(8, 25)))
            total -= k
            w = vocab[rng.choice(len(vocab), size=k, p=p)]
            sents.append(w[0].capitalize() + " " + " ".join(w[1:]) + ".")
        docs.append({"doc_id": f"svc{i}", "content": " ".join(sents)})
    probes = []
    for i in range(8):
        text = " ".join(vocab[rng.choice(len(vocab), size=PROBE_WORDS, p=p)])
        docs.append({"doc_id": f"probe{i}", "content": text})
        probes.append((f"probe{i}", text))
    return docs, probes


class HttpDriver:
    """The service through aiohttp's test server and client on a
    localhost socket: what a user's HTTP client sees."""

    def __init__(self, client):
        self.client = client

    async def ingest(self, docs):
        resp = await self.client.post("/ingest", json={"documents": docs})
        if resp.status != 200:
            raise AssertionError(f"/ingest answered {resp.status}: {await resp.text()}")
        return await resp.json()

    async def retrieve(self, query):
        resp = await self.client.post("/retrieve",
                                      json={"query": query, "top_k": SERVICE_TOP_K})
        return resp.status, await resp.json()

    async def warm_up(self):
        resp = await self.client.post("/admin/warmup", json={"top_k": [SERVICE_TOP_K]})
        if resp.status != 200:
            raise AssertionError(f"/admin/warmup answered {resp.status}")

    async def perf(self):
        resp = await self.client.get("/perf")
        return await resp.json()


async def drive_service(driver, pipeline, batches, docs, probes, queries,
                        warm_route):
    """Ingest, warm, then /retrieve from 1, 8 and 32 concurrent clients
    and the probes; every answer must be a 200 with results.  Each level
    also reads, from the pipeline's own telemetry, the p50 of its
    requests' ``AdvancedRAGPipeline.retrieve`` and of their stages, so the
    client's latency splits into the service's share (HTTP, event loop,
    thread hop) and the pipeline's, and ``batches`` (the manager's batch
    calls, (ms, queries), appended by ``timed_manager``) gives the device
    batch's own time."""
    import numpy as np

    rec = {}
    t = time.perf_counter()
    chunks = 0
    for s0 in range(0, len(docs), 64):
        rep = await driver.ingest(docs[s0:s0 + 64])
        if rep["errors"]:
            raise AssertionError(f"ingest errors: {rep['errors'][:3]}")
        chunks += rep["indexed"]
    rec["ingest_s"] = time.perf_counter() - t
    rec["ingest_docs_per_s"] = len(docs) / rec["ingest_s"]
    rec["ingest_chunks"] = chunks

    async def one(q):
        """(ms, None or how the answer failed, payload)"""
        t0 = time.perf_counter()
        status, payload = await driver.retrieve(q)
        ms = (time.perf_counter() - t0) * 1e3
        bad = (None if status == 200 and payload.get("results")
               else f"{status} with {len(payload.get('results') or [])} results")
        return ms, bad, payload

    async def client(qs):
        return [(await one(q))[:2] for q in qs]

    def telemetry():
        return {"retrieve": len(pipeline._retrieve_latencies), "batches": len(batches),
                **{k: len(v) for k, v in pipeline._stage_latencies.items()}}

    def p50_since(before):
        """p50 ms of the samples each window gained since ``before``
        (the windows hold LATENCY_WINDOW samples, more than a level adds)."""
        out = {}
        for key, n0 in before.items():
            if key == "batches":
                new = batches[n0:]
                out["manager_batch"] = float(np.percentile([b[0] for b in new], 50))
                out["queries_per_batch"] = float(np.mean([b[1] for b in new]))
                continue
            vals = (pipeline._retrieve_latencies if key == "retrieve"
                    else pipeline._stage_latencies[key])[n0:]
            if vals:
                out[key] = float(np.percentile(vals, 50))
        return out

    async def load(conc, rounds, qs):
        before = telemetry()
        t0 = time.perf_counter()
        out = await asyncio.gather(*[client(qs[i * rounds:(i + 1) * rounds])
                                     for i in range(conc)])
        wall = time.perf_counter() - t0
        ms = np.asarray([m for c in out for m, _ in c])
        rec = dict(requests=int(ms.size), p50_ms=float(np.percentile(ms, 50)),
                   p99_ms=float(np.percentile(ms, 99)), mean_ms=float(ms.mean()),
                   max_ms=float(ms.max()), requests_per_s=ms.size / wall,
                   pipeline_p50_ms=p50_since(before))
        bad = [b for c in out for _, b in c if b]
        if bad:     # every answer must be a 200 with results
            raise AssertionError(f"/retrieve from {conc} client(s): {len(bad)} of "
                                 f"{ms.size} answers failed ({sorted(set(bad))}); "
                                 f"level {rec}")
        return rec

    # warm: the first use builds nothing new (phase 2 built the kernels),
    # but each batch size's first launches are slower; the default
    # configuration warms its program shapes through /admin/warmup, the
    # fused one by traffic (/admin/warmup would also warm the unfused
    # shapes, whose first hybrid search builds the postings, and the
    # fused program would then take its BM25 from them instead of K3)
    t = time.perf_counter()
    if warm_route:
        await driver.warm_up()
    for conc in (1, 8, 32):
        await load(conc, 2, queries[:2 * conc])
    rec["warm_s"] = time.perf_counter() - t
    qi = 2 * 32
    rec["retrieve"] = {}
    for conc, rounds in ((1, SERVICE_SEQUENTIAL), *SERVICE_ROUNDS.items()):
        rec["retrieve"][conc] = await load(conc, rounds, queries[qi:qi + conc * rounds])
        qi += conc * rounds
    found = 0
    for doc_id, text in probes:
        _, bad, payload = await one(text)
        if bad:
            raise AssertionError(f"/retrieve of a probe answered {bad}")
        found += doc_id in [r["doc_id"] for r in payload["results"]]
    rec["probes_found"] = found
    perf = await driver.perf()
    rec["stage_p50_ms"] = {k: v["p50"] for k, v in perf["stages_ms"].items()
                           if v["count"]}
    rec["micro_batcher"] = perf.get("fused_micro_batcher", perf.get("micro_batcher"))
    return rec


def timed_manager(mgr, batches):
    """Time the manager's batch entry points on this instance: each call
    appends (ms, queries) to ``batches`` (the calls end in a device->host
    copy, so the host clock covers the device work)."""
    for name in ("fused_retrieve_batch_sync", "hybrid_search_batch_sync"):
        def timed(queries, *args, _fn=getattr(mgr, name), **kwargs):
            t0 = time.perf_counter()
            out = _fn(queries, *args, **kwargs)
            batches.append(((time.perf_counter() - t0) * 1e3, len(queries)))
            return out
        setattr(mgr, name, timed)


def run_service(pipeline, db, docs, probes, queries, warm_route, need, after=None):
    """``drive_service`` over the port's app on a localhost socket, then
    ``after(client)`` if given (phase 9 (d)).  The counters are zeroed
    just before each and read just after, so ``rec["launches"]`` are the
    load levels' own and must hold every kernel in ``need``; ``after``'s
    go to ``rec["lifecycle"]["launches"]``.  The app's shutdown closes the
    pipeline and its manager."""
    import torch

    batches = []
    timed_manager(pipeline.index_manager, batches)

    async def go():
        from aiohttp.test_utils import TestClient, TestServer

        from advanced_rag_tpu_torch.service import create_app
        from advanced_rag_tpu_torch.service.metrics import PROM

        client = TestClient(TestServer(create_app(pipeline.config, pipeline=pipeline,
                                                  db=db)))
        await client.start_server()
        try:
            reset_counters()
            rec = await drive_service(HttpDriver(client), pipeline, batches, docs,
                                      probes, queries, warm_route)
            torch.cuda.synchronize()
            rec["launches"] = read_counters()
            missing = [k for k in need if rec["launches"][k] == 0]
            if missing:
                raise AssertionError(f"the service's load levels ran no {missing}: "
                                     f"{rec['launches']}")
            if after is not None:
                reset_counters()
                rec["lifecycle"] = await after(client)
                torch.cuda.synchronize()
                rec["lifecycle"]["launches"] = read_counters()
            # without prometheus_client the service answers 501 there
            resp = await client.get("/metrics")
            text = await resp.text()
            if (resp.status, "rag_retrieve_latency_ms" in text) != (
                    (200, True) if PROM else (501, False)):
                raise AssertionError(f"/metrics answered {resp.status}")
        finally:
            await client.close()     # on_shutdown closes the pipeline
        return rec

    try:
        return asyncio.run(go())
    finally:
        for name in ("fused_retrieve_batch_sync", "hybrid_search_batch_sync"):
            delattr(pipeline.index_manager, name)


async def service_maintain(client):
    """Phase 9 (d): POST /admin/index/maintain; returns its answer."""
    t = time.perf_counter()
    resp = await client.post("/admin/index/maintain", json={})
    body = await resp.json()
    if resp.status != 200:
        raise AssertionError(f"/admin/index/maintain answered {resp.status}: {body}")
    rec = dict(maintain=body, maintain_s=time.perf_counter() - t)
    log(f"service lifecycle: /admin/index/maintain in {rec['maintain_s']:.2f}s: {body}")
    return rec


def service_restart(pipeline, probes, enc_root, encoders):
    """Phase 9 (d): maintain, POST /admin/index/checkpoint (save, inside
    RAG_CHECKPOINT_ROOT), then a fresh app booted from RAG_CHECKPOINT_DIR
    with the saving app's settings: for the fused app (``encoders``)
    RAG_EMBEDDER=ckpt: / RAG_RERANKER=ckpt: of phase 9 (a)'s files (phase
    4's models, which it serves), for the default app its hashing embedder
    (a seeded draw, the same in every app).  The fresh app's probes must
    answer with the chunk ids of the app that saved."""
    async def probe_ids(client):
        out = []
        for _, text in probes:
            resp = await client.post("/retrieve", json={"query": text,
                                                        "top_k": SERVICE_TOP_K})
            body = await resp.json()
            if resp.status != 200 or not body.get("results"):
                raise AssertionError(f"/retrieve of a probe answered {resp.status}")
            out.append([r["chunk_id"] for r in body["results"]])
        return out

    async def go(client):
        from aiohttp.test_utils import TestClient, TestServer

        from advanced_rag_tpu_torch.service import create_app

        rec = await service_maintain(client)
        cfg = pipeline.config
        ckpt_dir = enc_root / ("service-fused" if encoders else "service-default")
        env = {"RAG_CHECKPOINT_ROOT": str(enc_root)}
        saved_env = {k: os.environ.get(k) for k in (
            "RAG_CHECKPOINT_ROOT", "RAG_CHECKPOINT_DIR", "RAG_EMBEDDER", "RAG_RERANKER",
            "RAG_FUSED_E2E", "RAG_FUSED_TOKEN_LEN", "RAG_RERANK_MODE", "RAG_RERANK_BASE",
            "RAG_RERANK_ALPHA", "RAG_RESCORE_MIX", "CHAT_DB_PATH")}
        os.environ.update(env)
        fresh = None
        try:
            t = time.perf_counter()
            resp = await client.post("/admin/index/checkpoint",
                                     json={"dir": str(ckpt_dir), "action": "save"})
            body = await resp.json()
            if resp.status != 200 or body.get("rows") != pipeline.index_manager.store.size:
                raise AssertionError(f"/admin/index/checkpoint answered {resp.status}: "
                                     f"{body}")
            rec["save_s"] = time.perf_counter() - t
            rec["bytes"] = dir_bytes(ckpt_dir)
            saved = await probe_ids(client)
            # the settings of the app that saved, as a deployment's restart
            # would give them
            os.environ.update({"RAG_CHECKPOINT_DIR": str(ckpt_dir),
                               "CHAT_DB_PATH": str(ckpt_dir) + ".db"})
            if encoders:
                os.environ.update({
                    "RAG_EMBEDDER": f"ckpt:{enc_root / 'biencoder'}",
                    "RAG_RERANKER": f"ckpt:{enc_root / 'reranker'}",
                    "RAG_FUSED_E2E": "1",
                    "RAG_FUSED_TOKEN_LEN": str(cfg.fused_token_len),
                    "RAG_RERANK_MODE": cfg.rerank_mode,
                    "RAG_RERANK_BASE": cfg.rerank_base,
                    "RAG_RERANK_ALPHA": str(cfg.rerank_alpha),
                    "RAG_RESCORE_MIX": str(cfg.rescore_mix)})
            t = time.perf_counter()
            app = create_app(device="cuda")
            rec["boot_s"] = time.perf_counter() - t
            rec["restored_rows"] = app["state"].pipeline.index_manager.store.size
            fresh = TestClient(TestServer(app))
            await fresh.start_server()
            again = await probe_ids(fresh)
        finally:
            if fresh is not None:
                await fresh.close()
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        rec["probes_same_ids"] = sum(a == b for a, b in zip(again, saved))
        log(f"service lifecycle: checkpoint saved in {rec['save_s']:.2f}s "
            f"({rec['bytes']} bytes); a fresh app booted from it"
            + (" with the ckpt: encoders" if encoders else "")
            + f" in {rec['boot_s']:.2f}s ({rec['restored_rows']} rows); probes "
            f"answered with the saving app's chunk ids: {rec['probes_same_ids']}/"
            f"{len(probes)}")
        if rec["restored_rows"] != pipeline.index_manager.store.size or \
                rec["probes_same_ids"] != len(probes):
            raise AssertionError("the restarted service does not answer as the one "
                                 "that saved")
        return rec
    return go


def log_service(name, rec):
    log(f"service[{name}]: ingest {rec['ingest_chunks']} chunks of "
        f"{SERVICE_DOCS + 8} documents in {rec['ingest_s']:.2f}s "
        f"({rec['ingest_docs_per_s']:.1f} documents/s); warm {rec['warm_s']:.2f}s")
    for conc, v in rec["retrieve"].items():
        pl = v["pipeline_p50_ms"]
        log(f"service[{name}]: /retrieve from {conc} client(s): {v['requests']} requests, "
            f"p50 {v['p50_ms']:.2f} ms, p99 {v['p99_ms']:.2f} ms, max {v['max_ms']:.2f} ms "
            f"(SLA {SLA_MS:.0f} ms: "
            f"p99 {'within' if v['p99_ms'] <= SLA_MS else 'over'}), "
            f"{v['requests_per_s']:.1f} requests/s; inside: pipeline.retrieve p50 "
            f"{pl['retrieve']:.2f} ms; the manager's batch p50 {pl['manager_batch']:.2f} "
            f"ms at {pl['queries_per_batch']:.1f} queries a batch; stages p50 "
            + ", ".join(f"{k} {pl[k]:.3f}" for k in
                        ("query_rewrite", "retrieval", "reranking", "evaluation",
                         "compliance") if k in pl))
    log(f"service[{name}]: /perf stage p50 ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in rec["stage_p50_ms"].items())
        + f"; micro-batcher {rec['micro_batcher']}")
    log(f"service[{name}]: probes found {rec['probes_found']}/8; launches "
        f"{rec['launches']}")
    if "lifecycle" in rec:
        log(f"service[{name}]: phase 9 (d) (maintain, checkpoint, restarted app) "
            f"launches {rec['lifecycle']['launches']}")


def phase_service(embedder, reranker, texts, work):
    """Phase 8: the port's service (create_app over AdvancedRAGPipeline) in
    both configurations it starts in, each over a manager of its own that
    the app's shutdown closes.

    - fused: a bf16 manager restored from phase 4's bf16 checkpoint
      (phase 9 (b), under ``work``: the same 70k chunks and embedder)
      and, on the retriever, phase 4's cross-encoder; POST /ingest of
      SERVICE_DOCS documents (diagnostics, chunking, enrichment,
      index_chunks, compliance), then /retrieve from 1, 8 and 32
      concurrent clients (the orchestrator's micro-batcher forms the
      batches) and 8 probes; K1 and K3 must run;
    - default: a HashingEmbedder manager over the same 70k texts (built
      through index_chunks), HybridRetriever micro-batching into
      hybrid_search_batch_sync, the host passthrough rerank; the same
      requests; K1 must run.

    Every answer must be a 200 with results and every probe document must
    come back in its top 10.  After the load levels, phase 9 (d): both apps
    answer POST /admin/index/maintain, and the fused app (whose models phase
    9 (a) saved under ``work``) and the default one save their indexes for
    a restarted app to boot from.  Returns the records and the launches."""
    import gc
    import importlib.util
    import os

    import numpy as np
    import torch

    from advanced_rag_tpu_torch.config import PipelineConfig
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.pipeline import AdvancedRAGPipeline, HybridRetriever
    from advanced_rag_tpu_torch.utils.checkpoint import load_index
    from advanced_rag_tpu_torch.utils.db_pool import DatabasePool

    if importlib.util.find_spec("aiohttp") is None:
        raise AssertionError("phase 8 drives the port's HTTP service, which needs "
                             "aiohttp; it is not installed on this machine")
    saved_env = {k: os.environ.get(k) for k in (*SERVICE_ENV, "API_KEY")}
    os.environ.update(SERVICE_ENV)
    os.environ.pop("API_KEY", None)
    gc_threshold = gc.get_threshold()
    docs, probes = service_documents(31, SERVICE_DOCS)
    rng = np.random.default_rng(29)
    n_queries = 2 * 32 + SERVICE_SEQUENTIAL + sum(c * r for c, r in SERVICE_ROUNDS.items())
    queries = snippet_queries(rng, texts, n_queries)
    db_dir = str(BUILD_DIR)
    out = {}

    def manager(name, cfg, embedder=None, checkpoint=None):
        t = time.perf_counter()
        mgr = MultiIndexManager(cfg, embedder=embedder, device="cuda")
        if checkpoint is None:
            ingest_all(mgr, texts)
        else:
            load_index(mgr, checkpoint)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        log(f"service[{name}]: {type(mgr.embedder).__name__} manager over "
            f"{mgr.store.n_valid()} chunks "
            + ("built through index_chunks" if checkpoint is None else
               "restored from phase 4's bf16 checkpoint") + f" in {build_s:.2f}s")
        return mgr, build_s

    try:
        # fused: the pipeline's config carries the serving knobs phase 4 ran
        cfg = PipelineConfig(fused_rerank=True, semantic_dtype="bfloat16",
                             rerank_mode="residual", rerank_base="exact",
                             rerank_alpha=0.5, rescore_mix=0.65)
        cfg.semantic_dim = embedder.dim
        mgr, build_s = manager("fused", cfg, embedder, work / "index-bfloat16")
        pipe = AdvancedRAGPipeline(cfg, index_manager=mgr, retriever=HybridRetriever(
            mgr, cfg.retrieval, reranker=reranker))
        if not pipe._use_fused_path():
            raise AssertionError("the fused service does not take the fused path")
        rows_before = mgr.store.size
        # the heap setup that /admin/warmup applies for serving
        # (RAG_GC_TUNE), which this configuration does not call
        # (drive_service says why): without it, full collections rescan
        # the process's heap under load
        gc.collect()
        gc.freeze()
        gc.set_threshold(200_000, 50, 100)
        log(f"service[fused]: {gc.get_freeze_count()} objects frozen")
        db = DatabasePool(sqlite_path=os.path.join(db_dir, "service_fused.db"))
        rec = run_service(pipe, db, docs, probes, queries, warm_route=False,
                          need=("K1", "K3"),
                          after=service_restart(pipe, probes, work, encoders=True))
        if mgr.store.size - rows_before != rec["ingest_chunks"]:
            raise AssertionError("the ingested chunks did not all reach the store")
        if rec["ingest_chunks"] < 2 * SERVICE_DOCS:
            raise AssertionError(f"chunking split too few documents: "
                                 f"{rec['ingest_chunks']} chunks")
        rec["manager_build_s"] = build_s
        log_service("fused", rec)
        out["fused"] = rec
        del pipe, mgr
        torch.cuda.empty_cache()

        # default: the hashing embedder, the unfused micro-batched search
        dcfg = PipelineConfig()
        dmgr, build_s = manager("default", dcfg)
        dpipe = AdvancedRAGPipeline(dcfg, index_manager=dmgr)
        if dpipe._use_fused_path():
            raise AssertionError("the default service took the fused path")
        db = DatabasePool(sqlite_path=os.path.join(db_dir, "service_default.db"))
        rec = run_service(dpipe, db, docs, probes, queries, warm_route=True,
                          need=("K1",),
                          after=service_restart(dpipe, probes, work, encoders=False))
        rec["manager_build_s"] = build_s
        log_service("default", rec)
        out["default"] = rec
        del dpipe, dmgr
        torch.cuda.empty_cache()
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        gc.unfreeze()            # /admin/warmup freezes the heap for serving
        gc.set_threshold(*gc_threshold)
    for name in ("fused", "default"):
        if out[name]["probes_found"] != 8:
            raise AssertionError(f"service[{name}]: probes found "
                                 f"{out[name]['probes_found']}/8")
    return out


def phase_service_reference():
    """Phase 8's check: AdvancedRAGPipeline on the card against the CPU
    plain path on a small corpus, same seeded f32 weights: fused on the f32
    tier (K1, K3) and on the int8 tier (K2), default (hashing embedder) on
    the f32 tier; top-10 overlap >= 0.9 in each."""
    import dataclasses

    import torch

    from advanced_rag_tpu_torch.config import PipelineConfig
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.models.cross_encoder import CrossEncoderReranker
    from advanced_rag_tpu_torch.models.embedder import HashingEmbedder, NeuralEmbedder
    from advanced_rag_tpu_torch.models.encoder import SHIPPED_BIENCODER, SHIPPED_RERANKER
    from advanced_rag_tpu_torch.pipeline import AdvancedRAGPipeline

    bi = dataclasses.replace(SHIPPED_BIENCODER, num_layers=2, dtype=torch.float32)
    ce = dataclasses.replace(SHIPPED_RERANKER, num_layers=2, dtype=torch.float32)
    docs, probes = service_documents(37, 96)
    import numpy as np

    rng = np.random.default_rng(41)
    texts = [d["content"] for d in docs]
    queries = snippet_queries(rng, texts, 16) + [q for _, q in probes[:4]]
    out = {}
    for name, fused, tier in (("fused-f32", True, "float32"), ("fused-int8", True, "int8"),
                              ("default-f32", False, "float32")):
        ids = {}
        for d in ("cuda", "cpu"):
            cfg = PipelineConfig(fused_rerank=fused, semantic_dtype=tier)
            cfg.semantic_dim = 384
            cfg.retrieval.timeout_seconds = 120.0   # a check, not a measurement
            emb = (NeuralEmbedder(dim=384, config=bi, seed=3, device=d) if fused
                   else HashingEmbedder(dim=384, seed=3, device=d))
            pipe = AdvancedRAGPipeline(cfg, index_manager=MultiIndexManager(
                cfg, embedder=emb, device=d), device=d)
            if fused:
                pipe.retriever.reranker = CrossEncoderReranker(config=ce, seed=4,
                                                               device=d)
            pipe.ingest_documents(docs)
            res = [pipe.retrieve(q, top_k=10) for q in queries]
            if any(r["degraded"] or not r["results"] for r in res):
                raise AssertionError(f"service reference[{name}]: an empty result")
            ids[d] = [[h.chunk_id for h in r["results"]] for r in res]
            pipe.close()
        overlap = sum(len(set(a) & set(b)) for a, b in zip(ids["cuda"], ids["cpu"]))
        frac = overlap / sum(len(b) for b in ids["cpu"])
        out[name] = frac
        log(f"service reference[{name}]: card vs CPU plain path, /retrieve's pipeline "
            f"top-10 overlap {frac:.3f} over {len(queries)} queries")
        if frac < 0.9:
            raise AssertionError(f"card and CPU disagree ({name}: {frac:.3f})")
    return out


#: phase 9 (the index lifecycle): the default manager's corpus is phase
#: 4's 70k chunks plus LIFECYCLE_MORE of the same generator (none since
#: phase 13 (j)), the size at which maintenance_tick builds IVF by itself
#: while 9 (c) and (e) run (IndexConstants.IVF_AUTO_THRESHOLD, 200,000 in
#: service, lowered to LIFECYCLE_IVF_THRESHOLD there, so the phase ingests
#: 90,000 chunks, not 260,000 (150,000 until phase 13 (j)), and the script
#: stays within its 1200-second limit); LIFECYCLE_TAIL more then make an
#: appended tail above 0.2 of the rows, within 131,072 (so the capacity,
#: and PQ_WIDE, are 131,072), and LIFECYCLE_DEAD of the chunk_index
#: residues (1 in LIFECYCLE_GROUPS each) are deleted for the compaction
LIFECYCLE_IVF_THRESHOLD = 70_000
LIFECYCLE_MORE = LIFECYCLE_IVF_THRESHOLD - N_CHUNKS
LIFECYCLE_TAIL = 20_000
LIFECYCLE_GROUPS = 20
LIFECYCLE_DEAD = (0, 1, 2)


def dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def phase_encoder_checkpoints(embedder, reranker, texts, root):
    """Phase 9 (a): phase 4's bi-encoder and cross-encoder saved with the
    port's save_biencoder / save_reranker under ``root``, loaded on the card;
    the embeddings and CE scores of phase 4's probe texts must be
    bit-identical.  Returns the record (the files stay for phase 8's boot)."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.models.cross_encoder import CrossEncoderReranker
    from advanced_rag_tpu_torch.models.embedder import NeuralEmbedder
    from advanced_rag_tpu_torch.train import (load_biencoder, load_reranker,
                                              save_biencoder, save_reranker)

    probes = [texts[r] for r in range(0, len(texts), PROBE_EVERY)][:16]
    docs = [texts[r + 1] for r in range(0, len(texts), PROBE_EVERY)][:16]
    t = time.perf_counter()
    save_biencoder(embedder.model, embedder.config, embedder.dim, root / "biencoder")
    save_reranker(reranker.model, reranker.config, root / "reranker",
                  q_len=reranker.q_len, d_len=reranker.d_len)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    cfg, out_dim, bi = load_biencoder(root / "biencoder", device="cuda")
    ce_cfg, ce, layout = load_reranker(root / "reranker", device="cuda")
    emb = NeuralEmbedder(dim=out_dim, config=cfg, state_dict=bi.state_dict(),
                         tokenizer=embedder.tokenizer, device="cuda")
    rr = CrossEncoderReranker(config=ce_cfg, state_dict=ce.state_dict(), device="cuda",
                              **layout)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    if (cfg, out_dim, ce_cfg, layout) != (embedder.config, embedder.dim, reranker.config,
                                          {"q_len": reranker.q_len, "d_len": reranker.d_len}):
        raise AssertionError("the loaded encoders' geometry differs from the saved")
    same_emb = torch.equal(emb.encode_device(probes), embedder.encode_device(probes))
    same_ce = np.array_equal(rr.score_pairs(probes, docs), reranker.score_pairs(probes, docs))
    rec = dict(save_s=save_s, load_s=load_s,
               bytes={k: dir_bytes(root / k) for k in ("biencoder", "reranker")},
               bit_identical_embeddings=same_emb, bit_identical_ce_scores=same_ce)
    log(f"lifecycle[encoders]: saved in {save_s:.2f}s ({rec['bytes']} bytes), loaded on "
        f"the card in {load_s:.2f}s; {len(probes)} probe embeddings bit-identical "
        f"{same_emb}, CE scores bit-identical {same_ce}")
    if not (same_emb and same_ce):
        raise AssertionError("the reloaded encoders do not reproduce the saved ones")
    return rec


def index_round_trip(name, mgr, fresh, search, root, keep=False):
    """Phase 9 (b): ``mgr`` saved with save_index under ``root``, loaded
    into the empty manager ``fresh`` with load_index, both searched by
    ``search(m)`` (a list of (chunk_id, score, ...) rows per query), which
    must be equal.  The counters are zeroed before and read after; the
    directory is removed unless ``keep``.  Returns the record."""
    import shutil

    import torch

    from advanced_rag_tpu_torch.utils.checkpoint import load_index, save_index

    reset_counters()
    try:
        t = time.perf_counter()
        save_index(mgr, root)
        save_s = time.perf_counter() - t
        size = dir_bytes(root)
        rebuild = {}
        table = fresh.token_table
        if table is not None:          # time the re-tokenization apart
            real = table.rebuild

            def timed(contents):
                t0 = time.perf_counter()
                real(contents)
                torch.cuda.synchronize()
                rebuild["s"] = time.perf_counter() - t0
            table.rebuild = timed
        t = time.perf_counter()
        load_index(fresh, root)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        if table is not None:
            del table.rebuild
        before, after = search(mgr), search(fresh)
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    launches = read_counters()
    if before != after:
        raise AssertionError(f"lifecycle[{name}]: search results differ after the restore")
    rec = dict(save_s=save_s, load_s=load_s, bytes=size, rows=fresh.store.size,
               token_rebuild_s=rebuild.get("s"), queries=len(before), launches=launches)
    log(f"lifecycle[{name}]: {rec['rows']} rows saved in {save_s:.2f}s ({size} bytes), "
        f"loaded in {load_s:.2f}s"
        + ("" if table is None else f" (token table re-tokenized in {rebuild['s']:.2f}s)")
        + f"; {len(before)} queries answer with the same ids and scores; launches "
          f"{launches}")
    fresh.close()
    return rec


def fused_answers(reranker, queries):
    def search(m):
        out = []
        for batch in queries:
            out += [[(h["chunk_id"], h["score"], h["rerank_score"]) for h in hits]
                    for hits in m.fused_retrieve_batch_sync(batch, reranker=reranker,
                                                            **SERVE)]
        return out
    return search


def hybrid_answers(queries, k=10, **knobs):
    def search(m):
        out = []
        for batch in queries:
            out += [[(h["chunk_id"], h["score"]) for h in hits]
                    for hits in m.hybrid_search_batch_sync(batch, k, **knobs)]
        return out
    return search


def lifecycle_queries(rng, texts):
    """The probes (exact chunk texts) and a 32-query batch."""
    import numpy as np

    probes = rng.choice(np.arange(0, len(texts), PROBE_EVERY), size=8, replace=False)
    return [[texts[r] for r in probes], snippet_queries(rng, texts, 32)]


def ingest_range(mgr, texts, lo, hi):
    from advanced_rag_tpu_torch.index.corpus import ChunkRecord

    for s in range(lo, hi, 8192):
        recs = [ChunkRecord(chunk_id=f"c{i}", doc_id=f"d{i // 4}", content=texts[i],
                            chunk_index=i % LIFECYCLE_GROUPS,
                            token_count=texts[i].count(" ") + 1)
                for i in range(s, min(s + 8192, hi))]
        rep = mgr.index_chunks(recs)
        if rep["indexed"] != len(recs) or rep["errors"]:
            raise AssertionError(f"ingest failed: {rep['errors'][:3]}")


def overlap(a, b):
    return sum(len({r[0] for r in x} & {r[0] for r in y}) for x, y in zip(a, b)) / max(
        sum(len(y) for y in b), 1)


def served_k1_cases(mgr, queries):
    """K1 against its plain version on the tensors phase 9's manager serves:
    the 1536-wide semantic rows and the 768-wide domain rows, its row mask
    and real queries at Q = 1 and 32; the bound as phase 3 counts it."""
    import torch

    from advanced_rag_tpu_torch.ops import dense_kernels as dk
    from advanced_rag_tpu_torch.ops.dense import l2_normalize, mask_additive

    cases = []
    m = mask_additive(mgr._row_mask(None), mgr.semantic.capacity, mgr.device)
    for fam, idx, embedder in (("semantic", mgr.semantic, mgr.embedder),
                               ("domain", mgr.domain, mgr.domain_embedder)):
        rows = idx.emb
        n, d = rows.shape
        for nq in (1, 32):
            q = l2_normalize(embedder.encode_device(queries[:nq]).float()).contiguous()
            err, rel, swaps = compare(dk.dense_scores(q, rows, m),
                                      dk.dense_scores_plain(q, rows, m), 1e-5)
            qb = q.to(torch.bfloat16)
            b_ms, b_by = bound(n * d * 2 + nq * d * 4 + n * 4 + nq * n * 4,
                               3 * 2.0 * nq * n * d, BF16_OPS_PER_S)
            case = dict(shape=f"bf16 rows N={n} D={d} Q={nq} (phase 9, {fam})",
                        main=False, max_abs_err=err, rel_err=rel, tie_swaps=swaps,
                        ms=graph_ms(lambda: dk.dense_scores(q, rows, m)),
                        call_ms=cuda_ms(lambda: dk.dense_scores(q, rows, m)),
                        plain_ms=cuda_ms(lambda: dk.dense_scores_plain(q, rows, m), reps=3),
                        library_ms=graph_ms(lambda: torch.matmul(qb, rows.T)),
                        library_call_ms=cuda_ms(lambda: torch.matmul(qb, rows.T)),
                        bound_ms=b_ms, bound_by=b_by)
            log_case("K1", case)
            cases.append(case)
    return cases


def phase_lifecycle(texts, root):
    """Phase 9 (c): a default-configuration manager (HashingEmbedder, bf16,
    postings BM25) with enable_domain=True over 70,000 chunks; the domain
    rung of hybrid_search_batch_sync (domain_weight 0.2) at Q = 1 and 32;
    maintenance_tick's first IVF build behind its recall guardrail;
    LIFECYCLE_TAIL more chunks and the IVF rebuild; 15% deleted and the
    postings compaction; last, the manager saved under ``root`` (which
    phase 9 (e) restores; the caller removes it) and loaded into a fresh
    card manager and into a CPU manager (the plain path): the card's domain
    rung against the CPU's, top-10 overlap >= 0.9; the restored card
    manager, with the original's partitions and postings compacted as its
    were, must answer as the original; then the restart's own tick.
    Returns the record, the kernel cases it held against their plain
    versions and the semantic embedder's projection."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.config import PipelineConfig
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.models.embedder import HashingEmbedder
    from advanced_rag_tpu_torch.ops.dense import l2_normalize
    from advanced_rag_tpu_torch.ops.ivf import probe_lists
    from advanced_rag_tpu_torch.utils.checkpoint import load_index, save_index

    rng = np.random.default_rng(43)
    more = synthetic_corpus(LIFECYCLE_MORE + LIFECYCLE_TAIL, seed=12)
    corpus = list(texts) + more
    n1 = len(texts) + LIFECYCLE_MORE
    rec, cases = {}, {"K1": [], "K5": []}
    mgr = MultiIndexManager(PipelineConfig(), enable_domain=True, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t = time.perf_counter()
    ingest_range(mgr, corpus, 0, n1)
    torch.cuda.synchronize()
    rec["ingest_s"] = time.perf_counter() - t
    log(f"lifecycle[domain]: {mgr.store.n_valid()} chunks ingested in "
        f"{rec['ingest_s']:.2f}s (semantic {mgr.semantic.dim} wide, domain "
        f"{mgr.domain.dim}, capacity {mgr.semantic.capacity})")

    def hybrid(nq, r):
        check_hits(mgr.hybrid_search_batch_sync(snippet_queries(rng, corpus[:n1], nq), 10,
                                                domain_weight=0.2), nq, 10)

    rec["hybrid_exact"] = time_calls(hybrid, (1, 32))

    def tick(what):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        actions = mgr.maintenance_tick()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        log(f"lifecycle[maintenance]: {what}: {s:.2f}s, actions {actions}, nprobe "
            f"{mgr.semantic.config.nprobe}")
        return dict(actions=actions, seconds=s, nprobe=mgr.semantic.config.nprobe)

    rec["first_build"] = tick(f"first build at {n1} rows")
    if not rec["first_build"]["actions"].get("ivf_rebuilt"):
        raise AssertionError(f"maintenance_tick built no IVF at {n1} rows")
    rec["hybrid_ivf"] = time_calls(hybrid, (1, 32))
    t = time.perf_counter()
    ingest_range(mgr, corpus, n1, len(corpus))
    rec["tail_ingest_s"] = time.perf_counter() - t
    if not mgr.semantic.ivf_needs_rebuild:
        raise AssertionError("the appended tail did not pass 0.2 of the rows")
    rec["rebuild"] = tick(f"rebuild with a tail of {mgr.semantic.ivf_tail_rows} rows")
    if rec["rebuild"]["actions"].get("ivf_rows") != len(corpus):
        raise AssertionError("maintenance_tick did not rebuild the IVF over every row")
    deleted = mgr.delete_by_filter({"chunk_index": {"in": list(LIFECYCLE_DEAD)}})
    rec["deleted"] = deleted
    rec["stale_fraction"] = mgr.sparse.postings_stale_fraction
    rec["compaction"] = tick(f"{deleted} rows deleted (stale postings "
                             f"{rec['stale_fraction']:.3f})")
    if not rec["compaction"]["actions"].get("postings_compacted"):
        raise AssertionError("maintenance_tick did not compact the postings")
    rec["hybrid_after"] = time_calls(hybrid, (1, 32))
    torch.cuda.synchronize()
    rec["launches"] = read_counters()
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if rec["launches"]["K1"] == 0 or rec["launches"]["K5"] == 0:
        raise AssertionError(f"phase 9's manager ran no K1 or K5: {rec['launches']}")
    log(f"lifecycle[domain]: hybrid (domain_weight 0.2) exact scan "
        + "; ".join(f"Q={nq} p50 {v['p50_ms']:.2f} / p99 {v['p99_ms']:.2f} ms"
                    for nq, v in rec["hybrid_exact"].items())
        + "; IVF " + "; ".join(f"Q={nq} p50 {v['p50_ms']:.2f} / p99 {v['p99_ms']:.2f} ms"
                               for nq, v in rec["hybrid_ivf"].items())
        + f"; tail ingest {rec['tail_ingest_s']:.2f}s; peak {rec['peak_gb']:.2f} GB; "
          f"launches {rec['launches']}")

    # kernels on the served tensors (after the counters are read)
    live = [t for i, t in enumerate(corpus) if i % LIFECYCLE_GROUPS not in LIFECYCLE_DEAD]
    checks = snippet_queries(rng, live, 32)
    cases["K1"] = served_k1_cases(mgr, checks)
    parts = mgr.semantic._ivf
    q = l2_normalize(mgr.embedder.encode_device(checks).float()).contiguous()
    npb = min(mgr.semantic.config.nprobe, parts.packed_emb.shape[0])
    probes = probe_lists(parts, q, npb).contiguous()
    case = k5_case(probes, q, parts.packed_emb, None, "stream", kind="real")
    case["shape"] += " (phase 9)"
    log_case("K5-stream", case)
    cases["K5"].append(case)

    # save, then a restart on the card (ticked) and the plain path on the CPU
    queries = [checks[:1], checks]
    t = time.perf_counter()
    save_index(mgr, root)
    rec["save_s"] = time.perf_counter() - t
    rec["bytes"] = dir_bytes(root)
    proj = mgr.embedder._proj.cpu().numpy()
    dproj = mgr.domain_embedder._proj.cpu().numpy()
    restored = {}
    for dev in ("cuda", "cpu"):
        emb = HashingEmbedder(dim=proj.shape[1], vocab_size=proj.shape[0], proj=proj,
                              device=dev)
        demb = HashingEmbedder(dim=dproj.shape[1], vocab_size=dproj.shape[0],
                               proj=dproj, device=dev)
        m = MultiIndexManager(PipelineConfig(), embedder=emb, domain_embedder=demb,
                              enable_domain=True, device=dev)
        t = time.perf_counter()
        load_index(m, root)
        if dev == "cuda":
            torch.cuda.synchronize()
        rec[f"load_{dev}_s"] = time.perf_counter() - t
        # postings are not saved: built without the deleted rows, as the
        # original's compaction left them (a restored manager's first
        # hybrid search would build them over every row, as the JAX
        # package's restore does)
        m.sparse.build_postings(valid=m.store._host_valid[: m.sparse.size])
        restored[dev] = m
    search = hybrid_answers(queries, domain_weight=0.2)
    exact = {dev: search(m) for dev, m in restored.items()}
    rec["card_vs_cpu_overlap"] = overlap(exact["cuda"], exact["cpu"])
    restored["cpu"].close()
    del restored["cpu"]
    card = restored["cuda"]
    # IVF partitions are not saved either: given the original's, the
    # restored manager must answer as the original
    sem = card.semantic
    sem._ivf, sem._ivf_size = mgr.semantic._ivf, mgr.semantic._ivf_size
    sem.config.nprobe = mgr.semantic.config.nprobe
    original, again = search(mgr), search(card)
    rec["restore_overlap"] = overlap(again, original)
    rec["restore_identical"] = sum(a == b for a, b in zip(again, original))
    # a restart's maintenance builds its own partitions
    sem._ivf, sem._ivf_size = None, 0
    rec["restart_tick"] = card.maintenance_tick()
    log(f"lifecycle[checkpoint]: {card.store.size} rows ({card.store.n_valid()} live) saved "
        f"in {rec['save_s']:.2f}s ({rec['bytes']} bytes), loaded on the card in "
        f"{rec['load_cuda_s']:.2f}s and on the CPU in {rec['load_cpu_s']:.2f}s; domain "
        f"rung card vs CPU plain path top-10 overlap {rec['card_vs_cpu_overlap']:.3f} "
        f"(Q = 1 and 32); restored vs original (its partitions) overlap "
        f"{rec['restore_overlap']:.3f}, {rec['restore_identical']}/{len(original)} "
        f"queries identical; the restart's tick {rec['restart_tick']}")
    if rec["card_vs_cpu_overlap"] < 0.9 or rec["restore_identical"] != len(original):
        raise AssertionError("the restored managers disagree with the original")
    if not rec["restart_tick"].get("ivf_rebuilt"):
        raise AssertionError("the restarted manager's tick built no IVF")
    card.close()
    mgr.close()
    del card, mgr
    torch.cuda.empty_cache()
    return rec, cases, proj


#: phase 9 (e): chunks appended to the restored PQ managers (the 90,000
#: rows stay within the 131,072 capacity, so the codes keep phase 3's shape)
#: and the rebuild fraction that makes their tick re-pack the IVF-PQ tier
PQ_LIFECYCLE_TAIL = 2048
PQ_LIFECYCLE_REPACK = 0.005


def phase_pq_lifecycle(root, proj):
    """Phase 9 (e): the PQ tier's lifecycle at the default width (1536, m =
    384).  For a semantic_dtype="pq" manager and a semantic_opq=True one,
    each restored from phase 9 (c)'s checkpoint under ``root`` (its 90,000
    rows, 13,500 of them deleted; without the sparse family, whose postings
    build over 90k rows takes seconds of host time a manager and whose
    lifecycle is 9 (c)'s): maintenance_tick's first build (PQ + IVF-PQ
    behind the recall guardrail; with OPQ the rotated flat codes only,
    unguarded), and the guardrail's sweep run on to nprobe = nlist, the
    recall a refusal would need to miss; search_sync and hybrid_search_batch_sync at Q = 1 and 32;
    PQ_LIFECYCLE_TAIL appended chunks (the IVF-PQ tail) and the tick's
    re-pack at the same nlist (the rebuild fraction lowered to
    PQ_LIFECYCLE_REPACK on the instance); last the manager saved and loaded
    into a fresh card manager (given the original's nprobe, which
    checkpoints do not hold), whose answers must be identical.  K6 must run
    on the 131,072 x 384 codes.  Returns the records."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.config import IndexType, PipelineConfig
    from advanced_rag_tpu_torch.index.corpus import ChunkRecord
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.models.embedder import HashingEmbedder
    from advanced_rag_tpu_torch.utils.checkpoint import load_index

    out = {}
    extra = synthetic_corpus(PQ_LIFECYCLE_TAIL, seed=14)

    def manager(opq):
        emb = HashingEmbedder(dim=proj.shape[1], vocab_size=proj.shape[0], proj=proj,
                              device="cuda")
        return MultiIndexManager(PipelineConfig(semantic_dtype="pq", semantic_opq=opq),
                                 embedder=emb, enable_sparse=False, device="cuda")

    for name, opq in (("pq", False), ("pq-opq", True)):
        rng = np.random.default_rng(61)
        rec = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        mgr = manager(opq)
        t = time.perf_counter()
        load_index(mgr, root)
        torch.cuda.synchronize()
        rec["restore_s"] = time.perf_counter() - t
        sem = mgr.semantic
        live = np.flatnonzero(mgr.store._host_valid[: mgr.store.size])
        texts = [mgr.store.contents[i] for i in rng.choice(live, min(4096, len(live)),
                                                            replace=False)]
        t = time.perf_counter()
        rec["first_tick"] = mgr.maintenance_tick()
        torch.cuda.synchronize()
        rec["first_tick_s"] = time.perf_counter() - t
        acts = rec["first_tick"]
        if not acts.get("pq_built") or sem.has_ivfpq == opq or (sem._pq_rot is None) != (
                not opq) or ("demotion_recall" in acts) == opq:
            raise AssertionError(f"pq lifecycle[{name}]: first tick {acts}")
        if (tuple(sem.emb.shape), sem._pq.m) != (PQ_WIDE, PQ_WIDE[1]):
            raise AssertionError(f"pq lifecycle[{name}]: codes {tuple(sem.emb.shape)} are not "
                                 f"{PQ_WIDE}: phase 3 missed their shape")
        rec["nprobe"] = sem.config.nprobe
        if sem.has_ivfpq:
            rec["nlist"], rec["cap"] = map(int, sem._ivfpq.packed_rows.shape)
            # the guardrail's margin: its sweep stops at the first nprobe that
            # reaches the target, so the recall it reports sits just above
            # it, and it refuses only when the deepest probe misses too.  The
            # same sweep on the same 64 sampled rows, to the end (nlist).
            deepest = sem.tune_nprobe(recall_target=2.0, k=10,
                                      sample=min(64, sem.size))[1]
            rec["guardrail_deepest_recall"] = round(float(deepest), 4)
            sem.config.nprobe = rec["nprobe"]

        def hybrid(nq, r):
            check_hits(mgr.hybrid_search_batch_sync(snippet_queries(rng, texts, nq), 10),
                       nq, 10)

        def semantic(nq, r):
            for qtext in snippet_queries(rng, texts, nq):
                if len(mgr.search_sync(IndexType.SEMANTIC, qtext, 10)) != 10:
                    raise AssertionError("search_sync returned too few hits")

        rec["hybrid"] = time_calls(hybrid, (1, 32))
        rec["search_sync"] = time_calls(semantic, (1, 32))
        # a tail, then the re-pack
        start = mgr.store.size
        t = time.perf_counter()
        rep = mgr.index_chunks([ChunkRecord(chunk_id=f"e{i}", doc_id=f"e{i // 4}",
                                            content=extra[i]) for i in range(len(extra))])
        torch.cuda.synchronize()
        rec["tail_ingest_s"] = time.perf_counter() - t
        if rep["indexed"] != len(extra) or sem.capacity != PQ_WIDE[0]:
            raise AssertionError(f"pq lifecycle[{name}]: tail ingest {rep['indexed']}, "
                                 f"capacity {sem.capacity}")
        probe = [extra[0]]
        top = mgr.search_sync(IndexType.SEMANTIC, probe[0], 1)
        rec["tail_probe_found"] = bool(top) and top[0]["chunk_id"] == "e0"
        rec["tail_fill"] = sem._ivfpq_fill if sem.has_ivfpq else None
        sem.REBUILD_TAIL_FRACTION = PQ_LIFECYCLE_REPACK
        t = time.perf_counter()
        rec["repack_tick"] = mgr.maintenance_tick()
        torch.cuda.synchronize()
        rec["repack_tick_s"] = time.perf_counter() - t
        want = ({"ivf_rebuilt": False} if opq else
                {"ivf_rebuilt": True, "ivf_rows": start + len(extra)})
        if rec["repack_tick"] != want or not rec["tail_probe_found"]:
            raise AssertionError(f"pq lifecycle[{name}]: the tail probe found "
                                 f"{rec['tail_probe_found']}, re-pack tick "
                                 f"{rec['repack_tick']}")
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["memory_bytes"] = sem.memory_bytes()
        rec["launches"] = read_counters()
        if rec["launches"]["K6"] == 0:
            raise AssertionError(f"pq lifecycle[{name}] ran no K6: {rec['launches']}")
        queries = [probe + texts[:7], snippet_queries(rng, texts, 32)]
        if sem.has_ivfpq:   # after the counters are read: a check, not the path
            rec["k6_cases"] = ivfpq_k6_cases(sem._ivfpq,
                                             mgr.embedder.encode_device(queries[1]),
                                             sem.config.nprobe, "phase 9 (e)")
        nprobe = sem.config.nprobe

        def answers(m):
            m.semantic.config.nprobe = nprobe
            return hybrid_answers(queries)(m) + [
                [(h["chunk_id"], h["score"]) for h in m.search_sync(IndexType.SEMANTIC, qt, 10)]
                for qt in queries[1]]

        rec["round_trip"] = index_round_trip(f"pq lifecycle {name}", mgr, manager(opq),
                                             answers, BUILD_DIR / f"pq-lifecycle-{name}")
        times = lambda b: "; ".join(  # noqa: E731
            f"Q={nq} p50 {v['p50_ms']:.2f} / p99 {v['p99_ms']:.2f} ms" for nq, v in b.items())
        log(f"pq lifecycle[{name}]: restored {mgr.store.size - len(extra)} rows in "
            f"{rec['restore_s']:.2f}s; first tick {rec['first_tick_s']:.2f}s {acts}"
            + (f" (nlist {rec['nlist']}, cap {rec['cap']}; the guardrail's sweep reaches "
               f"recall {rec['guardrail_deepest_recall']:.4f} at nprobe {rec['nlist']})"
               if "nlist" in rec else "")
            + f"; hybrid {times(rec['hybrid'])}; search_sync {times(rec['search_sync'])}; "
              f"{len(extra)} more chunks in {rec['tail_ingest_s']:.2f}s (tail probe found); "
              f"re-pack tick {rec['repack_tick_s']:.2f}s {rec['repack_tick']}; peak "
              f"{rec['peak_gb']:.2f} GB; memory_bytes {rec['memory_bytes']}; launches "
              f"{rec['launches']}")
        out[name] = rec
        mgr.close()
        del mgr, sem
        torch.cuda.empty_cache()
    return out


#: phase 10 (training), at the shipped geometry: the chunks of phase 4's
#: corpus the trainers read (pairs: each chunk and an inverse-cloze window of
#: it, tokenized once at max_len 256), the steps of each trainer, and the
#: mining of hard negatives for MINE_QUERIES of those pairs
TRAIN_CHUNKS = 20_000
TRAIN_BATCH = 128
TRAIN_STEPS = 40
TRAIN_CONFIG = dict(learning_rate=5e-4, warmup_steps=50, total_steps=3000)
PARITY_BATCH = 16
MINE_QUERIES = 1024
MINE_BATCH = 64
MINE_K = 8
HARD_NEGS = 3
HARD_NEG_STEPS = 20
RERANK_STEPS = 30
DISTILL_STEPS = 10
#: chunks of the fused managers that serve the trained encoders before the
#: save and after the reload
SERVE_CHUNKS = 8192
#: card vs CPU over two updates of one batch (phase 10 (a)): the loss and
#: the pre-clip gradient norm of each step within rtol; each tensor's
#: gradient in the first step (lr 0, so both from one init) within
#: grad_rtol of its own norm plus grad_atol of the whole gradient's (the
#: attention key biases' true gradient is zero: the atol holds their
#: rounding noise); after the second update, where Adam steps about
#: lr * sign(g) per element, at most a fraction ``far`` of the elements more
#: than lr / 2 from the CPU's, and the two total updates' cosine at least
#: the given value.  bf16's: its own distance from f32 at this geometry and
#: batch on the CPU is 3.0e-2 of a tensor's norm (1.7e-5 of the whole for a
#: key bias) and 1.1e-3 of the elements past lr / 2
PARITY_TOL = {"float32": dict(loss=1e-5, grad_norm=1e-4, grad_rtol=1e-4, grad_atol=1e-6,
                              far=1e-5, cosine=0.999),
              "bfloat16": dict(loss=2e-3, grad_norm=5e-3, grad_rtol=5e-2, grad_atol=1e-4,
                               far=3e-3, cosine=0.98)}


def memory_mark():
    """Zero the peak counter; returns the bytes allocated now (what the
    earlier phases still hold), which ``peak_gb_since`` takes off."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_gb_since(base):
    """GB of device memory at the peak since ``memory_mark``, beyond its
    baseline: the trainer's own."""
    import torch

    return (torch.cuda.max_memory_allocated() - base) / 1e9


def step_times(history, batch):
    """p50 ms per step (synchronized: each step's loss is read), first step
    ms and pairs per second, from a history logged at every step."""
    import numpy as np

    ends = np.asarray([h["elapsed_s"] for h in history]) * 1e3
    per = np.diff(np.concatenate([[0.0], ends]))
    p50 = float(np.percentile(per[1:], 50))
    return dict(steps=len(history), step_ms_p50=p50, first_step_ms=float(per[0]),
                pairs_per_s=batch / p50 * 1e3, first_loss=history[0]["loss"],
                last_loss=history[-1]["loss"])


def contrastive_parity(cfg, batch, init, card):
    """Two updates of one batch on the card and on the CPU from ``init``:
    (loss, grad_norm) per step, each tensor's gradient in the first step
    (after the clip) and the parameters after, per device."""
    from advanced_rag_tpu_torch.models.encoder import SHIPPED_BIENCODER_OUT_DIM, BiEncoder
    from advanced_rag_tpu_torch.train import TrainConfig, make_optimizer, make_train_step

    out = {}
    tcfg = TrainConfig(**TRAIN_CONFIG)
    for name, dev in (("cuda", card), ("cpu", "cpu")):
        model = BiEncoder(cfg, out_dim=SHIPPED_BIENCODER_OUT_DIM)
        step, params, opt = make_train_step(model, make_optimizer(tcfg), tcfg, None, init,
                                            device=dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        t = time.perf_counter()
        metrics = []
        for i in range(2):
            params, opt, m = step(params, opt, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                grads = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()}
        out[name] = dict(metrics=metrics, lr=opt.schedule(1), seconds=time.perf_counter() - t,
                         grads=grads,
                         params={k: v.detach().cpu() for k, v in params.items()})
    return out


def parity_record(name, got, init, what="card vs CPU", names=("card", "cpu")):
    """``got["cuda"]`` against ``got["cpu"]`` (the card against the CPU, or
    ``what`` else) within PARITY_TOL[name]; the record names them ``names``."""
    import torch

    tol = PARITY_TOL[name]
    card, cpu = got["cuda"], got["cpu"]
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(card["metrics"], cpu["metrics"]))
    gn_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(card["metrics"], cpu["metrics"]))
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in cpu["grads"].values())))
    grad_err, grad_fails = {}, []
    for k, want in cpu["grads"].items():
        err = float((card["grads"][k] - want).double().norm())
        norm = float(want.double().norm())
        grad_err[k] = err / max(norm, 1e-30)
        if err > tol["grad_rtol"] * norm + tol["grad_atol"] * total:
            grad_fails.append(k)
    worst = max((k for k in grad_err if "key.bias" not in k), key=grad_err.get)
    lr = card["lr"]
    diff = torch.cat([(card["params"][k] - cpu["params"][k]).flatten() for k in init])
    far = float((diff.abs() > lr / 2).sum()) / diff.numel()
    upd_card = torch.cat([(card["params"][k] - init[k]).flatten() for k in init]).double()
    upd_cpu = torch.cat([(cpu["params"][k] - init[k]).flatten() for k in init]).double()
    cos = float(torch.nn.functional.cosine_similarity(upd_card, upd_cpu, dim=0))
    rec = dict(loss_rel_err=loss_rel, grad_norm_rel_err=gn_rel, lr_second_update=lr,
               grad_rel_err_max=grad_err[worst], grad_rel_err_worst_tensor=worst,
               grad_tensors=len(grad_err), grad_tensors_failed=grad_fails,
               param_max_abs_diff=float(diff.abs().max()),
               param_max_abs_diff_in_lr=float(diff.abs().max()) / lr,
               param_far_fraction=far, update_cosine=cos, tolerances=tol,
               **{f"{names[0]}_metrics": card["metrics"], f"{names[1]}_metrics": cpu["metrics"],
                  f"{names[0]}_s": card["seconds"], f"{names[1]}_s": cpu["seconds"]})
    log(f"training[parity {name}]: {what} over 2 updates of one batch: "
        f"loss rel err {loss_rel:.3g} (tol {tol['loss']}), grad_norm rel err {gn_rel:.3g} "
        f"(tol {tol['grad_norm']}); first-step gradients of {len(grad_err)} tensors: worst "
        f"rel err {grad_err[worst]:.3g} ({worst}; tol {tol['grad_rtol']} + "
        f"{tol['grad_atol']} of the whole), {len(grad_fails)} outside; params max |diff| "
        f"{rec['param_max_abs_diff_in_lr']:.3g} lr, {far:.3g} of the elements past lr/2 (tol "
        f"{tol['far']}), update cosine {cos:.6f} (tol >= {tol['cosine']}); {names[0]} "
        f"{card['seconds']:.2f}s, {names[1]} {cpu['seconds']:.2f}s")
    if not (loss_rel <= tol["loss"] and gn_rel <= tol["grad_norm"] and not grad_fails
            and far <= tol["far"] and cos >= tol["cosine"]):
        raise AssertionError(f"training disagrees ({what}, {name}): "
                             f"{ {k: v for k, v in rec.items() if 'metrics' not in k} }")
    return rec


def timed_steps(step, params, opt, batch, *extra, n=12):
    """p50 ms of the last n - 2 of n steps of ``step`` on one batch, each
    synchronized (the loss is read), and one more step under torch.profiler:
    its wall ms, device busy ms (the sum of its kernels' times; one stream)
    and the idle share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    times = []
    for _ in range(n):
        t = time.perf_counter()
        params, opt, m = step(params, opt, batch, *extra)
        float(m["loss"])
        times.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        params, opt, m = step(params, opt, batch, *extra)
        float(m["loss"])
        wall = (time.perf_counter() - t) * 1e3
    busy = sum(ev.time_range.elapsed_us() / 1e3 for ev in device_events(prof))
    if busy == 0.0:
        raise AssertionError("the profiler recorded no device kernels")
    return dict(step_ms_p50=float(np.percentile(times[2:], 50)), profiled_wall_ms=wall,
                device_ms=busy, idle_share=max(0.0, 1.0 - busy / wall))


def rotating(call, operands):
    """``call(operands)`` over enough copies of ``operands`` (a tensor or a
    tuple of tensors), one copy after another, that the bytes read between
    two reads of one copy are at least twice the card's L2: every timed call
    then reads its operands from device memory, as the bound assumes."""
    import itertools

    import torch

    group = operands if isinstance(operands, tuple) else (operands,)
    size = sum(o.values().nbytes + o.col_indices().nbytes + o.crow_indices().nbytes
               if o.layout == torch.sparse_csr else o.nbytes for o in group)
    copies = 1 + -(-2 * L2_BYTES // size)
    sets = [operands] + [tuple(o.clone() for o in group) if isinstance(operands, tuple)
                         else operands.clone() for _ in range(copies - 1)]
    it = itertools.cycle(sets)
    return lambda: call(next(it))


def mining_kernel_cases(mgr, queries):
    """K1 and K3 against their plain versions on the tensors that phase
    10's mining searches: its bf16 rows, its BM25 slots and row mask, and
    a batch of MINE_BATCH real training queries; the bounds as phase 3
    counts them.  These operands would fit in the L2 (K1's rows take 25
    MB), so every timing here rotates through copies of them (``rotating``)."""
    import torch

    from advanced_rag_tpu_torch.ops import dense_kernels as dk
    from advanced_rag_tpu_torch.ops import sparse_kernels as sk
    from advanced_rag_tpu_torch.ops.dense import mask_additive
    from advanced_rag_tpu_torch.ops.sparse import live_avg_len, query_weights

    dev = mgr.device
    sem, sp = mgr.semantic, mgr.sparse
    valid = mgr._row_mask(None)
    m = mask_additive(valid, sem.capacity, dev)
    rows = sem.emb
    n, d = rows.shape
    nq = len(queries)
    q = mgr.embedder.encode_device(queries).float().contiguous()
    err, rel, swaps = compare(dk.dense_scores(q, rows, m), dk.dense_scores_plain(q, rows, m),
                              1e-5)
    qb = q.to(torch.bfloat16)
    b_ms, b_by = bound(n * d * 2 + nq * d * 4 + n * 4 + nq * n * 4, 3 * 2.0 * nq * n * d,
                       BF16_OPS_PER_S)
    kernel = rotating(lambda r: dk.dense_scores(q, r, m), rows)
    plain = rotating(lambda r: dk.dense_scores_plain(q, r, m), rows)
    lib = rotating(lambda r: torch.matmul(qb, r.T), rows)
    k1 = dict(shape=f"bf16 rows N={n} D={d} Q={nq} (phase 10, mining)", main=False,
              max_abs_err=err, rel_err=rel, tie_swaps=swaps, ms=graph_ms(kernel),
              call_ms=cuda_ms(kernel), plain_ms=cuda_ms(plain, reps=3),
              library_ms=graph_ms(lib), library_call_ms=cuda_ms(lib),
              library="torch.matmul bf16 [Q, D] x [D, N]", bound_ms=b_ms, bound_by=b_by)
    log_case("K1", k1)
    del kernel, plain, lib
    q_idx, q_tf = sp.encode_query(queries)
    q_idx = torch.from_numpy(q_idx).to(dev).to(torch.int32).contiguous()
    n_docs = torch.tensor(float(max(sp.n_docs, 1)), device=dev)
    q_w = query_weights(q_idx, torch.from_numpy(q_tf).to(dev), sp.df, n_docs, "bm25")
    q_w = q_w.contiguous()
    avg_len = float(live_avg_len(sp.doc_len, valid))
    args = (q_idx, q_w, sp.idx_t, sp.tf_t, sp.doc_len, m, 1.2, 0.75, avg_len, "bm25")
    err, rel, swaps = compare(sk.bm25_scores(*args), sk.bm25_scores_plain(*args), 1e-5)
    p, t = sp.idx_t.shape[0], q_idx.shape[1]
    live = int((sp.idx_t >= 0).sum())
    b_ms, b_by = bound(p * n * 6 + n * 8 + nq * t * 8 + nq * n * 4, 2.0 * live * nq,
                       F32_OPS_PER_S)
    # the library's operands as phase 3 builds them: the [N, V] CSR matrix of
    # each row's tfw and the dense [V, Q] table of the queries' weights
    vocab = sp.vocab_size
    tfw = sk.slot_weights(sp.idx_t, sp.tf_t, sp.doc_len, 1.2, 0.75, avg_len, "bm25").T
    cols = sp.idx_t.T.long()
    live_rc = cols >= 0
    rows_rc = torch.arange(n, device=dev)[:, None].expand(n, p)[live_rc]
    csr = torch.sparse_coo_tensor(torch.stack([rows_rc, cols[live_rc]]), tfw[live_rc],
                                  (n, vocab), check_invariants=False).coalesce().to_sparse_csr()
    ids, w = sk.bm25_query_table(q_idx, q_w)
    wd = torch.zeros((vocab, nq), dtype=torch.float32, device=dev)
    wd[ids.long()] = w
    del tfw, cols, live_rc, rows_rc
    kernel = rotating(lambda s: sk.bm25_scores(q_idx, q_w, s[0], s[1], *args[4:]),
                      (sp.idx_t, sp.tf_t))
    plain = rotating(lambda s: sk.bm25_scores_plain(q_idx, q_w, s[0], s[1], *args[4:]),
                     (sp.idx_t, sp.tf_t))
    lib = rotating(lambda c: torch.sparse.mm(c, wd), csr)
    k3 = dict(shape=f"N={n} P={p} T={t} Q={nq} (phase 10, mining)", main=False,
              max_abs_err=err, rel_err=rel, tie_swaps=swaps, ms=graph_ms(kernel),
              call_ms=cuda_ms(kernel), plain_ms=cuda_ms(plain, reps=2, warmup=1),
              library_ms=graph_ms(lib), library_call_ms=cuda_ms(lib),
              library="torch.sparse.mm [N, V] CSR x [V, Q]", bound_ms=b_ms, bound_by=b_by)
    log_case("K3", k3)
    del kernel, plain, lib, csr
    torch.cuda.empty_cache()
    return {"K1": [k1], "K3": [k3]}


def zscore(v):
    import numpy as np

    v = np.asarray(v, np.float64)
    sd = v.std()
    return (v - v.mean()) / (sd if sd > 1e-9 else 1.0)


def phase_training(texts, root, dev="cuda"):
    """Phase 10: the port's trainers at the shipped geometry, on the card.

    (a) train_biencoder (SHIPPED_BIENCODER, out_dim 384, TRAIN_CONFIG,
    batch TRAIN_BATCH of pre-tokenized pairs over TRAIN_CHUNKS chunks,
    TRAIN_STEPS steps) and, from one init and one batch, two updates on
    the card against the same on the CPU in f32 and bf16 (PARITY_TOL);
    (b) hard negatives mined for MINE_QUERIES of the pairs through a bf16
    manager over the chunks with (a)'s model (hybrid_search_batch_sync,
    K1 and K3), filtered by filter_false_negatives, HARD_NEGS each, and
    their base scores from rescore_candidates_sync; (c) HARD_NEG_STEPS
    contrastive steps with the mined negatives, from (a)'s weights;
    (d) train_reranker (SHIPPED_RERANKER, warm-started from (a), residual,
    label smoothing 0.05, early stopping), after a check that its dropout
    is live and seeded; (e) distill_cross_encoder with (a)'s model as the
    teacher; (f) (c)'s bi-encoder and (d)'s reranker saved, reloaded and
    served by a fused manager, which must answer as one serving the
    in-memory models; (a)'s model must be unchanged by (d) and (e).
    Returns the record and the kernel cases held against their plain
    versions."""
    import dataclasses

    import numpy as np
    import torch

    from advanced_rag_tpu_torch.config import PipelineConfig
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.models.cross_encoder import CrossEncoderReranker
    from advanced_rag_tpu_torch.models.embedder import NeuralEmbedder
    from advanced_rag_tpu_torch.models.encoder import (
        SHIPPED_BIENCODER, SHIPPED_BIENCODER_OUT_DIM, SHIPPED_RERANKER, BiEncoder,
        CrossEncoder, init_bi_encoder, init_cross_encoder)
    from advanced_rag_tpu_torch.models.tokenizer import HashingTokenizer, TokenizerConfig
    from advanced_rag_tpu_torch.train import (
        DistillConfig, RerankTrainConfig, TrainConfig, TrainLoopConfig,
        distill_cross_encoder, filter_false_negatives, load_biencoder, load_reranker,
        make_optimizer, make_train_step, save_biencoder, save_reranker, train_biencoder,
        train_reranker, warm_start_cross_encoder)
    from advanced_rag_tpu_torch.train.contrastive import cloze_query
    from advanced_rag_tpu_torch.train.rerank import make_rerank_batch, make_rerank_step

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    out_dim = SHIPPED_BIENCODER_OUT_DIM
    bi_cfg, ce_cfg = SHIPPED_BIENCODER, SHIPPED_RERANKER
    rec = {}
    chunks = list(texts[:TRAIN_CHUNKS])
    tok = HashingTokenizer(TokenizerConfig(vocab_size=bi_cfg.vocab_size,
                                           max_len=bi_cfg.max_len))
    rng = np.random.default_rng(13)
    t = time.perf_counter()
    queries = [cloze_query(c, rng) for c in chunks]
    arrays = dict(zip(("q_ids", "q_mask"), tok.encode_batch(queries, bi_cfg.max_len)))
    arrays.update(zip(("d_ids", "d_mask"), tok.encode_batch(chunks, bi_cfg.max_len)))
    pairs_dev = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    rec["tokenize_s"] = time.perf_counter() - t
    log(f"training: {len(chunks)} pairs tokenized at max_len {bi_cfg.max_len} in "
        f"{rec['tokenize_s']:.2f}s")

    def pair_fn(r):
        sel = torch.from_numpy(r.integers(0, len(chunks), TRAIN_BATCH)).to(dev)
        return {k: v[sel] for k, v in pairs_dev.items()}

    # (a) contrastive training
    tcfg = TrainConfig(**TRAIN_CONFIG)
    base = memory_mark()
    bi_model, bi_params, hist = train_biencoder(
        chunks, encoder_config=bi_cfg, out_dim=out_dim, train_config=tcfg,
        loop_config=TrainLoopConfig(steps=TRAIN_STEPS, batch_size=TRAIN_BATCH,
                                    eval_every=TRAIN_STEPS, eval_pairs=64, log_every=1),
        pair_fn=pair_fn, device=dev)
    a = step_times(hist, TRAIN_BATCH)
    a.update(peak_gb=peak_gb_since(base),
             eval_recall_at_1=hist[-1]["eval_recall_at_1"])
    rec["contrastive"] = a
    log(f"training[contrastive]: {TRAIN_STEPS} steps of {TRAIN_BATCH} pairs: p50 "
        f"{a['step_ms_p50']:.2f} ms per step (first {a['first_step_ms']:.1f}), "
        f"{a['pairs_per_s']:.0f} pairs/s, peak device memory {a['peak_gb']:.2f} GB (above "
        f"what the earlier phases hold; so each trainer's peak below); loss "
        f"{a['first_loss']:.4f} -> {a['last_loss']:.4f}, eval recall@1 "
        f"{a['eval_recall_at_1']:.3f}")
    if not (np.isfinite([h["loss"] for h in hist]).all() and a["last_loss"] < a["first_loss"]):
        raise AssertionError(f"contrastive training did not lower the loss: {a}")

    cmodel = BiEncoder(bi_cfg, out_dim=out_dim)
    step, p, o = make_train_step(cmodel, make_optimizer(tcfg), tcfg, None, bi_params,
                                 device=dev)
    a.update({f"single_{k}": v for k, v in timed_steps(
        step, p, o, pair_fn(np.random.default_rng(1))).items()})
    log(f"training[contrastive]: one step of {TRAIN_BATCH} pairs p50 "
        f"{a['single_step_ms_p50']:.2f} ms; profiled: wall {a['single_profiled_wall_ms']:.2f} "
        f"ms, device busy {a['single_device_ms']:.2f} ms, idle share "
        f"{a['single_idle_share']:.3f}")
    del cmodel, step, p, o
    sel = np.arange(PARITY_BATCH)
    batch = {k: torch.from_numpy(v[sel]) for k, v in arrays.items()}
    batch["n_ids"], batch["n_mask"] = batch["d_ids"].roll(1, 0), batch["d_mask"].roll(1, 0)
    init = {k: v.cpu() for k, v in init_bi_encoder(bi_cfg, out_dim, seed=3,
                                                   device="cpu")[1].items()}
    rec["parity"] = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        got = contrastive_parity(dataclasses.replace(bi_cfg, dtype=dtype), batch, init, dev)
        rec["parity"][name] = parity_record(name, got, init)

    # (b) hard negatives mined through the port's manager (K1 and K3)
    a_snapshot = {k: v.detach().cpu().clone() for k, v in bi_params.items()}
    embedder = NeuralEmbedder(dim=out_dim, config=bi_cfg, state_dict=bi_params,
                              tokenizer=tok, device=dev)
    pcfg = PipelineConfig(semantic_dtype="bfloat16")
    pcfg.semantic_dim = out_dim
    mgr = MultiIndexManager(pcfg, embedder=embedder, device=dev)
    t = time.perf_counter()
    ingest_all(mgr, chunks)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t
    mine_rows = np.sort(rng.choice(len(chunks), MINE_QUERIES, replace=False))
    neg_rows = np.zeros((MINE_QUERIES, HARD_NEGS), np.int64)
    based, filtered, topped = [], 0, 0
    reset_counters()
    t = time.perf_counter()
    for lo in range(0, MINE_QUERIES, MINE_BATCH):
        rows = mine_rows[lo:lo + MINE_BATCH]
        batch_q = [queries[r] for r in rows]
        out = mgr.hybrid_search_batch_sync(batch_q, MINE_K, use_mmr=False,
                                           dense_weight=0.5, sparse_weight=0.5)
        cand = np.full((len(rows), 1 + HARD_NEGS), -1, np.int32)
        for b, (gold, hits) in enumerate(zip(rows, out)):
            negs = []
            for h in hits:
                r = int(h["row"])
                if h["chunk_id"] != f"c{r}":
                    raise AssertionError("mining: a hit's row is not its chunk's")
                if r == gold or r in negs:
                    continue
                if not filter_false_negatives(chunks[gold], [chunks[r]], 0.8):
                    filtered += 1
                    continue
                negs.append(r)
                if len(negs) == HARD_NEGS:
                    break
            while len(negs) < HARD_NEGS:
                j = int(rng.integers(0, len(chunks)))
                if j != gold and j not in negs:
                    negs.append(j)
                    topped += 1
            cand[b] = [gold] + negs
            neg_rows[lo + b] = negs
        dense, bm25 = mgr.rescore_candidates_sync(batch_q, cand)
        for b in range(len(rows)):
            base = zscore(0.5 * zscore(dense[b]) + 0.5 * zscore(bm25[b]))
            based.append((float(base[0]), [float(x) for x in base[1:]]))
    torch.cuda.synchronize()
    mine_s = time.perf_counter() - t
    mining_launches = read_counters()
    rec["mining"] = dict(ingest_s=ingest_s, mine_s=mine_s,
                         queries_per_s=MINE_QUERIES / mine_s, filtered=filtered,
                         topped_up=topped, launches=mining_launches)
    log(f"training[mining]: {len(chunks)} chunks ingested in {ingest_s:.2f}s; "
        f"{MINE_QUERIES} queries mined in {mine_s:.2f}s ({MINE_QUERIES / mine_s:.0f}/s), "
        f"{filtered} near-duplicates filtered, {topped} negatives topped up at random; "
        f"launches {mining_launches}")
    if mining_launches["K1"] == 0 or mining_launches["K3"] == 0:
        raise AssertionError(f"mining ran no K1 or K3: {mining_launches}")
    cases = mining_kernel_cases(mgr, [queries[r] for r in mine_rows[:MINE_BATCH]])
    mgr.close()
    del mgr, embedder
    torch.cuda.empty_cache()

    # (c) contrastive steps with the mined hard negatives, from (a)'s weights
    hard = BiEncoder(bi_cfg, out_dim=out_dim)
    hcfg = TrainConfig(learning_rate=TRAIN_CONFIG["learning_rate"], warmup_steps=5,
                       total_steps=TRAIN_CONFIG["total_steps"])
    step, hard_params, opt = make_train_step(hard, make_optimizer(hcfg), hcfg, None,
                                             bi_params, device=dev)
    mine_t = torch.from_numpy(mine_rows).to(dev)
    neg_t = torch.from_numpy(neg_rows).to(dev)
    base = memory_mark()
    hist, t0 = [], time.perf_counter()
    for _ in range(HARD_NEG_STEPS):
        sel = torch.from_numpy(rng.integers(0, MINE_QUERIES, TRAIN_BATCH)).to(dev)
        rows, negs = mine_t[sel], neg_t[sel].reshape(-1)
        b = {k: v[rows] for k, v in pairs_dev.items()}
        b["n_ids"], b["n_mask"] = pairs_dev["d_ids"][negs], pairs_dev["d_mask"][negs]
        hard_params, opt, m = step(hard_params, opt, b)
        hist.append(dict(loss=float(m["loss"]), accuracy=float(m["accuracy"]),
                         elapsed_s=time.perf_counter() - t0))
    c = step_times(hist, TRAIN_BATCH)
    c.update(peak_gb=peak_gb_since(base), negatives_per_pair=HARD_NEGS)
    rec["hard_negatives"] = c
    log(f"training[hard negatives]: {HARD_NEG_STEPS} steps of {TRAIN_BATCH} pairs + "
        f"{TRAIN_BATCH * HARD_NEGS} mined negatives: p50 {c['step_ms_p50']:.2f} ms per step, "
        f"{c['pairs_per_s']:.0f} pairs/s, peak {c['peak_gb']:.2f} GB; loss "
        f"{c['first_loss']:.4f} -> {c['last_loss']:.4f}")
    if not np.isfinite([h["loss"] for h in hist]).all():
        raise AssertionError("non-finite loss in the hard-negative steps")

    # (d) the reranker: dropout live and seeded, then train_reranker
    pairs = [(queries[r], chunks[r]) for r in mine_rows]
    negatives = [[chunks[j] for j in negs] for negs in neg_rows]
    rcfg = RerankTrainConfig(steps=RERANK_STEPS, queries_per_batch=8,
                             candidates_per_query=1 + HARD_NEGS, log_every=10, q_len=32,
                             d_len=216, residual=True, label_smoothing=0.05,
                             early_stop_patience=4)
    rtcfg = TrainConfig(learning_rate=3e-4, warmup_steps=100, total_steps=RERANK_STEPS)
    ce_init = warm_start_cross_encoder(init_cross_encoder(ce_cfg, seed=0, device=dev)[1],
                                       bi_params)
    drop_batch = make_rerank_batch(tok, pairs, negatives, rcfg, np.random.default_rng(5),
                                   base_scores=based, device=dev)

    def dropout_loss(seed):
        step, eval_fn, p, o = make_rerank_step(CrossEncoder(ce_cfg), make_optimizer(rtcfg),
                                               rtcfg, None, ce_init, rcfg, device=dev)
        if seed is None:
            return float(eval_fn(p, drop_batch)[0])
        _, _, m = step(p, o, drop_batch, torch.Generator(device=dev).manual_seed(seed))
        return float(m["loss"])

    drop = dict(seed_7=dropout_loss(7), seed_7_again=dropout_loss(7),
                seed_8=dropout_loss(8), eval=dropout_loss(None))
    log(f"training[reranker]: dropout {ce_cfg.dropout}: train-step loss with generator "
        f"seed 7 {drop['seed_7']:.6f}, again {drop['seed_7_again']:.6f}, seed 8 "
        f"{drop['seed_8']:.6f}; eval (no dropout) {drop['eval']:.6f}")
    if not (drop["seed_7"] == drop["seed_7_again"] and drop["seed_7"] != drop["seed_8"]
            and drop["seed_7"] != drop["eval"]):
        raise AssertionError(f"the reranker's dropout is not live and seeded: {drop}")
    step, _, p, o = make_rerank_step(CrossEncoder(ce_cfg), make_optimizer(rtcfg), rtcfg,
                                     None, ce_init, rcfg, device=dev)
    rerank_step = timed_steps(step, p, o, drop_batch,
                              torch.Generator(device=dev).manual_seed(9))
    rerank_step_ms = rerank_step["step_ms_p50"]
    del step, p, o
    base = memory_mark()
    t = time.perf_counter()
    ce_model, ce_params, rhist = train_reranker(
        pairs, negatives, encoder_config=ce_cfg, train_config=rtcfg, rerank_config=rcfg,
        tokenizer=tok, warm_start_params=bi_params, base_scores=based, device=dev)
    torch.cuda.synchronize()
    pairs_per_step = rcfg.queries_per_batch * rcfg.candidates_per_query
    d = dict(seconds=time.perf_counter() - t, history=rhist, dropout_losses=drop,
             peak_gb=peak_gb_since(base),
             ms_per_step=rhist[-1]["elapsed_s"] / rhist[-1]["step"] * 1e3,
             pairs_per_s=pairs_per_step / rerank_step_ms * 1e3, **rerank_step)
    rec["reranker"] = d
    last = rhist[-1]
    log(f"training[reranker]: one step of {pairs_per_step} pairs of 249 tokens p50 "
        f"{rerank_step_ms:.2f} ms ({d['pairs_per_s']:.0f} pairs/s; profiled: wall "
        f"{d['profiled_wall_ms']:.2f} ms, device busy {d['device_ms']:.2f} ms, idle share "
        f"{d['idle_share']:.3f}); train_reranker: "
        f"{last['step']} steps in {d['seconds']:.2f}s ({d['ms_per_step']:.1f} ms per step "
        f"with the host's batches and the evals), peak "
        f"{d['peak_gb']:.2f} GB; loss {rhist[0]['loss']:.4f} -> {last['loss']:.4f}, held-out "
        f"eval loss {rhist[0]['eval_loss']:.4f} -> {last['eval_loss']:.4f}, accuracy "
        f"{last['eval_accuracy']:.3f} (base-score floor {last['eval_base_accuracy']:.3f})"
        + (f", early stop at the best step {last['best_step']}" if "best_step" in last
           else ""))
    if not np.isfinite([h["eval_loss"] for h in rhist]).all():
        raise AssertionError("non-finite eval loss in the reranker's training")

    # (e) distillation from (a)'s model
    base = memory_mark()
    dcfg = DistillConfig(steps=DISTILL_STEPS, log_every=5)
    t = time.perf_counter()
    _, distilled, dhist = distill_cross_encoder(
        chunks, bi_model, None, encoder_config=ce_cfg,
        train_config=TrainConfig(learning_rate=1e-4, warmup_steps=2,
                                 total_steps=DISTILL_STEPS),
        distill_config=dcfg, device=dev)
    torch.cuda.synchronize()
    e = dict(seconds=time.perf_counter() - t, history=dhist,
             peak_gb=peak_gb_since(base),
             ms_per_step=dhist[-1]["elapsed_s"] / DISTILL_STEPS * 1e3)
    rec["distill"] = e
    log(f"training[distill]: {DISTILL_STEPS} steps of {dcfg.queries_per_batch} x "
        f"{dcfg.candidates_per_query} pairs in {e['seconds']:.2f}s ({e['ms_per_step']:.1f} ms "
        f"per step with the host's batches and the teacher), peak {e['peak_gb']:.2f} GB; KL "
        f"{dhist[0]['loss']:.4f} -> {dhist[-1]['loss']:.4f}, eval KL "
        f"{dhist[0]['eval_loss']:.4f} -> {dhist[-1]['eval_loss']:.4f}")
    if not np.isfinite([h["eval_loss"] for h in dhist]).all():
        raise AssertionError("non-finite eval loss in the distillation")
    from advanced_rag_tpu_torch.train.distill import (make_distill_batch, make_distill_step,
                                                      make_teacher_fn)

    dbatch, dq, dd = make_distill_batch(tok, chunks, dcfg, np.random.default_rng(3),
                                        ce_cfg.max_len, device=dev)
    teacher = make_teacher_fn(bi_model, None, tok, bi_cfg.max_len, dcfg.teacher_temperature)
    dbatch["teacher"] = torch.from_numpy(teacher(dq, dd)).to(dev)
    dtcfg = TrainConfig(learning_rate=1e-4, warmup_steps=2, total_steps=DISTILL_STEPS)
    step, _, p, o = make_distill_step(CrossEncoder(ce_cfg), make_optimizer(dtcfg), dtcfg,
                                      None, distilled, dcfg, device=dev)
    e.update(timed_steps(step, p, o, dbatch))
    e["pairs_per_s"] = dcfg.queries_per_batch * dcfg.candidates_per_query \
        / e["step_ms_p50"] * 1e3
    log(f"training[distill]: one step of {dcfg.queries_per_batch * dcfg.candidates_per_query} "
        f"pairs of {ce_cfg.max_len} tokens p50 {e['step_ms_p50']:.2f} ms "
        f"({e['pairs_per_s']:.0f} pairs/s; profiled: wall {e['profiled_wall_ms']:.2f} ms, "
        f"device busy {e['device_ms']:.2f} ms, idle share {e['idle_share']:.3f})")
    del step, p, o
    unchanged = all(torch.equal(v.detach().cpu(), a_snapshot[k]) for k, v in bi_params.items())
    rec["warm_start_source_unchanged"] = unchanged
    if not unchanged:
        raise AssertionError("training the reranker or the student changed the bi-encoder")
    del distilled

    # (f) save, reload, serve
    t = time.perf_counter()
    save_biencoder(hard_params, bi_cfg, out_dim, root / "biencoder")
    save_reranker(ce_params, ce_cfg, root / "reranker", q_len=rcfg.q_len, d_len=rcfg.d_len)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    l_cfg, l_dim, l_bi = load_biencoder(root / "biencoder", device=dev)
    l_ce_cfg, l_ce, layout = load_reranker(root / "reranker", device=dev)
    load_s = time.perf_counter() - t
    if (l_cfg, l_dim, l_ce_cfg, layout) != (bi_cfg, out_dim, ce_cfg,
                                            {"q_len": rcfg.q_len, "d_len": rcfg.d_len}):
        raise AssertionError("the reloaded encoders' geometry differs from the saved")
    serve_q = lifecycle_queries(np.random.default_rng(17), chunks[:SERVE_CHUNKS])
    answers = []
    reset_counters()
    for state_bi, state_ce in ((hard_params, ce_params),
                               (l_bi.state_dict(), l_ce.state_dict())):
        cfg = PipelineConfig(fused_rerank=True, semantic_dtype="bfloat16")
        cfg.semantic_dim = out_dim
        emb = NeuralEmbedder(dim=out_dim, config=bi_cfg, state_dict=state_bi, tokenizer=tok,
                             device=dev)
        rr = CrossEncoderReranker(config=ce_cfg, state_dict=state_ce, tokenizer=tok,
                                  device=dev, **layout)
        serving = MultiIndexManager(cfg, embedder=emb, device=dev)
        ingest_all(serving, chunks[:SERVE_CHUNKS])
        answers.append(fused_answers(rr, serve_q)(serving))
        serving.close()
    torch.cuda.synchronize()
    serve_launches = read_counters()
    same = answers[0] == answers[1]
    rec["reload"] = dict(save_s=save_s, load_s=load_s, queries=len(answers[0]),
                         identical=same, launches=serve_launches,
                         bytes={k: dir_bytes(root / k) for k in ("biencoder", "reranker")})
    log(f"training[reload]: saved in {save_s:.2f}s ({rec['reload']['bytes']} bytes), "
        f"loaded in {load_s:.2f}s; a fused manager over {SERVE_CHUNKS} chunks serving the "
        f"reloaded encoders answers {len(answers[0])} queries with the same ids and scores "
        f"as the in-memory ones: {same}; launches {serve_launches}")
    if not same or any(len(h) != SERVE["k_final"] for h in answers[0]):
        raise AssertionError("the reloaded encoders do not serve as the trained ones")
    rec["launches"] = {k: mining_launches[k] + serve_launches[k] for k in KERNEL_KEYS}
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"training: phase 10 took {rec['seconds']:.2f}s")
    return rec, cases


#: phase 11 (the sharded paths, parallel/ and the training mesh): the ranks
#: that share the card over Gloo in (b); the dense / sparse top-k; the
#: hybrid's and the retrieve + rerank program's knobs; the queries of the
#: 1M-row IVF checks; the parent's limit for a group of ranks to finish
SHARD_RANKS = 4
SHARD_K = 10
SHARD_HYBRID = dict(k_cand=96, k_out=48)
SHARD_E2E = dict(k_cand=96, k_out=48, k_rerank=48, k_final=10, use_mmr=True)
SHARD_TIER_Q = 32
#: the IVF-PQ subspaces held to the JAX test's bound (the exact top 10 in
#: depth 40 at full probe, 0.9): one dim a subspace.  At the auto m (PQ_M =
#: 96, 4-dim subspaces of 16 centroids) rank 0's own index, searched alone,
#: must not fall more than SHARD_IVFPQ_WITNESS below the recall of the
#: unsharded build_ivfpq (its default knobs) over the same rows, each
#: against the rank's exact top 10: the sharded build adds no loss of its
#: own
SHARD_IVFPQ_M = 384
SHARD_IVFPQ_WITNESS = 0.05
SHARD_JOIN_S = 420
#: phase 11 (c): the reranker's and the distillation's batch geometry
SHARD_RERANK = dict(queries_per_batch=16, candidates_per_query=8, q_len=32, d_len=216)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_group(backend, rank, world, port):
    """The default process group on 127.0.0.1 with a 60 s timeout, so that a
    collective that waits forever fails instead."""
    import torch

    from advanced_rag_tpu_torch.parallel.mesh import init_world

    torch.cuda.set_device(0)
    init_world(backend, f"tcp://127.0.0.1:{port}", rank, world, 60)


def shard_rows(ckpt, tokens_path, lo, hi, pq_cb):
    """Rows [lo, hi) of phase 9 (b)'s bf16 checkpoint on the card, read from
    its files alone: the bf16 rows, their SQ8 codes and scales (quantized
    from the f32 mirror, as a restore does), their PQ codes by ``pq_cb``,
    the [P, rows] slot mirror (bf16 tf), lengths, the valid column and the
    token table's rows."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.ops.pq import pq_encode_device
    from advanced_rag_tpu_torch.ops.quant import sq8_quantize

    dev = torch.device("cuda")
    put = lambda a: torch.from_numpy(np.array(a, order="C")).to(dev)  # noqa: E731
    mirror = put(np.load(ckpt / "dense_semantic.npy", mmap_mode="r")[lo:hi])
    sp = np.load(ckpt / "sparse.npz")
    c = dict(emb=mirror.to(torch.bfloat16),
             valid=put(np.load(ckpt / "columns.npz")["valid"][lo:hi].astype(bool)),
             idx_t=put(sp["doc_idx"][lo:hi].T).to(torch.int32),
             tf_t=put(sp["doc_tf"][lo:hi].T).to(torch.bfloat16),
             doc_len=put(sp["doc_len"][lo:hi]).float(),
             tokens=put(np.load(tokens_path, mmap_mode="r")[lo:hi]))
    c["codes"], c["scale"] = sq8_quantize(mirror)
    c["pq"] = pq_encode_device(c["emb"], pq_cb.to(dev))
    return c


def f32_encoders(work):
    """Phase 9 (a)'s saved bi-encoder and cross-encoder, in f32 activations."""
    import dataclasses

    import torch

    from advanced_rag_tpu_torch.models.encoder import BiEncoder, CrossEncoder
    from advanced_rag_tpu_torch.train import load_biencoder, load_reranker

    cfg, out_dim, bi = load_biencoder(work / "biencoder", device="cuda")
    ce_cfg, ce, _ = load_reranker(work / "reranker", device="cuda")
    bi32 = BiEncoder(dataclasses.replace(cfg, dtype=torch.float32), out_dim=out_dim)
    ce32 = CrossEncoder(dataclasses.replace(ce_cfg, dtype=torch.float32))
    bi32.load_state_dict(bi.state_dict())
    ce32.load_state_dict(ce.state_dict())
    return bi32.to("cuda").eval(), ce32.to("cuda").eval()


def sharded_programs(mesh, c, inp, bi, ce):
    """name -> fn(nq) for phase 11's calls on this rank's shard ``c``: the
    sharded dense top-k (bf16 K1, SQ8 K2), BM25 (K3), the fused hybrid on
    the scan, sq8 and pq (K6) rungs and the retrieve + rerank program, on
    the queries of ``inp`` at Q = nq (whole on every rank)."""
    import torch

    from advanced_rag_tpu_torch.parallel import (make_sharded_retrieve_rerank,
                                                 sharded_dense_topk, sharded_hybrid_retrieve,
                                                 sharded_sparse_topk)

    dev = torch.device("cuda")
    df, n_docs = inp["df"].to(dev), torch.tensor(inp["n_docs"], device=dev)
    w, lam = torch.tensor([0.7, 0.3], device=dev), torch.tensor(0.8, device=dev)
    qs = {}
    for nq, (q_ids, q_mask, q_idx, q_tf) in inp["queries"].items():
        q = dict(ids=q_ids.to(dev), mask=q_mask.to(dev), idx=q_idx.to(dev), tf=q_tf.to(dev))
        with torch.inference_mode():
            q["dense"] = bi(q["ids"], q["mask"])
        qs[nq] = q
    sparse = (c["idx_t"], c["tf_t"], c["doc_len"], df, n_docs)
    e2e = make_sharded_retrieve_rerank(bi, ce, mesh=mesh, pad_id=inp["pad_id"],
                                       sep_id=inp["sep_id"], **SHARD_E2E)

    def hybrid(rows, nq, **kw):
        q = qs[nq]
        return sharded_hybrid_retrieve(rows, *sparse, q["dense"], q["idx"], q["tf"],
                                       c["valid"], w, lam, mesh=mesh, **SHARD_HYBRID, **kw)

    return {
        "dense-bf16": lambda nq: sharded_dense_topk(c["emb"], qs[nq]["dense"], SHARD_K,
                                                    c["valid"], mesh=mesh),
        "dense-sq8": lambda nq: sharded_dense_topk(c["codes"], qs[nq]["dense"], SHARD_K,
                                                   c["valid"], c["scale"], mesh=mesh),
        "sparse": lambda nq: sharded_sparse_topk(*sparse, qs[nq]["idx"], qs[nq]["tf"],
                                                 SHARD_K, c["valid"], mesh=mesh),
        "hybrid-scan": lambda nq: hybrid(c["emb"], nq),
        "hybrid-sq8": lambda nq: hybrid(c["codes"], nq, emb_scale=c["scale"],
                                        dense_impl="sq8"),
        "hybrid-pq": lambda nq: hybrid(c["pq"], nq, pq_codebooks=inp["pq_cb"].to(dev),
                                       dense_impl="pq", pq_m=PQ_M, pq_bits=4),
        "e2e": lambda nq: e2e(qs[nq]["ids"], qs[nq]["mask"], qs[nq]["idx"], qs[nq]["tf"],
                              c["tokens"], c["emb"], *sparse, c["valid"], w, lam),
    }, qs


def as_topk(name, out):
    """(scores, ids) of a program's answer, the lists its checks compare."""
    if name == "e2e":
        return [(out.ce_scores, out.ids), (out.cand_scores, out.cand_ids)]
    if name.startswith("hybrid"):
        return [(out[1], out[0])]
    return [(out[0], out[1])]


def same_topk(name, got, want, tol=1e-5):
    """Scores within ``tol`` of the largest live score; ids equal where the
    scores are distinct, the same sets where they tie (the last tie group,
    cut by k, only in size).  Returns (max |err|, ids differing at ties)."""
    import numpy as np

    from advanced_rag_tpu_torch.ops.dense import NEG_INF

    max_err, swaps = 0.0, 0
    for (gs, gi), (ws, wi) in zip(got, want):
        gs, gi, ws, wi = (np.asarray(x.float().cpu() if x.is_floating_point() else x.cpu())
                          for x in (gs, gi, ws, wi))
        live = np.isfinite(ws) & (ws > NEG_INF / 2)
        scale = max(float(np.abs(ws[live]).max()), 1e-30) if live.any() else 1.0
        if not np.array_equal(live, np.isfinite(gs) & (gs > NEG_INF / 2)):
            raise AssertionError(f"{name}: live entries differ")
        err = float(np.abs(gs[live] - ws[live]).max()) if live.any() else 0.0
        max_err = max(max_err, err)
        if err > tol * scale:
            raise AssertionError(f"{name}: scores differ by {err} (> {tol} of {scale})")
        for r in range(ws.shape[0]):
            lo = 0
            while lo < ws.shape[1]:
                hi = lo + 1
                while hi < ws.shape[1] and abs(ws[r, hi] - ws[r, lo]) <= tol * scale:
                    hi += 1
                a, b = set(gi[r, lo:hi].tolist()), set(wi[r, lo:hi].tolist())
                if hi < ws.shape[1] and a != b:
                    raise AssertionError(f"{name}: row {r} ids differ at {lo}:{hi}")
                swaps += int(not np.array_equal(gi[r, lo:hi], wi[r, lo:hi]))
                lo = hi
    return max_err, swaps


def timed_programs(programs, reps=REPEATS):
    """p50 / p99 ms of each program at Q = 1, 8, 32 (host clock around calls
    that end in a synchronize; 2 warm-up calls)."""
    return {name: time_calls(lambda nq, r: fn(nq), BATCHES, reps)
            for name, fn in programs.items()}


def merge_ms(mesh, nq, k, dev, reps=3 * REPEATS):
    """p50 ms of one gather merge of [nq, k] (score, id) pairs over the
    shard axis, and of the all_reduce of an [nq, 96, 384] f32 MMR pool
    (more repeats than a call's: each is short, and Gloo's loopback
    latency spreads)."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.parallel import gather_merge_topk
    from advanced_rag_tpu_torch.parallel.comm import all_reduce_sum

    s = torch.randn(nq, k, device=dev)
    i = torch.arange(nq * k, dtype=torch.int32, device=dev).reshape(nq, k)
    pool = torch.zeros(nq, SHARD_HYBRID["k_cand"], 384, device=dev)
    out = {}
    for name, fn in (("merge", lambda: gather_merge_topk(s, i, min(k, 10), mesh=mesh)),
                     ("pool", lambda: all_reduce_sum(pool, mesh, "shard"))):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = float(np.percentile(times[2:], 50))
    return out


def merge_shares(mesh, times, dev):
    """The merges' p50 ms at Q = 1, 8, 32 and their share of the sharded
    dense call (one merge of k) and of the hybrid scan (two merges of
    k_cand and the MMR pool's all_reduce)."""
    out = {}
    for nq in BATCHES:
        k = merge_ms(mesh, nq, SHARD_K, dev)["merge"]
        deep = merge_ms(mesh, nq, SHARD_HYBRID["k_cand"], dev)
        hyb = 2 * deep["merge"] + deep["pool"]
        out[nq] = dict(merge_k_ms=k, merge_kcand_ms=deep["merge"], pool_ms=deep["pool"],
                       dense_share=k / times["dense-bf16"][nq]["p50_ms"],
                       hybrid_share=hyb / times["hybrid-scan"][nq]["p50_ms"])
    return out


def run_sharded(mesh, c, inp, bi, ce):
    """Every program of ``sharded_programs`` at Q = 1, 8, 32 -> answers."""
    import torch

    programs, _ = sharded_programs(mesh, c, inp, bi, ce)
    out = {}
    with torch.inference_mode():
        for name, fn in programs.items():
            for nq in BATCHES:
                out[(name, nq)] = as_topk(name, fn(nq))
    torch.cuda.synchronize()
    return out, programs


def unsharded_answers(c, inp, bi, ce):
    """The port's unsharded functions with the same knobs on the same rows."""
    import torch

    from advanced_rag_tpu_torch.ops.dense_kernels import (dense_topk_kernel,
                                                          dense_topk_sq8_kernel)
    from advanced_rag_tpu_torch.ops.e2e import make_retrieve_rerank
    from advanced_rag_tpu_torch.ops.hybrid import hybrid_retrieve
    from advanced_rag_tpu_torch.ops.sparse_kernels import sparse_topk_kernel

    dev = torch.device("cuda")
    df, n_docs = inp["df"].to(dev), torch.tensor(inp["n_docs"], device=dev)
    w, lam = torch.tensor([0.7, 0.3], device=dev), torch.tensor(0.8, device=dev)
    sparse = (c["idx_t"], c["tf_t"], c["doc_len"], df, n_docs)
    e2e = make_retrieve_rerank(bi, ce, pad_id=inp["pad_id"], sep_id=inp["sep_id"],
                               **SHARD_E2E)
    out = {}
    with torch.inference_mode():
        for nq, (q_ids, q_mask, q_idx, q_tf) in inp["queries"].items():
            q_ids, q_mask, q_idx, q_tf = (x.to(dev) for x in (q_ids, q_mask, q_idx, q_tf))
            q = bi(q_ids, q_mask)
            hy = lambda rows, **kw: hybrid_retrieve(  # noqa: E731
                rows, *sparse, q, q_idx, q_tf, c["valid"], w, lam, **SHARD_HYBRID, **kw)
            out[("dense-bf16", nq)] = dense_topk_kernel(c["emb"], q, SHARD_K, c["valid"],
                                                        normalize_queries=False)
            out[("dense-sq8", nq)] = dense_topk_sq8_kernel(c["codes"], c["scale"], q, SHARD_K,
                                                           c["valid"], normalize_queries=False)
            out[("sparse", nq)] = sparse_topk_kernel(*sparse, q_idx, q_tf, SHARD_K, c["valid"])
            out[("hybrid-scan", nq)] = hy(c["emb"])
            out[("hybrid-sq8", nq)] = hy(c["codes"], emb_scale=c["scale"], dense_impl="sq8")
            out[("hybrid-pq", nq)] = hy(c["pq"], pq_codebooks=inp["pq_cb"].to(dev),
                                        dense_impl="pq", pq_m=PQ_M, pq_bits=4)
            out[("e2e", nq)] = e2e(q_ids, q_mask, q_idx, q_tf, c["tokens"], c["emb"], None,
                                   None, *sparse, c["valid"], w, lam)
    return {key: as_topk(key[0], v) for key, v in out.items()}


def check_answers(got, want, who):
    """Every program's answer at every Q against ``want``; -> max |err|, swaps."""
    rec = {}
    for key, w in want.items():
        err, swaps = same_topk(f"{who} {key[0]} Q={key[1]}", got[key], w)
        rec[f"{key[0]}/{key[1]}"] = dict(max_abs_err=err, tie_swaps=swaps)
    return rec


def to_cpu(answers):
    return {k: [(s.cpu(), i.cpu()) for s, i in v] for k, v in answers.items()}


def pair_arrays(texts, n, seed, max_len):
    """n inverse-cloze pairs of ``texts`` tokenized at the shipped geometry."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.models.tokenizer import HashingTokenizer, TokenizerConfig
    from advanced_rag_tpu_torch.models.encoder import SHIPPED_BIENCODER
    from advanced_rag_tpu_torch.train.contrastive import cloze_query

    rng = np.random.default_rng(seed)
    tok = HashingTokenizer(TokenizerConfig(vocab_size=SHIPPED_BIENCODER.vocab_size,
                                           max_len=max_len))
    docs = [texts[i] for i in rng.integers(0, len(texts), n)]
    out = dict(zip(("q_ids", "q_mask"), tok.encode_batch([cloze_query(d, rng) for d in docs],
                                                         max_len)))
    out.update(zip(("d_ids", "d_mask"), tok.encode_batch(docs, max_len)))
    return {k: torch.from_numpy(v) for k, v in out.items()}


def phase_sharded_world1(texts, work, embedder):
    """Phase 11 (a): world size 1 under NCCL in this process."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from advanced_rag_tpu_torch.config import PipelineConfig
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.models.encoder import (SHIPPED_BIENCODER,
                                                       SHIPPED_BIENCODER_OUT_DIM, BiEncoder,
                                                       init_bi_encoder)
    from advanced_rag_tpu_torch.ops.pq import pq_train
    from advanced_rag_tpu_torch.parallel import build_mesh, build_pod_mesh, pod_dense_topk
    from advanced_rag_tpu_torch.train import (TrainConfig, build_train_mesh, make_optimizer,
                                              make_train_step)
    from advanced_rag_tpu_torch.utils.checkpoint import load_index

    dev = torch.device("cuda")
    rec = {}
    ckpt = work / "index-bfloat16"
    shard_dir = work / "sharded"
    shard_dir.mkdir(exist_ok=True)
    # phase 4's bf16 manager, restored: its tensors are what the ranks read
    # from the checkpoint's files
    t = time.perf_counter()
    cfg = PipelineConfig(fused_rerank=True, semantic_dtype="bfloat16")
    cfg.semantic_dim = SHIPPED_BIENCODER_OUT_DIM
    mgr = MultiIndexManager(cfg, embedder=embedder, device=dev)
    load_index(mgr, ckpt)
    n = mgr.store.size
    np.save(shard_dir / "tokens.npy", mgr.token_table._host[:n])
    rng = np.random.default_rng(53)
    inp = dict(n=n, n_docs=float(max(mgr.sparse.n_docs, 1)), df=mgr.sparse.df.cpu(),
               pad_id=mgr.token_table.tokenizer.config.pad_id,
               sep_id=mgr.token_table.tokenizer.config.sep_id, queries={})
    for nq in BATCHES:
        qt = snippet_queries(rng, texts, nq)
        q_ids, q_mask = embedder.tokenizer.encode_batch(qt, SERVE["q_max_len"])
        q_idx, q_tf = mgr.sparse.encode_query(qt)
        inp["queries"][nq] = tuple(torch.from_numpy(np.asarray(a))
                                   for a in (q_ids, q_mask, q_idx, q_tf))
    mirror = np.load(ckpt / "dense_semantic.npy", mmap_mode="r")
    inp["pq_cb"] = pq_train(np.asarray(mirror), m=PQ_M, bits=4, device=dev).codebooks.cpu()
    c = shard_rows(ckpt, shard_dir / "tokens.npy", 0, n, inp["pq_cb"])
    sp = mgr.sparse
    same = dict(emb=torch.equal(c["emb"], mgr.semantic.emb[:n]),
                idx_t=torch.equal(c["idx_t"], sp.idx_t[:, :n]),
                tf_t=torch.equal(c["tf_t"], sp.tf_t[:, :n]),
                doc_len=torch.equal(c["doc_len"], sp.doc_len[:n]),
                valid=torch.equal(c["valid"], mgr._row_mask(None)[:n]),
                tokens=torch.equal(c["tokens"], mgr.token_table.tokens[:n]))
    mgr.close()
    del mgr, sp
    rec["load_s"] = time.perf_counter() - t
    log(f"sharded[a]: {n} chunks restored from phase 9 (b)'s bf16 checkpoint, PQ "
        f"codebooks (m {PQ_M}) trained, rows read from its files in {rec['load_s']:.2f}s; "
        f"the files' rows equal the restored manager's tensors: {same}")
    if not all(same.values()):
        raise AssertionError(f"the checkpoint's files and the restored manager differ: {same}")

    port = free_port()
    init_group("nccl", 0, 1, port)
    try:
        mesh, pod, tmesh = build_mesh(), build_pod_mesh(), build_train_mesh()
        rec["meshes"] = dict(mesh=mesh.shape, pod=pod.shape, train=tmesh.shape,
                             backend=dist.get_backend())
        bi, ce = f32_encoders(work)
        reset_counters()
        t = time.perf_counter()
        answers, programs = run_sharded(mesh, c, inp, bi, ce)
        with torch.inference_mode():
            for nq in BATCHES:
                q = bi(inp["queries"][nq][0].to(dev), inp["queries"][nq][1].to(dev))
                answers[("pod", nq)] = as_topk("pod", pod_dense_topk(
                    c["emb"], q, SHARD_K, c["valid"], mesh=pod))
        rec["launches"] = read_counters()
        rec["calls_s"] = time.perf_counter() - t
        want = unsharded_answers(c, inp, bi, ce)
        for nq in BATCHES:
            want[("pod", nq)] = want[("dense-bf16", nq)]
        rec["checks"] = check_answers(answers, want, "world 1")
        times = timed_programs(programs)
        rec["ms"] = times
        rec["merge"] = merge_shares(mesh, times, dev)
        # the cross-encoder over one query's k_rerank pairs of the program's
        # layout ([CLS] q [SEP] in q_max_len slots, the doc window, [SEP])
        lq = SERVE["q_max_len"]
        seq = lq + c["tokens"].shape[1] + 1
        gen = torch.Generator(device=dev).manual_seed(73)
        pairs = (torch.randint(4, ce.config.vocab_size, (SHARD_E2E["k_rerank"], seq),
                               generator=gen, device=dev),
                 torch.ones(SHARD_E2E["k_rerank"], seq, device=dev),
                 (torch.arange(seq, device=dev) >= lq).long().expand(SHARD_E2E["k_rerank"], seq))
        with torch.inference_mode():
            q1 = [x.to(dev) for x in inp["queries"][1][:2]]
            embed = time_calls(lambda nq, r: bi(*q1), (1,))[1]["p50_ms"]
            rerank = time_calls(lambda nq, r: ce(*pairs), (1,))[1]["p50_ms"]
        mrow = n / 1e6
        dense = times["dense-sq8"][1]["p50_ms"]
        sparse = times["sparse"][1]["p50_ms"]
        e2e = times["e2e"][1]
        rec["anchors"] = dict(
            embed_ms=embed, dense_sq8_ms_per_mrow=dense / mrow,
            sparse_postings_ms_per_mrow=sparse / mrow,
            fuse_fixed_ms=max(times["hybrid-sq8"][1]["p50_ms"] - dense - sparse, 0.0),
            rerank_ms=rerank, eval_host_ms=0.0, jitter_p99_ms=e2e["p99_ms"] - e2e["p50_ms"])

        # one contrastive step pair on build_train_mesh()'s (1, 1) mesh
        # against mesh=None, from one init and batch
        init = init_bi_encoder(SHIPPED_BIENCODER, SHIPPED_BIENCODER_OUT_DIM, seed=3,
                               device="cpu")[1]
        batch = {k: v.to(dev) for k, v in pair_arrays(texts, 32, 59, 256).items()}
        tcfg = TrainConfig(**TRAIN_CONFIG)
        runs = []
        for m in (None, tmesh):
            model = BiEncoder(SHIPPED_BIENCODER, out_dim=SHIPPED_BIENCODER_OUT_DIM)
            step, p, o = make_train_step(model, make_optimizer(tcfg), tcfg, m, init,
                                         device=dev)
            metrics = [{k: float(v) for k, v in step(p, o, batch)[2].items()}
                       for _ in range(2)]
            runs.append((metrics, {k: v.detach().clone() for k, v in p.items()}))
        rec["train_mesh_1x1_same"] = (runs[0][0] == runs[1][0] and all(
            torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items()))
        del runs, model, step, p, o
    finally:
        dist.destroy_process_group()
    log(f"sharded[a]: world 1 under NCCL, meshes {rec['meshes']}; "
        f"{len(rec['checks'])} answers against the unsharded functions: max |err| "
        f"{max(v['max_abs_err'] for v in rec['checks'].values()):.3g}, ids differing at "
        f"ties {sum(v['tie_swaps'] for v in rec['checks'].values())}; launches "
        f"{rec['launches']}; the (1, 1) train mesh answers as mesh=None: "
        f"{rec['train_mesh_1x1_same']}")
    log("sharded[a]: p50 ms per call at Q = 1, 8, 32: " + "; ".join(
        f"{k} " + "/".join(f"{v[nq]['p50_ms']:.3f}" for nq in BATCHES)
        for k, v in rec["ms"].items()))
    log("sharded[a]: merge p50 ms (share of the dense call, of the hybrid scan) at Q = 1, "
        "8, 32: " + "; ".join(f"Q={nq} {v['merge_k_ms']:.3f} ({v['dense_share']:.3f}, "
                              f"{v['hybrid_share']:.3f})" for nq, v in rec["merge"].items()))
    if not rec["train_mesh_1x1_same"]:
        raise AssertionError("the (1, 1) train mesh does not answer as mesh=None")
    for key in ("K1", "K2", "K3", "K6"):
        if rec["launches"][key] == 0:
            raise AssertionError(f"phase 11 (a) launched no {key}: {rec['launches']}")
    inp["answers"] = to_cpu(answers)
    torch.save(inp, shard_dir / "inputs.pt")
    del c, answers, programs, bi, ce
    torch.cuda.empty_cache()
    return rec


def spawn_ranks(job, world, args):
    """``world`` processes of ``rank_main(job)`` (start method spawn) sharing
    the card; joined within SHARD_JOIN_S, killed and raised on a timeout or
    a non-zero exit -> each rank's result."""
    import torch
    import torch.multiprocessing as mp

    out = Path(args["dir"])
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(job, r, world, port, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + SHARD_JOIN_S
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise AssertionError(f"phase 11 {job}: ranks {hung} did not finish in {SHARD_JOIN_S}s")
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if bad:
        raise AssertionError(f"phase 11 {job}: ranks exited with {bad}")
    return [torch.load(out / f"{job}.{r}.pt", weights_only=False) for r in range(world)]


def rank_main(job, rank, world, port, args):
    """One rank of phase 11 (b) or (c): Gloo on cuda:0."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_group("gloo", rank, world, port)
    try:
        rec = (rank_search if job == "search" else rank_train)(rank, world, args)
    finally:
        dist.destroy_process_group()
    torch.save(rec, Path(args["dir"]) / f"{job}.{rank}.pt")


def rank_search(rank, world, args):
    """Phase 11 (b) on one rank: its quarter of the checkpoint's rows through
    every program, the pod mesh and tree_merge_topk; then its quarter of
    phase 6's 1M clustered rows through the sharded IVF / SQ8-IVF / IVF-PQ
    builds and searches at full probe against the exact sharded K1 scan."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.ops.dense_kernels import dense_topk_kernel
    from advanced_rag_tpu_torch.ops.ivfpq import build_ivfpq, ivfpq_topk
    from advanced_rag_tpu_torch.parallel import (build_mesh, build_pod_mesh,
                                                 build_sharded_ivf, build_sharded_ivfpq,
                                                 pod_dense_topk, sharded_dense_topk,
                                                 sharded_ivf_topk, sharded_ivfpq_topk,
                                                 tree_merge_topk)
    from advanced_rag_tpu_torch.parallel.sharded_search import to_global

    dev = torch.device("cuda")
    work = Path(args["work"])
    rec = {}
    t0 = time.perf_counter()
    inp = torch.load(work / "sharded" / "inputs.pt", weights_only=False)
    mesh, pod = build_mesh(), build_pod_mesh(dcn=2, shard=world // 2)
    per = inp["n"] // world
    lo = rank * per
    c = shard_rows(work / "index-bfloat16", work / "sharded" / "tokens.npy", lo, lo + per,
                   inp["pq_cb"])
    bi, ce = f32_encoders(work)
    reset_counters()
    answers, programs = run_sharded(mesh, c, inp, bi, ce)
    with torch.inference_mode():
        for nq in BATCHES:
            q = bi(inp["queries"][nq][0].to(dev), inp["queries"][nq][1].to(dev))
            answers[("pod", nq)] = as_topk("pod", pod_dense_topk(c["emb"], q, SHARD_K,
                                                                 c["valid"], mesh=pod))
            s, i = dense_topk_kernel(c["emb"], q, SHARD_K, c["valid"], normalize_queries=False)
            answers[("tree", nq)] = as_topk("tree", tree_merge_topk(
                s, to_global(i, lo), SHARD_K, "shard", world, mesh=mesh))
    rec["launches"] = read_counters()
    want = dict(inp["answers"])
    for nq in BATCHES:
        want[("tree", nq)] = want[("dense-bf16", nq)]
    rec["checks"] = check_answers(answers, want, f"rank {rank}")
    rec["ms"] = timed_programs(programs)
    rec["merge"] = merge_shares(mesh, rec["ms"], dev)
    rec["checkpoint_s"] = time.perf_counter() - t0
    del c, answers, programs
    torch.cuda.empty_cache()

    # the 1M clustered rows of phase 6, this rank's quarter
    t = time.perf_counter()
    x, qv = clustered_vectors(N_TIER, 256, seed=21)
    per = N_TIER // world
    rows = np.ascontiguousarray(x[rank * per:(rank + 1) * per])
    del x
    q = torch.from_numpy(qv[:SHARD_TIER_Q]).to(dev)
    valid = torch.ones(per, dtype=torch.bool, device=dev)
    rec["tier_make_s"] = time.perf_counter() - t
    reset_counters()
    xf = torch.from_numpy(rows).to(dev)
    _, oracle = sharded_dense_topk(xf, q, 10, valid, mesh=mesh)
    oracle = oracle.cpu().numpy()
    # this rank's own exact top 10 (local ids): the IVF-PQ witness's oracle
    _, local = dense_topk_kernel(xf, q, 10, valid, normalize_queries=False)
    local = local.cpu().numpy()
    del xf

    def recall(ids, exact=oracle):
        ids = ids.cpu().numpy()
        return float(np.mean([len(set(a[a >= 0]) & set(b)) / 10 for a, b in zip(ids, exact)]))

    rec["tiers"] = {}
    for name, dtype in (("ivf-bf16", "bfloat16"), ("ivf-sq8", "int8")):
        t = time.perf_counter()
        parts = build_sharded_ivf(rows, mesh, dtype=dtype, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        nlist = int(parts.packed_emb.shape[0])
        _, ids = sharded_ivf_topk(parts, q, 10, valid, mesh=mesh, nprobe=nlist)
        rec["tiers"][name] = dict(build_s=build_s, nlist=nlist, recall_at_10=recall(ids))
        del parts
    for m in (PQ_M, SHARD_IVFPQ_M):
        t = time.perf_counter()
        # 65,536 training rows: the residual codebooks' k-means holds
        # [m, sample, 16] f32, 6.1 GB at m = 384 over all 250,000
        idx = build_sharded_ivfpq(rows, mesh, m=m, bits=4, train_sample=65_536, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        nlist = int(idx.centroids.shape[0])
        _, ids = sharded_ivfpq_topk(idx, q, 40, valid, mesh=mesh, nprobe=nlist, m=m, bits=4)
        rec["tiers"][f"ivfpq-m{m}"] = tier = dict(build_s=build_s, nlist=nlist, depth=40,
                                                  recall_at_10=recall(ids))
        if m == PQ_M and rank == 0:
            # the witness at m 96: this rank's own index searched alone, and
            # the unsharded build (its default knobs: every row trains)
            # over the same rows, each against this rank's exact top 10
            _, ids = ivfpq_topk(idx, q, 40, valid, nprobe=nlist, m=m, bits=4)
            tier["rank_recall_at_10"] = recall(ids, local)
            del idx
            t = time.perf_counter()
            idx = build_ivfpq(rows, nlist, m=m, bits=4, device=dev)
            torch.cuda.synchronize()
            tier["unsharded_build_s"] = time.perf_counter() - t
            _, ids = ivfpq_topk(idx, q, 40, valid, nprobe=nlist, m=m, bits=4)
            tier["unsharded_recall_at_10"] = recall(ids, local)
        del idx
    rec["tier_launches"] = read_counters()
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["seconds"] = time.perf_counter() - t0
    bounds = {"ivf-bf16": 0.95, "ivf-sq8": 0.9, f"ivfpq-m{SHARD_IVFPQ_M}": 0.9}
    low = {k: v["recall_at_10"] for k, v in rec["tiers"].items()
           if v["recall_at_10"] < bounds.get(k, 0.0)}
    if low:
        raise AssertionError(f"rank {rank}: recall below the JAX tests' bounds: {low}")
    witness = rec["tiers"][f"ivfpq-m{PQ_M}"]
    if rank == 0 and witness["rank_recall_at_10"] < \
            witness["unsharded_recall_at_10"] - SHARD_IVFPQ_WITNESS:
        raise AssertionError(f"rank 0: the sharded build's IVF-PQ at m {PQ_M} falls below "
                             f"the unsharded build's on the same rows: {witness}")
    if rec["tier_launches"]["K5"] == 0 or rec["tier_launches"]["K6"] == 0:
        raise AssertionError(f"rank {rank}: K5 / K6 not launched: {rec['tier_launches']}")
    return rec


def train_reference(texts, work):
    """Phase 11 (c)'s single-process references on the card, in f32 at the
    shipped geometry: two contrastive updates of one batch of TRAIN_BATCH
    pairs, one reranker step and one distillation step; written under
    ``work`` with their inputs for the ranks."""
    import dataclasses

    import numpy as np
    import torch

    from advanced_rag_tpu_torch.models.encoder import (SHIPPED_BIENCODER,
                                                       SHIPPED_BIENCODER_OUT_DIM,
                                                       SHIPPED_RERANKER, init_bi_encoder,
                                                       init_cross_encoder)
    from advanced_rag_tpu_torch.models.tokenizer import HashingTokenizer, TokenizerConfig
    from advanced_rag_tpu_torch.train import DistillConfig, RerankTrainConfig
    from advanced_rag_tpu_torch.train.contrastive import cloze_query
    from advanced_rag_tpu_torch.train.distill import make_distill_batch
    from advanced_rag_tpu_torch.train.rerank import make_rerank_batch

    bi_cfg = dataclasses.replace(SHIPPED_BIENCODER, dtype=torch.float32)
    ce_cfg = dataclasses.replace(SHIPPED_RERANKER, dtype=torch.float32)
    chunks = list(texts[:4096])
    rng = np.random.default_rng(61)
    tok = HashingTokenizer(TokenizerConfig(vocab_size=ce_cfg.vocab_size,
                                           max_len=ce_cfg.max_len))
    pairs = [(cloze_query(t, rng), t) for t in chunks[:512]]
    negs = [[chunks[(i * 7 + j + 1) % len(chunks)] for j in range(8)] for i in range(512)]
    rcfg = RerankTrainConfig(**SHARD_RERANK)
    dcfg = DistillConfig(queries_per_batch=SHARD_RERANK["queries_per_batch"],
                         candidates_per_query=SHARD_RERANK["candidates_per_query"])
    distill, _, _ = make_distill_batch(tok, chunks, dcfg, rng, ce_cfg.max_len, device="cpu")
    distill["teacher"] = torch.from_numpy(
        rng.standard_normal((dcfg.queries_per_batch, dcfg.candidates_per_query))
        .astype(np.float32) * 5)
    ref = dict(bi_cfg=bi_cfg, ce_cfg=ce_cfg, rcfg=rcfg, dcfg=dcfg,
               bi_init=init_bi_encoder(bi_cfg, SHIPPED_BIENCODER_OUT_DIM, seed=3,
                                       device="cpu")[1],
               ce_init=init_cross_encoder(ce_cfg, seed=4, device="cpu")[1],
               batch=pair_arrays(texts, TRAIN_BATCH, 67, bi_cfg.max_len),
               rerank=make_rerank_batch(tok, pairs, negs, rcfg, rng, device="cpu"),
               distill=distill)
    ref["single"] = train_steps(ref, None)
    torch.save(ref, work / "sharded" / "train.pt")
    return ref


def train_steps(ref, mesh):
    """The steps of phase 11 (c) over ``mesh`` (None: one process): two
    contrastive updates, one reranker step (dropout from a generator seeded
    alike everywhere), one distillation step; metrics, each step's first
    gradients (after the clip, as the module holds them: on a model axis
    of two ranks, this rank's slices), the trained weights whole, what a
    rank holds between steps and ms a step."""
    import torch

    from advanced_rag_tpu_torch.models.encoder import (SHIPPED_BIENCODER_OUT_DIM, BiEncoder,
                                                       CrossEncoder)
    from advanced_rag_tpu_torch.train import TrainConfig, make_optimizer, make_train_step
    from advanced_rag_tpu_torch.train.distill import make_distill_step
    from advanced_rag_tpu_torch.train.rerank import make_rerank_step

    dev = torch.device("cuda")
    tcfg = TrainConfig(**TRAIN_CONFIG)
    grads = lambda m: {k: p.grad.detach().cpu().clone()  # noqa: E731
                       for k, p in m.named_parameters()}
    out = {}
    model = BiEncoder(ref["bi_cfg"], out_dim=SHIPPED_BIENCODER_OUT_DIM)
    step, p, o = make_train_step(model, make_optimizer(tcfg), tcfg, mesh, ref["bi_init"],
                                 device=dev)
    b = {k: v.to(dev) for k, v in ref["batch"].items()}
    metrics, times = [], []
    for i in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        p, o, m = step(p, o, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        times.append((time.perf_counter() - t) * 1e3)
        if i == 0:
            first = grads(model)
    held = dict(params_mb=sum(x.numel() * x.element_size() for x in model.parameters()) / 1e6,
                adam_mb=sum(v.numel() * v.element_size() for st in o.adamw.state.values()
                            for k, v in st.items() if k != "step") / 1e6)
    out["contrastive"] = dict(metrics=metrics, lr=o.schedule(1), seconds=sum(times) / 1e3,
                              grads=first, step_ms=times[1], held=held, **layout(model, o),
                              params={k: v.detach().cpu() for k, v in o.full_params().items()})
    del model, step, p, o
    for kind in ("rerank", "distill"):
        student = CrossEncoder(ref["ce_cfg"])
        b = {k: v.to(dev) for k, v in ref[kind].items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        if kind == "rerank":
            step, _, p, o = make_rerank_step(student, make_optimizer(tcfg), tcfg, mesh,
                                             ref["ce_init"], ref["rcfg"], device=dev)
            gen = torch.Generator(device=dev).manual_seed(71)
            p, o, m = step(p, o, b, gen)
        else:
            step, _, p, o = make_distill_step(student, make_optimizer(tcfg), tcfg, mesh,
                                              ref["ce_init"], ref["dcfg"], device=dev)
            p, o, m = step(p, o, b)
        out[kind] = dict(metrics={k: float(v) for k, v in m.items()}, grads=grads(student),
                         build_and_step_ms=(time.perf_counter() - t) * 1e3, **layout(student, o))
        del student, step, p, o
    return out


def layout(model, opt):
    """Which dim of each parameter a rank holds a slice of, and the rank's
    place on the model axis (tp, coordinate)."""
    mp = opt.mesh_params
    return dict(sliced=dict(zip([n for n, _ in model.named_parameters()], mp.dims)),
                model_index=(mp.tp, mp.mesh.index(mp.model_axis)))


def own_slices(grads, got):
    """``grads`` (whole) cut to the slices that the rank of ``got`` holds."""
    import torch

    tp, me = got["model_index"]
    return {k: g if got["sliced"].get(k) is None else torch.chunk(g, tp, got["sliced"][k])[me]
            for k, g in grads.items()}


def grads_within(name, got, want):
    """Each tensor's gradient within PARITY_TOL's f32 bounds of ``want``'s."""
    import torch

    tol = PARITY_TOL["float32"]
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in want.values())))
    bad = [k for k, w in want.items()
           if float((got[k] - w).double().norm()) > tol["grad_rtol"] * float(w.double().norm())
           + tol["grad_atol"] * total]
    if bad:
        raise AssertionError(f"{name}: gradients outside the f32 bounds: {bad[:5]}")
    return len(want)


def rank_train(rank, world, args):
    """Phase 11 (c) on one rank: the steps on a (data 2, model 1) mesh built
    by hand and on build_train_mesh(2)'s (data 1, model 2), each held to the
    single-process references with PARITY_TOL's f32 bounds."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.parallel.mesh import Mesh
    from advanced_rag_tpu_torch.train import build_train_mesh

    ref = torch.load(Path(args["work"]) / "sharded" / "train.pt", weights_only=False)
    rec = {}
    torch.cuda.reset_peak_memory_stats()
    for label, mesh in (("data2", Mesh(np.arange(world).reshape(world, 1), ("data", "model"))),
                        ("model2", build_train_mesh(world))):
        got = train_steps(ref, mesh)
        single = ref["single"]
        r = {"shape": mesh.shape}
        want = dict(single["contrastive"], grads=own_slices(single["contrastive"]["grads"],
                                                            got["contrastive"]))
        r["contrastive"] = parity_record(
            "float32", {"cuda": got["contrastive"], "cpu": want},
            ref["bi_init"], what=f"rank {rank} on {mesh.shape} vs one process",
            names=("mesh", "single"))
        r["contrastive"]["step_ms"] = got["contrastive"]["step_ms"]
        r["contrastive"]["held"] = got["contrastive"]["held"]
        for kind in ("rerank", "distill"):
            loss, want = got[kind]["metrics"]["loss"], single[kind]["metrics"]["loss"]
            if abs(loss - want) > PARITY_TOL["float32"]["loss"] * abs(want):
                raise AssertionError(f"rank {rank} {label} {kind}: loss {loss} vs {want}")
            r[kind] = dict(loss=loss, single_loss=want, tensors=grads_within(
                f"rank {rank} {label} {kind}", got[kind]["grads"],
                own_slices(single[kind]["grads"], got[kind])),
                build_and_step_ms=got[kind]["build_and_step_ms"])
        rec[label] = r
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return rec


def phase_sharded(texts, work, embedder, smi):
    """Phase 11: parallel/ and the training mesh on the card: (a) world size
    1 under NCCL in this process, (b) SHARD_RANKS ranks over Gloo, (c) two
    ranks training on a mesh.  -> the record and its launches."""
    import torch

    t_phase = time.perf_counter()
    rec = {"a": phase_sharded_world1(texts, work, embedder)}
    rec["a"]["seconds"] = time.perf_counter() - t_phase
    launches = dict(rec["a"]["launches"])

    t = time.perf_counter()
    torch.cuda.empty_cache()
    rec["parent_gb"] = [torch.cuda.memory_allocated() / 1e9]
    args = {"work": str(work), "dir": str(work / "sharded")}
    ranks = spawn_ranks("search", SHARD_RANKS, args)
    b = rec["b"] = {"seconds": time.perf_counter() - t, "rank0": ranks[0],
                    "peak_gb": [r["peak_gb"] for r in ranks],
                    "rank_seconds": [r["seconds"] for r in ranks],
                    "tier_launches": [r["tier_launches"] for r in ranks]}
    for r in ranks:
        for key in KERNEL_KEYS:
            launches[key] += r["launches"][key] + r["tier_launches"][key]
    r0 = ranks[0]
    log(f"sharded[b]: {SHARD_RANKS} ranks on one card over Gloo in {b['seconds']:.2f}s "
        f"(ranks {', '.join(f'{s:.1f}' for s in b['rank_seconds'])}s); rank 0's "
        f"{len(r0['checks'])} answers equal (a)'s: max |err| "
        f"{max(v['max_abs_err'] for v in r0['checks'].values()):.3g}, ids differing at "
        f"ties {sum(v['tie_swaps'] for v in r0['checks'].values())}; peak memory per rank "
        + ", ".join(f"{g:.2f}" for g in b["peak_gb"]) + " GB")
    log("sharded[b]: rank 0 p50 ms per call at Q = 1, 8, 32: " + "; ".join(
        f"{k} " + "/".join(f"{v[nq]['p50_ms']:.3f}" for nq in BATCHES)
        for k, v in r0["ms"].items()))
    log("sharded[b]: merge p50 ms (share of the dense call, of the hybrid scan): " + "; ".join(
        f"Q={nq} {v['merge_k_ms']:.3f} ({v['dense_share']:.3f}, {v['hybrid_share']:.3f})"
        for nq, v in r0["merge"].items()))
    log("sharded[b]: 1M clustered rows, 250,000 a rank, full probe (IVF-PQ: the exact top "
        "10 in depth 40): " + "; ".join(
        f"{k} build {v['build_s']:.2f}s nlist {v['nlist']} recall@10 {v['recall_at_10']:.4f}"
        for k, v in r0["tiers"].items()) + f"; K5/K6 launches per rank "
        + ", ".join(f"{x['K5']}/{x['K6']}" for x in b["tier_launches"]))
    w = r0["tiers"][f"ivfpq-m{PQ_M}"]
    log(f"sharded[b]: IVF-PQ m {PQ_M} witness on rank 0's 250,000 rows against its exact "
        f"top 10 (depth 40, full probe): its own sharded-build index {w['rank_recall_at_10']:.4f}"
        f", the unsharded build_ivfpq {w['unsharded_recall_at_10']:.4f} (built in "
        f"{w['unsharded_build_s']:.2f}s; the first may fall {SHARD_IVFPQ_WITNESS} below)")

    t = time.perf_counter()
    ref = train_reference(texts, work)
    torch.cuda.empty_cache()
    rec["parent_gb"].append(torch.cuda.memory_allocated() / 1e9)
    ranks = spawn_ranks("train", 2, args)
    c = rec["c"] = {"seconds": time.perf_counter() - t, "rank0": ranks[0],
                    "single_step_ms": ref["single"]["contrastive"]["step_ms"],
                    "peak_gb": [r["peak_gb"] for r in ranks]}
    for label in ("data2", "model2"):
        log(f"sharded[c]: {c['rank0'][label]['shape']}: contrastive ms per step a rank "
            + ", ".join(f"{r[label]['contrastive']['step_ms']:.1f}" for r in ranks)
            + f" (one process {c['single_step_ms']:.1f}); held between steps a rank: "
            + ", ".join(f"{r[label]['contrastive']['held']['params_mb']:.1f} MB weights + "
                        f"{r[label]['contrastive']['held']['adam_mb']:.1f} MB AdamW"
                        for r in ranks) + "; rerank loss "
            f"{c['rank0'][label]['rerank']['loss']:.6f} (one process "
            f"{c['rank0'][label]['rerank']['single_loss']:.6f}), distill loss "
            f"{c['rank0'][label]['distill']['loss']:.6f} (one process "
            f"{c['rank0'][label]['distill']['single_loss']:.6f})")
    rec["seconds"] = time.perf_counter() - t_phase
    rec["anchors"] = dict(rec["a"]["anchors"], source=f"chip_smoke.py phase 11 (a), {smi}")
    log(f"sharded: phase 11 took {rec['seconds']:.2f}s ((a) {rec['a']['seconds']:.2f}s, "
        f"(b) {b['seconds']:.2f}s, (c) {c['seconds']:.2f}s); this process held "
        + " and ".join(f"{g:.2f}" for g in rec["parent_gb"]) + " GB of the card when "
        "(b) and (c) started")
    return rec, launches


#: phase 12 (the host native code and the timing and profiling helpers): the
#: HNSW comparison's corpus (scripts/bench_hnsw_parity.py's "clustered"
#: corpus at D = 384, its queries and nprobe tuning queries), the reference's
#: HNSW knobs (indexing.py:150-153) and tests/test_hnsw_baseline.py's geometry
HNSW_N = 50_000                # 100,000 until phase 13 (j) came
HNSW_D = 384
HNSW_QUERIES = 128
HNSW_KNOBS = dict(M=16, ef_construction=200)
HNSW_EF = 64
HNSW_BUILD_LIMIT_S = 60.0
HNSW_TEST_GEOMETRY = (5000, 48)
TIER_Q = 8
ENCODE_REPS = 50
#: phase 12 (a): the chunks encode_documents runs over both ways (all of
#: phase 4's until phase 13 (j) came)
TEXT_PATH_CHUNKS = 35_000
#: U+212A KELVIN SIGN: str.lower() maps it to "k"; the C++ path would read
#: it as a separator, so the ASCII gate sends this text to the Python rule
KELVIN_DOC = "\u212aelvin scale temperature of the probe"


def parity_corpus(n: int, d: int, nq: int, seed: int = 0):
    """scripts/bench_hnsw_parity.py's "clustered" corpus (make_corpus) and
    its queries and tuning queries (run_config): n unit rows around
    max(256, n // 500) centres with noise 0.15; queries are stored rows
    plus noise 0.05, from a second seeded generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_clusters = max(256, n // 500)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, n)
    v = centers[assign] + 0.15 * rng.standard_normal((n, d)).astype(np.float32)
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    rng = np.random.default_rng(1)
    qs = []
    for _ in range(2):
        q = v[rng.integers(0, n, nq)] + 0.05 * rng.standard_normal((nq, d)).astype(np.float32)
        qs.append(q / np.linalg.norm(q, axis=1, keepdims=True))
    return v, qs[0], qs[1]


def sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def set_recall(ids, oracle):
    import numpy as np

    k = oracle.shape[1]
    return float(np.mean([len(set(a[a >= 0].tolist()) & set(b.tolist())) / k
                          for a, b in zip(ids, oracle)]))


def both_paths(fn):
    """(fn() through the C++ path, its seconds, fn() through the Python
    rule under ADVANCED_RAG_TPU_NO_NATIVE=1, its seconds)."""
    from advanced_rag_tpu_torch import native

    if not native.enabled():
        raise AssertionError(f"{native.SWITCH} is set: phase 12 compares both paths")
    t = time.perf_counter()
    fast = fn()
    fast_s = time.perf_counter() - t
    os.environ[native.SWITCH] = "1"
    try:
        t = time.perf_counter()
        slow = fn()
        slow_s = time.perf_counter() - t
    finally:
        del os.environ[native.SWITCH]
    return fast, fast_s, slow, slow_s


def same_arrays(name, got, want):
    import numpy as np

    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"{name}: array {i} differs between the C++ path and "
                                 "the Python rule")


def same_stores(fast, slow):
    """The rows two managers hold, one filled through the C++ path and one
    through the Python rule, must be identical: chunk ids and documents,
    the sparse index's rows (doc_idx, doc_tf, doc_len) and its df table.
    Returns the rows held."""
    import numpy as np

    a, b = fast.store, slow.store
    if (a.size, a.chunk_ids, a.doc_ids) != (b.size, b.chunk_ids, b.doc_ids):
        raise AssertionError("the stored chunk ids differ between the C++ path and the "
                             "Python rule")
    sa, sb = fast.sparse, slow.sparse
    if (sa.size, sb.size) != (a.size, a.size):
        raise AssertionError(f"the sparse indexes hold {sa.size} and {sb.size} rows of "
                             f"{a.size}")
    for name in ("_host_idx", "_host_tf", "_host_len"):
        if not np.array_equal(getattr(sa, name)[:sa.size], getattr(sb, name)[:sb.size]):
            raise AssertionError(f"the sparse rows ({name}) differ between the paths")
    if not np.array_equal(sa._df, sb._df):
        raise AssertionError("the df tables differ between the C++ path and the Python rule")
    return a.size


def range_ms(prof, name):
    """CPU ms of the ranges ``name`` in a profile (summed over calls)."""
    ev = [e for e in prof.key_averages() if e.key == name]
    if not ev:
        raise AssertionError(f"the trace holds no range {name!r}")
    return ev[0].cpu_time_total / 1e3


def phase_text_path(texts, embedder, reranker, dev="cuda"):
    """Phase 12 (a): the C++ text path against the Python rule on the card's
    host: TEXT_PATH_CHUNKS of phase 4's chunks, queries at Q = 1, 8 and 32,
    phase 8's service documents through the chunker, the diagnostics and
    two pipelines, the U+212A document, and one fused Q = 1 batch each way,
    with the share of its wall time that encode_queries takes.  Returns the record and the
    C++ path's pipeline (its manager serves (c))."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch import native
    from advanced_rag_tpu_torch.config import IndexConfig, IndexType, PipelineConfig
    from advanced_rag_tpu_torch.index import text as text_mod
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.pipeline import AdvancedRAGPipeline, HybridRetriever
    from advanced_rag_tpu_torch.pipeline.chunking import AdaptiveChunker
    from advanced_rag_tpu_torch.pipeline.diagnostics import DocumentDiagnostics

    rec = {}
    native.text_lib()
    rec["build_s"] = native.build_seconds.get("text_native")
    lib = native.library_path(native.SRC_DIR / "text_native.cpp", native.TEXT_FLAGS)
    log("native[a]: text_native.so " + (
        f"built by g++ in {rec['build_s']:.2f}s" if rec["build_s"] is not None else
        "was built before this run") + f" ({lib.name})")
    sparse = IndexConfig(index_type=IndexType.SPARSE)
    vocab, nnz = sparse.vocab_size, sparse.doc_nnz
    part = texts[:TEXT_PATH_CHUNKS]
    fast, fast_s, slow, slow_s = both_paths(
        lambda: text_mod.encode_documents(part, vocab, nnz))
    same_arrays("encode_documents", fast, slow)
    rec["encode_documents"] = dict(n=len(part), vocab=vocab, doc_nnz=nnz, cpp_s=fast_s,
                                   python_s=slow_s)
    log(f"native[a]: encode_documents over {len(part)} chunks (V={vocab}, P={nnz}): "
        f"C++ {fast_s:.3f}s, Python {slow_s:.3f}s; the four arrays identical")
    rng = np.random.default_rng(61)
    rec["encode_queries_us"] = {}
    for nq in BATCHES:
        batches = [snippet_queries(rng, texts, nq) for _ in range(ENCODE_REPS)]
        fast, fast_s, slow, slow_s = both_paths(
            lambda: [text_mod.encode_queries(b, vocab, sparse.query_nnz,
                                             drop_ratio=sparse.drop_ratio) for b in batches])
        for f, s in zip(fast, slow):
            same_arrays(f"encode_queries Q={nq}", f, s)
        rec["encode_queries_us"][nq] = dict(cpp=fast_s / ENCODE_REPS * 1e6,
                                           python=slow_s / ENCODE_REPS * 1e6)
        log(f"native[a]: encode_queries Q={nq}: C++ {fast_s / ENCODE_REPS * 1e6:.1f} us, "
            f"Python {slow_s / ENCODE_REPS * 1e6:.1f} us per batch; arrays identical")
    fast, _, slow, _ = both_paths(lambda: text_mod.encode_documents([KELVIN_DOC], vocab, nnz))
    same_arrays("encode_documents (U+212A)", fast, slow)
    if text_mod.hash_term("kelvin", vocab) not in fast[0][0].tolist():
        raise AssertionError("the U+212A document lost the term 'kelvin'")

    docs, probes = service_documents(31, SERVICE_DOCS)

    def chunk_and_diagnose():
        diag, chunker = DocumentDiagnostics(), AdaptiveChunker()
        out = []
        for doc in docs:
            m = diag.analyze_document(doc["content"])
            chunks = chunker.chunk_document(doc["content"], doc_id=doc["doc_id"], metrics=m)
            out.append((m, [(c.chunk_id, c.metadata.start_char, c.metadata.token_count,
                             c.metadata.entropy, c.metadata.redundancy) for c in chunks]))
        return out

    fast, fast_s, slow, slow_s = both_paths(chunk_and_diagnose)
    worst = 0.0
    for (mf, cf), (ms, cs) in zip(fast, slow):
        if [c[:3] for c in cf] != [c[:3] for c in cs]:
            raise AssertionError("chunk ids differ between the C++ path and the Python rule")
        if (mf.token_count, mf.sentence_count, mf.token_distribution, mf.domain_scores) != (
                ms.token_count, ms.sentence_count, ms.token_distribution, ms.domain_scores):
            raise AssertionError("diagnostics counts differ between the paths")
        diffs = [abs(getattr(mf, f) - getattr(ms, f)) for f in (
            "entropy", "redundancy", "domain_density", "vocabulary_diversity", "coherence",
            "complexity")] + [abs(mf.ngram_redundancy[g] - ms.ngram_redundancy[g])
                              for g in (1, 2, 3)]
        diffs += [abs(a - b) for x, y in zip(cf, cs) for a, b in zip(x[3:], y[3:])]
        worst = max(worst, *diffs)
    if worst > 1e-9:
        raise AssertionError(f"diagnostics differ by {worst} > 1e-9 between the paths")
    n_chunks = sum(len(c) for _, c in fast)
    rec["chunk_diagnose"] = dict(docs=len(docs), chunks=n_chunks, cpp_s=fast_s,
                                 python_s=slow_s, max_abs_diff=worst)
    log(f"native[a]: chunker + diagnostics over {len(docs)} service documents "
        f"({n_chunks} chunks): C++ {fast_s:.3f}s, Python {slow_s:.3f}s; chunk ids equal, "
        f"metrics within {worst:.3g}")

    cfg = PipelineConfig(fused_rerank=True, semantic_dtype="bfloat16")
    cfg.semantic_dim = embedder.dim

    def pipeline():
        mgr = MultiIndexManager(cfg, embedder=embedder, device=dev)
        return AdvancedRAGPipeline(cfg, index_manager=mgr, retriever=HybridRetriever(
            mgr, cfg.retrieval, reranker=reranker))

    # the first ingest into a fresh fused pipeline pays first-use costs that
    # are not the text path's; a throwaway pipeline takes them before the
    # two timed ones
    warm = pipeline()
    try:
        warm.ingest_documents(docs[:16])
        sync(dev)
    finally:
        warm.close()
    pipes = [pipeline(), pipeline()]
    try:
        def ingest(pipe):
            t = time.perf_counter()
            pipe.ingest_documents(docs)
            sync(dev)
            return time.perf_counter() - t

        # each path ingests once, into a fresh pipeline of its own: a second
        # ingest of the same documents finds every chunk stored and skips the
        # encoders, so both_paths (which runs its function twice) does not fit
        fast_s = ingest(pipes[0])
        os.environ[native.SWITCH] = "1"
        try:
            slow_s = ingest(pipes[1])
        finally:
            del os.environ[native.SWITCH]
        held = same_stores(*(p.index_manager for p in pipes))
        if held < len(docs):
            raise AssertionError(f"the pipelines hold {held} chunks of {len(docs)} documents")
        rec["pipeline_ingest"] = dict(cpp_s=fast_s, python_s=slow_s, chunks=held)
        log(f"native[a]: pipeline ingest of {len(docs)} documents ({held} chunks), each "
            f"path once into a fresh pipeline: C++ {fast_s:.3f}s, Python {slow_s:.3f}s; "
            "chunk ids, sparse rows and df table identical")
        mgr = pipes[0].index_manager
        query = [probes[0][1]]

        def fused():
            out = mgr.fused_retrieve_batch_sync(query, reranker=reranker, **SERVE)
            return [[(h["chunk_id"], h["score"], h["rerank_score"]) for h in hits]
                    for hits in out]

        fast, _, slow, _ = both_paths(fused)
        if fast != slow or not fast[0]:
            raise AssertionError("the fused Q=1 batch differs between the C++ path and "
                                 "the Python rule")
        # the host share needs the host ranges only: a CPU-activity profile,
        # without CUDA tracing's cost on every launch of the batch
        shares = {}
        for label, switch in (("cpp", False), ("python", True)):
            if switch:
                os.environ[native.SWITCH] = "1"
            try:
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                    for _ in range(5):
                        fused()
            finally:
                os.environ.pop(native.SWITCH, None)
            enc = range_ms(prof, "encode_queries")
            batch = range_ms(prof, "fused_retrieve_batch")
            shares[label] = dict(encode_queries_ms=enc / 5, batch_ms=batch / 5,
                                 share=enc / batch)
        rec["fused_q1"] = shares
        log("native[a]: fused Q=1 batch identical both ways; encode_queries share of the "
            "batch (annotate ranges, 5 batches): " + ", ".join(
                f"{k} {v['encode_queries_ms']:.4f} of {v['batch_ms']:.2f} ms ({v['share']:.5f})"
                for k, v in shares.items()))
    except BaseException:
        for p in pipes:
            p.close()
        raise
    pipes[1].close()
    return rec, pipes[0]


def phase_hnsw(launches, dev="cuda"):
    """Phase 12 (b): the HNSW baseline against the exact bf16 (K1), SQ8 (K2)
    and IVF bf16 (K5) tiers on scripts/bench_hnsw_parity.py's clustered
    corpus: recall@10 against the f32 exact oracle, bytes per row, build
    seconds, ms per query (HNSW: single queries on the host; the tiers: Q =
    TIER_Q through timing.fetch_ms and timing.scanned_ms).  Each tier's
    search and build run with the counters zeroed before and read after;
    the timers run outside them.  Returns the record and the IVF tier's K5
    cases on real probes."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.baselines import HNSWBaseline
    from advanced_rag_tpu_torch.config import IndexConfig, IndexType, Metric
    from advanced_rag_tpu_torch.index.dense_index import DenseIndex
    from advanced_rag_tpu_torch.utils import timing

    dev = torch.device(dev)
    rec = {"host_cpus": os.cpu_count(), "affinity_cpus": len(os.sched_getaffinity(0))}
    # tests/test_hnsw_baseline.py's checks at its geometry, and the cache
    rng = np.random.default_rng(0)
    n, d = HNSW_TEST_GEOMETRY
    v = rng.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    cache = Path(tempfile.mkdtemp(prefix="hnsw-", dir=BUILD_DIR))
    try:
        h = HNSWBaseline(v, M=16, ef_construction=200, seed=1, cache_path=cache / "g.bin")
        self_hit = float((h.search(v[:32], 1, ef=64, normalize=False)[1][:, 0]
                          == np.arange(32)).mean())
        rng = np.random.default_rng(2)
        q = v[rng.integers(0, n, 64)] + 0.03 * rng.standard_normal((64, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        oracle = np.argsort(-(q @ v.T), axis=1)[:, :10]
        s_a, i_a = h.search(q, 10, ef=64, normalize=False)
        small_recall = set_recall(i_a, oracle)
        loaded = HNSWBaseline(v, M=16, ef_construction=200, seed=1, cache_path=cache / "g.bin")
        s_b, i_b = loaded.search(q, 10, ef=64, normalize=False)
        if not (np.array_equal(i_a, i_b) and np.array_equal(s_a, s_b)):
            raise AssertionError("the HNSW graph loaded from its cache answers differently")
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    if small_recall < 0.85 or self_hit < 0.95:
        raise AssertionError(f"HNSW at {n}x{d}: recall {small_recall}, self-query {self_hit}")
    rec["test_geometry"] = dict(n=n, d=d, recall_at_10=small_recall, self_query=self_hit)
    log(f"native[b]: HNSW at {n}x{d}: recall@10 {small_recall:.4f} (>= 0.85), self-query "
        f"{self_hit:.3f} (>= 0.95); the cached graph answers identically")

    t = time.perf_counter()
    n = HNSW_N
    v, q, tune_q = parity_corpus(n, HNSW_D, HNSW_QUERIES)
    vd = torch.from_numpy(v).to(dev)
    oracle = torch.topk(torch.from_numpy(q).to(dev) @ vd.T, 10, dim=1).indices.cpu().numpy()
    del vd
    log(f"native[b]: clustered corpus {n}x{HNSW_D} ({max(256, n // 500)} centres), "
        f"{HNSW_QUERIES} queries and the f32 oracle in {time.perf_counter() - t:.2f}s")
    t = time.perf_counter()
    h = HNSWBaseline(v, **HNSW_KNOBS, normalize=False)
    build_s = time.perf_counter() - t
    if build_s > HNSW_BUILD_LIMIT_S:
        raise AssertionError(f"the HNSW build took {build_s:.1f}s at N={n}, over "
                             f"{HNSW_BUILD_LIMIT_S}s: halve HNSW_N")
    h.search(q[0], 10, ef=HNSW_EF, normalize=False)
    ids = np.empty((len(q), 10), np.int32)
    times = []
    for i in range(len(q)):
        t = time.perf_counter()
        ids[i] = h.search(q[i], 10, ef=HNSW_EF, normalize=False)[1][0]
        times.append((time.perf_counter() - t) * 1e3)
    rows = {"hnsw": dict(recall_at_10=set_recall(ids, oracle),
                         bytes_per_row=h.memory_bytes() / n, build_s=build_s,
                         ms_per_query=float(np.median(times)),
                         mean_ms_per_query=float(np.mean(times)), max_level=h.max_level,
                         where="host, single queries", **HNSW_KNOBS, ef=HNSW_EF)}
    del h
    q_dev = torch.from_numpy(q[:TIER_Q]).to(dev).contiguous()
    k5_cases = []
    for name, dtype, ivf, key in (("exact-bf16", "bfloat16", False, "K1"),
                                  ("exact-sq8", "int8", False, "K2"),
                                  ("ivf-bf16", "bfloat16", True, "K5")):
        sync(dev)
        reset_counters()
        cfg = IndexConfig(index_type=IndexType.SEMANTIC, dim=HNSW_D, metric=Metric.COSINE,
                          dtype=dtype)
        idx = DenseIndex(cfg, device=dev)
        t = time.perf_counter()
        idx.bulk_load(v, pre_normalized=True)
        entry = {}
        if ivf:
            idx.build_ivf()
            entry["nprobe"], entry["tune_recall"] = idx.tune_nprobe(
                0.95, k=10, sample=64, queries=tune_q)
            entry["nlist"] = int(idx._ivf.centroids.shape[0])
        sync(dev)
        entry["build_s"] = time.perf_counter() - t
        got = np.concatenate([idx.search(q[s:s + 32], 10)[1].cpu().numpy()
                              for s in range(0, len(q), 32)])
        counts = read_counters()
        if counts[key] == 0:
            raise AssertionError(f"tier {name} did not run {key}: {counts}")
        for k in KERNEL_KEYS:
            launches[k] += counts[k]
        entry.update(recall_at_10=set_recall(got, oracle),
                     bytes_per_row=idx.memory_bytes() / n, launches=counts)
        # the timers, outside the counted window: fetch_ms of the whole
        # search (the SQ8 tier's exact re-rank of its candidates is host
        # work), scanned_ms of its device part
        bound_mask = idx._bound()
        fetch = [timing.fetch_ms(lambda: idx.search(q_dev, 10), small=lambda r: r[1])
                 for _ in range(REPEATS)][2:]
        entry["fetch_ms_per_query"] = float(np.median(fetch)) / TIER_Q
        entry["scanned_ms_per_query"] = timing.scanned_ms(
            lambda eps, qq: idx._search_device(qq + eps, 10, bound_mask),
            operands=(q_dev,), device=str(dev)) / TIER_Q
        if ivf:
            k5_cases = real_probe_cases(idx._ivf, torch.from_numpy(q[:32]).to(dev),
                                        idx.config.nprobe)
        rows[name] = entry
        del idx
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if rows["exact-bf16"]["recall_at_10"] < 0.99:
        raise AssertionError(f"exact bf16 recall@10 {rows['exact-bf16']['recall_at_10']}")
    rec.update(n=n, d=HNSW_D, queries=HNSW_QUERIES, rows=rows)
    for name, r in rows.items():
        ms = (f"{r['ms_per_query']:.4f} ms/query (median, single queries on the host)"
              if name == "hnsw" else
              f"fetch {r['fetch_ms_per_query']:.4f} / device {r['scanned_ms_per_query']:.5f} "
              f"ms/query at Q={TIER_Q}")
        log(f"native[b]: {name:10s} recall@10 {r['recall_at_10']:.4f}, "
            f"{r['bytes_per_row']:.1f} B/row, build {r['build_s']:.2f}s, {ms}"
            + (f", nprobe {r['nprobe']} of {r['nlist']}" if "nprobe" in r else ""))
    return rec, k5_cases


def phase_timers(mgr, reranker, texts, launches, dev="cuda"):
    """Phase 12 (c): timing.scanned_ms of K1 (bf16, N = MAIN_N, Q = 32) within
    10% of graph_ms of the same call; chained_ms and fetch_ms of it at least
    its device time; a device_trace around one fused Q = 8 batch names the
    annotated ranges and K1's and K3's kernels."""
    import json as _json

    import numpy as np
    import torch

    from advanced_rag_tpu_torch.ops import dense_kernels as dk
    from advanced_rag_tpu_torch.ops.dense import l2_normalize, mask_additive
    from advanced_rag_tpu_torch.utils import timing
    from advanced_rag_tpu_torch.utils.profiling import device_trace

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(1234)
    n, d, nq = MAIN_N, 384, 32
    rows = l2_normalize(torch.randn(n, d, generator=gen, device=dev)).to(torch.bfloat16)
    m = mask_additive(torch.rand(n, generator=gen, device=dev) >= 1.0 / 3.0, n, dev)
    q = l2_normalize(torch.randn(nq, d, generator=gen, device=dev)).contiguous()
    rec = dict(shape=f"bf16 rows N={n} D={d} Q={nq}")
    rec["graph_ms"] = graph_ms(lambda: dk.dense_scores(q, rows, m))
    rec["scanned_ms"] = timing.scanned_ms(lambda eps, qq: dk.dense_scores(qq + eps, rows, m),
                                          rounds=20, operands=(q,), device=str(dev))
    rec["graph_ms_after"] = graph_ms(lambda: dk.dense_scores(q, rows, m))
    rec["chained_ms"] = timing.chained_ms(lambda i, eps: dk.dense_scores(q + eps, rows, m),
                                          rounds=20)
    rec["fetch_ms"] = timing.fetch_ms(lambda: dk.dense_scores(q, rows, m),
                                      small=lambda s: s[:, :1])
    device = min(rec["graph_ms"], rec["graph_ms_after"])
    rec["scanned_vs_graph"] = rec["scanned_ms"] / device - 1.0
    log(f"timers[c]: K1 {rec['shape']}: scanned_ms {rec['scanned_ms']:.4f}, graph_ms "
        f"{rec['graph_ms']:.4f} / {rec['graph_ms_after']:.4f} (scanned {rec['scanned_vs_graph']:+.3f}), "
        f"chained_ms {rec['chained_ms']:.4f}, fetch_ms {rec['fetch_ms']:.4f}")
    if abs(rec["scanned_vs_graph"]) > 0.10:
        raise AssertionError(f"scanned_ms {rec['scanned_ms']} is not within 10% of graph_ms "
                             f"{device}")
    if rec["chained_ms"] < device or rec["fetch_ms"] < device:
        raise AssertionError("chained_ms or fetch_ms read less than the device time")
    del rows, m
    trace_dir = Path(tempfile.mkdtemp(prefix="trace-", dir=BUILD_DIR))
    try:
        rng = np.random.default_rng(67)
        queries = snippet_queries(rng, texts, 8)
        sync(dev)
        reset_counters()
        with device_trace(str(trace_dir)):
            out = mgr.fused_retrieve_batch_sync(queries, reranker=reranker, **SERVE)
            sync(dev)
        counts = read_counters()
        for k in KERNEL_KEYS:
            launches[k] += counts[k]
        if len(out) != 8:
            raise AssertionError("the traced batch returned the wrong number of queries")
        traces = list(trace_dir.glob("trace_*.json"))
        if len(traces) != 1:
            raise AssertionError(f"device_trace wrote {len(traces)} traces")
        names = {e.get("name", "") for e in _json.loads(traces[0].read_text())["traceEvents"]}
        rec["trace_bytes"] = traces[0].stat().st_size
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    ranges = ("fused_retrieve_batch", "tokenize_queries", "encode_queries",
              "retrieve_rerank", "hydrate")
    missing = [r for r in ranges if r not in names]
    kernels = {k: sorted(nm for nm in names if pat in nm.lower())[:2]
               for k, pat in (("K1", "dense_scores_kernel"), ("K3", "bm25_scores_kernel"))}
    if missing or not all(kernels.values()):
        raise AssertionError(f"the trace misses ranges {missing} or kernels {kernels}")
    rec.update(trace_ranges=list(ranges), trace_kernels=kernels, launches=counts)
    log(f"timers[c]: device_trace of a fused Q=8 batch ({rec['trace_bytes']} bytes) names "
        f"{list(ranges)} and kernels {kernels}; launches {counts}")
    return rec


def phase_host_native(texts, embedder, reranker, dev="cuda"):
    """Phase 12: (a) the C++ text path, (b) HNSW against the tiers, (c) the
    timers and traces.  Returns the record, the launches of its paths and
    the K5 cases of (b)'s IVF tier."""
    t_phase = time.perf_counter()
    launches = dict.fromkeys(KERNEL_KEYS, 0)
    rec = {}
    t = time.perf_counter()
    rec["a"], pipe = phase_text_path(texts, embedder, reranker, dev)
    rec["a"]["seconds"] = time.perf_counter() - t
    try:
        t = time.perf_counter()
        rec["b"], k5_cases = phase_hnsw(launches, dev)
        rec["b"]["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        rec["c"] = phase_timers(pipe.index_manager, reranker, texts, launches, dev)
        rec["c"]["seconds"] = time.perf_counter() - t
    finally:
        pipe.close()
    for key in ("K1", "K2", "K3", "K5"):
        if launches[key] == 0:
            raise AssertionError(f"phase 12 launched no {key}: {launches}")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"native: phase 12 took {rec['seconds']:.2f}s ((a) {rec['a']['seconds']:.2f}s, "
        f"(b) {rec['b']['seconds']:.2f}s, (c) {rec['c']['seconds']:.2f}s); launches {launches}")
    return rec, launches, k5_cases


# -- phase 13: the HF checkpoint models (models/hf_*.py) -----------------------

#: sentence-transformers/all-MiniLM-L6-v2's and
#: cross-encoder/ms-marco-MiniLM-L-6-v2's geometry (BERT, uncased WordPiece)
HF_GEOMETRY = dict(vocab_size=30522, hidden_size=384, num_hidden_layers=6,
                   num_attention_heads=12, intermediate_size=1536,
                   max_position_embeddings=512, type_vocab_size=2)
#: (c)'s chunks and (b)'s texts, cut from 20,000 and 256 with phase 13 (g)
HF_CHUNKS = 10_000
HF_PARITY_TEXTS = 64
HF_BATCH = 64
HF_REQUESTS = 64
HF_CLIENTS = (1, 8)
HF_TOL = 1e-4                  # card vs CPU, f32, max |err|


def hf_vocab(size=None):
    """A vocab.txt of ``size`` entries (HF_GEOMETRY's) laid out as BERT-uncased's:
    [PAD], [unused0-98], [UNK], [CLS], [SEP], [MASK], more [unused], the
    printable ASCII characters and their ## pieces, then phase 4's corpus
    words (synthetic_corpus's vocabulary) by frequency."""
    import numpy as np

    size = size or HF_GEOMETRY["vocab_size"]
    words, _ = zipf_vocab(np.random.default_rng(11))
    out = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
           + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
           + [f"[unused{i}]" for i in range(99, 994)])
    chars = [chr(c) for c in range(33, 127)]
    out += chars + ["##" + c for c in chars]
    seen = set(out)
    for w in words.tolist():
        if len(out) == size:
            break
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out + [f"[unused{i}]" for i in range(994, 994 + size - len(out))]


#: the LayerNorm scales a seeded checkpoint draws as 1 + N(0, 0.05) (the GPT
#: families' ln_1 / ln_2 / ln_f and BLOOM's input_, post_attention_ and
#: word_embeddings_layernorm last)
LN_SCALES = ("LayerNorm.weight", "layer_norm.weight", "layernorm_embedding.weight",
             "ln_1.weight", "ln_2.weight", "ln_f.weight", "layernorm.weight")


def write_safetensors(path, state, bf16=False):
    """``state`` as one safetensors file of f32 (or, with ``bf16``, BF16)
    tensors: an 8-byte header length, the JSON header, the raw
    little-endian bytes."""
    import struct

    import torch

    header, blobs, off = {}, [], 0
    for name, t in state.items():
        t = t.detach().to(torch.bfloat16 if bf16 else torch.float32).contiguous().cpu()
        b = (t.view(torch.int16) if bf16 else t).numpy().tobytes()
        header[name] = {"dtype": "BF16" if bf16 else "F32", "shape": list(t.shape),
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for b in blobs:
            f.write(b)


def write_hf_checkpoint(path, head: bool, seed: int, family: str = "bert", dev=None):
    """An HF checkpoint with weights drawn from a seeded torch.Generator
    (N(0, 0.02); LayerNorm scales 1 + N(0, 0.05)) in model.safetensors,
    beside config.json and the family's tokenizer files.  "bert": at
    HF_GEOMETRY with vocab.txt, ``head``: BertForSequenceClassification
    with one label, else BertModel (with its pooler, as all-MiniLM-L6-v2
    ships).  Another family: at its HF_FAMILIES geometry, a sequence
    classifier with one label or a trunk as HF_FAMILIES says, with
    RoBERTa's (and RoBERTa-PreLayerNorm's) vocab.json + merges.txt, XLM-R's,
    ALBERT's or BigBird's Unigram tokenizer.json, or ELECTRA's /
    DistilBERT's / RoFormer's vocab.txt (phase 13's WordPiece vocabulary);
    a family of (h) at its ``written`` layers; an encoder-decoder of (i)
    (HF_ENCDEC) with its stacks cut to ``written`` layers and its
    tokenizer (encdec_tokenizer_files).  With ``dev`` the weights are drawn
    there and written as BF16 (the card draws them fastest, and half the
    bytes write in half the time)."""
    import torch

    from advanced_rag_tpu_torch.models.hf_bert import BertModel
    from advanced_rag_tpu_torch.models.hf_checkpoint import read_config
    from advanced_rag_tpu_torch.models.hf_cross_encoder import build_classifier
    from advanced_rag_tpu_torch.models.hf_embedder import build_trunk

    path.mkdir(parents=True, exist_ok=True)
    if family == "bert":
        (path / "vocab.txt").write_text("\n".join(hf_vocab()) + "\n")
        (path / "tokenizer_config.json").write_text(json.dumps(
            {"do_lower_case": True, "tokenizer_class": "BertTokenizer"}))
        cfg = dict(model_type="bert", hidden_act="gelu", layer_norm_eps=1e-12,
                   position_embedding_type="absolute", pad_token_id=0,
                   architectures=["BertForSequenceClassification" if head else "BertModel"],
                   **HF_GEOMETRY)
    elif family in HF_ENCDEC:
        spec = HF_ENCDEC[family]
        cfg = dict(spec["config"])
        for stack in ("encoder_layers", "decoder_layers"):
            cfg[stack] = min(cfg[stack], spec["written"])
        encdec_tokenizer_files(path, family, cfg["vocab_size"])
    else:
        spec = HF_FAMILIES[family]
        cfg = dict(spec["config"])
        if "written" in spec:
            cfg["num_hidden_layers"] = spec["written"]
        if family in ("roberta", "roberta-prelayernorm"):
            roberta_tokenizer_files(path, cfg["vocab_size"])
        elif family == "xlm-roberta":
            xlmr_tokenizer_files(path, cfg["vocab_size"])
        elif family in ("albert", "big_bird"):
            spm_tokenizer_files(path, cfg["vocab_size"], family)
        else:
            (path / "vocab.txt").write_text("\n".join(hf_vocab(cfg["vocab_size"])) + "\n")
            (path / "tokenizer_config.json").write_text(json.dumps(
                {"do_lower_case": True,
                 "tokenizer_class": {"electra": "ElectraTokenizer",
                                     "distilbert": "DistilBertTokenizer",
                                     "roformer": "BertTokenizer"}[family]}))
    if head:
        cfg["id2label"] = {"0": "LABEL_0"}
    (path / "config.json").write_text(json.dumps(cfg, indent=2))
    config = read_config(path)
    with torch.device("meta"):                # names and shapes, no storage
        module = (build_classifier(config, torch.float32) if head
                  else BertModel(config) if family == "bert"
                  else build_trunk(config, torch.float32))
    gen = torch.Generator(device=dev or "cpu").manual_seed(seed)
    state = {}
    for name, p in module.state_dict().items():
        n = torch.randn(p.shape, generator=gen, device=gen.device)
        state[name] = (1.0 + 0.05 * n if name.endswith(LN_SCALES) else 0.02 * n)
    write_safetensors(path / "model.safetensors", state, bf16=dev is not None)


def hf_parity(root, docs, queries, dev):
    """(b): each model on the card against the same module on the CPU, f32
    within HF_TOL; the bf16 distance from the CPU's f32 is recorded."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.models.hf_cross_encoder import HFCrossEncoder
    from advanced_rag_tpu_torch.models.hf_embedder import HFEmbedder

    rec = {}
    for kind, cls, run in (
            ("embed", HFEmbedder, lambda m: m.encode(docs)),
            ("rerank", HFCrossEncoder, lambda m: m.score_pairs(queries, docs))):
        path = root / ("emb" if kind == "embed" else "ce")
        t = time.perf_counter()
        want = run(cls(path, device="cpu"))
        rec[f"{kind}_cpu_s"] = time.perf_counter() - t
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            got = run(cls(path, dtype=dtype, device=dev))
            if got.shape != want.shape or not np.isfinite(got).all():
                raise AssertionError(f"hf {kind} {name}: shape {got.shape} or "
                                     "non-finite values")
            rec[f"{kind}_{name}_max_abs_err"] = float(np.abs(got - want).max())
        rec[f"{kind}_scale"] = float(np.abs(want).max())
        if rec[f"{kind}_float32_max_abs_err"] > HF_TOL:
            raise AssertionError(f"hf {kind}: the card's f32 differs from the CPU's "
                                 f"by {rec[f'{kind}_float32_max_abs_err']} > {HF_TOL}")
    norms = np.linalg.norm(HFEmbedder(root / "emb", device=dev).encode(docs[:8]), axis=1)
    if not np.allclose(norms, 1.0, atol=1e-5):
        raise AssertionError(f"hf embeddings are not unit vectors: {norms}")
    log("hf: card vs CPU on " + f"{len(docs)} texts: " + ", ".join(
        f"{k} {v:.3g}" for k, v in rec.items()))
    return rec


def hf_throughput(root, texts, queries, dev):
    """(d): encode at HF_BATCH x 128 tokens and rerank HF_BATCH pairs at
    256 tokens, f32 and bf16: the whole call (tokenization, the forward,
    the pooling) on the host clock and the model's forward alone in CUDA
    events, after warm-up."""
    import torch

    from advanced_rag_tpu_torch.models.hf_cross_encoder import HFCrossEncoder
    from advanced_rag_tpu_torch.models.hf_embedder import HFEmbedder

    # two 100-word chunks fill the embedder's 128 tokens, three a pair's 256
    docs = [f"{texts[i]} {texts[i + 1]}" for i in range(1, 2 * HF_BATCH, 2)]
    pairs_d = [" ".join(texts[i:i + 3]) for i in range(1, 3 * HF_BATCH, 3)]
    rec = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        emb = HFEmbedder(root / "emb", dtype=dtype, device=dev)
        ce = HFCrossEncoder(root / "ce", dtype=dtype, device=dev)
        e_in = [torch.from_numpy(a).to(dev) for a in emb._tokenize(docs, HF_BATCH)]
        c_in = [torch.from_numpy(a).to(dev)
                for a in ce._tokenize(queries[:HF_BATCH], pairs_d, HF_BATCH)]
        if not (bool(e_in[1].all()) and bool(c_in[1].all())):
            raise AssertionError("hf throughput batches are not full length")
        with torch.inference_mode():
            fwd_e = cuda_ms(lambda: emb.model(e_in[0], e_in[1], torch.zeros_like(e_in[0])))
            fwd_c = cuda_ms(lambda: ce.model(*c_in))
        whole = {}
        for key, call in (("encode", lambda: emb.encode_device(docs)),
                          ("rerank", lambda: ce.score_pairs(queries[:HF_BATCH], pairs_d))):
            call()
            sync(dev)
            t = time.perf_counter()
            for _ in range(10):
                call()
            sync(dev)
            whole[key] = (time.perf_counter() - t) / 10 * 1e3
        rec[name] = dict(
            encode_ms=whole["encode"], encode_texts_per_s=HF_BATCH / whole["encode"] * 1e3,
            encode_forward_ms=fwd_e, rerank_ms=whole["rerank"],
            rerank_pairs_per_s=HF_BATCH / whole["rerank"] * 1e3, rerank_forward_ms=fwd_c)
        log(f"hf[{name}]: encode {HF_BATCH} x {emb.max_len} tokens "
            f"{whole['encode']:.2f} ms ({rec[name]['encode_texts_per_s']:.0f} texts/s; "
            f"forward {fwd_e:.3f} ms); rerank {HF_BATCH} pairs x {ce.max_len} tokens "
            f"{whole['rerank']:.2f} ms ({rec[name]['rerank_pairs_per_s']:.0f} pairs/s; "
            f"forward {fwd_c:.3f} ms)")
    return rec


def hf_service(root, texts, queries, dev, emb_dir=None, ce_dir=None, chunks=None,
               clients=None, requests=None, warm=True, db="service_hf.db", embedder=None):
    """(c): a bf16-tier manager with the HF embedder of ``emb_dir`` (else
    ``root/emb``; or ``embedder``, built by the caller) ingests ``chunks``
    (HF_CHUNKS) of phase 4's chunks; the
    port's app, RAG_RERANKER=hf: wiring the HF cross-encoder of ``ce_dir``
    (else ``root/ce``) into that pipeline, answers ``requests``
    (HF_REQUESTS) /retrieve requests from each of ``clients`` (HF_CLIENTS)
    clients, where every answer must be a 200 with finite reranked scores.
    With ``warm``, /admin/warmup then puts the service's latency budgets in
    force (the retriever's degrade-to-empty, the endpoint's timeout) and
    the last level runs again as "warm-8": answers past the budgets are
    shed (an empty 200, a 504, a 503 once the breaker opens, a 429) and
    counted, not failed.  K1 and K3 must run (counters zeroed just before
    the ingest, read after the load) and then match their plain versions
    on the manager's own tensors."""
    import numpy as np

    from advanced_rag_tpu_torch.config import PipelineConfig
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.models.hf_cross_encoder import HFCrossEncoder
    from advanced_rag_tpu_torch.models.hf_embedder import HFEmbedder
    from advanced_rag_tpu_torch.pipeline import AdvancedRAGPipeline
    from advanced_rag_tpu_torch.utils.db_pool import DatabasePool

    cfg = PipelineConfig(semantic_dtype="bfloat16")
    emb_dir, ce_dir = emb_dir or root / "emb", ce_dir or root / "ce"
    chunks, clients = chunks or HF_CHUNKS, clients or HF_CLIENTS
    requests = requests or HF_REQUESTS
    emb = embedder or HFEmbedder(emb_dir, device=dev)
    cfg.semantic_dim = emb.dim
    mgr = MultiIndexManager(cfg, embedder=emb, device=dev)
    pipe = AdvancedRAGPipeline(cfg, index_manager=mgr, device=dev)
    rec = {}
    reset_counters()
    t = time.perf_counter()
    ingest_all(mgr, texts[:chunks])
    sync(dev)
    rec["ingest_s"] = time.perf_counter() - t
    rec["chunks"] = mgr.store.n_valid()
    log(f"hf: {rec['chunks']} chunks through index_chunks with the HF embedder in "
        f"{rec['ingest_s']:.2f}s")
    saved = {k: os.environ.get(k) for k in (*SERVICE_ENV, "API_KEY", "RAG_RERANKER")}
    os.environ.update(SERVICE_ENV, RAG_RERANKER=f"hf:{ce_dir}")
    os.environ.pop("API_KEY", None)

    async def go():
        from aiohttp.test_utils import TestClient, TestServer

        from advanced_rag_tpu_torch.service import create_app

        client = TestClient(TestServer(create_app(
            cfg, pipeline=pipe, db=DatabasePool(sqlite_path=str(BUILD_DIR / db)))))
        await client.start_server()
        try:
            if not isinstance(pipe.retriever.reranker, HFCrossEncoder):
                raise AssertionError("RAG_RERANKER=hf: wired no HF cross-encoder")
            if pipe._use_fused_path():
                raise AssertionError("the HF pipeline took the fused path")

            async def one(q, shed_ok):
                """(ms, "200" or how the answer was shed)"""
                t0 = time.perf_counter()
                resp = await client.post("/retrieve", json={"query": q,
                                                            "top_k": SERVICE_TOP_K})
                body = await resp.json()
                ms = (time.perf_counter() - t0) * 1e3
                scores = [r["score"] for r in body.get("results") or []]
                if shed_ok and (resp.status in (429, 503, 504)
                                or (resp.status == 200 and not scores)):
                    return ms, "empty" if resp.status == 200 else str(resp.status)
                if resp.status != 200 or not scores or not np.isfinite(scores).all():
                    raise AssertionError(f"/retrieve answered {resp.status} with "
                                         f"{len(scores)} results: {str(body)[:300]}")
                if not all("rerank_score" in r["metadata"] for r in body["results"]):
                    raise AssertionError("the HF reranker did not score the results")
                return ms, "200"

            async def client_run(qs, shed_ok):
                return [await one(q, shed_ok) for q in qs]

            async def level(name, conc, qs, shed_ok=False):
                per = requests // conc
                before = {k: len(v) for k, v in pipe._stage_latencies.items()}
                before["retrieve"] = len(pipe._retrieve_latencies)
                t0 = time.perf_counter()
                runs = await asyncio.gather(*[client_run(qs[c * per:(c + 1) * per], shed_ok)
                                              for c in range(conc)])
                wall = time.perf_counter() - t0
                ms = np.asarray([m for r in runs for m, _ in r])
                kinds = [k for r in runs for _, k in r]
                served = np.asarray([m for r in runs for m, k in r if k == "200"])
                # the pipeline's own p50s of this level: retrieve and its stages
                stages = {}
                for key, n0 in before.items():
                    vals = (pipe._retrieve_latencies if key == "retrieve"
                            else pipe._stage_latencies[key])[n0:]
                    if vals:
                        stages[key] = float(np.percentile(vals, 50))
                rec = dict(requests=int(ms.size), p50_ms=float(np.percentile(ms, 50)),
                           p99_ms=float(np.percentile(ms, 99)),
                           requests_per_s=ms.size / wall, pipeline_p50_ms=stages,
                           answers={k: kinds.count(k) for k in sorted(set(kinds))},
                           shed=int(ms.size - served.size),
                           served_p99_ms=(float(np.percentile(served, 99))
                                          if served.size else None))
                log(f"hf: /retrieve {name} from {conc} client(s): {ms.size} requests "
                    f"{rec['answers']}, p50 {rec['p50_ms']:.2f} ms, p99 "
                    f"{rec['p99_ms']:.2f} ms, {rec['requests_per_s']:.1f} requests/s; "
                    "pipeline p50 ms " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
                return rec

            for q in queries[:8]:                      # warm-up
                await one(q, False)
            out, qi = {}, 8
            for conc in clients:
                out[conc] = await level("cold", conc, queries[qi:qi + requests])
                qi += requests
            if warm:
                resp = await client.post("/admin/warmup", json={"top_k": [SERVICE_TOP_K]})
                if resp.status != 200:
                    raise AssertionError(f"/admin/warmup answered {resp.status}")
                if not pipe.is_warm(queries[qi], SERVICE_TOP_K):
                    raise AssertionError("the HF app is not warm after /admin/warmup")
                out[f"warm-{clients[-1]}"] = await level(
                    "warm", clients[-1], queries[qi:qi + requests], shed_ok=True)
                qi += requests
            sync(dev)
            launches = read_counters()
            if launches["K1"] == 0 or launches["K3"] == 0:
                raise AssertionError(f"the HF path ran no K1 or K3: {launches}")
            kernels = check_served_tensors(mgr, queries[qi:qi + 32])
            return out, launches, kernels
        finally:
            await client.close()     # on_shutdown closes the pipeline

    try:
        rec["retrieve"], launches, rec["kernels"] = asyncio.run(go())
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rec["launches"] = launches
    log(f"hf: launches {launches}; against the plain versions on its tensors "
        f"{rec['kernels']}")
    return rec, launches


# -- phase 13 (e), (f): the other HF encoder families ---------------------------

#: the published geometries the other families run at (config.json as
#: transformers writes it), each with its source and whether it is a
#: sequence classifier (a reranker) or a trunk (an embedder)
HF_FAMILIES = {
    "roberta": dict(
        source="sentence-transformers/all-distilroberta-v1", head=False,
        config=dict(model_type="roberta", architectures=["RobertaModel"],
                    vocab_size=50265, hidden_size=768, num_hidden_layers=6,
                    num_attention_heads=12, intermediate_size=3072,
                    max_position_embeddings=514, type_vocab_size=1, layer_norm_eps=1e-5,
                    pad_token_id=1, hidden_act="gelu", position_embedding_type="absolute")),
    "electra": dict(
        source="cross-encoder/ms-marco-electra-base", head=True,
        config=dict(model_type="electra", architectures=["ElectraForSequenceClassification"],
                    vocab_size=30522, embedding_size=768, hidden_size=768,
                    num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
                    max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12,
                    pad_token_id=0, hidden_act="gelu", position_embedding_type="absolute")),
    "xlm-roberta": dict(
        source="BAAI/bge-reranker-base", head=True,
        config=dict(model_type="xlm-roberta",
                    architectures=["XLMRobertaForSequenceClassification"],
                    vocab_size=250002, hidden_size=768, num_hidden_layers=12,
                    num_attention_heads=12, intermediate_size=3072,
                    max_position_embeddings=514, type_vocab_size=1, layer_norm_eps=1e-5,
                    pad_token_id=1, hidden_act="gelu", position_embedding_type="absolute")),
    "distilbert": dict(
        source="sentence-transformers/msmarco-distilbert-base-v4", head=False,
        config=dict(model_type="distilbert", architectures=["DistilBertModel"],
                    vocab_size=30522, dim=768, hidden_dim=3072, n_layers=6, n_heads=12,
                    max_position_embeddings=512, activation="gelu",
                    sinusoidal_pos_embds=False, pad_token_id=0)),
    # (h): written at ``written`` layers (ALBERT's one shared group is all
    # of its weights), on the card against the CPU at ``max_len``
    "big_bird": dict(
        source="google/bigbird-roberta-base", head=False, written=2, max_len=512,
        config=dict(model_type="big_bird", architectures=["BigBirdModel"],
                    vocab_size=50358, hidden_size=768, num_hidden_layers=12,
                    num_attention_heads=12, intermediate_size=3072, hidden_act="gelu_new",
                    max_position_embeddings=4096, type_vocab_size=2, layer_norm_eps=1e-12,
                    pad_token_id=0, bos_token_id=1, eos_token_id=2, sep_token_id=66,
                    attention_type="block_sparse", block_size=64, num_random_blocks=3,
                    use_bias=True, rescale_embeddings=False)),
    "albert": dict(
        source="albert-base-v2", head=True, written=12, max_len=256,
        config=dict(model_type="albert", architectures=["AlbertForSequenceClassification"],
                    vocab_size=30000, embedding_size=128, hidden_size=768,
                    num_hidden_layers=12, num_hidden_groups=1, inner_group_num=1,
                    num_attention_heads=12, intermediate_size=3072, hidden_act="gelu_new",
                    max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12,
                    pad_token_id=0, bos_token_id=2, eos_token_id=3,
                    position_embedding_type="absolute")),
    "roformer": dict(
        source="junnyu/roformer_chinese_base", head=True, written=2, max_len=256,
        config=dict(model_type="roformer", architectures=["RoFormerForSequenceClassification"],
                    vocab_size=50000, embedding_size=768, hidden_size=768,
                    num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
                    hidden_act="gelu", max_position_embeddings=1536, type_vocab_size=2,
                    layer_norm_eps=1e-12, pad_token_id=0, rotary_value=False)),
    "roberta-prelayernorm": dict(
        source="andreasmadsen/efficient_mlm_m0.40", head=False, written=2, max_len=256,
        config=dict(model_type="roberta-prelayernorm",
                    architectures=["RobertaPreLayerNormModel"], vocab_size=50265,
                    hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                    intermediate_size=4096, hidden_act="gelu", max_position_embeddings=514,
                    type_vocab_size=1, layer_norm_eps=1e-5, pad_token_id=1,
                    position_embedding_type="absolute")),
}
#: (e)'s families; (h) runs the others
E_FAMILIES = [f for f, spec in HF_FAMILIES.items() if "written" not in spec]
HF_FAMILY_TEXTS = 16                 # texts or pairs, card vs CPU
#: tokens a row of the throughput batches (256 too until phase 13 (g))
HF_FAMILY_LENGTHS = (128,)
HF_FAMILY_CHUNKS = 5_000             # the RoBERTa + ELECTRA service level
HF_FAMILY_REQUESTS = 32


def byte_bpe_vocab(size, front, last):
    """A byte-level BPE vocabulary of ``size`` entries and its merges:
    ``front``, GPT-2's 256 byte symbols, then, for phase 4's corpus words by
    frequency, the merges that build "Ġword" left to right (greedy, each
    merge once) while there is room, filler, and ``last`` at the end."""
    import numpy as np

    from advanced_rag_tpu_torch.models.hf_bpe import bytes_to_unicode

    words, _ = zipf_vocab(np.random.default_rng(11))
    vocab = {t: i for i, t in enumerate(front)}
    for ch in bytes_to_unicode().values():
        vocab.setdefault(ch, len(vocab))
    merges = []
    for w in words.tolist():
        cur = "Ġ"
        for ch in w:
            if cur + ch not in vocab:
                if len(vocab) == size - 1:
                    break
                vocab[cur + ch] = len(vocab)
                merges.append(f"{cur} {ch}")
            cur += ch
    while len(vocab) < size - 1:
        vocab[f"<unused{len(vocab)}>"] = len(vocab)
    vocab[last] = size - 1
    return vocab, merges


def bpe_files(path, vocab, merges, config):
    """vocab.json + merges.txt (behind the ``#version`` line) and
    tokenizer_config.json."""
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    (path / "tokenizer_config.json").write_text(json.dumps(config))


def roberta_tokenizer_files(path, size):
    """RoBERTa's vocab.json + merges.txt at ``size`` entries (byte_bpe_vocab:
    the specials in front, <mask> last)."""
    vocab, merges = byte_bpe_vocab(size, ["<s>", "<pad>", "</s>", "<unk>"], "<mask>")
    bpe_files(path, vocab, merges,
              {"tokenizer_class": "RobertaTokenizer", "add_prefix_space": False})


def xlmr_tokenizer_files(path, size):
    """XLM-R's tokenizer.json at ``size`` pieces: a Unigram model scored
    from phase 4's corpus (each word "▁word" at log of its Zipf weight, the
    letters at log of their frequency less 8, so known words stay whole),
    PUA filler, <mask> last; XLM-R's normalizer (a Precompiled charsmap of
    the full-width forms, then " {2,}" to one space), Metaspace and
    template."""
    import base64
    import math

    import numpy as np

    from advanced_rag_tpu_torch.models.hf_unigram import build_precompiled

    words, p = zipf_vocab(np.random.default_rng(11))
    letters = {}
    for w, pw in zip(words.tolist(), p.tolist()):
        for ch in w:
            letters[ch] = letters.get(ch, 0.0) + pw * len(w)
    total = sum(letters.values())
    pieces = [["<s>", 0.0], ["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0], ["▁", -4.0]]
    pieces += [[ch, math.log(n / total) - 8.0] for ch, n in sorted(letters.items())]
    seen = set()
    for w, pw in zip(words.tolist(), p.tolist()):
        if w not in seen:
            seen.add(w)
            pieces.append([f"▁{w}", math.log(pw)])
    if len(pieces) > size - 1:
        raise AssertionError(f"{len(pieces)} pieces do not fit a vocabulary of {size}")
    pieces += [[f"\U000F0000{i}", -40.0] for i in range(size - 1 - len(pieces))]
    pieces.append(["<mask>", 0.0])
    rules = {chr(0xFF01 + i): chr(0x21 + i) for i in range(94)}
    rules.update({"　": " ", "…": "..."})

    def added(i, tok, lstrip=False):
        return {"id": i, "content": tok, "single_word": False, "lstrip": lstrip,
                "rstrip": False, "normalized": False, "special": True}

    def special(tok):
        return {"SpecialToken": {"id": tok, "type_id": 0}}

    seq = [{"Sequence": {"id": "A", "type_id": 0}}, {"Sequence": {"id": "B", "type_id": 0}}]
    tj = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [added(i, t) for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>"])]
        + [added(size - 1, "<mask>", lstrip=True)],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap":
             base64.b64encode(build_precompiled(rules)).decode()},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                          "prepend_scheme": "always", "split": True},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [special("<s>"), seq[0], special("</s>")],
            "pair": [special("<s>"), seq[0], special("</s>"), special("</s>"), seq[1],
                     special("</s>")],
            "special_tokens": {t: {"id": t, "ids": [i], "tokens": [t]}
                               for t, i in (("<s>", 0), ("</s>", 2))}},
        "decoder": None,
        "model": {"type": "Unigram", "unk_id": 3, "vocab": pieces, "byte_fallback": False},
    }
    (path / "tokenizer.json").write_text(json.dumps(tj, ensure_ascii=False))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "XLMRobertaTokenizer"}))


def spm_tokenizer_files(path, size, family):
    """ALBERT's or BigBird's tokenizer.json at ``size`` pieces, as their
    converters lay it out: the class's specials first ([CLS], [SEP], [MASK]
    among them), "▁", the letters and phase 4's corpus words scored as in
    xlmr_tokenizer_files, PUA filler; ALBERT's normalizer (Replace "``" and
    "''", NFKD, StripAccents, Lowercase, a Precompiled charsmap of the
    full-width forms, " {2,}" to one space) or BigBird's (the charsmap,
    Strip right, " {2,}" to "▁"), Metaspace, the template [CLS] A [SEP] /
    [CLS] A [SEP] B [SEP] (B of type 1), and the class's
    tokenizer_config.json."""
    import base64
    import math

    import numpy as np

    from advanced_rag_tpu_torch.models.hf_unigram import build_precompiled

    words, p = zipf_vocab(np.random.default_rng(11))
    letters = {}
    for w, pw in zip(words.tolist(), p.tolist()):
        for ch in w:
            letters[ch] = letters.get(ch, 0.0) + pw * len(w)
    total = sum(letters.values())
    specials = (["<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]"] if family == "albert"
                else ["<pad>", "</s>", "<s>", "<unk>", "[CLS]", "[SEP]", "[MASK]"])
    ids = {t: i for i, t in enumerate(specials)}
    pieces = [[t, 0.0] for t in specials] + [["▁", -4.0]]
    pieces += [[ch, math.log(n / total) - 8.0] for ch, n in sorted(letters.items())]
    seen = set()
    for w, pw in zip(words.tolist(), p.tolist()):
        if w not in seen and len(pieces) < size:
            seen.add(w)
            pieces.append([f"▁{w}", math.log(pw)])
    pieces += [[f"\U000F0000{i}", -40.0] for i in range(size - len(pieces))]
    rules = {chr(0xFF01 + i): chr(0x21 + i) for i in range(94)}
    rules.update({"　": " ", "…": "..."})
    charsmap = {"type": "Precompiled",
                "precompiled_charsmap": base64.b64encode(build_precompiled(rules)).decode()}
    if family == "albert":
        steps = [{"type": "Replace", "pattern": {"String": "``"}, "content": '"'},
                 {"type": "Replace", "pattern": {"String": "''"}, "content": '"'},
                 {"type": "NFKD"}, {"type": "StripAccents"}, {"type": "Lowercase"},
                 charsmap, {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]
    else:
        steps = [charsmap, {"type": "Strip", "strip_left": False, "strip_right": True},
                 {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "▁"}]

    def special(tok, type_id):
        return {"SpecialToken": {"id": tok, "type_id": type_id}}

    def seq(name, type_id):
        return {"Sequence": {"id": name, "type_id": type_id}}

    tj = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False,
                          "lstrip": t == "[MASK]", "rstrip": False, "normalized": False,
                          "special": True} for t, i in ids.items()],
        "normalizer": {"type": "Sequence", "normalizers": steps},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                          "prepend_scheme": "always", "split": True},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [special("[CLS]", 0), seq("A", 0), special("[SEP]", 0)],
            "pair": [special("[CLS]", 0), seq("A", 0), special("[SEP]", 0), seq("B", 1),
                     special("[SEP]", 1)],
            "special_tokens": {t: {"id": t, "ids": [ids[t]], "tokens": [t]}
                               for t in ("[CLS]", "[SEP]")}},
        "decoder": None,
        "model": {"type": "Unigram", "unk_id": ids["<unk>"], "vocab": pieces,
                  "byte_fallback": False},
    }
    (path / "tokenizer.json").write_text(json.dumps(tj, ensure_ascii=False))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "AlbertTokenizer" if family == "albert" else "BigBirdTokenizer"}))


def hf_family(path, family, texts, queries, dev):
    """(e), one family: the model on the card against the same module on
    the CPU over HF_FAMILY_TEXTS texts or pairs (f32 within HF_TOL, the
    bf16 distance from the CPU's f32 recorded), then encode or rerank
    throughput at 64 rows of each of HF_FAMILY_LENGTHS tokens, f32 and
    bf16: the whole call on the host clock and the forward alone in CUDA
    events, after warm-up."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.models.hf_cross_encoder import HFCrossEncoder
    from advanced_rag_tpu_torch.models.hf_embedder import HFEmbedder

    head = HF_FAMILIES[family]["head"]
    cls = HFCrossEncoder if head else HFEmbedder
    docs, qs = texts[:HF_FAMILY_TEXTS], queries[:HF_FAMILY_TEXTS]

    def run(model, d, q):
        return model.score_pairs(q, d) if head else model.encode(d)

    rec = {"source": HF_FAMILIES[family]["source"], "kind": "rerank" if head else "encode"}
    t = time.perf_counter()
    want = run(cls(path, max_len=256, device="cpu"), docs, qs)
    rec["cpu_s"] = time.perf_counter() - t
    rec["scale"] = float(np.abs(want).max())
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        model = cls(path, max_len=256, dtype=dtype, device=dev)
        got = run(model, docs, qs)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"hf {family} {name}: shape {got.shape} or non-finite values")
        rec[f"{name}_max_abs_err"] = float(np.abs(got - want).max())
        if name == "float32" and rec[f"{name}_max_abs_err"] > HF_TOL:
            raise AssertionError(f"hf {family}: the card's f32 differs from the CPU's by "
                                 f"{rec[f'{name}_max_abs_err']} > {HF_TOL}")
        for length in HF_FAMILY_LENGTHS:
            model.max_len = length
            k = length // 64                    # chunks that fill ``length`` tokens
            rows = [" ".join(texts[i:i + k]) for i in range(1, k * HF_BATCH, k)]
            batch = [torch.from_numpy(a).to(dev) for a in (
                model._tokenize(queries[:HF_BATCH], rows, HF_BATCH) if head
                else model._tokenize(rows, HF_BATCH))]
            if not bool(batch[1].all()):
                raise AssertionError(f"hf {family} throughput rows are not {length} tokens")
            if not head:
                batch.append(torch.full_like(batch[0], model.type_id))
            with torch.inference_mode():
                fwd = cuda_ms(lambda: model.model(*batch))
            call = ((lambda: model.score_pairs(queries[:HF_BATCH], rows)) if head
                    else (lambda: model.encode_device(rows)))
            call()
            sync(dev)
            t = time.perf_counter()
            for _ in range(10):
                call()
            sync(dev)
            whole = (time.perf_counter() - t) / 10 * 1e3
            rec[f"{name}_{length}"] = dict(ms=whole, rows_per_s=HF_BATCH / whole * 1e3,
                                           forward_ms=fwd)
        del model
    log(f"hf[{family}]: card vs CPU on {HF_FAMILY_TEXTS} {'pairs' if head else 'texts'} "
        f"f32 {rec['float32_max_abs_err']:.3g}, bf16 {rec['bfloat16_max_abs_err']:.3g} "
        f"(scale {rec['scale']:.3g}); " + "; ".join(
            f"{n} x {L} {rec[f'{n}_{L}']['ms']:.2f} ms ({rec[f'{n}_{L}']['rows_per_s']:.0f}"
            f"/s, forward {rec[f'{n}_{L}']['forward_ms']:.2f})"
            for n in ("float32", "bfloat16") for L in HF_FAMILY_LENGTHS))
    if dev == "cuda":
        torch.cuda.empty_cache()
    return rec


# -- phase 13 (g): the decoder-only embedders (models/hf_llama.py) ----------

#: intfloat/e5-mistral-7b-instruct's config.json: Mistral-7B-v0.1's geometry
HF_DECODER = dict(model_type="mistral", architectures=["MistralModel"], vocab_size=32000,
                  hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
                  num_attention_heads=32, num_key_value_heads=8,
                  max_position_embeddings=32768, rms_norm_eps=1e-5, rope_theta=10000.0,
                  sliding_window=4096, hidden_act="silu", tie_word_embeddings=False,
                  bos_token_id=1, eos_token_id=2, pad_token_id=2)
HF_DECODER_D = HF_DECODER["hidden_size"]
#: google/gemma-2b's config.json (MQA, head_dim 256, a 256,000-piece vocab)
HF_GEMMA = dict(model_type="gemma", architectures=["GemmaForCausalLM"], vocab_size=256000,
                hidden_size=2048, intermediate_size=16384, num_hidden_layers=18,
                num_attention_heads=8, num_key_value_heads=1, head_dim=256,
                max_position_embeddings=8192, rms_norm_eps=1e-6, rope_theta=10000.0,
                hidden_act="gelu", hidden_activation="gelu_pytorch_tanh",
                tie_word_embeddings=True, bos_token_id=2, eos_token_id=1, pad_token_id=0)
HF_DECODER_WRITTEN = 2        # layers of the checkpoints written to disk ((i), (iv))
HF_DECODER_TEXTS = 8          # texts, card vs CPU
HF_DECODER_F32_LAYERS = 4     # (ii): f32 at a cut depth
HF_DECODER_CHUNKS = 1024      # (iii): chunks the 32-layer embedder ingests (2048
#                               until phase 13 (j) came)
HF_DECODER_REQUESTS = 32


def spbpe_tokenizer_files(path, size, family):
    """A SentencePiece BPE tokenizer.json at ``size`` pieces: the
    specials, the 256 byte pieces <0x00>-<0xFF>, "▁" and the letters, then,
    for phase 4's corpus words by frequency, the merges that build "▁word"
    left to right while there is room, filler pieces last; Mistral's
    legacy layout (Prepend + Replace, byte_fallback, fuse_unk) or Gemma's
    (Replace alone), and the class's tokenizer_config.json."""
    import numpy as np

    words, _ = zipf_vocab(np.random.default_rng(11))
    gemma = family == "gemma"
    specials = ["<pad>", "<eos>", "<bos>", "<unk>"] if gemma else ["<unk>", "<s>", "</s>"]
    vocab = {t: i for i, t in enumerate(specials + [f"<0x{b:02X}>" for b in range(256)])}
    for ch in ["▁"] + sorted({c for w in words.tolist() for c in w}):
        vocab.setdefault(ch, len(vocab))
    merges = []
    for w in words.tolist():
        cur = "▁"
        for ch in w:
            if cur + ch not in vocab:
                if len(vocab) == size:
                    break
                vocab[cur + ch] = len(vocab)
                merges.append([cur, ch])
            cur += ch
    while len(vocab) < size:
        vocab[f"<unused{len(vocab)}>"] = len(vocab)
    replace = {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}
    tj = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": vocab[t], "content": t, "single_word": False,
                          "lstrip": False, "rstrip": False, "normalized": False,
                          "special": True} for t in specials],
        "normalizer": replace if gemma else {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"}, replace]},
        "pre_tokenizer": None, "post_processor": None, "decoder": None,
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    (path / "tokenizer.json").write_text(json.dumps(tj, ensure_ascii=False))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "GemmaTokenizer"} if gemma else
        {"tokenizer_class": "LlamaTokenizer", "pad_token": "</s>", "add_bos_token": True,
         "add_eos_token": False}))


def decoder_weights(module, gen, dev=None):
    """Fill ``module``'s parameters from ``gen``: N(0, 0.02), RMSNorm
    scales 1 + N(0, 0.05) (Gemma's, which scale by 1 + w, N(0, 0.05));
    drawn in f32 on the generator's device and cast to each parameter's
    dtype."""
    import torch

    gemma = module.config.model_type == "gemma"
    with torch.no_grad():
        for name, p in module.named_parameters():
            n = torch.randn(p.shape, generator=gen, device=gen.device)
            if name.endswith("norm.weight"):
                n = (0.0 if gemma else 1.0) + 0.05 * n
            else:
                n = 0.02 * n
            p.copy_(n.to(p.device))
    return module


def write_decoder_checkpoint(path, geometry, seed, dev, layers=HF_DECODER_WRITTEN):
    """A decoder checkpoint at ``geometry``'s width and ``layers`` layers:
    config.json, the SentencePiece BPE tokenizer files and a BF16
    model.safetensors (published decoders ship half precision) drawn from a
    seeded torch.Generator on ``dev`` (the card draws them fastest);
    Mistral under MistralModel's names (as e5-mistral-7b-instruct ships),
    Gemma under GemmaForCausalLM's ("model." prefix, as gemma-2b ships)."""
    import torch

    from advanced_rag_tpu_torch.models.hf_checkpoint import read_config
    from advanced_rag_tpu_torch.models.hf_llama import DecoderModel

    path.mkdir(parents=True, exist_ok=True)
    family = geometry["model_type"]
    spbpe_tokenizer_files(path, geometry["vocab_size"], family)
    (path / "config.json").write_text(json.dumps(dict(geometry, num_hidden_layers=layers),
                                                 indent=2))
    with torch.device("meta"):
        module = DecoderModel(read_config(path))
    module = decoder_weights(module.to_empty(device=dev),
                             torch.Generator(device=dev).manual_seed(seed))
    prefix = "model." if family == "gemma" else ""
    write_safetensors(path / "model.safetensors",
                      {prefix + k: v for k, v in module.state_dict().items()}, bf16=True)


def full_depth_decoder(config, dtype, dev, seed, layers):
    """The decoder at ``layers`` layers built on the card, its weights
    drawn there from a seeded generator (no checkpoint of 7B parameters is
    written)."""
    import dataclasses

    import torch

    from advanced_rag_tpu_torch.models.hf_llama import DecoderModel

    with torch.device("meta"):
        module = DecoderModel(dataclasses.replace(config, num_hidden_layers=layers),
                          dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return decoder_weights(module.to_empty(device=dev), gen).eval()


def hf_decoder_parity(path, texts, dev):
    """(i), (iv): HFEmbedder on the card against device="cpu" over
    HF_DECODER_TEXTS texts at 128 tokens: f32 within HF_TOL, the bf16
    distance recorded."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.models.hf_embedder import HFEmbedder

    t = time.perf_counter()
    cpu = HFEmbedder(path, device="cpu")
    want = cpu.encode(texts)
    rec = {"cpu_s": time.perf_counter() - t, "scale": float(np.abs(want).max())}
    del cpu
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        model = HFEmbedder(path, dtype=dtype, device=dev)
        got = model.encode(texts)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"hf decoder {name}: shape {got.shape} or non-finite values")
        rec[f"{name}_max_abs_err"] = float(np.abs(got - want).max())
        norms = np.linalg.norm(got, axis=1)
        if not np.allclose(norms, 1.0, atol=1e-3):
            raise AssertionError(f"hf decoder {name}: embeddings are not unit vectors: {norms}")
        del model
    if rec["float32_max_abs_err"] > HF_TOL:
        raise AssertionError(f"hf decoder {path.name}: the card's f32 differs from the CPU's "
                             f"by {rec['float32_max_abs_err']} > {HF_TOL}")
    return rec


def hf_decoder_throughput(emb, texts, queries, dev):
    """(ii): the embedder at 64 rows x 128 tokens, the model's forward alone
    in CUDA events and the whole encode_device call (tokenization, forward,
    pooling) on the host clock, after warm-up, and one query's whole call
    (the /retrieve path's query encoding)."""
    import torch

    rows = [f"{texts[i]} {texts[i + 1]}" for i in range(1, 2 * HF_BATCH, 2)]
    batch = [torch.from_numpy(a).to(dev) for a in emb._tokenize(rows, HF_BATCH)]
    if not bool(batch[1].all()):
        raise AssertionError("hf decoder throughput rows are not 128 tokens")
    reps = 20 if emb.model.dtype == torch.bfloat16 else 5
    with torch.inference_mode():
        fwd = cuda_ms(lambda: emb.model(*batch), reps=reps, warmup=2)
    rec = {"forward_ms": fwd}
    for key, call, n in (("encode", lambda: emb.encode_device(rows), 5),
                         ("query", lambda: emb.encode_device(queries[:1]), 20)):
        call()
        sync(dev)
        t = time.perf_counter()
        for _ in range(n):
            call()
        sync(dev)
        rec[f"{key}_ms"] = (time.perf_counter() - t) / n * 1e3
    rec["texts_per_s"] = HF_BATCH / rec["encode_ms"] * 1e3
    return rec


def phase_hf_decoders(root, texts, queries, dev):
    """(g): e5-mistral-7b-instruct's geometry (HF_DECODER).  (i) a
    checkpoint of its full width at HF_DECODER_WRITTEN layers (a 32,000-piece
    byte-fallback tokenizer.json) through HFEmbedder, card against CPU;
    (ii) the 32-layer model built on the card (bf16; f32 at
    HF_DECODER_F32_LAYERS layers) timed at HF_BATCH x 128 tokens; (iii)
    that bf16 embedder's manager ingests HF_DECODER_CHUNKS chunks and the
    app with RAG_RERANKER=hf: on (e)'s ELECTRA reranker answers
    HF_DECODER_REQUESTS /retrieve requests from 1 client, K1 at D = 4096
    and K3 launched and held against their plain versions; (iv) gemma-2b's
    width (HF_GEMMA) at HF_DECODER_WRITTEN layers, card against CPU; (v)
    the peak device memory."""
    import torch

    from advanced_rag_tpu_torch.models.hf_embedder import HFEmbedder

    t_phase = time.perf_counter()
    base = memory_mark() if dev == "cuda" else 0
    rec = {"source": "intfloat/e5-mistral-7b-instruct config.json (Mistral-7B-v0.1)"}
    t = time.perf_counter()
    write_decoder_checkpoint(root / "mistral", HF_DECODER, seed=61, dev=dev)
    rec["write_s"] = time.perf_counter() - t
    log(f"hf[mistral]: {HF_DECODER_WRITTEN} layers at e5-mistral-7b-instruct's width "
        f"written in {rec['write_s']:.2f}s "
        f"({(root / 'mistral' / 'model.safetensors').stat().st_size / 1e9:.2f} GB)")
    rec["parity"] = hf_decoder_parity(root / "mistral", texts[1:1 + HF_DECODER_TEXTS], dev)
    log(f"hf[mistral]: card vs CPU on {HF_DECODER_TEXTS} texts at {HF_DECODER_WRITTEN} "
        "layers: " + ", ".join(f"{k} {v:.3g}" for k, v in rec["parity"].items()))
    runs = {}
    for name, dtype, layers in (("float32", torch.float32, HF_DECODER_F32_LAYERS),
                                ("bfloat16", torch.bfloat16, HF_DECODER["num_hidden_layers"])):
        emb = HFEmbedder(root / "mistral", dtype=dtype, device=dev)
        emb.model = full_depth_decoder(emb.model.config, dtype, dev, seed=63, layers=layers)
        runs[name] = dict(layers=layers, **hf_decoder_throughput(emb, texts, queries, dev))
        log(f"hf[mistral][{name}] at {layers} layers: forward {HF_BATCH} x {emb.max_len} "
            f"tokens {runs[name]['forward_ms']:.2f} ms; encode_device "
            f"{runs[name]['encode_ms']:.2f} ms ({runs[name]['texts_per_s']:.0f} texts/s); "
            f"one query {runs[name]['query_ms']:.2f} ms")
        if name == "float32":
            del emb
            if dev == "cuda":
                torch.cuda.empty_cache()
    rec["throughput"] = runs
    svc_queries = queries[HF_BATCH:]
    rec["service"], launches = hf_service(
        root, texts, svc_queries, dev, ce_dir=root / "electra", chunks=HF_DECODER_CHUNKS,
        clients=(1,), requests=HF_DECODER_REQUESTS, warm=False,
        db="service_hf_decoder.db", embedder=emb)
    rec["service"]["embedder_layers"] = HF_DECODER["num_hidden_layers"]
    del emb
    if dev == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    write_decoder_checkpoint(root / "gemma", HF_GEMMA, seed=65, dev=dev)
    rec["gemma"] = {"source": "google/gemma-2b config.json",
                    "write_s": time.perf_counter() - t,
                    **hf_decoder_parity(root / "gemma", texts[1:1 + HF_DECODER_TEXTS], dev)}
    log(f"hf[gemma]: card vs CPU on {HF_DECODER_TEXTS} texts at {HF_DECODER_WRITTEN} layers "
        "of gemma-2b's width: " + ", ".join(f"{k} {v:.3g}" for k, v in rec["gemma"].items()
                                            if k != "source"))
    rec["peak_gb"] = peak_gb_since(base) if dev == "cuda" else None
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"hf: (g) took {rec['seconds']:.2f}s; peak device memory {rec['peak_gb']} GB")
    return rec, launches


# -- phase 13 (h): the second group of encoder families ----------------------

HF_MORE = ("big_bird", "albert", "roformer", "roberta-prelayernorm")
#: (ii): the BigBird embedder's timed batches, rows by tokens a row
HF_BIG_BIRD_ROWS = {1024: 32, 4096: 8}
HF_BIG_BIRD_MAX_LEN = 1024    # (iii): the embedder's max_len in the manager
HF_BIG_BIRD_F32_LAYERS = 4     # (ii)'s f32 forwards (12 until phase 13 (j) came)
HF_MORE_CHUNKS = 2_000        # 5,000 until phase 13 (j) came
HF_MORE_REQUESTS = HF_FAMILY_REQUESTS
#: the card's published bf16 dense peak (H100 SXM, NVIDIA's data sheet)
BF16_PEAK_FLOPS = 989e12
#: (ii)'s profiled forward: device time by kernel group
ENCODER_KERNEL_GROUPS = (
    ("matmul", ("gemm", "cutlass", "xmma", "gemv", "sm90_", "nvjet")),
    ("softmax", ("softmax",)),
    ("cat/gather/copy", ("cat", "index", "gather", "copy")),
    ("reduce", ("reduce",)),
)


def encoder_weights(module, gen):
    """Fill an encoder's parameters from ``gen`` as write_hf_checkpoint
    draws them: N(0, 0.02), LayerNorm scales 1 + N(0, 0.05); drawn in f32
    on the generator's device."""
    import torch

    with torch.no_grad():
        for name, p in module.named_parameters():
            n = torch.randn(p.shape, generator=gen, device=gen.device)
            scale = name.endswith(LN_SCALES)
            p.copy_(((1.0 + 0.05 * n) if scale else 0.02 * n).to(p.device))
    return module


def full_depth_encoder(config, dtype, dev, seed, layers):
    """The trunk of ``config`` at ``layers`` layers built on the card, its
    weights drawn there from a seeded generator."""
    import dataclasses

    import torch

    from advanced_rag_tpu_torch.models.hf_embedder import build_trunk

    with torch.device("meta"):
        module = build_trunk(dataclasses.replace(config, num_hidden_layers=layers), dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return encoder_weights(module.to_empty(device=dev), gen).eval()


def big_bird_flops(config, rows, seq):
    """The multiply-adds (x2) of one block-sparse BigBird forward: the
    dense layers at every token, and each query's products with the keys
    Flax's five parts give it (all keys for blocks 0 and n-1; 4 + r blocks
    for 1 and n-2; 5 + r blocks for the middle ones), Q.K and P.V."""
    h, f, layers = config.hidden_size, config.intermediate_size, config.num_hidden_layers
    b, r = config.block_size, config.num_random_blocks
    nb = seq // b
    keys = b * (2 * seq + 2 * (4 + r) * b + (nb - 4) * (5 + r) * b)
    dense = 2 * seq * (4 * h * h + 2 * h * f)
    attention = 2 * 2 * keys * h
    return rows * layers * (dense + attention)


def hf_more_parity(path, family, texts, queries, dev):
    """(h) (i), (i) (i) and (j) (i), one family: the model on the card against the
    same module on the CPU at its ``max_len`` over HF_FAMILY_TEXTS texts or
    pairs, f32 within HF_TOL, the bf16 distance recorded.  The texts are
    half five chunks long (BigBird's 512 tokens filled: the window and
    random blocks see tokens) and half one chunk (the rest padding)."""
    import numpy as np
    import torch

    from advanced_rag_tpu_torch.models.hf_cross_encoder import HFCrossEncoder
    from advanced_rag_tpu_torch.models.hf_embedder import HFEmbedder

    spec = HF_ENCDEC.get(family) or HF_GPT.get(family) or HF_FAMILIES[family]
    head, max_len = spec.get("head", False), spec["max_len"]
    cls = HFCrossEncoder if head else HFEmbedder
    n = HF_FAMILY_TEXTS
    docs = ([" ".join(texts[i:i + 5]) for i in range(1, 5 * (n // 2), 5)]
            + texts[1:1 + n - n // 2])

    def run(model):
        return model.score_pairs(queries[:n], docs) if head else model.encode(docs)

    rec = {"source": spec["source"], "kind": "rerank" if head else "encode",
           "layers": spec["written"], "max_len": max_len}
    t = time.perf_counter()
    cpu = cls(path, max_len=max_len, device="cpu")
    want = run(cpu)
    rec["cpu_s"] = time.perf_counter() - t
    rec["tokens"] = int(cpu._tokenize(queries[:n], docs, n)[1].sum() if head
                        else cpu._tokenize(docs, n)[1].sum())
    del cpu
    rec["scale"] = float(np.abs(want).max())
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        got = run(cls(path, max_len=max_len, dtype=dtype, device=dev))
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"hf {family} {name}: shape {got.shape} or non-finite values")
        rec[f"{name}_max_abs_err"] = float(np.abs(got - want).max())
    if rec["float32_max_abs_err"] > HF_TOL:
        raise AssertionError(f"hf {family}: the card's f32 differs from the CPU's by "
                             f"{rec['float32_max_abs_err']} > {HF_TOL}")
    log(f"hf[{family}] ({spec['source']}'s width, {spec['written']} layers, max_len "
        f"{max_len}): card vs CPU on {n} {'pairs' if head else 'texts'} ({rec['tokens']} "
        f"tokens) f32 {rec['float32_max_abs_err']:.3g}, bf16 "
        f"{rec['bfloat16_max_abs_err']:.3g} (scale {rec['scale']:.3g})")
    return rec


def big_bird_throughput(emb, texts, dev):
    """(ii): the full-depth embedder at each HF_BIG_BIRD_ROWS length, every
    row filled: the forward alone in CUDA events and the whole
    encode_device call (tokenization, forward, pooling) on the host clock,
    after warm-up; the forward's TFLOP/s and share of the bf16 peak; in
    bf16 one forward under torch.profiler, its device time by
    ENCODER_KERNEL_GROUPS."""
    import torch

    cfg = emb.model.config
    bf16 = emb.model.dtype == torch.bfloat16
    out = {}
    for seq, rows in HF_BIG_BIRD_ROWS.items():
        emb.max_len = seq
        k = seq // 64                        # chunks that fill ``seq`` tokens
        docs = [" ".join(texts[i:i + k]) for i in range(1, k * rows, k)]
        ids, mask = (torch.from_numpy(a).to(dev) for a in emb._tokenize(docs, rows))
        if not bool(mask.all()):
            raise AssertionError(f"hf big_bird rows are not {seq} tokens")
        types = torch.zeros_like(ids)
        with torch.inference_mode():
            fwd = cuda_ms(lambda: emb.model(ids, mask, types), reps=10 if bf16 else 3,
                          warmup=2)
        emb.encode_device(docs)
        sync(dev)
        t = time.perf_counter()
        for _ in range(3):
            emb.encode_device(docs)
        sync(dev)
        whole = (time.perf_counter() - t) / 3 * 1e3
        flops = big_bird_flops(cfg, rows, seq)
        out[seq] = dict(rows=rows, forward_ms=fwd, encode_ms=whole,
                        rows_per_s=rows / whole * 1e3, tflop=flops / 1e12,
                        tflops_per_s=flops / fwd / 1e9,
                        bf16_peak_share=flops / fwd / 1e-3 / BF16_PEAK_FLOPS)
        if bf16 and dev == "cuda":
            with torch.inference_mode():
                prof = profile_call(lambda: emb.model(ids, mask, types),
                                    ENCODER_KERNEL_GROUPS)
            out[seq]["profile"] = prof
            log(f"hf[big_bird][bfloat16] {rows} x {seq} profiled: wall {prof['wall_ms']:.2f} "
                f"ms, device {prof['device_ms']:.2f} ms ({prof['n_kernels']} kernels), "
                f"by group {prof['groups_ms']}")
        log(f"hf[big_bird][{'bfloat16' if bf16 else 'float32'}] {cfg.num_hidden_layers} "
            f"layers: {rows} x {seq} tokens forward {fwd:.2f} ms "
            f"({out[seq]['tflops_per_s']:.1f} TFLOP/s, {out[seq]['bf16_peak_share']:.3f} of "
            f"the bf16 peak); encode_device {whole:.2f} ms ({out[seq]['rows_per_s']:.1f} rows/s)")
    emb.max_len = HF_BIG_BIRD_MAX_LEN
    return out


def phase_hf_more(root, texts, queries, dev):
    """(h): the second group of encoder families at published widths
    (HF_MORE).  (i) each written at its ``written`` layers (bigbird-roberta-
    base: block_sparse, block 64, 3 random blocks; albert-base-v2: all 12
    layers, one shared group; roformer_chinese_base; efficient_mlm_m0.40)
    with its tokenizer made here, on the card against the CPU
    (hf_more_parity); (ii) the 12-layer BigBird embedder built on the card,
    bf16 and f32, timed at HF_BIG_BIRD_ROWS (big_bird_throughput); (iii)
    that bf16 embedder at max_len HF_BIG_BIRD_MAX_LEN behind a bf16-tier
    manager ingesting HF_MORE_CHUNKS chunks, and the app with
    RAG_RERANKER=hf: on the albert-base-v2-width reranker (one label,
    max_len 256) answering HF_MORE_REQUESTS /retrieve requests from 1
    client, every answer a 200 with finite reranked scores, K1 (bf16, D =
    768) and K3 launched and held against their plain versions; (iv) the
    peak device memory."""
    import torch

    from advanced_rag_tpu_torch.models.hf_embedder import HFEmbedder

    t_phase = time.perf_counter()
    base = memory_mark() if dev == "cuda" else 0
    rec = {}
    t = time.perf_counter()
    for i, family in enumerate(HF_MORE):
        write_hf_checkpoint(root / family, head=HF_FAMILIES[family]["head"], seed=71 + 2 * i,
                            family=family, dev=dev)
    rec["write_s"] = time.perf_counter() - t
    log(f"hf: {', '.join(HF_MORE)} checkpoints written in {rec['write_s']:.2f}s (" + ", ".join(
        f"{(root / f / 'model.safetensors').stat().st_size / 1e6:.0f}" for f in HF_MORE)
        + " MB)")
    rec["parity"] = {f: hf_more_parity(root / f, f, texts, queries, dev) for f in HF_MORE}
    layers = HF_FAMILIES["big_bird"]["config"]["num_hidden_layers"]
    runs = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        emb = HFEmbedder(root / "big_bird", max_len=HF_BIG_BIRD_MAX_LEN, dtype=dtype,
                         device=dev)
        emb.model = full_depth_encoder(
            emb.model.config, dtype, dev, seed=79,
            layers=HF_BIG_BIRD_F32_LAYERS if dtype == torch.float32 else layers)
        runs[name] = big_bird_throughput(emb, texts, dev)
        if name == "float32":
            del emb
            if dev == "cuda":
                torch.cuda.empty_cache()
    rec["big_bird_throughput"] = runs
    rec["service"], launches = hf_service(
        root, texts, queries, dev, ce_dir=root / "albert", chunks=HF_MORE_CHUNKS,
        clients=(1,), requests=HF_MORE_REQUESTS, warm=False, db="service_hf_more.db",
        embedder=emb)
    rec["service"].update(embedder_layers=layers, embedder_max_len=HF_BIG_BIRD_MAX_LEN,
                          reranker=HF_FAMILIES["albert"]["source"])
    del emb
    rec["peak_gb"] = peak_gb_since(base) if dev == "cuda" else None
    rec["seconds"] = time.perf_counter() - t_phase
    if dev == "cuda":
        torch.cuda.empty_cache()
    log(f"hf: (h) took {rec['seconds']:.2f}s; peak device memory {rec['peak_gb']} GB")
    return rec, launches


# -- phase 13 (i): the encoder-decoder embedders (models/hf_bart.py) ---------

#: the published geometries (config.json's widths as the sources publish
#: them; the switches transformers' config classes set where the text
#: does not name them), each an embedder at max_len 128, written with its
#: stacks cut to ``written`` layers
HF_ENCDEC = {
    "bart": dict(source="facebook/bart-large", head=False, written=2, max_len=128,
                 config=dict(model_type="bart", architectures=["BartModel"],
                             vocab_size=50265, d_model=1024, encoder_layers=12,
                             decoder_layers=12, encoder_attention_heads=16,
                             decoder_attention_heads=16, encoder_ffn_dim=4096,
                             decoder_ffn_dim=4096, activation_function="gelu",
                             max_position_embeddings=1024, scale_embedding=False,
                             pad_token_id=1, bos_token_id=0, eos_token_id=2,
                             decoder_start_token_id=2)),
    "mbart": dict(source="facebook/mbart-large-cc25", head=False, written=2, max_len=128,
                  config=dict(model_type="mbart", architectures=["MBartForConditionalGeneration"],
                              vocab_size=250027, d_model=1024, encoder_layers=12,
                              decoder_layers=12, encoder_attention_heads=16,
                              decoder_attention_heads=16, encoder_ffn_dim=4096,
                              decoder_ffn_dim=4096, activation_function="gelu",
                              max_position_embeddings=1024, scale_embedding=True,
                              pad_token_id=1, bos_token_id=0, eos_token_id=2)),
    "pegasus": dict(source="google/pegasus-large", head=False, written=2, max_len=128,
                    config=dict(model_type="pegasus",
                                architectures=["PegasusForConditionalGeneration"],
                                vocab_size=96103, d_model=1024, encoder_layers=16,
                                decoder_layers=16, encoder_attention_heads=16,
                                decoder_attention_heads=16, encoder_ffn_dim=4096,
                                decoder_ffn_dim=4096, activation_function="relu",
                                max_position_embeddings=1024, scale_embedding=True,
                                pad_token_id=0, eos_token_id=1, decoder_start_token_id=0)),
    "marian": dict(source="Helsinki-NLP/opus-mt-en-de", head=False, written=6, max_len=128,
                   config=dict(model_type="marian", architectures=["MarianMTModel"],
                               vocab_size=58101, d_model=512, encoder_layers=6,
                               decoder_layers=6, encoder_attention_heads=8,
                               decoder_attention_heads=8, encoder_ffn_dim=2048,
                               decoder_ffn_dim=2048, activation_function="swish",
                               max_position_embeddings=512, scale_embedding=True,
                               pad_token_id=58100, eos_token_id=0,
                               decoder_start_token_id=58100)),
    "blenderbot": dict(source="facebook/blenderbot-400M-distill", head=False, written=2,
                       max_len=128,
                       config=dict(model_type="blenderbot",
                                   architectures=["BlenderbotForConditionalGeneration"],
                                   vocab_size=8008, d_model=1280, encoder_layers=2,
                                   decoder_layers=12, encoder_attention_heads=32,
                                   decoder_attention_heads=32, encoder_ffn_dim=5120,
                                   decoder_ffn_dim=5120, activation_function="gelu",
                                   max_position_embeddings=128, scale_embedding=True,
                                   pad_token_id=0, bos_token_id=1, eos_token_id=2,
                                   decoder_start_token_id=1)),
    "blenderbot-small": dict(source="facebook/blenderbot_small-90M", head=False, written=8,
                             max_len=128,
                             config=dict(model_type="blenderbot-small",
                                         architectures=["BlenderbotSmallForConditionalGeneration"],
                                         vocab_size=54944, d_model=512, encoder_layers=8,
                                         decoder_layers=8, encoder_attention_heads=16,
                                         decoder_attention_heads=16, encoder_ffn_dim=2048,
                                         decoder_ffn_dim=2048, activation_function="gelu",
                                         max_position_embeddings=512, scale_embedding=False,
                                         pad_token_id=0, bos_token_id=1, eos_token_id=2,
                                         decoder_start_token_id=1)),
}
HF_ENCDEC_ROWS, HF_ENCDEC_TOKENS = 64, 128    # (i) (ii)'s and (j) (ii)'s timed batch
#: (ii)'s f32 forwards: layers in each stack (the published depth until
#: phase 13 (j) came; cut to keep the script within its 1200-second limit)
HF_ENCDEC_F32_LAYERS = 2
HF_ENCDEC_CHUNKS = HF_FAMILY_CHUNKS           # (iii): chunks the bart-large manager ingests
HF_ENCDEC_REQUESTS = HF_FAMILY_REQUESTS


def encdec_tokenizer_files(path, family, size):
    """The family's tokenizer at ``size`` entries, as its class reads it:
    BART's and Blenderbot's byte-level BPE (roberta_tokenizer_files under
    their class names; Blenderbot's class adds A </s>), mBART's Unigram
    tokenizer.json (mbart_tokenizer_files), Pegasus's
    (pegasus_tokenizer_files), BlenderbotSmall's vocab.json + merges.txt
    (small_tokenizer_files), and for Marian, whose own tokenizer needs
    sentencepiece, phase 13's WordPiece vocab.txt named BertTokenizer."""
    if family in ("bart", "blenderbot"):
        roberta_tokenizer_files(path, size)
        (path / "tokenizer_config.json").write_text(json.dumps(
            {"tokenizer_class": "BartTokenizer" if family == "bart" else "BlenderbotTokenizer",
             "add_prefix_space": False}))
    elif family == "mbart":
        mbart_tokenizer_files(path, size)
    elif family == "pegasus":
        pegasus_tokenizer_files(path, size)
    elif family == "blenderbot-small":
        small_tokenizer_files(path, size)
    else:
        (path / "vocab.txt").write_text("\n".join(hf_vocab(size)) + "\n")
        (path / "tokenizer_config.json").write_text(json.dumps(
            {"do_lower_case": True, "tokenizer_class": "BertTokenizer"}))


def _special_added(i, tok, lstrip=False):
    return {"id": i, "content": tok, "single_word": False, "lstrip": lstrip,
            "rstrip": False, "normalized": False, "special": True}


def mbart_tokenizer_files(path, size):
    """mBART's tokenizer.json at ``size`` pieces: XLM-R's layout
    (xlmr_tokenizer_files) with the 25 language codes between the pieces
    and <mask>, as MBartConverter writes it; MBartTokenizerFast replaces the
    template with A </s> en_XX."""
    from advanced_rag_tpu_torch.models.hf_tokenizer import MBART_LANGUAGE_CODES

    codes = list(MBART_LANGUAGE_CODES)
    xlmr_tokenizer_files(path, size - len(codes))
    tj = json.loads((path / "tokenizer.json").read_text())
    pieces = tj["model"]["vocab"]
    mask = pieces.pop()
    pieces += [[c, 0.0] for c in codes] + [mask]
    tj["added_tokens"] = ([t for t in tj["added_tokens"] if t["content"] != "<mask>"]
                          + [_special_added(size - 1 - len(codes) + i, c)
                             for i, c in enumerate(codes)]
                          + [_special_added(size - 1, "<mask>", lstrip=True)])
    (path / "tokenizer.json").write_text(json.dumps(tj, ensure_ascii=False))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "MBartTokenizer", "src_lang": "en_XX"}))


def pegasus_tokenizer_files(path, size):
    """Pegasus's tokenizer.json at ``size`` pieces, as PegasusConverter
    lays it out: <pad>, </s>, <mask_1>, <mask_2>, <unk_2> ... <unk_102>,
    <unk>, then XLM-R's pieces here (xlmr_tokenizer_files); the charsmap,
    Strip right, " {2,}" to "▁"; WhitespaceSplit then Metaspace; A </s>."""
    head = ["<pad>", "</s>", "<mask_1>", "<mask_2>"] + [f"<unk_{i}>" for i in range(2, 103)]
    xlmr_tokenizer_files(path, size - len(head) + 4)
    tj = json.loads((path / "tokenizer.json").read_text())
    body = tj["model"]["vocab"][4:-1]          # without <s>, <pad>, </s>, <unk>, <mask>
    pieces = ([[t, 0.0 if i < 4 else -100.0] for i, t in enumerate(head)]
              + [["<unk>", 0.0]] + body)
    assert len(pieces) == size, len(pieces)
    charsmap = tj["normalizer"]["normalizers"][0]
    tj.update({
        "added_tokens": [_special_added(i, t) for i, t in enumerate(head + ["<unk>"])],
        "normalizer": {"type": "Sequence", "normalizers": [
            charsmap, {"type": "Strip", "strip_left": False, "strip_right": True},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "▁"}]},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "WhitespaceSplit"},
            {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
             "split": True}]},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [1], "tokens": ["</s>"]}}},
        "model": {"type": "Unigram", "unk_id": len(head), "vocab": pieces,
                  "byte_fallback": False}})
    (path / "tokenizer.json").write_text(json.dumps(tj, ensure_ascii=False))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PegasusTokenizer"}))


def small_tokenizer_files(path, size):
    """BlenderbotSmall's vocab.json + merges.txt at ``size`` entries: the
    specials and __newln__, each letter alone and with @@, then for phase
    4's corpus words by frequency the merges that build "word</w>" left to
    right (each merge once), every result in the vocabulary (as "x@@", or
    the word itself for the last), while there is room; filler last.  No
    tokenizer_config.json: config.json's model_type takes the slow class."""
    import numpy as np

    words, _ = zipf_vocab(np.random.default_rng(11))
    vocab = {t: i for i, t in enumerate(
        ["__null__", "__start__", "__end__", "__unk__", "__newln__"])}
    for ch in sorted({ch for w in words.tolist() for ch in w}):
        vocab.setdefault(ch, len(vocab))
        vocab.setdefault(ch + "@@", len(vocab))
    merges, seen = [], set()
    for w in words.tolist():
        if len(vocab) + len(w) > size:
            break
        cur = w[0]
        for i, ch in enumerate(w[1:], 1):
            last = i == len(w) - 1
            nxt = ch + "</w>" if last else ch
            if (cur, nxt) not in seen:
                seen.add((cur, nxt))
                merges.append(f"{cur} {nxt}")
            cur += nxt
            vocab.setdefault(cur[:-4] if last else cur + "@@", len(vocab))
    while len(vocab) < size:
        vocab[f"__unused{len(vocab)}__"] = len(vocab)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")


def encdec_flops(config, rows, seq):
    """The multiply-adds (x2) of one encoder-decoder forward of ``rows`` x
    ``seq`` tokens: per encoder token Q/K/V/O and the FFN, per decoder
    token self-attention's four projections, cross-attention's Q/O (its
    K/V over the encoder's tokens) and the FFN, and the attention products
    Q.K and P.V over all ``seq`` keys (self, and the decoder's cross)."""
    d, dec = config.hidden_size, config.decoder_layers
    enc = config.num_hidden_layers * (2 * seq * (4 * d * d + 2 * d * config.intermediate_size)
                                      + 2 * 2 * seq * seq * d)
    dec = dec * (2 * seq * (8 * d * d + 2 * d * config.decoder_ffn_dim)
                 + 2 * 2 * 2 * seq * seq * d)
    return rows * (enc + dec)


def full_depth_encdec(config, family, dtype, dev, seed, layers=None):
    """The trunk of ``config`` at the published depth of ``family`` (or
    ``layers`` in each stack) built on the card, its weights drawn there
    from a seeded generator."""
    import dataclasses

    import torch

    from advanced_rag_tpu_torch.models.hf_embedder import build_trunk

    published = HF_ENCDEC[family]["config"]
    with torch.device("meta"):
        module = build_trunk(dataclasses.replace(
            config, num_hidden_layers=layers or published["encoder_layers"],
            decoder_layers=layers or published["decoder_layers"]), dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return encoder_weights(module.to_empty(device=dev), gen).eval()


def forward_throughput(emb, family, texts, dev, flops_of, layers, queries=None):
    """(i) (ii) and (j) (ii), one family and dtype: the trunk (emb.model) at
    HF_ENCDEC_ROWS x HF_ENCDEC_TOKENS tokens, every row filled: the forward
    alone in CUDA events and the whole encode_device call on the host
    clock, after warm-up, and with ``queries`` one query's encode_device;
    the forward's TFLOP/s (``flops_of(config, rows, seq)``) and share of
    the bf16 peak.  ``layers``: the trunk's depth as recorded (a stack's
    or [encoder, decoder])."""
    import torch

    cfg = emb.model.config
    rows, seq = HF_ENCDEC_ROWS, HF_ENCDEC_TOKENS
    k = seq // 64                            # chunks that fill ``seq`` tokens
    docs = [" ".join(texts[i:i + k]) for i in range(1, k * rows, k)]
    ids, mask = (torch.from_numpy(a).to(dev) for a in emb._tokenize(docs, rows))
    if not bool(mask.all()):
        raise AssertionError(f"hf {family} rows are not {seq} tokens")
    with torch.inference_mode():
        fwd = cuda_ms(lambda: emb.model(ids, mask), reps=10, warmup=2)
    out = {}
    for key, batch, n in [("encode", docs, 5)] + ([("query", queries[:1], 20)]
                                                   if queries else []):
        emb.encode_device(batch)
        sync(dev)
        t = time.perf_counter()
        for _ in range(n):
            emb.encode_device(batch)
        sync(dev)
        out[f"{key}_ms"] = (time.perf_counter() - t) / n * 1e3
    flops = flops_of(cfg, rows, seq)
    out.update(layers=layers, forward_ms=fwd, rows_per_s=rows / out["encode_ms"] * 1e3,
               tflop=flops / 1e12, tflops_per_s=flops / fwd / 1e9,
               bf16_peak_share=flops / fwd / 1e-3 / BF16_PEAK_FLOPS)
    depth = " + ".join(map(str, layers)) if isinstance(layers, list) else layers
    log(f"hf[{family}][{str(emb.model.dtype).removeprefix('torch.')}] {depth} layers: "
        f"{rows} x {seq} tokens forward {fwd:.2f} ms ({out['tflops_per_s']:.1f} TFLOP/s, "
        f"{out['bf16_peak_share']:.3f} of the bf16 peak); encode_device "
        f"{out['encode_ms']:.2f} ms ({out['rows_per_s']:.1f} rows/s)"
        + (f"; one query {out['query_ms']:.2f} ms" if "query_ms" in out else ""))
    return out


def phase_hf_encdec(root, texts, queries, dev):
    """(i): the encoder-decoder embedders at published widths (HF_ENCDEC).
    (i) each written at its ``written`` layers with its tokenizer made here
    (encdec_tokenizer_files), on the card against the CPU (hf_more_parity);
    (ii) each built on the card at its published depth in bf16 (f32 at
    HF_ENCDEC_F32_LAYERS + HF_ENCDEC_F32_LAYERS layers), timed at
    HF_ENCDEC_ROWS x HF_ENCDEC_TOKENS (forward_throughput); (iii) a
    bart-large embedder built on the card (12 + 12 layers) in bf16 behind a
    bf16-tier manager (D = 1024) ingesting HF_ENCDEC_CHUNKS chunks, and the
    app with RAG_RERANKER=hf: on (e)'s ELECTRA reranker answering
    HF_ENCDEC_REQUESTS /retrieve requests from 1 client, every answer a 200
    with finite reranked scores, K1 (bf16, D = 1024) and K3 launched and
    held against their plain versions; (iv) the peak device memory."""
    import torch

    from advanced_rag_tpu_torch.models.hf_embedder import HFEmbedder

    t_phase = time.perf_counter()
    base = memory_mark() if dev == "cuda" else 0
    rec = {}
    t = time.perf_counter()
    for i, family in enumerate(HF_ENCDEC):
        write_hf_checkpoint(root / family, head=False, seed=91 + 2 * i, family=family,
                            dev=dev)
    rec["write_s"] = time.perf_counter() - t
    log(f"hf: {', '.join(HF_ENCDEC)} checkpoints written in {rec['write_s']:.2f}s (" + ", ".join(
        f"{(root / f / 'model.safetensors').stat().st_size / 1e6:.0f}" for f in HF_ENCDEC)
        + " MB)")
    rec["parity"] = {f: hf_more_parity(root / f, f, texts, queries, dev) for f in HF_ENCDEC}
    runs = {}
    for i, family in enumerate(HF_ENCDEC):
        runs[family] = {}
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            emb = HFEmbedder(root / family, max_len=HF_ENCDEC_TOKENS, dtype=dtype, device=dev)
            emb.model = full_depth_encdec(
                emb.model.config, family, dtype, dev, seed=97 + i,
                layers=HF_ENCDEC_F32_LAYERS if dtype == torch.float32 else None)
            cfg = emb.model.config
            runs[family][name] = forward_throughput(
                emb, family, texts, dev, encdec_flops,
                [cfg.num_hidden_layers, cfg.decoder_layers])
            del emb
            if dev == "cuda":
                torch.cuda.empty_cache()
    rec["throughput"] = runs
    emb = HFEmbedder(root / "bart", dtype=torch.bfloat16, device=dev)
    emb.model = full_depth_encdec(emb.model.config, "bart", torch.bfloat16, dev, seed=103)
    rec["service"], launches = hf_service(
        root, texts, queries, dev, ce_dir=root / "electra", chunks=HF_ENCDEC_CHUNKS,
        clients=(1,), requests=HF_ENCDEC_REQUESTS, warm=False, db="service_hf_encdec.db",
        embedder=emb)
    rec["service"].update(embedder=HF_ENCDEC["bart"]["source"],
                          embedder_layers=[emb.model.config.num_hidden_layers,
                                           emb.model.config.decoder_layers],
                          reranker=HF_FAMILIES["electra"]["source"])
    del emb
    rec["peak_gb"] = peak_gb_since(base) if dev == "cuda" else None
    rec["seconds"] = time.perf_counter() - t_phase
    if dev == "cuda":
        torch.cuda.empty_cache()
    log(f"hf: (i) took {rec['seconds']:.2f}s; peak device memory {rec['peak_gb']} GB")
    return rec, launches


# -- phase 13 (j): the GPT-family embedders (models/hf_gpt2.py, hf_bloom.py,
#    hf_xglm.py) --------------------------------------------------------------

#: the published geometries (config.json's numbers as the sources publish
#: them; the defaults of transformers' config classes where the text does
#: not name a field), each an embedder written with ``written`` layers and
#: held card against CPU at ``max_len``; GPT-SW3's file names model_type
#: gpt2, written here as gpt-sw3 (the AutoConfig key for its class)
HF_GPT = {
    "gpt2": dict(source="openai-community/gpt2", written=2, max_len=128,
                 config=dict(model_type="gpt2", architectures=["GPT2LMHeadModel"],
                             vocab_size=50257, n_positions=1024, n_ctx=1024, n_embd=768,
                             n_layer=12, n_head=12, activation_function="gelu_new",
                             layer_norm_epsilon=1e-05, bos_token_id=50256,
                             eos_token_id=50256)),
    "gpt-sw3": dict(source="AI-Sweden-Models/gpt-sw3-126m", written=2, max_len=128,
                    config=dict(model_type="gpt-sw3", architectures=["GPT2LMHeadModel"],
                                vocab_size=64000, n_positions=2048, n_embd=768, n_layer=12,
                                n_head=12, n_inner=3072, activation_function="gelu",
                                layer_norm_epsilon=1e-05, bos_token_id=2, eos_token_id=3,
                                pad_token_id=0)),
    "gpt_neo": dict(source="EleutherAI/gpt-neo-125m", written=2, max_len=512,
                    config=dict(model_type="gpt_neo", architectures=["GPTNeoForCausalLM"],
                                vocab_size=50257, max_position_embeddings=2048,
                                hidden_size=768, num_layers=12, num_heads=12,
                                attention_types=[[["global", "local"], 6]], window_size=256,
                                activation_function="gelu_new", layer_norm_epsilon=1e-05,
                                bos_token_id=50256, eos_token_id=50256)),
    "gptj": dict(source="EleutherAI/gpt-j-6b", written=2, max_len=128,
                 config=dict(model_type="gptj", architectures=["GPTJForCausalLM"],
                             vocab_size=50400, n_positions=2048, n_embd=4096, n_layer=28,
                             n_head=16, rotary_dim=64, activation_function="gelu_new",
                             layer_norm_epsilon=1e-05, bos_token_id=50256,
                             eos_token_id=50256, tie_word_embeddings=False)),
    "bloom": dict(source="bigscience/bloom-560m", written=2, max_len=128,
                  config=dict(model_type="bloom", architectures=["BloomForCausalLM"],
                              vocab_size=250880, hidden_size=1024, n_layer=24, n_head=16,
                              layer_norm_epsilon=1e-05,
                              apply_residual_connection_post_layernorm=False,
                              slow_but_exact=False, pretraining_tp=1, bos_token_id=1,
                              eos_token_id=2, pad_token_id=3)),
    "xglm": dict(source="facebook/xglm-564M", written=2, max_len=128,
                 config=dict(model_type="xglm", architectures=["XGLMForCausalLM"],
                             vocab_size=256008, max_position_embeddings=2048, d_model=1024,
                             ffn_dim=4096, num_layers=24, attention_heads=16,
                             activation_function="gelu", scale_embedding=True,
                             bos_token_id=0, eos_token_id=2, pad_token_id=1,
                             decoder_start_token_id=2)),
}
HF_GPT_SERVED = "gpt_neo"                     # (iii): gpt-neo-125m, SGPT-125M's base
HF_GPT_CHUNKS = HF_FAMILY_CHUNKS
HF_GPT_REQUESTS = HF_FAMILY_REQUESTS
EOT = "<|endoftext|>"


def gpt_layers(family, n):
    """``HF_GPT[family]["config"]``'s fields that set ``n`` layers (GPT-Neo's
    attention_types alternating global and local)."""
    if family == "gpt_neo":
        return dict(num_layers=n, attention_types=[[["global", "local"], n // 2]])
    return {"xglm": dict(num_layers=n)}.get(family, dict(n_layer=n))


def gpt_tokenizer_files(path, family, size):
    """The family's tokenizer at ``size`` entries, as its class reads it:
    GPT-2's vocab.json + merges.txt (``<|endoftext|>`` last, named the pad
    token, as GPT-2 embedders are deployed; GPT-Neo, GPT-J and GPT-SW3,
    whose own tokenizer needs sentencepiece, name GPT2Tokenizer); BLOOM's
    tokenizer.json (``<unk> <s> </s> <pad>`` at 0-3, its Split and
    ByteLevel pre-tokenizer, padding left as bloom-560m's config says);
    XGLM's Unigram tokenizer.json (xlmr_tokenizer_files' pieces with
    fairseq's four in front, seven <madeupword>s last, SpmConverter's
    normalizer, ``</s> A``)."""
    from advanced_rag_tpu_torch.models.hf_bpe import BLOOM_SPLIT

    if family == "bloom":
        specials = ["<unk>", "<s>", "</s>", "<pad>"]
        vocab, merges = byte_bpe_vocab(size, specials, "<unused_last>")
        tj = {"version": "1.0", "truncation": None, "padding": None,
              "added_tokens": [_special_added(i, t) for i, t in enumerate(specials)],
              "normalizer": None,
              "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                  {"type": "Split", "pattern": {"Regex": BLOOM_SPLIT},
                   "behavior": "Isolated", "invert": False},
                  {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                   "use_regex": False}]},
              "post_processor": {"type": "ByteLevel", "add_prefix_space": True,
                                 "trim_offsets": False, "use_regex": True},
              "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                          "trim_offsets": True, "use_regex": True},
              "model": {"type": "BPE", "dropout": None, "unk_token": None,
                        "continuing_subword_prefix": None, "end_of_word_suffix": None,
                        "fuse_unk": False, "byte_fallback": False, "vocab": vocab,
                        "merges": merges}}
        (path / "tokenizer.json").write_text(json.dumps(tj, ensure_ascii=False))
        (path / "tokenizer_config.json").write_text(json.dumps(
            {"tokenizer_class": "BloomTokenizerFast", "padding_side": "left",
             "pad_token": "<pad>", "unk_token": "<unk>", "bos_token": "<s>",
             "eos_token": "</s>"}))
    elif family == "xglm":
        madeup = [f"<madeupword{i}>" for i in range(7)]
        xlmr_tokenizer_files(path, size - len(madeup) + 1)
        tj = json.loads((path / "tokenizer.json").read_text())
        pieces = tj["model"]["vocab"][:-1] + [[w, 0.0] for w in madeup]   # <mask> out
        charsmap = tj["normalizer"]["normalizers"][0]

        def special(tok):
            return {"SpecialToken": {"id": tok, "type_id": 0}}

        seq = [{"Sequence": {"id": "A", "type_id": 0}}, {"Sequence": {"id": "B", "type_id": 0}}]
        tj.update({
            "added_tokens": ([_special_added(i, t) for i, t in
                              enumerate(["<s>", "<pad>", "</s>", "<unk>"])]
                             + [_special_added(size - len(madeup) + i, w)
                                for i, w in enumerate(madeup)]),
            "normalizer": {"type": "Sequence", "normalizers": [
                charsmap, {"type": "Strip", "strip_left": False, "strip_right": True},
                {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "▁"}]},
            "post_processor": {
                "type": "TemplateProcessing", "single": [special("</s>"), seq[0]],
                "pair": [special("</s>"), seq[0], special("</s>"), special("</s>"), seq[1]],
                "special_tokens": {t: {"id": t, "ids": [i], "tokens": [t]}
                                   for t, i in (("<s>", 0), ("</s>", 2))}},
            "model": {"type": "Unigram", "unk_id": 3, "vocab": pieces, "byte_fallback": False}})
        assert len(pieces) == size, len(pieces)
        (path / "tokenizer.json").write_text(json.dumps(tj, ensure_ascii=False))
        (path / "tokenizer_config.json").write_text(json.dumps(
            {"tokenizer_class": "XGLMTokenizer"}))
    else:
        bpe_files(path, *byte_bpe_vocab(size, [], EOT),
                  {"tokenizer_class": "GPT2Tokenizer", "add_prefix_space": False,
                   "pad_token": EOT, "bos_token": EOT, "eos_token": EOT, "unk_token": EOT})


def write_gpt_checkpoint(path, family, seed, dev):
    """A checkpoint of ``family`` at its HF_GPT width and ``written``
    layers: config.json, the tokenizer (gpt_tokenizer_files) and a BF16
    model.safetensors (the published ones ship half precision or are
    read so) drawn from a seeded generator on ``dev`` (N(0, 0.02);
    LayerNorm scales 1 + N(0, 0.05)) under the family's names with a head's
    prefix (``transformer.``; XGLM's ``model.``), as the LM checkpoints
    ship."""
    import torch

    from advanced_rag_tpu_torch.models.hf_checkpoint import read_config
    from advanced_rag_tpu_torch.models.hf_embedder import build_trunk

    spec = HF_GPT[family]
    path.mkdir(parents=True, exist_ok=True)
    cfg = dict(spec["config"], **gpt_layers(family, spec["written"]))
    gpt_tokenizer_files(path, family, cfg["vocab_size"])
    (path / "config.json").write_text(json.dumps(cfg, indent=2))
    with torch.device("meta"):
        module = build_trunk(read_config(path), torch.float32)
    module = encoder_weights(module.to_empty(device=dev),
                             torch.Generator(device=dev).manual_seed(seed))
    prefix = "model." if family == "xglm" else "transformer."
    write_safetensors(path / "model.safetensors",
                      {prefix + k: v for k, v in module.state_dict().items()}, bf16=True)


def full_depth_gpt(config, family, dtype, dev, seed):
    """The trunk of ``config`` at the published depth of ``family`` built on
    the card (full_depth_encoder; GPT-Neo's layers alternating global and
    local)."""
    import dataclasses

    published = HF_GPT[family]["config"]
    layers = published.get("n_layer") or published["num_layers"]
    kinds = ("global", "local") * (layers // 2) if family == "gpt_neo" else ()
    return full_depth_encoder(dataclasses.replace(config, attention_layers=kinds), dtype,
                              dev, seed, layers)


def gpt_flops(config, rows, seq):
    """The multiply-adds (x2) of one GPT-family forward of ``rows`` x
    ``seq`` tokens: per token Q/K/V/O and the MLP, and Q.K and P.V over
    all ``seq`` keys (the causal mask and GPT-Neo's window are not
    subtracted)."""
    d, f = config.hidden_size, config.intermediate_size
    return rows * config.num_hidden_layers * (2 * seq * (4 * d * d + 2 * d * f)
                                              + 2 * 2 * seq * seq * d)


def phase_hf_gpt(root, texts, queries, dev):
    """(j): the GPT-family embedders at published widths (HF_GPT).  (i)
    each written at 2 layers (GPT-Neo one global and one local) with its
    tokenizer made here (gpt_tokenizer_files), on the card against the CPU
    (hf_more_parity; GPT-Neo at max_len 512 on texts past its window of
    256 tokens); (ii) each built on the card at its published depth, f32
    (not GPT-J's 28 layers) and bf16, timed at HF_ENCDEC_ROWS x
    HF_ENCDEC_TOKENS (forward_throughput), and one GPT-J query's encode;
    (iii) the 12-layer bf16 gpt-neo-125m embedder behind a bf16-tier
    manager (D = 768) ingesting HF_GPT_CHUNKS chunks, and the app with
    RAG_RERANKER=hf: on (e)'s ELECTRA reranker answering HF_GPT_REQUESTS
    /retrieve requests from 1 client, every answer a 200 with finite
    reranked scores, K1 (bf16, D = 768) and K3 launched and held against
    their plain versions; (iv) the peak device memory."""
    import torch

    from advanced_rag_tpu_torch.models.hf_embedder import HFEmbedder
    from advanced_rag_tpu_torch.models.hf_tokenizer import load_tokenizer

    t_phase = time.perf_counter()
    base = memory_mark() if dev == "cuda" else 0
    rec = {}
    t = time.perf_counter()
    for i, family in enumerate(HF_GPT):
        write_gpt_checkpoint(root / family, family, seed=101 + 2 * i, dev=dev)
    rec["write_s"] = time.perf_counter() - t
    log(f"hf: {', '.join(HF_GPT)} checkpoints written in {rec['write_s']:.2f}s (" + ", ".join(
        f"{(root / f / 'model.safetensors').stat().st_size / 1e6:.0f}" for f in HF_GPT)
        + " MB)")
    neo = HF_GPT["gpt_neo"]
    window = neo["config"]["window_size"]
    longest = int(load_tokenizer(root / "gpt_neo")(
        [" ".join(texts[1:6])], max_length=neo["max_len"])["attention_mask"].sum())
    if longest <= window:
        raise AssertionError(f"hf gpt_neo: the long texts ({longest} tokens) do not pass "
                             f"the local window of {window}")
    rec["parity"] = {f: hf_more_parity(root / f, f, texts, queries, dev) for f in HF_GPT}
    rec["parity"]["gpt_neo"]["longest_tokens"] = longest
    runs = {}
    for i, family in enumerate(HF_GPT):
        runs[family] = {}
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            if name == "float32" and family == "gptj":
                continue                     # 28 layers of 4096: bf16 only
            emb = HFEmbedder(root / family, max_len=HF_ENCDEC_TOKENS, dtype=dtype,
                             device=dev)
            emb.model = full_depth_gpt(emb.model.config, family, dtype, dev, seed=107 + i)
            runs[family][name] = forward_throughput(
                emb, family, texts, dev, gpt_flops, emb.model.config.num_hidden_layers,
                queries if family == "gptj" else None)
            del emb
            if dev == "cuda":
                torch.cuda.empty_cache()
    rec["throughput"] = runs
    emb = HFEmbedder(root / HF_GPT_SERVED, dtype=torch.bfloat16, device=dev)
    emb.model = full_depth_gpt(emb.model.config, HF_GPT_SERVED, torch.bfloat16, dev,
                               seed=113)
    rec["service"], launches = hf_service(
        root, texts, queries, dev, ce_dir=root / "electra", chunks=HF_GPT_CHUNKS,
        clients=(1,), requests=HF_GPT_REQUESTS, warm=False, db="service_hf_gpt.db",
        embedder=emb)
    rec["service"].update(embedder=HF_GPT[HF_GPT_SERVED]["source"],
                          embedder_layers=emb.model.config.num_hidden_layers,
                          reranker=HF_FAMILIES["electra"]["source"])
    del emb
    rec["peak_gb"] = peak_gb_since(base) if dev == "cuda" else None
    rec["seconds"] = time.perf_counter() - t_phase
    if dev == "cuda":
        torch.cuda.empty_cache()
    log(f"hf: (j) took {rec['seconds']:.2f}s; peak device memory {rec['peak_gb']} GB")
    return rec, launches


def phase_hf(texts, dev="cuda"):
    """Phase 13: the HF checkpoint models on the card.  At MiniLM-L6's
    width: (a) an embedder (BertModel) and a reranker
    (BertForSequenceClassification, one label) written in HF format from
    seeded generators; (b) each on the card against the CPU; (d) encode
    and rerank throughput; (c) ingest and /retrieve through the port's app
    with RAG_RERANKER=hf:.  The other families at their published
    geometries (HF_FAMILIES): (e) each written, on the card against the
    CPU and timed; (f) a RoBERTa embedder's bf16-tier manager ingests
    HF_FAMILY_CHUNKS chunks and the app with RAG_RERANKER=hf: on the
    ELECTRA reranker answers HF_FAMILY_REQUESTS /retrieve requests from
    one client; (g) the decoder embedders (phase_hf_decoders); (h) the
    second group of encoder families (phase_hf_more); (i) the
    encoder-decoder embedders (phase_hf_encdec); (j) the GPT-family
    embedders (phase_hf_gpt).  Returns the record and the launches of (c),
    (f), (g), (h), (i) and (j)."""
    import numpy as np

    t_phase = time.perf_counter()
    base = memory_mark() if dev == "cuda" else 0
    rec = {}
    root = Path(tempfile.mkdtemp(prefix="hf-", dir=BUILD_DIR))
    try:
        t = time.perf_counter()
        write_hf_checkpoint(root / "emb", head=False, seed=41)
        write_hf_checkpoint(root / "ce", head=True, seed=43)
        rec["write_s"] = time.perf_counter() - t
        log(f"hf: two MiniLM-L6 checkpoints written in {rec['write_s']:.2f}s "
            f"({(root / 'emb' / 'model.safetensors').stat().st_size / 1e6:.1f} + "
            f"{(root / 'ce' / 'model.safetensors').stat().st_size / 1e6:.1f} MB)")
        rng = np.random.default_rng(47)
        docs = [texts[i] for i in rng.choice(HF_CHUNKS, HF_PARITY_TEXTS, replace=False)]
        queries = snippet_queries(rng, texts[:HF_CHUNKS], HF_PARITY_TEXTS + 8
                                  + (len(HF_CLIENTS) + 1) * HF_REQUESTS + 32)
        rec["parity"] = hf_parity(root, docs, queries[:HF_PARITY_TEXTS], dev)
        rec["throughput"] = hf_throughput(root, texts, queries, dev)
        rec["service"], launches = hf_service(root, texts, queries[HF_PARITY_TEXTS:], dev)
        t = time.perf_counter()
        for i, family in enumerate(E_FAMILIES):
            write_hf_checkpoint(root / family, head=HF_FAMILIES[family]["head"],
                                seed=51 + 2 * i, family=family, dev=dev)
        fam = {"write_s": time.perf_counter() - t}
        log(f"hf: {', '.join(E_FAMILIES)} checkpoints written in {fam['write_s']:.2f}s (" + ", ".join(
            f"{(root / f / 'model.safetensors').stat().st_size / 1e6:.0f}" for f in E_FAMILIES)
            + " MB)")
        fam_queries = snippet_queries(rng, texts[:HF_FAMILY_CHUNKS], HF_BATCH + 8
                                      + HF_FAMILY_REQUESTS + 32)
        for family in E_FAMILIES:
            fam[family] = hf_family(root / family, family, texts, fam_queries, dev)
        fam["service"], fam_launches = hf_service(
            root, texts, fam_queries[HF_BATCH:], dev, emb_dir=root / "roberta",
            ce_dir=root / "electra", chunks=HF_FAMILY_CHUNKS, clients=(1,),
            requests=HF_FAMILY_REQUESTS, warm=False, db="service_hf_families.db")
        rec["families"] = fam
        launches = {k: v + fam_launches[k] for k, v in launches.items()}
        dec_queries = snippet_queries(rng, texts[:HF_DECODER_CHUNKS], HF_BATCH + 8
                                      + HF_DECODER_REQUESTS + 32)
        rec["decoders"], dec_launches = phase_hf_decoders(root, texts, dec_queries, dev)
        launches = {k: v + dec_launches[k] for k, v in launches.items()}
        more_queries = snippet_queries(rng, texts[:HF_MORE_CHUNKS], 8 + HF_MORE_REQUESTS + 32)
        rec["encoders_more"], more_launches = phase_hf_more(root, texts, more_queries, dev)
        launches = {k: v + more_launches[k] for k, v in launches.items()}
        encdec_queries = snippet_queries(rng, texts[:HF_ENCDEC_CHUNKS],
                                         8 + HF_ENCDEC_REQUESTS + 32)
        rec["encdec"], encdec_launches = phase_hf_encdec(root, texts, encdec_queries, dev)
        launches = {k: v + encdec_launches[k] for k, v in launches.items()}
        gpt_queries = snippet_queries(rng, texts[:HF_GPT_CHUNKS], 8 + HF_GPT_REQUESTS + 32)
        rec["gpt"], gpt_launches = phase_hf_gpt(root, texts, gpt_queries, dev)
        launches = {k: v + gpt_launches[k] for k, v in launches.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec["peak_gb"] = peak_gb_since(base) if dev == "cuda" else None
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"hf: phase 13 took {rec['seconds']:.2f}s; peak device memory "
        f"{rec['peak_gb']} GB beyond the earlier phases'")
    return rec, launches


def main() -> None:
    name, count, smi = phase_device()
    phase_build()
    kernel_results = phase_kernels()
    t = time.perf_counter()
    texts = synthetic_corpus(N_CHUNKS, seed=11)
    log(f"corpus: {len(texts)} chunks of {WORDS_PER_CHUNK} words made in "
        f"{time.perf_counter() - t:.2f}s")
    manager_tiers = {}

    def after_bf16(mgr):
        manager_tiers.update(ivf=phase_manager_tier("ivf", mgr, mgr.embedder, texts))

    BUILD_DIR.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="lifecycle-", dir=BUILD_DIR))
    try:
        launches, tiers, embedder, reranker = phase_main_path(texts, after_bf16, work)
        manager_tiers["pq"] = phase_manager_tier("pq", None, embedder, texts, work)
        encoders = phase_encoder_checkpoints(embedder, reranker, texts, work)
        service = phase_service(embedder, reranker, texts, work)
        sharded, sharded_launches = phase_sharded(texts, work, embedder, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_reference()
    service["reference"] = phase_service_reference()
    tiers_1m = phase_tiers_1m()
    phase_tier_reference()
    from advanced_rag_tpu_torch.utils.constants import IndexConstants

    root = Path(tempfile.mkdtemp(prefix="ckpt-", dir=BUILD_DIR))
    threshold = IndexConstants.IVF_AUTO_THRESHOLD
    IndexConstants.IVF_AUTO_THRESHOLD = LIFECYCLE_IVF_THRESHOLD
    try:
        lifecycle, lifecycle_cases, proj = phase_lifecycle(texts, root)
        lifecycle["pq"] = phase_pq_lifecycle(root, proj)
    finally:
        IndexConstants.IVF_AUTO_THRESHOLD = threshold
        shutil.rmtree(root, ignore_errors=True)
    lifecycle["encoders"] = encoders
    root = Path(tempfile.mkdtemp(prefix="train-", dir=BUILD_DIR))
    try:
        training, training_cases = phase_training(texts, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    host_native, native_launches, native_k5 = phase_host_native(texts, embedder, reranker)
    hf, hf_launches = phase_hf(texts)
    kernel_results["K5"] += native_k5
    for key, cases in list(lifecycle_cases.items()) + list(training_cases.items()):
        kernel_results[key] += cases
    for rec in (manager_tiers["ivf"], tiers_1m["ivf-bf16"], tiers_1m["ivf-sq8"]):
        kernel_results["K5"] += rec.pop("real_probe_cases")
    for rec in (tiers_1m["ivfpq"], lifecycle["pq"]["pq"]):
        kernel_results["K6"] += rec.pop("k6_cases")
    round_trips = {f"{k}-restore": v["lifecycle"] for k, v in tiers.items()}
    round_trips["pq-restore"] = manager_tiers["pq"]["lifecycle"]
    service_runs = {k: service[k] for k in ("fused", "default")}
    service_runs.update({f"{k}-restart": service[k]["lifecycle"]
                         for k in ("fused", "default")})
    pq_runs = lifecycle["pq"]
    round_trips.update({f"{k}-lifecycle-restore": v["round_trip"] for k, v in pq_runs.items()})
    for runs in (tiers_1m, manager_tiers, round_trips, {"lifecycle": lifecycle},
                 service_runs, pq_runs, {"training": training}):
        for rec in runs.values():
            for key in KERNEL_KEYS:
                launches[key] += rec["launches"][key]
    for key in KERNEL_KEYS:
        launches[key] += sharded_launches[key] + native_launches[key] + hf_launches[key]

    meta = {
        "K1": ("advanced_rag_tpu/ops/pallas_dense.py:39", "dense_scan.cu", True),
        "K2": ("advanced_rag_tpu/ops/pallas_dense.py:61", "dense_scan.cu", True),
        "K3": ("advanced_rag_tpu/ops/pallas_sparse.py:43", "kernels.cu", True),
        # K3-ip (scoring="ip") and K4 (the single-query IVF entry, which the
        # JAX package's own path never calls either) are off the main path
        "K3-ip": ("advanced_rag_tpu/ops/pallas_sparse.py:77", "kernels.cu", False),
        "K4": ("advanced_rag_tpu/ops/pallas_ivf.py:36", "ivf.cu", False),
        "K5": ("advanced_rag_tpu/ops/pallas_ivf.py:181", "ivf.cu", True),
        "K6": ("advanced_rag_tpu/ops/pq.py:328", "pq.cu", True),
    }
    kernels = []
    for key, (replaces, src, on_path) in meta.items():
        # K5's and K6's cases through a route or kernel by name (the
        # crossovers) go with them
        cases = kernel_results[key] + [
            c for k in ("lookup", "onehot", "stream", "grouped")
            for c in kernel_results.get(f"{key}-{k}", [])]
        main = next(c for c in cases if c["main"])
        kernels.append({
            "name": key, "route": "cuda",
            "source": f"advanced_rag_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[key],
            "on_main_path": on_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "call_ms": main["call_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            "cases": cases,
        })
    for key in ("K5", "K6"):
        if launches[key] == 0:
            raise AssertionError(f"{key} was never launched on the main paths")
    print(json.dumps({"kernels": kernels, "main_path": tiers, "tiers_1m": tiers_1m,
                      "manager_tiers": manager_tiers, "service": service,
                      "lifecycle": lifecycle, "training": training, "sharded": sharded,
                      "host_native": host_native, "hf": hf, "nvidia_smi": smi}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()

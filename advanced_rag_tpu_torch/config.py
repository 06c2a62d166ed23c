"""Typed configuration of the PyTorch port.

A copy of ``advanced_rag_tpu/config.py``: the port keeps its own copy so
that importing it never imports the JAX package.  Field names, defaults
and the YAML loader are the same, so one config file drives both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from .utils.constants import (
    ChunkingConstants,
    IndexConstants,
    PerformanceConstants,
    RetrievalConstants,
)


class IndexType(str, Enum):
    """Index families (reference indexing.py:53-60)."""

    SEMANTIC = "semantic"
    SPARSE = "sparse"
    DOMAIN = "domain"
    HYBRID = "hybrid"


class Metric(str, Enum):
    """Dense similarity metrics (reference indexing.py:66-67)."""

    COSINE = "cosine"
    INNER_PRODUCT = "ip"
    L2 = "l2"


@dataclass
class IndexConfig:
    """Geometry + quality knobs for one device index.

    Replaces reference IndexConfig (indexing.py:62-77).  HNSW
    M/efConstruction/ef become IVF nlist/nprobe with the same recall
    intent; ``index_kind='flat'`` is an exact brute-force scan, which at
    is the default.
    """

    index_type: IndexType = IndexType.SEMANTIC
    dim: int = IndexConstants.SEMANTIC_DIM
    metric: Metric = Metric.COSINE
    index_kind: str = "flat"                # "flat" | "ivf"
    dtype: str = "bfloat16"                 # storage dtype for embeddings
    nlist: int = 0                          # 0 -> auto (factor * sqrt(N))
    nprobe: int = IndexConstants.IVF_NPROBE
    # Quantized-tier refinement (BACKLOG #2): over-retrieve
    # refine_factor * k with the compressed codes (int8/pq), then exactly
    # re-score the survivors from the f32 host mirror.  0 = auto per tier
    # (int8 -> 2, pq -> 32, float -> off); 1 = off.
    refine_factor: int = 0
    # PQ tier geometry (ops/pq.py, dtype="pq"): pq_m sub-quantizers of
    # pq_bits each (4 -> 16 centroids/subspace, 8 -> 256)
    pq_m: int = 0                           # 0 -> auto (dim // 4)
    pq_bits: int = 4
    # OPQ: learn an orthogonal rotation before quantizing (ops/pq.py
    # opq_train) — better codes at the same bytes on anisotropic
    # embeddings; flat-PQ tier only (IVF-PQ residuals are near-isotropic)
    pq_opq: bool = False
    kmeans_iters: int = IndexConstants.IVF_KMEANS_ITERS
    scan_block_size: int = IndexConstants.SCAN_BLOCK_SIZE
    min_capacity: int = IndexConstants.MIN_CAPACITY
    # Sparse/BM25 knobs (reference indexing.py:158-167, constants.py:179)
    vocab_size: int = IndexConstants.SPARSE_VOCAB_SIZE
    doc_nnz: int = IndexConstants.SPARSE_DOC_NNZ
    query_nnz: int = IndexConstants.SPARSE_QUERY_NNZ
    drop_ratio: float = IndexConstants.SPARSE_DROP_RATIO
    bm25_k1: float = IndexConstants.BM25_K1
    bm25_b: float = IndexConstants.BM25_B
    # Sharding (replaces Milvus num_shards=4, indexing.py:234-239)
    num_shards: int = 1
    # Recall guardrail on AUTOMATIC tier demotion (maintenance_tick):
    # after a first-time IVF / PQ+IVF-PQ build, probe recall@10 against
    # the exact oracle and refuse the swap — previous tier kept, refusal
    # recorded — if the new tier cannot reach this target at any swept
    # nprobe (VERDICT r3 weak #6).  0 disables the guard.  Explicit
    # build_* calls are never guarded (the operator asked for the tier).
    demote_recall_target: float = 0.90


@dataclass
class RetrievalConfig:
    """Hybrid retrieval knobs (reference retrieval.py:70-101)."""

    top_k: int = RetrievalConstants.DEFAULT_TOP_K
    max_top_k: int = RetrievalConstants.MAX_TOP_K
    dense_weight: float = RetrievalConstants.DENSE_WEIGHT
    sparse_weight: float = RetrievalConstants.SPARSE_WEIGHT
    domain_weight: float = RetrievalConstants.DOMAIN_WEIGHT
    rrf_k: int = RetrievalConstants.RRF_K
    use_mmr: bool = True
    mmr_lambda: float = RetrievalConstants.MMR_LAMBDA
    use_reranking: bool = True
    enable_domain: bool = False
    enable_sparse: bool = True
    over_retrieve_factor: int = RetrievalConstants.OVER_RETRIEVE_FACTOR
    timeout_seconds: float = RetrievalConstants.TIMEOUT_SECONDS
    adaptive_weights: bool = False
    recency_half_life_days: float = RetrievalConstants.RECENCY_HALF_LIFE_DAYS
    # Query micro-batching: coalesce concurrent searches with identical
    # knobs into one fused dispatch (pipeline/batcher.py).
    enable_micro_batching: bool = True
    micro_batch_size: int = PerformanceConstants.QUERY_BATCH_SIZE
    micro_batch_wait_ms: float = 2.0


@dataclass
class MeshConfig:
    """Device-mesh layout for sharded search / training.

    Replaces the reference's delegated Milvus sharding (indexing.py:234-239)
    with an explicit jax.sharding mesh: the corpus axis is sharded over
    ``shard`` (ICI), queries ride ``data``.
    """

    shard_axis: str = "shard"
    data_axis: str = "data"
    mesh_shape: Optional[Tuple[int, int]] = None   # None -> (n_devices, 1)


@dataclass
class PipelineConfig:
    """End-to-end pipeline knobs (reference pipeline.py:37-57)."""

    target_latency_ms: float = PerformanceConstants.TARGET_LATENCY_MS
    hybrid_alpha: float = 0.7
    top_k: int = 20
    rerank_top_k: int = 5
    enable_reranking: bool = True
    enable_mmr: bool = True
    enable_sparse: bool = True
    enable_domain: bool = False
    enable_enrichment: bool = True
    enable_query_rewriting: bool = True
    hallucination_threshold: float = 0.15
    faithfulness_threshold: float = 0.7
    drift_threshold: float = 0.15
    enable_compliance: bool = True
    compliance_tenant: str = "default"
    retention_days: int = 365
    embed_batch_size: int = PerformanceConstants.EMBED_BATCH_SIZE
    # ingest chunking window (word tokens).  Production should size
    # chunks to the serving encoder's window: a 512-word chunk in front
    # of a 128-token encoder silently truncates 75% of the text the
    # dense tier is supposed to rank (reference exposes the same knobs
    # via its chunking config section, chunking.py:74-96)
    chunk_base_size: int = ChunkingConstants.BASE_CHUNK_SIZE
    chunk_max_size: int = ChunkingConstants.MAX_CHUNK_SIZE
    chunk_min_size: int = ChunkingConstants.MIN_CHUNK_SIZE
    # "sentence" (diagnostics-sized packing) | "window" (fixed word
    # windows at chunk_base_size with chunk_overlap — the encoder-
    # geometry protocol; +0.01-0.02 R@10 measured on real text)
    chunk_strategy: str = "sentence"
    chunk_overlap: float = ChunkingConstants.OVERLAP_RATIO
    # storage dtype for the semantic embedding matrix: "bfloat16" (default),
    # "float32", "int8" (SQ8 tier, ops/quant.py: int8 codes + row
    # scales), or "pq" (product-quantized tier, ops/pq.py)
    semantic_dtype: str = "bfloat16"
    # exact re-score factor for quantized tiers (int8/pq); 0 = auto per
    # tier (int8 -> 2, pq -> 32), 1 disables
    semantic_refine: int = 0
    # learn an OPQ rotation when building flat-PQ codes (recall lift at
    # the same bytes/row on anisotropic embedding distributions)
    semantic_opq: bool = False
    semantic_dim: int = IndexConstants.SEMANTIC_DIM
    domain_dim: int = IndexConstants.DOMAIN_DIM
    sparse_vocab_size: int = IndexConstants.SPARSE_VOCAB_SIZE
    # ONE-DISPATCH retrieve+rerank (ops/e2e.py): keep a device-resident
    # token table next to the index so the cross-encoder gathers its
    # candidates on device.  Costs 4*fused_token_len B/row of device memory.
    fused_rerank: bool = False
    fused_token_len: int = 48
    # Rerank DOC-DISTINCT slates in the fused program: over-retrieve a
    # 3x chunk pool and keep the best-ranked chunk per distinct parent
    # doc before the cross-encoder (ops/e2e.py doc_dedupe).  Measured
    # (artifacts/ABLATE_SERVICE.json): +0.02 R@10 at depth 20 — the
    # per-doc slate the unfused protocol reranks — but -0.02..-0.04 at
    # depth 48, where a chunk slate's duplicate docs act as extra
    # lottery tickets for the gold doc while doc-distinct slates hand
    # the CE more tail docs to mis-promote.  Default OFF (the
    # reference's chunk-level semantics, retrieval.py:421-491); the
    # quality bench dev-picks the serving shape per corpus
    # (QUALITY_REAL.json fused_serving) and the service env sets
    # RAG_FUSED_DOC_DEDUPE accordingly.
    fused_doc_dedupe: bool = False
    # Rerank key (both the fused program and the host rerank stage):
    #   rerank_mode  "residual": base + alpha*CE (the trained objective,
    #                train/rerank.py) | "zblend": alpha*z(CE)+(1-alpha)*
    #                base | "replace": CE order alone
    #   rerank_base  "exact": candidates re-scored exactly per tier and
    #                z-blended (ops/rescore.py; measured +0.11 MRR@10
    #                over the fused order) | "exact_postings": same
    #                blend, BM25 rescored from the inverted postings —
    #                no O(N) term table, serves the full hybrid key at
    #                any corpus size | "fused": RRF merge order
    #   rerank_alpha CE weight (0 = retrieval order; pick on a dev set)
    #   rescore_mix  dense weight inside the exact base blend
    rerank_mode: str = "residual"
    rerank_base: str = "exact"
    rerank_alpha: float = 0.5
    rescore_mix: float = 0.5
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def __post_init__(self) -> None:
        # enable_mmr is the pipeline-level switch (reference
        # pipeline.py:37-57); it previously only reached the retriever
        # through the service's env wiring, so
        # PipelineConfig(enable_mmr=False) silently kept MMR on in
        # library use.  AND-combine so an explicit retrieval.use_mmr
        # False also sticks.  Never mutate the nested instance in
        # place: dataclasses.replace() shares it, so an in-place write
        # here would flip use_mmr on the ORIGINAL config too.
        if not self.enable_mmr and self.retrieval.use_mmr:
            self.retrieval = dataclasses.replace(
                self.retrieval, use_mmr=False)


def _apply_section(cfg: Any, section: Dict[str, Any]) -> Any:
    """Overlay a dict onto a dataclass, ignoring unknown keys."""
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(f"not a dataclass: {type(cfg)}")
    names = {f.name: f for f in dataclasses.fields(cfg)}
    updates = {}
    for key, value in (section or {}).items():
        if key not in names:
            continue
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            updates[key] = _apply_section(current, value)
        elif isinstance(current, Enum):
            updates[key] = type(current)(value)
        else:
            updates[key] = value
    return dataclasses.replace(cfg, **updates)


def load_yaml_config(path: str | Path) -> Dict[str, Any]:
    """Load a raw YAML config file (reference config.py:18-24)."""
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(f"config root must be a mapping: {path}")
    return data


def load_pipeline_config(path: str | Path) -> PipelineConfig:
    """YAML -> PipelineConfig (reference config.py:26-33)."""
    data = load_yaml_config(path)
    cfg = PipelineConfig()
    cfg = _apply_section(cfg, data.get("pipeline", {}))
    if "retrieval" in data:
        cfg = dataclasses.replace(
            cfg, retrieval=_apply_section(cfg.retrieval, data["retrieval"])
        )
    if "mesh" in data:
        cfg = dataclasses.replace(cfg, mesh=_apply_section(cfg.mesh, data["mesh"]))
    return cfg


def load_component_configs(path: str | Path) -> Dict[str, Dict[str, Any]]:
    """Per-component raw sections (reference config.py:35-52)."""
    data = load_yaml_config(path)
    sections = (
        "index",
        "chunking",
        "embeddings",
        "reranking",
        "evaluation",
        "domains",
        "monitoring",
        "storage",
        "security",
        "mesh",
    )
    return {name: data.get(name, {}) for name in sections}


__all__ = [
    "IndexType",
    "Metric",
    "IndexConfig",
    "RetrievalConfig",
    "MeshConfig",
    "PipelineConfig",
    "load_yaml_config",
    "load_pipeline_config",
    "load_component_configs",
]

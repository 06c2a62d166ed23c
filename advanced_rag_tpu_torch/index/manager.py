"""Multi-index manager: the port of ``advanced_rag_tpu/index/manager.py``
for the ingest and the fused retrieve + rerank path.

Row-aligned index families over one CorpusStore: ``semantic`` (dense
bi-encoder embeddings), ``sparse`` (BM25 over hashed terms) and, with
``config.fused_rerank``, the token table the cross-encoder gathers from.
``index_chunks`` and ``fused_retrieve_batch_sync`` keep the JAX manager's
signatures and result dicts.

This slice ports ``__init__``, ``index_chunks``, ``_row_mask``,
``fused_retrieve_batch_sync``, ``delete_by_filter``,
``get_collection_stats`` and ``close``.  Maintenance, the IVF/PQ tier
builds, the domain family and the non-fused search methods come with later
slices (ROADMAP.md).

Every search passes a row mask (validity or compiled filters), because the
device tensors are padded to capacity.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..config import IndexConfig, IndexType, Metric, PipelineConfig
from ..models.embedder import Embedder, NeuralEmbedder
from ..utils.cache import EmbeddingCache, semantic_cache
from ..utils.exceptions import IndexingError, ValidationError
from .corpus import ChunkRecord, CorpusStore
from .dense_index import DenseIndex
from .sparse_index import SparseIndex
from .text import encode_documents


class MultiIndexManager:
    """Owns the corpus store + index families; exposes ingest and the fused
    retrieve + rerank."""

    #: overall bound on waits for other threads' in-flight rows
    INGEST_WAIT_DEADLINE_S = 300.0

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        embedder: Optional[Embedder] = None,
        *,
        enable_sparse: bool = True,
        semantic_cache_: Optional[EmbeddingCache] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.config = config or PipelineConfig()
        dev = self.device
        if embedder is None:
            if not self.config.fused_rerank:
                raise NotImplementedError(
                    "the hashing-embedder default of the unfused manager "
                    "comes with the non-fused search slice; pass an embedder")
            embedder = NeuralEmbedder(dim=self.config.semantic_dim, device=dev)
        emb_dev = getattr(embedder, "device", dev)
        if torch.device(emb_dev) != dev:
            raise ValueError(f"embedder is on {emb_dev}, the manager on {dev}")
        self.embedder = embedder
        if self.embedder.dim != self.config.semantic_dim:
            self.config.semantic_dim = self.embedder.dim
        self.store = CorpusStore(device=dev)
        self.semantic = DenseIndex(
            IndexConfig(index_type=IndexType.SEMANTIC, dim=self.embedder.dim,
                        metric=Metric.COSINE,
                        dtype=self.config.semantic_dtype,
                        refine_factor=self.config.semantic_refine),
            device=dev)
        self.enable_sparse = enable_sparse
        self.sparse = (SparseIndex(IndexConfig(index_type=IndexType.SPARSE),
                                   device=dev)
                       if enable_sparse else None)
        # the token table: the text column on the device, which the fused
        # retrieve program gathers the reranker's candidates from
        self.token_table = None
        if self.config.fused_rerank:
            from ..models.tokenizer import HashingTokenizer, TokenizerConfig
            from .token_table import TokenTable

            tok = getattr(self.embedder, "tokenizer", None) or \
                HashingTokenizer(TokenizerConfig())
            self.token_table = TokenTable(
                tok, max_len=self.config.fused_token_len, device=dev)
        self._dev_scalars: Dict[Any, torch.Tensor] = {}
        self._default_reranker: Any = None
        self._semantic_cache = semantic_cache_ or semantic_cache
        self._sem_ns = "semantic:" + getattr(self.embedder, "cache_tag", "")
        self._closed = False
        # Serializes corpus mutations.  Distinct batches embed
        # concurrently outside the critical section; duplicate ingests
        # wait on the condition for in-flight rows, so "indexed" always
        # means "searchable".
        self._write_lock = threading.Lock()
        self._write_cv = threading.Condition(self._write_lock)
        self._inflight_rows: set = set()

    # -- embeddings ----------------------------------------------------------

    def _embed_batch_cached(self, texts: Sequence[str], embedder: Embedder,
                            cache: EmbeddingCache, namespace: str) -> np.ndarray:
        """Cache-aware batch embedding: misses are embedded in one batched
        pass of the embedder."""
        out = np.zeros((len(texts), embedder.dim), np.float32)
        miss_pos: List[int] = []
        miss_texts: List[str] = []
        for i, text in enumerate(texts):
            hit = cache.get_sync(text, namespace)
            if hit is not None and hit.shape[0] == embedder.dim:
                out[i] = hit
            else:
                miss_pos.append(i)
                miss_texts.append(text)
        if miss_texts:
            fresh = embedder.encode(miss_texts)
            for j, pos in enumerate(miss_pos):
                out[pos] = fresh[j]
                cache.put_sync(miss_texts[j], fresh[j], namespace)
        return out

    # -- ingest ----------------------------------------------------------------

    def index_chunks(self, chunks: Sequence[Any]) -> Dict[str, Any]:
        """Index chunk objects (anything with .content/.chunk_id/.doc_id, or
        ChunkRecord).  Returns a per-batch report: indexed counts and
        per-chunk errors."""
        t0 = time.perf_counter()
        records: List[ChunkRecord] = []
        errors: List[Dict[str, str]] = []
        for pos, chunk in enumerate(chunks):
            try:
                records.append(self._to_record(chunk))
            except Exception as exc:  # per-chunk error capture
                errors.append({"chunk": str(pos), "error": str(exc)})
        report: Dict[str, Any] = {
            "total": len(chunks),
            "indexed": 0,
            "errors": errors,
            "elapsed_ms": 0.0,
        }
        if not records:
            report["elapsed_ms"] = (time.perf_counter() - t0) * 1000
            return report

        # Phase 1 (locked): claim rows + dedupe; wait for any deduped row
        # still in flight in another thread.
        new_rows: List[int] = []
        new_records: List[ChunkRecord] = []
        try:
            with self._write_cv:
                first_new = self.store.size
                rows, store_pending = self.store.prepare_append(records)
                seen = set()
                for row, rec in zip(rows, records):
                    if row >= first_new and row not in seen:
                        seen.add(row)
                        new_rows.append(row)
                        new_records.append(rec)
                self._inflight_rows.update(new_rows)
                others = set(rows) - seen
                deadline = time.monotonic() + self.INGEST_WAIT_DEADLINE_S
                while others & self._inflight_rows:
                    self._write_cv.wait(timeout=1.0)
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            "ingest timed out waiting for in-flight "
                            f"duplicate rows {sorted(others)[:8]}")

            if not new_rows:
                report["indexed"] = len(records)
                report["rows"] = rows
                report["elapsed_ms"] = (time.perf_counter() - t0) * 1000
                return report

            # Phase 2 (unlocked): embedding + sparse encoding.  Claimed rows
            # stay invalid on the device until the commit below.
            start = min(new_rows)
            texts = [r.content for r in new_records]
            emb = self._embed_batch_cached(texts, self.embedder,
                                           self._semantic_cache, self._sem_ns)
            sp_enc = None
            if self.sparse is not None:
                sp_enc = encode_documents(texts, self.sparse.vocab_size,
                                          self.sparse.doc_nnz)

            # Phase 3 (locked): write every family's rows in place, in
            # ascending row order across concurrent ingests.
            mine = set(new_rows)
            with self._write_cv:
                deadline = time.monotonic() + self.INGEST_WAIT_DEADLINE_S
                while any(r < start for r in self._inflight_rows if r not in mine):
                    self._write_cv.wait(timeout=1.0)
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            "ingest timed out waiting for lower-row "
                            "in-flight commits")
                sem_vals = self.semantic.prepare_append(start, emb)
                sp_vals = (self.sparse.prepare_append_encoded(start, *sp_enc)
                           if self.sparse is not None else None)
                tok_vals = (self.token_table.prepare_append(start, texts)
                            if self.token_table is not None else None)
                self.semantic.commit_append(start, sem_vals)
                if sp_vals is not None:
                    self.sparse.commit_append(start, sp_vals)
                if tok_vals is not None:
                    self.token_table.commit_append(start, tok_vals)
                if store_pending is not None:
                    self.store.commit_append(*store_pending)   # rows go live last
        finally:
            with self._write_cv:
                self._inflight_rows.difference_update(new_rows)
                self._write_cv.notify_all()
        report["indexed"] = len(records)
        report["rows"] = rows
        report["elapsed_ms"] = (time.perf_counter() - t0) * 1000
        return report

    @staticmethod
    def _to_record(chunk: Any) -> ChunkRecord:
        if isinstance(chunk, ChunkRecord):
            if not chunk.content:
                raise ValidationError("empty chunk content")
            return chunk
        content = getattr(chunk, "content", None)
        if not content:
            raise ValidationError("empty chunk content")
        meta = getattr(chunk, "metadata", None)

        def get(name: str, default: Any) -> Any:
            if meta is None:
                return default
            value = getattr(meta, name, None)
            return default if value is None else value

        return ChunkRecord(
            chunk_id=getattr(chunk, "chunk_id", None) or get("chunk_id", f"chunk-{id(chunk)}"),
            doc_id=getattr(chunk, "doc_id", None) or get("doc_id", "unknown"),
            content=content,
            chunk_index=int(get("chunk_index", 0)),
            token_count=int(get("token_count", len(content.split()))),
            entropy=float(get("entropy", 0.0)),
            redundancy=float(get("redundancy", 0.0)),
            domain_density=float(get("domain_density", 0.0)),
            timestamp=float(get("timestamp", time.time())),
            metadata=dict(getattr(meta, "extra", None) or {}),
        )

    # -- search ------------------------------------------------------------------

    def _scalar(self, *vals: float) -> torch.Tensor:
        """Cached device scalar/vector for recurring knob values."""
        key = tuple(float(v) for v in vals)
        arr = self._dev_scalars.get(key)
        if arr is None:
            arr = torch.tensor(key[0] if len(key) == 1 else key,
                               dtype=torch.float32, device=self.device)
            self._dev_scalars[key] = arr
        return arr

    def _row_mask(self, filters: Optional[Dict[str, Any]]) -> torch.Tensor:
        mask = self.store.build_filter_mask(filters)
        return mask if mask is not None else self.store.valid_mask

    def fused_retrieve_batch_sync(
        self,
        queries: Sequence[str],
        k_final: int = 5,
        filters: Optional[Dict[str, Any]] = None,
        *,
        reranker: Any = None,
        k_rerank: int = 16,
        dense_weight: float = 0.7,
        sparse_weight: float = 0.3,
        use_mmr: bool = True,
        mmr_lambda: float = 0.8,
        q_max_len: int = 32,
        rerank_alpha: Optional[float] = None,
        rerank_mode: str = "zblend",
        rerank_base: str = "fused",
        rescore_mix: float = 0.5,
        doc_dedupe: bool = False,
    ) -> List[List[Dict[str, Any]]]:
        """Embed -> hybrid search -> cross-encoder rerank, all on the device
        (requires ``config.fused_rerank``); one device->host copy per call.

        The dense scan runs through kernel K1 (bf16/f32 tiers) or K2 (SQ8),
        BM25 through kernel K3.  ``doc_dedupe=True`` reranks a doc-distinct
        slate over a 3x chunk pool.
        """
        from ..models.cross_encoder import CrossEncoderReranker
        from ..ops.e2e import make_retrieve_rerank

        if self.token_table is None:
            raise IndexingError(
                "fused_retrieve requires PipelineConfig.fused_rerank=True")
        if not hasattr(self.embedder, "model"):
            raise IndexingError(
                "fused_retrieve requires a neural embedder (NeuralEmbedder)")
        if self._closed:
            raise IndexingError("index manager is closed")
        if not queries:
            return []
        if self.store.n_valid() == 0:
            return [[] for _ in queries]
        if reranker is None:
            # one lazily built default, not a fresh model per call
            if self._default_reranker is None:
                self._default_reranker = CrossEncoderReranker(device=self.device)
            reranker = self._default_reranker
        nq = len(queries)
        k_out = min(-(-max(k_rerank, k_final) // 8) * 8,
                    self.config.retrieval.max_top_k)
        k_rerank = min(k_rerank, k_out)
        # doc-distinct slates need a deeper chunk pool (~0.65*K distinct
        # docs per K chunks on multi-chunk corpora)
        k_pool = (min(-(-3 * k_out // 8) * 8, 256) if doc_dedupe else k_out)
        mask = self._row_mask(filters)

        dense_impl = "sq8" if self.semantic._sq8 else "scan"
        sparse_on = self.sparse is not None
        kw: Dict[str, Any] = {}
        if self.semantic._sq8:
            kw["emb_scale"] = self.semantic.emb_scale
        if rerank_alpha is not None:
            kw["rerank_alpha"] = self._scalar(rerank_alpha)
            if rerank_base == "exact":
                kw["rescore_mix"] = self._scalar(rescore_mix)
        # the program is a plain closure over the two models, built per call
        # so that it always serves the reranker it was given
        tcfg = self.token_table.tokenizer.config
        program = make_retrieve_rerank(
            self.embedder.model, reranker.model,
            k_cand=2 * k_pool, k_out=k_pool, k_rerank=k_rerank,
            k_final=k_final, dense_impl=dense_impl, use_mmr=use_mmr,
            rerank_mode=rerank_mode, rerank_base=rerank_base,
            doc_dedupe=doc_dedupe, enable_sparse=sparse_on,
            pad_id=tcfg.pad_id, sep_id=tcfg.sep_id)
        if doc_dedupe:
            cols = self.store.device_columns
            kw["doc_lo"] = cols["doc_hash_lo"]
            kw["doc_hi"] = cols["doc_hash_hi"]

        # pair sequence = [CLS] q [SEP] doc [SEP]; it must fit the
        # cross-encoder's position table
        pair_len = q_max_len + self.token_table.max_len + 1
        ce_max = reranker.model.config.max_len
        if pair_len > ce_max:
            raise IndexingError(
                f"fused pair length {pair_len} (q {q_max_len} + doc "
                f"{self.token_table.max_len} + 1) exceeds the reranker "
                f"max_len {ce_max}")
        dev = self.device
        texts = list(queries)
        q_ids, q_mask = self.embedder.tokenizer.encode_batch(texts, q_max_len)
        if sparse_on:
            q_idx, q_tf = self.sparse.encode_query(texts)
            sp = self.sparse
            sparse_args = (sp.doc_idx, sp.doc_tf, sp.idx_t, sp.tf_t,
                           sp.doc_len, sp.df, self._scalar(max(sp.n_docs, 1)))
        else:
            n_cap = self.semantic.capacity
            q_idx = np.full((nq, 1), -1, np.int32)
            q_tf = np.zeros((nq, 1), np.float32)
            none_idx = torch.full((n_cap, 1), -1, dtype=torch.int32, device=dev)
            none_tf = torch.zeros((n_cap, 1), dtype=torch.float32, device=dev)
            sparse_args = (none_idx, none_tf, none_idx.T, none_tf.T,
                           torch.zeros(n_cap, device=dev),
                           torch.zeros(8, dtype=torch.int32, device=dev),
                           self._scalar(1.0))

        res = program(
            torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_mask).to(dev),
            torch.from_numpy(q_idx).to(dev), torch.from_numpy(q_tf).to(dev),
            self.token_table.tokens, self.semantic.emb, *sparse_args, mask,
            self._scalar(dense_weight, sparse_weight),
            self._scalar(mmr_lambda), **kw)
        ids = res.ids.cpu().numpy()
        ce_scores = res.ce_scores.cpu().numpy()
        fused = res.fused_scores.cpu().numpy()
        out: List[List[Dict[str, Any]]] = []
        for qi in range(nq):
            hits: List[Dict[str, Any]] = []
            for row, ce, fs in zip(ids[qi].tolist(), ce_scores[qi].tolist(),
                                   fused[qi].tolist()):
                if row < 0:
                    continue
                hits.append(self.store.hit(int(row), float(fs),
                                           method="fused_rerank",
                                           rerank_score=float(ce)))
            out.append(hits)
        return out

    # -- admin ---------------------------------------------------------------------

    def delete_by_filter(self, filters: Dict[str, Any], *,
                         forget_content: bool = False) -> int:
        """Delete the rows a filter spec matches."""
        with self._write_lock:
            mask = self.store.build_filter_mask(filters)
            if mask is None:
                raise ValidationError("delete_by_filter requires filters")
            rows = torch.nonzero(mask).flatten().cpu().tolist()
            deleted = self.store.delete_rows(rows, forget_content=forget_content)
            if deleted and self.sparse is not None:
                self.sparse.remove_rows(rows)
            return deleted

    def get_collection_stats(self) -> Dict[str, Any]:
        stats: Dict[str, Any] = {"store": self.store.stats()}
        stats["semantic"] = {
            "rows": self.semantic.size,
            "dim": self.semantic.dim,
            "memory_bytes": self.semantic.memory_bytes(),
            "ivf": False,
            "pq": False,
            "ivfpq": False,
            "ivf_tail_rows": 0,
            "ivf_needs_rebuild": False,
        }
        if self.sparse is not None:
            stats["sparse"] = {
                "rows": self.sparse.size,
                "vocab_size": self.sparse.vocab_size,
                "memory_bytes": self.sparse.memory_bytes(),
            }
        return stats

    def close(self) -> None:
        self._closed = True


__all__ = ["MultiIndexManager"]

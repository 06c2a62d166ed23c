"""Multi-index manager: the port of ``advanced_rag_tpu/index/manager.py``.

Row-aligned index families over one CorpusStore: ``semantic`` (dense
bi-encoder embeddings), ``sparse`` (BM25 over hashed terms), optionally
``domain`` (dense domain embeddings, ``enable_domain=True``) and, with
``config.fused_rerank``, the token table the cross-encoder gathers from.
The ported methods keep the JAX manager's signatures and result dicts:
the ingest ``index_chunks``; the searches ``search_sync``/``search`` (one
family), ``hybrid_search_batch_sync``/``hybrid_search_sync`` (dense +
BM25 + RRF + MMR over any tier: flat, SQ8, IVF, PQ (with or without
OPQ) or IVF-PQ) and
``fused_retrieve_batch_sync`` (embed + hybrid + cross-encoder rerank, flat
and SQ8 tiers); the tier builds ``build_semantic``; the maintenance pass
``maintenance_tick`` (first IVF build behind a recall guardrail, on a PQ
tier the first PQ + IVF-PQ build behind it, a rebuild or re-pack once the
appended tail outgrows the partitions, postings compaction) and its daemon
``start_maintenance``/``stop_maintenance``;
``delete_by_filter``, ``get_collection_stats``, ``reset_state`` (the
rollback of a failed ``utils/checkpoint.py`` restore) and ``close``; and
``rescore_candidates_sync``, the exact per-tier rescore the unfused rerank
stage builds its key from.  Without an embedder the manager embeds with
``HashingEmbedder``, or with ``NeuralEmbedder`` under
``config.fused_rerank``, as the JAX manager does; the domain family
defaults to ``HashingEmbedder(dim=config.domain_dim, seed=17)``.

Every search passes a row mask (validity or compiled filters), because the
device tensors are padded to capacity.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..config import IndexConfig, IndexType, Metric, PipelineConfig
from ..models.embedder import Embedder, HashingEmbedder, NeuralEmbedder
from ..ops.dense import NEG_INF, l2_normalize
from ..utils.cache import EmbeddingCache, domain_cache, semantic_cache
from ..utils.constants import IndexConstants
from ..utils.exceptions import IndexingError, ValidationError
from ..utils.profiling import annotate
from .corpus import ChunkRecord, CorpusStore, next_pow2
from .dense_index import DenseIndex
from .sparse_index import SparseIndex
from .text import encode_documents

logger = logging.getLogger(__name__)


class MultiIndexManager:
    """Owns the corpus store + index families; exposes ingest and the fused
    retrieve + rerank."""

    #: overall bound on waits for other threads' in-flight rows
    INGEST_WAIT_DEADLINE_S = 300.0

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        embedder: Optional[Embedder] = None,
        domain_embedder: Optional[Embedder] = None,
        *,
        enable_sparse: bool = True,
        enable_domain: bool = False,
        semantic_cache_: Optional[EmbeddingCache] = None,
        domain_cache_: Optional[EmbeddingCache] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.config = config or PipelineConfig()
        dev = self.device
        if embedder is None:
            # the JAX manager's defaults: the neural bi-encoder for the
            # fused program, else the training-free hashing projection
            embedder = (NeuralEmbedder(dim=self.config.semantic_dim, device=dev)
                        if self.config.fused_rerank else
                        HashingEmbedder(dim=self.config.semantic_dim, device=dev))
        for emb in (embedder, domain_embedder):
            emb_dev = getattr(emb, "device", dev)
            if emb is not None and torch.device(emb_dev) != dev:
                raise ValueError(f"embedder is on {emb_dev}, the manager on {dev}")
        self.embedder = embedder
        if self.embedder.dim != self.config.semantic_dim:
            self.config.semantic_dim = self.embedder.dim
        self.store = CorpusStore(device=dev)
        self.semantic = DenseIndex(
            IndexConfig(index_type=IndexType.SEMANTIC, dim=self.embedder.dim,
                        metric=Metric.COSINE,
                        dtype=self.config.semantic_dtype,
                        refine_factor=self.config.semantic_refine,
                        pq_opq=self.config.semantic_opq),
            device=dev)
        self.enable_sparse = enable_sparse
        self.sparse = (SparseIndex(IndexConfig(index_type=IndexType.SPARSE),
                                   device=dev)
                       if enable_sparse else None)
        self.enable_domain = enable_domain
        self.domain_embedder = domain_embedder
        self.domain: Optional[DenseIndex] = None
        if enable_domain:
            self.domain_embedder = domain_embedder or HashingEmbedder(
                dim=self.config.domain_dim, seed=17, device=dev)
            self.domain = DenseIndex(
                IndexConfig(index_type=IndexType.DOMAIN,
                            dim=self.domain_embedder.dim, metric=Metric.COSINE),
                device=dev)
        # the token table: the text column on the device, which the fused
        # retrieve program gathers the reranker's candidates from.  It holds
        # hashing ids, so an embedder with another tokenizer (an HF
        # checkpoint's WordPiece) gets none and the pipeline takes its
        # default path (JAX builds the table with it; its first ingest fails)
        self.token_table = None
        if self.config.fused_rerank:
            from ..models.tokenizer import HashingTokenizer, TokenizerConfig
            from .token_table import TokenTable

            tok = getattr(self.embedder, "tokenizer", None)
            if tok is None or isinstance(tok, HashingTokenizer):
                self.token_table = TokenTable(
                    tok or HashingTokenizer(TokenizerConfig()),
                    max_len=self.config.fused_token_len, device=dev)
        self._dev_scalars: Dict[Any, torch.Tensor] = {}
        self._default_reranker: Any = None
        self._semantic_cache = semantic_cache_ or semantic_cache
        self._domain_cache = domain_cache_ or domain_cache
        # the namespaces carry each embedder's identity: the module-level
        # caches are shared across managers
        self._sem_ns = "semantic:" + getattr(self.embedder, "cache_tag", "")
        self._dom_ns = "domain:" + getattr(self.domain_embedder, "cache_tag", "")
        self._closed = False
        self._maint_thread: Optional[threading.Thread] = None
        self._maint_stop: Optional[threading.Event] = None
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

    def generate_semantic_embedding(self, text: str) -> np.ndarray:
        """Single-text semantic embedding (through the cache)."""
        return self._embed_batch_cached([text], self.embedder,
                                        self._semantic_cache, self._sem_ns)[0]

    def generate_domain_embedding(self, text: str) -> np.ndarray:
        """Single-text domain embedding (through the domain cache)."""
        if not self.domain_embedder:
            raise IndexingError("domain index not enabled")
        return self._embed_batch_cached([text], self.domain_embedder,
                                        self._domain_cache, self._dom_ns)[0]

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
            demb = None
            if self.domain is not None and self.domain_embedder is not None:
                demb = self._embed_batch_cached(texts, self.domain_embedder,
                                                self._domain_cache, self._dom_ns)

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
                dom_vals = (self.domain.prepare_append(start, demb)
                            if demb is not None else None)
                tok_vals = (self.token_table.prepare_append(start, texts)
                            if self.token_table is not None else None)
                self.semantic.commit_append(start, sem_vals)
                if sp_vals is not None:
                    self.sparse.commit_append(start, sp_vals)
                if dom_vals is not None:
                    self.domain.commit_append(start, dom_vals)
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

    def search_sync(
        self,
        index_type: IndexType | str,
        query: str,
        k: int,
        filters: Optional[Dict[str, Any]] = None,
        query_embedding: Optional[np.ndarray] = None,
    ) -> List[Dict[str, Any]]:
        """Search one index family; returns hydrated hit dicts sorted by
        score.  SEMANTIC runs the dense tier's own search (IVF, PQ, SQ8 or
        the exact scan, with the quantized tiers' exact refinement); SPARSE
        the compare-scan BM25 (kernel K3); DOMAIN the domain family's exact
        scan (K1), or no hits without that family, as in the JAX manager."""
        index_type = IndexType(index_type)
        if self._closed:
            raise IndexingError("index manager is closed")
        if k <= 0:
            raise ValidationError("k must be positive")
        k = min(k, self.config.retrieval.max_top_k)
        if self.store.n_valid() == 0:
            return []
        mask = self._row_mask(filters)
        if index_type == IndexType.SEMANTIC:
            q = (query_embedding if query_embedding is not None
                 else self.generate_semantic_embedding(query))
            scores, rows = self.semantic.search(np.asarray(q, np.float32)[None, :],
                                                k, mask)
        elif index_type == IndexType.SPARSE:
            if self.sparse is None:
                return []
            scores, rows = self.sparse.search_texts([query], k, mask)
        elif index_type == IndexType.DOMAIN:
            if self.domain is None or self.domain_embedder is None:
                return []
            q = (query_embedding if query_embedding is not None
                 else self.generate_domain_embedding(query))
            scores, rows = self.domain.search(np.asarray(q, np.float32)[None, :],
                                              k, mask)
        else:
            raise ValidationError(f"cannot search index type {index_type}")
        return self._hydrate(scores.cpu().numpy()[0], rows.cpu().numpy()[0],
                             method=index_type.value)

    async def search(self, index_type: IndexType | str, query: str, k: int,
                     filters: Optional[Dict[str, Any]] = None,
                     query_embedding: Optional[np.ndarray] = None
                     ) -> List[Dict[str, Any]]:
        """``search_sync`` in a worker thread."""
        return await asyncio.to_thread(self.search_sync, index_type, query, k,
                                       filters, query_embedding)

    def hybrid_search_sync(self, query: str, k: int,
                           filters: Optional[Dict[str, Any]] = None,
                           **knobs: Any) -> List[Dict[str, Any]]:
        """Single-query hybrid search (see hybrid_search_batch_sync)."""
        return self.hybrid_search_batch_sync([query], k, filters, **knobs)[0]

    @staticmethod
    def _query_bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def hybrid_search_batch_sync(
        self,
        queries: Sequence[str],
        k: int,
        filters: Optional[Dict[str, Any]] = None,
        *,
        dense_weight: float = 0.7,
        sparse_weight: float = 0.3,
        domain_weight: float = 0.2,
        rrf_k: int = 60,
        use_mmr: bool = True,
        mmr_lambda: float = 0.8,
        over_retrieve: int = 2,
        query_embedding: Optional[np.ndarray] = None,  # [D] or [Q, D]
    ) -> List[List[Dict[str, Any]]]:
        """Dense + BM25 + RRF + MMR in one pass over the device, batched.

        The batch is padded to a power of two with empty queries and k to
        a multiple of 8, as the JAX manager does (its compiled programs are
        shared by bucket).  The dense rung follows the semantic tier: IVF
        (kernel K5, plus the exact appended tail), PQ (kernel K6, deep
        candidates re-scored exactly on the host and re-fused), SQ8 (K2)
        or the exact scan (K1).  BM25 takes the inverted postings once the
        corpus reaches ``SparseIndex.POSTINGS_AUTO_THRESHOLD`` live rows
        (building them on first use) or once they exist, and the
        compare-scan kernel K3 below that.  With the domain family, its
        exact scan (K1) is a third RRF list, weighted ``domain_weight``;
        without it the weight is unused, as in the JAX manager.
        """
        from ..config import Metric
        from ..ops.hybrid import hybrid_retrieve

        if self._closed:
            raise IndexingError("index manager is closed")
        if k <= 0:
            raise ValidationError("k must be positive")
        if not queries:
            return []
        k = min(k, self.config.retrieval.max_top_k)
        if self.store.n_valid() == 0:
            return [[] for _ in queries]
        mask = self._row_mask(filters)
        dev = self.device

        k_out = min(-(-k // 8) * 8, self.config.retrieval.max_top_k)
        k_cand = min(-(-(k * max(over_retrieve, 1)) // 8) * 8,
                     2 * self.config.retrieval.max_top_k)
        k_cand = max(k_cand, k_out)
        nq = len(queries)
        qb = self._query_bucket(nq)

        cache_fill: List[str] = []
        if query_embedding is not None:
            qe = np.asarray(query_embedding, np.float32)
            if qe.ndim == 1:
                qe = qe[None, :]
            q = torch.from_numpy(np.pad(qe, ((0, qb - nq), (0, 0)))).to(dev)
        else:
            cached = [self._semantic_cache.get_sync(t, self._sem_ns)
                      for t in queries]
            cached = [c if c is not None and c.shape[0] == self.embedder.dim
                      else None for c in cached]
            if all(c is not None for c in cached):
                q = torch.from_numpy(np.pad(np.stack(cached).astype(np.float32),
                                            ((0, qb - nq), (0, 0)))).to(dev)
            else:
                q = self.embedder.encode_device(list(queries) + [""] * (qb - nq))
                cache_fill = list(queries)
        q = q.float()
        if self.semantic.config.metric == Metric.COSINE:
            q = l2_normalize(q)

        sem = self.semantic
        sparse_on = self.sparse is not None
        kw: Dict[str, Any] = {}
        if sparse_on:
            sp = self.sparse
            q_idx, q_tf = sp.encode_query(list(queries))
            if qb != nq:
                q_idx = np.pad(q_idx, ((0, qb - nq), (0, 0)), constant_values=-1)
                q_tf = np.pad(q_tf, ((0, qb - nq), (0, 0)))
            if sp.capacity != sem.capacity:
                raise IndexingError(
                    "index capacities diverged (semantic "
                    f"{sem.capacity} vs sparse {sp.capacity})")
            sparse_args = (sp.idx_t, sp.tf_t, sp.doc_len, sp.df,
                           self._scalar(max(sp.n_docs, 1)))
            # the rung ladder: postings once the corpus justifies them
            if (sp.has_postings
                    or self.store.n_valid() >= sp.POSTINGS_AUTO_THRESHOLD):
                if not sp.has_postings:
                    sp.build_postings()
                sparse_impl = "postings"
                kw.update(post_rows=sp.post_rows, post_tf=sp.post_tf,
                          post_tfw=sp.post_tfw)
            else:
                sparse_impl = "kernel"
        else:
            q_idx = np.full((qb, 1), -1, np.int32)
            q_tf = np.zeros((qb, 1), np.float32)
            sparse_args = (None, None, None, None, None)
            sparse_impl = "kernel"

        weights = [dense_weight, sparse_weight]
        if self.domain is not None and self.domain_embedder is not None:
            if self.domain.capacity != sem.capacity:
                raise IndexingError("index capacities diverged (domain)")
            qd = self._embed_batch_cached(list(queries), self.domain_embedder,
                                          self._domain_cache, self._dom_ns)
            qd = torch.from_numpy(np.pad(qd, ((0, qb - nq), (0, 0)))).to(dev)
            kw.update(domain_emb=self.domain.emb,
                      q_domain=(l2_normalize(qd)
                                if self.domain.config.metric == Metric.COSINE
                                else qd))
            weights.append(domain_weight)

        pq_refine = 0
        q_dense = q
        if sem.has_ivf:
            tail = sem.size - sem._ivf_size
            dense_impl = "ivf"
            kw.update(ivf_parts=sem._ivf,
                      nprobe=min(sem.config.nprobe,
                                 int(sem._ivf.centroids.shape[0])),
                      ivf_tail_start=sem._ivf_size,
                      ivf_tail_pad=next_pow2(tail) if tail > 0 else 0)
        elif sem.has_pq:
            # the flat PQ codes (IVF-PQ serves the single-family search only)
            dense_impl = "pq"
            kw.update(pq_codebooks=sem._pq.codebooks, pq_m=sem._pq.m,
                      pq_bits=sem._pq.bits)
            if sem._pq_rot is not None:
                # OPQ: the dense rung scores q R; the cached query, the exact
                # re-scores of _refuse_exact and MMR keep the original space
                q_dense = q @ sem._pq_rot
            # over-retrieve deep raw-PQ candidates, re-scored exactly from
            # the f32 mirror and re-fused on the host (_refuse_exact)
            pq_refine = int(sem.config.refine_factor) or 32
            if pq_refine > 1:
                kw["dense_depth"] = min(max(k_cand * pq_refine, k_cand), 1024)
        elif sem._sq8:
            dense_impl = "sq8"
        else:
            dense_impl = "scan"
        if sem._sq8:
            kw["emb_scale"] = sem.emb_scale
        sparse_agg = ("scatter"
                      if (sparse_impl == "postings" and dev.type == "cuda"
                          and qb <= 2 and sem.capacity >= 4_000_000)
                      else "sort")
        res = hybrid_retrieve(
            sem.emb, *sparse_args, q_dense,
            torch.from_numpy(q_idx).to(dev), torch.from_numpy(q_tf).to(dev),
            mask, self._scalar(*weights), self._scalar(mmr_lambda),
            k_cand=k_cand, k_out=k_out, metric=sem.search_metric,
            rrf_k=rrf_k, use_mmr=use_mmr, enable_sparse=sparse_on,
            dense_impl=dense_impl, sparse_impl=sparse_impl,
            sparse_agg=sparse_agg, **kw)
        q_host = q.cpu().numpy()
        if pq_refine > 1:
            ids, scores, counts = self._refuse_exact(
                q_host[:nq], res.dense_ids.cpu().numpy()[:nq],
                res.sparse_ids.cpu().numpy()[:nq],
                res.domain_ids.cpu().numpy()[:nq],
                k_cand=k_cand, k_out=k_out, rrf_k=rrf_k, use_mmr=use_mmr,
                mmr_lambda=mmr_lambda, weights=np.asarray(weights, np.float32),
                sparse_on=sparse_on, domain_on="domain_emb" in kw)
        else:
            ids = res.ids.cpu().numpy()
            scores = res.scores.cpu().numpy()
            counts = res.method_counts.cpu().numpy()
        for text, vec in zip(cache_fill, q_host):
            self._semantic_cache.put_sync(text, np.asarray(vec, np.float32),
                                          self._sem_ns)
        out: List[List[Dict[str, Any]]] = []
        for qi in range(nq):
            hits: List[Dict[str, Any]] = []
            for row, score, cnt in zip(ids[qi].tolist(), scores[qi].tolist(),
                                       counts[qi].tolist()):
                if row < 0 or len(hits) >= k:
                    continue
                hits.append(self.store.hit(int(row), float(score),
                                           method="hybrid",
                                           method_count=int(cnt)))
            out.append(hits)
        return out

    def _refuse_exact(
        self,
        q_host: np.ndarray,       # [Q, D] f32 normalized queries
        d_ids_deep: np.ndarray,   # [Q, depth] raw-PQ dense candidates
        s_ids: np.ndarray,        # [Q, k_cand] sparse candidates
        dom_ids: np.ndarray,      # [Q, k_cand] domain candidates (-1 pad)
        *,
        k_cand: int,
        k_out: int,
        rrf_k: int,
        use_mmr: bool,
        mmr_lambda: float,
        weights: np.ndarray,
        sparse_on: bool,
        domain_on: bool,
    ):
        """Host-side exact re-fusion for the PQ tier: the deep dense
        candidates re-scored exactly from the f32 mirror, then RRF and MMR
        re-run with the same ops on the CPU (pools of <= ~100 rows); MMR
        uses the exact mirror embeddings.  -> numpy (ids, scores, counts)."""
        from ..ops.fusion import mmr_select, rrf_fuse

        _, d_i = self.semantic._refine_exact_host(q_host, d_ids_deep, k_cand)
        methods = [d_i.astype(np.int32)]
        if sparse_on:
            methods.append(np.asarray(s_ids)[:, :k_cand].astype(np.int32))
        if domain_on:
            methods.append(np.asarray(dom_ids)[:, :k_cand].astype(np.int32))
        cand = torch.from_numpy(np.stack(methods, axis=0))      # [M, Q, K]
        w = torch.from_numpy(np.asarray(weights, np.float32)[: len(methods)])
        fused_s, fused_i, counts = rrf_fuse(cand, w, rrf_k=rrf_k, k_out=k_cand)
        if use_mmr:
            fi = fused_i.numpy()
            cand_emb = torch.from_numpy(self.semantic._host[np.clip(fi, 0, None)])
            pos = mmr_select(cand_emb, fused_s, k_out, float(mmr_lambda),
                             fused_i >= 0)
            sel_ok = pos >= 0
            safe_pos = torch.clamp(pos, min=0).long()
            out_i = torch.where(sel_ok, torch.gather(fused_i, 1, safe_pos), -1)
            out_s = torch.where(sel_ok, torch.gather(fused_s, 1, safe_pos), NEG_INF)
            out_c = torch.where(sel_ok, torch.gather(counts, 1, safe_pos), 0)
        else:
            out_i = fused_i[:, :k_out]
            out_s = fused_s[:, :k_out]
            out_c = counts[:, :k_out]
        return out_i.numpy(), out_s.numpy(), out_c.numpy()

    def _hydrate(self, scores: np.ndarray, rows: np.ndarray,
                 method: str) -> List[Dict[str, Any]]:
        hits = []
        for score, row in zip(scores.tolist(), rows.tolist()):
            if row < 0:
                continue
            hits.append(self.store.hit(int(row), float(score), method=method))
        return hits

    @annotate("fused_retrieve_batch")
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

        The dense scan runs through kernel K1 (bf16/f32 tiers) or K2 (SQ8);
        BM25 through kernel K3, or through the inverted postings once the
        sparse index has them (``rerank_base="exact_postings"`` then
        rescores BM25 from them too).  IVF and PQ corpora are served by
        ``hybrid_search_batch_sync``.  ``doc_dedupe=True`` reranks a
        doc-distinct slate over a 3x chunk pool.
        """
        from ..models.cross_encoder import CrossEncoderReranker
        from ..ops.e2e import make_retrieve_rerank

        if self.token_table is None:
            raise IndexingError(
                "fused_retrieve requires PipelineConfig.fused_rerank=True")
        if not hasattr(self.embedder, "model"):
            raise IndexingError(
                "fused_retrieve requires a neural embedder (NeuralEmbedder)")
        if self.semantic.has_ivf or self.semantic._pq_mode:
            raise IndexingError(
                "fused_retrieve supports the bf16/f32/SQ8 tiers; use "
                "hybrid_search_batch_sync on partitioned/PQ corpora")
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
        sparse_impl = "kernel"
        if sparse_on and self.sparse.has_postings:
            sparse_impl = "postings"
            kw.update(post_rows=self.sparse.post_rows,
                      post_tf=self.sparse.post_tf,
                      post_tfw=self.sparse.post_tfw)
        if self.semantic._sq8:
            kw["emb_scale"] = self.semantic.emb_scale
        if rerank_alpha is not None:
            kw["rerank_alpha"] = self._scalar(rerank_alpha)
            if rerank_base == "exact_postings" and sparse_impl != "postings":
                raise IndexingError(
                    'rerank_base="exact_postings" requires the inverted '
                    "postings sparse tier (SparseIndex.build_postings)")
            if rerank_base in ("exact", "exact_postings"):
                kw["rescore_mix"] = self._scalar(rescore_mix)
        # the program is a plain closure over the two models, built per call
        # so that it always serves the reranker it was given
        tcfg = self.token_table.tokenizer.config
        program = make_retrieve_rerank(
            self.embedder.model, reranker.model,
            k_cand=2 * k_pool, k_out=k_pool, k_rerank=k_rerank,
            k_final=k_final, dense_impl=dense_impl, sparse_impl=sparse_impl,
            sparse_agg=("scatter" if (sparse_impl == "postings"
                                      and self.device.type == "cuda" and nq <= 2
                                      and self.semantic.capacity >= 4_000_000)
                        else "sort"),
            use_mmr=use_mmr,
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
        with annotate("tokenize_queries"):
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

        with annotate("retrieve_rerank"):
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
        with annotate("hydrate"):
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

    def rescore_candidates_sync(
        self,
        queries: Sequence[str],
        rows: np.ndarray,                 # [Q, K] i32 candidate rows (-1 pad)
        filters: Optional[Dict[str, Any]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact per-tier rescore of retrieval candidates (host entry).

        -> (dense [Q, K], bm25 [Q, K]) f32: each candidate's exact dense
        dot and full-body BM25 (``ops/rescore.py``).  The unfused rerank
        stage builds its base key from these; the fused program computes
        the same in-program (``rerank_base="exact"``).  PQ corpora keep
        no full-precision rows, so they raise, as in the JAX manager.
        """
        from ..ops.rescore import exact_tier_scores

        if self._closed:
            raise IndexingError("index manager is closed")
        if self.semantic._pq_mode:
            raise IndexingError(
                "rescore_candidates_sync needs full-precision embeddings "
                "(bf16/f32/SQ8 tiers); PQ corpora keep ADC scores")
        rows = np.asarray(rows, np.int32)
        if rows.ndim != 2 or len(queries) != rows.shape[0]:
            raise ValidationError(
                "rescore_candidates_sync needs rows shaped [len(queries), K]")
        if not queries:
            return (np.zeros((0, 0), np.float32),) * 2
        dev = self.device
        q = self.embedder.encode_device(list(queries)).float()
        if self.semantic.config.metric == Metric.COSINE:
            q = l2_normalize(q)
        mask = self._row_mask(filters)
        if self.sparse is not None:
            sp = self.sparse
            q_idx, q_tf = sp.encode_query(list(queries))
            sparse_args = (sp.doc_idx, sp.doc_tf, sp.doc_len, sp.df,
                           self._scalar(max(sp.n_docs, 1)))
        else:
            n_cap = self.semantic.capacity
            q_idx = np.full((len(queries), 1), -1, np.int32)
            q_tf = np.zeros((len(queries), 1), np.float32)
            sparse_args = (
                torch.full((n_cap, 1), -1, dtype=torch.int32, device=dev),
                torch.zeros((n_cap, 1), dtype=torch.float32, device=dev),
                torch.zeros(n_cap, dtype=torch.float32, device=dev),
                torch.zeros(8, dtype=torch.int32, device=dev),
                self._scalar(1.0))
        with torch.inference_mode():
            d_ex, s_ex = exact_tier_scores(
                torch.from_numpy(rows).to(dev), q,
                torch.from_numpy(q_idx).to(dev), torch.from_numpy(q_tf).to(dev),
                self.semantic.emb, *sparse_args, valid=mask,
                emb_scale=self.semantic.emb_scale if self.semantic._sq8 else None)
        return (d_ex.float().cpu().numpy(), s_ex.float().cpu().numpy())

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
            "ivf": self.semantic.has_ivf,
            "pq": self.semantic.has_pq,
            "ivfpq": self.semantic.has_ivfpq,
            "ivf_tail_rows": self.semantic.ivf_tail_rows,
            "ivf_needs_rebuild": self.semantic.ivf_needs_rebuild,
        }
        if self.sparse is not None:
            stats["sparse"] = {
                "rows": self.sparse.size,
                "vocab_size": self.sparse.vocab_size,
                "memory_bytes": self.sparse.memory_bytes(),
            }
        if self.domain is not None:
            stats["domain"] = {
                "rows": self.domain.size,
                "dim": self.domain.dim,
                "memory_bytes": self.domain.memory_bytes(),
            }
        return stats

    def reset_state(self) -> None:
        """Reinitialize the store and every index family to empty, with the
        same configurations.

        Rolls back a partly applied restore: ``load_index`` fills the store
        before the dense files stream in, so a failure midway would leave
        a torn manager whose chunk ids block both a retry and a re-ingest."""
        dev = self.device
        self.store = CorpusStore(device=dev)
        self.semantic = DenseIndex(self.semantic.config, device=dev)
        if self.sparse is not None:
            self.sparse = SparseIndex(self.sparse.config, device=dev)
        if self.domain is not None:
            self.domain = DenseIndex(self.domain.config, device=dev)
        if self.token_table is not None:
            from .token_table import TokenTable

            self.token_table = TokenTable(self.token_table.tokenizer,
                                          max_len=self.token_table.max_len,
                                          device=dev)

    def build_semantic(self, *, pq: bool = False,
                       ivf: bool = False) -> Dict[str, Any]:
        """Tier builds under the write lock, so they cannot race an ingest:
        ``pq`` trains and swaps in the PQ codes (``semantic_dtype="pq"``;
        with ``semantic_opq`` an OPQ rotation too), ``ivf`` builds the IVF
        partitions, IVF-PQ on a PQ index; under an OPQ rotation IVF-PQ is
        skipped, as in the JAX manager."""
        out: Dict[str, Any] = {}
        with self._write_lock:
            sem = self.semantic
            if pq and sem._pq_mode and not sem.has_pq:
                sem.build_pq()
                out["pq_built"] = True
            if ivf and not (sem.has_ivf or sem.has_ivfpq):
                if sem._pq_mode and sem._pq_rot is not None:
                    out["ivf_skipped"] = "opq rotation active"
                else:
                    sem.build_ivf()
                    out["ivf_built"] = True
        return out

    # -- background maintenance ------------------------------------------------

    def maintenance_tick(self) -> Dict[str, Any]:
        """One maintenance pass, under the write lock (tier builds swap
        ``semantic.emb`` and ``_ivf``, which must never interleave with an
        ingest's commit basing itself on the old storage):

        - the first IVF build once ``IndexConstants.IVF_AUTO_THRESHOLD``
          rows are valid, kept only if the recall guardrail passes
          (``_demotion_recall_ok``), else the exact scan stays; on a PQ tier
          at that size the PQ codebooks and the IVF-PQ partitions, behind
          the same guardrail, which restores the bf16 staging tier when it
          fails; with OPQ the rotated flat codes only, unguarded (OPQ and
          IVF-PQ exclude each other);
        - an IVF rebuild, or an IVF-PQ re-pack (same nlist), once the
          appended tail outgrows ``DenseIndex.REBUILD_TAIL_FRACTION`` of the
          rows;
        - postings compaction once more than 10% of the postings belong to
          deleted rows.

        Build-then-swap: the new partitions are built from the host mirror
        while the old ones stay searchable, then assigned."""
        with self._write_lock:
            return self._maintenance_tick_locked()

    def _demotion_recall_ok(self, actions: Dict[str, Any], tier: str) -> bool:
        """Recall guardrail on an automatic tier demotion: probe the new
        IVF tier's recall@10 against the exact scan (``tune_nprobe``'s
        sweep, which also sets the serving nprobe) and return False when
        even the deepest probe misses ``config.demote_recall_target``; the
        caller then restores the previous tier.

        Only the data errors the probe can raise (``ValueError``,
        ``IndexingError``) are recorded and let the tick go on; anything
        else, a kernel's launch failure on the card included, propagates
        (the JAX manager catches every exception here)."""
        target = float(self.semantic.config.demote_recall_target)
        if target <= 0.0:
            return True
        try:
            nprobe, recall = self.semantic.tune_nprobe(
                recall_target=target, k=10, sample=min(64, self.semantic.size))
        except (ValueError, IndexingError) as exc:
            logger.exception("demotion recall probe failed")
            actions["demotion_probe_error"] = str(exc)[:200]
            return True
        actions["demotion_recall"] = round(float(recall), 4)
        if recall >= target:
            return True
        actions["demotion_blocked"] = {
            "tier": tier, "recall": round(float(recall), 4),
            "target": target, "nprobe": int(nprobe)}
        logger.warning("maintenance: %s demotion blocked: recall@10 %.3f < "
                       "target %.2f at nprobe %d; keeping the previous tier",
                       tier, recall, target, nprobe)
        return False

    def _maintenance_tick_locked(self) -> Dict[str, Any]:
        actions: Dict[str, Any] = {"ivf_rebuilt": False}
        sem = self.semantic
        if sem._pq_mode:
            if (not sem.has_pq
                    and self.store.n_valid() >= IndexConstants.IVF_AUTO_THRESHOLD):
                # flat codebooks (the hybrid rung, MMR decode) and the IVF-PQ
                # partitions (the nprobe-bounded dense search); the bf16
                # staging tensor stays alive in `prev`, so a refusal restores
                # it with one assignment
                prev = (sem.emb, sem._pq, sem._pq_rot, sem._ivfpq,
                        sem._ivfpq_size, sem.config.nprobe)
                sem.build_pq()
                guarded = sem._pq_rot is None
                if guarded:
                    sem.build_ivfpq()
                if guarded and not self._demotion_recall_ok(actions, "pq+ivfpq"):
                    (sem.emb, sem._pq, sem._pq_rot, sem._ivfpq,
                     sem._ivfpq_size, sem.config.nprobe) = prev
                else:
                    actions["pq_built"] = True
            elif sem.ivf_needs_rebuild:
                # the tail outgrew the partitions: re-pack at the same nlist
                sem.build_ivfpq(nlist=int(sem._ivfpq.centroids.shape[0]))
                actions["ivf_rebuilt"] = True
                actions["ivf_rows"] = sem._ivfpq_size
        elif (not sem.has_ivf
                and self.store.n_valid() >= IndexConstants.IVF_AUTO_THRESHOLD):
            prev = (sem._ivf, sem._ivf_size, sem.config.nprobe)
            sem.build_ivf()
            if self._demotion_recall_ok(actions, "ivf"):
                actions["ivf_rebuilt"] = True
                actions["ivf_rows"] = sem._ivf_size
            else:
                sem._ivf, sem._ivf_size, sem.config.nprobe = prev
        elif sem.ivf_needs_rebuild:
            sem.build_ivf(nlist=int(sem._ivf.centroids.shape[0]))
            actions["ivf_rebuilt"] = True
            actions["ivf_rows"] = sem._ivf_size
        # deleted rows' postings occupy list slots (masked at query time):
        # rebuild without them once more than 10% are dead
        if (self.sparse is not None
                and self.sparse.postings_stale_fraction > 0.10):
            self.sparse.build_postings(
                valid=self.store._host_valid[: self.sparse.size])
            actions["postings_compacted"] = True
        return actions

    def start_maintenance(self, interval_s: float = 30.0) -> None:
        """Run ``maintenance_tick`` on a daemon thread every ``interval_s``
        seconds, under ``torch.inference_mode`` (grad mode is per thread).
        A failed tick is logged and the loop goes on; callers that must
        see a fault call ``maintenance_tick`` themselves."""
        if self._maint_thread is not None:
            return
        stop = threading.Event()

        def loop() -> None:
            with torch.inference_mode():
                while not stop.wait(interval_s):
                    if self._closed:
                        return
                    try:
                        self.maintenance_tick()
                    except Exception:
                        logger.exception("maintenance tick failed")

        self._maint_stop = stop
        self._maint_thread = threading.Thread(
            target=loop, name="index-maintenance", daemon=True)
        self._maint_thread.start()

    def stop_maintenance(self) -> None:
        if self._maint_thread is not None:
            self._maint_stop.set()
            self._maint_thread.join(timeout=5.0)
            self._maint_thread = None

    def close(self) -> None:
        self.stop_maintenance()
        self._closed = True


__all__ = ["MultiIndexManager"]

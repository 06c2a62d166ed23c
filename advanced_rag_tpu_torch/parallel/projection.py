"""Latency projection of a sharded retrieve: the port of
``advanced_rag_tpu/parallel/projection.py``.

A configuration that cannot run on the machine at hand (10M rows over 8
cards) gets an explicit, assumption-stated projection from single-card
measurements.  Model (Q = 1 retrieve: SQ8 dense + BM25 + RRF / MMR + CE
rerank):

  t_total = t_embed + max_shard(t_dense + t_sparse + t_fuse) + t_merge
            + t_rerank + t_eval

- t_dense and t_sparse scale linearly in rows a shard from their measured
  time per million rows (each shard scans privately);
- t_fuse (RRF + MMR + dispatch) is fixed per shard;
- t_merge: log2(S) hops, each moving Q * k (id, score) pairs of 8 bytes,
  at ``hop_ms`` a hop and ``link_bytes_per_s``;
- t_embed, t_rerank and t_eval do not depend on the corpus.

Every anchor is given explicitly: ``MeasuredAnchors`` has no defaults, and
the merge's hop latency and link rate are parameters.  The port states no
number for them; ``MeasuredAnchors.from_smoke`` reads the anchors that
``chip_smoke.py`` measured on its card.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Union


@dataclass(frozen=True)
class MeasuredAnchors:
    """Single-card measurements the projection extrapolates from."""

    embed_ms: float                      # bi-encoder forward, one query
    dense_sq8_ms_per_mrow: float         # SQ8 scan + top-k per 1M rows
    sparse_postings_ms_per_mrow: float   # BM25 top-k per 1M rows
    fuse_fixed_ms: float                 # RRF + MMR + program overhead
    rerank_ms: float                     # cross-encoder over the slate
    eval_host_ms: float                  # host stages after the program
    jitter_p99_ms: float                 # p99 - p50 spread
    source: str

    @classmethod
    def from_smoke(cls, line: Union[str, Mapping[str, Any]]) -> "MeasuredAnchors":
        """The anchors of ``chip_smoke.py``'s JSON line (the line, or the
        object parsed from it): ``sharded.anchors``, with its card's name
        and power limit as the source."""
        doc = json.loads(line) if isinstance(line, str) else line
        anchors = dict(doc["sharded"]["anchors"])
        source = anchors.pop("source")
        return cls(**anchors, source=source)


def project_sharded_retrieve(
    rows: int = 10_000_000,
    n_shards: int = 8,
    *,
    anchors: MeasuredAnchors,
    hop_ms: float,
    link_bytes_per_s: float,
    k: int = 20,
    q: int = 1,
    sla_ms: float = 80.0,
) -> Dict[str, float]:
    rows_per_shard = rows / n_shards
    mrow = rows_per_shard / 1e6
    t_dense = anchors.dense_sq8_ms_per_mrow * mrow
    t_sparse = anchors.sparse_postings_ms_per_mrow * mrow
    t_shard = t_dense + t_sparse + anchors.fuse_fixed_ms
    hops = max(1, math.ceil(math.log2(n_shards)))
    payload_bytes = q * k * 8 * hops
    t_merge = hops * hop_ms + payload_bytes / link_bytes_per_s * 1e3
    p50 = (anchors.embed_ms + t_shard + t_merge + anchors.rerank_ms
           + anchors.eval_host_ms)
    return {
        "rows": rows,
        "n_shards": n_shards,
        "rows_per_shard": rows_per_shard,
        "t_embed_ms": round(anchors.embed_ms, 2),
        "t_shard_hybrid_ms": round(t_shard, 2),
        "t_merge_ms": round(t_merge, 2),
        "t_rerank_ms": round(anchors.rerank_ms, 2),
        "t_eval_ms": round(anchors.eval_host_ms, 2),
        "projected_p50_ms": round(p50, 2),
        "projected_p99_ms": round(p50 + anchors.jitter_p99_ms, 2),
        "sla_ms": sla_ms,
        "sla_headroom_x": round(sla_ms / (p50 + anchors.jitter_p99_ms), 2),
    }


__all__ = ["MeasuredAnchors", "project_sharded_retrieve"]

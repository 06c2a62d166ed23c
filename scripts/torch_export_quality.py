#!/usr/bin/env python3
"""Dump the service quality check's inputs for the PyTorch port, on the
machine where the JAX stack and orbax are installed.

    python scripts/torch_export_quality.py [--out build/quality] [--max-docs 24000]

Writes, under ``--out``:

- ``biencoder/`` and ``reranker/``: ``artifacts/biencoder_ckpt`` and
  ``artifacts/reranker_ckpt`` converted to the port's format
  (``scripts/torch_convert_checkpoints.py``);
- ``corpus.jsonl``: the documents ``scripts/bench_quality_service.py``
  ingests (``harvest_docstrings`` of installed packages' docstrings: doc_id
  = the object's qualname, content = the docstring body);
- ``queries.jsonl``: its test-half queries (summary line, gold doc_id), drawn
  as that script draws them (seed 0, ``queries[1::2]``);
- ``knobs.json``: the service settings of that script's MMR-off deployment,
  whose R@10 / MRR@10 ``artifacts/QUALITY_SERVICE.json`` records, with the
  rank-key knobs and slate depth from ``QUALITY_REAL.json``'s
  ``fused_serving`` tier.

The harvest depends on the installed packages, so it is made once here and
read by ``scripts/torch_quality_service.py`` wherever the port runs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def knobs(quality: dict) -> dict:
    """The service settings and the /retrieve depth of the MMR-off run."""
    rk = (quality["tiers"].get("fused_serving")
          or quality["tiers"].get("fused_reranked")
          or quality["tiers"]["trained_reranked"])
    env = {
        "RAG_FUSED_E2E": "1",
        "RAG_RERANK_MODE": rk.get("mode", "residual"),
        "RAG_RERANK_BASE": rk.get("base", "exact"),
        "RAG_RERANK_ALPHA": str(rk.get("alpha", 0.25)),
        "RAG_RESCORE_MIX": str(rk.get("mix", 0.5)),
        "RAG_DENSE_WEIGHT": str(rk.get("weights", [0.7, 0.3])[0]),
        "RAG_SPARSE_WEIGHT": str(rk.get("weights", [0.7, 0.3])[1]),
        "RAG_FUSED_DOC_DEDUPE": "1" if rk.get("doc_dedupe") else "0",
        "ENABLE_MMR": "0",
        "ENABLE_ADAPTIVE_WEIGHTS": "1",
        "RAG_CHUNK_BASE": "110",
        "RAG_CHUNK_MAX": "160",
        "RAG_CHUNK_MIN": "32",
        "RAG_CHUNK_STRATEGY": "window",
        "RAG_CHUNK_OVERLAP": "0.273",
        "RAG_INGEST_RPM": "100000",
        "RAG_RETRIEVE_RPM": "100000",
    }
    return {"env": env, "top_k": int(rk.get("k_rerank", 48)),
            "knobs": {k: rk.get(k) for k in ("base", "mix", "mode", "alpha", "weights")}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(REPO / "build" / "quality"))
    ap.add_argument("--max-docs", type=int, default=24000)
    ap.add_argument("--queries", type=int, default=384)
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    from scripts.torch_convert_checkpoints import convert_biencoder, convert_reranker

    convert_biencoder(REPO / "artifacts" / "biencoder_ckpt", out / "biencoder")
    convert_reranker(REPO / "artifacts" / "reranker_ckpt", out / "reranker")

    from scripts.bench_quality_real import harvest_docstrings

    docs = harvest_docstrings(args.max_docs)
    rng = np.random.default_rng(0)
    order = rng.permutation(len(docs))
    n_eval = min(args.queries, len(docs) // 4)
    eval_idx = sorted(order[:n_eval].tolist())
    queries = [docs[i][1] for i in eval_idx][1::2]
    gold = [docs[i][0] for i in eval_idx][1::2]
    with open(out / "corpus.jsonl", "w", encoding="utf-8") as f:
        for doc_id, _, body in docs:
            f.write(json.dumps({"doc_id": doc_id, "content": body}) + "\n")
    with open(out / "queries.jsonl", "w", encoding="utf-8") as f:
        for q, g in zip(queries, gold):
            f.write(json.dumps({"query": q, "gold": g}) + "\n")
    quality = json.loads((REPO / "QUALITY_REAL.json").read_text())
    (out / "knobs.json").write_text(json.dumps(knobs(quality), indent=2))
    print(json.dumps({"n_docs": len(docs), "n_queries": len(queries),
                      "quality_real_n_docs": quality["n_docs"], "out": str(out)}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The PyTorch port's /retrieve quality against the JAX package's on the
CPU, on a subset of ``scripts/torch_export_quality.py``'s dump.

    python scripts/torch_quality_parity.py [--dump build/quality]
        [--max-docs 2000] [--queries 64]

Both services run in this process on the CPU with the same settings
(``scripts/torch_quality_service.py:run``): the JAX app with the shipped
orbax checkpoints, the port's with the converted ones.  Prints one JSON
line: each side's R@10 / MRR@10, and how many queries put their gold
document at the same rank in both (equal up to bf16 rounding of the
encoders' activations, which can swap near-tied candidates).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", default=str(REPO / "build" / "quality"))
    ap.add_argument("--max-docs", type=int, default=2000)
    ap.add_argument("--queries", type=int, default=64)
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location(
        "torch_quality_service", REPO / "scripts" / "torch_quality_service.py")
    tqs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tqs)

    os.environ["RAG_COMPILE_CACHE"] = "0"     # no XLA cache under $HOME
    import jax

    jax.config.update("jax_platforms", "cpu")
    from advanced_rag_tpu.service import create_app as j_create_app
    from advanced_rag_tpu_torch.service import create_app as t_create_app

    dump = Path(args.dump)
    docs, queries = tqs.read_dump(dump, args.max_docs, args.queries)
    port = tqs.run(t_create_app, dump, docs, queries, device="cpu")
    # the JAX app reads the orbax checkpoints the dump was converted from
    orig = tqs.service_env
    tqs.service_env = lambda d: dict(
        orig(d), RAG_EMBEDDER=f"ckpt:{REPO / 'artifacts' / 'biencoder_ckpt'}",
        RAG_RERANKER=f"ckpt:{REPO / 'artifacts' / 'reranker_ckpt'}")
    ref = tqs.run(j_create_app, dump, docs, queries)
    same = sum(a == b for a, b in zip(port["gold_ranks"], ref["gold_ranks"]))
    print(json.dumps({
        "n_docs": len(docs), "n_queries": len(queries),
        "port": {k: port[k] for k in ("recall_at_10", "mrr_at_10", "ingest_chunks")},
        "jax": {k: ref[k] for k in ("recall_at_10", "mrr_at_10", "ingest_chunks")},
        "same_gold_rank": same,
        "differing": [(i, a, b) for i, (a, b) in enumerate(zip(port["gold_ranks"],
                                                                ref["gold_ranks"]))
                      if a != b],
    }), flush=True)


if __name__ == "__main__":
    main()

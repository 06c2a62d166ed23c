#!/usr/bin/env python3
"""R@10 and MRR@10 of the PyTorch port's /retrieve service with the repo's
trained encoders, on the card unless ``--device cpu``.

    python scripts/torch_quality_service.py [--dump build/quality]
        [--device cpu] [--max-docs N] [--queries N] [--out result.json]

Reads what ``scripts/torch_export_quality.py`` dumped: the converted
bi-encoder and reranker, the harvested corpus, the test-half queries and
the service settings of ``scripts/bench_quality_service.py``'s MMR-off
deployment (fused retrieve + rerank, doc-distinct slates, sliding-window
chunking), with a retrieve budget of TIMEOUT_MS so that no slow answer is
degraded to an empty one.  It boots the port's app in this process with
``RAG_EMBEDDER=ckpt:`` and ``RAG_RERANKER=ckpt:``, POSTs the corpus to
/ingest in batches of 256 documents, calls /admin/warmup, and asks each
query through /retrieve with the dumped depth, served over aiohttp's test
server on a localhost socket.  A hit is the gold document among the first
10 distinct doc_ids.  Prints one JSON line: R@10, MRR@10, p50/p99 ms per
query, ingest seconds, the per-query gold rank (0 = missed), and the
card's name and power limit.

``--max-docs`` / ``--queries`` take a subset: the first N queries and a
corpus of their gold documents plus the first other documents up to
``--max-docs``.  ``run`` takes the ``create_app`` to serve, so the same
protocol drives another implementation of the service.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def read_dump(dump: Path, max_docs: int = 0, n_queries: int = 0):
    """(documents, queries) of the dump, cut to the subset described in the
    module docstring."""
    docs = [json.loads(line) for line in open(dump / "corpus.jsonl", encoding="utf-8")]
    queries = [json.loads(line) for line in open(dump / "queries.jsonl", encoding="utf-8")]
    if n_queries:
        queries = queries[:n_queries]
    if max_docs and max_docs < len(docs):
        gold = {q["gold"] for q in queries}
        keep = [d for d in docs if d["doc_id"] in gold]
        for d in docs:
            if len(keep) >= max_docs:
                break
            if d["doc_id"] not in gold:
                keep.append(d)
        order = {d["doc_id"]: i for i, d in enumerate(docs)}
        docs = sorted(keep, key=lambda d: order[d["doc_id"]])
    return docs, queries


#: the retrieve budget: quality, not latency, is measured, so a slow
#: answer must not be degraded to an empty one (the service's default
#: budget is 300 ms; the CPU takes seconds per query)
TIMEOUT_MS = 60_000


def service_env(dump: Path) -> dict:
    cfg = json.loads((dump / "knobs.json").read_text())
    env = dict(cfg["env"], RAG_RETRIEVE_TIMEOUT_MS=str(TIMEOUT_MS))
    env["RAG_EMBEDDER"] = f"ckpt:{(dump / 'biencoder').resolve()}"
    env["RAG_RERANKER"] = f"ckpt:{(dump / 'reranker').resolve()}"
    env["CHAT_DB_PATH"] = str((dump / "chat.db").resolve())
    return env


def gold_rank(results, gold: str) -> int:
    """1-based rank of ``gold`` among the first 10 distinct doc_ids, 0 if
    absent."""
    seen = []
    for r in results:
        if r["doc_id"] not in seen:
            seen.append(r["doc_id"])
    seen = seen[:10]
    return seen.index(gold) + 1 if gold in seen else 0


async def _drive(app, docs, queries, top_k):
    import numpy as np
    from aiohttp.test_utils import TestClient, TestServer

    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        async def post(path, body):
            resp = await client.post(path, json=body)
            if resp.status != 200:
                raise RuntimeError(f"{path} answered {resp.status}: {await resp.text()}")
            return await resp.json()

        t = time.perf_counter()
        chunks = 0
        for i in range(0, len(docs), 256):
            rep = await post("/ingest", {"documents": docs[i:i + 256]})
            chunks += rep["indexed"]
        ingest_s = time.perf_counter() - t
        await post("/admin/warmup", {"top_k": [top_k]})
        ranks, lat, methods = [], [], {}
        for q in queries:
            t = time.perf_counter()
            out = await post("/retrieve", {"query": q["query"], "top_k": top_k})
            lat.append((time.perf_counter() - t) * 1e3)
            if out["results"]:
                m = out["results"][0].get("metadata", {}).get("method", "?")
                methods[m] = methods.get(m, 0) + 1
            ranks.append(gold_rank(out["results"], q["gold"]))
    finally:
        await client.close()
    n = len(queries)
    return {
        "recall_at_10": sum(r > 0 for r in ranks) / n,
        "mrr_at_10": sum(1.0 / r for r in ranks if r) / n,
        "ms_per_query_p50": float(np.percentile(lat, 50)),
        "ms_per_query_p99": float(np.percentile(lat, 99)),
        "ingest_s": ingest_s, "ingest_chunks": chunks,
        "result_methods": methods, "n_docs": len(docs), "n_queries": n,
        "gold_ranks": ranks, "retrieve_timeout_ms": TIMEOUT_MS,
    }


def run(create_app, dump: Path, docs, queries, **app_kw) -> dict:
    """Serve ``create_app(**app_kw)`` with the dump's settings and measure
    it; the process environment is restored afterwards."""
    env = service_env(dump)
    top_k = json.loads((dump / "knobs.json").read_text())["top_k"]
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return asyncio.run(_drive(create_app(**app_kw), docs, queries, top_k))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def card_name_and_power() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", default=str(REPO / "build" / "quality"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--max-docs", type=int, default=0)
    ap.add_argument("--queries", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the result here")
    args = ap.parse_args()
    import torch

    from advanced_rag_tpu_torch.service import create_app

    dump = Path(args.dump)
    docs, queries = read_dump(dump, args.max_docs, args.queries)
    res = run(create_app, dump, docs, queries, device=args.device)
    dev = torch.device(args.device or "cuda")
    res["device"] = (torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu")
    res["card"] = card_name_and_power() if dev.type == "cuda" else None
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()

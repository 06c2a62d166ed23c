#!/usr/bin/env python3
"""The HF tokenizers' ASCII fast paths against their general
per-character paths, in one process on one card's host: WordPiece's
(``models/hf_tokenizer.py``), the byte-level BPE split's (``hf_bpe.py``)
and XLM-R's ``Precompiled`` charsmap's (``hf_unigram.py``).

    python3 scripts/torch_hf_tokenizer_ab.py [--out chiprun_out/hf_tokenizer_ab.json]

Each pair of paths gives the same ids (``tests/test_torch_hf_tokenizer.py``,
``test_torch_hf_bpe.py``, ``test_torch_hf_unigram.py``); the general ones
are forced by replacing ``normalize`` / ``pre_tokenize`` with
``normalize_any`` / ``pre_tokenize_any``, ``hf_bpe.pre_tokenize`` with
``hf_bpe.pre_tokenize_any`` and ``Precompiled.__call__`` with
``Precompiled.normalize_any``.  The script writes ``chip_smoke.py`` phase
13's two MiniLM-L6 checkpoints and its RoBERTa and ELECTRA ones (and
XLM-R's tokenizer files), then, in the order on, off, off, on, each with
fresh tokenizers:

1. "tokenize": phase 13's 20,000 chunks at 128 tokens in batches of 64
   and one rerank batch of 64 pairs at 256 tokens (the mean of 10),
   WordPiece; "tokenize-bpe": the same chunks through RoBERTa's
   tokenizer; "tokenize-unigram": the rerank batch through XLM-R's;
2. "service": phase 13's service run (``hf_service``): the ingest seconds
   of the 20,000 chunks and /retrieve p50 / p99 from 1 and 8 clients,
   cold and warmed; "service-families": its RoBERTa + ELECTRA level, 5,000
   chunks and 32 requests from 1 client.

It prints one line ``AB {json}`` for each run, the card's name and power
limit, and writes every run to ``--out``.  Needs one CUDA card (the service
run launches K1 and K3).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def fast_path(on: bool):
    """The ASCII fast paths as they ship (``on``) or forced off."""
    from advanced_rag_tpu_torch.models import hf_bpe
    from advanced_rag_tpu_torch.models.hf_tokenizer import WordPieceTokenizer as W
    from advanced_rag_tpu_torch.models.hf_unigram import Precompiled as P

    saved = (W.__dict__["normalize"], W.__dict__["pre_tokenize"], hf_bpe.pre_tokenize,
             P.__dict__["__call__"])
    if not on:
        W.normalize = W.normalize_any
        W.pre_tokenize = staticmethod(W.pre_tokenize_any)
        hf_bpe.pre_tokenize = hf_bpe.pre_tokenize_any
        P.__call__ = P.normalize_any
    try:
        yield
    finally:
        W.normalize, W.pre_tokenize, hf_bpe.pre_tokenize, P.__call__ = saved


def tokenize_run(cs, root, texts, queries):
    from advanced_rag_tpu_torch.models.hf_tokenizer import WordPieceTokenizer

    tok = WordPieceTokenizer.from_pretrained(root / "emb")
    t = time.perf_counter()
    for s in range(0, cs.HF_CHUNKS, cs.HF_BATCH):
        tok(texts[s:s + cs.HF_BATCH], max_length=128)
    chunks_s = time.perf_counter() - t
    # phase 13 (d)'s rerank batch: a query with three chunks, 256 tokens
    docs = [" ".join(texts[i:i + 3]) for i in range(1, 3 * cs.HF_BATCH, 3)]
    tok = WordPieceTokenizer.from_pretrained(root / "ce")
    t = time.perf_counter()
    for _ in range(10):
        tok(queries[:cs.HF_BATCH], docs, max_length=256)
    return dict(chunks_s=chunks_s, rerank_batch_ms=(time.perf_counter() - t) / 10 * 1e3)


def family_tokenize_run(cs, root, texts, queries, family):
    from advanced_rag_tpu_torch.models.hf_tokenizer import load_tokenizer

    tok = load_tokenizer(root / family)
    t = time.perf_counter()
    if family == "roberta":
        for s in range(0, cs.HF_CHUNKS, cs.HF_BATCH):
            tok(texts[s:s + cs.HF_BATCH], max_length=128)
        return dict(chunks_s=time.perf_counter() - t)
    docs = [" ".join(texts[i:i + 3]) for i in range(1, 3 * cs.HF_BATCH, 3)]
    for _ in range(10):
        tok(queries[:cs.HF_BATCH], docs, max_length=256)
    return dict(rerank_batch_ms=(time.perf_counter() - t) / 10 * 1e3)


def service_run(cs, root, texts, queries, dev, **level):
    thresholds = gc.get_threshold()
    rec, _ = cs.hf_service(root, texts, queries, dev, **level)
    # /admin/warmup froze the heap and raised gc's thresholds: undo it, so
    # the next run starts as this one did
    gc.unfreeze()
    gc.set_threshold(*thresholds)
    return dict(ingest_s=rec["ingest_s"], retrieve={
        str(k): {m: v[m] for m in ("p50_ms", "p99_ms", "requests_per_s", "answers",
                                   "pipeline_p50_ms")}
        for k, v in rec["retrieve"].items()})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(HERE / "chiprun_out" / "hf_tokenizer_ab.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np

    import chip_smoke as cs

    if args.device == "cuda":
        cs.phase_build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if args.device == "cuda" else None
    texts = cs.synthetic_corpus(cs.HF_CHUNKS, seed=11)
    cs.BUILD_DIR.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="hf-ab-", dir=cs.BUILD_DIR))
    runs = []
    try:
        cs.write_hf_checkpoint(root / "emb", head=False, seed=41)
        cs.write_hf_checkpoint(root / "ce", head=True, seed=43)
        for i, family in enumerate(("roberta", "electra")):
            cs.write_hf_checkpoint(root / family, head=family == "electra",
                                   seed=51 + 2 * i, family=family)
        (root / "xlm-roberta").mkdir()
        cs.xlmr_tokenizer_files(root / "xlm-roberta",
                                cs.HF_FAMILIES["xlm-roberta"]["config"]["vocab_size"])
        rng = np.random.default_rng(47)
        queries = cs.snippet_queries(rng, texts, 8 + (len(cs.HF_CLIENTS) + 1)
                                     * cs.HF_REQUESTS + 32)
        families = dict(emb_dir=root / "roberta", ce_dir=root / "electra",
                        chunks=cs.HF_FAMILY_CHUNKS, clients=(1,),
                        requests=cs.HF_FAMILY_REQUESTS, warm=False,
                        db="service_hf_families.db")
        kinds = {
            "tokenize": lambda: tokenize_run(cs, root, texts, queries),
            "tokenize-bpe": lambda: family_tokenize_run(cs, root, texts, queries, "roberta"),
            "tokenize-unigram": lambda: family_tokenize_run(cs, root, texts, queries,
                                                            "xlm-roberta"),
            "service": lambda: service_run(cs, root, texts, queries, args.device),
            "service-families": lambda: service_run(cs, root, texts, queries, args.device,
                                                    **families),
        }
        for kind, run in kinds.items():
            for on in (True, False, False, True):
                with fast_path(on):
                    rec = run()
                rec.update(kind=kind, fast_path=on)
                runs.append(rec)
                print("AB " + json.dumps(rec), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "runs": runs}, indent=1))
    print(f"card: {smi}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Phase 8's service load from several checkouts of the port, in alternating
runs on one card.

    python3 scripts/torch_service_ab.py --arm parent=build/parent --arm change=. \\
        --order parent,change,change,parent --out build/service_ab_runs

Each ``--arm LABEL=ROOT`` names a checkout of the repository (for example
the parent commit unpacked with ``git archive`` into a git-ignored
directory).  The script first saves, with the checkout it lives in, the two
100,000-chunk indexes that ``chip_smoke.py`` phase 8 serves: the fused
configuration's bf16 manager over phase 4's embedder and the default
configuration's hashing-embedder manager.  Then, for each label of
``--order`` in turn, a fresh process imports that checkout's
``chip_smoke.py`` and port, restores both indexes, and drives each
configuration's app as phase 8 does (``run_service``: /ingest of the service
documents, warm-up, /retrieve from 1, 8 and 32 concurrent clients, the
probes), without phase 8's restart.  Every run prints one line
``AB {json}`` with its client-side p50 / p99 / mean / max latencies and
requests per second at each level, the pipeline's and the manager's p50
inside them, its ingest and a pure-Python probe of the host's speed (a
level whose answers fail is recorded and ends that configuration's run);
the script ends with a table of every run and each label's median, and
writes the runs to ``<out>/runs.jsonl`` and their logs beside it.
``--configs fused`` drives the fused configuration only.  With
``--switch-sets N`` the script then starts the fused app of its own
checkout once and runs N sets of the 1, 8 and 32 client levels, the query
encoding alternating between the C++ path and the Python rule
(``ADVANCED_RAG_TPU_NO_NATIVE``, in the order C++, Python, Python, C++),
each set on fresh queries: the one difference of the two paths on
/retrieve, on one host within minutes.  The checkouts
must serve the same index format and share ``chip_smoke.py``'s phase 8
functions.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
LEVELS = (1, 8, 32)
CONFIGS = ("fused", "default")


def encoders(cs):
    from advanced_rag_tpu_torch.models.cross_encoder import CrossEncoderReranker
    from advanced_rag_tpu_torch.models.embedder import NeuralEmbedder
    from advanced_rag_tpu_torch.models.encoder import (
        SHIPPED_BIENCODER, SHIPPED_BIENCODER_OUT_DIM, SHIPPED_RERANKER)

    embedder = NeuralEmbedder(dim=SHIPPED_BIENCODER_OUT_DIM, config=SHIPPED_BIENCODER,
                              seed=0, device="cuda")
    reranker = CrossEncoderReranker(config=SHIPPED_RERANKER, seed=1, q_len=32,
                                    d_len=216, device="cuda")
    return embedder, reranker


def fused_config(embedder):
    from advanced_rag_tpu_torch.config import PipelineConfig

    # phase 8's fused app: the serving knobs phase 4 ran
    cfg = PipelineConfig(fused_rerank=True, semantic_dtype="bfloat16",
                         rerank_mode="residual", rerank_base="exact",
                         rerank_alpha=0.5, rescore_mix=0.65)
    cfg.semantic_dim = embedder.dim
    return cfg


def prepare(work: Path, configs) -> None:
    """Save the managers of ``configs`` over phase 4's 100k chunks."""
    import torch

    import chip_smoke as cs
    from advanced_rag_tpu_torch.config import PipelineConfig
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.utils.checkpoint import save_index

    cs.phase_build()
    texts = cs.synthetic_corpus(cs.N_CHUNKS, seed=11)
    embedder, _ = encoders(cs)
    for name, cfg, emb in (("fused", fused_config(embedder), embedder),
                           ("default", PipelineConfig(), None)):
        if name not in configs:
            continue
        t = time.perf_counter()
        mgr = MultiIndexManager(cfg, embedder=emb, device="cuda")
        cs.ingest_all(mgr, texts)
        save_index(mgr, work / f"index-{name}")
        torch.cuda.synchronize()
        cs.log(f"prepare: {name} manager over {mgr.store.n_valid()} chunks built and "
               f"saved in {time.perf_counter() - t:.2f}s")
        mgr.close()
        del mgr
        torch.cuda.empty_cache()


def level_record(rec):
    out = {}
    for conc, v in rec["retrieve"].items():
        pl = v["pipeline_p50_ms"]
        out[str(conc)] = {k: v[k] for k in ("p50_ms", "p99_ms", "mean_ms", "max_ms",
                                             "requests_per_s")}
        out[str(conc)].update(pipeline_p50_ms=pl["retrieve"],
                              manager_batch_p50_ms=pl["manager_batch"],
                              queries_per_batch=pl["queries_per_batch"])
    return dict(levels=out, ingest_s=rec["ingest_s"], warm_s=rec["warm_s"],
                probes_found=rec["probes_found"], launches=rec["launches"])


def host_probe_ms() -> float:
    """ms of a fixed pure-Python loop: how fast the host runs Python at
    the start of a run, to read drift across runs."""
    t = time.perf_counter()
    sum(i * i for i in range(2_000_000))
    return (time.perf_counter() - t) * 1e3


def run_arm(label: str, work: Path, configs) -> None:
    """Phase 8's load levels on ``configs``, from this process's
    checkout; prints the AB line (a level whose answers fail is recorded
    under "failed" and ends that configuration's run)."""
    import gc

    import numpy as np
    import torch

    import chip_smoke as cs
    from advanced_rag_tpu_torch.config import PipelineConfig
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.pipeline import AdvancedRAGPipeline, HybridRetriever
    from advanced_rag_tpu_torch.utils.checkpoint import load_index
    from advanced_rag_tpu_torch.utils.db_pool import DatabasePool

    os.environ.update(cs.SERVICE_ENV)
    os.environ.pop("API_KEY", None)
    cs.phase_build()
    texts = cs.synthetic_corpus(cs.N_CHUNKS, seed=11)
    embedder, reranker = encoders(cs)
    docs, probes = cs.service_documents(31, cs.SERVICE_DOCS)
    n_queries = 2 * 32 + cs.SERVICE_SEQUENTIAL + sum(
        c * r for c, r in cs.SERVICE_ROUNDS.items())
    queries = cs.snippet_queries(np.random.default_rng(29), texts, n_queries)
    out = dict(label=label, root=str(Path(cs.__file__).resolve().parent),
               host_probe_ms=host_probe_ms())
    for name in configs:
        cfg = fused_config(embedder) if name == "fused" else PipelineConfig()
        mgr = MultiIndexManager(cfg, embedder=embedder if name == "fused" else None,
                                device="cuda")
        load_index(mgr, work / f"index-{name}")
        torch.cuda.synchronize()
        if name == "fused":
            pipe = AdvancedRAGPipeline(cfg, index_manager=mgr, retriever=HybridRetriever(
                mgr, cfg.retrieval, reranker=reranker))
            # the heap setup phase 8 applies to the fused app (the default
            # one gets it from /admin/warmup)
            gc.collect()
            gc.freeze()
            gc.set_threshold(200_000, 50, 100)
        else:
            pipe = AdvancedRAGPipeline(cfg, index_manager=mgr)
        if pipe._use_fused_path() != (name == "fused"):
            raise AssertionError(f"the {name} app took the wrong path")
        db_path = cs.BUILD_DIR / f"service_ab_{name}.db"
        db_path.unlink(missing_ok=True)
        try:
            rec = cs.run_service(pipe, DatabasePool(sqlite_path=str(db_path)), docs,
                                 probes, queries, warm_route=name == "default",
                                 need=("K1", "K3") if name == "fused" else ("K1",))
        except AssertionError as exc:
            cs.log(f"{name}: {exc}")
            out[name] = dict(failed=str(exc)[:2000])
        else:
            cs.log_service(name, rec)
            if rec["probes_found"] != 8:
                raise AssertionError(f"{name}: probes found {rec['probes_found']}/8")
            out[name] = level_record(rec)
        del pipe, mgr
        torch.cuda.empty_cache()
    print("AB " + json.dumps(out), flush=True)


#: the text path of each set of the in-process comparison: ABBA, so that a
#: drift of the host over the run cancels
SWITCH_PATTERN = ("cpp", "python", "python", "cpp")


def switch_sets(work: Path, n_sets: int) -> None:
    """The fused app of this checkout, started once: after its /ingest and
    warm-up, ``n_sets`` sets of the 1, 8 and 32 client levels, the query
    encoding alternating between the C++ path and the Python rule
    (``ADVANCED_RAG_TPU_NO_NATIVE``) in SWITCH_PATTERN's order, each set on
    fresh queries; prints the SWITCH line."""
    import asyncio
    import gc

    import numpy as np
    import torch
    from aiohttp.test_utils import TestClient, TestServer

    import chip_smoke as cs
    from advanced_rag_tpu_torch import native
    from advanced_rag_tpu_torch.index.manager import MultiIndexManager
    from advanced_rag_tpu_torch.pipeline import AdvancedRAGPipeline, HybridRetriever
    from advanced_rag_tpu_torch.service import create_app
    from advanced_rag_tpu_torch.utils.checkpoint import load_index
    from advanced_rag_tpu_torch.utils.db_pool import DatabasePool

    os.environ.update(cs.SERVICE_ENV)
    os.environ.pop("API_KEY", None)
    cs.phase_build()
    texts = cs.synthetic_corpus(cs.N_CHUNKS, seed=11)
    embedder, reranker = encoders(cs)
    docs, _ = cs.service_documents(31, cs.SERVICE_DOCS)
    rounds = {1: cs.SERVICE_SEQUENTIAL, **cs.SERVICE_ROUNDS}
    per_set = sum(c * r for c, r in rounds.items())
    queries = cs.snippet_queries(np.random.default_rng(37), texts,
                                 2 * 32 + per_set * n_sets)
    cfg = fused_config(embedder)
    mgr = MultiIndexManager(cfg, embedder=embedder, device="cuda")
    load_index(mgr, work / "index-fused")
    pipe = AdvancedRAGPipeline(cfg, index_manager=mgr, retriever=HybridRetriever(
        mgr, cfg.retrieval, reranker=reranker))
    gc.collect()
    gc.freeze()
    gc.set_threshold(200_000, 50, 100)
    batches = []
    cs.timed_manager(mgr, batches)
    db_path = cs.BUILD_DIR / "service_ab_switch.db"
    db_path.unlink(missing_ok=True)

    async def level(driver, conc, qs):
        async def client(mine):
            out = []
            for q in mine:
                t0 = time.perf_counter()
                status, payload = await driver.retrieve(q)
                ok = status == 200 and bool(payload.get("results"))
                out.append(((time.perf_counter() - t0) * 1e3,
                            None if ok else f"{status}: {str(payload)[:200]}"))
            return out
        n = len(qs) // conc
        b0 = len(batches)
        t0 = time.perf_counter()
        got = await asyncio.gather(*[client(qs[i * n:(i + 1) * n]) for i in range(conc)])
        wall = time.perf_counter() - t0
        ms = np.asarray([m for c in got for m, _ in c])
        return dict(p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)),
                    mean_ms=float(ms.mean()), requests_per_s=ms.size / wall,
                    failed=sum(bad is not None for c in got for _, bad in c),
                    failures=sorted({bad for c in got for _, bad in c if bad})[:3],
                    manager_batch_p50_ms=float(np.percentile(
                        [b[0] for b in batches[b0:]] or [float("nan")], 50)))

    async def go():
        client = TestClient(TestServer(create_app(cfg, pipeline=pipe,
                                                  db=DatabasePool(sqlite_path=str(db_path)))))
        await client.start_server()
        driver = cs.HttpDriver(client)
        try:
            for s0 in range(0, len(docs), 64):
                await driver.ingest(docs[s0:s0 + 64])
            for conc in LEVELS:
                await level(driver, conc, queries[:2 * conc])
            sets, qi = [], 2 * 32
            for i in range(n_sets):
                path = SWITCH_PATTERN[i % len(SWITCH_PATTERN)]
                if path == "python":
                    os.environ[native.SWITCH] = "1"
                try:
                    rec = dict(path=path, levels={})
                    for conc in LEVELS:
                        k = conc * rounds[conc]
                        rec["levels"][str(conc)] = await level(driver, conc,
                                                               queries[qi:qi + k])
                        qi += k
                finally:
                    os.environ.pop(native.SWITCH, None)
                cs.log(f"set {i} ({path}): " + "; ".join(
                    f"{c} clients p50 {v['p50_ms']:.2f} p99 {v['p99_ms']:.2f} batch "
                    f"{v['manager_batch_p50_ms']:.2f} failed {v['failed']}"
                    for c, v in rec["levels"].items()))
                sets.append(rec)
                if any(v["failed"] for v in rec["levels"].values()):
                    # a shed request opens the service's breaker, which then
                    # refuses every later one: the sets end here
                    cs.log(f"set {i} had failed answers: the sets end")
                    break
            return sets
        finally:
            await client.close()

    sets = asyncio.run(go())
    torch.cuda.synchronize()
    print("SWITCH " + json.dumps(dict(host_probe_ms=host_probe_ms(), sets=sets)), flush=True)


def switch_summary(sets) -> str:
    """Each path's medians and the C++ minus Python differences of the
    adjacent pairs (sets 2j and 2j + 1), over the pairs whose sets both
    answered every request."""
    pairs = [(a, b) for a, b in zip(sets[0::2], sets[1::2])
             if not any(v["failed"] for s in (a, b) for v in s["levels"].values())]
    sets = [s for pair in pairs for s in pair]
    lines = [f"switch: {len(pairs)} complete pairs of sets"]
    for conc in map(str, LEVELS):
        for key in ("p50_ms", "p99_ms", "manager_batch_p50_ms"):
            by = {p: [s["levels"][conc][key] for s in sets if s["path"] == p]
                  for p in ("cpp", "python")}
            diffs = [(a if a["path"] == "cpp" else b)["levels"][conc][key]
                     - (b if a["path"] == "cpp" else a)["levels"][conc][key]
                     for a, b in pairs]
            lines.append(
                f"switch {conc:>2} clients {key}: C++ median {statistics.median(by['cpp']):.2f}"
                f", Python median {statistics.median(by['python']):.2f}; C++ minus Python "
                f"per adjacent pair " + ", ".join(f"{d:+.2f}" for d in diffs))
    return "\n".join(lines)


def child(root: Path, args) -> list:
    return [sys.executable, str(Path(__file__).resolve()), "--child-root", str(root), *args]


def summary(runs, configs) -> str:
    lines = ["host probe ms per run: " + "; ".join(
        f"{r['label']} {r['host_probe_ms']:.1f}" for r in runs)]
    for name in configs:
        failed = [f"{r['step']} ({r[name]['failed'][:160]})" for r in runs
                  if "failed" in r[name]]
        if failed:
            lines.append(f"{name}: runs whose answers failed: " + "; ".join(failed))
        done = [r for r in runs if "levels" in r[name]]
        for conc in map(str, LEVELS):
            lines.append(f"{name} {conc:>2} clients, p50 / p99 ms per run: " + "; ".join(
                f"{r['label']} {r[name]['levels'][conc]['p50_ms']:.2f} / "
                f"{r[name]['levels'][conc]['p99_ms']:.2f}" for r in done))
            by = {}
            for r in done:
                by.setdefault(r["label"], []).append(r[name]["levels"][conc])
            lines.append("    median per label: " + "; ".join(
                f"{label} p50 {statistics.median(v['p50_ms'] for v in vals):.2f}, p99 "
                f"{statistics.median(v['p99_ms'] for v in vals):.2f}, manager batch "
                f"{statistics.median(v['manager_batch_p50_ms'] for v in vals):.2f} "
                f"(n={len(vals)})" for label, vals in by.items()))
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arm", action="append", default=[], metavar="LABEL=ROOT")
    ap.add_argument("--order", default="", help="comma-separated labels, run in turn")
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma-separated service configurations (fused, default)")
    ap.add_argument("--out", default=str(HERE / "build" / "service_ab_runs"))
    ap.add_argument("--work", default=str(HERE / "build" / "service_ab"))
    ap.add_argument("--arm-timeout", type=float, default=600.0)
    ap.add_argument("--child-root", help=argparse.SUPPRESS)
    ap.add_argument("--switch-sets", type=int, default=0,
                    help="then, in one process of this checkout, this many sets of the "
                         "fused levels, the query encoding alternating C++ / Python")
    ap.add_argument("--child", choices=("prepare", "arm", "switch"), help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    args = ap.parse_args()
    work = Path(args.work).resolve()
    configs = [c for c in args.configs.split(",") if c]
    if not configs or set(configs) - set(CONFIGS):
        raise SystemExit(f"--configs takes {CONFIGS}")
    if args.child:
        sys.path.insert(0, args.child_root)
        os.chdir(args.child_root)
        if args.child == "prepare":
            prepare(work, configs)
        elif args.child == "switch":
            switch_sets(work, args.switch_sets)
        else:
            run_arm(args.label, work, configs)
        return

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: the script needs a CUDA card")
    arms = dict(a.split("=", 1) for a in args.arm)
    roots = {k: Path(v).resolve() for k, v in arms.items()}
    for label, root in roots.items():
        if not (root / "chip_smoke.py").is_file():
            raise SystemExit(f"--arm {label}: {root} holds no chip_smoke.py")
    order = [x for x in args.order.split(",") if x]
    unknown = sorted(set(order) - set(roots))
    if not (order or args.switch_sets) or unknown:
        raise SystemExit(f"--order names no run or unknown labels {unknown}")
    if args.switch_sets and "fused" not in configs:
        raise SystemExit("--switch-sets drives the fused configuration")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    work.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    t = time.perf_counter()
    steps = [("prepare", HERE, ["--child", "prepare"])] + [
        (f"{i:02d}-{label}", roots[label], ["--child", "arm", "--label", label])
        for i, label in enumerate(order)]
    if args.switch_sets:
        steps.append(("switch", HERE, ["--child", "switch", "--switch-sets",
                                       str(args.switch_sets)]))
    runs, switch = [], None
    (out / "runs.jsonl").unlink(missing_ok=True)
    for step, root, extra in steps:
        log = out / f"{step}.log"
        t0 = time.perf_counter()
        with open(log, "w") as f:
            proc = subprocess.run(child(root, [*extra, "--work", str(work),
                                               "--configs", args.configs]), stdout=f,
                                  stderr=subprocess.STDOUT, timeout=args.arm_timeout)
        text = log.read_text()
        if proc.returncode != 0:
            print(text[-4000:], flush=True)
            raise SystemExit(f"{step} failed with exit code {proc.returncode}")
        ab = [json.loads(line[3:]) for line in text.splitlines() if line.startswith("AB ")]
        switch = next((json.loads(line[7:]) for line in text.splitlines()
                       if line.startswith("SWITCH ")), switch)
        if ab:
            runs.append(dict(ab[0], step=step, smi=smi.strip(),
                             seconds=time.perf_counter() - t0))
            with open(out / "runs.jsonl", "a") as f:
                f.write(json.dumps(runs[-1]) + "\n")
        print(f"[{time.perf_counter() - t:8.2f}s] {step}: {time.perf_counter() - t0:.1f}s",
              flush=True)
    if runs:
        print(summary(runs, configs), flush=True)
    if switch is not None:
        (out / "switch.json").write_text(json.dumps(dict(switch, smi=smi.strip())))
        failed = sum(v["failed"] for s in switch["sets"] for v in s["levels"].values())
        print(f"switch: {len(switch['sets'])} sets run, {failed} failed answers", flush=True)
        print(switch_summary(switch["sets"]), flush=True)


if __name__ == "__main__":
    main()

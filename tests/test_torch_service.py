"""The port's aiohttp service against the JAX package's, both driven
through aiohttp's test client in one process.

Both apps serve the same corpus with converted weights, in the two
configurations the service starts in (tests/test_torch_pipeline.py builds
the pipelines): the default one (hashing embedder with the JAX
projection, bf16 tier, host passthrough rerank) and the fused one (f32
encoders and cross-encoder, f32 tier).  Bounds: ``/ingest`` answers
equal; ``/retrieve`` chunk ids equal where the reference scores are
distinct (as sets within runs of equal scores), scores within the
tolerances of tests/test_torch_pipeline.py.  Validation, auth, rate
limits and the breaker answer with the JAX app's status codes; the paths
whose modules are not ported yet answer 501 or raise at startup.
"""

import json

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from advanced_rag_tpu.service import create_app as j_create_app
from advanced_rag_tpu.utils.db_pool import DatabasePool as JPool
from advanced_rag_tpu.utils.rate_limit import RateLimiter as JLimiter
from advanced_rag_tpu_torch.config import PipelineConfig
from advanced_rag_tpu_torch.service import app as t_app
from advanced_rag_tpu_torch.service import create_app as t_create_app
from advanced_rag_tpu_torch.service import metrics as t_metrics
from advanced_rag_tpu_torch.utils.db_pool import DatabasePool as TPool
from advanced_rag_tpu_torch.utils.rate_limit import RateLimiter as TLimiter
from test_torch_pipeline import (QUERIES, SCORE_TOL, assert_same_ranking, build,
                                 corpus)

DOCS = [{k: v for k, v in d.items() if k != "metadata"} for d in corpus()[:12]]


@pytest.fixture(autouse=True)
def service_env(monkeypatch):
    for name in ("API_KEY", "RAG_EMBEDDER", "RAG_RERANKER", "RAG_CHECKPOINT_DIR",
                 "RAG_FUSED_E2E", "RAG_FUSED_TOKEN_LEN"):
        monkeypatch.delenv(name, raising=False)
    # the JAX app would turn on a persistent XLA cache under $HOME, and
    # /admin/warmup would freeze the test process's garbage collector
    monkeypatch.setenv("RAG_COMPILE_CACHE", "0")
    monkeypatch.setenv("RAG_GC_TUNE", "0")


async def start(app):
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


async def both_clients(kind, tmp_path):
    jpipe, tpipe, _ = build(kind, ingest=False)
    jc = await start(j_create_app(pipeline=jpipe,
                                  db=JPool(sqlite_path=str(tmp_path / "j.db"))))
    tc = await start(t_create_app(pipeline=tpipe,
                                  db=TPool(sqlite_path=str(tmp_path / "t.db"))))
    return jc, tc


async def post_json(client, path, body, **kw):
    resp = await client.post(path, json=body, **kw)
    return resp.status, await resp.json()


def ranked(payload):
    return ([r["chunk_id"] for r in payload["results"]],
            np.asarray([r["score"] for r in payload["results"]], np.float64))


@pytest.mark.parametrize("kind", ["default-bf16", "fused-f32"])
async def test_both_apps_serve_the_same_ids(loop, tmp_path, kind):
    jc, tc = await both_clients(kind, tmp_path)
    try:
        for c in (jc, tc):
            resp = await c.get("/healthz")
            assert resp.status == 200
            health = await resp.json()
            assert health["status"] == "ok"
        assert health["dependencies"]["devices"] == ["cpu"]
        js, jrep = await post_json(jc, "/ingest", {"documents": DOCS})
        ts, trep = await post_json(tc, "/ingest", {"documents": DOCS})
        assert ts == js == 200
        jrep.pop("elapsed_ms"), trep.pop("elapsed_ms")
        assert trep == jrep and trep["indexed"] > len(DOCS)
        for q in QUERIES:
            for body in ({"query": q}, {"query": q, "top_k": 6}):
                js, jout = await post_json(jc, "/retrieve", body)
                ts, tout = await post_json(tc, "/retrieve", body)
                assert ts == js == 200
                assert tout["results"], body
                assert_same_ranking(ranked(tout), ranked(jout), *SCORE_TOL[kind])
                assert tout["rewritten_query"] == jout["rewritten_query"]
                assert set(tout) == set(jout)
                assert tout["metrics"] == pytest.approx(jout["metrics"], rel=1e-4,
                                                        abs=1e-6)
        for path in ("/perf", "/admin/index/stats"):
            jr, tr = await jc.get(path), await tc.get(path)
            assert tr.status == jr.status == 200
            assert set(await tr.json()) == set(await jr.json())
    finally:
        await jc.close()
        await tc.close()


def statuses_of(kind):
    """The (method, path, body, headers) sequence of one scenario."""
    big = {"documents": [{"content": "x" * 1_100_000}]}
    return {
        "validation": [("post", "/retrieve", {"query": ""}, None),
                       ("post", "/retrieve", {"query": "x" * 5000}, None),
                       ("post", "/ingest", {"documents": []}, None),
                       ("post", "/ingest", big, None),
                       ("post", "/ingest", {"documents": ["kernel scan rows"]}, None),
                       ("post", "/retrieve", {"query": "kernel",
                                              "filters": {"bogus": 1}}, None)],
        "auth": [("post", "/retrieve", {"query": "kernel"}, None),
                 ("post", "/retrieve", {"query": "kernel"}, {"X-API-Key": "k"}),
                 ("post", "/ingest", {"documents": ["a b c"]}, {"X-API-Key": "no"})],
        "rate-limit": [("post", "/ingest", {"documents": ["tiny doc here"]}, None)] * 4,
        "breaker": [("post", "/retrieve", {"query": "kernel"}, None)],
    }[kind]


@pytest.mark.parametrize("scenario", ["validation", "auth", "rate-limit", "breaker"])
async def test_error_paths_answer_as_the_jax_app(loop, tmp_path, monkeypatch,
                                                 scenario):
    """400 / 413 validation, 401 auth, 429 rate limit, 503 breaker: the
    port answers every step with the JAX app's status."""
    if scenario == "auth":
        monkeypatch.setenv("API_KEY", "k")
    jc, tc = await both_clients("default-bf16", tmp_path)
    try:
        for c, limiter in ((jc, JLimiter), (tc, TLimiter)):
            state = c.app["state"]
            if scenario == "rate-limit":
                state.limiters["ingest"] = limiter(limit=2, window_seconds=60)
            if scenario == "breaker":
                for _ in range(state.breaker.config.failure_threshold):
                    state.breaker.record_failure()
        got = {}
        for name, c in (("jax", jc), ("port", tc)):
            got[name] = []
            for method, path, body, headers in statuses_of(scenario):
                resp = await getattr(c, method)(path, json=body, headers=headers)
                got[name].append(resp.status)
        assert got["port"] == got["jax"]
        expect = {"validation": [400, 400, 400, 413, 200, 400], "auth": [401, 200, 401],
                  "rate-limit": [200, 200, 429, 429], "breaker": [503]}[scenario]
        assert got["port"] == expect
    finally:
        await jc.close()
        await tc.close()


async def test_ported_routes_answer_with_the_jax_apps_keys(loop, tmp_path):
    """/chat, /chat/stream (SSE), sessions, /feedback, /eval/run, /drift
    and /etl/run are host code over the pipeline: the port answers each
    with the JAX app's status and keys; /admin/warmup warms the port."""
    (tmp_path / "etl").mkdir()
    (tmp_path / "etl" / "a.txt").write_text("Kernel scans fuse dense ranks.")
    jc, tc = await both_clients("default-bf16", tmp_path)
    try:
        calls = [("post", "/chat", {"message": "how does the kernel scan?",
                                    "session_id": "s1"}),
                 ("get", "/chat/sessions", None),
                 ("get", "/chat/history/s1", None),
                 ("post", "/feedback", {"session_id": "s1", "positive": True}),
                 ("post", "/eval/run", {"cases": [{"query": QUERIES[0],
                                                   "relevant_ids": ["x"]}]}),
                 ("post", "/drift", {"queries": QUERIES[:2]}),
                 ("post", "/etl/run", {"root": str(tmp_path / "etl")}),
                 ("delete", "/chat/clear/s1", None)]
        for c in (jc, tc):
            assert (await c.post("/ingest", json={"documents": DOCS})).status == 200
        for method, path, body in calls:
            out = []
            for c in (jc, tc):
                resp = await getattr(c, method)(path, json=body)
                out.append((resp.status, set(await resp.json())))
            assert out[1] == out[0], path
            assert out[1][0] == 200, path
        events = []
        for c in (jc, tc):
            resp = await c.get("/chat/stream", params={"message": "kernel scan"})
            text = await resp.text()
            events.append([line for line in text.splitlines()
                           if line.startswith("event:")])
            assert resp.status == 200
        assert events[1][-1] == events[0][-1] == "event: done"
        # /admin/warmup on the port alone (the JAX app's answer has the
        # same keys; its warm-up compiles every program shape, seconds here)
        status, body = await post_json(tc, "/admin/warmup", {"top_k": [5]})
        assert status == 200 and set(body) == {"warmed_top_k", "seconds"}
        assert tc.app["state"].pipeline.is_warm(QUERIES[0], 5)
    finally:
        await jc.close()
        await tc.close()


async def test_not_ported_routes_answer_501(loop, tmp_path):
    jc, tc = await both_clients("default-bf16", tmp_path)
    try:
        for path, item in (("/admin/index/checkpoint", 2),
                           ("/admin/index/maintain", 3)):
            status, body = await post_json(tc, path, {"action": "save",
                                                      "dir": str(tmp_path)})
            assert status == 501
            assert f"queue A item {item}" in body["error"]
    finally:
        await jc.close()
        await tc.close()


@pytest.mark.parametrize("env,item", [
    (("RAG_EMBEDDER", "ckpt:/nowhere"), 2),
    (("RAG_RERANKER", "ckpt:/nowhere"), 2),
    (("RAG_RERANKER", "hf:/nowhere"), 6),
    (("RAG_CHECKPOINT_DIR", None), 2),
])
def test_not_ported_startup_paths_raise(tmp_path, monkeypatch, env, item):
    name, value = env
    if value is None:                      # a saved index to restore
        (tmp_path / "manifest.json").write_text(json.dumps({"size": 1}))
        value = str(tmp_path)
    monkeypatch.setenv(name, value)
    monkeypatch.setenv("CHAT_DB_PATH", str(tmp_path / "c.db"))
    with pytest.raises(NotImplementedError, match=f"queue A item {item}"):
        t_create_app(PipelineConfig(), device="cpu")


async def test_metrics_with_both_services_loaded(loop, tmp_path, monkeypatch):
    """The port's collectors live in its own registry, so both services
    load in one process; each /metrics counts its own requests, and
    without prometheus the port answers 501 as the JAX app does."""
    jc, tc = await both_clients("default-bf16", tmp_path)
    line = 'rag_api_requests_total{endpoint="/healthz",status="200"} '

    async def healthz_count(c):
        resp = await c.get("/metrics")
        assert resp.status == 200
        text = await resp.text()
        found = [ln for ln in text.splitlines() if ln.startswith(line)]
        return (float(found[0][len(line):]) if found else 0.0), text

    try:
        t0, _ = await healthz_count(tc)
        j0, _ = await healthz_count(jc)
        for _ in range(3):
            await tc.get("/healthz")
        await jc.get("/healthz")
        t1, ttext = await healthz_count(tc)
        j1, _ = await healthz_count(jc)
        assert (t1 - t0, j1 - j0) == (3.0, 1.0)
        for name in ("rag_retrieve_latency_ms", "rag_shed_total",
                     "rag_sla_compliance_ratio", "rag_hallucination_risk"):
            assert name in ttext
        assert t_metrics.REGISTRY is not None
        monkeypatch.setattr(t_app, "_PROM", False)
        assert (await tc.get("/metrics")).status == 501
    finally:
        await jc.close()
        await tc.close()

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
limits and the breaker answer with the JAX app's status codes.  The index
lifecycle: ``/admin/index/checkpoint`` (400, 403, 409 and 200, each
directory loading in the other package's app) and
``/admin/index/maintain`` answer as the JAX app does; a boot with
``RAG_CHECKPOINT_DIR`` restores the saved corpus (and raises where the JAX
app would start empty); ``RAG_EMBEDDER=ckpt:`` / ``RAG_RERANKER=ckpt:``
boot from the JAX app's orbax checkpoints converted by
``scripts/torch_convert_checkpoints.py``; ``RAG_RERANKER=hf:`` is in
tests/test_torch_hf_service.py.
"""

import json

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from advanced_rag_tpu.service import create_app as j_create_app
from advanced_rag_tpu.utils.db_pool import DatabasePool as JPool
from advanced_rag_tpu.utils.rate_limit import RateLimiter as JLimiter
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
                 "RAG_CHECKPOINT_ROOT", "RAG_FUSED_E2E", "RAG_FUSED_TOKEN_LEN"):
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


async def checkpoint(client, body):
    return await post_json(client, "/admin/index/checkpoint", body)


async def test_checkpoint_route_answers_as_the_jax_app(loop, tmp_path, monkeypatch):
    """400 without a dir, 403 outside RAG_CHECKPOINT_ROOT, 200 for a save,
    409 for a load into a manager that is not empty, 400 for an unknown
    action; then each app's directory loads in a fresh app of the other
    package, which serves the saving app's chunk ids."""
    root = tmp_path / "root"
    jc, tc = await both_clients("default-bf16", tmp_path)
    fresh = []
    try:
        for c in (jc, tc):
            assert (await c.post("/ingest", json={"documents": DOCS})).status == 200
        steps = [({}, None), ({"dir": str(tmp_path / "elsewhere")}, None),
                 ({"dir": str(root / "{}"), "action": "save"}, str(root)),
                 ({"dir": str(root / "{}"), "action": "load"}, str(root)),
                 ({"dir": str(root / "{}"), "action": "drop"}, str(root))]
        got = {"jax": [], "port": []}
        for body, root_env in steps:
            if root_env:
                monkeypatch.setenv("RAG_CHECKPOINT_ROOT", root_env)
            for name, c in (("jax", jc), ("port", tc)):
                b = {k: v.format(name) for k, v in body.items()}
                status, out = await checkpoint(c, b)
                got[name].append((status, sorted(out)))
        assert got["port"] == got["jax"]
        assert [s for s, _ in got["port"]] == [400, 403, 200, 409, 400]
        # the 409 left the port's index serving; the JAX app's rollback of
        # the refused load emptied its own (a reference fault, not ported)
        n_rows = tc.app["state"].pipeline.index_manager.store.size
        assert n_rows == json.loads((root / "jax" / "manifest.json").read_text())["size"]
        assert jc.app["state"].pipeline.index_manager.store.size == 0
        status, _ = await post_json(tc, "/retrieve", {"query": QUERIES[0]})
        assert status == 200 and _["results"]
        # each directory in the other package's fresh app
        jpipe, tpipe, _ = build("default-bf16", ingest=False)
        jf = await start(j_create_app(pipeline=jpipe,
                                      db=JPool(sqlite_path=str(tmp_path / "jf.db"))))
        tf = await start(t_create_app(pipeline=tpipe,
                                      db=TPool(sqlite_path=str(tmp_path / "tf.db"))))
        fresh = [jf, tf]
        assert await checkpoint(jf, {"dir": str(root / "port"), "action": "load"}) == \
            (200, {"loaded": True, "rows": n_rows})
        assert await checkpoint(tf, {"dir": str(root / "jax"), "action": "load"}) == \
            (200, {"loaded": True, "rows": n_rows})
        for q in QUERIES[:3]:
            _, want = await post_json(tc, "/retrieve", {"query": q})
            _, got_j = await post_json(jf, "/retrieve", {"query": q})
            _, got_t = await post_json(tf, "/retrieve", {"query": q})
            assert ranked(got_j)[0] == ranked(got_t)[0] == ranked(want)[0]
    finally:
        for c in [jc, tc, *fresh]:
            await c.close()


async def test_failed_checkpoint_load_is_rolled_back(loop, tmp_path, monkeypatch):
    """A load that fails midway (a dense file missing) answers 409 and
    leaves the manager empty, so the retry after the repair answers 200."""
    monkeypatch.setenv("RAG_CHECKPOINT_ROOT", str(tmp_path))
    jc, tc = await both_clients("default-bf16", tmp_path)
    jpipe, tpipe, _ = build("default-bf16", ingest=False)
    tf = await start(t_create_app(pipeline=tpipe,
                                  db=TPool(sqlite_path=str(tmp_path / "tf.db"))))
    try:
        assert (await tc.post("/ingest", json={"documents": DOCS})).status == 200
        ckpt = tmp_path / "ckpt"
        status, saved = await checkpoint(tc, {"dir": str(ckpt)})
        assert status == 200 and saved["saved"]
        (ckpt / "dense_semantic.npy").rename(tmp_path / "held.npy")
        status, out = await checkpoint(tf, {"dir": str(ckpt), "action": "load"})
        assert status == 409 and "dense_semantic.npy" in out["error"]
        mgr = tf.app["state"].pipeline.index_manager
        assert mgr.store.size == 0 and not mgr.store.chunk_ids
        (tmp_path / "held.npy").rename(ckpt / "dense_semantic.npy")
        assert await checkpoint(tf, {"dir": str(ckpt), "action": "load"}) == \
            (200, {"loaded": True, "rows": saved["rows"]})
    finally:
        for c in (jc, tc, tf):
            await c.close()


async def test_maintain_route_answers_as_the_jax_app(loop, tmp_path):
    """An idle pass, then a forced IVF build with nprobe tuning: the same
    keys and actions as the JAX app."""
    jc, tc = await both_clients("default-bf16", tmp_path)
    try:
        out = []
        for c in (jc, tc):
            assert (await c.post("/ingest", json={"documents": DOCS})).status == 200
            idle = await post_json(c, "/admin/index/maintain", {})
            built = await post_json(c, "/admin/index/maintain",
                                    {"build_ivf": True, "tune_recall": 0.9})
            out.append((idle, built))
        (j_idle, j_built), (t_idle, t_built) = out
        assert t_idle == j_idle == (200, {"ivf_rebuilt": False})
        assert t_built[0] == j_built[0] == 200
        assert set(t_built[1]) == set(j_built[1]) == {
            "ivf_built", "ivf_rebuilt", "nprobe", "tuned_recall"}
        assert t_built[1]["ivf_built"] is True and t_built[1]["tuned_recall"] >= 0.9
        assert tc.app["state"].pipeline.index_manager.semantic.has_ivf
        status, _ = await post_json(tc, "/retrieve", {"query": QUERIES[0]})
        assert status == 200
    finally:
        await jc.close()
        await tc.close()


async def test_boot_restores_the_saved_index(loop, tmp_path, monkeypatch):
    """RAG_CHECKPOINT_DIR at boot: both apps restore the port's save and
    answer with its chunk ids; a restore that fails raises in the port
    (rolled back) where the JAX app logs and starts empty."""
    jc, tc = await both_clients("default-bf16", tmp_path)
    booted = []
    try:
        assert (await tc.post("/ingest", json={"documents": DOCS})).status == 200
        monkeypatch.setenv("RAG_CHECKPOINT_ROOT", str(tmp_path))
        status, saved = await checkpoint(tc, {"dir": str(tmp_path / "ckpt")})
        assert status == 200
        monkeypatch.setenv("RAG_CHECKPOINT_DIR", str(tmp_path / "ckpt"))
        for make, pool, i in ((j_create_app, JPool, 0), (t_create_app, TPool, 1)):
            jpipe, tpipe, _ = build("default-bf16", ingest=False)
            app = make(pipeline=(jpipe, tpipe)[i],
                       db=pool(sqlite_path=str(tmp_path / f"b{i}.db")))
            booted.append(await start(app))
            assert app["state"].pipeline.index_manager.store.size == saved["rows"]
        for q in QUERIES[:3]:
            _, want = await post_json(tc, "/retrieve", {"query": q})
            for c in booted:
                _, got = await post_json(c, "/retrieve", {"query": q})
                assert ranked(got)[0] == ranked(want)[0]
        (tmp_path / "ckpt" / "records.jsonl").write_text("{not json\n")
        jpipe, tpipe, _ = build("default-bf16", ingest=False)
        japp = j_create_app(pipeline=jpipe, db=JPool(sqlite_path=str(tmp_path / "j2.db")))
        assert japp["state"].pipeline.index_manager.store.size == 0
        with pytest.raises(ValueError):
            t_create_app(pipeline=tpipe, db=TPool(sqlite_path=str(tmp_path / "t2.db")))
        mgr = tpipe.index_manager
        assert mgr.store.size == 0 and not mgr.store.chunk_ids
    finally:
        for c in [jc, tc, *booted]:
            await c.close()


def save_checkpoint_pair(tmp_path):
    """Small random bi-encoder and reranker saved by the JAX package
    (orbax), and the same two converted to the port's format."""
    import dataclasses

    from advanced_rag_tpu.models.encoder import EncoderConfig as JEncoderConfig
    from advanced_rag_tpu.models.encoder import init_bi_encoder, init_cross_encoder
    from advanced_rag_tpu.train.loop import save_biencoder as j_save_biencoder
    from advanced_rag_tpu.train.rerank import save_reranker as j_save_reranker
    from test_torch_encoder import convert_script

    geom = dict(vocab_size=2048, hidden_dim=32, num_layers=1, num_heads=4,
                mlp_dim=64, max_len=96)
    bcfg = JEncoderConfig(**geom, lexical_pool=True)
    ccfg = dataclasses.replace(bcfg, lexical_pool=False, lexical_match=True)
    _, bparams = init_bi_encoder(bcfg, out_dim=24, seed=3)
    _, cparams = init_cross_encoder(ccfg, seed=4)
    j_save_biencoder(bparams, bcfg, 24, tmp_path / "orbax_bi")
    j_save_reranker(cparams, ccfg, tmp_path / "orbax_ce", q_len=32, d_len=60)
    conv = convert_script()
    conv.convert_biencoder(tmp_path / "orbax_bi", tmp_path / "port_bi")
    conv.convert_reranker(tmp_path / "orbax_ce", tmp_path / "port_ce")


async def test_ckpt_embedder_and_reranker_boots(loop, tmp_path, monkeypatch):
    """RAG_FUSED_E2E=1 with RAG_EMBEDDER=ckpt: and RAG_RERANKER=ckpt:: the
    port boots from the converted directories, the JAX app from its orbax
    ones.  The embedder's width, the reranker's pair layout and the token
    table (raised to the checkpoint's d_len 60) agree; embeddings agree
    within the bf16 tolerance of tests/test_torch_encoder.py (the saved
    geometry runs bf16 activations) and /retrieve's ids overlap >= 0.8 on
    average, as tests/test_torch_manager.py asks of bf16 encoders."""
    save_checkpoint_pair(tmp_path)
    monkeypatch.setenv("RAG_FUSED_E2E", "1")
    apps = []
    try:
        for make, pool, kind, tag in ((j_create_app, JPool, "orbax", "j"),
                                      (t_create_app, TPool, "port", "t")):
            monkeypatch.setenv("RAG_EMBEDDER", f"ckpt:{tmp_path / (kind + '_bi')}")
            monkeypatch.setenv("RAG_RERANKER", f"ckpt:{tmp_path / (kind + '_ce')}")
            kw = {} if tag == "j" else {"device": "cpu"}
            apps.append(await start(make(db=pool(sqlite_path=str(tmp_path / f"{tag}.db")),
                                         **kw)))
        jst, tst = (c.app["state"] for c in apps)
        jm, tm = jst.pipeline.index_manager, tst.pipeline.index_manager
        assert tm.embedder.dim == jm.embedder.dim == 24 == tst.config.semantic_dim
        assert tm.token_table.max_len == jm.token_table.max_len == 60
        trr, jrr = tst.pipeline.retriever.reranker, jst.pipeline.retriever.reranker
        assert (trr.q_len, trr.d_len) == (jrr.q_len, jrr.d_len) == (32, 60)
        assert tst._preloaded_reranker is trr
        np.testing.assert_allclose(tm.embedder.encode(QUERIES),
                                   jm.embedder.encode(QUERIES), rtol=0, atol=2e-2)
        for c in apps:
            assert (await c.post("/ingest", json={"documents": DOCS})).status == 200
        overlap = []
        for q in QUERIES:
            (js, jout), (ts, tout) = [await post_json(c, "/retrieve", {"query": q})
                                      for c in apps]
            assert js == ts == 200 and tout["results"]
            jids, tids = ranked(jout)[0], ranked(tout)[0]
            overlap.append(len(set(jids) & set(tids)) / len(jids))
        assert np.mean(overlap) >= 0.8
    finally:
        for c in apps:
            await c.close()


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

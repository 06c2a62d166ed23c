"""``RAG_RERANKER=hf:<dir>`` in both services: the port's app boots with
the HF cross-encoder wired into its pipeline, as the JAX app does
(``advanced_rag_tpu/service/app.py:333-338``), and ``/retrieve`` answers
the JAX app's chunk ids.  Bounds: ids equal where the reference scores are
distinct, as sets within ties; scores within tests/test_torch_hf_models.py's
``KEY_TOL`` (the host rerank key).  A path that is not a checkpoint raises
at boot in both."""

import pytest

from advanced_rag_tpu.models.hf_cross_encoder import HFCrossEncoder as JCross
from advanced_rag_tpu.service import create_app as j_create_app
from advanced_rag_tpu.utils.db_pool import DatabasePool as JPool
from advanced_rag_tpu_torch.config import PipelineConfig
from advanced_rag_tpu_torch.models.hf_cross_encoder import HFCrossEncoder
from advanced_rag_tpu_torch.service import create_app as t_create_app
from advanced_rag_tpu_torch.utils.db_pool import DatabasePool as TPool
from test_torch_hf_models import KEY_TOL, write_checkpoint
from test_torch_pipeline import QUERIES, assert_same_ranking, build
from test_torch_service import DOCS, post_json, ranked, service_env, start  # noqa: F401


async def test_hf_reranker_boots_and_serves_the_jax_ids(loop, tmp_path, monkeypatch):
    write_checkpoint(tmp_path / "ce", head=True, seed=1)
    monkeypatch.setenv("RAG_RERANKER", f"hf:{tmp_path / 'ce'}")
    jpipe, tpipe, _ = build("default-bf16", ingest=False)
    jc = await start(j_create_app(pipeline=jpipe,
                                  db=JPool(sqlite_path=str(tmp_path / "j.db"))))
    tc = await start(t_create_app(pipeline=tpipe,
                                  db=TPool(sqlite_path=str(tmp_path / "t.db"))))
    try:
        assert isinstance(jc.app["state"].pipeline.retriever.reranker, JCross)
        rr = tc.app["state"].pipeline.retriever.reranker
        assert isinstance(rr, HFCrossEncoder) and rr.device.type == "cpu"
        assert rr.max_len == 256
        js, _ = await post_json(jc, "/ingest", {"documents": DOCS})
        ts, _ = await post_json(tc, "/ingest", {"documents": DOCS})
        assert ts == js == 200
        reranked = 0
        for q in QUERIES:
            for body in ({"query": q}, {"query": q, "top_k": 6}):
                js, jout = await post_json(jc, "/retrieve", body)
                ts, tout = await post_json(tc, "/retrieve", body)
                assert ts == js == 200
                assert tout["results"], body
                assert_same_ranking(ranked(tout), ranked(jout), *KEY_TOL)
                reranked += all("rerank_score" in r["metadata"]
                                for r in tout["results"])
        assert reranked >= 2
    finally:
        await jc.close()
        await tc.close()


def test_hf_reranker_of_a_missing_path_raises_at_boot(tmp_path, monkeypatch):
    """JAX's raises from huggingface_hub (a ValueError for this path shape,
    an OSError for others); the port's FileNotFoundError names the path."""
    monkeypatch.setenv("RAG_RERANKER", f"hf:{tmp_path / 'nowhere' / 'ckpt'}")
    monkeypatch.setenv("CHAT_DB_PATH", str(tmp_path / "c.db"))
    jpipe, tpipe, _ = build("default-bf16", ingest=False)
    with pytest.raises((ValueError, OSError)):
        j_create_app(pipeline=jpipe, db=JPool(sqlite_path=str(tmp_path / "j.db")))
    with pytest.raises(FileNotFoundError, match="nowhere/ckpt is not a checkpoint"):
        t_create_app(pipeline=tpipe, db=TPool(sqlite_path=str(tmp_path / "t.db")))
    with pytest.raises(FileNotFoundError, match="not a checkpoint directory"):
        t_create_app(PipelineConfig(), device="cpu")

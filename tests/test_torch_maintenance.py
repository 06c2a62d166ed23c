"""The manager's maintenance pass in the port against the JAX package's,
with ``IndexConstants.IVF_AUTO_THRESHOLD`` lowered to 180 rows in both.

Both managers embed with the JAX hashing projection carried over and
ingest the same chunks (tests/test_torch_checkpoint.py's corpus), so the
tick takes the same decisions: the first IVF build behind the recall
guardrail, a blocked build that restores the exact scan, the rebuild once
the appended tail passes 0.2 of the rows, and postings compaction past 10%
dead postings (the PQ tier's first PQ + IVF-PQ build is held against JAX's
in tests/test_torch_ivfpq.py).  k-means centroids agree across
the frameworks only to about rtol 1e-5, so after a build the JAX
partitions are carried over (``ivf_partitions_from_numpy``) before the
searches are compared; the guardrail recall is compared within 0.05.
Search bounds as in tests/test_torch_checkpoint.py, except after the
postings exist: their sort rung orders exactly tied BM25 scores otherwise
than JAX's (ROADMAP.md § C parity notes), which moves a tied pair's RRF
shares, so there the top-10 chunk ids must overlap >= 0.9 on average, as
tests/test_torch_search.py asks of the bf16 compare scan.
"""

import threading
import time

import numpy as np
import pytest
import torch

import advanced_rag_tpu.utils.constants as jconst
import advanced_rag_tpu_torch.utils.constants as tconst
from advanced_rag_tpu.config import PipelineConfig as JConfig
from advanced_rag_tpu.index.corpus import ChunkRecord as JRecord
from advanced_rag_tpu.index.manager import MultiIndexManager as JManager
from advanced_rag_tpu_torch.config import PipelineConfig
from advanced_rag_tpu_torch.index.corpus import ChunkRecord
from advanced_rag_tpu_torch.index.manager import MultiIndexManager
from advanced_rag_tpu_torch.models.convert import (hashing_from_numpy,
                                                   ivf_partitions_from_numpy)
from advanced_rag_tpu_torch.utils.exceptions import IndexingError

from test_torch_checkpoint import QUERIES, TEXTS, hits, records
from test_torch_pipeline import assert_same_ranking

THRESHOLD = 180


@pytest.fixture(autouse=True)
def small_threshold(monkeypatch):
    for mod in (jconst, tconst):
        monkeypatch.setattr(mod.IndexConstants, "IVF_AUTO_THRESHOLD", THRESHOLD)


def managers(tier="bfloat16", n=THRESHOLD, target=None):
    jmgr = JManager(JConfig(semantic_dtype=tier))
    tmgr = MultiIndexManager(
        PipelineConfig(semantic_dtype=tier),
        embedder=hashing_from_numpy(np.asarray(jmgr.embedder._proj), device="cpu"),
        device="cpu")
    for mgr in (jmgr, tmgr):
        if target is not None:
            mgr.semantic.config.demote_recall_target = target
    ingest(jmgr, tmgr, 0, n)
    return jmgr, tmgr


def ingest(jmgr, tmgr, lo, hi):
    jmgr.index_chunks(records(JRecord)[lo:hi])
    tmgr.index_chunks(records(ChunkRecord)[lo:hi])


def carry_ivf(jmgr, tmgr):
    tsem, jsem = tmgr.semantic, jmgr.semantic
    tsem._ivf = ivf_partitions_from_numpy(jsem._ivf, device="cpu")
    tsem._ivf_size = jsem._ivf_size
    tsem.config.nprobe = jsem.config.nprobe


def assert_same_hybrid(tmgr, jmgr):
    for g, w in zip(tmgr.hybrid_search_batch_sync(QUERIES, 10),
                    jmgr.hybrid_search_batch_sync(QUERIES, 10)):
        assert g
        assert_same_ranking(hits(g), hits(w), 1e-6, 0.0)


def test_below_the_threshold_the_tick_does_nothing():
    jmgr, tmgr = managers(n=THRESHOLD - 1)
    assert tmgr.maintenance_tick() == jmgr.maintenance_tick() == {"ivf_rebuilt": False}
    assert not tmgr.semantic.has_ivf


def test_first_build_then_tail_rebuild_match_jax():
    jmgr, tmgr = managers()
    got, want = tmgr.maintenance_tick(), jmgr.maintenance_tick()
    assert got.pop("demotion_recall") == pytest.approx(want.pop("demotion_recall"),
                                                       abs=0.05)
    assert got == want == {"ivf_rebuilt": True, "ivf_rows": THRESHOLD}
    assert tmgr.semantic.has_ivf and tmgr.semantic._ivf_size == THRESHOLD
    assert tmgr.semantic._ivf.centroids.shape == jmgr.semantic._ivf.centroids.shape
    carry_ivf(jmgr, tmgr)
    assert_same_hybrid(tmgr, jmgr)
    # nothing to do while the tail is small
    ingest(jmgr, tmgr, THRESHOLD, THRESHOLD + 20)
    assert tmgr.maintenance_tick() == jmgr.maintenance_tick() == {"ivf_rebuilt": False}
    # a tail above 0.2 of the rows: rebuilt with the same nlist
    ingest(jmgr, tmgr, THRESHOLD + 20, len(TEXTS))
    assert tmgr.semantic.ivf_needs_rebuild and jmgr.semantic.ivf_needs_rebuild
    nlist = tmgr.semantic._ivf.centroids.shape[0]
    got, want = tmgr.maintenance_tick(), jmgr.maintenance_tick()
    assert got == want == {"ivf_rebuilt": True, "ivf_rows": len(TEXTS)}
    assert tmgr.semantic._ivf.centroids.shape[0] == nlist
    assert tmgr.semantic.ivf_tail_rows == 0
    carry_ivf(jmgr, tmgr)
    assert_same_hybrid(tmgr, jmgr)


def test_guardrail_blocks_the_build_and_restores_the_exact_scan():
    jmgr, tmgr = managers(target=1.01)
    nprobe = tmgr.semantic.config.nprobe
    got, want = tmgr.maintenance_tick(), jmgr.maintenance_tick()
    assert got == want
    assert got["ivf_rebuilt"] is False and got["demotion_blocked"]["tier"] == "ivf"
    assert got["demotion_blocked"]["target"] == 1.01
    assert not tmgr.semantic.has_ivf and tmgr.semantic._ivf_size == 0
    assert tmgr.semantic.config.nprobe == nprobe
    assert_same_hybrid(tmgr, jmgr)


def test_postings_compaction_matches_jax():
    jmgr, tmgr = managers(n=len(TEXTS))
    for mgr in (jmgr, tmgr):
        mgr.semantic.config.demote_recall_target = 0.0      # no guardrail probe
        mgr.sparse.build_postings()
    deleted = sum(tmgr.delete_by_filter({"doc_id": f"d{d}"}) for d in range(0, 60, 6))
    assert deleted == sum(jmgr.delete_by_filter({"doc_id": f"d{d}"})
                          for d in range(0, 60, 6)) == 40
    assert tmgr.sparse.postings_stale_fraction > 0.10
    got, want = tmgr.maintenance_tick(), jmgr.maintenance_tick()
    assert got["postings_compacted"] is want["postings_compacted"] is True
    assert tmgr.sparse.postings_stale == 0
    np.testing.assert_array_equal(tmgr.sparse.post_rows.numpy(),
                                  np.asarray(jmgr.sparse.post_rows))
    assert tmgr.sparse.post_avg_len == pytest.approx(jmgr.sparse.post_avg_len, rel=1e-6)
    assert not (np.isin(tmgr.sparse.post_rows.numpy(),
                        np.arange(0, 240, 1)[~tmgr.store._host_valid[:240]])).any()
    carry_ivf(jmgr, tmgr)
    got = tmgr.hybrid_search_batch_sync(QUERIES, 10)
    want = jmgr.hybrid_search_batch_sync(QUERIES, 10)
    assert np.mean([len(set(hits(g)[0]) & set(hits(w)[0])) / len(w)
                    for g, w in zip(got, want)]) >= 0.9
    # compacted once: the next tick leaves the postings alone
    assert "postings_compacted" not in tmgr.maintenance_tick()


@pytest.mark.parametrize("exc,propagates", [(ValueError, False), (IndexingError, False),
                                            (RuntimeError, True)])
def test_guardrail_catches_only_the_probes_data_errors(monkeypatch, exc, propagates):
    """A data error of the recall probe is recorded and the build kept, as
    in JAX; anything else (a kernel launch failing on the card) reaches the
    caller instead of passing as a healthy tick."""
    _, tmgr = managers()

    def probe(*args, **kwargs):
        raise exc("probe failed")

    monkeypatch.setattr(tmgr.semantic, "tune_nprobe", probe)
    if propagates:
        with pytest.raises(exc, match="probe failed"):
            tmgr.maintenance_tick()
    else:
        actions = tmgr.maintenance_tick()
        assert actions["demotion_probe_error"] == "probe failed"
        assert actions["ivf_rebuilt"] is True and tmgr.semantic.has_ivf


def test_start_stop_and_close_the_maintenance_thread(monkeypatch):
    _, tmgr = managers(n=THRESHOLD - 1)
    ticks = []
    done = threading.Event()

    def tick():
        ticks.append(torch.is_inference_mode_enabled())
        if len(ticks) >= 2:
            done.set()
        if len(ticks) == 1:
            raise RuntimeError("a failed tick keeps the loop alive")
        return {}

    monkeypatch.setattr(tmgr, "maintenance_tick", tick)
    tmgr.start_maintenance(interval_s=0.01)
    thread = tmgr._maint_thread
    tmgr.start_maintenance(interval_s=0.01)         # idempotent
    assert tmgr._maint_thread is thread and thread.daemon
    assert done.wait(10.0)
    tmgr.stop_maintenance()
    assert tmgr._maint_thread is None and not thread.is_alive()
    assert ticks[:2] == [True, True]                 # under inference_mode
    n = len(ticks)
    time.sleep(0.05)
    assert len(ticks) == n
    tmgr.start_maintenance(interval_s=0.01)
    thread = tmgr._maint_thread
    tmgr.close()
    assert tmgr._maint_thread is None and not thread.is_alive()
    with pytest.raises(IndexingError, match="closed"):
        tmgr.hybrid_search_batch_sync(QUERIES, 3)

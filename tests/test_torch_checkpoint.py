"""Index checkpoints across the two packages: a directory saved by the JAX
package's ``utils/checkpoint.py`` loads in the port's, and one saved by the
port loads in the JAX package's, and both then search alike.

Managers embed with the JAX hashing projections carried over
(``hashing_from_numpy``: the semantic one and the domain family's), or,
for the fused token table, with f32 encoders of converted weights
(tests/test_torch_manager.py builds them).  The saving manager deletes a
document first, so the validity column and the df bookkeeping travel too.

Bounds: the restored manager's hybrid (``hybrid_search_batch_sync``) and
single-family (``search_sync``) results equal the saving manager's in the
other package: chunk ids equal where the reference scores are distinct
(as sets within runs of equal scores), scores within rtol 1e-6 (hybrid:
RRF) and 1e-5 / atol 1e-6 (``search_sync``: f32 dots, the SQ8 and PQ
tiers' exact re-scores).  Fused results (f32 models) must give the same
chunk ids.  What the port writes back from a loaded JAX checkpoint equals
what JAX wrote (manifest but ``saved_at``, every array of the npz files
and .npy files, records.jsonl byte for byte).
"""

import json
import shutil

import numpy as np
import pytest

from advanced_rag_tpu.config import IndexType as JIndexType
from advanced_rag_tpu.config import PipelineConfig as JConfig
from advanced_rag_tpu.index.corpus import ChunkRecord as JRecord
from advanced_rag_tpu.index.manager import MultiIndexManager as JManager
from advanced_rag_tpu.utils import checkpoint as jckpt
from advanced_rag_tpu_torch.config import IndexType, PipelineConfig
from advanced_rag_tpu_torch.index.corpus import ChunkRecord
from advanced_rag_tpu_torch.index.manager import MultiIndexManager
from advanced_rag_tpu_torch.models.convert import hashing_from_numpy
from advanced_rag_tpu_torch.utils import checkpoint as tckpt

from test_torch_manager import models_and_managers, served
from test_torch_pipeline import assert_same_ranking

TIERS = ["bfloat16", "float32", "int8", "pq", "domain"]


def corpus(n=240, seed=0):
    """n chunks of 8-30 words from a seeded 300-word vocabulary."""
    rng = np.random.default_rng(seed)
    vocab = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"),
                                size=int(rng.integers(3, 9)))) for _ in range(300)]
    p = 1.0 / (np.arange(300) + 5.0)
    p /= p.sum()
    return [" ".join(rng.choice(vocab, size=int(rng.integers(8, 31)), p=p))
            for _ in range(n)]


TEXTS = corpus()
QUERIES = [" ".join(t.split()[2:9]) for t in TEXTS[::37]]


def records(cls):
    return [cls(chunk_id=f"c{i}", doc_id=f"d{i // 4}", content=t, chunk_index=i % 4)
            for i, t in enumerate(TEXTS)]


def empty_managers(tier):
    """Empty JAX and port managers of ``tier`` ("domain": bf16 plus the
    domain family) that embed alike."""
    domain = tier == "domain"
    dtype = "bfloat16" if domain else tier
    jmgr = JManager(JConfig(semantic_dtype=dtype), enable_domain=domain)
    tmgr = MultiIndexManager(
        PipelineConfig(semantic_dtype=dtype),
        embedder=hashing_from_numpy(np.asarray(jmgr.embedder._proj), device="cpu"),
        domain_embedder=(hashing_from_numpy(np.asarray(jmgr.domain_embedder._proj),
                                            device="cpu") if domain else None),
        enable_domain=domain, device="cpu")
    return jmgr, tmgr


def fill(mgr, record_cls, tier):
    rep = mgr.index_chunks(records(record_cls))
    assert rep["indexed"] == len(TEXTS) and not rep["errors"]
    assert mgr.delete_by_filter({"doc_id": "d5"}) == 4
    if tier == "pq":
        assert mgr.build_semantic(pq=True) == {"pq_built": True}


def hits(out):
    return [h["chunk_id"] for h in out], np.asarray([h["score"] for h in out])


def assert_same_search(got_mgr, want_mgr, domain):
    g = got_mgr.hybrid_search_batch_sync(QUERIES, 10, domain_weight=0.3)
    w = want_mgr.hybrid_search_batch_sync(QUERIES, 10, domain_weight=0.3)
    assert len(g) == len(w) == len(QUERIES)
    for a, b in zip(g, w):
        assert len(a) == 10
        assert_same_ranking(hits(a), hits(b), 1e-6, 0.0)
    families = ["semantic", "sparse"] + (["domain"] if domain else [])
    for fam in families:
        for q in QUERIES:
            a = got_mgr.search_sync(IndexType(fam), q, 8)
            b = want_mgr.search_sync(JIndexType(fam), q, 8)
            assert a, (fam, q)
            assert_same_ranking(hits(a), hits(b), 1e-5, 1e-6)
            assert "c20" not in hits(a)[0]          # deleted before the save


def assert_same_files(got_dir, want_dir):
    gm = json.loads((got_dir / "manifest.json").read_text())
    wm = json.loads((want_dir / "manifest.json").read_text())
    gm.pop("saved_at"), wm.pop("saved_at")
    assert gm == wm
    assert sorted(p.name for p in got_dir.iterdir()) == \
        sorted(p.name for p in want_dir.iterdir())
    for name in ("columns.npz", "sparse.npz"):
        g, w = np.load(got_dir / name), np.load(want_dir / name)
        assert sorted(g.files) == sorted(w.files)
        for key in w.files:
            assert g[key].dtype == w[key].dtype, (name, key)
            np.testing.assert_array_equal(g[key], w[key])
    for path in want_dir.glob("*.npy"):
        g, w = np.load(got_dir / path.name), np.load(path)
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert (got_dir / "records.jsonl").read_bytes() == \
        (want_dir / "records.jsonl").read_bytes()


@pytest.mark.parametrize("tier", TIERS)
def test_jax_checkpoint_loads_in_the_port(tmp_path, tier):
    jmgr, tmgr = empty_managers(tier)
    fill(jmgr, JRecord, tier)
    want = jckpt.save_index(jmgr, tmp_path / "jax")
    got = tckpt.load_index(tmgr, tmp_path / "jax")
    assert got == want
    assert tmgr.store.n_valid() == jmgr.store.n_valid() == len(TEXTS) - 4
    assert tmgr.semantic.has_pq == (tier == "pq")
    assert tmgr.get_collection_stats()["semantic"]["rows"] == len(TEXTS)
    assert_same_search(tmgr, jmgr, tier == "domain")
    # written back by the port: the same bytes JAX wrote
    tckpt.save_index(tmgr, tmp_path / "port")
    assert_same_files(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("tier", TIERS)
def test_port_checkpoint_loads_in_jax(tmp_path, tier):
    jmgr, tmgr = empty_managers(tier)
    fill(tmgr, ChunkRecord, tier)
    manifest = tckpt.save_index(tmgr, tmp_path / "port")
    assert manifest["dense"]["semantic"]["dtype"] == \
        ("bfloat16" if tier == "domain" else tier)
    assert ("domain" in manifest["dense"]) == (tier == "domain")
    jckpt.load_index(jmgr, tmp_path / "port")
    assert jmgr.semantic.has_pq == (tier == "pq")
    assert_same_search(tmgr, jmgr, tier == "domain")
    # and back into a fresh port manager: the same search as the saver
    _, again = empty_managers(tier)
    again.embedder, again.domain_embedder = tmgr.embedder, tmgr.domain_embedder
    again._sem_ns, again._dom_ns = tmgr._sem_ns, tmgr._dom_ns
    tckpt.load_index(again, tmp_path / "port")
    for a, b in zip(again.hybrid_search_batch_sync(QUERIES, 10),
                    tmgr.hybrid_search_batch_sync(QUERIES, 10)):
        assert hits(a)[0] == hits(b)[0]
        np.testing.assert_array_equal(hits(a)[1], hits(b)[1])


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_fused_checkpoint_rebuilds_the_token_table(tmp_path, direction):
    """The fused manager's token table is re-tokenized from the restored
    contents, equal to the JAX package's rebuild; fused results equal."""
    jmgr, jrr, tmgr, trr = models_and_managers("float32")
    docs = TEXTS[:96]
    if direction == "jax->port":
        jmgr.index_chunks([JRecord(chunk_id=f"c{i}", doc_id=f"d{i // 3}", content=t)
                           for i, t in enumerate(docs)])
        jckpt.save_index(jmgr, tmp_path)
        tckpt.load_index(tmgr, tmp_path)
        rebuilt = JManager(jmgr.config, embedder=jmgr.embedder)
        jckpt.load_index(rebuilt, tmp_path)
        jtok = np.asarray(rebuilt.token_table.tokens)
    else:
        tmgr.index_chunks([ChunkRecord(chunk_id=f"c{i}", doc_id=f"d{i // 3}", content=t)
                           for i, t in enumerate(docs)])
        before = tmgr.token_table.tokens[: len(docs)].clone()
        tckpt.save_index(tmgr, tmp_path)
        jckpt.load_index(jmgr, tmp_path)
        jtok = np.asarray(jmgr.token_table.tokens)
        tmgr.reset_state()
        tckpt.load_index(tmgr, tmp_path)
        assert (tmgr.token_table.tokens[: len(docs)] == before).all()
    ttok = tmgr.token_table.tokens.numpy()
    assert tmgr.token_table.size == len(docs)
    np.testing.assert_array_equal(ttok[: len(docs)], jtok[: len(docs)])
    assert (ttok[len(docs):] == 0).all()
    queries = [" ".join(t.split()[:6]) for t in docs[::12]]
    got, _ = served(tmgr, trr, queries)
    want, _ = served(jmgr, jrr, queries)
    assert got == want


def test_load_refuses_a_manager_that_is_not_fresh(tmp_path):
    _, tmgr = empty_managers("bfloat16")
    fill(tmgr, ChunkRecord, "bfloat16")
    tckpt.save_index(tmgr, tmp_path)
    with pytest.raises(ValueError, match="fresh manager"):
        tckpt.load_index(tmgr, tmp_path)


def test_torn_load_rolls_back_and_a_retry_succeeds(tmp_path):
    _, saver = empty_managers("int8")
    fill(saver, ChunkRecord, "int8")
    tckpt.save_index(saver, tmp_path / "ckpt")
    _, tmgr = empty_managers("int8")
    tmgr.embedder, tmgr._sem_ns = saver.embedder, saver._sem_ns
    shutil.move(tmp_path / "ckpt" / "dense_semantic.npy", tmp_path / "held.npy")
    with pytest.raises(FileNotFoundError):
        tckpt.load_index(tmgr, tmp_path / "ckpt")
    assert tmgr.store.size == len(TEXTS)            # torn: the records are in
    with pytest.raises(ValueError, match="fresh manager"):
        tckpt.load_index(tmgr, tmp_path / "ckpt")
    tmgr.reset_state()
    assert tmgr.store.size == tmgr.semantic.size == tmgr.sparse.size == 0
    shutil.move(tmp_path / "held.npy", tmp_path / "ckpt" / "dense_semantic.npy")
    tckpt.load_index(tmgr, tmp_path / "ckpt")
    for a, b in zip(tmgr.hybrid_search_batch_sync(QUERIES, 10),
                    saver.hybrid_search_batch_sync(QUERIES, 10)):
        assert hits(a)[0] == hits(b)[0]
        np.testing.assert_array_equal(hits(a)[1], hits(b)[1])


def test_unknown_format_and_dtype_raise(tmp_path):
    _, saver = empty_managers("float32")
    fill(saver, ChunkRecord, "float32")
    tckpt.save_index(saver, tmp_path)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    for key, value, match in (("format_version", 2, "unsupported checkpoint format"),
                              ("dtype", "float16", "unknown dtype")):
        bad = json.loads(json.dumps(manifest))
        if key == "dtype":
            bad["dense"]["semantic"]["dtype"] = value
        else:
            bad[key] = value
        (tmp_path / "manifest.json").write_text(json.dumps(bad))
        _, tmgr = empty_managers("float32")
        with pytest.raises(ValueError, match=match):
            tckpt.load_index(tmgr, tmp_path)
        assert tmgr.store.size == 0


def test_fused_restore_keeps_a_forgotten_row_out(tmp_path):
    """A right-to-forget delete saves the row's content as null.  The JAX
    package's restore then fails in the token table's re-tokenization (a
    fault of the reference, not ported); the port tokenizes the row as
    empty text, and the row stays deleted."""
    jmgr, _, tmgr, trr = models_and_managers("float32")
    tmgr.index_chunks([ChunkRecord(chunk_id=f"c{i}", doc_id=f"d{i // 3}", content=t)
                       for i, t in enumerate(TEXTS[:48])])
    assert tmgr.delete_by_filter({"doc_id": "d2"}, forget_content=True) == 3
    tckpt.save_index(tmgr, tmp_path)
    with pytest.raises(AttributeError):
        jckpt.load_index(jmgr, tmp_path)
    _, _, fresh, _ = models_and_managers("float32")
    tckpt.load_index(fresh, tmp_path)
    assert fresh.store.contents[6] is None and not fresh.store._host_valid[6]
    empty = fresh.token_table._encode([""])[0]
    np.testing.assert_array_equal(fresh.token_table.tokens[6].numpy(), empty)
    queries = [" ".join(t.split()[:6]) for t in TEXTS[6:9]]
    got, _ = served(fresh, trr, queries)
    assert got == served(tmgr, trr, queries)[0]
    assert not {"c6", "c7", "c8"} & {c for ids in got for c in ids}

"""The port's HF checkpoint models (``models/hf_embedder.py``,
``models/hf_cross_encoder.py``) against the JAX package's, on the same
checkpoint directory.

The checkpoints are tiny ``BertConfig`` models written by transformers'
PyTorch classes (``save_pretrained``), once as ``model.safetensors`` and
once as ``pytorch_model.bin``, with every weight (LayerNorm included)
moved off its initial value.  JAX's classes read them through Flax's
``from_pretrained``: for ``model.safetensors`` its first call reads that
file (Flax reads PyTorch safetensors without ``from_pt``); for
``pytorch_model.bin`` alone the first call raises ``OSError`` and the
``from_pt=True`` branch (``hf_embedder.py:40-43``,
``hf_cross_encoder.py:44-47``) converts the pickle.  The port reads the
same directory with ``models/hf_checkpoint.py``.

Bounds: f32 embeddings and scores within 1e-5 absolute; bf16 embeddings
(unit vectors) within 1e-2 absolute, bf16 scores within 2e-2 of max(1,
|score|) (bf16 keeps 8 bits of mantissa; the two frameworks round the
attention and GELU at other points).  Pipelines: chunk ids equal where the
reference scores are distinct, as sets within ties; scores within 1e-3
relative and 1e-4 absolute (``KEY_TOL``): the host rerank key z-scores the
exact rescores of the 7-16 candidates, whose cosines can lie within 1e-3 of
each other, so the embedders' 1e-7 differences come out multiplied by the
inverse spread (9.3e-5 at the worst of these queries, with the query
embedding, the exact rescores and the scores of the cross-encoder each
within 2.4e-7).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import BertConfig, BertForSequenceClassification, BertModel
from transformers import BertTokenizerFast

from advanced_rag_tpu.config import PipelineConfig as JConfig
from advanced_rag_tpu.index.manager import MultiIndexManager as JManager
from advanced_rag_tpu.models.hf_cross_encoder import HFCrossEncoder as JCross
from advanced_rag_tpu.models.hf_embedder import HFEmbedder as JEmbedder
from advanced_rag_tpu.pipeline import AdvancedRAGPipeline as JPipeline
from advanced_rag_tpu.utils.cache import EmbeddingCache
from advanced_rag_tpu_torch.config import PipelineConfig
from advanced_rag_tpu_torch.index.manager import MultiIndexManager
from advanced_rag_tpu_torch.models import HFEmbedder
from advanced_rag_tpu_torch.models.hf_cross_encoder import HFCrossEncoder
from advanced_rag_tpu_torch.pipeline import AdvancedRAGPipeline
from test_torch_pipeline import (QUERIES, WORDS, assert_same_ranking, corpus,
                                 neural_models, ranked)

REPO = Path(__file__).resolve().parents[1]
D = 32
F32_TOL = 1e-5
KEY_TOL = (1e-3, 1e-4)
TEXTS = ["dense sparse fusion rank", "How does the KERNEL scan the cache?",
         "", "café naïve résumé", "东京 tokens", "a" * 101,
         "rerank bucket hash table slot weight drift metric " * 6,
         "[MASK] query [SEP] index", "latency, recall & drift!"] * 3


def vocab():
    chars = [chr(c) for c in range(0x21, 0x7F)] + list("éïü东京")
    out = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(set(WORDS))
    out += [c for c in chars if c not in out]
    out += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"]
    return out


def write_checkpoint(path, *, head: bool, fmt: str = "safetensors", seed: int = 0):
    """A tiny BERT (2 layers, 32 wide, 4 heads, FFN 64, 256 positions) and
    its tokenizer, written by transformers' PyTorch classes; returns the
    model."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.txt").write_text("\n".join(vocab()) + "\n", encoding="utf-8")
    BertTokenizerFast(vocab_file=str(path / "vocab.txt")).save_pretrained(path)
    cfg = BertConfig(vocab_size=len(vocab()), hidden_size=D, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=64,
                     max_position_embeddings=256, num_labels=1)
    torch.manual_seed(seed)
    model = (BertForSequenceClassification if head else BertModel)(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    model.save_pretrained(path, safe_serialization=fmt == "safetensors")
    return model


@pytest.fixture(scope="module", params=["safetensors", "bin"])
def checkpoints(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"hf-{request.param}")
    write_checkpoint(root / "emb", head=False, fmt=request.param)
    write_checkpoint(root / "ce", head=True, fmt=request.param, seed=1)
    weights = {"safetensors": "model.safetensors", "bin": "pytorch_model.bin"}
    for d in ("emb", "ce"):
        assert (root / d / weights[request.param]).exists()
        assert not (root / d / "flax_model.msgpack").exists()
    return root


def test_embedder_matches_jax(checkpoints):
    jemb = JEmbedder(str(checkpoints / "emb"), max_len=48, max_batch=8)
    emb = HFEmbedder(checkpoints / "emb", max_len=48, max_batch=8, device="cpu")
    assert emb.dim == jemb.dim == D
    want, got = jemb.encode(TEXTS), emb.encode(TEXTS)
    assert got.shape == (len(TEXTS), D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=0, atol=1e-5)
    assert emb.encode([]).shape == (0, D) == jemb.encode([]).shape
    dev = emb.encode_device(TEXTS[:3])
    assert isinstance(dev, torch.Tensor) and dev.shape == (3, D)
    np.testing.assert_allclose(dev.numpy(), want[:3], rtol=0, atol=F32_TOL)


def test_embedder_bf16_matches_jax(checkpoints):
    jemb = JEmbedder(str(checkpoints / "emb"), max_len=48, max_batch=8,
                     dtype=jnp.bfloat16)
    emb = HFEmbedder(checkpoints / "emb", max_len=48, max_batch=8,
                     dtype=torch.bfloat16, device="cpu")
    got = emb.encode(TEXTS)
    np.testing.assert_allclose(got, jemb.encode(TEXTS), rtol=0, atol=1e-2)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=0, atol=1e-5)


PAIRS_Q = TEXTS[:10] + ["dense " * 40, "q"]
PAIRS_D = TEXTS[::-1][:10] + ["sparse fusion " * 5, "kernel " * 60]


def test_cross_encoder_matches_jax(checkpoints):
    """20+ pairs at max_batch 8 (three batches, the last padded), one pair
    whose query alone passes max_len and one whose document does."""
    jce = JCross(str(checkpoints / "ce"), max_len=48, max_batch=8)
    ce = HFCrossEncoder(checkpoints / "ce", max_len=48, max_batch=8, device="cpu")
    qs, ds = PAIRS_Q * 2, PAIRS_D * 2
    assert len(qs) > 2 * ce.max_batch
    want, got = jce.score_pairs(qs, ds), ce.score_pairs(qs, ds)
    assert got.shape == (len(qs),) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert np.ptp(want) > 1e-3                      # the scores are not flat
    np.testing.assert_allclose(ce.score("dense sparse", TEXTS),
                               jce.score("dense sparse", TEXTS), rtol=0, atol=F32_TOL)
    assert ce.score("q", []).shape == (0,)
    with pytest.raises(ValueError, match="align"):
        ce.score_pairs(["a"], [])


def test_cross_encoder_bf16_matches_jax(checkpoints):
    jce = JCross(str(checkpoints / "ce"), max_len=48, max_batch=8, dtype=jnp.bfloat16)
    ce = HFCrossEncoder(checkpoints / "ce", max_len=48, max_batch=8,
                        dtype=torch.bfloat16, device="cpu")
    want, got = jce.score_pairs(PAIRS_Q, PAIRS_D), ce.score_pairs(PAIRS_Q, PAIRS_D)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    write_checkpoint(root / "emb", head=False)
    write_checkpoint(root / "ce", head=True, seed=1)
    return root


def test_entry_points_take_the_card_unless_told(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HFEmbedder(ckpt / "emb")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HFCrossEncoder(ckpt / "ce")


def test_deliberate_differences(ckpt):
    """Each instance has its own cache namespace (JAX's class has none, so
    two of its checkpoints of one width share "semantic:"); a max_len past
    the position table raises (JAX's gather clamps)."""
    a = HFEmbedder(ckpt / "emb", device="cpu")
    b = HFEmbedder(ckpt / "emb", device="cpu")
    cfg = PipelineConfig(semantic_dim=D)
    ns = {MultiIndexManager(cfg, embedder=e, device="cpu")._sem_ns for e in (a, b)}
    assert len(ns) == 2 and all(n.startswith(f"semantic:hf{D}-") for n in ns)
    jcfg = JConfig(semantic_dim=D)
    assert JManager(jcfg, embedder=JEmbedder(str(ckpt / "emb")))._sem_ns == "semantic:"
    with pytest.raises(ValueError, match="positions"):
        HFEmbedder(ckpt / "emb", max_len=257, device="cpu")
    with pytest.raises(ValueError, match="positions"):
        HFCrossEncoder(ckpt / "ce", max_len=512, device="cpu")


def configs(fused=False):
    out = []
    for cls in (JConfig, PipelineConfig):
        cfg = cls(fused_rerank=fused, semantic_dtype="float32", chunk_base_size=24,
                  chunk_max_size=48, chunk_min_size=8)
        cfg.semantic_dim = D
        cfg.retrieval.timeout_seconds = 60.0
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def hf_pipelines(ckpt):
    """Both packages' pipelines on one corpus: the HF embedder in the
    manager, the HF cross-encoder as the retriever's reranker."""
    jcfg, tcfg = configs()
    # JAX's HFEmbedder has no cache_tag, so every JAX HF manager of one width
    # in the process shares the module-level cache's "semantic:" namespace;
    # a cache of its own keeps another test's embeddings out of this one
    jpipe = JPipeline(jcfg, index_manager=JManager(
        jcfg, embedder=JEmbedder(str(ckpt / "emb"), max_len=64, max_batch=16),
        semantic_cache_=EmbeddingCache()))
    tpipe = AdvancedRAGPipeline(tcfg, index_manager=MultiIndexManager(
        tcfg, embedder=HFEmbedder(ckpt / "emb", max_len=64, max_batch=16,
                                  device="cpu"), device="cpu"))
    jpipe.retriever.reranker = JCross(str(ckpt / "ce"), max_len=96, max_batch=16)
    tpipe.retriever.reranker = HFCrossEncoder(ckpt / "ce", max_len=96, max_batch=16,
                                              device="cpu")
    docs = corpus()
    reports = (jpipe.ingest_documents(docs, source="t", user="u"),
               tpipe.ingest_documents(docs, source="t", user="u"))
    yield jpipe, tpipe, reports
    jpipe.close()
    tpipe.close()


@pytest.mark.parametrize("call", [dict(), dict(top_k=7)])
def test_pipeline_with_hf_models_matches_jax(hf_pipelines, call):
    jpipe, tpipe, (jrep, trep) = hf_pipelines
    assert trep["indexed"] == jrep["indexed"] > 30
    assert not jpipe._use_fused_path() and not tpipe._use_fused_path()
    reranked = 0
    for q in QUERIES:
        want, got = jpipe.retrieve(q, **call), tpipe.retrieve(q, **call)
        assert got["degraded"] is None and want["degraded"] is None
        assert got["results"], q
        assert_same_ranking(ranked(got), ranked(want), *KEY_TOL)
        # the query class decides whether the host rerank runs
        flags = ["rerank_score" in r.metadata for r in got["results"]]
        assert flags == ["rerank_score" in r.metadata for r in want["results"]]
        reranked += all(flags)
    assert reranked >= 2


def test_fused_configuration_serves_hf_models_through_the_default_path(ckpt):
    """``fused_rerank`` with HF models: JAX's gate fails on them (its token
    table takes the HF tokenizer, whose first ingest raises; a neural
    embedder with the HF reranker passes its gate into a program that
    reads ``model.config.max_len``).  The port serves both through the
    default path, with the answers of its unfused pipeline."""
    docs = corpus()[:8]
    jcfg, tcfg = configs(fused=True)
    jpipe = JPipeline(jcfg, index_manager=JManager(
        jcfg, embedder=JEmbedder(str(ckpt / "emb"), max_len=64)))
    with pytest.raises(AttributeError, match="encode_batch"):
        jpipe.ingest_documents(docs)
    jemb, _, temb, _ = neural_models()
    jpipe = JPipeline(jcfg, index_manager=JManager(jcfg, embedder=jemb))
    jpipe.retriever.reranker = JCross(str(ckpt / "ce"), max_len=96)
    jpipe.ingest_documents(docs)
    assert jpipe._use_fused_path()
    with pytest.raises(AttributeError, match="max_len"):
        jpipe.retrieve(QUERIES[0])
    jpipe.close()

    rr = HFCrossEncoder(ckpt / "ce", max_len=96, device="cpu")
    for embedder in (HFEmbedder(ckpt / "emb", max_len=64, device="cpu"), temb):
        pipes = []
        for fused in (True, False):
            cfg = configs(fused)[1]
            pipe = AdvancedRAGPipeline(cfg, index_manager=MultiIndexManager(
                cfg, embedder=embedder, device="cpu"))
            pipe.retriever.reranker = rr
            pipe.ingest_documents(docs)
            pipes.append(pipe)
        fused_pipe, plain = pipes
        # an HF embedder gets no token table; the port's own keeps it
        assert (fused_pipe.index_manager.token_table is None) == (embedder is not temb)
        assert not fused_pipe._use_fused_path()
        for q in QUERIES[:3]:
            got, want = fused_pipe.retrieve(q), plain.retrieve(q)
            assert got["results"]
            assert ranked(got)[0] == ranked(want)[0]
            np.testing.assert_array_equal(ranked(got)[1], ranked(want)[1])
        for pipe in pipes:
            pipe.close()


def load_export_script():
    spec = importlib.util.spec_from_file_location(
        "torch_export_hf", REPO / "scripts" / "torch_export_hf.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flax_only_checkpoints_convert_and_match_jax(tmp_path):
    """The JAX integration tests' own Flax fixtures
    (tests/test_integration_models.py:79-126): the port refuses the
    Flax-only directory naming the script; after
    ``scripts/torch_export_hf.py`` it reads the written model.safetensors
    and matches JAX's classes on the original msgpack within 1e-5."""
    from transformers import FlaxBertForSequenceClassification, FlaxBertModel

    vocab_words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
                   "tpu", "kernel", "retrieval", "dense", "sparse", "the", "a"]
    for name, head in (("ce", True), ("emb", False)):
        d = tmp_path / name
        d.mkdir()
        (d / "vocab.txt").write_text("\n".join(vocab_words))
        BertTokenizerFast(vocab_file=str(d / "vocab.txt")).save_pretrained(d)
        cfg = BertConfig(vocab_size=len(vocab_words), hidden_size=32,
                         num_hidden_layers=1, num_attention_heads=2,
                         intermediate_size=64, max_position_embeddings=64,
                         num_labels=1)
        cls = FlaxBertForSequenceClassification if head else FlaxBertModel
        cls(cfg, seed=0).save_pretrained(d)
        assert (d / "flax_model.msgpack").exists()
        with pytest.raises(ValueError, match="torch_export_hf.py"):
            (HFCrossEncoder if head else HFEmbedder)(d, max_len=32, device="cpu")
        out = load_export_script().export(d)
        assert out == d / "model.safetensors" and out.exists()
    texts = ["tpu kernel", "dense retrieval", "sparse", "the a the", "unknown words"]
    jce = JCross(str(tmp_path / "ce"), max_len=32, max_batch=4)
    ce = HFCrossEncoder(tmp_path / "ce", max_len=32, max_batch=4, device="cpu")
    np.testing.assert_allclose(ce.score_pairs(texts, texts[::-1]),
                               jce.score_pairs(texts, texts[::-1]), rtol=0, atol=F32_TOL)
    jemb = JEmbedder(str(tmp_path / "emb"), max_len=16, max_batch=4)
    emb = HFEmbedder(tmp_path / "emb", max_len=16, max_batch=4, device="cpu")
    np.testing.assert_allclose(emb.encode(texts), jemb.encode(texts), rtol=0,
                               atol=F32_TOL)

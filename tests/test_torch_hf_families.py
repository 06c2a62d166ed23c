"""The port's HF models of the other encoder families (``models/hf_roberta.py``,
``hf_electra.py``, ``hf_distilbert.py`` behind ``HFEmbedder`` /
``HFCrossEncoder``) against the JAX package's classes on the same
checkpoint directory.

Each checkpoint is tiny (2 layers, 32 wide, 4 heads, FFN 64) and written
by transformers' PyTorch classes (``save_pretrained``) with every weight
moved off its initial value, once as ``model.safetensors`` and once as
``pytorch_model.bin``, beside the family's tokenizer files:

- RoBERTa: a byte-level BPE (``test_torch_hf_bpe.write_bpe_dir``), pad id 1,
  one token type, eps 1e-5, its pooler in the embedder's file;
- XLM-RoBERTa: XLM-R's Unigram ``tokenizer.json``
  (``test_torch_hf_unigram.write_unigram_dir``);
- ELECTRA: ``embedding_size`` 16 under ``hidden_size`` 32, so
  ``embeddings_project`` runs; WordPiece;
- DistilBERT: WordPiece, learned and sinusoidal positions; embedder only.

Bounds as ``tests/test_torch_hf_models.py``: f32 within 1e-5 absolute;
bf16 embeddings (unit vectors) within 1e-2, bf16 scores within 2e-2 of
max(1, |score|).  The texts differ in length, so every batch is padded and
RoBERTa's padding takes position ``pad_token_id``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import (DistilBertConfig, DistilBertModel, DistilBertTokenizerFast,
                          ElectraConfig, ElectraForSequenceClassification, ElectraModel,
                          ElectraTokenizerFast, RobertaConfig,
                          RobertaForSequenceClassification, RobertaModel,
                          XLMRobertaConfig, XLMRobertaForSequenceClassification,
                          XLMRobertaModel)

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
from test_torch_hf_bpe import write_bpe_dir
from test_torch_hf_models import TEXTS, PAIRS_D, PAIRS_Q, vocab
from test_torch_hf_unigram import write_unigram_dir
from test_torch_pipeline import QUERIES, assert_same_ranking, corpus, ranked

D = 32
F32_TOL = 1e-5
KEY_TOL = (1e-3, 1e-4)
GEOMETRY = dict(hidden_size=D, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, num_labels=1)
FAMILIES = ["roberta", "xlm-roberta", "electra", "distilbert"]
RERANKERS = ["roberta", "xlm-roberta", "electra"]
WEIGHTS = {"safetensors": "model.safetensors", "bin": "pytorch_model.bin"}


def write_family(path, family, *, head, fmt="safetensors", seed=0, **extra):
    """A tiny checkpoint of ``family`` and its tokenizer in ``path``."""
    path.mkdir(parents=True, exist_ok=True)
    if family == "roberta":
        n = write_bpe_dir(path / "tok", "json")
        cfg = RobertaConfig(vocab_size=n, max_position_embeddings=66, type_vocab_size=1,
                            layer_norm_eps=1e-5, pad_token_id=1, **GEOMETRY)
        cls = RobertaForSequenceClassification if head else RobertaModel
    elif family == "xlm-roberta":
        n = write_unigram_dir(path / "tok")
        cfg = XLMRobertaConfig(vocab_size=n, max_position_embeddings=66,
                               type_vocab_size=1, layer_norm_eps=1e-5, pad_token_id=1,
                               **GEOMETRY)
        cls = XLMRobertaForSequenceClassification if head else XLMRobertaModel
    else:
        (path / "vocab.txt").write_text("\n".join(vocab()) + "\n", encoding="utf-8")
        if family == "electra":
            ElectraTokenizerFast(vocab_file=str(path / "vocab.txt")).save_pretrained(path)
            cfg = ElectraConfig(vocab_size=len(vocab()), embedding_size=16,
                                max_position_embeddings=64, **GEOMETRY)
            cls = ElectraForSequenceClassification if head else ElectraModel
        else:
            DistilBertTokenizerFast(vocab_file=str(path / "vocab.txt")).save_pretrained(path)
            cfg = DistilBertConfig(vocab_size=len(vocab()), dim=D, n_layers=2, n_heads=4,
                                   hidden_dim=64, max_position_embeddings=64, **extra)
            cls = DistilBertModel
    for f in (path / "tok").glob("*") if (path / "tok").exists() else []:
        f.rename(path / f.name)
    torch.manual_seed(seed)
    model = cls(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    model.save_pretrained(path, safe_serialization=fmt == "safetensors")
    assert (path / WEIGHTS[fmt]).exists() and not (path / "flax_model.msgpack").exists()
    return path


def make_all(root, fmt):
    for family in FAMILIES:
        write_family(root / family / "emb", family, head=False, fmt=fmt)
    for family in RERANKERS:
        write_family(root / family / "ce", family, head=True, fmt=fmt, seed=1)
    return root


@pytest.fixture(scope="module")
def st_dirs(tmp_path_factory):
    return make_all(tmp_path_factory.mktemp("fam-safetensors"), "safetensors")


@pytest.fixture(scope="module")
def bin_dirs(tmp_path_factory):
    return make_all(tmp_path_factory.mktemp("fam-bin"), "bin")


@pytest.fixture(scope="module")
def dirs(st_dirs, bin_dirs):
    return {"safetensors": st_dirs, "bin": bin_dirs}


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("family", FAMILIES)
def test_embedder_matches_jax(dirs, family, fmt):
    path = dirs[fmt] / family / "emb"
    jemb = JEmbedder(str(path), max_len=48, max_batch=8)
    emb = HFEmbedder(path, max_len=48, max_batch=8, device="cpu")
    assert emb.dim == jemb.dim == D
    want, got = jemb.encode(TEXTS), emb.encode(TEXTS)
    assert got.shape == (len(TEXTS), D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=0, atol=1e-5)
    # one text alone (no padding) and inside a padded batch agree
    np.testing.assert_allclose(emb.encode(TEXTS[:1]), got[:1], rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_embedder_bf16_matches_jax(st_dirs, family):
    path = st_dirs / family / "emb"
    jemb = JEmbedder(str(path), max_len=48, max_batch=8, dtype=jnp.bfloat16)
    emb = HFEmbedder(path, max_len=48, max_batch=8, dtype=torch.bfloat16, device="cpu")
    got = emb.encode(TEXTS)
    np.testing.assert_allclose(got, jemb.encode(TEXTS), rtol=0, atol=1e-2)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("family", RERANKERS)
def test_cross_encoder_matches_jax(dirs, family, fmt):
    path = dirs[fmt] / family / "ce"
    jce = JCross(str(path), max_len=48, max_batch=8)
    ce = HFCrossEncoder(path, max_len=48, max_batch=8, device="cpu")
    qs, ds = PAIRS_Q * 2, PAIRS_D * 2
    want, got = jce.score_pairs(qs, ds), ce.score_pairs(qs, ds)
    assert got.shape == (len(qs),) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert np.ptp(want) > 1e-3


@pytest.mark.parametrize("family", RERANKERS)
def test_cross_encoder_bf16_matches_jax(st_dirs, family):
    path = st_dirs / family / "ce"
    jce = JCross(str(path), max_len=48, max_batch=8, dtype=jnp.bfloat16)
    ce = HFCrossEncoder(path, max_len=48, max_batch=8, dtype=torch.bfloat16,
                        device="cpu")
    want, got = jce.score_pairs(PAIRS_Q, PAIRS_D), ce.score_pairs(PAIRS_Q, PAIRS_D)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * max(1.0, float(np.abs(want).max())))


def test_distilbert_sinusoidal_positions_match_jax(tmp_path):
    """sinusoidal_pos_embds: Flax builds its own table and reads none from
    the checkpoint; so does the port."""
    path = write_family(tmp_path / "sin", "distilbert", head=False,
                        sinusoidal_pos_embds=True)
    jemb = JEmbedder(str(path), max_len=48, max_batch=8)
    emb = HFEmbedder(path, max_len=48, max_batch=8, device="cpu")
    assert emb.model.embeddings.position_embeddings is None
    np.testing.assert_allclose(emb.encode(TEXTS), jemb.encode(TEXTS), rtol=0,
                               atol=F32_TOL)


def test_deliberate_differences(st_dirs):
    """A DistilBERT reranker: JAX's class passes token_type_ids, which
    FlaxDistilBertForSequenceClassification does not take, so it raises
    TypeError at the first score; the port refuses it at construction.
    RoBERTa's positions run past max_len by pad_token_id + 1: a max_len
    whose ids would pass the table raises (JAX's gather clamps)."""
    from transformers import DistilBertForSequenceClassification

    path = st_dirs / "distilbert" / "ce"
    path.mkdir(parents=True, exist_ok=True)
    for f in (st_dirs / "distilbert" / "emb").glob("*.json"):
        (path / f.name).write_bytes(f.read_bytes())
    (path / "vocab.txt").write_bytes((st_dirs / "distilbert" / "emb" / "vocab.txt").read_bytes())
    cfg = DistilBertConfig(vocab_size=len(vocab()), dim=D, n_layers=2, n_heads=4,
                           hidden_dim=64, max_position_embeddings=64, num_labels=1)
    DistilBertForSequenceClassification(cfg).save_pretrained(path)
    jce = JCross(str(path), max_len=32)
    with pytest.raises(TypeError, match="token_type_ids"):
        jce.score_pairs(["q"], ["d"])
    with pytest.raises(ValueError, match="DistilBERT"):
        HFCrossEncoder(path, max_len=32, device="cpu")
    HFEmbedder(st_dirs / "roberta" / "emb", max_len=64, device="cpu")
    with pytest.raises(ValueError, match="offset of 2"):
        HFEmbedder(st_dirs / "roberta" / "emb", max_len=65, device="cpu")


def configs():
    out = []
    for cls in (JConfig, PipelineConfig):
        cfg = cls(semantic_dtype="float32", chunk_base_size=24, chunk_max_size=48,
                  chunk_min_size=8)
        cfg.semantic_dim = D
        cfg.retrieval.timeout_seconds = 60.0
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def pipelines(st_dirs):
    """Both packages' pipelines on one corpus: a RoBERTa HFEmbedder in the
    manager and an ELECTRA HFCrossEncoder as the reranker, as
    RAG_RERANKER=hf: wires it."""
    jcfg, tcfg = configs()
    emb, ce = st_dirs / "roberta" / "emb", st_dirs / "electra" / "ce"
    # JAX's HFEmbedder has no cache_tag, so every JAX HF manager of one width
    # in the process shares the module-level cache's "semantic:" namespace;
    # a cache of its own keeps another test's embeddings out of this one
    jpipe = JPipeline(jcfg, index_manager=JManager(
        jcfg, embedder=JEmbedder(str(emb), max_len=64, max_batch=16),
        semantic_cache_=EmbeddingCache()))
    tpipe = AdvancedRAGPipeline(tcfg, index_manager=MultiIndexManager(
        tcfg, embedder=HFEmbedder(emb, max_len=64, max_batch=16, device="cpu"),
        device="cpu"))
    jpipe.retriever.reranker = JCross(str(ce), max_len=64, max_batch=16)
    tpipe.retriever.reranker = HFCrossEncoder(ce, max_len=64, max_batch=16, device="cpu")
    docs = corpus()
    reports = (jpipe.ingest_documents(docs, source="t", user="u"),
               tpipe.ingest_documents(docs, source="t", user="u"))
    yield jpipe, tpipe, reports
    jpipe.close()
    tpipe.close()


@pytest.mark.parametrize("call", [dict(), dict(top_k=7)])
def test_pipeline_with_roberta_embedder_and_electra_reranker(pipelines, call):
    jpipe, tpipe, (jrep, trep) = pipelines
    assert trep["indexed"] == jrep["indexed"] > 30
    reranked = 0
    for q in QUERIES:
        want, got = jpipe.retrieve(q, **call), tpipe.retrieve(q, **call)
        assert got["degraded"] is None and want["degraded"] is None
        assert got["results"], q
        assert_same_ranking(ranked(got), ranked(want), *KEY_TOL)
        flags = ["rerank_score" in r.metadata for r in got["results"]]
        assert flags == ["rerank_score" in r.metadata for r in want["results"]]
        reranked += all(flags)
    assert reranked >= 2


@pytest.mark.parametrize("family,head", [("roberta", True), ("xlm-roberta", False),
                                         ("electra", True), ("distilbert", False)])
def test_flax_only_checkpoints_convert_and_match_jax(tmp_path, family, head):
    """A Flax-only directory of each family (flax_model.msgpack written by
    transformers' Flax class): the port refuses it naming
    scripts/torch_export_hf.py; after the script it reads the written
    model.safetensors and matches JAX's class on the original msgpack."""
    import transformers as tf

    from test_torch_hf_models import load_export_script

    path = write_family(tmp_path / "pt", family, head=head)
    cfg = tf.AutoConfig.from_pretrained(path, local_files_only=True)
    flax_cls = (tf.FlaxAutoModelForSequenceClassification if head else tf.FlaxAutoModel)
    flax_dir = tmp_path / "flax"
    flax_dir.mkdir()
    for f in path.iterdir():
        if f.suffix in (".json", ".txt") and f.name != "config.json":
            (flax_dir / f.name).write_bytes(f.read_bytes())
    flax_cls.from_config(cfg, seed=3).save_pretrained(flax_dir)
    assert (flax_dir / "flax_model.msgpack").exists()
    port_cls = HFCrossEncoder if head else HFEmbedder
    with pytest.raises(ValueError, match="torch_export_hf.py"):
        port_cls(flax_dir, max_len=32, device="cpu")
    assert load_export_script().export(flax_dir) == flax_dir / "model.safetensors"
    if head:
        want = JCross(str(flax_dir), max_len=32).score_pairs(PAIRS_Q, PAIRS_D)
        got = port_cls(flax_dir, max_len=32, device="cpu").score_pairs(PAIRS_Q, PAIRS_D)
    else:
        want = JEmbedder(str(flax_dir), max_len=32).encode(TEXTS[:9])
        got = port_cls(flax_dir, max_len=32, device="cpu").encode(TEXTS[:9])
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)

"""The port's HF models of the second group of encoder families
(``models/hf_roberta_prelayernorm.py``, ``hf_albert.py``, ``hf_big_bird.py``,
``hf_roformer.py`` behind ``HFEmbedder`` / ``HFCrossEncoder``) against the
JAX package's classes on the same checkpoint directory.

Each checkpoint is tiny (2 layers, 32 wide, 4 heads, FFN 64) and written
by transformers' PyTorch classes with every weight moved off its initial
value, beside the family's tokenizer files; JAX's classes load it
``from_pt``:

- RoBERTa-PreLayerNorm: a byte-level BPE (``test_torch_hf_bpe``), pad id 1,
  eps 1e-5;
- ALBERT: ``embedding_size`` 16 under ``hidden_size`` 32, 2 groups of 2
  inner layers over 4 layers (so both groups run, each twice), its
  Unigram ``tokenizer.json`` with NFKD / StripAccents
  (``test_torch_hf_albert_tokenizer``);
- BigBird: ``original_full``, and ``block_sparse`` at ``block_size`` 8 with
  2 random blocks at 4, 5 and 8 blocks (32, 40, 64 tokens), BigBird's
  Unigram ``tokenizer.json``; a batch with an all-padding row; 1024
  tokens, where Flax takes its other random-block plan;
- RoFormer: with and without ``rotary_value``, a WordPiece tokenizer
  (``tokenizer_class`` BertTokenizer; RoFormer's own needs rjieba).

Bounds as ``tests/test_torch_hf_families.py``: f32 within 1e-5 absolute;
bf16 embeddings (unit vectors) within 1e-2, bf16 scores within 2e-2 of
max(1, |score|).  The texts differ in length, so every batch is padded;
nine texts at ``max_batch`` 8 make a last batch of one text padded to a
bucket of one, and three texts one of four, whose last row is all
padding."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers as tf

from advanced_rag_tpu.index.manager import MultiIndexManager as JManager
from advanced_rag_tpu.models.hf_cross_encoder import HFCrossEncoder as JCross
from advanced_rag_tpu.models.hf_embedder import HFEmbedder as JEmbedder
from advanced_rag_tpu.pipeline import AdvancedRAGPipeline as JPipeline
from advanced_rag_tpu.utils.cache import EmbeddingCache
from advanced_rag_tpu_torch.index.manager import MultiIndexManager
from advanced_rag_tpu_torch.models import HFEmbedder
from advanced_rag_tpu_torch.models.hf_checkpoint import load_checkpoint, read_config
from advanced_rag_tpu_torch.models.hf_cross_encoder import HFCrossEncoder
from advanced_rag_tpu_torch.models.hf_embedder import build_trunk
from advanced_rag_tpu_torch.pipeline import AdvancedRAGPipeline
from test_torch_hf_albert_tokenizer import write_spm_dir
from test_torch_hf_bpe import write_bpe_dir
from test_torch_hf_families import KEY_TOL, configs
from test_torch_hf_models import PAIRS_D, PAIRS_Q, TEXTS, vocab
from test_torch_pipeline import QUERIES, assert_same_ranking, corpus, ranked

D = 32
F32_TOL = 1e-5
GEOMETRY = dict(hidden_size=D, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, num_labels=1)
#: family -> (config class, trunk class, classifier class, config extras)
FAMILIES = {
    "roberta-prelayernorm": (tf.RobertaPreLayerNormConfig, tf.RobertaPreLayerNormModel,
                             tf.RobertaPreLayerNormForSequenceClassification,
                             dict(max_position_embeddings=66, layer_norm_eps=1e-5,
                                  pad_token_id=1)),
    "albert": (tf.AlbertConfig, tf.AlbertModel, tf.AlbertForSequenceClassification,
               dict(embedding_size=16, num_hidden_layers=4, num_hidden_groups=2,
                    inner_group_num=2, max_position_embeddings=64)),
    "big_bird": (tf.BigBirdConfig, tf.BigBirdModel, tf.BigBirdForSequenceClassification,
                 dict(max_position_embeddings=1024, block_size=8, num_random_blocks=2)),
    "roformer": (tf.RoFormerConfig, tf.RoFormerModel, tf.RoFormerForSequenceClassification,
                 dict(max_position_embeddings=64)),
}
#: the cases each test runs: (family, config extras, max_len)
CASES = {
    "roberta-prelayernorm": ("roberta-prelayernorm", {}, 48),
    "albert": ("albert", {}, 48),
    "big_bird-full": ("big_bird", dict(attention_type="original_full"), 48),
    "big_bird-sparse-4": ("big_bird", {}, 32),
    "big_bird-sparse-5": ("big_bird", {}, 40),
    "big_bird-sparse-8": ("big_bird", {}, 64),
    "roformer": ("roformer", {}, 48),
    "roformer-rotary-value": ("roformer", dict(rotary_value=True), 48),
}
RERANKERS = ["roberta-prelayernorm", "albert", "big_bird-full", "big_bird-sparse-8",
             "roformer", "roformer-rotary-value"]


def write_family(path, family, *, head, seed=0, **extra):
    """A tiny checkpoint of ``family`` and its tokenizer in ``path``."""
    path.mkdir(parents=True, exist_ok=True)
    cfg_cls, trunk, classifier, base = FAMILIES[family]
    if family == "roberta-prelayernorm":
        n = write_bpe_dir(path, "json")
        # the fast class by tokenizer_class, as the published checkpoints name it
        cfg = json.loads((path / "tokenizer_config.json").read_text())
        (path / "tokenizer_config.json").write_text(json.dumps(
            dict(cfg, tokenizer_class="RobertaTokenizer")))
    elif family == "roformer":
        (path / "vocab.txt").write_text("\n".join(vocab()) + "\n", encoding="utf-8")
        tf.BertTokenizerFast(vocab_file=str(path / "vocab.txt")).save_pretrained(path)
        n = len(vocab())
    else:
        n = write_spm_dir(path, family)
    cfg = cfg_cls(vocab_size=n, **{**GEOMETRY, **base, **extra})
    torch.manual_seed(seed)
    model = (classifier if head else trunk)(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    model.save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The checkpoints of each case; the block-sparse cases share one."""
    root = tmp_path_factory.mktemp("encoders-more")
    out, written = {}, {}
    for case, (family, extra, _) in CASES.items():
        key = "big_bird-sparse" if case.startswith("big_bird-sparse") else case
        if key not in written:
            written[key] = {
                "emb": write_family(root / key / "emb", family, head=False, **extra),
                "ce": write_family(root / key / "ce", family, head=True, seed=1, **extra)}
        out[case] = written[key]
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_embedder_matches_jax(dirs, case):
    family, _, max_len = CASES[case]
    path = dirs[case]["emb"]
    jemb = JEmbedder(str(path), max_len=max_len, max_batch=8)
    emb = HFEmbedder(path, max_len=max_len, max_batch=8, device="cpu")
    assert emb.dim == jemb.dim == D
    assert emb.model.config.model_type == family
    texts = TEXTS[:9]
    want, got = jemb.encode(texts), emb.encode(texts)
    assert got.shape == (len(texts), D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=0, atol=1e-5)
    # three texts make a bucket of four: its last row is all padding
    np.testing.assert_allclose(emb.encode(texts[:3]), jemb.encode(texts[:3]), rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("case", ["roberta-prelayernorm", "albert", "big_bird-sparse-8",
                                  "roformer-rotary-value"])
def test_embedder_bf16_matches_jax(dirs, case):
    _, _, max_len = CASES[case]
    path = dirs[case]["emb"]
    jemb = JEmbedder(str(path), max_len=max_len, max_batch=8, dtype=jnp.bfloat16)
    emb = HFEmbedder(path, max_len=max_len, max_batch=8, dtype=torch.bfloat16,
                     device="cpu")
    got = emb.encode(TEXTS[:9])
    np.testing.assert_allclose(got, jemb.encode(TEXTS[:9]), rtol=0, atol=1e-2)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", RERANKERS)
def test_cross_encoder_matches_jax(dirs, case):
    """Pairs at max_batch 8 (the last batch padded), one pair whose query
    alone passes max_len and one whose document does; ALBERT's tokenizer
    returns the pair's token types, the others' zeros are fed."""
    _, _, max_len = CASES[case]
    path = dirs[case]["ce"]
    jce = JCross(str(path), max_len=max_len, max_batch=8)
    ce = HFCrossEncoder(path, max_len=max_len, max_batch=8, device="cpu")
    want, got = jce.score_pairs(PAIRS_Q, PAIRS_D), ce.score_pairs(PAIRS_Q, PAIRS_D)
    assert got.shape == (len(PAIRS_Q),) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert np.ptp(want) > 1e-3


@pytest.mark.parametrize("case", ["roberta-prelayernorm", "albert", "big_bird-sparse-8",
                                  "roformer"])
def test_cross_encoder_bf16_matches_jax(dirs, case):
    _, _, max_len = CASES[case]
    path = dirs[case]["ce"]
    jce = JCross(str(path), max_len=max_len, max_batch=8, dtype=jnp.bfloat16)
    ce = HFCrossEncoder(path, max_len=max_len, max_batch=8, dtype=torch.bfloat16,
                        device="cpu")
    want, got = jce.score_pairs(PAIRS_Q, PAIRS_D), ce.score_pairs(PAIRS_Q, PAIRS_D)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("seq", [64, 1024])
def test_block_sparse_padding_rows_match_flax(dirs, seq):
    """The trunk's hidden states on a batch with an all-padding row, a
    half-padded row and a full one, against FlaxBigBirdModel's on the same
    ids: the padding row raises nothing and matches too.  At 1024 tokens
    Flax takes its plan for 1024 / 3072 / 4096 (a random-block list cut
    from max_position_embeddings' one)."""
    path = dirs["big_bird-sparse-8"]["emb"]
    flax = tf.FlaxAutoModel.from_pretrained(str(path), from_pt=True, local_files_only=True)
    config, state = load_checkpoint(path, head=False, pooler=False)
    model = build_trunk(config, torch.float32)
    model.load_state_dict(state)
    rng = np.random.default_rng(3)
    ids = rng.integers(5, config.vocab_size, (3, seq))
    mask = np.ones_like(ids)
    mask[1, seq // 2 + 3:] = 0
    mask[2] = 0
    ids[mask == 0] = config.pad_token_id
    want = np.asarray(flax(input_ids=ids, attention_mask=mask, params=flax.params,
                           train=False).last_hidden_state)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(ids), torch.from_numpy(mask),
                       torch.zeros((3, seq), dtype=torch.long))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)


def test_length_refusals(dirs, tmp_path):
    """BigBird: a length that is not a multiple of block_size raises
    ValueError as Flax's does (the port at construction, JAX at its first
    encode); block_sparse under four blocks raises ValueError naming the
    rule, where JAX raises ZeroDivisionError or TypeError."""
    path = dirs["big_bird-sparse-8"]["emb"]
    with pytest.raises(ValueError, match="multiple of block size"):
        JEmbedder(str(path), max_len=36).encode(["dense"])
    with pytest.raises(ValueError, match="not a multiple of block_size 8"):
        HFEmbedder(path, max_len=36, device="cpu")
    for max_len in (16, 24):
        with pytest.raises((ZeroDivisionError, TypeError)):
            JEmbedder(str(path), max_len=max_len).encode(["dense"])
        with pytest.raises(ValueError, match="needs at least 4 blocks"):
            HFEmbedder(path, max_len=max_len, device="cpu")
    with pytest.raises(ValueError, match="needs at least 4 blocks"):
        HFCrossEncoder(dirs["big_bird-sparse-8"]["ce"], max_len=24, device="cpu")
    # original_full takes any multiple of block_size, short rows too
    HFEmbedder(dirs["big_bird-full"]["emb"], max_len=16, device="cpu")


def test_config_refusals(tmp_path):
    """RoFormer with embedding_size other than hidden_size: Flax RoFormer
    has no embeddings_project and JAX's from_pt raises on the LayerNorm's
    shape; the port's read_config raises naming the field.  A BigBird
    attention_type other than Flax's two raises naming it."""
    cfg = tf.RoFormerConfig(vocab_size=len(vocab()), embedding_size=16,
                            max_position_embeddings=64, **GEOMETRY)
    tf.RoFormerModel(cfg).save_pretrained(tmp_path / "r")
    with pytest.raises(ValueError, match="expected to be of shape"):
        tf.FlaxAutoModel.from_pretrained(str(tmp_path / "r"), from_pt=True,
                                         local_files_only=True)
    with pytest.raises(ValueError, match="embedding_size 16 is not supported"):
        read_config(tmp_path / "r")
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "config.json").write_text(json.dumps(
        {"model_type": "big_bird", "attention_type": "block_sparse_v2"}))
    with pytest.raises(ValueError, match="attention_type 'block_sparse_v2'"):
        read_config(tmp_path / "b")


def test_families_read_their_defaults(tmp_path):
    """A config.json with model_type alone takes the family's class
    defaults (albert-xxlarge's widths for ALBERT, bigbird-roberta-base's
    block plan, RoFormer's 1536 positions, RoBERTa-PreLayerNorm's pad id
    and position offset)."""
    for family, cls in (("albert", tf.AlbertConfig), ("big_bird", tf.BigBirdConfig),
                        ("roformer", tf.RoFormerConfig),
                        ("roberta-prelayernorm", tf.RobertaPreLayerNormConfig)):
        (tmp_path / "config.json").write_text(json.dumps({"model_type": family}))
        c, d = read_config(tmp_path), cls()
        assert (c.vocab_size, c.hidden_size, c.num_attention_heads, c.intermediate_size,
                c.hidden_act, c.max_position_embeddings, c.pad_token_id) == (
            d.vocab_size, d.hidden_size, d.num_attention_heads, d.intermediate_size,
            d.hidden_act, d.max_position_embeddings, d.pad_token_id), family
        if family == "albert":
            assert (c.embedding_size, c.num_hidden_groups, c.inner_group_num) == (
                d.embedding_size, d.num_hidden_groups, d.inner_group_num)
        if family == "big_bird":
            assert (c.attention_type, c.block_size, c.num_random_blocks, c.use_bias,
                    c.rescale_embeddings) == (d.attention_type, d.block_size,
                                              d.num_random_blocks, d.use_bias,
                                              d.rescale_embeddings)
        if family == "roformer":
            assert c.rotary_value == d.rotary_value is False
        assert c.position_offset == (2 if family == "roberta-prelayernorm" else 0)


@pytest.mark.parametrize("case,head", [("roberta-prelayernorm", False), ("albert", True),
                                       ("big_bird-sparse-8", False), ("roformer", True)])
def test_flax_only_checkpoints_convert_and_match_jax(dirs, tmp_path, case, head):
    """A Flax-only directory of each family (flax_model.msgpack written by
    transformers' Flax class): the port refuses it naming
    scripts/torch_export_hf.py; after the script it reads the written
    model.safetensors and matches JAX's class on the original msgpack."""
    from test_torch_hf_models import load_export_script

    src = dirs[case]["ce" if head else "emb"]
    _, _, max_len = CASES[case]
    cfg = tf.AutoConfig.from_pretrained(src, local_files_only=True)
    flax_cls = tf.FlaxAutoModelForSequenceClassification if head else tf.FlaxAutoModel
    flax_dir = tmp_path / "flax"
    flax_dir.mkdir()
    for f in src.iterdir():
        if f.suffix in (".json", ".txt") and f.name != "config.json":
            (flax_dir / f.name).write_bytes(f.read_bytes())
    flax_cls.from_config(cfg, seed=3).save_pretrained(flax_dir)
    port_cls = HFCrossEncoder if head else HFEmbedder
    with pytest.raises(ValueError, match="torch_export_hf.py"):
        port_cls(flax_dir, max_len=max_len, device="cpu")
    assert load_export_script().export(flax_dir) == flax_dir / "model.safetensors"
    if head:
        want = JCross(str(flax_dir), max_len=max_len).score_pairs(PAIRS_Q, PAIRS_D)
        got = port_cls(flax_dir, max_len=max_len, device="cpu").score_pairs(PAIRS_Q, PAIRS_D)
    else:
        want = JEmbedder(str(flax_dir), max_len=max_len).encode(TEXTS[:9])
        got = port_cls(flax_dir, max_len=max_len, device="cpu").encode(TEXTS[:9])
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


@pytest.fixture(scope="module")
def pipelines(dirs):
    """Both packages' pipelines on one corpus: a block-sparse BigBird
    HFEmbedder (64 tokens, 8 blocks) in the manager and an ALBERT
    HFCrossEncoder as the reranker, as RAG_RERANKER=hf: wires them."""
    jcfg, tcfg = configs()
    emb, ce = dirs["big_bird-sparse-8"]["emb"], dirs["albert"]["ce"]
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


def test_pipeline_with_big_bird_embedder_and_albert_reranker(pipelines):
    """The slice's /retrieve path on the CPU: ingest, hybrid retrieval and
    the ALBERT rerank give the same ranking in both packages."""
    jpipe, tpipe, (jrep, trep) = pipelines
    assert trep["indexed"] == jrep["indexed"] > 30
    reranked = 0
    for q in QUERIES:
        want, got = jpipe.retrieve(q), tpipe.retrieve(q)
        assert got["degraded"] is None and want["degraded"] is None
        assert got["results"], q
        assert_same_ranking(ranked(got), ranked(want), *KEY_TOL)
        flags = ["rerank_score" in r.metadata for r in got["results"]]
        assert flags == ["rerank_score" in r.metadata for r in want["results"]]
        reranked += all(flags)
    assert reranked >= 2

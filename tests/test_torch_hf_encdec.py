"""The port's encoder-decoder embedders (``models/hf_bart.py`` behind
``HFEmbedder``) against the JAX package's ``HFEmbedder`` on the same
checkpoint directory, for ``bart``, ``mbart``, ``pegasus``, ``marian``,
``blenderbot`` and ``blenderbot-small``.

Each checkpoint is tiny (2 + 2 layers, 32 wide, 4 heads, FFN 64, 64
positions) and written by transformers' PyTorch classes with every weight
moved off its initial value, beside the family's tokenizer
(``test_torch_hf_encdec_tokenizer``: BART's and Blenderbot's byte-level
BPE, mBART's and Pegasus's Unigram, BlenderbotSmall's slow BPE; Marian's
own needs sentencepiece, so its checkpoint names BERT's WordPiece); JAX's
class loads it ``from_pt``.  The switches differ by family as the
published configs set them: ``scale_embedding`` on for mBART, Pegasus,
Marian and Blenderbot, Pegasus's ReLU, Marian's swish.

Bounds: f32 within 1e-5 absolute; bf16 embeddings (unit vectors) within
1e-2.  Nine texts at ``max_batch`` 8 make a last batch of one text; three
texts a bucket of four whose last row is all padding (id 0, as JAX's
``np.pad`` writes it, which mBART's shift reads as a language code)."""

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
from advanced_rag_tpu_torch.models.hf_bart import shift_tokens_right, sinusoids
from advanced_rag_tpu_torch.models.hf_checkpoint import (ENCDEC, load_checkpoint,
                                                         read_config, read_safetensors)
from advanced_rag_tpu_torch.models.hf_cross_encoder import HFCrossEncoder
from advanced_rag_tpu_torch.models.hf_embedder import build_trunk
from advanced_rag_tpu_torch.pipeline import AdvancedRAGPipeline
from test_torch_hf_bpe import train_bpe
from test_torch_hf_encdec_tokenizer import write_mbart_dir, write_pegasus_dir, write_small_dir
from test_torch_hf_families import KEY_TOL, configs
from test_torch_hf_models import TEXTS, vocab, write_checkpoint
from test_torch_pipeline import QUERIES, assert_same_ranking, corpus, ranked

D = 32
F32_TOL = 1e-5
MAX_LEN = 48
GEOMETRY = dict(d_model=D, encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
                decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
                max_position_embeddings=64)
#: family -> (config class, trunk class, config extras)
FAMILIES = {
    "bart": (tf.BartConfig, tf.BartModel, {}),
    "mbart": (tf.MBartConfig, tf.MBartModel, dict(scale_embedding=True)),
    "pegasus": (tf.PegasusConfig, tf.PegasusModel,
                dict(scale_embedding=True, activation_function="relu")),
    "marian": (tf.MarianConfig, tf.MarianModel,
               dict(scale_embedding=True, activation_function="swish")),
    "blenderbot": (tf.BlenderbotConfig, tf.BlenderbotModel, dict(scale_embedding=True)),
    "blenderbot-small": (tf.BlenderbotSmallConfig, tf.BlenderbotSmallModel, {}),
}


def write_tokenizer(path, family) -> int:
    """The family's tokenizer files in ``path``; returns the vocab size."""
    if family in ("bart", "blenderbot"):
        train_bpe(path.parent / f"{path.name}-bpe")
        cls = tf.BartTokenizerFast if family == "bart" else tf.BlenderbotTokenizerFast
        tok = cls(vocab_file=str(path.parent / f"{path.name}-bpe" / "vocab.json"),
                  merges_file=str(path.parent / f"{path.name}-bpe" / "merges.txt"))
        tok.save_pretrained(path)
        return len(tok)
    if family == "mbart":
        return write_mbart_dir(path)
    if family == "pegasus":
        return write_pegasus_dir(path)
    if family == "blenderbot-small":
        return write_small_dir(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.txt").write_text("\n".join(vocab()) + "\n", encoding="utf-8")
    tok = tf.BertTokenizerFast(vocab_file=str(path / "vocab.txt"))
    tok.save_pretrained(path)
    return len(vocab())


def write_family(path, family, *, seed=0, **extra):
    """A tiny checkpoint of ``family`` and its tokenizer in ``path``; the
    config's pad (and the decoder's start, but mBART's) is the
    tokenizer's pad id."""
    n = write_tokenizer(path, family)
    pad = tf.AutoTokenizer.from_pretrained(str(path), local_files_only=True).pad_token_id
    cfg_cls, trunk, base = FAMILIES[family]
    cfg = cfg_cls(vocab_size=n, pad_token_id=pad, decoder_start_token_id=pad,
                  **{**GEOMETRY, **base, **extra})
    torch.manual_seed(seed)
    model = trunk(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    model.save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("encdec")
    return {family: write_family(root / family, family) for family in FAMILIES}


def assert_unit_rows(emb, texts, got):
    """Unit rows, but for a text without tokens (BlenderbotSmall adds no
    special tokens, so an empty text pools nothing: a zero row, as in
    JAX)."""
    tokens = emb.tokenizer(list(texts), max_length=MAX_LEN)["attention_mask"].sum(1)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), (tokens > 0).astype(float),
                               rtol=0, atol=1e-5)
    assert (tokens > 0).sum() >= len(texts) - 1


@pytest.mark.parametrize("family", list(FAMILIES))
def test_embedder_matches_jax(dirs, family):
    path = dirs[family]
    jemb = JEmbedder(str(path), max_len=MAX_LEN, max_batch=8)
    emb = HFEmbedder(path, max_len=MAX_LEN, max_batch=8, device="cpu")
    assert emb.dim == jemb.dim == D
    assert emb.model.config.model_type == family
    texts = TEXTS[:9]
    want, got = jemb.encode(texts), emb.encode(texts)
    assert got.shape == (len(texts), D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert_unit_rows(emb, texts, got)
    # three texts make a bucket of four: its last row is all padding
    np.testing.assert_allclose(emb.encode(texts[:3]), jemb.encode(texts[:3]), rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_embedder_bf16_matches_jax(dirs, family):
    path = dirs[family]
    jemb = JEmbedder(str(path), max_len=MAX_LEN, max_batch=8, dtype=jnp.bfloat16)
    emb = HFEmbedder(path, max_len=MAX_LEN, max_batch=8, dtype=torch.bfloat16,
                     device="cpu")
    got = emb.encode(TEXTS[:9])
    np.testing.assert_allclose(got, jemb.encode(TEXTS[:9]), rtol=0, atol=1e-2)
    assert_unit_rows(emb, TEXTS[:9], got)
    np.testing.assert_allclose(emb.encode(TEXTS[:3]), jemb.encode(TEXTS[:3]), rtol=0,
                               atol=1e-2)


@pytest.mark.parametrize("family", ["bart", "mbart"])
def test_shift_matches_flax(family):
    """The decoder's input against Flax's shift_tokens_right: BART's start
    id; mBART's last non-pad token moved to the front, on right-padded
    rows, a row of pad ids (the count less one wraps to the last column)
    and a row of id 0, as JAX pads a bucket."""
    module = getattr(tf.models, family)
    flax_shift = getattr(module, f"modeling_flax_{family}").shift_tokens_right
    rng = np.random.default_rng(2)
    ids = rng.integers(3, 90, (5, 12))
    ids[1, 7:] = 1
    ids[2, 1:] = 1
    ids[3] = 1
    ids[4] = 0
    if family == "mbart":
        want = flax_shift(jnp.asarray(ids), 1)
        got = shift_tokens_right(torch.from_numpy(ids), 1, None)
    else:
        want = flax_shift(jnp.asarray(ids), 1, 2)
        got = shift_tokens_right(torch.from_numpy(ids), 1, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_trunk_padding_rows_match_flax(dirs):
    """mBART's decoder state on ids with an all-padding row of pad ids and
    one of zeros against FlaxMBartModel's on the same ids: finite, and
    equal to 1e-5."""
    path = dirs["mbart"]
    flax = tf.FlaxAutoModel.from_pretrained(str(path), from_pt=True, local_files_only=True)
    config, state = load_checkpoint(path, head=False, pooler=False)
    model = build_trunk(config, torch.float32)
    model.load_state_dict(state)
    rng = np.random.default_rng(4)
    ids = rng.integers(4, 60, (4, 16))
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    mask[2:] = 0
    ids[mask == 0] = config.pad_token_id
    ids[3] = 0
    want = np.asarray(flax(input_ids=ids, attention_mask=mask, params=flax.params,
                           train=False).last_hidden_state)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("family", ["pegasus", "marian"])
def test_saved_sinusoids_are_not_read(dirs, tmp_path, family):
    """Flax computes Marian's and Pegasus's sinusoids and reads no saved
    table: a checkpoint whose embed_positions.weight was changed gives
    Flax's embeddings, unchanged."""
    from safetensors.torch import save_file

    src = dirs[family]
    for f in src.iterdir():
        if f.is_file():
            (tmp_path / f.name).write_bytes(f.read_bytes())
    state = {k: v.clone() for k, v in read_safetensors(src / "model.safetensors").items()}
    names = [k for k in state if k.endswith("embed_positions.weight")]
    assert len(names) == 2
    # the table PyTorch computes is the port's; the saved one was moved
    # off it with every other weight, and is moved again here
    cfg_cls, trunk, base = FAMILIES[family]
    fresh = trunk(cfg_cls(vocab_size=8, pad_token_id=0, decoder_start_token_id=0,
                          **{**GEOMETRY, **base})).encoder.embed_positions
    np.testing.assert_allclose(fresh.weight.detach().numpy(), sinusoids(64, D), atol=1e-6)
    assert np.abs(state[names[0]].numpy() - sinusoids(64, D)).max() > 0.05
    for k in names:
        state[k] += 1.0
    save_file(state, str(tmp_path / "model.safetensors"), metadata={"format": "pt"})
    want = JEmbedder(str(tmp_path), max_len=MAX_LEN).encode(TEXTS[:4])
    got = HFEmbedder(tmp_path, max_len=MAX_LEN, device="cpu").encode(TEXTS[:4])
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(
        got, HFEmbedder(src, max_len=MAX_LEN, device="cpu").encode(TEXTS[:4]), atol=1e-6)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_reranker_is_refused(dirs, family):
    """None of the six reranks in JAX: BART and mBART raise TypeError at
    the first score (token_type_ids), the others ValueError at
    construction (no Flax sequence classifier); the port raises ValueError
    at construction, naming why."""
    path = dirs[family]
    if family in ("bart", "mbart"):
        jce = JCross(str(path), max_len=MAX_LEN)
        with pytest.raises(TypeError, match="token_type_ids"):
            jce.score_pairs(["q"], ["d"])
        match = "passes token_type_ids"
    else:
        with pytest.raises(ValueError, match="Unrecognized configuration class"):
            JCross(str(path), max_len=MAX_LEN)
        match = "has no class for it"
    with pytest.raises(ValueError, match=match):
        HFCrossEncoder(path, max_len=MAX_LEN, device="cpu")


def test_config_refusals(tmp_path):
    """Where Flax computes another model than the checkpoint's, read_config
    raises naming the field: Marian's share_encoder_decoder_embeddings
    false (Flax feeds its decoder the shared table, PyTorch its own), a
    decoder_start_token_id of null outside mBART (Flax's shift cannot run),
    an activation Flax's ACT2FN and the port do not share; max_len past
    Blenderbot's 128 positions raises at construction."""
    cases = [("marian", dict(share_encoder_decoder_embeddings=False),
              "share_encoder_decoder_embeddings false"),
             ("bart", dict(decoder_start_token_id=None), "decoder_start_token_id null"),
             ("pegasus", dict(activation_function="quick_gelu"),
              "activation_function 'quick_gelu'")]
    for family, extra, match in cases:
        (tmp_path / "config.json").write_text(json.dumps({"model_type": family, **extra}))
        with pytest.raises(ValueError, match=match):
            read_config(tmp_path)
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "mbart", "decoder_start_token_id": None}))
    assert read_config(tmp_path).decoder_start_token_id is None


def test_flax_marian_feeds_its_decoder_the_shared_table(tmp_path):
    """With share_encoder_decoder_embeddings false PyTorch's Marian embeds
    the decoder's ids with decoder.embed_tokens; Flax's reads the shared
    table, so the reference computes another model than the checkpoint
    holds, and the port refuses the config (test_config_refusals)."""
    cfg = tf.MarianConfig(vocab_size=64, **{**GEOMETRY, "encoder_layers": 1,
                                             "decoder_layers": 1}, pad_token_id=0,
                          decoder_start_token_id=0, share_encoder_decoder_embeddings=False)
    torch.manual_seed(0)
    model = tf.MarianModel(cfg).eval()
    model.save_pretrained(tmp_path)
    ids = np.array([[5, 6, 7, 8, 2]])
    flax = tf.FlaxAutoModel.from_pretrained(str(tmp_path), from_pt=True, local_files_only=True)
    want = np.asarray(flax(input_ids=ids, attention_mask=np.ones_like(ids)).last_hidden_state)
    with torch.no_grad():
        got = model(input_ids=torch.from_numpy(ids),
                    decoder_input_ids=torch.tensor([[0, 5, 6, 7, 8]])).last_hidden_state
    assert float(np.abs(got.numpy() - want).max()) > 1e-2
    with pytest.raises(ValueError, match="share_encoder_decoder_embeddings false"):
        read_config(tmp_path)


def test_max_len_past_the_positions_is_refused(dirs):
    with pytest.raises(ValueError, match="exceeds the 64 positions"):
        HFEmbedder(dirs["blenderbot"], max_len=65, device="cpu")
    HFEmbedder(dirs["bart"], max_len=64, device="cpu")


def test_families_read_their_defaults(tmp_path):
    """A config.json with model_type alone takes the family's class
    defaults (transformers' config classes)."""
    classes = {"bart": tf.BartConfig, "mbart": tf.MBartConfig, "pegasus": tf.PegasusConfig,
               "marian": tf.MarianConfig, "blenderbot": tf.BlenderbotConfig,
               "blenderbot-small": tf.BlenderbotSmallConfig}
    assert set(classes) == set(ENCDEC)
    for family, cls in classes.items():
        (tmp_path / "config.json").write_text(json.dumps({"model_type": family}))
        c, d = read_config(tmp_path), cls()
        assert (c.vocab_size, c.hidden_size, c.num_hidden_layers, c.decoder_layers,
                c.num_attention_heads, c.decoder_attention_heads, c.intermediate_size,
                c.decoder_ffn_dim, c.hidden_act, c.max_position_embeddings,
                c.scale_embedding, c.pad_token_id) == (
            d.vocab_size, d.d_model, d.encoder_layers, d.decoder_layers,
            d.encoder_attention_heads, d.decoder_attention_heads, d.encoder_ffn_dim,
            d.decoder_ffn_dim, d.activation_function, d.max_position_embeddings,
            d.scale_embedding, d.pad_token_id), family
        assert c.decoder_start_token_id == (None if family == "mbart"
                                            else d.decoder_start_token_id)
        assert c.position_offset == 0


@pytest.fixture(scope="module")
def pipelines(dirs, tmp_path_factory):
    """Both packages' pipelines on one corpus: a BART HFEmbedder in the
    manager and a BERT HFCrossEncoder as the reranker (none of the six
    reranks), as RAG_RERANKER=hf: wires them."""
    jcfg, tcfg = configs()
    ce = tmp_path_factory.mktemp("encdec-ce") / "ce"
    write_checkpoint(ce, head=True, seed=1)
    emb = dirs["bart"]
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


def test_pipeline_with_bart_embedder(pipelines):
    """The slice's /retrieve path on the CPU: ingest, hybrid retrieval and
    the rerank give the same ranking in both packages."""
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

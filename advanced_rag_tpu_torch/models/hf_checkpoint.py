"""A local HF encoder checkpoint read without ``transformers``.

The port's copy of what ``from_pretrained`` does for the encoder families
that JAX's ``FlaxAutoModel`` / ``FlaxAutoModelForSequenceClassification``
load for a RAG deployment:

- ``config.json``: ``model_type`` ``bert``, ``roberta``, ``xlm-roberta``,
  ``electra``, ``distilbert``, ``roberta-prelayernorm``, ``albert``,
  ``big_bird`` or ``roformer`` (``HFConfig``, one dataclass with the
  families' fields; a key the file leaves out takes the default of
  transformers' config class for the family), ``hidden_act`` ``gelu``
  (erf), ``gelu_new`` / ``gelu_pytorch_tanh`` (tanh) or ``relu``,
  ``position_embedding_type`` ``absolute``; anything else raises
  ``ValueError`` naming it.  Where Flax computes another model than the
  checkpoint holds, it raises naming the field: a RoFormer
  ``embedding_size`` other than ``hidden_size`` (Flax RoFormer has no
  ``embeddings_project``) and a BigBird ``attention_type`` other than
  ``original_full`` / ``block_sparse``;
- the decoder families ``llama``, ``mistral`` and ``gemma`` (``DECODERS``),
  with their grouped-query heads, ``head_dim``, ``rms_norm_eps``,
  ``hidden_act`` (``silu``; Gemma's ``hidden_activation``, whose None is
  the tanh GELU), ``attention_bias`` and Mistral's ``sliding_window``.
  Where Flax's modules compute another model than the checkpoint's,
  ``read_config`` raises naming the field: ``rope_theta`` other than
  10000 and any ``rope_scaling`` (Flax hard-codes theta 10000 and no
  scaling), Mistral's ``sliding_window: null`` (Flax then lets each token
  see only itself), a Llama / Mistral ``head_dim`` other than hidden /
  heads (Flax ignores it), ``mlp_bias`` (Flax's MLP has none), and
  ``max_position_embeddings`` under twice the head width (Flax cuts its
  sin/cos table to that many columns);
- the encoder-decoder families ``bart``, ``mbart``, ``pegasus``,
  ``marian``, ``blenderbot`` and ``blenderbot-small`` (``ENCDEC``): their
  ``d_model``, each stack's layers, heads and FFN width,
  ``activation_function``, ``scale_embedding``, ``pad_token_id`` and
  ``decoder_start_token_id``.  Where Flax computes another model than the
  checkpoint's, ``read_config`` raises naming the field: Marian's
  ``share_encoder_decoder_embeddings: false`` (Flax feeds the decoder the
  shared table, PyTorch its own ``decoder.embed_tokens``), and a
  ``decoder_start_token_id`` of null outside mBART (Flax's shift cannot
  start the decoder row);
- the GPT families ``gpt2`` / ``gpt-sw3``, ``gpt_neo``, ``gptj``, ``bloom``
  and ``xglm`` (``GPT``): each family's own field names (GPT-2's
  ``n_embd``, ``n_layer``, ``n_head``, ``n_inner``, ``n_positions``;
  GPT-Neo's ``attention_types`` and ``window_size``; GPT-J's
  ``rotary_dim``; BLOOM's ``n_embed`` / ``hidden_size``, ``n_head`` and
  ``apply_residual_connection_post_layernorm``; XGLM's ``d_model``,
  ``num_layers``, ``attention_heads``, ``ffn_dim`` and
  ``scale_embedding``), ``layer_norm_epsilon`` and
  ``activation_function``.  Where Flax computes another model than the
  checkpoint's, ``read_config`` raises naming the field: GPT-2's
  ``scale_attn_weights: false`` and ``scale_attn_by_inverse_layer_idx:
  true`` (Flax reads neither), GPT-J's ``rotary_dim: null`` (both
  frameworks then rotate the heads with a table as wide as the model,
  which no head fits), a BLOOM ``n_head`` that is not a power of two
  (Flax's ALiBi slopes then call ``jnp.cat``, which does not exist) and
  BLOOM's ``slow_but_exact: true`` with ``pretraining_tp`` over 1
  (PyTorch then drops the dense layers' biases, Flax reads neither);
- the weights: ``model.safetensors`` (a hand parser: an 8-byte header
  length, a JSON header, raw little-endian F32/F16/BF16/I64 bytes read
  with ``torch.frombuffer``), else ``pytorch_model.bin``
  (``torch.load(weights_only=True)``), or the sharded ``*.index.json``
  form of either; a directory with ``flax_model.msgpack`` alone raises,
  naming ``scripts/torch_export_hf.py``, which converts it;
- the names (``family_state``): legacy ``LayerNorm.gamma`` / ``beta``
  become ``weight`` / ``bias``, the ``position_ids`` buffer is dropped, the
  family's prefix (``bert.``, ``roberta.`` for RoBERTa and XLM-R,
  ``electra.``, ``distilbert.``; ``model.`` for the decoders) is added or
  removed to fit the module, the decoders' ``rotary_emb.inv_freq`` buffers
  are dropped, and the weights of heads the module does not run (MLM, LM,
  discriminator, a decoder's ``lm_head``) are left out, as
  ``from_pretrained`` leaves them.  An encoder-decoder's ``shared.weight``
  feeds both stacks (``encoder.`` / ``decoder.embed_tokens.weight``, its
  tied copies, are dropped), and Marian's and Pegasus's saved
  ``embed_positions.weight`` is dropped: Flax computes the sinusoids
  itself and reads neither.  The GPT families' prefix is ``transformer.``
  (XGLM's ``model.``; a bare ``GPT2Model`` has none); old GPT-2, GPT-Neo
  and GPT-J checkpoints' causal-mask buffers (``attn.bias``,
  ``attn.masked_bias``), GPT-2's cross-attention weights (Flax builds
  them, but no embedder feeds them) and any saved ``embed_positions``
  are dropped.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

ACTIVATIONS = ("gelu", "gelu_new", "gelu_pytorch_tanh", "relu")
#: the decoders' MLP gates: their own SiLU besides the encoders' activations
DECODER_ACTIVATIONS = ACTIVATIONS + ("silu", "swish")
#: the decoder-only families (hf_llama.py); the JAX cross-encoder's class
#: has no sequence classifier for them
DECODERS = ("llama", "mistral", "gemma")
#: the encoder families of the second group (hf_roberta_prelayernorm.py,
#: hf_albert.py, hf_big_bird.py, hf_roformer.py)
ENCODERS_MORE = ("roberta-prelayernorm", "albert", "big_bird", "roformer")
#: the encoder-decoder families (hf_bart.py); JAX's cross-encoder serves none
ENCDEC = ("bart", "mbart", "pegasus", "marian", "blenderbot", "blenderbot-small")
#: the encoder-decoders whose positions are sinusoids computed at build time
SINUSOIDAL = ("pegasus", "marian")
#: the GPT families (hf_gpt2.py, hf_bloom.py, hf_xglm.py); JAX's
#: cross-encoder serves none
GPT = ("gpt2", "gpt-sw3", "gpt_neo", "gptj", "bloom", "xglm")
#: the families whose trunk is built without storage and filled from the
#: checkpoint on the device (no buffer to initialize)
LARGE = DECODERS + ENCDEC + GPT
FAMILIES = (("bert", "roberta", "xlm-roberta", "electra", "distilbert") + ENCODERS_MORE
            + DECODERS + ENCDEC + GPT)
#: the attention types of Flax BigBird
BIG_BIRD_ATTENTION = ("original_full", "block_sparse")
_DTYPES = {"F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64}
_EXPORT_HINT = ("convert it with scripts/torch_export_hf.py (where "
                "transformers and Flax are installed), which writes "
                "model.safetensors beside it")
#: each family's weight prefix in a model with a head, and the top-level
#: modules of its trunk
_PREFIX = {"bert": "bert.", "roberta": "roberta.", "xlm-roberta": "roberta.",
           "electra": "electra.", "distilbert": "distilbert.",
           "roberta-prelayernorm": "roberta_prelayernorm.", "albert": "albert.",
           "big_bird": "bert.", "roformer": "roformer.",
           **{f: "model." for f in DECODERS + ENCDEC + ("xglm",)},
           **{f: "transformer." for f in GPT if f != "xglm"}}
_TRUNK = {"bert": ("embeddings.", "encoder."),
          "roberta": ("embeddings.", "encoder."),
          "xlm-roberta": ("embeddings.", "encoder."),
          "electra": ("embeddings.", "embeddings_project.", "encoder."),
          "distilbert": ("embeddings.", "transformer."),
          "roberta-prelayernorm": ("embeddings.", "encoder.", "LayerNorm."),
          "albert": ("embeddings.", "encoder."),
          "big_bird": ("embeddings.", "encoder."),
          "roformer": ("embeddings.", "encoder."),
          **{f: ("embed_tokens.", "layers.", "norm.") for f in DECODERS},
          **{f: ("shared.", "encoder.", "decoder.") for f in ENCDEC},
          **{f: ("wte.", "wpe.", "h.", "ln_f.") for f in GPT},
          "bloom": ("word_embeddings.", "word_embeddings_layernorm.", "h.", "ln_f."),
          "xglm": ("embed_tokens.", "layers.", "layer_norm.")}
#: the GPT families' saved buffers and the weights no embedder runs (old
#: checkpoints' causal masks, GPT-2's cross-attention, saved position
#: tables Flax computes itself), by the end of their names
_GPT_DROPPED = (".attn.bias", ".attn.masked_bias", ".attn.attention.bias",
                ".attn.attention.masked_bias", ".attn.embed_positions")
_GPT_DROPPED_PARTS = (".crossattention.", ".ln_cross_attn.", "embed_positions.")
#: the families whose sequence classifier reads the pooler (BERT's and
#: ALBERT's); the others' trunks never run theirs
_POOLED = ("bert", "albert")
#: the classification head's weights (DistilBERT serves as an embedder
#: only, so its ``pre_classifier`` / ``classifier`` are always left out)
_HEAD = {"bert": ("classifier.",),
         "roberta": ("classifier.dense.", "classifier.out_proj."),
         "xlm-roberta": ("classifier.dense.", "classifier.out_proj."),
         "electra": ("classifier.dense.", "classifier.out_proj."),
         "roberta-prelayernorm": ("classifier.dense.", "classifier.out_proj."),
         "albert": ("classifier.",),
         "big_bird": ("classifier.dense.", "classifier.out_proj."),
         "roformer": ("classifier.dense.", "classifier.out_proj.")}
# BartConfig's defaults (bart-large's geometry), under the other
# encoder-decoders' own
_ENCDEC_BASE = dict(vocab_size=50265, d_model=1024, encoder_layers=12, decoder_layers=12,
                    encoder_attention_heads=16, decoder_attention_heads=16,
                    encoder_ffn_dim=4096, decoder_ffn_dim=4096,
                    activation_function="gelu", max_position_embeddings=1024,
                    scale_embedding=False, pad_token_id=1, decoder_start_token_id=2)
# transformers' config classes' defaults, where a family's differ from
# BertConfig's (DistilBERT's names are read in read_config)
_DEFAULTS = {"roberta": dict(pad_token_id=1), "xlm-roberta": dict(pad_token_id=1),
             "roberta-prelayernorm": dict(pad_token_id=1, vocab_size=50265),
             "albert": dict(vocab_size=30000, embedding_size=128, hidden_size=4096,
                            num_attention_heads=64, intermediate_size=16384,
                            hidden_act="gelu_new"),
             "big_bird": dict(vocab_size=50358, hidden_act="gelu_new",
                              max_position_embeddings=4096),
             "roformer": dict(vocab_size=50000, max_position_embeddings=1536),
             "electra": dict(hidden_size=256, num_attention_heads=4,
                             intermediate_size=1024, embedding_size=128),
             "llama": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                           num_hidden_layers=32, num_attention_heads=32,
                           max_position_embeddings=2048, hidden_act="silu"),
             "mistral": dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                             num_hidden_layers=32, num_attention_heads=32,
                             num_key_value_heads=8, max_position_embeddings=131072,
                             hidden_act="silu", sliding_window=4096),
             "gemma": dict(vocab_size=256000, hidden_size=3072, intermediate_size=24576,
                           num_hidden_layers=28, num_attention_heads=16,
                           num_key_value_heads=16, head_dim=256,
                           max_position_embeddings=8192, tie_word_embeddings=True),
             **{f: _ENCDEC_BASE for f in ("bart", "mbart")},
             "pegasus": dict(_ENCDEC_BASE, pad_token_id=0, decoder_start_token_id=0),
             "marian": dict(_ENCDEC_BASE, vocab_size=58101, pad_token_id=58100,
                            decoder_start_token_id=58100),
             "blenderbot": dict(_ENCDEC_BASE, vocab_size=8008, d_model=2560,
                                encoder_layers=2, decoder_layers=24,
                                encoder_attention_heads=32, decoder_attention_heads=32,
                                encoder_ffn_dim=10240, decoder_ffn_dim=10240,
                                max_position_embeddings=128, pad_token_id=0,
                                decoder_start_token_id=1),
             "blenderbot-small": dict(_ENCDEC_BASE, d_model=512, encoder_layers=8,
                                      decoder_layers=8, encoder_ffn_dim=2048,
                                      decoder_ffn_dim=2048, max_position_embeddings=512,
                                      pad_token_id=0, decoder_start_token_id=1)}


@dataclass(frozen=True)
class HFConfig:
    vocab_size: int
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    intermediate_size: int
    max_position_embeddings: int
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    num_labels: int = 2
    model_type: str = "bert"
    #: RoBERTa / XLM-R / RoBERTa-PreLayerNorm: the padding id, which sets
    #: the position offset
    pad_token_id: int = 0
    #: ELECTRA, ALBERT: the embeddings' width (``hidden_size`` when None)
    embedding_size: Optional[int] = None
    #: ALBERT: the groups of shared layers and the layers in each group
    num_hidden_groups: int = 1
    inner_group_num: int = 1
    #: BigBird: ``original_full`` or ``block_sparse``, the block width,
    #: the random blocks of each query block, biases on Q/K/V, and the word
    #: embeddings scaled by sqrt(hidden_size)
    attention_type: Optional[str] = None
    block_size: int = 64
    num_random_blocks: int = 3
    use_bias: bool = True
    rescale_embeddings: bool = False
    #: RoFormer: the rotary positions also rotate the values
    rotary_value: bool = False
    #: DistilBERT: Flax's fixed sinusoidal table instead of the learned one
    sinusoidal_pos_embds: bool = False
    #: the decoders: KV heads, the head width Flax takes (Gemma's
    #: ``head_dim``, else hidden / heads), RMSNorm's eps, biases on the
    #: attention's projections, Mistral's window (keys up to this many
    #: positions back), and whether the (unused) LM head shares the
    #: embeddings
    num_key_value_heads: int = 0
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-6
    attention_bias: bool = False
    sliding_window: Optional[int] = None
    tie_word_embeddings: bool = False
    #: the encoder-decoders: the decoder stack's layers, heads and FFN
    #: width (the encoder's are ``num_hidden_layers``,
    #: ``num_attention_heads``, ``intermediate_size``), the token
    #: embeddings scaled by sqrt(d_model), and the id that starts the
    #: decoder's row (None for mBART, which starts it with the row's last
    #: non-pad token)
    decoder_layers: int = 0
    decoder_attention_heads: int = 0
    decoder_ffn_dim: int = 0
    scale_embedding: bool = False
    decoder_start_token_id: Optional[int] = None
    #: the GPT families: GPT-J's rotated head columns, GPT-Neo's local
    #: window and each layer's attention ("global" or "local"), BLOOM's
    #: residuals taken after the LayerNorms
    rotary_dim: Optional[int] = None
    window_size: int = 0
    attention_layers: Tuple[str, ...] = ()
    residual_post_ln: bool = False

    @property
    def position_offset(self) -> int:
        """How far past ``max_len - 1`` the position ids of a row reach:
        RoBERTa's start at ``pad_token_id + 1``."""
        return (self.pad_token_id + 1 if self.model_type in
                ("roberta", "xlm-roberta", "roberta-prelayernorm") else 0)


def checkpoint_dir(path) -> Path:
    """``path`` as a directory; anything else raises FileNotFoundError."""
    path = Path(path)
    if not path.is_dir():
        raise FileNotFoundError(f"{path} is not a checkpoint directory")
    return path


def read_json(path) -> dict:
    return json.loads(Path(path).read_text())


def read_config(path) -> HFConfig:
    """``config.json`` of an encoder checkpoint of one of ``FAMILIES``;
    other families, and options the port does not run, raise."""
    cfg = read_json(checkpoint_dir(path) / "config.json")
    model_type = cfg.get("model_type")
    if model_type not in FAMILIES:
        raise ValueError(
            f"{path}: model_type {model_type!r} is not supported; the port "
            f"reads {', '.join(map(repr, FAMILIES))} checkpoints")
    what = f"{path}: model_type {model_type!r}:"
    if model_type in DECODERS:
        return _decoder_config(cfg, model_type, what)
    if model_type in ENCDEC:
        return _encdec_config(cfg, model_type, what)
    if model_type in GPT:
        return _gpt_config(cfg, model_type, what)
    if model_type == "distilbert":
        cfg = dict(cfg, hidden_size=cfg.get("dim", 768),
                   intermediate_size=cfg.get("hidden_dim", 3072),
                   num_hidden_layers=cfg.get("n_layers", 6),
                   num_attention_heads=cfg.get("n_heads", 12),
                   hidden_act=cfg.get("activation", "gelu"),
                   # no token types; Flax's LayerNorms take 1e-12 always
                   type_vocab_size=0, layer_norm_eps=1e-12)
    cfg = {**_DEFAULTS.get(model_type, {}), **cfg}
    act = cfg.get("hidden_act", "gelu")
    if act not in ACTIVATIONS:
        raise ValueError(f"{what} hidden_act {act!r} is not supported "
                         f"(supported: {', '.join(ACTIVATIONS)})")
    pos = cfg.get("position_embedding_type", "absolute")
    if pos != "absolute":
        raise ValueError(f"{what} position_embedding_type {pos!r} is not "
                         "supported (only 'absolute')")
    if cfg.get("is_decoder"):
        raise ValueError(f"{what} a decoder (is_decoder) is not supported")
    # as PretrainedConfig: id2label decides num_labels when it is written
    num_labels = (len(cfg["id2label"]) if cfg.get("id2label")
                  else int(cfg.get("num_labels", 2)))
    hidden = int(cfg.get("hidden_size", 768))
    embedding = cfg.get("embedding_size")
    if model_type == "roformer" and embedding not in (None, hidden):
        raise ValueError(f"{what} embedding_size {embedding} is not supported: the JAX "
                         f"reference's Flax RoFormer has no embeddings_project and "
                         f"takes hidden_size {hidden} for the embeddings")
    attention = cfg.get("attention_type", "block_sparse")
    if model_type == "big_bird" and attention not in BIG_BIRD_ATTENTION:
        raise ValueError(f"{what} attention_type {attention!r} is not supported "
                         f"(supported: {', '.join(BIG_BIRD_ATTENTION)})")
    return HFConfig(
        vocab_size=int(cfg.get("vocab_size", 30522)), hidden_size=hidden,
        num_hidden_layers=int(cfg.get("num_hidden_layers", 12)),
        num_attention_heads=int(cfg.get("num_attention_heads", 12)),
        intermediate_size=int(cfg.get("intermediate_size", 3072)),
        max_position_embeddings=int(cfg.get("max_position_embeddings", 512)),
        type_vocab_size=int(cfg.get("type_vocab_size", 2)),
        layer_norm_eps=float(cfg.get("layer_norm_eps", 1e-12)),
        hidden_act=act, num_labels=num_labels, model_type=model_type,
        pad_token_id=int(cfg.get("pad_token_id") or 0),
        embedding_size=(int(cfg.get("embedding_size", hidden))
                        if model_type in ("electra", "albert") else None),
        sinusoidal_pos_embds=bool(cfg.get("sinusoidal_pos_embds", False)),
        num_hidden_groups=int(cfg.get("num_hidden_groups", 1)),
        inner_group_num=int(cfg.get("inner_group_num", 1)),
        attention_type=attention if model_type == "big_bird" else None,
        block_size=int(cfg.get("block_size", 64)),
        num_random_blocks=int(cfg.get("num_random_blocks", 3)),
        use_bias=bool(cfg.get("use_bias", True)),
        rescale_embeddings=bool(cfg.get("rescale_embeddings", False)),
        rotary_value=bool(cfg.get("rotary_value", False)))


def _decoder_config(cfg: dict, model_type: str, what: str) -> HFConfig:
    """The config of a Llama, Mistral or Gemma checkpoint; the fields that
    Flax's module would compute another model from raise."""
    cfg = {**_DEFAULTS[model_type], **cfg}
    if model_type == "gemma":
        # FlaxGemmaMLP: hidden_activation, else the tanh GELU (hidden_act unread)
        act = cfg.get("hidden_activation") or "gelu_pytorch_tanh"
    else:
        act = cfg.get("hidden_act", "silu")
    if act not in DECODER_ACTIVATIONS:
        raise ValueError(f"{what} hidden_act {act!r} is not supported "
                         f"(supported: {', '.join(DECODER_ACTIVATIONS)})")
    theta = float(cfg.get("rope_theta", 10000.0))
    if theta != 10000.0:
        raise ValueError(f"{what} rope_theta {theta:g} is not supported: the JAX "
                         "reference's Flax module hard-codes 10000")
    if cfg.get("rope_scaling") is not None:
        raise ValueError(f"{what} rope_scaling {cfg['rope_scaling']!r} is not "
                         "supported: the JAX reference's Flax module ignores it")
    if cfg.get("mlp_bias"):
        raise ValueError(f"{what} mlp_bias is not supported: the JAX reference's "
                         "Flax MLP has no biases")
    hidden, heads = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    kv = int(cfg.get("num_key_value_heads") or heads)
    if heads % kv:
        raise ValueError(f"{what} num_key_value_heads {kv} does not divide the "
                         f"{heads} attention heads")
    window = cfg.get("sliding_window")
    if model_type == "gemma":
        dim = int(cfg["head_dim"])
    else:
        if hidden % heads:
            raise ValueError(f"{what} num_attention_heads {heads} does not divide "
                             f"hidden_size {hidden}")
        dim = hidden // heads
        if cfg.get("head_dim") not in (None, dim):
            raise ValueError(f"{what} head_dim {cfg['head_dim']} is not supported: "
                             f"the JAX reference's Flax module takes hidden_size / "
                             f"num_attention_heads = {dim}")
        if model_type == "mistral" and window is None:
            raise ValueError(f"{what} sliding_window null is not supported: the JAX "
                             "reference's Flax Mistral then lets each token attend "
                             "only to itself")
    positions = int(cfg["max_position_embeddings"])
    if positions < 2 * dim:
        raise ValueError(f"{what} max_position_embeddings {positions} is under twice "
                         f"the head width {dim}: the JAX reference's Flax module cuts "
                         "its sin/cos table to that many columns")
    return HFConfig(
        vocab_size=int(cfg["vocab_size"]), hidden_size=hidden,
        num_hidden_layers=int(cfg["num_hidden_layers"]), num_attention_heads=heads,
        intermediate_size=int(cfg["intermediate_size"]),
        max_position_embeddings=positions, type_vocab_size=0, hidden_act=act,
        model_type=model_type, pad_token_id=int(cfg.get("pad_token_id") or 0),
        num_key_value_heads=kv, head_dim=dim,
        rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-6)),
        attention_bias=bool(cfg.get("attention_bias") or False),
        sliding_window=None if window is None else int(window),
        tie_word_embeddings=bool(cfg.get("tie_word_embeddings", False)))


def _encdec_config(cfg: dict, model_type: str, what: str) -> HFConfig:
    """The config of a BART-like encoder-decoder checkpoint; the fields
    that Flax's module would compute another model from raise."""
    cfg = {**_DEFAULTS[model_type], **cfg}
    act = cfg.get("activation_function", "gelu")
    if act not in DECODER_ACTIVATIONS:
        raise ValueError(f"{what} activation_function {act!r} is not supported "
                         f"(supported: {', '.join(DECODER_ACTIVATIONS)})")
    if model_type == "marian" and not cfg.get("share_encoder_decoder_embeddings", True):
        raise ValueError(f"{what} share_encoder_decoder_embeddings false is not "
                         "supported: the JAX reference's Flax Marian feeds the decoder "
                         "the shared table, not the checkpoint's decoder.embed_tokens")
    start = cfg.get("decoder_start_token_id")
    if start is None and model_type != "mbart":
        raise ValueError(f"{what} decoder_start_token_id null is not supported: the "
                         "JAX reference's Flax shift_tokens_right needs it")
    d = int(cfg["d_model"])
    for side in ("encoder", "decoder"):
        heads = int(cfg[f"{side}_attention_heads"])
        if d % heads:
            raise ValueError(f"{what} {side}_attention_heads {heads} does not divide "
                             f"d_model {d}")
    pad = cfg.get("pad_token_id")
    if pad is None:
        raise ValueError(f"{what} pad_token_id null is not supported: the decoder's "
                         "shift needs it")
    return HFConfig(
        vocab_size=int(cfg["vocab_size"]), hidden_size=d,
        num_hidden_layers=int(cfg["encoder_layers"]),
        num_attention_heads=int(cfg["encoder_attention_heads"]),
        intermediate_size=int(cfg["encoder_ffn_dim"]),
        max_position_embeddings=int(cfg["max_position_embeddings"]), type_vocab_size=0,
        layer_norm_eps=1e-5, hidden_act=act, model_type=model_type, pad_token_id=int(pad),
        decoder_layers=int(cfg["decoder_layers"]),
        decoder_attention_heads=int(cfg["decoder_attention_heads"]),
        decoder_ffn_dim=int(cfg["decoder_ffn_dim"]),
        scale_embedding=bool(cfg.get("scale_embedding", False)),
        decoder_start_token_id=None if model_type == "mbart" else int(start))


# transformers' config classes' defaults, under each GPT family's own names
_GPT_DEFAULTS = {
    "gpt2": dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12, n_head=12,
                 activation_function="gelu_new", layer_norm_epsilon=1e-5),
    "gpt_neo": dict(vocab_size=50257, max_position_embeddings=2048, hidden_size=2048,
                    num_layers=24, num_heads=16, window_size=256,
                    activation_function="gelu_new", layer_norm_epsilon=1e-5,
                    attention_types=[[["global", "local"], 12]]),
    "gptj": dict(vocab_size=50400, n_positions=2048, n_embd=4096, n_layer=28, n_head=16,
                 rotary_dim=64, activation_function="gelu_new", layer_norm_epsilon=1e-5),
    "bloom": dict(vocab_size=250880, hidden_size=64, n_layer=2, n_head=8,
                  layer_norm_epsilon=1e-5),
    "xglm": dict(vocab_size=256008, max_position_embeddings=2048, d_model=1024,
                 ffn_dim=4096, num_layers=24, attention_heads=16,
                 activation_function="gelu", scale_embedding=True, pad_token_id=1),
}
_GPT_DEFAULTS["gpt-sw3"] = _GPT_DEFAULTS["gpt2"]


def _gpt_config(cfg: dict, model_type: str, what: str) -> HFConfig:
    """The config of a GPT-2 / GPT-SW3, GPT-Neo, GPT-J, BLOOM or XGLM
    checkpoint, read under each family's own field names; the fields that
    Flax's module would compute another model from raise."""
    cfg = {**_GPT_DEFAULTS[model_type], **cfg}
    act = cfg.get("activation_function", "gelu_new")
    if model_type != "bloom" and act not in DECODER_ACTIVATIONS:
        raise ValueError(f"{what} activation_function {act!r} is not supported "
                         f"(supported: {', '.join(DECODER_ACTIVATIONS)})")
    if model_type in ("gpt2", "gpt-sw3"):
        if not cfg.get("scale_attn_weights", True):
            raise ValueError(f"{what} scale_attn_weights false is not supported: the JAX "
                             "reference's Flax GPT-2 ignores it and divides the logits "
                             "by sqrt(head_dim)")
        if cfg.get("scale_attn_by_inverse_layer_idx"):
            raise ValueError(f"{what} scale_attn_by_inverse_layer_idx true is not "
                             "supported: the JAX reference's Flax GPT-2 ignores it")
    if model_type == "xglm":
        hidden, layers = int(cfg["d_model"]), int(cfg["num_layers"])
        heads, inner = int(cfg["attention_heads"]), int(cfg["ffn_dim"])
        positions, eps = int(cfg["max_position_embeddings"]), 1e-5
    elif model_type == "bloom":
        # BloomConfig takes the older n_embed over hidden_size
        hidden = int(cfg.get("n_embed") or cfg["hidden_size"])
        layers, heads, inner = int(cfg["n_layer"]), int(cfg["n_head"]), 4 * hidden
        positions, eps = 0, float(cfg["layer_norm_epsilon"])
        if heads & (heads - 1):
            raise ValueError(f"{what} n_head {heads} is not supported: the JAX reference's "
                             "Flax ALiBi slopes for a head count that is not a power of "
                             "two call jnp.cat, which does not exist (AttributeError)")
        if cfg.get("slow_but_exact") and int(cfg.get("pretraining_tp") or 1) > 1:
            raise ValueError(f"{what} slow_but_exact true with pretraining_tp "
                             f"{cfg['pretraining_tp']} is not supported: PyTorch's BLOOM then "
                             "leaves out the dense layers' biases, which the JAX "
                             "reference's Flax BLOOM adds (it reads neither field)")
    elif model_type == "gpt_neo":
        hidden, layers = int(cfg["hidden_size"]), int(cfg["num_layers"])
        heads = int(cfg["num_heads"])
        inner = int(cfg.get("intermediate_size") or 4 * hidden)
        positions, eps = int(cfg["max_position_embeddings"]), float(cfg["layer_norm_epsilon"])
    else:
        hidden, layers, heads = int(cfg["n_embd"]), int(cfg["n_layer"]), int(cfg["n_head"])
        inner = int(cfg.get("n_inner") or 4 * hidden)
        positions, eps = int(cfg["n_positions"]), float(cfg["layer_norm_epsilon"])
    if hidden % heads:
        raise ValueError(f"{what} {heads} heads do not divide the width {hidden}")
    attention = ()
    if model_type == "gpt_neo":
        attention = tuple(kind for kinds, n in cfg["attention_types"]
                          for _ in range(int(n)) for kind in kinds)
        if len(attention) != layers or set(attention) - {"global", "local"}:
            raise ValueError(f"{what} attention_types {cfg['attention_types']!r} do not "
                             f"give 'global' or 'local' to each of the {layers} layers")
    rotary = cfg.get("rotary_dim")
    if model_type == "gptj" and rotary is None:
        raise ValueError(f"{what} rotary_dim null is not supported: the JAX reference's "
                         "Flax GPT-J then rotates each head with a table as wide as the "
                         "model, which does not fit a head")
    pad = cfg.get("pad_token_id")
    return HFConfig(
        vocab_size=int(cfg["vocab_size"]), hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, intermediate_size=inner,
        max_position_embeddings=positions, type_vocab_size=0, layer_norm_eps=eps,
        hidden_act="gelu_new" if model_type == "bloom" else act, model_type=model_type,
        pad_token_id=int(pad or 0),
        scale_embedding=bool(cfg.get("scale_embedding", False)),
        rotary_dim=int(rotary) if model_type == "gptj" else None,
        window_size=int(cfg.get("window_size") or 0) if model_type == "gpt_neo" else 0,
        attention_layers=attention,
        residual_post_ln=bool(cfg.get("apply_residual_connection_post_layernorm", False)))


def read_safetensors(file) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as views of one buffer."""
    size = os.path.getsize(file)
    buf = bytearray(size)
    with open(file, "rb") as f:
        if f.readinto(buf) != size:
            raise ValueError(f"{file}: short read")
    if size < 8:
        raise ValueError(f"{file}: not a safetensors file")
    (n,) = struct.unpack("<Q", buf[:8])
    if 8 + n > size:
        raise ValueError(f"{file}: header of {n} bytes overruns the file")
    header = json.loads(bytes(buf[8: 8 + n]))
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{file}: {name} has dtype {info['dtype']}, "
                             f"expected one of {', '.join(_DTYPES)}")
        shape = [int(d) for d in info["shape"]]
        start, end = (int(o) for o in info["data_offsets"])
        numel = 1
        for d in shape:
            numel *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != numel * itemsize or base + end > size or start < 0:
            raise ValueError(f"{file}: {name} spans bytes {start}-{end}, "
                             f"which does not hold {shape} {info['dtype']}")
        t = (torch.frombuffer(buf, dtype=dtype, count=numel, offset=base + start)
             if numel else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape)
    return out


def _read_file(file: Path) -> Dict[str, torch.Tensor]:
    if file.suffix == ".safetensors":
        return read_safetensors(file)
    return torch.load(file, map_location="cpu", weights_only=True)


def read_state_dict(path) -> Dict[str, torch.Tensor]:
    """The weights of a checkpoint directory under their stored names
    (legacy gamma/beta renamed, ``position_ids`` dropped), safetensors
    first, then the PyTorch pickle, either whole or sharded."""
    path = checkpoint_dir(path)
    raw: Dict[str, torch.Tensor] = {}
    for whole, index in (("model.safetensors", "model.safetensors.index.json"),
                         ("pytorch_model.bin", "pytorch_model.bin.index.json")):
        if (path / whole).exists():
            raw = _read_file(path / whole)
            break
        if (path / index).exists():
            weight_map = json.loads((path / index).read_text())["weight_map"]
            for shard in sorted(set(weight_map.values())):
                raw.update(_read_file(path / shard))
            missing = set(weight_map) - set(raw)
            if missing:
                raise ValueError(f"{path / index}: the shards lack "
                                 f"{sorted(missing)[:5]}")
            break
    else:
        if (path / "flax_model.msgpack").exists():
            raise ValueError(f"{path} holds Flax weights only "
                             f"(flax_model.msgpack): {_EXPORT_HINT}")
        raise FileNotFoundError(
            f"{path} has no model.safetensors or pytorch_model.bin "
            "(nor their .index.json shards)")
    out: Dict[str, torch.Tensor] = {}
    for name, t in raw.items():
        if name.endswith(("embeddings.position_ids", "rotary_emb.inv_freq")):
            continue
        if name.endswith("LayerNorm.gamma"):
            name = name[: -len("gamma")] + "weight"
        elif name.endswith("LayerNorm.beta"):
            name = name[: -len("beta")] + "bias"
        out[name] = t
    return out


def family_state(raw: Dict[str, torch.Tensor], config: HFConfig, *,
                 head: bool, pooler: bool = True) -> Dict[str, torch.Tensor]:
    """``raw`` under the names of the family's trunk (``head=False``, no
    prefix) or its sequence classifier (the prefixed trunk plus the
    classification head), as f32.  BERT's and ALBERT's trunks keep their
    pooler unless ``pooler`` is false (no other family's module runs one);
    DistilBERT's learned position table is left out where Flax computes a
    sinusoidal one, and so is RoFormer's table; the weights of other heads
    are left out."""
    family = config.model_type
    prefix, trunk_parts = _PREFIX[family], _TRUNK[family]
    if family in _POOLED and pooler:
        trunk_parts += ("pooler.",)
    computed = {"encoder.embed_positions.weight"} if family == "roformer" else set()
    if family in ENCDEC:
        # the tied copies of shared.weight, and the sinusoids Flax computes
        computed |= {"encoder.embed_tokens.weight", "decoder.embed_tokens.weight"}
        if family in SINUSOIDAL:
            computed |= {"encoder.embed_positions.weight",
                         "decoder.embed_positions.weight"}
    if config.sinusoidal_pos_embds:
        computed.add("embeddings.position_embeddings.weight")
    gpt = family in GPT
    out: Dict[str, torch.Tensor] = {}
    for name, t in raw.items():
        trunk = name[len(prefix):] if name.startswith(prefix) else name
        if trunk in computed or gpt and (trunk.endswith(_GPT_DROPPED) or any(
                part in f".{trunk}" for part in _GPT_DROPPED_PARTS)):
            continue
        if trunk.startswith(trunk_parts):
            key = f"{prefix}{trunk}" if head else trunk
        elif head and name.startswith(_HEAD.get(family, ())):
            key = name
        else:
            continue
        out[key] = t.float() if t.is_floating_point() else t
    if family in ENCDEC and not head and "shared.weight" not in out:
        raise ValueError(f"model_type {family!r}: the checkpoint has no shared.weight, "
                         "the token table both of the JAX reference's Flax stacks read")
    return out


def load_checkpoint(path, *, head: bool, pooler: bool = True
                    ) -> Tuple[HFConfig, Dict[str, torch.Tensor]]:
    """The config and the f32 state of a checkpoint directory, named for
    the family's trunk or, with ``head``, its sequence classifier."""
    config = read_config(path)
    return config, family_state(read_state_dict(path), config, head=head,
                                pooler=pooler)


__all__ = ["ACTIVATIONS", "BIG_BIRD_ATTENTION", "DECODERS", "ENCDEC", "ENCODERS_MORE",
           "FAMILIES", "GPT", "LARGE", "SINUSOIDAL",
           "HFConfig", "checkpoint_dir",
           "family_state", "load_checkpoint", "read_config", "read_json",
           "read_safetensors", "read_state_dict"]

"""A local HF BERT checkpoint read without ``transformers``.

The port's copy of what ``from_pretrained`` does for the BERT family
(``BertModel`` / ``BertForSequenceClassification``, e.g. a MiniLM
sentence-transformer or ``cross-encoder/ms-marco-MiniLM-L-6-v2``):

- ``config.json``: ``model_type`` ``bert`` only, ``hidden_act`` ``gelu``
  (erf), ``gelu_new`` / ``gelu_pytorch_tanh`` (tanh) or ``relu``,
  ``position_embedding_type`` ``absolute``; anything else raises
  ``ValueError`` naming it;
- the weights: ``model.safetensors`` (a hand parser: an 8-byte header
  length, a JSON header, raw little-endian F32/F16/BF16/I64 bytes read
  with ``torch.frombuffer``), else ``pytorch_model.bin``
  (``torch.load(weights_only=True)``), or the sharded ``*.index.json``
  form of either; a directory with ``flax_model.msgpack`` alone raises,
  naming ``scripts/torch_export_hf.py``, which converts it;
- the names: legacy ``LayerNorm.gamma`` / ``beta`` become ``weight`` /
  ``bias``, the ``position_ids`` buffer is dropped, and the ``bert.``
  prefix is added or removed to fit the module (``bert_state``).
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

import torch

ACTIVATIONS = ("gelu", "gelu_new", "gelu_pytorch_tanh", "relu")
_DTYPES = {"F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64}
_EXPORT_HINT = ("convert it with scripts/torch_export_hf.py (where "
                "transformers and Flax are installed), which writes "
                "model.safetensors beside it")


@dataclass(frozen=True)
class BertConfig:
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


def checkpoint_dir(path) -> Path:
    """``path`` as a directory; anything else raises FileNotFoundError."""
    path = Path(path)
    if not path.is_dir():
        raise FileNotFoundError(f"{path} is not a checkpoint directory")
    return path


def read_config(path) -> BertConfig:
    """``config.json`` of a BERT checkpoint; other families raise."""
    cfg = json.loads((checkpoint_dir(path) / "config.json").read_text())
    model_type = cfg.get("model_type")
    if model_type != "bert":
        raise ValueError(
            f"{path}: model_type {model_type!r} is not supported; the port "
            "reads BERT-family checkpoints (model_type 'bert') only")
    act = cfg.get("hidden_act", "gelu")
    if act not in ACTIVATIONS:
        raise ValueError(f"{path}: hidden_act {act!r} is not supported "
                         f"(supported: {', '.join(ACTIVATIONS)})")
    pos = cfg.get("position_embedding_type", "absolute")
    if pos != "absolute":
        raise ValueError(f"{path}: position_embedding_type {pos!r} is not "
                         "supported (only 'absolute')")
    if cfg.get("is_decoder"):
        raise ValueError(f"{path}: a decoder (is_decoder) is not supported")
    # as PretrainedConfig: id2label decides num_labels when it is written
    num_labels = (len(cfg["id2label"]) if cfg.get("id2label")
                  else int(cfg.get("num_labels", 2)))
    return BertConfig(
        vocab_size=int(cfg["vocab_size"]), hidden_size=int(cfg["hidden_size"]),
        num_hidden_layers=int(cfg["num_hidden_layers"]),
        num_attention_heads=int(cfg["num_attention_heads"]),
        intermediate_size=int(cfg["intermediate_size"]),
        max_position_embeddings=int(cfg["max_position_embeddings"]),
        type_vocab_size=int(cfg.get("type_vocab_size", 2)),
        layer_norm_eps=float(cfg.get("layer_norm_eps", 1e-12)),
        hidden_act=act, num_labels=num_labels)


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
        if name.endswith("embeddings.position_ids"):
            continue
        if name.endswith("LayerNorm.gamma"):
            name = name[: -len("gamma")] + "weight"
        elif name.endswith("LayerNorm.beta"):
            name = name[: -len("beta")] + "bias"
        out[name] = t
    return out


def bert_state(raw: Dict[str, torch.Tensor], *, head: bool,
               pooler: bool = True) -> Dict[str, torch.Tensor]:
    """``raw`` under the names of ``hf_bert.BertModel`` (``head=False``,
    no ``bert.`` prefix) or ``BertForSequenceClassification`` (``bert.``
    trunk plus ``classifier``), as f32; the weights of other heads (an MLM
    or NSP head) are left out, as ``from_pretrained`` leaves them."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in raw.items():
        trunk = name[len("bert."):] if name.startswith("bert.") else name
        if trunk.startswith(("embeddings.", "encoder.")) or (
                pooler and trunk.startswith("pooler.")):
            key = f"bert.{trunk}" if head else trunk
        elif head and name.startswith("classifier."):
            key = name
        else:
            continue
        out[key] = t.float() if t.is_floating_point() else t
    return out


def load_checkpoint(path, *, head: bool, pooler: bool = True
                    ) -> Tuple[BertConfig, Dict[str, torch.Tensor]]:
    """The config and the f32 state of a checkpoint directory, named for
    ``hf_bert.BertModel`` or, with ``head``, for
    ``BertForSequenceClassification``."""
    config = read_config(path)
    return config, bert_state(read_state_dict(path), head=head, pooler=pooler)


__all__ = ["ACTIVATIONS", "BertConfig", "bert_state", "checkpoint_dir",
           "load_checkpoint",
           "read_config", "read_safetensors", "read_state_dict"]

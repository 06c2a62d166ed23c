"""Convert the JAX package's Flax parameters into the port's state dicts.

``params_from_jax`` takes the Flax parameter tree as nested dicts of numpy
arrays (``{"params": {...}}`` or the inner dict) and returns a state dict
for ``BiEncoder`` or ``CrossEncoder`` of ``models/encoder.py``:

- Flax ``Dense`` kernels are [in, out]; ``nn.Linear`` weights are [out, in];
- the attention projections are ``DenseGeneral`` kernels [H, heads, hd]
  (query/key/value) and [heads, hd, H] (out), flattened onto [H, H] Linear
  weights, with the [heads, hd] biases flattened to [H];
- ``nn.Embed`` tables keep their [vocab, H] layout.

``hashing_from_numpy`` builds a ``HashingEmbedder`` around the JAX
embedder's signed projection, so two default (unfused) managers embed
alike.  ``ivf_partitions_from_numpy``, ``pq_from_numpy``,
``ivfpq_from_numpy`` and ``postings_from_numpy`` carry the JAX package's
index state (IVF partitions, PQ codebooks and codes, IVF-PQ partitions,
inverted postings), given as numpy, over into the port's tensors, so that
both packages can search identical state.

The tests read the repo's orbax checkpoints into numpy themselves; the
port never imports orbax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _dense(out: Dict[str, torch.Tensor], prefix: str, p: Mapping[str, Any]) -> None:
    out[f"{prefix}.weight"] = _t(p["kernel"]).T.contiguous()
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _trunk(out: Dict[str, torch.Tensor], p: Mapping[str, Any]) -> None:
    out["trunk.tok_embed.weight"] = _t(p["tok_embed"]["embedding"])
    out["trunk.pos_embed"] = _t(p["pos_embed"])
    if "seg_embed" in p:
        out["trunk.seg_embed.weight"] = _t(p["seg_embed"]["embedding"])
    out["trunk.final_ln.scale"] = _t(p["final_ln"]["scale"])
    out["trunk.final_ln.bias"] = _t(p["final_ln"]["bias"])
    i = 0
    while f"block_{i}" in p:
        blk = p[f"block_{i}"]
        pre = f"trunk.blocks.{i}"
        for src, dst in (("LayerNorm_0", "ln_attn"), ("LayerNorm_1", "ln_mlp")):
            out[f"{pre}.{dst}.scale"] = _t(blk[src]["scale"])
            out[f"{pre}.{dst}.bias"] = _t(blk[src]["bias"])
        mha = blk["MultiHeadDotProductAttention_0"]
        for name in ("query", "key", "value"):
            k = np.asarray(mha[name]["kernel"], np.float32)     # [H, heads, hd]
            out[f"{pre}.attn.{name}.weight"] = _t(k.reshape(k.shape[0], -1)).T.contiguous()
            out[f"{pre}.attn.{name}.bias"] = _t(np.asarray(mha[name]["bias"]).reshape(-1))
        ko = np.asarray(mha["out"]["kernel"], np.float32)       # [heads, hd, H]
        out[f"{pre}.attn.out.weight"] = _t(ko.reshape(-1, ko.shape[-1])).T.contiguous()
        out[f"{pre}.attn.out.bias"] = _t(mha["out"]["bias"])
        _dense(out, f"{pre}.mlp_in", blk["Dense_0"])
        _dense(out, f"{pre}.mlp_out", blk["Dense_1"])
        i += 1


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax BiEncoder/CrossEncoder params (numpy leaves) -> state dict."""
    p = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}
    _trunk(out, p["trunk"])
    if "proj" in p:                                   # BiEncoder
        _dense(out, "proj", p["proj"])
        if "lex_proj" in p:
            _dense(out, "lex_proj", p["lex_proj"])
            out["lex_scale"] = _t(p["lex_scale"])
    else:                                             # CrossEncoder
        if "match_embed" in p:
            out["match_embed.weight"] = _t(p["match_embed"]["embedding"])
        _dense(out, "pool", p["pool"])
        _dense(out, "score", p["score"])
    return out


def flax_layout(name: str, shape: Tuple[int, ...], num_heads: Optional[int] = None
                ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The Flax layout of the port's parameter ``name`` of torch ``shape``
    -> (the Flax kernel's shape, the torch dim that holds each Flax axis):
    the inverse of ``params_from_jax``'s mapping.  The attention
    projections need ``num_heads``."""
    if name.endswith((".attn.query.weight", ".attn.key.weight", ".attn.value.weight",
                      ".attn.out.weight")):
        if not num_heads:
            raise ValueError(f"{name}: the attention layout needs num_heads")
        if name.endswith(".attn.out.weight"):                # [heads, hd, H]
            return (num_heads, shape[1] // num_heads, shape[0]), (1, 1, 0)
        return (shape[1], num_heads, shape[0] // num_heads), (1, 0, 0)  # [H, heads, hd]
    if name.endswith(".weight") and not name.endswith("embed.weight") and len(shape) == 2:
        return (shape[1], shape[0]), (1, 0)                  # Dense [in, out]
    return tuple(shape), tuple(range(len(shape)))            # embeddings, vectors


def encoder_config_from_meta(meta: Mapping[str, Any], **overrides: Any):
    """The port's EncoderConfig from a checkpoint's ``encoder_config``."""
    from .encoder import EncoderConfig

    fields = ("vocab_size", "hidden_dim", "num_layers", "num_heads",
              "mlp_dim", "max_len", "num_segments", "num_reserved_ids")
    kw: Dict[str, Any] = {f: int(np.asarray(meta[f])) for f in fields if f in meta}
    kw["dropout"] = float(np.asarray(meta.get("dropout", 0.0)))
    kw["lexical_match"] = bool(np.asarray(meta.get("lexical_match", False)))
    kw["lexical_pool"] = bool(np.asarray(meta.get("lexical_pool", False)))
    kw.update(overrides)
    return EncoderConfig(**kw)


def hashing_from_numpy(proj: Any, device: DeviceLike = None):
    """The JAX ``HashingEmbedder``'s projection [vocab_size, dim] (numpy)
    -> the port's ``HashingEmbedder`` with that projection on ``device``."""
    from .embedder import HashingEmbedder

    proj = np.asarray(proj, np.float32)
    return HashingEmbedder(dim=proj.shape[1], vocab_size=proj.shape[0],
                           proj=proj, device=device)


def _tensor(a: Any, device: DeviceLike) -> torch.Tensor:
    """numpy (bf16 arrays from ml_dtypes included) -> tensor on device."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr, copy=True).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(resolve_device(device))


def ivf_partitions_from_numpy(parts: Any, device: DeviceLike = None):
    """The JAX package's ``IVFPartitions`` (any object with its fields, as
    arrays) -> the port's ``ops.ivf.IVFPartitions`` on ``device``."""
    from ..ops.ivf import IVFPartitions

    opt = lambda a: None if a is None else _tensor(a, device)  # noqa: E731
    return IVFPartitions(
        centroids=_tensor(parts.centroids, device).float(),
        packed_emb=_tensor(parts.packed_emb, device).contiguous(),
        packed_rows=_tensor(parts.packed_rows, device).to(torch.int32),
        tail_emb=_tensor(parts.tail_emb, device),
        tail_rows=_tensor(parts.tail_rows, device).to(torch.int32),
        packed_scale=opt(parts.packed_scale),
        tail_scale=opt(parts.tail_scale))


def pq_from_numpy(codebooks: Any, codes: Any, *, m: int, bits: int,
                  device: DeviceLike = None):
    """PQ codebooks [m, c, dsub] and codes [N, m] -> (``ops.pq.PQCodebook``,
    codes tensor) on ``device``."""
    from ..ops.pq import PQCodebook

    return (PQCodebook(_tensor(codebooks, device).float(), m, bits),
            _tensor(codes, device))


def ivfpq_from_numpy(idx: Any, device: DeviceLike = None):
    """A JAX ``IVFPQIndex`` (or any object with its fields as arrays) -> the
    port's ``ops.ivfpq.IVFPQIndex`` on ``device``."""
    from ..ops.ivfpq import IVFPQIndex

    return IVFPQIndex(
        centroids=_tensor(idx.centroids, device).float(),
        codebooks=_tensor(idx.codebooks, device).float(),
        packed_codes=_tensor(idx.packed_codes, device).to(torch.int8).contiguous(),
        packed_rows=_tensor(idx.packed_rows, device).to(torch.int32),
        tail_codes=_tensor(idx.tail_codes, device).to(torch.int8).contiguous(),
        tail_rows=_tensor(idx.tail_rows, device).to(torch.int32),
        tail_assign=_tensor(idx.tail_assign, device).to(torch.int32))


def postings_from_numpy(post_rows: Any, post_tf: Any, post_tfw: Any,
                        device: DeviceLike = None):
    """Inverted postings -> (rows i32, tf bf16, tf-weights bf16) tensors on
    ``device``, the dtypes the sparse index keeps them in."""
    return (_tensor(post_rows, device).to(torch.int32),
            _tensor(post_tf, device).to(torch.bfloat16),
            _tensor(post_tfw, device).to(torch.bfloat16))


__all__ = ["params_from_jax", "flax_layout", "encoder_config_from_meta", "hashing_from_numpy",
           "ivf_partitions_from_numpy", "pq_from_numpy", "postings_from_numpy"]

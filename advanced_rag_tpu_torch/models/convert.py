"""Convert the JAX package's Flax parameters into the port's state dicts.

``params_from_jax`` takes the Flax parameter tree as nested dicts of numpy
arrays (``{"params": {...}}`` or the inner dict) and returns a state dict
for ``BiEncoder`` or ``CrossEncoder`` of ``models/encoder.py``:

- Flax ``Dense`` kernels are [in, out]; ``nn.Linear`` weights are [out, in];
- the attention projections are ``DenseGeneral`` kernels [H, heads, hd]
  (query/key/value) and [heads, hd, H] (out), flattened onto [H, H] Linear
  weights, with the [heads, hd] biases flattened to [H];
- ``nn.Embed`` tables keep their [vocab, H] layout.

``load_orbax_numpy`` reads an orbax checkpoint directory (the repo's
``artifacts/*_ckpt``) into numpy.  orbax is imported inside that function
only: the port does not depend on it, and only the CPU tests call it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch


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


def load_orbax_numpy(path: str | Path) -> Dict[str, Any]:
    """Restore an orbax pytree checkpoint to nested dicts of numpy arrays."""
    import orbax.checkpoint as ocp

    ckptr = ocp.PyTreeCheckpointer()
    p = Path(path).absolute()
    meta = ckptr.metadata(p).item_metadata
    tree = meta.tree if hasattr(meta, "tree") else meta

    def to_numpy_args(node):
        if isinstance(node, Mapping):
            return {k: to_numpy_args(v) for k, v in node.items()}
        return ocp.RestoreArgs(restore_type=np.ndarray)

    blob = ckptr.restore(p, restore_args=to_numpy_args(tree))

    def as_numpy(node):
        if isinstance(node, Mapping):
            return {k: as_numpy(v) for k, v in node.items()}
        return np.asarray(node)

    return as_numpy(blob)


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


__all__ = ["params_from_jax", "load_orbax_numpy", "encoder_config_from_meta"]

#!/usr/bin/env python3
"""Convert the repo's orbax encoder checkpoints into the PyTorch port's
format (``advanced_rag_tpu_torch/train/loop.py``: ``config.json`` plus one
f32 state dict), for machines that have PyTorch but no orbax.

    python scripts/torch_convert_checkpoints.py \
        [--biencoder artifacts/biencoder_ckpt] [--reranker artifacts/reranker_ckpt] \
        [--out build/quality]

Run it where orbax is installed; it writes ``<out>/biencoder`` and
``<out>/reranker``, which ``RAG_EMBEDDER=ckpt:<out>/biencoder`` and
``RAG_RERANKER=ckpt:<out>/reranker`` serve in the port.  The orbax tree is
read into numpy (``load_orbax_numpy``) and mapped onto the port's modules
by ``models/convert.py:params_from_jax``; no module of the JAX package is
imported.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def load_orbax_numpy(path):
    """Restore an orbax pytree checkpoint to nested dicts of numpy arrays."""
    from collections.abc import Mapping

    import numpy as np
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


def convert_biencoder(src, dst):
    """orbax ``save_biencoder`` checkpoint -> the port's; returns
    (EncoderConfig, out_dim)."""
    from advanced_rag_tpu_torch.models.convert import (encoder_config_from_meta,
                                                       params_from_jax)
    from advanced_rag_tpu_torch.train.loop import save_biencoder

    blob = load_orbax_numpy(src)
    meta = blob["encoder_config"]
    cfg = encoder_config_from_meta(meta)
    out_dim = int(meta["out_dim"])
    save_biencoder(params_from_jax(blob["params"]), cfg, out_dim, dst)
    return cfg, out_dim


def convert_reranker(src, dst):
    """orbax ``save_reranker`` checkpoint -> the port's; returns
    (EncoderConfig, layout)."""
    from advanced_rag_tpu_torch.models.convert import (encoder_config_from_meta,
                                                       params_from_jax)
    from advanced_rag_tpu_torch.train.rerank import save_reranker

    blob = load_orbax_numpy(src)
    meta = blob["encoder_config"]
    cfg = encoder_config_from_meta(meta)
    layout = {k: int(meta[f"pair_{k}"]) for k in ("q_len", "d_len")
              if f"pair_{k}" in meta}
    save_reranker(params_from_jax(blob["params"]), cfg, dst, **layout)
    return cfg, layout


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--biencoder", default=str(REPO / "artifacts" / "biencoder_ckpt"))
    ap.add_argument("--reranker", default=str(REPO / "artifacts" / "reranker_ckpt"))
    ap.add_argument("--out", default=str(REPO / "build" / "quality"))
    args = ap.parse_args()
    out = Path(args.out)
    cfg, out_dim = convert_biencoder(args.biencoder, out / "biencoder")
    print(f"bi-encoder: {cfg} out_dim {out_dim} -> {out / 'biencoder'}")
    cfg, layout = convert_reranker(args.reranker, out / "reranker")
    print(f"reranker: {cfg} layout {layout} -> {out / 'reranker'}")


if __name__ == "__main__":
    main()

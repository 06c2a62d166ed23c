"""Reranker checkpoints: the persistence half of
``advanced_rag_tpu/train/rerank.py``, in ``train/loop.py``'s format.

The static-slot pair layout the reranker was trained with
(``pair_q_len``/``pair_d_len``) is saved beside its geometry, so that the
service restores the train-time input format (``RAG_RERANKER=ckpt:``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

from .. import DeviceLike, resolve_device
from ..models.convert import encoder_config_from_meta
from ..models.encoder import CrossEncoder, EncoderConfig
from .loop import Params, encoder_meta, load_params, save_params


def save_reranker(params: Params, config: EncoderConfig, path: str | Path,
                  q_len: Optional[int] = None,
                  d_len: Optional[int] = None) -> None:
    """Persist cross-encoder weights with their geometry and pair layout."""
    meta = encoder_meta(config)
    if q_len is not None:
        meta["pair_q_len"] = int(q_len)
    if d_len is not None:
        meta["pair_d_len"] = int(d_len)
    save_params({"encoder_config": meta, "params": params}, path)


def load_reranker(path: str | Path, device: DeviceLike = None
                  ) -> Tuple[EncoderConfig, CrossEncoder, Dict[str, int]]:
    """-> (EncoderConfig, CrossEncoder on ``device`` in eval mode, layout)
    from a ``save_reranker`` checkpoint; ``layout`` is a {"q_len",
    "d_len"} dict, empty when the checkpoint has no pair layout."""
    blob = load_params(path, device)
    meta = blob["encoder_config"]
    cfg = encoder_config_from_meta(meta)
    model = CrossEncoder(cfg)
    model.load_state_dict(blob["params"])
    layout: Dict[str, int] = {}
    if "pair_q_len" in meta:
        layout["q_len"] = int(meta["pair_q_len"])
    if "pair_d_len" in meta:
        layout["d_len"] = int(meta["pair_d_len"])
    return cfg, model.to(resolve_device(device)).eval(), layout


__all__ = ["save_reranker", "load_reranker"]

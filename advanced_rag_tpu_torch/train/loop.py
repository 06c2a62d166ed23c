"""Bi-encoder checkpoints: the persistence half of
``advanced_rag_tpu/train/loop.py``.

The JAX package writes orbax pytrees, which a host without orbax (the
port needs none) cannot read.  The port writes a directory of its own:

- ``config.json``: the encoder geometry (every ``EncoderConfig`` field but
  ``dtype``, as the JAX ``meta`` has them) plus the model's own fields
  (``out_dim`` for a bi-encoder, ``pair_q_len``/``pair_d_len`` for a
  reranker);
- ``weights.pt``: the module's state dict, f32 on the host, as the JAX
  params are, so converted and saved weights give the same function.

``scripts/torch_convert_checkpoints.py`` writes the repo's orbax
checkpoints in this format.
"""

from __future__ import annotations

import json
from dataclasses import asdict
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple, Union

import torch
from torch import nn

from .. import DeviceLike, resolve_device
from ..models.convert import encoder_config_from_meta
from ..models.encoder import BiEncoder, EncoderConfig

CONFIG_FILE = "config.json"
WEIGHTS_FILE = "weights.pt"

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def _host_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    return {k: v.detach().to("cpu", torch.float32).contiguous()
            for k, v in sd.items()}


def save_params(blob: Mapping[str, Any], path: str | Path) -> None:
    """Write ``{"encoder_config": dict, "params": state dict or module}``
    to the directory ``path`` (created; existing files are replaced)."""
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    torch.save(_host_state_dict(blob["params"]), root / WEIGHTS_FILE)
    (root / CONFIG_FILE).write_text(
        json.dumps(dict(blob["encoder_config"]), indent=2, sort_keys=True))


def load_params(path: str | Path, device: DeviceLike = None) -> Dict[str, Any]:
    """-> ``{"encoder_config": dict, "params": state dict}`` with the
    tensors on ``device`` (the card unless ``"cpu"``)."""
    root = Path(path)
    dev = resolve_device(device)
    meta = json.loads((root / CONFIG_FILE).read_text())
    params = torch.load(root / WEIGHTS_FILE, map_location=dev, weights_only=True)
    return {"encoder_config": meta, "params": params}


def encoder_meta(config: EncoderConfig) -> Dict[str, Any]:
    """The JSON-able encoder geometry: every field but the activation dtype."""
    return {k: v for k, v in asdict(config).items() if k != "dtype"}


def save_biencoder(params: Params, config: EncoderConfig, out_dim: int,
                   path: str | Path) -> None:
    """Persist bi-encoder weights with their encoder geometry and
    projection width (``RAG_EMBEDDER=ckpt:<path>`` restores them)."""
    meta = encoder_meta(config)
    meta["out_dim"] = int(out_dim)
    save_params({"encoder_config": meta, "params": params}, path)


def load_biencoder(path: str | Path, device: DeviceLike = None
                   ) -> Tuple[EncoderConfig, int, BiEncoder]:
    """-> (EncoderConfig, out_dim, BiEncoder with the saved weights on
    ``device``, in eval mode) from a ``save_biencoder`` checkpoint."""
    blob = load_params(path, device)
    meta = blob["encoder_config"]
    cfg = encoder_config_from_meta(meta)
    out_dim = int(meta["out_dim"])
    model = BiEncoder(cfg, out_dim=out_dim)
    model.load_state_dict(blob["params"])
    return cfg, out_dim, model.to(resolve_device(device)).eval()


__all__ = ["save_params", "load_params", "save_biencoder", "load_biencoder",
           "encoder_meta", "CONFIG_FILE", "WEIGHTS_FILE"]

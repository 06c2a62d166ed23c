"""Training loop of the bi-encoder, and its checkpoints: the port of
``advanced_rag_tpu/train/loop.py``.

``train_biencoder`` drives ``train/contrastive.py``'s step over
inverse-cloze synthetic pairs (or the caller's ``pair_fn``), evaluates
recall@1 on a held-out pool at ``eval_every`` and checkpoints the
weights there with ``save_biencoder``.

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
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from .. import DeviceLike, resolve_device
from ..models.convert import encoder_config_from_meta
from ..models.encoder import BiEncoder, EncoderConfig, init_bi_encoder
from ..models.tokenizer import HashingTokenizer, TokenizerConfig
from .contrastive import (TrainConfig, cloze_query, make_optimizer, make_train_step,
                          synthetic_pair_batch, train_mesh)

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


@dataclass
class TrainLoopConfig:
    steps: int = 500
    batch_size: int = 64
    eval_every: int = 100
    eval_pairs: int = 64
    log_every: int = 50
    checkpoint_dir: Optional[str] = None
    seed: int = 0


@torch.no_grad()
def _eval_recall_at_1(model: nn.Module, params: Mapping[str, torch.Tensor],
                      tok: HashingTokenizer, pairs: List[Tuple[str, str]],
                      max_len: int) -> float:
    """Query->its-own-doc retrieval accuracy over the eval pool, with
    ``params`` (deterministic forward)."""
    dev = next(iter(params.values())).device
    enc = lambda texts: [torch.from_numpy(a).to(dev)  # noqa: E731
                         for a in tok.encode_batch(texts, max_len)]
    q = torch.func.functional_call(model, dict(params), tuple(enc([q for q, _ in pairs])))
    d = torch.func.functional_call(model, dict(params), tuple(enc([d for _, d in pairs])))
    pred = torch.argmax(q @ d.T, dim=1).cpu().numpy()
    return float((pred == np.arange(len(pairs))).mean())


def train_biencoder(
    texts: Sequence[str],
    *,
    encoder_config: Optional[EncoderConfig] = None,
    out_dim: int = 384,
    train_config: Optional[TrainConfig] = None,
    loop_config: Optional[TrainLoopConfig] = None,
    mesh: Any = None,
    pair_fn: Optional[Callable[[np.random.Generator], Dict[str, torch.Tensor]]] = None,
    device: DeviceLike = None,
) -> Tuple[BiEncoder, Dict[str, torch.Tensor], List[Dict[str, float]]]:
    """-> (model, its state dict, history of {step, loss, accuracy,
    grad_norm, elapsed_s[, eval_recall_at_1]}), trained on ``device`` (the
    card unless ``"cpu"``), over ``mesh`` (None: ``build_train_mesh``).
    ``pair_fn(rng)`` gives a batch on the device in place of the synthetic
    inverse-cloze pairs.  On a mesh of several ranks every rank runs the
    loop from the same seeds, so it draws the same global batches, and
    rank 0 writes the checkpoints."""
    cfg = encoder_config or EncoderConfig()
    tcfg = train_config or TrainConfig()
    lcfg = loop_config or TrainLoopConfig()
    if not texts:
        raise ValueError("train_biencoder needs a non-empty corpus")
    dev = resolve_device(device)
    mesh = train_mesh(mesh, tcfg)

    model, params = init_bi_encoder(cfg, out_dim=out_dim, seed=lcfg.seed, device=dev)
    step_fn, params, opt_state = make_train_step(
        model, make_optimizer(tcfg), tcfg, mesh, params, device=dev)
    tok = HashingTokenizer(TokenizerConfig(vocab_size=cfg.vocab_size,
                                           max_len=cfg.max_len))
    rng = np.random.default_rng(lcfg.seed)

    # held-out eval pool: inverse-cloze pairs from the tail of the corpus
    eval_rng = np.random.default_rng(lcfg.seed + 1)
    pool = list(texts)[-max(lcfg.eval_pairs, 8):]
    eval_pairs = [(cloze_query(doc, eval_rng), doc) for doc in pool[: lcfg.eval_pairs]]

    history: List[Dict[str, float]] = []
    t0 = time.perf_counter()
    for step_i in range(1, lcfg.steps + 1):
        batch = (pair_fn(rng) if pair_fn is not None else
                 synthetic_pair_batch(tok, list(texts), lcfg.batch_size, rng,
                                      max_len=cfg.max_len, device=dev))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step_i % lcfg.log_every == 0 or step_i == lcfg.steps:
            entry = {
                "step": step_i,
                "loss": float(metrics["loss"]),
                "accuracy": float(metrics["accuracy"]),
                "grad_norm": float(metrics["grad_norm"]),
                "elapsed_s": time.perf_counter() - t0,
            }
            if step_i % lcfg.eval_every == 0 or step_i == lcfg.steps:
                entry["eval_recall_at_1"] = _eval_recall_at_1(
                    model, opt_state.full_params(), tok, eval_pairs, cfg.max_len)
            history.append(entry)
        if lcfg.checkpoint_dir and step_i % lcfg.eval_every == 0:
            full = opt_state.full_params()
            if mesh.rank == 0:
                save_biencoder(full, cfg, out_dim,
                               Path(lcfg.checkpoint_dir) / f"step_{step_i}")
    return model.eval(), opt_state.full_params(), history


__all__ = ["TrainLoopConfig", "train_biencoder", "save_params", "load_params",
           "save_biencoder", "load_biencoder", "encoder_meta", "CONFIG_FILE",
           "WEIGHTS_FILE"]

"""Contrastive fine-tuning of the bi-encoder: the port of
``advanced_rag_tpu/train/contrastive.py``.

Symmetric InfoNCE over in-batch negatives (plus mined hard negatives as
extra query->document columns), one forward and backward per step under
autograd, and optax's optimizer chain rebuilt on ``torch.optim``:

- the learning rate follows ``optax.warmup_cosine_decay_schedule(0, peak,
  warmup, max(total, warmup + 1))`` evaluated at the update count, so the
  first update has lr 0 and the schedule decays to 0;
- gradients are clipped as ``optax.clip_by_global_norm`` writes it: kept
  when their global norm is below the maximum, else ``g / norm * max``;
- ``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps 1e-8 outside the square
  root) decays every parameter, as ``optax.adamw(mask=None)`` does:
  ``p - lr * (adam + wd * p)``.

The JAX step runs over a (data, model) mesh; the port runs on one device,
so ``mesh`` must be None (sharded training is ROADMAP queue A item 9).  The
step updates the module's parameters in place: the ``params`` it returns
is the module's state dict, whose tensors are those parameters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, resolve_device


NOT_SHARDED = ("sharded training over a mesh is not ported yet (ROADMAP.md, queue A "
               "item 9: parallel/ onto torch.distributed)")


@dataclass(frozen=True)
class TrainConfig:
    """JAX's fields; ``data_axis`` / ``model_axis`` name a mesh's axes, which
    the port has not (``check_mesh``), so only their defaults are taken."""

    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    temperature: float = 0.05
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0
    data_axis: str = "data"
    model_axis: str = "model"

    def __post_init__(self) -> None:
        if (self.data_axis, self.model_axis) != ("data", "model"):
            raise NotImplementedError(f"{NOT_SHARDED}; leave data_axis and model_axis "
                                      "at their defaults")


def check_mesh(mesh: Any) -> None:
    """The port trains on one device: a mesh is refused."""
    if mesh is not None:
        raise NotImplementedError(f"{NOT_SHARDED}; pass mesh=None")


def warmup_cosine_decay(config: TrainConfig) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(init_value=0, peak_value=lr,
    warmup_steps, decay_steps=max(total_steps, warmup_steps + 1))``:
    count -> learning rate."""
    peak = float(config.learning_rate)
    warmup = int(config.warmup_steps)
    decay = max(int(config.total_steps), warmup + 1) - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * (count / warmup)
        c = min(count - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return schedule


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: each gradient kept when the
    global norm is below ``max_norm``, else ``g / norm * max_norm``.
    Returns the global norm before clipping (on the device, no sync)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class OptState:
    """The optimizer state of one module's parameters: AdamW, the schedule
    (``LambdaLR`` at the update count) and the global-norm clip.

    ``update()`` applies one update from the gradients in ``.grad`` and
    returns their global norm before clipping."""

    def __init__(self, params: Iterable[nn.Parameter], config: TrainConfig):
        self.params = [p for p in params if p.requires_grad]
        self.max_grad_norm = float(config.max_grad_norm)
        self.schedule = warmup_cosine_decay(config)
        peak = float(config.learning_rate)
        self.adamw = torch.optim.AdamW(self.params, lr=peak, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=config.weight_decay)
        self.lr_schedule = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, lambda count: self.schedule(count) / peak if peak else 0.0)

    @property
    def count(self) -> int:
        """Updates applied so far (optax's ``count``)."""
        return self.lr_schedule.last_epoch

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.adamw.param_groups[0]["lr"]

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def update(self) -> torch.Tensor:
        norm = clip_by_global_norm([p.grad for p in self.params if p.grad is not None],
                                   self.max_grad_norm)
        self.adamw.step()
        self.lr_schedule.step()
        return norm


class Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule,
    weight_decay))`` for ``torch.optim``: ``init(params)`` gives the state."""

    def __init__(self, config: TrainConfig):
        self.config = config

    def init(self, params: Iterable[nn.Parameter]) -> OptState:
        return OptState(params, self.config)


def make_optimizer(config: TrainConfig) -> Optimizer:
    return Optimizer(config)


def _info_nce(q: torch.Tensor, d: torch.Tensor, temperature: float,
              neg: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric InfoNCE with in-batch negatives; q/d are L2-normalized
    [B, D] f32.  ``neg`` [B*H, D]: mined hard negatives, extra columns of
    the q->d direction only (the d->q direction stays in-batch)."""
    logits = (q @ d.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    qd_logits = logits
    if neg is not None:
        qd_logits = torch.cat([logits, (q @ neg.T) / temperature], dim=1)
    loss = 0.5 * (F.cross_entropy(qd_logits, labels) + F.cross_entropy(logits.T, labels))
    acc = (torch.argmax(qd_logits, dim=1) == labels).float().mean()
    return loss, acc


def assign_params(model: nn.Module, params: Any) -> None:
    """Copy ``params`` (a state dict) into ``model`` unless they already
    are its own tensors."""
    if params is None:
        return
    own = model.state_dict()
    if all(k in own and own[k].data_ptr() == v.data_ptr() for k, v in params.items()):
        return
    model.load_state_dict(dict(params))


def make_train_step(
    model: nn.Module,
    optimizer: Optimizer,
    config: TrainConfig,
    mesh: Any = None,
    params: Any = None,
    device: DeviceLike = None,
) -> Tuple[Callable, Dict[str, torch.Tensor], OptState]:
    """Build the contrastive step on ``device`` (the card unless ``"cpu"``).

    Returns ``(step_fn, params, opt_state)``: ``params`` is the module's
    state dict (``params`` given here are loaded into it first), and
    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    updates it in place.  ``batch``: q_ids/q_mask/d_ids/d_mask [B, L] and,
    optionally, n_ids/n_mask [B*H, L] (mined hard negatives).  ``metrics``:
    loss, accuracy and the global gradient norm before clipping, as 0-d
    tensors on the device.  The forward is deterministic (train() mode, no
    dropout generator), as JAX's ``model.apply`` without dropout rngs.
    """
    check_mesh(mesh)
    dev = resolve_device(device)
    model.to(dev).train()
    assign_params(model, params)
    opt_state = optimizer.init(model.parameters())

    def loss_fn(batch):
        q = model(batch["q_ids"], batch["q_mask"])
        d = model(batch["d_ids"], batch["d_mask"])
        neg = model(batch["n_ids"], batch["n_mask"]) if "n_ids" in batch else None
        return _info_nce(q, d, config.temperature, neg=neg)

    def train_step(p, opt: OptState, batch):
        opt.zero_grad()
        loss, acc = loss_fn(batch)
        loss.backward()
        gnorm = opt.update()
        return p, opt, {"loss": loss.detach(), "accuracy": acc, "grad_norm": gnorm}

    return train_step, model.state_dict(), opt_state


def to_device(arrays: Dict[str, np.ndarray], device: DeviceLike) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in arrays.items()}


def cloze_query(doc: str, rng: np.random.Generator) -> str:
    """An inverse-cloze query: a random window of 2-7 words of ``doc`` (the
    whole doc when it has 4 words or fewer), drawn as the JAX trainers
    draw it (``synthetic_pair_batch``, ``train_biencoder``'s eval pool,
    ``distill._cloze_query``)."""
    words = doc.split()
    if len(words) <= 4:
        return doc
    w = rng.integers(2, min(8, len(words)))
    s = rng.integers(0, len(words) - w + 1)
    return " ".join(words[s : s + w])


def synthetic_pair_batch(
    tokenizer: Any, texts: list[str], batch_size: int, rng: np.random.Generator,
    max_len: Optional[int] = None, device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Self-supervised pairs: query = a random word window of the doc
    (inverse cloze task); the same ``rng`` draws as the JAX function, so
    one seed gives the same token arrays.  Tensors on ``device``."""
    picks = rng.integers(0, len(texts), batch_size)
    docs = [texts[i] for i in picks]
    queries = [cloze_query(d, rng) for d in docs]
    q_ids, q_mask = tokenizer.encode_batch(queries, max_len)
    d_ids, d_mask = tokenizer.encode_batch(docs, max_len)
    return to_device({"q_ids": q_ids, "q_mask": q_mask,
                      "d_ids": d_ids, "d_mask": d_mask}, device)


__all__ = [
    "TrainConfig",
    "cloze_query",
    "Optimizer",
    "OptState",
    "make_optimizer",
    "make_train_step",
    "synthetic_pair_batch",
    "warmup_cosine_decay",
]

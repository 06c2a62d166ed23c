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

The step runs over a (data, model) mesh of ranks (``build_train_mesh``;
one rank without a process group), with the numbers of JAX's GSPMD step:

- **data parallel**: each rank of the ``data`` axis takes its rows of the
  global batch; the embeddings are gathered across ``data``
  (``parallel/comm.py:gather_rows``), so the in-batch negatives span the
  global batch and every rank computes the global loss; the parameter
  gradients are then summed over ``data``;
- **tensor parallel over ``model``, gathered on use** (``MeshParams``):
  between steps each parameter that ``param_partition_spec`` shards is
  held as this rank's slice, with its AdamW state, so a rank keeps 1/tp of
  those weights and of their optimizer state.  A step all-gathers the
  whole weights over ``model`` for its forward; after the backward each
  whole gradient is cut to the rank's slice and the whole weights are
  freed; the global-norm clip sums the slices' squared norms over
  ``model``.  Every rank of ``model`` runs the same forward and backward
  on its ``data`` rows: the axis divides the memory held between steps,
  not the compute, and a step's peak still holds the whole weights and
  gradients.

The step updates the module's parameters in place: the ``params`` it
returns is the module's state dict, whose tensors are those parameters
(this rank's slices for the sharded ones; ``OptState.full_params()``
gathers the whole weights).
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
from ..models.convert import flax_layout
from ..parallel.comm import all_gather, all_reduce_sum, gather_rows
from ..parallel.mesh import Mesh, world


@dataclass(frozen=True)
class TrainConfig:
    """JAX's fields; ``data_axis`` / ``model_axis`` name the axes of the
    training mesh (``build_train_mesh``) that the steps split the batch and
    the parameters over."""

    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    temperature: float = 0.05
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0
    data_axis: str = "data"
    model_axis: str = "model"


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


def build_train_mesh(n_devices: Optional[int] = None,
                     config: TrainConfig = TrainConfig()) -> Mesh:
    """The (data, model) mesh over the world's ranks: ``model`` is 2 when
    the rank count is even and at least 2, else 1.  ``n_devices`` defaults
    to the world size and must equal it (one rank without a process
    group)."""
    _, size = world()
    n = n_devices or size
    if n != size:
        raise ValueError(f"a train mesh of {n} ranks does not cover {size} ranks")
    model = 2 if n % 2 == 0 and n >= 2 else 1
    return Mesh(np.arange(n).reshape(n // model, model),
                (config.data_axis, config.model_axis))


def train_mesh(mesh: Optional[Mesh], config: TrainConfig) -> Mesh:
    """The mesh a step runs on: ``build_train_mesh(config=config)`` for None
    (the 1 x 1 mesh when no process group is up); else ``mesh``, which must
    have the config's two axes and no other axis of more than one rank."""
    if mesh is None:
        return build_train_mesh(config=config)
    axes = (config.data_axis, config.model_axis)
    missing = [a for a in axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"the mesh's axes {mesh.axis_names} lack {missing} "
                         "(TrainConfig.data_axis / model_axis)")
    extra = {a: n for a, n in mesh.shape.items() if a not in axes and n > 1}
    if extra:
        raise ValueError(f"a train mesh splits over {axes} only, not {extra}")
    return mesh


def param_partition_spec(params: Dict[str, torch.Tensor], mesh: Any, model_axis: str, *,
                         num_heads: Optional[int] = None) -> Dict[str, Optional[int]]:
    """The JAX package's TP partition rule, read on the Flax layout so that
    both packages shard the same weights: each parameter of two or more
    dimensions, except biases and LayerNorm scales, is sharded on its last
    Flax axis that divides evenly by the ``model_axis`` size.

    -> per torch parameter name, the torch dim that holds that axis
    (``models/convert.py:flax_layout``; ``nn.Linear`` is [out, in] where
    Flax's kernel is [in, out]), or None (replicated).  The attention
    projections need ``num_heads``.  A rank keeps a contiguous block of that
    dim; which elements it holds does not change the numbers, since the
    weights are gathered whole before use and the clip and AdamW act on
    elements."""
    tp = mesh.shape[model_axis]
    spec: Dict[str, Optional[int]] = {}
    for name, t in params.items():
        spec[name] = None
        if tp <= 1 or "bias" in name or "scale" in name:
            continue
        shape, dims = flax_layout(name, tuple(t.shape), num_heads)
        if len(shape) < 2:
            continue
        for axis in range(len(shape) - 1, -1, -1):
            if shape[axis] % tp == 0 and shape[axis] >= tp:
                spec[name] = dims[axis]
                break
    return spec


class MeshParams:
    """A module's trainable parameters on a training mesh, gathered on use.

    Between steps each parameter that ``param_partition_spec`` shards is
    this rank's slice: the module's parameter holds the slice itself (and
    AdamW's state is the slice's shape), so a rank keeps 1/tp of those
    weights.  ``gather()`` gives the module its whole weights for a forward
    (an all-gather over ``model``); ``release()`` takes them back to the
    slices, and each whole gradient to this rank's slice of it."""

    def __init__(self, model: nn.Module, mesh: Mesh, config: TrainConfig):
        self.model = model
        self.mesh, self.data_axis, self.model_axis = mesh, config.data_axis, config.model_axis
        self.tp = mesh.shape[self.model_axis]
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        spec = param_partition_spec(dict(named), mesh, self.model_axis,
                                    num_heads=model.config.num_heads)
        self.params = [p for _, p in named]
        self.dims = [spec[n] for n, _ in named]
        me = mesh.index(self.model_axis)
        self.slices = [None if d is None else
                       torch.chunk(p.detach(), self.tp, d)[me].clone(
                           memory_format=torch.contiguous_format)
                       for p, d in zip(self.params, self.dims)]
        self.whole = True
        self.release()

    def _sharded(self):
        return [(p, d, s) for p, d, s in zip(self.params, self.dims, self.slices)
                if d is not None]

    @torch.no_grad()
    def gather(self) -> None:
        """The module's sharded parameters whole: the slices all-gathered
        over ``model`` (one bucket).  Collective: every rank of the mesh
        calls it at the same point."""
        sharded = self._sharded()
        if not self.whole and sharded:
            parts = all_gather(torch.cat([s.reshape(-1) for _, _, s in sharded]),
                               self.mesh, self.model_axis)          # [tp, total]
            off = 0
            for p, d, s in sharded:
                n = s.numel()
                p.data = torch.cat([parts[r, off:off + n].view_as(s) for r in range(self.tp)],
                                   dim=d)
                off += n
        self.whole = True

    @torch.no_grad()
    def release(self) -> None:
        """The module's sharded parameters back to this rank's slices, and
        each whole gradient to its slice.  Every rank of ``model`` computed
        the same whole gradient from the same rows, so the slice is the
        reduce-scatter's answer without the traffic."""
        if not self.whole:
            return
        me = self.mesh.index(self.model_axis)
        for p, d, s in self._sharded():
            g = p.grad
            p.data = s
            if g is not None:
                p.grad = torch.chunk(g, self.tp, d)[me].clone(
                    memory_format=torch.contiguous_format)
        self.whole = False

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """After the backward: the gradients to their slices, then summed
        over ``data`` (one bucket; the ranks of a ``data`` group hold the
        same slices)."""
        self.release()
        live = [p for p in self.params if p.grad is not None]
        if self.mesh.shape[self.data_axis] > 1 and live:
            flat = all_reduce_sum(torch.cat([p.grad.reshape(-1) for p in live]),
                                  self.mesh, self.data_axis)
            for p, g in zip(live, torch.split(flat, [p.numel() for p in live])):
                p.grad.copy_(g.view_as(p.grad))

    @torch.no_grad()
    def global_norm(self) -> torch.Tensor:
        """The global norm of the full gradient: the replicated gradients
        and, summed over ``model``, the squared norms of the slices."""
        rep = [p.grad for p, d in zip(self.params, self.dims)
               if d is None and p.grad is not None]
        sliced = [p.grad for p, d in zip(self.params, self.dims)
                  if d is not None and p.grad is not None]
        norms = list(torch._foreach_norm(rep)) if rep else []
        if sliced:
            sq = torch.sum(torch.stack(torch._foreach_norm(sliced)) ** 2)
            norms.append(torch.sqrt(all_reduce_sum(sq, self.mesh, self.model_axis)))
        return torch.linalg.vector_norm(torch.stack(norms))


def data_rows(batch: Dict[str, torch.Tensor], keys: Iterable[str], mesh: Mesh,
              axis: str) -> Dict[str, torch.Tensor]:
    """The global batch with its ``keys`` cut to this rank's rows over
    ``axis`` (the other entries stay whole)."""
    s = mesh.shape[axis]
    if s == 1:
        return batch
    c = mesh.index(axis)
    out = dict(batch)
    for k in keys:
        if k in batch:
            n = batch[k].shape[0]
            if n % s:
                raise ValueError(f"batch[{k!r}] has {n} rows, not a multiple of the "
                                 f"{s} ranks of {axis!r}")
            out[k] = batch[k][c * (n // s):(c + 1) * (n // s)]
    return out


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: each gradient kept when the
    global norm (computed from ``grads`` unless given) is below
    ``max_norm``, else ``g / norm * max_norm``.  Returns the global norm
    before clipping (on the device, no sync)."""
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class OptState:
    """The optimizer state of one module's parameters: AdamW, the schedule
    (``LambdaLR`` at the update count) and the global-norm clip.  With
    ``mesh_params`` (``MeshParams``) the update acts on each rank's slices:
    the gradients are sliced and summed over ``data`` first.

    ``update()`` applies one update from the gradients in ``.grad`` and
    returns their global norm before clipping."""

    def __init__(self, params: Iterable[nn.Parameter], config: TrainConfig,
                 mesh_params: Optional[MeshParams] = None):
        self.mesh_params = mesh_params
        self.params = (list(mesh_params.params) if mesh_params is not None
                       else [p for p in params if p.requires_grad])
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

    def gather(self) -> None:
        """Give the module its whole weights for the forward (a step calls
        it first; collective over ``model``)."""
        if self.mesh_params is not None:
            self.mesh_params.gather()

    def full_params(self) -> Dict[str, torch.Tensor]:
        """The module's state dict with its whole weights, for an eval, a
        checkpoint or the trained model.  On a ``model`` axis of more than
        one rank the weights are gathered into the module (collective:
        every rank of the mesh calls it at the same point) and stay whole
        until the next step; the ``params`` a step returns hold the
        slices."""
        if self.mesh_params is None:
            raise ValueError("full_params needs the state of a trainer's step "
                             "(Optimizer.init with mesh_params)")
        self.gather()
        return self.mesh_params.model.state_dict()

    @torch.no_grad()
    def update(self) -> torch.Tensor:
        mp = self.mesh_params
        if mp is not None:
            mp.reduce_grads()
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = clip_by_global_norm(grads, self.max_grad_norm,
                                   None if mp is None else mp.global_norm())
        self.adamw.step()
        self.lr_schedule.step()
        return norm


class Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule,
    weight_decay))`` for ``torch.optim``: ``init(params)`` gives the state
    (``init(params, mesh_params)`` on a training mesh)."""

    def __init__(self, config: TrainConfig):
        self.config = config

    def init(self, params: Iterable[nn.Parameter],
             mesh_params: Optional[MeshParams] = None) -> OptState:
        return OptState(params, self.config, mesh_params)


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


def prepare(model: nn.Module, optimizer: Optimizer, config: TrainConfig,
            mesh: Optional[Mesh], params: Any, device: DeviceLike
            ) -> Tuple[Mesh, OptState, Callable[[torch.Tensor], torch.Tensor]]:
    """What every trainer's step starts from: the module on ``device`` with
    ``params`` loaded, its optimizer state on the mesh, and the
    differentiable gather of per-row outputs across ``data``."""
    dev = resolve_device(device)
    mesh = train_mesh(mesh, config)
    model.to(dev)
    assign_params(model, params)
    opt_state = optimizer.init(model.parameters(), MeshParams(model, mesh, config))
    return mesh, opt_state, lambda t: gather_rows(t, mesh, config.data_axis)


#: the entries of a contrastive batch that are split over ``data``
SPLIT_KEYS = ("q_ids", "q_mask", "d_ids", "d_mask", "n_ids", "n_mask")


def make_train_step(
    model: nn.Module,
    optimizer: Optimizer,
    config: TrainConfig,
    mesh: Optional[Mesh] = None,
    params: Any = None,
    device: DeviceLike = None,
) -> Tuple[Callable, Dict[str, torch.Tensor], OptState]:
    """Build the contrastive step on ``device`` (the card unless ``"cpu"``)
    over ``mesh`` (None: ``build_train_mesh(config=config)``).

    Returns ``(step_fn, params, opt_state)``: ``params`` is the module's
    state dict (``params`` given here are loaded into it first; on a
    ``model`` axis of several ranks it holds this rank's slices of the
    sharded weights, ``opt_state.full_params()`` the whole ones), and
    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    updates it in place.  ``batch`` is the global batch, the same on every
    rank: q_ids/q_mask/d_ids/d_mask [B, L] and, optionally, n_ids/n_mask
    [B*H, L] (mined hard negatives), B and B*H divisible by the ``data``
    size.  ``metrics``: loss, accuracy and the global gradient norm before
    clipping, as 0-d tensors on the device, the same on every rank.  The
    forward is deterministic (train() mode, no dropout generator), as
    JAX's ``model.apply`` without dropout rngs.
    """
    mesh, opt_state, gather = prepare(model, optimizer, config, mesh, params, device)
    model.train()

    def loss_fn(batch):
        part = data_rows(batch, SPLIT_KEYS, mesh, config.data_axis)
        q = gather(model(part["q_ids"], part["q_mask"]))
        d = gather(model(part["d_ids"], part["d_mask"]))
        neg = gather(model(part["n_ids"], part["n_mask"])) if "n_ids" in part else None
        return _info_nce(q, d, config.temperature, neg=neg)

    def train_step(p, opt: OptState, batch):
        opt.zero_grad()
        opt.gather()
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
    "MeshParams",
    "build_train_mesh",
    "param_partition_spec",
    "train_mesh",
    "cloze_query",
    "Optimizer",
    "OptState",
    "make_optimizer",
    "make_train_step",
    "synthetic_pair_batch",
    "warmup_cosine_decay",
]

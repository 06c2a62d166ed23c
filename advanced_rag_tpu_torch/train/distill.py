"""Cross-encoder distillation from the bi-encoder: the port of
``advanced_rag_tpu/train/distill.py``.

A cross-encoder is bootstrapped with zero labels: for each synthetic
inverse-cloze query the teacher bi-encoder scores the positive document
and random corpus negatives (cosine / temperature), and the student
matches the teacher's distribution over the slate (listwise KL(teacher ||
student)).  The teacher runs under ``torch.no_grad()`` and returns numpy,
so its targets enter the student's loss as plain data.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, resolve_device
from ..models.encoder import CrossEncoder, EncoderConfig, init_cross_encoder
from ..models.tokenizer import HashingTokenizer, TokenizerConfig
from .contrastive import (Optimizer, OptState, TrainConfig, cloze_query, data_rows,
                          make_optimizer, prepare, to_device)


@dataclass
class DistillConfig:
    steps: int = 300
    queries_per_batch: int = 16
    candidates_per_query: int = 8     # 1 positive + (M-1) random negatives
    teacher_temperature: float = 0.05  # matches InfoNCE training temp
    student_temperature: float = 1.0
    log_every: int = 50
    seed: int = 0


def make_distill_batch(
    tok: HashingTokenizer,
    texts: Sequence[str],
    cfg: DistillConfig,
    rng: np.random.Generator,
    max_len: int,
    device: DeviceLike = None,
) -> Tuple[Dict[str, torch.Tensor], List[str], List[List[str]]]:
    """-> (student pair batch [B*M, L] on ``device``, queries [B],
    candidate docs [B][M]); candidate 0 is the positive.  The same rng
    draws as the JAX function; the same (queries, docs) go to the teacher."""
    b, m = cfg.queries_per_batch, cfg.candidates_per_query
    pos = rng.integers(0, len(texts), b)
    queries = [cloze_query(texts[i], rng) for i in pos]
    cand = np.empty((b, m), np.int64)
    cand[:, 0] = pos
    cand[:, 1:] = rng.integers(0, len(texts), (b, m - 1))
    docs = [[texts[i] for i in row] for row in cand]
    q_rep = [q for q in queries for _ in range(m)]
    d_rep = [d for row in docs for d in row]
    ids, mask, segs = tok.encode_pairs(q_rep, d_rep)
    return to_device({"ids": ids, "mask": mask, "segs": segs}, device), queries, docs


#: the entries of a pair batch that are split over ``data``
SPLIT_KEYS = ("ids", "mask", "segs")


def make_teacher_fn(
    teacher_model: nn.Module, teacher_params: Any, tok: HashingTokenizer,
    max_len: int, temperature: float,
) -> Callable[[Sequence[str], Sequence[Sequence[str]]], np.ndarray]:
    """Teacher scoring: bi-encoder cosine / temperature -> [B, M] f32
    numpy, with ``teacher_params`` (a state dict; None: the module's own
    weights) on the module's device, deterministic."""
    params = dict(teacher_params if teacher_params is not None
                  else teacher_model.state_dict())
    dev = next(iter(params.values())).device

    @torch.no_grad()
    def score(queries: Sequence[str], docs: Sequence[Sequence[str]]) -> np.ndarray:
        def embed(texts):
            ids, mask = tok.encode_batch(list(texts), max_len)
            return torch.func.functional_call(
                teacher_model, params,
                (torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)))

        q = embed(queries)
        d = embed([d for row in docs for d in row]).reshape(len(queries), len(docs[0]), -1)
        s = torch.einsum("bd,bmd->bm", q, d) / temperature
        return s.float().cpu().numpy()

    return score


def make_distill_step(
    student: CrossEncoder,
    optimizer: Optimizer,
    tcfg: TrainConfig,
    mesh: Any,
    params: Any,
    cfg: DistillConfig,
    device: DeviceLike = None,
):
    """The distillation step on ``device`` over ``mesh`` (None:
    ``build_train_mesh(config=tcfg)``).

    -> ``(step_fn, eval_fn, params, opt_state)``:
    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    and ``eval_fn(params, batch) -> (kl, agreement)`` on whole weights
    (``opt_state.full_params()``); ``batch`` (global,
    the same on every rank): ids/mask/segs [B*M, L] + teacher [B, M]
    (already / teacher temperature).  The pairs are split over ``data``
    and their scores gathered, so every rank computes the global loss.
    Both forwards are deterministic, as JAX's.
    """
    mesh, opt_state, gather = prepare(student, optimizer, tcfg, mesh, params, device)
    student.train()
    b, m = cfg.queries_per_batch, cfg.candidates_per_query

    def loss_fn(s, batch):
        s = s.reshape(b, m) / cfg.student_temperature
        t = batch["teacher"]
        log_p = F.log_softmax(s, dim=-1)
        q = F.softmax(t, dim=-1)
        kl = torch.mean(torch.sum(q * (F.log_softmax(t, dim=-1) - log_p), dim=-1))
        agree = (torch.argmax(s, -1) == torch.argmax(t, -1)).float().mean()
        return kl, agree

    def step(p, opt: OptState, batch):
        opt.zero_grad()
        opt.gather()
        part = data_rows(batch, SPLIT_KEYS, mesh, tcfg.data_axis)
        loss, agree = loss_fn(gather(student(part["ids"], part["mask"], part["segs"])),
                              batch)
        loss.backward()
        opt.update()
        return p, opt, {"loss": loss.detach(), "teacher_agreement": agree}

    @torch.no_grad()
    def eval_fn(p, batch):
        s = torch.func.functional_call(student, dict(p),
                                       (batch["ids"], batch["mask"], batch["segs"]))
        return loss_fn(s, batch)

    return step, eval_fn, student.state_dict(), opt_state


def distill_cross_encoder(
    texts: Sequence[str],
    teacher_model: nn.Module,
    teacher_params: Any,
    *,
    encoder_config: Optional[EncoderConfig] = None,
    train_config: Optional[TrainConfig] = None,
    distill_config: Optional[DistillConfig] = None,
    mesh: Any = None,
    device: DeviceLike = None,
) -> Tuple[CrossEncoder, Dict[str, torch.Tensor], List[Dict[str, float]]]:
    """-> (student model, its state dict, history), trained on ``device``
    (the card unless ``"cpu"``; the teacher's weights must be there).  The
    state dict drops into ``CrossEncoderReranker(state_dict=...)``."""
    if not texts:
        raise ValueError("distill_cross_encoder needs a non-empty corpus")
    cfg = encoder_config or EncoderConfig()
    tcfg = train_config or TrainConfig(learning_rate=1e-4)
    dcfg = distill_config or DistillConfig()
    dev = resolve_device(device)

    student, params = init_cross_encoder(cfg, seed=dcfg.seed, device=dev)
    step_fn, eval_fn, params, opt_state = make_distill_step(
        student, make_optimizer(tcfg), tcfg, mesh, params, dcfg, device=dev)
    tok = HashingTokenizer(TokenizerConfig(vocab_size=cfg.vocab_size,
                                           max_len=cfg.max_len))
    teacher = make_teacher_fn(teacher_model, teacher_params, tok,
                              cfg.max_len, dcfg.teacher_temperature)
    rng = np.random.default_rng(dcfg.seed)

    # one fixed eval batch: per-training-batch KL is noisy (each batch has
    # its own teacher-entropy floor)
    ev_batch, ev_q, ev_docs = make_distill_batch(
        tok, texts, dcfg, np.random.default_rng(dcfg.seed + 1), cfg.max_len, device=dev)
    ev_batch["teacher"] = torch.from_numpy(teacher(ev_q, ev_docs)).to(dev)

    history: List[Dict[str, float]] = []
    t0 = time.perf_counter()
    for step_i in range(1, dcfg.steps + 1):
        batch, queries, docs = make_distill_batch(tok, texts, dcfg, rng, cfg.max_len,
                                                  device=dev)
        batch["teacher"] = torch.from_numpy(teacher(queries, docs)).to(dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step_i % dcfg.log_every == 0 or step_i == dcfg.steps:
            params = opt_state.full_params()
            ev_loss, ev_agree = eval_fn(params, ev_batch)
            history.append({
                "step": step_i,
                "loss": float(metrics["loss"]),
                "teacher_agreement": float(metrics["teacher_agreement"]),
                "eval_loss": float(ev_loss),
                "eval_agreement": float(ev_agree),
                "elapsed_s": time.perf_counter() - t0,
            })
    return student.eval(), opt_state.full_params(), history


__all__ = [
    "DistillConfig",
    "make_distill_batch",
    "make_teacher_fn",
    "make_distill_step",
    "distill_cross_encoder",
]

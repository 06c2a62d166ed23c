"""Supervised cross-encoder reranker training with hard negatives, and
its checkpoints: the port of ``advanced_rag_tpu/train/rerank.py``.

Listwise cross-entropy over slates of one positive and mined negatives
(false negatives filtered by word Jaccard), optionally as a residual on
the slate's z-normalized retrieval score and with label smoothing; the
trunk can be warm-started from a trained bi-encoder.  Attention dropout
(``config.dropout``) runs in the train step only, from a
``torch.Generator`` seeded with ``seed + 7``; the eval function is
deterministic.  Early stopping keeps a host copy of the best weights.

The static-slot pair layout the reranker was trained with
(``pair_q_len``/``pair_d_len``) is saved beside its geometry, so that the
service restores the train-time input format (``RAG_RERANKER=ckpt:``).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import DeviceLike, resolve_device
from ..models.convert import encoder_config_from_meta
from ..models.encoder import CrossEncoder, EncoderConfig, init_cross_encoder
from ..models.tokenizer import HashingTokenizer, TokenizerConfig
from .contrastive import (OptState, Optimizer, TrainConfig, data_rows, make_optimizer,
                          prepare, to_device)
from .distill import SPLIT_KEYS
from .loop import Params, encoder_meta, load_params, save_params


@dataclass
class RerankTrainConfig:
    steps: int = 600
    queries_per_batch: int = 16
    candidates_per_query: int = 8     # 1 positive + (M-1) hard/random negatives
    log_every: int = 100
    seed: int = 0
    # static-slot pair layout (tokenizer.encode_pairs_static) of the fused
    # serving program: q_len + d_len + 1 must fit the encoder's max_len
    q_len: int = 32
    d_len: int = 48
    # held-out fraction of pairs for the eval batches (0: eval on
    # train-distribution slates, marked in history)
    eval_frac: float = 0.05
    # listwise label smoothing: (1 - a) * onehot + a / M
    label_smoothing: float = 0.0
    # residual mode: the slate's z-normalized retrieval score is added to
    # the CE logits in the loss (needs base scores in the batch)
    residual: bool = False
    # early stopping on the held-out eval loss at every log_every step: stop
    # after this many evals without improvement and return the best
    # weights; 0 disables
    early_stop_patience: int = 0


_JACCARD_WORD_RE = re.compile(r"[a-z0-9]+")


def token_jaccard(a: str, b: str) -> float:
    """Word-set Jaccard similarity: the false-negative detector."""
    sa = set(_JACCARD_WORD_RE.findall(a.lower()))
    sb = set(_JACCARD_WORD_RE.findall(b.lower()))
    if not sa or not sb:
        return 0.0
    return len(sa & sb) / len(sa | sb)


def filter_false_negatives(positive: str, candidates: Sequence[str],
                           max_jaccard: float = 0.8) -> List[str]:
    """Drop mined negatives that are (near-)duplicates of the positive:
    labeled negative they are contradictory supervision."""
    return [c for c in candidates
            if c != positive and token_jaccard(positive, c) < max_jaccard]


def make_rerank_batch(
    tok: HashingTokenizer,
    pairs: Sequence[Tuple[str, str]],
    negatives: Sequence[Sequence[str]],
    cfg: RerankTrainConfig,
    rng: np.random.Generator,
    base_scores: Optional[Sequence[Tuple[float, Sequence[float]]]] = None,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """One listwise batch on ``device``: ids/mask/segs [B*M, L], label [B]
    and base [B, M] (the slate's z-normalized retrieval scores, zeros
    without ``base_scores``); the same ``rng`` draws as the JAX function.

    Each sampled query's slate is its positive at a random slot plus M-1
    negatives from its mined list, topped up with other pairs' positives
    (at the list's lowest retrieval score) when the list is short;
    negatives equal to the positive are never used, and a pair list that
    cannot fill a slate raises.
    """
    b, m = cfg.queries_per_batch, cfg.candidates_per_query
    if len(pairs) < 2 and m > 1:
        raise ValueError(
            "make_rerank_batch needs >=2 pairs to draw negatives "
            f"(got {len(pairs)} with candidates_per_query={m})")
    sel = rng.integers(0, len(pairs), b)
    labels = rng.integers(0, m, b).astype(np.int32)
    q_rep: List[str] = []
    d_rep: List[str] = []
    base = np.zeros((b, m), np.float32)
    for row, qi in enumerate(sel):
        query, pos_doc = pairs[qi]
        neg_texts = list(negatives[qi]) if qi < len(negatives) else []
        if base_scores is not None:
            pos_s, neg_s = base_scores[qi]
            pool = [(t, float(s)) for t, s in zip(neg_texts, neg_s) if t != pos_doc]
        else:
            pos_s = 0.0
            pool = [(t, 0.0) for t in neg_texts if t != pos_doc]
        mined_min = min([s for _, s in pool], default=0.0)
        need = m - 1
        attempts = 0
        while len(pool) < need:
            j = int(rng.integers(0, len(pairs)))
            if j != qi and pairs[j][1] != pos_doc:
                pool.append((pairs[j][1], mined_min))
            attempts += 1
            if attempts > 100 * need + 100:
                raise ValueError(
                    "cannot assemble a negative slate: every other pair's "
                    "document equals this query's positive")
        negs = [pool[i] for i in rng.permutation(len(pool))[:need]]
        slate = negs[: labels[row]] + [(pos_doc, float(pos_s))] + negs[labels[row]:]
        q_rep.extend([query] * m)
        d_rep.extend([t for t, _ in slate])
        if base_scores is not None:
            v = np.asarray([s for _, s in slate], np.float64)
            sd = v.std()
            base[row] = ((v - v.mean()) / (sd if sd > 1e-9 else 1.0)).astype(np.float32)
    ids, mask, segs = tok.encode_pairs_static(q_rep, d_rep, cfg.q_len, cfg.d_len)
    return to_device({"ids": ids, "mask": mask, "segs": segs, "label": labels,
                      "base": base}, device)


def warm_start_cross_encoder(ce_params: Params, bi_params: Params) -> Dict[str, torch.Tensor]:
    """Copy a trained bi-encoder's trunk into cross-encoder weights.

    -> a new state dict: every ``trunk.*`` tensor of the bi-encoder cloned
    (never aliased: training the reranker must not rewrite the serving
    bi-encoder), on the cross-encoder's device; a longer CE position table
    takes the bi-encoder's prefix and keeps its own tail.  The CE-only
    tensors (``seg_embed``, ``match_embed``, ``pool``, ``score``) keep
    their fresh initialization.
    """
    ce = dict(ce_params.state_dict() if isinstance(ce_params, torch.nn.Module) else ce_params)
    bi = bi_params.state_dict() if isinstance(bi_params, torch.nn.Module) else bi_params
    for name, leaf in bi.items():
        if not name.startswith("trunk."):
            continue
        target = ce[name]
        leaf = leaf.detach().to(device=target.device, dtype=torch.float32)
        if name == "trunk.pos_embed" and target.shape != leaf.shape:
            n = min(target.shape[0], leaf.shape[0])
            ce[name] = torch.cat([leaf[:n], target[n:]], dim=0)
        else:
            ce[name] = leaf.clone()
    return ce


def make_rerank_step(
    student: CrossEncoder,
    optimizer: Optimizer,
    tcfg: TrainConfig,
    mesh: Any,
    params: Any,
    cfg: RerankTrainConfig,
    device: DeviceLike = None,
):
    """The listwise-CE step on ``device`` over ``mesh`` (None:
    ``build_train_mesh(config=tcfg)``).

    -> ``(step_fn, eval_fn, params, opt_state)``:
    ``step_fn(params, opt_state, batch, generator) -> (params, opt_state,
    metrics)`` trains in train() mode, with attention dropout drawn from
    ``generator`` when ``student.config.dropout > 0``;
    ``eval_fn(params, batch) -> (loss, accuracy)`` is deterministic and
    takes whole weights (``opt_state.full_params()``).
    ``batch`` (global, the same on every rank): ids/mask/segs [B*M, L],
    label [B], base [B, M]; the pairs are split over ``data`` and their
    scores gathered, so every rank computes the global loss.  The dropout
    masks are [1, 1, L, L], global as JAX's: every rank draws them from a
    generator seeded alike, so they are the same on every rank.
    """
    mesh, opt_state, gather = prepare(student, optimizer, tcfg, mesh, params, device)
    b, m = cfg.queries_per_batch, cfg.candidates_per_query

    def loss_fn(s, batch):
        s = s.reshape(b, m)
        if cfg.residual:
            s = s + batch["base"]
        label = batch["label"].long()
        loss = F.cross_entropy(s, label, label_smoothing=cfg.label_smoothing)
        acc = (torch.argmax(s, -1) == label).float().mean()
        return loss, acc

    def step(p, opt: OptState, batch, generator=None):
        student.train()
        opt.zero_grad()
        opt.gather()
        part = data_rows(batch, SPLIT_KEYS, mesh, tcfg.data_axis)
        loss, acc = loss_fn(gather(student(part["ids"], part["mask"], part["segs"],
                                           generator=generator)), batch)
        loss.backward()
        opt.update()
        return p, opt, {"loss": loss.detach(), "accuracy": acc}

    @torch.no_grad()
    def eval_fn(p, batch):
        student.eval()
        s = torch.func.functional_call(student, dict(p),
                                       (batch["ids"], batch["mask"], batch["segs"]))
        return loss_fn(s, batch)

    return step, eval_fn, student.state_dict(), opt_state


def train_reranker(
    pairs: Sequence[Tuple[str, str]],
    negatives: Sequence[Sequence[str]],
    *,
    encoder_config: Optional[EncoderConfig] = None,
    train_config: Optional[TrainConfig] = None,
    rerank_config: Optional[RerankTrainConfig] = None,
    mesh: Any = None,
    tokenizer: Optional[HashingTokenizer] = None,
    warm_start_params: Optional[Params] = None,
    base_scores: Optional[Sequence[Tuple[float, Sequence[float]]]] = None,
    device: DeviceLike = None,
) -> Tuple[CrossEncoder, Dict[str, torch.Tensor], List[Dict[str, float]]]:
    """-> (model, trained state dict, history), trained on ``device`` (the
    card unless ``"cpu"``).

    ``pairs``: (query, positive_doc); ``negatives[i]``: mined hard
    negatives of pairs[i] (filter them with :func:`filter_false_negatives`).
    ``warm_start_params``: a trained bi-encoder (module or state dict),
    whose trunk is copied in by :func:`warm_start_cross_encoder`.
    ``rerank_config.eval_frac`` of the pairs are held out before training
    (a ``seed + 2`` permutation) and four eval batches drawn from them
    (seeds ``seed + 1 + i``); history rows carry ``eval_is_heldout: 0.0``
    when the pool is too small to split.  With early stopping the model
    and the returned state dict (a host copy) are the best eval loss's.
    """
    if not pairs:
        raise ValueError("train_reranker needs a non-empty pair list")
    cfg = encoder_config or EncoderConfig()
    tcfg = train_config or TrainConfig(learning_rate=3e-4)
    rcfg = rerank_config or RerankTrainConfig()
    if rcfg.q_len + rcfg.d_len + 1 > cfg.max_len:
        raise ValueError(
            f"pair length {rcfg.q_len}+{rcfg.d_len}+1 exceeds encoder "
            f"max_len {cfg.max_len}")
    dev = resolve_device(device)

    student, params = init_cross_encoder(cfg, seed=rcfg.seed, device=dev)
    if warm_start_params is not None:
        params = warm_start_cross_encoder(params, warm_start_params)
    step_fn, eval_fn, params, opt_state = make_rerank_step(
        student, make_optimizer(tcfg), tcfg, mesh, params, rcfg, device=dev)
    tok = tokenizer or HashingTokenizer(
        TokenizerConfig(vocab_size=cfg.vocab_size, max_len=cfg.max_len))
    rng = np.random.default_rng(rcfg.seed)

    n_eval = int(len(pairs) * rcfg.eval_frac)
    heldout = n_eval >= rcfg.queries_per_batch and \
        len(pairs) - n_eval >= 2 * rcfg.queries_per_batch
    if rcfg.residual and base_scores is None:
        raise ValueError("residual training needs base_scores (the "
                         "retrieval scores of each mined candidate)")
    if heldout:
        perm = np.random.default_rng(rcfg.seed + 2).permutation(len(pairs))
        ev_idx, tr_idx = perm[:n_eval], perm[n_eval:]
        tr_pairs = [pairs[i] for i in tr_idx]
        tr_negs = [negatives[i] if i < len(negatives) else [] for i in tr_idx]
        ev_pairs = [pairs[i] for i in ev_idx]
        ev_negs = [negatives[i] if i < len(negatives) else [] for i in ev_idx]
        tr_base = [base_scores[i] for i in tr_idx] if base_scores is not None else None
        ev_base = [base_scores[i] for i in ev_idx] if base_scores is not None else None
    else:
        tr_pairs, tr_negs = list(pairs), list(negatives)
        ev_pairs, ev_negs = tr_pairs, tr_negs
        tr_base = ev_base = list(base_scores) if base_scores is not None else None
    ev_batches = [make_rerank_batch(tok, ev_pairs, ev_negs, rcfg,
                                    np.random.default_rng(rcfg.seed + 1 + i),
                                    base_scores=ev_base, device=dev)
                  for i in range(4)]
    # the floor: ranking the held-out slates by the retrieval score alone
    base_acc = float(np.mean([
        np.mean(np.argmax(eb["base"].cpu().numpy(), axis=1) == eb["label"].cpu().numpy())
        for eb in ev_batches])) if base_scores is not None else None

    history: List[Dict[str, float]] = []
    t0 = time.perf_counter()
    drop_gen = torch.Generator(device=dev).manual_seed(rcfg.seed + 7)
    best_loss, best_params, best_step, stale = float("inf"), None, 0, 0
    early = rcfg.early_stop_patience > 0 and heldout
    for step_i in range(1, rcfg.steps + 1):
        batch = make_rerank_batch(tok, tr_pairs, tr_negs, rcfg, rng,
                                  base_scores=tr_base, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch, drop_gen)
        if step_i % rcfg.log_every == 0 or step_i == rcfg.steps:
            params = opt_state.full_params()
            evs = [eval_fn(params, eb) for eb in ev_batches]
            row = {
                "step": step_i,
                "loss": float(metrics["loss"]),
                "accuracy": float(metrics["accuracy"]),
                "eval_loss": float(np.mean([float(e[0]) for e in evs])),
                "eval_accuracy": float(np.mean([float(e[1]) for e in evs])),
                "eval_is_heldout": 1.0 if heldout else 0.0,
                "elapsed_s": time.perf_counter() - t0,
            }
            if base_acc is not None:
                row["eval_base_accuracy"] = base_acc
            history.append(row)
            if early:
                if row["eval_loss"] < best_loss - 1e-4:
                    best_loss, best_step, stale = row["eval_loss"], step_i, 0
                    # a copy on the host: the live weights move on
                    best_params = {k: v.detach().to("cpu", torch.float32, copy=True)
                                   for k, v in params.items()}
                else:
                    stale += 1
                    if stale >= rcfg.early_stop_patience:
                        history[-1]["early_stopped"] = 1.0
                        break
    params = opt_state.full_params()
    if early and best_params is not None:
        history[-1]["best_step"] = best_step
        history[-1]["best_eval_loss"] = best_loss
        student.load_state_dict(best_params)
        params = best_params
    return student.eval(), params, history


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


__all__ = ["RerankTrainConfig", "token_jaccard", "filter_false_negatives",
           "make_rerank_batch", "warm_start_cross_encoder", "make_rerank_step",
           "train_reranker", "save_reranker", "load_reranker"]

"""Gloo ranks on the CPU for the port's sharded tests; imports torch and the
port only, never JAX.

A test computes its JAX reference in its own process, writes the inputs
with ``torch.save`` and calls ``run_ranks(suite, world, data, tmp)``,
which starts ``world`` processes of

    python tests/torch_dist_worker.py SUITE RANK WORLD PORT INPUT OUTPUT

Each rank joins a Gloo process group on 127.0.0.1 (60 s timeout, one
thread, a lower scheduling priority), runs every case of the suite on its own shard and saves what it
returned.  ``run_ranks`` joins the ranks within a time limit, kills them
and raises when one fails or the limit passes, and returns each rank's
result.  One group of ranks runs at a time on the machine (a lock file in
the temporary directory, held across test workers), so that the groups
of several test files do not crowd out the tests that run beside them.
"""

from __future__ import annotations

import fcntl
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from advanced_rag_tpu_torch.config import MeshConfig  # noqa: E402
from advanced_rag_tpu_torch.parallel.mesh import init_world  # noqa: E402
from advanced_rag_tpu_torch.models.convert import (ivf_partitions_from_numpy,  # noqa: E402
                                                   ivfpq_from_numpy)
from advanced_rag_tpu_torch.parallel import (build_mesh, build_pod_mesh,  # noqa: E402
                                             build_sharded_ivf, build_sharded_ivfpq,
                                             gather_merge_topk, hierarchical_merge_topk,
                                             make_sharded_retrieve_rerank, pod_dense_topk,
                                             shard_corpus_arrays, sharded_dense_topk,
                                             sharded_hybrid_retrieve, sharded_ivf_topk,
                                             sharded_ivfpq_topk, sharded_sparse_topk,
                                             sharded_token_gather, tree_merge_topk)

TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(suite: str, world: int, data, tmp: Path, timeout_s: float = 240.0):
    """Run ``suite`` on ``world`` Gloo ranks -> the list of their results.
    A port taken by another process between its pick and rank 0's bind is
    picked again (twice at most)."""
    tmp = Path(tmp)
    inp, out = tmp / f"{suite}.in.pt", tmp / f"{suite}.out"
    torch.save(data, inp)
    with open(Path(tempfile.gettempdir()) / "torch_dist_worker.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for attempt in range(3):
            failed, text = _launch(suite, world, inp, out, tmp, timeout_s)
            if not failed:
                return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]
            if "address already in use" not in text.lower() or attempt == 2:
                raise AssertionError(f"{suite}: {failed}:\n{text[-4000:]}")


def _launch(suite, world, inp, out, tmp, timeout_s):
    """One start of the ranks -> ("" or what failed, the failed rank's log)."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    logs = [open(tmp / f"{suite}.{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, suite, str(r), str(world),
                               str(port), str(inp), str(out)],
                              cwd=REPO, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    text = ""
    if bad:
        logs[bad[0]].seek(0)
        text = logs[bad[0]].read()
    for f in logs:
        f.close()
    if not bad:
        return "", ""
    code = procs[bad[0]].returncode
    return f"rank {bad[0]} exited with {code} (negative: killed past {timeout_s} s)", text


SUITES = {}


def suite(fn):
    SUITES[fn.__name__] = fn
    return fn


def mirror(doc_idx, doc_tf):
    """The rank's [P, local_n] slot mirror of its doc-major rows (K3's
    layout, bf16 term frequencies as the sparse index keeps them)."""
    return doc_idx.T.contiguous(), doc_tf.T.contiguous().to(torch.bfloat16)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@suite
def parallel(d):
    """Mesh coordinates, both merges, the sharded dense (f32, SQ8, queries
    split over data) and sparse (bm25, ip) programs."""
    mesh4 = build_mesh(MeshConfig(mesh_shape=(4, 1)))
    mesh22 = build_mesh(MeshConfig(mesh_shape=(2, 2)))
    k = d["k"]
    out = {"coords4": mesh4.coords, "coords22": mesh22.coords}
    emb, valid = shard_corpus_arrays(mesh4, d["emb"], d["valid"], device="cpu")
    q = t(d["q"])
    out["dense"] = sharded_dense_topk(emb, q, k, valid, mesh=mesh4, metric="ip")
    out["masked"] = sharded_dense_topk(emb, q[:1], 5, torch.zeros_like(valid), mesh=mesh4)
    codes, scale = shard_corpus_arrays(mesh4, d["codes"], d["scale"], device="cpu")
    out["sq8"] = sharded_dense_topk(codes, t(d["q_sq8"]), k, None, scale, mesh=mesh4)
    emb22 = shard_corpus_arrays(mesh22, d["emb22"], device="cpu")
    per = d["q22"].shape[0] // 2
    j = mesh22.index("data")
    out["dense22"] = sharded_dense_topk(emb22, t(d["q22"][j * per:(j + 1) * per]), k,
                                        None, mesh=mesh22)
    di, dt, dl, v = shard_corpus_arrays(mesh4, d["doc_idx"], d["doc_tf"], d["doc_len"],
                                        d["sp_valid"], device="cpu")
    idx_t, tf_t = mirror(di, dt)
    for scoring in ("bm25", "ip"):
        out[scoring] = sharded_sparse_topk(idx_t, tf_t, dl, t(d["df"]), t(d["n_docs"]),
                                           t(d["q_idx"]), t(d["q_tf"]), k, v, mesh=mesh4,
                                           scoring=scoring)
    r = mesh4.index("shard")
    s_l, i_l = t(d["m_scores"][r]), t(d["m_ids"][r])
    out["gather"] = gather_merge_topk(s_l, i_l, d["mk"], "shard", mesh=mesh4)
    out["tree"] = tree_merge_topk(s_l, i_l, d["mk"], "shard", 4, mesh=mesh4)
    return out


def _parts(arrays, r):
    return SimpleNamespace(**{f: (None if a is None else a[r]) for f, a in arrays.items()})


@suite
def sharded(d):
    """The fused hybrid on every rung, IVF / IVF-PQ search and builds, the
    token gather and the sharded retrieve + rerank."""
    mesh = build_mesh(MeshConfig(mesh_shape=(4, 1)))
    r = mesh.index("shard")
    out = {}
    h = d["hybrid"]
    emb, codes, scale, pq_codes, di, dt, dl, v = shard_corpus_arrays(
        mesh, h["emb"], h["codes"], h["scale"], h["pq_codes"], h["doc_idx"], h["doc_tf"],
        h["doc_len"], h["valid"], device="cpu")
    idx_t, tf_t = mirror(di, dt)
    common = (idx_t, tf_t, dl, t(h["df"]), t(h["n_docs"]), t(h["q"]), t(h["q_idx"]),
              t(h["q_tf"]), v, t(h["w"]), t(h["lam"]))
    kw = dict(mesh=mesh, k_cand=24, k_out=8)
    for mmr in (False, True):
        out[f"scan-{mmr}"] = sharded_hybrid_retrieve(emb, *common, use_mmr=mmr, **kw)
    out["sq8"] = sharded_hybrid_retrieve(codes, *common, None, scale, dense_impl="sq8", **kw)
    out["pq"] = sharded_hybrid_retrieve(pq_codes, *common, t(h["pq_cb"]), dense_impl="pq",
                                        pq_m=h["pq_m"], pq_bits=4, dense_depth=96, **kw)

    f = d["ivf"]
    emb, codes, scale, pq_codes, di, dt, dl, v = shard_corpus_arrays(
        mesh, f["emb"], f["codes"], f["scale"], f["pq_codes"], f["doc_idx"], f["doc_tf"],
        f["doc_len"], f["valid"], device="cpu")
    idx_t, tf_t = mirror(di, dt)
    q = t(f["q"])
    common = (idx_t, tf_t, dl, t(f["df"]), t(f["n_docs"]), q, t(f["q_idx"]), t(f["q_tf"]),
              v, t(f["w"]), t(f["lam"]))
    kw = dict(mesh=mesh, k_cand=16, k_out=8, nprobe=16)
    parts = {dt_: ivf_partitions_from_numpy(_parts(f[f"parts_{dt_}"], r), device="cpu")
             for dt_ in ("bfloat16", "int8")}
    out["ivf-bfloat16"] = sharded_hybrid_retrieve(emb, *common, None, None, None,
                                                  parts["bfloat16"], dense_impl="ivf",
                                                  dense_depth=40, **kw)
    out["ivf-int8"] = sharded_hybrid_retrieve(codes, *common, None, scale, None,
                                              parts["int8"], dense_impl="ivf",
                                              dense_depth=40, **kw)
    sidx = ivfpq_from_numpy(_parts(f["sidx"], r), device="cpu")
    out["ivfpq"] = sharded_hybrid_retrieve(pq_codes, *common, t(f["pq_cb"]), None, sidx,
                                           dense_impl="ivfpq", pq_m=f["pq_m"], pq_bits=4,
                                           dense_depth=64, **kw)
    for dt_ in ("bfloat16", "int8"):
        out[f"ivf_topk-{dt_}"] = sharded_ivf_topk(parts[dt_], q, 10, v, mesh=mesh, nprobe=16)
    m = int(sidx.codebooks.shape[0])
    out["ivfpq_topk"] = sharded_ivfpq_topk(sidx, q, 40, v, mesh=mesh, nprobe=16, m=m, bits=4)
    # the port's own per-rank builds (its k-means), at full probe
    rows = f["emb"][r * len(v):(r + 1) * len(v)]
    for dt_ in ("bfloat16", "int8"):
        own = build_sharded_ivf(rows, mesh, nlist=16, dtype=dt_, train_sample=2048,
                                device="cpu")
        out[f"own_ivf-{dt_}"] = sharded_ivf_topk(own, q, 10, v, mesh=mesh, nprobe=16)
    own = build_sharded_ivfpq(rows, mesh, nlist=16, train_sample=2048, device="cpu")
    out["own_ivfpq"] = sharded_ivfpq_topk(own, q, 40, v, mesh=mesh, nprobe=16,
                                          m=int(own.codebooks.shape[0]), bits=4)

    e = d["e2e"]
    bi, ce = e2e_models(e)
    tok, emb, di, dt, dl, v = shard_corpus_arrays(
        mesh, e["tok_ids"], e["emb"], e["doc_idx"], e["doc_tf"], e["doc_len"], e["valid"],
        device="cpu")
    out["token_gather"] = sharded_token_gather(tok, t(e["cand"]), mesh=mesh)
    prog = make_sharded_retrieve_rerank(bi, ce, mesh=mesh, **e["kw"])
    idx_t, tf_t = mirror(di, dt)
    out["e2e"] = prog(*(t(a) for a in e["queries"]), tok, emb, idx_t, tf_t, dl,
                      t(e["df"]), t(e["n_docs"]), v, t(e["w"]), t(e["lam"]))
    return out


def e2e_models(e):
    """The e2e test's bi-encoder and cross-encoder, from their state dicts."""
    from advanced_rag_tpu_torch.models.encoder import BiEncoder, CrossEncoder, EncoderConfig

    cfg = EncoderConfig(**e["enc"])
    bi, ce = BiEncoder(cfg, out_dim=e["out"]), CrossEncoder(cfg)
    bi.load_state_dict(e["bi_state"])
    ce.load_state_dict(e["ce_state"])
    return bi.eval(), ce.eval()


@suite
def multihost(d):
    """The pod mesh (dcn 2, shard 2): pod_dense_topk, masked, and the
    hierarchical merge."""
    pod = build_pod_mesh(dcn=2, shard=2, data=1)
    out = {"shape": pod.shape, "coords": pod.coords}
    block = pod.index("dcn") * 2 + pod.index("shard")
    for name in ("pod", "masked"):
        c = d[name]
        per = c["emb"].shape[0] // 4
        sl = slice(block * per, (block + 1) * per)
        valid = None if c["valid"] is None else t(c["valid"][sl])
        out[name] = pod_dense_topk(t(c["emb"][sl]), t(c["q"]), c["k"], valid, mesh=pod)
    out["hier"] = hierarchical_merge_topk(t(d["m_scores"][block]), t(d["m_ids"][block]),
                                          d["mk"], mesh=pod)
    try:
        build_pod_mesh(dcn=3, shard=2, data=1)
        out["bad_shape"] = None
    except ValueError as exc:
        out["bad_shape"] = str(exc)
    return out


@suite
def train_mesh(d):
    """The contrastive step on a (data 2, model 2) mesh: the first step's
    gradient slices (no clip), what a rank holds between steps, and two
    updates with the clip; the rerank steps (without dropout, and with it),
    the distillation steps and train_biencoder on the same mesh."""
    from advanced_rag_tpu_torch.models import encoder as tenc
    from advanced_rag_tpu_torch.train import contrastive as tc
    from advanced_rag_tpu_torch.train import distill as td
    from advanced_rag_tpu_torch.train import loop as tloop
    from advanced_rag_tpu_torch.train import rerank as tr

    mesh = tc.build_train_mesh(4)
    out = {"shape": mesh.shape, "coords": mesh.coords}
    c = d["contrastive"]
    make = lambda: tenc.BiEncoder(tenc.EncoderConfig(**c["enc"]), out_dim=c["out"])  # noqa: E731
    cfg = tc.TrainConfig(**c["train"], max_grad_norm=1e30)
    model = make()
    step, params, opt = tc.make_train_step(model, tc.make_optimizer(cfg), cfg, mesh,
                                           c["init"], device="cpu")
    step(params, opt, c["batches"][0])
    names = [n for n, _ in model.named_parameters()]
    out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
    out["sliced"] = dict(zip(names, opt.mesh_params.dims))
    # what the rank holds between steps: the module's parameters and their
    # gradients, and AdamW's moments
    out["held"] = dict(
        params=sum(p.numel() for p in model.parameters()),
        grads=sum(p.grad.numel() for p in model.parameters() if p.grad is not None),
        adam=sum(v.numel() for st in opt.adamw.state.values()
                 for k, v in st.items() if k != "step"))
    out["whole"] = sum(v.numel() for v in opt.full_params().values())
    cfg = tc.TrainConfig(**c["train"])
    model = make()
    step, params, opt = tc.make_train_step(model, tc.make_optimizer(cfg), cfg, mesh,
                                           c["init"], device="cpu")
    out["metrics"] = []
    for batch in c["batches"]:
        params, opt, m = step(params, opt, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["params"] = {k: v.clone() for k, v in opt.full_params().items()}

    tcfg = tc.TrainConfig(**d["train"])
    for kind in ("rerank", "rerank_dropout", "distill"):
        r = d[kind]
        student = tenc.CrossEncoder(tenc.EncoderConfig(**r["enc"]))
        if kind == "distill":
            step, _, params, opt = td.make_distill_step(
                student, tc.make_optimizer(tcfg), tcfg, mesh, r["init"],
                td.DistillConfig(**r["cfg"]), device="cpu")
            run = step
        else:
            step, _, params, opt = tr.make_rerank_step(
                student, tc.make_optimizer(tcfg), tcfg, mesh, r["init"],
                tr.RerankTrainConfig(**r["cfg"]), device="cpu")
            gen = torch.Generator().manual_seed(7)
            run = lambda p, o, b: step(p, o, b, gen)  # noqa: E731
        out[kind] = []
        for batch in r["batches"]:
            params, opt, m = run(params, opt, batch)
            out[kind].append({k: float(v) for k, v in m.items()})
        out[f"{kind}_params"] = {k: v.clone() for k, v in opt.full_params().items()}

    lp = d["loop"]

    def converted_init(config, out_dim, seed=0, device=None):
        model = tenc.BiEncoder(config, out_dim=out_dim)
        model.load_state_dict(c["init"])
        return model.to(device), model.state_dict()

    tloop.init_bi_encoder = converted_init
    _, params, hist = tloop.train_biencoder(
        lp["texts"], encoder_config=tenc.EncoderConfig(**c["enc"]), out_dim=c["out"],
        train_config=tcfg, mesh=mesh, loop_config=tloop.TrainLoopConfig(**lp["loop"]),
        device="cpu")
    out["loop"] = [{k: v for k, v in h.items() if k != "elapsed_s"} for h in hist]
    out["loop_params"] = {k: v.clone() for k, v in params.items()}
    return out


def main(argv):
    name, rank, world, port, inp, out = argv
    rank, world = int(rank), int(world)
    os.nice(5)              # behind the timing-sensitive tests beside them
    torch.set_num_threads(1)
    init_world("gloo", f"tcp://127.0.0.1:{port}", rank, world, TIMEOUT_S)
    try:
        result = SUITES[name](torch.load(inp, weights_only=False))
    finally:
        dist.destroy_process_group()
    torch.save(result, f"{out}.{rank}")


if __name__ == "__main__":
    main(sys.argv[1:])

"""The port's pod mesh, hierarchical merge, pod search, process-group setup
and latency projection (advanced_rag_tpu_torch/parallel/{multihost,
projection}.py) against the JAX package.

The JAX references run in this process on a (dcn 2, shard 2, data 1) mesh
of ``jax.devices()[:4]``; the port runs on four Gloo ranks on the CPU
(tests/torch_dist_worker.py, one spawn for the module).  ``distributed_init``
is held to JAX's under the same environment with both packages' group
set-up calls stubbed.  Tolerances: ids exact (sets where scores tie), f32
scores within 1e-5 relative; the projection's arithmetic exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist
from jax import shard_map
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

import torch_dist_worker as worker
from advanced_rag_tpu.parallel import multihost as jmh
from advanced_rag_tpu.parallel import projection as jproj
from advanced_rag_tpu_torch.parallel import mesh as tmesh
from advanced_rag_tpu_torch.parallel import multihost as tmh
from advanced_rag_tpu_torch.parallel import projection as tproj

ROWS = ("dcn", "shard")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(0)
    mesh = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2, 1), jmh.POD_AXES)
    put = lambda a, spec: jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))  # noqa: E731
    emb = rng.standard_normal((1024, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    d = {"pod": dict(emb=emb, q=emb[rng.integers(0, 1024, 4)], valid=None, k=10)}
    valid = np.zeros(512, bool)
    valid[:32] = True                 # only the first rank's rows live
    d["masked"] = dict(emb=rng.standard_normal((512, 16)).astype(np.float32),
                       q=rng.standard_normal((2, 16)).astype(np.float32), valid=valid, k=8)
    d["m_scores"] = rng.standard_normal((4, 3, 6)).astype(np.float32)
    d["m_ids"] = rng.permutation(10_000)[:72].reshape(4, 3, 6).astype(np.int32)
    d["mk"] = 6
    want = {}
    for name in ("pod", "masked"):
        c = d[name]
        v = None if c["valid"] is None else put(c["valid"], P(ROWS))
        want[name] = jmh.pod_dense_topk(put(c["emb"], P(ROWS, None)), put(c["q"], P("data", None)),
                                        c["k"], v, mesh=mesh, metric="ip")
    hier = shard_map(lambda s, i: jmh.hierarchical_merge_topk(s[0], i[0], 6), mesh=mesh,
                     in_specs=(P(ROWS), P(ROWS)), out_specs=(P(None, None), P(None, None)),
                     check_vma=False)
    want["hier"] = hier(jnp.asarray(d["m_scores"]), jnp.asarray(d["m_ids"]))
    want = {k: tuple(np.asarray(x) for x in v) for k, v in want.items()}
    got = worker.run_ranks("multihost", 4, d, tmp_path_factory.mktemp("multihost"))
    return d, want, got


def sorted_rows(scores, ids):
    order = np.lexsort((ids, -scores), axis=-1)
    return np.take_along_axis(scores, order, -1), np.take_along_axis(ids, order, -1)


def test_pod_mesh_groups_ranks_by_host(case):
    _, _, got = case
    assert all(g["shape"] == {"dcn": 2, "shard": 2, "data": 1} for g in got)
    assert [g["coords"] for g in got] == [{"dcn": r // 2, "shard": r % 2, "data": 0}
                                          for r in range(4)]
    assert all("does not cover 4 ranks" in g["bad_shape"] for g in got)


@pytest.mark.parametrize("name", ["pod", "masked", "hier"])
def test_pod_search_and_merge_match_jax(case, name):
    d, want, got = case
    for g in got:
        gs, gi = sorted_rows(*(np.asarray(x) for x in g[name]))
        ws, wi = sorted_rows(*want[name])
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(gi, wi)
    if name == "masked":
        ids = np.asarray(got[0][name][1])
        assert set(ids[ids >= 0].tolist()) <= set(range(32))
    if name == "pod":                  # each query finds itself first
        q_rows = [int(np.argmax(d["pod"]["emb"] @ q)) for q in d["pod"]["q"]]
        assert np.asarray(got[0][name][1])[:, 0].tolist() == q_rows


def test_pod_mesh_on_one_rank():
    mesh = tmh.build_pod_mesh()
    assert mesh.shape == {"dcn": 1, "shard": 1, "data": 1}
    assert mesh.axis_names == jmh.POD_AXES
    with pytest.raises(ValueError, match="does not cover"):
        tmh.build_pod_mesh(dcn=2)


@pytest.fixture
def stubbed(monkeypatch):
    """Both packages' group set-up stubbed; their calls recorded."""
    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: calls["jax"].append(kw))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls["torch"].append((a, kw)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(tmesh, "_group_timeout", None)
    for name in ("JAX_COORDINATOR", "NPROC", "PROC_ID"):
        monkeypatch.delenv(name, raising=False)
    return calls


def test_distributed_init_is_a_noop_without_env(stubbed):
    jmh.distributed_init()
    tmh.distributed_init(device="cpu")
    assert stubbed == {"jax": [], "torch": []}


def test_distributed_init_reads_the_jax_env(stubbed, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("NPROC", "2")
    monkeypatch.setenv("PROC_ID", "1")
    jmh.distributed_init()
    tmh.distributed_init(device="cpu", timeout_s=60)
    assert stubbed["jax"] == [{"coordinator_address": "10.0.0.1:8476",
                               "num_processes": 2, "process_id": 1}]
    (args, kw), = stubbed["torch"]
    assert args == ("gloo",)
    assert kw["init_method"] == "tcp://10.0.0.1:8476"
    assert (kw["world_size"], kw["rank"]) == (2, 1)
    assert kw["timeout"].total_seconds() == 60
    assert tmesh._group_timeout == kw["timeout"]      # the axis groups' timeout too


def test_distributed_init_is_idempotent(stubbed, monkeypatch):
    """A group of NPROC ranks already up is kept; one of another size raises
    (JAX raises when fewer processes than NPROC are up)."""
    monkeypatch.setenv("JAX_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("NPROC", "2")
    monkeypatch.setenv("PROC_ID", "0")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    tmh.distributed_init(device="cpu")
    assert stubbed["torch"] == []
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    with pytest.raises(RuntimeError, match="NPROC=2"):
        tmh.distributed_init(device="cpu")

    def already(**kw):
        raise RuntimeError("distributed.initialize should only be called once")

    monkeypatch.setattr(jax.distributed, "initialize", already)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    jmh.distributed_init()
    monkeypatch.setattr(jax, "process_count", lambda: 1)
    with pytest.raises(RuntimeError):
        jmh.distributed_init()


ANCHORS = dict(embed_ms=1.3, dense_sq8_ms_per_mrow=0.8, sparse_postings_ms_per_mrow=0.35,
               fuse_fixed_ms=2.1, rerank_ms=4.4, eval_host_ms=0.0, jitter_p99_ms=1.7)


@pytest.mark.parametrize("rows,n_shards,k", [(10_000_000, 8, 20), (4_000_000, 4, 10),
                                             (1_000_000, 1, 20), (2_000_000, 64, 100)])
def test_projection_is_jax_arithmetic(rows, n_shards, k):
    """On the same explicit anchors, with the JAX model's hop latency (0.1
    ms) and link rate (45 GB/s) given as parameters."""
    want = jproj.project_sharded_retrieve(rows, n_shards, jproj.MeasuredAnchors(**ANCHORS),
                                          k=k)
    got = tproj.project_sharded_retrieve(rows, n_shards,
                                         anchors=tproj.MeasuredAnchors(**ANCHORS, source="t"),
                                         hop_ms=0.1, link_bytes_per_s=45e9, k=k)
    want["t_merge_ms"] = want.pop("t_ici_merge_ms")
    assert got == want


def test_anchors_are_explicit_and_read_from_the_smoke_line():
    with pytest.raises(TypeError):
        tproj.MeasuredAnchors()
    line = json.dumps({"kernels": [], "sharded": {"anchors": {**ANCHORS,
                                                              "source": "NVIDIA H100, 700 W"}}})
    a = tproj.MeasuredAnchors.from_smoke(line)
    assert a == tproj.MeasuredAnchors(**ANCHORS, source="NVIDIA H100, 700 W")
    assert tproj.MeasuredAnchors.from_smoke(json.loads(line)) == a

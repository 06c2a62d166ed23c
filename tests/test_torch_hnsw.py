"""The port's HNSW baseline (advanced_rag_tpu_torch/baselines/hnsw.py)
against tests/test_hnsw_baseline.py's bounds and the JAX package's
baseline.

One test for each of tests/test_hnsw_baseline.py's six and for
tests/test_index_edges.py's TestHNSWBaselineSurface, at their geometry
and bounds; a graph saved by either package answers identically when the
other loads it (ids and scores exact), and the same seed gives the same
level structure in both.  CPU only: the baseline has no device path.
"""

import numpy as np
import pytest

from advanced_rag_tpu.baselines import HNSWBaseline as JaxHNSW
from advanced_rag_tpu.baselines import hnsw as j_hnsw
from advanced_rag_tpu_torch.baselines import HNSWBaseline, available
from advanced_rag_tpu_torch.baselines import hnsw as t_hnsw


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(0)
    n, d = 5000, 48
    v = rng.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v, HNSWBaseline(v, M=16, ef_construction=200, seed=1)


def recall(ids, oracle):
    return np.mean([len(set(ids[r]) & set(oracle[r])) / oracle.shape[1]
                    for r in range(len(ids))])


def test_self_query_exact(built):
    v, h = built
    _, ids = h.search(v[:32], 1, ef=64, normalize=False)
    assert (ids[:, 0] == np.arange(32)).mean() >= 0.95


def test_recall_vs_exact_oracle(built):
    v, h = built
    rng = np.random.default_rng(2)
    q = v[rng.integers(0, len(v), 64)] + 0.03 * rng.standard_normal(
        (64, v.shape[1])).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    oracle = np.argsort(-(q @ v.T), axis=1)[:, :10]
    _, ids = h.search(q, 10, ef=64, normalize=False)
    assert recall(ids, oracle) >= 0.85


def test_higher_ef_never_worse(built):
    v, h = built
    rng = np.random.default_rng(3)
    q = rng.standard_normal((32, v.shape[1])).astype(np.float32)
    oracle = np.argsort(-((q / np.linalg.norm(q, axis=1, keepdims=True)) @ v.T),
                        axis=1)[:, :10]
    recs = [recall(h.search(q, 10, ef=ef)[1], oracle) for ef in (16, 64, 256)]
    assert recs[2] >= recs[0] - 0.02
    assert recs[2] >= 0.9


def test_scores_sorted_and_ids_unique(built):
    v, h = built
    s, ids = h.search(v[:8], 20, ef=64, normalize=False)
    assert (np.diff(s, axis=1) <= 1e-6).all()
    for r in range(8):
        real = ids[r][ids[r] >= 0]
        assert len(set(real.tolist())) == len(real)


def test_memory_accounting(built):
    v, h = built
    n, d = v.shape
    assert h.memory_bytes() >= n * d * 4
    assert h.graph_bytes() <= n * (2 * 16 * 4 * 2 + 8)
    assert h.memory_bytes() == n * d * 4 + h.graph_bytes()


def test_k_larger_than_ef_and_corpus():
    rng = np.random.default_rng(5)
    v = rng.standard_normal((50, 16)).astype(np.float32)
    h = HNSWBaseline(v, M=8, ef_construction=50)
    s, ids = h.search(v[:2], 60, ef=4)
    assert ids.shape == (2, 60)
    real = ids[0][ids[0] >= 0]
    assert len(set(real.tolist())) == len(real)


def test_single_query_and_max_level():
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((200, 16)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    idx = HNSWBaseline(vecs, M=8, ef_construction=40)
    _, ids = idx.search(vecs[5], 3, ef=32)          # 1-D query reshapes
    assert 5 in np.asarray(ids).ravel().tolist()
    assert idx.max_level >= 0
    with pytest.raises(ValueError, match="wide"):
        idx.search(vecs[:2, :8], 3)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_saved_graph_answers_identically(tmp_path, direction):
    rng = np.random.default_rng(7)
    v = rng.standard_normal((1500, 32)).astype(np.float32)
    q = rng.standard_normal((40, 32)).astype(np.float32)
    path = tmp_path / "graph.bin"
    maker, loader = (JaxHNSW, HNSWBaseline) if direction == "jax-to-port" else (
        HNSWBaseline, JaxHNSW)
    saved = maker(v, M=12, ef_construction=80, seed=3, cache_path=path)
    assert path.stat().st_size > v.nbytes
    loaded = loader(v, M=12, ef_construction=80, seed=3, cache_path=path)
    for k, ef in ((1, 16), (10, 64), (25, 32)):
        s_want, i_want = saved.search(q, k, ef=ef)
        s_got, i_got = loaded.search(q, k, ef=ef)
        np.testing.assert_array_equal(i_got, i_want)
        np.testing.assert_array_equal(s_got, s_want)
    assert loaded.max_level == saved.max_level
    assert loaded.graph_bytes() == saved.graph_bytes()
    assert loaded.memory_bytes() == saved.memory_bytes()


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_same_seed_same_levels(seed):
    rng = np.random.default_rng(11)
    v = rng.standard_normal((3000, 16)).astype(np.float32)
    got = HNSWBaseline(v, M=4, ef_construction=32, seed=seed)
    want = JaxHNSW(v, M=4, ef_construction=32, seed=seed)
    assert got.max_level == want.max_level > 0


def test_bad_cache_file_raises(tmp_path):
    path = tmp_path / "not-a-graph.bin"
    path.write_bytes(b"\0" * 128)
    with pytest.raises(RuntimeError, match="not an HNSW graph"):
        HNSWBaseline(np.eye(4, dtype=np.float32), M=4, cache_path=path)


@pytest.mark.parametrize("shape", [(64, 12), (48, 16)], ids=["wider", "fewer-rows"])
def test_cache_file_of_another_shape_raises(tmp_path, shape):
    rng = np.random.default_rng(5)
    path = tmp_path / "graph.bin"
    HNSWBaseline(rng.standard_normal((64, 16)).astype(np.float32), M=4,
                 ef_construction=16, cache_path=path)
    other = rng.standard_normal(shape).astype(np.float32)
    with pytest.raises(ValueError, match="holds 64 rows 16 wide"):
        HNSWBaseline(other, M=4, ef_construction=16, cache_path=path)


def test_build_is_keyed_by_host_and_raises_on_failure(monkeypatch, tmp_path):
    from advanced_rag_tpu_torch import native

    assert available() and j_hnsw.available()
    assert "-march=native" in t_hnsw.FLAGS and "-fopenmp" in t_hnsw.FLAGS
    src = native.SRC_DIR / "hnsw_native.cpp"
    here = native.library_path(src, t_hnsw.FLAGS, key=native.host_key())
    assert here != native.library_path(src, t_hnsw.FLAGS, key="another host")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="native build failed"):
        HNSWBaseline(np.eye(4, dtype=np.float32), M=4)

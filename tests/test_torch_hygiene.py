"""Hygiene of the PyTorch port: what it imports, where it runs, how its
kernels are built.

- The port, chip_smoke.py and scripts/torch_quality_service.py (which run
  where there is no JAX) import no JAX, Flax, orbax or JAX package
  (checked in a fresh interpreter, over every module of the port).
- Entry points (the models, the manager, the pipeline, the retriever, the
  service and the trainers) run on the CUDA card unless given
  ``device="cpu"``; with no card they raise instead of moving to the CPU.
- The kernels build with one nvcc call for sm_90a from sources that
  include no PyTorch header.
- The host C++ (native/, baselines/) and the timing and profiling helpers
  are modules of the port, their libraries build into build/native/, and
  chip_smoke.py's phase 12 drives them.
"""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import advanced_rag_tpu_torch
from advanced_rag_tpu_torch import _build, native, resolve_device
from advanced_rag_tpu_torch.config import PipelineConfig
from advanced_rag_tpu_torch.index.manager import MultiIndexManager
from advanced_rag_tpu_torch.models.cross_encoder import CrossEncoderReranker
from advanced_rag_tpu_torch.models.embedder import HashingEmbedder, NeuralEmbedder
from advanced_rag_tpu_torch.models.encoder import BiEncoder, EncoderConfig
from advanced_rag_tpu_torch.pipeline import AdvancedRAGPipeline, HybridRetriever
from advanced_rag_tpu_torch.service import create_app
from advanced_rag_tpu_torch.train import (DistillConfig, RerankTrainConfig, TrainConfig,
                                          TrainLoopConfig, distill_cross_encoder,
                                          make_optimizer, make_train_step, train_biencoder,
                                          train_reranker)

REPO = Path(__file__).resolve().parent.parent
SMALL = EncoderConfig(vocab_size=256, hidden_dim=16, num_layers=1, num_heads=2,
                      mlp_dim=32, max_len=32)


def port_modules():
    pkg = advanced_rag_tpu_torch
    return [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
        pkg.__path__, pkg.__name__ + ".")]


#: scripts that run beside the port on hosts without JAX, and the Gloo ranks
#: of the sharded tests
CARD_SCRIPTS = [REPO / "scripts" / "torch_quality_service.py",
                REPO / "scripts" / "torch_nccl_one_card.py",
                REPO / "scripts" / "torch_service_ab.py",
                REPO / "tests" / "torch_dist_worker.py"]


#: top-level packages the port, chip_smoke.py and the card's scripts never
#: import: the JAX stack, and the HF libraries, ``sentencepiece`` and
#: ``regex`` the card's machine lacks
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "advanced_rag_tpu", "transformers",
             "tokenizers", "safetensors", "huggingface_hub", "sentencepiece", "regex")


def test_port_and_chip_smoke_import_no_jax():
    mods = port_modules()
    assert len(mods) >= 20
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"for path in {[str(p) for p in CARD_SCRIPTS]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('card_script', path)\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_port_source_names_jax_at_module_level():
    """No file of the port, nor chip_smoke.py or a script that runs on the
    card, imports jax, jaxlib, flax, orbax, the JAX package or the HF
    libraries the card's machine lacks, at any indentation (inside a
    function too)."""
    pat = re.compile(r"^\s*(import|from)\s+(" + "|".join(FORBIDDEN) + r")\b")
    files = sorted((REPO / "advanced_rag_tpu_torch").rglob("*.py"))
    assert len(files) >= 20
    for path in files + [REPO / "chip_smoke.py"] + CARD_SCRIPTS:
        for line in path.read_text().splitlines():
            assert not pat.match(line), f"{path}: {line}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        NeuralEmbedder(dim=8, config=SMALL)
    with pytest.raises(RuntimeError):
        CrossEncoderReranker(config=SMALL)
    with pytest.raises(RuntimeError):
        HashingEmbedder(dim=8, vocab_size=64)
    with pytest.raises(RuntimeError):
        MultiIndexManager(PipelineConfig(fused_rerank=True))
    with pytest.raises(RuntimeError):
        MultiIndexManager(PipelineConfig())
    with pytest.raises(RuntimeError):
        AdvancedRAGPipeline()
    with pytest.raises(RuntimeError):
        AdvancedRAGPipeline(PipelineConfig(fused_rerank=True))
    cpu_mgr = MultiIndexManager(PipelineConfig(), device="cpu")
    with pytest.raises(RuntimeError):
        HybridRetriever(cpu_mgr, device="cuda")
    with pytest.raises(RuntimeError):
        create_app()
    texts = ["a b c d e f", "g h i j k l"]
    with pytest.raises(RuntimeError):
        make_train_step(BiEncoder(SMALL, out_dim=8), make_optimizer(TrainConfig()),
                        TrainConfig())
    with pytest.raises(RuntimeError):
        train_biencoder(texts, encoder_config=SMALL, out_dim=8)
    with pytest.raises(RuntimeError):
        train_reranker([("a", "b"), ("c", "d")], [[], []], encoder_config=SMALL,
                       rerank_config=RerankTrainConfig(q_len=8, d_len=16))
    with pytest.raises(RuntimeError):
        distill_cross_encoder(texts, BiEncoder(SMALL, out_dim=8), None,
                              encoder_config=SMALL)


def test_trainers_run_on_cpu_when_asked(no_card):
    texts = [f"text {i} about topic {i % 3} and more words" for i in range(8)]
    bi, params, hist = train_biencoder(
        texts, encoder_config=SMALL, out_dim=8, device="cpu",
        loop_config=TrainLoopConfig(steps=2, batch_size=4, eval_pairs=4, log_every=1))
    assert len(hist) == 2 and next(bi.parameters()).device.type == "cpu"
    pairs = [(f"q {i}", t) for i, t in enumerate(texts)]
    ce, _, hist = train_reranker(
        pairs, [[t] for t in texts[::-1]], encoder_config=SMALL, device="cpu",
        warm_start_params=params,
        rerank_config=RerankTrainConfig(steps=1, queries_per_batch=2,
                                        candidates_per_query=2, q_len=8, d_len=16))
    assert len(hist) == 1 and next(ce.parameters()).device.type == "cpu"
    _, _, hist = distill_cross_encoder(
        texts, bi, params, encoder_config=SMALL, device="cpu",
        distill_config=DistillConfig(steps=1, queries_per_batch=2, candidates_per_query=2))
    assert len(hist) == 1


def test_entry_points_run_on_cpu_when_asked(no_card, tmp_path, monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    emb = NeuralEmbedder(dim=8, config=SMALL, device="cpu")
    assert emb.encode(["a b c"]).shape == (1, 8)
    assert CrossEncoderReranker(config=SMALL, device="cpu").score(
        "a b", ["a b c", "d"]).shape == (2,)
    out = HashingEmbedder(dim=8, vocab_size=64, device="cpu").encode(["a b", "c"])
    assert out.shape == (2, 8)
    cfg = PipelineConfig(fused_rerank=True)
    cfg.semantic_dim = 8
    mgr = MultiIndexManager(cfg, embedder=emb, device="cpu")
    assert mgr.device == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
    # the default (unfused) manager and pipeline: the hashing embedder
    pipe = AdvancedRAGPipeline(device="cpu")
    assert pipe.device == pipe.index_manager.device == torch.device("cpu")
    assert isinstance(pipe.index_manager.embedder, HashingEmbedder)
    assert pipe.index_manager.embedder.device == torch.device("cpu")
    ret = HybridRetriever(pipe.index_manager)
    assert ret.device == torch.device("cpu")
    with pytest.raises(ValueError, match="reranker is on cuda"):
        HybridRetriever(pipe.index_manager,
                        reranker=SimpleNamespace(device=torch.device("cuda")))
    cfg = PipelineConfig(fused_rerank=True)
    cfg.semantic_dim = 8
    fused = AdvancedRAGPipeline(cfg, index_manager=mgr)
    assert fused.device == torch.device("cpu")
    monkeypatch.setenv("CHAT_DB_PATH", str(tmp_path / "chat.db"))
    for name in ("RAG_EMBEDDER", "RAG_RERANKER", "RAG_CHECKPOINT_DIR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RAG_FUSED_E2E", "1")
    app = create_app(device="cpu")
    state = app["state"]
    assert state.device == state.pipeline.device == torch.device("cpu")
    assert state.pipeline.retriever.reranker.device == torch.device("cpu")
    state.pipeline.close()
    state.db.close()
    pipe.close()


def test_build_is_one_nvcc_call_for_sm_90a(tmp_path):
    """One nvcc compile for sm_90a per source (run together) and one link
    of their objects into the one library."""
    compiles, link = _build.nvcc_commands("nvcc", tmp_path / "lib.so", tmp_path / "obj")
    srcs = _build.sources()
    assert srcs and len(compiles) == len(srcs)
    for cmd, src in zip(compiles, srcs):
        assert cmd[0] == "nvcc" and cmd[-1] == str(src)
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-c" in cmd and "-std=c++17" in cmd and "-fPIC" in cmd
        assert "-shared" not in cmd
    assert link[0] == "nvcc" and "-shared" in link and "arch=compute_90a,code=sm_90a" in link
    assert link[link.index("-o") + 1] == str(tmp_path / "lib.so")
    assert link[-len(srcs):] == [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert _build.library_path().parent == REPO / "build" / "kernels"
    assert _build.library_path().name.startswith("libart_kernels_")


def test_kernel_sources_include_no_pytorch_header():
    files = sorted(_build.CSRC.glob("*.cu")) + sorted(_build.CSRC.glob("*.cuh"))
    assert files
    for path in files:
        for inc in re.findall(r'#include\s*[<"]([^>"]+)[>"]', path.read_text()):
            assert not inc.startswith(("torch/", "ATen/", "c10/")), (path, inc)
            assert "extension.h" not in inc


def test_find_nvcc_raises_without_a_toolkit(monkeypatch):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_host_native_code_and_timers_are_modules_of_the_port():
    mods = set(port_modules())
    for name in ("native", "baselines", "baselines.hnsw", "utils.timing", "utils.profiling"):
        assert f"advanced_rag_tpu_torch.{name}" in mods, name
    assert native.BUILD_DIR == REPO / "build" / "native"
    for src in ("text_native.cpp", "hnsw_native.cpp"):
        assert (native.SRC_DIR / src).is_file()
        assert native.SRC_DIR == REPO / "advanced_rag_tpu_torch" / "native"
    assert native.TEXT_FLAGS == ["-O3", "-shared", "-fPIC", "-std=c++17"]
    smoke = (REPO / "chip_smoke.py").read_text()
    main = smoke[smoke.index("def main()"):]
    assert "def phase_host_native(" in smoke and "phase_host_native(" in main
    for name in ("encode_documents", "encode_queries", "DocumentDiagnostics", "HNSWBaseline",
                 "scanned_ms", "chained_ms", "fetch_ms", "device_trace"):
        assert name in smoke, name


def test_hf_modules_are_the_ports_and_the_export_script_is_not():
    """The HF families' modules are modules of the port (so the checks
    above cover them); scripts/torch_export_hf.py, which runs where
    transformers and Flax are installed, imports transformers and is no
    card script."""
    mods = set(port_modules())
    for name in ("hf_checkpoint", "hf_tokenizer", "hf_bpe", "hf_unigram", "hf_bert",
                 "hf_roberta", "hf_electra", "hf_distilbert", "hf_llama", "hf_spbpe",
                 "hf_roberta_prelayernorm", "hf_albert", "hf_big_bird", "hf_roformer",
                 "hf_bart", "hf_blenderbot_small", "hf_embedder", "hf_cross_encoder"):
        assert f"advanced_rag_tpu_torch.models.{name}" in mods, name
    export = REPO / "scripts" / "torch_export_hf.py"
    assert export not in CARD_SCRIPTS
    assert re.search(r"^\s*from transformers import", export.read_text(), re.M)

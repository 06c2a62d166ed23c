"""Hygiene of the PyTorch port: what it imports, where it runs, how its
kernels are built.

- The port and chip_smoke.py import no JAX, Flax, orbax or JAX package
  (checked in a fresh interpreter, over every module of the port).
- Entry points run on the CUDA card unless given ``device="cpu"``; with no
  card they raise instead of moving to the CPU.
- The kernels build with one nvcc call for sm_90a from sources that
  include no PyTorch header.
"""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import advanced_rag_tpu_torch
from advanced_rag_tpu_torch import _build, resolve_device
from advanced_rag_tpu_torch.config import PipelineConfig
from advanced_rag_tpu_torch.index.manager import MultiIndexManager
from advanced_rag_tpu_torch.models.cross_encoder import CrossEncoderReranker
from advanced_rag_tpu_torch.models.embedder import HashingEmbedder, NeuralEmbedder
from advanced_rag_tpu_torch.models.encoder import EncoderConfig

REPO = Path(__file__).resolve().parent.parent
SMALL = EncoderConfig(vocab_size=256, hidden_dim=16, num_layers=1, num_heads=2,
                      mlp_dim=32, max_len=32)


def port_modules():
    pkg = advanced_rag_tpu_torch
    return [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
        pkg.__path__, pkg.__name__ + ".")]


def test_port_and_chip_smoke_import_no_jax():
    mods = port_modules()
    assert len(mods) >= 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'advanced_rag_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_port_source_names_jax_at_module_level():
    """Only models/convert.py may import orbax, and only inside a function."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|orbax|advanced_rag_tpu)\b")
    for path in (REPO / "advanced_rag_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            m = pat.match(line)
            if not m:
                continue
            assert path.name == "convert.py" and line.startswith("    ") and \
                m.group(2) == "orbax", f"{path}: {line}"


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


def test_entry_points_run_on_cpu_when_asked(no_card):
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


def test_build_is_one_nvcc_call_for_sm_90a(tmp_path):
    cmd = _build.nvcc_command("nvcc", tmp_path / "lib.so")
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-std=c++17" in cmd
    srcs = _build.sources()
    assert srcs and all(str(s) in cmd for s in srcs)
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

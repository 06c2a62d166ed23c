"""Index persistence: the port of ``advanced_rag_tpu/utils/checkpoint.py``.

The index is device tensors with host mirrors, so durability is writing
the mirrors and the record tables to disk and uploading them again.  The
on-disk format is the JAX package's, byte for byte, so a checkpoint saved
by either package loads in the other.  A directory with:

- ``manifest.json``: ``format_version``, ``saved_at``, ``size``, and per
  dense family its ``dim``, ``size``, ``dtype`` (``str(config.dtype)``:
  "bfloat16", "float32", "int8" or "pq"), ``metric`` and, with trained PQ
  codebooks, ``pq`` = {m, bits, opq}, with IVF-PQ partitions ``ivfpq`` =
  {nlist, m, bits}; ``sparse`` = {vocab_size, doc_nnz, size, n_docs} or
  null;
- ``columns.npz``: the store's metadata columns and ``valid``;
- ``dense_<family>.npy``: the family's f32 mirror rows (normalized);
- ``dense_<family>_pq.npy``: its PQ codebooks [m, c, dsub] f32, and
  ``dense_<family>_opq.npy`` its OPQ rotation [D, D] f32;
- ``dense_<family>_ivfpq_cent.npy`` / ``_ivfpq_cb.npy``: the IVF-PQ
  centroids [nlist, D] and residual codebooks [m, c, dsub], f32;
- ``sparse.npz``: ``doc_idx`` i32, ``doc_tf`` f32, ``doc_len`` f32 and
  ``df`` int64;
- ``records.jsonl``: chunk_id, doc_id, content and metadata per row.

IVF partitions and postings are not saved, as in the JAX package: the
maintenance tick (or ``build_semantic``) and the first large hybrid search
rebuild them.  Restore re-quantizes an SQ8 tier from the mirror, re-encodes
a PQ tier with the saved codebooks (and rotation), re-packs IVF-PQ
partitions from the mirror with the saved quantizers (after writing the
manifest's ``m`` and ``bits`` into the restoring config, which the search
reads), uploads a flat tier in one put and re-tokenizes the token table.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import TYPE_CHECKING, Any, Dict

import numpy as np
import torch

if TYPE_CHECKING:  # pragma: no cover
    from ..index.manager import MultiIndexManager

FORMAT_VERSION = 1

#: the ``dtype`` strings a manifest may hold (``str(IndexConfig.dtype)``)
DENSE_DTYPES = ("bfloat16", "float32", "int8", "pq")


def save_index(manager: "MultiIndexManager", path: str | Path) -> Dict[str, Any]:
    """Write the manager's full index state to ``path``; returns the
    manifest.  The caller keeps ingests out (the service waits until no
    rows are in flight)."""
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    store = manager.store

    np.savez_compressed(
        root / "columns.npz",
        valid=store._host_valid[: store.size],
        **{name: col[: store.size] for name, col in store._host_cols.items()},
    )

    manifest: Dict[str, Any] = {
        "format_version": FORMAT_VERSION,
        "saved_at": time.time(),
        "size": store.size,
        "dense": {},
        "sparse": None,
    }

    families = {"semantic": manager.semantic}
    if manager.domain is not None:
        families["domain"] = manager.domain
    for name, idx in families.items():
        np.save(root / f"dense_{name}.npy", idx._host[: idx.size])
        manifest["dense"][name] = {
            "dim": idx.dim,
            "size": idx.size,
            "dtype": str(idx.config.dtype),
            "metric": idx.config.metric.value,
        }
        if idx._pq is not None:
            # the trained codebooks, so the restore re-encodes with the same
            # quantizer (codes stay comparable across restarts)
            np.save(root / f"dense_{name}_pq.npy",
                    idx._pq.codebooks.float().cpu().numpy())
            manifest["dense"][name]["pq"] = {
                "m": idx._pq.m, "bits": idx._pq.bits, "opq": idx._pq_rot is not None,
            }
            if idx._pq_rot is not None:
                np.save(root / f"dense_{name}_opq.npy", idx._pq_rot.float().cpu().numpy())
        if idx._ivfpq is not None:
            # both quantizers; the restore re-packs the partitions with them
            np.save(root / f"dense_{name}_ivfpq_cent.npy",
                    idx._ivfpq.centroids.float().cpu().numpy())
            np.save(root / f"dense_{name}_ivfpq_cb.npy",
                    idx._ivfpq.codebooks.float().cpu().numpy())
            manifest["dense"][name]["ivfpq"] = {
                "nlist": int(idx._ivfpq.centroids.shape[0]),
                "m": int(idx._ivfpq.codebooks.shape[0]),
                "bits": idx.config.pq_bits,
            }

    if manager.sparse is not None:
        sp = manager.sparse
        np.savez_compressed(
            root / "sparse.npz",
            doc_idx=sp._host_idx[: sp.size],
            doc_tf=sp._host_tf[: sp.size],
            doc_len=sp._host_len[: sp.size],
            df=sp._df,
        )
        manifest["sparse"] = {
            "vocab_size": sp.vocab_size,
            "doc_nnz": sp.doc_nnz,
            "size": sp.size,
            "n_docs": sp.n_docs,
        }

    with open(root / "records.jsonl", "w", encoding="utf-8") as f:
        for row in range(store.size):
            f.write(json.dumps({
                "chunk_id": store.chunk_ids[row],
                "doc_id": store.doc_ids[row],
                "content": store.contents[row],
                "metadata": store.metadata[row],
            }) + "\n")

    with open(root / "manifest.json", "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def _check_manifest(manifest: Dict[str, Any]) -> None:
    """Refuse what the port cannot restore, before the store is touched."""
    if manifest.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format "
                         f"{manifest.get('format_version')}")
    for name, meta in manifest["dense"].items():
        if meta.get("dtype") not in DENSE_DTYPES:
            raise ValueError(f"dense family {name!r}: unknown dtype "
                             f"{meta.get('dtype')!r}")


def load_index(manager: "MultiIndexManager", path: str | Path) -> Dict[str, Any]:
    """Restore state saved by ``save_index`` (by either package) into a
    fresh manager; returns the manifest.

    The embedding files are read with ``np.load(mmap_mode="r")`` into the
    mirrors and reach the device in one put per family.  On a failure
    midway the manager is torn: roll it back with ``reset_state``."""
    from ..ops.pq import PQCodebook

    root = Path(path)
    with open(root / "manifest.json", encoding="utf-8") as f:
        manifest = json.load(f)
    _check_manifest(manifest)
    store = manager.store
    if store.size != 0:
        raise ValueError("load_index requires a fresh manager")
    dev = manager.device

    n = manifest["size"]
    cols = np.load(root / "columns.npz")

    # records first (host tables)
    with open(root / "records.jsonl", encoding="utf-8") as f:
        for row, line in enumerate(f):
            rec = json.loads(line)
            store.chunk_ids.append(rec["chunk_id"])
            store.doc_ids.append(rec["doc_id"])
            store.contents.append(rec["content"])
            store.metadata.append(rec["metadata"])
            store._chunk_row[rec["chunk_id"]] = row

    store._ensure_capacity(n)
    for name in store._host_cols:
        store._host_cols[name][:n] = cols[name]
    store._host_valid[:n] = cols["valid"]
    store.size = n
    store._upload()

    for name, meta in manifest["dense"].items():
        idx = manager.semantic if name == "semantic" else manager.domain
        if idx is None:
            continue
        emb = np.load(root / f"dense_{name}.npy", mmap_mode="r")
        size = int(meta["size"])
        idx._ensure_capacity(size)
        idx._host[:size] = emb
        idx.size = size
        pq_meta = meta.get("pq")
        if pq_meta and idx._pq_mode:
            cb = np.load(root / f"dense_{name}_pq.npy")
            idx._pq = PQCodebook(torch.from_numpy(np.asarray(cb, np.float32)).to(dev),
                                 int(pq_meta["m"]), int(pq_meta["bits"]))
            if pq_meta.get("opq"):
                rot = np.load(root / f"dense_{name}_opq.npy")
                idx._pq_rot = torch.from_numpy(np.asarray(rot, np.float32)).to(dev)
        # flat: one put; SQ8: re-quantized from the mirror on the host; PQ:
        # one bf16 put and the encode (and rotation) on the device with the
        # saved codebooks
        idx._upload()
        ivfpq_meta = meta.get("ivfpq")
        if ivfpq_meta and idx._pq_mode:
            # the search reads m and bits from the restoring config: a
            # checkpoint of bits 8 under a bits-4 config would otherwise
            # score 16 of its 256 codes a subspace
            idx.config.pq_m = int(ivfpq_meta["m"])
            idx.config.pq_bits = int(ivfpq_meta["bits"])
            idx.build_ivfpq(nlist=int(ivfpq_meta["nlist"]),
                            centroids=np.load(root / f"dense_{name}_ivfpq_cent.npy"),
                            codebooks=np.load(root / f"dense_{name}_ivfpq_cb.npy"))

    if manifest["sparse"] and manager.sparse is not None:
        sp = manager.sparse
        data = np.load(root / "sparse.npz")
        size = int(manifest["sparse"]["size"])
        sp._ensure_capacity(size)
        sp._host_idx[:size] = data["doc_idx"]
        sp._host_tf[:size] = data["doc_tf"]
        sp._host_len[:size] = data["doc_len"]
        sp._df[:] = data["df"]
        sp.size = size
        sp.n_docs = int(manifest["sparse"]["n_docs"])
        sp._upload()           # doc_tf and the [P, N] mirror in bf16
        sp._upload_df()        # df clipped to int32

    if manager.token_table is not None:
        # tokens are deterministic given the contents: rebuilt, not saved
        manager.token_table.rebuild(manager.store.contents)
    return manifest


__all__ = ["save_index", "load_index", "FORMAT_VERSION"]

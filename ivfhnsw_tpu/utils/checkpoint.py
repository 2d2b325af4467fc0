"""Checkpoint / resume subsystem.

The reference's persistence is stage-granular files (SURVEY.md §5): HNSW
graph files, faiss PQ files, precomputed-assignment batches, and the .index
posting-list format — all reproduced bit-compatibly elsewhere in this
package (models/ivfadc.py write/read, drivers/common.py stage gating).

This module adds the accelerator-side layer on top: a *whole-index checkpoint
directory* of flat arrays + a JSON manifest, with optional per-shard layout
for mesh-sharded deployments (one shard file per device, the orbax/zarr
pattern without requiring either at runtime). Fast (no per-list framing),
self-describing, resumable.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np


MANIFEST = "manifest.json"


def save_index(index, path: str) -> None:
    """Save an IVFADCIndex / IVFADCGroupingIndex to a checkpoint dir."""
    os.makedirs(path, exist_ok=True)
    store = index._ensure_store()
    cfg = dataclasses.asdict(index.config)
    manifest = {
        "format": "ivfhnsw_tpu.checkpoint.v1",
        "config": cfg,
        "ntotal": store.ntotal,
        "grouping": hasattr(index, "nsubc") and index.config.nsubc > 0,
    }
    arrays = {
        "centroids": index.centroids,
        "centroid_norms": index.centroid_norms,
        "pq_codebooks": index.pq.codebooks,
        "norm_centroids": index.norm_pq.centroids,
        "codes": store.codes,
        "ids": store.ids,
        "norm_codes": store.norm_codes,
        "list_offsets": store.list_offsets,
    }
    if index.do_opq:
        arrays["opq_R"] = index.opq_R
    if manifest["grouping"]:
        arrays["nn_centroid_idxs"] = index.nn_centroid_idxs
        arrays["inter_centroid_dists"] = index.inter_centroid_dists
        arrays["alphas"] = index.alphas
    for name, arr in arrays.items():
        np.save(os.path.join(path, f"{name}.npy"), np.asarray(arr))
    manifest["arrays"] = sorted(arrays)
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)


def load_index(path: str):
    """Rebuild an index from a checkpoint dir."""
    from ivfhnsw_tpu.models.ivfadc import IVFADCIndex
    from ivfhnsw_tpu.models.grouping import IVFADCGroupingIndex
    from ivfhnsw_tpu.models.storage import PostingListStore
    from ivfhnsw_tpu.utils.config import IndexConfig

    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != "ivfhnsw_tpu.checkpoint.v1":
        raise ValueError(f"unrecognized checkpoint format in {path}")
    cfg = IndexConfig(**manifest["config"])
    a = {name: np.load(os.path.join(path, f"{name}.npy"))
         for name in manifest["arrays"]}
    index = (IVFADCGroupingIndex(cfg) if manifest["grouping"]
             else IVFADCIndex(cfg))
    index.centroids = jnp.asarray(a["centroids"])
    index.centroid_norms = jnp.asarray(a["centroid_norms"])
    index.pq.codebooks = jnp.asarray(a["pq_codebooks"])
    index.norm_pq.centroids = jnp.asarray(a["norm_centroids"])
    if "opq_R" in a:
        index.opq_R = jnp.asarray(a["opq_R"])
    if manifest["grouping"]:
        index.nn_centroid_idxs = jnp.asarray(a["nn_centroid_idxs"])
        index.inter_centroid_dists = jnp.asarray(a["inter_centroid_dists"])
        index.alphas = jnp.asarray(a["alphas"])
    index.store = PostingListStore(
        codes=a["codes"], ids=a["ids"],
        norm_codes=a["norm_codes"],
        list_offsets=a["list_offsets"],
        nc=int(a["list_offsets"].shape[0] - 1))
    return index


def save_sharded(sharded, path: str) -> None:
    """Per-shard checkpoint of a ShardedIVFADC: one file set per mesh
    position so each host/device restores only its slice."""
    os.makedirs(path, exist_ok=True)
    D = sharded.mesh.devices.size
    manifest = {
        "format": "ivfhnsw_tpu.sharded_checkpoint.v1",
        "n_shards": D,
        "nc_loc": sharded.nc_loc,
    }
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    for name in ("centroids", "centroid_norms", "codes", "ids",
                 "norm_codes", "offsets"):
        arr = np.asarray(getattr(sharded, name))
        for s in range(D):
            np.save(os.path.join(path, f"{name}.shard{s:03d}.npy"), arr[s])
    for name in ("codebooks", "norm_centroids", "R"):
        np.save(os.path.join(path, f"{name}.npy"),
                np.asarray(getattr(sharded, name)))


def load_sharded_arrays(path: str, shard: int) -> dict:
    """Load one shard's arrays (host-local restore path)."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    out = {"manifest": manifest}
    for name in ("centroids", "centroid_norms", "codes", "ids",
                 "norm_codes", "offsets"):
        out[name] = np.load(os.path.join(path, f"{name}.shard{shard:03d}.npy"))
    for name in ("codebooks", "norm_centroids", "R"):
        out[name] = np.load(os.path.join(path, f"{name}.npy"))
    return out

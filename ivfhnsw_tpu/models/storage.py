"""Flat posting-list storage.

The reference keeps one std::vector per centroid for ids / PQ codes / norm
codes (IndexIVF_HNSW.h:64-66). On a dense-tensor machine the equivalent is a
flat layout sorted by centroid:

    codes       [N, M]  uint8
    ids         [N]     int32   (SIFT1B ids < 2^31; reference idx_t is u32)
    norm_codes  [N]     uint8
    list_offsets[nc+1]  int32   prefix sums, list i = rows [off[i], off[i+1])

Construction accumulates append batches host-side and finalizes with a stable
argsort by centroid key, which preserves the reference's push_back insertion
order within each list (IndexIVF_HNSW.cpp:124-133). Incremental add
(the vector_add driver) re-finalizes from the accumulated batches.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


@dataclass
class PostingListStore:
    """Finalized posting lists.

    Canonical arrays are HOST numpy: serialization, sharding and
    incremental re-finalization all consume them host-side. Device
    consumers (both search engines) use the lazily-uploaded, cached ``*_d``
    mirrors of the same arrays."""

    codes: np.ndarray        # [N, M] uint8
    ids: np.ndarray          # [N] int32
    norm_codes: np.ndarray   # [N] uint8
    list_offsets: np.ndarray  # [nc+1] int32
    nc: int

    def __post_init__(self):
        self.codes = np.asarray(self.codes, np.uint8)
        self.ids = np.asarray(self.ids, np.int32)
        self.norm_codes = np.asarray(self.norm_codes, np.uint8)
        self.list_offsets = np.asarray(self.list_offsets, np.int32)
        self._dev: dict = {}

    def _mirror(self, name: str) -> jnp.ndarray:
        if name not in self._dev:
            self._dev[name] = jnp.asarray(getattr(self, name))
        return self._dev[name]

    def release_device(self) -> None:
        """Drop every device-resident mirror (device memory release when a
        process serves/builds several indexes). Canonical host arrays are
        untouched; the next device consumer re-uploads lazily."""
        self._dev = {}

    @property
    def codes_d(self) -> jnp.ndarray:
        return self._mirror("codes")

    @property
    def ids_d(self) -> jnp.ndarray:
        return self._mirror("ids")

    @property
    def norm_codes_d(self) -> jnp.ndarray:
        return self._mirror("norm_codes")

    @property
    def list_offsets_d(self) -> jnp.ndarray:
        return self._mirror("list_offsets")

    @property
    def ntotal(self) -> int:
        return int(self.codes.shape[0])

    @property
    def code_m(self) -> int:
        return int(self.codes.shape[1])

    def list_sizes(self) -> np.ndarray:
        off = np.asarray(self.list_offsets)
        return off[1:] - off[:-1]

    def max_list_size(self) -> int:
        s = self.list_sizes()
        return int(s.max()) if s.size else 0


class PostingListBuilder:
    """Accumulates (centroid key, id, code, norm code) batches; finalize()
    produces a sorted PostingListStore."""

    def __init__(self, nc: int, code_m: int):
        self.nc = nc
        self.code_m = code_m
        self._keys: list[np.ndarray] = []
        self._ids: list[np.ndarray] = []
        self._codes: list[np.ndarray] = []
        self._norm_codes: list[np.ndarray] = []

    def add(self, keys, ids, codes, norm_codes) -> None:
        keys = np.asarray(keys, np.int32)
        n = keys.shape[0]
        codes = np.asarray(codes, np.uint8).reshape(n, self.code_m)
        if keys.min(initial=0) < 0 or (n and keys.max() >= self.nc):
            raise ValueError("centroid key out of range")
        self._keys.append(keys)
        self._ids.append(np.asarray(ids, np.int32))
        self._codes.append(codes)
        self._norm_codes.append(np.asarray(norm_codes, np.uint8).reshape(n))

    @property
    def ntotal(self) -> int:
        return sum(k.shape[0] for k in self._keys)

    def finalize(self) -> PostingListStore:
        if self._keys:
            keys = np.concatenate(self._keys)
            ids = np.concatenate(self._ids)
            codes = np.concatenate(self._codes)
            ncodes = np.concatenate(self._norm_codes)
        else:
            keys = np.zeros((0,), np.int32)
            ids = np.zeros((0,), np.int32)
            codes = np.zeros((0, self.code_m), np.uint8)
            ncodes = np.zeros((0,), np.uint8)
        order = np.argsort(keys, kind="stable")
        sizes = np.bincount(keys, minlength=self.nc)
        offsets = np.zeros(self.nc + 1, np.int32)
        np.cumsum(sizes, out=offsets[1:])
        return PostingListStore(
            codes=codes[order],
            ids=ids[order],
            norm_codes=ncodes[order],
            list_offsets=offsets,
            nc=self.nc,
        )


def store_from_lists(nc: int, code_m: int, per_list) -> PostingListStore:
    """Build a store from per-centroid (ids, codes, norm_codes) sequences
    (deserialization path)."""
    b = PostingListBuilder(nc, code_m)
    for c, (ids, codes, ncodes) in enumerate(per_list):
        n = len(ids)
        if n:
            b.add(np.full(n, c, np.int32), ids, codes, ncodes)
    return b.finalize()

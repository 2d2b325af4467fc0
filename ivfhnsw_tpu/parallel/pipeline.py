"""Streamed, resumable, multi-host-shaped index build.

The reference builds 1B-vector indexes with a sequential host loop
(test_ivfhnsw_sift1b.cpp:125-162: read a 1M batch from the .bvecs file,
add_batch, repeat) whose assignment sweep alone takes 2-3 days
(README.md:65). This orchestrator is the accelerator replacement targeted at
the "assign + encode in hours" north star (BASELINE.md):

    host IO (any batch iterator)
      -> sharded assign+encode step (parallel.build — data-parallel over
         the mesh, centroids all-gathered fsdp-style)
      -> host spill of (keys, ids, codes, norm_codes) in COMMITTED batches
      -> crash-safe cursor (write-ahead spill, atomic cursor replace,
         truncate-to-cursor on resume)
      -> finalize() assembles the PostingListStore (bit-identical however
         many times the build was interrupted and resumed).

The spill is flat binary (no per-list framing), so a 1B-vector build writes
sequentially at disk speed; per-centroid assembly happens once at finalize
(the same sort the PostingListBuilder does). Checkpoint cadence is
per-batch: the commit is two fsyncs + one rename, negligible against a
multi-second device step at production batch sizes.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ivfhnsw_tpu.parallel.build import make_assign_encode_step
from ivfhnsw_tpu.parallel.mesh import SHARD_AXIS

CURSOR = "cursor.json"
SPILLS = ("keys.i32", "ids.i32", "codes.u8", "norm_codes.u8")


class StreamedIndexBuild:
    """Resumable assign+encode over a mesh, spilling to ``workdir``.

    Usage::

        b = StreamedIndexBuild(index, mesh, workdir)
        for off, x in batches:          # any host IO source
            if b.processed > off:       # already committed (resume)
                continue
            b.add_batch(x)
        index = b.finalize()
    """

    def __init__(self, index, mesh, workdir: str):
        self.index = index
        self.mesh = mesh
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.M = index.config.pq_m
        self.D = mesh.devices.size

        nc, d = index.nc, index.d
        self.nc_loc = -(-nc // self.D)
        cpad = np.full((self.nc_loc * self.D, d), 1e30, np.float32)
        cpad[:nc] = np.asarray(index.centroids)
        self._centroids = jax.device_put(
            jnp.asarray(cpad.reshape(self.D, self.nc_loc, d)),
            NamedSharding(mesh, P(SHARD_AXIS)))
        self._codebooks = jnp.asarray(index.pq.codebooks)
        self._norm_cents = jnp.asarray(index.norm_pq.centroids)
        self._R = (jnp.asarray(index.opq_R) if index.do_opq
                   else jnp.zeros((0, 0), jnp.float32))
        self._step = make_assign_encode_step(mesh, use_opq=index.do_opq)
        self._x_sharding = NamedSharding(mesh, P(SHARD_AXIS))

        # Resume: truncate spills to the last committed cursor.
        self.processed = 0
        cur = os.path.join(workdir, CURSOR)
        sizes = {name: 0 for name in SPILLS}
        if os.path.exists(cur):
            with open(cur) as f:
                state = json.load(f)
            self.processed = state["processed"]
            sizes = state["sizes"]
        self._files = {}
        for name in SPILLS:
            p = os.path.join(workdir, name)
            if not os.path.exists(p):
                open(p, "wb").close()
            want = sizes.get(name, 0)
            if os.path.getsize(p) != want:
                # partial write past the last commit — discard it
                with open(p, "r+b") as f:
                    f.truncate(want)
            self._files[name] = open(p, "ab")

    # ------------------------------------------------------------------

    def add_batch(self, x, xids=None) -> None:
        """Assign+encode one host batch on the mesh and commit it."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        if xids is None:
            xids = np.arange(self.processed, self.processed + n,
                             dtype=np.int32)
        xids = np.asarray(xids, np.int32)
        pad = (-n) % self.D
        if pad:
            x = np.concatenate([x, np.zeros((pad, x.shape[1]), np.float32)])
        keys, codes, ncodes = self._step(
            jax.device_put(jnp.asarray(x), self._x_sharding),
            self._centroids, self._codebooks, self._R, self._norm_cents)
        keys = np.asarray(keys)[:n]
        codes = np.asarray(codes)[:n]
        ncodes = np.asarray(ncodes)[:n]

        # Commit protocol: append spills, fsync, then atomically replace the
        # cursor. A crash mid-append leaves bytes past the cursor that the
        # next __init__ truncates away — the committed prefix is always a
        # bit-exact record of the first `processed` vectors.
        for name, arr in zip(SPILLS, (keys.astype("<i4"),
                                      xids.astype("<i4"),
                                      codes.astype("u1"),
                                      ncodes.astype("u1"))):
            f = self._files[name]
            arr.tofile(f)
            f.flush()
            os.fsync(f.fileno())
        self.processed += n
        self._commit_cursor()

    def add_precomputed(self, keys, xids, codes, ncodes) -> None:
        """Commit one batch whose assign+encode already happened elsewhere
        (e.g. the routed TwoLevelAssigner + device-resident encoder on the
        billion-scale path, tools/build_1b.py) — reuses the same write-ahead
        spill + atomic-cursor crash-safety as add_batch."""
        keys = np.asarray(keys, "<i4")
        n = keys.shape[0]
        for name, arr in zip(SPILLS, (keys,
                                      np.asarray(xids, "<i4"),
                                      np.asarray(codes, "u1"),
                                      np.asarray(ncodes, "u1"))):
            f = self._files[name]
            arr.tofile(f)
            f.flush()
            os.fsync(f.fileno())
        self.processed += n
        self._commit_cursor()

    def _commit_cursor(self) -> None:
        sizes = {name: self._files[name].tell() for name in SPILLS}
        tmp = os.path.join(self.workdir, CURSOR + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"processed": self.processed, "sizes": sizes}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.workdir, CURSOR))

    # ------------------------------------------------------------------

    def close(self) -> None:
        for f in self._files.values():
            f.close()

    def finalize(self):
        """Assemble the committed spill into the index's store (same sorted
        flat layout the PostingListBuilder produces)."""
        self.close()
        return _assemble(self.index, [self.workdir], self.M,
                         expected=self.processed)


# ---------------------------------------------------------------------------
# Multi-host build: per-host spill directories + deterministic merge
# ---------------------------------------------------------------------------

def host_slice(total: int, num_hosts: int, host: int) -> tuple[int, int]:
    """Contiguous input range owned by ``host``: bit-identical merges need
    a deterministic global stream order, and contiguous ranges make
    "concatenate host spills in host order" reproduce exactly the order a
    single-host build would have streamed (PostingListBuilder's stable
    sort then preserves it within each list). The reference's analog is
    its segment-file naming convention (utils.cpp:273-275)."""
    per = -(-total // num_hosts)
    lo = min(host * per, total)
    return lo, min(lo + per, total)


def _assemble(index, workdirs, M: int, expected: int | None = None):
    from ivfhnsw_tpu.models.storage import PostingListBuilder

    parts = {name: [] for name in SPILLS}
    total = 0
    for wd in workdirs:
        cur = os.path.join(wd, CURSOR)
        with open(cur) as f:
            state = json.load(f)
        total += state["processed"]
        for name in SPILLS:
            p = os.path.join(wd, name)
            data = np.fromfile(p, np.uint8)[:state["sizes"][name]]
            parts[name].append(data)

    def cat(name, dtype):
        return np.concatenate(parts[name]).view(dtype)

    keys = cat("keys.i32", "<i4")
    ids = cat("ids.i32", "<i4")
    codes = cat("codes.u8", "u1").reshape(-1, M)
    ncodes = cat("norm_codes.u8", "u1")
    if expected is not None and total != expected:
        raise ValueError(f"spills hold {total} vectors, expected {expected}")
    if not (keys.shape[0] == ids.shape[0] == codes.shape[0]
            == ncodes.shape[0] == total):
        raise ValueError("spill files inconsistent with cursors")
    b = PostingListBuilder(index.nc, M)
    b.add(keys, ids, codes, ncodes)
    index.store = b.finalize()
    return index


def merge_host_spills(index, workdirs: list[str]):
    """Merge per-host spill directories (each produced by a
    ``StreamedIndexBuild`` over that host's :func:`host_slice` of the input)
    into one finalized index. Deterministic: spills are concatenated in the
    given host order, so the result is bit-identical to a single-host build
    that streamed the same vectors in the same global order — however many
    times any host's build crashed and resumed. Run on any one host after
    all cursors report their slice complete (SURVEY.md §7 layer 6:
    multi-host build pipeline)."""
    return _assemble(index, workdirs, index.config.pq_m)


def initialize_distributed() -> bool:
    """Initialize jax.distributed from standard env vars when present
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID). Returns
    True if multi-process JAX was initialized. On a single-host dev box
    (or when the vars are absent) this is a no-op returning False — the
    build then runs single-process over the local mesh."""
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    if not (addr and nproc and pid):
        return False
    jax.distributed.initialize(coordinator_address=addr,
                               num_processes=int(nproc),
                               process_id=int(pid))
    return True

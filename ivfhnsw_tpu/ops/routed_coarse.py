"""Two-level ROUTED coarse probe selection for large centroid sets.

The search-time analog of ops.hierarchical.TwoLevelAssigner (which serves
top-1 assignment during builds): replaces the flat sweep over all nc
centroids with super-cluster routing — the dense equivalent of the
reference's HNSW graph descent (hnswalg.cpp:48-109), whose upper layers
are exactly a coarse-to-fine router over the centroid set.

1. The nc centroids are partitioned into S super-clusters (k-means over the
   centroid set, tight capacity-bounded membership: every centroid appears
   in exactly one super's block).
2. Per super, a contiguous [cap, d+2] block packs [centroid | sqnorm | id]
   for every member (f32; ids are integers < 2^24, exact in f32).
3. A query scores the S supers (tiny matmul), takes its top-w supers, and
   gathers w WHOLE BLOCKS — B*w gathered rows of cap*(d+2) floats each —
   then scores all w*cap member candidates exactly and top-k's nprobe
   probes out of them.

The selected probes carry exact distances (term1 is f32-faithful), and only
the candidate CUT is approximate — the same place the reference accepts
HNSW's approximation (its efSearch plays the role of our ``w``). Routing
accuracy presumes mesoscale structure in the centroid set, like the
assigner (ops/hierarchical.py KNOWN LIMIT); measure probe-set overlap vs
the exact sweep before adopting.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ivfhnsw_tpu.ops.distances import ARGMIN_PRECISION, streaming_topk_l2
from ivfhnsw_tpu.ops.topk import topk_smallest


def greedy_partition(centroids, supers, cap: int, n_choice: int = 8):
    """Capacity-bounded partition of centroids over supers: nearest-first
    greedy with spill to the next-nearest super with room (the assigner's
    membership rule, ops/hierarchical.py, but every centroid is placed
    EXACTLY once — search blocks must cover the centroid set without
    duplicates). Returns (members [S, cap] i32, valid [S, cap] bool)."""
    centroids = np.asarray(centroids, np.float32)
    nc = centroids.shape[0]
    S = int(supers.shape[0])
    if S * cap < nc:
        raise ValueError(f"total capacity {S}x{cap} < nc={nc}")
    n_choice = min(n_choice, S)
    supers_d = jnp.asarray(supers)
    super_sqn = jnp.sum(supers_d ** 2, axis=1)
    # Chunk the query rows: one [nc, S] step is 64 GiB at nc=2^20, S=2^14
    # (the scale3 routed-setup OOM). Cap the per-step score matrix ~1 GiB.
    rows = max(1024, min(nc, (1 << 28) // max(S, 1)))
    cd = np.empty((nc, n_choice), np.float32)
    cids = np.empty((nc, n_choice), np.int32)
    for off in range(0, nc, rows):
        d_blk, i_blk = streaming_topk_l2(
            jnp.asarray(centroids[off:off + rows]), supers_d, n_choice,
            point_sqnorms=super_sqn)
        cd[off:off + rows] = np.asarray(d_blk)
        cids[off:off + rows] = np.asarray(i_blk)
    members = np.zeros((S, cap), np.int32)
    valid = np.zeros((S, cap), bool)
    fill = np.zeros(S, np.int64)
    for c in np.argsort(cd[:, 0], kind="stable"):
        for s in cids[c]:
            if fill[s] < cap:
                members[s, fill[s]] = c
                valid[s, fill[s]] = True
                fill[s] += 1
                break
        else:  # all n_choice nearest are full; place in the emptiest super
            s = int(np.argmin(fill))
            members[s, fill[s]] = c
            valid[s, fill[s]] = True
            fill[s] += 1
    return members, valid


class RoutedCoarse:
    """Search-time routing structure over a centroid set.

    Derived data (rebuildable from the centroids + key): super centroids
    from k-means over the centroid set, plus the tight partition —
    persistable via :meth:`save`/:meth:`from_state` (the k-means at
    nc=2^20 is worth caching between serving restarts). The packed block
    table is built by :meth:`build_table` and cached by the caller."""

    def __init__(self, centroids, n_super: int | None = None,
                 cap_factor: float = 1.5, key=None, niter: int = 15,
                 n_choice: int = 8):
        from ivfhnsw_tpu.ops.kmeans import kmeans
        centroids = np.asarray(centroids, np.float32)
        nc, d = centroids.shape
        n_super = n_super or max(16, min(nc // 2, nc // 64 or 16))
        key = key if key is not None else jax.random.PRNGKey(0)
        sup, _ = kmeans(key, centroids, n_super, niter=niter)
        self._init_from(centroids, np.asarray(sup), None, None,
                        cap_factor=cap_factor, n_choice=n_choice)

    def _init_from(self, centroids, sup, members, valid, cap_factor=1.5,
                   n_choice=8):
        nc, d = centroids.shape
        self.supers = jnp.asarray(sup)
        self.super_sqn = jnp.sum(self.supers ** 2, axis=1)
        self.n_super = int(sup.shape[0])
        if members is None:
            self.cap = max(8,
                           int(-(-cap_factor * nc // self.n_super)) + 7 & ~7)
            members, valid = greedy_partition(
                centroids, self.supers, self.cap, n_choice=n_choice)
        else:
            self.cap = int(members.shape[1])
        self.members, self.valid = members, valid
        self.d = d
        self.nc = nc
        self._centroids = centroids

    @classmethod
    def from_state(cls, centroids, supers, members, valid):
        """Rebuild from :meth:`save`d arrays without re-running k-means /
        the greedy partition (the centroids themselves live in the index
        file and are passed in, not duplicated in the state file)."""
        self = cls.__new__(cls)
        self._init_from(np.asarray(centroids, np.float32),
                        np.asarray(supers, np.float32),
                        np.asarray(members, np.int32),
                        np.asarray(valid, bool))
        return self

    def save(self, path: str) -> None:
        np.savez(path, supers=np.asarray(self.supers, np.float32),
                 members=self.members, valid=self.valid)

    def build_table(self, centroid_norms):
        """[S, cap, d+2] packed block table: channels [centroid(d) | sqnorm
        | id]. Invalid (padding) slots carry +inf sqnorm, so their
        candidate distance is +inf and they sort last."""
        if self.nc >= (1 << 24):
            raise ValueError("centroid ids exceed f32-exact range (2^24)")
        cn = np.asarray(centroid_norms, np.float32)
        m = self.members
        table = np.zeros((self.n_super, self.cap, self.d + 2), np.float32)
        table[:, :, :self.d] = self._centroids[m]
        table[:, :, self.d] = np.where(self.valid, cn[m], np.inf)
        table[:, :, self.d + 1] = np.where(self.valid, m.astype(np.float32),
                                           0.0)
        return jnp.asarray(table)


@functools.partial(jax.jit, static_argnames=("nprobe", "w", "precision"))
def routed_select_ext(queries, supers, super_sqn, table, *, nprobe: int,
                      w: int, precision=ARGMIN_PRECISION):
    """Routed probe selection.

    queries [B, d]; supers [S, d]; super_sqn [S]; table [S, cap, d+2]
    (see RoutedCoarse.build_table). Returns (qc_dists, probes i32, term1),
    all [B, nprobe], ascending by exact candidate distance.

    ``w`` = supers probed per query (the efSearch analog); requires
    w * cap >= nprobe. Candidate scoring runs at ``precision`` (HIGH =
    f32-fidelity 3-pass by default — term1 feeds the ADC bias directly)."""
    B, d = queries.shape
    S, cap, dc = table.shape
    w = min(w, S)  # clamp BEFORE validating: w > S must not mask w*cap < nprobe
    if w * cap < nprobe:
        raise ValueError(f"w*cap = {w}*{cap} < nprobe={nprobe}")
    qsq = jnp.sum(queries.astype(jnp.float32) ** 2, axis=-1)

    sip = jax.lax.dot_general(
        queries, supers, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32, precision=ARGMIN_PRECISION)
    _, sup = topk_smallest(super_sqn[None, :] - 2.0 * sip, w)   # [B, w]

    g = jnp.take(table, sup, axis=0)                   # [B, w, cap, d+2]
    ip = jax.lax.dot_general(
        g[..., :d].reshape(B, w * cap, d), queries,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32, precision=precision)
    term1 = qsq[:, None] - 2.0 * ip                    # [B, w*cap]
    dist = term1 + g[..., d].reshape(B, w * cap)       # +inf on padding
    d2, sel = topk_smallest(dist, nprobe)
    take = lambda a: jnp.take_along_axis(a.reshape(B, w * cap), sel, axis=1)
    probes = jnp.round(take(g[..., d + 1])).astype(jnp.int32)
    return d2, probes, jnp.take_along_axis(term1, sel, axis=1)

"""Two-level coarse quantizer for billion-scale assignment.

The exact matmul assigner costs n * nc * d FLOPs; at nb=10^9 and nc=2^20
that is ~2.6e17 * d flops — hours even on an accelerator (SURVEY.md §7 hard part #3;
the reference's CPU took 2-3 days, README.md:65). The standard fix is a
two-level search: cluster the nc centroids into super-clusters, route each
point to its ``w`` nearest supers, and do the exact argmin only over those
supers' members.

Execution is shaped for dense batched compute (two designs that fail):

- A per-POINT candidate gather (``centroids[cand]``, cand ``[B, w*cap]``)
  is gather-throughput-bound: ~2 MB of duplicated candidate rows per point,
  measured slower than the exact sweep at nc=2^17.
- Routing by the top-1 super's precomputed neighbor union probes the wrong
  neighborhoods for boundary points (94% match, 1.12x mean assigned
  distance — real losses, not ties).

What works: per-point top-``w`` supers (the accurate probe set), executed
as ``w`` bucketed passes. Pass j buckets points by their j-th nearest
super on the host; one ``lax.scan`` over supers then runs a dense
[bucket, cap] matmul per super against ONLY that super's members —
candidates are gathered once per super and shared by the bucket. A running
(distance, id) min across passes combines probes (||x||^2 is a per-point
constant, so pass distances are comparable). FLOPs: w*cap*d*2 per point
(~64x less than exact at the defaults) and zero per-point gathers.

Membership is capacity-bounded (2x the average, nearest-first greedy spill
to the next-nearest super with room): an unbounded ``counts.max()`` cap let
one collapsed super inflate every bucket matmul ~21x (a 4 TB intermediate
at nc=2^17). Bucket capacity is 2x the average batch share with one
identically-shaped overflow retry per pass; points unresolved by every
pass (pathological skew) fall back to the exact assigner — approximation
never loses points. :func:`TwoLevelAssigner.exact_match_rate` measures the
routing accuracy so the accuracy/TCO trade-off is known, not assumed.

KNOWN LIMIT: two-level routing presumes the centroid set has mesoscale
structure (clusters of centroids). On corpora whose cluster centers are
uniform random (no structure above the cluster scale — e.g. the bench's
synthetic 2^17 corpus), super k-means cannot localize and the match rate
caps out near ~75% regardless of caps; measure exact_match_rate on a
sample and fall back to the exact device sweep (ARGMIN precision,
~16 us/point at nc=2^17) when it is low.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ivfhnsw_tpu.ops.distances import (ARGMIN_PRECISION,
                                        streaming_topk_l2)
from ivfhnsw_tpu.ops.kmeans import kmeans

HIGHEST = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("precision",))
def _bucket_assign(x_pad, idx_mat, members, member_valid, centroids,
                   centroid_norms, precision=ARGMIN_PRECISION):
    """One launch: scan over supers; per super a dense [Bp, cap] score
    matmul against its member centroids.

    x_pad [n_pad, d]; idx_mat [ns, Bp] point indices (-1 = empty slot);
    members/member_valid [ns, cap]. Returns (ids [ns, Bp] i32,
    dists [ns, Bp] f32) — dists omit ||x||^2 (constant per point, so they
    compare across passes); undefined on empty slots."""

    def step(carry, row):
        idx_row, mem_row, mvalid_row = row
        xb = x_pad[jnp.maximum(idx_row, 0)]               # [Bp, d]
        cc = centroids[mem_row]                           # [cap, d]
        ip = jax.lax.dot_general(
            xb, cc, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32, precision=precision)
        d2 = centroid_norms[mem_row][None, :] - 2.0 * ip
        d2 = jnp.where(mvalid_row[None, :], d2, jnp.inf)
        j = jnp.argmin(d2, axis=1)
        return carry, (mem_row[j].astype(jnp.int32),
                       jnp.take_along_axis(d2, j[:, None], 1)[:, 0])

    _, out = jax.lax.scan(step, 0, (idx_mat, members, member_valid))
    return out


@functools.partial(jax.jit,
                   static_argnames=("ns", "Bp", "w", "rows", "precision"))
def _assign_device_core(x, supers, super_sqn, members, member_valid,
                        centroids, centroid_norms, *, ns: int, Bp: int,
                        w: int, rows: int, precision=ARGMIN_PRECISION):
    """Whole assignment in ONE launch for device-resident points: route
    top-w supers (row-chunked), then lax.scan over the w probe ranks, each
    rank bucketizing on device (argsort + scatter) and scanning supers with
    dense member matmuls. Returns (ids [n] i32, dists [n] f32; +inf where
    no pass resolved the point — caller falls back to exact)."""
    n, d = x.shape
    xr = x.reshape(n // rows, rows, d)

    def route_chunk(xc):
        _, sid = streaming_topk_l2(xc, supers, w, block=ns,
                                   point_sqnorms=super_sqn,
                                   precision=precision)
        return sid.astype(jnp.int32)

    sids = jax.lax.map(route_chunk, xr).reshape(n, w)
    iota_n = jnp.arange(n, dtype=jnp.int32)

    def super_scan(idx_mat):
        def step(carry, row):
            idx_row, mem_row, mvalid_row = row
            xb = x[jnp.minimum(idx_row, n - 1)]            # [Bp, d]
            cc = centroids[mem_row]                        # [cap, d]
            ip = jax.lax.dot_general(
                xb, cc, dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32, precision=precision)
            d2 = centroid_norms[mem_row][None, :] - 2.0 * ip
            d2 = jnp.where(mvalid_row[None, :], d2, jnp.inf)
            j = jnp.argmin(d2, axis=1)
            return carry, (mem_row[j].astype(jnp.int32),
                           jnp.take_along_axis(d2, j[:, None], 1)[:, 0])

        _, out = jax.lax.scan(step, 0, (idx_mat, members, member_valid))
        return out

    def one_pass(best, sid_col):
        best_d, best_i = best
        order = jnp.argsort(sid_col).astype(jnp.int32)
        ssid = sid_col[order]
        seg_start = jnp.searchsorted(ssid, jnp.arange(ns, dtype=jnp.int32))
        within = iota_n - seg_start[ssid].astype(jnp.int32)
        # Sentinel n marks empty slots; overflow (within >= Bp) is dropped
        # here and rescued by the point's other probe ranks (or the exact
        # fallback if every rank overflows).
        idx_mat = jnp.full((ns, Bp), n, jnp.int32)
        idx_mat = idx_mat.at[ssid, within].set(order, mode="drop")
        ids2d, d2d = super_scan(idx_mat)
        flat = idx_mat.reshape(-1)
        ids_n = jnp.zeros(n, jnp.int32).at[flat].set(
            ids2d.reshape(-1), mode="drop")
        d_n = jnp.full(n, jnp.inf).at[flat].set(
            d2d.reshape(-1), mode="drop")
        upd = d_n < best_d
        return (jnp.where(upd, d_n, best_d),
                jnp.where(upd, ids_n, best_i)), 0

    init = (jnp.full(n, jnp.inf), jnp.zeros(n, jnp.int32))
    (bd, bi), _ = jax.lax.scan(one_pass, init, jnp.moveaxis(sids, 1, 0))
    return bi, bd


class TwoLevelAssigner:
    """Approximate nearest-centroid assigner: k-means over the centroid set
    + per-point top-w super probes as bucketed per-super matmul passes."""

    def __init__(self, centroids, n_super: int | None = None, w: int = 8,
                 key=None, niter: int = 15):
        centroids = np.asarray(centroids, np.float32)
        nc, d = centroids.shape
        self.w = w
        # Fine supers (avg ~64 members) keep each member matmul small.
        n_super = n_super or max(16, min(nc // 2, nc // 64 or 16))
        key = key if key is not None else jax.random.PRNGKey(0)
        sup, _ = kmeans(key, centroids, n_super, niter=niter)
        self.supers = sup
        self.super_sqn = jnp.sum(sup ** 2, axis=1)
        self.n_super = n_super

        # Capacity-bounded membership (cap = 4x average, greedy spill).
        # 2x was too tight: super k-means over clustered centroid sets is
        # imbalanced enough that ~25% of supers fill and ~40% of centroids
        # spill OUT of their nearest super, capping routed-assign match at
        # ~67%. 4x leaves spill <2% at the cost of a 2x-wider (still tiny)
        # member matmul.
        n_choice = min(8, n_super)
        cd, cids = streaming_topk_l2(jnp.asarray(centroids), sup,
                                     n_choice, point_sqnorms=self.super_sqn)
        cd, cids = np.asarray(cd), np.asarray(cids)
        cap = max(8, -(-4 * nc // n_super))
        members = np.zeros((n_super, cap), np.int32)
        valid = np.zeros((n_super, cap), bool)
        fill = np.zeros(n_super, np.int64)
        for c in np.argsort(cd[:, 0], kind="stable"):
            for s in cids[c]:
                if fill[s] < cap:
                    members[s, fill[s]] = c
                    valid[s, fill[s]] = True
                    fill[s] += 1
                    break
            else:  # all n_choice full; total capacity is 4*nc, so room exists
                s = int(np.argmin(fill))
                members[s, fill[s]] = c
                valid[s, fill[s]] = True
                fill[s] += 1
        self.cap = cap
        self.members = jnp.asarray(members)
        self.member_valid = jnp.asarray(valid)
        self.centroids = jnp.asarray(centroids)
        self.centroid_norms = jnp.sum(self.centroids ** 2, axis=1)

    def _route(self, x, rows: int = 131072) -> np.ndarray:
        """Top-w supers per point [n, w], row-batched so the score matrix
        stays ~1 GB."""
        rows = max(1024, min(rows, (1 << 28) // max(self.n_super, 1)))
        w = min(self.w, self.n_super)
        out = np.empty((x.shape[0], w), np.int64)
        for off in range(0, x.shape[0], rows):
            blk = jnp.asarray(x[off:off + rows])
            _, sid = streaming_topk_l2(blk, self.supers, w,
                                       block=self.n_super,
                                       point_sqnorms=self.super_sqn)
            out[off:off + rows] = np.asarray(sid)
        return out

    def _exact(self, x) -> np.ndarray:
        """Exact fallback, row-batched: the per-step [rows, block] score
        matrix is capped at ~1 GB (an unbatched call on a large unresolved
        set would materialize rows x nc — 270 GB at 1M x 2^17)."""
        from ivfhnsw_tpu.ops.distances import assign_top1
        x = np.asarray(x, np.float32)
        block = min(65536, int(self.centroids.shape[0]))
        rows = max(1024, (1 << 28) // max(block, 1))
        out = np.empty(x.shape[0], np.int32)
        for off in range(0, x.shape[0], rows):
            _, idx = assign_top1(jnp.asarray(x[off:off + rows]),
                                 self.centroids, block=block,
                                 point_sqnorms=self.centroid_norms)
            out[off:off + rows] = np.asarray(idx, np.int32)
        return out

    @staticmethod
    def _bucketize(sid, n_super: int, Bp: int):
        """idx_mat [ns, Bp] of point indices (-1 pad) + overflow indices."""
        order = np.argsort(sid, kind="stable")
        ssid = sid[order]
        seg_start = np.searchsorted(ssid, np.arange(n_super))
        within = np.arange(order.shape[0]) - seg_start[ssid]
        ok = within < Bp
        idx_mat = np.full((n_super, Bp), -1, np.int64)
        idx_mat[ssid[ok], within[ok]] = order[ok]
        return idx_mat, order[~ok]

    def _one_pass(self, x_dev, sid_col, best_d, best_i):
        """Bucketed pass for one probe rank; folds results into the running
        (best_d, best_i) in place. Returns indices left unresolved."""
        n = best_d.shape[0]
        Bp = max(8, -(-2 * n // self.n_super) // 8 * 8)
        unresolved = np.empty(0, np.int64)
        idx_mat, overflow = self._bucketize(sid_col, self.n_super, Bp)
        for attempt in range(2):
            a, d = (np.asarray(v) for v in _bucket_assign(
                x_dev, jnp.asarray(idx_mat), self.members, self.member_valid,
                self.centroids, self.centroid_norms))
            got = idx_mat >= 0
            pts, ids_, ds_ = idx_mat[got], a[got], d[got]
            upd = ds_ < best_d[pts]
            best_d[pts[upd]] = ds_[upd]
            best_i[pts[upd]] = ids_[upd]
            if not overflow.size:
                break
            # Retry once with the same compiled shape; buckets rebuilt from
            # the overflow only.
            idx_mat, overflow2 = self._bucketize(sid_col[overflow],
                                                 self.n_super, Bp)
            idx_mat = np.where(idx_mat >= 0,
                               overflow[np.maximum(idx_mat, 0)], -1)
            unresolved = overflow[overflow2]
            overflow = np.empty(0, np.int64)
        return unresolved

    def assign(self, x, batch: int = 1 << 20) -> np.ndarray:
        x = np.asarray(x, np.float32)
        out = np.empty(x.shape[0], np.int32)
        for off in range(0, x.shape[0], batch):
            blk = x[off:off + batch]
            out[off:off + blk.shape[0]] = self._assign_batch(blk)
        return out

    def _assign_batch(self, x) -> np.ndarray:
        n = x.shape[0]
        sid = self._route(x)
        x_dev = jnp.asarray(x)
        best_d = np.full(n, np.inf, np.float32)
        best_i = np.zeros(n, np.int32)
        rem = None
        for j in range(sid.shape[1]):
            un = self._one_pass(x_dev, sid[:, j], best_d, best_i)
            rem = un if rem is None else np.intersect1d(rem, un)
        if rem is not None and rem.size:
            # Unresolved by every pass (pathological skew): exact fallback.
            best_i[rem] = self._exact(x[rem])
        return best_i

    def assign_device(self, x_dev, rows: int = 131072) -> np.ndarray:
        """Device-resident assignment: x never crosses the host boundary;
        one launch for the whole batch (route + all probe passes), ~4 MB of
        keys coming back. The build fast path: the f32 vectors never cross
        the host link."""
        n = int(x_dev.shape[0])
        ns = self.n_super
        rows = max(1024, min(rows, (1 << 28) // max(ns, 1), n))
        n_pad = -(-n // rows) * rows
        if n_pad != n:
            x_dev = jnp.pad(x_dev, ((0, n_pad - n), (0, 0)))
        Bp = max(8, -(-2 * n_pad // ns) // 8 * 8)
        bi, bd = _assign_device_core(
            x_dev, self.supers, self.super_sqn, self.members,
            self.member_valid, self.centroids, self.centroid_norms,
            ns=ns, Bp=Bp, w=min(self.w, ns), rows=rows)
        bi, bd = bi[:n], bd[:n]
        keys = np.asarray(bi)
        bad = np.asarray(jnp.isinf(bd))
        if bad.any():  # every probe rank overflowed (pathological skew)
            keys = keys.copy()  # np.asarray of a jax array is read-only
            idxs = np.nonzero(bad)[0]
            keys[idxs] = self._exact(np.asarray(x_dev[idxs]))
        return keys

    def exact_match_rate(self, x_sample, exact_assign_fn) -> float:
        """Fraction of sample points routed to the true nearest centroid."""
        approx = self.assign(x_sample)
        exact = exact_assign_fn(x_sample)
        return float((approx == np.asarray(exact)).mean())

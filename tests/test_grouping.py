"""Grouping+Pruning tests against a numpy oracle of the reference semantics
(IndexIVF_HNSW_Grouping.cpp: add_group :43-157, search :188-363,
compute_alpha :691-728)."""

import jax
import numpy as np
import pytest

from ivfhnsw_tpu import IVFADCGroupingIndex, IndexConfig, SearchParams
from ivfhnsw_tpu.utils.recall import recall_at_k


def make_dataset(rng, nb=6000, nq=12, d=32, nc_true=40):
    centers = rng.randn(nc_true, d).astype(np.float32) * 5
    base = centers[rng.randint(0, nc_true, nb)] + rng.randn(nb, d).astype(np.float32)
    queries = centers[rng.randint(0, nc_true, nq)] + rng.randn(nq, d).astype(np.float32)
    gt = np.argsort(((queries[:, None] - base[None]) ** 2).sum(-1), axis=1)
    return base, queries, gt


@pytest.fixture(scope="module")
def built():
    rng = np.random.RandomState(3)
    base, queries, gt = make_dataset(rng)
    cfg = IndexConfig(d=32, nc=32, code_size=8, nsubc=8)
    idx = IVFADCGroupingIndex(cfg)
    key = jax.random.PRNGKey(0)
    idx.train_centroids(key, base[:4000], niter=12)
    idx.compute_neighbor_centroids()
    idx.train_pq(key, base[:3000])
    idx.add(base, np.arange(base.shape[0], dtype=np.int32))
    idx.finalize()
    return idx, base, queries, gt


def ref_alpha(points, centroid, nn_centroids, nn_dists):
    """Direct transcription of the compute_alpha spec (:691-728)."""
    cv = nn_centroids - centroid[None]          # [S, d]
    gnum = gden = 0.0
    for p in points:
        v = p - centroid
        best = None
        for j in range(cv.shape[0]):
            num = max(0.0, float(cv[j] @ v))
            den = float(nn_dists[j])
            a = num / den if den > 0 else 0.0
            s = centroid + a * cv[j]
            dist = float(((p - s) ** 2).sum())
            if best is None or dist < best[0]:
                best = (dist, num, den)
        gnum += best[1]
        gden += best[2]
    return gnum / gden if gden > 0 else 0.0


def test_alpha_matches_reference_math(built):
    idx, base, *_ = built
    keys = idx.assign(base)
    C = np.asarray(idx.centroids)
    nn = np.asarray(idx.nn_centroid_idxs)
    nnd = np.asarray(idx.inter_centroid_dists)
    alphas = np.asarray(idx.alphas)
    # Check a few groups against the per-group reference computation.
    checked = 0
    for c in range(idx.nc):
        pts = base[keys == c]
        if len(pts) < 5 or checked >= 5:
            continue
        ref = ref_alpha(pts, C[c], C[nn[c]], nnd[c])
        assert abs(alphas[c] - ref) < 1e-3 * max(1.0, abs(ref)), (c, alphas[c], ref)
        checked += 1
    assert checked >= 3


def grouping_oracle(idx, queries, nprobe, k, max_codes=0, do_pruning=False):
    """Numpy implementation of the reference Grouping search (:188-363).
    Under OPQ the LUTs take the rotated query (the reference rotates the
    query before compute_inner_prod_table)."""
    R = np.asarray(idx.opq_R) if idx.do_opq else None
    C = np.asarray(idx.centroids)
    cn = (C ** 2).sum(1)
    cb = np.asarray(idx.pq.codebooks)
    ncent = np.asarray(idx.norm_pq.centroids)
    store = idx.store
    codes = np.asarray(store.codes)
    ids = np.asarray(store.ids)
    ncodes = np.asarray(store.norm_codes)
    off = np.asarray(store.list_offsets)
    nn = np.asarray(idx.nn_centroid_idxs)
    icd = np.asarray(idx.inter_centroid_dists)
    alphas = np.asarray(idx.alphas)
    S = idx.nsubc
    M, dsub = cb.shape[0], cb.shape[2]
    sub_sizes = (off[1:] - off[:-1]).reshape(idx.nc, S)
    group_sizes = sub_sizes.sum(1)
    out_d, out_i = [], []
    for q in queries:
        qc = ((q[None] - C) ** 2).sum(1)
        probes = np.argsort(qc)[:nprobe]
        q_rot = q @ R.T if R is not None else q
        lut = np.einsum("md,mkd->mk", q_rot.reshape(M, dsub), cb)
        # threshold pass
        threshold = 0.0
        qsd_all = np.zeros((nprobe, S))
        if do_pruning:
            tot, nsl, ncode = 0.0, 0, 0
            for i, c in enumerate(probes):
                if group_sizes[c] == 0:
                    continue
                a = alphas[c]
                for s in range(S):
                    if sub_sizes[c, s] == 0:
                        continue
                    qn = qc[nn[c, s]]
                    qsd_all[i, s] = ((1 - a) * qc[c]
                                     - a * ((1 - a) * icd[c, s] - qn))
                    tot += qsd_all[i, s]
                    nsl += 1
                ncode += group_sizes[c]
                if max_codes and ncode >= 2 * max_codes:
                    break
            threshold = tot / max(nsl, 1)
        cand_d, cand_i, ncode = [], [], 0
        for i, c in enumerate(probes):
            if group_sizes[c] == 0:
                continue
            a = alphas[c]
            t1 = (1 - a) * (qc[c] - cn[c])
            for s in range(S):
                sz = sub_sizes[c, s]
                if sz == 0:
                    continue
                if do_pruning and not (qsd_all[i, s] < threshold):
                    continue
                lo = off[c * S + s]
                hi = lo + sz
                nc_id = nn[c, s]
                t2 = a * (qc[nc_id] - cn[nc_id])
                cc = codes[lo:hi].astype(np.int64)
                t4 = 2 * lut[np.arange(M)[None, :], cc].sum(1)
                dd = t1 + t2 + ncent[ncodes[lo:hi].astype(np.int64)] - t4
                cand_d.append(dd)
                cand_i.append(ids[lo:hi])
                ncode += sz
            if max_codes and ncode >= max_codes:
                break
        cand_d = np.concatenate(cand_d)
        cand_i = np.concatenate(cand_i)
        order = np.argsort(cand_d, kind="stable")[:k]
        out_d.append(cand_d[order])
        out_i.append(cand_i[order])
    return np.stack(out_d), np.stack(out_i)


def assert_matches_oracle(dists, labels, ref_d, ref_i):
    np.testing.assert_allclose(dists, ref_d, rtol=1e-4, atol=1e-3)
    mismatch = labels != ref_i
    if mismatch.any():
        assert np.allclose(dists[mismatch], ref_d[mismatch], rtol=1e-4,
                           atol=1e-3)


def test_grouping_search_matches_oracle(built):
    idx, base, queries, gt = built
    d, l = idx.search(queries, SearchParams(k=10, nprobe=6, max_codes=0))
    rd, ri = grouping_oracle(idx, queries, 6, 10)
    assert_matches_oracle(d, l, rd, ri)


def test_grouping_pruning_matches_oracle(built):
    idx, base, queries, gt = built
    p = SearchParams(k=10, nprobe=8, max_codes=600, do_pruning=True)
    d, l = idx.search(queries, p)
    rd, ri = grouping_oracle(idx, queries, 8, 10, max_codes=600,
                             do_pruning=True)
    assert_matches_oracle(d, l, rd, ri)


def test_grouping_max_codes_budget(built):
    idx, base, queries, gt = built
    p = SearchParams(k=10, nprobe=8, max_codes=400)
    d, l = idx.search(queries, p)
    rd, ri = grouping_oracle(idx, queries, 8, 10, max_codes=400)
    assert_matches_oracle(d, l, rd, ri)


def test_grouping_recall(built):
    idx, base, queries, gt = built
    r = recall_at_k(idx.search(queries, SearchParams(k=100, nprobe=16,
                                                     max_codes=0))[1], gt)
    assert r[100] >= 0.9, r
    # Pruning trades little recall for fewer scanned codes.
    rp = recall_at_k(idx.search(queries,
                                SearchParams(k=100, nprobe=16, max_codes=0,
                                             do_pruning=True))[1], gt)
    assert rp[100] >= r[100] - 0.25


def test_grouping_serialization_roundtrip(built, tmp_path):
    idx, base, queries, gt = built
    path = str(tmp_path / "g.index")
    idx.write(path)
    idx2 = IVFADCGroupingIndex(idx.config)
    idx2.set_centroids(np.asarray(idx.centroids))
    idx2.pq, idx2.norm_pq = idx.pq, idx.norm_pq
    idx2.read(path)
    p = SearchParams(k=10, nprobe=6, max_codes=0)
    d1, l1 = idx.search(queries, p)
    d2, l2 = idx2.search(queries, p)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5)


def test_search_disk_exact_rerank(built, tmp_path):
    idx, base, queries, gt = built
    from ivfhnsw_tpu.utils import io
    path = str(tmp_path / "base.fvecs")
    io.write_xvec(path, base)
    f = io.XvecFile(path, base.shape[1])
    d, l = idx.search_disk(queries, SearchParams(k=10, nprobe=16, max_codes=0), f)
    # Reranked distances must be exact L2.
    for i in range(queries.shape[0]):
        exact = ((base[l[i, 0]] - queries[i]) ** 2).sum()
        np.testing.assert_allclose(d[i, 0], exact, rtol=1e-4)
    # Rerank should not hurt recall@1 vs raw ANN.
    r_disk = recall_at_k(l, gt, ks=(1,))
    r_ann = recall_at_k(idx.search(queries, SearchParams(k=10, nprobe=16,
                                                         max_codes=0))[1],
                        gt, ks=(1,))
    assert r_disk[1] >= r_ann[1] - 1e-9


def test_grouping_trace_mode(built):
    idx, base, queries, gt = built
    idx.engine = "auto"
    d, l, tr = idx.search(queries, SearchParams(k=10, nprobe=6, max_codes=500),
                          trace=True)
    assert tr["probes"].shape == (queries.shape[0], 6)
    assert (tr["n_scanned"] > 0).all()
    assert tr["included"].dtype == np.bool_


def test_search_disk_pads_short_candidates(tmp_path):
    """A query returning fewer than k finite candidates must pad with
    (+inf, -1) instead of raising (regression: shape-mismatch on assign)."""
    import jax
    from ivfhnsw_tpu.utils import io

    rng = np.random.RandomState(11)
    nb, d = 64, 16
    base = rng.randn(nb, d).astype(np.float32)
    cfg = IndexConfig(d=d, nc=8, code_size=4, nsubc=4)
    idx = IVFADCGroupingIndex(cfg)
    key = jax.random.PRNGKey(0)
    idx.train_centroids(key, base, niter=5)
    idx.compute_neighbor_centroids()
    idx.train_pq(key, base)
    idx.add(base, np.arange(nb, dtype=np.int32))
    idx.finalize()
    path = str(tmp_path / "tiny.fvecs")
    io.write_xvec(path, base)
    f = io.XvecFile(path, d)
    # k=40 but nprobe=1 limits candidates well below 2k=80.
    dd, ll = idx.search_disk(rng.randn(3, d).astype(np.float32),
                             SearchParams(k=40, nprobe=1, max_codes=0), f)
    assert dd.shape == (3, 40) and ll.shape == (3, 40)
    for i in range(3):
        n_fin = np.isfinite(dd[i]).sum()
        assert (ll[i, n_fin:] == -1).all()


def test_device_build_matches_host_build(built):
    """alpha_pass_device/add_batch_device (the streamed tens-of-millions
    build path) produce the same alphas, store layout, and codes as the
    host add() pipeline — only the transfer pattern differs."""
    import jax.numpy as jnp

    host_idx, base, queries, gt = built
    cfg = IndexConfig(d=32, nc=32, code_size=8, nsubc=8)
    dev = IVFADCGroupingIndex(cfg)
    dev.set_centroids(np.asarray(host_idx.centroids))
    dev.nn_centroid_idxs = host_idx.nn_centroid_idxs
    dev.inter_centroid_dists = host_idx.inter_centroid_dists
    dev.pq = host_idx.pq
    dev.norm_pq = host_idx.norm_pq
    dev.opq_R = host_idx.opq_R

    x_dev = jnp.asarray(base)
    bs = 2048
    key_blocks = []
    for off in range(0, base.shape[0], bs):
        keys = dev.assign_batch_device(x_dev[off:off + bs])
        key_blocks.append(keys)
        dev.alpha_pass_device(x_dev[off:off + bs], keys)
    dev.finalize_alphas()
    np.testing.assert_allclose(np.asarray(dev.alphas),
                               np.asarray(host_idx.alphas), rtol=1e-5)
    for bi, off in enumerate(range(0, base.shape[0], bs)):
        dev.add_batch_device(x_dev[off:off + bs],
                             np.arange(off, min(off + bs, base.shape[0]),
                                       dtype=np.int32),
                             precomputed_idx=key_blocks[bi])
    dev.finalize()

    hs, ds = host_idx._ensure_store(), dev._ensure_store()
    np.testing.assert_array_equal(np.asarray(hs.list_offsets),
                                  np.asarray(ds.list_offsets))
    np.testing.assert_array_equal(np.asarray(hs.ids), np.asarray(ds.ids))
    np.testing.assert_array_equal(np.asarray(hs.codes), np.asarray(ds.codes))
    # Norm codes may flip by one quantizer step on near-ties: the device
    # path jits at different batch shapes, so the reconstruction-norm
    # matmuls tile differently (ULP-level float drift at the bin edge).
    np.testing.assert_allclose(np.asarray(hs.norm_codes, np.int16),
                               np.asarray(ds.norm_codes, np.int16), atol=1)

    p = SearchParams(k=5, nprobe=8, max_codes=3000, do_pruning=True)
    dh, lh = host_idx.search(queries, p)
    dd, ld = dev.search(queries, p)
    np.testing.assert_array_equal(np.asarray(lh), np.asarray(ld))

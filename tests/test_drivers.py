"""Driver smoke tests (synthetic mode, tiny sizes) — the 12-binary surface
of the reference (SURVEY.md §2.2) exercised end-to-end."""

import sys

import numpy as np
import pytest

COMMON = ("-synthetic 0 -d 16 -nc 32 -code_size 4 -nb 5000 -nt 3000 "
          "-nq 50 -k 10 -nprobe 8 -max_codes 1000")


def run_driver(mod, args):
    sys.argv = ["driver"] + args.split()
    return __import__(f"ivfhnsw_tpu.drivers.{mod}", fromlist=["main"]).main()


def test_ivfadc_eval_driver(tmp_path):
    res = run_driver("ivfadc_eval", COMMON)
    assert res["recalls"][10] > 0.3


def test_ivfadc_eval_artifacts_resume(tmp_path):
    args = (COMMON
            + f" -path_centroids {tmp_path}/c.fvecs"
            + f" -path_pq {tmp_path}/q.pq -path_norm_pq {tmp_path}/n.pq"
            + f" -path_precomputed_idxs {tmp_path}/idx.ivecs"
            + f" -path_index {tmp_path}/x.index")
    r1 = run_driver("ivfadc_eval", args)
    # Second run must resume from every artifact and reproduce results.
    r2 = run_driver("ivfadc_eval", args)
    np.testing.assert_array_equal(r1["labels"], r2["labels"])


def test_grouping_eval_driver():
    res = run_driver("grouping_eval", COMMON + " -nsubc 4 -do_pruning on")
    assert res["recalls"][10] > 0.3


def test_enn_driver():
    rate = run_driver("enn", COMMON + " -nprobe 1 -max_codes 0")
    assert rate > 0.5


def test_disk_rerank_driver():
    res = run_driver("disk_rerank", COMMON + " -nsubc 4")
    assert res["recalls"][10] > 0.3


def test_vector_add_driver():
    res = run_driver("vector_add", COMMON + " -nsubc 4 -segments 3")
    assert len(res) == 3
    # Recall grows (or holds) as segments accumulate.
    assert res[-1]["recalls"][10] >= res[0]["recalls"][10]
    # Appends are linear: each segment adds exactly its own vectors.
    assert [r["ntotal"] for r in res] == [1667, 3334, 5000]


def test_vector_add_consumes_idx_segments(monkeypatch):
    """The driver must use the precomputed-idx segment files: poison
    index.assign after setup and verify the segment loop never calls it
    (reference pairs bigann_base_NN.bvecs with precomputed_idxs_*_NN.ivecs,
    test_ivfhnsw_grouping_sift1b_vector_add.cpp:97-127)."""
    import os
    import tempfile
    import jax
    from ivfhnsw_tpu import IVFADCGroupingIndex, IndexConfig
    from ivfhnsw_tpu.drivers import common as C
    from ivfhnsw_tpu.drivers import vector_add as VA
    from ivfhnsw_tpu.utils import io

    sys.argv = ["driver"] + (COMMON + " -nsubc 4").split()
    cfg, extras = C.parse_driver_args(("synthetic",))
    ds = C.get_dataset(cfg, 0)
    helper = IVFADCGroupingIndex(cfg.index)
    C.setup_quantizer(helper, cfg, ds, jax.random.PRNGKey(0))
    seg_dir = tempfile.mkdtemp(prefix="va_idx_")
    per = -(-ds.base.shape[0] // 2)
    for i in range(2):
        blk = ds.base[i * per:(i + 1) * per]
        io.write_xvec(os.path.join(seg_dir, f"base_{i:02d}.fvecs"), blk)
        idxs = helper.assign(blk).astype("<u4")
        with open(os.path.join(seg_dir, f"precomputed_idxs_{i:02d}.ivecs"),
                  "wb") as f:
            np.asarray([idxs.size], "<u4").tofile(f)
            idxs.tofile(f)

    calls = {"n": 0}
    orig_assign = IVFADCGroupingIndex.assign

    def counting_assign(self, x, batch=None):
        calls["n"] += 1
        return orig_assign(self, x, batch)

    monkeypatch.setattr(IVFADCGroupingIndex, "assign", counting_assign)
    sys.argv = ["driver"] + (COMMON
                             + f" -nsubc 4 -segment_dir {seg_dir}").split()
    res = VA.main()
    assert len(res) == 2
    # assign() may run during quantizer/PQ setup, but the segment loop uses
    # the idx files: exactly zero assigns after setup would be ideal, but
    # setup_pq assigns the train set — so bound the count instead.
    assert calls["n"] <= 1


def test_mkindex_driver(tmp_path):
    run_driver("mkindex",
               COMMON + f" -nsubc 4 -orcv_home {tmp_path}/orcv")
    import os
    assert os.path.exists(tmp_path / "orcv" / "hdr.vec")
    assert os.path.exists("centriods.log")
    os.remove("centriods.log")


def test_orca_debug_driver(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run_driver("orca_debug", COMMON)
    import os
    assert os.path.exists("centroids_hit.log")


def test_config_json_roundtrip(tmp_path):
    from ivfhnsw_tpu.utils.config import RunConfig, parse_args
    cfg = parse_args(COMMON.split()[2:])  # skip -synthetic flag pair
    text = cfg.to_json()
    cfg2 = RunConfig.from_json(text)
    assert cfg2.index.nc == cfg.index.nc
    assert cfg2.search.max_codes == cfg.search.max_codes


def test_example_script_smoke(tmp_path):
    """The examples/*.sh launcher surface works end-to-end (synthetic
    override, tiny sizes)."""
    import os
    import subprocess
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        ["bash", "examples/run_sift1b.sh",
         "-synthetic", "0", "-d", "16", "-nc", "32", "-nb", "6000",
         "-nt", "3000", "-nq", "50", "-code_size", "4", "-nprobe", "8",
         "-max_codes", "500", "-k", "10",
         "-path_base", "", "-path_learn", "", "-path_q", "", "-path_gt", "",
         "-path_centroids", str(tmp_path / "c.fvecs"),
         "-path_precomputed_idxs", str(tmp_path / "i.ivecs"),
         "-path_pq", str(tmp_path / "q.pq"),
         "-path_norm_pq", str(tmp_path / "n.pq"),
         "-path_index", str(tmp_path / "x.index")],
        capture_output=True, text=True, timeout=900, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Recall@" in r.stdout


def test_deep1b_geometry_d96():
    """DEEP1B canonical geometry (d=96, PQ16 -> dsub=6): the fused kernels
    and LUT layout must be dimension-agnostic (reference deep1b drivers,
    test_ivfhnsw_deep1b.cpp). Uses PQ16 on d=96 like run_deep1b.sh."""
    res = run_driver("ivfadc_eval",
                     "-synthetic 0 -d 96 -nc 32 -code_size 16 -nb 4000 "
                     "-nt 3000 -nq 50 -k 10 -nprobe 8 -max_codes 1000")
    assert res["recalls"][10] > 0.3

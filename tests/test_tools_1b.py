"""Script-path smoke for the 1B tools: tools/build_1b.py must produce a
resumable spill + in-stream groundtruth from nothing but a cache dir, and
tools/search_1b.py must search that spill shard-streamed and emit the
bench-visible JSON — the same two commands the real billion-vector run
uses, at BENCH_SMOKE geometry on CPU (the math itself is proven
bit-exact against direct search in test_search1b_math.py; this test
covers the file formats, cursor handling, prerequisite self-build, and
the committed-record write guard).

Reference analog: test_ivfhnsw_sift1b.cpp drives build+search through
files the same way (read_fvecs spill -> search loop at 188-215).
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tool, cache, extra=()):
    env = dict(os.environ)
    env.update({"BENCH_SMOKE": "1", "BENCH_FORCE_CPU": "1",
                "BENCH_CACHE_DIR": cache,
                "JAX_PLATFORMS": "cpu"})
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", tool), *extra],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=540)


def test_build_then_search_smoke(tmp_path):
    cache = str(tmp_path / "cache")
    os.makedirs(cache)

    r = _run("build_1b.py", cache,
             ("--target", "32768", "--batch", "8192"))
    assert r.returncode == 0, r.stderr[-2000:]
    art = json.load(open(os.path.join(cache, "build1b.json")))
    assert art["processed"] == 32768 and art["partial"] is False
    wd = os.path.join(cache, "build1b")
    # Spill + groundtruth on disk, cursor committed.
    for f in ("keys.i32", "ids.i32", "norm_codes.u8", "codes.u8",
              "cursor.json", "queries.npy", "gt.npy"):
        assert os.path.exists(os.path.join(wd, f)), f
    assert json.load(open(os.path.join(wd, "cursor.json")))[
        "processed"] == 32768

    r = _run("search_1b.py", cache, ("--shards", "4"))
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.load(open(os.path.join(cache, "search1b.json")))
    assert out["nb"] == 32768 and out["shards"] == 4
    assert len(out["per_shard"]) == 4
    # Unlimited budget relative to this corpus + top-1 GT: the true
    # neighbor's list is probed for nearly every query.
    assert out["recall_at_100"] > 0.9
    # Results go to the cache only, never into the checkout.
    assert not os.path.exists(os.path.join(ROOT, "RESULTS_SEARCH1B.json"))
    assert not os.path.exists(os.path.join(ROOT, "RESULTS_1B.json"))

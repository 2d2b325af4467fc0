"""bench.py's artifact contract: every stage is either measured in this run
or reads "not measured" — no number from another run is filled in — under
any budget, stage filter or termination. BENCH_FORCE_CPU keeps these runs
on the CPU backend."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_skipped_stage_reads_not_measured():
    """A stage this run did not measure is stamped "not measured" and
    gains no other field; a stamp never overwrites a measured stage's."""
    sys.path.insert(0, ROOT)
    import bench

    result = {"scale4_qps_nprobe128_mc100k": 123.0}
    bench.mark_not_measured(result, "grouping")
    assert result == {"scale4_qps_nprobe128_mc100k": 123.0,
                      "grouping_source": "not measured"}
    result["primary_source"] = "cache"
    bench.mark_not_measured(result, "primary")
    assert result["primary_source"] == "cache"


def test_bench_zero_budget_run_emits_complete_backfilled_artifact(tmp_path):
    """bench.py under an exhausted wall-clock budget must still emit ONE
    parseable JSON line with every stage explicitly skipped and marked
    "not measured". BENCH_CACHE_DIR isolates the subprocess's checkpoint
    writes from the real .bench_cache."""
    import json
    env = dict(os.environ, BENCH_FORCE_CPU="1", BENCH_BUDGET_S="0",
               BENCH_CACHE_DIR=str(tmp_path))
    r = subprocess.run([sys.executable, os.path.join(ROOT, "bench.py")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    line = r.stdout.strip().split("\n")[-1]
    res = json.loads(line)
    skipped = {s["stage"] for s in res.get("skipped_stages", [])}
    expected = {"primary", "grouping", "scale", "deep", "siftlike",
                "scale3sl", "scale4", "grouping_scale", "scale2", "scale3"}
    assert skipped == expected, skipped
    for st in expected:
        assert res.get(f"{st}_source") == "not measured", st
    # nothing measured, so no headline number either
    assert "value" not in res and "vs_baseline" not in res
    assert res["build_1b_source"] == "not measured"


def test_estimate_stage_need_partial_cache_discounts(monkeypatch, tmp_path):
    """A partial cache (centroids from a killed build) must cut the fresh
    estimate so an affordable stage isn't skipped on its cold estimate."""
    sys.path.insert(0, ROOT)
    import bench

    monkeypatch.setattr(bench, "CACHE", str(tmp_path))
    probe = ["s/x.index", "s/ceiling.json"]
    disc = [("s/centroids.npy", 2500), ("s/x.pq", 200), ("s/x.index", 4000)]
    # cold: full fresh estimate
    assert bench.estimate_stage_need(probe, 7100, 700, disc) == (False, 7100)
    # centroids cached: fresh minus the centroid phase
    (tmp_path / "s").mkdir()
    (tmp_path / "s" / "centroids.npy").write_bytes(b"")
    assert bench.estimate_stage_need(probe, 7100, 700, disc) == (False, 4600)
    # index cached too: floored at the warm estimate
    (tmp_path / "s" / "x.pq").write_bytes(b"")
    (tmp_path / "s" / "x.index").write_bytes(b"")
    assert bench.estimate_stage_need(probe, 7100, 700, disc) == (False, 700)
    # fully cached (ceiling present): warm estimate
    (tmp_path / "s" / "ceiling.json").write_bytes(b"{}")
    assert bench.estimate_stage_need(probe, 7100, 700, disc) == (True, 700)


def test_warm_reserve_counts_pending_cached_flagships(monkeypatch,
                                                      tmp_path):
    """Cold early stages must hold back the warm-run cost of every
    still-pending fully-cached flagship stage, so a driver budget that
    can measure the warm flagships always does (r04 verdict weak #7).
    Decided (ran/skipped) stages and the candidate itself don't count,
    and a wiped cache reserves nothing."""
    sys.path.insert(0, ROOT)
    import bench

    monkeypatch.setattr(bench, "CACHE", str(tmp_path))
    # Wiped cache: zero reserve — pre-reserve ordering.
    assert bench.warm_reserve("primary", set()) == 0.0
    # scale3sl + grouping_scale fully cached -> both reserved.
    for d, files in (("scale3sl", ("sl.index", "ceiling.json")),
                     ("grouping_scale", ("gs.index", "ceiling.json"))):
        (tmp_path / d).mkdir()
        for f in files:
            (tmp_path / d / f).write_bytes(b"")
    assert bench.warm_reserve("primary", set()) == 1300.0
    # A partially-cached stage (index without ceiling) reserves nothing.
    (tmp_path / "scale4").mkdir()
    (tmp_path / "scale4" / "s4.index").write_bytes(b"")
    assert bench.warm_reserve("primary", set()) == 1300.0
    # The candidate itself and already-decided stages are excluded.
    assert bench.warm_reserve("scale3sl", set()) == 600.0
    assert bench.warm_reserve("primary", {"grouping_scale"}) == 700.0
    assert bench.warm_reserve("scale3sl", {"grouping_scale"}) == 0.0


def _seed_smoke_cache(tmp_path):
    """Copy the committed warm .bench_cache_smoke artifacts into the test's
    isolated cache dir: keeps subprocess isolation (CI runs can't clobber
    the tracked cache) while staying warm (no cold tiny-corpus rebuild)."""
    import shutil
    src = os.path.join(ROOT, ".bench_cache_smoke")
    if os.path.isdir(src):
        shutil.copytree(src, str(tmp_path), dirs_exist_ok=True)
        for junk in ("last_result.json", ".lock"):
            p = os.path.join(str(tmp_path), junk)
            if os.path.exists(p):
                os.remove(p)


def test_bench_smoke_stage_filter_runs_real_tiny_primary(tmp_path):
    """BENCH_SMOKE + BENCH_STAGES CI rehearsal: the primary stage runs its
    REAL build/eval path at tiny shapes on CPU (measured this run), and
    every other stage skips with a stage-filter marker, "not measured"."""
    import json
    _seed_smoke_cache(tmp_path)
    env = dict(os.environ, BENCH_SMOKE="1", BENCH_FORCE_CPU="1",
               BENCH_STAGES="primary", BENCH_CACHE_DIR=str(tmp_path))
    r = subprocess.run([sys.executable, os.path.join(ROOT, "bench.py")],
                       capture_output=True, text=True, env=env,
                       timeout=1800)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().split("\n")[-1])
    assert res["stages_done"] == ["primary"]
    assert "primary_source" not in res          # measured this run
    assert res["value"] > 0 and res["recall_at_1"] > 0
    skipped = {s["stage"]: s["reason"] for s in res["skipped_stages"]}
    assert set(skipped) == {"grouping", "scale", "deep", "siftlike",
                            "scale3sl", "scale4", "grouping_scale",
                            "scale2", "scale3"}
    assert all(v == "stage filter" for v in skipped.values())
    assert res["grouping_source"] == "not measured"


def test_bench_sigterm_midstage_emits_complete_artifact(tmp_path):
    """Round-4 verdict item 1 acceptance test: SIGTERM a BENCH_FORCE_CPU
    smoke run mid-stage. The process must exit 0 and its LAST stdout line
    must parse as JSON and be COMPLETE: every STAGES_ALL entry is either
    measured this run (in stages_done) or stamped "not measured" by the
    flush. Reference protocol analog: the driver prints its measured
    numbers where the harness captures them (test_ivfhnsw_sift1b.cpp:
    188-215)."""
    import json
    import signal
    import time

    _seed_smoke_cache(tmp_path)
    env = dict(os.environ, BENCH_SMOKE="1", BENCH_FORCE_CPU="1",
               BENCH_CACHE_DIR=str(tmp_path))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "bench.py")],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env)
    # Wait for the first stage-boundary checkpoint (last_result.json), then
    # kill: the bench is genuinely mid-stage (grouping or later running).
    last = os.path.join(str(tmp_path), "last_result.json")
    t0 = time.time()
    while time.time() - t0 < 900 and proc.poll() is None:
        if os.path.exists(last):
            break
        time.sleep(0.5)
    terminated = False
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        terminated = True
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"rc={proc.returncode}"
    res = json.loads(out.strip().split("\n")[-1])
    if terminated:
        assert res.get("terminated_by_signal") == signal.SIGTERM

    sys.path.insert(0, ROOT)
    import bench
    done = set(res.get("stages_done", []))
    for st in bench.STAGES_ALL:
        assert (st in done or f"{st}_source" in res), (
            f"stage {st!r} missing from artifact: neither measured "
            f"(stages_done={sorted(done)}) nor provenance-stamped")
    # The artifact (not the exit code) is the deliverable — headline fields
    # must be present under any termination.
    assert "value" in res and "vs_baseline" in res

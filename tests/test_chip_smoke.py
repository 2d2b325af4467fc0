"""chip_smoke.py's contract off the card, and the compile-cache helper.

The smoke run must fail (non-zero exit, no result line) wherever JAX finds
no GPU and wherever the package is missing; its ``--rehearse-cpu`` dry run
at tiny sizes must pass every phase and never claim a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax

from ivfhnsw_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")
TINY = ["--n", "16384", "--nc", "64", "--train", "8192", "--nq", "16",
        "--group-n", "32768", "--group-nc", "128", "--group-pq-train",
        "4096", "--batch", "4096"]


def _run(args, tmp_path, cwd=ROOT, timeout=900, **env):
    e = dict(os.environ, JAX_PLATFORMS="cpu",
             JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"), **env)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=timeout)


def _last_json(stdout: str):
    lines = stdout.strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper changes nothing.
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_default(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_fails_without_gpu(tmp_path):
    r = _run([SMOKE] + TINY, tmp_path, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert _last_json(r.stdout) is None


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"] + TINY, tmp_path, cwd=str(tmp_path),
             timeout=300, PYTHONPATH="")
    assert r.returncode != 0
    assert _last_json(r.stdout) is None


def test_chip_smoke_rehearse_cpu(tmp_path):
    r = _run([SMOKE, "--rehearse-cpu"] + TINY, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    res = _last_json(r.stdout)
    assert res == {"rehearsal": "cpu", "passed": True,
                   "device": {"platform": "cpu", "kind": "cpu",
                              "count": res["device"]["count"]}}
    for phase in ("phase2", "phase3", "phase4"):
        assert phase in r.stdout
    assert "recall@100=" in r.stdout


def test_chip_smoke_rehearse_four_cards(tmp_path):
    """The sharded phase alone, on virtual CPU devices."""
    r = _run([SMOKE, "--rehearse-cpu", "--four-cards"] + TINY, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    res = _last_json(r.stdout)
    assert res["passed"] and res["device"]["count"] >= 4
    assert "4-card vs 1-card" in r.stdout
    assert "phase2 (nprobe" not in r.stdout      # no other phase runs

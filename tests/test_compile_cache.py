"""The one compile-cache helper every entry point uses
(utils/compile_cache.py): JAX_COMPILATION_CACHE_DIR when set, else one
fixed, gitignored path inside the checkout."""

import os
import subprocess

import jax

from picard_ica_tpu.utils import compile_cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_is_honoured(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.cache_dir() == str(tmp_path)
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_default_is_one_fixed_gitignored_path_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.cache_dir()
    assert path == os.path.join(_REPO, ".jax_cache")
    assert compile_cache.cache_dir() == path  # no pid, no timestamp
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", path], cwd=_REPO,
    ).returncode
    assert ignored == 0, ".jax_cache/ must be gitignored"


def test_entry_points_share_the_helper():
    """bench.py, chip_smoke.py, the suite, the staged trace, the graft
    entry and the test harness all call the one helper; none sets its
    own cache directory."""
    for rel in ("bench.py", "chip_smoke.py", "__graft_entry__.py",
                "benchmarks/suite.py", "benchmarks/xla_staged_trace.py",
                "tests/conftest.py"):
        with open(os.path.join(_REPO, rel)) as f:
            src = f.read()
        assert "enable_compile_cache" in src, rel
        assert "jax_compilation_cache_dir" not in src, rel

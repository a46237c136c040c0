"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR when set,
else .jax_cache/ at the checkout root."""

import os
import subprocess
import sys

from gnumap_tpu.utils import jaxcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_default_and_env(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxcache.cache_dir() == os.path.join(REPO, ".jax_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcache.cache_dir() == str(tmp_path)


def test_enable_honours_env(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; from gnumap_tpu.utils import jaxcache; "
         "print(jaxcache.enable()); "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [str(tmp_path / "cc")] * 2

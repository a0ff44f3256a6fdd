"""Persistent compile cache: JAX_COMPILATION_CACHE_DIR wins when set;
otherwise one fixed directory inside the checkout."""

import os
import subprocess
import sys

import jax

from kaldi_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_dir_is_fixed_inside_checkout_and_ignored():
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_env_var_wins_and_nothing_is_overridden(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_env_var_reaches_jax_in_a_fresh_process(tmp_path):
    code = ("from kaldi_tpu.utils.compile_cache import "
            "enable_compile_cache; import jax; enable_compile_cache(); "
            "print(jax.config.jax_compilation_cache_dir)")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path / "cc")


def test_without_env_var_uses_the_checkout_dir(tmp_path):
    code = ("from kaldi_tpu.utils.compile_cache import "
            "enable_compile_cache; import jax; d = enable_compile_cache(); "
            "print(d == jax.config.jax_compilation_cache_dir, d)")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=dict(env, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", compile_cache.DEFAULT_DIR]


def test_only_the_helper_sets_a_cache_dir():
    hits = []
    for root, dirs, files in os.walk(REPO):
        dirs[:] = [d for d in dirs if not d.startswith(".")
                   and d not in ("tests", "__pycache__", "_scratch")]
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                if "jax_compilation_cache_dir" in open(path).read():
                    hits.append(os.path.relpath(path, REPO))
    assert hits == [os.path.join("kaldi_tpu", "utils", "compile_cache.py")]

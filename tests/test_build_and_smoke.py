"""Build keying of the native library, the compile-cache rule, and the
GPU smoke script's refusal to run without a GPU."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_native_build_key_rebuilds_foreign_library(monkeypatch, tmp_path,
                                                   caplog):
    """A library built for another CPU (or other flags) lives under
    another key, so it is never loaded here: the loader builds its own,
    and a failed build is logged with the compiler's message."""
    from dvda import host

    monkeypatch.setattr(host, "_BUILD_DIR", str(tmp_path))
    mine = host.library_path()
    monkeypatch.setattr(host, "_host_cpu", lambda: "model name: foreign\n")
    foreign = host.library_path()
    monkeypatch.undo()
    monkeypatch.setattr(host, "_BUILD_DIR", str(tmp_path))
    assert foreign != mine and host.library_path() == mine
    monkeypatch.setattr(host, "_CXXFLAGS", host._CXXFLAGS + ["-O0"])
    assert host.library_path() != mine
    monkeypatch.setattr(host, "_CXXFLAGS", host._CXXFLAGS[:-1])

    with open(foreign, "wb") as fh:  # a copied-in library: never loaded
        fh.write(b"not a library for this machine")
    built = []

    def fake_build(so):
        built.append(so)
        return "g++: error: stub compiler message"

    monkeypatch.setattr(host, "_build", fake_build)
    monkeypatch.setattr(host, "_lib", None)
    monkeypatch.setattr(host, "_load_error", None)
    with caplog.at_level("WARNING", logger="dvda"):
        assert host._load() is None
    assert built == [mine]
    assert any("stub compiler message" in r.message for r in caplog.records)


def test_compile_cache_rule(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache
    and the package sets none of its own; otherwise the default is the
    fixed, gitignored .jaxcache in the checkout."""
    import jax

    from dvda import config
    from dvda.utils import jaxcache

    assert config.DEFAULT_COMPILE_CACHE == os.path.join(REPO, ".jaxcache")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jaxcache/" in fh.read().split()

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    monkeypatch.setattr(jaxcache, "_applied", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/jax/own/dir")
    assert jaxcache.ensure_compile_cache() == "/jax/own/dir"
    assert updates == []

    monkeypatch.setattr(jaxcache, "_applied", None)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    monkeypatch.setenv("DVDA_COMPILE_CACHE", "0")
    assert jaxcache.ensure_compile_cache() is None
    assert updates == []


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke script exits non-zero and prints no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr

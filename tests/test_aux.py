"""Auxiliary subsystems: external byte sources, seeking, profiling, config,
logging."""

import logging
import os

import numpy as np

from dvda.api import DVDA, TrackReader
from dvda.config import DecodeConfig
from dvda.container.aob import AOBReader
from dvda.container.sources import (
    CallableSectorSource,
    FileSectorSource,
    SourceAOBReader,
)
from dvda.testutil.synth import PcmTrackSpec, build_disc
from dvda.utils.log import configure, logger
from dvda.utils.profiling import ByteCounter, StageTimer, trace


def _disc(tmp_path):
    return build_disc(str(tmp_path / "AUDIO_TS"),
                      [[PcmTrackSpec(pcm_frames=960, seed=1)]])


def test_file_sector_source_matches_aob(tmp_path):
    layout = _disc(tmp_path)
    aob = AOBReader(layout.path, 1)
    src = FileSectorSource(os.path.join(layout.path, "ATS_01_1.AOB"))
    reader = SourceAOBReader([src])
    assert reader.total_sectors == aob.total_sectors
    assert np.array_equal(reader.read_sectors(0, 5), aob.read_sectors(0, 5))


def test_callable_sector_source_decodes(tmp_path):
    """The func_io analog: a track decoded through user callbacks."""
    layout = _disc(tmp_path)
    path = os.path.join(layout.path, "ATS_01_1.AOB")
    blob = open(path, "rb").read()

    def read(first, count):
        return blob[first * 2048 : (first + count) * 2048]

    src = CallableSectorSource(len(blob) // 2048, read)
    reader = SourceAOBReader([src])
    dvda = DVDA(layout.path)
    track = dvda.open_titleset(1).open_title(1).open_track(1)
    via_cb = TrackReader(reader, track, use_device=False).read_all()
    via_fs = track.open_reader(use_device=False).read_all()
    assert np.array_equal(via_cb, via_fs)


def test_track_seek_tell(tmp_path):
    layout = _disc(tmp_path)
    r = (DVDA(layout.path).open_titleset(1).open_title(1)
         .open_track(1).open_reader(use_device=False))
    assert r.total_pcm_frames == 960
    r.seek(500)
    assert r.tell() == 500
    a = r.read(100)
    assert a.shape == (100, 2)
    r.seek(0)
    b = r.read_all()
    assert np.array_equal(b[500:600], a)
    assert r.seek(10_000) == 960


def test_stage_timer():
    t = StageTimer()
    with t.stage("x"):
        pass
    t.add("y", 0.5)
    s = t.summary()
    assert "x" in s and "y" in s
    t.reset()
    assert t.summary() == "(no stages recorded)"


def test_trace_noop():
    with trace("region"):
        pass


def test_byte_counter():
    c = ByteCounter()
    c(b"abc")
    c(b"de")
    assert c.count == 5


def test_config_env(monkeypatch):
    monkeypatch.setenv("DVDA_DISABLE_DEVICE", "1")
    monkeypatch.setenv("DVDA_DISABLE_NATIVE", "1")
    monkeypatch.setenv("DVDA_DISABLE_NATIVE_DEMUX", "1")
    monkeypatch.setenv("DVDA_MULTI_DEVICE", "1")
    cfg = DecodeConfig.from_env()
    assert not cfg.use_device and not cfg.use_native
    assert not cfg.use_native_demux and cfg.multi_device


def test_config_compile_cache_env(monkeypatch, tmp_path):
    """One rule: JAX_COMPILATION_CACHE_DIR when set, else the fixed
    <checkout>/.jaxcache; DVDA_COMPILE_CACHE=0 is the off switch and any
    other value is an error."""
    import pytest

    from dvda.config import DEFAULT_COMPILE_CACHE, env_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("DVDA_COMPILE_CACHE", raising=False)
    assert env_compile_cache() == DEFAULT_COMPILE_CACHE
    monkeypatch.setenv("DVDA_COMPILE_CACHE", "0")
    assert env_compile_cache() == ""
    monkeypatch.setenv("DVDA_COMPILE_CACHE", str(tmp_path / "cc"))
    with pytest.raises(ValueError, match="DVDA_COMPILE_CACHE"):
        env_compile_cache()
    monkeypatch.delenv("DVDA_COMPILE_CACHE")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jx"))
    assert env_compile_cache() == str(tmp_path / "jx")


def test_compile_cache_applied():
    # the ops package enables the cache at import; the helper is
    # idempotent and, without JAX_COMPILATION_CACHE_DIR, points JAX at
    # the checkout's fixed directory
    import jax

    from dvda import ops  # noqa: F401  (triggers ensure at import)
    from dvda.utils.jaxcache import ensure_compile_cache

    active = ensure_compile_cache()
    assert active == ensure_compile_cache()  # idempotent
    if active and not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        assert jax.config.jax_compilation_cache_dir == active


def test_config_chunk_chains_resolver():
    """chunk_chains is clamped to >=1 and scaled by 6/out_ch
    (rounded) so per-chunk byte volume matches the 6-channel shape the
    default was swept at — for any channel count, not just divisors of 6."""
    cfg = DecodeConfig()  # default 256, tuned at 6-ch
    assert cfg.resolved_chunk_chains(6) == 256
    assert cfg.resolved_chunk_chains(2) == 256 * 3  # stereo: 1/3 bytes/chain
    assert cfg.resolved_chunk_chains(1) == 256 * 6
    assert cfg.resolved_chunk_chains(8) == 192      # wider than tuned: fewer
    assert cfg.resolved_chunk_chains(4) == 384
    assert cfg.resolved_chunk_chains() == 256  # default = tuned shape
    # clamps: zero/negative chunk_chains or out_ch never break range()
    assert DecodeConfig(chunk_chains=0).resolved_chunk_chains(6) == 1
    assert DecodeConfig(chunk_chains=-4).resolved_chunk_chains(0) >= 1


def test_config_filter_unroll_resolver(caplog):
    """filter_unroll only applies to the scan kernel; with the triton
    kernel it resolves to 1 with a warning instead of being silently
    dropped in the dispatch chain."""
    assert DecodeConfig(filter_unroll=4).resolved_filter_unroll() == 4
    assert DecodeConfig(filter_unroll=0).resolved_filter_unroll() == 1
    cfg = DecodeConfig(filter_kernel="triton", filter_interpret=True,
                       filter_unroll=4)
    with caplog.at_level("WARNING", logger="dvda"):
        assert cfg.resolved_filter_unroll() == 1
    assert any("scan filter only" in r.message for r in caplog.records)


def test_config_device_huffman_env_strict(monkeypatch):
    """Unrecognized DVDA_DEVICE_HUFFMAN values raise instead of
    silently meaning auto (which could flip the decode mode away from
    what the operator pinned)."""
    import pytest

    monkeypatch.setenv("DVDA_DEVICE_HUFFMAN", "true")
    with pytest.raises(ValueError, match="DVDA_DEVICE_HUFFMAN"):
        DecodeConfig.from_env()


def test_config_device_huffman_auto(monkeypatch):
    """device_huffman=None resolves to the standard mode on every
    backend and host size (the GPU crossover is not measured), and an
    explicit bool always wins."""
    import jax

    assert DecodeConfig(device_huffman=True).resolved_device_huffman()
    assert not DecodeConfig(device_huffman=False).resolved_device_huffman()
    assert not DecodeConfig(use_device=False).resolved_device_huffman()
    assert jax.default_backend() == "cpu"
    assert not DecodeConfig().resolved_device_huffman()
    # no backend or core-count branch: a GPU backend on a small host
    # and several devices resolve the same way
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    assert not DecodeConfig().resolved_device_huffman()
    assert not DecodeConfig(multi_device=True).resolved_device_huffman()
    # env: explicit 1/0 force, unset = auto (None)
    monkeypatch.setenv("DVDA_DEVICE_HUFFMAN", "1")
    assert DecodeConfig.from_env().device_huffman is True
    monkeypatch.setenv("DVDA_DEVICE_HUFFMAN", "0")
    assert DecodeConfig.from_env().device_huffman is False
    monkeypatch.delenv("DVDA_DEVICE_HUFFMAN")
    assert DecodeConfig.from_env().device_huffman is None


def test_config_object_toggles_decode_paths(tmp_path):
    """An explicit DecodeConfig threaded from open_disc selects the decode
    path — all three engine tiers must agree bit-exactly."""
    import numpy as np

    import dvda
    from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream
    from dvda.testutil.synth import MlpTrackSpec, build_disc

    mlp = MlpSynthConfig(channel_assignment=1, n_frames=32, seed=5)
    build_disc(str(tmp_path / "AUDIO_TS"),
               [[MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                              pcm_frames=mlp.total_pcm_frames)]])

    def decode(cfg):
        disc = dvda.open_disc(str(tmp_path / "AUDIO_TS"), config=cfg)
        r = disc.open_titleset(1).open_title(1).open_track(1).open_reader()
        assert r.config is cfg
        return r.read_all()

    native = decode(DecodeConfig())
    py_dev = decode(DecodeConfig(use_native=False))
    host_only = decode(DecodeConfig(use_device=False, use_native=False,
                                    use_native_demux=False))
    assert np.array_equal(native, py_dev)
    assert np.array_equal(native, host_only)


def test_logging_configure():
    configure("DEBUG")
    assert logger.level == logging.DEBUG
    configure("WARNING")

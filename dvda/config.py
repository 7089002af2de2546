"""Pipeline configuration — the single place environment flags are parsed.

The reference's configuration is compile-time Makefile flags plus CLI
getopt options (SURVEY §5).  The rebuild uses one dataclass covering the
whole pipeline.  A :class:`DecodeConfig` can be passed explicitly to
``DVDA(...)`` / ``Track.open_reader`` / ``decode_mlp_track`` /
``decode_native``; where none is given, :func:`default_config` builds one
from the environment **at use time**, so env toggles keep working for
CLIs and benchmarks:

    =================================  ====================================
    env var                            effect
    =================================  ====================================
    ``DVDA_DISABLE_DEVICE=1``          host-only decode (numpy/Python spec)
    ``DVDA_DISABLE_NATIVE=1``          skip the C++ parser (Python planner)
    ``DVDA_DISABLE_NATIVE_DEMUX=1``    Python packet walk (differential
                                       testing of host/src/demux.cc)
    ``DVDA_DISABLE_NATIVE_PACK=1``     numpy arena assembly (differential
                                       testing of mp_pack)
    ``DVDA_DISABLE_DRAIN_THREAD=1``    end-of-stream batched drain
                                       (differential testing of the
                                       background drain thread)
    ``DVDA_MULTI_DEVICE=1``            round-robin chain chunks over all
                                       local devices (data parallelism)
    ``DVDA_DEVICE_HUFFMAN=1/0``        force on-device Huffman residual
                                       decode on/off (unset = auto: off —
                                       see ``resolved_device_huffman``)
    ``DVDA_HOST_COMPLETE=1/0``         force the host-complete executor
                                       (native filter + rematrix + pack; no
                                       device kernels) on/off (unset =
                                       auto: on when the device is disabled
                                       or the measured device link is
                                       slower than 1 GB/s — see
                                       ``resolved_host_complete``)
    ``DVDA_LINK_MBPS=<float>``         skip the d2h link probe and use this
                                       bandwidth for executor selection
                                       (operator override + test hook)
    ``DVDA_FILTER_KERNEL=name``        AR-filter kernel: ``triton`` (the
                                       GPU kernel, ops/triton_filter.py) or
                                       ``scan`` (lax.scan); unset = auto:
                                       ``triton`` on a GPU backend, else
                                       ``scan``
    ``DVDA_FILTER_UNROLL=N``           unroll of the scan filter's sample
                                       loop (default 1)
    ``DVDA_CHUNK_CHAINS=N``            restart chains per device chunk
                                       (default 256)
    ``DVDA_HUFFMAN_SPLIT=k``           device-Huffman sub-lane stride:
                                       decode every k-sample run as its own
                                       lane (default 0 = one lane per
                                       block, see the field docstring)
    ``DVDA_PARSE_THREADS=N``           native MLP parse worker threads (0 =
                                       auto: min(8, cpu_count); sections
                                       split at full-restart frames)
    ``DVDA_NARROW_D2H=1/0``            narrow readback of 24-bit streams
                                       on/off (unset = on)
    ``DVDA_LOG=<level>``               log level (utils/log.py)
    ``DVDA_COMPILE_CACHE=0``           disable the persistent XLA
                                       compilation cache at
                                       ``<checkout>/.jaxcache`` (used when
                                       ``JAX_COMPILATION_CACHE_DIR`` is
                                       unset) — process-global, applied by
                                       utils/jaxcache.py at first op import
    =================================  ====================================

No other module reads ``DVDA_*`` variables directly.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = ["DecodeConfig", "default_config", "env_log_level"]


def _env_off(name: str) -> bool:
    return os.environ.get(name, "0") != "1"


def _env_tristate(name: str) -> bool | None:
    """``1``/``0``/unset → True/False/None (auto).  Any other value is an
    error: silently mapping e.g. ``true`` to auto would flip the decode
    mode (and its compile/throughput profile) away from what the operator
    pinned, with nothing logged."""
    raw = os.environ.get(name, "")
    if raw in ("1", ""):
        return True if raw == "1" else None
    if raw == "0":
        return False
    raise ValueError(f"{name}={raw!r}: expected '1', '0', or unset (auto)")


@dataclass
class DecodeConfig:
    #: run the device (JAX) kernels; False = pure host decode
    use_device: bool = True
    #: use the native C++ host parser when available
    use_native: bool = True
    #: use the native C++ packet demux/assembler when available
    use_native_demux: bool = True
    #: round-robin independent chain chunks over all local devices
    multi_device: bool = False
    #: decode Huffman residuals on device from the raw bitstream (the host
    #: parse then walks residual bits length-only — see ops/huffman_decode).
    #: None = auto (resolved_device_huffman)
    device_huffman: bool | None = None
    #: assemble device arenas in the native runtime (mp_pack) instead of
    #: numpy — same arenas/spec, less host staging time
    native_pack: bool = True
    #: AR-filter kernel: "triton" (the GPU kernel, ops/triton_filter.py)
    #: or "scan" (lax.scan, ops/mlp_filter.py).  None = auto: "triton" on
    #: a GPU backend, "scan" elsewhere (resolved_filter_kernel)
    filter_kernel: str | None = None
    #: run the "triton" kernel in the Pallas interpreter — on any backend,
    #: slowly; for tests.  Never chosen implicitly
    filter_interpret: bool = False
    #: unroll factor of the "scan" filter's sample loop (it multiplies the
    #: per-geometry first compile; default 1)
    filter_unroll: int = 1
    #: restart chains per dispatched device chunk **at 6-channel output**
    #: (swept on the previous accelerator; not yet on the H100); the resolver
    #: scales it inversely with the stream's channel count so chunk byte
    #: volume — and with it the dispatch-count/readback-overlap balance —
    #: stays constant across channel widths (a stereo chunk carries 1/3
    #: the bytes of a 5.1 chunk, so it gets 3× the chains rather than 3×
    #: the per-chunk fixed dispatch cost).  Smaller chunks start their
    #: d2h readback earlier at the cost of more dispatches
    chunk_chains: int = 256
    #: host parse threads: >1 splits the MLP stream at full-restart frames
    #: (parser state-reset points) and parses sections concurrently in the
    #: native runtime — the host-parse scaling axis on multi-core hosts
    #: (bit-identical output; see host/src/mlp_parse.cc).  0 = auto:
    #: min(8, cpu_count), i.e. 1 (sequential) on single-core hosts
    parse_threads: int = 0

    def resolved_parse_threads(self) -> int:
        if self.parse_threads > 0:
            return self.parse_threads
        return min(8, os.cpu_count() or 1)  # <=0 (incl. negatives) = auto

    def resolved_device_huffman(self) -> bool:
        """Mode selection for on-device Huffman residual decode.

        Both modes are bit-exact; they trade host parse cost against
        device compute: the skip-values parse is cheaper on the host,
        the device-Huffman chunk program dearer on the device.  Where
        the crossover lies on a GPU host has not been measured, so auto
        resolves to the standard mode on every backend."""
        if self.device_huffman is not None:
            return self.device_huffman
        return False

    def resolved_filter_kernel(self) -> str:
        """The AR-filter kernel the chunk program runs: ``"scan"``,
        ``"triton"`` or ``"triton-interpret"``.  Auto picks the kernel on
        a GPU backend and the scan elsewhere; asking for the kernel on a
        non-GPU backend without ``filter_interpret`` raises."""
        kernel = self.filter_kernel
        if kernel not in (None, "scan", "triton"):
            raise ValueError(f"filter_kernel={kernel!r}: expected 'scan', "
                             "'triton' or None (auto)")
        if kernel == "scan":
            return "scan"
        if self.filter_interpret:
            return "triton-interpret"
        import jax

        backend = jax.default_backend()
        if backend == "gpu":
            return "triton"
        if kernel is None:
            return "scan"
        raise ValueError(
            f"filter_kernel='triton' needs a GPU backend (default backend "
            f"is {backend!r}); use 'scan', or set filter_interpret=True")

    def resolved_filter_unroll(self) -> int:
        """``filter_unroll`` clamped to >=1.  The unroll knob belongs to
        the lax.scan filter only; the kernel carries its full time
        recursion in-kernel and has no unroll axis, so combining the two
        warns instead of silently dropping the knob an operator believes
        is active."""
        unroll = max(1, self.filter_unroll)
        if unroll > 1 and self.resolved_filter_kernel() != "scan":
            from .utils.log import logger

            logger.warning(
                "filter_unroll=%d applies to the scan filter only; the "
                "triton kernel has no unroll axis", unroll)
            return 1
        return unroll

    def resolved_chunk_chains(self, out_ch: int = 6) -> int:
        """``chunk_chains`` clamped to >=1 (a zero/negative value — env
        typo or programmatic — would make ``range(0, n, CHUNK)`` raise or
        build zero-sized arenas), then scaled by ``6/out_ch``
        (rounded) so per-chunk byte volume matches the 6-channel shape
        the default was swept at, for any channel count — more chains for
        narrow streams, fewer for 7/8-channel ones (decode output is
        bit-identical for any chunk size — test_chunk_chains_invariance)."""
        return max(1, round(max(1, self.chunk_chains) * 6 / max(1, out_ch)))

    #: host-complete decode: reconstruct PCM (filter + rematrix + output +
    #: pack) entirely in the native runtime (mp_reconstruct) instead of
    #: dispatching device kernels — the right executor when no accelerator
    #: is attached or the device link is slower than host compute (both
    #: executors consume the same parse and emit identical bytes).  None =
    #: auto: on when ``use_device`` is False (replacing the pure-Python
    #: spec as the host-only production path), and otherwise selected by
    #: measured link speed (``measured_link_MBps``): links under
    #: ``_LINK_THRESHOLD_MBPS`` get host-complete; PCIe-attached devices
    #: keep the device pipeline.  ``DVDA_LINK_MBPS`` overrides the probe
    host_complete: bool | None = None

    def resolved_host_complete(self) -> bool:
        if self.host_complete is not None:
            return self.host_complete
        if not self.use_device:
            return True
        # measured link speed, not a platform-name sniff: a directly
        # attached device under any platform string keeps the device
        # pipeline; any remote/slow link gets host-complete
        mbps = measured_link_MBps()
        if mbps is None:  # probe failed (logged): host path always works
            return True
        return mbps < _LINK_THRESHOLD_MBPS

    #: device-Huffman sub-lane stride: the skip-values parser emits every
    #: k-th sample's bit offset so the residual kernel decodes each
    #: k-sample run as an independent lane (k·J scan steps instead of
    #: S0·J).  0 = no split (one lane per block, the default; it also
    #: keeps the parse's bitpos tables at one entry per block); k>0 is
    #: for streams with very large blocks (S0 ≫ 64), where the S0-step
    #: scan could dominate.  The best k on the H100 is not measured.
    huffman_split: int = 0

    def resolved_huffman_split(self) -> int:
        return min(255, max(0, self.huffman_split))
    #: narrow d2h readback for 24-bit streams: the chunk program also
    #: emits an int16-packed copy of the output plus an on-device
    #: "fits in int16" flag; the host drains the half-size buffer and
    #: widens to 24-bit during assembly, falling back to the full-width
    #: buffer per chunk when any sample exceeds int16 (lossless either
    #: way).  Halves readback bytes whenever the audio's true dynamic
    #: range fits 16 bits.  None = auto (on).
    narrow_d2h: bool | None = None

    def resolved_narrow_d2h(self) -> bool:
        return True if self.narrow_d2h is None else self.narrow_d2h
    #: drain dispatched device chunks on a background thread, overlapping
    #: the d2h readback with parse/dispatch of later chunks (round 5: the
    #: round-4 end-of-stream batched drain serialized the whole readback
    #: AFTER the dispatch loop — d2h is the dominant e2e cost through a
    #: slow link, so the lost overlap halved device-path throughput).
    #: The ctypes parse calls release the GIL, so the reader thread and
    #: the native parser genuinely run concurrently.  False = the
    #: end-of-stream batched drain (differential testing)
    drain_thread: bool = True
    #: sectors per host I/O batch when walking a track
    io_batch_sectors: int = 4096
    #: decrypt CPPM-protected sectors when a device/MKB is available
    decrypt: bool = True
    #: keep CCI copy-control bytes instead of zeroing them (cppm)
    preserve_cci: bool = False

    @classmethod
    def from_env(cls) -> "DecodeConfig":
        return cls(
            use_device=_env_off("DVDA_DISABLE_DEVICE"),
            use_native=_env_off("DVDA_DISABLE_NATIVE"),
            use_native_demux=_env_off("DVDA_DISABLE_NATIVE_DEMUX"),
            multi_device=not _env_off("DVDA_MULTI_DEVICE"),
            native_pack=_env_off("DVDA_DISABLE_NATIVE_PACK"),
            device_huffman=_env_tristate("DVDA_DEVICE_HUFFMAN"),
            filter_kernel=os.environ.get("DVDA_FILTER_KERNEL") or None,
            filter_unroll=int(os.environ.get("DVDA_FILTER_UNROLL",
                                             "1")),
            chunk_chains=int(os.environ.get("DVDA_CHUNK_CHAINS", "256")),
            parse_threads=int(os.environ.get("DVDA_PARSE_THREADS", "0")),
            huffman_split=int(os.environ.get("DVDA_HUFFMAN_SPLIT", "0")),
            narrow_d2h=_env_tristate("DVDA_NARROW_D2H"),
            host_complete=_env_tristate("DVDA_HOST_COMPLETE"),
            drain_thread=_env_off("DVDA_DISABLE_DRAIN_THREAD"),
        )


#: device-link speed below which host-complete wins (MB/s).  On a slow
#: (networked) link the output drain of one second of 5.1/96k/24 audio
#: (1.728 MB) costs more than reconstructing it on the host; a PCIe-
#: attached GPU sits orders of magnitude above this line.  The crossover
#: on the H100 host is not measured (ROADMAP A4).
_LINK_THRESHOLD_MBPS = 1000.0

_link_probe_cache: dict = {}


def measured_link_MBps() -> float | None:
    """Measured d2h bandwidth (MB/s) of the default JAX device, probed
    once per process with an 8 MB readback (includes the per-call fixed
    cost, as real drains do).  ``DVDA_LINK_MBPS=<float>`` skips the
    probe — the operator override and the executor-selection test hook.
    ``None`` when no device backend is usable (callers treat that as
    "no usable link")."""
    override = os.environ.get("DVDA_LINK_MBPS", "")
    if override:
        return float(override)
    if "value" in _link_probe_cache:
        return _link_probe_cache["value"]
    try:
        import numpy as np

        import jax
        import jax.numpy as jnp

        mb = 8
        dev = jax.block_until_ready(
            jax.jit(lambda x: x + 1)(jnp.zeros(mb << 20, jnp.uint8)))
        best = None
        for _ in range(2):
            import time

            t0 = time.perf_counter()
            np.asarray(dev)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
            dev = jax.block_until_ready(dev + 1)
        value = mb / best
        _link_probe_cache["value"] = value
    except Exception as exc:
        # do NOT cache the failure: a transient backend hiccup at first
        # use would otherwise pin a fast-linked host to host-complete for
        # the whole process lifetime — retry the probe on the next call
        from .utils.log import logger

        logger.warning("device link probe failed (%s: %s); decoding with "
                       "the host-complete executor", type(exc).__name__, exc)
        value = None
    return value


def default_config() -> DecodeConfig:
    """The environment-derived config, evaluated at call time (cheap)."""
    return DecodeConfig.from_env()


def env_log_level(default: str = "WARNING") -> str:
    """Log level from ``DVDA_LOG`` (consumed by utils/log.py)."""
    return os.environ.get("DVDA_LOG", default)


#: the default persistent compilation cache: fixed, inside the checkout
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jaxcache")


def env_compile_cache() -> str:
    """Persistent-compilation-cache directory (consumed by
    utils/jaxcache.py).  Process-global JAX state rather than per-decode,
    hence env-only: ``JAX_COMPILATION_CACHE_DIR`` when set, else
    :data:`DEFAULT_COMPILE_CACHE`; ``DVDA_COMPILE_CACHE=0`` → disabled
    (empty string)."""
    jax_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR", "")
    if jax_dir:
        return jax_dir
    raw = os.environ.get("DVDA_COMPILE_CACHE", "")
    if raw == "0":
        return ""
    if raw:
        raise ValueError(f"DVDA_COMPILE_CACHE={raw!r}: only '0' (off) is "
                         "accepted; set JAX_COMPILATION_CACHE_DIR to move "
                         "the cache")
    return DEFAULT_COMPILE_CACHE

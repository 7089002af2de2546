#!/usr/bin/env python
"""Smoke run of the disc → WAV decode on one NVIDIA GPU.

Usage::

    python chip_smoke.py [--seed N] [--seconds S]
    python chip_smoke.py --multi          # four GPUs of one host

Synthesises a DVD-Audio disc from ``--seed`` (an MLP 5.1 / 96 kHz / 24-bit
track of ``--seconds``, default 182, an MLP stereo 96 kHz track and a PCM
24-bit / 192 kHz stereo track), decodes it through ``dvda2wav`` with the
default configuration, and checks, exactly (integer PCM, tolerance 0):

* the MLP tracks ran the chunk program on the GPU;
* the 5.1 WAV bytes equal the host-complete executor's, the device-Huffman
  mode's and, on a 2 s prefix, the pure-Python spec decoder's;
* the stereo MLP and PCM tracks equal their host decodes;
* the triton AR-filter kernel equals the lax.scan filter on real chunk
  inputs at 1 536 and 2 048 lanes (and times both);
* the off-path device ops (C2 decrypt, PCM unpack) equal their host specs;
* the tests marked ``gpu`` pass.

Each phase prints one line; numbers carry the card's name and power limit.
The last line is a JSON object naming the device.  Any failure exits
non-zero without that line; so does a machine where JAX finds no GPU.

``--multi`` runs only the multi-device decode (chain chunks round-robined
over every local GPU, ``DecodeConfig.multi_device``) and compares its
bytes with the one-device decode.
"""

import argparse
import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
RATE = 96000
PREFIX_S = 2      # the 5.1 track's first segment: the spec-parity prefix
SEGMENT_S = 30    # the rest of the 5.1 track is joined from such segments
STEREO_S = 20
PCM_S = 10
REPS = 25         # timed calls per filter, alternating


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    """``name, power limit`` of the first GPU, from nvidia-smi (a child
    process that never touches JAX)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0 and proc.stdout.strip(),
          f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


class Report:
    def __init__(self):
        self.card = ""

    def line(self, phase: str, msg: str) -> None:
        print(f"[{phase}] {msg}  [{self.card}]", flush=True)


# ------------------------------------------------------------- synthesis

def _synth(kind: str, seconds: int, seed: int) -> bytes:
    """One seeded MLP stream at the bench's headline shape (blocks of 40
    samples, 2 blocks per frame, restart and major sync every 8 frames).
    Runs in a worker process; imports no JAX device code."""
    sys.path.insert(0, REPO)
    from dvda.cli.bench import _mlp_cfg
    from dvda.testutil.mlp_synth import synth_mlp_stream

    assignment, nsub = {"mlp51": (17, 2), "stereo": (1, 1)}[kind]
    return synth_mlp_stream(_mlp_cfg(seconds, assignment, nsub, seed=seed))


def synth_disc(root: str, seed: int, seconds: int, with_extra: bool = True):
    """Write the disc; returns (audio_ts, track seconds, prefix stream).

    The 5.1 track joins seeded segments, each starting with a major sync
    and a restart, so the stream is valid across the joins; the first
    segment is PREFIX_S long and doubles as the spec-parity prefix."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    from dvda.testutil.synth import MlpTrackSpec, PcmTrackSpec, build_disc

    n = max(1, math.ceil((seconds - PREFIX_S) / SEGMENT_S))
    segs = [PREFIX_S] + [SEGMENT_S] * n
    jobs = [("mlp51", s, seed + i) for i, s in enumerate(segs)]
    if with_extra:
        jobs.append(("stereo", STEREO_S, seed + 100))
    workers = min(len(jobs), os.cpu_count() or 1)
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        streams = list(ex.map(_synth, *zip(*jobs)))
    mlp51 = b"".join(streams[:len(segs)])
    total = sum(segs)
    tracks = [MlpTrackSpec(mlp_stream=mlp51, pcm_frames=total * RATE,
                           sample_rate=RATE, channel_assignment=17)]
    secs = [total]
    if with_extra:
        tracks.append(MlpTrackSpec(mlp_stream=streams[-1],
                                   pcm_frames=STEREO_S * RATE,
                                   sample_rate=RATE, channel_assignment=1))
        tracks.append(PcmTrackSpec(pcm_frames=PCM_S * 192000,
                                   sample_rate=192000, bits_per_sample=24,
                                   channel_assignment=1, seed=seed + 200))
        secs += [STEREO_S, PCM_S]
    layout = build_disc(os.path.join(root, "AUDIO_TS"), [tracks])
    return layout.path, secs, streams[0]


# ----------------------------------------------------------- main path

class ChunkRecorder:
    """Wraps the chunk program to record where each chunk ran and which
    arenas it got (the smoke's instrumentation, not the library's)."""

    def __init__(self, ne):
        self.ne = ne
        self.orig = ne._uniform_arena_pipeline
        self.devices = []
        self.specs = []
        self.args = []

    def __call__(self, a4, a2, a1, spec, words=None):
        out = self.orig(a4, a2, a1, spec, words)
        self.devices.append(out.devices())
        self.specs.append(spec)
        if len(self.args) < 2:
            self.args.append((a4, a2, a1, spec, words))
        return out

    def __enter__(self):
        self.ne._uniform_arena_pipeline = self
        return self

    def __exit__(self, *exc):
        self.ne._uniform_arena_pipeline = self.orig

    def reset(self):
        self.devices.clear()
        self.specs.clear()


@contextlib.contextmanager
def env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dvda2wav(audio_ts: str, track: int, out_dir: str, *extra) -> tuple:
    """Decode one track through the CLI entry point; returns (seconds,
    WAV bytes)."""
    from dvda.cli import dvda2wav as cli

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["-A", audio_ts, "-T", "1", "-t", str(track),
                       "-d", out_dir, *extra])
    dt = time.perf_counter() - t0
    check(rc == 0, f"dvda2wav exited {rc} on track {track}")
    path = os.path.join(out_dir, f"track-01-{track:02d}.wav")
    with open(path, "rb") as fh:
        return dt, fh.read()


def wav_data(wav: bytes) -> bytes:
    i = wav.find(b"data")
    check(i >= 0, "WAV file has no data chunk")
    return wav[i + 8:]


def decode_main_path(rep, rec, audio_ts, secs, work):
    """Phase 4: every track through dvda2wav with the default config."""
    from dvda.utils.profiling import global_timer

    wavs, rates = {}, []
    for track, audio in enumerate(secs, start=1):
        times = []
        for _ in range(2):  # cold (compiles) then warm
            global_timer.reset()
            rec.reset()
            dt, wavs[track] = dvda2wav(audio_ts, track,
                                       os.path.join(work, "out"))
            times.append(dt)
        cold, warm = times
        if track <= 2:  # the MLP tracks must have run the chunk program
            counts = global_timer.counts
            check("mlp/host-recon" not in counts,
                  f"track {track} decoded with the host-complete executor "
                  "(auto selection chose it on this host); the device "
                  "chunk program did not run")
            check(counts.get("mlp/jit-call", 0) > 0,
                  f"track {track}: no chunk program was dispatched")
            platforms = {d.platform for ds in rec.devices for d in ds}
            check(platforms == {"gpu"},
                  f"track {track}: chunk outputs on {platforms}")
            n_chunks = counts["mlp/jit-call"]
        else:
            n_chunks = 0
        rates.append(f"track {track} ({audio} s) {audio / warm:.1f}x "
                     f"realtime, first call {cold - warm:.2f} s longer"
                     + (f", {n_chunks} chunks on the GPU" if n_chunks
                        else ""))
    rep.line("main", "dvda2wav warm: " + "; ".join(rates))
    return wavs


def parity(rep, rec, audio_ts, secs, work, wavs, prefix, params51):
    """Phase 5: exact byte parity of the GPU decode."""
    import numpy as np

    from dvda.codecs.mlp.spec import MlpDecoder

    gpu51 = wav_data(wavs[1])
    with env(DVDA_HOST_COMPLETE=1):
        _, hc = dvda2wav(audio_ts, 1, os.path.join(work, "out"))
    check(wav_data(hc) == gpu51,
          "5.1: GPU bytes differ from the host-complete executor's")

    dec = MlpDecoder(params51)
    dec.decode_bytes(prefix)
    ref = dec.take_frames().astype(np.int32)
    packed = ((ref[..., None] >> np.array([0, 8, 16])) & 0xFF).astype(
        np.uint8).tobytes()
    check(len(packed) > 0 and gpu51[:len(packed)] == packed,
          "5.1: GPU bytes differ from spec.py on the prefix")

    rec.reset()
    with env(DVDA_DEVICE_HUFFMAN=1, DVDA_HOST_COMPLETE=0):
        _, dh = dvda2wav(audio_ts, 1, os.path.join(work, "out"))
    check(any(e[0].endswith("_bitpos") for s in rec.specs for e in s),
          "device-Huffman mode did not reach the chunk program")
    check(wav_data(dh) == gpu51, "5.1: device-Huffman bytes differ")

    for track in range(2, len(secs) + 1):
        _, host_wav = dvda2wav(audio_ts, track, os.path.join(work, "out"),
                               "--no-device")
        check(host_wav == wavs[track],
              f"track {track}: GPU bytes differ from the host decode")
    rep.line("parity", f"5.1 ({len(gpu51)} bytes) == host-complete, "
             f"== device-Huffman, == spec.py on the {len(ref)}-frame "
             f"prefix; tracks 2..{len(secs)} == host decode")


# ------------------------------------------------------------- filter

class _Captured(Exception):
    pass


def filter_inputs(ne, chunk_args):
    """The AR filter's inputs inside one real chunk program: run the
    program eagerly up to the filter call and take its arguments."""
    import jax

    from dvda.ops import mlp_filter

    a4, a2, a1, spec, words = chunk_args
    spec = tuple(e for e in spec if e[0] != "__triton__")
    orig = mlp_filter.mlp_filter_blocks_tl

    def grab(*args):
        raise _Captured(args[:8])

    mlp_filter.mlp_filter_blocks_tl = grab
    try:
        with jax.disable_jit():
            ne._uniform_arena_pipeline(a4, a2, a1, spec, words)
    except _Captured as got:
        return tuple(jax.device_put(x) for x in got.args[0])
    finally:
        mlp_filter.mlp_filter_blocks_tl = orig
    raise SmokeError("the chunk program never called the filter")


def lanes(args8, a, b):
    """Lanes [a, b) of filter inputs (residuals are [NB, S, B])."""
    return (args8[0][:, :, a:b],) + tuple(x[a:b] for x in args8[1:])


def alternate(fns, reps=None):
    """Median seconds per call of each function, called in turns."""
    import jax

    reps = reps or REPS
    for f in fns.values():
        jax.block_until_ready(f())
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, f in fns.items():
            t0 = time.perf_counter()
            jax.block_until_ready(f())
            times[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) for k, v in times.items()}


def filter_phase(rep, ne, rec_args, audio_ts, secs, work, wav_ref):
    """Phase 6: the triton kernel against the scan on real chunk inputs,
    then the 5.1 track end to end with each filter."""
    import jax
    import jax.numpy as jnp

    from dvda.ops.mlp_filter import mlp_filter_blocks_tl
    from dvda.ops.triton_filter import mlp_filter_blocks_triton

    check(len(rec_args) >= 2, "need two 5.1 chunks for the 2048-lane case")
    per_chunk = [filter_inputs(ne, a) for a in rec_args[:2]]
    both = tuple(jnp.concatenate([x, y], axis=2 if i == 0 else 0)
                 for i, (x, y) in enumerate(zip(*per_chunk)))
    msgs = []
    for n_lanes in (1536, 2048):
        args8 = lanes(both, 0, n_lanes)
        check(args8[0].shape[2] == n_lanes, f"only {args8[0].shape[2]} lanes")
        zero = jnp.zeros((n_lanes, 8), jnp.int32)
        scan = jax.jit(lambda *a: mlp_filter_blocks_tl(*a, zero, zero)[0])
        kern = jax.jit(lambda *a: mlp_filter_blocks_triton(*a))
        check(bool(jnp.array_equal(scan(*args8), kern(*args8))),
              f"triton kernel differs from the scan at {n_lanes} lanes")
        t = alternate({"scan": lambda: scan(*args8),
                       "triton": lambda: kern(*args8)})
        NB, S, _ = args8[0].shape
        msgs.append(f"{n_lanes} lanes x {NB}x{S}: scan "
                    f"{t['scan'] * 1e3:.3f} ms, triton "
                    f"{t['triton'] * 1e3:.3f} ms (bit-equal)")

    # the whole chunk program with each filter
    a4, a2, a1, spec, words = rec_args[0]
    spec_scan = tuple(e for e in spec if e[0] != "__triton__")
    spec_kern = spec_scan + (("__triton__", 0, 0, (), "flag"),)
    prog = ne._uniform_arena_pipeline
    t = alternate({"scan": lambda: prog(a4, a2, a1, spec_scan, words),
                   "triton": lambda: prog(a4, a2, a1, spec_kern, words)})
    msgs.append(f"chunk program: scan {t['scan'] * 1e3:.3f} ms, triton "
                f"{t['triton'] * 1e3:.3f} ms")
    rep.line("filter", "; ".join(msgs))

    # end to end, alternating; the first round compiles the scan program
    e2e = {"scan": [], "triton": []}
    for rnd in range(4):
        for kernel in ("scan", "triton"):
            with env(DVDA_FILTER_KERNEL=kernel):
                dt, wav = dvda2wav(audio_ts, 1, os.path.join(work, "out"))
            check(wav == wav_ref, f"5.1 bytes differ with the {kernel} filter")
            if rnd:
                e2e[kernel].append(dt)
    med = {k: statistics.median(v) for k, v in e2e.items()}
    rep.line("filter-e2e", f"5.1 track ({secs[0]} s) end to end, median of "
             f"3: scan {secs[0] / med['scan']:.1f}x realtime "
             f"({med['scan']:.3f} s), triton "
             f"{secs[0] / med['triton']:.1f}x realtime "
             f"({med['triton']:.3f} s)")


# ---------------------------------------------------------- off-path

def offpath_phase(rep, seed):
    """Phase 7: C2 D-CBC on the device vs cppm/c2.py; PCM unpack on the
    device vs numpy."""
    import jax.numpy as jnp
    import numpy as np

    from dvda.codecs.pcm import chunk_size, decode_chunks_numpy
    from dvda.cppm.c2 import c2_dcbc_dec_batch
    from dvda.cppm.decrypt import _c2_g_vec
    from dvda.ops.c2_decrypt import dcbc_dec_device
    from dvda.ops.pcm_unpack import decode_chunks_device

    rng = np.random.default_rng(seed)
    n, w = 4096, 240
    words = rng.integers(0, 2**32, (n, w, 2), dtype=np.uint64).astype(
        np.uint32)
    fields = rng.integers(0, 2**32, (n, 5, 2), dtype=np.uint64).astype(
        np.uint32)
    k_au = int(rng.integers(0, 2**56, dtype=np.uint64))
    kau = np.array([k_au >> 32, k_au & 0xFFFFFFFF], np.uint32)
    t0 = time.perf_counter()
    dev = np.asarray(dcbc_dec_device(jnp.asarray(words), jnp.asarray(fields),
                                     jnp.asarray(kau)))
    t_dev = time.perf_counter() - t0
    f64 = (fields[..., 0].astype(np.uint64) << np.uint64(32)) \
        | fields[..., 1].astype(np.uint64)
    m56 = np.uint64((1 << 56) - 1)
    keys = np.full(n, np.uint64(k_au), np.uint64)
    for i in range(5):
        keys = _c2_g_vec(f64[:, i], keys) & m56
    hi, lo = words[..., 0].copy(), words[..., 1].copy()
    c2_dcbc_dec_batch(hi, lo, keys, w)
    check(np.array_equal(dev[..., 0], hi) and np.array_equal(dev[..., 1], lo),
          "device C2 D-CBC differs from cppm/c2.py")

    results = []
    for bits, ch in ((16, 2), (24, 2), (24, 6), (20, 6)):
        chunks = rng.integers(0, 256, (8192, chunk_size(bits, ch)),
                              dtype=np.uint8)
        ref = decode_chunks_numpy(chunks, bits, ch)
        got = np.asarray(decode_chunks_device(chunks, bits, ch))
        check(np.array_equal(ref, got),
              f"device PCM unpack differs from numpy ({bits} bit, {ch} ch)")
        results.append(f"{bits}b/{ch}ch")
    rep.line("offpath", f"C2 D-CBC {n} sectors == cppm/c2.py (first call "
             f"incl. compile {t_dev:.2f} s); PCM unpack == numpy for "
             + ", ".join(results))


# ------------------------------------------------------------ memory

def memory_phase(rep, ne, chunk_args):
    import jax

    a4, a2, a1, spec, words = chunk_args
    mem = ne._uniform_arena_pipeline.lower(a4, a2, a1, spec,
                                           words).compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    parts = [f"{f[:-len('_size_in_bytes')]} {getattr(mem, f, None)}"
             for f in fields]
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    rep.line("memory", "chunk program: " + ", ".join(parts)
             + f" bytes; device peak_bytes_in_use {peak}")


# ------------------------------------------------------------- tests

class _Counts:
    def __init__(self):
        self.passed = self.failed = self.skipped = 0
        self.errors = []

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed += 1
            self.errors.append(f"{report.nodeid}: {report.longreprtext}")
        elif report.skipped:
            self.skipped += 1
        elif report.when == "call":
            self.passed += 1


def gpu_tests_phase(rep):
    """Phase: the tests marked ``gpu``, in this process (it owns the
    card; a second process could not reserve it)."""
    import pytest

    counts = _Counts()
    rc = pytest.main(["-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:terminal", os.path.join(REPO, "tests")],
                     plugins=[counts])
    check(rc == 0 and counts.failed == 0 and counts.skipped == 0
          and counts.passed > 0,
          f"gpu tests: rc {rc}, {counts.passed} passed, {counts.failed} "
          f"failed, {counts.skipped} skipped\n"
          + "\n".join(counts.errors)[-4000:])
    rep.line("gpu-tests", f"{counts.passed} tests marked gpu passed")


# -------------------------------------------------------------- main

def stream_params51():
    from dvda.codecs.params import StreamParameters
    from dvda.testutil.synth import BPS_CODE, RATE_CODE

    return StreamParameters(BPS_CODE[24], 0xF, RATE_CODE[RATE], 0xF, 17)


def run(args, rep) -> int:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (devices: {devs}); this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    want = 4 if args.multi else 1
    check(len(devs) >= want, f"need {want} GPUs, JAX sees {len(devs)}")
    rep.card = card_line()
    rep.line("device", f"jax {jax.__version__}; {len(devs)} device(s): "
             f"{[str(d) for d in devs]}; kind {devs[0].device_kind}")

    sys.path.insert(0, REPO)
    from dvda import host
    from dvda.codecs.mlp import native_engine as ne

    t0 = time.perf_counter()
    check(host.available(), f"native runtime unavailable: {host._load_error}")
    rep.line("native", f"libdvda_host ready in {time.perf_counter() - t0:.1f}"
             f" s ({os.path.relpath(host.library_path(), REPO)})")

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as work:
        t0 = time.perf_counter()
        audio_ts, secs, prefix = synth_disc(work, args.seed, args.seconds,
                                            with_extra=not args.multi)
        rep.line("synth", f"disc from seed {args.seed}: tracks of "
                 f"{secs} s (5.1 = {PREFIX_S} s prefix + "
                 f"{(secs[0] - PREFIX_S) // SEGMENT_S} x {SEGMENT_S} s "
                 f"segments) in {time.perf_counter() - t0:.1f} s")

        if args.multi:
            return multi(rep, ne, audio_ts, secs, work, len(devs))

        with ChunkRecorder(ne) as rec:
            wavs = decode_main_path(rep, rec, audio_ts, secs, work)
            chunk_args = list(rec.args)  # the 5.1 track's first chunks
            parity(rep, rec, audio_ts, secs, work, wavs, prefix,
                   stream_params51())
        filter_phase(rep, ne, chunk_args, audio_ts, secs, work, wavs[1])
        offpath_phase(rep, args.seed)
        gpu_tests_phase(rep)
        memory_phase(rep, ne, chunk_args[0])
    return 0


def devs0_id() -> int:
    import jax

    return jax.devices()[0].id


def multi(rep, ne, audio_ts, secs, work, n_dev) -> int:
    out = os.path.join(work, "out")
    with ChunkRecorder(ne) as rec:
        dvda2wav(audio_ts, 1, out)  # compile
        rec.reset()
        t1, one = dvda2wav(audio_ts, 1, out)
        check({d.id for ds in rec.devices for d in ds} == {devs0_id()},
              "the one-device decode ran off the default device")
        with env(DVDA_MULTI_DEVICE=1):
            dvda2wav(audio_ts, 1, out)
            rec.reset()
            tn, many = dvda2wav(audio_ts, 1, out)
    check(many == one, "multi-device bytes differ from the one-device decode")
    per_dev = {}
    for ds in rec.devices:
        for d in ds:
            per_dev[d.id] = per_dev.get(d.id, 0) + 1
    check(len(per_dev) == n_dev and all(per_dev.values()),
          f"chunks per device {per_dev}: not every card received chunks")
    rep.line("multi", f"5.1 track ({secs[0]} s) on {n_dev} GPUs == 1 GPU "
             f"byte for byte; chunks per device {per_dev}; 1 GPU "
             f"{secs[0] / t1:.1f}x realtime, {n_dev} GPUs "
             f"{secs[0] / tn:.1f}x realtime")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=int, default=182,
                   help="length of the 5.1 track (>= 60)")
    p.add_argument("--multi", action="store_true",
                   help="only the multi-device decode, on four GPUs")
    args = p.parse_args(argv)
    if args.seconds < 60:
        p.error("--seconds must be at least 60")
    rep = Report()
    rc = run(args, rep)
    if rc:
        return rc
    import jax

    d = jax.devices()
    print(f"card: {rep.card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Production MLP decode path: native parse → one fused device pipeline.

The native host library (dvda/host, C++) parses the assembled track
stream in one pass — framing, parameter state machine, Huffman residuals,
noise.  The host side then only builds *small index tables* (chain →
block-range maps, per-sample series indices, frame offsets); all heavy
data movement — packing blocks into chain×channel filter lanes, gathering
per-channel series, slicing frames, noise/bypassed expansion — happens
**inside a single jitted program** via ``jnp.take`` on the raw parse
arrays, so the host never materialises the big intermediates:

    per substream: lane-pack (take) → filter (batched AR scan)
      → per-channel series gather
    → frame gather → rematrix (6 masked matrix applications)
    → output shifts + WAVE permutation → [T, C_out] flatten

Shapes are bucketed to powers of two so XLA programs are reused across
tracks.

Reference-semantics notes:

* the *packet-boundary cut* reproduces dvda_read's termination on a packet
  that completes zero frames (dvd-audio.c:766-775): frames are kept up to
  the first post-probe packet interval containing no frame end;
* chain construction matches the Python engine: restart segments merge
  when the first post-restart block uses FIR taps (the reference carries
  FIR state across restarts, see spec.py).

Returns ``None`` when the native library is unavailable or reports a
construct outside the fast path; callers fall back to the Python engines.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ... import host
from ...config import DecodeConfig, default_config
from ..params import WAVE_CHANNEL, StreamParameters
from ...utils.profiling import global_timer

__all__ = ["decode_native"]


def _bucket(n: int, lo: int = 8) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def _frame_cut(frame_end: np.ndarray, boundaries: np.ndarray, probe_end: int) -> int:
    """Number of frames to keep under the zero-frame-packet rule."""
    if boundaries.size == 0:
        return frame_end.shape[0]
    marks = np.concatenate([[probe_end], boundaries])
    idx = np.searchsorted(frame_end, marks, side="right")
    per_packet = np.diff(idx)
    zero = np.nonzero(per_packet == 0)[0]
    if zero.size == 0:
        return frame_end.shape[0]
    return int(idx[zero[0]])


def _padded_residuals(sub, nb_keep: int, S: int) -> np.ndarray:
    """Ragged (block, ch, sample) residuals → [nb_keep, n_ch, S]."""
    lens = sub["len"][:nb_keep]
    n_ch = sub["shift"].shape[1]
    rows = np.repeat(lens, n_ch)
    total = int(rows.sum())
    out = np.zeros((nb_keep * n_ch, S), dtype=np.int32)
    mask = np.arange(S)[None, :] < rows[:, None]
    out[mask] = sub["residuals"][:total]
    return out.reshape(nb_keep, n_ch, S)


from functools import partial


@partial(jax.jit, static_argnums=(3,))
def _uniform_arena_pipeline(a4, a2, a1, spec, words=None):
    """Arena-packed gather-free pipeline for *uniform* streams (constant
    block size, equal-length chains, constant frame length — the norm for
    real MLP encoders).

    All per-chunk inputs arrive in three flat arenas (int32/int16/int8)
    so the host performs exactly three h2d transfers per chunk.  In
    device-Huffman mode the raw bitstream ``words`` arrive as a SEPARATE
    whole-track buffer shared by every chunk (uploaded once per device,
    _SharedWords); chunks locate their bits through the ``wordbase``
    arena scalar.  ``spec`` is a static tuple of (name, width, offset,
    shape, dtype) describing each packed array; dtypes are minimised on the host
    (int16 filter coefficients/residuals, int8 shifts/flags, per-frame
    LFSR seeds instead of materialised noise, bit-packed bypass flags)
    and widened on device.

    Every data-movement step is a reshape/transpose — no gathers.
    """
    from ...ops.huffman_decode import decode_residuals_device
    from ...ops.mlp_filter import mlp_filter_blocks_tl
    from ...ops.rematrix import apply_output_stage_tl, rematrix_frames_tl

    arenas = {4: a4, 2: a2, 1: a1}
    arrs = {}
    flags = {}
    if words is not None:
        # whole-track bitstream words, uploaded once and shared by every
        # chunk program (see _SharedWords)
        arrs["words"] = words
    for name, width, off, shape, dtype in spec:
        if dtype == "flag":  # static markers: value rides in the offset
            flags[name] = off
            continue
        n = int(np.prod(shape)) if shape else 1
        x = jax.lax.slice(arenas[width], (off,), (off + n,)).reshape(shape)
        if dtype == "uint32":
            x = jax.lax.bitcast_convert_type(x, jnp.uint32)
        elif dtype == "uint8":
            x = jax.lax.bitcast_convert_type(x, jnp.uint8)
        arrs[name] = x

    def i32(name):
        return arrs[name].astype(jnp.int32)

    n_sub = max(int(name[1]) for name in arrs if name.startswith("s")) + 1

    packed = []   # per substream: (lane inputs..., Bc, n_ch, NB0, S0)
    byp6 = None
    for i in range(n_sub):
        res_tl = None
        if f"s{i}_bitpos" in arrs:
            # device-Huffman residual decode (ops/huffman_decode.py).
            # Substreams decode separately, inline where consumed (one
            # padded call would pad the 2-ch substream to the 4-ch one's
            # J/C); everything traces into one XLA program under jit.
            S0 = flags[f"s{i}_S"]
            cb = i32(f"s{i}_cb")
            Bc, NB0, n_ch = cb.shape
            Lc = Bc * NB0
            if f"s{i}_quant_c" in arrs:
                quantb = jnp.broadcast_to(
                    i32(f"s{i}_quant_c")[:, None], (Bc, NB0, n_ch))
            else:
                quantb = i32(f"s{i}_quant")
            bp = i32(f"s{i}_bitpos")
            # kernel emits filter-ready TIME-LEADING residuals directly
            # (one well-shaped permute inside the kernel; see NB0 arg)
            res_tl, byp_k = decode_residuals_device(
                arrs["words"], bp.reshape(Lc, bp.shape[-1]),
                cb.reshape(Lc, n_ch),
                i32(f"s{i}_lsbb").reshape(Lc, n_ch),
                i32(f"s{i}_off").reshape(Lc, n_ch),
                quantb.reshape(Lc, n_ch),
                i32(f"s{i}_nbyp").reshape(Lc),
                S0, flags[f"s{i}_J"],
                flags.get(f"s{i}_k", flags[f"s{i}_S"]),
                flags.get(f"s{i}_NW", 32),
                NB0,
                word_base=arrs.get("wordbase"))
            #                              [NB0, S0, n_ch*Bc], [Lc, S0]
            if f"s{i}_bypk" in arrs:
                # slot m's bit is the kidx[m]-th bypass symbol of the
                # packed burst field: a per-lane variable shift per slot.
                # One [T]-size permute puts the burst field time-leading
                # (chains minor) so the shifts run at full lane width and
                # the result feeds rematrix_frames_tl with no reorder.
                kb = (byp_k.reshape(Bc, NB0, S0)
                      .transpose(1, 2, 0))               # [NB0, S0, Bc]
                kidx = (i32(f"s{i}_bypk").reshape(Bc, NB0, 6)
                        .transpose(1, 2, 0))             # [NB0, 6, Bc]
                vld = (i32(f"s{i}_bypv").reshape(Bc, NB0, 6)
                       .transpose(1, 2, 0))
                rows = [((kb >> (5 - kidx[:, m])[:, None]) & 1)
                        * vld[:, m][:, None] for m in range(6)]
                byp6 = jnp.stack(rows, 2)        # [NB0, S0, 6, Bc]
        else:
            res = i32(f"s{i}_res")
            Bc, NB0, n_ch, S0 = res.shape
            res_tl = (res.transpose(1, 3, 2, 0)
                      .reshape(NB0, S0, n_ch * Bc))

        def pack(x):  # [Bc, NB0, n_ch, ...] -> [n_ch*Bc, NB0, ...]
            g = jnp.moveaxis(x, 2, 0)    # channel-major lane order
            return g.reshape((n_ch * Bc, NB0) + x.shape[3:])

        state0 = jnp.zeros((Bc * n_ch, 8), jnp.int32)
        block_len = jnp.full((Bc * n_ch, NB0), S0, jnp.int32)
        if f"s{i}_rc_fir_c" in arrs:
            # per-chain parameter rows broadcast across the chain's blocks
            def bc(x):
                return jnp.broadcast_to(
                    x[:, None], (Bc, NB0) + x.shape[1:])

            rc_fir = bc(i32(f"s{i}_rc_fir_c"))
            rc_iir = bc(i32(f"s{i}_rc_iir_c"))
            shift_b = bc(i32(f"s{i}_shift_c"))
            quant_b = bc(i32(f"s{i}_quant_c"))
            iir_init = bc(i32(f"s{i}_iir_init_c"))
            r0 = arrs[f"s{i}_iir_reset_c"] != 0           # [Bc, n_ch]
            iir_reset = jnp.concatenate(
                [r0[:, None], jnp.zeros((Bc, NB0 - 1, n_ch), bool)], axis=1)
        else:
            rc_fir = i32(f"s{i}_rc_fir")
            rc_iir = i32(f"s{i}_rc_iir")
            shift_b = i32(f"s{i}_shift")
            quant_b = i32(f"s{i}_quant")
            iir_init = i32(f"s{i}_iir_init")
            iir_reset = arrs[f"s{i}_iir_reset"] != 0
        packed.append((res_tl,
                       pack(rc_fir), pack(rc_iir), pack(shift_b),
                       pack(quant_b), pack(iir_reset), pack(iir_init),
                       block_len, state0, Bc, n_ch, NB0, S0))

    def run_filter(args8, state0):
        if "__triton__" in flags:  # value 1: the Pallas interpreter
            from ...ops.triton_filter import mlp_filter_blocks_triton

            return mlp_filter_blocks_triton(
                *args8, interpret=bool(flags["__triton__"]))
        return mlp_filter_blocks_tl(*args8, state0, state0,
                                    flags.get("__unroll__", 1))[0]

    # substreams with identical (NB0, S0) fuse into ONE filter call —
    # lanes are independent, so concatenating them saves a second scan's
    # fixed per-step costs (the scans run back-to-back otherwise)
    fuse = len(packed) > 1 and len({(p[11], p[12]) for p in packed}) == 1
    if fuse:
        # residuals are time-leading [NB, S, B]: lanes concat on axis 2
        cat = [jnp.concatenate([p[j] for p in packed],
                               axis=2 if j == 0 else 0)
               for j in range(9)]
        out_all = run_filter(cat[:8], cat[8])
        outs, row = [], 0
        for p in packed:
            lanes = p[9] * p[10]
            outs.append(jax.lax.slice_in_dim(out_all, row, row + lanes,
                                             axis=2))
            row += lanes
    else:
        outs = [run_filter(p[:8], p[8]) for p in packed]

    # --- time-leading join: chains stay on the minor (lane) axis -------
    # Time order within a chain is (block, sample) = (frame, in-frame
    # sample), so [NB0, S0, ...] leading axes flatten to the per-chain
    # period and re-split as [fpc, L0] for FREE — the old [n_ch, T] /
    # [F, L0, 8] join paid two stream-size permutes and then ran the
    # rematrix with 8 channels on the 128-lane axis (see rematrix_tl).
    Bc0 = packed[0][9]
    parts = []
    for out, p in zip(outs, packed):
        Bc, n_ch, NB0, S0 = p[9], p[10], p[11], p[12]
        # [NB0, S0, n_ch*Bc] (c-major lanes) → [period, n_ch, Bc]: free
        parts.append(out.reshape(NB0 * S0, n_ch, Bc))
    series_tl = jnp.concatenate(parts, axis=1)          # [period, C, Bc]
    period, C_tot = series_tl.shape[0], series_tl.shape[1]
    T_pad = Bc0 * period
    if C_tot < 8:
        series_tl = jnp.concatenate(
            [series_tl,
             jnp.zeros((period, 8 - C_tot, Bc0), jnp.int32)], axis=1)
    F_pad = arrs["mat_coeff"].shape[0]
    fpc = F_pad // Bc0                                  # frames per chain
    L0 = period // fpc
    channels = series_tl.reshape(fpc, L0, 8, Bc0)

    def tlf(x):  # [F_pad, ...] chain-major frame arrays → [fpc, ..., Bc]
        return jnp.moveaxis(x.reshape((Bc0, fpc) + x.shape[1:]), 0, -1)

    # LFSR noise expanded on device from per-frame seeds by jump doubling
    seeds = tlf(arrs["frame_seed"])[:, None, :]         # [fpc, 1, Bc]
    jumps = arrs["jumps"]                               # [K, 32] uint32
    width, k = 1, 0
    while width < L0:
        cur = seeds
        nxt = jnp.zeros_like(cur)
        for j in range(32):
            bit = ((cur >> jnp.uint32(j)) & jnp.uint32(1)) != 0
            nxt = nxt ^ jnp.where(bit, jumps[k, j], jnp.uint32(0))
        seeds = jnp.concatenate([cur, nxt], axis=1)[:, :L0]
        width *= 2
        k += 1
    shifted = (seeds >> jnp.uint32(7)) & jnp.uint32(0xFFFF)
    b0 = ((seeds >> jnp.uint32(15)) & jnp.uint32(0xFF)).astype(jnp.int32)
    b1 = (shifted & jnp.uint32(0xFF)).astype(jnp.int32)
    nshift = tlf(i32("frame_nshift"))[:, None, :]       # [fpc, 1, Bc]
    n0 = (((b0 ^ 0x80) - 0x80) << nshift)
    n1 = (((b1 ^ 0x80) - 0x80) << nshift)
    noise = jnp.stack([n0, n1], axis=2)                 # [fpc, L0, 2, Bc]

    if "byp" in arrs:
        # one [T]-size 2D transpose (chains to the minor axis), then the
        # six slot bits broadcast out with chains on lanes
        bits = i32("byp").reshape(Bc0, period).T.reshape(fpc, L0, 1, Bc0)
        byp = ((bits >> jnp.arange(6, dtype=jnp.int32)[None, None, :,
                                                       None]) & 1)
    else:  # device-Huffman mode: bits decoded on device (final substream)
        byp = byp6.reshape(fpc, L0, 6, byp6.shape[-1])
    # either way: [fpc, L0, 6, Bc]

    channels = rematrix_frames_tl(
        channels, noise, tlf(i32("mat_coeff")), tlf(i32("mat_noise")),
        tlf(i32("mat_out")), tlf(arrs["mat_active"] != 0),
        tlf(i32("mat_quant")), byp, flags.get("mat_mm", 6))
    staged = apply_output_stage_tl(channels, tlf(i32("out_shift")),
                                   i32("wave_perm"))    # [fpc,L0,C_out,Bc]
    # device-side little-endian byte packing, then ONE output permute to
    # WAV time order (chain, frame, sample) on the byte-packed tensor —
    # 3/4 the bytes of an int32 permute for 24-bit streams
    nbytes = 3 if "__pack24__" in flags else 2 if "__pack16__" in flags else 0
    if nbytes:
        def bytepack(nb):  # [fpc,L0,C_out,Bc] → uint8 [T_pad, C_out*nb]
            pk = jnp.stack(
                [((staged >> (8 * k)) & 0xFF).astype(jnp.uint8)
                 for k in range(nb)], axis=3)       # [fpc,L0,C_out,nb,Bc]
            return pk.transpose(4, 0, 1, 2, 3).reshape(T_pad, -1)

        if nbytes == 3 and "__narrow__" in flags:
            # narrow-d2h (config.narrow_d2h): width-reduced output plus an
            # on-device fits-flag, flattened together so the host learns
            # the flag from the SAME fetch (no extra round trip).  Two
            # tiers: int16 (2 B/sample) and, for even channel counts,
            # 12-bit (1.5 B/sample — channel pairs pack into 3 bytes);
            # the flag's bit 0 says the chunk fits THIS
            # tier, bit 1 (12-bit programs only) says it fits int16, so
            # the drain can redispatch an overflowed 12-bit chunk through
            # the 16-bit program instead of the wide one.  Padding lanes
            # are zero, so they never widen the range.  ONLY the narrow
            # buffer is produced — a dual narrow+wide program gives
            # `staged` two byte-pack consumers and XLA stops fusing the
            # output permute; chunks that overflow are REDISPATCHED by
            # the drain (_finish_uniform) from their still-alive device
            # arenas.
            tier = flags["__narrow__"] or 16
            lo, hi = staged.min(), staged.max()
            fits16 = jnp.logical_and(lo >= -(1 << 15), hi < (1 << 15))
            if tier == 12:
                fits12 = jnp.logical_and(lo >= -(1 << 11), hi < (1 << 11))
                c0 = staged[:, :, 0::2, :]
                c1 = staged[:, :, 1::2, :]
                pk = jnp.stack(
                    [c0 & 0xFF,
                     ((c0 >> 8) & 0xF) | ((c1 & 0xF) << 4),
                     (c1 >> 4) & 0xFF], axis=3).astype(jnp.uint8)
                narrow = (pk.transpose(4, 0, 1, 2, 3)
                          .reshape(T_pad, -1))      # [T_pad, C/2*3]
                flag = (fits12.astype(jnp.uint8)
                        + 2 * fits16.astype(jnp.uint8))
            else:
                narrow = bytepack(2)                # [T_pad, C_out*2]
                flag = fits16.astype(jnp.uint8)
            # the flag rides as 8 trailing ROWS: a major-axis concat is
            # layout-preserving (~free), where flattening narrow to 1-D
            # to append the flag forces a full relayout copy
            flag_rows = jnp.broadcast_to(flag, (8, narrow.shape[1]))
            return jnp.concatenate([narrow, flag_rows], axis=0)
        return bytepack(nbytes)
    return (staged.transpose(3, 0, 1, 2)
            .reshape(T_pad, staged.shape[2]))


class _ArenaBuilder:
    """Packs named arrays into three typed arenas + a static spec."""

    def __init__(self):
        self._parts = {4: [], 2: [], 1: []}
        self._spec = []

    def add(self, name: str, arr: np.ndarray) -> None:
        width = arr.dtype.itemsize
        base = {4: np.int32, 2: np.int16, 1: np.int8}[width]
        off = sum(p.size for p in self._parts[width])
        self._parts[width].append(np.ascontiguousarray(arr).view(base).ravel())
        self._spec.append((name, width, off, tuple(arr.shape),
                           str(arr.dtype)))

    def mark(self, name: str, value: int = 0) -> None:
        """A static marker entry (no data; ``value`` rides in the offset
        slot) — used for per-substream kernel constants like S0/J."""
        self._spec.append((name, 0, int(value), (), "flag"))

    def finish(self):
        arenas = tuple(
            np.concatenate(self._parts[w]) if self._parts[w]
            else np.zeros(0, {4: np.int32, 2: np.int16, 1: np.int8}[w])
            for w in (4, 2, 1)
        )
        return arenas, tuple(self._spec)


#: mp_pack source-array ids (host/src/mlp_parse.cc pack_src)
_PACK_SRC = {
    "rc_fir": 0, "rc_iir": 1, "iir_init": 2, "shift": 3, "quant": 4,
    "iir_reset": 5, "codebook": 6, "lsb_bits": 7, "res_offset": 8,
    "nbyp": 9, "byp_mask": 10,
    "mat_coeff": 20, "mat_noise": 21, "mat_out": 22, "mat_active": 23,
    "mat_quant": 24, "out_shift": 25, "frame_seed": 26, "frame_nshift": 27,
}

_W_IDX = {4: 0, 2: 1, 1: 2}
_W_BASE = {4: np.int32, 2: np.int16, 1: np.int8}


class _NativeArenaBuilder:
    """Arena assembly inside the native runtime.

    Python computes only the static spec and a small instruction table;
    every large copy/cast (residuals, coefficient tensors, decode tables)
    runs in one ``mp_pack`` call writing straight into the preallocated
    arena buffers (host/src/mlp_parse.cc).  Computed host-side entries
    (stream window, LUTs, permutations, LFSR jumps) are written by numpy
    after the native pass.  Layout semantics match :class:`_ArenaBuilder`
    (same add-order offsets per width), so the produced spec — and hence
    the compiled XLA program — is identical to the numpy path's."""

    def __init__(self, parse):
        self._parse = parse
        self._sizes = {4: 0, 2: 0, 1: 0}
        self._spec = []
        self._inst = []
        self._host = []

    def _alloc(self, name, shape, dtype):
        dt = np.dtype(dtype)
        width = dt.itemsize
        off = self._sizes[width]
        n = int(np.prod(shape)) if shape else 1
        self._sizes[width] = off + n
        self._spec.append((name, width, off, tuple(shape), str(dt)))
        return width, off

    def add_host(self, name, arr):
        width, off = self._alloc(name, arr.shape, arr.dtype)
        self._host.append((width, off, np.ascontiguousarray(arr)))

    def mark(self, name, value=0):
        self._spec.append((name, 0, int(value), (), "flag"))

    def _emit(self, op, src, sub, a, bb, c, d, e=0, f=0, g=0,
              *, name, shape, dtype):
        width, off = self._alloc(name, shape, dtype)
        self._inst.append([op, src, sub, a, bb, c, d, e, f, g, width, off])

    def add_chain(self, name, src, sub, blk0, blk1, NB0, CHUNK,
                  inner_shape, dtype):
        inner = int(np.prod(inner_shape)) if inner_shape else 1
        self._emit(0, _PACK_SRC[src], sub, blk0, blk1, NB0, inner, CHUNK,
                   name=name, shape=(CHUNK, NB0) + tuple(inner_shape),
                   dtype=dtype)

    def add_head(self, name, src, sub, blk0, blk1, NB0, CHUNK,
                 inner_shape, dtype):
        inner = int(np.prod(inner_shape)) if inner_shape else 1
        self._emit(1, _PACK_SRC[src], sub, blk0, blk1, NB0, inner, CHUNK,
                   name=name, shape=(CHUNK,) + tuple(inner_shape),
                   dtype=dtype)

    def add_frame(self, name, src, f0, f1, F_pad, inner_shape, dtype):
        inner = int(np.prod(inner_shape)) if inner_shape else 1
        self._emit(2, _PACK_SRC[src], 0, f0, f1, F_pad, inner,
                   name=name, shape=(F_pad,) + tuple(inner_shape),
                   dtype=dtype)

    def add_res(self, name, sub, t0, t1, CHUNK, NB0, n_ch, S0, dtype):
        self._emit(3, 0, sub, t0 * n_ch, t1 * n_ch, 0, 0,
                   name=name, shape=(CHUNK, NB0, n_ch, S0), dtype=dtype)

    def add_byp(self, name, t0, t1, T_pad):
        self._emit(4, 0, 0, t0, t1, T_pad, 0,
                   name=name, shape=(T_pad,), dtype=np.int8)

    def add_bitpos(self, name, sub, blk0, blk1, NB0, nsub, CHUNK,
                   base_bit, suboff):
        self._emit(5, 0, sub, blk0, blk1, NB0, nsub, CHUNK, base_bit,
                   suboff, name=name,
                   shape=(CHUNK, NB0, nsub), dtype=np.int32)

    def finish(self):
        arenas = tuple(np.zeros(self._sizes[w], _W_BASE[w]) for w in (4, 2, 1))
        if self._inst:
            inst = np.asarray(self._inst, dtype=np.int64).reshape(-1, 12)
            self._parse.pack(inst, *arenas)
        for width, off, arr in self._host:
            arenas[_W_IDX[width]][off : off + arr.size] = \
                arr.view(_W_BASE[width]).ravel()
        return arenas, tuple(self._spec)


@jax.jit
def _pipeline(subs, frame_idx, flat_idx, noise01, bypassed_t,
              mat_coeff, mat_noise, mat_out, mat_active, mat_quant,
              out_shift, wave_perm):
    """``subs``: tuple of per-substream dicts — raw parse arrays plus index
    tables (see decode_native).  All packing/gathering runs on device."""
    from ...ops.mlp_filter import mlp_filter_blocks
    from ...ops.rematrix import apply_output_stage, rematrix_frames

    Tb = flat_idx.shape[0]
    series_rows = []
    for u in subs:
        res = u["res"]          # [NBt, n_ch, S]
        n_ch = res.shape[1]
        bidx = u["bidx"]        # [Bc, NB] int32 (clamped)
        bmask = u["bmask"]      # [Bc, NB] bool
        Bc, NB = bidx.shape

        def pack(x):  # [NBt, n_ch, ...] -> [Bc*n_ch, NB, ...]
            g = jnp.take(x, bidx.reshape(-1), axis=0)
            g = g.reshape((Bc, NB) + x.shape[1:])
            g = jnp.moveaxis(g, 2, 1)
            return g.reshape((Bc * n_ch, NB) + g.shape[3:])

        lens_lane = jnp.where(
            bmask, jnp.take(u["lens"], bidx.reshape(-1), axis=0).reshape(Bc, NB), 0)
        block_len = jnp.repeat(lens_lane[:, None, :], n_ch, axis=1)
        block_len = block_len.reshape(Bc * n_ch, NB)
        lane_mask = jnp.repeat(bmask[:, None, :], n_ch, axis=1)
        iir_reset = pack(u["iir_reset"]) & lane_mask.reshape(Bc * n_ch, NB)
        state0 = jnp.zeros((Bc * n_ch, 8), jnp.int32)
        out, _, _ = mlp_filter_blocks(
            pack(res), pack(u["rc_fir"]), pack(u["rc_iir"]),
            pack(u["shift"]), pack(u["quant"]), iir_reset,
            pack(u["iir_init"]), block_len, state0, state0,
        )
        flat = out.reshape(-1)                       # [Bc*n_ch*NB*S]
        series_rows.append(jnp.take(flat, u["series_idx"], axis=0))  # [n_ch, Tb]

    series = jnp.concatenate(series_rows, axis=0)
    if series.shape[0] < 8:
        series = jnp.concatenate(
            [series, jnp.zeros((8 - series.shape[0], Tb), jnp.int32)], axis=0)

    channels = jnp.take(series, frame_idx, axis=1)   # [8, Fb, L]
    channels = channels.transpose(1, 2, 0)           # [Fb, L, 8]
    noise = jnp.take(noise01, frame_idx.reshape(-1), axis=0)
    noise = noise.reshape(frame_idx.shape + (2,))    # [Fb, L, 2]
    byp = jnp.take(bypassed_t, frame_idx.reshape(-1), axis=0).astype(jnp.int32)
    byp = byp.reshape(frame_idx.shape + (6,)).transpose(0, 2, 1)  # [Fb, 6, L]
    channels = rematrix_frames(channels, noise, mat_coeff, mat_noise,
                               mat_out, mat_active, mat_quant, byp)
    staged = apply_output_stage(channels, out_shift, wave_perm)
    flat_out = staged.reshape(-1, staged.shape[-1])
    return jnp.take(flat_out, flat_idx, axis=0)      # [Tb, C_out]


#: sentinel: the pipelined path hit a structure it does not handle — run
#: the monolithic path on the (finished) parse instead
_ABANDON = object()


def _warn_bail(parse) -> None:
    """Name WHY the native parser handed the stream back: the fallback is
    the pure-Python spec decoder, ~3 orders of magnitude slower, and a
    silent mode switch of that size must be diagnosable."""
    from ...utils.log import logger

    logger.warning(
        "native MLP parse bailed: %s; falling back to the pure-Python "
        "spec decoder (orders of magnitude slower)",
        host.bail_reason_text(getattr(parse, "bail_reason", 0)))


def decode_native(stream: bytes, boundaries: np.ndarray, probe_end: int,
                  parameters: StreamParameters,
                  want_packed: bool = False,
                  config: DecodeConfig | None = None) -> np.ndarray | None:
    """Decode a complete MLP stream.  Returns int32 [T, C] samples, or —
    with ``want_packed`` on a uniform 24-bit stream — uint8 [T, C*3]
    little-endian WAV data bytes (callers distinguish by dtype).

    The production path is *pipelined*: the native parser runs in frame
    batches interleaved with chunk dispatch, so parsing of chunk N+1
    overlaps chunk N's device compute and d2h drain.
    Streams the pipelined driver cannot handle fall back to the monolithic
    parse-then-dispatch path, reusing the same parser handle (no re-parse).
    """
    if not host.available():
        return None
    cfg = config if config is not None else default_config()
    if cfg.resolved_host_complete():
        return _decode_host_complete(stream, boundaries, probe_end,
                                     parameters, want_packed, cfg)
    # device-Huffman mode: residual bits walked length-only on the host,
    # values re-decoded on device from the raw stream (ops/huffman_decode)
    skip_values = cfg.resolved_device_huffman() and cfg.use_device
    inc = host.parse_mlp_stream_begin(
        stream, skip_values=skip_values,
        threads=cfg.resolved_parse_threads(),
        sub_every=cfg.resolved_huffman_split() if skip_values else 0)
    if inc is None:
        return None
    try:
        res = _decode_pipelined(inc, stream, boundaries, probe_end,
                                parameters, want_packed, config,
                                device_huffman=skip_values)
        if res is not _ABANDON:
            return res
        if skip_values:
            # the general path needs residual values: re-parse normally
            inc.close()
            inc = None  # the finally guard must not re-close (or None-deref)
            inc = host.parse_mlp_stream_begin(stream,
                                              threads=cfg.resolved_parse_threads())
            if inc is None:
                return None
        with global_timer.stage("mlp/native-parse"):
            inc.step(0)  # finish the walk; no bytes are re-parsed
        parse = inc.view()
        if parse.status != 0:
            _warn_bail(parse)
            return None
        return _decode_parsed(parse, boundaries, probe_end, parameters,
                              want_packed, config)
    finally:
        if inc is not None:
            inc.close()  # frees the zero-copy parse buffers


def _decode_host_complete(stream, boundaries, probe_end, parameters,
                          want_packed, cfg) -> np.ndarray | None:
    """Host-complete decode: native parse (optionally multi-threaded) +
    native reconstruction (mp_reconstruct) — no device kernels, no
    host↔device transfers.  The production executor when no accelerator
    is attached or the link to it is slower than host compute; output
    bytes are identical to the device pipeline's (test_host_complete).
    ``None`` falls back to the Python engines (parse bail)."""
    inc = host.parse_mlp_stream_begin(
        stream, threads=cfg.resolved_parse_threads())
    if inc is None:
        return None
    try:
        with global_timer.stage("mlp/native-parse"):
            inc.step(0)
        parse = inc.view()
        if parse.status != 0:
            _warn_bail(parse)
            return None
        out_ch = parameters.channel_count
        if parse.F == 0:
            return np.zeros((0, out_ch), dtype=np.int32)
        F = _frame_cut(parse.frame_end,
                       np.asarray(boundaries, dtype=np.int64), probe_end)
        if F == 0:
            return np.zeros((0, out_ch), dtype=np.int32)
        pb = _pack_bits(parameters.bits_per_sample) if want_packed else 0
        with global_timer.stage("mlp/host-recon"):
            return parse.reconstruct(F, out_ch, pb,
                                     _wave_perm(parse, out_ch),
                                     threads=cfg.resolved_parse_threads())
    finally:
        inc.close()


def _decode_pipelined(inc, stream, boundaries, probe_end, parameters,
                      want_packed, config, device_huffman=False):
    """Interleaved parse/dispatch over *piecewise-uniform* streams
    (see decode_native).

    The stream is decoded as a run of uniform **sections**: within a
    section, frame length, block size and chain length are constant, and
    geometry may change at any clean chain boundary (a fresh restart) —
    block-size switches, restart-cadence changes and partial tail chains
    each simply open a new section with freshly discovered geometry.
    Chunks inside a section share one compiled program.

    Returns the decoded array, ``None`` (parser bailed → Python engines),
    or ``_ABANDON`` (geometry churn or unhandled structure → monolithic
    path; already-dispatched device work is simply discarded)."""
    out_ch = parameters.channel_count
    pack_bits = _pack_bits(parameters.bits_per_sample)
    # the raw stream as 32-bit words, uploaded to each decode device once
    # and shared by every chunk program (see _SharedWords)
    words_all = _SharedWords(stream) if device_huffman else None

    st = {"more": True}

    def parse_step(n) -> bool:
        with global_timer.stage("mlp/native-parse"):
            st["more"] = inc.step(n)
        st["v"] = inc.view()
        if st["v"].status != 0:
            _warn_bail(st["v"])
            return False
        return True

    if not parse_step(64):
        return None
    while st["more"] and st["v"].F == 0:  # leading frames may all drop
        if not parse_step(64):
            return None
    if st["v"].F == 0:
        return _ABANDON  # empty/degenerate: monolithic handles it

    devices = _decode_devices(config)
    cfg = config if config is not None else default_config()
    CHUNK = cfg.resolved_chunk_chains(out_ch)
    kernel = cfg.resolved_filter_kernel()
    unroll = cfg.resolved_filter_unroll()
    nstate = {"narrow": _narrow_tier0(pack_bits, out_ch, cfg),
              "checked": False}

    pending = []
    drainer = _Drainer(nstate) if cfg.drain_thread else None
    try:
        return _pipelined_loop(
            inc, st, parse_step, boundaries, probe_end, out_ch, pack_bits,
            want_packed, device_huffman, words_all, devices, cfg, CHUNK,
            kernel, unroll, nstate, pending, drainer)
    finally:
        if drainer is not None:
            drainer.abort()  # no-op after a successful finish


def _pipelined_loop(inc, st, parse_step, boundaries, probe_end, out_ch,
                    pack_bits, want_packed, device_huffman, words_all,
                    devices, cfg, CHUNK, kernel, unroll, nstate,
                    pending, drainer):
    ci = 0
    mat_mm = 0                               # running rematrix unroll bound
    f0 = 0                                   # frame base of the section
    blk0s = [0] * st["v"].substream_count    # per-substream block bases
    suboffs = [0] * st["v"].substream_count  # flat sub_bitpos offsets
    t_base = 0                               # absolute sample base
    n_sections = 0
    prev_key = None
    while True:
        while st["more"] and st["v"].F <= f0:
            if not parse_step(64):
                return None
        v = st["v"]
        if v.F <= f0:
            break  # every parsed frame is covered
        key = (f0, tuple(blk0s))
        if key == prev_key:
            return _ABANDON  # no progress: truly non-uniform
        prev_key = key
        n_sections += 1
        if n_sections > 8:
            return _ABANDON  # geometry churn: the gather path handles it

        geo = _discover_geometry(st, parse_step, f0, blk0s)
        if geo is None:
            return None if st["v"].status != 0 else _ABANDON
        L0, period, fpc, struct = geo  # struct: (s, S0, NB0)

        c0 = 0
        while True:
            need_f = f0 + (c0 + CHUNK) * fpc + 1
            while st["more"] and st["v"].F < need_f:
                if not parse_step(max(64, need_f - st["v"].F)):
                    return None
            v = st["v"]
            done = not st["more"]
            avail = min((v.F - f0) // fpc,
                        *((v.sub[s]["len"].shape[0] - blk0s[s]) // NB0
                          for s, _, NB0 in struct))
            want = min(c0 + CHUNK, avail)
            if want <= c0:
                break  # section exhausted (tail opens a new section)
            n_ok = _verified_chains(v, struct, L0, fpc, f0, blk0s,
                                    c0, want, done)
            if n_ok == 0:
                break  # geometry broke at c0: close the section here
            c1 = c0 + n_ok
            with global_timer.stage("mlp/stage+dispatch"):
                subs_info = [(v.sub[s], blk0s[s], S0, NB0, suboffs[s])
                             for s, S0, NB0 in struct]
                mat_mm = max(mat_mm, _max_matrix_slots(
                    v.mat_active[f0 + c0 * fpc : f0 + c1 * fpc]))
                dev = _dispatch_uniform_chunk(
                    v, subs_info, c0, c1, CHUNK, period, L0, out_ch,
                    pack_bits=pack_bits,
                    device=(devices[ci % len(devices)] if devices else None),
                    words_all=words_all, kernel=kernel,
                    f_base=f0, t_base=t_base, native_pack=cfg.native_pack,
                    unroll=unroll, mat_mm=mat_mm, narrow=nstate["narrow"])
                if drainer is not None:
                    drainer.push(dev, n_ok * period)
                else:
                    pending.append((dev, n_ok * period))
                    _narrow_poll(pending, nstate)
            if drainer is not None:
                drainer.throttle()  # bound unsettled narrow work (no lock
                # held: outside the stage timer to keep dispatch honest)
            ci += 1
            if n_ok < want - c0:  # verification truncated: geometry broke
                c0 = c1
                break
            c0 = c1
        # close the section: advance every base past its verified chains
        f0 += c0 * fpc
        t_base += c0 * period
        for s, S0, NB0 in struct:
            blk0s[s] += c0 * NB0
            if device_huffman:
                k = int(st["v"].sub[s].get("sub_every", 0) or 0)
                if k:  # ceil(S0/k) flat sub_bitpos entries per block
                    suboffs[s] += c0 * NB0 * (-(-S0 // k))
        if not st["more"] and st["v"].F <= f0:
            break

    # ---- finish: packet-boundary frame cut + drain ------------------------
    global _LAST_PIPELINE_INFO
    _LAST_PIPELINE_INFO = {"sections": n_sections, "chunks": ci}
    v = st["v"]
    F = _frame_cut(v.frame_end, np.asarray(boundaries, dtype=np.int64),
                   probe_end)
    if F == 0 or ci == 0:
        return np.zeros((0, out_ch), dtype=np.int32)
    T = int(v.frame_len[:F].sum())
    if drainer is not None:
        with global_timer.stage("mlp/device+d2h"):
            return drainer.finish(T, out_ch, pack_bits, want_packed)
    return _finish_uniform(pending, T, out_ch, pack_bits, want_packed,
                           narrow_state=nstate)


def _max_matrix_slots(mat_active: np.ndarray) -> int:
    """Highest active rematrix slot + 1 over a frame range [F, 6] — the
    static unroll bound for rematrix_frames (slots beyond it are inactive
    in every frame of the chunk, so skipping them is exact).  The
    pipelined/monolithic drivers fold each chunk's local value into a
    RUNNING max (each chunk scans only its own frames — O(stream), not
    O(stream²)) and pass that down as ``mat_mm``, so the flag is
    MONOTONE along a stream: it can step up a handful of times at most
    (0→…→6) instead of oscillating per chunk, which would recompile the
    chunk program mid-stream (review r3)."""
    nz = np.nonzero(np.asarray(mat_active, bool).any(axis=0))[0]
    return int(nz[-1]) + 1 if nz.size else 0


def _window_rows(span_bits: int) -> int:
    """Aligned window row size (words, power of two) for the residual
    kernel: a sub-lane's max bit span plus a 64-bit guard must fit in
    NW*32 bits (ops/huffman_decode.py).  A huge span (only reachable
    with the split disabled on large dense blocks) costs select-tree
    depth, never silent wraparound.  Bounded by 8192 so the shared
    whole-track words buffer (padded to a multiple of 8192 words,
    _SharedWords) always tiles into NW rows; the format cannot exceed it
    (one block is ≤511 samples × ≤8 ch × ≤33 bits ≈ 4.2k words)."""
    need = (int(span_bits) + 64 + 31) // 32
    rows = _bucket(need, lo=8)
    if rows > 8192:
        raise ValueError(f"residual sub-lane span {span_bits} bits "
                         f"exceeds the 8192-word window bound")
    return rows


class _SharedWords:
    """Whole-track bitstream words for device-Huffman mode, uploaded to a
    device ONCE and shared by every chunk program (per-chunk stream
    windows would re-ship the track ~1.4×, pow2-bucketed).  The buffer is
    padded to a multiple of 8192 words (plus a 16-word guard for the
    kernel's 64-bit loads) so any kernel NW — a power of two ≤ 8192 by
    format bounds (one block's residuals fit well inside 8192·32 bits) —
    tiles it exactly; chunks index it through a per-chunk ``wordbase``
    aligned to 8192 words, keeping their bitpos tables int32-safe for
    arbitrarily long tracks."""

    def __init__(self, stream: bytes):
        n = (len(stream) + 3) // 4 + 16
        n = -(-n // 8192) * 8192
        buf = np.zeros(n * 4, np.uint8)
        buf[: len(stream)] = np.frombuffer(stream, np.uint8)
        self.np = buf.view(">u4").astype(np.uint32)
        self._per: dict = {}

    def on(self, device=None):
        """The device-resident copy for ``device`` (uploaded lazily once
        per device; None = default placement)."""
        if device not in self._per:
            self._per[device] = (jax.device_put(self.np, device)
                                 if device is not None
                                 else jax.device_put(self.np))
        return self._per[device]


def _chunk_word_base(subs_info, c0: int) -> int:
    """Bit offset every chunk bitpos is made relative to: the first
    residual bit of the chunk's first block, aligned DOWN to 2^18 bits
    (= 8192 words, a multiple of any kernel NW, matching _SharedWords
    padding).  Shared by the native/numpy dispatchers (a differential
    pair — one copy so the base math cannot drift)."""
    bit0 = min(int(si[0]["res_bitpos"][si[1] + c0 * si[3]])
               for si in subs_info)
    return (bit0 >> 18) << 18


def _narrow_tier0(pack_bits: int, out_ch: int, cfg) -> int:
    """Initial narrow-d2h tier for a 24-bit stream: start at the 12-bit
    tier (1.5 B/sample — channel pairs pack into 3 bytes) when the
    channel count is even, else at int16; 0 = narrow off.  The first
    chunk's embedded fits-flag settles the track's real tier
    (_narrow_poll): quiet content drains at half/ three-eighths the
    bytes, loud content pays one redispatched chunk."""
    if pack_bits != 24 or not cfg.resolved_narrow_d2h():
        return 0
    return 12 if out_ch % 2 == 0 else 16


def _pack_bits(bits_per_sample: int) -> int:
    """Device byte-packing width: 24- and 16-bit streams pack to their
    WAV sample width on device (25% / 50% less d2h than raw int32 and no
    host repack); other widths (20-bit uses non-byte-aligned generic bit
    packing on the host, utils/wav.py) return 0 = no packing."""
    return bits_per_sample if bits_per_sample in (16, 24) else 0


#: diagnostics from the last completed pipelined decode (tests/bench)
_LAST_PIPELINE_INFO: dict = {}


def _discover_geometry(st, parse_step, f0, blk0s):
    """Geometry of the section starting at frame ``f0`` / blocks ``blk0s``:
    frame length, per-substream block size and chain length (distance to
    the next uncoupled restart — or the remaining blocks for a tail
    section), parsing further as needed.  ``None`` on parser bail or when
    the substream periods disagree."""
    v = st["v"]
    L0 = int(v.frame_len[f0])
    if L0 <= 0:
        return None
    struct = []
    for s in range(v.substream_count):
        B = blk0s[s]
        sub = st["v"].sub[s]
        if sub["len"].shape[0] <= B:
            return None
        S0 = int(sub["len"][B])
        NB0 = None
        while NB0 is None:
            sub = st["v"].sub[s]
            restart = sub["restart"][B + 1 :]
            n = restart.shape[0]
            coupled = sub["fir_any"][B + 1 : B + 1 + n] != 0
            fresh = np.nonzero(restart & ~coupled)[0]
            if fresh.size:
                NB0 = int(fresh[0]) + 1
            elif not st["more"]:
                NB0 = sub["len"].shape[0] - B  # single-chain tail section
            elif not parse_step(st["v"].F):  # double the coverage
                return None
        if NB0 <= 0:
            return None
        struct.append((s, S0, NB0))
    periods = {S0 * NB0 for _, S0, NB0 in struct}
    if len(periods) != 1:
        return None
    period = periods.pop()
    if period % L0:
        return None
    return L0, period, period // L0, struct


def _verified_chains(v, struct, L0, fpc, f0, blk0s, c0, c1, done) -> int:
    """How many chains of [c0, c1) (section-relative) verify under the
    section geometry.  A chain verifies when its frames all have length
    ``L0``, its blocks all have size ``S0``, it starts at an uncoupled
    restart (except the stream's block 0), contains no internal chain
    split, and ends at a fresh chain start (or the exact stream end).
    The count stops at the first failing chain — the caller closes the
    section there and rediscovers geometry."""
    nc = c1 - c0
    ok = np.ones(nc, bool)
    fa = f0 + c0 * fpc
    fl = v.frame_len[fa : fa + nc * fpc]
    ok &= (fl.reshape(nc, fpc) == L0).all(axis=1)
    for s, S0, NB0 in struct:
        sub = v.sub[s]
        a = blk0s[s] + c0 * NB0
        nbk = sub["len"].shape[0]
        span = nc * NB0
        lens = sub["len"][a : a + span].reshape(nc, NB0)
        ok &= (lens == S0).all(axis=1)
        restart = sub["restart"][a : a + span]
        coupled = sub["fir_any"][a : a + span] != 0
        unc = (restart & ~coupled).reshape(nc, NB0)
        start_ok = unc[:, 0].copy()
        if a == 0:
            start_ok[0] = True  # the stream's block 0 starts a chain
        ok &= start_ok
        if NB0 > 1:
            ok &= ~unc[:, 1:].any(axis=1)
        # end boundary: the next block starts a fresh chain, or the stream
        # ends exactly at the chain's last block
        nxt = a + (np.arange(nc) + 1) * NB0
        end_ok = (nxt == nbk) & done
        inb = nxt < nbk
        idx = nxt[inb]
        if idx.size:
            fresh = sub["restart"][idx] & (sub["fir_any"][idx] == 0)
            end_ok[inb] = fresh
        ok &= end_ok
    bad = np.nonzero(~ok)[0]
    return int(bad[0]) if bad.size else nc


def _narrow_poll(pending, state, block=False):
    """Adaptive narrow-TIER check on the FIRST narrow chunk only: once its
    buffer lands, read it (the bytes are needed anyway) and settle the
    track's tier from the embedded flag — a 12-bit chunk that overflows
    but fits int16 moves the track to the 16-bit tier (and is itself
    redispatched through the 16-bit program); one that overflows int16
    turns narrow mode off entirely.  Full-scale content overflows chunk
    after chunk, and each narrow+wide pair costs extra readback, so the
    tier must settle early.

    Later chunks are deliberately NOT polled: their buffers are fetched in
    ONE batched device-side concat at the drain (_fetch_pending), so a
    per-read fixed cost is paid once, not per chunk.
    Their input arenas stay alive in HBM until the drain (each redo
    closure pins its chunk's arenas, ~5 MB/chunk — trivial vs HBM);
    chunks that overflow their tier mid-track are redispatched by the
    drain, batched."""
    if not state.get("narrow", 0) or state.get("checked"):
        return
    if not pending:
        return
    dev, n = pending[0]
    if not isinstance(dev, tuple) or dev[1] is None:
        state["checked"] = True
        return
    arr, redo, tier = dev
    if not block:
        ready = getattr(arr, "is_ready", None)
        if ready is None or not ready():
            return
    got = np.asarray(arr)
    state["checked"] = True
    flag = int(got[-1, -1])
    if flag & 1:  # fits this tier: keep the host copy, tier settled
        pending[0] = ((got, None, tier), n)
    elif tier == 12 and flag & 2:  # fits int16: move the track to tier 16
        state["narrow"] = 16
        pending[0] = ((redo(16), redo, 16), n)
    else:
        state["narrow"] = 0
        pending[0] = (redo(), n)


#: cached concat program (shapes/arity key via jit's own cache)
@jax.jit
def _concat0(*xs):
    return jnp.concatenate(xs, axis=0)


def _fetch_pending(pending):
    """Resolve every pending chunk to a host array with BATCHED reads:
    consecutive device-resident outputs with identical trailing shape on
    the same device are concatenated on device and fetched in ONE call.
    Returns a list of host arrays (views into the group reads)."""
    out = [None] * len(pending)
    group_idx, group_arr = [], []

    def flush():
        if not group_idx:
            return
        if len(group_arr) == 1:
            big = np.asarray(group_arr[0])
        else:
            big = np.asarray(_concat0(*group_arr))
        row = 0
        for i, a in zip(group_idx, group_arr):
            out[i] = big[row : row + a.shape[0]]
            row += a.shape[0]
        group_idx.clear()
        group_arr.clear()

    def key(a):
        try:
            dev = tuple(sorted(d.id for d in a.devices()))
        except Exception:
            dev = ()
        return (a.shape[1:], a.dtype, dev)

    for i, (dev, _n) in enumerate(pending):
        arr = dev[0] if isinstance(dev, tuple) else dev
        if isinstance(arr, np.ndarray):  # already on host (narrow check)
            out[i] = arr
            continue
        if group_arr and key(group_arr[-1]) != key(arr):
            flush()
        group_idx.append(i)
        group_arr.append(arr)
    flush()
    return out


class _Drainer:
    """Background chunk drain (round 5).

    The round-4 drain fetched every chunk in one batched read AFTER the
    dispatch loop, so through a slow device link the e2e time was
    parse+dispatch PLUS the whole readback — and the adaptive narrow-d2h
    tier never settled mid-stream (its one non-blocking poll usually ran
    before chunk 0's flag landed), so on content that overflows the tier
    EVERY chunk was dispatched narrow and redispatched wide at the drain:
    double device work, all of it serialized after the loop.  Together
    those halved device-path throughput.

    This thread resolves dispatched chunks to host arrays WHILE the main
    thread keeps parsing/dispatching (the ctypes parse calls release the
    GIL, so the overlap is real — measured total ≈ max(parse, drain), not
    the sum), with adaptive batching: each round it grabs everything
    queued so far, resolves the longest same-shape run in one device-side
    concat + single read call, and by the time that read
    returns more chunks have queued — batch size adapts to the link speed
    by itself.

    Narrow-tier protocol (see _uniform_arena_pipeline): the FIRST
    resolved narrow chunk settles the track's tier from its embedded
    fits-flag — later dispatches use the settled tier, and the main
    thread blocks in :meth:`throttle` once ≥3 unsettled narrow chunks are
    in flight, bounding wrong-tier work to 3 chunks AND making the set of
    compiled programs deterministic (the round-4 timing-dependent tier
    churn minted fresh XLA programs mid-bench, costing ~20 s compiles in
    timed runs).  Chunks that individually overflow the settled tier are
    redispatched from their still-alive device arenas by this thread, so
    even redos overlap the rest of the stream."""

    def __init__(self, nstate):
        import threading

        self._cv = threading.Condition()
        self._q = []            # (idx, dev, n) — new arrivals + redos
        self._results = {}      # idx -> (host array, tier)
        self._rows = []         # rows per idx, in push order
        self._done = False
        self._aborted = False
        self._exc = None
        self._nstate = nstate
        self._unsettled = 0
        self._settled = threading.Event()
        if not nstate.get("narrow", 0):
            nstate["checked"] = True
        if nstate.get("checked"):
            self._settled.set()
        self._th = threading.Thread(target=self._run, daemon=True,
                                    name="dvda-drain")
        self._th.start()

    # ------------------------------------------------------- main thread
    def push(self, dev, n: int) -> None:
        if self._exc is not None:
            raise self._exc
        idx = len(self._rows)
        self._rows.append(n)
        if isinstance(dev, tuple) and not self._nstate.get("checked"):
            self._unsettled += 1
        with self._cv:
            self._q.append((idx, dev, n))
            self._cv.notify()

    def throttle(self) -> None:
        """Block until the narrow tier settles once ≥3 unsettled narrow
        chunks are in flight (see class docstring)."""
        if (self._unsettled >= 3 and not self._nstate.get("checked")
                and not self._settled.is_set()):
            self._settled.wait()
        if self._exc is not None:
            raise self._exc

    def finish(self, T, out_ch, pack_bits, want_packed):
        """Join the drain and assemble the final [T, ...] output (same
        row-fill semantics as _finish_uniform)."""
        with self._cv:
            self._done = True
            self._cv.notify()
        self._th.join()
        if self._exc is not None:
            raise self._exc
        raw = _alloc_out(T, out_ch, pack_bits)
        row = 0
        for idx, n in enumerate(self._rows):
            take = min(n, T - row)
            if take > 0:
                got, tier = self._results[idx]
                _fill_rows(raw, row, take, got, tier, out_ch)
            row += take
            if row >= T:
                break
        return _unpack_raw(raw, T, out_ch, pack_bits, want_packed)

    def abort(self) -> None:
        """Stop draining and discard pending device work (parser bail or
        geometry abandon mid-stream).  Idempotent; harmless after
        finish()."""
        with self._cv:
            self._aborted = True
            self._done = True
            self._q.clear()
            self._cv.notify()
        self._settled.set()
        self._th.join()

    # ------------------------------------------------------ drain thread
    def _run(self):
        import time as _time

        try:
            work = []
            while True:
                with self._cv:
                    while not self._q and not self._done and not work:
                        self._cv.wait()
                    work.extend(self._q)
                    self._q.clear()
                    if self._aborted:
                        return
                    if not work and self._done:
                        return
                t0 = _time.perf_counter()
                work = self._resolve_one_group(work)
                global_timer.add("mlp/drain-thread",
                                 _time.perf_counter() - t0)
        except BaseException as exc:  # propagate to the main thread
            self._exc = exc
        finally:
            self._settled.set()

    @staticmethod
    def _key(dev):
        arr = dev[0] if isinstance(dev, tuple) else dev
        if isinstance(arr, np.ndarray):
            return None
        try:
            devs = tuple(sorted(d.id for d in arr.devices()))
        except Exception:
            devs = ()
        return (arr.shape, arr.dtype, devs)

    def _resolve_one_group(self, work):
        """Resolve the longest leading same-shape run of ``work`` (≤8) in
        one read; returns the remaining work (+ redos, appended last so
        their device compute overlaps other resolutions)."""
        key0 = self._key(work[0][1])
        group = [work[0]]
        for item in work[1:]:
            if (key0 is None or len(group) >= 8
                    or self._key(item[1]) != key0):
                break
            group.append(item)
        rest = work[len(group):]
        arrs = [d[0] if isinstance(d, tuple) else d for _i, d, _n in group]
        if key0 is None:  # already host-resident (redo resolved inline)
            big = arrs[0]
            rows = big.shape[0]
        elif len(arrs) == 1:
            big = np.asarray(arrs[0])
            rows = big.shape[0]
        else:
            big = np.asarray(_concat0(*arrs))
            rows = arrs[0].shape[0]
        for j, (idx, dev, n) in enumerate(group):
            got = big[j * rows : (j + 1) * rows]
            if isinstance(dev, tuple) and dev[1] is not None:
                tier = dev[2]
                flag = int(got[-1, -1])
                self._settle(flag, tier)
                if flag & 1:
                    self._results[idx] = (got, tier)
                elif tier == 12 and flag & 2:
                    rest.append((idx, (dev[1](16), dev[1], 16), n))
                else:
                    rest.append((idx, (dev[1](), None, 0), n))
            else:
                tier = dev[2] if isinstance(dev, tuple) else 0
                self._results[idx] = (got, tier)
        return rest

    def _settle(self, flag: int, tier: int) -> None:
        """First resolved narrow flag settles the track's tier."""
        if self._nstate.get("checked"):
            return
        self._nstate["checked"] = True
        if not flag & 1:
            self._nstate["narrow"] = (16 if tier == 12 and flag & 2
                                      else 0)
        self._settled.set()


def _finish_uniform(pending, T, out_ch, pack_bits, want_packed,
                    narrow_state=None):
    """Drain dispatched chunks and assemble the final [T, ...] output.

    All device-resident chunk outputs are fetched with batched
    device-side concats (_fetch_pending — one read call per run of
    same-shape chunks instead of one per chunk).  Chunks then copy
    straight into one preallocated array (a host concatenate here
    double-copied 52 MB per 30 s track).  Narrow-d2h chunks (see
    config.narrow_d2h) arrive as int16 bytes + an embedded fits-flag and
    are widened to the 24-bit WAV layout here — the third byte is the
    arithmetic sign extension of the int16 high byte; a chunk whose flag
    says some sample overflowed int16 is REDISPATCHED through the wide
    program from its still-alive device arenas (batched again), so output
    bytes are identical either way."""
    with global_timer.stage("mlp/device+d2h"):
        resolved = _fetch_pending(pending)
        # narrow chunks that overflowed their tier: redispatch (batched) —
        # a 12-bit chunk that still fits int16 reruns the 16-bit program,
        # anything else the wide one (flag bits: see the pipeline)
        redos = []
        for i, (dev, _n) in enumerate(pending):
            if not (isinstance(dev, tuple) and dev[1] is not None):
                continue
            flag = int(resolved[i][-1, -1])
            if flag & 1:
                continue
            if dev[2] == 12 and flag & 2:
                redos.append((i, dev[1](16), 16))
            else:
                redos.append((i, dev[1](), 0))
        if redos:
            fetched = _fetch_pending([(arr, pending[i][1])
                                      for i, arr, _t in redos])
            for (i, _arr, retier), got in zip(redos, fetched):
                resolved[i] = got
                pending[i] = (((got, None, retier), pending[i][1])
                              if retier else (got, pending[i][1]))
        raw = _alloc_out(T, out_ch, pack_bits)
        row = 0
        for (dev, n), got in zip(pending, resolved):
            take = min(n, T - row)
            if take > 0:
                tier = dev[2] if isinstance(dev, tuple) else 0
                _fill_rows(raw, row, take, got, tier, out_ch)
            row += take
            if row >= T:
                break
    return _unpack_raw(raw, T, out_ch, pack_bits, want_packed)


def _alloc_out(T: int, out_ch: int, pack_bits: int) -> np.ndarray:
    """The final output array: byte-packed [T, C*nbytes] for 16/24-bit
    streams (bytearray-backed so read_all_packed can hand the payload to
    the caller without a whole-track tobytes() copy), int32 otherwise."""
    nbytes = pack_bits // 8
    width = out_ch * nbytes if pack_bits else out_ch
    if pack_bits:
        return np.frombuffer(bytearray(T * width),
                             dtype=np.uint8).reshape(T, width)
    return np.empty((T, width), dtype=np.int32)


def _fill_rows(raw, row: int, take: int, got, tier: int, out_ch: int):
    """Copy one resolved chunk's first ``take`` rows into
    ``raw[row:row+take]``.  ``tier`` 0 = full-width rows; 12/16 = narrow
    bytes (trailing flag rows excluded by the byte cut) widened to the
    24-bit layout — the third byte is the arithmetic sign extension."""
    if not tier:
        raw[row : row + take] = got[:take]
        return
    dst = raw[row : row + take]
    nbn = take * out_ch * tier // 8
    flat = np.ascontiguousarray(got).reshape(-1)[:nbn]
    if tier == 12:
        if not host.widen12(flat, dst.reshape(-1)):
            trip = (flat.reshape(take, out_ch // 2, 3)
                    .astype(np.int32))
            c0 = trip[..., 0] | ((trip[..., 1] & 0xF) << 8)
            c1 = (trip[..., 1] >> 4) | (trip[..., 2] << 4)
            v = np.empty((take, out_ch), np.int32)
            v[:, 0::2] = (c0 ^ 0x800) - 0x800
            v[:, 1::2] = (c1 ^ 0x800) - 0x800
            d3 = dst.reshape(take, out_ch, 3)
            d3[:, :, 0] = v & 0xFF
            d3[:, :, 1] = (v >> 8) & 0xFF
            d3[:, :, 2] = (v >> 16) & 0xFF
    elif not host.widen24(flat, dst.reshape(-1)):
        pairs = flat.reshape(take, out_ch, 2)
        d3 = dst.reshape(take, out_ch, 3)
        d3[:, :, :2] = pairs
        d3[:, :, 2] = (pairs[:, :, 1].view(np.int8)
                       >> 7).view(np.uint8)


def _unpack_raw(raw, T, out_ch, pack_bits, want_packed):
    if not pack_bits:
        return raw
    if want_packed:
        return raw  # uint8 [T, C_out*nbytes], exactly the WAV data layout
    with global_timer.stage("mlp/unpack"):
        b = raw.reshape(T, out_ch, pack_bits // 8).astype(np.int32)
        if pack_bits == 16:
            v = b[..., 0] | (b[..., 1] << 8)
            return ((v ^ 0x8000) - 0x8000).astype(np.int32)
        v = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
        return ((v ^ 0x800000) - 0x800000).astype(np.int32)


def _decode_parsed(parse, boundaries, probe_end, parameters,
                   want_packed, config=None) -> np.ndarray | None:
    out_ch = parameters.channel_count
    if parse.F == 0:
        return np.zeros((0, out_ch), dtype=np.int32)

    F = _frame_cut(parse.frame_end, np.asarray(boundaries, dtype=np.int64),
                   probe_end)
    if F == 0:
        return np.zeros((0, out_ch), dtype=np.int32)
    frame_len = parse.frame_len[:F]
    T = int(frame_len.sum())
    Tb = _bucket(T)

    uniform = _try_uniform(parse, F, frame_len, T, out_ch,
                           parameters.bits_per_sample,
                           want_packed=want_packed, config=config)
    if uniform is not None:
        return uniform

    # ---------------- per-substream chain tables --------------------------
    subs = []
    for s in range(parse.substream_count):
        sub = parse.sub[s]
        nb_keep = int(sub["fr_nblocks"][:F].sum())
        lens = sub["len"][:nb_keep]
        n_ch = sub["shift"].shape[1]
        restarts = np.nonzero(sub["restart"][:nb_keep])[0]
        coupled = sub["fir_any"][restarts] != 0
        starts = [0] + [int(r) for i, r in enumerate(restarts)
                        if r != 0 and not coupled[i]] + [nb_keep]
        chain_start = np.asarray(starts[:-1], dtype=np.int64)
        chain_len = np.diff(np.asarray(starts, dtype=np.int64))
        n_chains = chain_start.shape[0]
        NB = _bucket(int(chain_len.max()) if chain_len.size else 1)
        Bc = _bucket(n_chains, lo=1)
        S = _bucket(int(lens.max()) if lens.size else 8)
        NBt = _bucket(max(nb_keep, 1))

        pos = np.arange(NB, dtype=np.int64)[None, :]
        cs = np.concatenate([chain_start, np.zeros(Bc - n_chains, np.int64)])
        cl = np.concatenate([chain_len, np.zeros(Bc - n_chains, np.int64)])
        bidx = np.minimum(cs[:, None] + pos, max(nb_keep - 1, 0)).astype(np.int32)
        bmask = pos < cl[:, None]

        def padNBt(x):
            out = np.zeros((NBt,) + x.shape[1:], dtype=x.dtype)
            out[: nb_keep] = x[:nb_keep]
            return out

        res = _padded_residuals(sub, nb_keep, S)

        # series index: t → flat [Bc*n_ch, NB, S] position for channel 0;
        # channel c adds c·NB·S (lane rows are chain-major, channel-minor)
        chain_of_block = np.repeat(np.arange(n_chains), chain_len)
        pos_of_block = np.arange(nb_keep) - chain_start[chain_of_block]
        blk_of_t = np.repeat(np.arange(nb_keep), lens)
        off_in_blk = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
        lane_row = chain_of_block[blk_of_t] * n_ch
        base = (lane_row * NB + pos_of_block[blk_of_t]) * S + off_in_blk
        series_idx = np.zeros((n_ch, Tb), dtype=np.int32)
        series_idx[:, : base.shape[0]] = (
            base[None, :] + (np.arange(n_ch) * NB * S)[:, None])

        subs.append(dict(
            res=padNBt(res),
            rc_fir=padNBt(sub["rc_fir"][:nb_keep]),
            rc_iir=padNBt(sub["rc_iir"][:nb_keep]),
            iir_init=padNBt(sub["iir_init"][:nb_keep]),
            shift=padNBt(sub["shift"][:nb_keep]),
            quant=padNBt(sub["quant"][:nb_keep]),
            iir_reset=padNBt(sub["iir_reset"][:nb_keep]),
            lens=padNBt(lens),
            bidx=bidx,
            bmask=bmask,
            series_idx=series_idx,
        ))

    # ---------------- frame tables ----------------------------------------
    Fb = _bucket(F)
    L = _bucket(int(frame_len.max()))
    t0 = np.concatenate([[0], np.cumsum(frame_len)]).astype(np.int64)
    starts = np.concatenate([t0[:-1], np.zeros(Fb - F, np.int64)])
    frame_idx = np.minimum(starts[:, None] + np.arange(L)[None, :],
                           Tb - 1).astype(np.int32)
    f_of_t = np.repeat(np.arange(F, dtype=np.int64), frame_len)
    l_of_t = np.arange(T, dtype=np.int64) - t0[f_of_t]
    flat_idx = np.zeros(Tb, dtype=np.int32)
    flat_idx[:T] = (f_of_t * L + l_of_t).astype(np.int32)

    noise01 = np.zeros((Tb, 2), dtype=np.int32)
    noise01[:T, 0] = parse.noise0[:T]
    noise01[:T, 1] = parse.noise1[:T]
    bypassed_t = np.zeros((Tb, 6), dtype=np.int8)
    bypassed_t[:T] = (
        (parse.bypassed_packed[:T, None] >> np.arange(6)) & 1
    ).astype(np.int8)

    def padF(x):
        pad = [(0, Fb - F)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x[:F], pad)

    out = _pipeline(
        tuple(subs), frame_idx, flat_idx, noise01, bypassed_t,
        padF(parse.mat_coeff), padF(parse.mat_noise), padF(parse.mat_out),
        padF(parse.mat_active), padF(parse.mat_quant),
        padF(parse.out_shift), _wave_perm(parse, out_ch),
    )
    return np.asarray(out)[:T]


def _wave_perm(parse, out_ch: int) -> np.ndarray:
    mapping = WAVE_CHANNEL[parse.assignment]
    perm = np.zeros(out_ch, dtype=np.int32)
    for c in range(out_ch):
        perm[mapping[c]] = c
    return perm


def _try_uniform(parse, F: int, frame_len: np.ndarray, T: int,
                 out_ch: int, bits_per_sample: int = 24,
                 want_packed: bool = False,
                 config: DecodeConfig | None = None) -> np.ndarray | None:
    """Attempt the gather-free arena pipeline; None if the stream is not
    uniform (varying block/frame sizes or uneven restart chains).

    Long tracks are split into fixed-size *chain chunks* (each a bucketed
    number of restart chains): every chunk shares one small XLA program
    (fast compile, reused forever) and chunks are dispatched
    asynchronously so staging and device compute overlap; chunk outputs
    stay device-resident until the drain, which fetches them with
    batched device-side concats (_fetch_pending — one read call per run
    of same-shape chunks).

    With ``want_packed`` (24-bit only) the device-packed little-endian
    3-byte samples are returned as uint8 [T, C*3] — exactly the WAV data
    layout — skipping the host-side unpack *and* the WAV writer's repack."""
    L0 = int(frame_len[0])
    if not (frame_len == L0).all():
        return None

    subs_info = []
    n_chains = None
    period = None  # samples per chain, must agree across substreams
    for s_idx in range(parse.substream_count):
        sub = parse.sub[s_idx]
        nb_keep = int(sub["fr_nblocks"][:F].sum())
        if nb_keep == 0:
            return None
        lens = sub["len"][:nb_keep]
        S0 = int(lens[0])
        if not (lens == S0).all():
            return None
        restart = sub["restart"][:nb_keep]
        restarts = np.nonzero(restart)[0]
        coupled = sub["fir_any"][restarts] != 0
        chain_starts = np.asarray(
            [0] + [int(r) for i, r in enumerate(restarts)
                   if r != 0 and not coupled[i]], dtype=np.int64)
        chain_lens = np.diff(np.concatenate([chain_starts, [nb_keep]]))
        NB0 = int(chain_lens[0])
        if not (chain_lens == NB0).all():
            return None
        nc = nb_keep // NB0
        per = NB0 * S0
        if n_chains is None:
            n_chains, period = nc, per
        elif nc != n_chains or per != period:
            return None
        subs_info.append((sub, 0, S0, NB0, 0))  # whole-stream: base 0
    if period % L0:
        return None

    # chains per chunk: fixed so every chunk shares one compiled program;
    # large enough that per-chunk dispatch round-trips stay negligible
    cfg = config if config is not None else default_config()
    CHUNK = cfg.resolved_chunk_chains(out_ch)
    pack_bits = _pack_bits(bits_per_sample)
    nstate = {"narrow": _narrow_tier0(pack_bits, out_ch, cfg),
              "checked": False}
    devices = _decode_devices(config)
    pending = []
    drainer = _Drainer(nstate) if cfg.drain_thread else None
    fpc = period // L0
    mat_mm = 0
    try:
        for ci, c0 in enumerate(range(0, n_chains, CHUNK)):
            c1 = min(c0 + CHUNK, n_chains)
            with global_timer.stage("mlp/stage+dispatch"):
                mat_mm = max(mat_mm, _max_matrix_slots(
                    parse.mat_active[c0 * fpc : c1 * fpc]))
                dev = _dispatch_uniform_chunk(
                    parse, subs_info, c0, c1, CHUNK,
                    period, L0, out_ch,
                    pack_bits=pack_bits,
                    device=(devices[ci % len(devices)]
                            if devices else None),
                    kernel=cfg.resolved_filter_kernel(),
                    native_pack=cfg.native_pack,
                    unroll=cfg.resolved_filter_unroll(),
                    mat_mm=mat_mm,
                    narrow=nstate["narrow"])
                if drainer is not None:
                    drainer.push(dev, (c1 - c0) * period)
                else:
                    pending.append((dev, (c1 - c0) * period))
                    _narrow_poll(pending, nstate)
            if drainer is not None:
                drainer.throttle()
        if drainer is not None:
            with global_timer.stage("mlp/device+d2h"):
                return drainer.finish(T, out_ch, pack_bits, want_packed)
        return _finish_uniform(pending, T, out_ch, pack_bits, want_packed,
                               narrow_state=nstate)
    finally:
        if drainer is not None:
            drainer.abort()  # no-op after a successful finish


def _decode_devices(config: DecodeConfig | None = None):
    """Device list for chunk round-robin, or None for default placement.

    Chain chunks are fully independent (no cross-chunk state, no
    collectives), so multi-chip decode is data parallelism over chunks:
    each chunk's arenas are placed on the next device and the shared
    program runs there.  Enabled with ``DVDA_MULTI_DEVICE=1``
    (exercised on a virtual CPU mesh by __graft_entry__.dryrun_multichip,
    and on four GPUs by ``chip_smoke.py --multi``)."""
    cfg = config if config is not None else default_config()
    if not cfg.multi_device:
        return None
    devs = jax.local_devices()
    return devs if len(devs) > 1 else None


def _dispatch_uniform_chunk(parse, subs_info, c0, c1, CHUNK, period, L0,
                            out_ch, pack_bits=0, device=None,
                            words_all=None, kernel="scan",
                            f_base=0, t_base=0, native_pack=True,
                            unroll=1, mat_mm=None, narrow=False):
    """Build arenas for section-relative chains [c0, c1) and dispatch the
    pipeline (async); returns the device array ([CHUNK*period, C_out],
    valid rows first).  ``subs_info`` carries (sub, block_base, S0, NB0)
    per substream; ``f_base``/``t_base`` are the section's absolute frame
    and sample offsets (nonzero for piecewise-uniform streams).

    With ``words_all`` (device-Huffman mode, a :class:`_SharedWords`) the
    chunk ships per-block decode tables instead of residual values and
    reads the raw bitstream from the track's shared device-resident word
    buffer; the residual kernel (ops/huffman_decode.py) re-decodes the
    values on device, fused ahead of the filter.

    Arena assembly runs in the native runtime by default (mp_pack via
    :class:`_NativeArenaBuilder`); ``native_pack=False`` (or a parse
    object without a live native handle) routes to the numpy
    implementation — the two produce identical arenas + spec (covered by
    a differential test)."""
    if native_pack and getattr(parse, "_h", None) is not None:
        return _dispatch_chunk_native(
            parse, subs_info, c0, c1, CHUNK, period, L0, out_ch,
            pack_bits=pack_bits, device=device, words_all=words_all,
            kernel=kernel, f_base=f_base, t_base=t_base,
            unroll=unroll, mat_mm=mat_mm, narrow=narrow)
    return _dispatch_chunk_py(
        parse, subs_info, c0, c1, CHUNK, period, L0, out_ch,
        pack_bits=pack_bits, device=device, words_all=words_all,
        kernel=kernel, f_base=f_base, t_base=t_base,
        unroll=unroll, mat_mm=mat_mm, narrow=narrow)


def _finish_dispatch(b, t_build, pack_bits, device, kernel, unroll=1,
                     narrow=False, words_dev=None):
    """Shared dispatch tail: filter-kernel mark, arena finish, packing
    flag, device placement, async pipeline call.  ``words_dev`` is the
    track's shared device-resident bitstream words (device-Huffman
    mode)."""
    import time as _time

    if kernel != "scan":  # DecodeConfig.resolved_filter_kernel
        b.mark("__triton__", int(kernel == "triton-interpret"))
    elif unroll > 1:
        b.mark("__unroll__", unroll)
    global_timer.add("mlp/arena-build", _time.perf_counter() - t_build)
    with global_timer.stage("mlp/arena-finish"):
        (a4, a2, a1), spec = b.finish()
    # 24-/16-bit streams return device-packed WAV-width samples
    # (25% / 50% less d2h than raw int32)
    tier = int(narrow or 0) if pack_bits == 24 else 0
    if pack_bits:
        wide_spec = spec + ((f"__pack{pack_bits}__", 0, 0, (), "flag"),)
        spec = wide_spec
        if tier:
            spec = wide_spec + (("__narrow__", 0, tier, (), "flag"),)
    with global_timer.stage("mlp/jit-call"):
        if device is not None:
            # committed inputs pin the chunk's program to this device
            a4, a2, a1 = (jax.device_put(a, device) for a in (a4, a2, a1))
        out = _uniform_arena_pipeline(a4, a2, a1, spec, words_dev)
        if tier:
            # keep the chunk's (device-resident) arenas alive so the
            # drain can rerun a wider program if the flag says the
            # chunk overflowed this tier: redo() runs the wide program
            # (exactly the narrow_d2h=False program, shared with the
            # compile cache); redo(16) the int16-tier program
            def redo(retier=0, a4=a4, a2=a2, a1=a1, wide_spec=wide_spec,
                     words_dev=words_dev):
                s = wide_spec if not retier else wide_spec + (
                    ("__narrow__", 0, retier, (), "flag"),)
                return _uniform_arena_pipeline(a4, a2, a1, s, words_dev)

            return out, redo, tier
        return out


def _dispatch_chunk_native(parse, subs_info, c0, c1, CHUNK, period, L0,
                           out_ch, pack_bits=0, device=None,
                           words_all=None, kernel="scan",
                           f_base=0, t_base=0, unroll=1, mat_mm=None, narrow=False):
    """Native-pack dispatch (see _dispatch_uniform_chunk)."""
    from ...ops.lfsr import _jump_columns

    import time as _time

    b = _NativeArenaBuilder(parse)
    fpc = period // L0
    f0 = f_base + c0 * fpc
    f1 = f_base + c1 * fpc
    t0, t1 = t_base + c0 * period, t_base + c1 * period
    _t_build = _time.perf_counter()
    base_bit = 0
    words_dev = None
    if words_all is not None:
        base_bit = _chunk_word_base(subs_info, c0)
        words_dev = words_all.on(device)
        b.add_host("wordbase", np.asarray(base_bit >> 5, np.int32))
    for s_idx, si in enumerate(subs_info):
        sub, blk_base, S0, NB0 = si[:4]
        suboff_base = si[4] if len(si) > 4 else None
        blk0, blk1 = blk_base + c0 * NB0, blk_base + c1 * NB0
        n_ch = sub["shift"].shape[1]

        def chain(name, src, inner_shape, dtype):
            b.add_chain(name, src, s_idx, blk0, blk1, NB0, CHUNK,
                        inner_shape, dtype)

        if words_all is not None:
            k = int(sub.get("sub_every", 0) or 0)
            if k:
                nsub = -(-S0 // k)
                if suboff_base is not None:  # O(1): section counter
                    off0 = suboff_base + (blk0 - blk_base) * nsub
                else:  # legacy caller: prefix-sum over preceding blocks
                    off0 = int((-(-sub["len"][:blk0].astype(np.int64)
                                  // k)).sum())
                b.mark(f"s{s_idx}_k", min(k, S0))
            else:
                nsub, off0 = 1, -1
                b.mark(f"s{s_idx}_k", S0)
            b.add_bitpos(f"s{s_idx}_bitpos", s_idx, blk0, blk1, NB0, nsub,
                         CHUNK, base_bit, off0)
            b.mark(f"s{s_idx}_NW",
                   _window_rows(sub.get("sub_span_max", 0)))
            chain(f"s{s_idx}_cb", "codebook", (n_ch,), np.int8)
            chain(f"s{s_idx}_lsbb", "lsb_bits", (n_ch,), np.int8)
            chain(f"s{s_idx}_off", "res_offset", (n_ch,), np.int32)
            chain(f"s{s_idx}_nbyp", "nbyp", (), np.int8)
            b.mark(f"s{s_idx}_S", S0)
            b.mark(f"s{s_idx}_J",
                   n_ch + (1 if sub["nbyp"][blk0:blk1].any() else 0))
            if s_idx == len(subs_info) - 1:
                # bypassed-LSB slot map (small: [nblk, 6] numpy)
                bits = ((sub["byp_mask"][blk0:blk1][:, None].astype(np.int32)
                         >> np.arange(6)) & 1)
                kidx = (np.cumsum(bits, axis=1) - bits).astype(np.int8)

                def chainview(x):
                    out = np.zeros((CHUNK, NB0) + x.shape[1:], x.dtype)
                    out[: x.shape[0] // NB0] = x.reshape(
                        (-1, NB0) + x.shape[1:])
                    return out

                b.add_host(f"s{s_idx}_bypk", chainview(kidx))
                b.add_host(f"s{s_idx}_bypv", chainview(bits.astype(np.int8)))
        else:
            amax = sub.get("res_amax")
            res_dtype = np.int16 if (amax is not None
                                     and amax <= 32767) else np.int32
            b.add_res(f"s{s_idx}_res", s_idx, t0, t1, CHUNK, NB0, n_ch, S0,
                      res_dtype)

        # see _dispatch_chunk_py for the per-chain rationale
        per_chain = NB0 == 1 or not (
            sub["param_update"][blk0:blk1].reshape(-1, NB0)[:, 1:].any())
        if per_chain:
            def head(name, src, inner_shape, dtype):
                b.add_head(name, src, s_idx, blk0, blk1, NB0, CHUNK,
                           inner_shape, dtype)

            head(f"s{s_idx}_rc_fir_c", "rc_fir", (n_ch, 8), np.int16)
            head(f"s{s_idx}_rc_iir_c", "rc_iir", (n_ch, 8), np.int16)
            head(f"s{s_idx}_iir_init_c", "iir_init", (n_ch, 8), np.int32)
            head(f"s{s_idx}_shift_c", "shift", (n_ch,), np.int8)
            head(f"s{s_idx}_quant_c", "quant", (n_ch,), np.int8)
            head(f"s{s_idx}_iir_reset_c", "iir_reset", (n_ch,), np.int8)
        else:
            chain(f"s{s_idx}_rc_fir", "rc_fir", (n_ch, 8), np.int16)
            chain(f"s{s_idx}_rc_iir", "rc_iir", (n_ch, 8), np.int16)
            chain(f"s{s_idx}_iir_init", "iir_init", (n_ch, 8), np.int32)
            chain(f"s{s_idx}_shift", "shift", (n_ch,), np.int8)
            chain(f"s{s_idx}_quant", "quant", (n_ch,), np.int8)
            chain(f"s{s_idx}_iir_reset", "iir_reset", (n_ch,), np.int8)

    T_pad = CHUNK * period
    F_pad = T_pad // L0
    b.add_frame("mat_coeff", "mat_coeff", f0, f1, F_pad, (6, 8), np.int16)
    b.add_frame("mat_noise", "mat_noise", f0, f1, F_pad, (6, 2), np.int16)
    b.add_frame("mat_out", "mat_out", f0, f1, F_pad, (6,), np.int8)
    b.add_frame("mat_active", "mat_active", f0, f1, F_pad, (6,), np.int8)
    b.mark("mat_mm", mat_mm if mat_mm is not None
           else _max_matrix_slots(parse.mat_active[:f1]))
    b.add_frame("mat_quant", "mat_quant", f0, f1, F_pad, (6,), np.int8)
    b.add_frame("out_shift", "out_shift", f0, f1, F_pad, (8,), np.int8)
    b.add_host("wave_perm", _wave_perm(parse, out_ch).astype(np.int8))
    b.add_frame("frame_seed", "frame_seed", f0, f1, F_pad, (), np.uint32)
    b.add_frame("frame_nshift", "frame_nshift", f0, f1, F_pad, (), np.int8)
    if words_all is None:
        b.add_byp("byp", t0, t1, T_pad)
    K = max(1, int(np.ceil(np.log2(max(L0, 2)))))
    jumps = np.array([_jump_columns(k) for k in range(K)], dtype=np.uint32)
    b.add_host("jumps", jumps)
    return _finish_dispatch(b, _t_build, pack_bits, device, kernel,
                            unroll, narrow=narrow, words_dev=words_dev)


def _dispatch_chunk_py(parse, subs_info, c0, c1, CHUNK, period, L0,
                       out_ch, pack_bits=0, device=None,
                       words_all=None, kernel="scan",
                       f_base=0, t_base=0, unroll=1, mat_mm=None, narrow=False):
    """Numpy-pack dispatch (fallback + differential reference for
    _dispatch_chunk_native; see _dispatch_uniform_chunk)."""
    from ...ops.lfsr import _jump_columns

    import time as _time

    b = _ArenaBuilder()
    nc = c1 - c0
    fpc = period // L0
    f0 = f_base + c0 * fpc
    f1 = f_base + c1 * fpc
    t0, t1 = t_base + c0 * period, t_base + c1 * period
    _t_build = _time.perf_counter()
    base_bit = 0
    words_dev = None
    if words_all is not None:
        base_bit = _chunk_word_base(subs_info, c0)
        words_dev = words_all.on(device)
        b.add("wordbase", np.asarray(base_bit >> 5, np.int32))
    for s_idx, si in enumerate(subs_info):
        sub, blk_base, S0, NB0 = si[:4]
        suboff_base = si[4] if len(si) > 4 else None
        blk0, blk1 = blk_base + c0 * NB0, blk_base + c1 * NB0

        def chainview(x, dtype=None, NB0=NB0):
            """Pre-sliced block-range array [(blk1-blk0), …] → chain view
            [CHUNK, NB0, …] (zero-padded trailing chains)."""
            dtype = dtype or x.dtype
            out = np.zeros((CHUNK, NB0) + x.shape[1:], dtype=dtype)
            out[: x.shape[0] // NB0] = x.reshape((-1, NB0) + x.shape[1:])
            return out

        if words_all is not None:
            n_ch = sub["codebook"].shape[1]
            bp = (sub["res_bitpos"][blk0:blk1] - base_bit).astype(np.int32)
            k = int(sub.get("sub_every", 0) or 0)
            if k:
                # sub-lane split: per-block every-k-sample offsets widen
                # bitpos to [nblk, nsub] — the kernel scans k·J steps over
                # nsub× the lanes (ops/huffman_decode.py).  Preceding
                # blocks each hold ceil(len/k) flat entries.
                nsub = -(-S0 // k)
                if suboff_base is not None:  # O(1): section counter
                    off0 = suboff_base + (blk0 - blk_base) * nsub
                else:
                    off0 = int((-(-sub["len"][:blk0].astype(np.int64)
                                  // k)).sum())
                rel = sub["sub_bitpos"][off0 : off0 + (blk1 - blk0) * nsub]
                bp = bp[:, None] + rel.reshape(blk1 - blk0, nsub)
                b.mark(f"s{s_idx}_k", min(k, S0))
            else:
                bp = bp[:, None]
                b.mark(f"s{s_idx}_k", S0)
            b.add(f"s{s_idx}_bitpos", chainview(bp))
            b.mark(f"s{s_idx}_NW",
                   _window_rows(sub.get("sub_span_max", 0)))
            b.add(f"s{s_idx}_cb",
                  chainview(sub["codebook"][blk0:blk1], np.int8))
            b.add(f"s{s_idx}_lsbb",
                  chainview(sub["lsb_bits"][blk0:blk1], np.int8))
            b.add(f"s{s_idx}_off", chainview(sub["res_offset"][blk0:blk1]))
            nbyp = sub["nbyp"][blk0:blk1]
            b.add(f"s{s_idx}_nbyp", chainview(nbyp.view(np.int8)))
            b.mark(f"s{s_idx}_S", S0)
            b.mark(f"s{s_idx}_J", n_ch + (1 if nbyp.any() else 0))
            if s_idx == len(subs_info) - 1:
                # bypassed-LSB slot map for the final substream: slot m's
                # bit is the k-th bypass symbol, k = popcount of lower mask
                bits = ((sub["byp_mask"][blk0:blk1][:, None].astype(np.int32)
                         >> np.arange(6)) & 1)
                kidx = (np.cumsum(bits, axis=1) - bits).astype(np.int8)
                b.add(f"s{s_idx}_bypk", chainview(kidx))
                b.add(f"s{s_idx}_bypv", chainview(bits.astype(np.int8)))
        else:
            res = _padded_residuals_range(
                sub, t0, t1, blk1 - blk0, S0)
            # the parser tracks max |residual| — no host scan needed
            amax = sub.get("res_amax")
            res_dtype = np.int16 if (
                amax <= 32767 if amax is not None
                else (np.abs(res) < 32768).all()) else np.int32
            res_c = np.zeros((CHUNK, NB0) + res.shape[1:], dtype=res_dtype)
            res_c[: (blk1 - blk0) // NB0] = res.reshape(
                (-1, NB0) + res.shape[1:])
            b.add(f"s{s_idx}_res", res_c)

        # real encoders set filter/coding parameters at restarts only; when
        # no non-head block re-reads decoding parameters (the parser's
        # per-block param_update flag — a byte scan, not an array compare;
        # sticky state means "no re-read" implies "identical rows", and IIR
        # resets only come from parameter reads), ship one row per chain —
        # NB0× less coefficient traffic
        per_chain = NB0 == 1 or not (
            sub["param_update"][blk0:blk1].reshape(-1, NB0)[:, 1:].any())
        if per_chain:
            def headview(x, dtype=None):
                """Chain-head rows [nc, …] → [CHUNK, …] (zero-padded)."""
                heads = x[blk0:blk1:NB0]
                out = np.zeros((CHUNK,) + heads.shape[1:],
                               dtype=dtype or x.dtype)
                out[: heads.shape[0]] = heads
                return out

            b.add(f"s{s_idx}_rc_fir_c", headview(sub["rc_fir"], np.int16))
            b.add(f"s{s_idx}_rc_iir_c", headview(sub["rc_iir"], np.int16))
            b.add(f"s{s_idx}_iir_init_c", headview(sub["iir_init"]))
            b.add(f"s{s_idx}_shift_c", headview(sub["shift"], np.int8))
            b.add(f"s{s_idx}_quant_c", headview(sub["quant"], np.int8))
            b.add(f"s{s_idx}_iir_reset_c",
                  headview(sub["iir_reset"]).view(np.int8))
        else:
            b.add(f"s{s_idx}_rc_fir", chainview(sub["rc_fir"][blk0:blk1], np.int16))
            b.add(f"s{s_idx}_rc_iir", chainview(sub["rc_iir"][blk0:blk1], np.int16))
            b.add(f"s{s_idx}_iir_init", chainview(sub["iir_init"][blk0:blk1]))
            b.add(f"s{s_idx}_shift", chainview(sub["shift"][blk0:blk1], np.int8))
            b.add(f"s{s_idx}_quant", chainview(sub["quant"][blk0:blk1], np.int8))
            b.add(f"s{s_idx}_iir_reset", chainview(sub["iir_reset"][blk0:blk1], np.int8))

    T_pad = CHUNK * period
    F_pad = T_pad // L0

    def padF(x, dtype=None):
        seg = x[f0:f1]
        pad = [(0, F_pad - seg.shape[0])] + [(0, 0)] * (x.ndim - 1)
        out = np.pad(seg, pad)
        return out.astype(dtype) if dtype is not None else out

    # matrix coefficients are ≤16-bit by format ((frac+2 ≤ 16)-bit values
    # scaled to 14 fractional bits, mlp.c:1016-1019) — int16 safe
    b.add("mat_coeff", padF(parse.mat_coeff, np.int16))
    b.add("mat_noise", padF(parse.mat_noise, np.int16))
    b.add("mat_out", padF(parse.mat_out, np.int8))
    b.add("mat_active", padF(parse.mat_active, np.int8))
    b.mark("mat_mm", mat_mm if mat_mm is not None
           else _max_matrix_slots(parse.mat_active[:f1]))
    b.add("mat_quant", padF(parse.mat_quant, np.int8))
    b.add("out_shift", padF(parse.out_shift, np.int8))
    b.add("wave_perm", _wave_perm(parse, out_ch).astype(np.int8))
    b.add("frame_seed", padF(parse.frame_seed))
    b.add("frame_nshift", padF(parse.frame_nshift, np.int8))
    if words_all is None:
        byp = np.zeros(T_pad, dtype=np.int8)
        byp[: t1 - t0] = parse.bypassed_packed[t0:t1].view(np.int8)
        b.add("byp", byp)  # device-Huffman mode decodes these on device
    K = max(1, int(np.ceil(np.log2(max(L0, 2)))))
    jumps = np.array([_jump_columns(k) for k in range(K)], dtype=np.uint32)
    b.add("jumps", jumps)

    return _finish_dispatch(b, _t_build, pack_bits, device, kernel,
                            unroll, narrow=narrow, words_dev=words_dev)


def _padded_residuals_range(sub, t_lo: int, t_hi: int, n_blocks: int,
                            S0: int) -> np.ndarray:
    """Residuals for a block range → [n_blocks, n_ch, S0].  The flat array
    is ragged per block, so the range is addressed by absolute *sample*
    offsets (valid across sections with different block sizes)."""
    n_ch = sub["shift"].shape[1]
    flat = sub["residuals"]
    return flat[t_lo * n_ch : t_hi * n_ch].reshape(n_blocks, n_ch, S0)

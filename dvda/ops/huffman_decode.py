"""On-device MLP Huffman residual decode — gather-free formulation.

Reference analog: ``decode_residual_data`` (mlp.c:1122-1241), a per-sample
host loop over Huffman codes + LSB fields.  Device formulation: the host
parser's *skip-values* mode (host/src/mlp_parse.cc) walks residual bits
length-only and emits per-block decode tables plus every k-th sample's
bit offset; this kernel then re-decodes the values from the **raw
bitstream** in parallel — each k-sample run is an independent lane, so
only the ``k·J`` symbols inside a run decode sequentially (``lax.scan``).

The design removes every in-scan gather (an element gather per symbol
would dominate the scan body):

* **window fetch** — each lane's bit span is covered by two NW-word
  *aligned* rows of the chunk window (`words.reshape(-1, NW)`), fetched
  once per chunk by row gather (contiguous minor-dim slices, which XLA
  vectorises, unlike element gathers);
* **in-scan word access** — a log2(2·NW)-level select tree over the
  lane's private 2·NW-word window (pure `where`s);
* **codebook decode** — the three MLP codebooks are unary-structured
  (codebooks.py), so (value, length) is computed *arithmetically* from
  the 9-bit peek: bit-length via 9 compares, the "01 0^m 1" mid-class
  via the bit-length of the low 7 bits, plus two short-prefix specials
  per codebook.  Validated exhaustively against the peek LUTs for every
  valid 9-bit peek (tests/test_huffman_device.py).

Symbol schedule: the scan runs one step per SAMPLE with the C channel
slots unrolled inside the body (per-slot parameters are static
leading-axis slices — no dynamic indexing).  The bypass burst is fused
into channel 0's slot: its fetch reads a third window word so the
shifted symbol (burst ≤6 + code ≤9 + LSB ≤24 = 39 bits) still decodes
from one fetch — a sample costs C slot bodies, not C+1.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["decode_residuals_device", "decode_residuals_numpy",
           "codebook_arith_decode"]


def codebook_arith_decode(cb_is1, cb_is2, cb_is3, p):
    """(msb_value, code_length) for the 9-bit peek ``p`` under the
    codebook selected by the boolean masks (exactly one true for lanes
    with a codebook; all false → (0, 0) is handled by the caller's
    ``use_cb`` mask).  Pure vector arithmetic — see module docstring."""
    def bitlen9(x):
        # exact bit-length via the f32 exponent (x < 2**24 converts
        # exactly; bitlen(x) = unbiased exponent + 1 for x > 0): 4 ops
        # where the compare ladder costs 18
        e = (jax.lax.bitcast_convert_type(x.astype(jnp.float32),
                                          jnp.int32) >> 23) - 126
        return jnp.where(x > 0, e, 0)

    m = 9 - bitlen9(p)                   # leading zeros of the 9-bit peek
    m01 = 7 - bitlen9(p & 0x7F)          # zeros after a "01" prefix
    top1 = p >> 8
    top2 = p >> 7
    mid = top2 == 1                      # "01 0^m01 1" class (all books)
    # codebook 1: 1xx→top3+3 (len 3) | 01…→11+m01 | 00…→8-m (len m+1)
    v1 = jnp.where(top1 == 1, (p >> 6) + 3, jnp.where(mid, 11 + m01, 8 - m))
    n1 = jnp.where(top1 == 1, 3, jnp.where(mid, 3 + m01, m + 1))
    # codebook 2: 11→8, 10→7 (len 2) | 01…→9+m01 | 00…→8-m
    v2 = jnp.where(top2 == 3, 8, jnp.where(top2 == 2, 7,
                                           jnp.where(mid, 9 + m01, 8 - m)))
    n2 = jnp.where(top2 >= 2, 2, jnp.where(mid, 3 + m01, m + 1))
    # codebook 3: 1→7 (len 1) | 01…→8+m01 | 00…→8-m
    v3 = jnp.where(top1 == 1, 7, jnp.where(mid, 8 + m01, 8 - m))
    n3 = jnp.where(top1 == 1, 1, jnp.where(mid, 3 + m01, m + 1))
    val = jnp.where(cb_is1, v1, jnp.where(cb_is2, v2, v3))
    nb = jnp.where(cb_is1, n1, jnp.where(cb_is2, n2, n3))
    return val, nb


@partial(jax.jit, static_argnums=(7, 8, 9, 10, 11))
def decode_residuals_device(
    words,      # uint32 [W]      bitstream words, W a multiple of NW
                # (whole-track shared buffer, or a per-chunk window)
    bitpos0,    # int32  [L, nsub]  per-sub-lane start bit, relative to
                # word_base*32 (word_base = 0 for a per-chunk window)
    codebook,   # int32  [L, C]   0 = no Huffman MSB
    lsb_bits,   # int32  [L, C]   0..24 (parser-enforced, mlp.c:975 analog)
    offset,     # int32  [L, C]   signed huffman offset (precombined)
    quant,      # int32  [L, C]   left-shift applied to the sum
    nbyp,       # int32  [L]      bypassed-LSB bits per sample (<= 6)
    S0: int,    # samples per block (static)
    J: int,     # slots per sample: C, or C+1 when any lane has bypass
                # (slot 0 is then the bypass-burst slot)
    k: int,     # samples per sub-lane (static); nsub*k >= S0
    NW: int,    # window row words (static, power of two); a sub-lane's
                # span + 64-bit guard must fit in NW*32 bits
    NB0: int = 0,  # static: when > 0, L factors as (Bc, NB0) chain-major
                # and residuals return TIME-LEADING [NB0, S0, C*Bc]
                # (filter-ready, channel-major lanes) via ONE permute
                # whose minor dims are (C, Bc) — the [C, L, S0] epilogue
                # would materialize a minor-40 intermediate
    word_base=None,  # int32 scalar: base WORD index of this chunk's bit
                # positions inside ``words`` — lets one whole-track
                # device buffer serve every chunk while bitpos stays
                # int32-safe for arbitrarily long tracks.  MUST be a
                # multiple of NW (callers align to 8192 words).  None/0 =
                # bitpos indexes ``words`` directly.
):
    """Returns (residuals int32 [C, L, S0], byp_field int32 [L, S0]) —
    or (residuals_tl int32 [NB0, S0, C*Bc], byp_field) when NB0 > 0.

    ``byp_field`` is the raw 6-bit burst field per sample (bit ``5-k`` =
    the ``k``-th bypassed-LSB symbol, bits ``k >= nbyp[lane]`` zeroed);
    the caller maps symbols to rematrix slots with per-lane shifts.
    Channel-major residuals + a packed bypass field keep **S0 as the
    minor dimension everywhere** (an [L, S0, J] / [L, S0, 6] epilogue
    would keep the narrow J axis minor).

    Per sample the scan runs ONE step with C slot bodies unrolled; the
    bypass burst (all ≤6 bypassed-LSB bits, read together from the
    window's top bits) is fused into slot 0, whose fetch covers three
    window words so the nbyp-shifted symbol still reads from one fetch.
    ``J`` only signals whether any lane has bypass (J == C + 1)."""
    L, C = codebook.shape
    if C == 0:
        return (jnp.zeros((0, L, S0), jnp.int32),
                jnp.zeros((L, S0), jnp.int32))
    nsub = bitpos0.shape[1]
    Lp = L * nsub
    u32 = jnp.uint32
    LOG = NW.bit_length() - 1
    has_burst = J == C + 1

    # ---- per-lane aligned windows: two NW-word rows per sub-lane -------
    words2d = words.reshape(-1, NW)
    flat_bp = bitpos0.reshape(Lp)
    row = (flat_bp >> (5 + LOG)).astype(jnp.int32)
    fetch_row = row if word_base is None else row + (word_base >> LOG)
    win = jnp.concatenate(
        [jnp.take(words2d, fetch_row, axis=0),
         jnp.take(words2d, fetch_row + 1, axis=0)], axis=1)  # [Lp, 2*NW]
    local0 = flat_bp - (row << (5 + LOG))                   # [0, 2*NW*32)

    def sel(i):  # win[:, i] via a select tree (no gather); i int32 [Lp]
        w = win
        for lev in reversed(range(LOG + 1)):
            half = 1 << lev
            w = jnp.where(((i >> lev) & 1).astype(bool)[:, None],
                          jax.lax.slice_in_dim(w, half, 2 * half, axis=1),
                          jax.lax.slice_in_dim(w, 0, half, axis=1))
        return w[:, 0]

    # ---- per-slot parameters [C, L'] — static leading-axis index ------
    def cols(x):  # [L, C] → [C, L*nsub]
        return (jnp.broadcast_to(x.T[:, :, None], (C, L, nsub))
                .reshape(C, Lp))

    cb_c, lbb_c = cols(codebook), cols(lsb_bits)
    off_c, qq_c = cols(offset), cols(quant)
    nbyp_l = jnp.broadcast_to(nbyp[:, None], (L, nsub)).reshape(Lp)
    nbyp_u = nbyp_l.astype(u32)
    # keep bits k < nbyp of the 6-bit burst field (rest is stream noise)
    byp_keep = 0x3F & ~((1 << (6 - nbyp_l)) - 1)

    def step(bitpos, _):
        """One SAMPLE: C unrolled slot bodies; the bypass burst is fused
        into slot 0 (its window fetch reads a third word so the shifted
        symbol — burst ≤6 + code ≤9 + LSB ≤24 = 39 bits — still comes
        from one fetch)."""
        vals = []
        packed = jnp.zeros((Lp,), jnp.int32)
        for j in range(C):
            cb_r, lbb_r = cb_c[j], lbb_c[j]
            off_r, qq_r = off_c[j], qq_c[j]
            idx = bitpos >> 5
            w0 = sel(idx)
            w1 = sel(idx + 1)
            b = (bitpos & 31).astype(u32)
            inv = (u32(32) - b) & u32(31)
            nz = b > 0
            hi = (w0 << b) | jnp.where(nz, w1 >> inv, u32(0))
            if j == 0 and has_burst:
                # burst field = top 6 bits at the sample start
                packed = (hi >> u32(26)).astype(jnp.int32) & byp_keep
                # slot 0's symbol starts nbyp bits in: shift a 64-bit
                # window (hi:hi2) left by nbyp — needs word idx+2
                w2 = sel(idx + 2)
                hi2 = (w1 << b) | jnp.where(nz, w2 >> inv, u32(0))
                sh = nbyp_u
                # mask like every other shift here: nbyp==0 lanes feed
                # the discarded where-branch a shift of 32 otherwise
                # (implementation-defined under XLA shift semantics)
                hi = jnp.where(nbyp_l > 0,
                               (hi << sh) | (hi2 >> ((u32(32) - sh)
                                                     & u32(31))), hi)
                # window bit 32 (after the shift) = hi2 bit nbyp
                ext = (hi2 >> (u32(31) - sh)) & u32(1)
                adv0 = nbyp_l
            else:
                ext = (w1 >> ((u32(31) - b) & u32(31))) & u32(1)
                adv0 = 0

            p9 = (hi >> u32(23)).astype(jnp.int32)
            msb, nb = codebook_arith_decode(cb_r == 1, cb_r == 2,
                                            cb_r == 3, p9)
            use_cb = cb_r > 0
            nb = jnp.where(use_cb, nb, 0)
            msb = jnp.where(use_cb, msb, 0)

            # LSB field = window bits [nb, nb+lbb), nb+lbb <= 33: the
            # 32-bit peek plus the single extension bit covers it
            e = nb + lbb_r
            r33 = jnp.where(e <= 32,
                            hi >> (((32 - e) & 31).astype(u32)),
                            (hi << u32(1)) | ext)
            lbb_u = lbb_r.astype(u32)
            lsb = jnp.where(lbb_r > 0,
                            (r33 & ((u32(1) << lbb_u) - u32(1)))
                            .astype(jnp.int32), 0)

            vals.append(((msb << lbb_r) + lsb + off_r) << qq_r)
            bitpos = bitpos + adv0 + nb + lbb_r
        return bitpos, (jnp.stack(vals), packed)

    _, (outs, byps) = jax.lax.scan(step, local0, None, length=k)

    if has_burst:
        byp = (byps.reshape(k, L, nsub).transpose(1, 2, 0)
               .reshape(L, nsub * k)[:, :S0])           # [L, S0]
    else:
        byp = jnp.zeros((L, S0), jnp.int32)

    if NB0 > 0:
        # step i of sub-lane u is sample u*k+i; one permute straight to
        # the filter's time-leading layout, minor dims (C, Bc)
        Bc = L // NB0
        samp = (outs.reshape(k, C, Bc, NB0, nsub)
                .transpose(3, 4, 0, 1, 2)               # [NB0,u,i,C,Bc]
                .reshape(NB0, nsub * k, C * Bc)[:, :S0])
        return samp, byp                                # [NB0, S0, C*Bc]

    # one major permute puts channels leading and samples minor; every
    # later slice is a free leading-axis index, S0 minor end to end
    samp = (outs.reshape(k, C, L, nsub).transpose(1, 2, 3, 0)
            .reshape(C, L, nsub * k)[:, :, :S0])        # [C, L, S0]
    return samp, byp


def decode_residuals_numpy(stream: bytes, sub: dict, lut_vals: np.ndarray,
                           lut_lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Executable numpy specification of the device kernel over a whole
    skip-values substream table (uniform block sizes); returns
    (residuals [NB, n_ch, S0], byp [NB, S0, 6]).  Test oracle only."""
    NB = sub["NB"]
    n_ch = sub["codebook"].shape[1]
    S0 = int(sub["len"][0])
    data = np.frombuffer(bytes(stream) + b"\0" * 8, np.uint8)

    def bits(pos, n):
        if n == 0:
            return 0
        w = int.from_bytes(bytes(data[pos >> 3 : (pos >> 3) + 8]), "big")
        return (w >> (64 - (pos & 7) - n)) & ((1 << n) - 1)

    res = np.zeros((NB, n_ch, S0), np.int32)
    byp = np.zeros((NB, S0, 6), np.int32)
    for b in range(NB):
        pos = int(sub["res_bitpos"][b])
        mask = int(sub["byp_mask"][b])
        slots = [m for m in range(6) if (mask >> m) & 1]
        for i in range(S0):
            for m in slots:
                byp[b, i, m] = bits(pos, 1)
                pos += 1
            for ci in range(n_ch):
                cb = int(sub["codebook"][b, ci])
                lb = int(sub["lsb_bits"][b, ci])
                off = int(sub["res_offset"][b, ci])
                q = int(sub["quant"][b, ci])
                msb = 0
                if cb:
                    p9 = bits(pos, 9)
                    msb = int(lut_vals[cb * 512 + p9])
                    pos += int(lut_lens[cb * 512 + p9])
                lsb = bits(pos, lb)
                pos += lb
                vv = (((msb << lb) + lsb + off) << q) & 0xFFFFFFFF
                res[b, ci, i] = vv - (1 << 32) if vv >= (1 << 31) else vv
    return res, byp

"""CPPM sector decryption on the device — batched C2 D-CBC in plain JAX.

Reference analog: the per-sector scalar loop cppm.c:531-566 (key chain)
and c2_dcbc cppm.c:486-529.  The D-CBC chain is sequential over a
sector's 240 words but independent across sectors, so a whole disc's
encrypted sectors decrypt as one ``lax.scan`` of 240 steps with all
sectors vectorised in lanes — pure uint32 elementwise work.  The per-sector
content-key derivation (four chained ``c2_g`` applications over sector
header fields) is likewise vectorised.

Used by dvda.cppm.decrypt when a device is available and the batch is
large; the numpy implementation (cppm/c2.py) is the host fallback and the
spec both are tested against.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..cppm.c2 import SBOX, SBOX_F

__all__ = ["dcbc_dec_device", "content_keys_device"]

# host-side numpy constants: module-level *device* arrays captured in
# traces trigger the jax-0.9 hoisted-constant cache bug (see
# ops/exact_int.py); numpy constants embed safely in the jaxpr
_SBOX = np.asarray(SBOX, dtype=np.uint32)
_SBOX_F = np.asarray(SBOX_F, dtype=np.uint32)


def _F(code, key):
    work = code + key
    work = work ^ jnp.take(_SBOX_F, (work & jnp.uint32(0xFF)).astype(jnp.int32))
    rol9 = (work << jnp.uint32(9)) | (work >> jnp.uint32(23))
    rol22 = (work << jnp.uint32(22)) | (work >> jnp.uint32(10))
    return work ^ rol9 ^ rol22


def _schedule(ka, kb, rounds: int):
    """Subkeys from the 56-bit key halves; returns list of uint32 [N]."""
    sk = []
    for rnd in range(rounds):
        ka = ka & jnp.uint32(0x00FFFFFF)
        sbox_idx = ((ka & jnp.uint32(0xFF)) ^ jnp.uint32(rnd)).astype(jnp.int32)
        sk.append(kb + (jnp.take(_SBOX, sbox_idx) << jnp.uint32(4)))
        kc = kb >> jnp.uint32(15)
        kd = ka >> jnp.uint32(7)
        ka = (ka << jnp.uint32(17)) | kc
        kb = (kb << jnp.uint32(17)) | kd
    return sk


def _enc_rounds(L, R, sk, rounds: int):
    for rnd in range(10):
        L = L + _F(R, sk[rnd % rounds])
        L, R = R, L
    return R, L  # final swap


def _c2_g_vec(hi, lo, key_hi, key_lo):
    """c2_g over uint32 half arrays; key halves are (hi24, lo32)."""
    sk = _schedule(key_hi, key_lo, 10)
    eL, eR = _enc_rounds(hi, lo, sk, 10)
    return eL ^ hi, eR ^ lo


def content_keys_device(fields, kau_hi, kau_lo):
    """Per-sector content keys from the 5 header fields
    (cppm.c:540-556).  ``fields``: uint32 [N, 5, 2] (hi/lo of the 64-bit
    values at offsets 24/32/40/48/84); returns (hi24, lo32) uint32 [N]."""
    khi = jnp.full(fields.shape[0], jnp.uint32(kau_hi))
    klo = jnp.full(fields.shape[0], jnp.uint32(kau_lo))
    for i in range(5):
        ghi, glo = _c2_g_vec(fields[:, i, 0], fields[:, i, 1], khi, klo)
        khi = ghi & jnp.uint32(0x00FFFFFF)
        klo = glo
    return khi, klo


@jax.jit
def dcbc_dec_device(words, fields, kau):
    """Decrypt D-CBC spans for a sector batch.

    words: uint32 [N, 240, 2] (hi/lo of each big-endian 64-bit word);
    fields: uint32 [N, 5, 2] header key fields; kau: uint32 [2] (hi24, lo).
    Returns decrypted words, same shape.
    """
    key_hi, key_lo = content_keys_device(fields, kau[0], kau[1])

    def dec_block(L, R, sk, rounds: int):
        cap_hi = cap_lo = None
        for rnd in range(9, -1, -1):
            L = L - _F(R, sk[rnd % rounds])
            L, R = R, L
            if rnd == 5:
                cap_hi = R & jnp.uint32(0x00FFFFFF)
                cap_lo = L
        L, R = R, L  # final swap (cppm.c:522)
        return L, R, cap_hi, cap_lo

    def step(carry, w):
        ikh, ikl, first = carry
        # the first word uses a 10-round key schedule, later words re-key
        # from the round-5 Feistel state with a 2-round schedule
        # (cppm.c:504-528); both variants are computed and selected to
        # keep the scan branch-free
        L10, R10, ch10, cl10 = dec_block(w[:, 0], w[:, 1],
                                         _schedule(ikh, ikl, 10), 10)
        L2, R2, ch2, cl2 = dec_block(w[:, 0], w[:, 1],
                                     _schedule(ikh, ikl, 2), 2)
        L = jnp.where(first, L10, L2)
        R = jnp.where(first, R10, R2)
        nkh = key_hi ^ jnp.where(first, ch10, ch2)
        nkl = key_lo ^ jnp.where(first, cl10, cl2)
        return (nkh, nkl, jnp.zeros_like(first)), jnp.stack([L, R], axis=1)

    N = words.shape[0]
    init = (key_hi, key_lo, jnp.ones(N, dtype=bool))
    _, out = jax.lax.scan(step, init, jnp.moveaxis(words, 1, 0))
    return jnp.moveaxis(out, 0, 1)

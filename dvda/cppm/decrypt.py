"""CPPM sector decryption — batched over whole sector runs.

Reference analog: ``cppm_decrypt_block`` (cppm.c:531-566) plus the PES
scrambling-control / CCI helpers (:568-614) and key derivation in
``cppm_init`` (:193-239).

The reference decrypts one 2048-byte sector at a time inline with the
fread.  Rebuild: the :class:`CppmDecryptor` processes a whole ``[N, 2048]``
sector batch — per-sector content keys derive with a vectorised C2 chain
and the 1920-byte encrypted spans decrypt with the vectorised D-CBC
(cppm/c2.py), which is sequential within a sector (240 chained words) but
fully parallel across sectors.  This plugs into AOBReader's decrypt hook.

An encrypt-side (:func:`encrypt_sectors`) exists for tests: no encrypted
discs are available, so round-trip vectors are synthesised (SURVEY §4(e)).
"""

from __future__ import annotations

import numpy as np

from .c2 import _F, _key_schedule, c2_dcbc_dec_batch, c2_g
from .mkb import load_mkb, process_mkb

__all__ = ["CppmDecryptor", "encrypt_sectors", "COPYRIGHT_CPPM"]

SECTOR_SIZE = 2048
ENCRYPTED_SIZE = 1920
ENCRYPTED_WORDS = ENCRYPTED_SIZE // 8
_M56 = 0x00FFFFFFFFFFFFFF
_M32 = 0xFFFFFFFF

COPYRIGHT_NONE = 0  # COPYRIGHT_PROTECTION_NONE (cppm.h:43)
COPYRIGHT_CPPM = 1  # COPYRIGHT_PROTECTION_CPPM (cppm.h:44)


def _be64(sectors: np.ndarray, offset: int) -> np.ndarray:
    """Per-sector big-endian uint64 at a byte offset."""
    b = sectors[:, offset : offset + 8].astype(np.uint64)
    out = np.zeros(sectors.shape[0], dtype=np.uint64)
    for i in range(8):
        out = (out << np.uint64(8)) | b[:, i]
    return out


def _c2_g_vec(code: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Vectorised c2_g over uint64 arrays (cppm.c:481-484)."""
    from .c2 import SBOX, _F_vec

    L = (code >> np.uint64(32)).astype(np.uint32)
    R = (code & np.uint64(_M32)).astype(np.uint32)
    ka = ((key >> np.uint64(32)) & np.uint64(0x00FFFFFF)).astype(np.uint32)
    kb = (key & np.uint64(_M32)).astype(np.uint32)
    sk = []
    for rnd in range(10):
        ka &= np.uint32(0x00FFFFFF)
        sk.append(kb + (SBOX[(ka & np.uint32(0xFF)) ^ np.uint32(rnd)] << np.uint32(4)))
        kc = kb >> np.uint32(15)
        kd = ka >> np.uint32(7)
        ka = (ka << np.uint32(17)) | kc
        kb = (kb << np.uint32(17)) | kd
    for rnd in range(10):
        L = L + _F_vec(R, sk[rnd])
        L, R = R, L
    L, R = R, L
    enc = (L.astype(np.uint64) << np.uint64(32)) | R.astype(np.uint64)
    return enc ^ code


class CppmDecryptor:
    """Stateful per-disc decryptor (media key + album ID)."""

    def __init__(self, media_key: int, id_album_media: int,
                 preserve_cci: bool = False, use_device: bool | None = None):
        self.media_key = media_key
        self.id_album_media = id_album_media
        self.preserve_cci = preserve_cci
        # k_au is per-disc (cppm.c:540-541)
        self.k_au = c2_g(id_album_media, media_key) & _M56
        # Decrypted sectors are consumed by the HOST demux, so the device
        # D-CBC kernel always pays a d2h round trip for its output — the
        # native host path (~119 MB/s/core) wins in this architecture.
        # Auto (None) therefore means host; pass use_device=True to force
        # the device kernel (ops/c2_decrypt.py).
        self.use_device = use_device

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_mkb_file(cls, mkb_path: str, id_album_media: int,
                      **kw) -> "CppmDecryptor | None":
        """File-based path: derive the media key from DVDAUDIO.MKB; the
        album ID must come from drive auth or be supplied by the caller."""
        mkb = load_mkb(mkb_path)
        if mkb is None:
            return None
        media_key = process_mkb(mkb)
        if media_key is None:
            return None
        return cls(media_key, id_album_media, **kw)

    @classmethod
    def from_drive(cls, drive, mkb_path: str,
                   **kw) -> "CppmDecryptor | None":
        """Probe + derive from an open :class:`css.DriveBackend`
        (cppm_init, cppm.c:193-239): the copyright flag decides whether the
        disc is protected at all (``ioctl_ReadCopyright``, ioctl.c:142 —
        NOT inferred from MKB file presence), then the album ID is read
        over the authenticated handshake (ASF-verified, ``GetASF``
        dvd_css.c:344) and the MKB file yields the media key."""
        from .css import read_album_id

        try:
            if drive.read_copyright() != COPYRIGHT_CPPM:
                return None  # unprotected (or unsupported scheme)
            album = read_album_id(drive)
        except OSError:
            return None
        return cls.from_mkb_file(mkb_path, album, **kw)

    @classmethod
    def from_device(cls, device: str, mkb_path: str,
                    **kw) -> "CppmDecryptor | None":
        """Full reference path against a real drive node (Linux ioctls)."""
        from .css import LinuxDrive

        try:
            drive = LinuxDrive(device)
        except OSError:
            return None
        try:
            return cls.from_drive(drive, mkb_path, **kw)
        finally:
            drive.close()

    # -- decryption ---------------------------------------------------------

    def decrypt_sectors(self, sectors: np.ndarray) -> np.ndarray:
        """Decrypt a ``[N, 2048] uint8`` batch in place-semantics (returns
        a new array); unencrypted sectors pass through untouched."""
        sectors = np.ascontiguousarray(sectors).copy()
        if sectors.size == 0:
            return sectors
        if not self._device_enabled(sectors.shape[0]):
            # native host path (host/src/c2.cc) when available
            from .. import host

            done = host.c2_decrypt_sectors(sectors, self.media_key,
                                           self.id_album_media,
                                           self.preserve_cci)
            if done is not None:
                return sectors
        # pack-header sync + PES scrambling control (cppm.c:568-574)
        is_pack = ((sectors[:, 0] == 0) & (sectors[:, 1] == 0)
                   & (sectors[:, 2] == 1) & (sectors[:, 3] == 0xBA))
        scrambled = is_pack & (((sectors[:, 20] >> 4) & 0x3) != 0)
        idx = np.nonzero(scrambled)[0]
        if idx.size:
            enc = sectors[idx]
            words = enc[:, SECTOR_SIZE - ENCRYPTED_SIZE :].reshape(
                -1, ENCRYPTED_WORDS, 8).astype(np.uint32)
            hi = ((words[..., 0] << 24) | (words[..., 1] << 16)
                  | (words[..., 2] << 8) | words[..., 3])
            lo = ((words[..., 4] << 24) | (words[..., 5] << 16)
                  | (words[..., 6] << 8) | words[..., 7])
            if self._device_enabled(idx.size):
                hi, lo = self._decrypt_device(enc, hi, lo)
            else:
                keys = self._content_keys(enc)
                c2_dcbc_dec_batch(hi, lo, keys, ENCRYPTED_WORDS)
            dec = np.empty_like(words, dtype=np.uint8)
            for i, src in enumerate([hi >> 24, hi >> 16, hi >> 8, hi,
                                     lo >> 24, lo >> 16, lo >> 8, lo]):
                dec[..., i] = (src & 0xFF).astype(np.uint8)
            enc[:, SECTOR_SIZE - ENCRYPTED_SIZE :] = dec.reshape(
                idx.size, ENCRYPTED_SIZE)
            enc[:, 20] &= 0xCD  # reset scrambling control (cppm.c:576-580)
            sectors[idx] = enc
        if not self.preserve_cci:
            self._reset_cci(sectors, is_pack)
        return sectors

    def _device_enabled(self, n: int) -> bool:
        del n
        from ..config import default_config

        return bool(self.use_device) and default_config().use_device

    def _decrypt_device(self, enc: np.ndarray, hi: np.ndarray,
                        lo: np.ndarray):
        """Device path: one scan over the whole batch (ops/c2_decrypt.py)."""
        import jax.numpy as jnp

        from ..ops.c2_decrypt import dcbc_dec_device

        fields = np.zeros((enc.shape[0], 5, 2), np.uint32)
        for i, off in enumerate((24, 32, 40, 48, 84)):
            b = enc[:, off : off + 8].astype(np.uint32)
            fields[:, i, 0] = (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]
            fields[:, i, 1] = (b[:, 4] << 24) | (b[:, 5] << 16) | (b[:, 6] << 8) | b[:, 7]
        kau = np.array([self.k_au >> 32, self.k_au & 0xFFFFFFFF], np.uint32)
        words = np.stack([hi, lo], axis=-1)
        out = np.asarray(dcbc_dec_device(jnp.asarray(words),
                                         jnp.asarray(fields),
                                         jnp.asarray(kau)))
        return out[..., 0], out[..., 1]

    def _content_keys(self, sectors: np.ndarray) -> np.ndarray:
        """Per-sector content key chain (cppm.c:540-556)."""
        k = np.full(sectors.shape[0], np.uint64(self.k_au), dtype=np.uint64)
        for off in (24, 32, 40, 48):
            k = _c2_g_vec(_be64(sectors, off), k) & np.uint64(_M56)
        return _c2_g_vec(_be64(sectors, 84), k) & np.uint64(_M56)

    def _reset_cci(self, sectors: np.ndarray, is_pack: np.ndarray) -> None:
        """Zero the copy-control bytes (mpeg2_reset_cci, cppm.c:582-614)."""
        for n in np.nonzero(is_pack)[0]:
            sec = sectors[n]
            pos = 14 + int(sec[13] & 0x07)
            while pos + 9 <= SECTOR_SIZE:
                if not (sec[pos] == 0 and sec[pos + 1] == 0 and sec[pos + 2] == 1):
                    break
                pes_len = (int(sec[pos + 4]) << 8) | int(sec[pos + 5])
                if sec[pos + 3] == 0xBD:
                    p = pos + 9 + int(sec[pos + 8])
                    if p + 13 <= SECTOR_SIZE:
                        if sec[p] == 0xA0 and sec[p + 3] > 8:
                            sec[p + 12] = 0
                        elif sec[p] == 0xA1 and sec[p + 3] > 4:
                            sec[p + 8] = 0
                pos += 6 + pes_len


# -------------------------------------------------------------- test-side

def encrypt_sectors(sectors: np.ndarray, media_key: int,
                    id_album_media: int) -> np.ndarray:
    """Inverse of :meth:`CppmDecryptor.decrypt_sectors` for synthesising
    test vectors: sets the PES scrambling-control bits and D-CBC-encrypts
    the 1920-byte span of every pack sector.  Scalar (test-only)."""
    out = np.ascontiguousarray(sectors).copy()
    k_au = c2_g(id_album_media, media_key) & _M56
    for n in range(out.shape[0]):
        sec = out[n]
        if not (sec[0] == 0 and sec[1] == 0 and sec[2] == 1 and sec[3] == 0xBA):
            continue
        sec[20] |= 0x10  # mark scrambled
        key = k_au
        for off in (24, 32, 40, 48):
            key = c2_g(int.from_bytes(sec[off : off + 8].tobytes(), "big"), key) & _M56
        key = c2_g(int.from_bytes(sec[84:92].tobytes(), "big"), key) & _M56

        span = sec[SECTOR_SIZE - ENCRYPTED_SIZE :]
        inkey = key
        for w in range(ENCRYPTED_WORDS):
            plain = int.from_bytes(span[w * 8 : w * 8 + 8].tobytes(), "big")
            key_round = 10 if w == 0 else 2
            sk = _key_schedule(inkey, key_round)
            # encrypt = inverse of the D-CBC decrypt rounds
            L = (plain >> 32) & _M32
            R = plain & _M32
            L, R = R, L  # undo final swap
            for rnd in range(10):
                L, R = R, L
                L = (L + _F(R, sk[rnd % key_round])) & _M32
            cipher = (L << 32) | R
            span[w * 8 : w * 8 + 8] = np.frombuffer(
                cipher.to_bytes(8, "big"), dtype=np.uint8)
            # next block's key: round-5 state of the DECRYPT direction
            dL = (cipher >> 32) & _M32
            dR = cipher & _M32
            for rnd in range(9, -1, -1):
                dL = (dL - _F(dR, sk[rnd % key_round])) & _M32
                dL, dR = dR, dL
                if rnd == 5:
                    inkey = key ^ (((dR & 0x00FFFFFF) << 32) | dL)
    return out

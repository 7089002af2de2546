"""CPPM tests: C2 cipher round trips, MKB processing, batched sector
decryption, and the CSS bus-key handshake against a mock drive
(SURVEY §4(e): no encrypted discs or drives exist, so vectors are
synthesised and the drive is a software logical unit)."""

import numpy as np
import pytest

from dvda.container.aob import AOBReader
from dvda.cppm.c2 import c2_dec, c2_enc, c2_g
from dvda.cppm.css import MockDrive, authenticate_bus_key, crypt_key, read_album_id
from dvda.cppm.decrypt import CppmDecryptor, encrypt_sectors
from dvda.cppm.mkb import DEVICE_KEYS, process_mkb
from dvda.testutil.synth import PcmTrackSpec, build_disc


def test_c2_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(20):
        code = int(rng.integers(0, 1 << 63))
        key = int(rng.integers(0, 1 << 56))
        assert c2_dec(c2_enc(code, key), key) == code


def test_c2_g_is_deterministic():
    assert c2_g(0x1122334455667788, 0xA5A5A5A5A5A5A5) == \
        c2_g(0x1122334455667788, 0xA5A5A5A5A5A5A5)
    assert c2_g(1, 2) != c2_g(2, 1)


def _build_mkb(media_key: int) -> bytes:
    """Synthesise a minimal valid MKB targeting device key (col 0, row
    0x0375) with a verify record."""
    dk = next(k for k in DEVICE_KEYS if k.col == 0 and k.row == 0x0375)
    verification = c2_enc(0xDEADBEEF00000000 | 0x12345678, media_key)

    def record(rtype, payload):
        length = 4 + len(payload)
        return bytes([rtype]) + length.to_bytes(3, "big") + payload

    # media-key record: 8-byte header (column in byte 4) + key table
    f = (dk.col << 32) | dk.row
    entry = c2_enc((media_key ^ f) & 0x00FFFFFFFFFFFFFF, dk.key)
    table_len = (dk.row + 1) * 8
    table = bytearray(table_len)
    table[dk.row * 8 : dk.row * 8 + 8] = entry.to_bytes(8, "big")
    payload = bytes([0, 0, 0, 0, dk.col, 0, 0, 1]) + bytes(table)
    return (record(0x81, verification.to_bytes(8, "big"))
            + record(0x01, payload)
            + record(0x02, b""))


def test_process_mkb_derives_media_key():
    media_key = 0x00A1B2C3D4E5F607
    mkb = _build_mkb(media_key)
    assert process_mkb(mkb) == media_key


def test_process_mkb_rejects_garbage():
    assert process_mkb(b"\x02\x00\x00\x04") is None
    assert process_mkb(b"") is None


def _record(rtype: int, payload: bytes) -> bytes:
    length = 4 + len(payload)
    return bytes([rtype]) + length.to_bytes(3, "big") + payload


def test_process_mkb_conditional_0x82_record():
    """0x82 conditionally-calculate records: header and row entry are
    encrypted with the running media key (zero here), and the column is
    byte 4 of the byteswapped decrypted header = bits 24..31 of the
    decrypted value (cppm.c:380-391)."""
    dk = next(k for k in DEVICE_KEYS if k.col == 0x01)
    media_key = 0x0055AA55AA55AA55
    f = (dk.col << 32) | dk.row
    # row entry is doubly wrapped: c2_dec(file_bytes, running_mk=0) then
    # c2_dec(., dk.key) must yield media_key ^ f
    inner = c2_enc((media_key ^ f) & 0x00FFFFFFFFFFFFFF, dk.key)
    entry = c2_enc(inner, 0)
    table = bytearray((dk.row + 1) * 8)
    table[dk.row * 8 : dk.row * 8 + 8] = entry.to_bytes(8, "big")
    # header decrypts (with running mk = 0) to DEADBEEF-prefixed data with
    # the column in bits 24..31
    header = c2_enc((0xDEADBEEF << 32) | (dk.col << 24) | 0x01, 0)
    verification = c2_enc(0xDEADBEEF00000000 | 0xCAFEF00D, media_key)
    mkb = (_record(0x81, verification.to_bytes(8, "big"))
           + _record(0x82, header.to_bytes(8, "big") + bytes(table))
           + _record(0x02, b""))
    assert process_mkb(mkb) == media_key


def test_process_mkb_skips_unknown_column_record():
    """A 0x01 record whose column matches no device key is skipped — the
    walk continues and a later record may still derive the media key
    (cppm.c:392-403: no_more_keys only ends the walk after a full pass)."""
    media_key = 0x00A1B2C3D4E5F607
    good = _build_mkb(media_key)
    bogus_payload = bytes([0, 0, 0, 0, 0xEE, 0, 0, 1]) + bytes(16)
    assert process_mkb(_record(0x01, bogus_payload) + good) == media_key


def _synthetic_sectors(n=6, seed=3):
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        build_disc(os.path.join(tmp, "AUDIO_TS"),
                   [[PcmTrackSpec(pcm_frames=960, seed=seed)]])
        aob = AOBReader(os.path.join(tmp, "AUDIO_TS"), 1)
        return aob.read_sectors(0, n).copy()


def test_sector_encrypt_decrypt_roundtrip():
    media_key = 0x00DEADBEEFCAFE42
    album = 0x1122334455667788
    sectors = _synthetic_sectors()
    enc = encrypt_sectors(sectors, media_key, album)
    assert not np.array_equal(enc, sectors)
    assert ((enc[:, 20] >> 4) & 3).all(), "scrambling control must be set"
    dec = CppmDecryptor(media_key, album, preserve_cci=True).decrypt_sectors(enc)
    assert np.array_equal(dec, sectors)


def test_cci_reset_native_matches_numpy(monkeypatch):
    """preserve_cci=False: the native path (c2.cc reset_cci, which runs
    after ALL sectors are plaintext since PES walks can cross into the
    decrypted payload) must produce byte-identical sectors to the numpy
    spec path."""
    from dvda import host

    media_key = 0x00DEADBEEFCAFE42
    album = 0x1122334455667788
    sectors = _synthetic_sectors(n=9)
    enc = encrypt_sectors(sectors, media_key, album)
    if host._load() is None:
        import pytest

        pytest.skip("native host library unavailable")
    a = CppmDecryptor(media_key, album,
                      preserve_cci=False).decrypt_sectors(enc.copy())
    monkeypatch.setattr(host, "c2_decrypt_sectors",
                        lambda *args, **kw: None)
    b = CppmDecryptor(media_key, album,
                      preserve_cci=False).decrypt_sectors(enc.copy())
    assert np.array_equal(a, b)
    # both equal the plaintext except (possibly) CCI bytes; sanity: the
    # audio payload region survives
    assert np.array_equal(a[:, 128:], sectors[:, 128:])


def test_decryptor_passes_unencrypted_through():
    sectors = _synthetic_sectors()
    dec = CppmDecryptor(1, 2, preserve_cci=True).decrypt_sectors(sectors)
    assert np.array_equal(dec, sectors)


def test_wrong_key_fails_roundtrip():
    sectors = _synthetic_sectors()
    enc = encrypt_sectors(sectors, 0x111111, 0x222222)
    dec = CppmDecryptor(0x111112, 0x222222, preserve_cci=True).decrypt_sectors(enc)
    assert not np.array_equal(dec, sectors)


def test_encrypted_disc_decodes(tmp_path):
    """End-to-end: encrypt a PCM disc's AOB, decode through AOBReader with
    the decryptor hooked, compare to the plaintext decode."""
    import os

    from dvda.api import DVDA

    media_key = 0x0055AA55AA55AA55
    album = 0x0123456789ABCDEF

    layout = build_disc(str(tmp_path / "AUDIO_TS"),
                        [[PcmTrackSpec(pcm_frames=960, seed=8)]])
    plain = (DVDA(layout.path).open_titleset(1).open_title(1)
             .open_track(1).open_reader(use_device=False)).read_all()

    aob_path = os.path.join(layout.path, "ATS_01_1.AOB")
    raw = np.fromfile(aob_path, dtype=np.uint8).reshape(-1, 2048)
    encrypt_sectors(raw, media_key, album).tofile(aob_path)

    dec = CppmDecryptor(media_key, album)
    aob = AOBReader(layout.path, 1, decrypt=dec.decrypt_sectors)
    from dvda.api import Track, TrackReader
    from dvda.container.ifo import parse_ats_ifo, resolve_title_toc

    with open(os.path.join(layout.path, "ATS_01_0.IFO"), "rb") as f:
        toc = resolve_title_toc(parse_ats_ifo(f.read()), 1)
    # decode via the PCM batch path with the decrypting reader
    dvda = DVDA(layout.path)
    ts = dvda.open_titleset(1)
    track = ts.open_title(1).open_track(1)
    reader = TrackReader(aob, track, use_device=False)
    assert np.array_equal(reader.read_all(), plain)


# ---------------------------------------------------------------- CSS auth

def test_crypt_key_shapes():
    k = crypt_key(0, 0, bytes(range(10)))
    assert len(k) == 5
    assert crypt_key(0, 1, bytes(range(10))) != k


def test_bus_key_handshake_with_mock_drive():
    for variant in (0, 7, 31):
        drive = MockDrive(variant=variant)
        agid, bus_key = authenticate_bus_key(drive)
        assert len(bus_key) == 5
        assert drive.report_asf() == 1


def test_read_album_id_via_mock_drive():
    album = 0xFEDCBA9876543210
    block = bytearray(2048)
    block[80:88] = album.to_bytes(8, "big")
    drive = MockDrive(variant=12, disc_key_block=bytes(block))
    assert read_album_id(drive) == album


def test_mock_drive_rejects_bad_key2():
    drive = MockDrive(variant=3)
    drive.send_challenge(0, bytes(10))
    drive.report_key1(0)
    with pytest.raises(IOError):
        drive.send_key2(0, b"wrong")


def test_from_drive_probe_path(tmp_path):
    """Encrypted-disc detection through the drive probe (cppm_init,
    cppm.c:193-239): the copyright flag (ioctl_ReadCopyright analog)
    gates everything; the ASF-verified handshake yields the album ID;
    the MKB file yields the media key."""
    from dvda.cppm.css import MockDrive
    from dvda.cppm.decrypt import COPYRIGHT_CPPM, CppmDecryptor

    media_key = 0x00A1B2C3D4E5F607
    album = 0x1122334455667788
    block = bytearray(2048)
    block[80:88] = album.to_bytes(8, "big")
    mkb_path = str(tmp_path / "DVDAUDIO.MKB")
    body = _build_mkb(media_key)
    with open(mkb_path, "wb") as f:
        f.write(b"DVDAUDIO.MKB" + len(body).to_bytes(4, "big") + body)

    # reference parity: COPYRIGHT_PROTECTION_CPPM == 1 (cppm.h:43-44)
    assert COPYRIGHT_CPPM == 1

    drive = MockDrive(variant=9, disc_key_block=bytes(block),
                      copyright_protection=COPYRIGHT_CPPM)
    dec = CppmDecryptor.from_drive(drive, mkb_path)
    assert dec is not None
    assert dec.media_key == media_key
    assert dec.id_album_media == album

    # an unprotected disc (copyright 0) yields no decryptor even though
    # an MKB file exists — detection follows the drive, not the file
    plain = MockDrive(variant=9, disc_key_block=bytes(block),
                      copyright_protection=0)
    assert CppmDecryptor.from_drive(plain, mkb_path) is None


def test_encrypted_mlp_disc_native_path(tmp_path):
    """Encrypted MLP disc through the production path: the AOBReader
    decrypt hook feeds plaintext sectors to the native demux + parser +
    device pipeline; output equals the plaintext decode."""
    import os

    from dvda.api import DVDA, TrackReader
    from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream
    from dvda.testutil.synth import MlpTrackSpec

    media_key = 0x00DEADBEEF001122
    album = 0x0F0E0D0C0B0A0908
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=20, seed=6, fir_across_restart=False)
    layout = build_disc(str(tmp_path / "AUDIO_TS"),
                        [[MlpTrackSpec(mlp_stream=synth_mlp_stream(cfg),
                                       pcm_frames=cfg.total_pcm_frames,
                                       sample_rate=cfg.sample_rate,
                                       channel_assignment=17)]])
    plain = (DVDA(layout.path).open_titleset(1).open_title(1)
             .open_track(1).open_reader(use_device=True)).read_all()

    aob_path = os.path.join(layout.path, "ATS_01_1.AOB")
    raw = np.fromfile(aob_path, dtype=np.uint8).reshape(-1, 2048)
    encrypt_sectors(raw, media_key, album).tofile(aob_path)

    dec = CppmDecryptor(media_key, album)
    aob = AOBReader(layout.path, 1, decrypt=dec.decrypt_sectors)
    track = DVDA(layout.path).open_titleset(1).open_title(1).open_track(1)
    reader = TrackReader(aob, track, use_device=True)
    assert reader.codec == "MLP"
    assert np.array_equal(reader.read_all(), plain)

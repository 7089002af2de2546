"""Container layer tests: IFO parse, AOB chaining, PS demux — validated
against synthesized discs and the reference dvda-debug-info oracle."""

import numpy as np

from dvda.api import DVDA
from dvda.container.aob import AOBReader, SECTOR_SIZE
from dvda.container.ifo import parse_audio_ts_ifo, parse_ats_ifo, resolve_title_toc
from dvda.container.packet import PacketReader, demux_audio_packets
from dvda.testutil.synth import PcmTrackSpec, build_disc


def _disc(tmp_path, **kw):
    specs = [
        [PcmTrackSpec(pcm_frames=1920, seed=1), PcmTrackSpec(pcm_frames=960, seed=2)],
        [PcmTrackSpec(pcm_frames=480, seed=3)],
    ]
    return build_disc(str(tmp_path / "AUDIO_TS"), specs, **kw), specs


def test_audio_ts_ifo_roundtrip(tmp_path):
    layout, _ = _disc(tmp_path)
    with open(layout.path + "/AUDIO_TS.IFO", "rb") as f:
        assert parse_audio_ts_ifo(f.read()) == 1


def test_ats_ifo_roundtrip(tmp_path):
    layout, specs = _disc(tmp_path)
    with open(layout.path + "/ATS_01_0.IFO", "rb") as f:
        ifo = parse_ats_ifo(f.read())
    assert ifo.title_count == 2
    assert ifo.titles[0].track_count == 2
    assert ifo.titles[1].track_count == 1
    toc = resolve_title_toc(ifo, 1)
    assert toc.tracks[0].first_sector == layout.titles[0][0].first_sector
    # track 1's last sector = track 2's first - 1 (dvd-audio.c:491-498)
    assert toc.tracks[0].last_sector == layout.titles[0][1].first_sector - 1
    assert toc.tracks[0].pts_length == specs[0][0].pts_length


def test_ats_ifo_matches_oracle(tmp_path, ref_oracle):
    layout, _ = _disc(tmp_path)
    text = ref_oracle.run_debug_info(layout.path)
    dvda = DVDA(layout.path)
    ts = dvda.open_titleset(1)
    rows = [ln.split() for ln in text.splitlines()[1:] if ln.strip()]
    got = []
    for title_num in range(1, ts.title_count + 1):
        title = ts.open_title(title_num)
        for track_num in range(1, title.track_count + 1):
            tr = title.open_track(track_num)
            got.append((title_num, track_num, tr.pts_length,
                        tr.first_sector, tr.last_sector))
    assert len(rows) == len(got)
    for row, g in zip(rows, got):
        assert (int(row[0]), int(row[1])) == g[:2]
        assert (int(row[-3]), int(row[-2]), int(row[-1])) == g[2:]


def test_aob_chaining(tmp_path):
    layout, _ = _disc(tmp_path, aob_split_sectors=3)
    reader = AOBReader(layout.path, 1)
    whole = AOBReader((_disc(tmp_path / "b")[0]).path, 1)
    assert reader.total_sectors == whole.total_sectors
    a = reader.read_sectors(0, reader.total_sectors)
    b = whole.read_sectors(0, whole.total_sectors)
    assert np.array_equal(a, b)
    # read spanning a file boundary
    assert np.array_equal(reader.read_sectors(2, 3), b[2:5])


def test_aob_case_insensitive(tmp_path):
    layout, _ = _disc(tmp_path, lowercase=True)
    reader = AOBReader(layout.path, 1)
    assert reader.total_sectors > 0
    dvda = DVDA(layout.path)
    assert dvda.titleset_count == 1


def test_pull_packet_reader_matches_bulk(tmp_path):
    layout, _ = _disc(tmp_path)
    aob = AOBReader(layout.path, 1)
    bulk = [p for p in demux_audio_packets(aob.read_sectors(0, aob.total_sectors))
            if p is not None]
    aob2 = AOBReader(layout.path, 1)
    pr = PacketReader(aob2)
    pulled = []
    while (p := pr.next_audio_packet()) is not None:
        pulled.append(p)
    assert len(bulk) == len(pulled)
    for a, b in zip(bulk, pulled):
        assert a.sector == b.sector
        assert a.payload == b.payload


def test_seek_and_tell(tmp_path):
    layout, _ = _disc(tmp_path, aob_split_sectors=4)
    aob = AOBReader(layout.path, 1)
    assert aob.seek(5)
    assert aob.tell() == 5
    s5 = aob.read()
    assert aob.tell() == 6
    assert np.array_equal(s5, aob.read_sectors(5, 1)[0])
    assert not aob.seek(aob.total_sectors)


def test_aob_nine_file_chain(tmp_path):
    """Maximum AOB chaining: 9 files (aob.c:101-123 allows 1..9)."""
    # 4320 frames of 16-bit stereo = 9 sectors → 9 one-sector AOB files
    spec = [[PcmTrackSpec(pcm_frames=4320, seed=4)]]
    whole = build_disc(str(tmp_path / "w" / "AUDIO_TS"), spec)
    total = AOBReader(whole.path, 1).total_sectors
    assert total == 9
    split = build_disc(str(tmp_path / "s" / "AUDIO_TS"), spec,
                       aob_split_sectors=1)
    import os
    aobs = [f for f in os.listdir(split.path) if f.endswith(".AOB")]
    assert len(aobs) == 9
    a = AOBReader(whole.path, 1)
    b = AOBReader(split.path, 1)
    assert a.total_sectors == b.total_sectors
    assert np.array_equal(a.read_sectors(0, total), b.read_sectors(0, total))

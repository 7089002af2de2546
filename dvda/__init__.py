"""dvda — a DVD-Audio decode framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of libdvd-audio:
AUDIO_TS parsing, AOB sector I/O, MPEG-2
program-stream demux, CPPM decryption, and the PCM and MLP (Meridian
Lossless Packing) codecs — re-architected as a thin host planner feeding
batched, vectorised device kernels.

Two API styles are provided:

* the Pythonic object API — ``open_disc(path).open_titleset(1)...``;
* C-style functions mirroring include/dvd-audio.h (``dvda_open``,
  ``dvda_titleset_count``, ``dvda_read``, ...) for drop-in familiarity.
"""

from .api import DVDA, Titleset, Title, Track, TrackReader, open_disc
import enum as _enum

from .codecs.params import PTS_PER_SECOND

__version__ = "0.1.0"

__all__ = [
    "DVDA", "Titleset", "Title", "Track", "TrackReader", "open_disc",
    "PTS_PER_SECOND",
    # C-style API parity (dvd-audio.h:59-201)
    "dvda_open", "dvda_close", "dvda_titleset_count", "dvda_open_titleset",
    "dvda_close_titleset", "dvda_titleset_number", "dvda_title_count",
    "dvda_open_title", "dvda_close_title", "dvda_title_number",
    "dvda_track_count", "dvda_title_pts_length", "dvda_open_track",
    "dvda_close_track", "dvda_track_number", "dvda_track_pts_index",
    "dvda_track_pts_length", "dvda_track_first_sector",
    "dvda_track_last_sector", "dvda_open_track_reader",
    "dvda_close_track_reader", "dvda_codec", "dvda_codec_t",
    "DVDA_PCM", "DVDA_MLP", "dvda_bits_per_sample",
    "dvda_sample_rate", "dvda_channel_count", "dvda_riff_wave_channel_mask",
    "dvda_read",
]


# -- C-style API (1:1 with include/dvd-audio.h) -----------------------------

def dvda_open(audio_ts_path, device=None):
    try:
        return DVDA(audio_ts_path, device)
    except Exception:
        return None


def dvda_close(dvda):
    dvda.close()


def dvda_titleset_count(dvda):
    return dvda.titleset_count


def dvda_open_titleset(dvda, titleset):
    try:
        return dvda.open_titleset(titleset)
    except Exception:
        return None


def dvda_close_titleset(titleset):
    titleset.close()


def dvda_titleset_number(titleset):
    return titleset.number


def dvda_title_count(titleset):
    return titleset.title_count


def dvda_open_title(titleset, title):
    try:
        return titleset.open_title(title)
    except Exception:
        return None


def dvda_close_title(title):
    title.close()


def dvda_title_number(title):
    return title.number


def dvda_track_count(title):
    return title.track_count


def dvda_title_pts_length(title):
    return title.pts_length


def dvda_open_track(title, track):
    try:
        return title.open_track(track)
    except Exception:
        return None


def dvda_close_track(track):
    track.close()


def dvda_track_number(track):
    return track.number


def dvda_track_pts_index(track):
    return track.pts_index


def dvda_track_pts_length(track):
    return track.pts_length


def dvda_track_first_sector(track):
    return track.first_sector


def dvda_track_last_sector(track):
    return track.last_sector


def dvda_open_track_reader(track):
    try:
        return track.open_reader()
    except Exception:
        return None


def dvda_close_track_reader(reader):
    reader.close()


class dvda_codec_t(_enum.IntEnum):
    """Codec enum (dvd-audio.h:52: typedef enum {DVDA_PCM, DVDA_MLP})."""

    DVDA_PCM = 0
    DVDA_MLP = 1


DVDA_PCM = dvda_codec_t.DVDA_PCM
DVDA_MLP = dvda_codec_t.DVDA_MLP


def dvda_codec(reader):
    """Returns the track's codec as :class:`dvda_codec_t`
    (dvda_codec, dvd-audio.h:165-166)."""
    return (dvda_codec_t.DVDA_PCM if reader.codec == "PCM"
            else dvda_codec_t.DVDA_MLP)


def dvda_bits_per_sample(reader):
    return reader.bits_per_sample


def dvda_sample_rate(reader):
    return reader.sample_rate


def dvda_channel_count(reader):
    return reader.channel_count


def dvda_riff_wave_channel_mask(reader):
    return reader.channel_mask


def dvda_read(reader, pcm_frames):
    """Returns int32 [n, channels]; n may be short at end of stream."""
    return reader.read(pcm_frames)

"""dvda-debug-info — print a disc's table of contents.

Reference analog: utils/dvda-debug-info.c; the output format replicates
its printf layout (``%5u  %5u  %3.1u:%2.2u  %10u  %12u  %11u``, :119-126)
so downstream scripts keep working.
"""

from __future__ import annotations

import argparse
import sys

from .. import __version__
from ..api import DVDA, DvdaError
from ..codecs.params import PTS_PER_SECOND


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dvda-debug-info", add_help=False)
    p.add_argument("-h", "--help", action="help")
    p.add_argument("--version", action="version",
                   version=f"libDVD-Audio {__version__} (dvda)")
    p.add_argument("-A", "--audio_ts", metavar="PATH",
                   help="path to disc's AUDIO_TS directory")
    args = p.parse_args(argv)
    if not args.audio_ts:
        p.print_help()
        return 0
    try:
        dvda = DVDA(args.audio_ts)
        titleset = dvda.open_titleset(1)
    except DvdaError:
        print(f'*** Error: "{args.audio_ts}" does not appear to be '
              f"a valid AUDIO_TS path", file=sys.stderr)
        return 1

    print("Title  Track  Length  PTS Length  First Sector  Last Sector")
    for title_num in range(1, titleset.title_count + 1):
        try:
            title = titleset.open_title(title_num)
        except DvdaError:
            continue
        for track_num in range(1, title.track_count + 1):
            track = title.open_track(track_num)
            pts = track.pts_length
            print("%5u  %5u  %3u:%02u  %10u  %12u  %11u" % (
                title_num, track_num,
                pts // PTS_PER_SECOND // 60,
                pts // PTS_PER_SECOND % 60,
                pts, track.first_sector, track.last_sector))
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""dvda2wav — extract DVD-Audio titles/tracks to RIFF WAVE files.

Reference analog: utils/dvda2wav.c (flags :67-76, extraction flow
:240-350).  Same options, same output naming (``track-TT-NN.wav``), same
status lines, and byte-identical WAV output (utils/wav.py); the decode
underneath is the batched device pipeline instead of the scalar pull loop.
"""

from __future__ import annotations

import argparse
import os
import sys

from .. import __version__
from ..api import DVDA, DvdaError
from ..utils.wav import wave_header


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dvda2wav", add_help=False,
        description="extract DVD-Audio tracks to WAV",
    )
    p.add_argument("-h", "--help", action="help",
                   help="show this help message and exit")
    p.add_argument("--version", action="version",
                   version=f"libDVD-Audio {__version__} (dvda)")
    p.add_argument("-A", "--audio_ts", metavar="PATH",
                   help="path to disc's AUDIO_TS directory")
    p.add_argument("-c", "--cdrom", metavar="DEVICE", default=None,
                   help="optional path to disc's cdrom device")
    p.add_argument("-T", "--title", type=int, default=0, metavar="TITLE",
                   help="title number to extract (default: all)")
    p.add_argument("-t", "--track", type=int, default=0, metavar="TRACK",
                   help="track number to extract (default: all)")
    p.add_argument("-d", "--dir", default=".", metavar="DIR",
                   help="output directory (default: current directory)")
    p.add_argument("--no-device", action="store_true",
                   help="decode host-side only (skip the device pipeline)")
    p.add_argument("--stream", action="store_true",
                   help="write in bounded-memory segments (MLP tracks "
                        "decode from manifest resume points instead of "
                        "materializing whole-track buffers; output bytes "
                        "are identical)")
    return p


def extract_track(title, track_num: int, output_dir: str,
                  use_device: bool | None, stream: bool = False) -> bool:
    track = title.open_track(track_num)
    reader = track.open_reader(use_device=use_device)
    print(f"* Extracting {reader.codec} track  "
          f"{reader.channel_count} channels  "
          f"{reader.sample_rate} Hz  {reader.bits_per_sample} bps")
    name = f"track-{title.number:02d}-{track_num:02d}.wav"
    path = os.path.join(output_dir, name)
    hdr = lambda frames: wave_header(  # noqa: E731 — one-shot builder
        reader.sample_rate, reader.channel_count, reader.channel_mask,
        reader.bits_per_sample, frames)
    bits_per_frame = reader.channel_count * reader.bits_per_sample
    if stream:
        # single pass in bounded memory: placeholder header, stream the
        # manifest-aligned segments, rewrite the header with the total
        with open(path, "wb") as f:
            f.write(hdr(0))
            total = 0
            for chunk in reader.iter_packed():
                f.write(chunk)
                total += len(chunk)
            f.seek(0)
            f.write(hdr(total * 8 // max(1, bits_per_frame)))
    else:
        # packed path: on the native MLP pipelines the executor emits the
        # WAV data bytes directly (no host unpack/repack passes)
        data = reader.read_all_packed()
        frames = len(data) * 8 // max(1, bits_per_frame)
        with open(path, "wb") as f:
            f.write(hdr(frames))
            f.write(data)
    reader.close()
    print(f'* Wrote: "{path}"')
    return True


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.audio_ts:
        build_parser().print_help()
        return 0
    try:
        dvda = DVDA(args.audio_ts, args.cdrom)
        titleset = dvda.open_titleset(1)
    except DvdaError:
        print(f'*** Error: "{args.audio_ts}" does not appear to be '
              f"a valid AUDIO_TS path", file=sys.stderr)
        return 1
    os.makedirs(args.dir, exist_ok=True)
    use_device = False if args.no_device else None
    titles = ([args.title] if args.title
              else range(1, titleset.title_count + 1))
    for title_num in titles:
        try:
            title = titleset.open_title(title_num)
        except DvdaError:
            print(f"*** Error: unable to open title {title_num}",
                  file=sys.stderr)
            return 1
        tracks = ([args.track] if args.track
                  else range(1, title.track_count + 1))
        for track_num in tracks:
            try:
                extract_track(title, track_num, args.dir, use_device,
                              stream=args.stream)
            except DvdaError:
                print(f"*** Error: unable to open track {track_num} "
                      f"for reading", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

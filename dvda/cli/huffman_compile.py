"""dvda-huffman: standalone Huffman codebook compiler CLI.

Reference analog: the ``huffman`` build-tool executable
(/root/reference/src/huffman.c:588-598, built by Makefile:135-136), which
compiles a codebook JSON into C jump-table headers at build time.  The
rebuild needs no build-time step (codecs/mlp/codebooks.py compiles the
canonical books at import), but the standalone tool is kept for tooling
parity: it accepts the reference's JSON codebook layout (or a frequency
list, matching the compiler's runtime entry point huffman.c:262-353) and
emits the flat 9-bit-peek tables the rebuild's decoders consume, as a C
header or JSON.

Usage:
    dvda-huffman -i mlp_codebook1.json [-o out.h] [--format c|json]
    dvda-huffman --frequencies freqs.json [-o out.h]

``--frequencies`` input is a JSON mapping (value → count) or a list of
``[value, count]`` pairs; a canonical prefix-free codebook is built first
(shortest codes to the most frequent values).
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["main"]


def _emit_c(name: str, values, lengths) -> str:
    n = len(values)
    lines = [
        "/* generated by dvda-huffman (dvda) — flat peek LUT:",
        "   index with the next %d bits (MSB-first); _len is the code"
        % (n.bit_length() - 1),
        "   length to consume (0 = invalid), _val the decoded value. */",
        f"static const int {name}_val[{n}] = {{",
    ]
    for i in range(0, n, 12):
        lines.append("    " + ", ".join(str(int(v))
                                        for v in values[i : i + 12]) + ",")
    lines.append("};")
    lines.append(f"static const int {name}_len[{n}] = {{")
    for i in range(0, n, 12):
        lines.append("    " + ", ".join(str(int(v))
                                        for v in lengths[i : i + 12]) + ",")
    lines.append("};")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    from ..codecs.mlp.codebooks import (build_codebook, compile_entries,
                                        load_codebook_json)

    ap = argparse.ArgumentParser(
        prog="dvda-huffman",
        description="compile a Huffman codebook (reference JSON layout) or "
                    "a frequency list into flat peek-LUT tables")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("-i", "--input", metavar="JSON",
                     help="codebook JSON (reference mlp_codebookN.json "
                          "layout: alternating bit arrays and values)")
    src.add_argument("--frequencies", metavar="JSON",
                     help="JSON value->count mapping or [value, count] "
                          "pairs; builds a canonical codebook first")
    ap.add_argument("-o", "--output", metavar="FILE",
                    help="output path (default: stdout)")
    ap.add_argument("--format", choices=("c", "json"), default="c",
                    help="output format (default: c header)")
    ap.add_argument("--name", default="huffman_table",
                    help="C identifier prefix (default: huffman_table)")
    args = ap.parse_args(argv)

    if args.input:
        entries = load_codebook_json(args.input)
    else:
        with open(args.frequencies) as f:
            raw = json.load(f)
        freqs = ({int(k): int(v) for k, v in raw.items()}
                 if isinstance(raw, dict)
                 else [(int(v), int(c)) for v, c in raw])
        entries = build_codebook(freqs)
    try:
        values, lengths = compile_entries(entries)
    except ValueError as exc:  # duplicate/overlapping codes
        print(f"dvda-huffman: {exc}", file=sys.stderr)
        return 1

    if args.format == "json":
        text = json.dumps({"bits": int(len(values)).bit_length() - 1,
                           "values": [int(v) for v in values],
                           "lengths": [int(v) for v in lengths]})
    else:
        text = _emit_c(args.name, values, lengths)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/bin/sh
# Build the reference decoder (dvda2wav / dvda-debug-info) OUT-OF-TREE as a
# test oracle.  The reference tree at /root/reference is read-only and its
# Makefile generates headers into src/, so we copy the sources into the
# gitignored .refbuild/ directory and build there.  The resulting binaries are
# used by tests/ for golden-file parity only; nothing in .refbuild is part of
# the dvda framework.
set -e
REPO="$(cd "$(dirname "$0")/.." && pwd)"
REF=/root/reference
BUILD="$REPO/.refbuild"
if [ -x "$BUILD/dvda2wav" ] && [ -x "$BUILD/dvda-debug-info" ]; then
    echo "oracle already built: $BUILD/dvda2wav"
    exit 0
fi
rm -rf "$BUILD"
mkdir -p "$BUILD"
cp -r "$REF/src" "$REF/include" "$REF/utils" "$REF/Makefile" "$REF/libdvd-audio.pc.m4" "$BUILD/"
chmod -R u+w "$BUILD"
cd "$BUILD"
make dvda2wav dvda-debug-info -j2
echo "oracle built: $BUILD/dvda2wav"

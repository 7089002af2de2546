#!/bin/sh
# ThreadSanitizer check for the multi-threaded MLP parser
# (host/src/mlp_parse.cc MT machinery: pass-1 scan, worker pool,
# in-order merge, sequential redo).  Synthesizes streams with
# dvda.testutil, then runs tools/tsan_mt_parse.cc built with
# -fsanitize=thread over clean and corrupted variants at several thread
# counts.  Exits nonzero on any race report or MT/sequential mismatch.
set -e
repo="$(cd "$(dirname "$0")/.." && pwd)"
work="${TMPDIR:-/tmp}/dvda_tsan"
mkdir -p "$work"

python - "$work" <<'EOF'
import sys, numpy as np
sys.path.insert(0, ".")
from dvda.codecs.mlp.codebooks import peek_lut
from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream

work = sys.argv[1]
cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                     n_frames=1200, seed=7, major_sync_every=8,
                     restart_every=8, blocks_per_frame=2, block_size=40)
stream = synth_mlp_stream(cfg)
open(f"{work}/stream.bin", "wb").write(stream)
vals = np.zeros((4, 512), dtype=np.int32)
lens = np.zeros((4, 512), dtype=np.int32)
for k in (1, 2, 3):
    v, l = peek_lut(k)
    vals[k], lens[k] = v, l
with open(f"{work}/stream.bin.luts", "wb") as f:
    f.write(vals.tobytes())
    f.write(lens.tobytes())
print("stream bytes:", len(stream))
EOF

g++ -O1 -g -fsanitize=thread -std=c++17 \
    -o "$work/tsan_mt_parse" \
    "$repo/tools/tsan_mt_parse.cc" "$repo/dvda/host/src/mlp_parse.cc"

for t in 2 4 8; do
    echo "threads=$t clean:"
    "$work/tsan_mt_parse" "$work/stream.bin" "$t"
    echo "threads=$t corrupted (sequential-redo path):"
    "$work/tsan_mt_parse" "$work/stream.bin" "$t" 200000 400000
done
echo "TSAN MT parse check passed"

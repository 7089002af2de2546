"""The bench relay-wedge watchdog (cli/bench.py): when a run's device
connection wedges permanently (observed: futex-blocked forever while
fresh processes still reach the chip), a daemon thread must emit ONE
parseable partial-result JSON line and hard-exit, so the driver records
what completed instead of a timeout."""

import json
import subprocess
import sys


def test_watchdog_emits_partial_and_exits():
    code = """
import os, sys, time
sys.path.insert(0, %r)
os.environ["JAX_PLATFORMS"] = "cpu"
from dvda.cli import bench
bench._results_live["mlp_51_hostcomplete"] = {
    "ours_x_realtime": 99.0, "vs_baseline": 3.3}
bench._start_watchdog(wedge_s=3)
bench._last_progress = time.monotonic() - 10   # already past threshold
time.sleep(60)  # the watchdog must os._exit long before this returns
print("WATCHDOG DID NOT FIRE")
"""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", code % repo],
                       capture_output=True, text=True, timeout=90)
    assert "WATCHDOG DID NOT FIRE" not in p.stdout
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["relay_wedged"] is True
    assert got["value"] == 99.0          # falls back to the partial headline
    assert got["configs"]["mlp_51_hostcomplete"]["ours_x_realtime"] == 99.0

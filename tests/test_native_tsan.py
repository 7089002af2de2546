"""ThreadSanitizer regression check for the MT section parser.

The reference's stated QA process is sanitizer runs over the decode
tools (SURVEY §4: Valgrind, TODO:58-60); the rebuild's only threaded
native component is the section-parallel MLP parser, so this test builds
it with ``-fsanitize=thread`` (tools/tsan_mt_parse.{cc,sh}) and runs the
clean and corrupted (sequential-redo) paths at several thread counts,
failing on any race report or MT/sequential mismatch."""

import os
import shutil
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tsan_available() -> bool:
    if shutil.which("g++") is None:
        return False
    probe = subprocess.run(
        ["g++", "-fsanitize=thread", "-x", "c++", "-", "-o", "/dev/null"],
        input=b"int main(){return 0;}", capture_output=True)
    return probe.returncode == 0


@pytest.mark.skipif(not _tsan_available(),
                    reason="g++ with -fsanitize=thread unavailable")
def test_mt_parse_thread_sanitizer():
    result = subprocess.run(
        ["sh", os.path.join(REPO, "tools", "tsan_mt_parse.sh")],
        capture_output=True, text=True, timeout=540, cwd=REPO)
    assert result.returncode == 0, result.stdout + result.stderr
    assert "TSAN MT parse check passed" in result.stdout
    assert "WARNING: ThreadSanitizer" not in result.stdout + result.stderr

#!/usr/bin/env python
"""Benchmark entry point: delegates to dvda.cli.bench (the packaged
benchmark).  Prints ONE JSON line with the headline metric."""

import os
import sys

_repo = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _repo)

from dvda.cli.bench import main

if __name__ == "__main__":
    main()

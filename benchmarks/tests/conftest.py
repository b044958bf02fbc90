"""The benchmark's own tests: ``python -m pytest benchmarks/tests -q``
from the repository root. They put ``benchmarks/`` and the root on the
path, as ``benchmarks/run.py`` does."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

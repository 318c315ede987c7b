"""The benchmark's own tests (run with ``python -m pytest perfbench/tests``
from the repository's root): they import ``perfbench`` and the port from
the checkout."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
repository's root (not collected by the repository's ``tests/`` run). The
program is imported from ``src``."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

"""The benchmark's CPU tests: ``python -m pytest perfbench/tests -q``. Tests
marked ``cuda`` run one short cell on the card and skip without one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

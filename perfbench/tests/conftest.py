"""CPU tests of the benchmark (``python -m pytest perfbench/tests``), run
from the root of a checkout: the checkout's root goes on ``sys.path`` so
that ``perfbench`` and the program import as ``run.py`` imports them."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

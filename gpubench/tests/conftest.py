"""The benchmark's own tests: run from the repository's root with
`python -m pytest gpubench/tests`; the card's with `-m cuda` on a machine
with an NVIDIA card."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

"""The benchmark's own tests run from the repository's root:

    python -m pytest glmbench/tests            # the CPU tests
    python -m pytest glmbench/tests -m gpu     # on a machine with a card
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

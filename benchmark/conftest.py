"""The benchmark's own tests (``python -m pytest benchmark/``): its
folder and the checkout's root on the import path, the CPU's threads
shared out."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

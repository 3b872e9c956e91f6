import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# the tiny runs time a window of a few seconds: a few threads a process,
# so that several test processes do not crowd each other's steps out
torch.set_num_threads(2)

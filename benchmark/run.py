#!/usr/bin/env python3
"""
Run one cell of the benchmark of bild_tpu_torch on this machine's card(s):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See ``benchmark/README.md`` and
``benchmark/harness.py``.
"""
import time

_T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _startup_seconds():
    """Seconds between the process's start and `_T_START`, from ``/proc``."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK")
                   - (time.perf_counter() - _T_START))
    except (OSError, ValueError, IndexError):
        return 0.0


if __name__ == "__main__":
    pre = _startup_seconds()
    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    sys.exit(harness.main(sys.argv[1:], _T_START, pre))

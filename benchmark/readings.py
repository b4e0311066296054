#!/usr/bin/env python3
"""
The readings that a cell's correctness limits are set from: the reference's
numbers of one cell over several seeds, in one process, each seed a run of
the cell (set-up, a window of ``--seconds``, the check), printed as one JSON
line per seed and written to ``--out``.

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 \\
        --seconds 10 [--matmul split] [--out readings.jsonl]

``--fault <name>`` plants a fault of ``faults.py`` in the program. Only
the first seed's set-up warms up: the later ones replay what it built.
``--matmul split`` runs the control: the program's own bfloat16 tier of
the Rouse likelihood (``bild_tpu_torch.config.set_rouse_matmul``), one
precision below the configuration's float32. A sound limit lies above every
sound seed's number and below the control's (``PERF.md`` gives both).
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--matmul", default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--fault", default=None,
                    help="plant a fault of benchmark/faults.py in the program")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    import contextlib
    from benchmark import faults, harness
    out = open(args.out, "a") if args.out else None
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        planted = faults.plant(args.fault) if args.fault else contextlib.nullcontext()
        with planted:
            code, res = harness.run(args.workload, seed, args.seconds, bool(args.trace),
                                    matmul=args.matmul, readings=True, warm=n == 0)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "matmul": args.matmul or "config", "fault": args.fault,
                           "code": code,
                           "process_s": time.perf_counter() - t0, **(res or {})})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

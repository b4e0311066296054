"""
The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run reads the cell's configuration (``configs/<name>.json``, through
``BENCHMARK.json``'s ``file``) and traffic (``traffic/<name>.json``), builds
the configuration's model kind (``models/<model>.py``: the program's model,
the traffic law, the float64 reference), hands set-up and the calls to the
traffic's entry (``entries/<entry>.py``), warms up, and calls back to back
until ``--seconds`` have passed. ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` traces the middle half of the window and reports
the cell's per-layer metrics, each read by ``metrics/<name>.py`` from the
traced calls' records. After the window the model kind's reference
(``reference/check.py`` on its ``logL``) judges the kept answers against
the traffic's ``check.limits``. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number
beside its limit (also the last lines of standard error).

No file here needs an edit for a new cell: a configuration, a model
kind, a traffic mix, an entry, a metric and a kernel-name list are files
found by name.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from benchmark import guard, trace
from benchmark.reference import check
from benchmark.traffic import generate

ROOT = Path(__file__).resolve().parent.parent


def load_module(path):
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(items, name, what):
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def model_kind(root, cfg):
    """The class ``Kind`` of ``benchmark/models/<model>.py``, the model kind
    that configuration ``cfg`` names; a ``SystemExit`` that names the file
    where there is none."""
    path = Path(root) / "benchmark" / "models" / f"{cfg['model']}.py"
    if not path.is_file():
        raise SystemExit(f"no model kind for the configuration {cfg['name']!r}: "
                         f"benchmark/models/{cfg['model']}.py does not exist")
    return load_module(path).Kind


class Context:
    """What an entry gets: the program (``bt``), the configuration, the
    traffic, the seed, the device, whether set-up warms up (``warm``), and
    the configuration's model kind (``kind``, ``models/<model>.py``): the
    program's model, its sizes, the traffic law and the reference."""

    def __init__(self, bt, cfg, traffic, seed, device, kind, warm=True):
        self.bt, self.cfg, self.traffic, self.seed = bt, cfg, traffic, int(seed)
        self.device, self.kind, self.warm = device, kind, warm

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def card(device):
    """The card's name and power limit (nvidia-smi), for the record."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = "nvidia-smi not available"
    return out


def end_to_end(name, window, e2e, setup_s):
    """The value of end-to-end metric ``name``. ``traj_per_s.<suffix>`` is
    ``traj_per_s`` under a bound of its own, for cells whose work per call
    varies with the data."""
    if name == "setup_s":
        return setup_s
    if re.fullmatch(r"traj_per_s(\.\w+)?", name):
        return (window["trajectories"] - window["failed"]) / window["seconds"]
    if name == "frame_accuracy":
        return e2e["frame_accuracy"]
    m = re.fullmatch(r"sample_p(\d+)_s", name)
    if m:
        return float(np.percentile(e2e["walls"], int(m.group(1))))
    raise KeyError(f"no end-to-end metric {name!r} in the harness")


def window_loop(entry, seconds, traced, sampler_cls):
    """Calls back to back until ``seconds`` have passed; with ``traced``,
    the calls that start in the window's middle half run under the device
    profiler. A call that raises is a failed call: its trajectories count
    as failed, the first traceback goes to standard error, the window goes
    on. A window that uses up the traffic ends there, marked
    ``exhausted``. Returns ``(window, traced records, spent, device
    window)``."""
    win = trace.DeviceWindow() if traced else None
    records, spent = [], {"steps": 0.0, "samplers": 0.0}
    trajectories = failed = i = 0
    exhausted = False
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if win is not None and not win.started and time.perf_counter() - t0 >= seconds / 4:
            win.start()
        tracing = win is not None and win.running
        c0 = time.perf_counter()
        try:
            with trace.time_split(sampler_cls, spent) if tracing else contextlib.nullcontext():
                rec = entry.call(i)
        except generate.Exhausted as e:
            print(f"benchmark: {e}", file=sys.stderr)
            exhausted = True
            break
        except Exception:   # a failed request: counted, and the window goes on
            if not failed:
                traceback.print_exc()
            failed += entry.per_call
            trajectories += entry.per_call
            i += 1
            continue
        if tracing:
            rec["wall"] = time.perf_counter() - c0
            records.append(rec)
            if time.perf_counter() - t0 >= 3 * seconds / 4:
                win.stop()
        trajectories += rec["trajectories"]
        i += 1
    t1 = time.perf_counter()
    if win is not None and win.running:
        win.stop()
    return ({"seconds": t1 - t0, "calls": i, "trajectories": trajectories,
             "failed": failed, "exhausted": exhausted}, records, spent, win)


def traced_record(entry_name, records, spent, win, sizes):
    if win is None or not win.started:
        return None
    rec = win.read()
    rec.update(entry=entry_name, sizes=sizes, calls=len(records),
               trajectories=sum(r["trajectories"] for r in records),
               amis_steps=sum(r["amis_steps"] for r in records),
               evals=sum(r.get("evals", 0) for r in records),
               profiles=[p for r in records for p in r["profiles"]],
               calls_s=sum(r["wall"] for r in records),
               steps_s=spent["steps"], samplers_s=spent["samplers"])
    return rec


def run(workload, seed, seconds, trace_on, root=ROOT, device="cuda", pre_s=0.0,
        t_start=None, matmul=None, readings=False, warm=True):
    """One run: ``(exit code, result dict or None)``; prints the checks to
    standard error. ``matmul``: the program's precision tier in place of
    the configuration's (the control runs; the model kind applies it);
    ``device`` other than CUDA only for the CPU tests; ``readings`` adds
    every number the reference computed (``readings``) and the
    reference's seconds (``judge_s``); ``warm=False`` skips the warm-up (a
    later run in a process that ran the cell)."""
    t_start = time.perf_counter() if t_start is None else t_start
    root = Path(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = _named(spec["workloads"], workload, "workload")
    cfg_entry = _named(spec["configs"], cell["config"], "configuration")
    cfg = json.loads((root / cfg_entry["file"]).read_text())
    bench = root / "benchmark"
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text())
    Kind = model_kind(root, cfg)
    device = torch.device(device)
    if device.type == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < cell["chips"]):
        print(f"benchmark: the cell {workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2, None
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)

    import bild_tpu_torch as bt
    from bild_tpu_torch.amis.sampler import FixedkSampler
    bt.config.exact_fp32()
    kind = Kind(bt, cfg, device, matmul)
    ctx = Context(bt, cfg, traffic, seed, device, kind, warm)
    entry = load_module(bench / "entries" / f"{traffic['entry']}.py").Entry(ctx)
    entry.setup()
    if trace_on and device.type == "cuda":
        trace.DeviceWindow.warm()
    ctx.sync()
    setup_s = pre_s + time.perf_counter() - t_start

    window, records, spent, win = window_loop(entry, seconds, trace_on and device.type == "cuda",
                                              FixedkSampler)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    metrics, out_device, breakdown = {}, {}, None
    if not trace_on:
        e2e = entry.e2e()
        for m in spec["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": end_to_end(m["name"], window, e2e, setup_s),
                                      "unit": m["unit"]}
    else:
        rec = traced_record(traffic["entry"], records, spent, win, kind.sizes)
        if rec is not None:
            out_device = {"busy_s": rec["busy_s"], "window_s": rec["window_s"]}
            breakdown = {"device_ops": rec["device_ops"], "idle_gaps": rec["idle_gaps"]}
            for m in spec["per_layer"]:
                if applies(m, workload):
                    value = load_module(bench / "metrics" / f"{m['name']}.py").read(rec)
                    if value is not None:
                        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    j0 = time.perf_counter()
    numbers = entry.judge(check)
    judge_s = time.perf_counter() - j0
    del entry
    ok, rows = check.verdict(numbers, traffic["check"]["limits"])
    ok = ok and window["failed"] == 0 and not window["exhausted"]
    found = guard.forbidden_loaded()
    if found:
        print(f"benchmark: modules that a run must not load are loaded: {found}",
              file=sys.stderr)
        return 3, None
    if device.type == "cuda":
        print(f"benchmark: card {card(device)}", file=sys.stderr)
    print(f"benchmark: {window['calls']} calls, {window['trajectories']} trajectories in "
          f"{window['seconds']:.3f} s; setup {setup_s:.3f} s", file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    result = {
        "correct": bool(ok),
        "attempted": window["trajectories"],
        "failed": window["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else device.type),
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak),
                   **out_device},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    if readings:
        result["readings"] = {k: float(v) for k, v in numbers.items()}
        result["window"] = window
        result["judge_s"] = judge_s
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return 0, result


def parse(argv):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start, pre_s):
    args = parse(argv)
    code, result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                       pre_s=pre_s, t_start=t_start)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code

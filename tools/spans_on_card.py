"""
The program's spans (`bild_tpu_torch.utils.profiling`) on a CUDA card:

    python tools/spans_on_card.py clock [--calls 20] [--seconds 50] [--out FILE]
    python tools/spans_on_card.py cost --seed N [--spans on|off] [--out FILE]
    python tools/spans_on_card.py ab --seed N [--calls 30] [--out FILE]

from the root of a checkout.

``clock``: one CPU+CUDA `utils.profiling.trace` over ``--calls`` calls of
the benchmark cell ``rouse2-sample-T100`` and one call of
``rouse2-lockstep-T100``: each span's in-memory start against the start of
its profiler range's event, and the ten longest idle gaps of the device,
each with the innermost span open at its middle (and the host call the
benchmark's breakdown names, `benchmark.trace.idle_gaps`). Then a sparse
session: a span around one small kernel every 20 ms for ``--seconds``
seconds, the offsets fitted against the time since its first span, which
tells a fixed delay from a drift of the profiler's clock. Last, the
spans' cost with the profiler off, in ns.

``cost``: one ``--trace 1`` run of ``rouse2-sample-T100`` (51 s window)
through `benchmark.harness.run` in this process, with the spans as
shipped (``on``) or with their check made to read false (``off``), so that
two runs on one seed give the spans' traced cost in ``step_ms.single`` and
``call_mean_ms.single``. With the spans on it also gives the ``sample``
span's mean and ``sampler.steps`` per step beside those two metrics.

``ab``: the traced cost without the noise of two windows: under one
CUDA-only profiler session (as the benchmark's traced window), each of
``--calls`` calls of ``rouse2-sample-T100`` runs twice on the same
trajectory and program seed, once with the spans on and once off, in
turns (on, off; then off, on). Gives each arm's call wall and host time
in `FixedkSampler.steps` per AMIS step (as ``step_ms.single`` and
``call_mean_ms.single`` measure them), and the paired differences.

Each mode prints one JSON document and writes it to ``--out`` if given.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import bild_tpu_torch as bt  # noqa: E402
from benchmark import harness, trace  # noqa: E402
from bild_tpu_torch import _spans  # noqa: E402
from bild_tpu_torch.utils import profiling  # noqa: E402

CUDA_EVENT = torch.autograd.DeviceType.CUDA
DEVICE = torch.device("cuda" if torch.cuda.is_available() else "cpu")
ACTIVITIES = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if DEVICE.type == "cuda" else [])


def sync():
    if DEVICE.type == "cuda":
        torch.cuda.synchronize()


def card():
    if DEVICE.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def entry_for(cell, seed):
    """The benchmark's entry of ``cell``, set up (warmed) from ``seed``."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = harness._named(spec["workloads"], cell, "workload")
    conf = harness._named(spec["configs"], work["config"], "configuration")
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{work['traffic']}.json").read_text())
    bt.config.exact_fp32()
    bt.config.set_rouse_matmul(cfg["matmul"])
    ctx = harness.Context(bt, cfg, traffic, seed, DEVICE)
    entry = harness.load_module(ROOT / "benchmark" / "entries"
                                / f"{traffic['entry']}.py").Entry(ctx)
    entry.setup()
    return entry


def quartiles(values):
    v = sorted(values)
    return {"n": len(v), "min": v[0], "median": statistics.median(v), "max": v[-1],
            "within_50us": sum(abs(x) <= 50_000 for x in v)}


def analyse(prof, snap, label):
    """Span starts against their range events; the ten longest idle gaps
    of the device by the innermost span at their middle."""
    names = {s["name"] for s in snap["spans"]}
    ranges, device, host = {}, [], []
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == CUDA_EVENT:
            if e.name() not in names:
                device.append((a, b))
        elif e.name() in names:
            ranges.setdefault(e.name(), []).append(a)
        else:
            host.append((a, b, e.name()))
    offsets, unmatched = [], {}
    for name in names:
        mine = sorted(s["start_ns"] for s in snap["spans"] if s["name"] == name)
        theirs = sorted(ranges.get(name, []))
        if len(mine) == len(theirs):
            offsets += [t - m for m, t in zip(mine, theirs)]
        else:
            unmatched[name] = [len(mine), len(theirs)]
    depth = []
    for s in snap["spans"]:
        depth.append(0 if s["parent"] is None else depth[s["parent"]] + 1)
    merged = []
    for a, b in sorted(device):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(((a2 - b1, b1, a2) for (_, b1), (a2, _) in zip(merged, merged[1:])),
                  reverse=True)[:10]
    rows = []
    for (width, lo, hi), (host_label, _) in zip(gaps, trace.idle_gaps(device, host)):
        mid = (lo + hi) / 2
        inside = sorted((depth[i], s["name"]) for i, s in enumerate(snap["spans"])
                        if s["end_ns"] is not None and s["start_ns"] <= mid <= s["end_ns"])
        rows.append({"gap_ms": width / 1e6, "span": inside[-1][1] if inside else None,
                     "chain": [n for _, n in inside], "host": host_label})
    return {"label": label, "spans": len(snap["spans"]), "calls": snap["calls"],
            "offset_ns": quartiles(offsets) if offsets else None, "unmatched": unmatched,
            "busy_s": trace.union_seconds(device), "gaps": rows, "names": snap["names"],
            "counters": {k: v for k, v in snap["counters"].items() if v}}


def sparse_session(seconds):
    """A span every 20 ms for ``seconds`` s: the offsets against time."""
    x = torch.ones(1000, device=DEVICE)
    with profile(activities=ACTIVITIES) as prof:
        t_end, i = time.time() + seconds, 0
        while time.time() < t_end:
            with profiling.span(f"clock.{i}"):
                x.add_(1)
            i += 1
            time.sleep(0.02)
        sync()
    snap = profiling.snapshot()
    events = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock.") and e.device_type() != CUDA_EVENT}
    t0 = snap["spans"][0]["start_ns"]
    pts = [((s["start_ns"] - t0) / 1e9, events[s["name"]] - s["start_ns"])
           for s in snap["spans"]]
    mt = statistics.fmean(t for t, _ in pts)
    mo = statistics.fmean(o for _, o in pts)
    slope = (sum((t - mt) * (o - mo) for t, o in pts)
             / sum((t - mt) ** 2 for t, _ in pts))
    return {"seconds": seconds, "offset_ns": quartiles([o for _, o in pts]),
            "first_second_median_ns": statistics.median(o for t, o in pts if t < 1),
            "last_second_median_ns": statistics.median(o for t, o in pts if t > seconds - 1),
            "slope_ns_per_s": slope, "intercept_ns": mo - slope * mt}


def off_cost_ns(n=200_000):
    """ns a call with the profiler off: the check, a ``with span`` block,
    a `spanned` function and a bare function."""
    def timed(fn):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        return (time.perf_counter_ns() - t0) / n

    def block():
        with profiling.span("cost"):
            pass

    @profiling.spanned("cost")
    def decorated():
        pass

    def bare():
        pass

    return {"enabled_check": timed(torch.autograd._profiler_enabled),
            "with_span": timed(block), "spanned": timed(decorated), "bare_call": timed(bare)}


def clock(args):
    out = {"card": card(), "torch": torch.__version__}
    entry = entry_for("rouse2-sample-T100", 3100000001)
    sync()
    with tempfile.TemporaryDirectory() as logdir:
        with profiling.trace(logdir) as prof:
            t0 = time.perf_counter()
            for i in range(args.calls):
                entry.call(i)
            sync()
            out["sample_wall_s"] = time.perf_counter() - t0
        out["sample"] = analyse(prof, profiling.snapshot(), "rouse2-sample-T100")
    del entry
    entry = entry_for("rouse2-lockstep-T100", 3100000002)
    sync()
    with tempfile.TemporaryDirectory() as logdir:
        with profiling.trace(logdir) as prof:
            entry.call(0)
            sync()
        out["lockstep"] = analyse(prof, profiling.snapshot(), "rouse2-lockstep-T100")
    del entry
    out["sparse"] = sparse_session(args.seconds)
    out["off_ns"] = off_cost_ns()
    return out


def cost(args):
    if args.spans == "off":
        _spans._enabled = lambda: False
    code, res = harness.run("rouse2-sample-T100", args.seed, 51.0, True, device=DEVICE.type)
    m = {k: v["value"] for k, v in res["metrics"].items()} if res else {}
    out = {"card": card(), "seed": args.seed, "spans": args.spans, "exit": code,
           "correct": res and res["correct"], "metrics": m}
    snap = profiling.snapshot()
    if args.spans == "on" and snap["calls"]:
        names, steps = snap["names"], snap["counters"]["run_steps.steps"]
        out["sample_span_ms"] = names["sample"]["total_s"] / names["sample"]["count"] * 1e3
        out["steps_span_ms"] = names["sampler.steps"]["total_s"] / steps * 1e3
        out["spans_per_call"] = len(snap["spans"]) / snap["calls"]
    return out


def ab(args):
    from bild_tpu_torch.amis.sampler import FixedkSampler
    from bild_tpu_torch.parallel.batch import run_steps

    shipped = _spans._enabled
    entry = entry_for("rouse2-sample-T100", args.seed)
    arms = {arm: {"wall_s": [], "steps_s": [], "steps": []} for arm in ("on", "off")}
    with profile(activities=ACTIVITIES[1:] or ACTIVITIES):
        for i in range(args.calls):
            for arm in (("on", "off") if i % 2 == 0 else ("off", "on")):
                _spans._enabled = shipped if arm == "on" else (lambda: False)
                spent = {"steps": 0.0, "samplers": 0.0}
                steps0 = run_steps.steps
                sync()
                t0 = time.perf_counter()
                with trace.time_split(FixedkSampler, spent):
                    entry.call(i)
                sync()
                a = arms[arm]
                a["wall_s"].append(time.perf_counter() - t0)
                a["steps_s"].append(spent["steps"])
                a["steps"].append(run_steps.steps - steps0)
        _spans._enabled = shipped
    on, off = arms["on"], arms["off"]
    out = {"card": card(), "seed": args.seed, "calls": args.calls,
           "steps_equal": on["steps"] == off["steps"]}
    for arm, a in arms.items():
        out[arm] = {"call_mean_ms": 1e3 * statistics.fmean(a["wall_s"]),
                    "step_ms": 1e3 * sum(a["steps_s"]) / max(sum(a["steps"]), 1)}
    diffs = [1e3 * (x - y) for x, y in zip(on["wall_s"], off["wall_s"])]
    out["call_ms_on_minus_off"] = {"mean": statistics.fmean(diffs),
                                   "median": statistics.median(diffs),
                                   "quartiles": statistics.quantiles(diffs, n=4)}
    out["step_ms_on_minus_off"] = out["on"]["step_ms"] - out["off"]["step_ms"]
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("clock")
    c.add_argument("--calls", type=int, default=20)
    c.add_argument("--seconds", type=float, default=50.0)
    k = sub.add_parser("cost")
    k.add_argument("--seed", type=int, required=True)
    k.add_argument("--spans", choices=("on", "off"), default="on")
    a = sub.add_parser("ab")
    a.add_argument("--seed", type=int, required=True)
    a.add_argument("--calls", type=int, default=30)
    for p in (c, k, a):
        p.add_argument("--out")
    args = parser.parse_args()
    out = {"clock": clock, "cost": cost, "ab": ab}[args.mode](args)
    text = json.dumps(out, indent=1)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)


if __name__ == "__main__":
    main()

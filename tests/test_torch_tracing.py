"""bild_tpu_torch's spans and counters (`utils.profiling.span`, `snapshot`,
`ops.counters`): nothing recorded with the profiler off, the layers'
spans and their links under a profiler session, self time, one log a
session, spans on the session's thread alone, the adaptive rounds' slot
counters against an independent count, and the benchmark's readers of
them on hand-built snapshots."""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import bild_tpu_torch as bt
from benchmark import harness
from bild_tpu_torch import _spans
from bild_tpu_torch.infer import adaptive
from bild_tpu_torch.ops import counters
from bild_tpu_torch.parallel import TrajectoryBatch
from bild_tpu_torch.utils import profiling
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64
CPU = [ProfilerActivity.CPU]
SAMPLE_KW = dict(k_max=3, init_runs=4)
DATASET_KW = dict(k_max=3, N=16, informed_init=True, optimize_boundaries=True)
SCHEDULES = {"lockstep": dict(steps_per_k=4, scout_steps=2, refine_top=2),
             "adaptive": dict(init_steps=2, steps_per_round=1, max_steps_per_k=8,
                              samplesize=256)}


@pytest.fixture(scope="module")
def model():
    return bt.models.MultiStateRouse(8, 1.0, 5.0, d=3, localization_error=0.1,
                                     device="cpu", dtype=F64)


def profiles(B, T):
    prof = np.zeros((B, T), dtype=int)
    for b in range(B):
        prof[b, 5 + 2 * b: 15 + 3 * b] = 1
    return prof


@pytest.fixture(scope="module")
def batch(model):
    return model.trajectories_from_loopingprofiles(
        profiles(6, 40), generator=torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def traj(model):
    return model.trajectory_from_loopingprofile(
        profiles(1, 30)[0], generator=torch.Generator().manual_seed(1))


def sample(traj, model, seed=2):
    return bt.sample(traj, model, generator=torch.Generator().manual_seed(seed), **SAMPLE_KW)


def trajectories(batch):
    err = np.full(3, 0.1)
    return [bt.Trajectory(data=batch.data[i], valid=batch.valid[i], localization_error=err)
            for i in range(batch.B)]


def by_name(snap, name):
    return [s for s in snap["spans"] if s["name"] == name]


def parent_name(snap, s):
    return None if s["parent"] is None else snap["spans"][s["parent"]]["name"]


def test_no_session_records_no_span_and_counters_count(traj, model, monkeypatch):
    before = profiling.snapshot()

    def no_range(*args, **kwargs):
        raise AssertionError("a span opened a profiler range with the profiler off")

    monkeypatch.setattr(_spans, "_Range", no_range)
    steps = counters.read(["run_steps.steps"])["run_steps.steps"]
    sample(traj, model)
    assert counters.read(["run_steps.steps"])["run_steps.steps"] > steps
    assert profiling.snapshot() == before


def test_sample_records_its_layers(traj, model):
    with profile(activities=CPU):
        sample(traj, model, seed=2)
        sample(traj, model, seed=3)
    snap = profiling.snapshot()
    assert snap["calls"] == 2
    assert {"sample", "sample.decide", "sampler.init", "sampler.enumerate",
            "sampler.steps", "sampler.fetch", "run_steps"} <= set(snap["names"])
    roots = [i for i, s in enumerate(snap["spans"]) if s["parent"] is None]
    assert [snap["spans"][i]["name"] for i in roots] == ["sample", "sample"]
    assert [snap["spans"][i]["call"] for i in roots] == [0, 1]
    wanted = {"sample.decide": "sample", "sampler.init": "sample", "sampler.steps": "sample",
              "sampler.enumerate": "sampler.init", "sampler.fetch": "sampler.steps",
              "run_steps": "sampler.steps"}
    for s in snap["spans"]:
        if s["parent"] is not None:
            assert parent_name(snap, s) == wanted[s["name"]]
            root = snap["spans"][roots[s["call"]]]
            assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] <= root["end_ns"]
            assert snap["spans"][s["parent"]]["call"] == s["call"]
    assert snap["names"]["sample"]["count"] == 2
    assert snap["counters"]["run_steps.steps"] > 0


def test_self_time_is_duration_less_children():
    with profile(activities=CPU):
        with profiling.span("outer"):
            with profiling.span("inner"):
                time.sleep(0.02)
            with profiling.span("inner"):
                with profiling.span("leaf"):
                    time.sleep(0.01)
            time.sleep(0.01)
    snap = profiling.snapshot()

    def took(s):
        return (s["end_ns"] - s["start_ns"]) / 1e9

    outer, = by_name(snap, "outer")
    inner = by_name(snap, "inner")
    leaf, = by_name(snap, "leaf")
    names = snap["names"]
    assert names["outer"]["self_s"] == pytest.approx(took(outer) - sum(map(took, inner)),
                                                     abs=1e-9)
    assert names["inner"]["self_s"] == pytest.approx(sum(map(took, inner)) - took(leaf),
                                                     abs=1e-9)
    assert names["inner"]["total_s"] == pytest.approx(sum(map(took, inner)), abs=1e-9)
    assert names["leaf"]["self_s"] == names["leaf"]["total_s"]
    assert names["outer"]["self_s"] >= 0.009 and names["inner"]["count"] == 2


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_sample_dataset_records_its_layers(model, batch, schedule):
    with profile(activities=CPU):
        bt.parallel.sample_dataset(model, trajectories(batch), schedule=schedule,
                                   generator=torch.Generator().manual_seed(4),
                                   **DATASET_KW, **SCHEDULES[schedule])
    snap = profiling.snapshot()
    assert snap["calls"] == 1
    wanted = {"dataset.chunk": {"sample_dataset"}, "dataset.sample": {"dataset.chunk"},
              "dataset.climb": {"dataset.chunk"},
              "run_steps": {"dataset.sample", "adaptive.round"},
              "adaptive.round": {"dataset.sample"}, "adaptive.decide": {"adaptive.round"},
              "adaptive.fetch": {"adaptive.round"}}
    names = {"sample_dataset", "dataset.chunk", "dataset.sample", "dataset.climb",
             "run_steps"}
    if schedule == "adaptive":
        names |= {"adaptive.round", "adaptive.decide", "adaptive.fetch"}
    assert set(snap["names"]) == names
    for s in snap["spans"]:
        if s["name"] != "sample_dataset":
            assert parent_name(snap, s) in wanted[s["name"]]
    steps = snap["counters"]["run_steps.steps"]
    assert steps == (snap["counters"]["run_lanes.steps"]
                     + snap["counters"].get("adaptive.slot_steps", 0)
                     // batch.B) and steps > 0
    assert snap["counters"]["optimize_boundary_batch.evaluations"] > 0


def test_adaptive_slot_counters_against_an_independent_count(model, batch, monkeypatch):
    slots = {"all": 0, "filler": 0}
    run_slots = adaptive.run_slots

    def counted(*args, steps, live, **kwargs):
        slots["all"] += live.numel() * steps
        slots["filler"] += int((~live).sum()) * steps
        return run_slots(*args, steps=steps, live=live, **kwargs)

    monkeypatch.setattr(adaptive, "run_slots", counted)
    names = ["adaptive.slot_steps", "adaptive.filler_slot_steps"]
    before = counters.read(names)
    kw = SCHEDULES["adaptive"]
    with profile(activities=CPU):
        res = adaptive.sample_batch_adaptive(model, TrajectoryBatch(batch.data, batch.valid),
                                             k_max=3, N=16,
                                             generator=torch.Generator().manual_seed(5), **kw)
    got = {k: v - before[k] for k, v in counters.read(names).items()}
    snap = profiling.snapshot()
    # every round is a span, and so is the closing decision pass, which
    # finds every trajectory settled and runs no slots
    assert snap["names"]["adaptive.round"]["count"] == res.rounds + 1 > 1
    assert {k: snap["counters"][k] for k in names} == got
    assert got["adaptive.slot_steps"] == res.rounds * batch.B * kw["steps_per_round"]
    assert got["adaptive.slot_steps"] == slots["all"]
    assert got["adaptive.filler_slot_steps"] == slots["filler"] > 0


@pytest.mark.parametrize("between", ["snapshot", "a call without the profiler"])
def test_a_second_session_starts_a_new_log(traj, model, between):
    with profile(activities=CPU):
        sample(traj, model)
    if between == "snapshot":
        first = profiling.snapshot()
        assert profiling.snapshot() == first
    else:
        sample(traj, model)
        first = profiling.snapshot()
    assert first["calls"] == 1
    with profile(activities=CPU):
        sample(traj, model)
        sample(traj, model)
    second = profiling.snapshot()
    assert second["calls"] == 2 and second["names"]["sample"]["count"] == 2
    assert second["spans"][0]["start_ns"] > first["spans"][-1]["start_ns"]
    # the same seed twice: each call counts what the first session's one did
    assert second["counters"]["run_steps.steps"] == 2 * first["counters"]["run_steps.steps"]


def test_each_trace_block_starts_a_new_log(tmp_path):
    for i in range(2):
        with profiling.trace(str(tmp_path / str(i))):
            with profiling.span(f"block{i}"):
                pass
    snap = profiling.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["block1"] and snap["calls"] == 1


def test_spans_record_only_on_the_thread_of_the_session():
    def worker():
        with profiling.span("elsewhere"):
            pass

    with profile(activities=CPU):
        with profiling.span("here"):
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join()
    snap = profiling.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["here"] and snap["calls"] == 1


def snap_of(names, counts):
    return {"spans": [], "calls": 2,
            "names": {k: {"count": n, "total_s": t, "self_s": t} for k, (n, t) in names.items()},
            "counters": counts}


HAND = snap_of({"sample": (2, 0.5), "sample.decide": (6, 0.04), "sampler.fetch": (8, 0.2),
                "sample_dataset": (2, 10.0), "dataset.climb": (2, 0.8),
                "adaptive.round": (30, 3.0), "adaptive.decide": (30, 0.15)},
               {"graphs.replays": 120, "graphs.copies": 600, "run_steps.steps": 144,
                "adaptive.slot_steps": 4000, "adaptive.filler_slot_steps": 1000})
READINGS = {"graph_calls_per_step.dataset": 5.0, "graph_calls_per_step.adaptive": 5.0,
            "graph_calls_per_step.single": 5.0, "climb_share.dataset": 8.0,
            "filler_share.adaptive": 25.0, "decide_ms.adaptive": 5.0,
            "decide_ms.single": 20.0, "fetch_wait_share.single": 40.0}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_the_benchmark_reads_the_snapshot(metric, monkeypatch):
    read = harness.load_module(harness.ROOT / "benchmark" / "metrics" / f"{metric}.py").read
    monkeypatch.setattr(profiling, "snapshot", lambda: HAND)
    assert read({}) == pytest.approx(READINGS[metric])
    monkeypatch.setattr(profiling, "snapshot", lambda: {**snap_of({}, {}), "calls": 0})
    assert read({}) is None
    monkeypatch.delattr(profiling, "snapshot")          # a program without spans
    assert read({}) is None

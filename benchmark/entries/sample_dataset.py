"""
Entry ``sample_dataset``: one caller runs
``bild_tpu_torch.parallel.sample_dataset`` on a new dataset per call, back
to back (a closed loop).

Traffic keys: ``T``, ``max_switches``, ``per_call`` (trajectories in a
call's dataset, at most the configuration's ``chunk_size``), ``max_calls``
(datasets made for the window; a window that uses them all fails),
``block_calls`` (datasets drawn at a time, all of them by default: the
first block draws from the window's own substreams, block j from
substreams tagged j, so raising ``max_calls`` keeps the first block's
datasets bit for bit), ``call`` (keyword arguments of `sample_dataset`,
``schedule`` among them) and ``check.rows`` (rows kept in each call, drawn from the seed, and rows
judged, drawn from the seed among all kept). One warm-up call runs on a
dataset of its own of the same size: the captured step graphs are keyed
by the lane count.

A kept row's samples are copied as the timed path left them: the program's
per-lane summaries (``parallel.batch._summaries`` after the lockstep
scout and refine, ``infer.adaptive._final_summaries`` after the adaptive
rounds) are wrapped from outside for the window's calls, and read the
kept rows' lanes before they summarize them. So the reference judges the
likelihoods that the step graphs scored, and the evidences, MAP profiles
and marginals that the call returned from those samples.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.traffic import generate

STATE = ("ss", "thetas", "logLs", "logdeltas")


class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        self.bt = ctx.bt
        self.traffic = ctx.traffic
        self.kw = {"chunk_size": int(ctx.cfg["chunk_size"]), **self.traffic["call"]}
        self.per_call = self.traffic["per_call"]
        if self.per_call > self.kw["chunk_size"]:
            raise ValueError(f"per_call {self.per_call} is over the configuration's "
                             f"chunk_size {self.kw['chunk_size']}: a call is one chunk")
        from bild_tpu_torch.parallel import batch
        from bild_tpu_torch.infer import adaptive
        from bild_tpu_torch import postproc
        self._batch, self._adaptive = batch, adaptive
        self._lanes, self._steps = batch.run_lanes, batch.run_steps
        self._climb = postproc.optimize_boundary_batch
        self.results, self.kept = [], []

    def _datasets(self, tag, calls):
        """``(truths (calls, per_call, T), [the Trajectory list of each
        call])``, drawn ``block_calls`` datasets at a time."""
        c, t = self.ctx, self.traffic
        per, block = t["per_call"], int(t.get("block_calls", calls))
        truths, sets = [], []
        for j, first in enumerate(range(0, calls, block)):
            n = min(block, calls - first)
            tags = (tag,) if j == 0 else (tag, j)
            drawn = generate.truths(generate.substream(c.seed, *tags, "truths"), n * per,
                                    t["T"], c.kind.n_states, t["max_switches"], c.device)
            data = c.kind.trajectories(generate.substream(c.seed, *tags, "data"), drawn)
            trajs = [c.kind.trajectory(row) for row in data.unbind(0)]
            truths.append(drawn.cpu().numpy().reshape(n, per, -1))
            sets.extend(trajs[i * per:(i + 1) * per] for i in range(n))
        return np.concatenate(truths), sets

    def setup(self):
        self.truths, self.sets = self._datasets("window", self.traffic["max_calls"])
        if self.ctx.warm:
            _, warm = self._datasets("warmup", 1)
            self._run(warm[0], generate.substream(self.ctx.seed, "warmup"))
        self.ctx.sync()

    def _run(self, trajs, seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return self.bt.parallel.sample_dataset(self.ctx.kind.model, trajs, generator=g,
                                               **self.kw)

    @contextlib.contextmanager
    def _kept_lanes(self, rows):
        """Inside the block, ``got[(row, k)]`` receives each of ``rows``'s
        lanes as the program's summaries read it: the filled steps of its
        samples. A later summary of a (row, k) replaces an earlier one, as
        the refine's results replace the scout's."""
        got, B = {}, self.per_call
        batch, adaptive = self._batch, self._adaptive
        summaries, final = batch._summaries, adaptive._final_summaries

        def copy(state, active, n_done):
            lanes = np.flatnonzero(np.isin(np.arange(state.ss.shape[0]) % B, rows))
            idx = torch.as_tensor(lanes, device=state.ss.device)
            ks = (active[idx].sum(dim=1) - 1).cpu().numpy()
            done = (n_done[idx].cpu().numpy() if isinstance(n_done, torch.Tensor)
                    else np.full(len(lanes), int(n_done)))
            top = int(done.max(initial=0))
            arrays = {f: getattr(state, f)[idx, :top].cpu().numpy() for f in STATE}
            for j, (lane, k) in enumerate(zip(lanes, ks)):
                got[(int(lane % B), int(k))] = {f: a[j, :done[j]] for f, a in arrays.items()}

        def lockstep(state, active, n_done, *args, **kw):
            copy(state, active, n_done)
            return summaries(state, active, n_done, *args, **kw)

        def adaptive_(grid, active, *args, **kw):
            copy(grid, active, grid.n_steps)
            return final(grid, active, *args, **kw)

        batch._summaries, adaptive._final_summaries = lockstep, adaptive_
        try:
            yield got
        finally:
            batch._summaries, adaptive._final_summaries = summaries, final

    def call(self, i):
        """One call: ``{"trajectories", "profiles", "amis_steps", "evals"}``."""
        if i >= len(self.sets):
            raise generate.Exhausted(f"the window used all {len(self.sets)} datasets: "
                                     "raise the traffic's max_calls")
        lane_steps, steps, climbed = (self._lanes.lane_steps, self._steps.steps,
                                      self._climb.evaluations)
        rng = np.random.default_rng(generate.substream(self.ctx.seed, "rows", i))
        rows = np.sort(rng.choice(self.per_call, replace=False,
                                  size=min(self.traffic["check"]["rows"], self.per_call)))
        with self._kept_lanes(rows) as got:
            res = self._run(self.sets[i], generate.substream(self.ctx.seed, "program", i))
        self.ctx.sync()
        if res.evals is not None:
            sampled = int(np.sum(res.evals))
        else:
            sampled = (self._lanes.lane_steps - lane_steps) * int(self.kw.get("N", 128))
        evals = sampled + self._climb.evaluations - climbed
        self.results.append(res)
        self.kept.extend((i, int(r), {k: s for (row, k), s in got.items() if row == r})
                         for r in rows)
        T = self.traffic["T"]
        return {"trajectories": len(self.sets[i]), "profiles": [[evals, T, T]],
                "amis_steps": self._steps.steps - steps, "evals": evals}

    def e2e(self):
        hits = frames = 0
        for res, truths in zip(self.results, self.truths):
            climbed = np.stack(res.optimized)
            hits += int(np.sum(climbed == truths))
            frames += climbed.size
        return {"frame_accuracy": hits / max(frames, 1)}

    def answers(self):
        """``check.rows`` of the kept rows, drawn from the seed, as plain
        arrays (`reference.check.judge_dataset`)."""
        rng = np.random.default_rng(generate.substream(self.ctx.seed, "judged"))
        picks = rng.choice(len(self.kept), replace=False,
                           size=min(self.traffic["check"]["rows"], len(self.kept)))
        out = []
        for j in np.sort(picks):
            i, r, samples = self.kept[j]
            res = self.results[i]
            out.append({"data": self.sets[i][r].data.double().cpu().numpy(),
                        "evidence": res.evidence[r],
                        "best_k": int(res.best_k()[r]),
                        "profiles_by_k": res.profiles_by_k[r],
                        "optimized": res.optimized[r],
                        "eliminated": bool(res.eliminated[r]),
                        "marginals": None if res.marginals is None else res.marginals[r],
                        "samples": samples})
        self.results, self.kept = [], []
        return out

    def judge(self, check):
        return check.judge_dataset(self.ctx.kind.reference, self.answers(),
                                   self.ctx.kind.n_states, float(self.kw.get("dE", 0.0)))

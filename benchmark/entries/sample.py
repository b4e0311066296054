"""
Entry ``sample``: one caller runs ``bild_tpu_torch.sample()`` on one new
trajectory per call, back to back (a closed loop).

Traffic keys: ``T``, ``max_switches``, ``pool`` (trajectories made for the
window; a window that uses them all fails), ``warmup_calls`` (calls on
trajectories of their own before the window), ``call`` (keyword arguments
of `sample`) and ``check.calls`` (calls kept for the reference, drawn from
the seed; the call that scored the most profiles is kept besides).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.traffic import generate

KEEP_ONE_IN = 8


class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        self.bt = ctx.bt
        self.traffic = ctx.traffic
        self.kw = dict(self.traffic["call"])
        self.per_call = 1
        self.walls = []
        self.hits = self.frames = 0
        self.kept, self.longest = {}, (-1, None)

    def _data(self, tag, count):
        c, t = self.ctx, self.traffic
        truths = generate.truths(generate.substream(c.seed, tag, "truths"), count,
                                 t["T"], c.kind.n_states, t["max_switches"], c.device)
        data = c.kind.trajectories(generate.substream(c.seed, tag, "data"), truths)
        return truths.cpu().numpy(), data

    def setup(self):
        self.truths, self.data = self._data("window", self.traffic["pool"])
        if self.ctx.warm:
            _, warm = self._data("warmup", self.traffic["warmup_calls"])
            for i in range(len(warm)):
                self._sample(warm[i], generate.substream(self.ctx.seed, "warmup", i))
        self.ctx.sync()

    def _sample(self, data, seed):
        kind = self.ctx.kind
        g = torch.Generator(device=self.ctx.device)
        g.manual_seed(seed)
        return self.bt.sample(kind.trajectory(data), kind.model, generator=g, **self.kw)

    def call(self, i):
        """One call: ``{"trajectories", "profiles", "amis_steps", "T"}``."""
        if i >= len(self.data):
            raise generate.Exhausted(f"the window used all {len(self.data)} trajectories "
                                     "of the pool: raise the traffic's pool")
        c = self.ctx
        t0 = time.perf_counter()
        res = self._sample(self.data[i], generate.substream(c.seed, "program", i))
        self.walls.append(time.perf_counter() - t0)
        best = np.asarray(res.best_profile()[:])
        self.hits += int(np.sum(best == self.truths[i]))
        self.frames += best.size
        steps = sum(s.n_steps_host for s in res.samplers)
        profiles = sum(s.n_steps_host * s.N + (len(s._exhaustive["logLs"])
                                               if s._exhaustive else 0)
                       for s in res.samplers)
        if generate.substream(c.seed, "keep", i) % KEEP_ONE_IN == 0 \
                and len(self.kept) < self.traffic["check"]["calls"]:
            self.kept[i] = res
        if profiles > self.longest[0]:
            self.longest = (profiles, (i, res))
        T = self.traffic["T"]
        return {"trajectories": 1, "profiles": [[profiles, T, T]], "amis_steps": steps}

    def e2e(self):
        return {"walls": self.walls, "frame_accuracy": self.hits / max(self.frames, 1)}

    def answers(self):
        """The kept calls' answers as plain arrays (`reference.check.judge_sample`)."""
        kept = dict(self.kept)
        if self.longest[1] is not None:
            i, res = self.longest[1]
            kept[i] = res
        self.kept, self.longest = {}, (-1, None)
        out = []
        for i, res in sorted(kept.items()):
            samplers = []
            for s in res.samplers:
                entry = {"k": s.k, "evidence": float(s.evidences[-1][0])}
                if s._exhaustive is not None:
                    entry.update(exhaustive=True, profiles=s._exhaustive["profiles"],
                                 logLs=s._exhaustive["logLs"])
                elif hasattr(s, "_lane"):
                    st, sc = s.state, s.n_steps_host
                    entry.update(exhaustive=False,
                                 ss=st.ss[:sc].cpu().numpy(),
                                 thetas=st.thetas[:sc].cpu().numpy(),
                                 logLs=st.logLs[:sc].cpu().numpy(),
                                 logdeltas=st.logdeltas[:sc].cpu().numpy())
                samplers.append(entry)
            out.append({"data": self.data[i].double().cpu().numpy(),
                        "best_k": int(res.best_k()),
                        "best_profile": np.asarray(res.best_profile()[:]),
                        "samplers": samplers})
            del res
        return out

    def judge(self, check):
        return check.judge_sample(self.ctx.kind.reference, self.answers(),
                                  self.ctx.kind.n_states, float(self.kw.get("dE", 0.0)))

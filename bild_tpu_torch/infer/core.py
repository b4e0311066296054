"""
Top-level inference entry point (counterpart of `bild_tpu.infer.core`).

The outer active-learning loop over switch counts k is sequential,
data-dependent host logic; every numeric step inside it (proposal draws,
batched likelihoods, ensemble reweighting) runs on the model's device
through `FixedkSampler`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.special import logsumexp

from ..amis.sampler import FixedkSampler, draw_seed, spawn_generator
from ..config import DEFAULT_DEVICE, resolve_device
from ..trajectory import make_trajectory
from .choice import ChoiceSampler

__all__ = ["sample", "SamplingResults"]


def sample(traj, model,
           dE=0,
           init_runs=20,
           certainty_in_k=0.99,
           k_lookahead=2,
           k_max=20,
           sampler_kw={},
           choice_kw={},
           decision_interval=1,
           generator: Optional[torch.Generator] = None):
    """
    Run the full BILD scheme for one trajectory.

    Parameters as `bild_tpu.sample`: ``dE`` is the evidence margin;
    ``init_runs`` the minimum AMIS steps per new k; sampling stops once the
    choice distribution concentrates beyond ``certainty_in_k`` and the
    lookahead region (the last ``k_lookahead`` values of k) carries less
    expected information than one more sample. ``decision_interval``
    commits each decision to that many AMIS steps.

    ``generator`` (a `torch.Generator` on the model's device) seeds every
    draw: each sampler gets a generator spawned from it, and the choice
    sampler's numpy RNG is seeded from it too, so a run is reproducible
    from the generator alone. Seeded from numpy's global RNG if omitted.

    Returns
    -------
    SamplingResults
    """
    device = resolve_device(getattr(model, "device", DEFAULT_DEVICE))
    traj = make_trajectory(traj, device=device,
                           dtype=getattr(model, "dtype", torch.float32))
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(int(np.random.randint(2**31)))

    choice_kw = dict(choice_kw)
    choice_kw.setdefault("rng", np.random.default_rng(draw_seed(generator)))

    samplers = []
    log = {"k": [], "pk": [], "KLD": [], "I_la": []}
    memory = {"fresh sample": False}

    def add_samples(k, n=1):
        ran = samplers[k].steps(n)
        for _ in range(ran):
            for entry in log.values():
                entry.append(None)
            log["k"][-1] = k
        if ran:
            memory["fresh sample"] = True

    def determine_next_step():
        k_new = len(samplers)

        if not memory["fresh sample"]:
            if len(log["k"]) == 0:
                return k_new
            return log["k"][-1]  # pragma: no cover

        logE = np.array([s.evidences[-1][0] for s in samplers])
        dlogE = np.array([s.evidences[-1][1] for s in samplers])
        N = np.array([np.inf if s.exhausted else s.n_steps_host
                      for s in samplers])

        cs = ChoiceSampler(logE, dlogE**2, N, dE, **choice_kw)
        pk = cs.counts0 / cs.samplesize

        if k_new < k_lookahead + 1 and k_new <= k_max:
            k_next = k_new
            KLD = None
            I_la = np.inf
        else:
            KLD = cs.KLD_moreSamples()
            k_KLD = int(np.argmax(KLD))

            if k_new >= k_lookahead + 1:
                I_la = cs.KLD_omitK(np.arange(k_new - k_lookahead, k_new))
            else:
                I_la = np.inf

            k_next = k_KLD
            if I_la > KLD[k_KLD] and k_new <= k_max:
                k_next = k_new

        log["pk"][-1] = pk
        log["KLD"][-1] = KLD
        log["I_la"][-1] = I_la
        memory["fresh sample"] = False
        return k_next

    # pad every sampler's parameter arrays to k_max slots (as bild_tpu does)
    sampler_kw = dict(sampler_kw)
    sampler_kw.setdefault("k_pad", k_max)

    def add_sampler(k):
        if k != len(samplers):
            raise RuntimeError("samplers must be added in order of k")
        samplers.append(FixedkSampler(traj, model, k=k,
                                      generator=spawn_generator(generator),
                                      **sampler_kw))
        add_samples(k, init_runs)

    k_next = 0
    run_condition = True
    try:
        while run_condition:
            if k_next < len(samplers):
                add_samples(k_next, decision_interval)
            elif k_next == len(samplers):
                add_sampler(k_next)
            else:  # pragma: no cover
                raise RuntimeError("Trying to sample outside of existing range; this is a bug")

            k_next = determine_next_step()

            # stopping: certainty reached, unless a new k is demanded
            if k_next == len(samplers):
                run_condition = True
            else:
                run_condition = np.max(log["pk"][-1]) < certainty_in_k
                if log["KLD"][-1] is not None:
                    run_condition &= log["KLD"][-1][k_next] > 0

    except KeyboardInterrupt:  # pragma: no cover
        pass  # return partial results

    return SamplingResults(traj, model, dE, samplers, log)


class SamplingResults:
    """
    Output container: ``traj``, ``model``, ``dE``, ``samplers``, ``log``
    (NaN-padded diagnostic arrays), properties ``k``/``evidence``/
    ``evidence_se``, and `best_k`, `best_profile`, `log_marginal_posterior`
    (including the evidence-weighted ``'average'``).
    """

    def __init__(self, traj, model, dE, samplers, log=None):
        self.traj = traj
        self.model = model
        self.dE = dE
        self.samplers = samplers

        def to_padded_array(list_2d):
            def length(obj):
                return 1 if obj is None else len(np.atleast_1d(obj))

            dim0 = len(list_2d)
            max_dim1 = max(map(length, list_2d), default=1)
            arr = np.full((dim0, max_dim1), np.nan)
            for i, item in enumerate(list_2d):
                if item is not None:
                    item = np.atleast_1d(item)
                    arr[i, : len(item)] = item
            return arr

        self.log = {}
        keys_1d = {"k", "I_la"}
        if log is not None:
            for k in log.keys() & keys_1d:
                self.log[k] = np.array([np.nan if v is None else v for v in log[k]])
            for k in log.keys() - keys_1d:
                self.log[k] = to_padded_array(log[k])

    @property
    def k(self):
        return np.array([s.k for s in self.samplers])

    @property
    def evidence(self):
        return np.array([s.evidences[-1][0] for s in self.samplers])

    @property
    def evidence_se(self):
        return np.array([s.evidences[-1][1] for s in self.samplers])

    def best_k(self, dE=None):
        """Smallest k whose evidence is within dE of the maximum."""
        if dE is None:
            dE = self.dE
        ks_plausible = self.k[self.evidence >= np.max(self.evidence) - dE]
        return int(np.min(ks_plausible))

    def best_profile(self, dE=None):
        return self.samplers[self.best_k(dE)].MAP_profile()

    def log_marginal_posterior(self, dE=None):
        """``(n, T)`` log marginal posterior; ``dE='average'`` averages over
        k weighted by evidence."""
        if isinstance(dE, str) and dE == "average":
            with np.errstate(under="ignore"):
                logpost = logsumexp(
                    [s.log_marginal_posterior() + logev
                     for s, logev in zip(self.samplers, self.evidence)
                     if s.evidences[-1][0] > -np.inf],
                    axis=0,
                )
                return logpost - logsumexp(logpost, axis=0)
        if dE is None:
            dE = self.dE
        return self.samplers[self.best_k(dE)].log_marginal_posterior()

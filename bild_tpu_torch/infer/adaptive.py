"""
Adaptive dataset schedule (counterpart of `bild_tpu.infer.adaptive`):
per-trajectory active learning over a batch.

Where `parallel.sample_batch` gives every (trajectory, k) lane the same
fixed number of AMIS steps, `sample_batch_adaptive` re-decides after every
round where each trajectory's next likelihood budget goes, by the
reference's rule (``bild/core.py:138-227``): the expected KL information
gain of more samples at each opened k (`KLD_moreSamples`), the lookahead
importance of opening a new k (`KLD_omitK`), and certainty-based stopping.

- The device state is a **lane grid**: one `AmisState` whose ``L·B`` lanes
  are the (k, trajectory) pairs, k-major. k opens lazily per trajectory
  (host bookkeeping only).
- A **bootstrap** runs lanes ``k = 0..k_lookahead`` for ``init_steps``
  steps through the lockstep runner (`parallel.batch.run_lanes`).
- Each **round**, `decide_batch` evaluates the decision rule for every
  trajectory at once on the device (one packed fetch); the chosen ``(k,
  trajectory)`` slots, B of them, are gathered, advanced
  ``steps_per_round`` steps from each slot's own step count (`run_slots`:
  one likelihood launch per step for all slots; on CUDA one replay of a
  captured step, `parallel.graphs`) and scattered back.
- **Budget reallocation**: the slot of a converged trajectory goes to
  another live trajectory's next-highest-KLD lane, so one trajectory can
  advance several of its k-lanes in one round; the rest are dead filler
  slots, which the likelihood evaluates and the update leaves unchanged.

Randomness: as in the lockstep runner, one 64-bit key per (k, trajectory)
lane, drawn k-major from the caller's `torch.Generator`, and each lane's
draws at step i come from its stream folded by i (`lanes.LaneRNG.fold`,
per lane here). A lane's result therefore depends only on its key and its
own step count: an adaptive lane after n steps equals the lockstep lane
with the same key after n steps, bit for bit where the likelihood is
lane-exact.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .._spans import span
from ..amis.cfc import CFC
from ..amis.dirichlet import check_exhausted
from ..amis.sampler import AmisState, _marginal_posterior, draw_seed
from ..lanes import LaneRNG, normal
from ..ops import counters
from ..parallel.batch import (BatchResults, TrajectoryBatch, _informed_proposals_all_k,
                              _Lanes, _per_k_params, _prepare_batch, lane_step,
                              run_lanes, run_steps)
from ..profiles import st2profile

__all__ = ["sample_batch_adaptive", "decide_batch", "run_slots"]


# ---------------------------------------------------------------------------
# batched choice-distribution decision (device)
# ---------------------------------------------------------------------------

def _pick(curves, margin):
    """Winning k per draw: the smallest k within ``margin`` of that draw's
    maximum (reference ``bild/choicesampler.py:112-151``); ``curves (...,
    S, K)``. `torch.argmax` takes no bool and returns the first maximum."""
    floor = curves.amax(dim=-1, keepdim=True) - margin
    return torch.argmax((curves >= floor).to(torch.uint8), dim=-1)


def _tally(picks, K):
    """Histogram of the winning ks: ``(..., S) -> (..., K)``."""
    return (picks[..., None] == torch.arange(K, device=picks.device)).sum(dim=-2)


def decide_batch(logev, var_logev, n_steps, opened, noise, *,
                 margin, certainty, k_lookahead: int, k_max: int):
    """
    The reference's ``determine_next_step`` and stop rule
    (``bild/core.py:138-192,217-227``) for a batch of trajectories at once.

    ``logev, var_logev, n_steps (B, K)``: per-(trajectory, k) evidence,
    its squared standard error and AMIS step count; unopened lanes, lanes
    with k >= T and exhausted lanes carry ``logev=-inf`` or
    ``n_steps=inf`` (zero expected gain). ``opened (B,)``: samplers opened
    per trajectory. ``noise (samplesize, K)``: the Monte-Carlo draws'
    standard normals, shared across trajectories. ``margin``, ``certainty``:
    dE and certainty_in_k.

    Returns a dict of tensors on ``noise``'s device: ``k_next``,
    ``is_open`` (k_next opens a new sampler), ``keep_going`` (the
    reference's run condition), each ``(B,)``, and ``pk``, ``KLD`` ``(B,
    K)`` and ``I_la`` ``(B,)``. The per-k probes of ``KLD`` run one k at a
    time, which bounds the ``(B, S, K)`` temporaries.
    """
    B, K = logev.shape
    dtype = noise.dtype
    neg_inf = -math.inf

    # center per trajectory: the margin rule is shift-invariant, and in
    # float32 a |logE| ~ 3000 would quantize the rms-step shifts away
    finite = torch.isfinite(logev)
    center = torch.where(finite, logev, neg_inf).amax(dim=1, keepdim=True)
    logev_c = torch.where(finite, logev - center, neg_inf).to(dtype)
    sd = torch.sqrt(var_logev).to(dtype)
    step_rms = torch.sqrt(var_logev / (n_steps + 1.0)).to(dtype)  # inf -> 0

    curves = logev_c[:, None, :] + sd[:, None, :] * noise[None]     # (B,S,K)
    counts0 = _tally(_pick(curves, margin), K).to(dtype)            # (B,K)
    samplesize = noise.shape[0]
    pk = counts0 / samplesize

    # KLD_moreSamples: the central-difference histogram swing per probed k
    # (reference choicesampler.py:153-178)
    ks = torch.arange(K, device=noise.device)
    KLD = torch.empty((B, K), dtype=dtype, device=noise.device)
    for k in range(K):
        shift = 0.5 * step_rms[:, k, None, None] * (ks == k)
        up = _tally(_pick(curves + shift, margin), K).to(dtype)
        down = _tally(_pick(curves - shift, margin), K).to(dtype)
        KLD[:, k] = ((up - down) ** 2 / (counts0 + 1.0)).sum(dim=-1) / (2.0 * samplesize)

    # KLD_omitK over the lookahead region [opened - k_lookahead, opened)
    # (reference choicesampler.py:180-210, core.py:180)
    omit = ((ks[None, :] >= (opened - k_lookahead)[:, None])
            & (ks[None, :] < opened[:, None]))                      # (B,K)
    omit_curves = torch.where(omit[:, None, :], neg_inf, curves)
    reduced = _tally(_pick(omit_curves, margin), K).to(dtype)
    reduced = reduced * (samplesize / reduced.sum(dim=-1, keepdim=True))
    gap = torch.where(omit, 0.0, counts0 - reduced)
    I_la = (gap ** 2 / (reduced + 1.0)).sum(dim=-1) / (2.0 * samplesize)

    # decision (reference bild/core.py:153-186)
    k_new = opened
    bootstrap = (k_new < k_lookahead + 1) & (k_new <= k_max)
    k_KLD = torch.argmax(KLD, dim=1)
    kld_at_best = KLD.gather(1, k_KLD[:, None])[:, 0]
    I_la = torch.where(k_new >= k_lookahead + 1, I_la, math.inf)
    want_open = (I_la > kld_at_best) & (k_new <= k_max)
    k_next = torch.where(bootstrap | want_open, k_new, k_KLD)
    is_open = k_next == k_new

    # stop rule (reference bild/core.py:217-227): continue while a new k is
    # demanded, or certainty is not reached and the chosen k still informs
    pk_max = pk.amax(dim=1)
    kld_next = KLD.gather(1, k_next.clamp(max=K - 1)[:, None])[:, 0]
    keep_going = is_open | ((pk_max < certainty) & (kld_next > 0))
    return {"k_next": k_next, "is_open": is_open, "keep_going": keep_going,
            "pk": pk, "KLD": KLD, "I_la": I_la}


def _decide_packed(logev, var_logev, n_steps, opened, noise, **kw):
    """`decide_batch` with what the host loop reads packed into one
    ``(B, K+3)`` tensor (k_next, is_open, keep_going, KLD): one fetch per
    decision."""
    out = decide_batch(logev, var_logev, n_steps, opened, noise, **kw)
    f = out["KLD"].dtype
    return torch.cat([out["k_next"][:, None].to(f), out["is_open"][:, None].to(f),
                      out["keep_going"][:, None].to(f), out["KLD"]], dim=1)


# ---------------------------------------------------------------------------
# slots at their own step counts (device)
# ---------------------------------------------------------------------------

def _keep(ok, new: AmisState, old: AmisState) -> AmisState:
    """Per lane: ``new`` where ``ok``, else ``old``."""
    def pick(a, b):
        return torch.where(ok.view((-1,) + (1,) * (a.dim() - 1)), a, b)

    return AmisState(**{f: pick(getattr(new, f), getattr(old, f))
                        for f in ("ss", "thetas", "logLs", "logdeltas",
                                  "a_params", "logps", "evidences")},
                     n_steps=pick(new.n_steps, old.n_steps),
                     mom_ok=pick(new.mom_ok, old.mom_ok))


def slot_step(mutable, scratch, logL_fn, lane_data, keys, transitions,
              active, logprior, cb, pb, N, T, mom_maxiter, informed, live):
    """
    One step of slots at their own step counts, in place on ``mutable``
    (`AmisState.tensors`, then the gamma sampler's exhaustion flag): the
    state is copied into the second buffer ``scratch`` (the same tensors of
    another state), `parallel.batch.lane_step` advances that copy, and a
    slot in ``live`` with room left takes it (`_keep`); every other slot
    keeps its state bit for bit. No host read: the step `run_slots` runs
    eagerly and replays as a CUDA graph.
    """
    state = AmisState(*mutable[:-1])
    work = AmisState(*scratch)
    ok = live & (state.n_steps < state.logLs.shape[1])
    work.assign(state)
    lane_step(work.tensors() + [mutable[-1]], (), logL_fn, lane_data, keys,
              transitions, active, logprior, cb, pb, N, T, mom_maxiter,
              informed)
    state.assign(_keep(ok, work, state))


def run_slots(logL_fn, lane_data, state: AmisState, rng: LaneRNG,
              transitions, active, logprior, cb, pb, *, N, T, steps, live,
              informed=None, mom_maxiter=1000) -> AmisState:
    """
    `parallel.batch.run_lanes` for lanes at their own step counts
    (``state.n_steps`` an ``(L,)`` tensor): ``steps`` AMIS steps
    (`slot_step`) for every lane in ``live`` (bool ``(L,)``) that has room
    left; the other lanes come back unchanged. Per step one proposal draw
    (each lane's stream folded by its own step index), one call
    ``logL_fn(profiles (L, N, T), lane_data)`` for all lanes and one
    ensemble update. ``informed = (a, logp, use)`` becomes the second
    mixture component of a lane in ``use`` after its first step.
    Reductions are lane-exact. Updates ``state`` in place and returns it;
    on CUDA the steps replay one CUDA graph of the step
    (`parallel.batch.run_steps`). The gamma sampler's exhaustion flag
    (``rng.exhausted``, made here if ``rng`` has none) is read once, after
    the steps.
    """
    flag = rng.exhausted
    if flag is None:
        flag = torch.zeros((), dtype=torch.bool, device=state.ss.device)
    mutable = state.tensors() + [flag]
    run_steps("slots", slot_step, mutable,
              (logL_fn, tuple(lane_data), rng.keys, transitions, active,
               logprior, cb, pb, N, T, mom_maxiter, informed, live),
              steps, scratch=[torch.empty_like(t) for t in mutable[:-1]])
    if rng.exhausted is None:
        check_exhausted(flag)
    return state


def _final_summaries(grid: AmisState, active, T, n, marginals):
    """Per-lane MAP profiles ``(L, T)`` and marginals ``(L, n, T)`` (or
    None) over each lane's filled ensemble rows: the lanes' step counts
    differ, so the rows are masked by each lane's own ``n_steps``."""
    L, S, _, K1 = grid.ss.shape
    nd = grid.n_steps
    row_ok = (torch.arange(S, device=nd.device)[None, :, None]
              < nd[:, None, None])                                  # (L,S,1)
    flat_ss = grid.ss.reshape(L, -1, K1)
    flat_th = grid.thetas.reshape(L, -1, K1)
    idx = torch.where(row_ok, grid.logLs, -math.inf).reshape(L, -1).argmax(dim=1)
    rows = torch.arange(L, device=nd.device)
    map_prof = st2profile(flat_ss[rows, idx], flat_th[rows, idx], T,
                          active=active, exact=True)
    logpost = None
    if marginals:
        log_w = torch.where(
            row_ok, grid.logLs - grid.logdeltas
            + torch.log(nd.clamp(min=1).to(grid.logLs.dtype))[:, None, None],
            -math.inf).reshape(L, -1)
        logpost = _marginal_posterior(flat_ss, flat_th, log_w, T=T,
                                      nStates=n, active=active,
                                      exact=True).cpu().numpy()
    return map_prof.cpu().numpy(), logpost


def _cat(a: AmisState, b: AmisState) -> AmisState:
    return AmisState(**{f: torch.cat([getattr(a, f), getattr(b, f)])
                        for f in ("ss", "thetas", "logLs", "logdeltas",
                                  "a_params", "logps", "evidences",
                                  "n_steps", "mom_ok")})


# ---------------------------------------------------------------------------
# host loop
# ---------------------------------------------------------------------------

def sample_batch_adaptive(model, batch: TrajectoryBatch,
                          k_max=10,
                          N=128,
                          max_steps_per_k=24,
                          init_steps=4,
                          steps_per_round=2,
                          dE=0.0,
                          certainty_in_k=0.99,
                          k_lookahead=2,
                          samplesize=4096,
                          max_rounds=None,
                          concentration_brake=1e-2,
                          polarization_brake=1e-3,
                          informed_init=True,
                          marginals=False,
                          reallocate=True,
                          mom_maxiter=1000,
                          generator: Optional[torch.Generator] = None
                          ) -> BatchResults:
    """
    Adaptive (per-trajectory active-learning) inference over a batch.

    Parameters as `bild_tpu.infer.sample_batch_adaptive`, with
    ``generator`` (a `torch.Generator`, seeded from numpy's global RNG if
    omitted) in place of the JAX key. The batch is moved to the model's
    device and dtype first.

    max_steps_per_k : AMIS-step capacity per (trajectory, k) lane; a full
        lane is exhausted (the reference's ``max_fev``).
    init_steps : steps a newly opened k runs before it enters decisions
        (the reference's ``init_runs``).
    steps_per_round : AMIS steps per chosen slot per round; decisions
        happen between rounds.
    certainty_in_k, k_lookahead, samplesize : the reference's stopping
        certainty, lookahead width and choice Monte-Carlo size.
    max_rounds : optional cap on the rounds; unconverged trajectories keep
        their current estimates.
    reallocate : give the slots of converged trajectories to other live
        trajectories' next-best-KLD lanes; off: one lane per live
        trajectory per round (the reference's semantics).

    Returns `BatchResults` with ``evals`` (likelihood evaluations per
    trajectory, ``N`` times its lanes' steps), ``steps`` (AMIS steps per
    (trajectory, k)) and ``rounds``.
    """
    if not 1 <= init_steps <= max_steps_per_k:
        raise ValueError(f"init_steps must be in [1, max_steps_per_k="
                         f"{max_steps_per_k}], got {init_steps}")
    if steps_per_round < 1:
        raise ValueError(f"steps_per_round must be >= 1, got {steps_per_round}")
    device = getattr(model, "device", batch.data.device)
    dtype = getattr(model, "dtype", batch.data.dtype)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(int(np.random.randint(2**31)))

    B_real, T_in = batch.B, batch.T
    batch, T_eff = _prepare_batch(model, batch, device, dtype)
    B, T = batch.B, batch.T
    S, m = max_steps_per_k, steps_per_round
    L = min(k_max, max(T - 1, 0)) + 1          # device lanes (k < T)
    K1 = L                                     # padded parameter slots
    per_traj, logL_fn = model.lockstep_fns(batch, max_intervals=K1)
    cfc = CFC(model.transitions)
    transitions = torch.as_tensor(model.transitions, device=device)
    n = cfc.n
    cb = N * concentration_brake
    pb = N * polarization_brake

    K_host = k_max + 2                         # host arrays incl. virtual opens
    lengths = (np.asarray(batch.lengths) if batch.lengths is not None
               else np.full(B, T))

    informed = (_informed_proposals_all_k(model, batch, K1, n, T,
                                          (batch.data, T_eff, B))
                if informed_init else None)
    # one key per (k, trajectory) lane, drawn k-major (as sample_batch)
    lane_keys = torch.randint(0, 2**62, (k_max + 1, B), generator=generator,
                              device=generator.device).cpu().numpy()
    noise_rng = LaneRNG.from_seeds([draw_seed(generator)], device)
    params = {k: _per_k_params(cfc, k, K1, B, n, informed) for k in range(L)}
    # the grid: lane = k * B + trajectory row
    lanes = _Lanes(np.repeat(np.arange(L), B), np.tile(np.arange(B), L),
                   params, lane_keys, device, dtype)
    # the gamma sampler's exhaustion flag of every step: read once, at the end
    lanes.rng.exhausted = torch.zeros((), dtype=torch.bool, device=device)
    lane_data = tuple(x[lanes.row_index] for x in per_traj)

    # ---- host bookkeeping ------------------------------------------------
    logE = np.full((B, K_host), -np.inf)
    varE = np.full((B, K_host), 1e-20)
    nst = np.full((B, K_host), np.inf)         # inf = unopened/exhausted/k>=T
    nst_true = np.zeros((B, K_host))           # actual step counts
    momok_h = np.ones((B, k_max + 1), dtype=bool)
    opened = np.zeros(B, dtype=int)
    init_pending = np.zeros(B, dtype=int)
    done = np.zeros(B, dtype=bool)
    evals = np.zeros(B, dtype=np.int64)

    def record(ev_rows, ns_rows, mok_rows, kb, bidx):
        """Ingest fetched per-slot results into the host arrays. A
        trajectory can hold several slots of one round: its evaluations
        accumulate with `np.add.at`."""
        ran = ns_rows - nst_true[bidx, kb]
        np.add.at(evals, bidx, (ran * N).astype(np.int64))
        nst_true[bidx, kb] = ns_rows
        logE[bidx, kb] = ev_rows[:, 0]
        varE[bidx, kb] = ev_rows[:, 1] ** 2
        nst[bidx, kb] = np.where(ns_rows >= S, np.inf, ns_rows)
        momok_h[bidx, kb] &= mok_rows

    def host_open(rows, ks):
        """Open an unidentifiable k (k >= length or beyond the device lanes)
        as the reference does (``bild/amis.py:641-648``): evidence -inf,
        exhausted, no likelihood work."""
        logE[rows, ks] = -np.inf
        varE[rows, ks] = 1e-20
        nst[rows, ks] = np.inf
        opened[rows] += 1

    # ---- bootstrap: lanes 0..k_lookahead through the lockstep runner -----
    n_boot = min(k_lookahead + 1, k_max + 1, L)
    nb = n_boot * B
    boot = run_lanes(
        logL_fn, tuple(x[:nb] for x in lane_data),
        AmisState.create(S, N, K1 - 1, n, lanes.a0[:nb], lanes.logp0[:nb],
                         device=device, dtype=dtype, lanes=nb),
        lanes.rng[:nb], transitions, lanes.active[:nb], lanes.logprior[:nb],
        cb, pb, N=N, T=T, start=0, stop=init_steps,
        informed=(None if lanes.informed is None
                  else tuple(x[:nb] for x in lanes.informed)),
        mom_maxiter=mom_maxiter)
    ev_b = boot.evidences[:, init_steps - 1].cpu().numpy()
    mok_b = boot.mom_ok.cpu().numpy()
    for kk in range(n_boot):
        sl = slice(kk * B, (kk + 1) * B)
        record(ev_b[sl], np.full(B, float(init_steps)), mok_b[sl],
               np.full(B, kk), np.arange(B))
    opened[:] = n_boot
    # lanes at or after a trajectory's own length are unidentifiable
    for kk in range(n_boot):
        bad = kk >= lengths
        logE[bad, kk] = -np.inf
        varE[bad, kk] = 1e-20
        nst[bad, kk] = np.inf

    # the full grid: the bootstrapped lanes, then fresh ones
    boot.n_steps = torch.full((nb,), init_steps, dtype=torch.long, device=device)
    grid = boot
    if L > n_boot:
        fresh = AmisState.create(S, N, K1 - 1, n, lanes.a0[nb:],
                                 lanes.logp0[nb:], device=device, dtype=dtype,
                                 lanes=L * B - nb)
        fresh.n_steps = torch.zeros(L * B - nb, dtype=torch.long, device=device)
        grid = _cat(boot, fresh)

    decisions = [0]

    def decide_all():
        noise = normal(noise_rng.fold(decisions[0]), (1, samplesize, K_host),
                       0, dtype, device)[0]
        decisions[0] += 1

        def t(x, dt=dtype):
            return torch.as_tensor(x, dtype=dt, device=device)

        packed = _decide_packed(
            t(logE), t(varE), t(nst), t(opened, torch.long), noise,
            margin=float(dE), certainty=float(certainty_in_k),
            k_lookahead=k_lookahead, k_max=k_max).cpu().numpy()
        return {"k_next": packed[:, 0].astype(int),
                "is_open": packed[:, 1] != 0,
                "keep_going": packed[:, 2] != 0,
                "KLD": packed[:, 3:]}

    rounds = 0
    while not done.all() and (max_rounds is None or rounds < max_rounds):
        with span("adaptive.round"):
            with span("adaptive.decide"):
                # decide; re-run after virtual opens: an unidentifiable k opens
                # with no device work, like the reference's -inf sampler
                for _ in range(K_host):
                    dec = decide_all()
                    live = ~done & (init_pending == 0)
                    virt = live & dec["is_open"] & (
                        (dec["k_next"] >= lengths) | (dec["k_next"] >= L))
                    if not virt.any():
                        break
                    host_open(np.where(virt)[0], dec["k_next"][virt])

                live = ~done & (init_pending == 0)
                done |= live & ~dec["keep_going"]
                live = ~done & (init_pending == 0)

                # device opens: start init on the new lane
                opening = live & dec["is_open"]
                init_pending[opening] = init_steps
                opened[opening] += 1

                # primary slot per live trajectory
                kb_pri = np.where(init_pending > 0, opened - 1, dec["k_next"])
                rows = np.where(~done)[0]
                if rows.size == 0:
                    break
                kb_list = list(kb_pri[rows])
                bidx_list = list(rows)
                used = set(zip(kb_list, bidx_list))

                # budget reallocation: spare slots -> the highest-KLD remaining
                # (lane, trajectory) candidates of live, non-initializing rows
                spare = B - len(rows)
                if spare > 0 and reallocate:
                    cand_ok = np.zeros((B, K_host), dtype=bool)
                    cand_ok[~done & (init_pending == 0)] = True
                    cand_ok &= np.isfinite(nst) & (nst > 0)      # opened, not exhausted
                    cand_ok[:, L:] = False
                    cand_ok &= dec["KLD"] > 0
                    for kk, bb in used:
                        if kk < K_host:
                            cand_ok[bb, kk] = False
                    flat = np.argsort(-np.where(cand_ok, dec["KLD"], -np.inf),
                                      axis=None)[:spare]
                    for f in flat:
                        bb, kk = divmod(int(f), K_host)
                        if not cand_ok[bb, kk]:
                            break
                        kb_list.append(kk)
                        bidx_list.append(bb)
                        used.add((kk, bb))

                # dead filler slots (left unchanged) on distinct unused pairs
                n_live_slots = len(kb_list)
                need = B - n_live_slots
                for kk in range(L):
                    for bb in range(B):
                        if need == 0:
                            break
                        if (kk, bb) not in used:
                            kb_list.append(kk)
                            bidx_list.append(bb)
                            used.add((kk, bb))
                            need -= 1

                kb = np.asarray(kb_list, dtype=np.int64)
                bidx = np.asarray(bidx_list, dtype=np.int64)
                idx = torch.as_tensor(kb * B + bidx, device=device)
                live_mask = torch.arange(B, device=device) < n_live_slots
            sel = run_slots(
                logL_fn, tuple(x[idx] for x in lane_data), grid.select(idx),
                lanes.rng[idx], transitions, lanes.active[idx],
                lanes.logprior[idx], cb, pb, N=N, T=T, steps=m, live=live_mask,
                informed=(None if lanes.informed is None
                          else tuple(x[idx] for x in lanes.informed)),
                mom_maxiter=mom_maxiter)
            grid.put(idx, sel)

            i_last = (sel.n_steps - 1).clamp(min=0)
            with span("adaptive.fetch"):
                packed = torch.cat([
                    sel.evidences[torch.arange(B, device=device), i_last],
                    sel.n_steps[:, None].to(dtype), sel.mom_ok[:, None].to(dtype)],
                    dim=1).cpu().numpy()           # ONE fetch per round
            sl = slice(0, n_live_slots)
            record(packed[sl, :3], packed[sl, 3], packed[sl, 4] != 0,
                   kb[sl], bidx[sl])
            init_pending = np.maximum(init_pending - m, 0)
            rounds += 1
            sample_batch_adaptive.slot_steps += B * m
            sample_batch_adaptive.filler_slot_steps += (B - n_live_slots) * m

    # ---- final summaries -------------------------------------------------
    check_exhausted(lanes.rng.exhausted)
    maps_d, margs_d = _final_summaries(grid, lanes.active, T, n, marginals)
    K_out = k_max + 1
    map_profiles = np.zeros((K_out, B, T), dtype=int)
    map_profiles[:L] = maps_d.reshape(L, B, T)
    margs_out = None
    if marginals:
        margs_out = np.full((K_out, B, n, T), -np.inf)
        margs_out[:L] = margs_d.reshape(L, B, n, T)

    evidence = logE[:, :K_out].copy()
    evidence_se = np.sqrt(varE[:, :K_out])
    # unidentifiability guard at true lengths (as sample_batch)
    over = np.arange(K_out)[None, :] >= lengths[:, None]
    evidence[over] = -np.inf
    evidence_se[over] = 1e-10

    if T < T_in:
        pad = T_in - T
        map_profiles = np.pad(map_profiles, [(0, 0), (0, 0), (0, pad)],
                              mode="edge")
        if margs_out is not None:
            margs_out = np.concatenate(
                [margs_out, np.full(margs_out.shape[:3] + (pad,),
                                    -math.log(n))], axis=-1)

    return BatchResults(
        k=np.arange(K_out),
        evidence=evidence[:B_real],
        evidence_se=evidence_se[:B_real],
        map_profiles=map_profiles[:, :B_real],
        dE=dE,
        marginals=margs_out[:, :B_real] if margs_out is not None else None,
        mom_ok=momok_h[:B_real],
        evals=evals[:B_real],
        steps=nst_true[:B_real, :K_out].astype(np.int64),
        rounds=rounds,
    )


counters.register("adaptive.slot_steps", sample_batch_adaptive, "slot_steps")
counters.register("adaptive.filler_slot_steps", sample_batch_adaptive, "filler_slot_steps")

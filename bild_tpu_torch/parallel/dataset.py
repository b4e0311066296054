"""
Dataset-scale inference (counterpart of `bild_tpu.parallel.dataset`):

    ragged trajectories -> length buckets -> fixed-size chunks
      -> lockstep `sample_batch` (or adaptive `sample_batch_adaptive`)
         per chunk
      -> per-chunk checkpoint files -> original-order DatasetResults

Chunking bounds device memory (a chunk of B trajectories runs ``(k_max+1)
B`` lanes per AMIS step); the per-chunk checkpoint makes long runs
resumable at chunk granularity: rerun the same call and completed chunks
load from disk.

Under a ``mesh`` every rank holds the whole dataset and makes the same
call; each chunk's rows are split over the ranks (`sample_batch(mesh=)`),
every rank returns the same full results, and the mesh's first rank alone
writes the chunk files.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from .._spans import span, spanned
from ..amis.sampler import draw_seed
from ..infer.adaptive import sample_batch_adaptive
from ..lanes import mix_int
from .batch import (TrajectoryBatch, _prepare_batch, bucket_trajectories,
                    sample_batch)
from .mesh import (broadcast_from_process0, checkpoint_hit, fetch_to_host,
                   is_multiprocess, require_data_axis)

__all__ = ["DatasetResults", "sample_dataset"]


@dataclasses.dataclass
class DatasetResults:
    """Per-trajectory results in the ORIGINAL dataset order; trajectories
    keep their true lengths (profiles/marginals are trimmed from bucket
    padding)."""

    k: np.ndarray                       # (K+1,)
    evidence: np.ndarray                # (B, K+1)
    evidence_se: np.ndarray             # (B, K+1)
    profiles_by_k: List[np.ndarray]     # B entries, each (K+1, T_i)
    dE: float = 0.0
    marginals: Optional[List[np.ndarray]] = None  # B entries, (K+1, n, T_i)
    optimized: Optional[List[np.ndarray]] = None  # B entries, (T_i,)
    eliminated: Optional[np.ndarray] = None       # (B,) postproc flags
    # (B, K+1): CFC method-of-marginals converged for that (trajectory, k)
    # lockstep run (see BatchResults.mom_ok); True for skipped k
    mom_ok: Optional[np.ndarray] = None
    # (B,): likelihood evaluations spent per trajectory (schedule="adaptive")
    evals: Optional[np.ndarray] = None
    # (B,): each row's global trajectory id (`sample_dataset_sharded`)
    ids: Optional[np.ndarray] = None

    def best_k(self, dE=None) -> np.ndarray:
        dE = self.dE if dE is None else dE
        plausible = self.evidence >= (
            np.max(self.evidence, axis=1, keepdims=True) - dE)
        return np.argmax(plausible, axis=1)

    def best_profile(self, dE=None) -> List[np.ndarray]:
        bk = self.best_k(dE)
        return [p[k] for p, k in zip(self.profiles_by_k, bk)]

    def log_marginal_posterior(self, dE=None) -> List[np.ndarray]:
        if self.marginals is None:
            raise ValueError("run sample_dataset(..., marginals=True) first")
        from scipy.special import logsumexp
        if isinstance(dE, str) and dE == "average":
            out = []
            for ev, m in zip(self.evidence, self.marginals):
                finite = np.isfinite(ev)
                w = np.where(finite[:, None, None], m + ev[:, None, None],
                             -np.inf)
                with np.errstate(under="ignore"):
                    logpost = logsumexp(w, axis=0)
                    out.append(logpost - logsumexp(logpost, axis=0,
                                                   keepdims=True))
            return out
        bk = self.best_k(dE)
        return [m[k] for m, k in zip(self.marginals, bk)]


def _chunk_tag(indices, batch, config_str):
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(indices).tobytes())
    h.update(np.ascontiguousarray(batch.data.cpu().numpy()).tobytes())
    h.update(config_str.encode())
    return h.hexdigest()[:16]


@spanned("sample_dataset")
def sample_dataset(model, trajs: Sequence,
                   k_max=10,
                   steps_per_k=20,
                   N=128,
                   dE=0.0,
                   scout_steps=None,
                   refine_top=3,
                   informed_init=True,
                   marginals=False,
                   chunk_size=1024,
                   bucket_edges=(64, 128, 256, 512, 1024),
                   mesh=None,
                   generator: Optional[torch.Generator] = None,
                   checkpoint_dir=None,
                   show_progress=False,
                   optimize_boundaries=False,
                   schedule="lockstep",
                   **sample_kw) -> DatasetResults:
    """
    Full-dataset inference over ragged trajectories (a sequence of
    `Trajectory`; each chunk is stacked on the model's device, in its
    dtype, wherever the trajectories lie).

    Parameters mirror `sample_batch` plus:

    chunk_size : max trajectories per `sample_batch` call (bounds memory).
    bucket_edges : pad-to lengths for ragged trajectories.
    generator : a `torch.Generator`; one seed drawn from it keys the whole
        run, and chunk ``c`` runs on a generator seeded from (that seed,
        c), so a chunk's results do not depend on which chunks ran before.
    checkpoint_dir : optional directory for per-chunk result files, keyed
        by a content hash of (chunk data, configuration, seed, model
        fingerprint): a rerun loads completed chunks instead of
        recomputing; another configuration or model recomputes.
    show_progress : tqdm over chunks, if tqdm is installed.
    optimize_boundaries : run `postproc.optimize_boundary_batch` on each
        chunk's best profiles at ``dE``; results land in
        ``DatasetResults.optimized`` with per-trajectory ``eliminated``.
    schedule : "lockstep" (default) runs the fixed ``steps_per_k``
        schedule through `sample_batch`; "adaptive" runs
        `infer.adaptive.sample_batch_adaptive` per chunk (evidence-driven
        budget allocation and certainty-based stopping). Its knobs
        (``init_steps``, ``steps_per_round``, ``max_steps_per_k``,
        ``certainty_in_k``, ...) pass through ``**sample_kw``;
        ``steps_per_k``, ``scout_steps`` and ``refine_top`` are ignored
        under it. ``DatasetResults.evals`` then holds each trajectory's
        likelihood evaluations.
    mesh : optional `parallel.mesh.Mesh` spanning several ranks: every
        rank makes this same call with the same dataset, configuration and
        generator (``None`` is made safe by broadcasting rank 0's seed);
        each chunk's rows are split over the ranks and every rank returns
        the same full results. Inputs that differ between ranks raise on
        every rank. The mesh's first rank alone writes the chunk files;
        resuming needs ``checkpoint_dir`` on a filesystem every rank
        reads. Not with ``schedule='adaptive'``.

    Returns `DatasetResults` in the original trajectory order.
    """
    if "ensemble" in sample_kw:
        raise ValueError(
            "ensemble= is not carried through DatasetResults: run "
            "parallel.sample_batch(..., ensemble=M) directly")
    if schedule not in ("lockstep", "adaptive"):
        raise ValueError(f"schedule must be 'lockstep' or 'adaptive', "
                         f"got {schedule!r}")
    require_data_axis(mesh)
    if schedule == "adaptive" and mesh is not None:
        raise ValueError("schedule='adaptive' does not support a mesh yet "
                         "(per-trajectory decisions are single-process)")
    multiproc = mesh is not None and is_multiprocess(mesh)
    if generator is None:
        # the default seed must be the same on every rank
        seed0 = np.int64(np.random.randint(2**31))
        if multiproc:
            seed0 = broadcast_from_process0(seed0, mesh)
        generator = torch.Generator()
        generator.manual_seed(int(seed0))
    seed = draw_seed(generator)
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)

    # everything that changes results keys the chunk checkpoints; extra
    # sample_batch kwargs only when present
    config = ("v1", k_max, steps_per_k, N, scout_steps, refine_top,
              informed_init, marginals, chunk_size,
              bool(optimize_boundaries), float(dE), seed)
    if schedule != "lockstep":
        config += (schedule,)
    if sample_kw:
        config += (sorted(sample_kw.items()),)
    fingerprint = getattr(model, "likelihood_fingerprint", lambda: None)()
    if fingerprint is not None:
        config += (fingerprint,)
    config_str = repr(config)

    if multiproc:
        # every rank must walk the same dataset and configuration, or the
        # chunks' collectives would pair different work; every rank sees
        # every digest, so all raise together
        h = hashlib.sha256(config_str.encode())
        for t in trajs:
            h.update(np.ascontiguousarray(t.data.cpu().numpy()).tobytes())
            h.update(np.ascontiguousarray(t.valid.cpu().numpy()).tobytes())
        digests = fetch_to_host(np.frombuffer(h.digest()[:8], np.int64), mesh)
        if np.any(digests != digests[0]):
            raise ValueError(
                "sample_dataset multi-process launch diverged: ranks "
                f"{[r for r, x in zip(mesh.ranks, digests) if x != digests[0]]}"
                f" passed a (dataset, configuration, seed) that differs from "
                f"rank {mesh.ranks[0]}'s; every rank must pass identical inputs")

    B_total = len(trajs)
    K1 = k_max + 1
    evidence = np.full((B_total, K1), np.nan)
    evidence_se = np.full((B_total, K1), np.nan)
    profiles_by_k: List[Optional[np.ndarray]] = [None] * B_total
    margs_by_traj: List[Optional[np.ndarray]] = [None] * B_total
    opt_by_traj: List[Optional[np.ndarray]] = [None] * B_total
    elim_all = np.zeros(B_total, dtype=bool)
    mom_all = np.ones((B_total, K1), dtype=bool)
    evals_all = np.zeros(B_total, dtype=np.int64)

    # stable chunk schedule: bucket, then split each bucket, stacked on the
    # model's device and in its dtype (the chunk tags hash those bytes)
    work = []
    for idx, batch in bucket_trajectories(
            trajs, bucket_edges=bucket_edges,
            device=getattr(model, "device", None),
            dtype=getattr(model, "dtype", None)):
        for lo in range(0, len(idx), chunk_size):
            sl = slice(lo, lo + chunk_size)
            sub = TrajectoryBatch(
                data=batch.data[sl], valid=batch.valid[sl],
                lengths=None if batch.lengths is None else batch.lengths[sl])
            work.append((idx[sl], sub))

    iterator = work
    if show_progress:
        try:
            from tqdm.auto import tqdm
            iterator = tqdm(work, desc="chunks")
        except ImportError:
            pass

    for c, (indices, sub) in enumerate(iterator):
        with span("dataset.chunk"):
            ck_path = None
            loaded = None
            if checkpoint_dir is not None:
                ck_path = os.path.join(checkpoint_dir,
                                       f"chunk_{_chunk_tag(indices, sub, config_str)}.npz")
                if checkpoint_hit(ck_path, mesh):
                    loaded = np.load(ck_path)

            if loaded is not None:
                ev, se = loaded["evidence"], loaded["evidence_se"]
                maps = loaded["map_profiles"]
                marg = loaded["marginals"] if marginals else None
                opt = loaded["optimized"] if optimize_boundaries else None
                elim = loaded["eliminated"] if optimize_boundaries else None
                mom = loaded["mom_ok"]
                evl = loaded["evals"] if loaded["evals"].size else None
            else:
                chunk_gen = torch.Generator(device=sub.data.device)
                chunk_gen.manual_seed(mix_int(seed + c) & (2**63 - 1))
                with span("dataset.sample"):
                    if schedule == "adaptive":
                        res = sample_batch_adaptive(
                            model, sub, k_max=k_max, N=N, dE=dE,
                            informed_init=informed_init, marginals=marginals,
                            generator=chunk_gen, **sample_kw)
                    else:
                        res = sample_batch(
                            model, sub, k_max=k_max, steps_per_k=steps_per_k, N=N,
                            dE=dE, scout_steps=scout_steps, refine_top=refine_top,
                            informed_init=informed_init, marginals=marginals,
                            generator=chunk_gen, mesh=mesh, **sample_kw)
                ev, se, maps = res.evidence, res.evidence_se, res.map_profiles
                marg = res.marginals
                mom = res.mom_ok
                evl = res.evals
                opt = elim = None
                if optimize_boundaries:
                    # every rank climbs all rows from the gathered profiles, on
                    # the batch sample_batch ran (its padding trimmed: banded
                    # GGM tables refuse it as missing frames), padded back
                    from ..postproc import optimize_boundary_batch
                    with span("dataset.climb"):
                        ran, T_eff = _prepare_batch(
                            model, sub, getattr(model, "device", sub.data.device),
                            getattr(model, "dtype", sub.data.dtype))
                        opt, elim = optimize_boundary_batch(
                            res.best_profile(dE)[:, :T_eff], ran, model)
                    opt = np.pad(opt, [(0, 0), (0, sub.T - T_eff)], mode="edge")
                if ck_path is not None and (mesh is None or mesh.index == 0):
                    tmp = ck_path + ".tmp.npz"
                    np.savez(tmp, evidence=ev, evidence_se=se,
                             map_profiles=maps,
                             marginals=(marg if marginals else np.zeros(0)),
                             optimized=(opt if opt is not None else np.zeros(0)),
                             eliminated=(elim if elim is not None
                                         else np.zeros(0)),
                             mom_ok=mom,
                             evals=(evl if evl is not None else np.zeros(0)))
                    os.replace(tmp, ck_path)

            lengths = (np.asarray(sub.lengths) if sub.lengths is not None
                       else np.full(len(indices), sub.T))
            for row, i in enumerate(np.asarray(indices)):
                evidence[i] = ev[row]
                evidence_se[i] = se[row]
                mom_all[i] = mom[row]
                if evl is not None:
                    evals_all[i] = evl[row]
                Ti = int(lengths[row])
                profiles_by_k[i] = np.asarray(maps[:, row, :Ti], dtype=int)
                if marginals:
                    margs_by_traj[i] = marg[:, row, :, :Ti]
                if optimize_boundaries:
                    opt_by_traj[i] = np.asarray(opt[row, :Ti], dtype=int)
                    elim_all[i] = bool(elim[row])

    return DatasetResults(
        k=np.arange(K1),
        evidence=evidence,
        evidence_se=evidence_se,
        profiles_by_k=profiles_by_k,
        dE=dE,
        marginals=margs_by_traj if marginals else None,
        optimized=opt_by_traj if optimize_boundaries else None,
        eliminated=elim_all if optimize_boundaries else None,
        mom_ok=mom_all,
        evals=evals_all if schedule == "adaptive" else None,
    )

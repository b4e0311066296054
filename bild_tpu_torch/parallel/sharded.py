"""
Process-local (sharded) dataset inference (counterpart of
`bild_tpu.parallel.sharded`).

`sample_dataset` under a mesh has every rank hold the whole dataset.
`sample_dataset_sharded` is for datasets too large for that:

- each rank loads only its shard of trajectories (e.g. its own CSV file,
  `io.load_trajectories_csv(..., return_ids=True)`);
- ranks agree on the schedule (length buckets, chunk composition, random
  streams) from an all-gathered table of global ids and frame counts, 16
  bytes per trajectory, never from the data;
- chunks are composed so that each rank's block of a chunk's rows holds
  trajectories it owns, padded with filler rows; each rank stacks its own
  rows, builds their likelihood inputs and informed init, and runs their
  lanes (`sample_batch(lockstep=, informed_arrays=, mesh=)`);
- each trajectory's random streams are keyed by its global id
  (`sample_batch(row_keys=)`), not its position, so results do not depend
  on the rank count or the chunk composition: a run on disjoint shards
  over two ranks equals the one-rank run on all the data bit for bit.

Results are small (evidence curves, profiles) and every rank returns all
of them; the mesh's first rank alone writes the chunk files.
"""
from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..amis.sampler import draw_seed
from ..lanes import LaneRNG
from .batch import (TrajectoryBatch, _informed_proposals_all_k_impl,
                    sample_batch)
from .dataset import DatasetResults
from .mesh import (broadcast_from_process0, checkpoint_hit, feed_process_local,
                   fetch_to_host, is_multiprocess, require_data_axis,
                   world_mesh)

__all__ = ["sample_dataset_sharded"]

_FILLER_ID = np.int64(1) << 31     # filler-row key namespace (ids must be < 2^31)

# what a rank's own shard can get wrong, by code (0: nothing)
_SHARD_FAULTS = {1: "its trajectories and ids differ in number",
                 2: "its global ids are not in [0, 2^31)",
                 3: "it has duplicate ids"}


def _shard_fault(local_trajs, local_ids):
    """``(code, message)`` of the first fault of this rank's shard, or
    ``(0, None)``."""
    if len(local_ids) != len(local_trajs):
        return 1, f"{len(local_trajs)} trajectories vs {len(local_ids)} ids"
    if len(local_ids) and (local_ids.min() < 0
                           or local_ids.max() >= int(_FILLER_ID)):
        return 2, "global ids must be in [0, 2^31)"
    if len(np.unique(local_ids)) != len(local_ids):
        return 3, "duplicate ids in the local shard"
    return 0, None


def _allgather_metadata(local_trajs, local_ids, comm):
    """Every rank's shard faults, (ids, lengths) table, data digest and
    dimension, gathered over ``comm`` (the world's ranks; None: this
    process alone). Returns ``(ids, lengths, owner, digests, dims)`` over
    the global dataset, ``owner`` being each trajectory's rank. A fault of
    any rank's shard raises on every rank."""
    code, message = _shard_fault(local_trajs, local_ids)
    lengths = np.asarray([len(t) for t in local_trajs], dtype=np.int64)
    d = local_trajs[0].d if len(local_trajs) else -1
    head = np.array([[code, len(local_ids), d]], dtype=np.int64)
    heads = head if comm is None else fetch_to_host(head, comm)
    if heads[:, 0].any():
        if code:
            raise ValueError(message)
        bad = {int(r): _SHARD_FAULTS[int(c)]
               for r, c in zip(comm.ranks, heads[:, 0]) if c}
        raise ValueError(f"the shards of other ranks are invalid: {bad}")
    h = hashlib.sha256()
    for t in local_trajs:
        h.update(np.ascontiguousarray(t.data.cpu().numpy()).tobytes())
        h.update(np.ascontiguousarray(t.valid.cpu().numpy()).tobytes())
    digest = np.frombuffer(h.digest(), dtype=np.uint8)
    ranks = [0] if comm is None else list(comm.ranks)
    counts = heads[:, 1]
    table = np.full((1, int(counts.max()), 2), -1, dtype=np.int64)
    table[0, :len(local_ids), 0] = local_ids
    table[0, :len(local_ids), 1] = lengths
    if comm is None:
        tables, digests = table, digest[None]
    else:
        tables, digests = fetch_to_host((table, digest[None]), comm)
    ids = np.concatenate([tables[p, :counts[p], 0] for p in range(len(ranks))])
    lens = np.concatenate([tables[p, :counts[p], 1] for p in range(len(ranks))])
    owner = np.concatenate([np.full(counts[p], r) for p, r in enumerate(ranks)])
    return ids, lens, owner.astype(np.int64), digests, heads[:, 2]


def _schedule(lengths, owner, row_owner, chunk_size, edges):
    """
    The chunks of a run: ``[(T_pad, rows (chunk_size,)), ...]``, ``rows``
    holding global trajectory indices (into ``lengths`` and ``owner``,
    which are in ascending-id order) or -1 for a filler row. Trajectories
    are bucketed by length (``edges``; a longer one gets a bucket of its
    own length), and within a bucket each chunk row ``r`` takes the next
    trajectory of the rank ``row_owner[r]``, so that every rank's rows are
    rows it holds. ``T_pad`` is the bucket's edge, or its longest
    trajectory if shorter. A rank that owns trajectories but no chunk row
    raises (`bild_tpu` runs no chunk for it and leaves its rows NaN).
    """
    row_owner = np.asarray(row_owner)
    ranks = sorted(set(row_owner.tolist()))
    stranded = sorted(set(np.asarray(owner).tolist()) - set(ranks))
    if stranded:
        raise ValueError(
            f"ranks {stranded} own trajectories but no row of a chunk (the "
            f"mesh spans ranks {ranks}): no chunk would run them")
    edges = sorted(edges)
    buckets = {}
    for gi, T in enumerate(lengths):
        pad = next((e for e in edges if T <= e), int(T))
        buckets.setdefault(pad, []).append(gi)
    work = []
    for pad in sorted(buckets):
        gis = buckets[pad]
        T_pad = min(pad, int(max(lengths[gi] for gi in gis)))
        per_rank = {p: [gi for gi in gis if owner[gi] == p] for p in ranks}
        quota = {p: int(np.sum(row_owner == p)) for p in ranks}
        n_chunks = max(-(-len(per_rank[p]) // quota[p]) for p in ranks)
        taken = dict.fromkeys(ranks, 0)
        for _ in range(n_chunks):
            rows = np.full(chunk_size, -1, dtype=np.int64)
            for r in range(chunk_size):
                p = row_owner[r]
                if taken[p] < len(per_rank[p]):
                    rows[r] = per_rank[p][taken[p]]
                    taken[p] += 1
            work.append((T_pad, rows))
    return work


def sample_dataset_sharded(model, local_trajs: Sequence, local_ids,
                           mesh=None,
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
                           generator: Optional[torch.Generator] = None,
                           checkpoint_dir=None,
                           show_progress=False,
                           **sample_kw) -> DatasetResults:
    """
    Full-dataset inference where each rank holds only its shard.

    local_trajs, local_ids : this rank's trajectories and their global
        integer ids (unique across ranks, 0 <= id < 2^31; e.g. the
        ``traj_id`` column of a sharded CSV). Ids set the result order.
    mesh : a `parallel.mesh.Mesh` from ``make_mesh(distributed=True)``;
        every rank of the world calls with its own shard. ``None``: this
        process alone, with all the data (same schedule, no collectives),
        the run that sharded runs equal bit for bit.
    generator : a `torch.Generator`; one seed drawn from it keys every
        trajectory's streams with its id (``None``: rank 0's seed).
    Other parameters as `sample_dataset`; ``chunk_size`` must be divisible
    by the mesh's ``data`` axis.

    Returns `DatasetResults`, the same on every rank, ordered by ascending
    global id (``DatasetResults.ids``). A shard fault of any rank (ids and
    trajectories differing in number, ids out of range or repeated) and a
    rank that owns trajectories but no chunk row raise on every rank.
    Chunk files (``shard_chunk_<hash>.npz``) are keyed by the
    configuration, every rank's data digest and the chunk's rows.
    """
    local_ids = np.asarray(local_ids, dtype=np.int64)
    require_data_axis(mesh)
    multiproc = mesh is not None and is_multiprocess(mesh)
    if mesh is not None:
        D = mesh.shape["data"]
        if chunk_size % D != 0:
            raise ValueError(f"chunk_size={chunk_size} must be divisible by "
                             f"the mesh data axis ({D})")
    if generator is None:
        seed0 = np.int64(np.random.randint(2**31))
        if multiproc:
            seed0 = broadcast_from_process0(seed0, mesh)
        generator = torch.Generator()
        generator.manual_seed(int(seed0))
    seed = draw_seed(generator)
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)

    # ---- metadata agreement over the world (never the data) ---------------
    comm = None if mesh is None else world_mesh(mesh)
    if comm is not None and not is_multiprocess(comm):
        comm = None
    ids_g, len_g, owner_g, digests, dims = _allgather_metadata(
        local_trajs, local_ids, comm)
    if len(np.unique(ids_g)) != len(ids_g):
        raise ValueError("global ids are not disjoint across processes")
    d_dim = int(dims.max())
    if d_dim <= 0:
        raise ValueError("no trajectories on any process")
    if np.any((dims > 0) & (dims != d_dim)):
        raise ValueError(f"inconsistent trajectory dimension across "
                         f"processes: {dims.tolist()}")
    # canonical global order: ascending id (the result order)
    perm = np.argsort(ids_g, kind="stable")
    ids_g, len_g, owner_g = ids_g[perm], len_g[perm], owner_g[perm]

    config = ("sharded-v1", k_max, steps_per_k, N, scout_steps, refine_top,
              informed_init, marginals, chunk_size, float(dE), seed,
              digests.tobytes().hex())
    if sample_kw:
        config += (sorted(sample_kw.items()),)
    fingerprint = getattr(model, "likelihood_fingerprint", lambda: None)()
    if fingerprint is not None:
        config += (fingerprint,)
    config_str = repr(config)

    # ---- schedule: buckets -> ownership-aligned chunks ---------------------
    if mesh is not None:
        row_owner = np.repeat(np.asarray(mesh.ranks), chunk_size // D)
        me = mesh.rank
    else:
        row_owner = np.zeros(chunk_size, dtype=np.int64)
        me = 0
    work = _schedule(len_g, owner_g, row_owner, chunk_size, bucket_edges)
    if mesh is not None:
        mesh.index                    # a rank outside the mesh stops here

    # ---- per-chunk inference ---------------------------------------------
    device = getattr(model, "device", torch.device("cpu"))
    dtype = getattr(model, "dtype", torch.float32)
    n_states = len(model.transitions)
    local_by_id = {int(i): t for i, t in zip(local_ids, local_trajs)}
    mine = np.flatnonzero(row_owner == me)       # this rank's chunk rows
    B_total = len(ids_g)
    K1out = k_max + 1
    evidence = np.full((B_total, K1out), np.nan)
    evidence_se = np.full((B_total, K1out), np.nan)
    profiles_by_k: List[Optional[np.ndarray]] = [None] * B_total
    margs_by_traj: List[Optional[np.ndarray]] = [None] * B_total
    mom_all = np.ones((B_total, K1out), dtype=bool)

    iterator = work
    if show_progress:
        try:
            from tqdm.auto import tqdm
            iterator = tqdm(work, desc="chunks")
        except ImportError:
            pass

    for T_pad, rows in iterator:
        ck_path, loaded = None, None
        if checkpoint_dir is not None:
            hh = hashlib.sha256()
            hh.update(config_str.encode())
            hh.update(rows.tobytes())
            hh.update(np.asarray([T_pad]).tobytes())
            ck_path = os.path.join(checkpoint_dir,
                                   f"shard_chunk_{hh.hexdigest()[:16]}.npz")
            if checkpoint_hit(ck_path, mesh):
                loaded = np.load(ck_path)

        lengths = np.where(rows >= 0, len_g[np.maximum(rows, 0)], 0)
        if loaded is not None:
            ev, se = loaded["evidence"], loaded["evidence_se"]
            maps = loaded["map_profiles"]
            marg = loaded["marginals"] if marginals else None
            mom = loaded["mom_ok"]
        else:
            # this rank's rows, stacked at the bucket-wide T_pad, so that a
            # trajectory's inputs do not depend on its chunk partners
            loc_data = torch.zeros((len(mine), T_pad, d_dim), dtype=dtype,
                                   device=device)
            loc_valid = torch.zeros((len(mine), T_pad), dtype=torch.bool,
                                    device=device)
            for j, r in enumerate(mine):
                if rows[r] >= 0:
                    t = local_by_id[int(ids_g[rows[r]])]
                    loc_data[j, :len(t)] = t.data
                    loc_valid[j, :len(t)] = t.valid
            local_batch = TrajectoryBatch(data=loc_data, valid=loc_valid,
                                          lengths=lengths[mine])
            # likelihood inputs and informed init of this rank's rows only
            # (host-side table builds never see other ranks' data)
            K1 = min(k_max, max(T_pad - 1, 0)) + 1
            per_traj, logL_fn = model.lockstep_fns(local_batch,
                                                   max_intervals=K1)
            if mesh is not None:
                per_traj = tuple(feed_process_local(x, mesh,
                                                    global_batch=chunk_size)
                                 for x in per_traj)
            informed_arrays = None
            if informed_init:
                informed_arrays = _informed_proposals_all_k_impl(
                    model, local_batch, K1, n_states, T_pad)
            # the batch argument carries only shapes and true lengths
            batch = TrajectoryBatch(
                data=torch.zeros((chunk_size, T_pad, 0), dtype=dtype),
                valid=torch.zeros((chunk_size, T_pad), dtype=torch.bool),
                lengths=lengths)
            # streams keyed by global trajectory id (filler rows: a
            # disjoint namespace)
            row_ids = np.where(rows >= 0, ids_g[np.maximum(rows, 0)],
                               _FILLER_ID + np.arange(chunk_size))
            row_keys = LaneRNG(torch.full((chunk_size,), seed)).fold(
                torch.as_tensor(row_ids)).keys.numpy()
            res = sample_batch(
                model, batch, k_max=k_max, steps_per_k=steps_per_k, N=N,
                dE=dE, scout_steps=scout_steps, refine_top=refine_top,
                informed_init=False, informed_arrays=informed_arrays,
                lockstep=(per_traj, logL_fn), marginals=marginals,
                mesh=mesh, row_keys=row_keys, **sample_kw)
            ev, se, maps = res.evidence, res.evidence_se, res.map_profiles
            marg, mom = res.marginals, res.mom_ok
            if ck_path is not None and (mesh is None or mesh.index == 0):
                tmp = ck_path + ".tmp.npz"
                np.savez(tmp, evidence=ev, evidence_se=se,
                         map_profiles=maps,
                         marginals=(marg if marginals else np.zeros(0)),
                         mom_ok=mom)
                os.replace(tmp, ck_path)

        k_here = ev.shape[1]
        for r in range(chunk_size):
            gi = rows[r]
            if gi < 0:
                continue
            evidence[gi, :k_here] = ev[r]
            evidence[gi, k_here:] = -np.inf
            evidence_se[gi, :k_here] = se[r]
            evidence_se[gi, k_here:] = 1e-10
            mom_all[gi, :k_here] = mom[r]
            Ti = int(len_g[gi])
            prof = np.zeros((K1out, Ti), dtype=int)
            prof[:k_here] = maps[:, r, :Ti]
            profiles_by_k[gi] = prof
            if marginals:
                n = marg.shape[2]
                m = np.full((K1out, n, Ti), -np.inf)
                m[:k_here] = marg[:, r, :, :Ti]
                margs_by_traj[gi] = m

    return DatasetResults(
        k=np.arange(K1out),
        evidence=evidence,
        evidence_se=evidence_se,
        profiles_by_k=profiles_by_k,
        dE=dE,
        marginals=margs_by_traj if marginals else None,
        mom_ok=mom_all,
        ids=ids_g,
    )

"""Measure the episodic-sharding decision (the port's counterpart of
``scripts/bench_episodic_sharding.py``; SCALING.md).

``train/runner.py::run`` keeps episodic training on one device under a
mesh; this script puts numbers on that decision: epochs of
reference-geometry episodes at ImageNet scale (N=1000, K=16, d=1024, fc
adapter) run

1. replicated: ``EpisodicTrainer``'s step, the shipped path;
2. with each live episode's query rows split over the shards of a mesh
   (``parallel.make_mesh``), parameters replicated: what "shard the
   episodic step" would ship as.  JAX got this step from jit's sharding
   propagation; here :class:`QueryShardedTrainer` builds it: each shard
   computes its rows' share of L1 (over the *global* query weights'
   denominator) on a replica of the parameters; the query-independent
   terms (L2, L3 on the prototypes) count once, on the first shard; the
   gradients are summed onto the primary replica, one AdamW step runs there
   and the replicas are refreshed.

As the JAX script times its jitted epoch on fixed inputs, one epoch of
episodes is drawn once (``make_episode_queries`` seeded 1) and put on the
device before any timing; a timed epoch is the steps over its live
episodes alone, between a sync of the mesh's devices at each end.  The two
trainers' epochs alternate (one warm-up each, then ``--repeats`` pairs,
every other pair in reverse order), so a drift of the clocks or the host
reaches both.  Both start from the
same state and step on the same episodes, so their parameters must agree
within PARAM_BAR; a larger difference exits 1.

    python -m protoclip_tpu_torch.scripts.bench_episodic_sharding [--devices 8] [--repeats 100]
    python -m protoclip_tpu_torch.scripts.bench_episodic_sharding --device cuda:0 --devices 2
    python -m protoclip_tpu_torch.scripts.bench_episodic_sharding --device cpu --devices 4 \
        --n-class 20 --k-shots 4 --dim 64

``--device cuda`` (the default) meshes over the cards; a device with an
index (``cuda:0``) or the CPU is repeated ``--devices`` times, several
shards on one device (with one card that measures the wiring's cost, not
scaling: SCALING.md's numbers are the TPU's).  Prints one JSON line with
the median time of an epoch each way, their ratio and the quartiles of
the paired epochs' ratios.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from protoclip_tpu_torch.ops.losses import nll_of_probs, protoclip_loss
from protoclip_tpu_torch.parallel import Mesh
from protoclip_tpu_torch.train.episodic import (
    EpisodicTrainer,
    _deterministic,
    make_episode_queries,
    max_episodes,
    max_queries,
    named_leaves,
)

PARAM_BAR = 1e-6  # max |sharded - replicated| over every parameter, fp32


def _replica(tree, device):
    return {k: _replica(v, device) if isinstance(v, dict)
            else v.detach().to(device, copy=True).requires_grad_(True)
            for k, v in tree.items()}


@dataclasses.dataclass
class QueryShardedTrainer(EpisodicTrainer):
    """``EpisodicTrainer`` whose step splits each episode's query rows over
    the shards of ``mesh`` (see the module docstring)."""

    mesh: Optional[Mesh] = None

    def __post_init__(self):
        super().__post_init__()
        devices = self.mesh.devices
        self._replicas = [self.params] + [_replica(self.params, d) for d in devices[1:]]
        self._bank_t_on = {d: self._frozen_bank_t.to(d) for d in set(devices)}

    def _shard_loss(self, s, params, zq_frozen, labels, weights, denom):
        """(loss, terms, matches) of shard ``s``'s rows: their L1 share over
        the global weights' sum ``denom``, plus the query-independent terms
        on shard 0 alone."""
        p, img_proto, txt_proto = self._probs(params, self._bank_t_on[self.mesh.devices[s]],
                                              zq_frozen)
        others = tuple(t for t in self.losses if t != "L1")
        terms = (protoclip_loss(p, labels, img_proto, txt_proto, others)
                 if s == 0 and others else {"total": torch.zeros((), device=p.device)})
        loss = terms.pop("total")
        if len(self.losses) == 0 or "L1" in self.losses:
            # the shard's mean over its 0/1 weights, rescaled to the global sum
            terms["L1"] = (nll_of_probs(p, labels, weights)
                           * torch.clamp_min(weights.sum(), 1.0) / denom)
            loss = loss + terms["L1"]
        matches = ((p.argmax(dim=-1) == labels).float() * weights).sum()
        return loss, terms, matches

    def _step(self, zq_frozen, labels, weights):
        devices = self.mesh.devices
        primary = devices[0]
        denom = torch.clamp_min(weights.sum(), 1.0)
        parts = zip(torch.tensor_split(zq_frozen, len(devices)),
                    torch.tensor_split(labels, len(devices)),
                    torch.tensor_split(weights, len(devices)))
        total = torch.zeros((), device=primary)
        terms: dict = {}
        matches = torch.zeros((), device=primary)
        with _deterministic():
            for s, (device, params, (zq, lab, w)) in enumerate(zip(devices, self._replicas,
                                                                     parts)):
                for _, p in named_leaves(params):
                    p.grad = None
                loss, t, m = self._shard_loss(s, params, zq.to(device), lab.to(device),
                                              w.to(device), denom.to(device))
                loss.backward()
                total += loss.detach().to(primary)
                matches += m.detach().to(primary)
                for key, value in t.items():
                    terms[key] = terms.get(key, 0.0) + value.detach().to(primary)
        replicas = [dict(named_leaves(r)) for r in self._replicas[1:]]
        for name, p in named_leaves(self.params):
            # as EpisodicTrainer._step: a parameter outside the forward has
            # a zero gradient, and AdamW still decays it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            for other in replicas:
                if other[name].grad is not None:
                    p.grad += other[name].grad.to(p.device)
        self.optimizer.step()
        with torch.no_grad():
            for other in replicas:
                for name, p in named_leaves(self.params):
                    other[name].copy_(p)
        terms["total"] = total
        return terms, matches


def mesh_for(device: str, n: int):
    """``--device cuda``: the first ``n`` cards (0: all); a device with an
    index or the CPU: that device repeated ``n`` times (0: once)."""
    from protoclip_tpu_torch.parallel import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return make_mesh(n or None)
    return make_mesh(n or 1, devices=[dev] * (n or 1))


def max_param_diff(a: EpisodicTrainer, b: EpisodicTrainer) -> float:
    theirs = dict(named_leaves(b.params))
    return max(float((p.detach() - theirs[name].detach().to(p.device)).abs().max())
               for name, p in named_leaves(a.params))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--devices", type=int, default=0, help="mesh size (0 = all)")
    parser.add_argument("--repeats", type=int, default=100,
                        help="timed epochs each way (default 100: with 5, as the JAX script, "
                        "a mesh of one device read 0.93-1.05x of replicated on the card)")
    parser.add_argument("--n-class", type=int, default=1000)
    parser.add_argument("--k-shots", type=int, default=16)
    parser.add_argument("--dim", type=int, default=1024)
    parser.add_argument("--device", default="cuda",
                        help="cuda: mesh over the cards; cuda:<i> or cpu: that device "
                        "repeated --devices times (default: cuda)")
    return parser


def time_epochs(trainers, mesh: Mesh, episodes, repeats: int):
    """Each trainer's epoch seconds: the steps over ``episodes`` (device
    tensors: the live episodes' query indices, labels and weights), a sync
    of the mesh's devices at each end; one warm-up epoch each, then
    ``repeats`` rounds of one epoch each, the order reversed every other
    round."""
    idx, labels, weights = episodes
    cards = sorted({d for d in mesh.devices if d.type == "cuda"}, key=str)

    def sync():
        for card in cards:
            torch.cuda.synchronize(card)

    def epoch(trainer):
        sync()
        t0 = time.perf_counter()
        for e in range(idx.shape[0]):
            trainer._step(trainer._frozen_keys[idx[e]], labels[e], weights[e])
        sync()
        return time.perf_counter() - t0

    for trainer in trainers:
        epoch(trainer)
    times = [[] for _ in trainers]
    for r in range(repeats):
        pairs = list(zip(trainers, times))
        for trainer, seconds in pairs[::-1] if r % 2 else pairs:
            seconds.append(epoch(trainer))
    return times


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from protoclip_tpu_torch.device import resolve_device

    resolve_device(args.device)
    mesh = mesh_for(args.device, args.devices)
    n, k, d = args.n_class, args.k_shots, args.dim
    rng = np.random.default_rng(0)
    keys = rng.standard_normal((n * k, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=-1, keepdims=True)
    bank_t = rng.standard_normal((n, d)).astype(np.float32)
    common = dict(frozen_keys=keys, bank_t_init=bank_t, n_class=n, k_shots=k,
                  adapter_kind="fc", alpha=0.5, beta=12.0, train_epoch=2000, seed=0)
    replicated = EpisodicTrainer(**common, device=mesh.device)
    sharded = QueryShardedTrainer(**common, device=mesh.device, mesh=mesh)
    q_idx, q_lab, q_w, valid = make_episode_queries(np.random.default_rng(1), n, k)
    live = np.flatnonzero(valid > 0)
    episodes = (torch.from_numpy(q_idx[live]).to(mesh.device).long(),
                torch.from_numpy(q_lab[live]).to(mesh.device).long(),
                torch.from_numpy(q_w[live]).to(mesh.device))

    t_rep, t_shard = time_epochs((replicated, sharded), mesh, episodes, args.repeats)
    t_single, t_sharded = float(np.median(t_rep)), float(np.median(t_shard))
    pair_ratios = np.asarray(t_shard) / np.asarray(t_rep)
    diff = max_param_diff(replicated, sharded)
    one_device = len(set(mesh.devices)) == 1
    out = {
        "backend": mesh.device.type,
        "devices": mesh.size,
        "n_class": n,
        "k_shots": k,
        "dim": d,
        "episodes_per_epoch": max_episodes(n),
        "query_buffer": max_queries(n, k),
        "epoch_s_replicated": round(t_single, 4),
        "epoch_s_query_sharded": round(t_sharded, 4),
        "sharded_over_replicated": round(t_sharded / t_single, 3),
        "epoch_ms_replicated": t_single * 1e3,
        "epoch_ms_query_sharded": t_sharded * 1e3,
        "ratio_of_medians": t_sharded / t_single,
        "pair_ratio_quartiles": [float(q) for q in np.quantile(pair_ratios, [0.25, 0.5, 0.75])],
        "live_episodes": int(live.size),
        "timer": "steps only, a sync at each end",
        "mesh_devices": [str(dev) for dev in mesh.devices],
        "epochs": 1 + args.repeats,
        "max_abs_param_diff": diff,
        "param_bar": PARAM_BAR,
        "note": ("every shard on one device: the wiring's cost, not scaling" if one_device
                 else "one shard a device"),
    }
    if mesh.device.type == "cuda":
        out["device"] = torch.cuda.get_device_name(mesh.device)
    print(json.dumps(out), flush=True)
    if not diff <= PARAM_BAR:
        print(f"FAIL: the sharded epochs' parameters are {diff} off the replicated ones "
              f"(bar {PARAM_BAR})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

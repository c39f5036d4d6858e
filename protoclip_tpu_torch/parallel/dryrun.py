"""A dry run of every multi-device path on a tiny ViT (the port's analog of
``__graft_entry__.dryrun_multichip``).

    python -m protoclip_tpu_torch.parallel.dryrun [--devices 8] [--processes 2] \\
        [--device cpu]

On an ``n_devices`` mesh: one sharded Q^T step, one episodic epoch beside
the mesh, the int8 (W8A8) mesh encode, the ``cli/serve.py`` mesh route with
one real base64 JPEG, and ``cli/extract.py --mesh``.  With ``processes >
1`` it spawns that many ranks (``file://`` rendezvous) and runs the Q^T
step and the sharded encode over the one global mesh; the ranks must agree
bit for bit.

By default the mesh is the first ``n_devices`` cards.  With ranks, rank
``r`` drives cards ``r * k`` to ``(r + 1) * k - 1`` (``k = n_devices /
processes``) and the ranks join over NCCL; where there are fewer cards than
``n_devices``, the ranks share them round robin and join over gloo (NCCL
takes one rank per card).  ``device="cpu"`` repeats the CPU ``n_devices``
times, as the JAX tests run 8 virtual host devices, over gloo.
"""

from __future__ import annotations

import argparse
import base64
import io
import os
import pickle
import sys
import tempfile
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from protoclip_tpu_torch.device import resolve_device

N_CLASS, K_SHOTS = 8, 4
RANK_TIMEOUT_S = 300.0


def tiny_state_dict(rng: np.random.Generator) -> dict:
    """A tiny ViT CLIP in the OpenAI checkpoint layout: 32 px, patch 16,
    2 layers of width 64 in each tower, embed 32, a 128-token vocabulary."""
    width, layers, patch, grid, embed, vocab, ctx = 64, 2, 16, 2, 32, 128, 16
    sd = {}

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.05

    def tower(prefix):
        for i in range(layers):
            p = f"{prefix}transformer.resblocks.{i}"
            sd.update({
                f"{p}.ln_1.weight": np.ones(width, np.float32),
                f"{p}.ln_1.bias": np.zeros(width, np.float32),
                f"{p}.attn.in_proj_weight": randn(3 * width, width),
                f"{p}.attn.in_proj_bias": randn(3 * width),
                f"{p}.attn.out_proj.weight": randn(width, width),
                f"{p}.attn.out_proj.bias": randn(width),
                f"{p}.ln_2.weight": np.ones(width, np.float32),
                f"{p}.ln_2.bias": np.zeros(width, np.float32),
                f"{p}.mlp.c_fc.weight": randn(4 * width, width),
                f"{p}.mlp.c_fc.bias": randn(4 * width),
                f"{p}.mlp.c_proj.weight": randn(width, 4 * width),
                f"{p}.mlp.c_proj.bias": randn(width),
            })

    sd["visual.conv1.weight"] = randn(width, 3, patch, patch)
    sd["visual.class_embedding"] = randn(width)
    sd["visual.positional_embedding"] = randn(grid * grid + 1, width)
    for ln in ("visual.ln_pre", "visual.ln_post", "ln_final"):
        sd[f"{ln}.weight"] = np.ones(width, np.float32)
        sd[f"{ln}.bias"] = np.zeros(width, np.float32)
    tower("visual.")
    sd["visual.proj"] = randn(width, embed)
    tower("")
    sd["token_embedding.weight"] = randn(vocab, width)
    sd["positional_embedding"] = randn(ctx, width)
    sd["text_projection"] = randn(width, embed)
    sd["logit_scale"] = np.float32(np.log(1 / 0.07))
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _tiny_clip(device):
    from protoclip_tpu_torch.models.clip import convert_clip_state_dict, to_device

    cfg, params = convert_clip_state_dict(tiny_state_dict(np.random.default_rng(0)))
    return cfg, to_device(params, torch.device(device))


def _mesh(n_devices: int, device):
    from protoclip_tpu_torch.parallel import make_mesh

    if device is None or torch.device(device).type == "cuda":
        return make_mesh(n_devices)
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    return make_mesh(n_devices, devices=[device] * (n_devices // world))


def qt_step(mesh, seed: int = 0) -> dict:
    """One Q^T step of the tiny ViT on ``mesh`` over a global batch of 2
    rows per shard, the same on every process.  Returns the stats, the
    global batch's features and the trained parameters (host arrays)."""
    from protoclip_tpu_torch.train.episodic import named_leaves
    from protoclip_tpu_torch.train.qt import QTTrainer

    cfg, params = _tiny_clip(mesh.device)
    rng = np.random.default_rng(seed)  # the same draws on every process
    bank_v = rng.standard_normal((N_CLASS * K_SHOTS, cfg.embed_dim)).astype(np.float32)
    bank_t = rng.standard_normal((N_CLASS, cfg.embed_dim)).astype(np.float32)
    trainer = QTTrainer(clip_params=params, clip_cfg=cfg, bank_v_init=bank_v,
                        bank_t_init=bank_t, n_class=N_CLASS, k_shots=K_SHOTS,
                        adapter_kind="fc", alpha=0.5, beta=10.0, compute_dtype="float32",
                        mesh=mesh)
    batch = 2 * mesh.size
    images = rng.integers(0, 256, (batch, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, N_CLASS, (batch,))
    feats = trainer.encode(images).cpu().numpy()
    stats = trainer.train_step(images, labels, n_valid=batch)
    trained = {name: p.detach().cpu().numpy() for name, p in named_leaves(trainer.params)}
    return {"stats": stats, "features": feats, "params": trained}


def _episodic_epoch(device, rng) -> dict:
    """One Proto-CLIP-F epoch: deliberately on one device beside the mesh
    (``train/runner.py::run``)."""
    from protoclip_tpu_torch.train.episodic import EpisodicTrainer

    keys = rng.standard_normal((N_CLASS * K_SHOTS, 32)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=-1, keepdims=True)
    bank_t = rng.standard_normal((N_CLASS, 32)).astype(np.float32)
    trainer = EpisodicTrainer(frozen_keys=keys, bank_t_init=bank_t, n_class=N_CLASS,
                              k_shots=K_SHOTS, adapter_kind="fc", alpha=0.5, beta=10.0,
                              train_epoch=2, seed=0, device=device)
    return trainer.run_epoch()


def _int8_mesh_encode(mesh, rng) -> float:
    """The W8A8 serving encode sharded over the mesh: the towers quantized
    once (``quantize_for_serving``), K3 on every shard."""
    from protoclip_tpu_torch.io.export import make_encode_fn
    from protoclip_tpu_torch.models.clip import quantize_for_serving
    from protoclip_tpu_torch.parallel import make_sharded_encode, replicated

    cfg, params = _tiny_clip(mesh.device)
    qparams = replicated(mesh).put(quantize_for_serving(params))
    encode = make_sharded_encode(make_encode_fn(cfg, int8=True), mesh)
    images = rng.integers(0, 256, (2 * mesh.size, 32, 32, 3)).astype(np.uint8)
    feats = encode(qparams, images).cpu().numpy()
    if feats.shape != (2 * mesh.size, cfg.embed_dim) or not np.isfinite(feats).all():
        raise RuntimeError(f"int8 mesh encode: bad features {feats.shape}")
    norms = np.linalg.norm(feats, axis=-1)
    if not np.allclose(norms, 1.0, atol=1e-2):
        raise RuntimeError(f"int8 mesh encode: rows not unit-norm {norms}")
    return float(np.abs(feats).sum())


def _jpeg_b64(image: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "JPEG", quality=90)
    return base64.b64encode(buf.getvalue()).decode()


def _serve_mesh(n_devices: int, device) -> int:
    """The ``cli/serve.py --mesh`` route: one real base64 JPEG through the
    micro-batcher."""
    from protoclip_tpu_torch.cli.serve import make_mesh_encode_route

    route, info = make_mesh_encode_route(clip=_tiny_clip(device or "cuda"),
                                         mesh_devices=n_devices, per_device_batch=2,
                                         warmup=True, coalesce_ms=0.0, device=device)
    try:
        out = route({"images": [_jpeg_b64(np.full((48, 40, 3), 128, np.uint8))]})
        feats = np.asarray(out["features"], np.float32)
        if feats.shape != (1, 32) or not np.isfinite(feats).all():
            raise RuntimeError(f"serve mesh route: bad features {feats.shape}")
        if info["mesh_devices"] != n_devices:
            raise RuntimeError(f"serve mesh route: {info}")
    finally:
        route.batcher.close()
        route.pool.shutdown(wait=False)
    return int(feats.shape[1])


def _extract_mesh(n_devices: int, device) -> int:
    """``cli/extract.py --mesh`` on a folder of PNGs whose count the batch
    (one row per shard) does not divide."""
    from PIL import Image

    from protoclip_tpu_torch.cli import extract as extract_cli

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="dryrun_extract_") as tmp:
        weights = os.path.join(tmp, "tiny.pt")
        torch.save(tiny_state_dict(rng), weights)
        img_dir = os.path.join(tmp, "imgs")
        os.makedirs(img_dir)
        n_img = 2 * n_devices + 3  # a ragged tail on purpose
        for i in range(n_img):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)).save(
                os.path.join(img_dir, f"{i:03d}.png"))
        out = os.path.join(tmp, "feats.npz")
        argv = sys.argv
        try:
            sys.argv = ["extract", "--backbone", "tiny", "--weights", weights, "--input",
                        img_dir, "--out", out, "--batch", str(n_devices), "--mesh",
                        str(n_devices), "--device", str(device or "cuda")]
            extract_cli.main()
        finally:
            sys.argv = argv
        with np.load(out) as z:
            feats = z["features"]
    if feats.shape[0] != n_img or not np.isfinite(feats).all():
        raise RuntimeError(f"extract --mesh: bad features {feats.shape}")
    return int(feats.shape[0])


def _rank_main(rank: int, processes: int, rendezvous: str, out_dir: str, target: Callable,
               kwargs: dict, backend: str, device_ids: Optional[List[int]]) -> None:
    from protoclip_tpu_torch.parallel import init_distributed

    # one intra-op thread: every rank, and the 1-rank reference, sums alike
    torch.set_num_threads(1)
    init_distributed(f"file://{rendezvous}", processes, rank, local_device_ids=device_ids,
                     backend=backend)
    try:
        result = target(**kwargs)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
    finally:
        torch.distributed.destroy_process_group()


def rank_cards(n_devices: int, processes: int) -> Tuple[str, List[List[int]]]:
    """The backend and each rank's CUDA device ids for ``processes`` ranks
    of ``n_devices / processes`` shards: every rank its own slice of the
    cards over NCCL, or, with fewer cards than shards, the cards shared
    round robin over gloo."""
    resolve_device("cuda")  # raises without CUDA
    cards, per = torch.cuda.device_count(), n_devices // processes
    ids = [[(r * per + i) % cards for i in range(per)] for r in range(processes)]
    return ("nccl" if cards >= n_devices else "gloo"), ids


def run_ranks(target: Callable, processes: int, timeout_s: float = RANK_TIMEOUT_S,
              backend: str = "gloo", device_ids: Optional[List[List[int]]] = None,
              **kwargs) -> List:
    """``target(**kwargs)`` in each of ``processes`` spawned ranks joined
    over ``backend`` (``file://`` rendezvous in a temp dir), rank ``r``
    driving the CUDA devices ``device_ids[r]`` where given; returns each
    rank's result.  ``target`` must be importable (a module-level
    function).  A rank that fails or outlives ``timeout_s`` fails the run,
    and every rank still alive is killed."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="protoclip_ranks_") as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, processes, rendezvous, tmp, target, kwargs, backend,
                                   device_ids[r] if device_ids else None))
                 for r in range(processes)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            late = [r for r, p in enumerate(procs) if p.is_alive()]
            if late:
                raise RuntimeError(f"ranks {late} did not finish within {timeout_s:.0f} s")
            failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
            if failed:
                raise RuntimeError(f"ranks failed (rank: exit code): {failed}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        results = []
        for r in range(processes):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
    return results


def global_qt_step(n_devices: int, device=None) -> dict:
    """A rank's part of the multi-process dry run: the Q^T step (and its
    sharded encode) over the global mesh of ``n_devices`` shards (default:
    the rank's cards)."""
    return qt_step(_mesh(n_devices, device))


def assert_ranks_agree(results: List[dict]) -> None:
    """Every rank's features, loss and trained parameters bit for bit."""
    first = results[0]
    for rank, other in enumerate(results[1:], 1):
        if other["stats"]["loss"] != first["stats"]["loss"]:
            raise RuntimeError(f"rank {rank} loss {other['stats']['loss']} != "
                               f"{first['stats']['loss']}")
        np.testing.assert_array_equal(other["features"], first["features"])
        for name, value in first["params"].items():
            np.testing.assert_array_equal(other["params"][name], value, err_msg=name)


def dryrun_multigpu(n_devices: int, processes: int = 1, device: Optional[str] = None) -> str:
    """Run every mesh path once on an ``n_devices`` mesh (see the module
    docstring); returns the summary line it prints."""
    if processes > 1:
        if n_devices % processes:
            raise ValueError(f"{n_devices} devices do not split over {processes} processes")
        if device is None or torch.device(device).type == "cuda":
            backend, device_ids = rank_cards(n_devices, processes)
        else:
            backend, device_ids = "gloo", None
        results = run_ranks(global_qt_step, processes, backend=backend, device_ids=device_ids,
                            n_devices=n_devices, device=device)
        assert_ranks_agree(results)
        stats = results[0]["stats"]
        line = (f"[dryrun_multigpu] {processes}-process x {n_devices // processes}-device "
                f"{backend} group OK: qt loss={stats['loss']:.6f} acc={stats['acc']:.4f} "
                f"enc={float(np.abs(results[0]['features']).sum()):.6f}")
        print(line)
        return line
    mesh = _mesh(n_devices, device)
    rng = np.random.default_rng(0)
    qt = qt_step(mesh)["stats"]
    if not np.isfinite(qt["loss"]):
        raise RuntimeError(f"non-finite Q^T loss: {qt}")
    episodic = _episodic_epoch(mesh.device, rng)
    if not np.isfinite(episodic["loss"]):
        raise RuntimeError(f"non-finite episodic loss: {episodic}")
    line = (f"[dryrun_multigpu] {n_devices}-device mesh OK: "
            f"qt loss={qt['loss']:.4f} acc={qt['acc']:.3f} | "
            f"episodic loss={episodic['loss']:.4f} | "
            f"int8-encode checksum={_int8_mesh_encode(mesh, rng):.4f} | "
            f"serve-mesh dim={_serve_mesh(n_devices, device)} | "
            f"extract-mesh rows={_extract_mesh(n_devices, device)}")
    print(line)
    return line


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--devices", type=int, default=8, help="shards of the mesh")
    parser.add_argument("--processes", type=int, default=1, help="ranks to spawn (gloo)")
    parser.add_argument("--device", help="cpu: n_devices CPU shards (default: the cards)")
    args = parser.parse_args(argv)
    dryrun_multigpu(args.devices, args.processes, args.device)


if __name__ == "__main__":
    main()

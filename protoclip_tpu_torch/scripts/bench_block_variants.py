"""Time the block variants of the TPU bench on the card.

    python -m protoclip_tpu_torch.scripts.bench_block_variants [VARIANT ...] [--device cuda|cpu]

Counterpart of ``scripts/bench_block_variants.py``, with its grammar,
default (``v0 v1 v2``), geometry (B=512, L=197, LP=200, D=768, H=12, 12
layers; ``$BENCH_GEOM=vitl`` and ``$BENCH_LP16`` as there) and seeded
draws, so one command line gives the same checksums in both packages up to
the order of fp32 sums.  Variants:

- ``v0``-``v10``, ``v2g8``, ``v2g32``, ``v6g8``: the bf16 block stack;
- ``int8...``: the W8A8 stack with the script's modifiers (``g8``/``g32``,
  ``h``, ``gb``, ``noattn``, ``static``, ``recip``, ``cast``, ``lnb``, and
  the int8 attention core ``int8s``);
- ``micro:NAME``: one half of a block (``mlp_xla``, ``mlp_pallas``,
  ``int8mlp``, ``int8mlp_nogelu``, ``int8mlp_fp32gelu``, ``int8qkv``,
  ``attn_pallas``, ``attn_nosm``, ``attn_noqkv``, ``attn_*@G``).

Each prints the script's line: ms per 12-layer stack (the minimum of 8
runs, each timed with CUDA events after one warm-up call, whose wall time
is the "compile" field) and the checksum ``sum(out)`` in fp32.  The
variants run on the card through the port's kernels (``ops/
block_variants.py``); ``--device cpu`` runs their plain versions.  As in
the script, ``v10`` folds the LayerNorm affine into the weights and keeps
the folded weights for every later bf16 variant of the same command line.
"""

from __future__ import annotations

import argparse
import functools
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Optional

import torch

from protoclip_tpu_torch.device import resolve_device
from protoclip_tpu_torch.ops import block_variants as bv

DEFAULT_VARIANTS = ("v0", "v1", "v2")
RUNS = 8
# make_kernel's flags (bench_block_variants.py:61-68)
SCORE_BF16 = ("v1", "v2", "v3", "v4", "v5", "v6", "v6g8", "v2g8", "v2g32")
GELU_BF16 = ("v2", "v3", "v4", "v2g8", "v2g32")
STACK_GROUPS = {"v2g8": 8, "v2g32": 32, "v6g8": 8}
MICRO_ATTN = {"attn_pallas": "softmax", "attn_nosm": "no_softmax", "attn_noqkv": "noqkv"}
INT8MLP = ("int8mlp", "int8mlp_nogelu", "int8mlp_fp32gelu")
INT8_GROUP = 16  # main's int8 default (:370), a literal where the stacks take G


# -- the grammar (bench_block_variants.py:358-383) ------------------------------------------


def parse_variant(variant: str, geom: bv.Geometry) -> dict:
    """What the script's ``main`` hands on for one name: ``bench_micro``'s
    argument, ``bench_int8``'s keywords, or ``build_stack_fn``'s (variant,
    g) plus whether it folds the weights first."""
    if variant.startswith("micro:"):
        return {"kind": "micro", "which": variant.split(":", 1)[1]}
    if variant.startswith("int8"):
        spec = variant[len("int8"):]
        quant_mode = "dyn"
        if "recip" in spec:
            quant_mode = "recip"
        elif "cast" in spec:
            quant_mode = "cast"
        rest = spec.replace("g32", "").replace("g8", "").replace("noattn", "").replace(
            "gb", "").replace("recip", "").replace("cast", "").replace("lnb", "")
        return {
            "kind": "int8",
            "g": 32 if "g32" in spec else (8 if "g8" in spec else INT8_GROUP),
            "quant_hid": "h" not in rest,
            "skip_attn": "noattn" in spec,
            "quant_scores": variant.startswith("int8s") and "static" not in spec,
            "gelu_bf16": "gb" in spec,
            "static_scales": "static" in spec,
            "quant_mode": quant_mode,
            "ln_stats_bf16": "lnb" in spec,
            "tag": variant,
        }
    return {"kind": "stack", "variant": variant, "g": STACK_GROUPS.get(variant, geom.group),
            "fold": variant == "v10"}


# one chain per numeric function: schedule-only variants share their twin's
_STACK_TWINS = {(False, False, False): "v0", (True, False, False): "v1",
                (True, True, False): "v2", (False, False, True): "v10"}
_INT8_CANON = ("int8", "int8h", "int8gb", "int8noattn", "int8static", "int8recip", "int8cast",
               "int8lnb", "int8hgb", "int8s", "int8sg8", "int8sg32")


def _stack_key(variant: str):
    return (variant in SCORE_BF16, variant in GELU_BF16, variant == "v10")


def _int8_key(spec: dict):
    return tuple(sorted(_int8_flags(spec).items())), (spec["g"] if spec["quant_scores"] else None)


def twin(spec: dict, geom: bv.Geometry) -> str:
    """The variant whose chain this one runs: the same function, another
    TPU schedule (grid group, head layout, pipelining, chunking)."""
    if spec["kind"] == "stack":
        return _STACK_TWINS[_stack_key(spec["variant"])]
    if spec["kind"] == "micro":
        return spec["which"].split("@")[0]
    key = _int8_key(spec)
    for name in _INT8_CANON:
        if _int8_key(parse_variant(name, geom)) == key:
            return name
    return spec["tag"]


def _int8_flags(spec: dict) -> dict:
    """The keywords of :func:`bv.block_int8` that change what it computes."""
    flags = {k: spec[k] for k in ("quant_hid", "skip_attn", "quant_scores", "gelu_bf16",
                                  "static_scales", "quant_mode", "ln_stats_bf16")}
    if flags["quant_scores"]:  # make_kernel_int8s fixes the rest
        flags.update(quant_hid=True, skip_attn=False, gelu_bf16=False, static_scales=False)
    if flags["skip_attn"]:
        flags.update(gelu_bf16=False, quant_hid=True)
    return flags


# -- one variant, ready to run -----------------------------------------------------------------


@dataclass
class Prepared:
    name: str      # the name on the command line
    label: str     # the script's line prefix
    spec: dict
    g: int
    x: torch.Tensor
    layers: list
    block: Callable  # block(x, layer, ops)


def _on(device, tensors):
    return tuple(t.to(device) for t in tensors)


def _per_layer(device, *stacks):
    return [_on(device, (s[i] for s in stacks)) for i in range(stacks[0].shape[0])]


@functools.lru_cache(maxsize=2)
def _int8_host_layers(geom: bv.Geometry, down_bf16: bool) -> list:
    return bv.int8_layers(bv.main_draws(geom)[1], geom.layers, down_bf16)


def _int8_micro_layers(geom, w_a, w_b, n_bias_a, device):
    """Quantized micro layers: (wa_q, sa, zeros fp32, wb_q, sb, zeros fp32,
    LN ones, LN zeros), as bench_micro stacks them (:487-498, :553-565)."""
    d = geom.width
    out = []
    for i in range(geom.layers):
        out.append(_on(device, (*bv.quant_layer(w_a[i]), torch.zeros(n_bias_a),
                                *bv.quant_layer(w_b[i]), torch.zeros(d),
                                torch.ones(d), torch.zeros(d))))
    return out


def prepare(name: str, spec: dict, geom: bv.Geometry, device, weights=None) -> Prepared:
    """The stack of one variant on ``device``.  ``weights``: the bf16
    weights of the stack variants (``main``'s, folded after ``v10``)."""
    h, length, d, n = geom.heads, geom.length, geom.width, geom.layers
    kind = spec["kind"]
    if kind == "stack":
        x, main_weights = bv.main_draws(geom)
        q_round, gelu_bf16, folded = _stack_key(spec["variant"])
        block = functools.partial(bv.block_bf16, n_head=h, length=length, q_round=q_round,
                                  gelu_bf16=gelu_bf16, folded=folded)
        layers = _per_layer(device, *(main_weights if weights is None else weights))
        return Prepared(name, spec["variant"], spec, spec["g"], x.to(device),
                        layers, lambda t, layer, ops: block(t, layer, ops=ops))
    if kind == "int8":
        if spec["quant_scores"] and (spec["quant_mode"] != "dyn" or spec["ln_stats_bf16"]):
            raise SystemExit(f"{spec['tag']}: int8s variants do not support recip/cast/lnb")
        flags = _int8_flags(spec)
        block = functools.partial(bv.block_int8, n_head=h, length=length, group=spec["g"],
                                  **flags)
        layers = [_on(device, layer)
                  for layer in _int8_host_layers(geom, not flags["quant_hid"])]
        return Prepared(name, f"{spec['tag']}(g={spec['g']})", spec, spec["g"],
                        bv.main_draws(geom)[0].to(device), layers,
                        lambda t, layer, ops: block(t, layer, ops=ops))
    which = spec["which"]
    base, _, gs = which.partition("@")
    g = geom.group
    if which in ("mlp_xla", "mlp_pallas"):
        x, wfc, wproj = bv.micro_draws(geom, "mlp")
        bfc, bproj = torch.zeros(n, 4 * d, dtype=torch.bfloat16), torch.zeros(n, d, dtype=torch.bfloat16)
        layers = _per_layer(device, wfc, bfc, wproj, bproj)
        if which == "mlp_xla":
            def run(t, layer, ops):
                return bv.mlp_xla(t, layer)
        else:
            def run(t, layer, ops):
                return bv.mlp_bf16(t, layer, ops=ops)
    elif which in INT8MLP:
        x, wfc, wproj = bv.micro_draws(geom, "mlp")
        mode = which.removeprefix("int8mlp_") if "_" in which else "bf16gelu"
        layers = _int8_micro_layers(geom, wfc, wproj, 4 * d, device)

        def run(t, layer, ops):
            return bv.mlp_int8(t, layer, mode, ops=ops)
    elif which == "int8qkv":
        x, wqkv, wo = bv.micro_draws(geom, "qkv")
        layers = _int8_micro_layers(geom, wqkv, wo, 3 * d, device)

        def run(t, layer, ops):
            return bv.qkv_int8(t, layer, ops=ops)
    elif base in MICRO_ATTN:
        x, wqkv, wo = bv.micro_draws(geom, "qkv")
        g = int(gs) if gs else g
        zeros = functools.partial(torch.zeros, dtype=torch.bfloat16)
        layers = _per_layer(device, wqkv, zeros(n, 3 * d), wo, zeros(n, d), torch.ones(n, d),
                            torch.zeros(n, d))

        def run(t, layer, ops):
            return bv.attn_bf16(t, layer, h, length, MICRO_ATTN[base], ops=ops)
    else:
        raise SystemExit(f"unknown micro {which}")
    return Prepared(name, which, spec, g, x.to(device), layers, run)


def iter_prepared(names: Iterable[str], geom: bv.Geometry, device) -> Iterator[Prepared]:
    """Each variant of one command line in turn.  After ``v10`` the folded
    weights stay for every later stack variant, as ``main`` keeps them
    (:384-385): ``v10 v10`` folds twice."""
    weights = None
    for name in names:
        spec = parse_variant(name, geom)
        if spec["kind"] == "stack":
            if weights is None:
                weights = bv.main_draws(geom)[1]
            if spec["fold"]:
                weights = bv.fold_ln_into_weights(weights)
        yield prepare(name, spec, geom, device, weights)


# -- timing ---------------------------------------------------------------------------------------


def stack_output(prep: Prepared, ops=bv.KERNEL_OPS, batch: Optional[int] = None):
    """The stack's output on the kernels (``ops=KERNEL_OPS``) or on the
    plain versions, over all of x or its first ``batch`` elements."""
    with torch.inference_mode():
        return bv.run_stack(lambda t, layer: prep.block(t, layer, ops), prep.x, prep.layers,
                            batch)


def time_stack(prep: Prepared) -> dict:
    """The first call's wall time and checksum, then ``RUNS`` timed calls
    (CUDA events on the card, the host clock on the CPU), each ending in
    the on-device fp32 sum as the script's ends in its scalar fetch."""
    cuda = prep.x.is_cuda

    def call():
        return stack_output(prep).float().sum()

    t0 = time.perf_counter()
    cs = float(call())
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(RUNS):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            call()
            times.append((time.perf_counter() - t) * 1e3)
    ordered = sorted(times)
    return {"ms_min": ordered[0], "ms_median": ordered[len(ordered) // 2], "ms_runs": times,
            "checksum": cs, "compile_s": compile_s}


def result_line(prep: Prepared, res: dict) -> str:
    """The script's line for this variant (:396-399, :717-719, :985-988)."""
    ms, cs, cmp = res["ms_min"], res["checksum"], res["compile_s"]
    if prep.spec["kind"] == "stack":
        return (f"{prep.label}: {ms:.1f} ms/12-block-stack  "
                f"(checksum {cs:.2f}, compile {cmp:.0f}s, g={prep.g})")
    if prep.spec["kind"] == "int8":
        return f"{prep.label}: {ms:.1f} ms/12-block-stack (checksum {cs:.2f}, compile {cmp:.0f}s)"
    return f"{prep.label}: {ms:.1f} ms/12-layer  (checksum {cs:.2f}, compile {cmp:.0f}s)"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", help="default: v0 v1 v2")
    parser.add_argument("--device", default=None,
                        help="cuda (the default; raises without CUDA) or cpu (plain versions)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    geom = bv.geometry()
    for prep in iter_prepared(args.variants or DEFAULT_VARIANTS, geom, device):
        print(result_line(prep, time_stack(prep)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

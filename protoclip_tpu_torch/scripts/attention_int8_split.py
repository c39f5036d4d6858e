"""Split the int8 attention core's time on the card into its v-amax pass and
its attention kernel.

    python -m protoclip_tpu_torch.scripts.attention_int8_split [--source FILE.cu ...]

Compiles each ``FILE.cu`` (default: the package's ``csrc/attention_int8.cu``)
with nvcc, as is and, where the source has the hook, with
``-DATTENTION_INT8_AMAX_ONLY``, which returns after the v-amax launch.  Each
build is timed at the block-variant bench's two geometries (ViT-B/16: B=512,
LP=200, length 197, D=768, 12 heads; ViT-L/14: B=128, LP=264, length 257,
D=1024, 16 heads; group 16, bf16 column slices of one QKV buffer): the
device time of one call queued behind a spinning kernel (the host's launch
time hidden), and CUDA events around one call with the host's time.  Prints
the card's name and power limit, then one JSON line: per source and
geometry the whole call, the v-amax pass, the attention kernel (their
difference), the bounds (all q, k, v read and the output written once; v
read once for the v-amax pass) and how many outputs differ from
``attention_int8_plain``.  Needs CUDA; raises without it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from protoclip_tpu_torch.ops import _build
from protoclip_tpu_torch.ops import kernels as K
from protoclip_tpu_torch.scripts._card import bound_ms, build, device_ms, median_ms

HOOK = "ATTENTION_INT8_AMAX_ONLY"
RUNS = 12
GEOMETRIES = {  # name: (batch, padded rows LP, length, D, heads, group)
    "vit_b16": (512, 200, 197, 768, 12, 16),
    "vit_l14": (128, 264, 257, 1024, 16, 16),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, nargs="+",
                    default=[_build.CSRC_DIR / "attention_int8.cu"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("attention_int8_split needs an NVIDIA card (CUDA is not available)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    builds = {}
    for source in args.source:
        builds[str(source)] = {"whole": build(source, "attention_int8")}
        if HOOK in source.read_text():
            builds[str(source)]["amax"] = build(source, "attention_int8", HOOK)
    g = torch.Generator(device="cuda").manual_seed(0)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    result = {"nvidia_smi": smi, "runs": {}}
    for tag, (b, lp, length, d, h, group) in GEOMETRIES.items():
        qkv = torch.randn(b, lp, 3 * d, device=dev, generator=g).to(bf16)
        sl = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:])
        dh, ld = d // h, 3 * d
        out = torch.empty(b, lp, d, device=dev, dtype=bf16)
        vamax = torch.empty(b // group, h, device=dev)
        want = K.attention_int8_plain(*sl, h, length, group)
        bound, bound_by, _, _ = bound_ms(4 * b * lp * d * 2, {"int8": 4 * b * lp * length * d})
        for source, libs in builds.items():
            row = {"source": source, "geometry": tag, "batch": b, "padded_rows": lp,
                   "length": length, "D": d, "heads": h, "group": group,
                   "bound_ms": bound, "bound_by": bound_by,
                   "amax_bound_ms": bound_ms(b * lp * d * 2, 0)[0]}
            for which, lib in libs.items():
                def run(lib=lib):
                    _build.check(lib.attention_int8(
                        K._DTYPES[bf16], sl[0].data_ptr(), sl[1].data_ptr(), sl[2].data_ptr(),
                        lp * ld, dh, ld, out.data_ptr(), lp * d, dh, d, b, lp, h, dh, length,
                        group, vamax.data_ptr(), dh ** -0.5 / 127.0,
                        torch.cuda.current_stream().cuda_stream), "attention_int8")
                row[f"{which}_device_ms"] = device_ms(run, runs=20, warmup=3)
                if which == "whole":
                    row["whole_ms"] = median_ms(run, runs=RUNS, warmup=1)
                    run()
                    torch.cuda.synchronize()
                    row["moved"] = int((out != want).sum())
                    row["max_abs_err"] = float((out.float() - want.float()).abs().max())
            if "amax_device_ms" in row:
                row["core_device_ms"] = row["whole_device_ms"] - row["amax_device_ms"]
            result["runs"][f"{tag}:{source}"] = row
        del qkv, sl, out, want
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

"""Measure the card's achievable int8 and bf16 GEMM peaks, and the port's
own GEMMs beside them (the port's counterpart of
``scripts/bench_int8_peak.py``).

Times ``steps`` N x N x N products, each consumed whole (summed into the
checksum) so that every step does the full work, and reports the best of
6 runs as TOP/s (int8) or TFLOP/s (bf16) with the checksum, in four forms:

- ``int8->int32``: int8 x int8 -> int32 through ``torch._int_mm`` (the
  library's product, as the JAX script measures XLA's);
- ``bf16->fp32``: bf16 operands, fp32 accumulation, ``torch.matmul``;
- ``gemm_int8_epilogue``: the port's K3.c kernel (``csrc/
  gemm_int8_epilogue.cu``, epilogue ``dequant_bias_f32``, unit scales and
  a zero bias, so its output is the int32 product in fp32);
- ``gemm_bias_epilogue``: the port's K2.b kernel (``csrc/
  gemm_bias_epilogue.cu``, epilogue ``bias``, a zero bias).

The library lines bound what any W8A8 or bf16 kernel can reach on this
card; the kernel lines say whether the kernel or the card sets the floor.
On the card each product is timed with CUDA events around it alone (the
summing kernel that consumes it runs outside the events); on the CPU
(``--device cpu``) the library lines and the kernels' plain versions run,
timed by the host clock, and each line says which it ran.  The int8
checksum is held exactly to the product's int64 sum, K3.c's output to
``_int_mm``'s element for element, and K2.b's to ``torch.matmul``'s at
bf16's bars (max |diff| <= K2B_MAX_REL of max |matmul|, each row's cosine
>= K2B_MIN_COSINE); a miss exits 1.

    python -m protoclip_tpu_torch.scripts.bench_int8_peak [N] [steps] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

RUNS = 6
# K2.b against torch.matmul: both round an fp32 accumulation to bf16
K2B_MAX_REL = 1e-2
K2B_MIN_COSINE = 0.9999


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("n", nargs="?", type=int, default=8192)
    parser.add_argument("steps", nargs="?", type=int, default=20)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    return parser


def time_steps(torch, device, product, consume, steps: int):
    """(seconds of the ``steps`` products, the last product): each product
    between two CUDA events on the card (summed over the steps), or by the
    host clock on the CPU; each is consumed after its end event."""
    if device.type != "cuda":
        total, out = 0.0, None
        for _ in range(steps):
            t0 = time.perf_counter()
            out = product()
            total += time.perf_counter() - t0
            consume(out)
        return total, out
    events = []
    out = None
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = product()
        end.record()
        consume(out)
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / 1e3, out


def run_form(torch, device, tag, product, acc_dtype, n, steps, ran):
    """Best of RUNS timed runs (after one untimed run, which also builds a
    kernel); returns the form's record and the last product."""
    checksum = torch.zeros((), dtype=acc_dtype, device=device)

    def consume(out):
        checksum.add_(out.sum(dtype=acc_dtype))

    t0 = time.perf_counter()
    time_steps(torch, device, product, consume, 1)
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(RUNS):
        checksum.zero_()
        seconds, out = time_steps(torch, device, product, consume, steps)
        times.append(seconds)
    best = min(times)
    ops = 2.0 * n * n * n * steps
    cs = checksum.item()
    print(f"{tag} [{ran}]: {best * 1000:.1f} ms/{steps}x{n}^3 -> "
          f"{ops / best / 1e12:.1f} Tops/s (checksum {cs:.1f}, first call {first_s:.1f}s)",
          flush=True)
    return {"ran": ran, "ms": best * 1e3, "ms_per_product": best * 1e3 / steps,
            "tops": ops / best / 1e12, "checksum": cs, "first_call_s": first_s,
            "runs_ms": [t * 1e3 for t in times]}, out


def exact_product_sum(a, b) -> int:
    """The sum of the elements of ``a @ b`` for int8 ``a`` (M, K), ``b``
    (K, N), exactly: sum_k (sum_i a[i, k]) (sum_j b[k, j]) in int64."""
    cols = a.cpu().numpy().astype(np.int64).sum(axis=0)
    rows = b.cpu().numpy().astype(np.int64).sum(axis=1)
    return int(cols @ rows)


def bf16_agreement(got, ref):
    """(max |got - ref| over max |ref|, the least cosine of a row) of two
    products, in fp32."""
    got, ref = got.float(), ref.float()
    rel = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    cos = (got * ref).sum(-1) / (got.norm(dim=-1) * ref.norm(dim=-1)).clamp_min(1e-30)
    return rel, float(cos.min())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from protoclip_tpu_torch.device import resolve_device
    from protoclip_tpu_torch.ops import kernels as K

    device = resolve_device(args.device)
    n, steps = args.n, args.steps
    on_card = device.type == "cuda"
    timer = "cuda_events" if on_card else "host_clock"
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randint(-127, 128, (n, n), generator=gen, device=device, dtype=torch.int8)
    # the second operand stored (N, K): K-major, the layout K3.c reads
    b_nk = torch.randint(-127, 128, (n, n), generator=gen, device=device, dtype=torch.int8)
    b = b_nk.t()
    a16, b16 = a.to(torch.bfloat16), b.contiguous().to(torch.bfloat16)
    ones = torch.ones(n, dtype=torch.float32, device=device)
    zeros = torch.zeros(n, dtype=torch.float32, device=device)
    zeros16 = zeros.to(torch.bfloat16)
    kernel = "kernel" if on_card else "plain"

    forms = {}
    forms["int8->int32"], int_out = run_form(
        torch, device, "int8->int32", lambda: torch._int_mm(a, b), torch.int64, n, steps,
        "library: torch._int_mm")
    forms["bf16->fp32"], mm_out = run_form(
        torch, device, "bf16->fp32", lambda: torch.matmul(a16, b16), torch.float64, n, steps,
        "library: torch.matmul")
    forms["gemm_int8_epilogue"], k3c_out = run_form(
        torch, device, "gemm_int8_epilogue", lambda: K.gemm_int8_epilogue(
            a, ones[:, None], b_nk, ones, zeros, "dequant_bias_f32", torch.bfloat16),
        torch.float64, n, steps, f"{kernel}: K3.c, csrc/gemm_int8_epilogue.cu")
    forms["gemm_bias_epilogue"], k2b_out = run_form(
        torch, device, "gemm_bias_epilogue",
        lambda: K.gemm_bias_epilogue(a16, b16, zeros16, "bias"), torch.float64, n, steps,
        f"{kernel}: K2.b, csrc/gemm_bias_epilogue.cu")

    # the int8 checksum against the exact int64 sum of the product's
    # elements, sum_k colsum(a)[k] * rowsum(b)[k] (no product needed); K3.c's
    # output (the int32 product rounded to fp32 once) against _int_mm's
    exact = steps * exact_product_sum(a, b)
    k3c_diff = float((k3c_out - int_out.float()).abs().max())
    k2b_rel, k2b_cos = bf16_agreement(k2b_out, mm_out)
    failures = []
    if int(forms["int8->int32"]["checksum"]) != exact:
        failures.append(f"int8 checksum {forms['int8->int32']['checksum']} != {exact}")
    if k3c_diff != 0.0:
        failures.append(f"gemm_int8_epilogue off torch._int_mm by {k3c_diff}")
    if not (k2b_rel <= K2B_MAX_REL and k2b_cos >= K2B_MIN_COSINE):
        failures.append(f"gemm_bias_epilogue off torch.matmul: max |diff| {k2b_rel} of max "
                        f"|matmul| (bar {K2B_MAX_REL}), row cosine {k2b_cos} "
                        f"(bar {K2B_MIN_COSINE})")
    print(json.dumps({
        "metric": "gemm_peak", "device": torch.cuda.get_device_name(device) if on_card
        else "cpu", "n": n, "steps": steps, "runs": RUNS, "timer": timer,
        "int8_checksum_exact": exact, "gemm_int8_epilogue_vs_int_mm_max_abs_diff": k3c_diff,
        "gemm_bias_epilogue_vs_matmul_max_rel_diff": k2b_rel,
        "gemm_bias_epilogue_vs_matmul_min_row_cosine": k2b_cos,
        "forms": forms, "ok": not failures}), flush=True)
    if failures:
        print("FAIL: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

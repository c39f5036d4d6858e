"""Split the int8 GEMM's time on the card into main loop and epilogue.

    python -m protoclip_tpu_torch.scripts.gemm_int8_split [--source FILE.cu]

Compiles ``FILE.cu`` (default: the package's ``csrc/gemm_int8_epilogue.cu``)
twice with nvcc, as is and with ``-DGEMM_MAIN_LOOP_ONLY``, which stops
the kernel after its products, and times both builds with CUDA events at
the four GEMMs of a ViT-B/16 image block at B=256 (M = 256 x 197) and of a
text block at B=1024 (M = 1024 x 77, D = 512), each with its K3 epilogue
in bf16, plus fc with the fp32 epilogue that has no QuickGELU (the same
bytes: what the GELU's ``expf`` and IEEE division cost).  ``torch._int_mm``
on the same operands times a library main loop alone.  Prints the card's
name and power limit, then one JSON line: per GEMM the whole kernel, its
main loop, their difference (the epilogue), the bound of the epilogue's
bytes (fp32 or bf16 output written, bf16 residual read) and whether the
whole kernel's output equals its plain version bit for bit.  Needs CUDA;
raises without it.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path
from typing import Optional

import torch

from protoclip_tpu_torch.ops import _build
from protoclip_tpu_torch.ops import kernels as K

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, the data sheet's rate
RUNS = 20
SPIN_CYCLES = 20_000_000  # ~10 ms of a spinning kernel at the H100's clock
SHAPES = {  # block: (M, D, {GEMM with K = D: (N, epilogue)}); proj (K = 4D) is added
    "image": (256 * 197, 768, {"qkv": (2304, "dequant_bias"),
                               "out_proj": (768, "dequant_bias_residual"),
                               "fc": (3072, "dequant_bias_gelu"),
                               "fc_nogelu": (3072, "dequant_bias_f32")}),
    "text": (1024 * 77, 512, {"qkv": (1536, "dequant_bias"),
                              "out_proj": (512, "dequant_bias_residual"),
                              "fc": (2048, "dequant_bias_gelu")}),
}


def build(source: Path, define: Optional[str] = None,
          entry: str = "gemm_int8_epilogue") -> ctypes.CDLL:
    """``source`` alone, with ``-D<define>`` where given, into a library of
    its own under ``build/split/``, with ``entry``'s C signature declared."""
    out_dir = _build.BUILD_DIR.parent / "split"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(str(source.resolve()).encode()).hexdigest()[:8]
    lib = out_dir / f"{source.stem}_{tag}{'_' + define.lower() if define else ''}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", f"-I{source.parent}",
           f"-I{_build.CSRC_DIR}", *([f"-D{define}"] if define else []),
           str(source), "-o", str(lib)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{done.stdout}{done.stderr}")
    dll = ctypes.CDLL(str(lib))
    fn = getattr(dll, entry)
    fn.restype, fn.argtypes = _build._SIGNATURES[entry]
    return dll


def median_ms(fn, runs: int = RUNS) -> float:
    """Median CUDA-event time of one call queued behind a spinning kernel,
    so the host's launch overhead is hidden: the device's time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[runs // 2]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, default=_build.CSRC_DIR / "gemm_int8_epilogue.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("gemm_int8_split needs an NVIDIA card (CUDA is not available)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = {"whole": build(args.source), "main_loop": build(args.source, "GEMM_MAIN_LOOP_ONLY")}
    g = torch.Generator(device="cuda").manual_seed(0)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    result = {"source": str(args.source), "nvidia_smi": smi, "gemms": {}}
    for tag, (m, d, gemms) in SHAPES.items():
        gemms = {**gemms, "proj": (d, "dequant_bias_residual")}
        for name, (n, epi) in gemms.items():
            k = 4 * d if name == "proj" else d
            a = torch.randint(-127, 128, (m, k), device=dev, dtype=torch.int8, generator=g)
            w = torch.randint(-127, 128, (n, k), device=dev, dtype=torch.int8, generator=g)
            a_s = torch.rand(m, 1, device=dev, generator=g) * 1e-2
            w_s = torch.rand(n, device=dev, generator=g) * 1e-2
            bias = torch.randn(n, device=dev, generator=g)
            res = torch.randn(m, n, device=dev, generator=g).to(bf16) if "residual" in epi else None
            out_bytes = 4 if epi in K._FP32_OUT_EPILOGUES else 2
            out = torch.empty(m, n, device=dev, dtype=torch.float32 if out_bytes == 4 else bf16)
            row = {"M": m, "K": k, "N": n, "epilogue": epi}
            for which, lib in libs.items():
                def run(lib=lib):
                    _build.check(lib.gemm_int8_epilogue(
                        K._DTYPES[bf16], a.data_ptr(), a_s.data_ptr(), w.data_ptr(),
                        w_s.data_ptr(), bias.data_ptr(), None if res is None else res.data_ptr(),
                        out.data_ptr(), m, n, k, K._INT8_EPILOGUES[epi],
                        torch.cuda.current_stream().cuda_stream), "gemm_int8_epilogue")
                row[f"{which}_ms"] = median_ms(run)
            row["epilogue_ms"] = row["whole_ms"] - row["main_loop_ms"]
            run(libs["whole"])
            want = K.gemm_int8_epilogue_plain(a, a_s, w, w_s, bias, epi, bf16, res)
            torch.cuda.synchronize()
            row["bit_exact"] = bool(torch.equal(out, want))
            del want
            row["epilogue_bytes_bound_ms"] = (m * n * (out_bytes + (2 if res is not None else 0))
                                              / PEAK_BYTES_PER_S * 1e3)
            row["int_mm_ms"] = median_ms(lambda: torch._int_mm(a, w.t()))
            result["gemms"][f"{tag}.{name}"] = row
            del a, w, res, out
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

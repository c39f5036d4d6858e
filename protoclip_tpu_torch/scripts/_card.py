"""What the card tools share: the H100's peaks and the bounds worked from
them, the device timers, the side build of one kernel source, and the
rules that hold a kernel against its plain version.

``chip_smoke.py``, the probes under ``scripts/`` (``gemm_int8_split``,
``attention_int8_split``, ``fp32_kernels``) and ``tests/test_torch_cuda.py``
import these; none keeps a copy.  Nothing here needs a card until a timer or
the side build is called.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path
from typing import Optional

import torch

from protoclip_tpu_torch.ops import _build

# Published H100 SXM peaks (NVIDIA data sheet, dense): bound = max(bytes /
# memory rate, flops / compute rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

TIME_RUNS = 12
SPIN_CYCLES = 20_000_000  # ~10 ms of a spinning kernel at the H100's clock


def median_ms(fn, runs: int = TIME_RUNS, warmup: int = 2, spin_cycles: int = 0) -> float:
    """Median of per-run CUDA-event times of one call of ``fn`` after
    ``warmup`` calls; with ``spin_cycles``, each call enqueued behind a
    spinning kernel of that many cycles (``torch.cuda._sleep``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin_cycles:
            torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, runs: int = TIME_RUNS, warmup: int = 1,
              spin_cycles: int = SPIN_CYCLES) -> float:
    """:func:`median_ms` with each call enqueued behind a spinning kernel:
    the host has issued every launch of the call before the start event
    runs, so the host's time to reach the launches, which plain
    :func:`median_ms` includes (most of it for a kernel shorter than its
    Python wrapper), is hidden and the time is the device's, as long as
    the spin outlasts the host's issue time."""
    return median_ms(fn, runs, warmup, spin_cycles)


def bound_ms(n_bytes, ops, dtype="bfloat16"):
    """(least ms, what bounds it, bytes ms, operations ms).  ``ops`` is a
    count in ``dtype`` or a {dtype: count} map, each at its peak rate."""
    ops = ops if isinstance(ops, dict) else {dtype: ops}
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = sum(n / PEAK_FLOPS[dt] for dt, n in ops.items()) * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations"), \
        by_bytes, by_ops


def attention_flops(b, l, d, causal):
    pairs = l * (l + 1) // 2 if causal else l * l  # keys a query attends
    return 4 * b * pairs * d


def k2_work(b, l, d, causal, dtype="bfloat16"):
    """{entry: (bytes, operations)} of K2's kernels and entries at a block
    of batch ``b``, length ``l`` and width ``d`` with activations in
    ``dtype`` (bf16: 2 bytes a value, fp32: 4): each input read once and
    each output written once, LayerNorm parameters in fp32, the MLP 4d
    wide, and the flops of the four products and of the attention's two."""
    vb = 4 if dtype == "float32" else 2
    m = b * l
    gemm = {"qkv": (d, 3 * d, False), "out_proj": (d, d, True), "fc": (d, 4 * d, False),
            "proj": (4 * d, d, True)}
    attn = (4 * b * l * d * vb, attention_flops(b, l, d, causal))
    work = {"layernorm_rows": (2 * m * d * vb + 2 * d * 4, 8 * m * d)}
    for name, (kk, nn, res) in gemm.items():
        work[f"gemm_bias_epilogue.{name}"] = (
            (m * kk + kk * nn + nn + m * nn * (2 if res else 1)) * vb, 2 * m * kk * nn)
    work.update({"attention_packed": attn, "fused_attention_packed": attn, "fused_attention": attn,
                 "fused_transformer_block": ((2 * m * d + 12 * d * d + 9 * d) * vb + 4 * d * 4,
                                             24 * m * d * d + attn[1])})
    return work


def build(source: Path, entry: str, define: Optional[str] = None) -> ctypes.CDLL:
    """``source`` alone, with ``-D<define>`` where given, into a library of
    its own under ``build/split/``, with ``entry``'s C signature declared:
    a kernel file's other builds (another commit's source, a ``csrc/``
    ``#ifdef`` hook) beside the package's library."""
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


# -- a kernel against its plain version ---------------------------------------------

# Acceptance bars for a kernel against its plain version on the card:
# max|diff| / max|plain| and the flattened cosine.
BARS = {"bfloat16": (1e-2, 0.9999), "float32": (1e-5, 0.9999)}
# K3's block: a quantization step is amax/127, and LayerNorm and attention
# sum in another order than the plain version, so an int8 code on a rounding
# tie may move one step; K2's fp32 bar does not apply.
INT8_BLOCK_BARS = {"bfloat16": (2e-2, 0.9999), "float32": (1e-2, 0.99999)}
# EVA02-CLIP-bigE's post-norm block: each half ends in T(x + T(LN(branch))),
# so a step that the first half's output moves on a rounding tie carries
# into the second half's sum, and an output may lie two bf16 steps from the
# plain version's: 2 * 2^-7 of a value in [2^e, 2^(e+1)), at most 2^-6 of
# max|plain|.  At the bank's batch (1024 x 257 rows, 471 M outputs) the
# largest gap reads two steps at the top of the range (1.16% of max|plain|,
# cosine 0.999995), where the bf16 bars' 1e-2 admits one.
POSTNORM_BLOCK_BARS = (2.0 ** -6, 0.9999)
# An EVA02 kernel or mode against its plain version: within the bf16 bars,
# and bit for bit equal in at least this share of its outputs.  A
# LayerNorm's fp32 statistics, rsqrtf, and an epilogue's exp or erf round
# in another order than the plain version, so an output on a rounding tie
# moves a bf16 step now and then (at most 1 in 38,000 on an H100); on
# inputs where the products sum exactly, a wrong mode moves a large share
# (tanh-GELU 5.7%, LayerNorm statistics over 2736 lanes 23%).
EVA_EQUAL_SHARE = 0.999


def compare(kernel_out, plain_out):
    """(max|diff| / max|plain|, flattened cosine, max|diff|)."""
    a = kernel_out.double().flatten()
    b = plain_out.double().flatten()
    diff = float((a - b).abs().max())
    rel = diff / max(float(b.abs().max()), 1e-30)
    cos = float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-300))
    return rel, cos, diff


def max_abs_err(out, ref):
    """The largest |difference| over one output or a tuple of them."""
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    return max(float((o.double() - r.double()).abs().max()) for o, r in zip(outs, refs))


def ulp_steps(out, ref):
    """|out - ref| in units in the last place of their dtype (bf16 or fp32),
    counted across zero: the distance of their bit patterns in order."""
    int_t, width = (torch.int16, 16) if out.dtype == torch.bfloat16 else (torch.int32, 32)

    def ordered(t):
        bits = t.contiguous().view(int_t).long()
        return torch.where(bits >= 0, bits, -(bits + (1 << (width - 1))))

    return (ordered(out) - ordered(ref)).abs()


def bars_agreement(out, ref, bars):
    """Within (rel, cos) bars: max|diff| / max|plain| below the first,
    flattened cosine above the second."""
    rel, cos, diff = compare(out, ref)
    lim_rel, lim_cos = bars
    return {"rel": rel, "cos": cos, "max_abs_err": diff, "ok": rel < lim_rel and cos > lim_cos}


def exact_agreement(outs, refs):
    """Bit-exact: every output tensor equal to the plain version's."""
    equal = all(torch.equal(o, r) for o, r in zip(outs, refs))
    return {"bit_exact": equal, "max_abs_err": max_abs_err(tuple(outs), tuple(refs)),
            "ok": equal}


def ln_quant_agreement(got, want, bf16_stats=False):
    """LN statistics sum in another order: int8 codes equal in >= 99.9% of
    entries, never more than one step apart, scales within 1e-6.  With
    ``bf16_stats`` the mean and variance are rounded to bf16, and a sum on
    a rounding tie moves its row's scale by up to one bf16 ulp: scales
    within 1e-6 in >= 99.9% of rows and none more than 2^-7 apart."""
    (q, sc), (rq, rsc) = got, want
    step = (q.int() - rq.int()).abs()
    equal_share = float((step == 0).float().mean())
    rel = (sc - rsc).abs() / rsc
    scale_rel = float(rel.max())
    scale_share = float((rel <= 1e-6).float().mean())
    scales_ok = scale_rel <= 1e-6 or (bf16_stats and scale_share >= 0.999
                                      and scale_rel <= 2.0 ** -7)
    return {"max_step": int(step.max()), "equal_share": equal_share, "scale_rel": scale_rel,
            "scale_equal_share": scale_share, "max_abs_err": float(step.max()),
            "ok": int(step.max()) <= 1 and equal_share >= 0.999 and scales_ok}


def ulp_agreement(out, ref):
    """QuickGELU op by op in T: the card's expf and PyTorch's may differ by
    an fp32 ulp before rounding, so >= 99.9% of outputs equal and none more
    than one ulp of T off."""
    steps = ulp_steps(out, ref)
    equal_share = float((steps == 0).float().mean())
    return {"max_ulps": int(steps.max()), "equal_share": equal_share,
            "max_abs_err": max_abs_err(out, ref),
            "ok": int(steps.max()) <= 1 and equal_share >= 0.999}


def int8_attention_agreement(out, ref, step):
    """``attention_int8``: bit-exact, or, where the softmax sums in another
    order than the plain version move a weight code a step on a rounding
    tie, no output more than two steps (``step`` = v_amax / 127) off and a
    cosine above 0.9999; ``moved`` counts the outputs that differ."""
    _, cos, diff = compare(out, ref)
    exact = bool(torch.equal(out, ref))
    return {"bit_exact": exact, "moved": int((out != ref).sum()), "max_abs_err": diff,
            "max_steps": diff / step, "cos": cos,
            "ok": exact or (diff <= 2 * step and cos > 0.9999)}


def int8_attention_rule(v):
    """The rule of :func:`agreement` for ``attention_int8`` with v: one step
    is v's largest |value| / 127 (each group's v_amax is at most that)."""
    return ("int8_attention", float(v.abs().max()) / 127)


def eva_agreement(out, ref):
    """:data:`EVA_EQUAL_SHARE`'s rule: the bf16 bars, and the share of
    outputs bit for bit equal."""
    got = bars_agreement(out, ref, BARS["bfloat16"])
    share = float((out == ref).float().mean())
    return {**got, "equal_share": share, "ok": got["ok"] and share >= EVA_EQUAL_SHARE}


def agreement(out, ref, rule):
    """``out`` against ``ref`` by ``rule``: "exact", "ulp", "ln_quant",
    "ln_quant_bf16_stats", "eva", ("int8_attention", step) or a (rel, cos)
    pair of bars.  Tuples are a kernel's several outputs."""
    if rule == "exact":
        return exact_agreement(*((out, ref) if isinstance(out, tuple) else ([out], [ref])))
    if isinstance(rule, tuple) and rule[0] == "int8_attention":
        return int8_attention_agreement(out, ref, rule[1])
    if rule in ("ln_quant", "ln_quant_bf16_stats"):
        return ln_quant_agreement(out, ref, bf16_stats=rule == "ln_quant_bf16_stats")
    if rule == "ulp":
        return ulp_agreement(out, ref)
    if rule == "eva":
        return eva_agreement(out, ref)
    return bars_agreement(out, ref, rule)


def exact_sum_values(g, shape, steps, step):
    """bf16 values ``k * step``, k uniform in [-steps, steps], drawn by
    ``g`` on its device.
    With ``step`` a power of two, a product of two such values needs few
    bits and a sum of a few thousand of them is exact in fp32 in any
    order, so a GEMM on them reaches its epilogue with the plain version's
    accumulator bit for bit."""
    k = torch.randint(-steps, steps + 1, shape, device=g.device, generator=g)
    return (k * step).to(torch.bfloat16)

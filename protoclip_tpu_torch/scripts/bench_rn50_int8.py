"""Can an int8 product beat the bf16 convolution at RN50's shapes on this
card?  (The port's counterpart of ``scripts/bench_rn50_int8.py``.)

RN50's bf16 encode spends a small share of its time in ``F.conv2d``
(cuDNN, channels_last, the layout ``models/resnet.py`` keeps).  This
probe asks whether rewriting its convolutions as int8 products, with all
the quantization's overhead included, is worth anything at the network's
hot shapes.  Each shape is timed four ways:

- ``bf16 conv``: ``F.conv2d`` on channels_last bf16 activations with OIHW
  kernels stored channels_last, as ``models/resnet.py`` runs it;
- ``int8 matmul (+quant+rescale)``: im2col (``F.unfold``; a 1 x 1 conv is
  a reshape of the NHWC rows), per-row dynamic quantization (``quant_rows``,
  K3.b), then the int8 product with its dequantizing epilogue
  (``gemm_int8_epilogue``, K3.c, ``dequant_bias_f32``: acc * row scale *
  column scale, in fp32);
- ``int8 matmul (pre-quantized input)``: the activations quantized once
  beforehand with one scale for the tensor (so a patch's rows keep one
  scale and the epilogue dequantizes exactly), im2col at 1 byte an
  element, then K3.c;
- ``int8 product (torch._int_mm)``: the library's int8 product on the same
  quantized rows, the library line.

The int8 products compute the real convolution: ``F.unfold`` orders a
patch (C, kh, kw), which matches OIHW kernels reshaped to (cout,
cin*kh*kw).  Each is held to the bf16 convolution at a cosine >= 0.99.
layer4.conv2's im2col rows are 9 x 512 = 4608 wide, wider than
``quant_rows.cu`` takes (4096): that shape has no dynamic line (its JSON
line gives the reason), and the dynamic sum and speed-up are over the
shapes that K3.b quantized, against their bf16 convs.

Timed per step with CUDA events (``bench_int8_peak.time_steps``: the best
of 5 runs of ``steps`` steps; each step's output is summed outside its
events); on the CPU (``--device cpu``) the plain versions run, timed by the
host clock.

    python -m protoclip_tpu_torch.scripts.bench_rn50_int8 [batch] [steps] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

RUNS = 5
MIN_COSINE = 0.99  # an int8 product against the bf16 convolution

# RN50 hot shapes (width 64): (name, H = W, cin, cout, kernel).  conv2 of a
# stride-2 block runs at the pre-pool resolution.
SHAPES = [
    ("layer3.conv1 1x1", 14, 1024, 256, 1),
    ("layer3.conv2 3x3", 14, 256, 256, 3),
    ("layer3.conv3 1x1", 14, 256, 1024, 1),
    ("layer2.conv2 3x3", 28, 128, 128, 3),
    ("layer4.conv2 3x3", 7, 512, 512, 3),
    ("layer1.conv2 3x3", 56, 64, 64, 3),
    ("layer1.conv3 1x1", 56, 64, 256, 1),
]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("batch", nargs="?", type=int, default=256)
    parser.add_argument("steps", nargs="?", type=int, default=20)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    return parser


def im2col(x, ksize: int):
    """NCHW-indexed ``x`` (channels_last strides) -> (B*H*W, cin*k*k) rows,
    a patch ordered (C, kh, kw) as ``F.unfold`` orders it; a 1 x 1 conv is
    the NHWC rows themselves.  int8 has no ``F.unfold``: it is padded and
    its k*k shifted views stacked in the same order."""
    import torch
    import torch.nn.functional as F

    b, c, h, w = x.shape
    if ksize == 1:
        return x.permute(0, 2, 3, 1).reshape(-1, c)
    pad = ksize // 2
    if x.dtype != torch.int8:
        return F.unfold(x, ksize, padding=pad).transpose(1, 2).reshape(-1, c * ksize * ksize)
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, pad, pad, pad, pad))  # (B, H+2p, W+2p, C)
    taps = [xp[:, i:i + h, j:j + w] for i in range(ksize) for j in range(ksize)]
    return torch.stack(taps, dim=-1).reshape(-1, c * ksize * ksize)


def quant_weights(w):
    """OIHW kernel -> (int8 (cout, cin*k*k), fp32 column scales (cout,)):
    per output channel, as ``ops.kernels.quantize_block`` quantizes."""
    from protoclip_tpu_torch.ops.kernels import quantize_cols

    q, scale = quantize_cols(w.reshape(w.shape[0], -1).t())
    return q.t().contiguous(), scale.reshape(-1)


def best_ms(torch, device, fn, steps: int):
    """(best ms of RUNS runs of ``steps`` calls of ``fn``, its last output),
    after one untimed call (which also builds a kernel)."""
    from protoclip_tpu_torch.scripts.bench_int8_peak import time_steps

    sink = []
    fn()
    runs = [time_steps(torch, device, fn, lambda out: sink.append(out.sum(dtype=torch.float64)),
                       steps) for _ in range(RUNS)]
    return min(seconds for seconds, _ in runs) * 1e3, runs[-1][1]


def bench_shape(torch, device, name, b, hw, cin, cout, ksize, steps, gen) -> dict:
    import torch.nn.functional as F

    from protoclip_tpu_torch.ops import kernels as K

    pad = ksize // 2
    flops = 2.0 * b * hw * hw * cin * cout * ksize * ksize
    print(f"{name}: B={b} {hw}x{hw} {cin}->{cout} k={ksize} ({flops / 1e9:.1f} GFLOP)",
          flush=True)
    x = torch.randn((b, hw, hw, cin), generator=gen, device=device).to(torch.bfloat16)
    x = x.permute(0, 3, 1, 2)  # NCHW indexing, channels_last strides
    w = (torch.randn((cout, cin, ksize, ksize), generator=gen, device=device)
         * (cin * ksize * ksize) ** -0.5).to(torch.bfloat16)
    w = w.contiguous(memory_format=torch.channels_last)
    wq, wscale = quant_weights(w.float())
    bias = torch.zeros(cout, dtype=torch.float32, device=device)
    width = cin * ksize * ksize
    on_card = device.type == "cuda"
    if width > K.QUANT_MAX_WIDTH:
        quantizer = f"none: W={width} > {K.QUANT_MAX_WIDTH}, wider than quant_rows.cu takes"
    else:
        quantizer = "quant_rows (K3.b)" if on_card else "plain: the CPU"

    def conv_bf16():
        return F.conv2d(x, w, padding=pad)

    def int8_dyn():
        q, s = K.quant_rows(im2col(x, ksize))
        return K.gemm_int8_epilogue(q, s, wq, wscale, bias, "dequant_bias_f32", torch.bfloat16)

    # one scale for the whole tensor, taken once: a patch's rows share it
    x_scale = (x.float().abs().amax().clamp_min(K.QUANT_FLOOR) / 127.0).reshape(1)
    x_q = torch.round(x.float() / x_scale).clamp_(-127, 127).to(torch.int8)
    rows_q = im2col(x_q, ksize)
    row_scales = x_scale.expand(rows_q.shape[0], 1).contiguous()

    def int8_pre():
        return K.gemm_int8_epilogue(im2col(x_q, ksize), row_scales, wq, wscale, bias,
                                    "dequant_bias_f32", torch.bfloat16)

    def int_mm():
        return torch._int_mm(rows_q, wq.t())

    out = {"name": name, "batch": b, "hw": hw, "cin": cin, "cout": cout, "k": ksize,
           "gflop": flops / 1e9, "quantizer": quantizer,
           "int8_kernel": "gemm_int8_epilogue (K3.c)" if on_card else "plain: the CPU"}
    ref = None
    for key, tag, fn in (("bf16", "bf16 conv (F.conv2d, channels_last)", conv_bf16),
                         ("i8mm", "int8 matmul (+quant+rescale)", int8_dyn),
                         ("i8pre", "int8 matmul (pre-quantized input)", int8_pre),
                         ("int_mm", "int8 product (torch._int_mm)", int_mm)):
        if key == "i8mm" and width > K.QUANT_MAX_WIDTH:
            print(f"  {tag:42s} left out: {quantizer}", flush=True)
            out[key] = out[f"{key}_cosine_vs_bf16_conv"] = None
            continue
        ms, result = best_ms(torch, device, fn, steps)
        per_step = ms / steps
        print(f"  {tag:42s} {per_step:8.3f} ms/step  "
              f"{flops / (per_step / 1e3) / 1e12:7.1f} Top/s", flush=True)
        out[key] = per_step
        if key == "bf16":
            ref = result.permute(0, 2, 3, 1).reshape(-1, cout).double()
        elif key != "int_mm":
            got = result.double()
            out[f"{key}_cosine_vs_bf16_conv"] = float(
                (got * ref).sum() / (got.norm() * ref.norm()))
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from protoclip_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    print(f"devices: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}
    for name, hw, cin, cout, k in SHAPES:
        results[name] = bench_shape(torch, device, name, args.batch, hw, cin, cout, k,
                                    args.steps, gen)

    tot = {key: sum(r[key] for r in results.values()) for key in ("bf16", "i8pre", "int_mm")}
    # the dynamic line over the shapes that K3.b quantized, against their convs
    dyn = [r for r in results.values() if r["i8mm"] is not None]
    left_out = [name for name, r in results.items() if r["i8mm"] is None]
    tot["i8mm"] = sum(r["i8mm"] for r in dyn)
    tot["bf16_i8mm_shapes"] = sum(r["bf16"] for r in dyn)
    print(
        f"\nsum over probed shapes: bf16 {tot['bf16']:.2f} ms | int8 dyn-quant "
        f"{tot['i8mm']:.2f} ms ({tot['bf16_i8mm_shapes'] / tot['i8mm']:.2f}x over {len(dyn)} "
        f"shapes{'; left out: ' + ', '.join(left_out) if left_out else ''}) | int8 pre-quant "
        f"{tot['i8pre']:.2f} ms ({tot['bf16'] / tot['i8pre']:.2f}x) | torch._int_mm "
        f"{tot['int_mm']:.2f} ms ({tot['bf16'] / tot['int_mm']:.2f}x)"
    )
    low = [f"{name} {key} cosine {r[key + '_cosine_vs_bf16_conv']:.5f}"
           for name, r in results.items() for key in ("i8mm", "i8pre")
           if r[key] is not None and r[key + "_cosine_vs_bf16_conv"] < MIN_COSINE]
    print(json.dumps({
        "metric": "rn50_int8", "batch": args.batch, "steps": args.steps, "runs": RUNS,
        "timer": "cuda_events" if device.type == "cuda" else "host_clock",
        "shapes": list(results.values()),
        "sum_ms": tot, "i8mm_left_out": left_out,
        "speedup_dyn": tot["bf16_i8mm_shapes"] / tot["i8mm"],
        "speedup_pre": tot["bf16"] / tot["i8pre"], "speedup_int_mm": tot["bf16"] / tot["int_mm"],
        "min_cosine": MIN_COSINE, "ok": not low}), flush=True)
    if low:
        print("FAIL: int8 products off the convolution: " + "; ".join(low), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

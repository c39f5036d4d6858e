"""Run one cell once and print its result as the last line of stdout.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and inputs from the seed, the program built and every
shape of the cell's traffic warmed) counts from this process's start to
the opening of the window.  After the window the program's state is
freed and the plain reference checks what the timed path produced.  The
numbers compared, each beside its limit, are the last lines on stderr and
the last key of the result.  Without a card, or with fewer cards than the
cell asks for, or with JAX or the JAX package loaded, the run exits
non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    bench = harness.Bench()
    chips = bench.workload(args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t0=T0, bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once, on the card this process finds.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (imports, the CUDA context, the
kernels' build or load, the seeded inputs and weights, the warm-up) is
timed from process start; then the cell's loop runs for ``--seconds``;
then what the window produced is held against the plain reference.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its limit.
The last lines of standard error are the same numbers.

Without a CUDA card, or with fewer than the cell asks for, the run exits
non-zero and prints no result.  So it does if a module of JAX or of the
JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# compile caches at fixed paths inside the checkout: only a cell's first
# run there builds
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache", "torch_extensions")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from benchmark import harness

    try:
        result, lines = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                    T_START)
    except harness.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

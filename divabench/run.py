"""Run one cell of the benchmark once and print its result line.

    python3 divabench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell named in ``BENCHMARK.json``, sets up, measures for
``--seconds``, checks a sample of the window's outputs against the plain
reference, and prints the checked numbers beside their limits as the last
lines of standard error and one JSON object as the last line of standard
output.  Exits 2 without a result where the machine lacks the cards the
cell asks for, 3 where the program is not in the checkout, 4 where a
forbidden module (JAX or the JAX package) was loaded, 1 on any other
failure.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("divabench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 3
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("USE_FLAX", "0")
    from divabench import harness
    harness._cache_dirs(ROOT)
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start=T_START)
    except harness.NoDevice as e:
        print(f"divabench: {e}", file=sys.stderr)
        return 2
    loaded = harness._forbidden_loaded()
    if loaded:
        print("divabench: loaded in the reporting process: "
              + ", ".join(loaded), file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

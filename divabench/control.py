"""Readings of a cell's compared numbers: the program's and the control's.

    python3 divabench/control.py --workload <name> --seeds 1,2,3

For each seed, in one process on the card: the cell's set-up and warm-up,
one unit of the timed path, then the program's numbers against the float32
reference, and each control's: the reference computed in bfloat16 (the
precision below the configuration's float32) put in the program's place,
and the entry's own controls where it has them (``controls``: the
reference in the program's place with one guarantee broken).  A limit lies
above the program's largest reading and below the smallest of a control
that it is to catch.  The benchmark's own runs do not run this; it prints
one JSON line a seed and a summary line.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from divabench import harness
    harness._cache_dirs(ROOT)
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell.load(manifest, args.workload)
    print(json.dumps(readings(cell, [int(s) for s in args.seeds.split(",")])),
          flush=True)
    return 0


def controls(entry, state, unit) -> dict:
    """The entry's controls by name, each an output for ``compare``; the
    bfloat16 reference alone where the entry defines none."""
    import torch
    if hasattr(entry, "controls"):
        return entry.controls(state, unit)
    return {"bfloat16": entry.reference_unit(state, unit, torch.bfloat16)}


def readings(cell, seeds, device=None) -> dict:
    """{"program": {number: [reading a seed]}, "controls": {name: {...}}}."""
    import torch
    from divabench import harness
    if device is None:
        if not torch.cuda.is_available():
            raise harness.NoDevice("torch.cuda.is_available() is false")
        device = "cuda:0"
    device = torch.device(device)
    entry = harness.entry_module(cell.traffic["entry"])
    out = {"program": {}, "controls": {}, "seconds": []}
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = harness._ctx(cell, seed, device)
        state = entry.setup(ctx)
        unit = entry.step(state, 0)
        entry.release(state)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = entry.reference_unit(state, unit, torch.float32)
        prog = entry.compare(unit, ref)
        ctls = {name: entry.compare(c, ref)
                for name, c in controls(entry, state, unit).items()}
        for k, v in prog.items():
            out["program"].setdefault(k, []).append(v)
        for name, nums in ctls.items():
            for k, v in nums.items():
                out["controls"].setdefault(name, {}).setdefault(k, []) \
                    .append(v)
        out["seconds"].append(time.perf_counter() - t0)
        print(json.dumps({"seed": seed, "program": prog, "controls": ctls,
                          "seconds": out["seconds"][-1]}), flush=True)
        del state, unit, ref
    return out


if __name__ == "__main__":
    sys.exit(main())

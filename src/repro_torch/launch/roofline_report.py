"""Render the roofline tables from the dry run's records, on the H100 (the
counterpart of ``repro.launch.roofline_report``: the same columns and the
same analytic compute term, with the H100's peaks and its 80 GB).

    PYTHONPATH=src python -m repro_torch.launch.roofline_report [--dir single]
    PYTHONPATH=src python -m repro_torch.launch.roofline_report --summary

Without ``--dir`` it renders both meshes' tables.  Each roofline table is
followed by the per-rank memory peaks and their parts, which the roofline
table's "state GB/chip" (arguments + outputs - aliases, the reference's
measure) does not show.  ``--summary``: one row a cell that ran, both
meshes side by side (the three terms, the dominant one, the peak).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.roofline import (HBM_BW, INTER_NODE_BW, NVLINK_BW, PEAK_FLOPS,
                                         PEAK_FLOPS_BY_DTYPE)

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
HBM_GB = 80  # H100 SXM per card
PARTS = ("state", "gathered", "activations", "temporaries", "cache", "batch")


def load(mesh_dir: str):
    recs = []
    for f in sorted((OUT_DIR / mesh_dir).glob("*.json")):
        recs.append(json.loads(f.read_text()))
    return recs


def fmt_row(r) -> str:
    if r["status"] != "ok":
        return (f"| {r['arch']} | {r['shape']} | — | — | — | — | — | skip | — | — | "
                f"{r['reason'].split(':')[0]} |")
    t = r["roofline"]
    mem = r["memory"]
    hbm_gb = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
              - mem["alias_size_in_bytes"]) / 1e9
    # analytic compute term: records store MODEL_FLOPS = 6*N_active*D (train
    # fwd+bwd); inference steps execute only the forward pass (2*N*D = /3)
    mult = 1.0 if r["shape"].startswith("train") else (1.0 / 3.0)
    mf = r["model_flops"] * mult
    t_ana = mf / (r["n_chips"] * PEAK_FLOPS)
    useful = (mf / r["n_chips"]) / max(r["flops_per_device"], 1e-9)
    return ("| {arch} | {shape} | {tc:.3f} | {ta:.3f} | {tm:.3f} | {tcol:.3f} | {dom} | "
            "{frac:.2f} | {useful:.1f} | {hbm:.1f} | {note} |").format(
        arch=r["arch"], shape=r["shape"], tc=t["t_compute_s"], ta=t_ana,
        tm=t["t_memory_s"], tcol=t["t_collective_s"], dom=t["dominant"],
        frac=t["roofline_frac"], useful=useful, hbm=hbm_gb,
        note="fits" if hbm_gb <= HBM_GB else f"needs {hbm_gb/HBM_GB:.1f}x HBM")


def fmt_peak_row(r) -> str:
    if r["status"] != "ok":
        return f"| {r['arch']} | {r['shape']} | — |" + " — |" * len(PARTS) + " skip |"
    mem = r["memory"]
    peak = mem["peak_bytes"] / 1e9
    parts = " | ".join(f"{mem['peak_parts'].get(p, 0) / 1e9:.1f}" for p in PARTS)
    note = "fits" if peak <= HBM_GB else f"needs {peak / HBM_GB:.1f}x HBM"
    return f"| {r['arch']} | {r['shape']} | {peak:.1f} | {parts} | {note} |"


def render(mesh_dir: str) -> None:
    recs = load(mesh_dir)
    print(f"Roofline table ({mesh_dir} mesh, per-chip terms; peaks: "
          f"{PEAK_FLOPS/1e12:.0f} TF/s bf16, {PEAK_FLOPS_BY_DTYPE['float32']/1e12:.1f} "
          f"TF/s fp32, {HBM_BW/1e9:.0f} GB/s HBM, {NVLINK_BW/1e9:.0f} GB/s NVLink, "
          f"{INTER_NODE_BW/1e9:.0f} GB/s across nodes)")
    print()
    print("| arch | shape | t_compute counted (s) | t_compute analytic (s) | t_memory (s) | "
          "t_collective (s) | dominant | roofline frac | useful-FLOP ratio | "
          f"state GB/chip | fits {HBM_GB}GB? |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        print(fmt_row(r))
    print()
    print(f"Per-rank memory peak ({mesh_dir} mesh, GB)")
    print()
    print("| arch | shape | peak | " + " | ".join(PARTS) + f" | fits {HBM_GB}GB? |")
    print("|---|---|---|" + "---|" * len(PARTS) + "---|")
    for r in recs:
        print(fmt_peak_row(r))
    print()


def _terms(r) -> str:
    if r is None or r["status"] != "ok":
        return "— | — |"
    t = r["roofline"]
    return (f"{t['t_compute_s']:.3f} / {t['t_memory_s']:.3f} / {t['t_collective_s']:.3f} "
            f"{t['dominant']} | {r['memory']['peak_bytes'] / 1e9:.1f} |")


def render_summary() -> None:
    by = {d: {(r["arch"], r["shape"]): r for r in load(d)} for d in ("single", "multi")}
    print("| arch | shape | (16, 16): compute / memory / collective s | peak GB | "
          "(2, 16, 16): compute / memory / collective s | peak GB |")
    print("|---|---|---|---|---|---|")
    for key in sorted(set(by["single"]) | set(by["multi"])):
        one, two = by["single"].get(key), by["multi"].get(key)
        if all(r is None or r["status"] != "ok" for r in (one, two)):
            continue
        print(f"| {key[0]} | {key[1]} | {_terms(one)} {_terms(two)}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=None, help="one mesh dir (default: single and multi)")
    ap.add_argument("--summary", action="store_true",
                    help="both meshes side by side, the cells that ran")
    args = ap.parse_args(argv)
    if args.summary:
        render_summary()
        return
    for d in [args.dir] if args.dir else ["single", "multi"]:
        render(d)


if __name__ == "__main__":
    main()

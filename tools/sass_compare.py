"""Check that another checkout's CUDA kernels survive unchanged in this one.

    python tools/sass_compare.py OTHER_CHECKOUT [--out FILE]

Builds every ``src/repro_torch/kernels/csrc/*.cu`` of this checkout (its own
``kernels/build.py``) and of OTHER_CHECKOUT (``nvcc`` with this checkout's
flags, into a temporary directory), disassembles both with ``cuobjdump
-sass`` and reports, per source, how many of the other checkout's kernels
have a kernel here whose machine code is the same instruction for
instruction (addresses and encodings aside; names may differ, as a template
parameter added to a kernel changes its name).  Needs the CUDA toolkit
(``nvcc``, ``cuobjdump``).  Prints one JSON object; exits 1 if a kernel of
the other checkout has no twin here.
"""
from __future__ import annotations

import argparse
import difflib
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

_FUNCTION = re.compile(r"^\s*Function : (\S+)\s*$")
_ADDRESS = re.compile(r"/\*[0-9a-f]{4,}\*/")
_ENCODING = re.compile(r"/\* 0x[0-9a-f]+ \*/")


def _tool(name: str) -> str:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(found).exists():
        raise RuntimeError(f"{name} not found: this check needs the CUDA toolkit")
    return found


def kernels(lib: Path) -> dict[str, tuple[str, ...]]:
    """{mangled kernel name: its SASS instructions} of one library."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = _FUNCTION.match(line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        if name is None:
            continue
        text = _ENCODING.sub("", _ADDRESS.sub("", line)).strip()
        if text and not text.startswith(".") and not set(text) <= {"."}:
            funcs[name].append(text)
    return {k: tuple(v) for k, v in funcs.items()}


def nearest_diff(body: tuple[str, ...], ours: dict, lines: int = 40) -> list[str]:
    """The first ``lines`` lines of the diff from ``body`` to the most
    similar kernel of ``ours``."""
    best = max(ours.values(), key=lambda b: difflib.SequenceMatcher(None, body, b).ratio())
    diff = difflib.unified_diff(body, best, "other", "here", n=1, lineterm="")
    return list(diff)[:lines]


def demangle(names) -> list[str]:
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if not filt or not names:
        return list(names)
    out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True)
    return out.stdout.splitlines() if out.returncode == 0 else list(names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--out", type=Path, help="also write the report here")
    args = ap.parse_args(argv)
    other_csrc = args.other / "src" / "repro_torch" / "kernels" / "csrc"
    names = sorted(p.stem for p in other_csrc.glob("*.cu"))
    build.build_all(names)
    report, missing_any = {}, False
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for n in names:   # one nvcc per source, all started together
            lib = Path(tmp) / f"lib{n}.so"
            procs[n] = (lib, subprocess.Popen(
                [_tool("nvcc"), *build.NVCC_FLAGS, "-o", str(lib), str(other_csrc / f"{n}.cu")],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
        for n, (lib, proc) in procs.items():
            err = proc.communicate()[1]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for the other checkout's {n}:\n{err}")
            theirs, ours = kernels(lib), kernels(build._lib_path(n))
            bodies = set(ours.values())
            missing = [k for k, body in theirs.items() if body not in bodies]
            missing_any |= bool(missing)
            report[n] = dict(other_kernels=len(theirs), kernels=len(ours),
                             unchanged=len(theirs) - len(missing),
                             changed=demangle(missing),
                             first_diff=nearest_diff(theirs[missing[0]], ours) if missing else [])
    text = json.dumps({"sass_compare": report, "all_unchanged": not missing_any})
    print(text)
    if args.out:
        args.out.write_text(text + "\n")
    return 1 if missing_any else 0


if __name__ == "__main__":
    sys.exit(main())

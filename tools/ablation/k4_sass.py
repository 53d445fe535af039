"""Instructions of the inline twined kernel (K4) in SASS: those one tap
runs on its common path, before and after the increment pickup, and the
whole kernel's in this checkout's build and a parent checkout's.

    python3 tools/ablation/k4_sass.py [PARENT_ROOT]

Run from the repository root where the card's toolkit is (nvcc,
cuobjdump). It compiles
tools/ablation/k4_tap.cu (one tap a thread: K4's loop body before and
after, config 4's case: a spherical source, degree 1, three channels,
float32) to a cubin and counts, in each of its two kernels, the
instructions on the shortest path from the entry to the exit: every
branch the cheap way, so no full pickup, no gate that wraps, no support
outside the table and no slow path of a division; a call counts as one.
The two share the loads of the inputs and the stores. It also counts
the instructions of K4's config-4 instantiation (degree 1, three
channels, affine target, float32) in this checkout's library and, given
one, the parent checkout's (chip_smoke.parent_k4_library). Prints one
line each and, last, one JSON object.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from envutil_tpu_torch.ops import kernels as K  # noqa: E402
from envutil_tpu_torch.ops import resample as R  # noqa: E402

INSTANCE = "resample_inline_twined_kernelILi1ELi3ELi0EfE"
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def disassemble(path):
    """{function name: [(address, instruction)]} of a cubin or library."""
    tool = os.path.join(os.path.dirname(K.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            cur = funcs.setdefault(line.split("Function : ")[1].strip(), [])
        elif cur is not None:
            m = INSN.search(line)
            if m:
                cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def shortest_path(insns):
    """Instructions on the shortest path from the first instruction to
    an unpredicated EXIT (breadth-first, one per instruction)."""
    at = {a: i for i, (a, _t) in enumerate(insns)}
    dist, frontier = {0: 1}, [0]
    while frontier:
        nxt = []
        for i in frontier:
            text = insns[i][1]
            pred = text.startswith("@")
            op = text.split()[1 if pred else 0]
            if op.startswith("EXIT") and not pred:
                return dist[i]
            succ = [i + 1] if i + 1 < len(insns) else []
            target = re.search(r"\b(?:BRA|JMP)\S*\s+\S*?(0x[0-9a-f]+)", text)
            if op.startswith(("BRA", "JMP")) and target:
                t = at.get(int(target.group(1), 16))
                succ = ([t] if t is not None else []) + (succ if pred else [])
            elif op.startswith("RET") and not pred:
                succ = []
            for j in succ:
                if j not in dist:
                    dist[j] = dist[i] + 1
                    nxt.append(j)
        frontier = nxt
    return None


def main():
    out = ROOT / "envutil_tpu_torch" / "_build" / "k4_tap.cubin"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([K.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-cubin", "-o", str(out),
                    str(ROOT / "tools" / "ablation" / "k4_tap.cu")],
                   check=True)
    taps = disassemble(out)
    rec = {"card": CS.card_line(), "tap": {}, "kernel": {}}
    for name in ("tap_before", "tap_after"):
        insns = taps[name]
        rec["tap"][name] = dict(static=len(insns),
                                shortest_path=shortest_path(insns))
        print(f"{name}: {len(insns)} instructions, "
              f"{rec['tap'][name]['shortest_path']} on the shortest path",
              flush=True)
    libs = {"after": R._INLINE_TWINED}
    if len(sys.argv) > 1:
        libs["before"] = CS.parent_k4_library(sys.argv[1])
    K.build_all(list(libs.values()))
    for which, lib in libs.items():
        funcs = disassemble(lib._so())
        name = next(f for f in funcs if INSTANCE in f)
        rec["kernel"][which] = len(funcs[name])
        print(f"K4 {which}: {INSTANCE}: {len(funcs[name])} instructions",
              flush=True)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()

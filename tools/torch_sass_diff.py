#!/usr/bin/env python3
"""Compare the machine code (SASS) of the port's kernel libraries in two
checkouts, kernel by kernel.

    python3 tools/torch_sass_diff.py --root DIR [--libs flash_attention,...]
        [--show PATTERN]

Builds each named ``csrc/<name>.cu`` in this checkout and in the one at
DIR (for example the parent commit unpacked under build/), disassembles
both with ``cuobjdump -sass`` and pairs their kernels by their
instructions: a kernel of DIR's library is "same" when this checkout's
library has a kernel with the same instruction text, branch labels
renumbered per kernel, whatever its name (a kernel moved into a shared
header takes a namespace and a template argument).  Prints, for each
kernel, its pairing or how many instructions differ, and ends with one
JSON line.  ``--show PATTERN`` also prints the global-memory and
constant-bank instructions (loads, stores, atomics) of this checkout's
kernels whose name holds PATTERN, in program order, to read where a
kernel's loads fall against its stores.  Needs the CUDA toolkit (nvcc,
cuobjdump); no card.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"\.L_x_\d+")
_MEMORY = re.compile(r"\b(LDG|STG|U?LDC|RED|ATOMG)\b")


def _build_lib(root, name):
    """Path of ``csrc/<name>.cu`` of the checkout at ``root``, built
    there by its own ``_build`` (a fresh interpreter, so two checkouts'
    packages never mix)."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from paddle_tpu_torch.kernels import _build; "
            "print(_build._target(%r)[1]); _build.load(%r)"
            % (root, name, name))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuobjdump():
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.isfile(cand):
            return cand
    sys.exit("cuobjdump not found")


def kernels(lib):
    """{mangled name: [instruction text, labels renumbered]} of a library."""
    text = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = _INSN.search(line)
        if cur is not None and m:
            cur.append(m.group(1))
    for name, insns in funcs.items():
        labels = {}
        funcs[name] = [_LABEL.sub(
            lambda mm: labels.setdefault(mm.group(0), "L%d" % len(labels)),
            i) for i in insns]
    return funcs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True,
                    help="the other checkout (for example the parent)")
    ap.add_argument("--libs", default="flash_attention,fused_ln")
    ap.add_argument("--show", default=None,
                    help="print the memory instructions of this "
                         "checkout's kernels whose name holds this")
    args = ap.parse_args()
    other = os.path.abspath(args.root)
    result = {}
    for name in args.libs.split(","):
        mine = kernels(_build_lib(ROOT, name))
        for k, insns in sorted(mine.items()):
            if args.show is not None and args.show in k:
                print("%s: %s, memory instructions in order:"
                      % (name, k))
                for i, insn in enumerate(insns):
                    if _MEMORY.search(insn):
                        print("  %4d  %s" % (i, insn))
        theirs = kernels(_build_lib(other, name))
        by_code = {tuple(v): k for k, v in mine.items()}
        rows = []
        for k, insns in sorted(theirs.items()):
            match = by_code.get(tuple(insns))
            if match is not None:
                print("%s: %s (%d instructions) same as %s"
                      % (name, k, len(insns), match))
            else:
                print("%s: %s (%d instructions) has no same kernel here"
                      % (name, k, len(insns)))
            rows.append({"kernel": k, "instructions": len(insns),
                         "same_as": match})
        extra = sorted(set(mine) - {r["same_as"] for r in rows})
        for k in extra:
            print("%s: %s (%d instructions) is new" % (name, k,
                                                       len(mine[k])))
        result[name] = {"kernels": rows, "new": extra,
                        "all_same": all(r["same_as"] for r in rows)}
    print(json.dumps({"sass_diff": result}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The port's CUDA libraries of two checkouts, compared function by function.

    python3 scripts/sass_diff.py TREE_A TREE_B

Each TREE is a checkout of this repository (the parent commit unpacked by
``git archive``, this one as ``.``).  Each builds its own kernels
(``vote_saver_tpu_torch.ops._build.build``, in a process of its own, into
its ``.torch_build/``); then ``cuobjdump -sass`` of each library of A is
set against the library of the same unit of B, function by function (the
anonymous namespace's per-build name left out of the function names, the
instruction addresses kept).  A function is "identical", "offsets" where
its instructions differ only in the offsets of constant-bank operands
(``c[0x3][0x40]``: a global table moved in the unit's constant bank), or
"differs".  One line a unit, one line a function that is not identical, and
the last line one JSON object of the counts by unit.  Needs the CUDA
toolkit (nvcc, cuobjdump); imports nothing of JAX.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def build(tree: pathlib.Path) -> list[pathlib.Path]:
    """The libraries of `tree`, built by its own _build."""
    code = "from vote_saver_tpu_torch.ops import _build; print('\\n'.join(map(str, _build.build()[0])))"
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True, check=True)
    return [pathlib.Path(line) for line in out.stdout.split() if line.endswith(".so")]


def functions(tool: str, lib: pathlib.Path) -> dict:
    """{function name: [instruction, ...]} of one library."""
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            anon = re.search(r"(\d+)_GLOBAL__N__", name)  # <length><the anonymous namespace's name>
            if anon:
                name = name[: anon.start()] + "ANON" + name[anon.end(1) + int(anon.group(1)):]
            out[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            out[name].append(re.sub(r"\s+", " ", line.strip()))
    return out


def unit_of(lib: pathlib.Path) -> str:
    return re.match(r"libvstorch_(.+)_[0-9a-f]+\.so$", lib.name).group(1)


def main() -> None:
    sys.path.insert(0, str(ROOT))
    from vote_saver_tpu_torch.ops import _build

    a_tree, b_tree = (pathlib.Path(t).resolve() for t in sys.argv[1:3])
    tool = str(pathlib.Path(_build.nvcc()).with_name("cuobjdump"))
    libs_a, libs_b = ({unit_of(p): p for p in build(t)} for t in (a_tree, b_tree))
    const = re.compile(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]")
    summary = {}
    for unit in sorted(libs_a):
        if unit not in libs_b:
            print(f"[sass_diff] {unit}: only in A")
            continue
        fa, fb = functions(tool, libs_a[unit]), functions(tool, libs_b[unit])
        counts = dict(identical=0, offsets=0, differs=0, only_a=0, only_b=0)
        for name in sorted(set(fa) | set(fb)):
            short = _build.short_name(name)
            if name not in fb or name not in fa:
                side = "a" if name not in fb else "b"
                counts[f"only_{side}"] += 1
                print(f"[sass_diff]   {unit}: only in {side.upper()} {short}")
                continue
            x, y = fa[name], fb[name]
            if x == y:
                counts["identical"] += 1
                continue
            if len(x) == len(y) and all(const.sub("c[]", u) == const.sub("c[]", v) for u, v in zip(x, y)):
                kind = "offsets"
            else:
                kind = "differs"
            counts[kind] += 1
            n = sum(u != v for u, v in zip(x, y)) + abs(len(x) - len(y))
            print(f"[sass_diff]   {unit}: {kind} {short} ({len(x)} / {len(y)} instructions, {n} lines differ)")
        summary[unit] = counts
        print(f"[sass_diff] {unit}: {counts}", flush=True)
    print(json.dumps({"sass_diff": summary, "a": str(a_tree), "b": str(b_tree)}))


if __name__ == "__main__":
    main()

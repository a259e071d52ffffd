"""Compare the machine code (SASS) of the kernels of two versions of a CUDA
source: did a change leave the kernels it was not meant to touch as they were?

    python -m realtime_style_transfer_torch.sass_diff OLD.cu NEW.cu

Both sources are compiled to ``sm_90a`` cubins with the flags of
``ops/kernels.py`` and disassembled with ``cuobjdump -sass``.  Each kernel of
OLD is matched by its demangled name in NEW, where a NEW kernel with one more
template argument that is ``0``/``false`` (say a new ``bool Q`` operand flag)
also answers to the name without it.  Addresses and encodings are dropped, so
two kernels match when their instruction text is the same.  Prints one line a
kernel and a summary; needs ``nvcc``, ``cuobjdump`` and ``cu++filt``, no GPU.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
from typing import Dict, List

from .ops import kernels


def _tool(name: str) -> str:
    return os.path.join(os.path.dirname(kernels._nvcc()), name)


def sass_by_kernel(source: str) -> Dict[str, List[str]]:
    """Demangled kernel name -> instruction lines of ``source``'s cubin."""
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC",
                                                            "-Xptxas", "-v")]
        subprocess.run([kernels._nvcc(), *flags, "-cubin", "-o", cubin, source], check=True)
        text = subprocess.run([_tool("cuobjdump"), "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    funcs: Dict[str, List[str]] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = subprocess.run([_tool("cu++filt"), m.group(1)], check=True,
                                  capture_output=True, text=True).stdout.strip()
            name = re.sub(r"\((int|bool)\)", "", name.replace("(anonymous namespace)",
                                                              "<unnamed>"))
            cur = re.sub(r"\(.*", "", name)
            funcs[cur] = []
        elif cur is not None:
            body = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", line).strip()
            if body:
                funcs[cur].append(body)
    return funcs


def aliases(name: str) -> List[str]:
    """``name`` and, when its last template argument is 0 or false, the name
    without that argument."""
    m = re.fullmatch(r"(.*), (0|false)>", name)
    return [name] + ([m.group(1) + ">"] if m else [])


def main(argv: List[str]) -> int:
    old_src, new_src = argv
    old, new = sass_by_kernel(old_src), sass_by_kernel(new_src)
    by_alias = {a: body for name, body in new.items() for a in aliases(name)}
    same = 0
    for name, body in sorted(old.items()):
        other = by_alias.get(name)
        if other is None:
            print(f"SASS {name}: missing in {new_src}")
        elif other == body:
            same += 1
            print(f"SASS {name}: identical ({len(body)} lines)")
        else:
            print(f"SASS {name}: DIFFERS ({len(body)} vs {len(other)} lines)")
    print(f"SASS summary: {same}/{len(old)} kernels of {old_src} identical in {new_src}")
    return 0 if same == len(old) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

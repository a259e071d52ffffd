"""Compare the machine code (SASS) of the kernels of two versions of a CUDA
source: did a change leave the kernels it was not meant to touch as they were?

    python -m realtime_style_transfer_torch.sass_diff [--ptx] OLD.cu NEW.cu

Both sources are compiled to ``sm_90a`` cubins with the flags of
``ops/kernels.py`` and disassembled with ``cuobjdump -sass``.  Each kernel of
OLD is matched by its demangled name in NEW, where a NEW kernel with one more
template argument that is ``0``/``false`` (say a new ``bool Q`` operand flag)
also answers to the name without it.  Addresses and encodings are dropped, so
two kernels match when their instruction text is the same; a kernel that
differs is also compared with the targets of its branches and calls dropped
("same but for code addresses": its code moved, its instructions did not).
With ``--ptx`` the same comparison is made on the PTX that ``nvcc`` hands to
``ptxas`` (``.loc`` lines, block-label and depot numbers and the anonymous
namespace's hash dropped): a kernel whose PTX is the same but whose SASS
differs was changed by ``ptxas``, not by its source.  Prints one line a
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


_BRANCH = re.compile(r"^(@!?U?P[T0-9] )?(BRA|BSSY|CALL|JMP)\S* ")


def without_addresses(body: List[str]) -> List[str]:
    """``body`` with the code addresses of its branches and calls dropped (and
    the return address that a ``MOV`` sets up just before a call)."""
    return [re.sub(r"0x[0-9a-f]+", "ADDR", line)
            if _BRANCH.match(line) or (line.startswith("MOV ") and i + 1 < len(body)
                                       and body[i + 1].startswith("CALL"))
            else line for i, line in enumerate(body)]


def _demangle(mangled: str) -> str:
    name = subprocess.run([_tool("cu++filt"), mangled], check=True,
                          capture_output=True, text=True).stdout.strip()
    name = re.sub(r"\((int|bool)\)", "", name.replace("(anonymous namespace)", "<unnamed>"))
    return re.sub(r"\(.*", "", name)


def ptx_by_kernel(source: str) -> Dict[str, List[str]]:
    """Demangled kernel name -> PTX lines of ``source``'s kernels."""
    with tempfile.TemporaryDirectory() as tmp:
        ptx = os.path.join(tmp, "k.ptx")
        flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC",
                                                            "-Xptxas", "-v", "-gencode",
                                                            "arch=compute_90a,code=sm_90a")]
        subprocess.run([kernels._nvcc(), *flags, "-arch=sm_90a", "-ptx", "-o", ptx, source],
                       check=True)
        text = open(ptx).read()
    funcs: Dict[str, List[str]] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*(?:\.visible |\.weak )?\.entry (\S+)\(", line)
        if m:
            cur = _demangle(m.group(1))
            funcs[cur] = []
            continue
        if cur is None or re.match(r"\s*\.(loc|file)\b", line):
            continue
        body = re.sub(r"\d*_GLOBAL__N__[0-9a-f]+_\d+_\w+?_[0-9a-f]{8}", "_GLOBAL__N_",
                      line.strip())
        body = re.sub(r"_INTERNAL_[0-9a-f]{8}_", "_INTERNAL_", body)
        body = re.sub(r"\$L__BB\d+_", "$L__BB_", re.sub(r"__local_depot\d+", "__local_depot",
                                                         body))
        if body:
            funcs[cur].append(body)
        if line.startswith("}"):
            cur = None
    return funcs


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
            cur = _demangle(m.group(1))
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
    ptx = argv[:1] == ["--ptx"]
    old_src, new_src = argv[1:] if ptx else argv
    kind, by_kernel = ("PTX", ptx_by_kernel) if ptx else ("SASS", sass_by_kernel)
    old, new = by_kernel(old_src), by_kernel(new_src)
    by_alias = {a: body for name, body in new.items() for a in aliases(name)}
    same = moved = 0
    for name, body in sorted(old.items()):
        other = by_alias.get(name)
        if other is None:
            print(f"{kind} {name}: missing in {new_src}")
        elif other == body:
            same += 1
            print(f"{kind} {name}: identical ({len(body)} lines)")
        elif without_addresses(other) == without_addresses(body):
            moved += 1
            print(f"{kind} {name}: same but for code addresses ({len(body)} lines)")
        else:
            print(f"{kind} {name}: DIFFERS ({len(body)} vs {len(other)} lines)")
    print(f"{kind} summary: {same}/{len(old)} kernels of {old_src} identical in {new_src}, "
          f"{moved} more the same but for code addresses")
    return 0 if same == len(old) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Rewrite a CUDA source of the port into C++ for the CPU stand-in in
this directory (cuda_runtime.h): drop the source's PTX helpers (the
stand-in defines them), turn each kernel launch into a shim::launch call
and the dynamic shared array into the stand-in's buffer.

    python3 tools/cpu_shim/rewrite.py src/repro_torch/csrc/rglru.cu > out.cpp
"""
import re
import sys

HELPERS = ("cp_async16", "cp_async_commit", "cp_async_wait", "mma_tf32",
           "named_sync", "named_arrive", "rcp_rn", "sqrt_rn")


def drop_function(src: str, name: str) -> str:
    """Remove the definition of the device function `name` (and its
    `template <int N>` line)."""
    i = src.find(f" {name}(")
    if i < 0:
        return src
    start = src.rfind("\n__device__", 0, i)
    tmpl = src.rfind("\ntemplate <int N>\n", 0, i)
    if tmpl >= 0 and tmpl + len("\ntemplate <int N>") == start:
        start = tmpl
    depth, k = 0, src.find("{", i)
    while True:
        depth += {"{": 1, "}": -1}.get(src[k], 0)
        if depth == 0:
            break
        k += 1
    return src[:start] + "\n" + src[k + 1:]


def matching(src: str, k: int) -> int:
    """Index of the parenthesis that closes the one at k."""
    depth = 0
    while True:
        depth += {"(": 1, ")": -1}.get(src[k], 0)
        if depth == 0:
            return k
        k += 1


def rewrite(src: str) -> str:
    for name in HELPERS:
        src = drop_function(src, name)
    src = re.sub(r"extern __shared__ __align__\(16\) (float) "
                 r"(\w+)\[\];", r"\1* \2 = (\1*)shim::dyn_smem;", src)
    src = src.replace("__shared__", "static")
    src = src.replace("__restrict__", "__restrict")
    out, pos = [], 0
    while True:
        i = src.find("<<<", pos)
        if i < 0:
            out.append(src[pos:])
            break
        start = max(src.rfind(c, 0, i) for c in ";{}") + 1
        j = src.find(">>>", i)
        k = src.find("(", j)
        m = matching(src, k)
        kernel, config, args = src[start:i].strip(), src[i + 3:j], \
            src[k + 1:m]
        out.append(src[pos:start] + f"\n  shim::launch({config}, [&]() {{ "
                   f"{kernel}({args}); }})")
        pos = m + 1
    return '#include "cuda_runtime.h"\n' + "".join(out)


if __name__ == "__main__":
    print(rewrite(open(sys.argv[1]).read()))

"""Build librx_native.so: ``python -m rx_tools_tpu_torch.native.build``.

One g++ call (no cmake needed) with the reference package's flags, into
``build/native/`` at the root of the checkout; ``build(out)`` writes
elsewhere (the tests build into a temporary directory).
"""

import os
import subprocess
import sys

from rx_tools_tpu_torch import native

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(HERE, "src", "iqcodec.cpp"),
           os.path.join(HERE, "src", "ringbuf.cpp")]


def build(out: str | None = None) -> str:
    """Compile the library to ``out`` (default :data:`native.LIB_PATH`)
    and return its path.  The file is written under a temporary name and
    renamed, so a concurrent loader never sees half of it."""
    out = out or native.LIB_PATH
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.check_call([
        "g++", "-O3", "-march=native", "-fno-math-errno", "-std=c++17",
        "-shared", "-fPIC", *SOURCES, "-lpthread", "-o", tmp])
    os.replace(tmp, out)
    if out == native.LIB_PATH:
        native._TRIED = False       # the next available() loads it
    return out


if __name__ == "__main__":
    print(build(), file=sys.stderr)

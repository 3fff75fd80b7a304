"""Build the native fast-CSV parser: ``python -m desire.data.native.build``."""

import os
import subprocess
import sys


def build(verbose: bool = True) -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "fast_csv.cpp")
    out = os.path.join(here, "libfast_csv.so")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-o", out, src]
    if verbose:
        print("+", " ".join(cmd))
    subprocess.check_call(cmd)
    return out


if __name__ == "__main__":
    try:
        path = build()
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"build failed: {e}", file=sys.stderr)
        sys.exit(1)
    print(f"built {path}")

"""Source-hash-keyed builds of the native host libraries (a copy of
bagel_tpu/native/_build.py that builds into the checkout's `build/`).

Each library builds on first use with g++ into `build/lib<name>-<hash>.so`
at the root of the checkout (git-ignored, beside the CUDA kernels), the
hash taken over the source: a binary is reused only when it was built from
the checked-in source on this host. Callers take their pure-Python
fallbacks when g++ or a library the source links (libjpeg) is missing.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import Optional, Sequence

from bagel_tpu_torch.ops._build import BUILD_DIR


def build_library(src: str, name: str,
                  extra_flags: Sequence[str] = ()) -> Optional[str]:
    """Compile `src` into a source-hashed .so under build/; returns the
    path, or None when g++ or the libraries it links are unavailable."""
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError:
        return None
    lib_path = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"  # concurrent builders never load a partial file
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", src, "-o", tmp, *extra_flags],
            check=True, capture_output=True,
        )
        os.replace(tmp, lib_path)
    except (OSError, subprocess.CalledProcessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return lib_path

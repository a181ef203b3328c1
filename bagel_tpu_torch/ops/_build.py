"""Build the package's CUDA kernels with nvcc at first use, and load them.

Each `csrc/<name>.cu` compiles on its own into a shared library with a plain
C interface, `build/<name>-<hash>.so` at the root of the checkout, keyed by a
hash of its source, of every shared header `csrc/*.cuh` (so that an edited
header rebuilds the kernels) and of the compiler flags, with nvcc's ptxas
report beside it
(`build/<name>-<hash>.ptxas.txt`); ctypes loads it. Nothing here runs
at import time. A missing or failing nvcc raises with nvcc's own error
output: there is no fallback.

`count_launch(fn)` is where each wrapper counts the launches of its kernel
(`fn.launches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # threads that first call a kernel at once build it once


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    """nvcc under $CUDA_HOME (default /usr/local/cuda), else on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file() and os.access(candidate, os.X_OK):
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found (looked in {candidate} and on PATH): the CUDA "
            "kernels of bagel_tpu_torch cannot be built"
        )
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(p.name.encode() + p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def report_path(name: str) -> Path:
    """nvcc's ptxas report (registers, spills), kept beside the library."""
    return library_path(name).with_suffix(".ptxas.txt")


def kernel_names() -> list:
    """Every kernel source of the package: the stems of `csrc/*.cu`."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile each `csrc/<name>.cu` whose library does not exist yet, one
    nvcc process per source, all started together. Returns nvcc's ptxas
    report per name, read back from `report_path` for a library built
    before ("" where that report is missing). Raises
    KernelBuildError with nvcc's stderr if a compile fails (after every
    started nvcc has ended)."""
    reports: Dict[str, str] = {}
    procs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            kept = report_path(name)
            reports[name] = kept.read_text() if kept.is_file() else ""
            continue
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{stderr}{stdout}")
            continue
        reports[name] = stderr + stdout
        report_path(name).write_text(reports[name])
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise KernelBuildError("\n".join(failed))
    return reports


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless its library exists. Returns nvcc's
    ptxas report (as `build_all`). Raises
    KernelBuildError with nvcc's stderr if the compile fails."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                build(name)
                lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def count_launch(fn) -> None:
    """Add one to `fn.launches` for a launch of fn's kernel, unless the
    current stream is capturing a CUDA graph: that call records the kernel
    and launches nothing, and each replay of the graph launches it (counted
    from the graph's own nodes: `inference.decode_program.replayed_launches`)."""
    if not torch.cuda.is_current_stream_capturing():
        fn.launches += 1

"""Build the CUDA kernels of `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface (no PyTorch headers, so nvcc takes seconds), compiled for
`sm_90a` into `build/` beside this file at first use. The file name carries
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. `build_all` starts one nvcc per source,
all at once, and waits for every one of them.

Nothing here runs at import: the CPU tests import the kernel modules, and
this machine may have no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 600

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, or the PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile every source that has no up-to-date library, one nvcc each,
    all started together. Returns {name: nvcc's output} for what was
    compiled (ptxas's registers, shared memory and spills). Raises with that
    output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in (names or sources()) if not _lib_path(n).exists()]
    procs = {}
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    done, failed = {}, []
    for name, (proc, tmp) in procs.items():
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc timed out after {NVCC_TIMEOUT_S} s"
        if proc.returncode == 0:
            os.replace(tmp, _lib_path(name))
        else:
            failed.append(f"== {name}.cu\n{log}")
        done[name] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return done


def function(lib_name: str, fn_name: str, argtypes, restype=ctypes.c_int):
    """The C function `fn_name` of `csrc/<lib_name>.cu`, built if needed
    (typed once, then taken from a cache: wrappers call this every
    launch)."""
    fn = _fns.get((lib_name, fn_name))
    if fn is not None:
        return fn
    lib = _libs.get(lib_name)
    if lib is None:
        build_all([lib_name])
        lib = _libs[lib_name] = ctypes.CDLL(str(_lib_path(lib_name)))
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = restype
    _fns[(lib_name, fn_name)] = fn
    return fn


__all__ = ["build_all", "function", "sources", "nvcc", "BUILD_DIR"]

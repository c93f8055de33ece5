"""Build and load the port's CUDA kernels.

Each ``deepspeed_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into ``deepspeed_tpu_torch/_build/``
(listed in ``.gitignore``), then loaded with ``ctypes``. The library's file
name carries a hash of its source and flags, so an edited source rebuilds and
an unchanged one is reused. :func:`build` starts one ``nvcc`` per source, all
at once, and waits for all of them; ptxas's register and shared-memory report
for each library is kept in a ``.log`` beside it.

Nothing here runs when the module is imported: the first kernel launch (or an
explicit :func:`build`) compiles.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_LOADED = {}  # name -> ctypes.CDLL, one load per process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels are built on a machine with the CUDA toolkit")


def sources():
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict:
    """Compile every listed source (default: all) that has no current library;
    one ``nvcc`` per source, started together. Returns name -> library path.
    Raises with the compiler's output if any build fails."""
    names = list(names or sources())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        # compile to a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log = proc.communicate()[0].decode(errors="replace")
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib

"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with ctypes. A library is built
at first use into `lang2seg_tpu_torch/_build/<name>-<hash>/`, keyed by a
hash of its source and flags, so an edited source is rebuilt and an
unchanged one is reused. `build_all` starts one `nvcc` per source, all at
once. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v"]
# per-library flags: NMS must not contract its IoU into FMAs, nor the ROI
# pool its bin edges, nor the ROI crop its hat weights and sums, nor the
# BatchNorm pass its affine (bit identity with the f32 reference, and
# with torch's own ops); no source may use fast math
SOURCE_FLAGS = {"nms": ["-fmad=false"], "fused_filter": [],
                "roi_pool": ["-fmad=false"], "roi_crop": ["-fmad=false"],
                "bn_act": ["-fmad=false"]}
# variants built from another library's source, with flags added; only
# measuring tools load them
VARIANTS = {"nms_clocks": ("nms", ["-DNMS_PHASE_CLOCKS"]),
            "fused_filter_clocks": ("fused_filter",
                                    ["-DFUSED_FILTER_PHASE_CLOCKS"]),
            "roi_pool_clocks": ("roi_pool", ["-DROI_POOL_PHASE_CLOCKS"])}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "lang2seg_tpu_torch are built on a machine with the "
                       "CUDA toolkit")


def _source(name: str) -> Path:
    return CSRC_DIR / f"{VARIANTS.get(name, (name,))[0]}.cu"


def _flags(name: str):
    if name in VARIANTS:
        base, extra = VARIANTS[name]
        return _flags(base) + extra
    return ARCH_FLAGS + COMMON_FLAGS + SOURCE_FLAGS[name]


def library_path(name: str) -> Path:
    src = _source(name).read_bytes()
    key = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}" / f"lib{name}.so"


def build_all(names: Iterable[str] = tuple(SOURCE_FLAGS)) -> Dict[str, Path]:
    """Build every missing library among `names` in parallel (one nvcc
    process per source). Returns name -> library path; raises with the
    compiler's output if a build fails. The compiler's log (with the
    registers and shared memory `-Xptxas -v` reports) is kept beside each
    library as build.log."""
    nvcc = None
    procs = {}
    paths = {}
    for name in names:
        path = library_path(name)
        paths[name] = path
        if path.exists():
            continue
        nvcc = nvcc or _nvcc()
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(_source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        paths[name].with_name("build.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name` (csrc/<name>.cu, or a variant), built
    first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _libs[name] = lib
        return lib

"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a digest of its source so an edited source is rebuilt, and
loaded with ``ctypes``.  ``build_all()`` starts one ``nvcc`` per source,
all at once.  A missing compiler or a failed build raises: there is no
fallback to the plain versions.

``LAUNCHES`` holds one plain integer per kernel.  A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
the main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "..", "..", "build",
                                          "kernels"))
SOURCES = ("spatial_stats", "cam_head", "flash_attention", "rwkv6_scan",
           "decode_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {"spatial_stats_bgc": 0,
                            "spatial_stats_rows_bgc": 0,
                            "cam_head_bgd": 0,
                            "flash_attention_bhsd": 0,
                            "rwkv6_scan_bhtk": 0,
                            "decode_attention_bkgd": 0}

# devices whose tensors go to a kernel's plain version: the CPU, and
# ``meta`` (shapes only: the launch analyses run the plain versions there)
PLAIN_DEVICES = ("cpu", "meta")

_LIBS: Dict[str, ctypes.CDLL] = {}

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL, _PI = ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)
_PLL = ctypes.POINTER(_LL)
_SIGNATURES = {
    "spatial_stats": {
        "spatial_stats_launch": ([ctypes.c_char_p, _F, _VP], _I)},
    "cam_head": {
        "cam_head_launch": ([_VP] * 7 + [_I] * 6 + [_VP], _I),
        "cam_head_workspace_bytes": ([_I, _I, _I], _LL),
        "cam_head_mma_info": ([_I, _I, _PI], _I),
        "cam_head_body_launches": ([_PI], _I)},
    "flash_attention": {
        "flash_attention_launch": ([_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _F, _VP], _I),
        "flash_attention_workspace_floats": ([_LL, _I], _LL),
        "flash_attention_wgmma_probe": ([_VP] * 6, _I),
        "flash_attention_f32_wgmma_probe": ([_VP] * 7, _I),
        "flash_attention_hd256_info": ([_PI], _I),
        "flash_attention_hd256_f32_info": ([_PI], _I),
        "flash_attention_wide_info": ([_I, _PI], _I),
        "flash_attention_body_launches": ([_PI], _I)},
    "rwkv6_scan": {
        "rwkv6_scan_launch": ([_PLL, _VP], _I)},
    "decode_attention": {
        "decode_attention_launch": ([_VP] * 6 + [_I] * 10 + [_F]
                                    + [_LL] * 6 + [_VP], _I),
        "decode_attention_blocks_per_sm": ([_I, _I, _I, _PI], _I),
        "decode_attention_hd256_info": ([_I, _I, _PI], _I)},
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built from source at first use")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile every out-of-date source in parallel; returns the library
    paths.  ``nvcc``'s resource report (``-Xptxas -v``) is kept beside
    each library as ``<lib>.log``."""
    names = list(names or SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {n: _lib_path(n) for n in names
            if not os.path.exists(_lib_path(n))}
    procs = {}
    for n, out in todo.items():
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, n + ".cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    errors = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        with open(out + ".log", "w") as f:
            f.write(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed on {n}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: _lib_path(n) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(path)
        for fn, (args, res) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        _LIBS[name] = lib
    return lib


# the sources' code for a tensor map the driver refused, + its CUresult
# (cudaError_t values stay below it)
MAP_ERROR = 100000


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch, or on a
    TMA tensor map the driver refused (``MAP_ERROR`` + its CUresult)."""
    if rc >= MAP_ERROR:
        raise RuntimeError(f"{what}: the driver refused a TMA tensor map "
                           f"(CUresult {rc - MAP_ERROR})")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")

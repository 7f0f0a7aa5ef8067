"""Build the CUDA kernels from ``src/repro_torch/csrc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles with one ``nvcc`` call into its own shared
library with a plain C interface (seconds, against minutes for a source that
includes PyTorch's headers). All sources compile in parallel at first use,
into ``build/repro_torch/`` under the repository root, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("sparsign", "vote_update", "ef_server", "ternary", "weighted_vote_update",
           "sparsign_pack2bit", "unpack2bit", "golomb_encode", "golomb_decode", "pack2bit",
           "pack8")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c = ctypes
_p, _i, _ll, _u32 = _c.c_void_p, _c.c_int, _c.c_longlong, _c.c_uint32
# argtypes of each library's C entry points: pointers and the stream as
# c_void_p, or ctypes would pass them as 32-bit ints and cut them
SIGNATURES = {
    "sparsign": {"sparsign_launch": [_p, _p, _p, _p, _i, _ll, _ll, _u32, _i, _p],
                 "sparsign_map_launch": [_p, _p, _p, _p, _i, _ll, _ll, _u32, _ll, _u32, _i,
                                         _p]},
    "vote_update": {"vote_update_launch": [_p, _p, _p, _ll, _c.c_float, _i, _i, _i, _p]},
    "ef_server": {"ef_server_launch": [_p, _p, _p, _p, _p, _ll, _p]},
    "ternary": {"ternary_launch": [_p, _p, _p, _p, _i, _ll, _ll, _u32, _i, _i, _p],
                "ternary_map_launch": [_p, _p, _p, _p, _i, _ll, _ll, _u32, _ll, _u32, _i, _i,
                                       _p],
                "ternary_pack2bit_launch": [_p, _p, _p, _p, _ll, _ll, _u32, _i, _i, _p],
                "ternary_pack2bit_map_launch": [_p, _p, _p, _p, _ll, _ll, _u32, _ll, _u32, _i,
                                                _i, _p],
                "noise_table_launch": [_p, _p],
                "ternary_fallbacks_launch": [_p, _i, _p]},
    "weighted_vote_update": {"weighted_vote_update_launch":
                             [_p, _p, _p, _p, _ll, _c.c_float, _c.c_float, _i, _i, _p]},
    "sparsign_pack2bit": {"sparsign_pack2bit_launch": [_p, _p, _p, _p, _ll, _ll, _u32, _i, _p],
                          "sparsign_pack2bit_map_launch": [_p, _p, _p, _p, _ll, _ll, _u32, _ll,
                                                           _u32, _i, _p]},
    "unpack2bit": {"unpack2bit_sum_into_launch": [_p, _p, _i, _ll, _i, _i, _p],
                   "unpack2bit_wsum_into_launch": [_p, _p, _p, _i, _ll, _i, _p]},
    "golomb_encode": {"golomb_encode_launch": [_p, _p, _p, _p, _p, _ll, _ll, _u32, _i, _i, _p],
                      "golomb_encode_map_launch": [_p, _p, _p, _p, _p, _ll, _ll, _u32, _ll,
                                                   _u32, _i, _i, _p],
                      "golomb_encode_scratch_bytes": [_ll]},
    "golomb_decode": {"ungolomb_launch": [_p, _p, _p, _p, _p, _i, _ll, _ll, _i, _p],
                      "ungolomb_scratch_bytes": [_i, _ll, _ll, _i]},
    "pack2bit": {"pack2bit_launch": [_p, _p, _ll, _ll, _p],
                 "unpack2bit_launch": [_p, _p, _ll, _p]},
    "pack8": {"qsgd8_pack8_launch": [_p, _p, _p, _p, _ll, _ll, _u32, _i, _p],
              "qsgd8_pack8_map_launch": [_p, _p, _p, _p, _ll, _ll, _u32, _ll, _u32, _i, _p],
              "unpack8_sum_into_launch": [_p, _p, _p, _i, _ll, _i, _p]},
}
#: entry points that return something other than a CUDA error code
RESTYPES = {"golomb_encode_scratch_bytes": _ll, "ungolomb_scratch_bytes": _ll}

_LIBS: dict = {}
#: nvcc's output (``-Xptxas -v``: registers, spills) and build seconds, per source
BUILD_LOG: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"{name}-{_source_hash(name)}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one nvcc process per source, all started
    together; returns {name: seconds} for the sources it compiled."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: BUILD_LOG[n]["seconds"] for n in todo}


def library(name: str, entry: str | None = None):
    """The C entry point ``entry`` (default: the source's first in
    ``SIGNATURES``) of ``csrc/<name>.cu``, built and loaded on first use. An
    entry point the library lacks (an older kernel tree's, as the split
    modes of ``chip_smoke.py`` build them) is left unbound."""
    entry = entry or next(iter(SIGNATURES[name]))
    if (name, entry) not in _LIBS:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for sym, argtypes in SIGNATURES[name].items():
            if not hasattr(lib, sym):
                continue
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(sym, ctypes.c_int)
            _LIBS[(name, sym)] = fn
    return _LIBS[(name, entry)]


def check_launch(name: str, err: int) -> None:
    """Raise if the launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")

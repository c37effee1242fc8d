"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` — one
``nvcc -c`` per source, all started together — and link into one shared
library with a plain C interface, which ``ctypes`` loads.  The library is
keyed on a hash of the sources and the flags and lands in ``build/`` at
the repository root, so the first call in a fresh checkout builds it and
later calls reuse it; ``nvcc``'s output (ptxas's registers, shared memory
and spills per kernel) is kept beside it (``build_log``).  Nothing here
runs at import time; a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

#: C entry points and their argument types (every pointer and the stream
#: are ``c_void_p``, a float scalar ``c_float``; each returns the
#: ``cudaGetLastError()`` code)
_SIGNATURES = {
    "repro_fanout_mean": (_P, _P, _P, _LL, *(_I,) * 10, _P),
    "repro_fanout_mean_bwd": (_P, _P, _P, _LL, *(_I,) * 6, _P),
    "repro_cache_probe_gather": (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P),
    "repro_cache_probe_compact": (_P, _P, _P, _P, _P, _P, *(_I,) * 14, _P),
    "repro_cache_probe_tiered": (_P, _P, _P, _P, _P, _P, _P, _LL,
                                 *(_I,) * 8, _P),
    "repro_flash_attention_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _F, _P),
    "repro_flash_attention_sm90": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _F, *(_LL,) * 12, _P),
    "repro_flash_attention_sm90_smem": (_I,),
    "repro_gather_reduce": (_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _P),
    "repro_ssd_scan": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "repro_ssd_scan_sm90": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            *(_LL,) * 7, _P),
    "repro_ssd_scan_sm90_smem": (_I, _I),
}


def _nvcc() -> str:
    """Path of ``nvcc`` (``PATH`` first, then ``/usr/local/cuda/bin``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch need "
                       "the CUDA toolkit to build")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"


def build_log(lib: Path) -> Path:
    """Where ``build`` keeps ``nvcc``'s output for the library ``lib``."""
    return lib.with_suffix(".log")


def build(verbose: bool = False) -> Path:
    """Compile and link the kernels unless the library for these sources
    already exists; returns its path.  ``verbose`` prints ``nvcc``'s
    output (ptxas register and shared-memory reports included)."""
    lib = library_path()
    if lib.exists():
        return lib
    srcs, _ = _sources()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s.name, log) for s, p, log in zip(srcs, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in failed))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", *map(str, objs),
             "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        build_log(lib).write_text("".join(
            f"[nvcc {s.name}]\n{log.strip()}\n" for s, log in zip(srcs, logs)))
        os.replace(tmp_lib, lib)
    if verbose:
        print(build_log(lib).read_text(), end="")
        print(f"built {lib.name} in {time.perf_counter() - t0:.1f}s")
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if status != 0:
        msg = library().repro_error_string(status).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{status} ({msg})")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of the CUDA ``device`` (a launch plan's
    width)."""
    import torch
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def dtype_code(t) -> int:
    """The kernels' element-type code for ``t`` (0 float32, 1 bfloat16)."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16 rows, "
                        f"got {t.dtype}")
    return codes[t.dtype]

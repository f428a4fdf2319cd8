"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The
library goes to ``build/dtc_tpu_torch/`` at the repository root, named
with a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads. A source may build several libraries, each with its
own preprocessor defines (:data:`_VARIANTS`). :func:`build_all` starts one
``nvcc`` per library at once. Nothing builds at import: the first launch
builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dtc_tpu_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

#: The C signatures of each library's entry points: {function: argtypes}.
_SIGNATURES = {
    "decode_attention": {
        "dtc_decode_attention": [_P] * 8 + [_L] + [_I] * 5 + [_F] + [_I] * 2 + [_P],
        "dtc_decode_split_len": [_I, _I],
    },
    "flash_attention": {
        "dtc_flash_fwd": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P],
        "dtc_flash_bwd_dq": [_P] * 8 + [_I] * 4 + [_F, _F] + [_I] * 3 + [_P],
        "dtc_flash_bwd_dkv": [_P] * 8 + [_I] * 4 + [_F] + [_I] * 3 + [_P],
    },
    "flash_attention_tc": {
        "dtc_flash_tc_fwd": [_P] * 5 + [_I] * 4 + [_F] + [_I] * 4 + [_P],
        "dtc_flash_tc_dkv": [_P] * 8 + [_I] * 4 + [_F] + [_I] * 5 + [_P],
        "dtc_flash_tc_dq": [_P] * 8 + [_I] * 4 + [_F, _F] + [_I] * 5 + [_P],
        "dtc_flash_tc_smem_bytes": [_I, _I],
    },
    "overlap_collectives": {
        "dtc_overlap_ag_step": [_P, _L, _L, _P, _L, _L, _P, _L] + [_I] * 5 + [_I] * 6 + [_P],
        "dtc_overlap_rs_step": [_P, _L, _L, _P, _L, _L, _P, _P] + [_I] * 4 + [_I] * 6 + [_P],
        "dtc_overlap_tc_smem_bytes": [_I, _I, _I],
    },
}

#: Libraries built from another name's source with preprocessor defines:
#: {library: (source stem, defines)}. The decode megakernel builds one
#: library per (compute, KV) dtype pair, and the flash source one for its
#: CUDA-core kernels and one for its tensor-core kernels, so that their
#: template instances compile in separate processes at once.
_MEGAKERNELS = {
    f"decode_fused_{c}_{k}": ("decode_fused", [f"-DDTC_CD={ci}", f"-DDTC_KV={ki}"])
    for ci, c in enumerate(("f32", "bf16"))
    for ki, k in enumerate(("f32", "bf16", "i8"))
}
_VARIANTS = {**_MEGAKERNELS, "flash_attention_tc": ("flash_attention", ["-DDTC_FLASH_TC=1"])}
for _name in _MEGAKERNELS:
    _SIGNATURES[_name] = {
        "dtc_fused_layers": [_P] * 9 + [_I] * 9 + [_F] + [_I] * 2 + [_P] * 2 + [_I] * 3
        + [_F, _P],
        "dtc_fused_layers_config": [_I] * 5 + [_P] * 2,
    }

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else ``PATH``, else
    ``/usr/local/cuda/bin``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _stem_and_defines(name: str) -> tuple[str, list[str]]:
    return _VARIANTS.get(name, (name, []))


def _sources(name: str) -> list[Path]:
    main = CSRC / f"{_stem_and_defines(name)[0]}.cu"
    if not main.is_file():
        raise FileNotFoundError(main)
    return [main] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + _stem_and_defines(name)[1]).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the last build of ``name``."""
    return library_path(name).with_suffix(".log")


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    (process or None, temporary output path)."""
    lib = library_path(name)
    if lib.is_file():
        return None, None
    stem, defines = _stem_and_defines(name)
    cmd = [nvcc(), *NVCC_FLAGS, *defines]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    log = open(log_path(name), "w")
    try:
        proc = subprocess.Popen(
            cmd + ["-o", str(tmp), str(CSRC / f"{stem}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        )
    except OSError:
        log.close()
        raise
    proc.log = log  # closed when the build is reaped
    return proc, tmp


def _finish(name: str, proc, tmp) -> None:
    if proc is None:
        return
    rc = proc.wait()
    proc.log.close()
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name} (rc {rc}):\n{log_path(name).read_text()}"
        )
    os.replace(tmp, library_path(name))


def build_all(names=None) -> dict[str, float]:
    """Build every kernel library that is missing, one ``nvcc`` per library
    started together. Returns the wall seconds until each finished."""
    names = list(names or _SIGNATURES)
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    took = {}
    for n, (proc, tmp) in started.items():
        _finish(n, proc, tmp)
        took[n] = time.perf_counter() - t0
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if missing."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dtc_error_string.argtypes = [ctypes.c_int]
    lib.dtc_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def error_string(lib: ctypes.CDLL, code: int) -> str:
    return f"{code} ({lib.dtc_error_string(code).decode()})"

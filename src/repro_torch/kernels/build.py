"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each source under ``src/repro_torch/csrc/`` is compiled for ``sm_90a`` into
its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds). Libraries go into ``build/`` at the repository root,
named by a hash of the sources and flags, so a changed source rebuilds and
an unchanged one is reused. ``build()`` starts one ``nvcc`` per source, all
at once; ``launch()`` builds on first use.

Every launch function returns ``cudaGetLastError()``; ``launch()`` raises
when it is not 0. Wrappers count their launches in ``LAUNCHES`` (one plain
integer per kernel) through ``count()``, under a lock: Hogwild trainers and
autograd's device thread launch at the same time. A run reads the counts to
show that its path went through the kernels.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# source stem -> (C symbol, argtypes)
SIGNATURES = {
    "pairwise": ("pairwise_launch", [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "dedup_aggregate": ("dedup_aggregate_launch", [_P, _P, _P, _P, _I, _I, _P]),
    "fused_update": ("fused_update_launch",
                     [_P, _P, _P, _P, _I, _I, _LL, _F, _F, _P]),
    "l1_bwd": ("l1_bwd_launch", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "flash_attention": ("flash_attention_launch",
                        [_P, _P, _P, _P, *[_I] * 9, _F, _I, _P]),
    "ssd_scan": ("ssd_scan_launch", [*[_P] * 7, *[_I] * 5, _P]),
    "rescal_proj": ("rescal_proj_launch", [*[_P] * 8, *[_I] * 3, _P]),
}
# a source's other C functions: symbol -> (argtypes, restype)
FUNCTIONS = {
    "pairwise": {
        "pairwise_l1_plan": ([_I] * 4, _I),
    },
    "l1_bwd": {
        "l1_bwd_pair_launch": ([*[_P] * 6, *[_I] * 4, _P], _I),
        "l1_bwd_pair_scratch": ([_I] * 4, _LL),
        "l1_bwd_plan": ([*[_I] * 5, *[ctypes.POINTER(_I)] * 2], _I),
        "l1_bwd_pair_plan": ([_I] * 4, _I),
    },
}

# launches per kernel; the pairwise kernel counts per mode; the l1 backward
# per product computed (d_o, d_n), and l1_bwd_pair the calls that computed
# both in one pass (two launches each: the pass, then d_n's partial sums);
# rescal_proj per direction
LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("pairwise_dot", "pairwise_l2sq", "pairwise_l1", "dedup_aggregate",
     "fused_update", "l1_bwd_do", "l1_bwd_dn", "l1_bwd_pair", "flash_attention",
     "ssd_scan", "rescal_proj_fwd", "rescal_proj_bwd"), 0)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count(*names: str) -> None:
    """Add one launch to each of ``names``; safe from any thread."""
    with _COUNT_LOCK:
        for name in names:
            LAUNCHES[name] += 1


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SIGNATURES), verbose: bool = False
          ) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, all in parallel.

    Raises with nvcc's output if any compile fails. With ``verbose`` prints
    ptxas's register and shared-memory report of each fresh build.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = None
    procs = {}
    paths = {}
    for name in names:
        out = lib_path(name)
        paths[name] = out
        if out.exists():
            continue
        exe = exe or nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees a whole file
        if verbose:
            print(f"--- nvcc {name}.cu\n{log.strip()}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            symbol, argtypes = SIGNATURES[name]
            for sym, (args, res) in {symbol: (argtypes, _I),
                                     **FUNCTIONS.get(name, {})}.items():
                fn = getattr(lib, sym)
                fn.argtypes = args
                fn.restype = res
            _LIBS[name] = lib
        return lib


def launch(name: str, *args, symbol: str = "") -> None:
    """Call the launch function of ``name`` (or its function ``symbol``);
    raise if the launch failed."""
    fn = getattr(library(name), symbol or SIGNATURES[name][0])
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")

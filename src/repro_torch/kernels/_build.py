"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/<name>-<digest>.so`` at the
root of the checkout, which ``ctypes`` loads.  The digest covers the sources
and the flags, so an edited kernel rebuilds and a stale library is never
loaded.  The build happens at first use — or all at once, one ``nvcc``
process per source started together, through :func:`build` — never when a
module is imported, so the CPU tests import every module without a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("flash_attention", "fused_score", "flash_decode", "fused_ffn",
           "rwkv6_scan", "attention_any", "ffn_any", "rwkv6_scan_any")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
#: guards every wrapper's ``launches`` counter (a plain integer on the
#: wrapper function, one added where it launches its kernel)
COUNT_LOCK = threading.Lock()
#: the wrappers that count their kernel's launches, as (ops module, function)
_COUNTED = (("fused_score", "fused_score"),
            ("flash_attention", "flash_attention"),
            ("fused_ffn", "fused_ffn_2d"),
            ("flash_decode", "flash_decode"),
            ("flash_decode", "flash_decode_with_self"),
            ("rwkv6_scan", "rwkv6_scan"))
_counted: Dict[str, object] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}
#: ptxas resource use of the last build, per source: one line per kernel
#: instantiation (mangled template name, registers, static shared memory,
#: spill bytes)
ptxas_log: Dict[str, List[str]] = {}


def _ptxas_summary(log: str) -> List[str]:
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = f"{m.group(1)} B spill stores"
        if "Performance Loss" in ln:   # e.g. wgmma serialized by ptxas
            out.append(f"{name}: {ln.strip()}")
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{name}: {m.group(1)} registers, "
                       f"{smem.group(1) if smem else 0} B static smem, "
                       f"{spill}")
    return out


def _nvcc() -> str:
    roots = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             "/usr/local/cuda"]
    for root in filter(None, roots):
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels build on the GPU machine")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every named source that has no current library, one nvcc
    process each, all started together.  Returns the wall seconds taken;
    raises with the compiler's output when a build fails."""
    t0 = time.perf_counter()
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        ptxas_log[name] = _ptxas_summary(log)
        if proc.returncode:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: a concurrent process never
    if failed:                     # loads a half-written library
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def function(lib: str, symbol: str, argtypes: Sequence):
    """The C function ``symbol`` of library ``lib`` (built at first use),
    with ``argtypes`` declared and an ``int`` (cudaError_t) result."""
    key = (lib, symbol)
    fn = _fns.get(key)
    if fn is not None:
        return fn
    with _lock:
        if key not in _fns:
            if lib not in _libs:
                build([lib])
                _libs[lib] = ctypes.CDLL(str(_target(lib)))
            fn = getattr(_libs[lib], symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[key] = fn
    return _fns[key]


def forbid_grad(kernel: str, *tensors) -> None:
    """Raise when grad mode is on and an operand requires grad.  The hand
    kernels have no backward (nor have the JAX package's Pallas kernels),
    so a launch there would cut the autograd graph silently: no output of
    a kernel is ever tracked, and nothing falls back to the plain
    version."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward, and an operand "
            f"requires grad; differentiate through impl='chunked' or "
            f"'reference' (no kernel), or call it under torch.no_grad()")


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a C pointer value,
    read at every launch: a dispatcher's own stream, or the capture stream
    while a CUDA graph records the launch."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def _wrappers() -> Dict[str, object]:
    if not _counted:
        import importlib
        found = {fn: getattr(importlib.import_module(
            f"repro_torch.kernels.{mod}.ops"), fn) for mod, fn in _COUNTED}
        with _lock:
            _counted.update(found)     # whole: no reader sees it half filled
    return _counted


def launch_counts() -> Dict[str, int]:
    """Every counting wrapper's ``launches``, by function name."""
    wrappers = _wrappers()
    with COUNT_LOCK:
        return {name: w.launches for name, w in wrappers.items()}


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (function name -> launches) to the wrappers' counters:
    a CUDA-graph replay runs no wrapper, so its executor adds what the
    capture recorded."""
    wrappers = _wrappers()
    with COUNT_LOCK:
        for name, n in counts.items():
            wrappers[name].launches += n

"""Build the CUDA kernels at first use and bind them with ctypes.

Each source in `bbx_torch/csrc/` is compiled on its own by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), all sources at once in parallel.  The
libraries go into ``build/bbx_torch/<hash>/`` at the repository root, keyed
by a hash of the sources and flags, so an edited kernel is rebuilt and an
unchanged one is reused.

Every exported C function launches on the stream it is given and returns
``cudaGetLastError()`` as an int; `check` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "bbx_torch")

# Kernel library name -> its source file in csrc/.
SOURCES = {
    "valid3": "valid3.cu",
    "solvable_disjoint": "solvable_disjoint.cu",
    "solvable_exact": "solvable_exact.cu",
    "afterstate": "afterstate.cu",
    "gae": "gae.cu",
    "move": "move.cu",
    "regen": "regen.cu",
    "evaluator": "evaluator.cu",
    "evaluator_backward": "evaluator_backward.cu",
    "sample": "sample.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Each entry point: (its library, its C symbol, its argtypes).
SIGNATURES = {
    # bits, ids, shifts, anchor_ok, out, k, stream
    "valid3": ("valid3", "bbx_valid3", [_P, _P, _P, _P, _P, _I, _P]),
    # ids, valid3, no_conflict, out, k, stream
    "solvable_disjoint": ("solvable_disjoint", "bbx_solvable_disjoint",
                          [_P, _P, _P, _P, _I, _P]),
    # bits, ids, valid3, place, shifts, anchor_ok, out, k, stream
    "solvable_exact": ("solvable_exact", "bbx_solvable_exact",
                       [_P, _P, _P, _P, _P, _P, _P, _I, _P]),
    # board, pieces, out (planes, features, overlap), b, element size, stream
    "afterstate": ("afterstate", "bbx_afterstate", [_P, _P, _P, _I, _I, _P]),
    # rewards, dones, values, last_value, adv, ret, gamma, gamma*lambda,
    # t, n, stream
    "gae": ("gae", "bbx_gae", [_P, _P, _P, _P, _P, _P, _F, _F, _I, _I, _P]),
    # board, ids, used, done, streak, action, place, anchor_ok, nblocks,
    # new_board, ints, flags, used_after, center, bits, n, stream
    "move": ("move", "bbx_move", [_P] * 15 + [_I, _P]),
    # 10 state fields, 13 of bbx_move's outputs, ids, fresh, place, shifts,
    # anchor_ok, 7 reward coefficients, auto_reset, out4, out1, n, stream
    "step_finish": ("move", "bbx_step_finish",
                    [_P] * 28 + [_F] * 7 + [_I, _P, _P, _I, _P]),
    # bits, ids, need, seed, place, shifts, anchor_ok, no_conflict,
    # out_ids, attempts, n, stream
    "regen": ("regen", "bbx_regen", [_P] * 10 + [_I, _P]),
    # planes, feats, ctx, the 8 evaluator parameters, layout, scores, b,
    # c1, c2, h, d, element size, stream
    "evaluator": ("evaluator", "bbx_evaluator", [_P] * 13 + [_I] * 6 + [_P]),
    # c1, c2, h, d -> elements of the weight layout (0 beyond the limits)
    "evaluator_layout_size": ("evaluator", "bbx_evaluator_layout_size", [_I] * 4),
    # b, c1, c2, h, d, element size, out (7 int64 sizes)
    "evaluator_grad_sizes": ("evaluator_backward", "bbx_evaluator_grad_sizes",
                             [_I] * 6 + [_P]),
    # planes, feats, ctx, dscores, the 8 evaluator parameters, layout, x0,
    # dz0, tile sums, records, b, c1, c2, h, d, element size, stream
    "evaluator_grad_tiles": ("evaluator_backward", "bbx_evaluator_grad_tiles",
                             [_P] * 17 + [_I] * 6 + [_P]),
    # x0, dz0, partials, b, c1, c2, h, d, element size, stream
    "evaluator_grad_dense0": ("evaluator_backward", "bbx_evaluator_grad_dense0",
                              [_P] * 3 + [_I] * 6 + [_P]),
    # records, partials, tile sums, layout, grads, dctx, b, c1, c2, h, d,
    # element size, stream
    "evaluator_grad_reduce": ("evaluator_backward", "bbx_evaluator_grad_reduce",
                              [_P] * 6 + [_I] * 6 + [_P]),
    # mask, seed, actions, n, stream
    "sample": ("sample", "bbx_sample", [_P] * 3 + [_I, _P]),
}

_LOADED: dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SOURCES):
        with open(os.path.join(CSRC, SOURCES[name]), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    for extra in sorted(os.listdir(CSRC)):
        if extra.endswith(".cuh"):
            with open(os.path.join(CSRC, extra), "rb") as f:
                h.update(extra.encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all() -> dict:
    """Compile every kernel library that is not built yet, in parallel.

    Returns ``{"seconds": wall time, "ptxas": {name: nvcc's -Xptxas -v
    report}}``; raises with nvcc's output if any source fails to compile.
    """
    out = build_dir()
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, src in SOURCES.items():
        lib = os.path.join(out, f"lib{name}.so")
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(out, f"{name}.log"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    ptxas = {}
    for name in SOURCES:
        log = os.path.join(out, f"{name}.log")
        if os.path.exists(log):
            with open(log) as f:
                ptxas[name] = f.read()
    return {"seconds": time.perf_counter() - t0, "ptxas": ptxas}


def function(name: str):
    """The ctypes function of entry point `name` (built on first use)."""
    fn = _LOADED.get(name)
    if fn is None:
        lib, symbol, argtypes = SIGNATURES[name]
        lib_path = os.path.join(build_dir(), f"lib{lib}.so")
        if not os.path.exists(lib_path):
            build_all()
        fn = getattr(ctypes.CDLL(lib_path), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = fn
    return fn


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on `t`'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_many(checks) -> None:
    """`require` for each ``(name, t, dtype, shape)`` of `checks`, with
    the common case (all of them right) tested in one pass."""
    for name, t, dtype, shape in checks:
        if not (t.is_cuda and t.dtype == dtype and t.shape == shape
                and t.is_contiguous()):
            require(name, t, dtype, shape)


def require(name: str, t, dtype, shape) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")

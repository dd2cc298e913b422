"""Build and load the port's CUDA kernels (``sr3_tpu_torch/csrc``).

The kernels are CUDA C++ for Hopper (``sm_90a``) with a plain C interface.
At first use each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library, keyed
on a hash of the sources and flags, under ``sr3_tpu_torch/_build/`` (ignored
by git), and loaded with ctypes; the compilers' output (ptxas' registers and
spills of every kernel) is kept beside it as ``<library>.log``. Nothing is
built when a module is imported, and CPU tensors never reach this module:
the op wrappers dispatch CPU inputs to their plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
DEFAULT_CUDA_HOME = "/usr/local/cuda"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
# name: (argtypes, restype)
_SIGNATURES = {
    # B, HW, C, G, dtype
    "sr3_gn_workspace_floats": ([_I] * 5, _L),
    # B, HW, C, G, dtype, route, out (8 long long)
    "sr3_gn_plan": ([_I] * 6 + [_P], _I),
    # x, gamma, beta, y, B, HW, C, G, eps, swish, dtype, stream
    "sr3_group_norm": ([_P] * 4 + [_I] * 4 + [_F, _I, _I, _P], _I),
    # counts (64 long long), reset
    "sr3_group_norm_clusters": ([_P, _I], _I),
    # B, HW, C, dtype
    "sr3_gn_stats_workspace_floats": ([_I] * 4, _L),
    # x, s1, s2, workspace, B, HW, C, dtype, stream
    "sr3_gn_stats": ([_P] * 4 + [_I] * 4 + [_P], _I),
    # x, pre_scale, pre_bias, post_scale, post_shift, gamma, beta, w, bias,
    # res, y, workspace, tickets, B, H, W, Cin, Cout, G, eps, dtype, stream
    "sr3_gn_silu_conv3x3": ([_P] * 13 + [_I] * 6 + [_F, _I, _P], _I),
    # x, top, bottom, mult, add, w, bias, res, y, B, H, W, Cin, Cout,
    # dtype, stream
    "sr3_gn_silu_conv3x3_halo": ([_P] * 9 + [_I] * 6 + [_P], _I),
    # counts (7 long long), reset
    "sr3_gn_silu_conv3x3_tiles": ([_P, _I], _I),
    # B, H, W, Cout, out (7 long long)
    "sr3_gn_silu_conv3x3_plan": ([_I] * 4 + [_P], _I),
    # B, HW, C, G, dtype, pre
    "sr3_gn_bwd_workspace_floats": ([_I] * 6, _L),
    # x, dy, pre_scale, pre_bias, gamma, beta, mean, rstd, dx, dgamma, dbeta,
    # dpre_scale, dpre_bias, workspace, B, HW, C, G, eps, swish, dtype,
    # stream
    "sr3_gn_bwd": ([_P] * 14 + [_I] * 4 + [_F, _I, _I, _P], _I),
    # x, pre_scale, pre_bias, gamma, beta, act, mean, rstd, workspace, B, HW,
    # C, G, eps, dtype, stream
    "sr3_gn_bwd_act": ([_P] * 9 + [_I] * 4 + [_F, _I, _P], _I),
    # q, k, v, o, lse, workspace, BH, S, D, scale, dtype, stream
    "sr3_flash_attention_fwd": ([_P] * 6 + [_I] * 3 + [_F, _I, _P], _I),
    # BH, S, D, dtype
    "sr3_flash_attention_fwd_workspace_floats": ([_I] * 4, _L),
    # BH, S, D, out (7 long long)
    "sr3_flash_attention_fwd_plan": ([_I] * 3 + [_P], _I),
    # counts (5 long long), reset
    "sr3_flash_attention_fwd_tiles": ([_P, _I], _I),
    # q, k, v, g (of dtype), lse, dsum, dk, dv, workspace, BH, S, D, scale,
    # dtype, stream
    "sr3_flash_attention_bwd_dkv": ([_P] * 9 + [_I] * 3 + [_F, _I, _P], _I),
    # q, k, v, g (of dtype), lse, dsum, dq, workspace, BH, S, D, scale,
    # dtype, stream
    "sr3_flash_attention_bwd_dq": ([_P] * 8 + [_I] * 3 + [_F, _I, _P], _I),
    # BH, S, D, dtype, kernel (0: K5, 1: K6)
    "sr3_flash_attention_bwd_workspace_floats": ([_I] * 5, _L),
    # BH, S, D, kernel, out (7 long long)
    "sr3_flash_attention_bwd_plan": ([_I] * 4 + [_P], _I),
    # counts (9 long long), reset
    "sr3_flash_attention_bwd_tiles": ([_P, _I], _I),
}

_lib = None


def find_nvcc():
    """nvcc from $CUDA_HOME / $CUDA_PATH, then $PATH, then the default
    toolkit location; None when there is none."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(env)
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc")
    return default if os.path.isfile(default) else None


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path():
    """Where the library for the current sources and flags is built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsr3_kernels_{h.hexdigest()[:16]}.so")


def build():
    """Compile csrc/*.cu into the shared library unless it already exists.
    Returns its path. Raises RuntimeError when nvcc is missing or fails."""
    out = library_path()
    if os.path.isfile(out):
        return out
    return compile_library(CSRC_DIR, out)


def compile_library(src_dir, out):
    """Compile every ``*.cu`` of ``src_dir`` with NVCC_FLAGS, one nvcc
    process each, all started together, and link them into the shared
    library ``out`` (ptxas' output beside it as ``out + ".log"``). Returns
    ``out``. Raises RuntimeError when nvcc is missing or fails."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the sr3_tpu_torch CUDA kernels are compiled at "
            "first use on a CUDA tensor. Install the CUDA toolkit or point "
            "CUDA_HOME at it (searched $CUDA_HOME, $CUDA_PATH, $PATH and "
            f"{DEFAULT_CUDA_HOME})."
        )
    out_dir = os.path.dirname(os.path.abspath(out))
    os.makedirs(out_dir, exist_ok=True)
    cu = sorted(glob.glob(os.path.join(src_dir, "*.cu")))
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", src_dir, "-c", "-o", o, p]
                for p, o in zip(cu, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [" ".join(c) + "\n" + log
                  for c, proc, log in zip(cmds, procs, logs) if proc.returncode]
        if failed:
            raise RuntimeError("nvcc failed building the sr3_tpu_torch "
                               "kernels:\n" + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        link = [nvcc, *GENCODE, "-shared", "-o", lib, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed linking the sr3_tpu_torch kernels:\n"
                               + " ".join(link) + "\n" + proc.stdout
                               + proc.stderr)
        with open(out + ".log", "w") as f:  # ptxas: registers, spills
            f.write("\n".join(logs))
        os.replace(lib, out)  # atomic: a concurrent loader never sees half
    return out


def bind(lib):
    """Set the ctypes signature of every C entry (_SIGNATURES) on a loaded
    kernel library; returns it."""
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load_library():
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(build()))
    return _lib


def check(err, name):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def dtype_code(t):
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return code


def stream_of(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t):
    """Device pointer of a tensor, or None (NULL) for None."""
    return None if t is None else t.data_ptr()


def needs_grad(*tensors):
    """Whether autograd must record an op on these tensors (None skipped):
    the wrappers then go through their autograd Function."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)

"""Build and load the port's CUDA kernels: `csrc/*.cu` -> one `.so`.

Route (b) of the Hopper build: each source is compiled by `nvcc` for
`sm_90a` into an object (all compiles started together), the objects are
linked into one shared library with a plain C interface, and the library
is loaded with `ctypes`. No source includes PyTorch's headers, so a build
takes seconds and needs neither `ninja` nor `torch.utils.cpp_extension`.

The library is built at first use into `slotdiffusion_tpu_torch/_build/`
(listed in `.gitignore`), in a directory keyed by a hash of the sources
and flags, so a fresh checkout builds everything on its first call and a
changed source never loads a stale library.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes. Each returns cudaGetLastError().
_SIGNATURES = {
    # x, w, b, y, B, C, H*W, groups, eps, silu, the long path's workspace
    # and chunk (null and 0 for runs of up to MAX_GROUP), stream (x, y
    # f32 / bf16)
    "sdt_group_norm_f32": [_P] * 4 + [_I] * 4 + [_F, _I, _P, _I, _P],
    "sdt_group_norm_bf16": [_P] * 4 + [_I] * 4 + [_F, _I, _P, _I, _P],
    # q, k, v, out, B, Nq, Nk, H, D, scale, stream (q, k, v, out f32 / bf16)
    "sdt_mha_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "sdt_mha_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # k, v, slots0, wq, ln_q_scale, ln_q_bias, gru_wi, gru_bi, gru_wh,
    # gru_bh, ln_mlp_scale, ln_mlp_bias, w1, b1, w2, b2, slots_out, mask,
    # B, N, S, D, M, num_iterations, eps, scale, with_mask, then the
    # launch plan: cluster, positions, tile, resident, smem_bytes; stream
    "sdt_sa_iterations_bf16": [_P] * 18 + [_I] * 6 + [_F, _F] + [_I] * 6 +
    [_P],
    # cluster, smem_bytes, int* out: clusters the card runs at once
    "sdt_sa_active_clusters": [_I, _I, _P],
    # w, U^T [16, Fp, Cp], C, F, Fp, Cp, stream
    "sdt_winograd_weights_bf16": [_P, _P] + [_I] * 4 + [_P],
    # x, U^T, V scratch, f32 scratch or NULL, y, B, H, W, C, F, Fp, Cp, Tp,
    # per_split, stream
    "sdt_winograd_conv_bf16": [_P] * 5 + [_I] * 9 + [_P],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from csrc/ at first use")
    return path


def build_dir():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build(verbose=False):
    """Compile csrc/*.cu into `libsdt_kernels.so` unless this source hash
    is already built; returns the library path."""
    out_dir = build_dir()
    lib_path = os.path.join(out_dir, "libsdt_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_ROOT, exist_ok=True)
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-")
    try:
        procs = []
        objs = []
        for src in _sources():
            if not src.endswith(".cu"):
                continue
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            objs.append(obj)
        errors = []
        for src, p in procs:
            out, _ = p.communicate()
            if verbose and out:
                print(out.decode(errors="replace"), flush=True)
            if p.returncode != 0:
                errors.append(f"{src}:\n{out.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = os.path.join(tmp, "libsdt_kernels.so")
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp_lib],
                       check=True)
        os.makedirs(out_dir, exist_ok=True)
        os.replace(tmp_lib, lib_path)  # atomic: a reader sees all or none
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err, name):
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(device):
    """The current CUDA stream of `device`, as the C entry points take it
    (the raw handle PyTorch keeps: a fraction of a microsecond, where
    building a `torch.cuda.Stream` object takes several)."""
    import torch
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def traced(name):
    """Decorate a kernel's launch function: while a torch.profiler trace
    records, each launch runs inside a span named `name` (the kernel's
    `sdt::` operator), so a trace of eager work names the launches as a
    trace of an exported program does; else it costs one flag check."""
    import torch
    enabled = torch.autograd._profiler_enabled

    def wrap(fn):
        @functools.wraps(fn)
        def launch(*args, **kwargs):
            if not enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return launch
    return wrap

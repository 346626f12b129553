"""Builds the port's CUDA sources (`csrc/*.cu`) into shared libraries
at first use and loads them with ctypes.

Each source has a plain C interface, so it compiles with `nvcc` alone
in seconds (no PyTorch headers). The library lands in
`build/cloud_tpu_torch/` at the repository root, named by a hash of
its source, every header under `csrc/` (`*.cuh`) and the flags, so an
edited source or header builds anew and an unchanged tree is reused.
Importing this module needs no `nvcc`: nothing is built until a kernel
is first launched on a CUDA tensor.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "cloud_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
#: ptxas report (registers, shared memory, spills) of each source built
#: by this process, by source name.
build_logs = {}
#: Seconds each of those builds took (they run side by side).
build_seconds = {}
_builds = [0]  # nvcc runs by this process


def build_count():
    """How many sources this process has compiled with nvcc (a resumed
    fit reads it before and after re-entry)."""
    return _builds[0]


def nvcc_path():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's "
            "CUDA kernels are compiled at first use on a machine with "
            "the CUDA toolkit.")
    return path


def sources():
    """Names of the CUDA sources under csrc/ (without `.cu`)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def headers():
    """Names of the headers under csrc/ (`*.cuh`), which any source may
    include."""
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))


def library_path(name):
    digest = hashlib.sha256()
    for f in [name + ".cu"] + headers():
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(f.encode() + b"\0" + fh.read() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "{}-{}.so".format(
        name, digest.hexdigest()[:16]))


def build(names):
    """Compiles every source in `names` whose library is missing, one
    `nvcc` process per source, all started together. Raises with the
    compiler's output if any build fails."""
    missing = [n for n in names if not os.path.exists(library_path(n))]
    if not missing:
        return
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in missing:
        path = library_path(name)
        tmp = "{}.{}.tmp".format(path, os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    start = time.monotonic()

    def wait(name, proc):
        build_logs[name] = proc.communicate()[0]
        build_seconds[name] = time.monotonic() - start

    waiters = [threading.Thread(target=wait, args=(name, proc))
               for name, (proc, _, _) in procs.items()]
    for waiter in waiters:
        waiter.start()
    for waiter in waiters:
        waiter.join()
    _builds[0] += len(procs)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        output = build_logs[name]
        if proc.returncode != 0:
            failed.append("{} (exit {}):\n{}".format(name, proc.returncode,
                                                     output))
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name):
    """The ctypes library built from `csrc/<name>.cu` (built first when
    missing)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib


def check(err, what):
    """Raises when a launch returned a CUDA error (0 = success)."""
    if err != 0:
        raise RuntimeError("{} failed: cudaError_t {}".format(what, err))


__all__ = ["BUILD_DIR", "build", "build_count", "build_logs",
           "build_seconds", "check",
           "headers", "load", "library_path", "sources"]

"""The port's CUDA libraries: their build, loading, launch and tensor check.

Every kernel source of ``csrc/`` is compiled with ``nvcc`` for sm_90a into
``build/`` at its first use (``build_library``), loaded with ``ctypes``
with its entry points declared as data (``load``), and called through
``launch``, which turns a nonzero ``cudaError`` into a ``RuntimeError``.
``check_tensor`` refuses what no kernel takes.  A wrapper module (the
sweep's, the stage's, the EOS's, the cooling's) holds the rest: its source,
its translation units, its entry points' signatures and arguments, its
launch counters and its choice between the kernel and the plain code.
Nothing here builds or loads when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
# device functions that every kernel source includes
HEADERS = (CSRC_DIR / "hydro_device.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# the kernels' dtype codes (csrc/hydro_device.cuh)
KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1}


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from csrc/*.cu on first use")
    return nvcc


def build_library(source, units, *, scalars=False, fmad=False):
    """Compile the kernel source ``source`` of ``csrc/`` for sm_90a into
    ``build/``, one ``nvcc`` process per translation unit of ``units`` (a
    list of ``-D`` flag tuples), all started together, the objects linked
    into one library.  The library is named by the hash of the source, of
    the header it includes and of the unit list, so editing any of them
    rebuilds.  Without FMA contraction (``--fmad=false``), or with it where
    ``fmad`` (a source whose own products and sums are rounded intrinsics,
    so that only the math library's ``pow`` contracts, as it does in
    PyTorch's build; the name is keyed by it).  ``scalars`` marks a
    source's library for decks with scalars
    (``lib<name>_scalars_<hash>.so``).  Returns ``(path, compiler_log)``;
    the log holds ptxas' register and shared memory report, and is empty
    when the library was built before."""
    source = Path(source)
    digest = hashlib.sha256()
    for path in (source,) + HEADERS:
        digest.update(path.read_bytes())
    digest.update(repr([list(unit) for unit in units]).encode())
    if fmad:
        digest.update(b"--fmad=true")
    kind = "_scalars" if scalars else ""
    lib = BUILD_DIR / f"lib{source.stem}{kind}_{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = lib.with_name(f"{lib.stem}.{os.getpid()}.units")
    work.mkdir(exist_ok=True)
    flags = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", f"--fmad={'true' if fmad else 'false'}"]
    procs = []
    for k, defines in enumerate(units):
        obj = work / f"unit{k}.o"
        cmd = flags + ["-Xptxas", "-v", "-Xcompiler", "-fPIC", "-c",
                       *defines, "-o", str(obj), str(source)]
        procs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for obj, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{obj.name} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run(flags + ["-shared", "-o", str(tmp)]
                         + [str(obj) for obj, _ in procs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib, "".join(log)


_loaded = {}


def load(source, units, entries, *, scalars=False, fmad=False):
    """The library of ``build_library(source, units, scalars=scalars,
    fmad=fmad)``, built at its first use and loaded once, with each entry
    point of ``entries`` (``{name: (argtypes, restype)}``) declared."""
    key = (source, bool(scalars), tuple(map(tuple, units)), bool(fmad))
    if key not in _loaded:
        path, _ = build_library(source, units, scalars=scalars, fmad=fmad)
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded[key] = lib
    return _loaded[key]


def launch(fn, *args):
    """Call the entry point ``fn`` (a launch or a query; each returns a
    ``cudaError`` code) and raise ``RuntimeError`` naming it on a nonzero
    code."""
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed with cudaError {rc}")


def occupancy_of(fn, *codes):
    """``(dynamic shared memory in bytes, resident blocks per SM)`` that
    the entry point ``fn`` (a kernel's occupancy query) reports for its
    instantiation of the template codes ``codes`` on the current card."""
    out = (ctypes.c_int * 2)()
    launch(fn, *codes, out)
    return out[0], out[1]


def check_tensor(name, x, contiguous=True):
    """Raise unless ``x`` is a non-empty float32/float64 CUDA tensor of
    five dimensions, contiguous unless the kernel reads it through its
    strides (not ``contiguous``)."""
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} takes float32 or float64, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"{name}: the state must be [nb, nvar, nz, ny, nx], "
                         f"got {list(x.shape)}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")
    if x.numel() == 0:
        # a refined level with no leaves, say (a zero-sized grid is a
        # launch error, not a no-op)
        raise ValueError(f"{name}: an empty state (a level with no blocks) "
                         "never reaches a launch")


def ptxas_summary(compiler_log, kernels=None, occupancy=False):
    """One line per entry function in a ``build_library`` log (of this or
    any checkout's kernels): its name, registers and spills, from ``nvcc
    -Xptxas -v``.  An instantiation ``<kernel>_kernel<T, switches...>`` of
    a kernel in ``kernels`` (``{kernel: (describe, threads, query)}``, from
    the wrappers) is named ``<kernel> <f32|f64> describe(switches)``; any
    other entry function by its mangled name.  With ``occupancy``, each
    such instantiation also gets the dynamic shared memory and resident
    blocks per SM that this checkout's kernel asks the current card for,
    ``query(dtype code, switches)``, and its warps (blocks of
    ``threads``)."""
    kernels = kernels or {}
    pattern = re.compile(
        rf"Compiling entry function .*({'|'.join(kernels) or '(?!)'})"
        r"_kernelI([fd])((?:L[ib]\d+E)+)E")
    lines, current = [], None
    for line in compiler_log.splitlines():
        if m := pattern.search(line):
            k = [int(x) for x in re.findall(r"L[ib](\d+)E", m.group(3))]
            kernel, dtype = m.group(1), "fd".index(m.group(2))
            current = (f"{kernel} {('f32', 'f64')[dtype]} "
                       f"{kernels[kernel][0](k)}")
            spill = ""
        elif m := re.search(r"Compiling entry function '(\w+)'", line):
            current, kernel, spill = m.group(1), None, ""
        elif current and "spill stores" in line:
            spill = line.strip()
        elif current and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            text = f"{current}: {regs} registers, {spill}"
            if occupancy and kernel is not None:
                _, threads, query = kernels[kernel]
                smem, blocks = query(dtype, k)
                text += (f"; {smem} bytes of dynamic shared memory, "
                         f"{blocks} blocks = {threads // 32 * blocks} warps "
                         "per SM")
            lines.append(text)
            current = None
    return lines

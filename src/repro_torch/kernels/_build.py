"""Building the port's kernels from the sources in the tree, at first use.

* CUDA C++ sources (``csrc/*.cu``, with the ``csrc/*.cuh`` headers beside
  them and the shared ``kernels/csrc/*.cuh`` they include) are compiled by
  ``nvcc`` into a shared library with a plain C interface, for ``sm_90a``,
  and bound with ``ctypes``.  No PyTorch header is included, so one build
  takes seconds.  The library's file name carries a hash of the source, the
  headers and the flags, so an edited source or header is rebuilt and an
  unchanged one is loaded as it is.
* Triton kernels generated at run time are written as modules into the
  build directory (``@triton.jit`` reads its function's source from a real
  file) and imported from there.  Triton's own cache of compiled binaries
  is kept in the build directory too.

Everything goes into ``build/`` at the root of the source tree, which
``.gitignore`` lists.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from types import ModuleType

#: ``src/repro_torch/kernels/_build.py`` -> the root of the source tree.
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build"

NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC")

#: Flags of one source beyond :data:`NVCC_FLAGS`, by file name.  The
#: wgmma kernels encode their TMA tensor maps with the driver API
#: (``-lcuda``, found in the toolkit's ``stubs``); these and the redesigned
#: SSD, nhwc and decode kernels have ptxas report their registers and
#: spills (``-Xptxas -v``), which :func:`build_log` keeps.
SOURCE_FLAGS = {"flash_attention.cu": ("-Xptxas", "-v", "-lcuda"),
                "fused_ce.cu": ("-Xptxas", "-v", "-lcuda"),
                "ssd_intra_chunk.cu": ("-Xptxas", "-v"),
                "fused_nhwc.cu": ("-Xptxas", "-v"),
                "fused_nhwc_bwd.cu": ("-Xptxas", "-v"),
                "flash_decode.cu": ("-Xptxas", "-v"),
                "paged_flash_decode.cu": ("-Xptxas", "-v")}
#: Headers every source may include (``../../csrc/*.cuh``): the Hopper
#: helpers the tensor-core kernels share.
SHARED_HEADERS = Path(__file__).resolve().parent / "csrc"

_LOCK = threading.Lock()
_LIBS: dict[Path, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    pass


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on the ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def source_flags(source: Path) -> tuple[str, ...]:
    """``source``'s own flags, placed after the source file (a library
    named before the code that needs it would be dropped); a ``-lcuda``
    source links against the toolkit's stub of the driver library."""
    extra = SOURCE_FLAGS.get(source.name, ())
    if "-lcuda" in extra:
        home = Path(nvcc()).resolve().parent.parent
        extra = tuple(f"-L{d}" for d in (home / "lib64" / "stubs",
                                         home / "lib" / "stubs")
                      if d.is_dir()) + extra
    return extra


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` lives: keyed on a hash of the
    source text, the headers beside it and the shared ones (``*.cuh``) and
    the compiler flags."""
    headers = [*sorted(source.parent.glob("*.cuh")),
               *sorted(SHARED_HEADERS.glob("*.cuh"))]
    text = source.read_bytes() + b"".join(h.read_bytes() for h in headers)
    flags = NVCC_FLAGS + SOURCE_FLAGS.get(source.name, ())
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / "kernels" / f"{source.stem}-{digest}.so"


def build_log(source: Path) -> str:
    """What nvcc printed when it built ``source``'s library ("" before the
    build)."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def start_build(source: Path) -> subprocess.Popen | None:
    """Start ``nvcc`` on ``source`` in the background, or return None when
    the library is already built.  :func:`finish_build` waits for it; several
    sources can be started together and compile in parallel."""
    out = library_path(source)
    if out.is_file():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source),
           *source_flags(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish_build(source: Path, proc: subprocess.Popen | None) -> Path:
    out = library_path(source)
    if proc is None:
        return out
    log, _ = proc.communicate()
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed on {source} (exit {proc.returncode}):\n"
                         f"{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)                  # atomic: readers never see half
    return out


def load_library(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load the shared library of ``source``; once
    per process (a launch must not re-read and hash the source)."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(finish_build(source, start_build(source))))
            _LIBS[source] = lib
        return lib


def import_generated(stem: str, text: str) -> ModuleType:
    """Write generated Python source under ``build/generated`` (named by a
    hash of the text) and import it."""
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    name = f"{stem}_{digest}"
    with _LOCK:
        mod = sys.modules.get(name)
        if mod is not None:
            return mod
        os.environ.setdefault("TRITON_CACHE_DIR",
                              str(BUILD_DIR / "triton-cache"))
        path = BUILD_DIR / "generated" / f"{name}.py"
        path.parent.mkdir(parents=True, exist_ok=True)
        if not path.is_file() or path.read_text() != text:
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(text)
            os.replace(tmp, path)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
        return mod

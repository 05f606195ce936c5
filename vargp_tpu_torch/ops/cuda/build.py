"""Build and load the hand-written Hopper kernels.

One ``nvcc`` per ``.cu`` file under ``vargp_tpu_torch/csrc``, all started
together, compiles it for ``sm_90a``, and one link makes the objects one
shared library with a plain C interface, loaded with ``ctypes``.  No PyTorch headers are involved, so the build takes
seconds.  It runs at first use, never at import: the library goes into
``vargp_tpu_torch/_build/<hash of the sources and flags>/``, so a changed
source rebuilds and an unchanged one is loaded as it is.

Each kernel is also a PyTorch operator, ``vargp_torch::<name>``
(:func:`kernel_op`): a CUDA implementation (the launch), a CPU one (the
plain version), a fake one (shapes, dtypes and strides, with the real
one's checks, and the refusal of any device but the CPU and the card)
and a cost function, so that ``torch.export`` keeps a launch as one graph
node and ``utils.flops`` bills it by its cost.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from vargp_tpu_torch.utils import tracing

NAMESPACE = "vargp_torch"


class Cost(NamedTuple):
    """One launch's work: the unpadded operations the kernel does, the
    bytes of its inputs read once and its outputs written once, and the
    precision class its operations run in (``utils.flops.PEAKS``:
    ``3xtf32`` on the tensor cores, ``f32`` on the CUDA cores)."""

    flops: int
    bytes: int
    precision: str


# "vargp_torch::<name>" -> cost(*input shapes) -> Cost: the one record of
# each operator's work, read by the FLOP audit and the smoke's bounds
COSTS = {}
_LIB = torch.library.Library(NAMESPACE, "DEF")  # the operators' registrations

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
_LIB_NAME = "libvargp_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # name: argument types; every function returns cudaGetLastError()
    "vargp_sym_gram": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "vargp_sym_gram_tri": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "vargp_cross_gram": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "vargp_diag_chol": (_P, _P, _I, _L, _I, _I, _P),  # in, out, G, batch stride, row stride, h
    "vargp_rbf_gram": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "vargp_rbf_gram_sym": (_P, _P, _P, _I, _I, _I, _P),  # sx, gamma2, out, G, M, D
    "vargp_rbf_gram_small": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "vargp_diag_chol_chunked": (_P, _P, _I, _P),
    "vargp_chol": (_P, _P, _I, _I, _I, _P),  # K, L, G, S, cluster size, stream
    "vargp_chol_inv": (_P, _P, _P, _I, _I, _I, _P),
    "vargp_tri_mm": (_P, _P, _P, _I, _I, _I, _P),  # L, X, out, G, S, N
    # W, v, w, kxx, f_mean, f_var, G, T, M, B, W's and w's row strides, matrices a hyper sample
    "vargp_marginal_moments": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``; raises
    when there is neither."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and /usr/local/cuda/bin): "
        "the CUDA toolkit is needed to build vargp_tpu_torch's kernels"
    )


def library_path() -> Path:
    return BUILD_ROOT / _digest() / _LIB_NAME


def build() -> Path:
    """Compile the kernels unless this exact source set is already built.
    Returns the library's path.  One ``nvcc`` per source, all started
    together, then one link.  Safe against concurrent builds: each
    compiles into its own directory and renames its library into place."""
    import shutil

    so = library_path()
    if so.is_file():
        return so
    nvcc = find_nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    work = so.parent / f"objects.{os.getpid()}"
    work.mkdir(exist_ok=True)
    tmp = so.with_name(f"{_LIB_NAME}.{os.getpid()}.tmp")
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objects = [work / f"{src.stem}.o" for src in sources()]
    jobs = [[nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objects)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in jobs]
        failed = [(cmd, out) for cmd, p in zip(jobs, procs)
                  for out in [p.communicate()[0]] if p.returncode != 0]
        if not failed:
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objects)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                failed.append((cmd, res.stdout + res.stderr))
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("kernel build failed:\n" + "\n".join(
                f"{' '.join(cmd)}\n{out}" for cmd, out in failed))
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


def resource_usage(names: list[str] | None = None, csrc: Path = CSRC) -> str:
    """What ``ptxas -v`` reports for each kernel of the named sources in
    ``csrc`` (all by default): registers, spills, shared memory.  Compiles
    each source to a throwaway object; the library is not touched."""
    import tempfile

    nvcc = find_nvcc()
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(Path(csrc).glob("*.cu")):
            if names and src.name not in names:
                continue
            cmd = [nvcc, *flags, "-Xptxas", "-v", "-c", "-o", f"{tmp}/{src.stem}.o", str(src)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stdout}{res.stderr}")
            out.append(f"== {src.name}\n{res.stdout}{res.stderr}")
    return "\n".join(out)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; anything else raises: tensors on several devices, or on a
    device with no kernel (a real meta tensor among them).  The operators'
    CUDA and fake implementations call it once a call."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {dev}")


def check_f32_contiguous(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: kernels take contiguous float32 tensors, got "
                f"{t.dtype} with strides {t.stride()}"
            )


def kernel_op(name: str, schema: str, *, cpu, cuda, fake, cost):
    """Register one kernel as the operator ``vargp_torch::<name>`` with
    ``schema`` (its arguments and results): ``cpu`` runs for CPU tensors,
    ``cuda`` (the launch) for CUDA tensors, ``fake`` for fake and meta
    tensors (shapes only: it calls :func:`on_cpu`, so a real meta tensor,
    or any device but the CPU and the card, is refused there); ``cost``
    (input shapes -> :class:`Cost`) goes into :data:`COSTS`.  Returns the
    operator, a callable.  ``torch.library.Library``'s define and impl,
    not ``torch.library.custom_op``, whose Python layers around every call
    cost the host more."""
    _LIB.define(f"{name}{schema}")
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    COSTS[f"{NAMESPACE}::{name}"] = cost
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def cost(name: str, *shapes) -> Cost:
    """The operator ``vargp_torch::<name>``'s cost at these input shapes."""
    return COSTS[f"{NAMESPACE}::{name}"](*shapes)


def on_card(t: torch.Tensor) -> bool:
    """True for a tensor on a CUDA device, real or fake."""
    return t.device.type == "cuda"


def result_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """The dtype that the plain versions' arithmetic gives ``tensors``
    (float32 on the card, where the kernels take nothing else)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def launch(name: str, device: torch.device, *args) -> None:
    """Call one kernel launcher on ``device``'s current PyTorch stream,
    raise if CUDA refused the launch, and count it under ``name`` in
    ``utils.tracing.LAUNCHES``."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name}: launch refused") from torch.cuda.CudaError(
            status
        )
    tracing.LAUNCHES[name] += 1


if __name__ == "__main__":
    # python -m vargp_tpu_torch.ops.cuda.build [--csrc DIR] [source.cu ...]:
    # ptxas's report of registers, spills and shared memory per kernel
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", type=Path, default=CSRC)
    ap.add_argument("names", nargs="*")
    args = ap.parse_args()
    print(resource_usage(args.names or None, args.csrc))

"""FLOP and byte audit of one call, op by op, under a ``TorchDispatchMode``.

Counterpart of ``vargp_tpu/utils/flops.py``, which walks a jaxpr.  PyTorch
has no program to walk, so ``audit`` runs the call once and sees every
ATen op that reaches the dispatcher, the backward's too:

- products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot``:
  ``matmul`` and ``einsum`` lower to these; ``linalg_solve_triangular``;
  the Cholesky ``linalg_cholesky_ex``) are grouped by their operands'
  shapes and precision class (``f32``, ``tf32`` when the backend allows
  it, ``f64``, ...);
- data movement (``cat``, ``constant_pad_nd``, ``copy_``, ``clone``, a
  transpose made contiguous, ``index``, ``index_put``, ``scatter``,
  ``gather``, ``index_select``) counts its output's bytes;
- each ``vargp_torch::`` operator (a hand-written kernel) is billed by its
  cost function (``ops.cuda.build.COSTS``) in its own bucket, and the ops
  its body runs (its plain version, on the CPU) are not seen.

Elementwise ops and reductions are not billed, as in the JAX version.  The
speed of light (``sol_ms``) divides each bucket by its peak rate on an
NVIDIA H100 SXM at 700 W (NVIDIA's data sheet), ``PEAKS`` by precision
class: 67 TFLOP/s float32 on the CUDA cores; 495 TFLOP/s TF32 on the
tensor cores, 165 effective for the kernels' 3xTF32 products (three TF32
products for one f32 product); HBM3 at 3.35 TB/s for the bytes moved and
each operator's bytes.  An operator's cost names its own precision class
for the shapes it is given (K5's small f32 kernel up to 16 features, its
3xTF32 tile above).  A bucket's time is the larger of its operations over
their rate and its bytes over the memory rate (for an operator, per
launch); the buckets add.
"""

import collections
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM data sheet, dense, 700 W
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
TF32X3_FLOPS = TF32_FLOPS / 3
HBM_BYTES_PER_S = 3.35e12
# peak operations per second by precision class: the products' (``f32``,
# ``tf32``) and the operators' costs' (``f32``, ``3xtf32``)
PEAKS = {"f32": F32_FLOPS, "tf32": TF32_FLOPS, "3xtf32": TF32X3_FLOPS}
OPERATOR_BUCKET = "vargp_torch"

PRODUCTS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm", "aten::mv", "aten::dot",
            "aten::linalg_solve_triangular", "aten::linalg_cholesky_ex"}
MOVES = {"aten::cat", "aten::constant_pad_nd", "aten::copy_", "aten::clone", "aten::_to_copy",
         "aten::index", "aten::index_put", "aten::index_put_", "aten::scatter",
         "aten::scatter_add", "aten::gather", "aten::index_select"}


def precision(dtype: torch.dtype) -> str:
    """A product's precision class: its dtype's name, ``tf32`` for a float32
    product that the backend may run in TF32."""
    if dtype == torch.float32:
        return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "f32"
    return str(dtype).removeprefix("torch.").replace("float", "f")


def _product_flops(name: str, args) -> int:
    a, b = args[0], args[1] if len(args) > 1 else None
    if name in ("aten::addmm", "aten::baddbmm"):
        a, b = args[1], args[2]
    if name == "aten::dot":
        return 2 * a.shape[0]
    if name == "aten::mv":
        return 2 * a.shape[0] * a.shape[1]
    if name == "aten::linalg_cholesky_ex":
        n = a.shape[-1]
        return math.prod(a.shape[:-2]) * n ** 3 // 3
    if name == "aten::linalg_solve_triangular":  # A (..., n, n) X = B (..., n, k)
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        return math.prod(batch) * a.shape[-1] ** 2 * b.shape[-1]
    batch = math.prod(a.shape[:-2])  # mm: 1
    return 2 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


def bound_s(flops: float, nbytes: float, precision: str) -> tuple[float, str]:
    """The least time for this work on the H100, in seconds, and what sets
    it: the larger of ``flops`` at ``precision``'s peak (``operations``) and
    ``nbytes`` at the memory rate (``bytes``)."""
    t_ops, t_bytes = flops / PEAKS[precision], nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bytes(out) -> int:
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return sum(t.numel() * t.element_size() for t in outs if isinstance(t, torch.Tensor))


class _Audit(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        from vargp_tpu_torch.ops.cuda.build import COSTS

        self.costs = COSTS
        self.dots = collections.Counter()  # ((name, shapes), class) -> flops
        self.moves = collections.Counter()  # op name -> bytes
        self.ops = {}  # operator name -> {flops, bytes, calls}
        self.op_sol_s = 0.0  # the operators' launches, each at its bound

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.name()
        if name in self.costs:
            shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
            cost = self.costs[name](*shapes)
            op = self.ops.setdefault(name, dict(flops=0, bytes=0, calls=0))
            op["flops"] += cost.flops
            op["bytes"] += cost.bytes
            op["calls"] += 1
            self.op_sol_s += bound_s(*cost)[0]
        elif name in PRODUCTS:
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            shapes = tuple(tuple(t.shape) for t in tensors)
            self.dots[((name, shapes), precision(tensors[0].dtype))] += _product_flops(name, args)
        elif name in MOVES:
            self.moves[name] += _bytes(out)
        return out


def audit(fn, *args):
    """Run ``fn(*args)`` once under the audit: returns (summary, dots,
    moves, ops).  ``dots`` maps ((op, operand shapes), precision class) to
    FLOPs, ``moves`` op names to bytes, ``ops`` each ``vargp_torch::``
    operator to {flops, bytes, calls}.  ``summary`` holds ``gflop_<class>``
    per precision class, ``gflop_vargp_torch`` (the operators),
    ``movement_mb`` and ``sol_ms`` (the speed of light on the H100)."""
    mode = _Audit()
    with mode:
        fn(*args)
    by_class = collections.Counter()
    for (_, cls), fl in mode.dots.items():
        by_class[cls] += fl
    mv = sum(mode.moves.values())
    sol = (sum(fl / PEAKS.get(cls, F32_FLOPS) for cls, fl in by_class.items())
           + mv / HBM_BYTES_PER_S + mode.op_sol_s)
    summary = {f"gflop_{cls}": fl / 1e9 for cls, fl in sorted(by_class.items())}
    summary.setdefault("gflop_f32", 0.0)
    summary[f"gflop_{OPERATOR_BUCKET}"] = sum(op["flops"] for op in mode.ops.values()) / 1e9
    summary["operator_mb"] = sum(op["bytes"] for op in mode.ops.values()) / 1e6
    summary["movement_mb"] = mv / 1e6
    summary["sol_ms"] = sol * 1e3
    return summary, mode.dots, mode.moves, mode.ops


def achieved(summary: dict, measured_s: float) -> dict:
    """Achieved TFLOP/s (every bucket's operations over ``measured_s``) and
    the share of the speed of light (``sol_ms`` over the measured time), in
    percent."""
    gf = sum(v for k, v in summary.items() if k.startswith("gflop_"))
    return dict(
        tflops=gf / 1e3 / measured_s,
        pct_sol=100.0 * (summary["sol_ms"] / 1e3) / measured_s,
    )

"""Utilities; counterpart of ``vargp_tpu/utils``: metrics logging,
checkpoints, seeds, the carrying of parameters between numpy and the port
(``convert``), reference-checkpoint migration (``torch_compat``),
predictor export (``export``), device profiles (``profiling``), the
FLOP audit (``flops``) and the spans and launch counters (``tracing``)."""

from vargp_tpu_torch.utils.checkpoint import load_chain, load_pytree, save_chain, save_pytree
from vargp_tpu_torch.utils.logging import MetricsLogger
from vargp_tpu_torch.utils.prng import seed_everything

__all__ = [
    "MetricsLogger",
    "save_chain",
    "load_chain",
    "save_pytree",
    "load_pytree",
    "seed_everything",
]

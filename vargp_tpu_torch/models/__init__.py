"""Model families; counterpart of ``vargp_tpu/models``: pure-function
ELBOs over parameter trees.

- ``vargp``: the paper's method, the auto-regressive continual GP, on the
  inputs or (``dkl``) on an MLP's features;
- ``global_svgp``: the "VAR-GP (Global)" streaming-SVGP baseline;
- ``vargp_retrain``: the retraining ablation (past tasks' variational
  parameters trainable again).
"""

from vargp_tpu_torch.models import global_svgp, vargp, vargp_retrain

__all__ = ["vargp", "global_svgp", "vargp_retrain"]

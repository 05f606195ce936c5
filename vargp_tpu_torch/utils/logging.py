"""Metrics logging; a copy of ``vargp_tpu/utils/logging.py``.

One JSONL line per scalar, ``{tag, value, step, time}``, in
``<log_dir>/metrics.jsonl``; a TensorBoard mirror when
``torch.utils.tensorboard`` imports, and an opt-in W&B mirror
(``wandb=True`` or ``VARGP_TPU_WANDB=1``) when the wandb package is
installed.  Both mirrors are best effort: neither package is required.
"""

import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir: str | None, tensorboard: bool = True,
                 wandb: bool | None = None):
        """``log_dir=None`` gives a logger that writes nothing."""
        self.log_dir = log_dir
        if log_dir is None:
            self._f = self._tb = self._wandb = None
            return
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:
                self._tb = None
        self._wandb = None
        if wandb is None:
            wandb = os.environ.get("VARGP_TPU_WANDB", "") not in ("", "0")
        if wandb:
            try:
                import wandb as _wandb

                self._wandb = _wandb.init(
                    project=os.environ.get("WANDB_PROJECT", "vargp_tpu"),
                    dir=log_dir,
                    mode=os.environ.get("WANDB_MODE", "offline"),
                    reinit=True,
                )
            except Exception:
                self._wandb = None

    def add_scalar(self, tag: str, value: float, step: int = 0) -> None:
        if self._f is None:
            return
        rec = dict(tag=tag, value=float(value), step=int(step), time=time.time())
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step=step)
        if self._wandb is not None:
            self._wandb.log({tag: float(value)}, step=int(step))

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

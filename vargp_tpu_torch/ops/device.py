"""Device resolution for the port's entry points.

``device=None`` means the card.  There is no quiet move to the CPU: with
no CUDA device the call raises, and the CPU (where every kernel wrapper
takes its plain PyTorch version) is used only when the caller asks for it.
"""

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vargp_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"vargp_tpu_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


def check_on_device(device: torch.device, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``device`` (index-agnostic for a
    bare ``cuda``)."""
    for t in tensors:
        if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index
        ):
            raise ValueError(f"tensor on {t.device}, expected {device}")

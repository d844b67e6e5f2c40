"""Device resolution and float32 precision switches of the port.

Every entry point takes an explicit ``device``. The default is the card:
``"cuda"`` raises when CUDA is absent instead of falling back to the CPU.
``"cpu"`` is the parity path the tests use; there every hand-written
kernel's wrapper runs its plain PyTorch version.

TF32 is turned off for matmul and cuDNN here, once, so a float32 product on
the card keeps float32 precision like XLA's on the CPU.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names an absent card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' for the plain-PyTorch parity path"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; expected cuda or cpu")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)

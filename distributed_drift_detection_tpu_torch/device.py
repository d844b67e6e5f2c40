"""Device resolution and float32 precision switches of the port.

Every entry point takes an explicit ``device``. The default is the card:
``"cuda"`` raises when CUDA is absent instead of falling back to the CPU.
``"cpu"`` is the parity path the tests use; there every hand-written
kernel's wrapper runs its plain PyTorch version.

The entry points that run on a device mesh (``parallel/mesh.py``) also take
a sequence of devices, which may repeat one (``["cpu"] * 8`` stands in for
the JAX package's eight virtual CPU devices, ``["cuda:0"] * 4`` is a
four-shard mesh on one card). :func:`resolve_devices` gives an entry
point's devices: a sequence as it is, ``"cuda"`` every visible card (the
port's ``jax.devices()``), any other single device itself.

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


def is_device_sequence(device) -> bool:
    """Whether ``device`` is a sequence of devices rather than one."""
    return isinstance(device, (list, tuple))


def resolve_devices(device="cuda") -> "list[torch.device]":
    """The devices an entry point may shard over: each entry of a sequence
    (:func:`resolve_device`), every visible card for ``"cuda"`` without an
    index, else the one device."""
    if is_device_sequence(device):
        if not device:
            raise ValueError("an empty device sequence")
        return [resolve_device(d) for d in device]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)

"""Device selection — the port's counterpart of `tpu_tree_search/ops/backend.py`.

The JAX package resolves a kernel *flavor* per platform from a knob matrix
(``TTS_KERNEL_BACKEND``). The port has one flavor per device: a CUDA tensor
goes to the hand-written kernels, a CPU tensor to their plain PyTorch
versions. What remains to resolve is the device itself: ``cuda`` unless the
caller asks for ``cpu``, and never a silent fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` means ``cuda``. A CUDA device that is not there raises instead
    of falling back to the CPU; ``"cpu"`` is honoured only when asked for.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def resolve_devices(devices) -> list[torch.device]:
    """A list of device positions (``resolve_device`` each; entries may
    repeat a card), all cards or all the CPU. A card that is not there
    raises."""
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("the device list is empty")
    if len({d.type for d in out}) > 1:
        raise ValueError("a device list holds cards or the CPU, not both: "
                         f"{[str(d) for d in out]}")
    missing = [str(d) for d in out
               if d.type == "cuda" and d.index >= torch.cuda.device_count()]
    if missing:
        raise ValueError(f"no card {', '.join(missing)}: this machine has "
                         f"{torch.cuda.device_count()}")
    return out


def profile_backend(device=None) -> str:
    """The cost-model profile key's backend of a run on ``device`` (the JAX
    ``profile_backend``): ``gpu`` on the card, ``cpu`` on the CPU; None
    means the card when there is one."""
    if device is None:
        return "gpu" if torch.cuda.is_available() else "cpu"
    return "gpu" if torch.device(device).type == "cuda" else "cpu"

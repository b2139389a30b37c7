"""PyTorch/CUDA port of the HuSCF-GAN system.

The package mirrors the module layout of the JAX package ``repro`` so
that ``repro_torch.X`` is the counterpart of ``repro.X``. It imports
torch and numpy only. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; asking for CUDA on a machine without it raises.
"""
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA that is asked for and
    missing is an error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev

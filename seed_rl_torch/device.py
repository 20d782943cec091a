"""Device selection: the card by default, the CPU only when asked for."""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; raises if that is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "seed_rl_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or --device=cpu) to run on the CPU"
        )
    return device

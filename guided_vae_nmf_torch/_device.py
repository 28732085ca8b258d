"""Device choice for the port's entry points: the GPU unless the caller
names another device. Without a GPU an entry point raises; it never moves
to the CPU on its own."""

import torch


def resolve_device(device=None):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda")

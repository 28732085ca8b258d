"""Precisions of the reference: "f64" (the reference itself), "f32", and
"tf32" (the control: each product's operands rounded to TF32's 10-bit
significand, the products summed in float32, as the tensor cores do with
TF32 on)."""

import torch

PRECISIONS = ("f64", "f32", "tf32")


def dtype(prec):
    if prec not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{prec!r}")
    return torch.float64 if prec == "f64" else torch.float32


def round_tf32(x):
    """float32 x rounded to the nearest TF32 value (ties to even), held as
    float32."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(
        torch.float32)


def cast(x, prec):
    return torch.as_tensor(x).to(dtype(prec))


def mm(a, b, prec):
    """a @ b in the precision (both operands already in its dtype)."""
    if prec == "tf32":
        return round_tf32(a) @ round_tf32(b)
    return a @ b

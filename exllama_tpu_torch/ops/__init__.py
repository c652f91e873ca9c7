"""Operators of the port: kernel wrappers with their plain versions."""

import contextlib

import torch


@contextlib.contextmanager
def full_f32_matmul():
    """The plain versions' f32 (and exact integer-valued) products in full
    precision on the card as well: TF32 off inside, the process-wide switch
    restored on the way out."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was

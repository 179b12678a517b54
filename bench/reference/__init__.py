"""Plain PyTorch references of the benchmark's configurations, in fp32 with
TF32 off. They import nothing of the program (``repro_torch``) and take
nothing it made: the benchmark hands them the inputs it made itself."""
import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """fp32 matmuls without TF32 while open."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved

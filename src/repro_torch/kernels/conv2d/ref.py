"""Plain PyTorch version of the conv2d kernel: the math of
``repro/kernels/conv2d/ref.py``, a VALID convolution with f32 accumulation
and one rounding to the input dtype.  Layouts stay the reference's (NHWC
input, HWIO weights); only this function permutes, locally, to the
NCHW / OIHW views ``F.conv2d`` takes."""
import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1
           ) -> torch.Tensor:
    """x: (N, Hp, Wp, C), already padded; w: (kh, kw, C, K) ->
    (N, Ho, Wo, K) in x's dtype, Ho = (Hp - kh) // stride + 1."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 stride=stride)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)

"""Plain PyTorch version of the blocked matmul kernel."""
import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (M, K), b: (K, N) -> (M, N) in a's dtype, f32 accumulation."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)

"""The ``fail_prob_rows`` kernel's order of additions, in plain PyTorch.

Not a test module: ``test_torch_fail_prob.py`` holds this order to
``torch.sum``'s on the CPU, and ``test_torch_kernels_cuda.py`` holds the
kernel to it bit for bit on the card.  The order (``csrc/fail_prob.cu``), for
each (DIMM, row) of a (D, M, R, C) grid:

* a quad: ``((c[4k] + c[4k+1]) + c[4k+2]) + c[4k+3]``, cells past C adding 0;
* over the mats, from 0: ``u[k] = (((0 + q[0][k]) + q[1][k]) + ...)``;
* 128 slots, from 0: ``s[j] = ((0 + u[j]) + u[j+128]) + ...``;
* the tree: ``s[j] += s[j+h]`` for h = 64, 32, ..., 1; the row's sum is s[0].

Every step is an elementwise float32 add, which rounds alike on both.
"""
import torch

SLOTS = 128


def kernel_order_row_sums(grid: torch.Tensor) -> torch.Tensor:
    """(D, M, R, C) float32 grid -> (D, R) row sums in the kernel's order."""
    D, M, R, C = grid.shape
    quads = -(-C // 4)
    cells = torch.zeros((D, M, R, 4 * quads), dtype=grid.dtype, device=grid.device)
    cells[..., :C] = grid
    q = ((cells[..., 0::4] + cells[..., 1::4]) + cells[..., 2::4]) + cells[..., 3::4]
    u = torch.zeros((D, R, quads), dtype=grid.dtype, device=grid.device)
    for m in range(M):
        u = u + q[:, m]
    blocks = -(-quads // SLOTS)
    padded = torch.zeros((D, R, blocks * SLOTS), dtype=grid.dtype, device=grid.device)
    padded[..., :quads] = u
    s = torch.zeros((D, R, SLOTS), dtype=grid.dtype, device=grid.device)
    for b in range(blocks):
        s = s + padded[..., b * SLOTS:(b + 1) * SLOTS]
    h = SLOTS // 2
    while h:
        s = s[..., :h] + s[..., h:2 * h]
        h //= 2
    return s[..., 0]

"""Batched SPD solve: ``x[i] = a[i]⁻¹ b[i]`` for the ALS normal equations.

Port of ``incubator_predictionio_tpu/ops/pallas_kernels.py``
(``batched_spd_solve``, :197). For 1 ≤ k ≤ 128 the solve is the
normalization-free Gauss-Jordan elimination of the reference:

- on a CUDA tensor, the hand-written kernels of ``csrc/gauss_jordan.cu``
  (built with ``nvcc`` for ``sm_90a`` at first use, bound with ``ctypes``):
  the warp kernel for k ≤ 32, the wide kernel for 32 < k ≤ 128;
- on a CPU tensor, its plain PyTorch version :func:`gauss_jordan_plain`,
  the same arithmetic as the reference's ``_gj_eliminate`` (:37).

For k > 128 both devices use batched Cholesky (``torch.linalg.cholesky`` +
``cholesky_solve``), which is the reference's own rule for that range
(``_solve_reference``, :191), not a fallback. A CUDA tensor never reaches
the plain version: it launches the kernel or raises.

Padding follows the reference (:222-240): k is rounded up to a multiple
of 8 with an identity diagonal in the padding, so padded coordinates solve
to 0 and do not couple to the real ones. The batch needs no padding on the
card: both kernels loop over the systems there are (the reference pads the
batch with identity systems for its 512- and 128-wide slabs).
"""

from __future__ import annotations

import ctypes
import threading

import torch

#: largest k the Gauss-Jordan kernels take (a k = 128 system is a 64 KB
#: register tile of one 256-thread block); larger systems take the Cholesky
#: rule
MAX_GJ_K = 128


class LaunchCounter:
    """Counts kernel launches, so a run can show it went through the kernel."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        with _count_lock:
            self.count = 0


#: the counters are ticked from every thread that solves (the engine
#: server's fold-in thread among them) while others read or reset them
_count_lock = threading.Lock()


#: one tick per launch of either Gauss-Jordan CUDA kernel, and nowhere else
gauss_jordan_launches = LaunchCounter()
#: one tick per launch of the warp kernel (k ≤ 32)
gauss_jordan_warp_launches = LaunchCounter()
#: one tick per launch of the wide kernel (32 < k ≤ 128)
gauss_jordan_wide_launches = LaunchCounter()

#: largest k the warp kernel takes; the wide kernel takes the rest up to
#: :data:`MAX_GJ_K`
MAX_WARP_K = 32


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def gauss_jordan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: normalization-free Gauss-Jordan in torch
    ops, batch first (a [N, k, k], b [N, k] → x [N, k]).

    Pivot rows are never scaled: at step j row j's own factor is masked to
    zero, so row j survives verbatim; after k steps A is diagonal and one
    divide by the diagonal gives x (the reference's ``_gj_eliminate``).
    """
    a = a.to(torch.float32).clone()
    b = b.to(torch.float32).clone()
    k = a.shape[-1]
    rows = torch.arange(k, device=a.device)
    for j in range(k):
        rowj = a[:, j, :].clone()                    # [N, k] raw pivot row
        inv = 1.0 / a[:, j, j]                        # [N]
        bj = b[:, j].clone()                          # [N]
        f = a[:, :, j] * inv[:, None]                 # [N, k] column j
        f = torch.where(rows[None, :] == j, torch.zeros_like(f), f)
        a -= f[:, :, None] * rowj[:, None, :]
        b -= f * bj[:, None]
    return b / torch.diagonal(a, dim1=1, dim2=2)


def cholesky_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky solve: the rule for k > 128 (``_solve_reference``)."""
    chol = torch.linalg.cholesky(a.to(torch.float32))
    return torch.cholesky_solve(b.to(torch.float32)[..., None], chol)[..., 0]


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from ._build import load_library

        lib = load_library("gauss_jordan")
        lib.pio_gauss_jordan_solve.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.pio_gauss_jordan_solve.restype = ctypes.c_int
        _lib = lib
    return _lib


def build_kernel() -> None:
    """Build and load the CUDA kernels now (they are otherwise built at
    first use)."""
    _kernel_lib()


def _pad(a: torch.Tensor, b: torch.Tensor, kp: int):
    """Reference padding of k to kp: identity diagonal in the padded
    coordinates, zeros elsewhere in them and in b."""
    n, k = b.shape
    if kp == k:
        return a, b
    ap = torch.zeros((n, kp, kp), dtype=torch.float32, device=a.device)
    ap[:, :k, :k] = a
    idx = torch.arange(k, kp, device=a.device)
    ap[:, idx, idx] = 1.0
    bp = torch.zeros((n, kp), dtype=torch.float32, device=a.device)
    bp[:, :k] = b
    return ap, bp


def gauss_jordan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel for k (warp or wide) on contiguous, 16-byte
    aligned float32 CUDA tensors (a [N, k, k], b [N, k], k a multiple of 8
    in [8, 128])."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"CUDA kernel needs a and b on one CUDA device, got "
                         f"{a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"CUDA kernel takes float32, got {a.dtype}/{b.dtype}")
    n, k = b.shape
    if a.shape != (n, k, k) or k % 8 or not 8 <= k <= MAX_GJ_K:
        raise ValueError(f"bad shapes a {tuple(a.shape)}, b {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("CUDA kernel needs contiguous a and b")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("CUDA kernel needs 16-byte aligned a and b")
    lib = _kernel_lib()
    x = torch.empty((n, k), dtype=torch.float32, device=a.device)
    if n == 0:
        return x
    index = a.device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(lib, a, b, x, index)
    return _launch(lib, a, b, x, index)


def _launch(lib, a, b, x, index: int) -> torch.Tensor:
    # the raw handle of PyTorch's current stream (what Triton's launcher
    # reads too): a fraction of the cost of building a torch.cuda.Stream
    stream = torch._C._cuda_getCurrentRawStream(index)
    n, k = b.shape
    err = lib.pio_gauss_jordan_solve(a.data_ptr(), b.data_ptr(), x.data_ptr(),
                                     n, k, stream)
    if err != 0:
        raise RuntimeError(f"gauss_jordan kernel launch failed: CUDA error {err}")
    count_launch(k)
    return x


def count_launch(k: int) -> None:
    """One launch of a Gauss-Jordan kernel for width ``k``: the total and
    that kernel's own counter tick together, under one lock."""
    with _count_lock:
        gauss_jordan_launches.count += 1
        if k <= MAX_WARP_K:
            gauss_jordan_warp_launches.count += 1
        else:
            gauss_jordan_wide_launches.count += 1


def batched_spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve N independent SPD systems a[i] @ x[i] = b[i].

    a [N, k, k], b [N, k] → x [N, k] float32, on a's device.
    """
    if a.ndim != 3 or b.ndim != 2 or a.shape[0] != b.shape[0] \
            or a.shape[1] != a.shape[2] or a.shape[2] != b.shape[1]:
        raise ValueError(f"bad shapes a {tuple(a.shape)}, b {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    k = b.shape[1]
    if k > MAX_GJ_K:
        return cholesky_solve(a, b)
    if a.dtype != torch.float32:
        a = a.float()
    if b.dtype != torch.float32:
        b = b.float()
    kp = _round_up(k, 8)
    if kp != k:
        a, b = _pad(a, b, kp)
    if a.device.type == "cpu":
        x = gauss_jordan_plain(a, b)
    elif a.device.type == "cuda":
        a, b = a.contiguous(), b.contiguous()
        if a.data_ptr() % 16:  # a view at an odd offset: the kernel loads 16 B
            a = a.clone()
        if b.data_ptr() % 16:
            b = b.clone()
        x = gauss_jordan_cuda(a, b)
    else:
        raise ValueError(f"unsupported device {a.device}")
    return x if kp == k else x[:, :k]

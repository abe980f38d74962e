"""The port's SPD solve (incubator_predictionio_torch/ops/spd_solve.py)
against the JAX reference (ops/pallas_kernels.py) on the CPU.

The port's CPU path is the plain PyTorch Gauss-Jordan, the same arithmetic
as the CUDA kernel; it is held to both the reference's XLA Cholesky
(``_solve_reference``) and its Pallas Gauss-Jordan in interpret mode, at
the reference's own tolerance (rtol = atol = 2e-4,
tests/test_pallas_kernels.py). The CUDA kernel itself is held to the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.ops.pallas_kernels import (  # noqa: E402
    _solve_reference,
    batched_spd_solve as ref_batched_spd_solve,
)
from incubator_predictionio_torch.device import resolve_device  # noqa: E402
from incubator_predictionio_torch.ops import spd_solve  # noqa: E402

TOL = 2e-4


def _random_spd(n, k, seed=0):
    """The reference test's systems: M Mᵀ + I, numpy from a seed."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, k, k)).astype(np.float32)
    a = np.einsum("nij,nkj->nik", m, m) + np.eye(k, dtype=np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    return a, b


def _port(a, b):
    return spd_solve.batched_spd_solve(torch.from_numpy(a),
                                       torch.from_numpy(b)).numpy()


CASES = [(5, 10), (300, 32), (130, 7), (1, 1), (513, 16), (40, 80),
         (24, 128), (9, 100)]


@pytest.mark.parametrize("n,k", CASES)
def test_plain_matches_reference_cholesky(n, k):
    a, b = _random_spd(n, k, seed=n + k)
    x_ref = np.asarray(_solve_reference(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(_port(a, b), x_ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n,k", CASES)
def test_plain_matches_reference_pallas_interpret(n, k):
    a, b = _random_spd(n, k, seed=n + k)
    x_pal = np.asarray(ref_batched_spd_solve(
        jnp.asarray(a), jnp.asarray(b), use_pallas=True, interpret=True))
    np.testing.assert_allclose(_port(a, b), x_pal, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [511, 513, 1025])
def test_batches_straddling_512(n):
    a, b = _random_spd(n, 8, seed=n)
    x_ref = np.asarray(_solve_reference(jnp.asarray(a), jnp.asarray(b)))
    x_pal = np.asarray(ref_batched_spd_solve(
        jnp.asarray(a), jnp.asarray(b), use_pallas=True, interpret=True))
    x = _port(a, b)
    assert x.shape == (n, 8)
    np.testing.assert_allclose(x, x_ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(x, x_pal, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n,k", [(6, 129), (3, 140)])
def test_above_128_uses_cholesky(n, k, monkeypatch):
    a, b = _random_spd(n, k, seed=k)

    def no_gj(*_a, **_k):
        raise AssertionError("Gauss-Jordan used above k=128")

    monkeypatch.setattr(spd_solve, "gauss_jordan_plain", no_gj)
    x_ref = np.asarray(_solve_reference(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(_port(a, b), x_ref, rtol=TOL, atol=TOL)


def test_padding_rules():
    """k rounds up to a multiple of 8 with an identity diagonal in the
    padding; padded coordinates solve to 0 and leave the rest unchanged."""
    a, b = _random_spd(3, 5, seed=1)
    ap, bp = spd_solve._pad(torch.from_numpy(a), torch.from_numpy(b), 8)
    eye = torch.eye(8)
    assert torch.equal(ap[:, 5:, 5:], eye[5:, 5:].expand(3, 3, 3))
    assert torch.equal(ap[:, :5, 5:], torch.zeros(3, 5, 3))
    assert torch.equal(ap[:, 5:, :5], torch.zeros(3, 3, 5))
    assert torch.equal(bp[:, 5:], torch.zeros(3, 3))
    x = spd_solve.gauss_jordan_plain(ap, bp)
    assert torch.equal(x[:, 5:], torch.zeros(3, 3))
    x_ref = np.asarray(_solve_reference(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(x[:, :5].numpy(), x_ref, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(x[:, :5].numpy(), _port(a, b))


def test_cpu_path_launches_no_kernel():
    a, b = _random_spd(20, 16, seed=4)
    before = spd_solve.gauss_jordan_launches.count
    _port(a, b)
    assert spd_solve.gauss_jordan_launches.count == before


def test_launch_counters_are_exact_across_threads():
    """The fold-in thread launches while serving threads read: the three
    counters tick together under one lock, with no lost update."""
    import sys
    import threading

    counters = (spd_solve.gauss_jordan_launches,
                spd_solve.gauss_jordan_warp_launches,
                spd_solve.gauss_jordan_wide_launches)
    before = [c.count for c in counters]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # preempt as often as the interpreter can
    try:
        threads = [threading.Thread(target=lambda k=k: [
            spd_solve.count_launch(k) for _ in range(5_000)])
            for k in (8, 16, 32, 40, 64, 128, 32, 128)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    got = [c.count - b for c, b in zip(counters, before)]
    assert got == [40_000, 20_000, 20_000]


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()


def test_kernel_wrapper_refuses_cpu_tensors():
    """A CPU tensor handed to the kernel itself raises: only the wrapper
    chooses the plain version, and only for CPU tensors."""
    a, b = _random_spd(8, 8, seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        spd_solve.gauss_jordan_cuda(torch.from_numpy(a), torch.from_numpy(b))


def test_bad_shapes_raise():
    a, b = _random_spd(4, 6, seed=3)
    with pytest.raises(ValueError):
        spd_solve.batched_spd_solve(torch.from_numpy(a),
                                    torch.from_numpy(b[:, :5]))
    with pytest.raises(ValueError):
        resolve_device("mps")

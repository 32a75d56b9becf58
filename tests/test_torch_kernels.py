"""
ES kernel and correction of the torch port against the JAX package's
(``ops/kernels.py``): numpy copies equal, torch twins within 1e-6
relative (float32 transcendental rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.ops import kernels as jk
from ska_sdp_cip_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)


@pytest.mark.parametrize("epsilon", [1e-3, 1e-4, 1e-5])
@pytest.mark.parametrize("sigma", [1.5, 2.0])
def test_host_rules_match(epsilon, sigma):
    support = tk.kernel_support_for_epsilon(epsilon, sigma)
    assert support == jk.kernel_support_for_epsilon(epsilon, sigma)
    assert tk.es_beta(support, sigma) == jk.es_beta(support, sigma)
    nodes, folded = tk.gauss_legendre_kernel_quadrature(
        support, tk.es_beta(support, sigma)
    )
    ref_nodes, ref_folded = jk.gauss_legendre_kernel_quadrature(
        support, jk.es_beta(support, sigma)
    )
    np.testing.assert_array_equal(nodes, ref_nodes)
    np.testing.assert_array_equal(folded, ref_folded)


@pytest.mark.parametrize("support", [6, 8])
def test_es_kernel_matches_numpy_and_jnp(support):
    """
    In float64 the torch twin is the numpy kernel to rounding; in
    float32 it matches the jnp twin (both round the same float32
    arithmetic; against float64 they differ by ~beta * 2^-24).
    """
    beta = tk.es_beta(support)
    z = np.concatenate(
        [np.linspace(-1.2, 1.2, 2001), [-1.0, 1.0, 0.0]]
    )
    ref = jk.es_kernel_np(z, beta)
    ours64 = tk.es_kernel(torch.from_numpy(z), beta).numpy()
    # |z| == 1 exactly: zero in the torch (and jnp) form, exp(-beta)
    # (~1e-6 of the peak) in the closed numpy form.
    inner = np.abs(z) != 1.0
    np.testing.assert_allclose(ours64[inner], ref[inner], rtol=1e-12)
    assert (ours64[~inner] == 0).all()
    z32 = z.astype(np.float32)
    ours32 = tk.es_kernel(torch.from_numpy(z32), beta).numpy()
    jnp_ref = np.asarray(jk.es_kernel_jnp(jnp.asarray(z32), beta))
    np.testing.assert_allclose(ours32, jnp_ref, rtol=1e-6, atol=1e-7)


def test_correction_matches_jnp_and_numpy():
    support = 6
    beta = tk.es_beta(support)
    nodes, folded = tk.gauss_legendre_kernel_quadrature(support, beta)
    rng = np.random.default_rng(3)
    k = rng.uniform(-0.3, 0.3, size=(32, 48)).astype(np.float32)
    nodes32, folded32 = nodes.astype(np.float32), folded.astype(np.float32)
    ours = tk.correction(
        torch.from_numpy(k),
        torch.from_numpy(nodes32),
        torch.from_numpy(folded32),
        support,
    ).numpy()
    ref = np.asarray(
        jk.correction_jnp(
            jnp.asarray(k), jnp.asarray(nodes32), jnp.asarray(folded32),
            support,
        )
    )
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    exact = tk.correction_np(k.astype(np.float64), support, beta)
    np.testing.assert_allclose(exact, jk.correction_np(k, support, beta))
    np.testing.assert_allclose(ours, exact, rtol=1e-5)

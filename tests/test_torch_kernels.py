"""The torch port's smoothing kernels against the JAX package's: W and
(1/r) dW/dr for Lucy, cubic, quintic and Wendland C2, in 2D and 3D, on the
same seeded float32 (r, cut) samples — inside, at and beyond the support,
and at r = 0.

Both sides evaluate the same float32 operations in the same order, so
agreement is to a few ulps: rtol 1e-6, atol 1e-6 times the largest
magnitude of the sample set."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph import kernels as jk

from tpusph_torch import kernels as tk

KERNELS = (tk.LUCY, tk.CUBIC_SPLINE, tk.QUINTIC_SPLINE, tk.WENDLAND_C2)


def samples(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    cut = rng.choice(np.float32([0.55, 1.1, 3.0]), n).astype(np.float32)
    r = (rng.uniform(0, 1.2, n) * cut).astype(np.float32)
    r[:8] = 0.0
    r[8:16] = cut[8:16]
    return r, cut


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dim", [2, 3])
def test_kernels_match_reference(kernel, dim):
    r, cut = samples(seed=kernel * 10 + dim)
    for jfn, tfn in ((jk.kernel_w, tk.kernel_w),
                     (jk.kernel_wfd, tk.kernel_wfd)):
        ref = np.asarray(jfn(kernel, dim)(jnp.asarray(r), jnp.asarray(cut)))
        got = tfn(kernel, dim)(torch.from_numpy(r),
                               torch.from_numpy(cut)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())


"""The torch port's fix-meso half-steps against the JAX package's, on the
same seeded state: both half-steps including the Kahan-compensated rho/e
ledgers and the stationary (mobile = False) and dead rows.

Every operation is elementwise float32 in the same order on both sides,
so the results must agree bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusph import integrate as jint
from tpusph.state import Box as JBox
from tpusph.state import ParticleState as JState

from tpusph_torch import integrate
from tpusph_torch.state import state_from_numpy, state_to_numpy


def random_state(n=1000, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    return dict(
        x=rng.uniform(0, 10, (n, 3)).astype(np.float32), v=f32(n, 3),
        vest=f32(n, 3), f=f32(n, 3),
        rho=rng.uniform(0.5, 1.5, n).astype(np.float32), drho=f32(n),
        e=rng.uniform(0.5, 2.0, n).astype(np.float32), de=f32(n),
        cv=np.ones(n, np.float32),
        rmass=rng.uniform(0.05, 1.0, n).astype(np.float32),
        type=rng.integers(0, 3, n).astype(np.int32),
        tag=np.arange(1, n + 1, dtype=np.int32),
        mobile=rng.uniform(size=n) > 0.2, owned=np.ones(n, bool),
        vir=np.zeros(n, np.float32), rho_c=f32(n) * 1e-7,
        e_c=f32(n) * 1e-7)


@pytest.mark.parametrize("dt", [5e-3, 2e-3])
def test_half_steps_bitwise(dt):
    arrays = random_state()
    jst = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tst = state_from_numpy(arrays)
    box = JBox.create([0, 0, 0], [10, 10, 10])
    for _ in range(3):
        jst = jint.final_integrate(jint.initial_integrate(jst, dt, box), dt)
        tst = integrate.final_integrate(integrate.initial_integrate(tst, dt),
                                        dt)
    ref = jax.device_get(jst)
    got = state_to_numpy(tst)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(got[f.name],
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)


def test_kahan_ledger_keeps_lost_bits():
    """1e4 increments far below ulp(rho): the compensated sum tracks the
    float64 total where a plain float32 sum would not move at all."""
    arrays = random_state(n=64, seed=1)
    arrays.update(rho=np.ones(64, np.float32), rho_c=np.zeros(64, np.float32),
                  drho=np.full(64, 2e-5, np.float32),
                  type=np.ones(64, np.int32))
    st = state_from_numpy(arrays)
    dt = 1e-3
    for _ in range(5000):
        st = integrate.final_integrate(st, dt)
    # 5000 half-steps of 0.5 * 1e-3 * 2e-5 = 5e-5 in total
    got = st.rho.double() - st.rho_c.double()
    np.testing.assert_allclose(got.numpy(), 1.0 + 5e-5, rtol=0, atol=1e-10)

"""SPH velocity-Verlet integration — the ``fix meso`` / ``fix
meso/stationary`` step of ``tpusph/integrate.py`` on torch tensors
(src/USER-SPH/fix_meso.cpp; the ``mobile`` mask covers both fixes).

  initial_integrate:  e += dtf*de; rho += dtf*drho (Kahan ledgers)
                      vest = v + 2*dtf/m * f; v += dtf/m * f; x += dt * v
  final_integrate:    v += dtf/m * f; e += dtf*de; rho += dtf*drho

Every operation is its own eager torch op, so IEEE order is kept and the
two-sum compensation is never folded away. Do not compile these functions
or build them with fast-math. ``dtf / m`` divides a filled tensor: torch
evaluates a Python scalar over a tensor as reciprocal-times-scalar.
"""

from __future__ import annotations

import dataclasses

import torch

from tpusph_torch.state import ParticleState


def _kahan_add(acc, comp, inc):
    """Compensated acc += inc (two-sum): fp32 ``rho += dtf*drho`` rounds
    at ulp(acc) per add, a random walk past 1e-3 relative over 5k steps
    (the 1e-4 accuracy gate); the compensation keeps the lost bits."""
    y = inc - comp
    t = acc + y
    comp = (t - acc) - y
    return t, comp


def initial_integrate(state: ParticleState, dt: float) -> ParticleState:
    dtf = 0.5 * dt
    alive = state.alive
    move = alive & state.mobile
    movef = move[:, None]
    e, e_c = _kahan_add(state.e, state.e_c,
                        torch.where(alive, dtf * state.de, 0.0))
    rho, rho_c = _kahan_add(state.rho, state.rho_c,
                            torch.where(alive, dtf * state.drho, 0.0))
    m_safe = torch.where(move, state.rmass, 1.0)
    dtfm = (torch.full_like(m_safe, dtf) / m_safe)[:, None]
    vest = torch.where(movef, state.v + 2.0 * dtfm * state.f, state.vest)
    v = torch.where(movef, state.v + dtfm * state.f, state.v)
    # positions are NOT wrapped here: like Domain::pbc they wrap only at a
    # rebuild, so the strip layout's image topology holds between rebuilds
    x = torch.where(movef, state.x + dt * v, state.x)
    return dataclasses.replace(state, x=x, v=v, vest=vest, e=e, rho=rho,
                               e_c=e_c, rho_c=rho_c)


def final_integrate(state: ParticleState, dt: float) -> ParticleState:
    dtf = 0.5 * dt
    alive = state.alive
    move = alive & state.mobile
    m_safe = torch.where(move, state.rmass, 1.0)
    dtfm = (torch.full_like(m_safe, dtf) / m_safe)[:, None]
    v = torch.where(move[:, None], state.v + dtfm * state.f, state.v)
    e, e_c = _kahan_add(state.e, state.e_c,
                        torch.where(alive, dtf * state.de, 0.0))
    rho, rho_c = _kahan_add(state.rho, state.rho_c,
                            torch.where(alive, dtf * state.drho, 0.0))
    return dataclasses.replace(state, v=v, e=e, rho=rho, e_c=e_c,
                               rho_c=rho_c)

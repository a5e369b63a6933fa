"""Marsaglia universal RNG — seed-stream parity for `velocity ... create`.

Reference parity: src/random_mars.cpp (SURVEY.md §2.1 L1, the RanMars
class used by velocity.cpp and the stochastic fixes). That class wraps the
classic Marsaglia–Zaman–Tsang (1987) "universal" lagged-Fibonacci
generator with a Weyl-sequence correction; the implementation below is
from the published recipe. With the same integer seed the
uniform/gaussian draw sequence matches the reference generator draw for
draw, so `velocity create` (one stream walked in tag order, reference
loop-all semantics) reproduces reference initial conditions at seed
level — the r2 gap was "distributions match, seed streams don't".

A copy of ``tpusph/rng.py`` (host numpy, framework-free). Device-side
stochastics (fix phase_change) use a ``torch.Generator`` on the device
instead (``ops/phase_change.py``).

Vectorization: the lagged-Fibonacci recurrence reads lag-97 and lag-33
values, so its dependency distance is 33 draws — uniforms generate in
numpy blocks of up to 33, with the Weyl term c_k = c - (k+1)*cd folded
back into [0, cm) in closed form. Every public draw goes through one
internal FIFO of pre-generated uniforms, so scalar and batch calls can
interleave without perturbing the stream.
"""

from __future__ import annotations

import numpy as np


class RanMars:
    """Marsaglia universal RNG, draw-for-draw parity with the reference's
    RanMars (seed in (0, 900_000_000) exclusive, like the reference)."""

    def __init__(self, seed: int):
        seed = int(seed)
        if seed <= 0 or seed >= 900_000_000:
            raise ValueError(
                f"RanMars seed must be in (0, 900000000), got {seed}")
        u = np.zeros(98)  # 1-indexed [1..97]
        ij = (seed - 1) // 30082
        kl = (seed - 1) - 30082 * ij
        i = (ij // 177) % 177 + 2
        j = ij % 177 + 2
        k = (kl // 169) % 178 + 1
        m = kl % 169
        for ii in range(1, 98):
            s, t = 0.0, 0.5
            for _ in range(24):
                m1 = ((i * j) % 179) * k % 179
                i, j, k = j, k, m1
                m = (53 * m + 1) % 169
                if (m * m1) % 64 >= 32:
                    s += t
                t *= 0.5
            u[ii] = s
        self._u = u
        self._c = 362436.0 / 16777216.0
        self._cd = 7654321.0 / 16777216.0
        self._cm = 16777213.0 / 16777216.0
        self._i97 = 97
        self._j97 = 33
        self._gauss_save: float | None = None
        self._fifo = np.empty(0)
        self._pos = 0

    # raw generation -----------------------------------------------------

    def _gen_block(self, n: int) -> np.ndarray:
        """Advance the generator by n <= 33 draws, vectorized. Within a
        block every read u[j97-k] predates every same-block write (the
        i97/j97 gap is 64 mod 97 and the write lag is 33)."""
        u = self._u
        ki = self._i97 - np.arange(n)
        kj = self._j97 - np.arange(n)
        ki = np.where(ki <= 0, ki + 97, ki)
        kj = np.where(kj <= 0, kj + 97, kj)
        uni = u[ki] - u[kj]
        uni = np.where(uni < 0.0, uni + 1.0, uni)
        u[ki] = uni
        c = np.mod(self._c - (np.arange(n) + 1) * self._cd, self._cm)
        res = uni - c
        res = np.where(res < 0.0, res + 1.0, res)
        self._i97 = int(ki[-1]) - 1 or 97
        self._j97 = int(kj[-1]) - 1 or 97
        self._c = float(c[-1])
        return res

    def _refill(self, want: int):
        blocks = [self._fifo[self._pos:]]
        have = len(blocks[0])
        while have < want:
            b = self._gen_block(33)
            blocks.append(b)
            have += len(b)
        self._fifo = np.concatenate(blocks)
        self._pos = 0

    # public draws (all through the FIFO — interleaving-safe) ------------

    def uniform(self) -> float:
        if self._pos == len(self._fifo):
            self._refill(1)
        self._pos += 1
        return float(self._fifo[self._pos - 1])

    def uniform_batch(self, n: int) -> np.ndarray:
        if len(self._fifo) - self._pos < n:
            self._refill(n)
        out = self._fifo[self._pos:self._pos + n].copy()
        self._pos += n
        return out

    def gaussian(self) -> float:
        """Polar (Marsaglia) transform with one saved deviate — the
        reference gaussian() consumption pattern (retry in place until
        0 < rsq < 1)."""
        if self._gauss_save is not None:
            g, self._gauss_save = self._gauss_save, None
            return g
        while True:
            v1 = 2.0 * self.uniform() - 1.0
            v2 = 2.0 * self.uniform() - 1.0
            rsq = v1 * v1 + v2 * v2
            if 0.0 < rsq < 1.0:
                break
        fac = float(np.sqrt(-2.0 * np.log(rsq) / rsq))
        self._gauss_save = v1 * fac
        return v2 * fac

    def gaussian_batch(self, n: int) -> np.ndarray:
        """n gaussians == n successive gaussian() calls exactly. The
        rejection loop retries IN PLACE (a rejected pair's redraw precedes
        the next slot's draws) which forbids naive vectorization; the
        FIFO keeps the per-draw Python cost to a few float ops."""
        self._refill(int(n * 2.6) + 8)  # ~4/pi uniforms per gaussian
        out = np.empty(n)
        for i in range(n):
            out[i] = self.gaussian()
        return out

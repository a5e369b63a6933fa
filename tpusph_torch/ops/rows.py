"""Packed field-row and output-row meanings, and the coefficient-table
order, shared by every sweep of the port — the constants of
``tpusph/ops/pallas_pair.py``.

The sweeps read one (F_ROWS, n_slots) float32 field matrix (one row per
field, slot-major within a row so neighbouring threads read neighbouring
addresses) and write one (8, n_slots) output matrix. Row meanings are the
reference's, so a reader can match every row to its JAX counterpart. This
module imports nothing of the port, so every other module can read it.
"""

F_ROWS = 16
RX, RY, RZ = 0, 1, 2
RM = 3      # mass
RTYPE = 4   # type as f32 (0 = dead)
RRHO = 5
RSLOT = 6   # sign-encoded slot: slot if owned, -(slot+1) if a seam ghost
            # (strip vapor sweep only)
RMIX = 7    # per-tile mixed-phase flag (strip cgrad skip, force ST skip)
RVX, RVY, RVZ = 8, 9, 10
RE = 11
RCGX, RCGY, RCGZ = 12, 13, 14
RCV = 15    # per-particle heat capacity
# output rows (8)
OFX, OFY, OFZ, ODRHO, ODE, ORHO, OCGX, OCGY = range(8)
OVIR = ORHO  # force sweep only: the rho row carries the pair virial

# coefficient tables in the order the sweeps read them (params.stacked)
TABLES_2D = ("cut", "visc", "heat_D", "cut_heat", "sigma", "cut_tension",
             "cut_rho", "tsat")
TABLES_1D = ("rho0", "tait_b", "c0", "gas_gamma", "color")

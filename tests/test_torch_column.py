"""The port's column sweeps (``tpusph_torch.ops.pallas_pair``: the plain
versions of the CUDA column kernels, through their wrappers on CPU
tensors) and ``PallasBackend.force_stage`` against the JAX package's XLA
cell-grid backend (``tpusph.ops.cellgrid.CellGridBackend``) on the same
seeded lattice system and the same sorted layout. The Pallas kernel itself
is not run here: in interpret mode it is far too slow for the CPU.

Tolerances are tests/test_pallas.py's (the reference's column-vs-cellgrid
bar): rho rtol 2e-5 / atol 1e-6; cg 1e-4 / 1e-4; f and de 2e-4 / 5e-4;
drho 2e-4 / 1e-4. The sums run in another order, the column kernel's
pair forms are the kernel-side ones (``tile_physics``), and its pair mask
(rsq > 1e-12) is the TPU kernel's, in float32."""

import numpy as np
import pytest
import torch

from tpusph import grid as jgrid
from tpusph import kernels as jkernels
from tpusph.forces import compute_forces
from tpusph.ops.cellgrid import CellGridBackend as JCellGrid
from tpusph.params import PhysicsSpec as JSpec

from tpusph_torch import grid
from tpusph_torch.ops import pallas_pair
from tpusph_torch.ops.pallas_pair import PallasBackend, pack_dense
from tpusph_torch.ops.rows import (
    OCGX, OCGY, ODE, ODRHO, OFX, OFY, OFZ, ORHO, RCGX, RRHO)
from tpusph_torch.params import PhysicsSpec, tables_from_numpy
from tpusph_torch.state import Box, state_from_numpy

from test_pallas import lattice_system
from test_torch_strip_sweeps import by_tag, host

TOLS = {"rho": (2e-5, 1e-6), "cg": (1e-4, 1e-4), "f": (2e-4, 5e-4),
        "drho": (2e-4, 1e-4), "de": (2e-4, 5e-4), "vir": (2e-4, 5e-4)}

SPECS = {
    # tests/test_pallas.py's spec
    "pallas": dict(kernel=jkernels.WENDLAND_C2, tait=True,
                   heatconduction=True, surface_tension=True,
                   rhosum_every=1),
    # the bench configuration's styles
    "bench": dict(kernel=jkernels.LUCY, rhosum_every=1, rhosum_nd=True,
                  tait=True, heatconduction=True, surface_tension=True),
    "morris": dict(kernel=jkernels.LUCY, morris=True, tait=False),
    "idealgas": dict(kernel=jkernels.CUBIC_SPLINE, ideal_gas=True,
                     tait=False, rhosum_every=1),
    # tests/test_heat_phasechange.py's pinned-conduction spec, with the
    # per-particle pair virial
    "heatpc_virial": dict(kernel=jkernels.LUCY, tait=True,
                          heat_phasechange=True, rhosum_every=1,
                          virial=True),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def layouts(dim, periodic, seed, nside=None):
    """The lattice system sorted into both packages' cell grids (equal
    orders, ``tests/test_torch_cellgrid.py``): the JAX (backend, state,
    data, box, tables) and the port's (backend, state, data, tables)."""
    st, box, tables = lattice_system(dim, nside=nside or (8 if dim == 3
                                                          else 16),
                                     periodic=periodic, seed=seed)
    if seed == 41:
        tables.set_heatconduction(1, 2, d=0.15, h=float(tables.max_cut()),
                                  tsat=1.0)
    jgeom = jgrid.make_geometry(box, tables.max_cut(), dim, skin=0.2, cap=32)
    cgb = JCellGrid(jgeom)
    jst, jdata = cgb.init_aux(st, box)
    assert int(jdata.overflow[0]) == 0
    tbox = Box.create(np.asarray(box.lo), np.asarray(box.hi), box.periodic)
    ttab = tables_from_numpy(host(tables))
    geom = grid.make_geometry(tbox, ttab.max_cut(), dim, skin=0.2, cap=32)
    pb = PallasBackend(geom, tbox, ntypes=ttab.ntypes)
    tst, data = pb.init_aux(state_from_numpy(host(st)), tbox)
    np.testing.assert_array_equal(tst.tag.numpy(), np.asarray(jst.tag))
    return (cgb, jst, jdata, box, tables), (pb, tst, data, ttab)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("periodic", [True, False])
def test_column_sweeps_match_cellgrid(dim, periodic):
    (cgb, jst, jdata, box, tables), (pb, tst, data, ttab) = layouts(
        dim, periodic, seed=dim)
    jspec = JSpec(dim=dim, **SPECS["pallas"])
    spec = PhysicsSpec(dim=dim, **SPECS["pallas"])
    tabs = ttab.stacked("cpu")
    cgrid = pb.colgrid
    fld, pos, ok = pack_dense(tst, data, cgrid)
    alive = tst.alive.numpy()

    rho_c = np.asarray(cgb.rho_summation(jst, tables, jspec, box, aux=jdata))
    out = pallas_pair.column_rho(fld, tabs, cgrid, spec)
    (rho,) = pallas_pair.unpack_dense(out, pos, ok, (ORHO,))
    np.testing.assert_allclose(rho.numpy()[alive], rho_c[alive],
                               rtol=2e-5, atol=1e-6)

    cg_c = cgb.color_gradient(jst, tables, jspec, box, aux=jdata)
    out = pallas_pair.column_cgrad(fld, tabs, cgrid, spec)
    cg = np.stack([a.numpy() for a in pallas_pair.unpack_dense(
        out, pos, ok, (OCGX, OCGY, ODE))], 1)
    np.testing.assert_allclose(cg, np.asarray(cg_c), rtol=1e-4, atol=1e-4)

    # the force sweep reads the reference's colour gradient
    f_c, drho_c, de_c = (np.asarray(a) for a in cgb.force(
        jst, tables, jspec, box, aux=jdata, cg=cg_c))
    cg_t = torch.as_tensor(np.array(cg_c))
    for a in range(3):
        fld[RCGX + a, pos[ok]] = cg_t[ok, a]
    out = pallas_pair.column_force(fld, tabs, cgrid, spec)
    f0, f1, f2, drho, de = (a.numpy() for a in pallas_pair.unpack_dense(
        out, pos, ok, (OFX, OFY, OFZ, ODRHO, ODE)))
    np.testing.assert_allclose(np.stack([f0, f1, f2], 1), f_c, rtol=2e-4,
                               atol=5e-4)
    np.testing.assert_allclose(drho, drho_c, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(de, de_c, rtol=2e-4, atol=5e-4)


@pytest.mark.parametrize("name,dim,periodic,seed", [
    ("bench", 3, True, 40), ("morris", 3, False, 43),
    ("idealgas", 2, True, 44), ("heatpc_virial", 3, True, 41),
])
def test_force_stage_matches_cellgrid(name, dim, periodic, seed):
    """PallasBackend.force_stage (one pack, rho sweep and patch, cgrad
    sweep and patch, force sweep, unpack) against the reference's
    cell-grid stage (rho, then cg, then force): the Morris, ideal-gas,
    T_sat-pinned and virial branches with the bench's."""
    (cgb, jst, jdata, box, tables), (pb, tst, data, ttab) = layouts(
        dim, periodic, seed)
    kw = SPECS[name]
    ref = host(compute_forces(jst, tables, JSpec(dim=dim, **kw), box, cgb,
                              istep=0, aux=jdata))
    out = pb.force_stage(tst, ttab.stacked("cpu"), PhysicsSpec(dim=dim, **kw),
                         data, istep=0)
    got = {f: getattr(out, f).numpy() for f in ("tag", "type", "owned", "f",
                                                 "drho", "de", "rho", "vir")}
    fields = ("f", "drho", "de") + (("rho",) if kw.get("rhosum_every")
                                    else ()) \
        + (("vir",) if kw.get("virial") else ())
    for field in fields:
        (a,) = by_tag(ref, field)
        (b,) = by_tag(got, field)
        rtol, atol = TOLS[field]
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                   err_msg=f"{name} {field}")


def test_column_wrappers_on_cpu_and_bad_inputs():
    """On CPU tensors the wrappers run the plain version and count no
    kernel launch; they check dtype, shape, contiguity, device and the
    cell capacity first, and a device with no kernel raises."""
    _, (pb, tst, data, ttab) = layouts(3, True, seed=7)
    spec = PhysicsSpec(dim=3, **SPECS["bench"])
    tabs = ttab.stacked("cpu")
    cgrid = pb.colgrid
    fld, _, _ = pack_dense(tst, data, cgrid)
    before = {k: w.launches for k, w in pallas_pair.KERNELS.items()}
    pb.force_stage(tst, tabs, spec, data, istep=0)
    assert {k: w.launches for k, w in pallas_pair.KERNELS.items()} == before
    kern = pallas_pair.column_force
    bad = {
        "fld dtype": dict(fld=fld.double()),
        "fld shape": dict(fld=fld[:, :-1].contiguous()),
        "fld contiguity": dict(fld=fld.T.contiguous().T),
        "tab2 device": dict(tabs=tabs._replace(tab2=tabs.tab2.to("meta"))),
        "no kernel": dict(fld=fld.to("meta"), tabs=tabs._replace(
            tab2=tabs.tab2.to("meta"), tab1=tabs.tab1.to("meta"))),
        "cap": dict(cg=cgrid._replace(cap=pallas_pair.MAX_CAP + 8)),
    }
    args = dict(fld=fld, tabs=tabs, cg=cgrid, spec=spec)
    for what, change in bad.items():
        with pytest.raises(ValueError):
            kern(**{**args, **change})
            pytest.fail(what)
    out = kern(**args)
    assert out.shape == (8, cgrid.n_slots)
    # the rho patch the stage applies leaves dead slots untouched
    assert float(fld[RRHO][fld[4] < 0.5].abs().max()) == 0.0

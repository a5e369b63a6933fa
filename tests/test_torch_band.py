"""The port's band sweeps (``tpusph_torch.ops.band_pair``: the plain
versions of the CUDA band kernels, through their wrappers on CPU tensors)
and ``BandBackend.force_stage`` against the JAX package's XLA cell-grid
backend (``tpusph.ops.cellgrid.CellGridBackend``) on tests/test_band.py's
seeded lattice systems, joined on particle tag (the band layout is slot
resident). The Pallas band kernel itself is not run here: in interpret
mode it is far too slow for the CPU.

Tolerances are tests/test_band.py's (the reference's band-vs-cellgrid
bar): rho rtol 2e-5 / atol 1e-6; f and de 2e-4 / 5e-4; drho 2e-4 / 1e-4;
the colour gradient tests/test_pallas.py's 1e-4 / 1e-4; scalar-folded
tables against per-type lookups 1e-5 / 1e-6. The sums run in another
order, with the kernel-side pair forms (``tile_physics``) and the TPU
kernel's pair mask (rsq > 1e-12), in float32."""

import numpy as np
import pytest
import torch

from tpusph import grid as jgrid
from tpusph import kernels as jkernels
from tpusph.forces import compute_forces
from tpusph.ops.cellgrid import CellGridBackend as JCellGrid
from tpusph.params import PhysicsSpec as JSpec

from tpusph_torch.ops import band_pair
from tpusph_torch.ops.band_pair import (
    BandBackend, choose_band_geometry, pack_fields)
from tpusph_torch.ops.rows import (
    OCGX, OCGY, ODE, ODRHO, OFX, OFY, OFZ, ORHO, RCGX, RRHO, RTYPE)
from tpusph_torch.params import PhysicsSpec, tables_from_numpy
from tpusph_torch.state import Box, state_from_numpy

from test_pallas import lattice_system
from test_torch_strip_sweeps import by_tag, host

TOLS = {"rho": (2e-5, 1e-6), "cg": (1e-4, 1e-4), "f": (2e-4, 5e-4),
        "drho": (2e-4, 1e-4), "de": (2e-4, 5e-4), "vir": (2e-4, 5e-4)}

SPECS = {
    # tests/test_band.py's spec
    "band": dict(kernel=jkernels.WENDLAND_C2, tait=True, heatconduction=True,
                 surface_tension=True, rhosum_every=1),
    # tests/test_band.py's variants
    "morris": dict(kernel=jkernels.LUCY, morris=True, tait=False),
    "idealgas": dict(kernel=jkernels.LUCY, ideal_gas=True, tait=False),
    "lj": dict(kernel=jkernels.LUCY, lj=True, tait=False),
    # the bench's styles, with the per-particle pair virial
    "bench_virial": dict(kernel=jkernels.LUCY, rhosum_every=1,
                         rhosum_nd=True, tait=True, heatconduction=True,
                         surface_tension=True, virial=True),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cellgrid(st, box, tables, dim):
    """The JAX package's cell grid (tests/test_band.py's: skin 0.2, cap
    64): (backend, sorted state, data)."""
    geom = jgrid.make_geometry(box, tables.max_cut(), dim, skin=0.2, cap=64)
    cgb = JCellGrid(geom)
    jst, jdata = cgb.init_aux(st, box)
    assert int(jdata.overflow[0]) == 0
    return cgb, jst, jdata


def band_layout(st, box, tables, dim, skin=0.2):
    """Carry the JAX state and tables across, choose the band geometry and
    build the slots: (backend, state, aux, tables) of the port."""
    tbox = Box.create(np.asarray(box.lo), np.asarray(box.hi), box.periodic)
    ttab = tables_from_numpy(host(tables))
    x = np.asarray(st.x)[np.asarray(st.type) > 0]
    geom = choose_band_geometry(tbox, ttab.max_cut(), dim, skin, x=x)
    assert geom is not None, "band geometry must exist for this box"
    bb = BandBackend(geom, ntypes=ttab.ntypes)
    tst, aux = bb.init_aux(state_from_numpy(host(st)), tbox)
    assert int(aux.overflow.sum()) == 0
    return bb, tst, aux, ttab


def band_stage(st, box, tables, dim, spec_kw):
    """The port's BandBackend.force_stage on the CPU, as host arrays."""
    bb, tst, aux, ttab = band_layout(st, box, tables, dim)
    out = bb.force_stage(tst, ttab.stacked("cpu"),
                         PhysicsSpec(dim=dim, **spec_kw), aux, istep=0)
    return {f: getattr(out, f).numpy() for f in ("tag", "type", "owned", "f",
                                                 "drho", "de", "rho", "vir")}


def check_stage(ref, got, fields, label):
    np.testing.assert_array_equal(by_tag(got, "tag")[0],
                                  by_tag(ref, "tag")[0])
    for field in fields:
        (a,) = by_tag(ref, field)
        (b,) = by_tag(got, field)
        rtol, atol = TOLS[field]
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                   err_msg=f"{label} {field}")


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("periodic", [True, False])
def test_band_matches_cellgrid(dim, periodic):
    """tests/test_band.py::test_band_matches_cellgrid: the force stage
    (rho sweep and patch, cgrad sweep and patch, force sweep)."""
    st, box, tables = lattice_system(dim, periodic=periodic, seed=dim + 20)
    kw = SPECS["band"]
    cgb, jst, jdata = cellgrid(st, box, tables, dim)
    ref = host(compute_forces(jst, tables, JSpec(dim=dim, **kw), box, cgb,
                              istep=0, aux=jdata))
    got = band_stage(st, box, tables, dim, kw)
    check_stage(ref, got, ("rho", "f", "drho", "de"), f"{dim}d {periodic}")


@pytest.mark.parametrize("name", ["morris", "idealgas", "lj",
                                  "bench_virial"])
def test_band_variants_match_cellgrid(name):
    """tests/test_band.py::test_band_variants_match_cellgrid's Morris,
    ideal-gas and LJ equations of state, and the bench's styles with the
    pair virial."""
    st, box, tables = lattice_system(3, nside=8, seed=31)
    kw = SPECS[name]
    cgb, jst, jdata = cellgrid(st, box, tables, 3)
    ref = host(compute_forces(jst, tables, JSpec(dim=3, **kw), box, cgb,
                              istep=0, aux=jdata))
    got = band_stage(st, box, tables, 3, kw)
    fields = ("f", "de", "drho") + (("rho", "vir") if kw.get("virial")
                                    else ())
    check_stage(ref, got, fields, name)


def test_band_scalar_fold_flags_preserve_physics():
    """tests/test_band.py's case: uniform tables folded to scalars with one
    shared cutoff give the per-type lookups' stage to 1e-5."""
    st, box, tables = lattice_system(3, nside=8, ntypes=2, seed=9)
    h = float(tables.max_cut())
    for i in (1, 2):
        for j in (i, 2):
            tables.set_heatconduction(i, j, d=0.15, h=h)
            tables.set_surfacetension(i, j, sigma=0.8, h=h)
    base = dict(kernel=jkernels.LUCY, tait=True, heatconduction=True,
                surface_tension=True, rhosum_every=1)
    flagged = dict(base, shared_wfd=True, scalar_tables=(
        "cut", "cut_heat", "cut_rho", "cut_tension", "visc", "heat_D",
        "sigma", "rho0", "tait_b", "c0", "gas_gamma"))
    out0 = band_stage(st, box, tables, 3, base)
    out1 = band_stage(st, box, tables, 3, flagged)
    for field in ("rho", "f", "de", "drho"):
        (a,) = by_tag(out0, field)
        (b,) = by_tag(out1, field)
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=field)


def test_band_sweeps_match_cellgrid():
    """Each band sweep alone against the cell grid's: the rho sum, the
    colour gradient, and the force sweep fed the reference's colour
    gradient (tests/test_torch_column.py's join, here on tag)."""
    st, box, tables = lattice_system(3, nside=8, periodic=False, seed=23)
    spec_kw = SPECS["band"]
    jspec = JSpec(dim=3, **spec_kw)
    cgb, jst, jdata = cellgrid(st, box, tables, 3)
    bb, tst, aux, ttab = band_layout(st, box, tables, 3)
    spec = PhysicsSpec(dim=3, **spec_kw)
    tabs = ttab.stacked("cpu")
    fld = pack_fields(tst)
    alive = tst.alive.numpy()
    # port slot -> JAX sorted row, by tag
    jtag = np.asarray(jst.tag)
    jalive = np.asarray(jst.type) > 0
    order = np.argsort(np.where(jalive, jtag, np.iinfo(np.int32).max))
    jrow = order[np.searchsorted(jtag[order], tst.tag.numpy()[alive])]

    rho_c = np.asarray(cgb.rho_summation(jst, tables, jspec, box, aux=jdata))
    out = band_pair.band_rho(fld, tabs, bb.geom, spec)
    np.testing.assert_allclose(out[ORHO].numpy()[alive], rho_c[jrow],
                               rtol=2e-5, atol=1e-6)

    cg_j = cgb.color_gradient(jst, tables, jspec, box, aux=jdata)
    cg_c = np.asarray(cg_j)
    out = band_pair.band_cgrad(fld, tabs, bb.geom, spec)
    cg = torch.stack([out[OCGX], out[OCGY], out[ODE]], 1).numpy()
    np.testing.assert_allclose(cg[alive], cg_c[jrow], rtol=1e-4, atol=1e-4)

    f_c, drho_c, de_c = (np.asarray(a) for a in cgb.force(
        jst, tables, jspec, box, aux=jdata, cg=cg_j))
    slots = torch.as_tensor(np.nonzero(alive)[0])
    for a in range(3):
        fld[RCGX + a, slots] = torch.as_tensor(cg_c[jrow, a])
    out = band_pair.band_force(fld, tabs, bb.geom, spec)
    f = torch.stack([out[OFX], out[OFY], out[OFZ]], 1).numpy()
    np.testing.assert_allclose(f[alive], f_c[jrow], rtol=2e-4, atol=5e-4)
    np.testing.assert_allclose(out[ODRHO].numpy()[alive], drho_c[jrow],
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(out[ODE].numpy()[alive], de_c[jrow],
                               rtol=2e-4, atol=5e-4)


def test_band_wrappers_on_cpu_and_bad_inputs():
    """On CPU tensors the wrappers run the plain version and count no
    kernel launch; they check dtype, shape, contiguity, device and the
    group and window sizes the kernels take first, and a device with no
    kernel raises."""
    st, box, tables = lattice_system(3, nside=8, seed=7)
    bb, tst, aux, ttab = band_layout(st, box, tables, 3)
    spec = PhysicsSpec(dim=3, **SPECS["bench_virial"])
    tabs = ttab.stacked("cpu")
    fld = pack_fields(tst)
    before = {k: w.launches for k, w in band_pair.KERNELS.items()}
    bb.force_stage(tst, tabs, spec, aux, istep=0)
    assert {k: w.launches for k, w in band_pair.KERNELS.items()} == before
    kern = band_pair.band_force
    geom = bb.geom
    bad = {
        "fld dtype": dict(fld=fld.double()),
        "fld shape": dict(fld=fld[:, :-1].contiguous()),
        "fld contiguity": dict(fld=fld.T.contiguous().T),
        "tab2 device": dict(tabs=tabs._replace(tab2=tabs.tab2.to("meta"))),
        "no kernel": dict(fld=fld.to("meta"), tabs=tabs._replace(
            tab2=tabs.tab2.to("meta"), tab1=tabs.tab1.to("meta"))),
    }
    for what, g2 in (("group", geom._replace(c=band_pair.MAX_GC)),
                     ("window", geom._replace(G=40, k=30))):
        bad[what] = dict(geom=g2, fld=torch.zeros(fld.shape[0], g2.n_slots))
    args = dict(fld=fld, tabs=tabs, geom=geom, spec=spec)
    for what, change in bad.items():
        with pytest.raises(ValueError):
            kern(**{**args, **change})
            pytest.fail(what)
    out = kern(**args)
    assert out.shape == (8, geom.n_slots)
    # dead slots read nothing and are written as zeros
    dead = fld[RTYPE] < 0.5
    assert float(out[:, dead].abs().max()) == 0.0
    assert float(fld[RRHO][dead].min()) == 1.0

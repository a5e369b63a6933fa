"""The torch port's strip force stage (rho sweep -> patch -> colour-gradient
sweep -> patch -> force sweep, through the plain PyTorch versions of the
CUDA sweeps) against the JAX package's dense O(N^2) oracle, on the same
seeded lattice system.

Tolerances are tests/test_strip.py's (the reference's strip-vs-oracle
bar): rho rtol 2e-5 / atol 1e-6; f and de 2e-4 / 5e-4; drho 2e-4 / 1e-4.
The sums run in a different order than the oracle's, in float32."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpusph import kernels as jkernels
from tpusph.forces import compute_forces
from tpusph.ops import dense
from tpusph.params import PhysicsSpec as JSpec

from tpusph_torch.ops.strip_pair import StripBackend, choose_strip_geometry
from tpusph_torch.params import PhysicsSpec, tables_from_numpy
from tpusph_torch.state import Box, state_from_numpy

from test_pallas import lattice_system

TOLS = {"rho": (2e-5, 1e-6), "f": (2e-4, 5e-4), "drho": (2e-4, 1e-4),
        "de": (2e-4, 5e-4),
        # the pair virial sums f_ij . r_ij: f's bar
        "vir": (2e-4, 5e-4)}

SPECS = {
    # the bench configuration's styles
    "bench": dict(kernel=jkernels.LUCY, rhosum_every=1, rhosum_nd=True,
                  tait=True, heatconduction=True, surface_tension=True),
    "morris": dict(kernel=jkernels.LUCY, morris=True, tait=False),
    "idealgas": dict(kernel=jkernels.LUCY, ideal_gas=True, tait=False),
    "lj": dict(kernel=jkernels.LUCY, lj=True, tait=False),
    "wendland_heat_st": dict(kernel=jkernels.WENDLAND_C2, tait=True,
                             heatconduction=True, surface_tension=True,
                             rhosum_every=1),
    # T_sat pinning on the 1-2 pair, and the per-particle pair virial
    "cubic_heatpc_virial": dict(kernel=jkernels.CUBIC_SPLINE, tait=True,
                                heat_phasechange=True, virial=True),
    "quintic_idealgas_rhosum": dict(kernel=jkernels.QUINTIC_SPLINE,
                                    ideal_gas=True, tait=False,
                                    rhosum_every=1),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread (see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def host(tree) -> dict:
    d = jax.device_get(tree)
    return {f.name: np.asarray(getattr(d, f.name))
            for f in dataclasses.fields(d)}


def by_tag(arrays: dict, *fields):
    keep = (arrays["type"] > 0) & arrays["owned"]
    order = np.argsort(arrays["tag"][keep], kind="stable")
    return [arrays[f][keep][order] for f in fields]


def port_layout(st, box, tables, dim, skin=0.2):
    """Carry the JAX state/tables across, choose the strip geometry and
    build the layout: (backend, state, aux, tables) of the port."""
    tbox = Box.create(np.asarray(box.lo), np.asarray(box.hi), box.periodic)
    ttab = tables_from_numpy(host(tables))
    x = np.asarray(st.x)[np.asarray(st.type) > 0]
    geom = choose_strip_geometry(tbox, ttab.max_cut(), dim, skin, x=x)
    assert geom is not None
    sb = StripBackend(geom, ntypes=ttab.ntypes)
    tst, aux = sb.init_aux(state_from_numpy(host(st)), tbox)
    assert int(aux.overflow.sum()) == 0
    return sb, tst, aux, ttab


def port_force_stage(st, box, tables, spec_kw, dim):
    """The port's force stage on the CPU, as host arrays."""
    sb, tst, aux, ttab = port_layout(st, box, tables, dim)
    spec = PhysicsSpec(dim=dim, **spec_kw)
    out = sb.force_stage(tst, ttab.stacked("cpu"), spec, aux, istep=0)
    return {f.name: getattr(out, f.name).numpy()
            for f in dataclasses.fields(out)}


@pytest.mark.parametrize("name,dim,periodic", [
    ("bench", 3, True), ("bench", 3, False), ("morris", 3, True),
    ("idealgas", 3, True), ("lj", 3, True), ("wendland_heat_st", 2, True),
    ("cubic_heatpc_virial", 3, True), ("quintic_idealgas_rhosum", 3, False),
])
def test_force_stage_matches_dense(name, dim, periodic):
    st, box, tables = lattice_system(dim, nside=12 if dim == 3 else 24,
                                     periodic=periodic, seed=dim + 40)
    spec_kw = SPECS[name]
    if spec_kw.get("heat_phasechange"):
        tables.set_heatconduction(1, 2, d=0.15, h=0.99, tsat=1.1)
    ref = host(compute_forces(st, tables, JSpec(dim=dim, **spec_kw), box,
                              dense, istep=0))
    got = port_force_stage(st, box, tables, spec_kw, dim)
    np.testing.assert_array_equal(by_tag(got, "tag")[0],
                                  by_tag(ref, "tag")[0])
    fields = ("f", "drho", "de") + (("rho",) if spec_kw.get("rhosum_every")
                                    else ()) \
        + (("vir",) if spec_kw.get("virial") else ())
    for field in fields:
        (a,) = by_tag(ref, field)
        (b,) = by_tag(got, field)
        rtol, atol = TOLS[field]
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                   err_msg=f"{name} {field}")


def test_sweep_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the wrappers run the plain version and count no
    kernel launch."""
    from tpusph_torch.ops import strip_pair

    st, box, tables = lattice_system(3, nside=12, seed=7)
    before = {k: w.launches for k, w in strip_pair.SWEEPS.items()}
    port_force_stage(st, box, tables, SPECS["bench"], 3)
    assert {k: w.launches for k, w in strip_pair.SWEEPS.items()} == before


def test_sweep_wrapper_rejects_bad_inputs():
    """The wrapper checks dtype, shape, contiguity and device before it
    picks the plain version or the kernel; a device with no kernel
    raises."""
    from tpusph_torch.ops import strip_pair
    from tpusph_torch.ops.band_pair import pack_fields

    st, box, tables = lattice_system(3, nside=12, seed=7)
    sb, tst, aux, ttab = port_layout(st, box, tables, 3)
    spec = PhysicsSpec(dim=3, **SPECS["bench"])
    tabs = ttab.stacked("cpu")
    fld = pack_fields(tst, aux.mix)
    sweep = strip_pair.SWEEPS["rho"]
    args = dict(fld=fld, tabs=tabs, win=sb.win, delta=aux.delta,
                geom=sb.geom, spec=spec)
    bad = {
        "fld dtype": dict(fld=fld.double()),
        "fld shape": dict(fld=fld[:, :-128]),
        "fld contiguity": dict(fld=fld.T.contiguous().T),
        "delta dtype": dict(delta=aux.delta.long()),
        "perm shape": dict(win=sb.win._replace(perm=sb.win.perm[:, :3])),
        "fld device": dict(fld=fld.to("meta")),
        "no kernel": dict(fld=fld.to("meta"), tabs=tabs._replace(
            tab2=tabs.tab2.to("meta"), tab1=tabs.tab1.to("meta")),
            win=strip_pair.StripWindows(sb.win.perm.to("meta"),
                                        sb.win.shift.to("meta")),
            delta=aux.delta.to("meta")),
    }
    for what, change in bad.items():
        with pytest.raises(ValueError):
            sweep(**{**args, **change})
            pytest.fail(what)
    assert sweep.launches == 0
    out = sweep(**args)
    assert out.shape == (8, sb.geom.n_slots) and out.device == fld.device

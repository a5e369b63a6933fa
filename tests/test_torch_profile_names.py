"""``tpusph_torch.profile_step`` attributes the device time of each
hand-written kernel to its wrapper's name in ``ops.all_kernels()``, from
the kernel names the profiler reports (demangled C++ template names). The
one-pass scans (the strip's colour gradient and vapor sweep, the column
and band layouts' three sweeps, the compacted force sweep) are check
kernels on no path: a stray launch of one must be counted under its own
name, never as the main path's sweep. Runs on the CPU: it reads names
only."""

import pytest

from tpusph_torch import profile_step
from tpusph_torch.ops import all_kernels

SIG = "(float const*, float const*, float const*, int)"


def test_kernel_names_are_the_registry():
    """Every wrapper, the compacted force sweep's too: it runs on no path
    of ``Simulation`` (the window profile_step times), so a launch of it
    there is counted under its own name."""
    assert sorted(profile_step.KERNEL_NAMES) == sorted(all_kernels())


@pytest.mark.parametrize("name,short", [
    (f"void sph::strip_filter_kernel<0, 16>{SIG}", "strip_rho"),
    (f"void sph::strip_filter_kernel<1, 16>{SIG}", "strip_cgrad"),
    (f"void sph::strip_sweep_kernel<1>{SIG}", "strip_cgrad_scan"),
    (f"void sph::strip_filter_kernel<(int)2, 2>{SIG}", "strip_force"),
    (f"void (anonymous namespace)::strip_vapor_filter_kernel{SIG}",
     "strip_vapor"),
    (f"void (anonymous namespace)::strip_vapor_scan_kernel{SIG}",
     "strip_vapor_scan"),
    (f"void sph::cell_sweep_kernel<0, 0, 16>{SIG}", "column_rho"),
    (f"void sph::cell_sweep_kernel<1, 0, 12>{SIG}", "column_cgrad"),
    (f"void sph::cell_sweep_kernel<2, 0, 6>{SIG}", "column_force"),
    (f"void sph::cell_sweep_kernel<(int)1, (int)1, 16>{SIG}", "band_cgrad"),
    (f"void (anonymous namespace)::column_sweep_kernel<0>{SIG}",
     "column_rho_scan"),
    (f"void (anonymous namespace)::column_sweep_kernel<1>{SIG}",
     "column_cgrad_scan"),
    (f"void (anonymous namespace)::column_sweep_kernel<2>{SIG}",
     "column_force_scan"),
    (f"void (anonymous namespace)::band_sweep_kernel<(int)0>{SIG}",
     "band_rho_scan"),
    (f"void (anonymous namespace)::compact_filter_kernel{SIG}",
     "compact_force"),
    (f"void (anonymous namespace)::compact_scan_kernel{SIG}",
     "compact_force_scan"),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", None),
])
def test_profiled_kernel_maps_to_its_wrapper(name, short):
    assert profile_step._kernel_of(name) == short

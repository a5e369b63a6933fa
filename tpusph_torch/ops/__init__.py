"""Pair-sweep backends of the torch port: the strip backend, the band
backend and the column kernel's backend on the cell grid, with their CUDA
kernels, and the compacted force sweep over the strip windows
(``mxu_compact``, on no path of ``Simulation``)."""


def all_kernels() -> dict:
    """Every kernel wrapper of the port by name (``strip_rho`` ...
    ``strip_vapor``, ``column_rho`` ... ``column_force``, ``band_rho`` ...
    ``band_force``, ``compact_force``, and the check kernels
    ``strip_{cgrad,vapor}_scan``, ``column_{rho,cgrad,force}_scan``,
    ``band_{rho,cgrad,force}_scan`` and ``compact_force_scan``, which no
    path launches): one registry of launch counts. Imported on call, so
    that importing the package imports no backend."""
    from tpusph_torch.ops import (band_pair, mxu_compact, pallas_pair,
                                  strip_pair)
    return {**{f"strip_{k}": w for k, w in strip_pair.KERNELS.items()},
            **{f"column_{k}": w for k, w in pallas_pair.KERNELS.items()},
            **{f"band_{k}": w for k, w in band_pair.KERNELS.items()},
            **{f"compact_{k}": w for k, w in mxu_compact.KERNELS.items()},
            **{f"strip_{k}_scan": w for k, w in strip_pair.SCANS.items()},
            **{f"column_{k}_scan": w for k, w in pallas_pair.SCANS.items()},
            **{f"band_{k}_scan": w for k, w in band_pair.SCANS.items()},
            **{f"compact_{k}_scan": w
               for k, w in mxu_compact.SCANS.items()}}

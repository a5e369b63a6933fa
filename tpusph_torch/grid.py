"""The aux carried between steps — the strip backend's subset of
``tpusph.grid.GridData``. The cell-grid fields (cell_id, starts, rank)
have no reader on the strip path and are not carried."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GridData:
    """Per-rebuild device data of the strip layout."""
    counts: torch.Tensor        # (ncols,) i64 live particles per column
    x_ref: torch.Tensor         # (N, 3) positions at build (skin trigger)
    overflow: torch.Tensor      # (1,) i64 dropped rows + window violations
    nbuilds: torch.Tensor       # (1,) i64 cumulative rebuild count
    # (ncols, nnbr, nblocks) i32 window-retarget offsets in blocks
    delta: torch.Tensor
    # seam-ghost copy map: source row, destination row, column-axis shift;
    # re-copied EVERY step (StripBackend.refresh_seam)
    seam_src: torch.Tensor
    seam_dest: torch.Tensor
    seam_shift: torch.Tensor
    # (2,) worst coverage shortfall in rows (below, above), clipped at 0
    margin_short: torch.Tensor
    # (2,) unclipped worst need-minus-window in rows (negative = slack)
    margin_need: torch.Tensor
    # per-slot three-valued mixed-phase flag (StripBackend._mixed_flags)
    mix: torch.Tensor | None = None

"""The port's dual-column records against the JAX kernel, at the quality
tier's pass-1 config (``dual_col``, hyps 2, sr 12, off 5, uncapped realign,
colfix 3) as JAX's ``render_frames_scan_quality`` derives it; scene and bars:
test_torch_scan_kernel.py.

Slot 0's records carry the right column's corners beside each strip row;
they are copies, so they must equal the JAX kernel's ``debug_records``
exactly, including the last chunk's lane 127, which takes its own chunk's
first column (the march masks it). The JAX side runs only its solve (one
small interpret-mode compile); pass 1's frames, which march these records
through the colfix K = 3 cascade, are held against JAX's in
test_torch_scan_quality.py.
"""

import dataclasses

from test_torch_scan_kernel import check_records, run_jax, run_port
from test_torch_scan_quality import jax_quality_configs


def test_dual_col_records_match_jax():
    _, cfg1, _ = jax_quality_configs()
    assert cfg1.dual_col and cfg1.hyps == 2 and cfg1.colfix == 3
    assert not cfg1.row_edge and not cfg1.pack_xy
    assert cfg1.nrec == 3 + 6 * cfg1.sr
    _, dbg = run_jax(cfg1, phases="solve")
    _, recs, _ = run_port(cfg1)
    check_records(recs, dbg)
    assert dataclasses.replace(cfg1, dual_col=False).nrec < cfg1.nrec

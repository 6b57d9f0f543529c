"""k2_roofline: K2's share of its roofline, in %.

K2 is the BN254 cell hash from byte rows (`p2_sponge2_kernel`,
csrc/poseidon2_bn254.cu).  Its device time is the profiler's, summed over
the traced window; its bound is every cell the window's slots hold times
one cell's bound (peaks.bn254_cell_bound_s).
"""

from port_bench import peaks
from port_bench.trace import kernel_seconds


def read(rec: dict):
    t = kernel_seconds(rec, "p2_sponge2_kernel")
    if t <= 0:
        return None
    cells = rec["slots"] * rec["slot_cells"]
    return 100 * cells * peaks.bn254_cell_bound_s(rec["config"]["cell_size"]) / t

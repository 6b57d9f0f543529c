"""k6_roofline: K6's share of its roofline, in %.

K6 is the Goldilocks cell digest from byte rows (`gl_sponge8_kernel`,
csrc/goldilocks.cu), with the configuration's hash, in the cells that
commit slots of device data: every cell the traced window's slots hold
times one cell's bound (peaks.gl_cell_bound_s).
"""

from port_bench import peaks
from port_bench.trace import kernel_seconds


def read(rec: dict):
    t = kernel_seconds(rec, "gl_sponge8_kernel")
    if t <= 0:
        return None
    cfg = rec["config"]
    cells = rec["slots"] * rec["slot_cells"]
    return 100 * cells * peaks.gl_cell_bound_s(cfg["cell_size"], cfg["hash"]) / t

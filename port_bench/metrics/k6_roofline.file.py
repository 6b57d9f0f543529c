"""k6_roofline.file: K6's share of its roofline, in %, in the cells that
commit a slot file: K6 reads the copied chunk as a strided (B, cell).T
view there, rows from the card's generator elsewhere (k6_roofline)."""

from port_bench import peaks
from port_bench.trace import kernel_seconds


def read(rec: dict):
    t = kernel_seconds(rec, "gl_sponge8_kernel")
    if t <= 0:
        return None
    cfg = rec["config"]
    cells = rec["slots"] * rec["slot_cells"]
    return 100 * cells * peaks.gl_cell_bound_s(cfg["cell_size"], cfg["hash"]) / t

"""k1_roofline: K1's share of its roofline, in %.

K1 is the BN254 subtree kernel (`p2_tree_kernel`, csrc/poseidon2_bn254.cu):
all its launches of the traced window against every slot tree the window
built, from its Montgomery cell hashes to its root (peaks.bn254_tree_bound_s).
"""

from port_bench import peaks
from port_bench.trace import kernel_seconds


def read(rec: dict):
    t = kernel_seconds(rec, "p2_tree_kernel")
    if t <= 0:
        return None
    return 100 * rec["slots"] * peaks.bn254_tree_bound_s(rec["slot_cells"]) / t

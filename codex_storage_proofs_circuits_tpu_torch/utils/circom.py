"""circom main-component writer.

Emits the `proof_main.circom` wrapper instantiating the reference circuit's
top template with the five shape parameters
(reference/nim/proof_input/src/cli.nim:186-204, DataSet.hs:62-80).
"""

from __future__ import annotations

from ..oracle.dataset import GlobalConfig, DataSetConfig


def circom_main_component_text(glob: GlobalConfig, dset: DataSetConfig) -> str:
    params = (
        glob.max_depth,
        glob.max_log2_n_slots,
        glob.block_tree_depth,
        glob.n_field_elems_per_cell,
        dset.n_samples,
    )
    return (
        "pragma circom 2.0.0;\n"
        'include "sample_cells.circom";\n'
        "// SampleAndProven( maxDepth, maxLog2NSlots, blockTreeDepth,"
        " nFieldElemsPerCell, nSamples )\n"
        "component main {public [entropy,dataSetRoot,slotIndex]} = "
        f"SampleAndProve{params!r};\n"
    )


def write_circom_main_component(fname: str, glob: GlobalConfig, dset: DataSetConfig) -> None:
    with open(fname, "w") as f:
        f.write(circom_main_component_text(glob, dset))

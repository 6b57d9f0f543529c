"""snarkjs-compatible proof-input JSON writer.

Schema and value encoding follow the reference exporter
(reference/nim/proof_input/src/json/bn254.nim:57-79, Sampling.hs:97-113):
field elements are written as *quoted decimal strings* (JavaScript cannot
handle big numbers), scalar counts as plain JSON numbers.

Keys: dataSetRoot, entropy, nCellsPerSlot, nSlotsPerDataSet, slotIndex,
slotRoot, slotProof, cellData, merklePaths.
"""

from __future__ import annotations

import json
from typing import IO

from ..oracle.sampling import ProofInput


def proof_input_to_dict(pi: ProofInput) -> dict:
    return {
        "dataSetRoot": str(pi.data_set_root),
        "entropy": str(pi.entropy),
        "nCellsPerSlot": pi.n_cells_per_slot,
        "nSlotsPerDataSet": pi.n_slots_per_dataset,
        "slotIndex": pi.slot_index,
        "slotRoot": str(pi.slot_root),
        "slotProof": [str(v) for v in pi.slot_proof],
        "cellData": [[str(v) for v in cell] for cell in pi.cell_data],
        "merklePaths": [[str(v) for v in path] for path in pi.merkle_paths],
    }


def export_proof_input(fname_or_fh: str | IO, pi: ProofInput) -> None:
    d = proof_input_to_dict(pi)
    if isinstance(fname_or_fh, str):
        with open(fname_or_fh, "w") as f:
            json.dump(d, f, indent=1)
            f.write("\n")
    else:
        json.dump(d, fname_or_fh, indent=1)
        fname_or_fh.write("\n")


def load_proof_input(fname: str) -> ProofInput:
    """Read a proof-input JSON back (inverse of export_proof_input)."""
    with open(fname) as f:
        d = json.load(f)
    return ProofInput(
        entropy=int(d["entropy"]),
        data_set_root=int(d["dataSetRoot"]),
        slot_index=int(d["slotIndex"]),
        slot_root=int(d["slotRoot"]),
        n_slots_per_dataset=int(d["nSlotsPerDataSet"]),
        n_cells_per_slot=int(d["nCellsPerSlot"]),
        slot_proof=[int(v) for v in d["slotProof"]],
        cell_data=[[int(v) for v in c] for c in d["cellData"]],
        merkle_paths=[[int(v) for v in p] for p in d["merklePaths"]],
    )

"""cells_ms.gl: the GL proof input's cells stage: the sampled cells' bytes (one
models/data.load_cells call) and their felts
(models/gl_proof_input.ProofStatsGL.cells_s, the program's host clock), in
ms a request over the traced window.  Nothing where the program keeps no
such stats."""


def read(rec: dict):
    stats = rec.get("proof_gl")
    if not stats or not rec.get("proofs"):
        return None
    return 1e3 * stats["cells_s"] / rec["proofs"]

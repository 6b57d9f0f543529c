"""slots_ms.gl: the GL proof input's slots stage: every slot's tree, the roots
to the host, the dataset tree and the slot's proof
(models/gl_proof_input.ProofStatsGL.slots_s, the program's host clock), in
ms a request over the traced window.  Nothing where the program keeps no
such stats."""


def read(rec: dict):
    stats = rec.get("proof_gl")
    if not stats or not rec.get("proofs"):
        return None
    return 1e3 * stats["slots_s"] / rec["proofs"]

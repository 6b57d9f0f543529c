"""sample_ms.gl: the GL proof input's sample stage: the device sampler (one
sponge launch), to its indices on the host
(models/gl_proof_input.ProofStatsGL.sample_s, the program's host clock), in
ms a request over the traced window.  Nothing where the program keeps no
such stats."""


def read(rec: dict):
    stats = rec.get("proof_gl")
    if not stats or not rec.get("proofs"):
        return None
    return 1e3 * stats["sample_s"] / rec["proofs"]

"""tools_torch/gen_vectors.py and gen_gl_vectors.py, the JAX generators
pointed into the port's oracle: their output equals the frozen
tests/vectors/*.json byte for byte, and lands in --out, not in
tests/vectors/."""

import os

import pytest

from tools_torch import gen_gl_vectors, gen_vectors

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")


@pytest.mark.parametrize("tool,name", [(gen_vectors, "bn254_testvectors.json"),
                                       (gen_gl_vectors, "gl_testvectors.json")])
def test_generator_output_equals_the_frozen_vectors(tool, name, tmp_path, capsys):
    frozen = os.path.join(VECTORS, name)
    before = os.stat(frozen).st_mtime_ns
    assert tool.main(["--out", str(tmp_path)]) == 0
    with open(tmp_path / name, "rb") as a, open(frozen, "rb") as b:
        assert a.read() == b.read()
    assert os.stat(frozen).st_mtime_ns == before
    assert capsys.readouterr().out == f"wrote {tmp_path / name}\n"


def test_default_output_is_under_build():
    for tool in (gen_vectors, gen_gl_vectors):
        out = os.path.normpath(tool.DEFAULT_OUT)
        assert out.endswith(os.path.join("build", "vectors")) and out != VECTORS

"""What the benchmark loads: no JAX, no JAX package; the reference loads
nothing of the program.  Each check runs in a fresh interpreter."""

import subprocess
import sys

from port_bench.run import BANNED

PORT = "codex_storage_proofs_circuits_tpu_torch"


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print('\\n'.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_the_harness_and_the_program_load_no_jax():
    loaded = _loaded(
        "from port_bench import run, spec, control, harness, judge\n"
        "from port_bench.tests.tiny import tiny_spec\n"
        "for w in ('codex-bn254-p2.commit-dev-1g', 'codex-bn254-p2.prove-fresh-4x256m'):\n"
        "    s = spec.load(w)\n"
        "    spec.request_kind(s.traffic['request']).Client(tiny_spec(w), 1, 'cpu', '.')\n")
    assert PORT in loaded
    assert not loaded & set(BANNED)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import pkgutil, importlib, port_bench.reference as R\n"
                     "for m in pkgutil.iter_modules(R.__path__):\n"
                     "    importlib.import_module('port_bench.reference.' + m.name)\n"
                     "import port_bench.judge, port_bench.peaks\n")
    assert not loaded & (set(BANNED) | {PORT})


def test_banned_names_compare_whole():
    assert "codex_storage_proofs_circuits_tpu" in BANNED
    assert PORT.split(".")[0] not in BANNED

"""The port imports neither jax nor the JAX package: every module of the port
package, chip_smoke.py, bench_torch.py and the scripts of tools_torch/ load,
and the host C library of native/ builds and loads, in a fresh interpreter
with jax and every module of codex_storage_proofs_circuits_tpu absent from
sys.modules (the machine with the GPU has no jax, and the port keeps its
own copies of the JAX package's jax-free modules)."""

import os
import pkgutil
import subprocess
import sys

import codex_storage_proofs_circuits_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules() -> list[str]:
    return [port.__name__] + [
        m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")
    ]


def test_port_modules_are_found():
    mods = _port_modules()
    for name in ("ops.limbs", "ops.poseidon2_cuda", "ops.fake_prng", "kernels.build",
                 "models.streaming", "models.proof_input", "utils.cli", "convert",
                 "ops.goldilocks_plain", "ops.goldilocks_cuda", "ops.gl_encode",
                 "models.gl_hashing", "models.gl_proof_input", "fields.goldilocks",
                 "fields.gl_tables", "oracle.goldilocks_pipeline", "models.circuit",
                 "parallel", "parallel.mesh", "parallel.tree", "parallel.gl_tree",
                 "parallel.proof_input", "parallel.distributed", "entry", "native",
                 "native.build", "ops.microbench_plain", "ops.microbench_cuda"):
        assert f"{port.__name__}.{name}" in mods


def test_port_imports_no_jax():
    mods = _port_modules() + ["chip_smoke", "tools_torch.chunk_sweep", "tools_torch.time_against",
                              "tools_torch.gl_tree_widths", "tools_torch.p2_tree_widths",
                              "tools_torch.tile_sweep",
                              "tools_torch.print_testvectors", "bench_torch",
                              "tools_torch.profile_stages", "tools_torch.scaling_bench",
                              "tools_torch.gen_vectors", "tools_torch.gen_gl_vectors",
                              "tools_torch.microbench", "tools_torch.microbench2"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "native = importlib.import_module('codex_storage_proofs_circuits_tpu_torch.native')\n"
        "assert native.available(), native.build_error()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "jax_pkg = 'codex_storage_proofs_circuits_tpu'\n"
        "bad = sorted(m for m in sys.modules if m == jax_pkg or m.startswith(jax_pkg + '.'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]

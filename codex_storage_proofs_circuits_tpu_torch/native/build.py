"""Build the host C library of native/ (cspc_native.c, which includes
cspc_gl.c) with the system C compiler.

The two constants headers the C sources include by quoted name,
poseidon2_constants.h and gl_constants.h, are generated from the port's
fields/bn254.py and fields/goldilocks.py (so a CSPC_GL_CONSTANTS override
reaches the C library as it reaches the CUDA kernels) and written beside
the library, under build/native/<hash>/ at the root of the checkout (a
directory .gitignore lists).  The hash covers the C sources, the headers,
the compiler and its flags, so a changed source or compiler builds anew.
The compiler is $CC (default cc), with -O3 -march=native, and again
without -march=native where the toolchain refuses it.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

from ..fields import bn254
from ..fields import goldilocks as G
from ..oracle.goldilocks import SPONGE_IV_GL

_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_DIR)
SOURCES = ("cspc_native.c", "cspc_gl.c")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "native")
LIB_NAME = "libcspc_native.so"
CFLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]
CC_TIMEOUT_S = 300


def _limbs4(x: int) -> str:
    ls = [(x >> (64 * i)) & ((1 << 64) - 1) for i in range(4)]
    return "{" + ", ".join(f"0x{v:016x}ULL" for v in ls) + "}"


def c_constants_header() -> str:
    """The BN254 Poseidon2 constants of fields/bn254.py as poseidon2_constants.h:
    4 x uint64 little-endian limbs, values in Montgomery form (R = 2^256)."""
    P = bn254.P
    mont = bn254.to_mont
    lines = [
        "/* generated by codex_storage_proofs_circuits_tpu_torch/native/build.py"
        " from fields/bn254.py — do not edit */",
        "#pragma once",
        "#include <stdint.h>",
        "",
        f"static const uint64_t FR_P[4] = {_limbs4(P)};",
        f"static const uint64_t FR_P_INV_NEG = 0x{(-pow(P, -1, 1 << 64)) % (1 << 64):016x}ULL;"
        " /* -P^-1 mod 2^64 */",
        f"static const uint64_t FR_R_MONT[4] = {_limbs4(bn254.R_MONT)};",
        f"static const uint64_t FR_R2_MONT[4] = {_limbs4(bn254.R2_MONT)};",
        "",
        "/* round constants, Montgomery form */",
        "static const uint64_t P2_EXT_RC[8][3][4] = {",
    ]
    for triple in bn254.EXTERNAL_ROUND_CONSTS:
        lines.append("  {" + ", ".join(_limbs4(mont(c)) for c in triple) + "},")
    lines.append("};")
    lines.append("static const uint64_t P2_INT_RC[56][4] = {")
    lines.extend(f"  {_limbs4(mont(c))}," for c in bn254.INTERNAL_ROUND_CONSTS)
    lines.append("};")
    lines.append("")
    lines.append("/* Montgomery forms of the Merkle keys 0..3 and sponge IVs */")
    lines.append("static const uint64_t P2_KEYS[4][4] = {")
    lines.extend(f"  {_limbs4(mont(k))}," for k in range(4))
    lines.append("};")
    lines.append(f"static const uint64_t P2_SPONGE1_IV[4] = {_limbs4(mont((1 << 64) + 0x0301))};")
    lines.append(f"static const uint64_t P2_SPONGE2_IV[4] = {_limbs4(mont((1 << 64) + 0x0302))};")
    lines.append(f"static const uint64_t P2_ONE_MONT[4] = {_limbs4(mont(1))};")
    lines.append("")
    return "\n".join(lines)


def gl_c_constants_header() -> str:
    """The Goldilocks tables of fields/goldilocks.py as gl_constants.h: plain
    uint64 residues below p (the C path needs no Montgomery form)."""

    def row(vs) -> str:
        return "  {" + ", ".join(f"0x{v:016x}ULL" for v in vs) + "},"

    lines = [
        "/* generated by codex_storage_proofs_circuits_tpu_torch/native/build.py"
        " from fields/goldilocks.py — do not edit */",
        "#pragma once",
        "#include <stdint.h>",
        "",
        f"#define GL_P 0x{G.P_GL:016x}ULL",
        f"#define GL_SPONGE_IV 0x{SPONGE_IV_GL:016x}ULL",
        f"#define GL_RF {G.RF}",
        f"#define GL_RP {G.RP}",
        f"#define GL_T {G.T}",
        f"#define GL_RATE {G.RATE}",
        f"#define GL_MONO_ROUNDS {G.MONOLITH_ROUNDS}",
        f"#define GL_MONO_BARS {G.MONOLITH_BARS}",
        "",
        "static const uint64_t GL_EXT_RC[GL_RF][GL_T] = {",
        *(row(r) for r in G.P2GL_EXTERNAL_RC),
        "};",
        "",
        "static const uint64_t GL_INT_RC[GL_RP] = {",
        "  " + ", ".join(f"0x{v:016x}ULL" for v in G.P2GL_INTERNAL_RC),
        "};",
        "",
        "static const uint64_t GL_DIAG_M1[GL_T] = {",
        "  " + ", ".join(f"0x{(v - 1) % G.P_GL:016x}ULL" for v in G.P2GL_INTERNAL_DIAG),
        "};",
        "",
        "static const uint64_t GL_MONO_RC[GL_MONO_ROUNDS][GL_T] = {",
        *(row(r) for r in G.MONOLITH_RC),
        "};",
        "",
        "/* Monolith Concrete (Plonky2-compatible MDS) full matrix */",
        "static const uint64_t GL_MONO_CONCRETE[GL_T][GL_T] = {",
        *("  {" + ", ".join(f"{v}ULL" for v in r) + "}," for r in G.MONOLITH_CONCRETE),
        "};",
        "",
    ]
    return "\n".join(lines)


HEADERS = {
    "poseidon2_constants.h": c_constants_header,
    "gl_constants.h": gl_c_constants_header,
}


def _cc() -> str:
    return os.environ.get("CC", "cc")


def build_dir() -> str:
    """The directory the library of the current sources, headers and
    compiler is built into."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    for name, gen in HEADERS.items():
        h.update(name.encode())
        h.update(gen().encode())
    h.update(" ".join([_cc(), *CFLAGS]).encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _compile(cmd: list[str]) -> subprocess.CompletedProcess | str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=CC_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:  # no compiler / hang
        return f"{cmd[0]}: {e}"


def build_into(out_dir: str) -> str | None:
    """Write the headers and compile the library into out_dir; None, or the
    compiler's error.  The library is written under a temporary name and
    renamed, so processes building the same directory at once each see a
    whole file."""
    fresh = not os.path.isdir(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    for name, gen in HEADERS.items():
        tmp = os.path.join(out_dir, f"{name}.{tag}")
        with open(tmp, "w") as f:
            f.write(gen())
        os.replace(tmp, os.path.join(out_dir, name))
    so = os.path.join(out_dir, LIB_NAME)
    cmd = [_cc(), *CFLAGS, "-I", out_dir, os.path.join(_DIR, SOURCES[0]), "-o", f"{so}.{tag}"]
    r = _compile(cmd)
    if not isinstance(r, str) and r.returncode != 0:
        # retry without -march=native (unsupported on some toolchains)
        cmd.remove("-march=native")
        r = _compile(cmd)
    if isinstance(r, str) or r.returncode != 0:
        if fresh:  # leave no directory of headers without its library
            shutil.rmtree(out_dir, ignore_errors=True)
        return r if isinstance(r, str) else r.stderr[-2000:]
    os.replace(f"{so}.{tag}", so)
    return None


def library() -> tuple[str, str | None]:
    """(path of the built library, None), building it at first use, or
    (path, the build's error)."""
    out_dir = build_dir()
    so = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(so):
        return so, None
    return so, build_into(out_dir)

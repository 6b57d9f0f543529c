"""Build and load the hand-written CUDA kernels of csrc/ (nvcc + ctypes).

At first use, the csrc/*.cu sources and two constants headers generated
from fields/bn254.py and fields/goldilocks.py are compiled by nvcc for
sm_90a, one nvcc per source, all started together, and linked into one
shared library with a plain C interface, under build/torch_kernels/<hash>/
at the root of the checkout (a directory .gitignore lists).  The hash covers
the sources, the headers and the flags, so a changed source builds anew.  The library is
loaded with ctypes: every pointer and the stream cross as c_void_p, sizes as
c_int or c_longlong.  Each C entry point returns cudaGetLastError() after
its launch, and `check` raises if that is not 0.

Kernel wrappers add one to LAUNCHES[name] each time they launch a kernel.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..fields import bn254
from ..fields import goldilocks as G
from ..fields.gl_tables import SPONGE_IV

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_NAME = "libcspc_torch_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
NVCC_TIMEOUT_S = 900

# Launch counts of the kernels: K1 "perm", K2 "sponge2", K3 "prng",
# K4 "gl_perm", K5 "mono_perm", K6 "gl_sponge8" / "mono_sponge8".  K2 and
# K6 count their byte-row entries (the main paths') under those names and
# their limb-plane entries (the JAX parity API) under "..._planes".
LAUNCHES = {
    "perm": 0, "sponge2": 0, "prng": 0,
    "gl_perm": 0, "mono_perm": 0, "gl_sponge8": 0, "mono_sponge8": 0,
    "sponge2_planes": 0, "gl_sponge8_planes": 0, "mono_sponge8_planes": 0,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    # x, xrs, xcs, y, yrs, ycs, z, zrs, zcs, key, out, out_lanes, n, device, stream
    "cspc_p2_perm": [_VP, _LL, _LL, _VP, _LL, _LL, _VP, _LL, _LL, _I, _VP, _I, _LL, _I, _VP],
    # blocks, nb, out, n, device, stream
    "cspc_p2_sponge2": [_VP, _I, _VP, _LL, _I, _VP],
    # rows, row_stride, col_stride, cell_size, out, n, device, stream
    "cspc_p2_sponge2_rows": [_VP, _LL, _LL, _I, _VP, _LL, _I, _VP],
    # seed1_base, seed2_base, out, n_steps, n, device, stream
    "cspc_fake_prng_rows": [_VP, _VP, _VP, _I, _LL, _I, _VP],
    # hash, x, xls, xks, xcs, y, yls, yks, ycs, key, out, out_lanes, n, device, stream
    "cspc_gl_perm": [_I, _VP, _LL, _LL, _LL, _VP, _LL, _LL, _LL, _I, _VP, _I, _LL, _I, _VP],
    # hash, felts, fs, ks, cs, nf, out, n, device, stream
    "cspc_gl_sponge8": [_I, _VP, _LL, _LL, _LL, _I, _VP, _LL, _I, _VP],
    # hash, rows, row_stride, col_stride, cell_size, out, n, device, stream
    "cspc_gl_sponge8_rows": [_I, _VP, _LL, _LL, _I, _VP, _LL, _I, _VP],
}


def _words(x: int) -> str:
    """Integer < 2^256 -> C initializer of 8 little-endian 32-bit words."""
    return "{" + ", ".join(f"0x{(x >> (32 * i)) & 0xFFFFFFFF:08x}u" for i in range(8)) + "}"


def constants_header() -> str:
    """The Poseidon2 constants of fields/bn254.py as a CUDA header: P, 2P,
    R mod P (ONE_MONT) and R^2 mod P as initializers of 8 x 32-bit words for
    local constexpr arrays, the 32-bit Montgomery quotient factor, and the
    round constants, Merkle keys and sponge IV in Montgomery form
    (R = 2^256)."""
    mont = bn254.to_mont
    p = bn254.P
    lines = [
        "// generated by kernels/build.py from fields/bn254.py; do not edit",
        "#pragma once",
        "#include <cstdint>",
        "",
        f"#define FR_PINV 0x{(-pow(p, -1, 1 << 32)) % (1 << 32):08x}u  // -P^-1 mod 2^32",
        f"#define P2_N_INTERNAL {bn254.N_INTERNAL_ROUNDS}",
        f"#define FR_P_WORDS {_words(p)}",
        f"#define FR_2P_WORDS {_words(2 * p)}",
        f"#define FR_ONE_WORDS {_words(bn254.R_MONT)}",
        f"#define FR_R2_WORDS {_words(bn254.R2_MONT)}",
        f"static __constant__ uint32_t P2_EXT_RC[{bn254.N_EXTERNAL_ROUNDS}][3][8] = {{",
    ]
    for triple in bn254.EXTERNAL_ROUND_CONSTS:
        lines.append("  {" + ", ".join(_words(mont(c)) for c in triple) + "},")
    lines.append("};")
    lines.append(f"static __constant__ uint32_t P2_INT_RC[{bn254.N_INTERNAL_ROUNDS}][8] = {{")
    lines.extend(f"  {_words(mont(c))}," for c in bn254.INTERNAL_ROUND_CONSTS)
    lines.append("};")
    lines.append("static __constant__ uint32_t P2_KEYS[4][8] = {")
    lines.extend(f"  {_words(mont(k))}," for k in range(4))
    lines.append("};")
    lines.append(
        f"static __constant__ uint32_t P2_SPONGE2_IV[8] = {_words(mont((1 << 64) + 0x0302))};"
    )
    return "\n".join(lines) + "\n"


def _matrix(m) -> str:
    return "{" + ", ".join("{" + ", ".join(f"{v}u" for v in row) + "}" for row in m) + "}"


def gl_constants_header() -> str:
    """The Goldilocks tables of fields/goldilocks.py as a CUDA header: the
    Poseidon2-GL round constants and internal diagonal (mu_i - 1), the
    Monolith round constants and Concrete matrix, the sponge IV.  The
    Concrete is an initializer of small integers for a local constexpr
    array, so the unrolled row sums fold it into immediates.  The external
    layer circ(2 M4, M4, M4) is the kernel's M4 addition chain, which holds
    only for the M4 it was written for (checked here)."""
    if [list(row) for row in G.M4] != M4_CHAIN:
        raise ValueError("the Poseidon2-GL M4 is not the matrix of the kernel's addition chain")
    m = G.MONOLITH_CONCRETE
    if any(v < 0 for row in m for v in row) or max(sum(row) for row in m) >= 1 << 20:
        raise ValueError("the Monolith Concrete is not a small non-negative matrix")

    def u64(v: int) -> str:
        return f"0x{v:016x}ULL"

    def rows(table) -> str:
        return "\n".join("  {" + ", ".join(u64(v) for v in row) + "}," for row in table)

    return "\n".join([
        "// generated by kernels/build.py from fields/goldilocks.py; do not edit",
        "#pragma once",
        "#include <cstdint>",
        "",
        f"#define GL_RATE {G.RATE}",
        f"#define GL_P2_RF {G.RF}",
        f"#define GL_P2_RP {G.RP}",
        f"#define GL_MONO_ROUNDS {G.MONOLITH_ROUNDS}",
        f"#define GL_MONO_BARS {G.MONOLITH_BARS}",
        f"#define GL_SPONGE_IV {u64(SPONGE_IV)}",
        f"#define GL_MONO_CONCRETE {_matrix(G.MONOLITH_CONCRETE)}",
        f"static __constant__ uint64_t GL_P2_EXT_RC[{G.RF}][{G.T}] = {{",
        rows(G.P2GL_EXTERNAL_RC),
        "};",
        f"static __constant__ uint64_t GL_P2_INT_RC[{G.RP}] = {{"
        + ", ".join(u64(v) for v in G.P2GL_INTERNAL_RC) + "};",
        f"static __constant__ uint64_t GL_P2_DIAG[{G.T}] = {{"
        + ", ".join(u64((d - 1) % G.P_GL) for d in G.P2GL_INTERNAL_DIAG) + "};",
        f"static __constant__ uint64_t GL_MONO_RC[{G.MONOLITH_ROUNDS}][{G.T}] = {{",
        rows(G.MONOLITH_RC),
        "};",
    ]) + "\n"


# The M4 of csrc/goldilocks.cu::m4, whose addition chain computes exactly
# this matrix.
M4_CHAIN = [[5, 7, 1, 3], [4, 6, 1, 1], [1, 3, 5, 7], [1, 1, 4, 6]]

HEADERS = {
    "poseidon2_bn254_constants.h": constants_header,
    "goldilocks_constants.h": gl_constants_header,
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.h")))


def build_dir() -> str:
    """The directory the library of the current sources is built into."""
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    for name, gen in HEADERS.items():
        h.update(name.encode())
        h.update(gen().encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _replace_atomically(path: str, data: bytes) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _run_all(cmds: list[list[str]], what: list[str]) -> list[str]:
    """Run the commands in parallel; raise on the first that fails or times
    out.  Returns each command's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    try:
        for p, w in zip(procs, what):
            try:
                out, _ = p.communicate(timeout=NVCC_TIMEOUT_S)
            except subprocess.TimeoutExpired as e:
                raise RuntimeError(f"nvcc did not finish {w} in {NVCC_TIMEOUT_S} s") from e
            logs.append(f"== {w}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {w} ({p.returncode}):\n{out[-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def build_into(out_dir: str, parallel: bool = True) -> None:
    """Build the library into out_dir: one nvcc per source, all started
    together (parallel=False runs them one after another, for
    kernels/time_build.py), then one link."""
    os.makedirs(out_dir, exist_ok=True)
    for name, gen in HEADERS.items():
        _replace_atomically(os.path.join(out_dir, name), gen().encode())
    tag = f"{os.getpid()}.tmp"
    srcs = [s for s in _sources() if s.endswith(".cu")]
    objs = [os.path.join(out_dir, os.path.basename(s) + f".{tag}.o") for s in srcs]
    nvcc = _nvcc()
    cmds = [[nvcc, *NVCC_FLAGS, "-I", out_dir, "-I", CSRC, "-c", s, "-o", o]
            for s, o in zip(srcs, objs)]
    names = [os.path.basename(s) for s in srcs]
    try:
        if parallel:
            logs = _run_all(cmds, names)
        else:
            logs = [log for c, w in zip(cmds, names) for log in _run_all([c], [w])]
        lib = os.path.join(out_dir, f"{LIB_NAME}.{tag}")
        logs += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                           "-o", lib, *objs]], ["link"])
        _replace_atomically(os.path.join(out_dir, "nvcc.log"), "\n".join(logs).encode())
        os.replace(lib, os.path.join(out_dir, LIB_NAME))
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)


def load() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            out_dir = build_dir()
            so = os.path.join(out_dir, LIB_NAME)
            if not os.path.exists(so):
                build_into(out_dir)
            lib = ctypes.CDLL(so)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cspc_error_string.argtypes = [ctypes.c_int]
            lib.cspc_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load().cspc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def require_cuda(t: torch.Tensor, what: str, dtype, shape: tuple | None = None) -> None:
    """Raise unless t is a CUDA tensor of dtype (and shape, None = any size)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if shape is not None and (
        t.ndim != len(shape)
        or any(w is not None and w != s for w, s in zip(shape, t.shape))
    ):
        raise ValueError(f"{what}: shape {tuple(t.shape)} does not match {shape}")


def launch_args(t: torch.Tensor) -> tuple[int, int]:
    """(device index, stream handle) for a launch on t's device."""
    dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream

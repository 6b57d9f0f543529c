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

# Launch counts of the kernels: K1 "p2_tree" (the subtree kernel of the
# main path) and "perm" (its one-layer permutation and compression entry),
# K2 "sponge2", K3 "prng", K4 "gl_perm", K5 "mono_perm", K6 "gl_sponge8" /
# "mono_sponge8".  K2 and K6 count their byte-row entries (the main paths')
# under those names and their limb-plane entries (the JAX parity API) under
# "..._planes".  The microbenchmark kernels M1-M6 (csrc/microbench.cu)
# count under "mb_mul", "mb_add", "mb_mix", "mb_ilp", "mb_conv", "mb_dot".
LAUNCHES = {
    "p2_tree": 0, "perm": 0, "sponge2": 0, "prng": 0,
    "gl_perm": 0, "mono_perm": 0, "gl_sponge8": 0, "mono_sponge8": 0,
    "sponge2_planes": 0, "gl_sponge8_planes": 0, "mono_sponge8_planes": 0,
    "mb_mul": 0, "mb_add": 0, "mb_mix": 0, "mb_ilp": 0, "mb_conv": 0, "mb_dot": 0,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    # x, xrs, xcs, y, yrs, ycs, z, zrs, zcs, key, out, out_lanes, n, device, stream
    "cspc_p2_perm": [_VP, _LL, _LL, _VP, _LL, _LL, _VP, _LL, _LL, _I, _VP, _I, _LL, _I, _VP],
    # x, xrs, xcs, mont_in, out0, out, w, levels, key_mask, done, device, stream
    "cspc_p2_tree": [_VP, _LL, _LL, _I, _VP, _VP, _LL, _I, ctypes.c_uint,
                     ctypes.POINTER(ctypes.c_int), _I, _VP],
    # blocks, nb, out, n, device, stream
    "cspc_p2_sponge2": [_VP, _I, _VP, _LL, _I, _VP],
    # rows, row_stride, col_stride, cell_size, out, n, device, stream
    "cspc_p2_sponge2_rows": [_VP, _LL, _LL, _I, _VP, _LL, _I, _VP],
    # seed1_base, seed2_base, out, n_steps, n, device, stream
    "cspc_fake_prng_rows": [_VP, _VP, _VP, _I, _LL, _I, _VP],
    # hash, x, xls, xks, xcs, y, yls, yks, ycs, key, out, out_lanes, n, device, stream
    "cspc_gl_perm": [_I, _VP, _LL, _LL, _LL, _VP, _LL, _LL, _LL, _I, _VP, _I, _LL, _I, _VP],
    # hash, x, xls, xks, xcs, out, w, levels, key_mask, done, device, stream
    "cspc_gl_tree": [_I, _VP, _LL, _LL, _LL, _VP, _LL, _I, ctypes.c_uint,
                     ctypes.POINTER(ctypes.c_int), _I, _VP],
    # hash, felts, fs, ks, cs, nf, out, n, device, stream
    "cspc_gl_sponge8": [_I, _VP, _LL, _LL, _LL, _I, _VP, _LL, _I, _VP],
    # hash, rows, row_stride, col_stride, cell_size, out, n, device, stream
    "cspc_gl_sponge8_rows": [_I, _VP, _LL, _LL, _I, _VP, _LL, _I, _VP],
    # op, a, b, out, n, device, stream
    "cspc_mb_elem": [_I, _VP, _VP, _VP, _LL, _I, _VP],
    # m, k, a, w, out, n_dots, cols, device, stream
    "cspc_mb_dot": [_I, _I, _VP, _VP, _VP, _I, _LL, _I, _VP],
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


def _ints(v) -> str:
    return "{" + ", ".join(str(x) for x in v) + "}"


def _crt12(a: int, b: int) -> int:
    """The lane at (a mod 4, b mod 3): csrc/goldilocks.cu::crt12."""
    return (9 * a + 4 * b) % 12


def concrete_tables(m) -> dict[str, list[int]]:
    """Monolith's Concrete m = circ(c) + diag(d) (m[r][k] = c[(k - r) mod 12]
    off the diagonal) as the kernel's frequency-domain form
    (csrc/goldilocks.cu::concrete_half).  y = m x is the cyclic convolution
    of x with e[j] = c[-j mod 12], plus d * x.  With lane i at
    (i mod 4, i mod 3), e's 4-point sums and differences at each b give, in
    Z (s = 1), Z (s = -1) and Z[s]/(s^2 + 1), the 3-point kernels k1, km and
    kr + ki s of the convolutions the kernel runs, scaled by the inverse
    transform's 1/4 (1/2 in the complex ring, whose inverse counts it
    twice); diag is d, with c[0] the least diagonal entry.  Raises when m is
    not 12 x 12 small non-negative integers, not a circulant plus a
    diagonal, or when a scaled kernel value is not an integer."""
    n = 12
    if len(m) != n or any(len(row) != n for row in m):
        raise ValueError("the Monolith Concrete is not a 12 x 12 matrix")
    if any(v < 0 for row in m for v in row) or max(sum(row) for row in m) >= 1 << 20:
        raise ValueError("the Monolith Concrete is not a small non-negative matrix")
    c0 = min(m[r][r] for r in range(n))
    c = [c0] + [m[0][k] for k in range(1, n)]
    if any(m[r][k] != c[(k - r) % n] for r in range(n) for k in range(n) if k != r):
        raise ValueError("the Monolith Concrete is not a circulant plus a diagonal:"
                         " the kernel's convolution form does not apply")
    e = [c[-j % n] for j in range(n)]
    tables: dict[str, list[int]] = {"k1": [], "km": [], "kr": [], "ki": []}
    for b in range(3):
        v0, v1, v2, v3 = (e[_crt12(a, b)] for a in range(4))
        for name, val, scale in (("k1", v0 + v1 + v2 + v3, 4), ("km", v0 - v1 + v2 - v3, 4),
                                 ("kr", v0 - v2, 2), ("ki", v1 - v3, 2)):
            if val % scale:
                raise ValueError("the Monolith Concrete's transform is not integral after the"
                                 " inverse scaling: the kernel's convolution form does not apply")
            tables[name].append(val // scale)
    tables["diag"] = [m[r][r] - c0 for r in range(n)]
    return tables


def concrete_apply(tables: dict[str, list[int]], x: list[int]) -> list[int]:
    """The kernel's Concrete step by step in Python integers (each half's
    arithmetic modulo 2^64, as uint64_t): x (12 values below 2^64) ->
    canonical M x mod p."""
    mod = (1 << 64) - 1
    k1, km, kr, ki = tables["k1"], tables["km"], tables["kr"], tables["ki"]

    def half(h: list[int]) -> list[int]:
        p1, pm, pr, pi = [0] * 3, [0] * 3, [0] * 3, [0] * 3
        for b in range(3):
            v0, v1, v2, v3 = (h[_crt12(a, b)] for a in range(4))
            p1[b], pm[b] = (v0 + v2 + v1 + v3) & mod, (v0 + v2 - v1 - v3) & mod
            pr[b], pi[b] = (v0 - v2) & mod, (v1 - v3) & mod
        y = [0] * 12
        for b in range(3):
            z1 = zm = zr = zi = 0
            for j in range(3):
                i = (b - j) % 3
                z1 += k1[j] * p1[i]
                zm += km[j] * pm[i]
                zr += kr[j] * pr[i] - ki[j] * pi[i]
                zi += kr[j] * pi[i] + ki[j] * pr[i]
            e, o = z1 + zm, z1 - zm
            for a, v in enumerate((e + zr, o + zi, e - zr, o - zi)):
                y[_crt12(a, b)] = v & mod
        return [(v + d * hv) & mod for v, d, hv in zip(y, tables["diag"], h)]

    lo = half([v & 0xFFFFFFFF for v in x])
    hi = half([v >> 32 for v in x])
    return [(a + (b << 32)) % G.P_GL for a, b in zip(lo, hi)]


def gl_constants_header() -> str:
    """The Goldilocks tables of fields/goldilocks.py as a CUDA header: the
    Poseidon2-GL round constants and internal diagonal (mu_i - 1), the
    Monolith round constants and the Concrete's convolution tables
    (concrete_tables), the sponge IV.  The Concrete tables are initializers
    of small integers for local constexpr arrays, so the unrolled
    convolutions fold them into shifts and adds.  The external layer
    circ(2 M4, M4, M4) is the kernel's M4 addition chain, which holds only
    for the M4 it was written for (checked here)."""
    if [list(row) for row in G.M4] != M4_CHAIN:
        raise ValueError("the Poseidon2-GL M4 is not the matrix of the kernel's addition chain")
    conc = concrete_tables(G.MONOLITH_CONCRETE)

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
        f"#define GL_MONO_CONC_K1 {_ints(conc['k1'])}",
        f"#define GL_MONO_CONC_KM {_ints(conc['km'])}",
        f"#define GL_MONO_CONC_KR {_ints(conc['kr'])}",
        f"#define GL_MONO_CONC_KI {_ints(conc['ki'])}",
        f"#define GL_MONO_CONC_DIAG {_ints(conc['diag'])}",
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

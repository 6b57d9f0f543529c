"""native — ctypes bindings for the host C library (libcspc_native).

The port's copy of the JAX package's native/: a multi-threaded, bit-exact
CPU implementation of the math the reference delegates to its pinned
native dependencies (constantine / nim-poseidon2,
reference/nim/proof_input/proof_input.nimble:11-13).  It serves as

  * a fast CPU oracle for verifying the CUDA kernels (chip_smoke.py holds
    whole 1 GB slot roots built on the card against it),
  * the `--backend=native` compute path of `cspc-torch`, and
  * the fake-data route of models/data.py for contiguous cell ranges.

cspc_native.c and cspc_gl.c are the JAX package's sources unchanged; the
constants headers they include are generated from the port's fields/ and
the library is compiled at first use with $CC into build/native/<hash>/
(native/build.py).  `available()` reports whether that worked.  The
threads of each call: CSPC_NATIVE_THREADS (default os.cpu_count()).
Felts cross the ABI in canonical form as 4 little-endian uint64 limbs.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import build

_lock = threading.Lock()
_lib = None
_err: str | None = None

MASK64 = (1 << 64) - 1
_U64P = ctypes.POINTER(ctypes.c_uint64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _load():
    global _lib, _err
    with _lock:
        if _lib is not None or _err is not None:
            return _lib
        so, _err = build.library()
        if _err is not None:
            return None
        lib = ctypes.CDLL(so)
        lib.cspc_permutation.argtypes = [_U64P]
        lib.cspc_keyed_compress.argtypes = [_U64P, _U64P, _U64P, ctypes.c_int]
        lib.cspc_sponge2.argtypes = [_U64P, _U64P, ctypes.c_size_t]
        lib.cspc_sponge1.argtypes = [_U64P, _U64P, ctypes.c_size_t]
        lib.cspc_fake_cells.argtypes = [
            _U8P, ctypes.c_size_t, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_size_t]
        lib.cspc_fake_cells_mt.argtypes = [
            _U8P, ctypes.c_size_t, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_size_t, ctypes.c_int]
        lib.cspc_hash_cells.argtypes = [
            _U64P, _U8P, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int]
        lib.cspc_merkle_total_nodes.argtypes = [ctypes.c_size_t]
        lib.cspc_merkle_total_nodes.restype = ctypes.c_size_t
        lib.cspc_merkle_build.argtypes = [_U64P, _U64P, ctypes.c_size_t, ctypes.c_int]
        lib.cspc_merkle_build.restype = ctypes.c_int
        lib.cspc_slot_tree_from_bytes.argtypes = [
            _U64P, _U64P, _U8P, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_int]
        lib.cspc_slot_tree_from_bytes.restype = ctypes.c_int
        lib.cspc_sample_cell_index.argtypes = [
            _U64P, _U64P, ctypes.c_uint64, ctypes.c_int]
        lib.cspc_sample_cell_index.restype = ctypes.c_uint64
        # Goldilocks track
        lib.cspc_gl_permutation.argtypes = [_U64P, ctypes.c_int]
        lib.cspc_gl_compress.argtypes = [
            _U64P, _U64P, _U64P, ctypes.c_uint64, ctypes.c_int]
        lib.cspc_gl_digest_felts.argtypes = [
            _U64P, _U64P, ctypes.c_size_t, ctypes.c_int]
        lib.cspc_gl_hash_cell.argtypes = [
            _U64P, _U8P, ctypes.c_size_t, ctypes.c_int]
        lib.cspc_gl_hash_cells.argtypes = [
            _U64P, _U8P, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.cspc_gl_merkle_build.argtypes = [
            _U64P, _U64P, ctypes.c_size_t, ctypes.c_int, ctypes.c_int]
        lib.cspc_gl_merkle_build.restype = ctypes.c_int
        lib.cspc_gl_slot_tree.argtypes = [
            _U64P, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.cspc_gl_slot_tree.restype = ctypes.c_int
        lib.cspc_gl_sample_cell_index.argtypes = [
            _U64P, _U64P, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int]
        lib.cspc_gl_sample_cell_index.restype = ctypes.c_uint64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _err


def _nthreads() -> int:
    return int(os.environ.get("CSPC_NATIVE_THREADS", os.cpu_count() or 1))


# -- felt <-> limb conversion ------------------------------------------------


def _to_limbs(xs) -> np.ndarray:
    """ints -> (n, 4) uint64 LE limbs."""
    out = np.empty((len(xs), 4), np.uint64)
    for i, v in enumerate(xs):
        for j in range(4):
            out[i, j] = (v >> (64 * j)) & MASK64
    return out


def _from_limbs(a: np.ndarray) -> list[int]:
    a = np.ascontiguousarray(a.reshape(-1, 4), np.uint64)
    return [int(r[0]) | int(r[1]) << 64 | int(r[2]) << 128 | int(r[3]) << 192
            for r in a]


def _ptr64(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


# -- primitive wrappers ------------------------------------------------------


def permutation(state: tuple[int, int, int]) -> tuple[int, int, int]:
    lib = _load()
    buf = np.ascontiguousarray(_to_limbs(state))
    lib.cspc_permutation(_ptr64(buf))
    return tuple(_from_limbs(buf))


def keyed_compression(key: int, x: int, y: int) -> int:
    lib = _load()
    xs, ys = _to_limbs([x]), _to_limbs([y])
    out = np.zeros(4, np.uint64)
    lib.cspc_keyed_compress(_ptr64(out), _ptr64(xs), _ptr64(ys), key)
    return _from_limbs(out)[0]


def sponge2(inputs) -> int:
    lib = _load()
    xs = np.ascontiguousarray(_to_limbs(list(inputs)))
    out = np.zeros(4, np.uint64)
    lib.cspc_sponge2(_ptr64(out), _ptr64(xs), len(xs))
    return _from_limbs(out)[0]


def sponge1(inputs) -> int:
    lib = _load()
    xs = np.ascontiguousarray(_to_limbs(list(inputs)))
    out = np.zeros(4, np.uint64)
    lib.cspc_sponge1(_ptr64(out), _ptr64(xs), len(xs))
    return _from_limbs(out)[0]


def fake_cells(cell_size: int, seed: int, start_idx: int, n: int) -> np.ndarray:
    lib = _load()
    out = np.empty(n * cell_size, np.uint8)
    lib.cspc_fake_cells_mt(out.ctypes.data_as(_U8P), cell_size,
                           seed & MASK64, start_idx & MASK64, n, _nthreads())
    return out.reshape(n, cell_size)


def hash_cells(data: np.ndarray, cell_size: int) -> list[int]:
    """Hash n cells (flat uint8 array of n*cell_size bytes) -> n felts."""
    lib = _load()
    data = np.ascontiguousarray(data, np.uint8).reshape(-1)
    n = len(data) // cell_size
    out = np.empty((n, 4), np.uint64)
    lib.cspc_hash_cells(_ptr64(out), data.ctypes.data_as(_U8P),
                        cell_size, n, _nthreads())
    return _from_limbs(out)


def merkle_layers(leaves: list[int]) -> list[list[int]]:
    """All layers (bottom first, leaves included) of the keyed Merkle tree."""
    lib = _load()
    n = len(leaves)
    total = lib.cspc_merkle_total_nodes(n)
    out = np.empty((total, 4), np.uint64)
    lvs = np.ascontiguousarray(_to_limbs(leaves))
    d = lib.cspc_merkle_build(_ptr64(out), _ptr64(lvs), n, _nthreads())
    assert d >= 0, f"cspc_merkle_build failed: {d}"
    flat = _from_limbs(out)
    layers, off, w, bottom = [], 0, n, True
    layers.append(flat[:n])
    off = n
    while w > 1 or bottom:
        w = (w + 1) >> 1
        layers.append(flat[off:off + w])
        off += w
        bottom = False
    return layers


def slot_tree_from_bytes(data: np.ndarray, cell_size: int,
                         cells_per_block: int) -> tuple[list, list[list[int]]]:
    """Full slot tree from raw slot bytes.

    Returns (mini_trees, big_layers): mini_trees is a list of per-block layer
    lists; big_layers the big-tree layers over the block roots.
    """
    lib = _load()
    data = np.ascontiguousarray(data, np.uint8).reshape(-1)
    n_cells = len(data) // cell_size
    n_blocks = n_cells // cells_per_block
    stride = lib.cspc_merkle_total_nodes(cells_per_block)
    big_total = lib.cspc_merkle_total_nodes(n_blocks)
    mini = np.empty((n_blocks * stride, 4), np.uint64)
    big = np.empty((big_total, 4), np.uint64)
    d = lib.cspc_slot_tree_from_bytes(
        _ptr64(mini), _ptr64(big), data.ctypes.data_as(_U8P),
        cell_size, cells_per_block, n_blocks, _nthreads())
    assert d >= 0, f"cspc_slot_tree_from_bytes failed: {d}"

    def split(flat: list[int], n: int) -> list[list[int]]:
        layers, off, w, bottom = [flat[:n]], n, n, True
        while w > 1 or bottom:
            w = (w + 1) >> 1
            layers.append(flat[off:off + w])
            off += w
            bottom = False
        return layers

    mini_flat = _from_limbs(mini)
    minis = [split(mini_flat[b * stride:(b + 1) * stride], cells_per_block)
             for b in range(n_blocks)]
    return minis, split(_from_limbs(big), n_blocks)


def sample_cell_index(entropy: int, slot_root: int, n_cells: int, counter: int) -> int:
    lib = _load()
    log2n = (n_cells - 1).bit_length()
    assert 1 << log2n == n_cells
    e, r = _to_limbs([entropy]), _to_limbs([slot_root])
    return int(lib.cspc_sample_cell_index(_ptr64(e), _ptr64(r), counter, log2n))


# -- full proof-input generation ---------------------------------------------


def generate_proof_input_native(glob, dset, slot_index: int, entropy: int):
    """`--backend=native` twin of oracle.sampling.generate_proof_input:
    the hot loops (fake data, cell hashing, tree builds) run in C; path
    extraction and bundling stay in Python over the returned layers."""
    from ..oracle.dataset import slot_cfg_from_dataset_cfg
    from ..oracle.merkle import MerkleTree, merkle_tree, extract_proof
    from ..oracle.sampling import ProofInput
    from ..oracle.slot import SlotTree, load_cell, cell_data_to_field_elements

    if not available():
        raise RuntimeError(f"native library unavailable: {build_error()}")

    slot_cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]

    def build(cfg):
        if cfg.data_src.kind == "fake":
            data = fake_cells(cfg.cell_size, cfg.data_src.seed, 0, cfg.n_cells)
        else:
            with open(cfg.data_src.filename, "rb") as f:
                raw = f.read(cfg.cell_size * cfg.n_cells)
            data = np.frombuffer(raw, np.uint8)
        minis, big = slot_tree_from_bytes(data, cfg.cell_size, cfg.cells_per_block)
        return SlotTree([MerkleTree(m) for m in minis], MerkleTree(big))

    slot_trees = [build(c) for c in slot_cfgs]
    slot_roots = [t.root for t in slot_trees]
    dset_tree = merkle_tree(slot_roots, keyed_compression)
    slot_proof = extract_proof(dset_tree, slot_index).padded(glob.max_log2_n_slots)

    our_cfg, our_tree = slot_cfgs[slot_index], slot_trees[slot_index]
    our_root = slot_roots[slot_index]
    idxs = [sample_cell_index(entropy, our_root, dset.n_cells, c)
            for c in range(1, dset.n_samples + 1)]

    from ..oracle.slot import extract_cell_proof

    cell_data = [cell_data_to_field_elements(load_cell(our_cfg, i)) for i in idxs]
    merkle_paths = [
        extract_cell_proof(our_cfg, our_tree, i).padded(glob.max_depth).merkle_path
        for i in idxs
    ]
    return ProofInput(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=our_root,
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=slot_proof.merkle_path,
        cell_data=cell_data,
        merkle_paths=merkle_paths,
    )


# -- Goldilocks track --------------------------------------------------------

GL_HASH_CODE = {"poseidon2": 0, "monolith": 1}


def _gl_digests(flat: np.ndarray) -> list[tuple]:
    a = flat.reshape(-1, 4)
    return [tuple(int(v) for v in row) for row in a]


def gl_permutation(hash_fun: str, state) -> list[int]:
    lib = _load()
    buf = np.array(list(state), dtype=np.uint64)
    assert buf.shape == (12,)
    lib.cspc_gl_permutation(_ptr64(buf), GL_HASH_CODE[hash_fun])
    return [int(v) for v in buf]


def gl_compress(hash_fun: str, key: int, x, y) -> tuple:
    lib = _load()
    xa = np.array(x, np.uint64)
    ya = np.array(y, np.uint64)
    out = np.zeros(4, np.uint64)
    lib.cspc_gl_compress(_ptr64(out), _ptr64(xa), _ptr64(ya),
                         key & MASK64, GL_HASH_CODE[hash_fun])
    return tuple(int(v) for v in out)


def gl_digest_felts(hash_fun: str, felts) -> tuple:
    lib = _load()
    xs = np.array(list(felts) or [0], np.uint64)
    out = np.zeros(4, np.uint64)
    n = len(felts) if hasattr(felts, "__len__") else len(xs)
    lib.cspc_gl_digest_felts(_ptr64(out), _ptr64(xs), n, GL_HASH_CODE[hash_fun])
    return tuple(int(v) for v in out)


def gl_slot_tree_layers(hash_fun: str, n_cells: int, cell_size: int, seed: int,
                        block_tree_depth: int) -> list[list[tuple]]:
    """Threaded flat GL slot-tree layers for a fake-data slot (digests)."""
    lib = _load()
    total = 2 * n_cells - 1
    out = np.empty((total, 4), np.uint64)
    d = lib.cspc_gl_slot_tree(_ptr64(out), n_cells, cell_size, seed & MASK64,
                              block_tree_depth, GL_HASH_CODE[hash_fun],
                              _nthreads())
    assert d >= 0, f"cspc_gl_slot_tree failed: {d}"
    flat = _gl_digests(out)
    layers, off, w = [], 0, n_cells
    while w >= 1:
        layers.append(flat[off:off + w])
        off += w
        if w == 1:
            break
        w //= 2
    return layers


def gl_sample_cell_index(hash_fun: str, entropy, slot_root, n_cells: int,
                         counter: int) -> int:
    lib = _load()
    assert n_cells & (n_cells - 1) == 0
    e = np.array(entropy, np.uint64)
    r = np.array(slot_root, np.uint64)
    return int(lib.cspc_gl_sample_cell_index(
        _ptr64(e), _ptr64(r), n_cells, counter & MASK64,
        GL_HASH_CODE[hash_fun]))


def generate_proof_input_gl_native(hash_fun: str, glob, dset, slot_index: int,
                                   entropy):
    """`--backend=native` twin of oracle.goldilocks_pipeline
    .generate_proof_input_gl: fake data, cell sponges and tree builds in
    threaded C; path extraction and bundling in Python over the layers."""
    from ..oracle.dataset import slot_cfg_from_dataset_cfg
    from ..oracle.goldilocks import bytes_to_digests_gl, compress_fn
    from ..oracle.goldilocks_pipeline import ProofInputGL, _pad_digest_path
    from ..oracle.merkle import MerkleTree, extract_proof, merkle_tree
    from ..oracle.slot import SlotTree, load_cell

    if not available():
        raise RuntimeError(f"native library unavailable: {build_error()}")
    assert all(
        slot_cfg_from_dataset_cfg(glob, dset, i).data_src.kind == "fake"
        for i in range(dset.n_slots)
    ), "native GL path currently supports the fake-data source"

    slot_cfgs = [slot_cfg_from_dataset_cfg(glob, dset, i) for i in range(dset.n_slots)]

    def build(cfg):
        btd = cfg.cells_per_block.bit_length() - 1
        flat = gl_slot_tree_layers(hash_fun, cfg.n_cells, cfg.cell_size,
                                   cfg.data_src.seed, btd)
        k = cfg.cells_per_block
        n_blocks = cfg.n_cells // k
        minis = []
        for b in range(n_blocks):
            mlayers = [flat[d][b * (k >> d):(b + 1) * (k >> d)]
                       for d in range(btd + 1)]
            minis.append(MerkleTree(mlayers))
        big_layers = [flat[d] for d in range(btd, len(flat))]
        if n_blocks == 1:
            comp = compress_fn(hash_fun)
            return SlotTree([MerkleTree(m.layers) for m in minis],
                            merkle_tree([minis[0].root], comp))
        return SlotTree(minis, MerkleTree(big_layers))

    slot_trees = [build(c) for c in slot_cfgs]
    slot_roots = [t.root for t in slot_trees]
    comp = compress_fn(hash_fun)
    dset_tree = merkle_tree(slot_roots, comp)
    slot_proof = extract_proof(dset_tree, slot_index)

    our_cfg, our_tree = slot_cfgs[slot_index], slot_trees[slot_index]
    our_root = slot_roots[slot_index]
    idxs = [gl_sample_cell_index(hash_fun, entropy, our_root, dset.n_cells, c)
            for c in range(1, dset.n_samples + 1)]

    k = our_cfg.cells_per_block
    cell_data, merkle_paths = [], []
    for idx in idxs:
        block_idx, within = divmod(idx, k)
        bot = extract_proof(our_tree.mini_trees[block_idx], within)
        top = extract_proof(our_tree.big_tree, block_idx)
        merkle_paths.append(
            _pad_digest_path(bot.merkle_path + top.merkle_path, glob.max_depth)
        )
        cell_data.append(bytes_to_digests_gl(load_cell(our_cfg, idx)))

    return ProofInputGL(
        entropy=entropy,
        data_set_root=dset_tree.root,
        slot_index=slot_index,
        slot_root=our_root,
        n_slots_per_dataset=dset.n_slots,
        n_cells_per_slot=dset.n_cells,
        slot_proof=_pad_digest_path(slot_proof.merkle_path, glob.max_log2_n_slots),
        cell_data=cell_data,
        merkle_paths=merkle_paths,
    )

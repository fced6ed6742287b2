"""Build, load and count the port's CUDA kernels.

``csrc/*.cu`` is compiled by ``nvcc`` at first use (one process per
source, in parallel, then one link) into one shared library with a
plain C interface, cached under
``fractalshark_tpu_torch/build/`` by a hash of the sources and flags,
and loaded with ctypes.  Nothing here runs at import: the CPU tests
import every module of the port on machines without nvcc or a card.

Build flags, and why:

* ``-gencode arch=compute_90a,code=sm_90a``: Hopper (H100).
* ``-fmad=false``: nvcc contracts ``a*b+c`` into a fused multiply-add
  by default.  That breaks the df32 error-free transforms (``split``,
  ``two_prod``) and changes the HDR mantissas' rounding, so every
  ``*`` and ``+`` rounds on its own, as in the plain PyTorch twins.
* ``-ftz=true``: the reference's CPU backend (XLA:CPU) runs with
  subnormals flushed to zero, f32 and f64 alike; the f32 kernels flush
  likewise (the plain twins flush explicitly, ``ops/hdrfloat.ftz``).
  f64 has no flush mode on the card: the f64 kernels flush each result
  in code (``csrc/hdr.cuh`` ``ftz``).
* ``-prec-div=true -prec-sqrt=true``: IEEE division and square root
  (no ``--use_fast_math``).

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0.  The cooperative launches of K9's
whole form and K11 (``coop_launch`` in ``csrc/ntt_products.cuh``) size
their grid by what can be co-resident (queried once per kernel, block
size, shared memory and device, and cached in the library) and return
the launch's refusal (e.g. ``cudaErrorCooperativeLaunchTooLarge``),
which ``check`` raises: no cooperative launch falls back to another
form.  K12
(``csrc/orbit_chunk.cu``) likewise returns a refused opt-in to its block
form's shared memory or a refused cooperative launch of its grid form.
``launches`` counts each kernel's launches: a wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-ftz=true", "-prec-div=true",
              "-prec-sqrt=true", "-Xcompiler", "-fPIC"]

# launch counters, one per kernel instance: K1 (escape) once per frame
# (one C call, both passes); K2 per mantissa type and
# mode (full = the reference's one-kernel la_pallas render, phase1 = its
# la_only machine, lao_f64 = the f64 LAO render); K4 (ntt_orbit, three
# CUDA kernels) and K5 (orbit_tail) once per orbit step, whether launched
# alone or by the per-step chunk loop (fs_orbit_chunk); K6 per entry
# point (perturb_pallas and perturb_stream: the HDR-f32 routes of B10 and
# B11; perturb_hdr32/hdr64: perturb_render_hdr; perturb_f32/f64:
# perturb_render_float; two_phase_tail: the two-phase LAv2 tail over the
# uncompressed orbit, B3's identity-anchor form); K3 (rc_tail) once per
# launch over compressed anchors; K4-NR (ntt_nr) and K5-NR (nr_tail)
# once per NR step, whether launched alone or by the NR chunk loop
# (fs_nr_chunk);
# K1-seq (escape_seq) once per frame sequence, K7 (la_stream) per launch
# (the AT skip and every stage; a relaunch over the pixels still in a
# stage), K8 (ntt_phase) per phase transform (a four-step's two launches
# count two); K9 once per
# multiply per form (ntt_products_whole: one cooperative launch;
# ntt_products_split: three launches), K10 once per tail under each
# setting of BATCHED_TAIL (fused_tail_grid, fused_tail_batched: one C
# call, two launches) and K11 (iterate_full) once per
# step, also inside the flagged chunk loops; K12 once per chunk per form
# and instance (orbit_chunk_block, orbit_chunk_grid, nr_chunk_block,
# nr_chunk_grid); K13 (escape_hdr32/hdr64) and K14 (escape_2x32/2x64) once
# per frame per instance (one C call, both passes), K15 (bla_f32/f64) per
# launch, K6's glitch instance (perturb_scaled: the Scaled family's f32
# pass) per launch; K16 (perturb_hdr_df) per launch, K17 (escape_4x32/
# 4x64: the QD escape) and K18 (escape_qf32/qf64: the QF escape) once per
# frame per instance (one C call, both passes)
KERNELS = ("escape", "lav2_full", "lav2_phase1", "rc_tail", "ntt_orbit",
           "orbit_tail", "lav2_full_f64", "lav2_lao_f64", "perturb_pallas",
           "perturb_stream", "perturb_hdr32", "perturb_hdr64", "perturb_f32",
           "perturb_f64", "two_phase_tail", "ntt_nr", "nr_tail",
           "escape_seq", "la_stream", "ntt_phase", "ntt_products_whole",
           "ntt_products_split", "fused_tail_grid", "fused_tail_batched",
           "iterate_full", "orbit_chunk_block", "orbit_chunk_grid",
           "nr_chunk_block", "nr_chunk_grid", "escape_hdr32", "escape_hdr64",
           "escape_2x32", "escape_2x64", "bla_f32", "bla_f64",
           "perturb_scaled", "perturb_hdr_df", "escape_4x32", "escape_4x64",
           "escape_qf32", "escape_qf64")
launches = {k: 0 for k in KERNELS}

_lib = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
_F64 = ctypes.c_double

# argtypes of every C entry point (pointers and the stream as c_void_p)
_SIGNATURES = {
    # escape: out | width height | min_x max_y dx dy | max_iter cap |
    # list counters parity | stream
    "fs_escape_f32": [_P, _I32, _I32] + [_F32] * 4 + [_I64, _I32, _P, _P,
                                                      _I32, _P],
    "fs_escape_f32_loop": [_P, _I32, _I32] + [_F32] * 4
    + [_I64, _I32, _P, _P, _I32, _P],
    "fs_escape_f64": [_P, _I32, _I32] + [_F64] * 4 + [_I64, _I32, _P, _P,
                                                      _I32, _P],
    # lav2: dc(3) nodes side orbit stages at | state(8) | work counter |
    # n_work n_nodes stage_count | max_ref max_iter chunk at_step | flags |
    # stream
    "fs_lav2": [_P] * 18 + [_I32] * 3 + [_I64] * 4 + [_I32, _P],
    "fs_lav2_f64": [_P] * 18 + [_I32] * 3 + [_I64] * 4 + [_I32, _P],
    "fs_lav2_lanes": [_I32, _I32],
    # perturb: dc(3) orbit | state(6) | work | n_work max_ref max_iter
    # chunk flags | stream
    "fs_perturb_f32": [_P] * 11 + [_I32, _I64, _I64, _I64, _I32, _P],
    "fs_perturb_f64": [_P] * 11 + [_I32, _I64, _I64, _I64, _I32, _P],
    # rc_tail: dc(3) anchor index, values | state(8) | work counter |
    # scalars | stream
    "fs_rc_tail": [_P] * 15 + [_I32, _I64, _I64, _F32, _F32, _F32, _F32,
                               _F32, _F32, _I64, _I64, _I32, _P],
    # ntt_orbit: x y coef work tables | D log2n | stream
    "fs_ntt_orbit": [_P] * 5 + [_I32, _I32, _P],
    # orbit_tail: coef row_in row_out cx cy | scx scy | nx ny scratch |
    # D log2n | stream
    "fs_orbit_tail": [_P] * 5 + [_I32, _I32] + [_P] * 3 + [_I32, _I32, _P],
    # orbit_chunk: x y rows cx cy | scx scy | coef work tables |
    # D log2n steps | stream
    "fs_orbit_chunk": [_P] * 5 + [_I32, _I32] + [_P] * 3
    + [_I32, _I32, _I32, _P],
    # ntt_nr: x y dx dy signs coef work tables | D log2n | stream
    "fs_ntt_nr": [_P] * 8 + [_I32, _I32, _P],
    # nr_tail: coef signs cx cy | scx scy | nx ny ndx ndy scratch |
    # D log2n | stream
    "fs_nr_tail": [_P] * 4 + [_I32, _I32] + [_P] * 5 + [_I32, _I32, _P],
    # nr_chunk: x y dx dy signs cx cy | scx scy | coef work tables |
    # D log2n steps | stream
    "fs_nr_chunk": [_P] * 7 + [_I32, _I32] + [_P] * 3
    + [_I32, _I32, _I32, _P],
    # escape_seq: out params | frames width height | list counters parity
    # | stream
    "fs_escape_seq_f32": [_P, _P, _I32, _I32, _I32, _P, _P, _I32, _P],
    "fs_escape_seq_f64": [_P, _P, _I32, _I32, _I32, _P, _P, _I32, _P],
    # la_stream: dc(3) nodes side stages at | state(8) | work | n_work
    # n_nodes stage_count | max_iter chunk_steps at_step | first | stream
    "fs_la_stream": [_P] * 16 + [_I32] * 3 + [_I64] * 3 + [_I32, _P],
    # ntt_phase: y out tw mat | rows m lanes inverse epilogue | scale words
    # | stream
    "fs_ntt_phase": [_P] * 4 + [_I32] * 5 + [_I64, _I64, _P],
    # ntt_products: v0..v3 | V din | signs plan out work tables | log2n
    # whole | stream
    "fs_ntt_products": [_P] * 4 + [_I32, _I32] + [_P] * 5
    + [_I32, _I32, _P],
    # fused_tail: inv cadd rnd cfg zsign dig sgn shw state | K log2n L F D
    # | stream
    "fs_fused_tail": [_P] * 9 + [_I32] * 5 + [_P],
    "fs_fused_tail_state_bytes": [],
    # ntt_products_threads: V log2n (K9's block size)
    "fs_ntt_products_threads": [_I32, _I32],
    # iterate_full: x y | din | cadd rnd cfg zsign dig sgn shw scratch
    # tables state | log2n F D | stream
    "fs_iterate_full": [_P, _P, _I32] + [_P] * 10 + [_I32] * 3 + [_P],
    # orbit_chunk_fused: x y rows cadd rnd | scx scy | dig inv work tables
    # | D log2n steps route | tail state | stream
    "fs_orbit_chunk_fused": [_P] * 5 + [_I32, _I32] + [_P] * 4
    + [_I32] * 4 + [_P, _P],
    # nr_chunk_fused: x y dx dy signs cadd rnd | scx scy | dig inv work
    # tables | D log2n steps route | tail state | stream
    "fs_nr_chunk_fused": [_P] * 7 + [_I32, _I32] + [_P] * 4
    + [_I32] * 4 + [_P, _P],
    # orbit_chunk_k12: x y rows cx cy | scx scy | work coef scratch tables
    # | D log2n steps grid | stream
    "fs_orbit_chunk_k12": [_P] * 5 + [_I32, _I32] + [_P] * 4
    + [_I32] * 4 + [_P],
    # nr_chunk_k12: x y dx dy signs cx cy | scx scy | work coef scratch
    # tables | D log2n steps grid | stream
    "fs_nr_chunk_k12": [_P] * 7 + [_I32, _I32] + [_P] * 4
    + [_I32] * 4 + [_P],
    # k12_block_bytes: log2n D V
    "fs_k12_block_bytes": [_I32] * 3,
    # escape_hdr: out | width height | (mantissa, exponent) of min_x max_y
    # dx dy | max_iter cap | list counters parity | stream
    "fs_escape_hdr_f32": [_P, _I32, _I32] + [_F32, _I32] * 4
    + [_I32, _I32, _P, _P, _I32, _P],
    "fs_escape_hdr_f64": [_P, _I32, _I32] + [_F64, _I32] * 4
    + [_I32, _I32, _P, _P, _I32, _P],
    # escape_df: out | width height | (hi, lo) of min_x max_y dx dy |
    # max_iter cap | list counters parity | stream
    "fs_escape_df_f32": [_P, _I32, _I32] + [_F32] * 8
    + [_I32, _I32, _P, _P, _I32, _P],
    "fs_escape_df_f64": [_P, _I32, _I32] + [_F64] * 8
    + [_I32, _I32, _P, _P, _I32, _P],
    # bla: dc(3) orbit probe steps levels | state(6) | work tally | n_work
    # max_ref max_iter | chunk | num_levels lm2 init | stream
    "fs_bla_f32": [_P] * 15 + [_I32] * 3 + [_I64] + [_I32] * 3 + [_P],
    "fs_bla_f64": [_P] * 15 + [_I32] * 3 + [_I64] + [_I32] * 3 + [_P],
    # perturb_scaled: dcr dci orbit | state(6) | work bad glitch | n_work
    # max_ref max_iter chunk flags | stream
    "fs_perturb_scaled": [_P] * 12 + [_I32, _I64, _I64, _I64, _I32, _P],
    # perturb_hdr_df: dc(5) orbit | state(8) | work | n_work max_ref
    # max_iter chunk init | stream
    "fs_perturb_hdr_df": [_P] * 15 + [_I32, _I64, _I64, _I64, _I32, _P],
    # escape_qd / escape_qf: out | width height | min_x max_y dx dy, four
    # components each | max_iter cap | list counters parity | stream
    "fs_escape_qd_f32": [_P, _I32, _I32] + [_F32] * 16
    + [_I32, _I32, _P, _P, _I32, _P],
    "fs_escape_qd_f64": [_P, _I32, _I32] + [_F64] * 16
    + [_I32, _I32, _P, _P, _I32, _P],
    "fs_escape_qf_f32": [_P, _I32, _I32] + [_F32] * 16
    + [_I32, _I32, _P, _P, _I32, _P],
    "fs_escape_qf_f64": [_P, _I32, _I32] + [_F64] * 16
    + [_I32, _I32, _P, _P, _I32, _P],
}


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libfs_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu unless the hashed library exists; return it.
    One nvcc per source, all started together, then one link."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    jobs = []
    for src in sorted(SRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors, logs = [], []
    for obj, proc in jobs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            errors.append(err[-4000:])
    try:
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *(str(o) for o, _ in jobs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stderr[-4000:])
    finally:
        for obj, _ in jobs:
            obj.unlink(missing_ok=True)
    if verbose:
        print("".join(logs))
    os.replace(tmp, so)
    return so


def lib():
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.fs_error_string.argtypes = [ctypes.c_int]
            handle.fs_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def resolve_device(device):
    """``device`` as a torch device; CUDA must really be there."""
    import torch
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available (pass --device cpu to run the plain "
                           "PyTorch versions)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().fs_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


_COUNTERS: dict = {}


def queue_counter(device):
    """Eight bytes of device scratch for a launch's work counter (K2 and
    K3 count their queue's pixels in its first four); the C entry zeroes
    it on the stream before the launch."""
    import torch
    key = str(device)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int64, device=device)
    return _COUNTERS[key]


class PassList:
    """K1's and K1-seq's pass-2 list on one device, cached and grown when
    a call needs more: ``items`` (int32, one a listed pixel) and two
    uint32 counters, which the calls take in turn (``take``): the one a
    call counts in is zero on entry, and its pass 1 zeroes the other."""

    def __init__(self, device):
        import torch
        self.items = torch.empty(0, dtype=torch.int32, device=device)
        self.counters = torch.zeros(2, dtype=torch.int32, device=device)
        self.parity = 0

    def take(self, pixels: int):
        """(items, counters, parity) for a call of `pixels` pixels."""
        import torch
        if self.items.numel() < pixels:
            self.items = torch.empty(pixels, dtype=torch.int32,
                                     device=self.counters.device)
        self.parity ^= 1
        return self.items, self.counters, self.parity

    def reset(self) -> None:
        """Both counters to zero (after a refused call)."""
        self.counters.zero_()


_PASS_LISTS: dict = {}


def pass_list(device) -> PassList:
    key = str(device)
    if key not in _PASS_LISTS:
        _PASS_LISTS[key] = PassList(device)
    return _PASS_LISTS[key]


_TAIL_STATES: dict = {}


def tail_state(device):
    """K10's and K11's device scratch on `device`
    (``fs_fused_tail_state_bytes``), zero between calls: their launches
    leave it as they found it."""
    import torch
    key = str(device)
    if key not in _TAIL_STATES:
        words = -(-lib().fs_fused_tail_state_bytes() // 4)
        _TAIL_STATES[key] = torch.zeros(words, dtype=torch.int32,
                                        device=device)
    return _TAIL_STATES[key]


_SCRATCH: dict = {}


def scratch(device, words: int):
    """At least `words` int32 words of device scratch on `device`, cached
    and grown when a call needs more: K9's work and K11's, which only the
    launch that takes them reads and writes, in stream order (a later
    launch on the stream may take the same words)."""
    import torch
    key = str(device)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.empty(words, dtype=torch.int32, device=device)
        _SCRATCH[key] = buf
    return buf[:words]


def stream(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream

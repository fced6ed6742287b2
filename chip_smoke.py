#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fractalshark_tpu_torch) on one
NVIDIA card: builds the CUDA kernels from the checkout, holds each one
against its plain PyTorch version on the card, then renders through the
port's CLI entry point and checks the frames against values of the JAX
reference.

    python3 chip_smoke.py

Phases: (1) card, (2) build, (3) K1 and K2 vs plain on the card at the
main path's shapes, bit-identical (K1 f32 and f64 at View 0 1024², one C
entry call a frame whose trace, taken in a child process, is its two
passes and no host sync; K2 in chunks over the live pixels),
then the tails through tools/time_pixel_loops.py, each vs its twin at a
cut budget in chunks over the live pixels and timed at its full budget:
the two-phase tail (K6 resumed from K2's handoff) on View #6 256², K3
over View #6's compressed orbit from K2's handoff at 64² and from the
zero state at 16² (pinned to the frame K3 gave before its redesign),
beside K3's serial floor, (3b)
K2 with f64 mantissas and the K6 instances vs plain, bit-identical, in
chunks over the live pixels, on the main path's frames (View #5 1024²,
View #3 LAO 64², View #6 PO 16² and 256², View #2 64² and 256², the 1e8
frame 64²; K2 f32 at 1024² with its phases apart), each timed with all
its launches at its full budget (tools/time_pixel_loops.py) and pinned
(View #5 1024² and View #6 PO 256² to the frames of the kernels before
their redesign), beside K6's serial floor (one pixel over a one-row
orbit), (4) K4/K5 (one device-orbit step) vs
plain at 32, 2,048, 16,384 and 32,768 limbs from the View #30 centre,
digit for digit, (5) the device orbit: View #30 at 16,384 limbs against
the exact Python-int recurrence after 256 steps (the NR chunk too), then,
with the launch counts from 0, bounded sessions (K12) and their time per
iteration at 16,384, 2,048 and 32 limbs and the device's busy share over
a 32-limb session, then, counts from 0, a session at 32,768 limbs, past
K12's D < 2^16, on the per-step loop of K4 then K5 against the
16,384-limb orbit, (6) the paths through
``fractalshark_tpu_torch.cli.main``, each with the launch counts set to 0
just before it and read just after: View 0 AUTO at 1024² (K1), a
small-table deep frame (K2 full mode), View #6 AUTO at 64² and 256² (K2
phase 1 + the tail, K6 resumed: no anchor table), View #6 with
``--perturbation-alg GPU`` at 64² and 256² (K12's block form for the
orbit, then K2 phase 1 + the tail), View #30 with
the device orbit at 512² (K12's grid form), View #5 AUTO at 64², 256²
and 1024² (``Gpu1x64PerturbedLAv2``: K2-f64), View #3 LAO (K2-f64
``la_only``), View #2 AUTO at 64² and 256² and its HDRx64 name (no valid
LA table: K6 f64 float and HDR-f64), and the perturbation-only names on
the 1e8 frame (K6 on B10's route, and f32 float) and on View #6 at 16²
and 256² (K6 on B11's route; 256² and View #5 1024² pinned to the
frames K6 and K2 gave before their redesign), and View #6 through the RC
names at 256² (K2 phase 1 + K3) and 16² (``...RCLAv2PO``: K3 from the
zero state), pinned to the frames K3 gave before its redesign, (7)
K4-NR/K5-NR (one NR step: z and dz/dc) vs plain and vs the exact step at 8, 16, 2,048 and 16,384 limbs
from random states whose dz/dc wraps, (8) the feature finder: NR chunks
of 256 steps vs the exact wrapped Python-int recurrence at 16 and 2,048
limbs (16,384 in phase 5, beside the orbit's), then, with the launch
counts set to 0 just before and read just after, the device evaluator
(c = (−0.15, 0.4) against the host evaluator; View #6's centre at full
width against the wrapped recurrence and the host evaluator) and device
refinement to the period-858 and period-3 nuclei (K12's block form),
then, counts from 0, the evaluator at View #30's centre and precision
(K12's grid form) against the wrapped recurrence, then
``--feature-find``/``--feature-scan`` through the CLI against the JAX
package's JSON, (9) K1-seq: the View 0 zoom sequence (8 frames, ×1.3
each, 512 iterations) at 1024² against its plain version and each frame
against K1 f32, the f64 instance, then ``escape_sequence`` at 4096²
(launch count from 0), each of its frames against K1 f32, and its
median time with its bound at that size, (10) K7: the streaming LA
phase, one launch that carries each pixel through the AT skip and every
stage, against its plain version in every state array on the 1e8 frame
at 64² (in launches of 0, 1, 7 and 1,000 steps over the live pixels)
and on View #6 at 256², its handoff there against K2's ``la_only``
state, its time at 256² (CUDA events and a profiler trace) with its
bound, and View #6 256² through the CLI with
``FRACTALSHARK_LA_PHASE=stream`` (launch counts from 0) against the
two-phase frame's iter_sum and CRC (K7 then K6's tail) in one K7
launch, (11) K8: every phase of the four-step at n = 8,192, 65,536 and
131,072 with 4, 6, 8 and 14 rows, forward and inverse, against its
plain version, and a transform's two launches (the twiddle matrix and
transpose in the first's epilogue, the scale in the inverse's second)
against their twins, then, from a profiler trace, no CUDA kernel between
the two, the transforms' times with their bounds, then the generic
multiplies (``multiply_3way`` with the launch count from 0,
``multiply_nr``) at 2,048 and 16,384 limbs against Python ints and the
debug checksum tool against its host mirror, (12) K9-K11 and the
flag-off routes (K10 under both flags at every size with K = 2 and 4,
and with zsign against its tiled twin; each call's trace, taken in a
child process, two launches and no host sync), (13) K12: every form that takes each size against the
plain chunk and, bit for bit, against the per-step loop of K4 then K5
(and K4-NR then K5-NR), timed in turns with it, then 2,048 steps of the
orbit and of NR in 256-step chunks, the row carried between them, in
both.  The kernels line takes K12's launches from the View #6 and View
#30 device-orbit frames and the feature evaluator's two runs, K4/K5's
from the 32,768-limb session; K4-NR/K5-NR are on no path (0), (14) the
render families: K13 (``csrc/escape_hdr.cu``, f32 and f64 mantissas) and
K14 (``csrc/escape_df.cu``, 2x32 and 2x64) on the integration sweep's
shallow frame at 1024² × 256, K15 (``csrc/bla.cu``, f32 and f64) and
K6's glitch instance (counts and flags) on the 1e8 frame at 1024² ×
1,500, each against its twin (K15 and the glitch instance in launches
over the live pixels) and timed (tools/time_pixel_loops.py), K13 at View
#6's and View #8's centres (2^453, 2^2220) at 256², K15 on View #6 at
256² (held at a cut budget, timed at the preset's), the Scaled repair
pass (K6 HDR-f64) on a poisoned orbit, then the nine frames of
``FAMILY_PINS`` through the CLI at 256² (counts from 0, the plain twins
made to raise), pinned to the JAX package's values; their launches are
the kernels line's, (15) the last render families: K16
(``csrc/perturb_hdr_df.cu``, HDR double-float perturbation) against its
twin in launches over the live pixels on the 1e8 frame at 64² × 1,500,
then timed on View #9 at 1024² × 40,000 (its step count, the deepest
pixel's steps and the bound from them); K17 and K18
(``csrc/escape_quad.cu``: QD and QF escapes, 4x32 and 4x64) against
their twins at 256² on the 1e17 frame (budget cut) and on a 1e18 frame
by -2 whose low f32 components are subnormal, then timed at 1024² × 600
on the 1e17 frame; then ``escape_qf`` (K18's public entry) and the
``LATE_PINS`` frames through the CLI at 256² (counts from 0, the twins
made to raise), pinned to the JAX package's values; their launches are
the kernels line's.
Exits non-zero if any
phase fails, and at once when no CUDA device is present.  The next-to-last lines are the card's
``nvidia-smi`` name and power limit and a JSON object of the kernels;
the last line is ``{"ok": true, ...}``.

Expected frame values are those of the JAX package on the CPU with FMA
contraction off (``XLA_FLAGS=--xla_cpu_max_isa=AVX``), taken through its
CLI with the same algorithm name (``Gpu1x64PerturbedLAv2`` where the
card's AUTO picks it): the port's kernels round every * and + on their
own (``nvcc -fmad=false``), while XLA:CPU's default contracts a*b+c.
With ``--perturbation-alg GPU`` the JAX package gives the same two View
#6 frames as with its native orbit.

Bounds (``bound_ms``): the larger of the bytes a kernel must move (each
input read once, each output written once) over 3.35 TB/s and the
operations its function needs on this run's inputs over the card's
instruction rate for their type outside the tensor cores: 33.5e12 f32,
16.7e12 f64 and 16.7e12 int32 a second (132 SMs × 128, 64 and 64 lanes
× 1.98 GHz, Hopper white paper; with ``-fmad=false`` every counted * and
+ is one instruction, so the data sheet's 67 and 34 TFLOP/s, which count
an FMA as two, do not apply).  Where the count depends on the data, it
is a lower bound of what these inputs need, as each ``*_ops`` function
says.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time

# View #6 (zoom 2^452, 4,718,592-iteration budget): iter_sum and CRC-32
# of the grid as <u4, JAX package on the CPU with FMA off; the same with
# its native orbit and with its device orbit (--perturbation-alg GPU)
VIEW6_64 = (3_268_937_305, 2_518_423_760)
VIEW6_256 = (52_302_966_139, 1_647_051_423)
VIEW6_GPU_ORBIT = {64: VIEW6_64, 256: VIEW6_256}
VIEW6_PERIOD = 457_977
# the f64 band and the perturbation-only routes, (iter_sum, CRC-32),
# JAX package on the CPU with FMA off, same algorithm name
VIEW5_F64 = {64: (368_487_031, 1_798_867_883),
             256: (5_811_856_715, 3_730_178_401)}
VIEW2_F64 = {64: (239_779, 2_524_369_276), 256: (3_835_560, 1_365_795_567)}
VIEW2_HDR64_64 = (239_779, 2_524_369_276)
VIEW3_LAO64_64 = (58_903_876, 1_899_311_131)
SMALL_DEEP_PO_64 = (5_005_495, 1_005_249_289)   # HDR-f32 and f32 float
VIEW6_PO_16 = (231_680_604, 3_835_526_492)
# View #6 PO and View #5 AUTO at the sizes users render, (iter_sum,
# CRC-32): the CLI on an NVIDIA H100 with K6 and K2 as they were before
# their redesign (one lane per pixel, the orbit row gathered when a step
# starts; tools/time_pixel_loops.py --cli); the redesign gives the same
# bits
VIEW6_PO_256 = (56_290_173_760, 4_071_284_753)
VIEW5_1024 = (93_151_215_571, 721_975_011)
# View #6 through the RC names (K3 over the compressed orbit, error_exp
# 20), (iter_sum, CRC-32): the CLI on an NVIDIA H100 with K3 as it was
# before its redesign; the redesign gives the same bits
VIEW6_RC_256 = (52_302_961_633, 3_147_924_880)
VIEW6_RC_PO_16 = (231_681_032, 2_118_348_537)
# the budgets at which phases 3/3b hold K2, K2-f64, K3 and K6 against
# their plain twins (lockstep loops, a few ms a step on the card): a few
# seconds a twin; each kernel is also timed at its main budget.  K2 and
# K6 run them in chunks of these steps, each launch over the pixels the
# last one left live
TWIN_BUDGET = 256
PO_TWIN_BUDGET = 500
TWIN_CHUNK = 65
PO_TWIN_CHUNK = 126
# the feature finder, JAX package on the CPU: the CLI's JSON lines for
# --feature-scan 3x3 on tests/test_cli.py:80-90's input (each Phase-A
# mode) and for --feature-find on the 1e8 frame with
# --feature-max-period 3000; the device refinement of period 858 from
# that frame's centre (40-digit centre, NR steps)
_SCAN_3 = ('{"found": 1, "features": [{"center_x": '
           '"-1.754877666246692760049508896358528691895e+00", "center_y": '
           '"0", "period": 3, "size_exp2": -4, "residual_exp2": -195, '
           '"nr_iterations": 3}]}')
FEATURE_SCAN = {"direct": _SCAN_3, "pt": _SCAN_3, "la": _SCAN_3}
SCAN_ARGS = ["--center-x", "-1.75487766624669276", "--center-y", "0",
             "--zoom", "100000", "--feature-scan", "3x3",
             "--feature-max-period", "64", "--width", "32", "--height", "32"]
FEATURE_FIND_1E8 = (
    '{"center_x": "-7.436439788719175333769749883804773785841e-01", '
    '"center_y": "1.318259410297359947061587497198248392972e-01", '
    '"period": 858, "size_exp2": -31, "residual_exp2": -192, '
    '"nr_iterations": 22}')
REFINE_858 = (("-7.436439788719175333769749883804773785841e-01",
               "1.318259410297359947061587497198248392972e-01"), 22)
PERIOD3_RE = -1.754877666246692760049520
NR_LIMBS = (8, 16, 2048, 16384)
NR_CHUNK_LIMBS = (16, 2048)     # 16,384 runs in phase 5
# the same frames with XLA:CPU's default FMA contraction, and the TPU
# v5e's bench record (BENCH_r05.json deep_iter_sum): printed, not targets
VIEW6_256_JAX_CPU_FMA = 52_302_949_912
VIEW6_256_TPU = 52_302_966_139
# a deep view whose orbit and LA table fit the one-kernel caps
SMALL_DEEP = ("-0.743643887037158704752191506114774",
              "0.131825904205311970493132056385139", "1e8", 2000)
ORBIT_LIMBS = (32, 2048, 16384)
ORACLE_STEPS = 256
SESSION_BUDGET = 16384
# the orbit past K12's D < 2^16 (65,536 digits), where the default route
# keeps K4 then K5 per step: a session from View #30's centre
WIDE_SESSION_LIMBS = 32768
WIDE_SESSION_BUDGET = 1024
# K1-seq: the JAX bench's headline sequence (bench.py _headline): View 0,
# 8 frames each 1.3x deeper, 512 iterations, f32; compared at 1024²,
# timed at 4096²
SEQ_FRAMES, SEQ_FACTOR, SEQ_BUDGET = 8, 1.3, 512
SEQ_SMALL, SEQ_BIG = 1024, 4096
# K8: the four-step sizes (2,048, 16,384 and 32,768 limbs: the View #32
# operand) and row counts (4/6: a multiply's forward/inverse, 8/14:
# multiply_nr's)
NTT_SIZES = (8192, 65536, 131072)
NTT_ROWS = (4, 6, 8, 14)
MUL_LIMBS = (2048, 16384)
# K7's frames: View #6 at this size, with the pinned two-phase frame; the
# 1e8 frame at 64² in launches of these chunks
STREAM_SIZE, STREAM_PIN = 256, VIEW6_256
STREAM_CHUNKS = (0, 1, 7, 1000)
# K8: the transforms timed (rows, n): a multiply's forward and inverse at
# 16,384 limbs, multiply_nr's inverse at 32,768
TIMED_TRANSFORMS = ((4, 65536), (6, 65536), (14, 131072))
# phase 12: K9 at these transform sizes (the 3-way, NR, iteration and
# signed NR-iteration plans, both forms), K10 at these (orbit and NR, with
# and without shadows, both forms), K11 at these limb counts
FUSED_NFFT = (2048, 16384, 32768, 131072)
TAIL_NFFT = (2048, 65536)
FULL_LIMBS = (2048, 16384)
# the flag settings of the flagged routes and their limb counts: the
# product flags with MXU_ITER off where nfft >= 8,192 (the reference's
# precedence), each with and without BATCHED_TAIL; then MXU_ITER_FULL
FLAG_RUNS = [
    ("PALLAS_NTT", {"FP.PALLAS_NTT": True}, 512),
    ("PALLAS_NTT", {"FP.PALLAS_NTT": True, "NM.MXU_ITER": False}, 2048),
    ("PALLAS_NTT_SPLIT", {"FP.PALLAS_NTT_SPLIT": True, "NM.MXU_ITER": False},
     16384),
    ("PALLAS_NTT_SPLIT + WHOLE_ALIGNED", {
        "FP.PALLAS_NTT_SPLIT": True, "NM.MXU_ITER": False,
        "NP.WHOLE_ALIGNED": True}, 16384),
]
FLAG_RUNS = [(label + tail, dict(flags, **extra), limbs)
             for label, flags, limbs in FLAG_RUNS
             for tail, extra in (("", {}),
                                 (" + BATCHED_TAIL", {"NP.BATCHED_TAIL": True}))
             ] + [("MXU_ITER_FULL", {"NM.MXU_ITER_FULL": True}, limbs)
                  for limbs in FULL_LIMBS]
FLAG_SESSION_BUDGET = 2048
# phase 13, K12: the orbit chunk at these limb counts (View #6's centre
# below 2,048 limbs, View #30's above), the NR chunk at these (128 and 256
# limbs: the crossover of the block and grid forms); a few steps
# of every form that takes the size against the plain chunk, a chunk of
# CHUNK_STEPS against the per-step loop and timed in turns with it, and
# CHUNK_SESSION steps in both; the kernels line takes each entry's times
# at its main path's size (View #6 and its NR evaluation at 32 limbs,
# View #30 and its NR evaluation at 16,384)
CHUNK_ORBIT_LIMBS = (32, 128, 256, 512, 2048, 16384)
CHUNK_NR_LIMBS = (16, 32, 128, 256, 2048, 16384)
CHUNK_STEPS = 256
CHUNK_TWIN_STEPS = 3
CHUNK_SESSION = 2048
CHUNK_SESSION_LIMBS = (32, 2048, 16384)
CHUNK_MAIN = {"orbit_chunk_block": 32, "orbit_chunk_grid": 16384,
              "nr_chunk_block": 32, "nr_chunk_grid": 16384}
# View #30 at 512² with the device orbit (data/records.json:view30_e2e)
VIEW30_PERIOD = 669_773
VIEW30_512_ITER_SUM = 351_206_692_131
# the device-orbit frames whose runs give K12's orbit launches
VIEW6_GPU_MAIN = "View #6 --perturbation-alg GPU 256²"
VIEW30_MAIN = "View #30 --perturbation-alg GPU 512²"

# phase 14: the render families the port took last, through the CLI at
# 256², each with its kernel's launch counter and (iter_sum, CRC-32 of
# the grid as <u4), JAX package on the CPU with FMA off, same algorithm
# name: the integration sweep's shallow frame (budget 256; K13, K14) and
# the 1e8 frame (budget 1,500; K6-glitch, K15)
FAMILY_SHALLOW = ["--center-x", "-0.6", "--center-y", "0.45", "--zoom",
                  "64", "--iterations", "256"]
FAMILY_DEEP = ["--center-x", "-0.743643887037158704752191506114774",
               "--center-y", "0.131825904205311970493132056385139",
               "--zoom", "1e8", "--iterations", "1500"]
FAMILY_PINS = {
    "CpuHDR32": (FAMILY_SHALLOW, "escape_hdr32", (9_071_295, 3_836_288_825)),
    "CpuHDR64": (FAMILY_SHALLOW, "escape_hdr64", (9_075_337, 3_220_277_600)),
    "GpuHDRx32": (FAMILY_SHALLOW, "escape_hdr32",
                  (9_071_295, 3_836_288_825)),
    "Gpu2x32": (FAMILY_SHALLOW, "escape_2x32", (9_075_247, 2_706_351_084)),
    "Gpu2x64": (FAMILY_SHALLOW, "escape_2x64", (9_075_311, 3_935_581_982)),
    "Gpu1x32PerturbedScaled": (FAMILY_DEEP, "perturb_scaled",
                               (74_862_945, 2_633_024_294)),
    "Cpu64PerturbedBLA": (FAMILY_DEEP, "bla_f64", (74_821_549, 279_905_926)),
    "GpuHDRx32PerturbedBLA": (FAMILY_DEEP, "bla_f32",
                              (74_819_159, 962_749_141)),
    "GpuHDRx64PerturbedBLA": (FAMILY_DEEP, "bla_f64",
                              (74_821_549, 279_905_926)),
}

KERNEL_META = {
    "escape": ("fractalshark_tpu_torch/csrc/escape.cu",
               "fractalshark_tpu/ops/escape.py:211"),
    "lav2_full": ("fractalshark_tpu_torch/csrc/lav2.cu",
                  "fractalshark_tpu/ops/la_pallas.py:45"),
    "lav2_phase1": ("fractalshark_tpu_torch/csrc/lav2.cu",
                    "fractalshark_tpu/ops/la_kernel.py:99"),
    "rc_tail": ("fractalshark_tpu_torch/csrc/rc_tail.cu",
                "fractalshark_tpu/ops/perturb_stream.py:395"),
    # B3 over identity anchors, the two-phase tail of an uncompressed
    # orbit: K6 resumed from the handoff
    "two_phase_tail": ("fractalshark_tpu_torch/csrc/perturb.cu",
                       "fractalshark_tpu/ops/perturb_stream.py:395"),
    "ntt_orbit": ("fractalshark_tpu_torch/csrc/ntt_orbit.cu",
                  "fractalshark_tpu/ops/bignum/ntt_mxu.py:800"),
    "orbit_tail": ("fractalshark_tpu_torch/csrc/orbit_tail.cu",
                   "fractalshark_tpu/ops/bignum/ntt_pallas.py:1530"),
    # the f64 instance of B2 (_lav2_impl with sub_dtype=np.float64)
    "lav2_full_f64": ("fractalshark_tpu_torch/csrc/lav2.cu",
                      "fractalshark_tpu/ops/la_kernel.py:99"),
    "lav2_lao_f64": ("fractalshark_tpu_torch/csrc/lav2.cu",
                     "fractalshark_tpu/ops/la_kernel.py:99"),
    "perturb_pallas": ("fractalshark_tpu_torch/csrc/perturb.cu",
                       "fractalshark_tpu/ops/perturb_pallas.py:50"),
    "perturb_stream": ("fractalshark_tpu_torch/csrc/perturb.cu",
                       "fractalshark_tpu/ops/perturb_stream.py:112"),
    "perturb_hdr64": ("fractalshark_tpu_torch/csrc/perturb.cu",
                      "fractalshark_tpu/ops/perturb.py:177"),
    "perturb_f64": ("fractalshark_tpu_torch/csrc/perturb.cu",
                    "fractalshark_tpu/ops/perturb.py:112"),
    "perturb_f32": ("fractalshark_tpu_torch/csrc/perturb.cu",
                    "fractalshark_tpu/ops/perturb.py:112"),
    # K4-NR (B8b; B7 computes the same on packed pairs) and K5-NR (the NR
    # configuration of B8c's tail; B6's paired tail likewise)
    "ntt_nr": ("fractalshark_tpu_torch/csrc/ntt_orbit.cu",
               "fractalshark_tpu/ops/bignum/ntt_mxu.py:557"),
    "nr_tail": ("fractalshark_tpu_torch/csrc/orbit_tail.cu",
                "fractalshark_tpu/ops/bignum/ntt_pallas.py:1134"),
    "escape_seq": ("fractalshark_tpu_torch/csrc/escape.cu",
                   "fractalshark_tpu/ops/escape.py:220"),
    "la_stream": ("fractalshark_tpu_torch/csrc/la_stream.cu",
                  "fractalshark_tpu/ops/la_stream.py:69"),
    # B9b; K8 also replaces B9a, ntt_mxu.py:243 (the same function)
    "ntt_phase": ("fractalshark_tpu_torch/csrc/ntt_phase.cu",
                  "fractalshark_tpu/ops/bignum/ntt_pallas.py:1661"),
    # K9's whole form: B-f1 (and, under WHOLE_ALIGNED, B-f3 :764); its
    # split form: B-f2 (the trio :593/:612/:650)
    "ntt_products_whole": ("fractalshark_tpu_torch/csrc/ntt_products.cu",
                           "fractalshark_tpu/ops/bignum/ntt_pallas.py:308"),
    "ntt_products_split": ("fractalshark_tpu_torch/csrc/ntt_products.cu",
                           "fractalshark_tpu/ops/bignum/ntt_pallas.py:593"),
    # K10 gridded (B8c's form on residue rows) and batched (B-f4)
    "fused_tail_grid": ("fractalshark_tpu_torch/csrc/fused_tail.cu",
                        "fractalshark_tpu/ops/bignum/ntt_pallas.py:1134"),
    "fused_tail_batched": ("fractalshark_tpu_torch/csrc/fused_tail.cu",
                           "fractalshark_tpu/ops/bignum/ntt_pallas.py:1265"),
    "iterate_full": ("fractalshark_tpu_torch/csrc/iterate_full.cu",
                     "fractalshark_tpu/ops/bignum/ntt_mxu.py:920"),
    # K12, a chunk of steps in one launch: the block form replaces the
    # unpaired step (B8a, with B8c's tail), the grid form the paired one
    # (B5, with B6's tail); the NR instance B8b and B7 likewise
    "orbit_chunk_block": ("fractalshark_tpu_torch/csrc/orbit_chunk.cu",
                          "fractalshark_tpu/ops/bignum/ntt_mxu.py:618"),
    "orbit_chunk_grid": ("fractalshark_tpu_torch/csrc/orbit_chunk.cu",
                         "fractalshark_tpu/ops/bignum/ntt_mxu.py:800"),
    "nr_chunk_block": ("fractalshark_tpu_torch/csrc/orbit_chunk.cu",
                       "fractalshark_tpu/ops/bignum/ntt_mxu.py:557"),
    "nr_chunk_grid": ("fractalshark_tpu_torch/csrc/orbit_chunk.cu",
                      "fractalshark_tpu/ops/bignum/ntt_mxu.py:812"),
    # the render families (phase 14): XLA loops in the reference, each
    # given a kernel here (K13, K14, K15, K6's glitch instance)
    "escape_hdr32": ("fractalshark_tpu_torch/csrc/escape_hdr.cu",
                     "fractalshark_tpu/ops/hdr_escape.py:93"),
    "escape_hdr64": ("fractalshark_tpu_torch/csrc/escape_hdr.cu",
                     "fractalshark_tpu/ops/hdr_escape.py:93"),
    "escape_2x32": ("fractalshark_tpu_torch/csrc/escape_df.cu",
                    "fractalshark_tpu/ops/dblflt.py:143"),
    "escape_2x64": ("fractalshark_tpu_torch/csrc/escape_df.cu",
                    "fractalshark_tpu/ops/dblflt.py:143"),
    "bla_f32": ("fractalshark_tpu_torch/csrc/bla.cu",
                "fractalshark_tpu/ops/bla_kernel.py:29"),
    "bla_f64": ("fractalshark_tpu_torch/csrc/bla.cu",
                "fractalshark_tpu/ops/bla_kernel.py:29"),
    "perturb_scaled": ("fractalshark_tpu_torch/csrc/perturb.cu",
                       "fractalshark_tpu/ops/scaled.py:47"),
    # the last render families (phase 15): K16, K17 (QD) and K18 (QF)
    "perturb_hdr_df": ("fractalshark_tpu_torch/csrc/perturb_hdr_df.cu",
                       "fractalshark_tpu/ops/hdr_df.py:170"),
    "escape_4x32": ("fractalshark_tpu_torch/csrc/escape_quad.cu",
                    "fractalshark_tpu/ops/quadd.py:152"),
    "escape_4x64": ("fractalshark_tpu_torch/csrc/escape_quad.cu",
                    "fractalshark_tpu/ops/quadd.py:152"),
    "escape_qf32": ("fractalshark_tpu_torch/csrc/escape_quad.cu",
                    "fractalshark_tpu/ops/quadflt.py:140"),
    "escape_qf64": ("fractalshark_tpu_torch/csrc/escape_quad.cu",
                    "fractalshark_tpu/ops/quadflt.py:140"),
}

# phase 14's kernel frames (tools/time_pixel_loops.py FRAMES) and the
# kernels-line entry each gives: held to its twin at its full budget
# (K15 and the glitch instance in launches of FAMILY_CHUNK steps over the
# live pixels), then timed; K13 at View #6's and View #8's centres at
# 256² (each past its mantissa type's exponent range) at these budgets;
# K15 on View #6 at 256² held at VIEW6_BLA_TWIN_BUDGET, timed at the
# preset's; the Scaled repair pass on the poisoned orbit of
# tests/test_scaled.py:52-73 (entry 5 made f32-subnormal), at this size
# and budget
FAMILY_FRAMES = [
    ("shallow_hdr32_1024", "escape_hdr32"),
    ("shallow_hdr64_1024", "escape_hdr64"),
    ("shallow_2x32_1024", "escape_2x32"),
    ("shallow_2x64_1024", "escape_2x64"),
    ("1e8_bla_f32_1024", "bla_f32"),
    ("1e8_bla_f64_1024", "bla_f64"),
    ("1e8_scaled_1024", "perturb_scaled"),
]
FAMILY_CHUNK = 257
DEEP_HDR = {6: ("f32", 2000), 8: ("f64", 2000)}

# phase 15: the quad-float escapes' frames, the 1e17 frame of
# tests/test_quadflt.py (every pixel runs the budget) and a 1e18 frame on
# the antenna by -2 (counts 4-40; the 4x32 splits of dx and dy have
# subnormal low components, which decide counts)
QUAD_1E17 = ["--center-x", "-0.743643887037151", "--center-y",
             "0.131825904205330", "--zoom", "1e17", "--iterations", "600"]
QUAD_ANTENNA = ["--center-x", "-1.9999999999999999995", "--center-y",
                "0.0000000000000000003", "--zoom", "1e18", "--iterations",
                "200"]
# label: (argv, algorithm, launch-counter key, (iter_sum, CRC-32 of the
# grid as <u4)) at 256², JAX package on the CPU with FMA off
LATE_PINS = {
    "Gpu4x32 shallow": (FAMILY_SHALLOW, "Gpu4x32", "escape_4x32",
                        (9_075_311, 3_935_581_982)),
    "Gpu4x64 shallow": (FAMILY_SHALLOW, "Gpu4x64", "escape_4x64",
                        (9_075_311, 3_935_581_982)),
    "Gpu4x32 1e17": (QUAD_1E17, "Gpu4x32", "escape_4x32",
                     (39_321_600, 3_590_186_626)),
    "Gpu4x64 1e17": (QUAD_1E17, "Gpu4x64", "escape_4x64",
                     (39_321_600, 3_590_186_626)),
    "Gpu4x32 antenna": (QUAD_ANTENNA, "Gpu4x32", "escape_4x32",
                        (1_768_497, 3_998_572_575)),
    "Gpu2x32PerturbedLAv2PO 1e8": (FAMILY_DEEP, "Gpu2x32PerturbedLAv2PO",
                                   "perturb_hdr_df",
                                   (74_863_500, 1_390_317_758)),
    "GpuHDRx2x32PerturbedLAv2PO 1e8": (
        FAMILY_DEEP, "GpuHDRx2x32PerturbedLAv2PO", "perturb_hdr_df",
        (74_863_500, 1_390_317_758)),
    # no valid LA table on View #2: the LAv2 name takes K16
    "Gpu2x32PerturbedLAv2 View #2": (["--view", "2"], "Gpu2x32PerturbedLAv2",
                                     "perturb_hdr_df",
                                     (3_835_560, 1_365_795_567)),
}
# K16 against its twin on this frame (tools/time_pixel_loops.py), timed on
# the other; K17 and K18 against their twins at 256² on the 1e17 frame at
# this budget (every pixel runs it: the twin's depth is the cut) and on
# the antenna frame at its own, then timed at 1024²
HDR_DF_TWIN_FRAME = "1e8_hdr_df_64"
HDR_DF_FRAME = "view9_hdr_df_1024"
QUAD_FRAMES = [("1e17_qd32_1024", "escape_4x32"),
               ("1e17_qd64_1024", "escape_4x64"),
               ("1e17_qf32_1024", "escape_qf32"),
               ("1e17_qf64_1024", "escape_qf64")]
QUAD_TWIN_SIZE = 256
QUAD_TWIN_BUDGET = 40
VIEW6_BLA_TWIN_BUDGET = 2000
POISON = ("-0.6", "0.4", "4", 200, 256)

HBM_BYTES_PER_S = 3.35e12
# instructions a second outside the tensor cores, H100 SXM (132 SMs at
# the 1.98 GHz boost clock; per SM and clock 128 FP32, 64 FP64 and 64
# INT32 lanes, Hopper white paper).  The kernels are built with
# -fmad=false, so each counted * or + is one instruction: the data
# sheet's 67 (f32) and 34 (f64) TFLOP/s count an FMA as two operations.
SM_CLOCKS_PER_S = 132 * 1.98e9
F32_OPS_PER_S = 128 * SM_CLOCKS_PER_S
F64_OPS_PER_S = 64 * SM_CLOCKS_PER_S
I32_OPS_PER_S = 64 * SM_CLOCKS_PER_S


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, device, reps: int = 1, warm: bool = True):
    """(result, ms per call) with CUDA events, after one warm-up call
    unless `warm` is False (the plain twins: nothing to warm, and a
    second run of them costs seconds)."""
    import torch
    out = fn() if warm else None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(end) / reps


def compare(name, kern, plain, results):
    import torch
    a, b = kern.cpu(), plain.cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{name}: {a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    diff = (a.to(torch.float64) - b.to(torch.float64)).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    bad = int((a != b).sum())
    log(f"  {name}: {bad} of {a.numel()} differ, max_abs_err {err}")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version at {bad} elements")
    results["max_abs_err"] = max(results.get("max_abs_err", 0.0), err)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, ops: float, rate: float) -> dict:
    """bound_ms / bound_by from the bytes moved and operations needed."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    out = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"    bound {out['bound_ms']:.6f} ms by {out['bound_by']} "
        f"({n_bytes} bytes, {ops:.4g} ops)")
    return out


# ---------------------------------------------------------------- phases


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    log(f"[1] card: {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    return card


def phase_build():
    from fractalshark_tpu_torch import kernels
    t0 = time.perf_counter()
    so = kernels.build(verbose=True)
    kernels.lib()
    log(f"[2] build: {so.name} in {time.perf_counter() - t0:.2f} s")


def deep_inputs(view_or_center, size, device):
    """Host tables and f32 dc grid of a deep frame, via the engine."""
    from fractalshark_tpu_torch.engine.renderers import get_orbit_calc
    from fractalshark_tpu_torch.ops import la_kernel
    from fractalshark_tpu_torch.ops.perturb import _dc_grids_hdr, delta_params

    f, res, la = frame_inputs(view_or_center, size, device)
    T, orbit = la_kernel.device_tables(res, la, f.device)
    dx, dy, cxo, cyo = delta_params(f.ptz, res.center_x, res.center_y,
                                    size, size)
    dc = _dc_grids_hdr(dx, dy, cxo, cyo, size, size, f.device)
    return (f, res, la, T, orbit, dc,
            get_orbit_calc(f).last_details.get("backend"))


def frame_inputs(view_or_center, size, device):
    """Host orbit and LA table of a frame (a preset index or a
    (x, y, zoom, budget) tuple), via the engine."""
    from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
    from fractalshark_tpu_torch.engine.fractal import Fractal
    from fractalshark_tpu_torch.engine.la_reference import get_or_build_la
    from fractalshark_tpu_torch.engine.renderers import get_orbit_calc

    if isinstance(view_or_center, int):
        f = Fractal(width=size, height=size, view=view_or_center,
                    device=device)
    else:
        x, y, zoom, n = view_or_center
        f = Fractal(width=size, height=size, num_iterations=n,
                    view=PointZoomBBConverter(pt_x=x, pt_y=y,
                                              zoom_factor=zoom, prec=512),
                    device=device)
    res = get_orbit_calc(f).get_and_create_useful_results(f.ptz,
                                                          f.num_iterations)
    return f, res, get_or_build_la(f, res)


def escape_ops(iters, interior=None) -> float:
    """K1 and K1-seq: 7 operations per iteration (z², |z|² and the
    update) of every pixel the interior shortcut leaves, at the budget
    too, plus 14 a pixel for its coordinate and the shortcut's test
    (`interior`: the pixels the shortcut resolves, as the kernel tests
    them; None: no shortcut, every pixel iterates)."""
    import torch
    iters = torch.as_tensor(iters)
    if interior is None:
        return 7.0 * float(iters.sum(dtype=torch.float64))
    left = torch.where(torch.as_tensor(interior).to(iters.device), 0, iters)
    return 7.0 * float(left.sum(dtype=torch.float64)) + 14.0 * iters.numel()


def lav2_ops(T, pixels: int) -> float:
    """K2: at least one LA step per stage for every pixel, each step a
    complex HDR product and add (about 40 f32 operations)."""
    return 40.0 * pixels * T.stage_count




def ntt_ops(n: int) -> float:
    """K4: 8 transforms of n/2·log2(n) butterflies at 8 integer
    operations (a Montgomery product, a modular add and a subtract), the
    pointwise products (3 Montgomery products of 6 operations per point
    and prime) and the CRT (about 12 per coefficient)."""
    lg = n.bit_length() - 1
    return 8 * (n // 2) * lg * 8 + 2 * n * 3 * 6 + 2 * n * 12


def tail_ops(n: int) -> float:
    """K5: about 8 integer operations per digit sum (the combine, the
    ripple's add, mask and shift) for both components."""
    return 2 * n * 8.0


def ntt_nr_ops(n: int) -> float:
    """K4-NR: 16 transforms of n/2·log2(n) butterflies at 8 integer
    operations, the pointwise products (10 Montgomery products of 6
    operations and 4 signed combines per point and prime) and the CRT of
    4 rows (about 12 per coefficient)."""
    lg = n.bit_length() - 1
    return 16 * (n // 2) * lg * 8 + 2 * n * (10 * 6 + 4 * 2) + 4 * n * 12


def nr_tail_ops(n: int) -> float:
    """K5-NR: K5's 8 operations per digit sum over four components."""
    return 4 * n * 8.0


def phase_kernels(device, size_escape=1024, size_deep=256,
                  size_small=64):
    """K1-K3 against their plain versions on the card."""
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.ops import escape, la_kernel
    from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex

    stats = {k: {} for k in KERNEL_META}
    log("[3] K1-K3 vs plain versions on the card")

    # K1 at View 0, the main path's 1024² (f32 = Gpu1x32, f64 = Gpu1x64):
    # one C entry call a frame (the launch count), its two passes and no
    # host sync (a profiler trace in a child process)
    ptz = get_view_preset(0).ptz.square_aspect_ratio(size_escape, size_escape)
    p = escape.PlainParams.from_view(ptz, size_escape, size_escape)
    traced = {r["frame"]: r for r in tool_records(
        "time_pixel_loops.py", "--only", "view0_1024_f32", "view0_1024_f64",
        "--trace", "--no-floor") if "frame" in r}
    for dt in ("f32", "f64"):
        tdt = torch.float32 if dt == "f32" else torch.float64
        kernels.reset_counts()
        k = escape.escape(p, size_escape, size_escape, 256, dt, device)
        calls = kernels.launches["escape"]
        _, ms = timed(lambda: escape.escape(
            p, size_escape, size_escape, 256, dt, device), device, reps=5)
        pl, pms = timed(lambda: escape.escape_plain(
            p, size_escape, size_escape, 256, tdt, device), device,
            warm=False)
        compare(f"K1 escape {dt} View 0 {size_escape}² x256", k, pl,
                stats["escape"])
        tr = traced[f"view0_{size_escape}_{dt}"]
        log(f"    kernel {ms:.4f} ms a call, plain {pms:.3f} ms; {calls} "
            f"K1 call; the tool's run: {tr['ms_median']:.4f} ms, device "
            f"{tr['trace']['device_ms']:.4f} ms in "
            f"{tr['trace']['kernel_ms']}, {tr['trace']['syncs']} host syncs")
        if calls != 1 or tr["launches"] != {"escape": 1} or \
                tr["trace"]["syncs"] or tr["iter_sum"] != int(pl.sum()) or \
                set(tr["trace"]["kernel_names"]) != {"escape_pass1",
                                                     "escape_pass2"}:
            raise AssertionError(f"K1 {dt}: not one call of two passes "
                                 f"without a sync: {calls}, {tr}")
        # the f32 frame is the tile (interior shortcut), f64 escape_jax's
        # loop (none)
        inside = escape.interior_mask(p, size_escape, size_escape, tdt,
                                      device) if dt == "f32" else None
        b = bound(nbytes(k), escape_ops(k, inside),
                  F32_OPS_PER_S if dt == "f32" else F64_OPS_PER_S)
        if dt == "f32":
            stats["escape"].update(ms=ms, plain_ms=pms, **b)

    def k2(T, orbit, dc, n, max_ref, la_only):
        """K2 at budget n, timed; K2 and its plain twin at the twin budget
        (both from the zero state), for the comparison."""
        flat = HDRComplex(*(t.reshape(-1) for t in dc))
        nc = min(n, TWIN_BUDGET)
        ks, ms = timed(lambda: la_kernel.lav2_run(
            T, orbit, dc, n, max_ref, la_only), device, reps=3)
        kc = la_kernel.lav2_run(T, orbit, dc, nc, max_ref, la_only,
                                chunk_steps=TWIN_CHUNK)
        ps_, pms = timed(lambda: la_kernel.lav2_plain(
            T, orbit, flat, la_kernel.init_state_plain(T, flat, nc), nc,
            max_ref, la_only), device, warm=False)
        return ks, kc, [t.reshape(dc.re.shape) for t in ps_], ms, pms, nc

    def k2_both(label, T, orbit, dc, n, max_ref, modes):
        """K2 against its plain twin, every state array; the last mode's
        states (main budget, twin budget), times and bound."""
        for la_only in modes:
            key = "lav2_phase1" if la_only else "lav2_full"
            ks, kc, pls, ms, pms, nc = k2(T, orbit, dc, n, max_ref, la_only)
            for i, name in enumerate(la_kernel._STATE):
                compare(f"K2 {key} {label} budget {nc} {name}", kc[i], pls[i],
                        stats[key])
            log(f"    kernel {ms:.3f} ms (budget {n}), plain {pms:.3f} ms "
                f"(budget {nc})")
        b = bound(nbytes(T.nodes, T.side, T.stages, orbit, *dc, *ks),
                  lav2_ops(T, dc.re.numel()), F32_OPS_PER_S)
        return ks, kc, dict(ms=ms, plain_ms=pms, **b)

    # K2 in both modes on the small-table deep frame (full mode is its
    # main-path route) and on View #6, at the small size
    f, res, la, T, orbit, dc, backend = deep_inputs(SMALL_DEEP, size_small,
                                                    device)
    _, _, st = k2_both(f"1e8 {size_small}²", T, orbit, dc, SMALL_DEEP[3],
                       res.max_ref_iteration(), (True, False))
    stats["lav2_full"].update(st)
    f, res, la, T, orbit, dc, backend = deep_inputs(6, size_small, device)
    k2_both(f"View #6 {size_small}²", T, orbit, dc, f.num_iterations,
            res.max_ref_iteration(), (False, True))

    # K2 phase 1 on View #6 at the main path's size
    f, res, la, T, orbit, dc, backend = deep_inputs(6, size_deep, device)
    n = f.num_iterations
    _, _, st = k2_both(f"View #6 {size_deep}²", T, orbit, dc, n,
                       res.max_ref_iteration(), (True,))
    stats["lav2_phase1"].update(st)
    tail_frames(device, stats)
    return stats, backend


def perturb_tail_ops(grid, start, budget: int) -> float:
    """The two-phase tail and K3: one HDR step per tail iteration done
    (60 operations, K6's count) plus the escaping step of each pixel that
    escapes; a lower bound for K3, whose steps between anchors also run
    the df32 recurrence."""
    import torch
    live = start < budget
    done = torch.where(live, grid - start, 0)
    return 60.0 * (float(done.sum()) + float((live & (grid < budget)).sum()))


# phase 3's tail frames (tools/time_pixel_loops.py FRAMES): each held to
# its twin at the cut budget (the first launch, then launches of the
# chunk over the live pixels) and timed with all its launches at its full
# budget; the pins; the kernels line's entry whose numbers it gives
TAIL_FRAMES = [
    ("view6_tail_256", None, "two_phase_tail"),
    ("view6_rc_64", None, None),
    ("view6_rc_po_16", VIEW6_RC_PO_16, "rc_tail"),
]


def tail_frames(device, stats):
    """The two-phase tail (K6 resumed from K2's handoff) on View #6 256²
    and K3 over View #6's compressed orbit (error_exp 8 from K2's handoff
    at 64², the CLI's error_exp 20 from the zero state at 16²): each
    against its twin at the cut budget, then timed at its full budget."""
    tpl = pixel_loops()
    floor = tpl.rc_floor(device, 1)
    for name, pin, entry in TAIL_FRAMES:
        fr = tpl.setup(name, device)
        budget = TWIN_BUDGET if fr.kern == "tail" or fr.mode[1] \
            else PO_TWIN_BUDGET
        nc = min(fr.n, budget)
        kc = fr.run(nc, TWIN_CHUNK)
        pl, pms = timed(lambda: fr.plain(nc), device, warm=False)
        compare(f"{fr.key} {name} budget {nc} (chunks of {TWIN_CHUNK} over "
                f"the live pixels) iterations", kc.reshape(-1), pl,
                stats[fr.key])
        log(f"    plain {pms:.3f} ms (budget {nc})")
        out, rec = tpl.time_frame(fr, 1 if fr.n > 10 ** 6 and fr.size < 64
                                  else 3)
        got = (rec["iter_sum"], rec["crc32"])
        steps = int((out - fr.start).max()) + 1
        log(f"  {fr.key} {name} budget {fr.n}: {rec['ms_median']:.3f} ms "
            f"(of {[round(t, 3) for t in rec['ms']]}), "
            f"{sum(rec['launches'].values())} launches over "
            f"{rec['work'][:4]}{'...' if len(rec['work']) > 4 else ''} "
            f"pixels, (iter_sum, crc32) {got} (expected {pin}); deepest "
            f"pixel {steps} tail steps, K3's one-pixel floor "
            f"{steps * floor['hit'] / 1e6:.3f} ms (anchor every step) / "
            f"{steps * floor['df32'] / 1e6:.3f} ms (df32 every step)")
        if pin is not None and got != pin:
            raise AssertionError(f"{fr.key} {name}: {got} != {pin}")
        if entry is None:
            continue
        tables = (fr.orbit,) if fr.kern == "tail" else (fr.A.index, fr.A.val)
        stats[entry].update(ms=rec["ms_median"], plain_ms=pms, **bound(
            nbytes(*tables, *fr.dc, fr.start, out),
            perturb_tail_ops(out, fr.start, fr.n), F32_OPS_PER_S))


def perturb_ops(iters, budget: int, hdr_mode: bool) -> float:
    """K6: one step per iteration done plus the escaping step of each
    pixel below the budget; an HDR step is about 60 operations (2·Z·dz +
    dz² + dc with the aligned adds, two reductions, the norms and
    compares), a float step 17."""
    steps = float(iters.sum()) + float((iters < budget).sum())
    return (60.0 if hdr_mode else 17.0) * steps


def tool_records(script: str, *args) -> list:
    """The JSON records a timing tool of this checkout prints, run in a
    child process.  Its profiler traces are taken there: in this
    process, after the earlier phases, torch.profiler recorded no CUDA
    kernel at all (H100, torch 2.11), while a fresh process records every
    one."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", script), *args],
        capture_output=True, text=True, timeout=600, cwd=root)
    if proc.returncode:
        raise AssertionError(f"{script} failed: {proc.stderr[-2000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


def pixel_loops():
    """tools/time_pixel_loops.py of this checkout: the K6 and K2 frames of
    the main path and their timing, one measurement for the smoke and the
    tool."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "time_pixel_loops.py")
    spec = importlib.util.spec_from_file_location("time_pixel_loops", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# phase 3b's frames (tools/time_pixel_loops.py FRAMES) in order: each held
# to its twin at the cut budget and timed with all its launches at its
# full budget; the pins; the kernels line's entry whose time, plain time
# and bound the frame gives (None: held and timed only)
PIXEL_FRAMES = [
    ("view3_lao_64", VIEW3_LAO64_64, "lav2_lao_f64"),
    ("view5_f64_1024", VIEW5_1024, "lav2_full_f64"),
    # K2 f32 with its phases apart (more pixels than the card's lanes)
    ("view6_phase1_1024", None, None),
    ("1e8_full_1024", None, None),
    ("1e8_pallas_64", SMALL_DEEP_PO_64, "perturb_pallas"),
    ("view6_po_16", VIEW6_PO_16, None),
    ("view6_po_256", VIEW6_PO_256, "perturb_stream"),
    ("view2_hdr64_64", VIEW2_HDR64_64, "perturb_hdr64"),
    ("view2_f64_64", VIEW2_F64[64], None),
    ("view2_f64_256", VIEW2_F64[256], "perturb_f64"),
    ("1e8_f32_64", SMALL_DEEP_PO_64, "perturb_f32"),
]


def phase_f64_perturb_kernels(device, stats):
    """K2 with f64 mantissas (View #3 and View #5 at 64², full and
    la_only) against the plain twin; then each frame of PIXEL_FRAMES (K2
    on View #3 LAO 64², View #5 1024², View #6 and the 1e8 frame at 1024²
    with the phases apart; K6 on View #6 PO 16² and 256², View #2 and the
    1e8 frame) against its twin in chunks over the live pixels, and timed
    at its full budget beside K6's serial floor."""
    import torch

    from fractalshark_tpu_torch.ops import la_kernel, perturb
    from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex

    log("[3b] K2-f64 and K6 vs plain versions on the card, each frame "
        "timed at its full budget (tools/time_pixel_loops.py)")
    tpl = pixel_loops()
    floor = tpl.serial_floor(device, 1)

    def k2_twin(fr, la_only, key):
        """K2 vs its twin at TWIN_BUDGET in chunks of TWIN_CHUNK over the
        live pixels, every state array: the twin's ms."""
        nc = min(fr.n, TWIN_BUDGET)
        flat = HDRComplex(*(t.reshape(-1) for t in fr.dc))
        kc = fr.run(nc, TWIN_CHUNK) if la_only == fr.mode else \
            la_kernel.lav2_run(fr.T, fr.orbit, fr.dc, nc, fr.mr, la_only,
                               TWIN_CHUNK)
        phases = "apart" if la_kernel.split_phases(
            flat.re.numel(), la_kernel.lanes_on(fr.T, device, fr.dtype)) \
            else "together"
        pl, pms = timed(lambda: la_kernel.lav2_plain(
            fr.T, fr.orbit, flat, la_kernel.init_state_plain(fr.T, flat, nc),
            nc, fr.mr, la_only), device, warm=False)
        for i, name in enumerate(la_kernel._STATE):
            compare(f"K2 {key} {fr.name} budget {nc} (phases {phases}, "
                    f"{la_kernel.last_run_stats['dispatches']} launches) "
                    f"{name}", kc[i].reshape(-1), pl[i], stats[key])
        log(f"    plain {pms:.3f} ms (budget {nc})")
        return pms

    def k6_twin(fr):
        """K6 vs its twin at PO_TWIN_BUDGET in chunks of PO_TWIN_CHUNK over
        the live pixels: the twin's ms."""
        nc = min(fr.n, PO_TWIN_BUDGET)
        flat = HDRComplex(*(t.reshape(-1) for t in fr.dc))
        kc = fr.run(nc, PO_TWIN_CHUNK)
        pl, pms = timed(lambda: perturb.perturb_plain(
            fr.orbit, flat, perturb.init_state_plain(flat, nc, fr.mode), nc,
            fr.mr, fr.mode), device, warm=False)
        compare(f"K6 {fr.key} {fr.name} budget {nc} "
                f"({perturb.last_run_stats['dispatches']} launches) "
                f"iterations", kc.reshape(-1), pl[4], stats[fr.key])
        log(f"    plain {pms:.3f} ms (budget {nc})")
        return pms

    for name in ("view3_lao_64", "view5_f64_64"):
        fr = tpl.setup(name, device)
        for la_only in (False, True):
            k2_twin(fr, la_only, "lav2_lao_f64" if la_only
                    else "lav2_full_f64")

    for name, pin, entry in PIXEL_FRAMES:
        fr = tpl.setup(name, device)
        pms = (k6_twin if fr.kern == "k6" else
               lambda f: k2_twin(f, f.mode, f.key))(fr)
        out, rec = tpl.time_frame(fr, 1 if fr.n > 10 ** 6 else 3)
        grid = tpl.grid_of(fr, out)
        got = (rec["iter_sum"], rec["crc32"])
        form = f"{'hdr' if fr.kern == 'k2' or fr.mode else 'float'}_" \
            f"{'f64' if fr.dtype == torch.float64 else 'f32'}"
        if fr.kern == "k6":
            # a pixel at the budget ran n steps, one that escaped its
            # count and the escaping step
            steps = int(torch.where(grid >= fr.n, grid, grid + 1).max())
            what = f"{steps} steps"
        else:
            steps = tpl.deepest_body_steps(fr)
            what = f"<= {steps} body steps"
        log(f"  {fr.key} {name} budget {fr.n}: {rec['ms_median']:.3f} ms "
            f"(of {[round(t, 3) for t in rec['ms']]}), "
            f"{sum(rec['launches'].values())} launches over "
            f"{rec['work'][:4]}{'...' if len(rec['work']) > 4 else ''} "
            f"pixels, (iter_sum, crc32) {got} (expected {pin}); deepest "
            f"pixel {what}, serial floor {steps * floor[form] / 1e6:.3f} ms")
        if pin is not None and got != pin:
            raise AssertionError(f"{fr.key} {name}: {got} != {pin}")
        if entry is None:
            continue
        rate = F64_OPS_PER_S if fr.dtype == torch.float64 else F32_OPS_PER_S
        if fr.kern == "k6":
            # a pixel reads orbit rows up to its count at most
            rows = fr.orbit[:int(grid.max()) + 1]
            b = bound(nbytes(rows, *(fr.dc if fr.mode else fr.dc[:2]), grid),
                      perturb_ops(grid, fr.n, fr.mode), rate)
        else:
            b = bound(nbytes(fr.T.nodes, fr.T.side, fr.T.stages, fr.orbit,
                             *fr.dc, *out),
                      lav2_ops(fr.T, fr.dc.re.numel()), rate)
        stats[entry].update(ms=rec["ms_median"], plain_ms=pms, **b)


def crc_pin(grid) -> tuple:
    """(iter_sum, CRC-32 of the grid as <u4)."""
    import zlib
    a = grid.cpu().numpy()
    return int(a.sum()), zlib.crc32(a.astype("<u4").tobytes())


def view30_center():
    from fractalshark_tpu_torch.core.views import get_view_preset
    ptz = get_view_preset(30).ptz
    return ptz.pt_x, ptz.pt_y, ptz.radius


def phase_orbit_kernels(device, stats, reps=20, steps=3):
    """K4 and K5 against their twins, digit for digit, for a few steps
    from the View #30 centre at each limb count and at the per-step
    route's WIDE_SESSION_LIMBS (whose times the kernels line keeps);
    times and bounds."""
    import torch

    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP

    log("[4] K4/K5 vs plain versions on the card (View #30 centre)")
    cx, cy, _ = view30_center()
    for key in ("ntt_orbit", "orbit_tail"):
        stats[key]["by_limbs"] = {}
    for limbs in ORBIT_LIMBS + (WIDE_SESSION_LIMBS,):
        spec = FP.FixedSpec.for_limbs(limbs)
        scx, cxd = FP.hp_to_digits(cx, spec)
        scy, cyd = FP.hp_to_digits(cy, spec)
        cxt = torch.from_numpy(cxd.astype("int32")).to(device)
        cyt = torch.from_numpy(cyd.astype("int32")).to(device)
        x, y = cxt.clone(), cyt.clone()
        row = torch.from_numpy(FP.shadow_row_np(scx, cxd, scy, cyd)).to(
            device)
        for step in range(steps):
            coef = FP.orbit_products(x, y, spec)
            want = FP.orbit_products_plain(x, y, spec.nfft)
            compare(f"K4 {limbs} limbs step {step}", coef, want,
                    stats["ntt_orbit"])
            got = FP.orbit_tail(coef, row, scx, cxt, scy, cyt, spec)
            plain = FP.orbit_tail_plain(want, row, scx, cxt, scy, cyt, spec)
            for name, a, b in zip(("x", "y", "row"), got, plain):
                compare(f"K5 {limbs} limbs step {step} {name}", a, b,
                        stats["orbit_tail"])
            x, y, row = got
        _, k4ms = timed(lambda: FP.orbit_products(x, y, spec), device, reps)
        _, k4pms = timed(lambda: FP.orbit_products_plain(x, y, spec.nfft),
                         device)
        _, k5ms = timed(lambda: FP.orbit_tail(coef, row, scx, cxt, scy, cyt,
                                              spec), device, reps)
        _, k5pms = timed(lambda: FP.orbit_tail_plain(
            coef, row, scx, cxt, scy, cyt, spec), device)
        log(f"    {limbs} limbs: K4 {k4ms:.4f} ms (plain {k4pms:.3f}), "
            f"K5 {k5ms:.4f} ms (plain {k5pms:.3f})")
        n, D = spec.nfft, spec.digits
        for key, ms, pms, nb, ops in (
                ("ntt_orbit", k4ms, k4pms, 2 * D * 4 + 2 * n * 8,
                 ntt_ops(n)),
                ("orbit_tail", k5ms, k5pms,
                 2 * n * 8 + 4 * D * 4 + 2 * 12 * 4, tail_ops(n))):
            st = dict(ms=ms, plain_ms=pms, **bound(nb, ops, I32_OPS_PER_S))
            stats[key]["by_limbs"][limbs] = st
            stats[key].update(st)       # the last, largest size stays


@functools.lru_cache(maxsize=16)
def exact_steps(spec, cx: int, cy: int, steps: int, start=None):
    """The exact recurrence of the device digits, with Python ints: from
    ``start`` = (x, y, dx, dy) (default z = c and dz/dc = 1), ``steps``
    times x' = rhu(x² − y² + cx·2^16F),
    y' = rhu(2xy + cy·2^16F), dx' = rhu(2(x·dx − y·dy) + 2^32F),
    dy' = rhu(2(x·dy + y·dx)), rhu(v) = sign(v + h)·((|v + h| >> 16F) mod
    2^16D); cx, cy signed fixed-point ints.  Returns (x, y, dx, dy) and
    the number of steps where a magnitude of dz/dc wrapped."""
    shift = 16 * spec.frac_digits
    half = 1 << (shift - 1)
    mod = 1 << (16 * spec.digits)
    one = 1 << (2 * shift)
    wraps = 0

    def rhu(v):
        t = v + half
        m = abs(t) >> shift
        return (m % mod if t >= 0 else -(m % mod)), m >= mod

    x, y, dx, dy = start or (cx, cy, 1 << shift, 0)
    for _ in range(steps):
        k1 = dx * (x + y)          # x·dx − y·dy = k1 − k3, x·dy + y·dx
        k2 = x * (dy - dx)         # = k1 + k2, three products
        k3 = y * (dx + dy)
        (dx, w1), (dy, w2) = rhu(2 * (k1 - k3) + one), rhu(2 * (k1 + k2))
        (x, _), (y, _) = (rhu((x + y) * (x - y) + (cx << shift)),
                          rhu(2 * x * y + (cy << shift)))
        wraps += w1 or w2
    return (x, y, dx, dy), wraps


def state_ints(signs_digits) -> list:
    """Signed Python ints of (s0, d0, s1, d1, ...) host state tuples."""
    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    it = iter(signs_digits)
    return [int(s) * FP.digits_to_int(d) for s, d in zip(it, it)]


def check_chunks(cx, cy, limbs: int, steps: int, name: str, device,
                 nr_us: dict) -> None:
    """From c = (cx, cy) at ``limbs``: the orbit chunk and the NR chunk of
    ``steps`` steps (K12 on the default route) against one exact Python-int
    recurrence, digit for digit; the NR chunk's µs per step (CUDA
    events) into ``nr_us``.  A zero magnitude's sign is compared only
    through the exact ints here; the twins' tests pin it."""
    import torch

    from fractalshark_tpu_torch.core.highprecision import HighPrecision
    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    from fractalshark_tpu_torch.ops.bignum import orbit as O

    spec = FP.FixedSpec.for_limbs(limbs)
    scx, cxd = FP.hp_to_digits(cx, spec)
    scy, cyd = FP.hp_to_digits(cy, spec)
    one_s, one_d = FP.hp_to_digits(HighPrecision(1, prec=64), spec)
    cxt = torch.from_numpy(cxd.astype("int32")).to(device)
    cyt = torch.from_numpy(cyd.astype("int32")).to(device)
    state = O.OrbitState(scx, cxd, scy, cyd, device)
    nr = O.NRState((scx, scy, one_s, 1), cxd, cyd, one_d,
                   0 * one_d, device)
    t0 = time.perf_counter()
    O.orbit_chunk(state, scx, cxt, scy, cyt, spec, steps)
    _, ms = timed(lambda: O.orbit_nr_chunk(nr, scx, cxt, scy, cyt, spec,
                                           steps), device, warm=False)
    z = state_ints(state.numpy())
    got = state_ints(nr.numpy())
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, wraps = exact_steps(spec, scx * FP.digits_to_int(cxd),
                              scy * FP.digits_to_int(cyd), steps)
    ok = z == list(want[:2]) and got == list(want)
    nr_us[limbs] = ms / steps * 1e3
    log(f"  {name}, {limbs} limbs, {steps} steps: z and z, dz/dc (the "
        f"orbit and NR chunks) {'equal' if ok else 'DIFFER'} to the "
        f"Python-int recurrence; |dz/dc| wrapped at {wraps} steps; NR "
        f"chunk {nr_us[limbs]:.2f} us/step (device {dev_s:.2f} s, Python "
        f"ints {time.perf_counter() - t0:.1f} s)")
    if not ok:
        raise AssertionError(f"{limbs} limbs: device chunks differ from "
                             f"the exact recurrence")


def phase_device_orbit(device, nr_us):
    """The device orbit on its own: the digit state after ORACLE_STEPS
    steps at 16,384 limbs against exact Python ints (with the NR chunk
    from the same start); then, with the launch counts from 0 just before
    and read just after, bounded sessions and their time per iteration at
    each limb count (K12), and the device's busy share over a 32-limb
    session (torch.profiler); then, its counts from 0 too, a session at
    WIDE_SESSION_LIMBS, past K12's D < 2^16, on the per-step loop of K4
    then K5, against the 16,384-limb session's orbit.  Returns (µs/iter
    by limbs, that session's launches)."""
    import numpy as np
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.ops.bignum import orbit as O

    log("[5] device orbit")
    cx, cy, rad = view30_center()
    check_chunks(cx, cy, max(ORBIT_LIMBS), ORACLE_STEPS, "View #30 centre",
                 device, nr_us)

    def session(name, x0, y0, r0, limbs, budget):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        res = O.compute_reference_orbit_device(
            x0, y0, budget, r0, limbs32=limbs, periodicity=False,
            chunk_steps=4096, device=device)
        wall = time.perf_counter() - t0
        n_it = res.count_orbit_entries() - 1
        log(f"  session {name} {limbs} limbs: {n_it} iterations in "
            f"{wall:.3f} s, {wall / n_it * 1e6:.2f} us/iter, timers "
            f"{res.extra['session_timers']}")
        if n_it != budget or res.escaped_at:
            raise AssertionError(f"{limbs} limbs: session stopped at "
                                 f"{n_it}")
        return res, wall / n_it * 1e6

    per_iter, sessions = {}, {}
    v6 = get_view_preset(6).ptz
    kernels.reset_counts()
    for limbs in ORBIT_LIMBS:
        # View #30's centre is i + 2^-26000: held to 32 limbs it leaves
        # the repelling cycle of i and escapes within a thousand steps,
        # so 32 limbs (View #6's own width) runs View #6's centre
        name, (x0, y0, r0) = (("View #6", (v6.pt_x, v6.pt_y, v6.radius))
                              if limbs < 2048 else ("View #30", (cx, cy, rad)))
        sessions[limbs], per_iter[limbs] = session(name, x0, y0, r0, limbs,
                                                   SESSION_BUDGET)
    launches = {k: v for k, v in kernels.launches.items() if v}
    log(f"  launches of the sessions: {launches}")
    for k in ("orbit_chunk_block", "orbit_chunk_grid"):
        if not launches.get(k):
            raise AssertionError(f"device orbit: kernel {k} never launched")
    if launches.get("ntt_orbit") or launches.get("orbit_tail"):
        raise AssertionError("device orbit: K4/K5 on K12's sizes")
    busy_share(device, (v6.pt_x, v6.pt_y, v6.radius))

    kernels.reset_counts()
    res, per_iter[WIDE_SESSION_LIMBS] = session(
        "View #30", cx, cy, rad, WIDE_SESSION_LIMBS, WIDE_SESSION_BUDGET)
    wide = dict(kernels.launches)
    log(f"  launches of the {WIDE_SESSION_LIMBS}-limb session: "
        f"{ {k: v for k, v in wide.items() if v} }")
    if not (wide["ntt_orbit"] and wide["orbit_tail"]) or any(
            wide[k] for k in wide if k.startswith("orbit_chunk_")):
        raise AssertionError(f"{WIDE_SESSION_LIMBS} limbs: not on the "
                             f"per-step loop")
    ref, m = sessions[max(ORBIT_LIMBS)], WIDE_SESSION_BUDGET + 1
    same = (np.array_equal(res.orbit_x[:m], ref.orbit_x[:m]) and
            np.array_equal(res.orbit_y[:m], ref.orbit_y[:m]))
    log(f"  {WIDE_SESSION_LIMBS}-limb orbit "
        f"{'equal to' if same else 'DIFFERS from'} the "
        f"{max(ORBIT_LIMBS)}-limb one over {m} entries")
    if not same:
        raise AssertionError(f"{WIDE_SESSION_LIMBS}-limb orbit differs")
    return per_iter, wide


def busy_share(device, view):
    """The device's busy share over one 32-limb session of SESSION_BUDGET
    steps (View #6's centre): the union of the kernel intervals that
    torch.profiler records, over the window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fractalshark_tpu_torch.ops.bignum import orbit as O
    x0, y0, r0 = view
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        O.compute_reference_orbit_device(
            x0, y0, SESSION_BUDGET, r0, limbs32=32, periodicity=False,
            chunk_steps=4096, device=device)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    if not spans:
        log("  device busy share, 32-limb session: not measured (the "
            "profiler recorded no device time)")
        return
    log(f"  device busy share, 32-limb session of {SESSION_BUDGET} steps: "
        f"{busy / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
        f"({busy / 1e4 / wall:.1f} %), {len(spans)} device events")


def cli_run(argv):
    from fractalshark_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}")
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    return stats, wall


def phase_slice(outdir, device="cuda"):
    """The paths through the CLI, each path's launch counts from 0."""
    from fractalshark_tpu_torch import kernels
    log("[6] the paths through fractalshark_tpu_torch.cli.main")
    total = {k: 0 for k in kernels.launches}
    runs = {}

    def run(label, argv, want_alg, want_kernels):
        kernels.reset_counts()
        s, wall = cli_run(argv + ["--stats", "--device", device])
        grew = dict(kernels.launches)
        for k, v in grew.items():
            total[k] += v
        log(f"  {label}: {s['algorithm']} via {s['kernel']} (orbit "
            f"{s['orbit_backend']}, {s['orbit_len']} entries, period "
            f"{s['orbit_period']}), iter_sum {s['iter_sum']}, crc32 "
            f"{s['crc32']}, wall {wall:.3f} s, launches {grew}")
        log(f"    timings {json.dumps(s['timings'])}")
        if s["algorithm"] != want_alg:
            raise AssertionError(f"{label}: algorithm {s['algorithm']}")
        for k in want_kernels:
            if grew[k] <= 0:
                raise AssertionError(f"{label}: kernel {k} never launched")
        s["launches"] = grew
        runs[label] = s
        return s

    png = os.path.join(outdir, "view0_1024.png")
    s = run("View 0 AUTO 1024²", ["--view", "0", "--width", "1024",
                                  "--height", "1024", "--output-png", png],
            "Gpu1x32", ["escape"])
    if not (s["iter_min"] >= 0 and s["iter_max"] <= 256 and s["iter_sum"] > 0
            and os.path.getsize(png) > 1000):
        raise AssertionError("View 0 frame is not plausible")
    x, y, zoom, budget = SMALL_DEEP
    run("small-table deep frame 64²",
        ["--center-x", x, "--center-y", y, "--zoom", zoom, "--iterations",
         str(budget), "--render-algorithm", "GpuHDRx32PerturbedLAv2",
         "--width", "64", "--height", "64"],
        "GpuHDRx32PerturbedLAv2", ["lav2_full"])
    for size, want in ((64, VIEW6_64), (256, VIEW6_256)):
        png = os.path.join(outdir, f"view6_{size}.png")
        s = run(f"View #6 AUTO {size}²",
                ["--view", "6", "--width", str(size), "--height", str(size),
                 "--output-png", png],
                "GpuHDRx32PerturbedLAv2", ["lav2_phase1", "two_phase_tail"])
        got = (s["iter_sum"], s["crc32"])
        if s["launches"]["rc_tail"] or "anchors_s" in s["timings"]:
            raise AssertionError(f"View #6 {size}²: anchors on the "
                                 f"uncompressed orbit's tail")
        log(f"    expected (JAX CPU, FMA off) {want}, got {got}")
        if got != want:
            raise AssertionError(f"View #6 {size}²: {got} != {want}")
    log(f"  View #6 256² iter_sum {runs['View #6 AUTO 256²']['iter_sum']}; "
        f"known other values: TPU v5e {VIEW6_256_TPU} (BENCH_r05), JAX CPU "
        f"with FMA contraction {VIEW6_256_JAX_CPU_FMA}")
    for size, want in VIEW6_GPU_ORBIT.items():
        s = run(f"View #6 --perturbation-alg GPU {size}²",
                ["--view", "6", "--width", str(size), "--height", str(size),
                 "--perturbation-alg", "GPU"],
                "GpuHDRx32PerturbedLAv2",
                ["orbit_chunk_block", "lav2_phase1", "two_phase_tail"])
        if s["launches"]["ntt_orbit"] or s["launches"]["orbit_tail"]:
            raise AssertionError("View #6 GPU orbit: K4/K5 on the path")
        got = (s["iter_sum"], s["crc32"])
        native = runs[f"View #6 AUTO {size}²"]
        log(f"    expected (JAX CPU, FMA off, --perturbation-alg GPU) "
            f"{want}, got {got}; native-orbit frame "
            f"{(native['iter_sum'], native['crc32'])}; device orbit "
            f"{s['timings']['ref_orbit_s'] / s['orbit_len'] * 1e6:.2f} "
            f"us/iter over {s['orbit_len']} entries")
        if s["orbit_backend"] != "device" or got != want:
            raise AssertionError(f"View #6 GPU orbit {size}²: {got} != "
                                 f"{want}")
        if s["orbit_period"] != VIEW6_PERIOD:
            raise AssertionError(f"View #6 GPU orbit period "
                                 f"{s['orbit_period']} != {VIEW6_PERIOD}")

    def pinned(label, argv, want_alg, want_kernels, want,
               source="JAX CPU, FMA off"):
        s = run(label, argv, want_alg, want_kernels)
        got = (s["iter_sum"], s["crc32"])
        log(f"    expected ({source}) {want}, got {got}")
        if got != want:
            raise AssertionError(f"{label}: {got} != {want}")
        return s

    def size(n):
        return ["--width", str(n), "--height", str(n)]

    # View #30 with the device orbit: 669,773 steps at 16,384 limbs on
    # K12's grid form (data/records.json:view30_e2e)
    s = run(VIEW30_MAIN,
            ["--view", "30", "--width", "512", "--height", "512",
             "--perturbation-alg", "GPU"], "GpuHDRx32PerturbedLAv2",
            ["orbit_chunk_grid"])
    log(f"    expected period {VIEW30_PERIOD}, iter_sum "
        f"{VIEW30_512_ITER_SUM}; device orbit "
        f"{s['timings']['ref_orbit_s'] / s['orbit_len'] * 1e6:.2f} us/iter")
    if (s["orbit_period"], s["iter_sum"]) != (VIEW30_PERIOD,
                                              VIEW30_512_ITER_SUM):
        raise AssertionError("View #30 512² differs from the record")

    # the f64 band: View #5 with a valid LA table, View #2 without
    for n, want in VIEW5_F64.items():
        pinned(f"View #5 AUTO {n}²", ["--view", "5"] + size(n),
               "Gpu1x64PerturbedLAv2", ["lav2_full_f64"], want)
    for n, want in VIEW2_F64.items():
        pinned(f"View #2 AUTO {n}²", ["--view", "2"] + size(n),
               "Gpu1x64PerturbedLAv2", ["perturb_f64"], want)
    pinned("View #2 GpuHDRx64PerturbedLAv2 64²",
           ["--view", "2", "--render-algorithm", "GpuHDRx64PerturbedLAv2"]
           + size(64), "GpuHDRx64PerturbedLAv2", ["perturb_hdr64"],
           VIEW2_HDR64_64)
    pinned("View #3 Gpu1x64PerturbedLAv2LAO 64²",
           ["--view", "3", "--render-algorithm", "Gpu1x64PerturbedLAv2LAO"]
           + size(64), "Gpu1x64PerturbedLAv2LAO", ["lav2_lao_f64"],
           VIEW3_LAO64_64)
    # perturbation only: B10's route (short orbit, small budget), then
    # B11's (View #6's orbit of 457,977 entries, the preset's budget)
    x, y, zoom, budget = SMALL_DEEP
    deep = ["--center-x", x, "--center-y", y, "--zoom", zoom,
            "--iterations", str(budget)] + size(64)
    for alg, key in (("GpuHDRx32PerturbedLAv2PO", "perturb_pallas"),
                     ("Gpu1x32PerturbedLAv2PO", "perturb_f32")):
        pinned(f"1e8 frame {alg} 64²", deep + ["--render-algorithm", alg],
               alg, [key], SMALL_DEEP_PO_64)
    po6 = ["--view", "6", "--render-algorithm", "GpuHDRx32PerturbedLAv2PO"]
    pinned("View #6 GpuHDRx32PerturbedLAv2PO 16²", po6 + size(16),
           "GpuHDRx32PerturbedLAv2PO", ["perturb_stream"], VIEW6_PO_16)
    # sizes users render, at the presets' full budgets
    pinned("View #6 GpuHDRx32PerturbedLAv2PO 256²", po6 + size(256),
           "GpuHDRx32PerturbedLAv2PO", ["perturb_stream"], VIEW6_PO_256,
           "the kernels before their redesign")
    pinned("View #5 AUTO 1024²", ["--view", "5"] + size(1024),
           "Gpu1x64PerturbedLAv2", ["lav2_full_f64"], VIEW5_1024,
           "the kernels before their redesign")
    # the RC names: K3 over View #6's compressed orbit, after K2's phase 1
    # and from the zero state
    rc6 = ["--view", "6", "--render-algorithm"]
    pinned("View #6 GpuHDRx32PerturbedRCLAv2 256²",
           rc6 + ["GpuHDRx32PerturbedRCLAv2"] + size(256),
           "GpuHDRx32PerturbedRCLAv2", ["lav2_phase1", "rc_tail"],
           VIEW6_RC_256, "K3 before its redesign")
    pinned("View #6 GpuHDRx32PerturbedRCLAv2PO 16²",
           rc6 + ["GpuHDRx32PerturbedRCLAv2PO"] + size(16),
           "GpuHDRx32PerturbedRCLAv2PO", ["rc_tail"], VIEW6_RC_PO_16,
           "K3 before its redesign")
    return total, runs


def cli_line(argv, device) -> str:
    """The last line the port's CLI prints on ``device``; fails unless it
    exits 0."""
    from fractalshark_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--device", str(device)])
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}")
    return buf.getvalue().strip().splitlines()[-1]


def nr_random_state(limbs: int, seed: int):
    """(spec, [sx, x, sy, y, sdx, dx, sdy, dy, scx, cx, scy, cy]): z and c
    below 4, every digit of dz/dc random (|dz/dc| near 2^32, so
    |2·z·dz/dc| wraps), signs (+, −, −, +) for z and dz/dc."""
    import numpy as np

    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    spec = FP.FixedSpec.for_limbs(limbs)
    rng = np.random.default_rng(seed)
    st = []
    for k, sign in enumerate((1, -1, -1, 1, -1, 1)):
        d = rng.integers(0, 1 << 16, size=spec.digits, dtype=np.uint32)
        if k not in (2, 3):
            d[-1] = 0
            d[-2] &= 3
        st += [sign, d]
    return spec, st


def phase_nr_kernels(device, stats):
    """K4-NR and K5-NR against their twins and the exact step, digit for
    digit, at each of NR_LIMBS from a state whose dz/dc wraps; times and
    bounds."""
    import torch

    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP

    log("[7] K4-NR/K5-NR vs plain versions on the card (random states, "
        "dz/dc wrapping)")
    for key in ("ntt_nr", "nr_tail"):
        stats[key]["by_limbs"] = {}
    for limbs in NR_LIMBS:
        spec, st = nr_random_state(limbs, limbs)
        n, D = spec.nfft, spec.digits

        def t(a):
            return torch.from_numpy(a.astype("int32")).to(device)
        mags = [t(st[k]) for k in (1, 3, 5, 7)]
        signs = FP.sign_row(*st[0:8:2], device)
        cx, cy = t(st[9]), t(st[11])
        coef = FP.nr_products(*mags, signs, spec)
        want = FP.nr_products_plain(*mags, signs, n)
        compare(f"K4-NR {limbs} limbs", coef, want, stats["ntt_nr"])
        got = FP.nr_tail(coef, st[8], cx, st[10], cy, spec)
        plain = FP.nr_tail_plain(want, st[8], cx, st[10], cy, spec)
        for name, a, b in zip(("x", "y", "dx", "dy", "signs"), got, plain):
            compare(f"K5-NR {limbs} limbs {name}", a, b, stats["nr_tail"])
        ints = state_ints(st)
        exact, wraps = exact_steps(spec, ints[4], ints[5], 1,
                                   tuple(ints[:4]))
        dev = [int(s) * FP.digits_to_int(m.cpu().numpy())
               for s, m in zip(got[4].cpu(), got[:4])]
        log(f"    exact step: {'equal' if dev == list(exact) else 'DIFFER'}"
            f", dz/dc wrapped: {bool(wraps)}")
        if dev != list(exact) or not wraps:
            raise AssertionError(f"{limbs} limbs: NR step differs from the "
                                 f"exact step or did not wrap")
        _, k4ms = timed(lambda: FP.nr_products(*mags, signs, spec), device,
                        reps=20)
        _, k4pms = timed(lambda: FP.nr_products_plain(*mags, signs, n),
                         device)
        _, k5ms = timed(lambda: FP.nr_tail(coef, st[8], cx, st[10], cy,
                                           spec), device, reps=20)
        _, k5pms = timed(lambda: FP.nr_tail_plain(coef, st[8], cx, st[10],
                                                  cy, spec), device)
        log(f"    {limbs} limbs: K4-NR {k4ms:.4f} ms (plain {k4pms:.3f}), "
            f"K5-NR {k5ms:.4f} ms (plain {k5pms:.3f})")
        for key, ms, pms, nb, ops in (
                ("ntt_nr", k4ms, k4pms, 4 * D * 4 + 16 + 4 * n * 8,
                 ntt_nr_ops(n)),
                ("nr_tail", k5ms, k5pms, 4 * n * 8 + 6 * D * 4 + 16,
                 nr_tail_ops(n))):
            b = dict(ms=ms, plain_ms=pms, **bound(nb, ops, I32_OPS_PER_S))
            stats[key]["by_limbs"][limbs] = b
            stats[key].update(b)        # the last, largest size stays


def phase_feature(device, nr_us):
    """NR chunks against the exact recurrence at NR_CHUNK_LIMBS; the
    feature finder's device path through its library entry points (the
    launch counts from 0 just before, read just after); the CLI's
    feature commands against the JAX package's JSON."""
    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.core.highprecision import HighPrecision
    from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
    from fractalshark_tpu_torch.core.precision import precision_from_view
    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.engine import feature_finder as FF
    from fractalshark_tpu_torch.engine.native_orbit import (
        compute_reference_orbit_native)
    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    from fractalshark_tpu_torch.ops.bignum import orbit as O

    log("[8] feature finder: NR chunks, the device evaluator and "
        "refinement, the CLI")
    cx, cy, _ = view30_center()
    for limbs in NR_CHUNK_LIMBS:
        check_chunks(cx, cy, limbs, ORACLE_STEPS, "View #30 centre", device,
                     nr_us)
    kernels.reset_counts()

    def close(label, host, dev, rel_bits=150):
        """Every component within 2^-rel_bits relative of the host's."""
        errs = [(h - d).exponent2() - h.exponent2()
                if not (h - d).is_zero() else None
                for h, d in zip(host, dev)]
        log(f"    {label}: device - host, log2 relative per component: "
            f"{errs}")
        if any(e is not None and e >= -rel_bits for e in errs):
            raise AssertionError(f"{label}: device and host evaluators "
                                 f"differ")

    # (a) tests/test_nr_device.py:39-48
    hx, hy = HighPrecision("-0.15", prec=200), HighPrecision("0.4", prec=200)
    close("(a) c = (-0.15, 0.4), period 12, 200 bits",
          FF.evaluate_critical_orbit_and_derivs(hx, hy, 12, 200)[:4],
          O.evaluate_critical_orbit_and_derivs_device(hx, hy, 12, 200,
                                                      device=device))

    # (b) refinement to the period-858 nucleus from the 1e8 frame's centre
    ptz = PointZoomBBConverter(pt_x=SMALL_DEEP[0], pt_y=SMALL_DEEP[1],
                               zoom_factor=SMALL_DEEP[2], prec=512)
    prec = precision_from_view(ptz) + 64
    t0 = time.perf_counter()
    fs = FF.refine_periodic_point(ptz.pt_x.with_precision(prec),
                                  ptz.pt_y.with_precision(prec), 858, prec,
                                  backend="device", device=device)
    got = ((fs.center_x.to_string(40), fs.center_y.to_string(40)),
           fs.nr_iterations)
    log(f"  (b) refine_periodic_point(backend='device') period 858 at "
        f"{prec} bits: {got} in {time.perf_counter() - t0:.2f} s; JAX CPU "
        f"{REFINE_858}")
    if got != REFINE_858:
        raise AssertionError("device refinement of period 858 differs")

    # (c) View #6's centre at full width: the period from the native
    # orbit's periodicity test, as find_periodic_point takes it
    v6 = get_view_preset(6).ptz
    prec = precision_from_view(v6) + 64
    vx, vy = v6.pt_x.with_precision(prec), v6.pt_y.with_precision(prec)
    period = compute_reference_orbit_native(
        vx, vy, 1_000_000, v6.radius, periodicity=True).period - 1
    t0 = time.perf_counter()
    spec, st = O.critical_orbit_state_device(vx, vy, period, prec,
                                             device=device)
    dev_ints = state_ints(st.numpy())
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = FF.evaluate_critical_orbit_and_derivs(vx, vy, period, prec)
    host_s = time.perf_counter() - t0
    scx, cxd = FP.hp_to_digits(vx, spec)
    scy, cyd = FP.hp_to_digits(vy, spec)
    t0 = time.perf_counter()
    exact, wraps = exact_steps(spec, scx * FP.digits_to_int(cxd),
                               scy * FP.digits_to_int(cyd), period - 1)
    limbs = spec.digits // 2
    log(f"  (c) View #6 centre, period {period}, {prec} bits ({limbs} "
        f"limbs): device {dev_s:.3f} s ({dev_s / (period - 1) * 1e6:.2f} "
        f"us/step), host evaluator {host_s:.3f} s, exact recurrence "
        f"{time.perf_counter() - t0:.1f} s; digits "
        f"{'equal' if dev_ints == list(exact) else 'DIFFER'}; |dz/dc| "
        f"wrapped at {wraps} steps (host |dz/dc| ~ 2^{host[2].exponent2()})")
    if dev_ints != list(exact):
        raise AssertionError("View #6 device evaluation differs from the "
                             "exact recurrence")
    zdev = [HighPrecision.from_mant_exp(v, -spec.frac_bits, prec=prec)
            for v in dev_ints[:2]]
    close("(c) View #6 z", host[:2], zdev)

    # (4) tests/test_nr_device.py:51-58
    fs = FF.refine_periodic_point(HighPrecision("-1.754", prec=256),
                                  HighPrecision("0.0004", prec=256), 3, 256,
                                  backend="device", device=device)
    err = (abs(float(fs.center_x) - PERIOD3_RE), abs(float(fs.center_y)))
    log(f"  refine period 3 from (-1.754, 0.0004): {fs.nr_iterations} steps"
        f", |error| {err}")
    if max(err) >= 1e-18:
        raise AssertionError("device refinement missed the period-3 nucleus")
    launches = dict(kernels.launches)
    log(f"  launches on the feature path: "
        f"{ {k: v for k, v in launches.items() if v} }")
    if launches["nr_chunk_block"] <= 0:
        raise AssertionError("feature path: kernel nr_chunk_block never "
                             "launched")
    if launches["ntt_nr"] or launches["nr_tail"]:
        raise AssertionError("feature path: K4-NR/K5-NR on the path")

    # (d) the evaluator at View #30's centre and precision (16,384 limbs:
    # K12's grid form), its launch counts from 0, over ORACLE_STEPS
    # steps against the exact recurrence of phase 5's NR chunk
    v30 = get_view_preset(30).ptz
    prec = precision_from_view(v30) + 64
    kernels.reset_counts()
    t0 = time.perf_counter()
    spec, st = O.critical_orbit_state_device(v30.pt_x, v30.pt_y,
                                             ORACLE_STEPS + 1, prec,
                                             device=device)
    dev_ints = state_ints(st.numpy())
    dev_s = time.perf_counter() - t0
    wide = dict(kernels.launches)
    scx, cxd = FP.hp_to_digits(v30.pt_x, spec)
    scy, cyd = FP.hp_to_digits(v30.pt_y, spec)
    exact, wraps = exact_steps(spec, scx * FP.digits_to_int(cxd),
                               scy * FP.digits_to_int(cyd), ORACLE_STEPS)
    log(f"  (d) View #30 centre, {ORACLE_STEPS + 1} as the period, {prec} "
        f"bits ({spec.digits // 2} limbs): device {dev_s:.3f} s; digits "
        f"{'equal' if dev_ints == list(exact) else 'DIFFER'} to the exact "
        f"recurrence (|dz/dc| wrapped at {wraps} steps); launches "
        f"{ {k: v for k, v in wide.items() if v} }")
    if dev_ints != list(exact):
        raise AssertionError("View #30 device evaluation differs from the "
                             "exact recurrence")
    if wide["nr_chunk_grid"] <= 0 or wide["ntt_nr"] or wide["nr_tail"]:
        raise AssertionError("View #30 evaluation: not on K12's grid form")

    # (5) the CLI, against the JAX package's JSON
    size = ["--width", "32", "--height", "32"]
    t0 = time.perf_counter()
    line = cli_line(["--center-x", SMALL_DEEP[0], "--center-y",
                     SMALL_DEEP[1], "--zoom", SMALL_DEEP[2],
                     "--feature-find", "--feature-max-period", "3000"] + size,
                    device)
    log(f"  --feature-find 1e8 frame ({time.perf_counter() - t0:.2f} s): "
        f"{'equal' if line == FEATURE_FIND_1E8 else 'DIFFERS'}: {line}")
    if line != FEATURE_FIND_1E8:
        raise AssertionError("--feature-find differs from the JAX package")
    for mode, want in FEATURE_SCAN.items():
        line = cli_line(SCAN_ARGS + ["--feature-mode", mode], device)
        log(f"  --feature-scan 3x3 {mode}: "
            f"{'equal' if line == want else 'DIFFERS'}: {line}")
        if line != want:
            raise AssertionError(f"--feature-scan {mode} differs")
    return launches, wide


def phase_escape_seq(device, stats, card):
    """K1-seq against its plain version and K1, then the headline
    sequence through ``escape_sequence`` (its launch count from 0), each
    of its frames against K1, and the kernel's median time of 3 at its
    size (tools/time_pixel_loops.py seq_4096), beside its bound there."""
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.ops import escape

    log("[9] K1-seq (B13): the View 0 zoom sequence")
    st = stats["escape_seq"]
    f32, n = torch.float32, SEQ_BUDGET

    def frames(size, count=SEQ_FRAMES):
        ptz = get_view_preset(0).ptz.square_aspect_ratio(size, size)
        return escape.zoom_sequence(
            escape.PlainParams.from_view(ptz, size, size), size, size, count,
            SEQ_FACTOR)

    S = SEQ_SMALL
    fs = frames(S)
    k, ms = timed(lambda: escape.escape_sequence_kernel(fs, S, S, n, f32,
                                                        device), device, 3)
    pl, pms = timed(lambda: escape.escape_sequence_plain(fs, S, S, n, f32,
                                                         device), device,
                    warm=False)
    compare(f"K1-seq f32 {SEQ_FRAMES} frames {S}² x{n}", k, pl, st)
    log(f"    kernel {ms:.3f} ms, plain {pms:.3f} ms")
    for i, p in enumerate(fs):
        compare(f"K1-seq frame {i} vs K1 f32", k[i].to(torch.int64),
                escape.escape_kernel(p, S, S, n, f32, device), st)
    f2 = frames(256, 3)
    compare("K1-seq f64 3 frames 256²", escape.escape_sequence_kernel(
        f2, 256, 256, n, torch.float64, device),
        escape.escape_sequence_plain(f2, 256, 256, n, torch.float64, device),
        st)

    B = SEQ_BIG
    fb = frames(B)
    kernels.reset_counts()
    t0 = time.perf_counter()
    out = escape.escape_sequence(fb, B, B, n, device=device)
    wall = time.perf_counter() - t0
    launches = kernels.launches["escape_seq"]
    ok = (out.shape == (SEQ_FRAMES, B, B) and str(out.dtype) == "uint32"
          and int(out.max()) == n and int(out.min()) < n)
    log(f"  escape_sequence {SEQ_FRAMES} frames {B}² x{n}: {launches} "
        f"launch, wall {wall:.3f} s (with the copy to the host), iter sums "
        f"{[int(v) for v in out.reshape(SEQ_FRAMES, -1).sum(axis=1)]}")
    if not ok or launches != 1:
        raise AssertionError("escape_sequence at 4096² is not plausible")
    seq = torch.from_numpy(out.astype("int64"))
    inside = torch.stack([escape.interior_mask(p, B, B, f32, device)
                          for p in fb]).cpu()
    for i, p in enumerate(fb):
        compare(f"K1-seq {B}² frame {i} vs K1 f32", seq[i],
                escape.escape_kernel(p, B, B, n, f32, device), st)
    tpl = pixel_loops()
    _, rec = tpl.time_frame(tpl.setup("seq_4096", device), 3)
    med = rec["ms_median"]
    if (rec["iter_sum"], rec["launches"]) != (int(seq.sum()),
                                              {"escape_seq": 1}):
        raise AssertionError("K1-seq's timed run differs")
    log(f"  headline (K1-seq, {SEQ_FRAMES} × {B}² × {n}, f32): median "
        f"{med:.3f} ms of {[round(t, 3) for t in rec['ms']]}, "
        f"{SEQ_FRAMES * B * B / (med / 1e3) / 1e6:.1f} Mpix/s on {card}; "
        f"pixels the shortcut leaves at the budget "
        f"{int(((seq == n) & ~inside).sum())} of {seq.numel()}, "
        f"{float(seq[~inside].sum()) / max(int((~inside).sum()), 1):.2f} "
        f"iterations a pixel it leaves")
    # ms and bound at the timed size; the plain version at 1024²
    st.update(ms=med, plain_ms=pms, **bound(
        seq.numel() * 4, escape_ops(seq, inside), F32_OPS_PER_S))
    return {"escape_seq": launches}


def stream_ops(steps: int) -> float:
    """K7: about 100 f32 operations an LA step (the complex HDR products
    newdz, dz_ev and z, their adds and reductions, three Chebyshev norms
    and the compares), over the steps this frame's pixels take (the
    twin's count)."""
    return 100.0 * steps


def phase_la_stream(device, stats):
    """K7 against its plain version in every state array (the 1e8 frame
    at 64² in chunks of 0, 1, 7 and 1,000 steps over the live pixels;
    View #6 at 256² unbounded), its handoff against K2's la_only state,
    its time at View #6 256² with its bound there, then View #6 through
    the CLI with FRACTALSHARK_LA_PHASE=stream (launch counts from 0): the
    pinned frame in one K7 launch."""
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.ops import la_kernel
    from fractalshark_tpu_torch.ops import la_stream as LS
    from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex
    from fractalshark_tpu_torch.ops.perturb import _dc_grids_hdr, delta_params

    log("[10] K7 (B12): the streaming LA phase, one launch a frame")
    st = stats["la_stream"]
    _, _, _, T, _, dc, _ = deep_inputs(SMALL_DEEP, 64, device)
    n = SMALL_DEEP[3]
    flat = HDRComplex(*(t.reshape(-1).contiguous() for t in dc))
    for chunk in STREAM_CHUNKS:
        ks = LS.run_stages(T, flat, n, chunk)
        runs = LS.last_run_stats["work"]
        ps = LS.run_stages(T, flat, n, chunk, plain=True)
        if LS.last_run_stats["work"] != runs:
            raise AssertionError(f"K7 chunk {chunk}: launches {runs}, the "
                                 f"twin's {LS.last_run_stats['work']}")
        for name, a, b in zip(LS.STATE, ks, ps):
            compare(f"K7 1e8 frame 64² chunk {chunk} ({len(runs)} launches) "
                    f"{name}", a, b, st)
    log(f"  K7 1e8 frame 64²: {LS.last_run_stats['steps']} LA steps")
    bound(nbytes(T.nodes, T.side, T.stages, T.at, *flat, *ks),
          stream_ops(LS.last_run_stats["steps"]), F32_OPS_PER_S)

    S = STREAM_SIZE
    f, res, la = frame_inputs(6, S, device)
    n6 = f.num_iterations
    got = LS.la_phase_stream(res, la, f.ptz, S, S, n6, device=device)
    _, _, ref_iter, dzr, dzi, dze, it, _ = la_kernel.la_perturb_render(
        res, la, f.ptz, S, S, n6, la_only=True, return_state=True,
        device=device)
    want = {"it": it, "jwait": ref_iter, "done": it >= n6, "dzr": dzr,
            "dzi": dzi, "dze": dze}
    for key, b in want.items():
        compare(f"K7 handoff vs K2 la_only View #6 {S}² {key}", got[key], b,
                st)
    T6 = la_kernel.la_tables_on(la, device)
    dc6 = _dc_grids_hdr(*delta_params(f.ptz, res.center_x, res.center_y, S,
                                      S), S, S, device)
    f6 = HDRComplex(*(t.reshape(-1).contiguous() for t in dc6))
    chunk = LS.DEFAULT_CHUNK_STEPS
    ks, ms = timed(lambda: LS.run_stages(T6, f6, n6, chunk), device, 5)
    ps, pms = timed(lambda: LS.run_stages(T6, f6, n6, chunk, plain=True),
                    device, warm=False)
    steps = LS.last_run_stats["steps"]
    for name, a, b in zip(LS.STATE, ks, ps):
        compare(f"K7 View #6 {S}² {name}", a, b, st)
    tr = tool_records("time_pixel_loops.py", "--only", "view6_stream_256",
                      "--trace", "--no-floor")[0]
    log(f"  K7 View #6 {S}² (AT skip and {T6.stage_count} stages, {steps} "
        f"LA steps): {ms:.4f} ms a run (CUDA events; the tool's "
        f"{tr['ms_median']:.4f}), device {tr['trace']['device_ms']:.4f} ms "
        f"in {tr['trace']['kernel_names']}, {tr['trace']['syncs']} host "
        f"sync(s), {tr['launches']} launches; plain {pms:.1f} ms")
    st.update(ms=ms, plain_ms=pms, **bound(
        nbytes(T6.nodes, T6.side, T6.stages, T6.at, *f6, *ks),
        stream_ops(steps), F32_OPS_PER_S))

    os.environ["FRACTALSHARK_LA_PHASE"] = "stream"
    try:
        kernels.reset_counts()
        s, wall = cli_run(["--view", "6", "--width", str(S), "--height",
                           str(S), "--stats", "--device", str(device)])
        launches = dict(kernels.launches)
    finally:
        del os.environ["FRACTALSHARK_LA_PHASE"]
    got = (s["iter_sum"], s["crc32"])
    log(f"  View #6 {S}² FRACTALSHARK_LA_PHASE=stream: la_phase "
        f"{s['la_phase']}, iter_sum {got[0]}, crc32 {got[1]} (two-phase "
        f"{STREAM_PIN}), wall {wall:.3f} s, timings "
        f"{json.dumps(s['timings'])}, K7 launches {launches['la_stream']} "
        f"(expected 1), launches {launches}")
    if s["la_phase"] != "stream" or got != STREAM_PIN or \
            launches["la_stream"] != 1 or launches["two_phase_tail"] <= 0 \
            or launches["rc_tail"] or \
            launches["lav2_phase1"] != 0:
        raise AssertionError("the stream-phase View #6 frame differs")
    return {"la_stream": launches["la_stream"]}


def ntt_phase_ops(rows: int, m: int, lanes: int) -> float:
    """K8: m/2·log2(m) butterflies per column at 8 integer operations (a
    twiddle product of 5, an add and a subtract)."""
    return rows * lanes * (m // 2) * (m.bit_length() - 1) * 8.0


def fourstep_ops(rows: int, n: int) -> float:
    """A four-step transform in K8's two launches: both phases (n/2·
    log2(n) butterflies a row) and the epilogue's Montgomery product with
    the twiddle matrix (6 operations a point)."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    return ntt_phase_ops(rows, n1, n2) + ntt_phase_ops(rows, n2, n1) + \
        6.0 * rows * n


def phase_ntt(device, stats):
    """K8 against its plain version at every four-step phase shape, and
    its two launches a four-step transform (the twiddle matrix and
    transpose in the first's epilogue, the inverse's scale in the
    second's) against their twins at every size and row count, with no
    CUDA kernel between the two (profiler trace); the transform timed
    with its bound; then the generic multiplies against Python ints
    (multiply_3way's launch count from 0) and the checksum tool against
    its host mirror."""
    import numpy as np
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.ops.bignum import debug as DBG
    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    from fractalshark_tpu_torch.ops.bignum import ntt as N

    log("[11] K8 (B9a/B9b): four-step NTT phases, a transform in two "
        "launches; the generic multiplies")
    st = stats["ntt_phase"]
    rng = np.random.default_rng(11)

    def residues(shape):
        a = np.stack([rng.integers(0, (N.P1, N.P2)[r % 2], shape[1:])
                      for r in range(shape[0])])
        return torch.from_numpy(a.astype(np.int32)).to(device)

    for n in NTT_SIZES:
        n1, n2 = N.split_n(n)
        bad = 0
        for rows in NTT_ROWS:
            for m, lanes in ((n1, n2), (n2, n1)):
                y = residues((rows, m, lanes))
                for inv in (False, True):
                    a = N.phase_kernel(y, m, inv)
                    b = N.phase_transform_plain(y, m, inv)
                    bad += int((a != b).sum())
            x = residues((rows, n))
            for inv in (False, True):
                head = N.fourstep_head(x, n, inv)
                want = N.fourstep_head_plain(x, n, inv)
                bad += int((head != want).sum())
                bad += int((N.fourstep_tail(want, n, inv)
                            != N.fourstep_tail_plain(want, n, inv)).sum())
        log(f"  K8 n = {n} ({n1} × {n2}), rows {NTT_ROWS}: both phases "
            f"alone and the two fused launches, forward and inverse: {bad} "
            f"elements differ")
        if bad:
            raise AssertionError(f"K8 disagrees with its plain version at "
                                 f"n = {n}")
    st["max_abs_err"] = 0.0
    # device time, kernels and host syncs from a profiler trace of each
    # call (tools/time_ntt.py): a transform is two K8 launches alone
    traced = {r["call"]: r for r in tool_records(
        "time_ntt.py", "--only", "fourstep", "phase_kernel") if "call" in r}
    times = {}
    for rows, m, lanes in ((4, 256, 256), (14, 256, 512)):
        y = residues((rows, m, lanes))
        _, ms = timed(lambda: N.phase_kernel(y, m, False), device, 20)
        tr = traced[f"phase_kernel [{rows},{m},{lanes}]"]
        times[f"phase {rows}x{m}x{lanes}"] = (
            round(ms, 4), round(tr["device_ms"], 4), round(bound(
                2 * nbytes(y), ntt_phase_ops(rows, m, lanes),
                I32_OPS_PER_S)["bound_ms"], 5))
    for label, tr in traced.items():
        if not label.startswith("fourstep"):
            continue
        log(f"  {label}: {tr['kernels']} CUDA kernels "
            f"({tr['kernel_names']}), {tr['kernels_between_k8']} between "
            f"the two K8 launches, {tr['syncs']} host syncs, "
            f"{tr['ms']:.4f} ms a call, device {tr['device_ms']:.4f} ms")
        if tr["kernel_names"] != {"phase_kernel": 2} or \
                tr["kernels_between_k8"] != 0:
            raise AssertionError(f"{label} ran {tr['kernel_names']}, not "
                                 f"two K8 launches alone")
    for rows, n in TIMED_TRANSFORMS:
        x = residues((rows, n))
        for inv in (False, True):
            fn = (lambda: N.fourstep_inverse_scaled(x, n)) if inv else \
                (lambda: N.fourstep_forward(x, n))
            _, ms = timed(fn, device, 20)
            mat = N._on(("k8_mat", n, inv), device,
                        lambda: N._k8_matrix(n, inv))
            b = bound(4 * nbytes(x) + nbytes(mat), fourstep_ops(rows, n),
                      I32_OPS_PER_S)
            key = f"{'inverse' if inv else 'forward'} {rows}x{n}"
            times[key] = (round(ms, 4), round(b["bound_ms"], 5))
            if (rows, n, inv) == (4, 65536, False):   # 16,384 limbs
                plain = lambda: N.fourstep_tail_plain(   # noqa: E731
                    N.fourstep_head_plain(x, n, False), n, False)
                _, pms = timed(plain, device)
                st.update(ms=ms, plain_ms=pms, **b)
    log(f"  K8 ms (CUDA events a call[, device], bound) by call: {times}")

    def operands(spec, k):
        """k random magnitudes below 4 (in the fixed-point range)."""
        out = []
        for _ in range(k):
            v = rng.integers(0, 1 << 16, spec.digits, dtype=np.uint32)
            v[-1], v[-2] = 0, v[-2] & 3
            out.append(v)
        return out

    launches = 0
    for limbs in MUL_LIMBS:
        spec = FP.FixedSpec.for_limbs(limbs)
        d = operands(spec, 4)
        ints = [FP.digits_to_int(v) for v in d]
        half = 1 << (spec.frac_bits - 1)

        def rs(v):
            return (v + half) >> spec.frac_bits

        t0 = time.perf_counter()
        if limbs == max(MUL_LIMBS):
            kernels.reset_counts()
        x3 = FP.multiply_3way(d[0], d[1], spec, device=device)
        if limbs == max(MUL_LIMBS):
            launches = kernels.launches["ntt_phase"]
        nr = FP.multiply_nr(*d, spec, device=device)
        torch.cuda.synchronize(device)
        dev_s = time.perf_counter() - t0
        x, y, dx, dy = ints
        want = [rs(a * b) for a, b in ((x, x), (y, y), (x, y), (x, dx),
                                       (x, dy), (y, dx), (y, dy))]
        got = [FP.digits_to_int(t.cpu().numpy()) for t in (*x3, *nr)]
        ok = got == want[:3] + want
        log(f"  {limbs} limbs: multiply_3way and multiply_nr "
            f"{'equal' if ok else 'DIFFER from'} the Python-int products "
            f"({dev_s:.3f} s on the card)")
        if not ok:
            raise AssertionError(f"{limbs} limbs: generic multiplies differ")
    # four phases on the four-step route, one each way on the flat one
    want = 4 if spec.nfft >= N.FOURSTEP_MIN else 2
    log(f"  multiply_3way at {max(MUL_LIMBS)} limbs: {launches} K8 launches "
        f"(expected {want})")
    if launches != want:
        raise AssertionError("multiply_3way did not run its K8 phases")

    spec = FP.FixedSpec.for_limbs(2048)
    dx, dy = operands(spec, 2)
    diff = DBG.diff_checksums(
        DBG.checksum_multiply_3way(dx, dy, spec, device=device),
        DBG.host_multiply_3way_checksums(dx, dy, spec))
    log(f"  checksum_multiply_3way at 2,048 limbs against the host mirror: "
        f"diverging stages {diff}")
    if diff:
        raise AssertionError("the debug checksums diverge")
    return {"ntt_phase": launches}


def products_ops(n: int, V: int, pair_plan) -> float:
    """K9: V forward and K inverse transforms per prime of n/2·log2(n)
    butterflies at 8 integer operations, 6 per Montgomery product and 2
    per combine at every point and prime, the scale (6 per point)."""
    lg = n.bit_length() - 1
    K = len(pair_plan)
    terms = sum(len(t) for t in pair_plan)
    return 2 * ((V + K) * (n // 2) * lg * 8 + n * (terms * 8 + K * 6))


def tail_fused_ops(K: int, n: int, L: int) -> float:
    """K10: the CRT of each coefficient (about 20 integer operations) and
    about 16 per digit sum (four parts, the addends, the ripple)."""
    return K * (20.0 * n + 16.0 * L)


def _flags(spec):
    """Set module flags from {"FP.NAME": value}; returns the old values."""
    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    from fractalshark_tpu_torch.ops.bignum import ntt_mxu as NM
    from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP
    mods = {"FP": FP, "NM": NM, "NP": NP}
    old = {}
    for key, v in spec.items():
        mod, name = key.split(".")
        old[key] = getattr(mods[mod], name)
        setattr(mods[mod], name, v)
    return old


def phase_fused(device, stats):
    """K9, K10 and K11 against their plain twins (K11 also against K4 +
    K5), then the flagged routes: under each flag setting of FLAG_RUNS,
    with the launch counts set to 0 just before and read just after, the
    View #30 centre's 256 steps against the exact recurrence and a bounded
    session against the default route's; an NR chunk under PALLAS_NTT
    against the exact wrapped recurrence.  The flags are restored after
    each run, also when it fails."""
    import numpy as np
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    from fractalshark_tpu_torch.ops.bignum import ntt_mxu as NM
    from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP
    from fractalshark_tpu_torch.ops.bignum import orbit as O

    log("[12] K9-K11 (B-f1..B-f5): the flag-off bignum kernels")
    rng = np.random.default_rng(12)
    P = (2013265921, 1811939329)
    plans = {"3way": (2, NP.PLAN_3WAY), "nr": (4, NP.PLAN_NR),
             "iter": (2, NP.PLAN_ITER), "nriter": (4, NP.PLAN_NR_ITER)}
    signs = torch.tensor([1, -1, -1, 1], dtype=torch.int32, device=device)
    times = {}
    for n in FUSED_NFFT:
        x = torch.zeros(4, n, dtype=torch.int32, device=device)
        x[:, :n // 2] = torch.from_numpy(rng.integers(
            0, 1 << 16, (4, n // 2)).astype(np.int32)).to(device)
        for name, (V, plan) in plans.items():
            sg = signs if name == "nriter" else None
            want, pms = timed(lambda: NP.products_plain(x[:V], sg, n, plan),
                              device, warm=False)
            for form in ("whole", "split"):
                key = f"ntt_products_{form}"
                got, ms = timed(lambda: NP.launch_products(
                    list(x[:V]), n, sg, n, plan, form), device, reps=10)
                compare(f"K9 {form} n={n} {name}", got, want, stats[key])
                times[f"{form} {n} {name}"] = (round(ms, 4), round(pms, 3))
                if n == 16384 and name == "iter":
                    stats[key].update(ms=ms, plain_ms=pms, **bound(
                        nbytes(x[:V], got), products_ops(n, V, plan),
                        I32_OPS_PER_S))
    log(f"  K9 ms (kernel, plain) by form, nfft, plan: {times}")
    times = {}
    for n in TAIL_NFFT:
        for K in (2, 4):
            inv = torch.from_numpy(np.stack([np.stack([
                rng.integers(0, p, n, dtype=np.uint64) for p in P])
                for _ in range(K)]).astype(np.int32)).to(device)
            cadd = torch.from_numpy(rng.integers(0, 1 << 16, (K, n)).astype(
                np.int32)).to(device)
            rnd = torch.zeros(n, dtype=torch.int32, device=device)
            rnd[n // 2 - 3] = 1 << 15
            cfg = NP.tail_cfg((1, -1, -1, 0), K == 4)
            for fd in (None, (n // 2 - 2, n // 2)):
                want, pms = timed(lambda: NP.fused_tail_plain(
                    inv, cadd, rnd, cfg, fd), device, warm=False)
                for batched in (False, True):
                    key = "fused_tail_batched" if batched \
                        else "fused_tail_grid"
                    got, ms = timed(lambda: NP.launch_tail(
                        inv, cadd, rnd, cfg, fd, batched), device, reps=10)
                    label = f"K10 {key[11:]} n={n} K={K}" + \
                        (" shadows" if fd else "")
                    for a, b in zip(got, want):
                        compare(label, a, b, stats[key])
                    times[label[4:]] = (round(ms, 4), round(pms, 3))
                    if n == 65536 and K == 2 and fd:
                        stats[key].update(ms=ms, plain_ms=pms, **bound(
                            nbytes(inv, cadd, rnd, *got),
                            tail_fused_ops(K, n, n), I32_OPS_PER_S))
    log(f"  K10 ms (kernel, plain): {times}")
    # zsign (component 1's gswap read on the card) and the tiled twin
    for n in TAIL_NFFT:
        inv = torch.from_numpy(np.stack([np.stack([
            rng.integers(0, p, n, dtype=np.uint64) for p in P])
            for _ in range(2)]).astype(np.int32))
        cadd = torch.from_numpy(rng.integers(0, 1 << 16, (2, n)).astype(
            np.int32))
        rnd = torch.zeros(n, dtype=torch.int32)
        fd = (n // 2 - 2, n // 2)
        cfg = NP.tail_cfg((1, -1, 1, 0), False)
        want = NP.tail_tiled_plain(inv, cadd, rnd, cfg, fd, zsign=(1, -1))
        zsign = torch.tensor([1, -1], dtype=torch.int32, device=device)
        for batched in (False, True):
            got = NP.launch_tail(inv.to(device), cadd.to(device),
                                 rnd.to(device), cfg, fd, batched, zsign)
            key = "fused_tail_batched" if batched else "fused_tail_grid"
            for a, b in zip(got, want):
                compare(f"K10 {key[11:]} n={n} zsign vs the tiled twin", a,
                        b, stats[key])
    # each call's CUDA kernels and host syncs from a profiler trace in a
    # child process (tools/time_ntt.py): two launches, no sync, counted
    # under the flag's route
    for r in tool_records("time_ntt.py", "--only", "tail"):
        if "call" not in r:
            continue
        form = r["call"].split()[1]
        log(f"  K10 {r['call']}: {r['kernel_names']}, {r['syncs']} host "
            f"syncs, device {r['device_ms']:.4f} ms, {r['ms']:.4f} ms a "
            f"call")
        if r["kernel_names"] != {"tail_tiles": 1, "tail_finish": 1} or \
                r["syncs"] or r["launches"] != {f"fused_tail_{form}": 1}:
            raise AssertionError(f"K10 {r['call']}: not two launches "
                                 f"without a sync: {r}")
    # K9's and K11's CUDA kernels and host syncs of one call, from a trace
    # in a child process (tools/time_ntt.py): the whole form one
    # cooperative kernel, the split form its three launches, K11 one; no
    # sync, one count under the call's counter
    want = {"whole": {"whole_kernel": 1},
            "split": {"fwd_kernel": 1, "row_kernel": 1, "inv_kernel": 1},
            "iterate_full": {"iterate_full_kernel": 1}}
    device_ms = {}
    for r in tool_records("time_ntt.py", "--only", "products",
                          "iterate_full"):
        if "call" not in r:
            continue
        kind = r["call"].split()[1] if r["call"].startswith("products") \
            else "iterate_full"
        counter = "iterate_full" if kind == "iterate_full" \
            else f"ntt_products_{kind}"
        device_ms[r["call"]] = (round(r["device_ms"], 4), round(r["ms"], 4))
        if r["kernel_names"] != want[kind] or r["syncs"] or \
                r["launches"] != {counter: 1}:
            raise AssertionError(f"{r['call']}: not {want[kind]} without a "
                                 f"sync: {r}")
    log(f"  K9/K11 traced: {len(device_ms)} calls, each its kernels and no "
        f"host sync; (device ms, ms a call): {json.dumps(device_ms)}")
    # the C entry's block size and the twins' (ntt_pallas.block_threads)
    lib = kernels.lib()
    bad = [(n, V) for n in (1 << k for k in range(2, 18)) for V in (1, 2, 4)
           if lib.fs_ntt_products_threads(V, n.bit_length() - 1)
           != NP.block_threads(n, V)]
    if bad:
        raise AssertionError(f"K9's block size differs from the twins' at "
                             f"(n, V) = {bad}")
    cx, cy, rad = view30_center()
    for limbs in FULL_LIMBS:
        spec = FP.FixedSpec.for_limbs(limbs)
        n, D, F = spec.nfft, spec.digits, spec.frac_digits
        scx, cxd = FP.hp_to_digits(cx, spec)
        scy, cyd = FP.hp_to_digits(cy, spec)
        cxt = torch.from_numpy(cxd.astype("int32")).to(device)
        cyt = torch.from_numpy(cyd.astype("int32")).to(device)
        cadd, rnd = FP.addend_planes(cxt, cyt, spec)
        cfg = NP.tail_cfg((scx, scy, scx * scy, 0), False)
        got, ms = timed(lambda: NM.mxu_iterate_full(cxt, cyt, cadd, rnd, cfg,
                                                    n, (F, D)), device, 20)
        want, pms = timed(lambda: NM.mxu_iterate_full_plain(
            cxt, cyt, cadd, rnd, cfg, n, (F, D)), device, warm=False)
        for a, b in zip(got, want):
            compare(f"K11 {limbs} limbs", a, b, stats["iterate_full"])
        nx, ny, row = FP.iterate_z_row(
            cxt, cyt, torch.from_numpy(FP.shadow_row_np(scx, cxd, scy, cyd))
            .to(device), scx, cxt, scy, cyt, spec)
        dig, sgn, shw = got
        same = (torch.equal(dig[0, F:F + D], nx) and
                torch.equal(dig[1, F:F + D], ny) and
                torch.equal(torch.cat([shw.reshape(-1), sgn]), row))
        log(f"  K11 {limbs} limbs: {ms:.4f} ms (plain {pms:.3f}), "
            f"{'equal' if same else 'DIFFERS from'} K4 + K5")
        if not same:
            raise AssertionError(f"K11 differs from K4 + K5 at {limbs} limbs")
        stats["iterate_full"].update(ms=ms, plain_ms=pms, **bound(
            nbytes(cxt, cyt, cadd, rnd, *got),
            products_ops(n, 2, NP.PLAN_ITER) + tail_fused_ops(2, n, n),
            I32_OPS_PER_S))

    # the flagged routes, each run's launch counts from 0
    launches = {k: 0 for k in ("ntt_products_whole", "ntt_products_split",
                               "fused_tail_grid", "fused_tail_batched",
                               "iterate_full")}
    exact, default, us = {}, {}, {}
    for label, flags, limbs in FLAG_RUNS:
        spec = FP.FixedSpec.for_limbs(limbs)
        scx, cxd = FP.hp_to_digits(cx, spec)
        scy, cyd = FP.hp_to_digits(cy, spec)
        if limbs not in exact:
            exact[limbs] = list(exact_steps(
                spec, scx * FP.digits_to_int(cxd),
                scy * FP.digits_to_int(cyd), ORACLE_STEPS)[0][:2])
            t0 = time.perf_counter()
            default[limbs] = O.compute_reference_orbit_device(
                cx, cy, FLAG_SESSION_BUDGET, rad, limbs32=limbs,
                periodicity=False, chunk_steps=256, device=device)
            us[(limbs, "default")] = (time.perf_counter() - t0) / \
                FLAG_SESSION_BUDGET * 1e6
        old = _flags(flags)
        try:
            kernels.reset_counts()
            state = O.OrbitState(scx, cxd, scy, cyd, device)
            O.orbit_chunk(state, scx, torch.from_numpy(cxd.astype("int32"))
                          .to(device), scy, torch.from_numpy(
                              cyd.astype("int32")).to(device), spec,
                          ORACLE_STEPS)
            got = state_ints(state.numpy())
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            res = O.compute_reference_orbit_device(
                cx, cy, FLAG_SESSION_BUDGET, rad, limbs32=limbs,
                periodicity=False, chunk_steps=256, device=device)
            us[(limbs, label)] = (time.perf_counter() - t0) / \
                FLAG_SESSION_BUDGET * 1e6
            run = {k: v for k, v in kernels.launches.items() if v}
        finally:
            _flags(old)
        same = (np.array_equal(res.orbit_x, default[limbs].orbit_x) and
                np.array_equal(res.orbit_y, default[limbs].orbit_y))
        log(f"  {label}, {limbs} limbs: {ORACLE_STEPS} steps "
            f"{'equal' if got == exact[limbs] else 'DIFFER from'} the "
            f"Python-int recurrence; session of {FLAG_SESSION_BUDGET} "
            f"{'equal to' if same else 'DIFFERS from'} the default route's; "
            f"{us[(limbs, label)]:.2f} us/iter (default "
            f"{us[(limbs, 'default')]:.2f}); launches {run}")
        if got != exact[limbs] or not same:
            raise AssertionError(f"{label} at {limbs} limbs differs")
        routed = [k for k in launches if run.get(k)]
        if not routed or run.get("ntt_orbit") or run.get("orbit_tail"):
            raise AssertionError(f"{label}: not on the flagged kernels {run}")
        for k in routed:
            launches[k] += run[k]
    # an NR chunk under PALLAS_NTT at 2,048 limbs (nfft 8,192: MXU_ITER
    # off), against the exact wrapped recurrence
    old = _flags({"FP.PALLAS_NTT": True, "NM.MXU_ITER": False})
    try:
        kernels.reset_counts()
        check_chunks(cx, cy, 2048, ORACLE_STEPS, "View #30 centre, "
                     "PALLAS_NTT", device, {})
        run = {k: v for k, v in kernels.launches.items() if v}
    finally:
        _flags(old)
    log(f"  NR chunk under PALLAS_NTT: launches {run}")
    if not run.get("ntt_products_whole") or run.get("ntt_nr"):
        raise AssertionError("the NR chunk did not take K9 + K10")
    for k in launches:
        launches[k] += run.get(k, 0)
    log("  flagged routes, us/iter: " + json.dumps(
        {f"{limbs} {label}": round(v, 3) for (limbs, label), v in
         us.items()}))
    return launches


def chunk_centre(limbs: int):
    """(spec, scx, cx digits, scy, cy digits, radius) of a chunk's c:
    View #6's centre below 2,048 limbs (View #30's, i + 2^-26000, leaves
    the cycle of i when held to so few digits), View #30's above."""
    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    spec = FP.FixedSpec.for_limbs(limbs)
    if limbs < 2048:
        v6 = get_view_preset(6).ptz
        x0, y0, r0 = v6.pt_x, v6.pt_y, v6.radius
    else:
        x0, y0, r0 = view30_center()
    scx, cxd = FP.hp_to_digits(x0, spec)
    scy, cyd = FP.hp_to_digits(y0, spec)
    return spec, (x0, y0, r0), scx, cxd, scy, cyd


def k12_forms(spec, values: int) -> list:
    """K12's forms that take ``spec``'s size, the default one first."""
    from fractalshark_tpu_torch.ops.bignum import orbit as O
    forms = [O.chunk_form(spec)]
    for form in ("block", "grid"):
        if form not in forms:
            try:
                O.check_chunk(spec, form, values)
            except ValueError:
                continue
            forms.append(form)
    return forms


def chunk_ops(n: int, values: int) -> float:
    """One step of K12: K4's and K5's operations (ntt_ops + tail_ops), or
    K4-NR's and K5-NR's."""
    return ntt_ops(n) + tail_ops(n) if values == 2 else \
        ntt_nr_ops(n) + nr_tail_ops(n)


def phase_chunk(device, stats):
    """K12 against the plain chunk (a few steps from c and from a
    mid-orbit state, every form that takes the size) and against the
    per-step loop (a chunk of CHUNK_STEPS, bit for bit), the two timed in
    turns (loop, K12, K12, loop) with CUDA events; then CHUNK_SESSION
    steps in chunks of CHUNK_STEPS, the row carried between them as a
    session carries it, in the default form and in the per-step loop,
    bit for bit.  These launches are the yardstick's, not a path's: the
    kernels line does not count them."""
    import torch

    from fractalshark_tpu_torch.core.highprecision import HighPrecision
    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    from fractalshark_tpu_torch.ops.bignum import orbit as O

    log("[13] K12: the orbit and NR chunks in one launch")
    one = HighPrecision(1, prec=64)
    per_step = {}

    def t32(a):
        return torch.from_numpy(a.astype("int32")).to(device)

    def same(label, got, want):
        ok = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want))
        log(f"  {label}: {'equal' if ok else 'DIFFER'}")
        if not ok:
            raise AssertionError(f"{label}: K12 differs")

    def time_turns(label, run, forms, n, values, D):
        """ms per chunk of each form, in turns with the loop's."""
        out = {}
        for form in forms:
            ms = {"steps": [], form: []}
            for f in ("steps", form, form, "steps"):
                ms[f].append(timed(lambda: run(f), device, reps=4)[1])
            out[form] = sum(ms[form]) / 2
            out["steps"] = min(out.get("steps", 1e9), sum(ms["steps"]) / 2)
        per_step[label] = {f: round(v / CHUNK_STEPS * 1e3, 3)
                           for f, v in out.items()}
        log(f"    {label}: us/step {per_step[label]} (loop, K12 forms; "
            f"{CHUNK_STEPS}-step chunks, in turns)")
        return out

    def record(key, limbs, ms, plain_ms, n, D, values):
        st = stats[key]
        st.update(ms=ms, plain_ms=plain_ms, **bound(
            2 * values * D * 4 + 2 * D * 4 + (
                12 * 4 * (CHUNK_STEPS + 1) if values == 2 else 32),
            CHUNK_STEPS * chunk_ops(n, values), I32_OPS_PER_S))
        st["limbs"] = limbs

    # the orbit
    for limbs in CHUNK_ORBIT_LIMBS:
        spec, _, scx, cxd, scy, cyd = chunk_centre(limbs)
        n, D = spec.nfft, spec.digits
        cxt, cyt = t32(cxd), t32(cyd)
        scratch = O._Scratch(spec, device)
        forms = k12_forms(spec, 2)

        def copy(st):
            s = O.OrbitState(1, cxd, 1, cyd, device)
            s.x, s.y, s.row = st.x.clone(), st.y.clone(), st.row.clone()
            return s

        def run(form, st, steps):
            rows = torch.empty(steps + 1, 12, dtype=torch.int32,
                               device=device)
            rows[0] = st.row
            O.launch_orbit_chunk(st, rows, scx, cxt, scy, cyt, spec, steps,
                                 scratch, form)
            st.row = rows[steps]
            return rows

        start = O.OrbitState(scx, cxd, scy, cyd, device)
        mid = copy(start)
        run(forms[0], mid, CHUNK_STEPS)
        for name, st in (("c", start), ("mid-orbit", mid)):
            want = O.orbit_chunk_plain(st.x, st.y, st.row, scx, cxt, scy,
                                       cyt, spec, CHUNK_TWIN_STEPS)
            for form in forms:
                s = copy(st)
                rows = run(form, s, CHUNK_TWIN_STEPS)
                label = f"K12 {form} {limbs} limbs from {name}"
                for a, b in zip((s.x, s.y, rows), want):
                    compare(label, a, b, stats[f"orbit_chunk_{form}"])
        ref = copy(mid)
        want_rows = run("steps", ref, CHUNK_STEPS)
        for form in forms:
            s = copy(mid)
            rows = run(form, s, CHUNK_STEPS)
            same(f"K12 {form} {limbs} limbs, {CHUNK_STEPS} steps vs the "
                 f"per-step loop (signs of row 0: {mid.row[10:].tolist()})",
                 (s.x, s.y, rows), (ref.x, ref.y, want_rows))
        bench = copy(mid)
        ms = time_turns(f"orbit {limbs} limbs",
                        lambda f: run(f, bench, CHUNK_STEPS), forms, n, 2,
                        D)
        for form in forms:
            key = f"orbit_chunk_{form}"
            if CHUNK_MAIN[key] == limbs:
                s = copy(mid)
                _, pms = timed(lambda: O.orbit_chunk_plain(
                    s.x, s.y, s.row, scx, cxt, scy, cyt, spec, CHUNK_STEPS),
                    device, warm=False)
                record(key, limbs, ms[form], pms, n, D, 2)

    # the NR instance
    for limbs in CHUNK_NR_LIMBS:
        spec, st = nr_random_state(limbs, 100 + limbs)
        n, D = spec.nfft, spec.digits
        cx, cy = t32(st[9]), t32(st[11])
        scratch = O._Scratch(spec, device, values=4)
        forms = k12_forms(spec, 4)

        def nr_state(sgn, mags):
            return O.NRState(sgn, *mags, device)

        signs = [s for s in st[0:8:2]]
        mags = [m for m in st[1:8:2]]
        want = O.nr_chunk_plain(FP.sign_row(*signs, device),
                                *[t32(m) for m in mags], st[8], cx, st[10],
                                cy, spec, CHUNK_TWIN_STEPS)
        for form in forms:
            s = nr_state(signs, mags)
            O.launch_nr_chunk(s, st[8], cx, st[10], cy, spec,
                              CHUNK_TWIN_STEPS, scratch, form)
            for a, b in zip((s.signs, s.x, s.y, s.dx, s.dy), want):
                compare(f"K12-NR {form} {limbs} limbs", a, b,
                        stats[f"nr_chunk_{form}"])
        # from z = c, dz/dc = 1 at the chunk's centre
        spec, _, scx, cxd, scy, cyd = chunk_centre(limbs)
        cxt, cyt = t32(cxd), t32(cyd)
        one_s, one_d = FP.hp_to_digits(one, spec)
        start = ((scx, scy, one_s, 1), (cxd, cyd, one_d, 0 * one_d))
        outs = {}
        for form in ["steps"] + forms:
            s = nr_state(*start)
            O.launch_nr_chunk(s, scx, cxt, scy, cyt, spec, CHUNK_STEPS,
                              scratch, form)
            outs[form] = (s.signs, s.x, s.y, s.dx, s.dy)
        for form in forms:
            same(f"K12-NR {form} {limbs} limbs, {CHUNK_STEPS} steps vs the "
                 f"per-step loop", outs[form], outs["steps"])
        bench = nr_state(*start)
        ms = time_turns(f"NR {limbs} limbs", lambda f: O.launch_nr_chunk(
            bench, scx, cxt, scy, cyt, spec, CHUNK_STEPS, scratch, f),
            forms, n, 4, D)
        for form in forms:
            key = f"nr_chunk_{form}"
            if CHUNK_MAIN[key] == limbs:
                s = nr_state(*start)
                _, pms = timed(lambda: O.nr_chunk_plain(
                    s.signs, s.x, s.y, s.dx, s.dy, scx, cxt, scy, cyt, spec,
                    CHUNK_STEPS), device, warm=False)
                record(key, limbs, ms[form], pms, n, D, 4)

    # CHUNK_SESSION steps as a session runs them, chunk after chunk with
    # the row (the NR signs) carried: the default form against the
    # per-step loop, bit for bit
    for limbs in CHUNK_SESSION_LIMBS:
        spec, _, scx, cxd, scy, cyd = chunk_centre(limbs)
        cxt, cyt = t32(cxd), t32(cyd)
        one_d = FP.hp_to_digits(one, spec)[1]
        got = {}
        for form in (O.chunk_form(spec), "steps"):
            scratch = O._Scratch(spec, device)
            nscratch = O._Scratch(spec, device, values=4)
            st = O.OrbitState(scx, cxd, scy, cyd, device)
            nr = O.NRState((scx, scy, 1, 1), cxd, cyd, one_d, 0 * cxd,
                           device)
            rows = torch.empty(CHUNK_SESSION + 1, 12, dtype=torch.int32,
                               device=device)
            rows[0] = st.row
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for k in range(0, CHUNK_SESSION, CHUNK_STEPS):
                O.launch_orbit_chunk(st, rows[k:k + CHUNK_STEPS + 1], scx,
                                     cxt, scy, cyt, spec, CHUNK_STEPS,
                                     scratch, form)
                st.row = rows[k + CHUNK_STEPS]
            torch.cuda.synchronize(device)
            orbit_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(0, CHUNK_SESSION, CHUNK_STEPS):
                O.launch_nr_chunk(nr, scx, cxt, scy, cyt, spec, CHUNK_STEPS,
                                  nscratch, form)
            torch.cuda.synchronize(device)
            nr_s = time.perf_counter() - t0
            got[form] = (st.x, st.y, rows, nr.signs, nr.x, nr.y, nr.dx,
                         nr.dy)
            log(f"  {form}, {limbs} limbs: {CHUNK_SESSION} orbit steps in "
                f"{orbit_s * 1e3:.3f} ms, {CHUNK_SESSION} NR steps in "
                f"{nr_s * 1e3:.3f} ms")
        a, b = got.values()
        same(f"{limbs} limbs, {CHUNK_SESSION} steps in {CHUNK_STEPS}-step "
             f"chunks: K12's orbit and NR vs the per-step loop's", a, b)
    log("  K12 us/step by size (loop, K12 forms): " + json.dumps(per_step))


def hdr_escape_ops(grid, budget: int) -> float:
    """K13: about 80 operations an iteration (two squares and a product,
    four aligned adds, each an exponent compare, a clamped power of two, a
    scaling product and a sum, three reductions off the bits, the
    compare), of each pixel's iterations and the escaping step's ~30; a
    lower bound that counts the integer operations at the float rate."""
    return 80.0 * float(grid.sum()) + 30.0 * float((grid < budget).sum())


def df_escape_ops(grid, budget: int) -> float:
    """K14: about 150 operations an iteration (two squares and a product by
    Dekker's two-prod, 17 operations each, five double-float adds of 20),
    and the escaping step's ~66 (the squares and the magnitude's add)."""
    return 150.0 * float(grid.sum()) + 66.0 * float((grid < budget).sum())


def bla_ops(tally) -> float:
    """K15: 60 operations a step (a BLA step's two complex products, add
    and reductions; a single step is K6's HDR step), counted from the
    run's own BLA and single steps (K15's tally); the level probes left
    out: a lower bound."""
    return 60.0 * float(tally.sum())


def quad_escape_ops(grid, budget: int, qf: bool) -> float:
    """The distinct * and + of an iteration (a split or product the
    iteration repeats counted once: the compiler computes it once).  K17
    (QD): 890 (two squares of 169, a product of 171 with the squares'
    splits, four QD sums of 94, the doubling, the compare; a product is
    Dekker two-prods of 9 plus a split of 4 an operand component, two-
    and three-sums of 6 and 18 and a five-term renorm of 31), and the
    escaping step's 433 (the squares, the magnitude's sum, the compare);
    K18 (QF): 2,149 (squares of 412, a product of 440, four sums of 220,
    each of double-float sums of 20 and products of 16 plus splits) and
    1,045."""
    per, last = (2149.0, 1045.0) if qf else (890.0, 433.0)
    return per * float(grid.sum()) + last * float((grid < budget).sum())


def hdr_df_steps(grid, budget: int) -> tuple[float, int]:
    """K16's steps (each pixel's iterations and an escaped pixel's
    escaping step) and the deepest pixel's."""
    steps = grid + (grid < budget).to(grid.dtype)
    return float(steps.sum()), int(steps.max())


HDR_DF_STEP_OPS = 272.0   # distinct f32 * and + of a K16 step: (2Z + dz)
#                           dz (a complex double-float product of 120,
#                           two HDC2 sums of 44: each two double-float
#                           sums and four scalings), the orbit sum (44),
#                           two reduces (7 each) and the two |z|^2 of
#                           the hi parts (3 each); the exponent logic
#                           not counted: a lower bound


@contextlib.contextmanager
def forbid_twins():
    """A context in which a call of any render family's plain twin
    raises: a CUDA tensor never reaches one."""
    from fractalshark_tpu_torch.ops import (bla_kernel, dblflt, hdr_df,
                                            hdr_escape, perturb, quadd,
                                            quadflt)
    targets = [(hdr_escape, "escape_hdr_plain"), (dblflt, "escape_df_plain"),
               (bla_kernel, "bla_plain"), (perturb, "perturb_plain"),
               (hdr_df, "perturb_hdr_df_plain"), (quadd, "escape_qd_plain"),
               (quadflt, "escape_qf_plain")]
    saved = [getattr(m, n) for m, n in targets]

    def refuse(*_a, **_k):
        raise AssertionError("a plain twin ran on the CLI path")
    try:
        for m, n in targets:
            setattr(m, n, refuse)
        yield
    finally:
        for (m, n), f in zip(targets, saved):
            setattr(m, n, f)


def phase_families(device, stats):
    """The render families the port took last: K13 and K14 (every
    instance) on the shallow frame at 1024², K15 (f32, f64) and K6's glitch
    instance on the 1e8 frame at 1024² x 1,500, each against its twin and
    timed; K13 at View #6's and View #8's centres; K15 on View #6 at 256²
    (timed at the preset budget); the Scaled repair pass on a poisoned
    orbit; then the nine 256² frames through the CLI (counts from 0, the
    twins forbidden), pinned to the JAX package's values."""
    import numpy as np
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.engine.reforbit import RefOrbitCalc
    from fractalshark_tpu_torch.ops import hdr_escape, perturb, scaled

    log("[14] the render families: K13, K14, K15 and K6-glitch vs their "
        "twins, timed (tools/time_pixel_loops.py), then the CLI frames")
    tpl = pixel_loops()
    for name, entry in FAMILY_FRAMES:
        fr = tpl.setup(name, device)
        st = stats[entry]
        rate = F64_OPS_PER_S if fr.dtype == torch.float64 else F32_OPS_PER_S
        if fr.kern in ("k13", "k14"):
            k = fr.run()
            pl, pms = timed(fr.plain, device, warm=False)
            compare(f"{entry} {name}", k, pl, st)
            out, rec = tpl.time_frame(fr, 3)
            ops = (hdr_escape_ops if fr.kern == "k13" else df_escape_ops)(
                out, fr.n)
            b = bound(nbytes(out), ops, rate)
        elif fr.kern == "k15":
            k = fr.run(None, FAMILY_CHUNK)
            pl, pms = timed(fr.plain, device, warm=False)
            compare(f"{entry} {name} (launches of {FAMILY_CHUNK} steps over "
                    f"the live pixels)", k, pl, st)
            out, rec = tpl.time_frame(fr, 3)
            tally = torch.zeros((out.numel(), 2), dtype=torch.int64,
                                device=device)
            fr.run(None, None, tally)
            t = tally.sum(dim=0).tolist()
            log(f"    steps: {t[0]} BLA, {t[1]} single, for "
                f"{int(out.sum())} iterations")
            rows = fr.orbit[:int(out.max()) + 2]
            b = bound(nbytes(rows, fr.T.probe, fr.T.steps, *fr.dc, out),
                      bla_ops(tally), rate)
        else:
            k = fr.run(None, FAMILY_CHUNK)
            pl, pms = timed(fr.plain, device, warm=False)
            for i, what in ((4, "iterations"), (6, "glitch flags")):
                compare(f"{entry} {name} (launches of {FAMILY_CHUNK} steps "
                        f"over the live pixels) {what}", k[i], pl[i], st)
            state, rec = tpl.time_frame(fr, 3)
            out = state[4].reshape(fr.size, fr.size)
            rows = fr.orbit[:int(out.max()) + 1]
            b = bound(nbytes(rows, fr.bad[:rows.shape[0]], *fr.dc[:2], out,
                             state[6]),
                      perturb_ops(out, fr.n, False), rate)
        log(f"  {entry} {name} budget {fr.n}: {rec['ms_median']:.3f} ms (of "
            f"{[round(t, 3) for t in rec['ms']]}), launches "
            f"{rec['launches']}, (iter_sum, crc32) "
            f"{(rec['iter_sum'], rec['crc32'])}; plain {pms:.3f} ms")
        if rec["launches"].get(entry, 0) < 1:
            raise AssertionError(f"{name}: {entry} never launched")
        st.update(ms=rec["ms_median"], plain_ms=pms, **b)

    # K13 past each mantissa type's exponent range
    for v, (mant, n) in DEEP_HDR.items():
        ptz = get_view_preset(v).ptz.square_aspect_ratio(256, 256)
        npdt = np.float32 if mant == "f32" else np.float64
        p = hdr_escape.view_to_hdr_params(ptz, 256, 256, dtype=npdt)
        tdt = torch.float32 if mant == "f32" else torch.float64
        k = hdr_escape.escape_hdr_kernel(p, 256, 256, n, tdt, device)
        compare(f"escape_hdr{mant[1:]} View #{v} centre 256² x{n} (dx "
                f"2^{p['dx'][1]})", k,
                hdr_escape.escape_hdr_plain(p, 256, 256, n, tdt, device),
                stats["escape_hdr" + mant[1:]])

    # K15 on View #6: held at a cut budget, timed at the preset's
    fr = tpl.setup("view6_bla_256", device)
    nc = VIEW6_BLA_TWIN_BUDGET
    compare(f"bla_f32 view6_bla_256 budget {nc} (launches of "
            f"{FAMILY_CHUNK} steps over the live pixels)",
            fr.run(nc, FAMILY_CHUNK), fr.plain(nc), stats["bla_f32"])
    out, rec = tpl.time_frame(fr, 1)
    tally = torch.zeros((out.numel(), 2), dtype=torch.int64, device=device)
    fr.run(None, None, tally)
    t = tally.sum(dim=0).tolist()
    log(f"  bla_f32 view6_bla_256 budget {fr.n}: {rec['ms_median']:.3f} ms "
        f"(of {[round(x, 3) for x in rec['ms']]}), "
        f"{sum(rec['launches'].values())} launches over "
        f"{rec['work'][:4]} pixels, (iter_sum, crc32) "
        f"{(rec['iter_sum'], rec['crc32'])}; steps {t[0]} BLA, {t[1]} "
        f"single, deepest pixel {int(tally.sum(dim=1).max())} steps")
    bound(nbytes(fr.orbit, fr.T.probe, fr.T.steps, *fr.dc, out),
          bla_ops(tally), F32_OPS_PER_S)

    # the Scaled repair pass: a poisoned orbit glitches pixels
    x, y, zoom, n, size = POISON
    ptz = PointZoomBBConverter(pt_x=x, pt_y=y, zoom_factor=zoom).\
        square_aspect_ratio(size, size)
    res = RefOrbitCalc().get_and_create_useful_results(ptz, n)
    res = type(res)(
        center_x=res.center_x, center_y=res.center_y,
        orbit_x=res.orbit_x.copy(), orbit_y=res.orbit_y.copy(),
        max_radius=res.max_radius, period=res.period,
        escaped_at=res.escaped_at, max_iterations=res.max_iterations,
        precision_bits=res.precision_bits)
    res.orbit_x[5] = res.orbit_y[5] = 1e-40
    kernels.reset_counts()
    got, gstats = scaled.perturb_render_scaled(res, ptz, size, size, n,
                                               device=device)
    want, wstats = scaled.perturb_render_scaled(res, ptz, size, size, n,
                                                device="cpu")
    log(f"  poisoned orbit {size}² x{n}: {gstats} (plain on the CPU "
        f"{wstats}), launches "
        f"{ {k: v for k, v in kernels.launches.items() if v} }")
    compare("Scaled render, poisoned orbit (f32 pass + HDR-f64 repair)",
            got, want, stats["perturb_scaled"])
    if gstats != wstats or gstats["glitched_pixels"] <= 0 or \
            kernels.launches["perturb_hdr64"] < 1:
        raise AssertionError("the Scaled repair pass did not run as its "
                             "twin")
    k = scaled.scaled_pass(res, ptz, size, size, n, device=device)
    pl = scaled.scaled_pass(res, ptz, size, size, n, device="cpu")
    for i, what in ((0, "iterations"), (1, "glitch flags")):
        compare(f"perturb_scaled poisoned orbit {size}² x{n} {what}", k[i],
                pl[i], stats["perturb_scaled"])

    # the CLI frames, counts from 0, the twins forbidden
    launches = {entry: 0 for _, entry in FAMILY_FRAMES}
    with forbid_twins():
        for alg, (argv, key, pin) in FAMILY_PINS.items():
            kernels.reset_counts()
            s, wall = cli_run(argv + ["--render-algorithm", alg, "--width",
                                      "256", "--height", "256", "--stats",
                                      "--device", "cuda"])
            grew = {k: v for k, v in kernels.launches.items() if v}
            got = (s["iter_sum"], s["crc32"])
            log(f"  {alg} 256²: via {s['kernel']}, (iter_sum, crc32) {got} "
                f"(JAX CPU, FMA off: {pin}), wall {wall:.3f} s, launches "
                f"{grew}, timings {json.dumps(s['timings'])}")
            if got != pin or grew.get(key, 0) < 1:
                raise AssertionError(f"{alg} 256²: {got} != {pin} or no "
                                     f"{key} launch")
            launches[key] += grew[key]
    return launches


def phase_late(device, stats):
    """The last render families: K16 against its twin on the 1e8 frame at
    64² (launches of FAMILY_CHUNK steps over the live pixels), then timed
    on View #9 at 1024² × 40,000; K17 and K18 (both component types)
    against their twins at 256² on the 1e17 frame (QUAD_TWIN_BUDGET) and
    on the antenna frame, then timed at 1024² × 600 on the 1e17 frame;
    then escape_qf through its public entry and the LATE_PINS frames
    through the CLI (counts from 0, the twins forbidden), pinned to the
    JAX package's values."""
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
    from fractalshark_tpu_torch.ops import quadd, quadflt

    log("[15] the last render families: K16, K17 and K18 vs their twins, "
        "timed (tools/time_pixel_loops.py), then the CLI frames")
    tpl = pixel_loops()
    st = stats["perturb_hdr_df"]
    fr = tpl.setup(HDR_DF_TWIN_FRAME, device)
    k = fr.run(None, FAMILY_CHUNK)
    pl, pms = timed(fr.plain, device, warm=False)
    compare(f"perturb_hdr_df {fr.name} budget {fr.n} (launches of "
            f"{FAMILY_CHUNK} steps over the live pixels)", k, pl, st)
    fr = tpl.setup(HDR_DF_FRAME, device)
    out, rec = tpl.time_frame(fr, 3)
    steps, deepest = hdr_df_steps(out, fr.n)
    b = bound(nbytes(fr.orbit, *fr.dc, out), HDR_DF_STEP_OPS * steps,
              F32_OPS_PER_S)
    log(f"  perturb_hdr_df {fr.name} budget {fr.n}: {rec['ms_median']:.3f} "
        f"ms (of {[round(t, 3) for t in rec['ms']]}), launches "
        f"{rec['launches']} over {rec['work'][:4]} pixels, (iter_sum, "
        f"crc32) {(rec['iter_sum'], rec['crc32'])}; {steps:.0f} steps, "
        f"the deepest pixel {deepest}; plain {pms:.3f} ms at "
        f"{HDR_DF_TWIN_FRAME}")
    if rec["launches"].get("perturb_hdr_df", 0) < 1:
        raise AssertionError("K16 never launched")
    st.update(ms=rec["ms_median"], plain_ms=pms, **b)

    for name, entry in QUAD_FRAMES:
        st = stats[entry]
        qf = entry.startswith("escape_qf")
        mod, kind = (quadflt, "qf") if qf else (quadd, "qd")
        variant = "4x" + entry[-2:]
        dt = torch.float64 if variant == "4x64" else torch.float32
        rate = F64_OPS_PER_S if variant == "4x64" else F32_OPS_PER_S
        plain_ms = []
        for argv, n in ((QUAD_1E17, QUAD_TWIN_BUDGET),
                        (QUAD_ANTENNA, int(QUAD_ANTENNA[-1]))):
            x, y, zoom = argv[1], argv[3], argv[5]
            s = QUAD_TWIN_SIZE
            ptz = PointZoomBBConverter(pt_x=x, pt_y=y, zoom_factor=zoom,
                                       prec=256).square_aspect_ratio(s, s)
            scal = getattr(mod, kind + "_params")(ptz, s, s, variant)
            k = getattr(mod, f"escape_{kind}_kernel")(scal, s, s, n, dt,
                                                      device)
            pl, pms = timed(lambda: getattr(mod, f"escape_{kind}_plain")(
                scal, s, s, n, dt, device), device, warm=False)
            compare(f"{entry} zoom {zoom} {s}² x{n}", k, pl, st)
            plain_ms.append(pms)
        pms = plain_ms[0]
        fr = tpl.setup(name, device)
        out, rec = tpl.time_frame(fr, 3)
        b = bound(nbytes(out), quad_escape_ops(out, fr.n, qf), rate)
        log(f"  {entry} {name} budget {fr.n}: {rec['ms_median']:.3f} ms "
            f"(of {[round(t, 3) for t in rec['ms']]}), launches "
            f"{rec['launches']}, (iter_sum, crc32) "
            f"{(rec['iter_sum'], rec['crc32'])}; plain {pms:.3f} ms at "
            f"{QUAD_TWIN_SIZE}² x{QUAD_TWIN_BUDGET}")
        if rec["launches"].get(entry, 0) < 1:
            raise AssertionError(f"{name}: {entry} never launched")
        st.update(ms=rec["ms_median"], plain_ms=pms, **b)

    launches = {"perturb_hdr_df": 0, "escape_4x32": 0, "escape_4x64": 0,
                "escape_qf32": 0, "escape_qf64": 0}
    with forbid_twins():
        # K18's path: escape_qf, the public function no algorithm name
        # routes to, on the 1e17 frame at 256²
        x, y, zoom, n = (QUAD_1E17[1], QUAD_1E17[3], QUAD_1E17[5],
                         int(QUAD_1E17[-1]))
        ptz = PointZoomBBConverter(pt_x=x, pt_y=y, zoom_factor=zoom,
                                   prec=256).square_aspect_ratio(256, 256)
        for variant in ("4x32", "4x64"):
            kernels.reset_counts()
            got = quadflt.escape_qf(ptz, 256, 256, n, variant=variant,
                                    device=device)
            key = "escape_qf" + variant[2:]
            torch.cuda.synchronize(device)
            grid = got.cpu().numpy()
            log(f"  escape_qf {variant} 1e17 256² x{n}: (iter_sum, crc32) "
                f"{crc_pin(got)}, launches {kernels.launches[key]}")
            if kernels.launches[key] != 1 or int(grid.min()) != n:
                raise AssertionError(f"escape_qf {variant}: not one {key} "
                                     f"launch, or a pixel escaped before "
                                     f"{n}")
            launches[key] += 1
        for label, (argv, alg, key, pin) in LATE_PINS.items():
            kernels.reset_counts()
            s, wall = cli_run(argv + ["--render-algorithm", alg, "--width",
                                      "256", "--height", "256", "--stats",
                                      "--device", "cuda"])
            grew = {k: v for k, v in kernels.launches.items() if v}
            got = (s["iter_sum"], s["crc32"])
            log(f"  {label} 256²: via {s['kernel']}, (iter_sum, crc32) {got} "
                f"(JAX CPU, FMA off: {pin}), wall {wall:.3f} s, launches "
                f"{grew}, timings {json.dumps(s['timings'])}")
            if got != pin or grew.get(key, 0) < 1:
                raise AssertionError(f"{label} 256²: {got} != {pin} or no "
                                     f"{key} launch")
            launches[key] += grew[key]
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    try:
        import fractalshark_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port is not importable here: {e}", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_s = {}
    def run(name, fn, *args):
        """One phase, its wall time kept for the summary."""
        tp = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - tp, 1)
        return out

    card = phase_card(torch)
    run("2", phase_build)
    stats, backend = run("3", phase_kernels, device)
    log(f"    orbit backend: {backend}")
    run("3b", phase_f64_perturb_kernels, device, stats)
    run("4", phase_orbit_kernels, device, stats)
    nr_us = {}
    per_iter, wide_orbit = run("5", phase_device_orbit, device, nr_us)
    with tempfile.TemporaryDirectory() as outdir:  # the frames' PNGs
        launches, runs = run("6", phase_slice, outdir)
    run("7", phase_nr_kernels, device, stats)
    feature, wide_nr = run("8", phase_feature, device, nr_us)
    launches.update(run("9", phase_escape_seq, device, stats, card))
    launches.update(run("10", phase_la_stream, device, stats))
    launches.update(run("11", phase_ntt, device, stats))
    launches.update(run("12", phase_fused, device, stats))
    run("13", phase_chunk, device, stats)
    launches.update(run("14", phase_families, device, stats))
    launches.update(run("15", phase_late, device, stats))
    # K12's and K4/K5's launches, each from its own path's run: View #6's
    # and View #30's device-orbit frames, the feature evaluator at View
    # #6's sizes and at View #30's, and the orbit past K12's D < 2^16.
    # K4-NR/K5-NR are on no path since K12 took every NR size (0).
    frame = {k: runs[label]["launches"][k] for label, k in (
        (VIEW6_GPU_MAIN, "orbit_chunk_block"),
        (VIEW30_MAIN, "orbit_chunk_grid"))}
    launches.update(frame, nr_chunk_block=feature["nr_chunk_block"],
                    nr_chunk_grid=wide_nr["nr_chunk_grid"],
                    ntt_orbit=wide_orbit["ntt_orbit"],
                    orbit_tail=wide_orbit["orbit_tail"], ntt_nr=0,
                    nr_tail=0)
    if any(m.split(".")[0] in ("jax", "fractalshark_tpu")
           for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    kernels_out = []
    for name, (src, replaces) in KERNEL_META.items():
        st = stats[name]
        kernels_out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": None})
    log("orbit us/iter (session wall): " + json.dumps(
        {str(k): round(v, 3) for k, v in per_iter.items()}))
    log("K4/K5 by limbs: " + json.dumps(
        {k: stats[k]["by_limbs"] for k in ("ntt_orbit", "orbit_tail")}))
    log("K4-NR/K5-NR by limbs: " + json.dumps(
        {k: stats[k]["by_limbs"] for k in ("ntt_nr", "nr_tail")}))
    log("NR chunk us/step: " + json.dumps(
        {str(k): round(v, 3) for k, v in sorted(nr_us.items())}))
    log(f"phase wall s: {json.dumps(phase_s)}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

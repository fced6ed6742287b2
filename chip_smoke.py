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
(and K4-NR then K5-NR), timed in turns with it, both instances up to
32,768 limbs (D = 2^16), then 2,048 steps of the
orbit and of NR in 256-step chunks, the row carried between them, in
both.  The kernels line takes K12's launches from the View #6 and View
#30 device-orbit frames and the feature evaluator's two runs, K4/K5's
from the 32,768-limb session; K4-NR/K5-NR are on no path (0), (14) the
render families: K13 (``csrc/escape_hdr.cu``, f32 and f64 mantissas) and
K14 (``csrc/escape_df.cu``, 2x32 and 2x64) on the integration sweep's
shallow frame at 1024² × 256, K15 (``csrc/bla.cu``, f32 and f64) and
K6's glitch instance (counts and flags) on the 1e8 frame at 1024² ×
1,500, each against its twin at the full budget (K15 on the frame at
512², through its run loop and in launches over the live pixels, with
its per-pixel tally of BLA and single steps; the glitch instance in such
launches) and timed
(tools/time_pixel_loops.py; K15's timed frames held to their pins,
``K15_TIMED_PINS``), K13 at View #6's and View #8's centres
(2^453, 2^2220) at 256², K15 (f32 and f64) on View #6, held to its twin
and its tally at 128² and a cut budget (``VIEW6_BLA_TWIN_BUDGET``), timed
at 256² at the preset's budget and held to its pin, and its deepest
pixel run alone (its serial floor), K14 2x64 against its twin on the
guard frame (``DF_GUARD_SCALARS``: iterations on and off its exact fast
path) and K13 on its guard frames (``HDR_GUARD_SCALARS``: iterations in
and out of its value form), the Scaled repair pass (K6 HDR-f64) on a poisoned orbit, and the
glitch instance there with the bad flag moved to two more positions (in
one launch and in launches over the live pixels), then the nine frames of
``FAMILY_PINS`` through the CLI at 256² (counts from 0, the plain twins
made to raise), pinned to the JAX package's values; their launches are
the kernels line's, (15) the last render families: K16
(``csrc/perturb_hdr_df.cu``, HDR double-float perturbation) against its
twin in launches over the live pixels on the 1e8 frame at 64² (budget
cut to 600), then timed on View #9 at 1024² × 40,000 (its step count, the deepest
pixel's steps and the bound from them); K17 and K18
(``csrc/escape_quad.cu``: QD and QF escapes, 4x32 and 4x64) against
their twins at 256² on the 1e17 frame (budget cut) and on a 1e18 frame
by -2 whose low f32 components are subnormal, then timed at 1024² × 600
on the 1e17 frame, and K17 4x64 and K18 4x64 against their twins on
their guard frames (``QUAD_GUARD_SCALARS``, ``QF_GUARD_SCALARS``:
iterations on and off their exact fast path), K18 4x64 also on the
integration sweep's shallow frame at 64² (counts that differ);
then ``escape_qf`` (K18's public entry) and the
``LATE_PINS`` frames through the CLI at 256² (counts from 0, the twins
made to raise), pinned to the JAX package's values; their launches are
the kernels line's, (16) the gather tail and the app surface: K19
(``csrc/rc_tail.cu``'s f64 cursor, the gather tail's exact mode) against
its twin bit for bit on View #6 RC 256² from K2's handoff and RC PO 16²
from the zero state (cut budgets, launches over the live pixels), each
timed at its full budget beside K3 on the same start with the pixels
that flip between the two, its init launch timed apart and the deepest
pixel's steps at K19's serial floor, then on its guard orbits
(``RC_GUARD_ORBITS``: recurrences in and out of its unflushed form),
then View #6 ``...RCLAv2`` 256² through the CLI with
``FRACTALSHARK_RC_TAIL=gather`` (K19 launches, K3 does not; its launches
are the kernels line's), pinned to the JAX package's f64 gather
(``VIEW6_RC_256_GATHER``); the device orbit's reuse digits: the
1e60 authority of ``tests/test_reuse.py:195`` on the card (K12's block
form), its reuse copy equal to the CPU twins' and the 1e62 view it
serves within 1e-13 of a direct device orbit, phase 5's 16,384-limb
chunk (K12's grid form) again with reuse rows, each equal to the exact
state's truncation, and K12's time a step with and without them; then,
each with the launch counts from 0, a two-worker render pool on View 0
at 1024² (passes 4 and 1) against a one-shot render, three Max autozoom
steps at 256² against the CPU twins' path, a render server in a thread
serving View #6 256² twice over a unix socket (rc 0, the second from
the orbit cache, the PNGs equal to a direct render) and the tray's
poster mode on View 0 at 1024² in 128-row bands (K1 f64, equal to the
whole frame), resumed with half its tiles deleted, (17) the sharded
paths (``parallel/``): K20 (``csrc/sharded_tail.cu``, a rank's block of
the sharded step's CRT/carry tail, from the reshard's receive buffer)
against its plain version block by block at 16,384 limbs with M = 1, 2,
4 and 8 blocks, no collective, and timed (a call pair through the public
calls and through a workspace, each launch's device time from a CUDA
graph);
then this script's worker processes (``--parallel-rank``) as M = 4 ranks
and, on a subgroup, M = 2, all on this card in a gloo group (collectives
staged through host memory): the sharded forward, inverse and 3-way
multiply at nfft 8,192 and 65,536 against the one-device K8 transforms,
256 sharded steps from View #30's centre at 16,384 limbs against K12's
session (counts from 0: K8 and K20 only), the View 0 escape at 512² in
bands (K1) and its all_reduce statistics, View #6 HDR and PO at 64² (K6)
and RC PO 16² (K3, pinned) against the one-card frames, the sharded
multiply and step timed, and their collectives timed apart (the device
synchronised around each, in a second run); with two cards or more the
same on an NCCL group, one rank a card; on each rank the host's waits on
the card outside the collectives, none allowed in the reshard and the
tail.  K20's launches are the sharded session's, (18) the graft entry
points: ``graft_entry.entry`` (K1, View 0 256² x 512 in f32) against its
plain version, ``graft_entry.dryrun_multichip(8)`` (eight gloo ranks on
this card: K6 on each rank's slab and its stream form, K8's sharded
product at nfft 4,096, three sharded orbit steps with K20, each against
one device's) with the JAX package's 8-device iter_sum, and
``tools/run_view32_torch.py`` on View #32 at 32,768 limbs (K12's grid
form) capped at 4,096 steps and resumed to 8,192 in the same directory,
its orbit x/y/e equal to an uninterrupted 8,192-step run's bit for bit,
each run's cap_hit record and projection checked (phase 18 alone:
``python3 -c "import chip_smoke as c, torch; c.phase_build();
c.phase_graft(torch.device('cuda', 0))"``), (19) the endurance
pipeline (``tools/run_view27_torch.py``: the native session compressed
and checkpointed, the LA table built through memmaps, ``VirtualResults``,
K2 ``la_only``, the tables released between the phases, the gather tail)
at the mini location of ``tests/test_torch_view27_pipeline.py`` (the 1e13
frame, period 999, 16² x 12,000) in f64 (K19) and df32 (K3), each pinned
to the JAX package's grid (``MINI_RC_PINS``) with the twins made to
raise; the device memory the dropped tables free; K19 and K3 against
their twins from one handoff at a cut budget (phase 19 alone:
``python3 -c "import chip_smoke as c, torch; c.phase_build();
c.phase_endurance(torch.device('cuda', 0), {k: {} for k in
c.KERNEL_META})"``), (20) an explorer's paths after one frame: the zoom
sequence (``tools/run_view30_torch.py``'s ``sequence``) on View #6 at
64², three frames at a zoom step of 1.5 against one native orbit and one
LA table (no table put on the card again), each frame's K2 handoff and
K6 tail against their twins at a cut budget, every frame pinned to the
JAX package's (``ZOOM_PINS``, the last ``VIEW6_64``), and the feature-zoom clip (``tools/autozoom_clip_torch.py``)
from View 0 at 64², six frames at 10 fps through the render pool, every
step presented in generation order and equal to a direct render of its
step (phase 20 alone: ``python3 -c "import chip_smoke as c, torch;
c.phase_build(); c.phase_zoom(torch.device('cuda', 0), {k: {} for k in
c.KERNEL_META})"``).  The kernels line adds phase 19's launches (K2
``la_only``, K19, K3) and phase 20's (K2 ``la_only``, K6 resumed, K1) to
the earlier phases'.
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
# the same frame through the JAX package's gather tail on the CPU with FMA
# off (tools/view6_rc_pins.py): mode "f64", K19's reference (the gather
# route's CLI frame is held to it), and "df32", which the JAX package's
# tests pin to its sweep, K3's reference (= VIEW6_RC_256)
VIEW6_RC_256_GATHER = {"f64": (52_302_966_139, 1_647_051_423),
                       "df32": (52_302_961_633, 3_147_924_880)}
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
CHUNK_ORBIT_LIMBS = (32, 128, 256, 512, 2048, 16384, WIDE_SESSION_LIMBS)
CHUNK_NR_LIMBS = (16, 32, 128, 256, 2048, 16384, WIDE_SESSION_LIMBS)
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
    # phase 16: the gather tail's f64 mode (_init_state :77 and
    # _tail_impl :119, XLA in the reference), K3's loop with an f64 cursor
    "rc_tail_f64": ("fractalshark_tpu_torch/csrc/rc_tail.cu",
                    "fractalshark_tpu/ops/rc_tail.py:119"),
    # phase 17: the sharded orbit step's CRT/carry tail (plain jnp in the
    # reference, _pcarry/_psigned_finish/_pstreams), K20
    "sharded_tail": ("fractalshark_tpu_torch/csrc/sharded_tail.cu",
                     "fractalshark_tpu/parallel/orbit_sharded.py:81-167"),
}

# phase 14's kernel frames (tools/time_pixel_loops.py FRAMES) and the
# kernels-line entry each gives: held to its twin at its full budget
# (K15 through its run loop and in launches of FAMILY_CHUNK steps over
# the live pixels, its step tally too; the glitch instance in such
# launches), then timed; K13 at View #6's and View #8's centres at 256²
# (each past its mantissa type's exponent range) at these budgets; K15
# on View #6 (VIEW6_BLA_FRAMES); the Scaled repair pass on the poisoned
# orbit of tests/test_scaled.py:52-73 (entry 5 made f32-subnormal), at
# this size and budget
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
# K15 on View #6 at 256², both mantissa types, at the preset's budget
VIEW6_BLA_FRAMES = [("view6_bla_256", "bla_f32"),
                    ("view6_bla64_256", "bla_f64")]
# their twins' budget at 128²: the deepest pixel's 1,617 / 1,631 steps
# (f32 / f64; the preset's budget: 6,228 / 5,475), 13,882 / 14,363 of
# the 16,384 pixels escaped (K15's tally on the H100); the twin runs
# every pixel in lockstep to the deepest one, ~5 ms a step on the card
VIEW6_BLA_TWIN_BUDGET = 792_000
# K15's timed frames, whose twins now run at 512² and 128²: (iter_sum,
# CRC-32) of the frames K15 and its twin agreed on bit for bit when the
# twin still ran these sizes; the kernel is held to them
K15_TIMED_PINS = {"1e8_bla_f32_1024": (1197472414, 2175409724),
                  "1e8_bla_f64_1024": (1197468156, 4089822739),
                  "view6_bla_256": (56282797997, 1152900570),
                  "view6_bla64_256": (51893602644, 3489529998)}
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
# K16's twin runs every pixel in lockstep: at the frame's 1,500 it took
# 26-29 s; 600 keeps launches of FAMILY_CHUNK over the live pixels
HDR_DF_TWIN_BUDGET = 600
# K16 on that frame at its own budget of 1,500, in launches of
# FAMILY_CHUNK steps: (budget, (iter_sum, CRC-32)) of the grid K16 and
# its twin agreed on bit for bit at that depth (take_late_pins, run once
# outside the smoke on an NVIDIA H100 80GB HBM3, PERF.md §6); the
# smoke runs the kernel alone there and holds it to the pin
HDR_DF_PIN = (1500, (4_670_055, 1_191_621_971))
HDR_DF_FRAME = "view9_hdr_df_1024"
QUAD_FRAMES = [("1e17_qd32_1024", "escape_4x32"),
               ("1e17_qd64_1024", "escape_4x64"),
               ("1e17_qf32_1024", "escape_qf32"),
               ("1e17_qf64_1024", "escape_qf64")]
QUAD_TWIN_SIZE = 256
# K18 4x64 on the shallow frame, against its twin (the twin costs ~40 s at
# 256²)
QF_SHALLOW_SIZE = 64
# and at 256², the kernel alone held to (iter_sum, CRC-32) of the grid it
# and its twin agreed on (take_late_pins, the same run; also the JAX
# package's "Gpu4x64 shallow" value in LATE_PINS)
QF_SHALLOW_PIN = (256, (9_075_311, 3_935_581_982))
QUAD_TWIN_BUDGET = 40
# K17 4x64's guard frame (the 16 scalars, size, budget): cx = -2 + (x - 8)
# 2^-300, cy = -y (2^-300 + 2^-480).  Rows y > 0 carry a component near
# 2^-480 in cy (below the fast path's range: every iteration takes the
# reference arithmetic); on row 0, z's components near -2 fall below the
# range for tens of iterations and then rise into it; c = -2 stays in it
QUAD_GUARD_SCALARS = [-2.0, -2.0 ** -297, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                      2.0 ** -300, 0.0, 0.0, 0.0, 2.0 ** -300, 2.0 ** -480,
                      0.0, 0.0]
QUAD_GUARD_SIZE = 16
QUAD_GUARD_BUDGET = 300
# K18 4x64's guard frame (min_x, max_y, dx, dy as (a.hi, a.lo, b.hi,
# b.lo), size, budget): cx = -2 + (x - 8) D, D = QF_GUARD_STEP (a full
# mantissa near 2^-200); cy = -y (2^-340 + 2^-440 (1 + 2^-52)).  In rows
# 3, 5-7 and 9-15 the product y 2^-440 (1 + 2^-52) rounds and its error,
# near 2^-492, is a component of cy below the fast path's range (every
# iteration takes the reference arithmetic); in rows 1, 2, 4 and 8 (y a
# power of two: the product exact) zy's lower components start below the
# range and rise into it; in row 0 (cy = 0) every iteration is admitted.
# Columns 0-7 escape after 73-74 iterations, column 8 (cx = -2) after
# 146-158 but in row 0, columns 9-15 of rows 1-15 after 236-243, a count
# that a wrong bit moves
QF_GUARD_STEP = float.fromhex("0x1.3c0ca428c59fbp-200")
QF_GUARD_SCALARS = [-2.0, -8 * QF_GUARD_STEP, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                    QF_GUARD_STEP, 0.0, 0.0, 0.0, 2.0 ** -340, 0.0,
                    2.0 ** -440 + 2.0 ** -492, 0.0]
QF_GUARD_SIZE = 16
QF_GUARD_BUDGET = 300
# K14 2x64's guard frame (min_x, max_y, dx, dy as (hi, lo), size,
# budget): cx = -2 + (x - 8) 2^-300, with a low part of 2^-457 in column 8
# (below the fast path's range: every iteration there takes the reference
# arithmetic); cy = -y 2^-440.  On row 0 (cy = 0) every iteration is
# admitted; on the other rows zy's low parts start below the range and
# rise into it after about 25 iterations
DF_GUARD_SCALARS = [-2.0, -2.0 ** -297, 0.0, 0.0, 2.0 ** -300,
                    2.0 ** -460, 2.0 ** -440, 0.0]
DF_GUARD_SIZE = 16
DF_GUARD_BUDGET = 300
# K13's guard frames: (the splits (mantissa, exponent) of min_x, max_y,
# dx, dy, as ops/hdr_escape.py takes them; width; height), budget.  The
# value form runs where zx, zy, cx and cy are zero or of an exponent in
# [-30, 30] (csrc/escape_hdr.cu).  Frame 0, cx = -1 + x/16, cy = (16 -
# y) 2^-16: in column 16 (cx = +0) rows 15 and 17 (cy = +-2^-16) admit
# z = c and then fall below the window (zx = -cy^2 = -2^-32) in f32 and
# f64; in column 0 (cx = -1) the f64 zx falls to -cy^2 every other
# iteration (f32 rounds 1 - cy^2 to 1: an exact zero, admitted); row 16
# has cy = +0.  Frame 1, cx = 2^-140 - x/4 (column 0 below the window:
# every iteration of it takes the reference arithmetic), cy = -0 - y/2
# (row 0: cy = -0): at c = (2^-140, -1) z reaches (-1, -1) and zx^2 - zy^2
# cancels to an exact 0 with exponent 0, 140 binades above cx, past the
# adds' gap clamp of 126
HDR_GUARD_SCALARS = (
    ({"min_x": (-1.0, 0), "max_y": (1.0, -12), "dx": (1.0, -4),
      "dy": (1.0, -16)}, 32, 24),
    ({"min_x": (1.0, -140), "max_y": (-0.0, 0), "dx": (-1.0, -2),
      "dy": (1.0, -1)}, 4, 4),
)
HDR_GUARD_BUDGET = 300
# K19's guard orbits, synthetic compressed orbits of RC_GUARD_TOTAL
# positions ((anchor positions, x, y, cx low, cy low)), rendered from the
# zero state on a 16² view at 1e4 around -0.75 + 0.1i at this budget.
# Its recurrence runs unflushed where z's and c's components are zero or
# of an exponent in [-450, 500] (csrc/rc_tail.cu): "guard_c" has c low
# about 2^-600 (every recurrence refused), "guard_mix" an admitted c and
# anchors with components below the range (the recurrence from them
# refused, the others admitted)
RC_GUARD_ORBITS = {
    "guard_c": ([0, 40, 41, 90], [0.0, 0.3, 2.0 ** -460, -0.5],
                [0.0, 0.2, 0.0, 2.0 ** -700], 2.0 ** -600, -(2.0 ** -601)),
    "guard_mix": ([0, 7, 30, 31, 77, 150],
                  [0.0, 2.0 ** -500, -1.25, 2.0 ** -460, 0.5, 2.0 ** -449],
                  [0.0, 2.0 ** -520, 0.0, 2.0 ** -455, 2.0 ** -600, 0.25],
                  -1.25, 2.0 ** -440),
}
RC_GUARD_TOTAL, RC_GUARD_SIZE, RC_GUARD_BUDGET = 200, 16, 300
RC_GUARD_VIEW = ("-0.75", "0.1", "1e4")
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
    stats["rc_tail_f64"]["floor_ns"] = floor   # phase 16's K19 floors
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


def load_tool(name: str):
    """tools/<name>.py of this checkout as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pixel_loops():
    """tools/time_pixel_loops.py of this checkout: the K6 and K2 frames of
    the main path and their timing, one measurement for the smoke and the
    tool."""
    return load_tool("time_pixel_loops")


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
    from the View #30 centre at each limb count and at WIDE_SESSION_LIMBS
    (whose times the kernels line keeps: the first forms' time at the
    size K12's grid form now takes); times and bounds."""
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


# exact_trace calls started early in a child process (prefetch_exact_trace)
_PREFETCHED: dict = {}


def prefetch_exact_trace():
    """Start phase 5's 16,384-limb exact trace of View #30's centre (about
    a minute of Python ints) in a child process, so that it runs while the
    earlier phases use the card; ``exact_trace`` takes its result.
    Returns the pool, to be shut down at the end."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    spec = FP.FixedSpec.for_limbs(max(ORBIT_LIMBS))
    cx, cy, _ = view30_center()
    (scx, cxd), (scy, cyd) = (FP.hp_to_digits(v, spec) for v in (cx, cy))
    args = (spec, scx * FP.digits_to_int(cxd), scy * FP.digits_to_int(cyd),
            ORACLE_STEPS, None, True)
    pool = ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"))
    _PREFETCHED[args] = pool.submit(exact_trace, *args)
    return pool


@functools.lru_cache(maxsize=16)
def exact_trace(spec, cx: int, cy: int, steps: int, start=None,
                keep_z: bool = False):
    """The exact recurrence of the device digits, with Python ints: from
    ``start`` = (x, y, dx, dy) (default z = c and dz/dc = 1), ``steps``
    times x' = rhu(x² − y² + cx·2^16F),
    y' = rhu(2xy + cy·2^16F), dx' = rhu(2(x·dx − y·dy) + 2^32F),
    dy' = rhu(2(x·dy + y·dx)), rhu(v) = sign(v + h)·((|v + h| >> 16F) mod
    2^16D); cx, cy signed fixed-point ints.  Returns (x, y, dx, dy) and
    the number of steps where a magnitude of dz/dc wrapped, and with
    ``keep_z`` the states (x, y) before each step."""
    early = _PREFETCHED.pop((spec, cx, cy, steps, start, keep_z), None)
    if early is not None:
        return early.result()
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
    zs = []
    for _ in range(steps):
        if keep_z:
            zs.append((x, y))
        k1 = dx * (x + y)          # x·dx − y·dy = k1 − k3, x·dy + y·dx
        k2 = x * (dy - dx)         # = k1 + k2, three products
        k3 = y * (dx + dy)
        (dx, w1), (dy, w2) = rhu(2 * (k1 - k3) + one), rhu(2 * (k1 + k2))
        (x, _), (y, _) = (rhu((x + y) * (x - y) + (cx << shift)),
                          rhu(2 * x * y + (cy << shift)))
        wraps += w1 or w2
    return (x, y, dx, dy), wraps, tuple(zs) if keep_z else None


def exact_steps(spec, cx: int, cy: int, steps: int, start=None):
    """``exact_trace``'s final state and wraps."""
    return exact_trace(spec, cx, cy, steps, start)[:2]


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
    # the states before each step kept: phase 16 checks the reuse rows of
    # the 16,384-limb chunk against them
    want, wraps, _ = exact_trace(spec, scx * FP.digits_to_int(cxd),
                                 scy * FP.digits_to_int(cyd), steps, None,
                                 True)
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
    WIDE_SESSION_LIMBS (D = 2^16, K12's grid form and neither K4 nor K5),
    against the 16,384-limb session's orbit.  Returns (µs/iter by limbs,
    that session's launches)."""
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
    if not wide["orbit_chunk_grid"] or wide["ntt_orbit"] or \
            wide["orbit_tail"] or wide["orbit_chunk_block"]:
        raise AssertionError(f"{WIDE_SESSION_LIMBS} limbs: not on K12's "
                             f"grid form alone")
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
    forms = [O.chunk_form(spec, values)]
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

    def chunk_bound(n, D, values):
        return bound(2 * values * D * 4 + 2 * D * 4 + (
            12 * 4 * (CHUNK_STEPS + 1) if values == 2 else 32),
            CHUNK_STEPS * chunk_ops(n, values), I32_OPS_PER_S)

    def record(key, limbs, ms, plain_ms, n, D, values):
        st = stats[key]
        st.update(ms=ms, plain_ms=plain_ms, **chunk_bound(n, D, values))
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
            if form == "grid" and limbs >= CHUNK_MAIN[key]:
                # the grid form at 16,384 limbs and at D = 2^16: a chunk's
                # ms, the loop's and the bound, for the log
                stats[key].setdefault("by_limbs", {})[limbs] = dict(
                    ms=ms[form], loop_ms=ms["steps"],
                    **chunk_bound(n, D, 2))

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
            if form == "grid" and limbs >= CHUNK_MAIN[key]:
                # NR's grid form at 16,384 limbs and at D = 2^16
                stats[key].setdefault("by_limbs", {})[limbs] = dict(
                    ms=ms[form], loop_ms=ms["steps"],
                    **chunk_bound(n, D, 4))

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
    """K13: 10 operations an iteration, its value form's (two squares, the
    magnitude's sum and compare, the doubling, the product, the
    difference and two sums), and the escaping step's 4; a lower bound:
    an iteration the window refuses runs the HDR step, about 80."""
    return 10.0 * float(grid.sum()) + 4.0 * float((grid < budget).sum())


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
    """A context in which a call of any render family's plain twin, the
    RC tails' (K3, K19) or K1's raises: a CUDA tensor never reaches
    one."""
    from fractalshark_tpu_torch.ops import (bla_kernel, dblflt, escape,
                                            hdr_df, hdr_escape, perturb,
                                            quadd, quadflt)
    from fractalshark_tpu_torch.ops import perturb_stream as ps
    targets = [(hdr_escape, "escape_hdr_plain"), (dblflt, "escape_df_plain"),
               (bla_kernel, "bla_plain"), (perturb, "perturb_plain"),
               (hdr_df, "perturb_hdr_df_plain"), (quadd, "escape_qd_plain"),
               (quadflt, "escape_qf_plain"), (ps, "rc_tail_plain"),
               (ps, "rc_init_plain"), (escape, "escape_plain")]
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


def k15_twin(fr, st, budget=None):
    """K15 on a frame at `budget` (its full budget when None) through its
    run loop, the default launches and launches of FAMILY_CHUNK steps
    over the live pixels, against the twin in one lockstep run: the grids
    and the per-pixel tally of BLA and single steps.  Returns (the twin's
    grid, its ms, K15's tally)."""
    import torch

    n = budget or fr.n
    tally = torch.zeros((fr.size * fr.size, 2), dtype=torch.int64,
                        device=fr.orbit.device)
    k = fr.run(n, None, tally)
    want_tally = torch.zeros_like(tally)
    pl, pms = timed(lambda: fr.plain(n, want_tally), fr.orbit.device,
                    warm=False)
    compare(f"{fr.key} {fr.name} budget {n} (its run loop)", k, pl, st)
    compare(f"{fr.key} {fr.name} budget {n} (launches of {FAMILY_CHUNK} "
            f"steps over the live pixels)", fr.run(n, FAMILY_CHUNK), pl,
            st)
    compare(f"{fr.key} {fr.name} steps (BLA, single) a pixel", tally,
            want_tally, st)
    return pl, pms, tally


def hold_pin(label, got, pin) -> None:
    """Hold a kernel's (iter_sum, CRC-32) to its pin."""
    log(f"  {label}: (iter_sum, crc32) {got}, the pin {pin}")
    if got != pin:
        raise AssertionError(f"{label}: {got} != the pin {pin}")


def k15_pin(name, rec):
    """Hold a timed K15 frame to its pin in K15_TIMED_PINS."""
    hold_pin(name, (rec["iter_sum"], rec["crc32"]), K15_TIMED_PINS[name])


def phase_families(device, stats):
    """The render families the port took last: K13 and K14 (every
    instance) on the shallow frame at 1024², K15 (f32, f64) and K6's glitch
    instance on the 1e8 frame at 1024² x 1,500, each against its twin (K15
    at 512²) and timed; K14 2x64 and K13 on their guard frames; K13 at View #6's and
    View #8's centres; K15 (f32, f64) on View #6 (its twin at 128² and
    VIEW6_BLA_TWIN_BUDGET, timed at 256² at the preset budget), its
    deepest pixel alone; the Scaled repair pass on a poisoned
    orbit, and the glitch instance with the bad flag at two more
    positions; then the nine 256² frames through the CLI (counts from 0,
    the twins forbidden), pinned to the JAX package's values."""
    import numpy as np
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.engine.reforbit import RefOrbitCalc
    from fractalshark_tpu_torch.ops import dblflt, hdr_escape, perturb, scaled
    from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex
    from fractalshark_tpu_torch.ops.tables import orbit_on

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
            if entry == "escape_2x64":
                # the guard frame: iterations on and off the exact fast path
                g, n = DF_GUARD_SIZE, DF_GUARD_BUDGET
                compare(f"{entry} guard frame {g}² x{n}",
                        dblflt.escape_df_kernel(DF_GUARD_SCALARS, g, g, n,
                                                torch.float64, device),
                        dblflt.escape_df_plain(DF_GUARD_SCALARS, g, g, n,
                                               torch.float64, device), st)
            if fr.kern == "k13":
                # the guard frames: iterations in and out of the value form
                for i, (p, w, h) in enumerate(HDR_GUARD_SCALARS):
                    n = HDR_GUARD_BUDGET
                    compare(f"{entry} guard frame {i} {w}x{h} x{n}",
                            hdr_escape.escape_hdr_kernel(p, w, h, n,
                                                         fr.dtype, device),
                            hdr_escape.escape_hdr_plain(p, w, h, n,
                                                        fr.dtype, device),
                            st)
            out, rec = tpl.time_frame(fr, 3)
            ops = (hdr_escape_ops if fr.kern == "k13" else df_escape_ops)(
                out, fr.n)
            b = bound(nbytes(out), ops, rate)
        elif fr.kern == "k15":
            # the twin on the same frame at 512² (at 1024² it took 13-18
            # s a type); the 1024² frame timed, its bound from K15's own
            # tally there
            tw = tpl.setup(name.replace("_1024", "_512"), device)
            pl, pms, _ = k15_twin(tw, st)
            tally = torch.zeros((fr.size * fr.size, 2), dtype=torch.int64,
                                device=device)
            fr.run(None, None, tally)
            out, rec = tpl.time_frame(fr, 3)
            t = tally.sum(dim=0).tolist()
            log(f"    steps: {t[0]} BLA, {t[1]} single, for "
                f"{int(out.sum())} iterations")
            rows = fr.orbit[:int(out.max()) + 2]
            b = bound(nbytes(rows, fr.T.probe, fr.T.bound, fr.T.steps,
                             *fr.dc, out), bla_ops(tally), rate)
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
        if fr.kern == "k15":
            k15_pin(name, rec)
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

    # K15 on View #6, both mantissa types: held to the twin at 128² and
    # the cut budget (the twin runs every pixel in lockstep to the deepest
    # one's ~1,600 steps there, ~6,200 at the preset's), then timed at
    # 256² at the preset's budget with the deepest pixel run alone, the
    # bound from K15's own tally there
    for name, entry in VIEW6_BLA_FRAMES:
        fr = tpl.setup(name, device)
        k15_twin(tpl.setup(name.replace("_256", "_128"), device),
                 stats[entry], VIEW6_BLA_TWIN_BUDGET)
        tally = torch.zeros((fr.size * fr.size, 2), dtype=torch.int64,
                            device=device)
        fr.run(None, None, tally)
        out, rec = tpl.time_frame(fr, 1)
        t = tally.sum(dim=0).tolist()
        floor = tpl.bla_floor(fr, 1)
        log(f"  {entry} {name} budget {fr.n}: {rec['ms_median']:.3f} ms "
            f"(of {[round(x, 3) for x in rec['ms']]}), "
            f"{sum(rec['launches'].values())} launches over "
            f"{rec['work'][:4]} pixels, (iter_sum, crc32) "
            f"{(rec['iter_sum'], rec['crc32'])}; steps {t[0]} BLA, {t[1]} "
            f"single; serial floor {json.dumps(floor)}")
        k15_pin(name, rec)
        bound(nbytes(fr.orbit, fr.T.probe, fr.T.bound, fr.T.steps, *fr.dc,
                     out), bla_ops(tally),
              F64_OPS_PER_S if fr.dtype == torch.float64 else F32_OPS_PER_S)

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
    # the glitch kernel's first-bad index with the flag at two more
    # positions, in one launch and in launches of FAMILY_CHUNK steps over
    # the live pixels, against the twin's bad[] in one lockstep run
    orbit = orbit_on(res, device, torch.float32)
    dc = perturb._dc_grids_float(*perturb.delta_params(
        ptz, res.center_x, res.center_y, size, size), size, size, device,
        torch.float32)
    flat = HDRComplex(*(t.reshape(-1) for t in dc))
    mr = res.max_ref_iteration()
    for pos in (1, mr // 2):
        bad = torch.zeros(res.device_orbit(np.float64)[0].size,
                          dtype=torch.bool)
        bad[pos] = True
        zero = perturb.init_state_plain(flat, n, False)
        pl = perturb.perturb_plain(orbit, flat,
                                   zero + (torch.zeros_like(zero[5]),), n,
                                   mr, False, bad=bad.to(device))
        for chunk in (0, FAMILY_CHUNK):
            k = perturb.run_state(orbit, dc, n, mr, False, "perturb_scaled",
                                  chunk, bad=bad)
            for i, what in ((4, "iterations"), (6, "glitch flags")):
                compare(f"perturb_scaled poisoned orbit {size}² x{n}, bad at "
                        f"{pos} only, chunk {chunk} {what}", k[i], pl[i],
                        stats["perturb_scaled"])

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


def shallow_ptz(size: int):
    """The shallow frame (FAMILY_SHALLOW) at size²."""
    from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
    a = FAMILY_SHALLOW
    return PointZoomBBConverter(pt_x=a[1], pt_y=a[3], zoom_factor=a[5],
                                prec=256).square_aspect_ratio(size, size)


def take_late_pins(device="cuda") -> dict:
    """The pins HDR_DF_PIN and QF_SHALLOW_PIN, taken once outside the
    smoke: K16 on HDR_DF_TWIN_FRAME at its budget of 1,500 (launches of
    FAMILY_CHUNK steps, and the default launches) and K18 4x64 on the
    shallow frame at 256², each against its twin at that depth; the
    (iter_sum, CRC-32) pins are printed only where the two agree bit for
    bit.  Run: python3 -c "import chip_smoke as c; c.take_late_pins()"."""
    import torch

    from fractalshark_tpu_torch.ops import quadflt
    device = torch.device(device)
    phase_build()
    st, pins = {}, {}
    fr = pixel_loops().setup(HDR_DF_TWIN_FRAME, device)
    n = HDR_DF_PIN[0]
    k = fr.run(n, FAMILY_CHUNK)
    pl, pms = timed(lambda: fr.plain(n), device, warm=False)
    compare(f"perturb_hdr_df {fr.name} budget {n} (launches of "
            f"{FAMILY_CHUNK} steps)", k, pl, st)
    compare(f"perturb_hdr_df {fr.name} budget {n} (default launches)",
            fr.run(n), pl, st)
    pins["HDR_DF_PIN"] = (n, crc_pin(k))
    log(f"  twin {pms:.1f} ms")
    s, n = QF_SHALLOW_PIN[0], int(FAMILY_SHALLOW[-1])
    scal = quadflt.qf_params(shallow_ptz(s), s, s, "4x64")
    k = quadflt.escape_qf_kernel(scal, s, s, n, torch.float64, device)
    pl, pms = timed(lambda: quadflt.escape_qf_plain(
        scal, s, s, n, torch.float64, device), device, warm=False)
    compare(f"escape_qf64 shallow frame {s}² x{n}", k, pl, st)
    pins["QF_SHALLOW_PIN"] = (s, crc_pin(k))
    log(f"  twin {pms:.1f} ms")
    log("late pins: " + json.dumps(pins))
    return pins


def phase_late(device, stats):
    """The last render families: K16 against its twin on the 1e8 frame at
    64² at HDR_DF_TWIN_BUDGET (launches of FAMILY_CHUNK steps over the
    live pixels), then timed
    on View #9 at 1024² × 40,000; K17 and K18 (both component types)
    against their twins at 256² on the 1e17 frame (QUAD_TWIN_BUDGET) and
    on the antenna frame, then timed at 1024² × 600 on the 1e17 frame;
    K17 4x64 and K18 4x64 against their twins on their guard frames
    (QUAD_GUARD_SCALARS, QF_GUARD_SCALARS), K18 4x64 also on the shallow
    frame at 64²; K16 at budget 1,500 and K18 4x64 on the shallow frame at
    256² held to their pins (HDR_DF_PIN, QF_SHALLOW_PIN); then escape_qf
    through its public entry and the
    LATE_PINS frames
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
    n = HDR_DF_TWIN_BUDGET
    k = fr.run(n, FAMILY_CHUNK)
    pl, pms = timed(lambda: fr.plain(n), device, warm=False)
    compare(f"perturb_hdr_df {fr.name} budget {n} (launches of "
            f"{FAMILY_CHUNK} steps over the live pixels)", k, pl, st)
    n, pin = HDR_DF_PIN
    hold_pin(f"perturb_hdr_df {fr.name} budget {n}",
             crc_pin(fr.run(n, FAMILY_CHUNK)), pin)
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
        if variant == "4x64":
            # the guard frame: iterations on and off the exact fast path
            # (the twin on the CPU: at 16² the card's launches cost more
            # than the work)
            scal, g, n = ((QF_GUARD_SCALARS, QF_GUARD_SIZE, QF_GUARD_BUDGET)
                          if qf else (QUAD_GUARD_SCALARS, QUAD_GUARD_SIZE,
                                      QUAD_GUARD_BUDGET))
            compare(f"{entry} guard frame {g}² x{n}",
                    getattr(mod, f"escape_{kind}_kernel")(scal, g, g, n, dt,
                                                          device),
                    getattr(mod, f"escape_{kind}_plain")(scal, g, g, n, dt,
                                                         "cpu"), st)
        if entry == "escape_qf64":
            # a frame whose counts differ (the 1e17 frame's do not)
            s, n = QF_SHALLOW_SIZE, int(FAMILY_SHALLOW[-1])
            scal = quadflt.qf_params(shallow_ptz(s), s, s, variant)
            compare(f"{entry} shallow frame {s}² x{n}",
                    quadflt.escape_qf_kernel(scal, s, s, n, dt, device),
                    quadflt.escape_qf_plain(scal, s, s, n, dt, device), st)
            s, pin = QF_SHALLOW_PIN
            scal = quadflt.qf_params(shallow_ptz(s), s, s, variant)
            hold_pin(f"{entry} shallow frame {s}² x{n}", crc_pin(
                quadflt.escape_qf_kernel(scal, s, s, n, dt, device)), pin)
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


# phase 16: K19's frames (tools/time_pixel_loops.py FRAMES), K3's twins
# of them, and the CLI frame of the gather route
K19_FRAMES = (("view6_rc_256_k19", "view6_rc_256"),
              ("view6_rc_po_16_k19", "view6_rc_po_16"))
GATHER_CLI = ["--view", "6", "--render-algorithm", "GpuHDRx32PerturbedRCLAv2",
              "--width", "256", "--height", "256", "--stats", "--device",
              "cuda"]
# the f64 recurrence of a K19 step between anchors: 7 f64 operations
# (3 products, 2 adds, the doubling), each worth two f32 ones at the
# card's rates
K19_RECUR_F32_OPS = 7 * F32_OPS_PER_S / F64_OPS_PER_S
REUSE_FRAC_BITS = 1000       # the View #30 session's reuse copy
AUTH = dict(cx="-0.743643887037158704752191506114774",
            cy="0.131825904205311970493132056385139", prec=768, n=600)
APP_SIZE, APP_BANDS = 1024, 128


def k19_ops(grid, start, budget: int, ratio: float) -> float:
    """K19: the HDR step of each tail iteration (perturb_tail_ops), plus
    the f64 recurrence at each step that does not land on an anchor,
    1 - 1/ratio of them for an orbit compressed `ratio` to 1 (a lower
    bound: the catch-up is not counted), in f32 operations."""
    import torch
    live = start < budget
    steps = float(torch.where(live, grid - start, 0).sum())
    return perturb_tail_ops(grid, start, budget) + \
        K19_RECUR_F32_OPS * steps * (1.0 - 1.0 / ratio)


def rc_guard_orbit(kind, C):
    """The RC_GUARD_ORBITS orbit `kind` as the CompressedOrbit class C."""
    import numpy as np
    idx, x, y, cx, cy = RC_GUARD_ORBITS[kind]
    return C(np.asarray(x), np.asarray(y), np.asarray(idx, np.int64),
             RC_GUARD_TOTAL, cx, cy, 0)


def rc_guard_view(HP, PTZ):
    """(ptz, centre x, centre y) of the guard orbits' view, from the
    HighPrecision and PointZoomBBConverter classes given."""
    x, y, zoom = RC_GUARD_VIEW
    ptz = PTZ(pt_x=x, pt_y=y, zoom_factor=zoom, prec=256).\
        square_aspect_ratio(RC_GUARD_SIZE, RC_GUARD_SIZE)
    return ptz, HP(x, prec=256), HP(y, prec=256)


def phase_app_guard(device, st):
    """K19 against its twin on the guard orbits from the zero state, in
    one launch and in launches of 7 steps over the live pixels."""
    import torch

    from fractalshark_tpu_torch.core.highprecision import HighPrecision
    from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
    from fractalshark_tpu_torch.engine.perturbation_results import (
        CompressedOrbit)
    from fractalshark_tpu_torch.ops import hdrfloat as hdr
    from fractalshark_tpu_torch.ops import perturb, rc_tail
    from fractalshark_tpu_torch.ops import perturb_stream as ps
    from fractalshark_tpu_torch.ops.tables import anchor_table_f64

    ptz, cx, cy = rc_guard_view(HighPrecision, PointZoomBBConverter)
    g, n = RC_GUARD_SIZE, RC_GUARD_BUDGET
    dc = perturb._dc_grids_hdr(*perturb.delta_params(ptz, cx, cy, g, g), g,
                               g, device)
    dz = hdr.complex_zero((g, g), device=device)
    z = torch.zeros((g, g), dtype=torch.int64, device=device)
    init = {"dzr": dz.re, "dzi": dz.im, "dze": dz.e, "it": z, "jwait": z,
            "done": z.bool()}
    for kind in RC_GUARD_ORBITS:
        comp = rc_guard_orbit(kind, CompressedOrbit)
        A = anchor_table_f64(comp, device)
        z_mr = ps.wrap_value(comp, A.max_ref)
        want = rc_tail.rc_tail_gather_plain(A, dc, init, n, z_mr)
        for chunk in (None, 7):
            compare(f"rc_tail_f64 guard orbit {kind} {g}² x{n} (chunk "
                    f"{chunk})", ps.rc_tail_run(A, dc, init, n, z_mr, chunk),
                    want, st)


def phase_app_gather(device, stats, tpl):
    """(a) K19 against its twin bit for bit at the cut budget in chunks
    over the live pixels, timed at the full budget beside K3 on the same
    start (the flips between the two counted) and its init launch timed
    apart, then on the guard orbits, then the gather route through the
    CLI: K19 launches and K3 does not, and the frame is the JAX package's
    f64 gather's."""
    import torch

    from fractalshark_tpu_torch import kernels

    st = stats["rc_tail_f64"]
    for name, k3_name in K19_FRAMES:
        fr = tpl.setup(name, device)
        budget = TWIN_BUDGET if fr.mode[1] else PO_TWIN_BUDGET
        nc = min(fr.n, budget)
        kc = fr.run(nc, TWIN_CHUNK)
        pl, pms = timed(lambda: fr.plain(nc), device, warm=False)
        compare(f"rc_tail_f64 {name} budget {nc} (chunks of {TWIN_CHUNK} "
                f"over the live pixels)", kc.reshape(-1), pl.reshape(-1), st)
        out, rec = tpl.time_frame(fr, 1 if fr.size < 64 else 3)
        init_ms = tpl.time_init(fr, 3)
        k3 = tpl.setup(k3_name, device)
        out3, rec3 = tpl.time_frame(k3, 1 if fr.size < 64 else 3)
        flips = int((out != out3).sum())
        ratio = fr.comp.compression_ratio()
        steps = int((out - fr.start).max()) + 1
        floor = {k: steps * st["floor_ns"][k] / 1e6
                 for k in ("k19_hit", "k19_f64")}
        b = bound(nbytes(fr.A.rows, *fr.dc, fr.start, out),
                  k19_ops(out, fr.start, fr.n, ratio), F32_OPS_PER_S)
        log(f"  rc_tail_f64 {name} budget {fr.n}: {rec['ms_median']:.3f} ms "
            f"(of {[round(t, 3) for t in rec['ms']]}), launches "
            f"{rec['launches']} over {rec['work'][:4]} pixels, (iter_sum, "
            f"crc32) {(rec['iter_sum'], rec['crc32'])}; K3 (df32) "
            f"{rec3['ms_median']:.3f} ms, (iter_sum, crc32) "
            f"{(rec3['iter_sum'], rec3['crc32'])}; {flips} of "
            f"{out.numel()} pixels differ from K3 (last-ulp flips, "
            f"rc_tail.py:41-44); plain {pms:.3f} ms at budget {nc}; "
            f"ratio {ratio:.1f}, {rec['ms_median'] / b['bound_ms']:.1f}x "
            f"its bound; the init launch (with one step) {init_ms:.3f} ms, "
            f"{init_ms / rec['ms_median']:.1%} of the frame; the deepest "
            f"pixel's {steps} steps at K19's serial floor "
            f"{floor['k19_hit']:.3f} ms (an anchor every step) / "
            f"{floor['k19_f64']:.3f} ms (the recurrence every step)")
        if rec["launches"].get("rc_tail_f64", 0) < 1 or \
                rec["launches"].get("rc_tail", 0):
            raise AssertionError(f"{name}: not K19 alone")
        if name == K19_FRAMES[0][0]:
            st.update(ms=rec["ms_median"], plain_ms=pms, **b)
    phase_app_guard(device, st)
    kernels.reset_counts()
    os.environ["FRACTALSHARK_RC_TAIL"] = "gather"
    try:
        with forbid_twins():
            s, wall = cli_run(GATHER_CLI)
    finally:
        del os.environ["FRACTALSHARK_RC_TAIL"]
    grew = {k: v for k, v in kernels.launches.items() if v}
    log(f"  CLI View #6 GpuHDRx32PerturbedRCLAv2 256² with "
        f"FRACTALSHARK_RC_TAIL=gather: (iter_sum, crc32) "
        f"{(s['iter_sum'], s['crc32'])}, wall {wall:.3f} s, launches {grew}")
    if grew.get("rc_tail_f64", 0) < 1 or grew.get("rc_tail", 0):
        raise AssertionError("the gather route did not take K19 alone")
    pin = VIEW6_RC_256_GATHER["f64"]
    if (s["iter_sum"], s["crc32"]) != pin:
        raise AssertionError(f"the gather route's View #6 RC 256²: "
                             f"{(s['iter_sum'], s['crc32'])} != {pin}, the "
                             f"JAX package's f64 gather")
    return {"rc_tail_f64": grew["rc_tail_f64"]}


def phase_app_reuse(device):
    """(b) The device orbit with reuse: the 1e60 authority of
    tests/test_reuse.py:195 on the card (K12's block form), its reuse copy
    equal to the CPU twins' session int for int, and the 1e62 view it
    serves against a direct device orbit; then View #30 at 16,384 limbs,
    ORACLE_STEPS steps in one chunk (K12's grid form) with reuse rows,
    each row equal to the exact Python-int state's truncation."""
    import numpy as np
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.core.highprecision import HighPrecision
    from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
    from fractalshark_tpu_torch.engine.reforbit import RefOrbitCalc
    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    from fractalshark_tpu_torch.ops.bignum import orbit as O

    prec = AUTH["prec"]
    v1 = PointZoomBBConverter(pt_x=AUTH["cx"], pt_y=AUTH["cy"],
                              zoom_factor="1e60", prec=prec)
    v2 = PointZoomBBConverter(
        pt_x=HighPrecision(AUTH["cx"], prec=prec) + HighPrecision(
            "1e-55", prec=prec), pt_y=AUTH["cy"], zoom_factor="1e62",
        prec=prec)
    ros = {}
    for dev in ("cuda", "cpu"):
        calc = RefOrbitCalc(orbit_backend="device", reuse_mode="on")
        calc.device = dev
        kernels.reset_counts()
        r1 = calc.get_and_create_useful_results(v1, AUTH["n"])
        ros[dev] = r1.extra["reuse_orbit"]
        if dev == "cuda":
            block = kernels.launches["orbit_chunk_block"]
            r2 = calc.get_and_create_useful_results(v2, AUTH["n"])
            reused = calc.last_details.get("reused")
    direct = RefOrbitCalc(orbit_backend="device", reuse_mode="off")
    direct.device = "cuda"
    r3 = direct.get_and_create_useful_results(v2, AUTH["n"])
    same = ros["cuda"].zx == ros["cpu"].zx and ros["cuda"].zy == ros["cpu"].zy
    n = min(r2.count_orbit_entries(), r3.count_orbit_entries())
    err = max(float(np.abs(r2.orbit_x[:n] - r3.orbit_x[:n]).max()),
              float(np.abs(r2.orbit_y[:n] - r3.orbit_y[:n]).max()))
    log(f"  reuse authority 1e60 ({r1.count_orbit_entries()} entries, "
        f"{ros['cuda'].frac_bits} fraction bits, K12 block launches "
        f"{block}): reuse copy {'equal' if same else 'DIFFERENT'} to the CPU "
        f"twins'; the 1e62 view reused {reused}, {n} entries within "
        f"{err:.3g} of the direct device orbit")
    if not (same and reused and n > 100 and err <= 1e-13 and block):
        raise AssertionError("the device orbit's reuse path failed")

    spec = FP.FixedSpec.for_limbs(16384)
    cx, cy, _ = view30_center()
    scx, cxd = FP.hp_to_digits(cx, spec)
    scy, cyd = FP.hp_to_digits(cy, spec)
    R = min(-(-REUSE_FRAC_BITS // 16) + FP.INT_DIGITS, spec.digits)
    state = O.OrbitState(scx, cxd, scy, cyd, device)
    kernels.reset_counts()
    _, reuse = O.orbit_chunk(state, scx, torch.from_numpy(
        cxd.astype("int32")).to(device), scy, torch.from_numpy(
        cyd.astype("int32")).to(device), spec, ORACLE_STEPS,
        reuse_digits=R)
    grid = kernels.launches["orbit_chunk_grid"]
    reuse = reuse.cpu().numpy()
    shift = 16 * (spec.digits - R)
    bad = 0
    # (phase 5's exact trace of this chunk, cached)
    for k, (x, y) in enumerate(exact_trace(
            spec, scx * FP.digits_to_int(cxd), scy * FP.digits_to_int(cyd),
            ORACLE_STEPS, None, True)[2]):
        for v, part, sg in ((x, reuse[k, :R], reuse[k, 2 * R]),
                            (y, reuse[k, R:2 * R], reuse[k, 2 * R + 1])):
            m = FP.digits_to_int(part.astype(np.uint32))
            bad += int(sg) * m != (abs(v) >> shift) * (1 if v >= 0 else -1)
    log(f"  View #30 16,384 limbs, {ORACLE_STEPS} steps, R = {R}: {bad} "
        f"reuse rows differ from the exact truncation; K12 grid launches "
        f"{grid}")
    if bad or grid != 1:
        raise AssertionError("View #30's reuse rows differ")
    # K12's chunk with and without the reuse rows (CUDA events, the state
    # carried on), in turns
    for limbs in (64, 16384):
        spec = FP.FixedSpec.for_limbs(limbs)
        scx, cxd = FP.hp_to_digits(cx, spec)
        scy, cyd = FP.hp_to_digits(cy, spec)
        cxt = torch.from_numpy(cxd.astype("int32")).to(device)
        cyt = torch.from_numpy(cyd.astype("int32")).to(device)
        state = O.OrbitState(scx, cxd, scy, cyd, device)
        scratch = O._Scratch(spec, device)
        R = min(-(-REUSE_FRAC_BITS // 16) + FP.INT_DIGITS, spec.digits)
        ms = {0: [], R: []}
        for r in (0, R, R, 0):
            ms[r].append(timed(lambda: O.orbit_chunk(
                state, scx, cxt, scy, cyt, spec, ORACLE_STEPS, scratch, r),
                device)[1] / ORACLE_STEPS * 1e3)
        log(f"  K12 {O.chunk_form(spec)} form, {limbs} limbs: "
            f"{[round(v, 3) for v in ms[R]]} us a step with {R} reuse "
            f"digits, {[round(v, 3) for v in ms[0]]} without")


def phase_app_surface(device, outdir):
    """(c) The app surface on the card: a two-worker pool, three Max
    autozoom steps, the render server and the tray's poster mode, each
    with the launch counts from 0 just before it."""
    import threading

    import numpy as np

    from fractalshark_tpu_torch import cli, kernels, server, tray
    from fractalshark_tpu_torch.engine.autozoom import (AutoZoomer,
                                                        AutoZoomHeuristic)
    from fractalshark_tpu_torch.engine.fractal import Fractal
    from fractalshark_tpu_torch.engine.render_pool import RenderThreadPool
    from fractalshark_tpu_torch.io.saved_location import load_locations
    from fractalshark_tpu_torch.ops import escape
    from fractalshark_tpu_torch.ops.coloring import rgba16_to_numpy
    from fractalshark_tpu_torch.parallel.tile_farm import TileFarm

    # the pool: two workers, two non-supersedable View 0 jobs
    f = Fractal(width=APP_SIZE, height=APP_SIZE, view=0, device=device)
    one = rgba16_to_numpy(Fractal(width=APP_SIZE, height=APP_SIZE, view=0,
                                  device=device).render())
    kernels.reset_counts()
    pool = RenderThreadPool(f, num_workers=2, progressive_scales=(4, 1))
    try:
        gens = [pool.enqueue_render(supersedable=False) for _ in range(2)]
        for g in gens:
            if not pool.wait(g, timeout=120):
                raise AssertionError("pool job timed out")
        finals = []
        while True:
            fr = pool.next_frame(timeout=2)
            if fr is None:
                break
            if fr.final:
                finals.append(fr)
    finally:
        pool.shutdown()
    ok = len(finals) == 2 and all(np.array_equal(x.rgba, one)
                                  for x in finals)
    log(f"  pool (2 workers, passes (4, 1)) View 0 {APP_SIZE}²: {len(finals)} "
        f"final frames {'equal' if ok else 'NOT equal'} to a one-shot "
        f"render; launches {dict((k, v) for k, v in kernels.launches.items() if v)}")
    if not ok or kernels.launches["escape"] < 4:
        raise AssertionError("the pool's frames differ or K1 did not run")

    # autozoom: three Max steps, the targets against the CPU twins' path
    paths = {}
    for dev in (device, "cpu"):
        g = Fractal(width=256, height=256, view=0, algorithm="Gpu1x32",
                    device=dev)
        z = AutoZoomer(g, AutoZoomHeuristic.MAX)
        kernels.reset_counts()
        paths[str(dev)] = [(z.step()["target"], g.ptz.pt_x.to_string(30),
                            g.ptz.pt_y.to_string(30)) for _ in range(3)]
        if dev == device:
            zoom_launches = kernels.launches["escape"]
    ok = paths[str(device)] == paths["cpu"]
    log(f"  autozoom Max x3 View 0 256²: targets "
        f"{[p[0] for p in paths[str(device)]]} "
        f"{'equal' if ok else 'NOT equal'} to the CPU twins'; K1 launches "
        f"{zoom_launches}")
    if not ok or zoom_launches < 3:
        raise AssertionError("autozoom's path differs on the card")

    # the render server, in a thread, over a unix socket
    sock = os.path.join(outdir, "fs.sock")
    rs = server.RenderServer(sock)
    ready = threading.Event()
    t = threading.Thread(target=rs.serve_forever, daemon=True,
                         kwargs={"ready_cb": lambda _s: ready.set()})
    t.start()
    if not ready.wait(30):
        raise AssertionError("the server did not start")
    argv = ["--view", "6", "--width", "256", "--height", "256", "--stats",
            "--device", "cuda"]
    replies, lens = [], []
    try:
        kernels.reset_counts()
        for k in range(2):
            replies.append(server.request(
                {"argv": argv + ["--output-png",
                                 os.path.join(outdir, f"srv{k}.png")]},
                sock, timeout=300))
            lens.append(server.request({"op": "stats"}, sock,
                                       timeout=30)["orbit_cache_len"])
        srv_launches = {k: v for k, v in kernels.launches.items() if v}
    finally:
        server.request({"op": "shutdown"}, sock, timeout=30)
        t.join(timeout=30)
    # a direct render in this process, on the server's orbit cache (the
    # orbit's host time once)
    with contextlib.redirect_stdout(io.StringIO()):
        if cli.main(argv + ["--output-png", os.path.join(outdir,
                                                         "direct.png")],
                    orbit_calc=rs.orbit_calc) != 0:
            raise AssertionError("the direct CLI render failed")
    pngs = [open(os.path.join(outdir, n), "rb").read()
            for n in ("srv0.png", "srv1.png", "direct.png")]
    hit = [json.loads(r["stdout"].strip().splitlines()[-1]).get(
        "orbit_len") for r in replies]
    ok = all(r["rc"] == 0 for r in replies) and lens[0] == lens[1] >= 1 \
        and pngs[0] == pngs[1] == pngs[2] and not t.is_alive()
    log(f"  server: View #6 256² twice, rc {[r['rc'] for r in replies]}, "
        f"walls {[r['wall_s'] for r in replies]} s, orbit cache "
        f"{lens}, orbit_len {hit}, PNGs {'equal' if ok else 'NOT equal'} to "
        f"a direct CLI render; launches {srv_launches}")
    if not ok:
        raise AssertionError("the server's renders failed or differ: "
                             f"{[r['stderr'][-500:] for r in replies]}")

    # the tray's poster mode: View 0 in bands, K1 f64, then resumed
    v = Fractal(width=APP_SIZE, height=APP_SIZE, view=0, device=device)
    loc = os.path.join(outdir, "poster.txt")
    with open(loc, "w") as fh:
        fh.write(f"{APP_SIZE} {APP_SIZE} {v.ptz.min_x.to_string(40)} "
                 f"{v.ptz.min_y.to_string(40)} {v.ptz.max_x.to_string(40)} "
                 f"{v.ptz.max_y.to_string(40)} {v.num_iterations} 1 "
                 f"view0\n")
    out = os.path.join(outdir, "tray")
    tiles = APP_SIZE // APP_BANDS
    # the view as the tray reads it back from the file
    tray_f = Fractal(width=APP_SIZE, height=APP_SIZE,
                     view=load_locations(loc)[0].to_view(), device=device)
    runs = []
    for k in range(2):
        kernels.reset_counts()
        with forbid_twins():
            if tray.main([loc, "--out-dir", out, "--tile-rows",
                          str(APP_BANDS), "--device", "cuda"]) != 0:
                raise AssertionError("tray exited non-zero")
        png = [n for n in os.listdir(out) if n.endswith(".png")]
        ck = os.path.join(out, "tiles_000")
        farm = TileFarm(tray_f.ptz, APP_SIZE, APP_SIZE, APP_BANDS, ck)
        runs.append((open(os.path.join(out, png[0]), "rb").read(),
                     farm.gather_local(), kernels.launches["escape"]))
        if k == 0:
            for tl in farm.tiles[::2]:
                os.remove(farm._tile_path(tl))
    p = escape.PlainParams.from_view(tray_f.ptz, APP_SIZE, APP_SIZE)
    whole = escape.escape(p, APP_SIZE, APP_SIZE, v.num_iterations, "f64",
                          device).cpu().numpy()
    ok = runs[0][0] == runs[1][0] and np.array_equal(runs[0][1], runs[1][1]) \
        and np.array_equal(runs[0][1].astype(np.int64), whole) \
        and (runs[0][2], runs[1][2]) == (tiles, tiles - tiles // 2)
    log(f"  tray poster View 0 {APP_SIZE}² in {APP_BANDS}-row bands: "
        f"{'equal' if ok else 'NOT equal'} to K1 f64's whole frame, resumed "
        f"with half the tiles deleted to the same PNG; K1 launches "
        f"{runs[0][2]}, then {runs[1][2]}")
    if not ok:
        raise AssertionError("the tray's poster differs")


def phase_app(device, stats):
    """(16) The gather tail (K19), the device orbit's reuse digits, and the
    app surface: pool, autozoom, server and tray on the card."""
    log("[16] K19 (the gather tail's f64 cursor) vs its twin and K3, the "
        "gather CLI route, the device orbit's reuse digits, then the "
        "pool, autozoom, server and tray on the card")
    launches = phase_app_gather(device, stats, pixel_loops())
    phase_app_reuse(device)
    with tempfile.TemporaryDirectory() as outdir:
        phase_app_surface(device, outdir)
    return launches


# ------------------------------------------------------- phase 17: parallel
# The sharded paths (parallel/), each over a torch.distributed mesh of
# worker processes (this script with --parallel-rank): M = 4 ranks and, on
# a subgroup of ranks 0 and 1, M = 2, all on cuda:0 with a gloo group on
# CUDA tensors (NCCL refuses two ranks on one card; gloo stages each
# collective through host memory, so these times are no NCCL scaling);
# with two cards or more also an NCCL group, one rank a card.
PAR_NTT = (8192, 65536)
PAR_LIMBS = 16384
PAR_STEPS = 256
PAR_ESCAPE = (0, 512, 256)          # View 0 at 512², budget 256 (K1, f64)
PAR_PO, PAR_RC_PO = 64, 16          # View #6 PO (K6) and RC PO (K3) sizes
PAR_REPS = 5
PAR_TIMED_STEPS = 64                # the sharded step's timed chunk
K20_MESHES = (1, 2, 4, 8)            # K20's blocks held to their twins
K20_GRAPH_LAUNCHES = 256             # launches a CUDA graph, device time
PAR_WAIT_STEPS = 4                   # the steps whose host waits count


def par_inputs(device):
    """The one-device references of the parallel phase, on this card:
    View #30's 256-step orbit at 16,384 limbs (K12) and K12's time a step,
    the View 0 escape at 512² and its min, max and sum, View #6 HDR and
    PO at 64² (K6) and RC PO 16² (K3, pinned to ``VIEW6_RC_PO_16``), and
    ``multiply_3way``'s time at 16,384 limbs; with View #6's orbit, its
    compressed orbit and view for the workers."""
    import pickle

    import numpy as np
    import torch

    from fractalshark_tpu_torch.engine.perturbation_results import (
        CompressedOrbit)
    from fractalshark_tpu_torch.ops import escape, perturb
    from fractalshark_tpu_torch.ops import perturb_stream as PS
    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    from fractalshark_tpu_torch.ops.bignum import orbit as O

    cx, cy, rad = view30_center()
    res = O.compute_reference_orbit_device(
        cx, cy, PAR_STEPS, rad, limbs32=PAR_LIMBS, periodicity=False,
        chunk_steps=PAR_STEPS, device=device)
    spec = FP.FixedSpec.for_limbs(PAR_LIMBS)
    scx, cxd = FP.hp_to_digits(cx, spec)
    scy, cyd = FP.hp_to_digits(cy, spec)
    state = O.OrbitState(scx, cxd, scy, cyd, device)
    cxt, cyt = state.x.clone(), state.y.clone()
    O.orbit_chunk(state, scx, cxt, scy, cyt, spec, PAR_STEPS)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    O.orbit_chunk(state, scx, cxt, scy, cyt, spec, PAR_STEPS)
    torch.cuda.synchronize(device)
    k12_us = (time.perf_counter() - t0) / PAR_STEPS * 1e6
    a, b = (np.random.default_rng(s).integers(0, 1 << 16, spec.digits)
            for s in (0, 1))
    FP.multiply_3way(a, b, spec, device)
    times = []
    for _ in range(PAR_REPS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        FP.multiply_3way(a, b, spec, device)
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    view, size, n = PAR_ESCAPE
    from fractalshark_tpu_torch.core.views import get_view_preset
    p = escape.PlainParams.from_view(
        get_view_preset(view).ptz.square_aspect_ratio(size, size), size,
        size)
    esc = escape.escape(p, size, size, n, "f64", device, tile=False)
    f, v6, _ = frame_inputs(6, PAR_PO, device)
    comp = CompressedOrbit.from_uncompressed(v6, error_exp=20)
    ptz_rc = get_view_preset(6).ptz.square_aspect_ratio(PAR_RC_PO,
                                                        PAR_RC_PO)
    out = {"res30": res, "k12_us": k12_us,
           "mul_ms": float(np.median(times)), "escape": esc.cpu(),
           "v6": pickle.dumps((v6, comp)), "ptz": f.ptz, "ptz_rc": ptz_rc,
           "n6": f.num_iterations}
    out["po"] = PS.perturb_render_stream(v6, f.ptz, PAR_PO, PAR_PO,
                                         f.num_iterations, device=device).cpu()
    out["hdr"] = perturb.perturb_render_hdr(v6, f.ptz, PAR_PO, PAR_PO,
                                            f.num_iterations,
                                            device=device).cpu()
    out["escape_stats"] = {"min": int(esc.min()), "max": int(esc.max()),
                           "sum": int(esc.to(torch.int64).sum())}
    out["rc"] = PS.perturb_render_stream_rc(
        comp, v6.center_x, v6.center_y, ptz_rc, PAR_RC_PO, PAR_RC_PO,
        f.num_iterations, device=device).cpu()
    got = crc_pin(out["rc"])
    log(f"  one card: View #6 RC PO {PAR_RC_PO}² (K3) (iter_sum, crc32) "
        f"{got} (pin {VIEW6_RC_PO_16}); K12 {k12_us:.2f} us a step and "
        f"multiply_3way {out['mul_ms']:.3f} ms at {PAR_LIMBS} limbs")
    if got != VIEW6_RC_PO_16:
        raise AssertionError(f"View #6 RC PO {PAR_RC_PO}²: {got} != "
                             f"{VIEW6_RC_PO_16}")
    return out


def k20_graph_us(fn, device, launches: int = K20_GRAPH_LAUNCHES) -> float:
    """Device µs a launch of ``fn`` (one K20 launch), from a CUDA graph of
    ``launches`` back-to-back launches replayed between two CUDA events:
    the kernels' time without the host's call overhead."""
    import torch
    fn()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches * 1e3


def par_k20(device, stats):
    """K20 against its plain version block by block on one card, with no
    collective: View #30's first step at 16,384 limbs (its residue rows
    from the one-device transforms, K8), packed for M = 1, 2, 4 and 8
    ranks into the receive buffers the reshard's all_to_all would give
    each rank (``orbit_sharded.receive_buffers``), launch A's outputs on
    each, then the words stacked as the all_gather would, launch B's; the
    blocks' digits and signs against the whole-vector tail (K10's twin).
    Timed at M = 2 on rank 0's block of 32,768 digits, the words fixed:
    the call pair through the public wrappers and through a workspace
    (the sharded step's own calls), and each launch's device time."""
    import torch

    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    from fractalshark_tpu_torch.ops.bignum import ntt as N
    from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP
    from fractalshark_tpu_torch.parallel import orbit_sharded as OS
    from fractalshark_tpu_torch.parallel.mesh import Mesh

    st = stats["sharded_tail"]
    cx, cy, _ = view30_center()
    spec = FP.FixedSpec.for_limbs(PAR_LIMBS)
    nf, D = spec.nfft, spec.digits
    scx, cxd = FP.hp_to_digits(cx, spec)
    scy, cyd = FP.hp_to_digits(cy, spec)
    x = torch.from_numpy(cxd.astype("int32")).to(device)
    y = torch.from_numpy(cyd.astype("int32")).to(device)
    v = torch.zeros(4, nf, dtype=torch.int32, device=device)
    v[0:2, :D], v[2:4, :D] = x, y
    f = N.fourstep_forward(v, nf)
    fx, fy = f[0:2], f[2:4]
    e = torch.cat([N.mod_sub_rows(N.mont_mul_rows(fx, fx),
                                  N.mont_mul_rows(fy, fy)),
                   N.mont_mul_rows(fx, fy)])
    inv = N.fourstep_inverse_scaled(e, nf, True).view(2, 2, nf)
    cadd, rnd = FP.addend_planes(x, y, spec)
    cfg = NP.tail_cfg((scx, scy, 1, 0), nr=False)
    zsign = torch.tensor([scx, scy], dtype=torch.int32, device=device)
    whole = NP.fused_tail_plain(inv, cadd, rnd,
                                NP.tail_cfg((scx, scy, scx * scy, 0), False))
    H = OS.HALO
    pad = torch.nn.functional.pad
    cp, rp = pad(cadd, (H, 0)), pad(rnd, (H, 0))

    def planes(r, lloc):
        return (cp[:, r * lloc:r * lloc + H + lloc].contiguous(),
                rp[r * lloc:r * lloc + H + lloc].contiguous())

    for M in K20_MESHES:
        lloc = nf // M
        lays, recvs = OS.receive_buffers(inv, M)
        pa = [OS.tail_a_plain(recvs[r], *planes(r, lloc), cfg, lays[r],
                              zsign) for r in range(M)]
        ka = [OS.tail_a(recvs[r], *planes(r, lloc), cfg, lays[r], zsign)
              for r in range(M)]
        for r in range(M):
            for i, what in enumerate(("digits", "prefix words", "words")):
                compare(f"sharded_tail A M={M} block {r} {what}", ka[r][i],
                        pa[r][i], st)
        words = torch.stack([a[2] for a in ka])
        pb = [OS.tail_b_plain(a[0], a[1], words, r)
              for r, a in enumerate(pa)]
        kb = [OS.tail_b(a[0], a[1], words, lays[r])
              for r, a in enumerate(ka)]
        for r in range(M):
            compare(f"sharded_tail B M={M} block {r} digits", kb[r][0],
                    pb[r][0], st)
            compare(f"sharded_tail B M={M} block {r} signs", kb[r][1],
                    pb[r][1], st)
        compare(f"sharded_tail M={M} blocks vs the whole tail",
                torch.cat([b[0] for b in kb], 1), whole[0], st)
        compare(f"sharded_tail M={M} signs vs the whole tail", kb[0][1],
                whole[1], st)
    # timed: rank 0's block at M = 2, launch A then B, the words fixed
    lloc = nf // 2
    lays, recvs = OS.receive_buffers(inv, 2)
    b0 = (recvs[0], *planes(0, lloc))
    words = torch.stack([OS.tail_a(recvs[r], *planes(r, lloc), cfg,
                                   lays[r], zsign)[2] for r in range(2)])

    def public():
        a = OS.tail_a(*b0, cfg, lays[0], zsign)
        return OS.tail_b(a[0], a[1], words, lays[0])

    def plain():
        a = OS.tail_a_plain(*b0, cfg, lays[0], zsign)
        return OS.tail_b_plain(a[0], a[1], words, 0)

    ws = OS.Workspace(spec, Mesh(None, 2, 0, device))
    ws.bind(b0[1:], cfg)
    ws.recv.copy_(recvs[0])
    ws.gathered.copy_(words)

    def path():
        ws.launch_a(zsign)
        ws.launch_b()

    path()
    for got, want in zip((ws.dig, ws.sgn), public()):
        compare("sharded_tail workspace vs the public calls", got, want, st)
    _, ms = timed(public, device, 50)
    _, ws_ms = timed(path, device, 50)
    _, pms = timed(plain, device, warm=False)
    a_us = k20_graph_us(lambda: ws.launch_a(zsign), device)
    b_us = k20_graph_us(ws.launch_b, device)
    n_bytes = nbytes(*b0, words) + 4 * 2 * lloc + 8
    b = bound(n_bytes, 40.0 * 2 * lloc, I32_OPS_PER_S)
    log(f"  sharded_tail (A + B) on a rank's block of {lloc} digits: "
        f"{ms:.4f} ms a call pair through the public calls, {ws_ms:.4f} "
        f"through the workspace; device {a_us:.2f} us (A) and {b_us:.2f} "
        f"us (B) a launch ({K20_GRAPH_LAUNCHES} in a CUDA graph); plain "
        f"{pms:.3f} ms; bound {b['bound_ms']:.5f} ms ({n_bytes} bytes)")
    st.update(ms=ws_ms, public_ms=ms, device_us=(a_us, b_us), plain_ms=pms,
              **b)


def par_host_waits(fn) -> list:
    """The host's waits on the card while ``fn`` runs, outside the mesh's
    collectives: the warnings of ``torch.cuda.set_sync_debug_mode`` that
    name a synchronizing operation (a pageable host-to-device copy, a read
    back, a synchronise), with the mode off inside each collective (gloo
    stages through the host)."""
    import warnings

    import torch

    from fractalshark_tpu_torch.parallel import mesh as PM
    names = ("all_gather", "all_to_all", "all_reduce")
    saved = {n: getattr(PM, n) for n in names}

    def quiet(coll):
        def call(*a, **k):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return coll(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(1)
        return call

    for n in names:
        setattr(PM, n, quiet(saved[n]))
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(1)
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        for n in names:
            setattr(PM, n, saved[n])
    return [str(w.message).splitlines()[0] for w in seen
            if "called a synchronizing" in str(w.message)]


def par_worker(argv) -> int:
    """One rank of the parallel phase: ``--parallel-rank RANK WORLD
    BACKEND DIR`` (the inputs and the results in DIR)."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, backend, workdir = (int(argv[0]), int(argv[1]), argv[2],
                                     argv[3])
    device = torch.device("cuda", 0 if backend == "gloo" else rank)
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="file://" + os.path.join(
        workdir, f"store_{backend}"), world_size=world, rank=rank)
    try:
        from fractalshark_tpu_torch import kernels
        from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
        from fractalshark_tpu_torch.ops.bignum import ntt as N
        from fractalshark_tpu_torch.ops.bignum import orbit as O
        from fractalshark_tpu_torch.parallel import ntt_sharded as NS
        from fractalshark_tpu_torch.parallel import orbit_sharded as OS
        from fractalshark_tpu_torch.parallel import render as PR
        from fractalshark_tpu_torch.parallel import stream_render as SR

        # the parent writes the inputs while the ranks start
        path = os.path.join(workdir, "inputs.pkl")
        deadline = time.monotonic() + 300
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise AssertionError("no inputs from the parent")
            time.sleep(0.05)
        with open(path, "rb") as fh:
            inp = pickle.load(fh)
        v6, comp = pickle.loads(inp["v6"])
        sub = dist.new_group([0, 1]) if world > 2 else None
        meshes = [(world, None)] + ([(2, sub)] if world > 2 else [])
        out = {}
        for M, group in meshes:
            if rank >= M:
                continue
            mesh = NS.make_limb_mesh(device, group)
            tag = f"{backend} M={M}"
            t_case = time.perf_counter()
            for n in PAR_NTT:
                rng = np.random.default_rng(n)
                x = torch.from_numpy(rng.integers(0, 1 << 16, (4, n)).astype(
                    np.int32)).to(device)
                n1, n2 = N.split_n(n)
                h = n1 // M
                want = N.fourstep_forward(x, n).view(4, n2, n1)
                f = NS.fourstep_forward_sharded(x, n, mesh)
                if not torch.equal(f, want[:, :, rank * h:(rank + 1) * h]):
                    raise AssertionError(f"{tag} forward {n} differs")
                back = NS.gather_columns(NS.fourstep_inverse_sharded(
                    f, n, mesh, extra_scale_r=False), mesh)
                if not torch.equal(back, x):
                    raise AssertionError(f"{tag} round trip {n} differs")
                a, b = (rng.integers(0, 1 << 16, n) for _ in range(2))
                a[n // 2:] = 0
                b[n // 2:] = 0
                ab = torch.from_numpy(np.stack([a, a, b, b]).astype(
                    np.int32)).to(device)
                fa = N.fourstep_forward(ab, n)
                prod = N.mont_mul_rows(fa[[0, 1, 2, 3, 0, 1]],
                                       fa[[0, 1, 2, 3, 2, 3]])
                if not torch.equal(NS.multiply_3way_sharded(a, b, mesh),
                                   N.fourstep_inverse_scaled(prod, n, True)):
                    raise AssertionError(f"{tag} multiply {n} differs")
            spec = FP.FixedSpec.for_limbs(PAR_LIMBS)
            a, b = (np.random.default_rng(s).integers(0, 1 << 16, spec.nfft)
                    for s in (0, 1))
            a[spec.digits:] = 0
            b[spec.digits:] = 0

            def mul_ms(a, b):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                NS.multiply_3way_sharded(a, b, mesh)
                torch.cuda.synchronize(device)
                return (time.perf_counter() - t0) * 1e3

            times = [mul_ms(a, b) for _ in range(PAR_REPS + 1)]
            out[f"{M}_mul_ms"] = float(np.median(times[1:]))
            # the digits already on the card (no host staging of inputs)
            ad, bd = (torch.from_numpy(v).to(device) for v in (a, b))
            times = [mul_ms(ad, bd) for _ in range(PAR_REPS + 1)]
            out[f"{M}_mul_dev_ms"] = float(np.median(times[1:]))
            # again with each collective timed alone (the device synced
            # around it): the multiply's collectives and the rest
            coll = par_time_collectives(device)
            synced = [mul_ms(a, b) for _ in range(PAR_REPS)]
            out[f"{M}_mul_coll_ms"] = coll.pop() * 1e3 / PAR_REPS
            out[f"{M}_mul_synced_ms"] = float(np.mean(synced))
            # the sharded session: 256 steps from View #30's centre
            cx, cy, rad = view30_center()
            kernels.reset_counts()
            res = O.compute_reference_orbit_device(
                cx, cy, PAR_STEPS, rad, limbs32=PAR_LIMBS, periodicity=False,
                chunk_steps=PAR_STEPS, device=device, mesh=mesh)
            counts = {k: v for k, v in kernels.launches.items() if v}
            ref = inp["res30"]
            if not (np.array_equal(res.orbit_x, ref.orbit_x) and
                    np.array_equal(res.orbit_y, ref.orbit_y)):
                raise AssertionError(f"{tag} sharded session differs from "
                                     f"K12's")
            if counts != {"ntt_phase": 4 * PAR_STEPS,
                          "sharded_tail": 2 * PAR_STEPS}:
                raise AssertionError(f"{tag} session launches {counts}")
            out[f"{M}_launches"] = counts
            spec = FP.FixedSpec.for_limbs(PAR_LIMBS)
            scx, cxd = FP.hp_to_digits(cx, spec)
            scy, cyd = FP.hp_to_digits(cy, spec)
            state = O.OrbitState(scx, cxd, scy, cyd, device)
            cxt, cyt = state.x.clone(), state.y.clone()
            # the host's waits on the card outside the collectives, in the
            # reshard and the tail (the workspace's step) and in a chunk
            ws = OS._session(spec, mesh, scx, scy, cxt, cyt)
            inv = OS.inverse_block(cxt, cyt, spec, mesh)
            zsign = torch.tensor([scx, scy], dtype=torch.int32,
                                 device=device)
            waits = par_host_waits(lambda: [ws.step(inv, zsign, mesh)
                                            for _ in range(PAR_WAIT_STEPS)])
            if waits:
                raise AssertionError(f"{tag} the reshard and the tail wait "
                                     f"on the card: {waits}")
            out[f"{M}_chunk_waits"] = par_host_waits(
                lambda: O.orbit_chunk(state, scx, cxt, scy, cyt, spec,
                                      PAR_WAIT_STEPS, mesh=mesh))
            state = O.OrbitState(scx, cxd, scy, cyd, device)

            def chunk_us():
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                O.orbit_chunk(state, scx, cxt, scy, cyt, spec,
                              PAR_TIMED_STEPS, mesh=mesh)
                torch.cuda.synchronize(device)
                return (time.perf_counter() - t0) / PAR_TIMED_STEPS * 1e6

            out[f"{M}_step_us"] = chunk_us()
            # a second chunk with each collective timed alone: its
            # collectives' share (this chunk's own time is the synced one)
            coll = par_time_collectives(device)
            out[f"{M}_step_synced_us"] = chunk_us()
            out[f"{M}_coll_us"] = coll.pop() / PAR_TIMED_STEPS * 1e6
            # the renders: View 0 escape in bands (K1) and its statistics,
            # View #6 HDR (K6 HDR), View #6 PO (K6), View #6 RC PO (K3)
            from fractalshark_tpu_torch.core.views import get_view_preset
            from fractalshark_tpu_torch.ops import escape
            view, size, n = PAR_ESCAPE
            p = escape.PlainParams.from_view(
                get_view_preset(view).ptz.square_aspect_ratio(size, size),
                size, size)
            part = PR.sharded_escape_render(p, size, size, n, mesh)
            if not torch.equal(PR.gather_rows(part, size, mesh).cpu(),
                               inp["escape"]):
                raise AssertionError(f"{tag} escape bands differ")
            got = PR.sharded_stats(part, mesh)
            if got != inp["escape_stats"]:
                raise AssertionError(f"{tag} sharded_stats {got} != "
                                     f"{inp['escape_stats']}")
            hdr = PR.sharded_perturb_render_hdr(v6, inp["ptz"], PAR_PO,
                                                PAR_PO, inp["n6"], mesh)
            if not torch.equal(PR.gather_rows(hdr, PAR_PO, mesh).cpu(),
                               inp["hdr"]):
                raise AssertionError(f"{tag} View #6 HDR {PAR_PO}² "
                                     f"differs")
            po = SR.sharded_perturb_render_stream(
                v6, inp["ptz"], PAR_PO, PAR_PO, inp["n6"], mesh)
            if not torch.equal(po.cpu(), inp["po"]):
                raise AssertionError(f"{tag} View #6 PO {PAR_PO}² differs")
            rc = SR.sharded_perturb_render_stream_rc(
                comp, v6.center_x, v6.center_y,
                inp["ptz_rc"], PAR_RC_PO, PAR_RC_PO, inp["n6"], mesh)
            if not torch.equal(rc.cpu(), inp["rc"]):
                raise AssertionError(f"{tag} View #6 RC PO {PAR_RC_PO}² "
                                     f"differs")
            out[f"{M}_s"] = time.perf_counter() - t_case
        with open(os.path.join(workdir, f"out_{backend}_{rank}.json"),
                  "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()
    return 0


def par_time_collectives(device):
    """Wrap the mesh's collectives with a host clock, the device
    synchronised just before and just after each (so the clock holds the
    collective's whole transfer, its staging through host memory
    included, on either backend, and none of the launches queued before
    it); ``pop()`` gives the seconds so far and puts the collectives
    back.  The syncs cost time of their own: a run timed so is not the
    path's time."""
    import torch

    from fractalshark_tpu_torch.parallel import mesh as PM
    names = ("all_gather", "all_to_all", "all_reduce")
    saved = {n: getattr(PM, n) for n in names}
    spent = [0.0]

    def wrap(fn):
        def timed_fn(*a, **k):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize(device)
            spent[0] += time.perf_counter() - t0
            return out
        return timed_fn

    for n in names:
        setattr(PM, n, wrap(saved[n]))

    class Clock:
        def pop(self):
            for n in names:
                setattr(PM, n, saved[n])
            return spent[0]
    return Clock()


def par_start(workdir, world: int, backend: str) -> list:
    """Start ``world`` worker processes (they wait for the inputs), each
    writing its log under ``workdir``."""
    procs = []
    for r in range(world):
        with open(os.path.join(workdir, f"log_{backend}_{r}.txt"),
                  "w") as log_file:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--parallel-rank",
                 str(r), str(world), backend, workdir],
                stdout=log_file, stderr=subprocess.STDOUT))
    return procs


def par_wait(procs, workdir, backend: str, timeout: float) -> list:
    """Wait for every worker; a failing worker ends the others and fails
    the phase.  Returns each rank's results."""
    world = len(procs)
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(workdir, f"log_{backend}_{r}.txt")) as fh:
                tail = fh.read()[-3000:]
            raise AssertionError(f"parallel {backend} rank {r}: exit "
                                 f"{p.returncode}\n{tail}")
    outs = []
    for r in range(world):
        with open(os.path.join(workdir, f"out_{backend}_{r}.json")) as fh:
            outs.append(json.load(fh))
    return outs


def phase_parallel(device, stats):
    """(17) The sharded paths: K20 against its plain version block by
    block on one card; then M = 4 and M = 2 ranks as processes on this
    card in a gloo group (collectives staged through host memory): the
    sharded forward, inverse and 3-way multiply at nfft 8,192 and 65,536
    against the one-device transforms (K8), 256 sharded steps from View
    #30's centre at 16,384 limbs against K12's session (launching K8 and
    K20 and nothing else), the View 0 escape in bands (K1) at 512² and
    its all_reduce statistics, View #6 HDR and PO at 64² (K6) and RC PO
    at 16² (K3) against the one-card frames; the sharded multiply and
    step timed, then timed again with the device synchronised around each
    collective for the collectives' share; with two cards or more the
    same over NCCL, one rank a card.  Returns K20's launches on the
    sharded session (rank 0, M = 2)."""
    import pickle

    log("[17] parallel: K20 vs its plain version block by block; the "
        "sharded paths on M = 4 and 2 ranks on one card (gloo: collectives "
        "staged through host memory, not NCCL scaling)")
    import torch

    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        procs = par_start(workdir, 4, "gloo")
        try:
            par_k20(device, stats)
            inp = par_inputs(device)
            tmp = os.path.join(workdir, "inputs.tmp")
            with open(tmp, "wb") as fh:
                pickle.dump(inp, fh)
            os.replace(tmp, os.path.join(workdir, "inputs.pkl"))
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            raise
        runs = [("gloo", procs)]
        if torch.cuda.device_count() >= 2:
            runs.append(("nccl", None))
        else:
            log("  one card: NCCL across cards not measured")
        launches = None
        for backend, procs in runs:
            if procs is None:
                t0 = time.perf_counter()
                procs = par_start(workdir, min(4, torch.cuda.device_count()),
                                  backend)
            world = len(procs)
            outs = par_wait(procs, workdir, backend, 300)
            o = outs[0]
            meshes = sorted(int(k.split("_")[0]) for k in o if
                            k.endswith("_step_us"))
            for M in meshes:
                log(f"  {backend} M={M}: every case equal on every rank; "
                    f"sharded multiply {o[f'{M}_mul_ms']:.3f} ms (one card "
                    f"{inp['mul_ms']:.3f}; from digits on the card "
                    f"{o[f'{M}_mul_dev_ms']:.3f}; with each collective synced "
                    f"{o[f'{M}_mul_synced_ms']:.3f}, of which collectives "
                    f"{o[f'{M}_mul_coll_ms']:.3f}), sharded step "
                    f"{o[f'{M}_step_us']:.1f} us (synced "
                    f"{o[f'{M}_step_synced_us']:.1f}, of which collectives "
                    f"{o[f'{M}_coll_us']:.1f}; K12 "
                    f"{inp['k12_us']:.2f}) at {PAR_LIMBS} limbs; session "
                    f"launches {o[f'{M}_launches']}; host waits outside "
                    f"the collectives: 0 in the reshard and the tail, "
                    f"{len(o[f'{M}_chunk_waits'])} in a {PAR_WAIT_STEPS}-"
                    f"step chunk {sorted(set(o[f'{M}_chunk_waits']))}; "
                    f"cases {o[f'{M}_s']:.1f} s")
            log(f"  {backend}: {world} ranks in "
                f"{time.perf_counter() - t0:.1f} s")
            if launches is None:
                launches = outs[0][f"{min(meshes)}_launches"]["sharded_tail"]
    return {"sharded_tail": launches}


GRAFT_RANKS = 8
# __graft_entry__.py's dry run on 8 devices (MULTICHIP_r05.json): every
# pixel of the 64 x 64 frame at the budget of 500
GRAFT_ITER_SUM = 2_048_000
GRAFT_KERNELS = ("perturb_hdr32", "perturb_stream", "ntt_phase",
                 "sharded_tail")
V32_CAP, V32_STEPS = 4096, 8192


def phase_graft(device):
    """(18) The graft entry points: ``graft_entry.entry`` (K1, View 0
    256² x 512 in f32) against its plain version; ``dryrun_multichip(8)``,
    eight ranks in a gloo group on this card (K6 on each rank's slab, the
    stream form, K8's sharded product, three sharded orbit steps with K20),
    every check passing on every rank, iter_sum that of the JAX package's
    8-device run; then ``tools/run_view32_torch.py``'s ``run`` on View #32
    at 32,768 limbs (K12's grid form) capped at 4,096 steps, resumed in the
    same directory to 8,192: its orbit x/y/e equal an uninterrupted
    8,192-step run's bit for bit, each run's cap_hit record and projection
    checked."""
    import contextlib
    import io

    import numpy as np
    import torch

    from fractalshark_tpu_torch import graft_entry, kernels
    from fractalshark_tpu_torch.utils.growable import GrowableArray

    log("[18] the graft entry points: entry(), dryrun_multichip(8) on "
        "one card, View #32's script capped, resumed and uninterrupted")
    t0 = time.perf_counter()
    fn, args = graft_entry.entry(device)
    got = fn(*args)
    fn_c, args_c = graft_entry.entry("cpu")
    want = fn_c(*args_c)
    if got.dtype != torch.int32 or not torch.equal(got.cpu(), want):
        raise AssertionError("entry(): K1 != its plain version")
    log(f"  entry(): {tuple(got.shape)} iter_sum {int(want.sum())} = the "
        f"plain version's ({time.perf_counter() - t0:.1f} s)")

    t1 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = graft_entry.dryrun_multichip(GRAFT_RANKS, device.type)
    if rec["iter_sum"] != GRAFT_ITER_SUM or \
            rec["shape"] != [8 * GRAFT_RANKS, 64] or \
            not all(rec["checks"].values()):
        raise AssertionError(f"dryrun_multichip: {rec}")
    missing = [k for k in GRAFT_KERNELS if not rec["launches"].get(k)]
    if missing:
        raise AssertionError(f"dryrun_multichip launched no {missing}")
    log(f"  {buf.getvalue().strip()}; rank 0's launches {rec['launches']} "
        f"({time.perf_counter() - t1:.1f} s)")

    t2 = time.perf_counter()
    rv = load_tool("run_view32_torch")
    with tempfile.TemporaryDirectory() as d:
        runs = {}
        for label, cap, sub in (("capped", V32_CAP, "resumed"),
                                ("resumed", V32_STEPS, "resumed"),
                                ("straight", V32_STEPS, "straight")):
            kernels.reset_counts()
            with contextlib.redirect_stdout(io.StringIO()):
                st = rv.run(max_it=cap, out_dir=os.path.join(d, sub),
                            device=device)
            new = cap - (V32_CAP if label == "resumed" else 0)
            want_s = 1e6 * st["orbit_s"] / new
            if st["phase"] != "cap_hit" or st["orbit_new_it"] != new or \
                    st["orbit_len"] != cap + 1 or \
                    abs(st["projected_s_per_Mit"] - want_s) > 1e-3 * want_s:
                raise AssertionError(f"View #32 {label}: {st}")
            grid = kernels.launches["orbit_chunk_grid"]
            if grid != new // 256 or kernels.launches["ntt_orbit"] or \
                    kernels.launches["orbit_tail"]:
                raise AssertionError(f"View #32 {label}: launches "
                                     f"{dict(kernels.launches)}")
            runs[label] = st
        stores = [[GrowableArray.open_existing(
            os.path.join(d, sub, f"view32_orbit.{ext}")).view()
            for ext in "xye"] for sub in ("resumed", "straight")]
        for ext, a, b in zip("xye", *stores):
            if a.shape != b.shape or a.tobytes() != b.tobytes():
                raise AssertionError(f"View #32 orbit {ext}: resumed != "
                                     "uninterrupted")
        hdr = int(np.count_nonzero(stores[1][2]))
    st = runs["straight"]
    log(f"  View #32 at 32,768 limbs: {V32_CAP} steps, resumed to "
        f"{V32_STEPS} = {V32_STEPS} uninterrupted, x/y/e bit for bit "
        f"({hdr} HDR entries); {st['us_per_iter']:.2f} us an iteration, "
        f"{st['projected_s_per_Mit']:.1f} s a million iterations "
        f"uninterrupted (resumed run {runs['resumed']['us_per_iter']:.2f} "
        f"us); {time.perf_counter() - t2:.1f} s")
    log(f"  phase 18: {time.perf_counter() - t0:.1f} s")


# phase 19: the endurance pipeline (tools/run_view27_torch.py) at the
# mini location of tests/test_torch_view27_pipeline.py: the 1e13 frame,
# its orbit of period 999 (the JAX test's cut at 2,048 positions leaves it
# whole) compressed to 7 anchors, 16², budget 12,000.  The JAX package's
# grids there, FMA off, (iter_sum, CRC-32 of the int64 grid as <u8), in
# each gather mode (tools/view23_rc_pins.py prints them too); the twins
# are held at the cut budget, past every pixel's first 2,000 iterations
MINI_RC_VIEW = ("-0.743643887037158704752191506114774",
                "0.131825904205311970493132056385139", "1e13")
MINI_RC_SIZE, MINI_RC_BUDGET, MINI_RC_TWIN_BUDGET = 16, 12_000, 3_000
MINI_RC_PINS = {"f64": (616_704, 2_861_679_134),
                "df32": (617_276, 2_469_540_814)}
MINI_RC_KERNELS = {"f64": "rc_tail_f64", "df32": "rc_tail"}


def phase_endurance(device, stats):
    """(19) The endurance pipeline on the card at the mini location:
    ``tools/run_view27_torch.py``'s ``run`` (the native session, the LA
    build through memmaps, ``VirtualResults``, K2 ``la_only``, the tables
    released, the gather tail) in f64 (K19) and df32 (K3), each pinned to
    the JAX package's grid, its launches counted from 0 (the twins made to
    raise); then the tables dropped between the phases free device
    memory, the grid with them kept is the driver's, and K19 and K3 equal
    their twins from one handoff at the cut budget."""
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.core.hdr_host import HD
    from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
    from fractalshark_tpu_torch.engine import native_la as NL
    from fractalshark_tpu_torch.engine import renderers as R
    from fractalshark_tpu_torch.engine.la_reference import LAParameters
    from fractalshark_tpu_torch.engine.perturbation_results import (
        CompressedOrbit, VirtualResults)
    from fractalshark_tpu_torch.engine.reforbit import RefOrbitCalc
    from fractalshark_tpu_torch.ops.rc_tail import rc_tail_gather

    log("[19] the endurance pipeline (tools/run_view27_torch.py) at the "
        "mini location, f64 (K19) and df32 (K3), the tables released")
    t0 = time.perf_counter()
    rv = load_tool("run_view27_torch")
    x, y, zoom = MINI_RC_VIEW
    g, n, nt = MINI_RC_SIZE, MINI_RC_BUDGET, MINI_RC_TWIN_BUDGET
    ptz = PointZoomBBConverter(pt_x=x, pt_y=y, zoom_factor=zoom, prec=512)
    launches = {}
    os.environ["FRACTALSHARK_RC_TAIL"] = "gather"   # 999 positions: not auto
    try:
        with tempfile.TemporaryDirectory() as d:
            runs = {}
            for mode in MINI_RC_KERNELS:
                kernels.reset_counts()
                with forbid_twins(), \
                        contextlib.redirect_stdout(io.StringIO()):
                    st = rv.run(view=27, size=g, budget=n, mode=mode,
                                out_dir=d, device=device, ptz=ptz)
                runs[mode] = st, {k: v for k, v in kernels.launches.items()
                                  if v}
    finally:
        del os.environ["FRACTALSHARK_RC_TAIL"]
    for mode, name in MINI_RC_KERNELS.items():
        st, grew = runs[mode]
        other = [k for k in MINI_RC_KERNELS.values() if k != name]
        got = (st["iter_sum"], st["crc32"])
        log(f"  driver {mode}: (iter_sum, crc32) {got}, route {st['tail']}, "
            f"phase 1 {st['phase1_s']:.3f} s, phase 2 {st['phase2_s']:.3f} "
            f"s, launches {grew}")
        if got != MINI_RC_PINS[mode]:
            raise AssertionError(f"the driver's {mode} frame: {got} != "
                                 f"{MINI_RC_PINS[mode]}, the JAX package's")
        if not grew.get(name) or not grew.get("lav2_phase1") or \
                any(grew.get(k) for k in other):
            raise AssertionError(f"the driver's {mode} frame did not take "
                                 f"K2 la_only and {name} alone")
        for k, v in grew.items():
            launches[k] = launches.get(k, 0) + v

    sq = ptz.square_aspect_ratio(g, g)
    res = RefOrbitCalc().get_and_create_useful_results(sq, 50_000)
    comp = CompressedOrbit.from_uncompressed(res, error_exp=20)
    la = NL.generate_native_rc(comp, HD.from_hp(res.max_radius),
                               params=LAParameters(period_divisor=8,
                                                   low_bound=1))
    virt = VirtualResults.from_compressed(comp, res.center_x, res.center_y)
    init = R.la_handoff(virt, la, sq, g, g, n, device=device)
    torch.cuda.synchronize(device)
    held = torch.cuda.memory_allocated(device)
    R.drop_la_tables(virt, la, device)
    freed = held - torch.cuda.memory_allocated(device)
    log(f"  the tables dropped between the phases: {freed} bytes freed")
    if freed <= 0 or la._torch_cache:
        raise AssertionError("dropping the LA tables freed no device memory")
    del init
    kept = rv.grid_pin(R.two_phase_render(
        virt, la, sq, g, g, n, comp=comp, device=device, tail="gather").cpu())
    if kept != MINI_RC_PINS["f64"]:
        raise AssertionError(f"the frame with the tables kept: {kept} != "
                             "the driver's, which released them")

    init = R.la_handoff(virt, la, sq, g, g, nt, device=device)
    for mode, name in MINI_RC_KERNELS.items():
        kern = rc_tail_gather(comp, res.center_x, res.center_y, sq, g, g, nt,
                              {k: v.clone() for k, v in init.items()},
                              mode=mode, device=device)
        plain = rc_tail_gather(comp, res.center_x, res.center_y, sq, g, g,
                               nt, {k: v.cpu() for k, v in init.items()},
                               mode=mode, device="cpu")
        compare(f"{name} endurance mini {g}² budget {nt} (from one "
                "handoff)", kern, plain, stats[name])
    log(f"  phase 19: {time.perf_counter() - t0:.1f} s")
    return launches


# phase 20: the zoom sequence (tools/run_view30_torch.py sequence) on
# View #6, its twins' cut budget (at 64² every pixel's handoff at this
# budget leaves a tail of up to ~670 steps; the twins run every pixel in
# lockstep), and the feature-zoom clip (tools/autozoom_clip_torch.py)
ZOOM_VIEW, ZOOM_SIZE, ZOOM_FRAMES, ZOOM_STEP = 6, 64, 3, 1.5
ZOOM_TWIN_BUDGET = 796_000
# each frame's (iter_sum, CRC-32 of the grid as <u4) at the preset's
# budget, the JAX package on the CPU with FMA off
# (tools/view6_zoom_pins.py, artifacts/view6_zoom_pins.json); the last
# frame has the preset's box
ZOOM_PINS = ((3_268_313_226, 2_050_583_409), (3_268_491_399, 4_135_625_860),
             VIEW6_64)
CLIP_FRAMES, CLIP_SIZE, CLIP_FPS = 6, 64, 10.0


def phase_zoom(device, stats):
    """(20) An explorer's paths after one frame.  The zoom sequence on
    View #6 (``run_view30_torch.sequence``: every frame against one
    native orbit and one LA table, ``two_phase_render`` with the tables
    kept), its launches counted from 0 a frame, every frame pinned to the
    JAX package's (ZOOM_PINS, the last VIEW6_64); each frame's K2 ``la_only`` handoff and K6 tail against
    their twins (CPU tensors) from one handoff at ZOOM_TWIN_BUDGET.  Then
    the feature-zoom clip at 64² and 10 fps through the render pool
    (``autozoom_clip_torch.run``): every step presented, none aborted, in
    generation order, each frame equal to a direct render of its step.
    The twins are made to raise on both paths."""
    import torch

    from fractalshark_tpu_torch.engine import renderers as R
    from fractalshark_tpu_torch.engine.fractal import Fractal
    from fractalshark_tpu_torch.engine.la_reference import get_or_build_la

    log(f"[20] the zoom sequence (tools/run_view30_torch.py) on View "
        f"#{ZOOM_VIEW} {ZOOM_SIZE}², the feature-zoom clip "
        "(tools/autozoom_clip_torch.py)")
    t0 = time.perf_counter()
    g, frames, step = ZOOM_SIZE, ZOOM_FRAMES, ZOOM_STEP
    f = Fractal(width=g, height=g, view=ZOOM_VIEW, device=device)
    res = R.get_orbit_calc(f).get_and_create_useful_results(
        f.ptz, f.num_iterations)
    la = get_or_build_la(f, res)
    with forbid_twins(), contextlib.redirect_stdout(io.StringIO()):
        seq, grids = load_tool("run_view30_torch").sequence(
            res, la, f.ptz, g, f.num_iterations, frames, step, device)
    launches = {"lav2_phase1": 0, "two_phase_tail": 0}
    for fr in seq["per_frame"]:
        log(f"  frame {fr['k']} (final x{fr['scale']:.4g}): wall "
            f"{fr['wall_s']:.4f} s (phase 1 {fr['phase1_s']:.4f}, phase 2 "
            f"{fr['phase2_s']:.4f}), (iter_sum, crc32 <u8) "
            f"{(fr['iter_sum'], fr['crc32'])}, launches {fr['launches']}")
        for k, v in fr["launches"].items():
            if v < 1:
                raise AssertionError(f"sequence frame {fr['k']}: {k} never "
                                     "launched")
            launches[k] += v
    log(f"  first {seq['first_wall_s']:.4f} s, warm median "
        f"{seq['warm_median_s']:.4f} s ({seq['mpix_per_s']:.3f} Mpix/s), "
        f"{seq['tables_cached']} device tables cached once")
    for k, pin in enumerate(ZOOM_PINS):
        hold_pin(f"sequence frame {k} (View #{ZOOM_VIEW} {g}², the "
                 f"preset's box x{1.0 / step ** (frames - 1 - k):.4g})",
                 crc_pin(torch.from_numpy(grids[k])), pin)

    nt = ZOOM_TWIN_BUDGET
    for k in range(frames):
        ptz = f.ptz.zoomed_at_center(1.0 / step ** (frames - 1 - k))
        kern = R.la_handoff(res, la, ptz, g, g, nt, device=device)
        plain = R.la_handoff(res, la, ptz, g, g, nt, device="cpu")
        for key in ("dzr", "dzi", "dze", "it", "jwait", "done"):
            compare(f"lav2_phase1 sequence frame {k} {g}² budget {nt} "
                    f"handoff {key}", kern[key], plain[key],
                    stats["lav2_phase1"])
        compare(f"two_phase_tail sequence frame {k} {g}² budget {nt} (from "
                "one handoff)",
                R._identity_tail(res, ptz, g, g, nt, kern, None, None,
                                 device),
                R._identity_tail(res, ptz, g, g, nt,
                                 {key: v.cpu() for key, v in kern.items()},
                                 None, None, "cpu"),
                stats["two_phase_tail"])

    with tempfile.TemporaryDirectory() as d, forbid_twins(), \
            contextlib.redirect_stdout(io.StringIO()):
        man = load_tool("autozoom_clip_torch").run(
            CLIP_FRAMES, CLIP_SIZE, CLIP_FPS, d, device)
    log(f"  clip {CLIP_SIZE}² x {man['n_steps']} at {CLIP_FPS} fps: "
        f"presented {man['presented']}, aborted {man['aborted']}, achieved "
        f"{man['achieved_fps']} fps (gaps {man['min_gap_s']}-"
        f"{man['max_gap_s']} s), wall {man['wall_s']} s, routes "
        f"{man['routes']}, launches {man['launches']}, in generation order "
        f"{man['in_generation_order']}, every frame = its direct render "
        f"{man['all_equal_direct']}")
    if man["presented"] != CLIP_FRAMES or man["aborted"] or \
            not man["in_generation_order"] or not man["all_equal_direct"] \
            or not man["launches"].get("escape"):
        raise AssertionError("the feature-zoom clip did not present every "
                             "step as its direct render, in order, on K1")
    for k, v in man["launches"].items():
        launches[k] = launches.get(k, 0) + v
    log(f"  phase 20: {time.perf_counter() - t0:.1f} s")
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
    exact_pool = prefetch_exact_trace()
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
    launches.update(run("16", phase_app, device, stats))
    launches.update(run("17", phase_parallel, device, stats))
    run("18", phase_graft, device)
    for p, fn in (("19", phase_endurance), ("20", phase_zoom)):
        for k, v in run(p, fn, device, stats).items():
            launches[k] = launches.get(k, 0) + v
    exact_pool.shutdown()
    # K12's launches, each from its own path's run: View #6's and View
    # #30's device-orbit frames, the feature evaluator at View #6's sizes
    # and at View #30's.  K4/K5 are on no path since K12 took the orbit at
    # D = 2^16 too (the 32,768-limb session's counts, which phase 5 holds
    # to 0), K4-NR/K5-NR since K12 took every NR size (0).
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
    log(f"K12 grid by limbs, {CHUNK_STEPS}-step chunks: " + json.dumps(
        {k: stats[k]["by_limbs"] for k in ("orbit_chunk_grid",
                                            "nr_chunk_grid")}))
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
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(par_worker(sys.argv[2:]))
    sys.exit(main())

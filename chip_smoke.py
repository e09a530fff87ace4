#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports only
the port (``orb_slam3_fast_tpu_torch``), never JAX, and runs sixteen phases:

1. device: fails without CUDA; prints the card's name and power limit;
2. build: compiles the thirty kernels (A-Y, no K or O, then Z, AA, AB,
   AC, AD, AE and AF) from the 33 sources of ``orb_slam3_fast_tpu_torch/csrc``
   (kernel W's camera kinds in three), one nvcc per source in parallel,
   each source's finishing time logged, and the map's host C++ library,
   so that no timed frame pays for g++;
3. each kernel against its plain PyTorch version on the same CUDA tensors,
   with CUDA-event times (a plain version that takes over ~50 ms a call,
   as D's, R's, S's, U's, Z's, AA's and the whole BAs' do, timed on its one
   comparison call, its first-call costs included, after one call of each
   torch.linalg function: ``warm_library``), the least time the card could
   take for the same work (bytes or operations at the H100's published
   peaks) and, where one PyTorch call computes the same function, that
   call's time: A-D at the
   step's shapes (640x480 pyramid, 1024 keypoint slots, 1024 x 1024
   stereo, 4096 x 1024 window, 1024 edges); E and F on a local-BA problem
   at the mapper's caps (32 pose slots, 4096 landmarks, 16384
   observations), a whole BA through them, and F's failure flag on an
   indefinite system; G on 1024 matches; C's epipolar and mutual modes at
   768 x 768; H at 640x480 and 1280x720; I on kernel A's maps of those
   pyramids and on a tie-heavy map; J on 1024 stereo matches; L on 4096
   landmarks; the whole extraction on the card against the plain one; M on
   the 768 two-view matches of the mono corridor's frames 0 and 5 and on a
   planar pair (its F and H branches), through the pin-hole camera, EuRoC
   cam0's distortion and TUM-VI's cam0 (its three camera instances), its
   first stage (the unprojection) and its last (the 12-motion verdict) each
   bit for bit its plain version, the verdict on crafted motions reaching
   every branch too (``verdict_cases``); N on a corridor frame's 768
   descriptors with the 10^4- and the 10^6-word vocabulary; P on 768 slots
   with 256 subsets and 20% outliers; Q (128 hypotheses) and R on the 768
   pair slots of a keyframe pair, with and without the scale; S on a
   70-keyframe essential graph; U (the graph's PCG branch) on drift graphs
   of 200, 512 and 2048 vertices and forced on S's graph; T and E at the
   circle's global-BA size (128 pose slots, 4096 landmarks, ~30k
   observations), and a whole bundle_adjust_cg through E and T; D, E,
   Q and R with a camera carrying EuRoC cam0's distortion; V on a
   64-sample window (and its merge and compose), W at the frame's 768
   slots in its three forms, X at K = 16 and 32 and its refinement, Y at
   K = 16, M = 2048, O = 8192; Z (the 4-DoF essential graph) on
   yaw-drifted circles of 30 (dense), 200 and 512 (PCG) vertices; AA
   (FullInertialBA's LM segment) on tests/test_vi_ba.py's problem and on
   tests/test_vi_ba_cg.py's 200-keyframe inertial world, a segment and a
   whole solve each, the latter moving every state toward the truth; AB
   (the fisheye match's gates and triangulation) on phase 13's frame 1
   (both 512x512 KB8 images, 1000 slots each, kernel C's mutual best-2)
   and the KB8 instances of D, E, L, P, W, Y, Q, R and AA at their paths'
   shapes through TUM-VI's cam0 (Q and R on the loop verification's 768
   pair slots, AA on the two problems of its pin-hole row), each timed
   beside its pin-hole time; AC (the LM iteration's update, cost, accept
   and damping after E and F or T, and the chi2 gate) at the local BA's
   caps (from F's step) and at the global BA's size (from T's) in its
   three camera instances: the step accepted, its negative rejected, a
   zero step rejected with AC's cost E's bit for bit, the state within
   1e-5 of the plain version's with the same accepts and damping, two
   runs bit for bit, the gate's mask equal off the chi2 bound; E's
   outputs bit for bit the parent commit's (``E_DIGESTS``); both BA forms
   timed whole with every plain LM function made to raise; AD (the
   searches' epilogues) at each search's stage set on kernel C's outputs
   at its shapes (stereo 1024 x 1024, projection 4096 x 1024,
   frame-to-frame 1024 x 1024, initialisation, mutual and epipolar 768 x
   768) and on a seeded and a tie-heavy input each (``epilogue_case``), its
   masks, right u and depth bit for bit the plain version's;
4. the stereo tracking step at 640x480 and 1280x720, 12 frames each, chained
   through the pose with constant-velocity prediction over a textured plane
   of known depth; every frame must match >= 30 landmarks, keep >= 30
   inliers and land within one pixel's worth of translation of the truth,
   and A-D and H-L must have been launched; a per-stage split follows;
5. the stereo ``System`` (configs/synthetic_stereo.yaml) with local mapping
   on 30 frames of the synthetic corridor: the gates of
   tests/test_slam_e2e.py's stereo test, >= 3 keyframes, a local BA and
   triangulated landmarks, every kernel A-L (C in its epipolar mode too)
   and N (keyframe indexing) launched on that path, M and P not; per-frame
   and per-BA times;
6. the RGB-D ``System`` (the same configuration loaded for RGB-D, virtual
   baseline bf = 32) on the 25 frames of tests/test_slam_e2e.py's RGB-D
   test, depth from the splats: its gates (final state OK, > 20 frames
   tracked, unscaled ATE < 0.40 m), at least the 3 keyframes and 2 local
   BAs the JAX tracker makes on the same frames, H, I, L and N launched and
   J, M and P not;
7. the monocular ``System`` (configs/synthetic_mono.yaml) on the 40 frames
   of tests/test_slam_e2e.py's mono test: its gates (final state OK, > 30
   tracked, >= 3 keyframes, > 200 landmarks, scale-aligned ATE < 0.15 m),
   M, N (at least once per keyframe) and C's window mode launched; then
   tests/test_reloc.py's scenario (30 frames, 3 blank ones ->
   RECENTLY_LOST, frame 20 again -> OK near its pose) with P and N
   launched;
9. (run before phase 8, whose host threads would slow it) the monocular
   System with loop closing and the Atlas (``System(..., "monocular",
   enable_loop_closing=True, multi_map=True)``) on tests/test_loop_closing.py's
   150-frame circle, rendered by a pool of worker processes: that test's
   gates (final OK, > 120 tracked, >= 1 loop, scale-aligned ATE < 0.20 m),
   Q, R, S, T, E, N and the mono path's kernels launched, T and not F inside
   the global BA; then tests/test_atlas.py's scenario (the same circle,
   frames 55-67 black, max_recently_lost 6): >= 2 maps, >= 1 merge, final
   OK, > 100 frames OK, the ATE of ``trajectory_world()`` < 0.5;
10. (also run before phase 8) the default constructor: (a) the stereo
   System with every default (its local mapping and loop closing on the
   async backend's worker thread) on tests/test_pipeline.py's scenario and
   gates; (b) the mono System of phase 9, the async backend left at its
   default, fed the circle at 20 fps: drained, no worker error, and the
   loop test's gates where the JAX package's own async System meets them
   at that pace, else its readings (``ASYNC_LOOP_MIN_TRACKED``,
   ``ASYNC_LOOP_MAX_ATE``), the final state, loops and global BAs
   reported; (c) phase 9's loop scenario with the graph forced
   to kernel U: U launched, S not, the same closure frame; (d) the mono
   System with EuRoC cam0's distortion on phase 7's corridor: phase 7's
   gates, D and E launched in their distorted instances; (e) a global BA
   over phase 9's loop map requested of an async backend's GBA thread: it
   completes, T launched on ``slam-gba`` alone, F not;
11. (also before phase 8) the inertial System, synchronous, without loop
   closing: (a) ``System(configs/synthetic_mono.yaml, "monocular-inertial")``
   on tests/test_vi_tracker.py's 45-frame arc with its IMU stream, biases
   and noise (init_min_kfs 8, init_min_time 1.0, min_init_matches 60):
   the IMU initialised, >= 5 frames OK after the init frame, scale-aligned
   ATE after it < 0.25 m (where the JAX package's own tracker stands on
   that scenario; ``VI_GATES``), V, W, X and Y launched; (b)
   ``"stereo-inertial"`` (scale fixed) on the stereo corridor with the
   same IMU stream: final OK, at most one frame lost (the JAX package's
   own tracker loses one there too), the IMU initialised, unscaled ATE
   after it < 0.10 m; and the RGB-D-inertial System on 25 frames of the
   RGB-D corridor with the same IMU stream: final OK, every frame tracked,
   V launched every frame;
12. (also before phase 8) inertial loop closing: (a) the stereo-inertial
   System, synchronous, with loop closing and the Atlas, on the loop
   scenario's ring world seen in stereo along the circle flown at a
   modulated speed, with its exact IMU stream: final OK, > 120 tracked,
   the IMU initialised, >= 1 loop closed, unscaled ATE < 0.20 m, Z (the
   4-DoF essential graph) and AA (FullInertialBA) launched and S, U and T
   not; (b) its first loop correction rerun on the card from a snapshot
   of the map taken just before it, against the same correction on the
   host's plain path (in phase 8's host section; ``VI_CORRECTION_BOUNDS``);
   (c) the default constructor ``System(settings, "stereo-inertial")``
   (the async backend, loop closing, the Atlas) on phase 11 (b)'s corridor
   at 20 fps: drained, no worker error, the IMU initialised, V-Y launched
   on the tracker thread; (d) MergeInertialBA on tests/test_vi_ba_cg.py's
   welded map with that test's gates, Y launched;
13. (also before phase 8) the fisheye two-camera rig
   (configs/TUMVI_fisheye_stereo_inertial.yaml: two 512x512 KB8 cameras,
   Stereo.T_c1_c2 with its 0.047 rad roll, 1000 features), synchronous,
   without loop closing, on tests/test_fisheye.py's corridor: (a)
   ``System(..., "stereo")`` on its 25 frames with that test's gates
   (final OK, > 20 tracked, unscaled ATE < 0.3 m, scale within 0.12);
   (c) on (a)'s map, 3 blank pairs -> RECENTLY_LOST, frame 15 again ->
   OK within 0.3 m; (b) ``"stereo-inertial"`` on 45 frames of the arc with
   the body's IMU stream through IMU.T_b_c1, at the JAX package's own level
   (``FISHEYE_VI_GATES``); AB, C's mutual mode and the KB8 instances of L,
   D, E (and P in (c), W and Y in (b)) launched, J, M, Q-U, Z and AA not;
14. (also before phase 8) loop closing on the fisheye rig: phase 12's ring
   world along its circle seen by the TUM-VI rig, rendered once, and the
   body's IMU stream through IMU.T_b_c1 (``fisheye_loop_frames``):
   (a) ``System(..., "stereo")`` with loop closing and the Atlas,
   synchronous, at the JAX package's own level
   (``FISHEYE_LOOP_GATES``; python -m tests.fisheye_loop_reference), Q and
   R in KB8, S or U and T launched; (b) ``"stereo-inertial"``, the IMU
   initialised and the loop closed through the inertial branch (Z and AA
   in KB8); each first loop correction rerun on the card from a snapshot
   and, in phase 8's host section, on the host (``VI_CORRECTION_BOUNDS``);
   (c) the default constructors ``System(TUM-VI config, "stereo" |
   "stereo-inertial")`` fed the circle at 20 fps: drained, no worker error,
   the IMU initialised (loops and tracking reported);
15. (also before phase 8) the monocular KB8 rig: TUM-VI's cam0 alone, on
   the left images phases 13 and 14 rendered: (a) ``System(TUM-VI config,
   "monocular")``, synchronous, without loop closing, on 13 (a)'s 25
   frames; (b) ``"monocular-inertial"`` on 13 (b)'s 45 frames with the
   body's IMU stream; (c) ``"monocular"`` with loop closing and the Atlas,
   synchronous, on 14's circle, its first loop correction rerun on the card
   from a snapshot; each at the JAX package's own level
   (``FISHEYE_MONO_GATES``; python -m tests.fisheye_mono_reference), M, D,
   E, L and AC in KB8 and N launched on (a), V, X, W and Y in KB8 on (b),
   Q and R in KB8 with the scale free, S or U, and T on (c), AB and J on
   none; (d) the default constructors ``System(TUM-VI config, "monocular" |
   "monocular-inertial")`` fed the circle at 20 fps: drained, no worker
   error;
16. (also before phase 8) several ranks (``parallel/``): (a) in this
   process a NCCL world of one (a FileStore in a temporary directory):
   kernel AE on 4096 rows x 1024 slots at 10^4 and 10^6 words bit for bit
   its plain version, its counts the host database's and its scores within
   1e-5; kernel AF's dense run at the local caps and its CG run at phase
   3's global-BA size, one iteration's stages against their plain versions
   (the state within 1e-5, the accepts equal), each whole run within 5e-4
   (R) and 5e-3 (t) of the single-device BA and of its plain run; times
   split into kernels and collectives; (b) two gloo ranks spawned on the
   card (``run_ranks``): AE's scores bit for bit (a)'s, AF's runs in halves
   within 5e-4 / 5e-3 of (a)'s and the ranks' states equal, then phase 9's
   loop System run by both, synchronous: phase 9's gates, the loop at phase
   9's frame +- 5, both ranks' keyframe poses and tracks bit for bit equal,
   AE and AF launched on each rank, T not inside the global BA;
8. one frame of the plain (CPU) step, and the stereo and mono Systems, the
   relocalisation run (from the host mono run's state after frame 29), the
   RGB-D and the distorted mono Systems' first ``HOST_PREFIX`` frames and
   the loop scenario's first ``LOOP_HOST_PREFIX`` with the plain versions
   on the host, against the card; the loop scenario's first
   correction (its snapshot taken in 10 (c), whose run repeats phase 9's up
   to there) rerun on the card and on the host; (11 c) the inertial
   Systems' first 31 (mono) and 38 (stereo) frames on the host against
   the card: the same states, keyframes and
   IMU-initialisation frame, poses within each path's own bound
   (``VI_BOUNDS``: the inertial plain paths alone do not repeat across
   host CPUs to 2e-3, ``track_spread.py --save-host``), (13 a) the
   fisheye stereo System's first ``HOST_PREFIX`` frames and (15 a) the
   fisheye monocular System's 25 at ``FISHEYE_BOUNDS``, (15 b) the fisheye
   monocular-inertial System's frames up to its first loss at
   ``VI_BOUNDS["monocular"]``, and (15 c) its loop correction from the
   snapshot; the time of each part (the build, phase 3, each path, each
   host run and phase 8 in all) and the total, a
   JSON line of the kernels, then ``{"ok":
   true, "device": {...}}`` last.  The loop path is held to its own bound
   (``LOOP_DT`` / ``LOOP_DR``: two host CPUs running the plain path alone
   land 6.1e-3 apart over its 150 frames), its correction too.  The async runs of phase 10 are not held
   against the host: what the worker has done by the time a frame is
   tracked depends on the host's speed, so they do not repeat.

Launch counts are zeroed just before each path of phases 4-7 and 9-16 and
read just after; a run on the async backend also reads them per thread.
Every such read (``path_counts``) fails unless AC's update launched once
for each launch of E,
in each camera instance and on each thread, and its gate wherever E
launched: every BA iteration on every path is E -> F (or T) -> AC; unless
AD launched once for each launch of C that AB does not follow, on each
thread (every search but the fisheye match is C -> AD), and in the stage
sets of the searches the path runs.  In phases 5-15 every plain epilogue
function (``EPILOGUE_PLAIN``) and kernel M's plain unprojection and
verdict (``TWOVIEW_PLAIN``) raise on a CUDA tensor.
No path's host comparison is cut in depth but these prefixes: the
fisheye monocular-inertial one's frames up to its first loss (24
frames); and, for the time limit, the stereo-inertial one's first 38
frames and the mono-inertial one's first 31 (each through the frame
after its IMU initialisation; past frame 40 the stereo-inertial card and
host runs end in other states, and the mono-inertial one is lost from
frame 37), the loop scenario's first 30 and its first correction, the RGB-D System's
first 16 (its three keyframes and two local BAs; 22.0 s in full),
the distorted mono System's first 14 (its initialisation at frame 4 and
the local BAs of the keyframes of frames 6 and 13; 41.3 s in full), and
the fisheye stereo System's first 15 (its first four keyframes and three
local BAs; 40.2-48.3 s in full).
The relocalisation run's host replica does not track its first 30
frames again: it goes on from a copy of the host mono run's System
after them (the same System on the same frames; 25.0 s in full).  Every
scene is rendered on the host by one pool of worker processes
(``render_pool``, a torch thread and a core each), which the script
opens first and closes last; an image is the same rendered there or
here.  The time of each part is printed beside the total.  Any failure
raises, so the script exits nonzero without the last line.
"""
from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 12
WARMUP = 2
SYS_FRAMES = 30  # the System phase: test_slam_e2e.py's stereo sequence
SYS_CONFIG = "configs/synthetic_stereo.yaml"
N_LM = 4096
N_DLT = 1024  # kernel G's check: matches of two keyframes
RGBD_FRAMES = 25  # the RGB-D phase: test_slam_e2e.py's RGB-D sequence
RGBD_BF = 0.08 * 400.0  # its virtual baseline x fx
RGBD_MIN_KF, RGBD_MIN_BA = 3, 2  # what the JAX tracker + mapper make on those frames on the CPU
# (python -m tests.rgbd_reference_counts: keyframes at frames 0, 10, 15; 2 local BAs)
MONO_CONFIG = "configs/synthetic_mono.yaml"
MONO_FRAMES = 40  # the mono phase: test_slam_e2e.py's mono sequence
VI_FRAMES = 45  # tests/test_vi_tracker.py's mono-inertial arc
X_LONG = 120  # phase 3's long chain for kernel X (42 s of coarse edges 0.35 s apart; P = 369)
VI_RGBD_FRAMES = 25  # the RGB-D-inertial run of phase 11: the RGB-D phase's length
# Phase 11's gates.  The JAX package's own InertialTracker on test_vi_tracker.py's mono scenario (CPU, python -m
# tests.test_torch_vi_system) initialises the IMU at frame 29, is RECENTLY_LOST from frame 37 on, tracks 6 frames
# after the initialisation frame, fits a scale of 1.388 (scale-aligned ATE 0.033 m) and ends with a gyro bias
# (0.00175, 0.00071, 0.00159): short of that test's own gates (final OK, >= 10 frames after init, |s - 1| < 0.12,
# the bias within 1.5e-3), which it does not meet.  The mono gates are where the reference stands: the IMU
# initialised, >= VI_MONO_MIN_AFTER frames tracked after it, the test's ATE < 0.25 m; the rest is reported.
VI_MONO_MIN_AFTER = 5
# The JAX package's own stereo-inertial tracker on phase 11 (b)'s scene (CPU, python -m tests.test_torch_vi_sensors)
# initialises the IMU at frame 36, loses one frame of 45, ends OK with an unscaled ATE of 0.0101 m after the init.
# Phase 11 (c) holds each inertial run against its host run at its own bound (as the loop path has LOOP_DT /
# LOOP_DR), because the plain paths alone do not repeat across host CPUs to TRACK_DT (track_spread.py --save-host,
# PERF.md §6): two hosts running the mono-inertial plain path land 1.04e-2 / 6.1e-4 apart at worst (frame 36, the
# last before the tracker is lost; beyond 2e-3 from frame 34), so the whole mono run is held to 2e-2 in t and the
# sync paths' 1e-3 in rotation entries; the stereo-inertial runs land within 5e-2 / 5e-3 of each other over frames
# 0-42 and its card run in another state than the host's at 41-42, so its first 41 frames are held to 5e-2 / 5e-3.
# For the time limit (PERF.md §6) each inertial run is held over its frames up to the one after its IMU
# initialisation (X, then Y over the chain) and so its first inertial pose optimisation (W): the mono-inertial run's
# first 31 frames (the IMU at frame 29; it is lost at frame 37), the stereo-inertial one's first 38 (the IMU at 36).
VI_HOST_PREFIX = {"monocular": 31, "stereo": 38}
VI_BOUNDS = {"monocular": (2e-2, 1e-3), "stereo": (5e-2, 5e-3)}
VI_STEREO_MAX_ATE = 0.10
VI_GATES = {"monocular": f"IMU initialised, >= {VI_MONO_MIN_AFTER} frames OK after the init frame, scale-aligned ATE "
                         "after it < 0.25 m, V-Y launched",
            "stereo": f"final OK, at most one frame lost, IMU initialised, unscaled ATE after it < "
                      f"{VI_STEREO_MAX_ATE} m, V-Y launched"}
VI_GYRO_BIAS, VI_ACC_BIAS = (0.002, -0.001, 0.0015), (0.03, -0.02, 0.04)
RELOC_FRAMES, RELOC_REVISIT = 30, 20  # test_reloc.py: 30 frames, 3 blank ones, frame 20 again
LOOP_FRAMES = 150  # tests/test_loop_closing.py's circle
# Phase 8 holds the loop scenario's card run to its host run over the first LOOP_HOST_PREFIX frames and its first loop
# correction rerun on the host from a snapshot of the card's map (as phases 12 (b) and 14 do), for the time limit:
# the whole 150 frames on the host took 152.5-209.0 s of chip_smoke.py's 1200 s and the first 60 55.2-102.1 s
# (PERF.md §6); the first 30 (the initialisation, tracking, local BAs and every keyframe's loop query, before the
# circle's drifting middle from frame ~36) are those the card and the host run keep within TRACK_DT / TRACK_DR
LOOP_HOST_PREFIX = 30
# Phase 8's other prefixes, for the time limit (PERF.md §6: in full the three took 22.0, 41.3 and 40.2-48.3 s of
# phase 8's ~490): the RGB-D System through its three keyframes (frames 0, 10, 15) and so its two local BAs; the
# distorted mono System through its initialisation (frame 4) and the local BAs of its next two keyframes (frames 6
# and 13); the fisheye stereo System of 13 (a) through its first four keyframes (frames 0, 4, 8, 14) and so its
# first three local BAs.  The relocalisation run's host replica goes on from the host mono run's state after its
# frame 29 (the same System on the same frames) instead of tracking frames 0-29 again.
HOST_PREFIX = {"rgbd": 16, "distorted mono": 14, "fisheye": 15}
ATLAS_BLACKOUT = range(55, 68)  # tests/test_atlas.py's sensor dropout
TRACK_DT, TRACK_DR = 2e-3, 1e-3  # a System's card run against its host run: t, rotation entries
# The loop path's own bound (150 frames of mono SLAM, map units of ~7.8 m): the plain path alone,
# run on two host CPUs, lands 6.1e-3 / 2.66e-3 apart at frames 44-137 (its float32 LU solves round
# differently per CPU and the drifting middle of the circle amplifies it; float64 solves repeat
# across CPUs), and the card 6.07e-3 / 2.76e-3 from the host run (PERF.md, the loop path's spread)
LOOP_DT, LOOP_DR = 1e-2, 5e-3
# EuRoC cam0's radial-tangential coefficients k1 k2 p1 p2 k3 (configs/EuRoC_stereo_inertial.yaml:10-13), put on the
# synthetic 640x480 intrinsics for the distorted-camera cases of kernels D, E, Q, R and phase 10 (d)
EUROC_DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
# Phase 10 (b), the default (async) mono System fed the loop circle at 20 fps, keeps the pipeline test's and the
# loop test's gates where the JAX package's own async System meets them at that pace on the CPU, and falls to its
# readings where it does not (python -m tests.async_loop_reference, one run a process, 33 runs, PERF.md §6): it
# always drained; it tracked as few as ASYNC_LOOP_MIN_TRACKED frames of the loop test's > 120 and ended as far as
# ASYNC_LOOP_MAX_ATE m of its < 0.20 (scale-aligned ATE); 9 runs did not end OK, 27 closed no loop, 29 completed
# no global BA, 2 had a worker error (a numpy SVD that did not converge); the port keeps the no-error gate.  A run
# that falls behind (the worker's queue at 4-6 keyframes) runs out of fresh landmarks and loses the map; the JAX
# package's tracker has no back-pressure either.  What the worker has done when a frame is tracked depends on the
# host's speed, so no run repeats.
ASYNC_LOOP_MIN_TRACKED, ASYNC_LOOP_MAX_ATE = 95, 3.90
# The H100 SXM's published peaks (NVIDIA's data sheet): HBM3 bytes/s, and
# float32 outside the tensor cores, taken here for all scalar work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# The bounds of the kernels that solve small systems (G, M, P) count what a
# direct method needs, whatever algorithm the kernel runs: r n (n + 1) flops
# to form the n x n normal matrix of r rows, n^3 for its null vector by
# elimination, 200 for a 3x3 SVD (the closed-form symmetric eigenproblem).
SVD3_FLOPS = 200


def normal_flops(rows: int, n: int) -> int:
    return rows * n * (n + 1)


def null_flops(n: int) -> int:
    return n**3
SHIFT = 2  # px per frame, sideways pan
DISP_640 = 8  # px of disparity at 640 wide; the plane is at bf / disparity


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after ``warmup`` warm-up runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def warm_library(device) -> None:
    """One call of each torch.linalg function the plain versions use, so
    that no plain version's one timed call pays for creating the library's
    handles and workspaces."""
    a = torch.eye(6, device=device) + 0.1 * torch.ones(6, 6, device=device)
    torch.linalg.solve(a, torch.ones(6, device=device))
    torch.linalg.svd(a)
    torch.linalg.inv(a)
    torch.linalg.det(a)
    torch.linalg.cholesky_ex(a)
    torch.linalg.solve(a.double(), torch.ones(6, device=device, dtype=torch.float64))
    torch.cuda.synchronize()


def timed(fn):
    """(fn's result, its milliseconds by CUDA events) of one call."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes the work
    must move (each input read once, each output written once) over the
    memory rate and its operations over the peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


# --- the scene ---------------------------------------------------------------


class Rig:
    """Pin-hole stereo rig for a W x H frame: fx = 0.7 W, baseline 0.1."""

    def __init__(self, w: int, h: int):
        self.w, self.h = w, h
        self.fx = self.fy = 0.7 * w
        self.cx, self.cy = w / 2.0, h / 2.0
        self.bf = 0.1 * self.fx
        self.disp = DISP_640 * w // 640
        self.z = self.bf / self.disp
        self.x0 = 8

    def t_true(self, k: int) -> np.ndarray:
        return np.array([-k * SHIFT * self.z / self.fx, 0.0, 0.0], np.float32)


def make_canvas(rng, rig: Rig) -> np.ndarray:
    """bench.py's texture recipe (noise plus bright rectangles) on a canvas
    wide enough for the whole pan."""
    h, w = rig.h, rig.w + rig.x0 + SHIFT * 16 + rig.disp + 8
    img = rng.uniform(0, 50, (h, w)).astype(np.float32)
    for _ in range(120 * (h * w) // (480 * 640)):
        cy, cx = rng.integers(20, h - 40), rng.integers(0, w - 24)
        img[cy : cy + rng.integers(8, 24), cx : cx + rng.integers(8, 24)] += rng.uniform(80, 170)
    return np.clip(img, 0, 255)


def frame(canvas: np.ndarray, rig: Rig, k: int, device):
    o = rig.x0 + k * SHIFT
    il = torch.as_tensor(canvas[:, o : o + rig.w].copy(), device=device)
    ir = torch.as_tensor(canvas[:, o + rig.disp : o + rig.disp + rig.w].copy(), device=device)
    return il, ir


def make_local_map(canvas, rig: Rig, cfg, device):
    """4096 landmark slots: plane points back-projected from the keypoints
    of reference frames, normal and distance band as WorldMap sets them
    (map/worldmap.py:171-174)."""
    from orb_slam3_fast_tpu_torch.frontend.tracker import LocalMap
    from orb_slam3_fast_tpu_torch.ops import extractor as ext

    pos, desc, normal, dmax = [], [], [], []
    for k in (0, 5, 10, 15):
        kp = ext.extract(frame(canvas, rig, k, device)[0], cfg)
        v = kp.valid
        xy = kp.xy[v]
        center = torch.tensor([k * SHIFT * rig.z / rig.fx, 0.0, 0.0], device=device)
        p = torch.stack(
            [(xy[:, 0] - rig.cx) * rig.z / rig.fx + center[0], (xy[:, 1] - rig.cy) * rig.z / rig.fy,
             torch.full_like(xy[:, 0], rig.z)], 1,
        )
        d = p - center
        dist = torch.linalg.vector_norm(d, dim=1)
        pos.append(p)
        desc.append(kp.desc[v])
        normal.append(d / dist[:, None])
        dmax.append(dist * cfg.scale_factor ** kp.level[v].float())
    pos, desc, normal, dmax = (torch.cat(x)[:N_LM] for x in (pos, desc, normal, dmax))
    n = pos.shape[0]
    pad = N_LM - n

    def padded(x):
        return torch.cat([x, torch.zeros((pad, *x.shape[1:]), dtype=x.dtype, device=device)]).contiguous()

    return LocalMap(
        pos=padded(pos), desc=padded(desc), normal=padded(normal),
        dmin=padded(dmax / cfg.scale_factor ** (cfg.n_levels - 1)), dmax=padded(dmax),
        mask=torch.arange(N_LM, device=device) < n,
    )


def setup(rig: Rig, device, seed: int = 0):
    """The scene, its local map and the step for ``rig``."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera
    from orb_slam3_fast_tpu_torch.frontend.tracker import StereoTrackingStep
    from orb_slam3_fast_tpu_torch.ops import extractor as ext

    cfg = ext.ExtractorConfig(n_features=1024)
    canvas = make_canvas(np.random.default_rng(seed), rig)
    lm = make_local_map(canvas, rig, cfg, device)
    step = StereoTrackingStep(Camera.pinhole(rig.fx, rig.fy, rig.cx, rig.cy), rig.bf, (rig.w, rig.h), cfg, device=device)
    return step, lm, canvas


def track(rig: Rig, step, lm, canvas, device, n_frames: int = N_FRAMES):
    """Track ``n_frames`` frames; returns per-frame (matches, inliers,
    translation error, rotation error, step ms or None)."""
    from orb_slam3_fast_tpu_torch.utils import lie

    T_prev = T = lie.SE3.identity(device)  # frame 0 starts at its true pose
    rows = []
    for k in range(n_frames):
        vel = T.compose(T_prev.inverse())
        T_pred = vel.compose(T)
        il, ir = frame(canvas, rig, k, device)
        timed = device.type == "cuda" and k >= WARMUP
        if timed:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        res = step(il, ir, T_pred, lm)
        ms = None
        if timed:
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        T_prev, T = T, res.T
        t = res.T.t.cpu().numpy()
        R = res.T.R.cpu().numpy()
        if not (np.isfinite(t).all() and np.isfinite(R).all()):
            raise RuntimeError(f"{rig.w}x{rig.h} frame {k}: non-finite pose")
        rows.append((int(res.n_matches), int(res.n_inliers), float(np.abs(t - rig.t_true(k)).max()),
                     float(np.abs(R - np.eye(3)).max()), ms))
    return rows


def check_sequence(rig: Rig, rows) -> None:
    """Every frame: >= 30 matches and inliers (min_map_inliers,
    frontend/tracker.py:48), translation error under one pixel's worth at
    the plane's depth (z / fx), rotation entries within 1e-3 of identity."""
    bound = rig.z / rig.fx
    for k, (m, n, et, er, _) in enumerate(rows):
        if m < 30 or n < 30 or et > bound or er > 1e-3:
            raise RuntimeError(
                f"{rig.w}x{rig.h} frame {k}: matches {m}, inliers {n}, |dt| {et:.3g} m "
                f"(bound {bound:.3g}), |dR| {er:.3g}"
            )


# --- the System's scene: numpy copies of tests/synthetic.py's helpers ----------
# (tests/synthetic.py imports jax, which the card's machine does not have)


def _frames_from_normals(normals):
    """Per-splat orthonormal in-plane tangent frames (e1, e2) from normals."""
    n = normals / np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-9)
    helper = np.where(np.abs(n[:, 2:3]) < 0.9, np.array([[0.0, 0.0, 1.0]]), np.array([[1.0, 0.0, 0.0]]))
    e1 = np.cross(n, helper)
    e1 /= np.maximum(np.linalg.norm(e1, axis=-1, keepdims=True), 1e-9)
    return e1.astype(np.float32), np.cross(n, e1).astype(np.float32)


def make_corridor_world(rng, n=800, half_w=4.0, half_h=3.0, length=40.0, tile=6):
    """Textured square splats on the four walls of a box corridor along +z
    (synthetic.make_corridor_world, the same draws from ``rng``)."""
    n4 = n // 4
    zs = rng.uniform(1.0, length, n)
    walls = [
        np.stack([np.full(n4, -half_w), rng.uniform(-half_h, half_h, n4), zs[:n4]], -1),
        np.stack([np.full(n4, half_w), rng.uniform(-half_h, half_h, n4), zs[n4: 2 * n4]], -1),
        np.stack([rng.uniform(-half_w, half_w, n4), np.full(n4, -half_h), zs[2 * n4: 3 * n4]], -1),
        np.stack([rng.uniform(-half_w, half_w, n - 3 * n4), np.full(n - 3 * n4, half_h), zs[3 * n4:]], -1),
    ]
    tilt = rng.uniform(0.7, 3.0, (n, 1))
    base = np.concatenate([np.tile([1.0, 0.0, 0.0], (n4, 1)), np.tile([-1.0, 0.0, 0.0], (n4, 1)),
                           np.tile([0.0, 1.0, 0.0], (n4, 1)), np.tile([0.0, -1.0, 0.0], (n - 3 * n4, 1))])
    e1, e2 = _frames_from_normals(base + tilt * np.array([[0.0, 0.0, -1.0]]))
    return {
        "centers": np.concatenate(walls).astype(np.float32),
        "sizes": rng.uniform(0.15, 0.4, n).astype(np.float32),
        "tex": rng.uniform(40.0, 230.0, (n, tile, tile)).astype(np.float32),
        "e1": e1,
        "e2": e2,
    }


_PIXEL_RAYS: dict = {}


def pixel_rays(cam, wh) -> np.ndarray:
    """The unit-z ray of every pixel of a ``wh`` image of ``cam`` (h, w, 3),
    float64, computed once per camera and size: a KB8 camera's 10-step
    Newton unprojection of the whole grid costs seconds on the host."""
    from orb_slam3_fast_tpu_torch.cameras import models as cm

    key = (cam.kind, tuple(cam.params.tolist()), tuple(wh))
    if key not in _PIXEL_RAYS:
        w, h = wh
        uu, vv = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
        grid = torch.as_tensor(np.stack([uu, vv], -1).reshape(-1, 2), dtype=torch.float32)
        _PIXEL_RAYS[key] = cm.unproject(cam, grid).numpy().reshape(h, w, 3).astype(np.float64)
    return _PIXEL_RAYS[key]


def render(world, cam, R, t, wh=(640, 480), bg=30.0) -> np.ndarray:
    """Perspective render of the world-anchored textured quads seen from
    T_cw = (R, t) (synthetic.render): per pixel, the ray-plane hit of the
    nearest quad, its texture sampled bilinearly."""
    from orb_slam3_fast_tpu_torch.cameras import models as cm

    w, h = wh
    img = np.full((h, w), bg, dtype=np.float32)
    zbuf = np.full((h, w), np.inf, dtype=np.float32)
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    centers = world["centers"].astype(np.float64)
    Xc = centers @ R.T + t
    tile = world["tex"].shape[1]
    e1, e2 = world["e1"].astype(np.float64), world["e2"].astype(np.float64)
    sizes = world["sizes"].astype(np.float64)
    all_dirs = pixel_rays(cam, wh)
    half = 0.5 * sizes
    quad = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
    corners_w = centers[:, None, :] + np.einsum("qa,iad->iqd", quad, np.stack([e1 * half[:, None], e2 * half[:, None]], 1))
    cc = corners_w @ R.T + t  # (n,4,3)
    uvq = cm.project(cam, torch.as_tensor(cc, dtype=torch.float32)).numpy()
    for i in range(len(centers)):
        if Xc[i, 2] < 0.5 or np.any(cc[i, :, 2] < 0.2):
            continue
        u0 = max(int(np.floor(uvq[i, :, 0].min())), 0)
        u1 = min(int(np.ceil(uvq[i, :, 0].max())) + 1, w)
        v0 = max(int(np.floor(uvq[i, :, 1].min())), 0)
        v1 = min(int(np.ceil(uvq[i, :, 1].max())) + 1, h)
        if u1 <= u0 or v1 <= v0 or (u1 - u0) * (v1 - v0) > 200_000:
            continue
        dirs = all_dirs[v0:v1, u0:u1]
        pc, a1, a2 = Xc[i], R @ e1[i], R @ e2[i]
        nc = np.cross(a1, a2)
        denom = dirs @ nc
        ok = np.abs(denom) > 1e-9
        lam = (pc @ nc) / np.where(ok, denom, 1.0)
        hit = dirs * lam[..., None]
        rel = hit - pc
        a = rel @ a1 / (half[i] * 2)
        b = rel @ a2 / (half[i] * 2)
        inside = ok & (lam > 0.2) & (np.abs(a) <= 0.5) & (np.abs(b) <= 0.5)
        if not inside.any():
            continue
        depth = hit[..., 2]
        zb = zbuf[v0:v1, u0:u1]
        vis = inside & (depth < zb)
        if not vis.any():
            continue
        txf = np.clip((a + 0.5) * tile - 0.5, 0.0, tile - 1.001)
        tyf = np.clip((b + 0.5) * tile - 0.5, 0.0, tile - 1.001)
        x0i, y0i = txf.astype(np.int32), tyf.astype(np.int32)
        wx, wy = txf - x0i, tyf - y0i
        T_ = world["tex"][i]
        x1i, y1i = np.minimum(x0i + 1, tile - 1), np.minimum(y0i + 1, tile - 1)
        val = (T_[y0i, x0i] * (1 - wy) * (1 - wx) + T_[y0i, x1i] * (1 - wy) * wx
               + T_[y1i, x0i] * wy * (1 - wx) + T_[y1i, x1i] * wy * wx)
        img[v0:v1, u0:u1][vis] = val[vis]
        zb[vis] = depth[vis]
    return img


def make_ring_world(rng, n=1800, r_wall=9.0, half_h=2.5, tile=6):
    """Splats on a cylinder wall around the origin and over the whole floor
    and ceiling disc, a closed scene for a loop (synthetic.make_ring_world,
    the same draws from ``rng``)."""
    n_wall = n // 2
    a = rng.uniform(0, 2 * np.pi, n_wall)
    wall = np.stack([r_wall * np.cos(a), r_wall * np.sin(a), rng.uniform(-half_h, half_h, n_wall)], -1)
    n_fc = n - n_wall
    a2 = rng.uniform(0, 2 * np.pi, n_fc)
    rr = r_wall * np.sqrt(rng.uniform(0.0, 1.0, n_fc))
    zf = np.where(rng.uniform(size=n_fc) < 0.5, -half_h, half_h)
    fc = np.stack([rr * np.cos(a2), rr * np.sin(a2), zf], -1)
    tilt = rng.uniform(0.7, 3.0, n_fc)
    normals = np.concatenate([
        np.stack([-np.cos(a), -np.sin(a), np.zeros(n_wall)], -1),  # the wall faces inward
        np.stack([-np.cos(a2), -np.sin(a2), -np.sign(zf) * tilt], -1),  # floor and ceiling tilted inward
    ])
    e1, e2 = _frames_from_normals(normals)
    return {
        "centers": np.concatenate([wall, fc]).astype(np.float32),
        "sizes": rng.uniform(0.25, 0.7, n).astype(np.float32),
        "tex": rng.uniform(40.0, 230.0, (n, tile, tile)).astype(np.float32),
        "e1": e1,
        "e2": e2,
    }


def circle_trajectory(n_frames, radius=4.0, frac=1.1):
    """The camera circling the origin at ``radius``, looking along the
    tangent; ``frac`` > 1 revisits the start (synthetic.circle_trajectory).
    A list of T_cw as (R, t) numpy float32 pairs."""
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * frac * i / n_frames
        c, s = np.cos(a), np.sin(a)
        center = np.array([radius * c, radius * s, 0.0], np.float32)
        R_wc = np.stack([np.array([c, s, 0.0], np.float32), np.array([0.0, 0.0, -1.0], np.float32),
                         np.array([-s, c, 0.0], np.float32)], axis=1)  # columns: right, down, forward
        R = R_wc.T
        poses.append((R, -R @ center))
    return poses


def arc_trajectory(n_frames, step=0.08, yaw_rate=0.004, lateral=0.0):
    """Forward motion with a slow yaw (synthetic.arc_trajectory): a list of
    T_cw as (R, t) numpy float32 pairs."""
    from orb_slam3_fast_tpu_torch.utils import lie

    poses = []
    T_wc = lie.SE3.identity("cpu")
    inc = lie.se3_exp(torch.tensor([step * 0.3, lateral, step, 0.0, yaw_rate, 0.0], dtype=torch.float32))
    for _ in range(n_frames):
        T_cw = T_wc.inverse()
        poses.append((T_cw.R.numpy(), T_cw.t.numpy()))
        T_wc = T_wc.compose(inc)
    return poses


def arc_trajectory_with_imu(n_frames, dt_frame=0.05, imu_rate=200.0, step=0.08, yaw_rate=0.004, lateral=0.0,
                            g_world=(0.0, 9.81, 0.0), gyro_bias=(0.0, 0.0, 0.0), acc_bias=(0.0, 0.0, 0.0),
                            noise_gyro=0.0, noise_acc=0.0, seed=0, accel_amp=0.6, accel_freq=0.9, T_bc=None):
    """An arc whose speed is modulated sinusoidally and the IMU stream a
    body-mounted sensor measures on it (synthetic.arc_trajectory_with_imu,
    the same draws from ``seed``); the camera is the body, unless ``T_bc``
    (the (4,4) pose of the camera in the body, IMU.T_b_c1) puts the IMU
    elsewhere on the rig: it then measures the body's rotation rate and its
    specific force, the lever arm's centripetal term included.  Returns
    (T_cw per frame as (R, t) numpy float32 pairs, IMU rows (ts, ax, ay,
    az, wx, wy, wz))."""
    from orb_slam3_fast_tpu_torch.utils import lie

    rng = np.random.default_rng(seed)
    xi0 = np.array([step * 0.3, lateral, step, 0.0, yaw_rate, 0.0], np.float64) / dt_frame
    v0, w_b = xi0[:3], xi0[3:]
    g_w = np.asarray(g_world, np.float64)
    if T_bc is not None:  # the body's rotation from the camera, and its origin in the camera frame
        R_bc = np.asarray(T_bc, np.float64)[:3, :3]
        t_cb = -R_bc.T @ np.asarray(T_bc, np.float64)[:3, 3]
    dt_imu = 1.0 / imu_rate
    two_pi_f = 2.0 * np.pi * accel_freq
    poses, imu = [], []
    T_wb = lie.SE3.identity("cpu")
    for i in range(n_frames):
        T_cw = T_wb.inverse()
        poses.append((T_cw.R.numpy(), T_cw.t.numpy()))
        for j in range(int(round(dt_frame * imu_rate))):
            t0 = i * dt_frame + j * dt_imu
            m = 1.0 + accel_amp * np.sin(two_pi_f * t0)
            dm = accel_amp * two_pi_f * np.cos(two_pi_f * t0)
            R_wb = T_wb.R.numpy().astype(np.float64)
            f_b = v0 * dm + np.cross(w_b, v0 * m) - R_wb.T @ g_w
            if T_bc is not None:  # the IMU on the body: the rig's rotation and the lever arm's centripetal term
                f_b = R_bc @ (f_b + np.cross(w_b, np.cross(w_b, t_cb)))
            a_meas = f_b + np.asarray(acc_bias) + rng.normal(0, noise_acc, 3)
            w_meas = (w_b if T_bc is None else R_bc @ w_b) + np.asarray(gyro_bias) + rng.normal(0, noise_gyro, 3)
            imu.append([t0 + dt_imu, *a_meas, *w_meas])
            m_mid = 1.0 + accel_amp * np.sin(two_pi_f * (t0 + 0.5 * dt_imu))
            xi = np.concatenate([v0 * m_mid, w_b]) * dt_imu
            T_wb = T_wb.compose(lie.se3_exp(torch.tensor(xi, dtype=torch.float32)))
    return poses, np.asarray(imu)


def stereo_pair(world, cam, R, t, baseline, wh=(640, 480)):
    """The right camera sits +baseline along x of the left one."""
    return render(world, cam, R, t, wh), render(world, cam, R, np.asarray(t) - np.array([baseline, 0.0, 0.0]), wh)


def splat_depth(world, cam, R, t, wh=(640, 480)) -> np.ndarray:
    """The RGB-D test's depth map (tests/test_slam_e2e.py:102-116): each
    splat's square footprint at its centre's depth, far to near, 0 where no
    splat lies (invalid)."""
    from orb_slam3_fast_tpu_torch.cameras import models as cm

    w, h = wh
    Xc = world["centers"] @ np.asarray(R, np.float32).T + np.asarray(t, np.float32)
    uv = cm.project(cam, torch.as_tensor(Xc)).numpy()
    depth = np.zeros((h, w), np.float32)
    fx = float(cam.params[0])
    for j in np.argsort(-Xc[:, 2]):
        z = Xc[j, 2]
        if z < 0.5:
            continue
        u, v = uv[j]
        s = world["sizes"][j] * fx / z
        if s < 2:
            continue
        u0, v0, u1, v1 = int(u - s / 2), int(v - s / 2), int(u + s / 2), int(v + s / 2)
        depth[max(v0, 0) : max(v1, 0), max(u0, 0) : max(u1, 0)] = z
    return depth


# --- phase 3: each kernel against its plain version ---------------------------


_RENDER_POOL = None  # main()'s pool of render workers while it is open (render_pool)


@contextlib.contextmanager
def render_pool():
    """One pool of spawn worker processes (a torch thread each, one a core,
    at most 8) that renders every scene ``main`` draws while it is open;
    its workers exit when it closes.  Each image is the same, rendered
    here or there: ``render`` is numpy and elementwise torch."""
    global _RENDER_POOL
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max(1, min(8, os.cpu_count() or 1)), mp_context=multiprocessing.get_context("spawn"),
                             initializer=torch.set_num_threads, initargs=(1,)) as ex:
        _RENDER_POOL = ex
        try:
            yield
        finally:
            _RENDER_POOL = None


def render_map(fn, items, parallel: bool = False) -> list:
    """``[fn(x) for x in items]``: on ``render_pool``'s workers while it is
    open, else on a pool of its own with ``parallel`` (the 150-frame
    circles), else in this process."""
    if _RENDER_POOL is not None:
        return list(_RENDER_POOL.map(fn, items))
    if not parallel:
        return [fn(x) for x in items]
    with render_pool():
        return list(_RENDER_POOL.map(fn, items))


def _render_view(kind: str, world, cams, pose):
    """One frame of a corridor scene from T_cw ``pose``: ``"mono"`` an
    image, ``"mono1"`` a 1-tuple of it, ``"stereo"`` a 0.12 m stereo pair,
    ``"rgbd"`` the image and its splat depth, ``"rig"`` the two cameras of
    ``cams = (cam1, cam2, T_c1_c2)`` at ``FISHEYE_WH``."""
    R, t = pose
    if kind == "mono":
        return render(world, cams[0], R, t)
    if kind == "mono1":
        return (render(world, cams[0], R, t),)
    if kind == "stereo":
        return stereo_pair(world, cams[0], R, t, 0.12)
    if kind == "rgbd":
        return render(world, cams[0], R, t), splat_depth(world, cams[0], R, t)
    return stereo_pair_cams(world, cams[0], cams[1], R, t, cams[2], FISHEYE_WH)


def render_views(kind: str, world, cams, poses) -> list:
    """``_render_view`` at each pose, through :func:`render_map`."""
    return render_map(functools.partial(_render_view, kind, world, tuple(cams)), list(poses))


def compare_kernels(device) -> list[dict]:
    from orb_slam3_fast_tpu_torch.frontend.tracker import visible_landmarks
    from orb_slam3_fast_tpu_torch.ops import extractor as ext
    from orb_slam3_fast_tpu_torch.ops import fast
    from orb_slam3_fast_tpu_torch.ops import hamming as ham
    from orb_slam3_fast_tpu_torch.ops import image
    from orb_slam3_fast_tpu_torch.ops import matching as mat
    from orb_slam3_fast_tpu_torch.optim import pose_opt
    from orb_slam3_fast_tpu_torch.utils import lie

    rig = Rig(640, 480)
    cfg = ext.ExtractorConfig(n_features=1024)
    step, lm, canvas = setup(rig, device, seed=1)
    il, ir = frame(canvas, rig, 1, device)
    out = []

    # A: FAST + NMS on the 8 levels of one 640x480 image
    levels = image.build_pyramid(il, cfg.n_levels, cfg.scale_factor)
    err = 0.0
    for lv in levels:
        for k, p in zip(fast.fast_nms(lv, 20.0, 7.0, ext.EDGE_BORDER), fast.fast_nms_plain(lv, 20.0, 7.0, ext.EDGE_BORDER)):
            err = max(err, float((k - p).abs().max()))
        torch.cuda.synchronize()
    if err != 0.0:
        raise RuntimeError(f"fast_nms differs from its plain version by {err}")
    ms = cuda_ms(lambda: [fast.fast_nms(lv, 20.0, 7.0, ext.EDGE_BORDER) for lv in levels], 50)
    plain_ms = cuda_ms(lambda: [fast.fast_nms_plain(lv, 20.0, 7.0, ext.EDGE_BORDER) for lv in levels], 10)
    px = sum(lv.numel() for lv in levels)
    # per pixel: 4 bytes read, 8 written; 16 circle differences, 64
    # threshold tests, up to 64 adds, the run tests and 8 NMS maxima (~150)
    out.append(dict(name="fast_nms", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/fast_nms.cu",
                    replaces="orb_slam3_fast_tpu/ops/fast.py:62", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    **bound(12 * px, 150 * px), library_ms=None, shapes="8 levels of 480x640, tolerance exact"))

    # B: angle + BRIEF for the 1024 slots of that image
    kp = ext.extract(il, cfg)
    blurs = [image.gaussian_blur(lv) for lv in levels]
    scales = torch.as_tensor(ext.slot_scales(cfg), device=device)
    xy = torch.round(kp.xy / scales[:, None]).to(torch.int32)  # level-local integer positions (sub < 0.5 px)
    desc_in = ext.describe_inputs(levels, blurs, kp.level)
    a_k, d_k = ext.orb_describe(*desc_in, xy)
    a_p, d_p = ext.orb_describe_plain(*desc_in, xy)
    torch.cuda.synchronize()
    a_err = float((a_k - a_p).abs().max())
    bit_diff = float((ham.unpack_desc(d_k) != ham.unpack_desc(d_p)).float().mean())
    # the angle is a sum of 961 products in another order (~1e-5 rad); a
    # bit flips only where that moves a rotated sample across a rounding edge
    if a_err > 1e-3 or bit_diff > 1e-3:
        raise RuntimeError(f"orb_describe: angle err {a_err}, bit mismatch {bit_diff}")
    ms = cuda_ms(lambda: ext.orb_describe(*desc_in, xy), 50)
    plain_ms = cuda_ms(lambda: ext.orb_describe_plain(*desc_in, xy), 10)
    n_kp = xy.shape[0]
    # per keypoint: the 31x31 and 29x29 patches read, 12 bytes in, 36 out;
    # 961 moment terms (4 flops) and 512 rotated samples (~10 flops)
    out.append(dict(name="orb_describe", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/orb_describe.cu",
                    replaces="orb_slam3_fast_tpu/ops/extractor.py:297", max_abs_err=a_err, ms=ms, plain_ms=plain_ms,
                    **bound(n_kp * ((961 + 841) * 4 + 48), n_kp * (961 * 4 + 512 * 10)), library_ms=None,
                    shapes=f"1024 keypoints over 8 levels, angle tol 1e-3 rad, bit mismatch {bit_diff:.2e} <= 1e-3"))

    # C: stereo mode (1024 x 1024) and window mode (4096 x 1024)
    kp_r = ext.extract(ir, cfg)
    f32 = torch.float32
    sgate = ham.StereoGate(
        kp.xy[:, 0].contiguous(), kp.xy[:, 1].contiguous(), kp.level.to(f32), kp.valid.to(f32),
        kp_r.xy[:, 0].contiguous(), kp_r.xy[:, 1].contiguous(), (2.0 * step.slot_scales).contiguous(),
        kp_r.level.to(f32), kp_r.valid.to(f32), rig.bf / step.min_z,
    )
    uv, pred, vis = visible_landmarks(
        step.cam, torch.eye(3, device=device), torch.as_tensor(rig.t_true(1), device=device), lm.pos, lm.mask,
        lm.normal, lm.dmin, lm.dmax, (rig.w, rig.h),
    )
    wgate = ham.WindowGate(
        uv[:, 0].contiguous(), uv[:, 1].contiguous(), 3.0 * mat._pow_level(pred, step.scales), pred.to(f32),
        vis.to(f32), kp.xy[:, 0].contiguous(), kp.xy[:, 1].contiguous(), kp.level.to(f32), kp.valid.to(f32),
    )
    err = 0.0
    for da, db, gate in ((kp.desc, kp_r.desc, sgate), (lm.desc, kp.desc, wgate)):
        (bk, ck), (bp, cp) = ham.hamming_best2(da, db, gate), ham.hamming_best2_plain(da, db, gate)
        torch.cuda.synchronize()
        if not (torch.equal(bk.idx, bp.idx) and torch.equal(bk.idx2, bp.idx2)):
            raise RuntimeError("hamming_best2: indices differ from the plain version")
        if ck is not None and not torch.equal(ck, cp):
            raise RuntimeError("hamming_best2: column argmin differs from the plain version")
        err = max(err, float((bk.dist.double() - bp.dist.double()).abs().max()),
                  float((bk.dist2.double() - bp.dist2.double()).abs().nan_to_num(posinf=0.0).max()))
    if err != 0.0:
        raise RuntimeError(f"hamming_best2 distances differ by {err}")
    ms_s = cuda_ms(lambda: ham.hamming_best2(kp.desc, kp_r.desc, sgate), 50)
    ms_w = cuda_ms(lambda: ham.hamming_best2(lm.desc, kp.desc, wgate), 50)
    pms_s = cuda_ms(lambda: ham.hamming_best2_plain(kp.desc, kp_r.desc, sgate), 10)
    pms_w = cuda_ms(lambda: ham.hamming_best2_plain(lm.desc, kp.desc, wgate), 10)
    # every pair's gate (~8 operations); the distance (8 xor, 8 popcount,
    # 8 adds) where the gate lets it through: every pair in stereo mode
    n_s, n_w = kp.n * kp_r.n, int(ham.window_mask(wgate).sum())
    c_bytes = sum((a.shape[0] + b.shape[0]) * 52 + a.shape[0] * 16 for a, b in ((kp.desc, kp_r.desc), (lm.desc, kp.desc)))
    c_ops = 8 * (kp.n * kp_r.n + lm.desc.shape[0] * kp.n) + 24 * (n_s + n_w)
    out.append(dict(name="hamming_best2", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/hamming_best2.cu",
                    replaces="orb_slam3_fast_tpu/ops/hamming.py:28", max_abs_err=err, ms=ms_s + ms_w,
                    plain_ms=pms_s + pms_w, nbytes=c_bytes, ops=c_ops, library_ms=None,
                    shapes=f"stereo 1024x1024 {ms_s:.4f} ms (plain {pms_s:.4f}), window 4096x1024 "
                           f"{ms_w:.4f} ms (plain {pms_w:.4f}), tolerance exact"))

    # D: pose optimisation over the 1024 slots of frame 1
    kp_l, right_u = step.front(il, ir)
    T0 = lie.SE3(torch.eye(3, device=device), torch.as_tensor(rig.t_true(0), device=device))
    idx, accept = step.match_map(kp_l, T0, lm)
    obs = step.pose_obs(kp_l, right_u, idx, accept, lm)
    Tk, ik, nk = pose_opt.pose_optimization(step.cam, rig.bf, T0, obs)
    (Tp, ip, np_), plain_ms = timed(lambda: pose_opt.pose_optimization_plain(step.cam, rig.bf, T0, obs))
    err = max(float((Tk.t - Tp.t).abs().max()), float((Tk.R - Tp.R).abs().max()))
    # sums in another order can flip a borderline LM accept: pose within
    # 1e-3 (m, and rotation entries), inlier counts within 2
    if err > 1e-3 or abs(int(nk) - int(np_)) > 2:
        raise RuntimeError(f"pose_lm: pose err {err}, inliers {int(nk)} vs {int(np_)}")
    ms = cuda_ms(lambda: pose_opt.pose_optimization(step.cam, rig.bf, T0, obs), 50)
    n_edge = int(obs.valid.sum())
    # per active edge and LM iteration (4 x 10): residual, Jacobian and
    # normal-equation terms, ~150 flops; 30 bytes in and 1 out per slot
    # D with a distorted camera (EuRoC cam0's coefficients on the synthetic intrinsics): the same slots, their
    # pixels projected through it at frame 1's pose with 0.5 px noise, from frame 0's pose
    from orb_slam3_fast_tpu_torch.cameras.models import Camera, stereo_project

    cam_d = Camera.pinhole(400.0, 400.0, 320.0, 240.0, EUROC_DIST)
    T1 = lie.SE3(torch.eye(3, device=device), torch.as_tensor(rig.t_true(1), device=device))
    g = torch.Generator().manual_seed(4)
    uvr = stereo_project(cam_d, T1.apply(obs.xw), rig.bf).cpu() + 0.5 * torch.randn(obs.xw.shape[0], 3, generator=g)
    uvr[:, 2] = torch.where(obs.is_stereo.cpu(), uvr[:, 2], -1.0)
    uvr = torch.where(obs.valid.cpu()[:, None], uvr, obs.uv.cpu())  # the empty slots as the tracker leaves them
    obs_d = obs._replace(uv=uvr.to(device).contiguous())
    Tk, ik, nk = pose_opt.pose_optimization(cam_d, rig.bf, T0, obs_d)
    (Tp, ip, np_), plain_d = timed(lambda: pose_opt.pose_optimization_plain(cam_d, rig.bf, T0, obs_d))
    err_d = max(float((Tk.t - Tp.t).abs().max()), float((Tk.R - Tp.R).abs().max()))
    if err_d > 1e-3 or abs(int(nk) - int(np_)) > 2:
        raise RuntimeError(f"pose_lm with distortion: pose err {err_d}, inliers {int(nk)} vs {int(np_)}")
    ms_d = cuda_ms(lambda: pose_opt.pose_optimization(cam_d, rig.bf, T0, obs_d), 50)
    out.append(dict(name="pose_lm", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/pose_lm.cu",
                    replaces="orb_slam3_fast_tpu/optim/pose_opt.py:117", max_abs_err=max(err, err_d), ms=ms,
                    plain_ms=plain_ms, **bound(obs.xw.shape[0] * 31 + 96, n_edge * 40 * 150), library_ms=None,
                    shapes=f"{int(obs.valid.sum())} active of 1024 edges, 4x10 LM, tolerance 1e-3; with EuRoC "
                           f"cam0's distortion {ms_d:.4f} ms (plain {plain_d:.4f}), pose err {err_d:.3g}, inliers "
                           f"{int(nk)} / {int(np_)} (tolerance 1e-3 and 2)"))
    return out + compare_front_kernels(device, cfg, step, lm, il, ir, kp, kp_r)


def near(x: torch.Tensor, threshold: float, tol: float = 1e-5) -> torch.Tensor:
    """Where a float quantity lies within ``tol`` (relative) of a threshold."""
    return (x - threshold).abs() <= tol * max(abs(threshold), 1.0)


def visibility_borderline(R, t, lm, uv, wh, sf: float) -> torch.Tensor:
    """Landmark slots where one of kernel L's tests, or PredictScale's
    log(ratio) / log(sf), lies within 1e-5 of its threshold: there float
    rounding in another order may flip a flag or a level."""
    pos, normal, dmin, dmax = lm.pos, lm.normal, lm.dmin, lm.dmax
    xc = pos @ R.T + t
    po = pos + R.T @ t
    dist = po.norm(dim=1)
    q = torch.log(dmax / dist.clamp(min=1e-9)) / float(np.log(sf))  # unclamped: ratio < 1 is level 0 on both
    return (((q - q.round()).abs() <= 1e-5) | near(xc[:, 2], 0.05) | near(uv[:, 0], 0.0)
            | near(uv[:, 0], float(wh[0])) | near(uv[:, 1], 0.0) | near(uv[:, 1], float(wh[1]))
            | near(dist / (dmin * 0.8).clamp(min=1e-12), 1.0) | near(dist / (dmax * 1.2).clamp(min=1e-12), 1.0)
            | near((po * normal).sum(1) / dist.clamp(min=1e-9), 0.5))


def compare_front_kernels(device, cfg, step, lm, il, ir, kp, kp_r) -> list[dict]:
    """Phase 3 for H, I, J and L, and the whole extraction on the card
    against the plain one: H at 640x480 and 1280x720, I on kernel A's maps
    of those pyramids and on a tie-heavy map, J on the 1024 stereo matches
    of the step's frame, L on its 4096-slot local map at two poses."""
    from orb_slam3_fast_tpu_torch.frontend import tracker as trk
    from orb_slam3_fast_tpu_torch.ops import extractor as ext
    from orb_slam3_fast_tpu_torch.ops import fast, image
    from orb_slam3_fast_tpu_torch.ops import matching as mat
    from orb_slam3_fast_tpu_torch.utils import lie

    out = []
    big = Rig(1280, 720)
    images = {(640, 480): il, (1280, 720): frame(make_canvas(np.random.default_rng(5), big), big, 0, device)[0]}
    nl, sf = cfg.n_levels, cfg.scale_factor

    # H: levels within 1e-4 of F.interpolate's chain; each blur bit-equal to
    # gaussian_blur of the kernel's own level
    h_err = blur_err = 0.0
    blur_bad = h_bytes = h_ops = 0
    h_ms, h_pms, notes, maps = [], [], [], {}
    for (w, h), img in images.items():
        shapes, offs = image.pyramid_layout(h, w, nl, sf)
        lk, bk = image.pyramid_blur(img, nl, sf)
        lp, bp = image.pyramid_blur_plain(img, nl, sf)
        torch.cuda.synchronize()
        h_err = max(h_err, float((lk - lp).abs().max()))
        blur_err = max(blur_err, float((bk - bp).abs().max()))
        blur_bad += sum(int((b != image.gaussian_blur(lv)).sum())
                        for lv, b in zip(image.level_views(lk, shapes, offs), image.level_views(bk, shapes, offs)))
        h_ms.append(cuda_ms(lambda: image.pyramid_blur(img, nl, sf), 50))
        h_pms.append(cuda_ms(lambda: image.pyramid_blur_plain(img, nl, sf), 10))
        notes.append(f"{w}x{h} {h_ms[-1]:.4f} ms (plain {h_pms[-1]:.4f})")
        # the image read once, every level and blur written once; ~10 flops
        # of resize and 28 of blur per level pixel
        h_bytes += 4 * h * w + 8 * lk.numel()
        h_ops += 38 * lk.numel()
        raw, nms = torch.empty_like(lk), torch.empty_like(lk)
        for lv, r, m in zip(*(image.level_views(x, shapes, offs) for x in (lk, raw, nms))):
            fast.fast_nms(lv, cfg.ini_th_fast, cfg.min_th_fast, ext.EDGE_BORDER, out=(r, m))
        maps[(w, h)] = (nms, raw, shapes, offs)
    if not (h_err <= 1e-4 and blur_bad == 0):
        raise RuntimeError(f"pyramid_blur: levels differ by {h_err:.3g} (tolerance 1e-4), {blur_bad} blurred pixels "
                           "differ from gaussian_blur of the kernel's level")
    out.append(dict(name="pyramid_blur", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/pyramid_blur.cu",
                    replaces="orb_slam3_fast_tpu/ops/image.py:59", max_abs_err=h_err, ms=sum(h_ms), plain_ms=sum(h_pms),
                    **bound(h_bytes, h_ops), library_ms=None,
                    shapes=f"8 levels + blurs of {', '.join(notes)}; levels within 1e-4 grey (F.interpolate on the "
                           f"card), blurs bit-equal to gaussian_blur of the kernel's level ({blur_err:.3g} from the "
                           "plain chain's)"))

    # I: exact on both pyramids' maps and on a tie-heavy map of small integers
    nms0, raw0, shapes0, offs0 = maps[(640, 480)]
    rng = np.random.default_rng(6)
    ties = torch.as_tensor((rng.integers(0, 4, nms0.numel()) * (rng.uniform(size=nms0.numel()) < 0.2))
                           .astype(np.float32), device=device)
    i_ms, i_pms, notes, i_bytes, i_ops = [], [], [], 0, 0
    for label, args in [(f"{w}x{h}", m) for (w, h), m in maps.items()] + [("ties", (ties, raw0, shapes0, offs0))]:
        got, want = ext.select_subpixel(*args, cfg), ext.select_subpixel_plain(*args, cfg)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise RuntimeError(f"select_subpixel differs from its plain version on the {label} map")
        if label == "ties":
            notes.append(f"tie-heavy map exact ({int(want[3].sum())} valid)")
            continue
        i_ms.append(cuda_ms(lambda: ext.select_subpixel(*args, cfg), 50))
        i_pms.append(cuda_ms(lambda: ext.select_subpixel_plain(*args, cfg), 10))
        notes.append(f"{label} {i_ms[-1]:.4f} ms (plain {i_pms[-1]:.4f})")
        # the NMS map read once, 5 pre-NMS pixels per slot, 21 bytes out per
        # slot; K compares per pixel for the cell top-K, the bitonic sort of
        # each level's candidates, ~20 flops per slot
        n = got[0].shape[0]
        cand = [-(-h // cfg.cell) * -(-w // cfg.cell) * cfg.cand_per_cell for h, w in args[2]]
        sort_ops = sum(p * k * (k + 1) / 4 for p, k in ((1 << (c - 1).bit_length(), (c - 1).bit_length()) for c in cand))
        i_bytes += 4 * args[0].numel() + 20 * n + 21 * n
        i_ops += cfg.cand_per_cell * args[0].numel() + sort_ops + 20 * n
    out.append(dict(name="select_subpixel", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/select_subpixel.cu",
                    replaces="orb_slam3_fast_tpu/ops/extractor.py:140", max_abs_err=0.0, ms=sum(i_ms),
                    plain_ms=sum(i_pms), **bound(i_bytes, i_ops), library_ms=None,
                    shapes=f"{', '.join(notes)}; 1024 slots, tolerance exact"))

    # the whole extraction: the card's kernels against the plain versions on
    # the card -- the same valid slots, angles within 1e-4 rad, at most 1%
    # of the slots' descriptor words differing
    for (w, h), img in images.items():
        kk, kpl = ext.extract(img, cfg), ext.extract_plain(img, cfg)
        torch.cuda.synchronize()
        same_valid = torch.equal(kk.valid, kpl.valid)
        v = kpl.valid
        xy_err = float((kk.xy - kpl.xy)[v].abs().max())
        ang_err = float((kk.angle - kpl.angle)[v].abs().max())
        words = int((kk.desc != kpl.desc)[v].sum())
        log(f"extract {w}x{h} on the card against the plain extractor on the card: valid slots equal {same_valid} "
            f"({int(v.sum())}), max |dxy| {xy_err:.3g} px, max |dangle| {ang_err:.3g} rad, {words} descriptor words "
            f"differ ({words / kk.n:.4f} of {kk.n} slots)")
        if not (same_valid and xy_err <= 1e-3 and ang_err <= 1e-4 and words <= 0.01 * kk.n):
            raise RuntimeError(f"extract {w}x{h}: the card's extraction differs from the plain one beyond the bounds")

    # J: 1024 stereo matches of the step's frame
    sm = mat.stereo_match(kp, kp_r, step.scales, bf=step.bf, min_z=step.min_z, slot_scale_r=step.slot_scales)
    args = (il, ir, kp.xy, sm.right_u, sm.valid)
    (uk, okk), (up, okp) = mat.stereo_subpixel_refine(*args), mat.stereo_subpixel_refine_plain(*args)
    sad, _ = mat.sad_table(*args[:4])
    two = torch.sort(sad, dim=1).values[:, :2]
    tie = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0].abs().clamp(min=1.0)
    both = okk & okp & ~tie
    j_err = float((uk - up)[both].abs().max()) if bool(both.any()) else 0.0
    if not (torch.equal(okk[~tie], okp[~tie]) and j_err <= 1e-3):
        raise RuntimeError(f"stereo_subpixel_refine: ok differs off near-tie rows, or u by {j_err:.3g} px")
    n = kp.n
    out.append(dict(name="stereo_subpixel_refine", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/sad_refine.cu",
                    replaces="orb_slam3_fast_tpu/ops/matching.py:380", max_abs_err=j_err,
                    ms=cuda_ms(lambda: mat.stereo_subpixel_refine(*args), 50),
                    plain_ms=cuda_ms(lambda: mat.stereo_subpixel_refine_plain(*args), 10),
                    # 121 left and 231 right pixels per match, 13 bytes in, 5
                    # out; 11 offsets x 121 pixels x 3 flops
                    **bound(n * (352 * 4 + 18), n * (11 * 121 * 3 + 20)), library_ms=None,
                    shapes=f"{n} matches ({int(sm.valid.sum())} valid, {int(okp.sum())} refined); u within 1e-3 px, "
                           f"ok equal off the {int(tie.sum())} rows whose two least SADs lie within 1e-5"))

    # L: the 4096-slot local map at the step's pose and at a turned one
    wh = (640, 480)
    poses = [lie.SE3(torch.eye(3, device=device), torch.as_tensor(Rig(640, 480).t_true(1), device=device)),
             lie.se3_exp(torch.tensor([0.05, -0.02, 0.1, 0.02, -0.03, 0.01], device=device))]
    l_err, n_border, n_vis = 0.0, 0, []
    for T in poses:
        lm_args = (lm.pos, lm.mask, lm.normal, lm.dmin, lm.dmax, wh)
        (uvk, lvk, vk), (uvp, lvp, vp) = (trk.visible_landmarks(step.cam, T.R, T.t, *lm_args),
                                          trk.visible_landmarks_plain(step.cam, T.R, T.t, *lm_args))
        border = visibility_borderline(T.R, T.t, lm, uvp, wh, cfg.scale_factor)
        l_err = max(l_err, float((uvk - uvp)[lm.mask].abs().max()))
        n_border += int(border.sum())
        n_vis.append(int(vp.sum()))
        if not (torch.equal(lvk[~border], lvp[~border]) and torch.equal(vk[~border], vp[~border]) and l_err <= 1e-3):
            raise RuntimeError(f"visible_landmarks: uv differs by {l_err:.3g} px, or a level or flag off the "
                               "borderline rows")
    m = lm.pos.shape[0]
    T = poses[1]
    lm_args = (lm.pos, lm.mask, lm.normal, lm.dmin, lm.dmax, wh)
    out.append(dict(name="visible_landmarks", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/visible_landmarks.cu",
                    replaces="orb_slam3_fast_tpu/frontend/tracker.py:92", max_abs_err=l_err,
                    ms=cuda_ms(lambda: trk.visible_landmarks(step.cam, T.R, T.t, *lm_args), 50),
                    plain_ms=cuda_ms(lambda: trk.visible_landmarks_plain(step.cam, T.R, T.t, *lm_args), 10),
                    # 33 bytes in and 17 out per slot; ~100 flops per slot
                    **bound(50 * m + 48, 100 * m), library_ms=None,
                    shapes=f"{m} slots at two poses ({n_vis} visible); uv within 1e-3 px, level and visible equal "
                           f"off the {n_border} borderline rows"))
    return out


def ba_problem(rng, device, cam=None):
    """A seeded local-BA problem at the path's caps (MapperConfig: 12 + 8
    keyframes padded to K = 32, 4096 landmarks, 16384 observations): 20
    free poses and 8 fixed ones along a forward arc, the rest padding; every
    landmark seen from 4 random poses; 60% stereo edges, 10% outliers, 0.5
    px noise; free poses and landmarks perturbed from the truth.  The pixels
    are those of the synthetic pin-hole camera, or of ``cam`` (the port's
    projection) where it is given."""
    from orb_slam3_fast_tpu_torch.optim import ba
    from orb_slam3_fast_tpu_torch.utils import lie

    K, live, fixed, M, obs_per_lm = 32, 20, 8, 4096, 4
    n_real = live + fixed
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.zeros((K, 3), np.float32)
    for k in range(n_real):
        T = lie.se3_exp(torch.tensor([0.02 * k, 0.0, 0.1 * k, 0.0, 0.004 * k, 0.0])).inverse()
        R[k], t[k] = T.R.numpy(), T.t.numpy()
    X = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M), rng.uniform(5, 30, M)], -1).astype(np.float32)
    lm = np.repeat(np.arange(M), obs_per_lm).astype(np.int32)
    kf = rng.integers(0, n_real, len(lm)).astype(np.int32)
    xc = np.einsum("oij,oj->oi", R[kf], X[lm]) + t[kf]
    fx, cx, cy, bf = 400.0, 320.0, 240.0, 48.0
    u = fx * xc[:, 0] / xc[:, 2] + cx
    uv = np.stack([u, fx * xc[:, 1] / xc[:, 2] + cy, u - bf / xc[:, 2]], -1)
    if cam is not None:
        from orb_slam3_fast_tpu_torch.cameras.models import stereo_project

        uv = stereo_project(cam, torch.as_tensor(xc.astype(np.float32)), bf).numpy().astype(np.float64)
    uv = uv + rng.normal(0, 0.5, (len(lm), 3))
    out = rng.uniform(size=len(lm)) < 0.1
    uv[out, :2] += rng.uniform(15, 40, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
    stereo = rng.uniform(size=len(lm)) < 0.6
    uv[~stereo, 2] = -1.0
    pose_fixed = np.ones(K, bool)
    pose_fixed[fixed:n_real] = False
    t0 = t.copy()
    t0[~pose_fixed] += rng.normal(0, 0.02, ((~pose_fixed).sum(), 3)).astype(np.float32)
    return ba.make_problem(
        R, t0, pose_fixed, X + rng.normal(0, 0.05, X.shape).astype(np.float32), np.ones(M, bool), kf, lm,
        uv.astype(np.float32), (1.0 / 1.44 ** rng.integers(0, 4, len(lm))).astype(np.float32), stereo,
        np.ones(len(lm), bool), device=device,
    )


def schur_bytes_ops(prob) -> tuple[float, float]:
    """Kernel F's least work on ``prob``: per landmark with n observations
    n^2 6x3x6 products (216 flops each) into S and a 3x3 inverse; the 6K
    Cholesky (6K)^3 / 3; the blocks read once (E's outputs), dp and dl
    written."""
    K, M, O = prob.R.shape[0], prob.xw.shape[0], prob.obs_kf.shape[0]
    n_obs = torch.bincount(prob.obs_lm[prob.obs_valid].long(), minlength=M).double()
    return K * 168 + M * 52 + O * 72 + K * 24 + M * 12, 216 * float((n_obs**2).sum()) + 60 * M + (6 * K) ** 3 / 3


def corridor_keypoints(device):
    """Keypoints (768 features) of two corridor frames 6 cm apart, with F
    from their true poses: the inputs of kernel C's epipolar and mutual
    modes at the System's shapes."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera
    from orb_slam3_fast_tpu_torch.ops import extractor as ext

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    world = make_corridor_world(np.random.default_rng(1), n=900)
    poses = arc_trajectory(6, step=0.06, lateral=0.05)
    cfg = ext.ExtractorConfig(n_features=768)
    kps = [ext.extract(torch.as_tensor(render(world, cam, *poses[i])).to(device), cfg) for i in (0, 5)]
    (Ra, ta), (Rb, tb) = poses[0], poses[5]
    R_ba = Rb @ Ra.T  # a -> b
    t_ba = tb - R_ba @ ta
    tx = np.array([[0, -t_ba[2], t_ba[1]], [t_ba[2], 0, -t_ba[0]], [-t_ba[1], t_ba[0], 0]])
    Kinv = np.linalg.inv(cam.K().numpy().astype(np.float64))
    F_ab = (Kinv.T @ tx @ R_ba @ Kinv).astype(np.float32)  # x_b^T F x_a = 0
    return kps, torch.as_tensor(F_ab).to(device), torch.as_tensor(ext.level_sigma2(cfg)).to(device)


def compare_system_kernels(device) -> tuple[list[dict], dict]:
    """Phase 3 for the System's kernels: E + F on a BA problem at the path's
    caps, G on N_DLT matches, C's epipolar and mutual modes at 768 x 768,
    each against its plain version, with CUDA-event times; F's failure flag
    on an indefinite system.  Returns (E, F, G entries, C's two modes)."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera
    from orb_slam3_fast_tpu_torch.ops import hamming as ham
    from orb_slam3_fast_tpu_torch.ops import matching as mat
    from orb_slam3_fast_tpu_torch.ops import twoview
    from orb_slam3_fast_tpu_torch.optim import ba

    rng = np.random.default_rng(3)
    cam, bf = Camera.pinhole(400.0, 400.0, 320.0, 240.0), 48.0
    prob = ba_problem(rng, device)
    K, M, O = prob.R.shape[0], prob.xw.shape[0], prob.obs_kf.shape[0]
    out = []

    # E: the blocks; W scattered into Z for the comparison
    inl = torch.ones_like(prob.obs_valid)
    args = (cam, bf, prob.R, prob.t, prob.xw, prob, inl)
    bk, bp = ba.build_normal_blocks(*args), ba.build_normal_blocks_plain(*args)
    Zk = ba.coupling_to_dense(bk[4], prob)
    err_e = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-12)
                for x, y in zip((*bk[:4], Zk, *bk[5:]), bp))
    # atomics sum in another order: every block within 1e-4 of its max
    if not err_e <= 1e-4:
        raise RuntimeError(f"ba_blocks: a block differs by {err_e:.3g} of its max from the plain version")
    # per observation: 28 bytes in, a 6x3 W (72 bytes) out, ~600 flops of
    # projection, Jacobians and block products; per pose 48 bytes in and 168
    # out, per landmark 13 in and 52 out
    e_bytes = O * (28 + 72) + K * (48 + 168) + M * (13 + 52)
    # E with a distorted camera: the same problem, its pixels through EuRoC cam0's distortion
    cam_d = Camera.pinhole(400.0, 400.0, 320.0, 240.0, EUROC_DIST)
    prob_d = ba_problem(np.random.default_rng(3), device, cam=cam_d)
    args_d = (cam_d, bf, prob_d.R, prob_d.t, prob_d.xw, prob_d, inl)
    bk_d, bp_d = ba.build_normal_blocks(*args_d), ba.build_normal_blocks_plain(*args_d)
    err_ed = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-12)
                 for x, y in zip((*bk_d[:4], ba.coupling_to_dense(bk_d[4], prob_d), *bk_d[5:]), bp_d))
    if not err_ed <= 1e-4:
        raise RuntimeError(f"ba_blocks with distortion: a block differs by {err_ed:.3g} of its max")
    ms_ed = cuda_ms(lambda: ba.build_normal_blocks(*args_d), 20)
    plain_ed = cuda_ms(lambda: ba.build_normal_blocks_plain(*args_d), 5)
    out.append(dict(name="ba_blocks", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/ba_blocks.cu",
                    replaces="orb_slam3_fast_tpu/optim/ba.py:72", max_abs_err=max(err_e, err_ed),
                    **bound(e_bytes, 600 * O), library_ms=None,
                    ms=cuda_ms(lambda: ba.build_normal_blocks(*args), 20),
                    plain_ms=cuda_ms(lambda: ba.build_normal_blocks_plain(*args), 5),
                    shapes=f"K={K} ({int((~prob.pose_fixed).sum())} free), M={M}, O={O}; error relative to each "
                           f"block's max, tolerance 1e-4; with EuRoC cam0's distortion {ms_ed:.4f} ms (plain "
                           f"{plain_ed:.4f}), every block within {err_ed:.2e} of its max (tolerance 1e-4)"))

    # F: the same blocks into the kernel and into a float64 plain solve
    lam = torch.tensor(1e-4, device=device)
    dk, lk, ok = ba.schur_solve(*bk[:6], prob, lam)
    if not bool(ok):
        raise RuntimeError("ba_schur: the Cholesky solve failed on a positive definite system")
    b64 = [x.double() for x in (*bk[:4], Zk, bk[5])]
    d64, l64 = ba.schur_solve_plain(*b64, prob.pose_fixed, prob.lm_valid, lam.double())
    err_f = max(float((dk.double() - d64).abs().max() / d64.abs().max()),
                float((lk.double() - l64).abs().max() / l64.abs().max()))
    d32, _ = ba.schur_solve_plain(*bp[:6], prob.pose_fixed, prob.lm_valid, lam)
    err_f32 = float((dk - d32).abs().max() / d32.abs().max())
    if not err_f <= 1e-4:
        raise RuntimeError(f"ba_schur: dp / dl differ by {err_f:.3g} (relative) from the float64 plain solve")
    # a reduced system that is not positive definite (every pose block
    # shifted below zero by twice its trace): the flag, and no step
    trace = bk[0].diagonal(dim1=1, dim2=2).sum(-1)
    bad = [bk[0] - 2.0 * trace[:, None, None] * torch.eye(6, device=device), *bk[1:6]]
    dz, lz, ok = ba.schur_solve(*bad, prob, lam)
    if bool(ok) or float(dz.abs().max()) != 0.0 or float(lz.abs().max()) != 0.0:
        raise RuntimeError("ba_schur: an indefinite system was not flagged, or left a step")
    # the library call: a Cholesky factorisation and solve of the same
    # float64 reduced system, which the plain path forms first
    Sd, bs, *_ = ba.reduced_system_plain(*b64, prob.pose_fixed, lam.double())
    lib_f = cuda_ms(lambda: torch.cholesky_solve(bs[:, None], torch.linalg.cholesky_ex(Sd)[0]), 20)
    f_bytes, f_ops = schur_bytes_ops(prob)
    out.append(dict(name="ba_schur", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/ba_schur.cu",
                    replaces="orb_slam3_fast_tpu/optim/ba.py:108", max_abs_err=err_f, **bound(f_bytes, f_ops),
                    library_ms=lib_f,
                    ms=cuda_ms(lambda: ba.schur_solve(*bk[:6], prob, lam), 20),
                    plain_ms=cuda_ms(lambda: ba.schur_solve_plain(*bp[:6], prob.pose_fixed, prob.lm_valid, lam), 5),
                    shapes=f"6K={6 * K}; error relative to the float64 plain solve of the same blocks, tolerance "
                           f"1e-4; {err_f32:.3g} against the float32 plain solve; an indefinite system flagged, "
                           "dp and dl zero"))

    # E + F: a whole bundle_adjust against the plain one
    Rk, tk, _, ik = ba.bundle_adjust(cam, bf, prob)
    (Rp, tp, _, ip), ba_plain_ms = timed(lambda: ba.bundle_adjust_plain(cam, bf, prob))
    err_ba = max(float((tk - tp).abs().max()), float((Rk - Rp).abs().max()))
    flips = float((ik != ip).float().mean())
    if not (err_ba <= 1e-3 and flips <= 0.005):
        raise RuntimeError(f"bundle_adjust: pose err {err_ba:.3g}, inlier flags differing {flips:.4f}")
    ba_ms = cuda_ms(lambda: ba.bundle_adjust(cam, bf, prob), 3)
    out[-1]["shapes"] += (f"; bundle_adjust 5+10 LM via E+F {ba_ms:.3f} ms (plain {ba_plain_ms:.3f}), pose err "
                          f"{err_ba:.3g} (tolerance 1e-3), inlier flags differing {flips:.4f} (tolerance 0.005)")

    # G: 1024 matches of two keyframes 0.4 m apart
    g = torch.Generator().manual_seed(0)
    Xs = torch.stack([torch.rand(N_DLT, generator=g) * 8 - 4, torch.rand(N_DLT, generator=g) * 6 - 3,
                      2 + 20 * torch.rand(N_DLT, generator=g)], 1)
    P0 = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]])
    P1 = torch.tensor([[1.0, 0, 0, -0.4], [0, 1, 0, 0.05], [0, 0, 1, 0.1]])
    x0 = Xs[:, :2] / Xs[:, 2:] + 1e-3 * torch.randn(N_DLT, 2, generator=g)
    xc1 = Xs + P1[:, 3]
    x1 = xc1[:, :2] / xc1[:, 2:] + 1e-3 * torch.randn(N_DLT, 2, generator=g)
    dlt = [a.to(device).contiguous() for a in (P0, P1, x0, x1)]
    Xk, Xp = twoview.triangulate_dlt(*dlt), twoview.triangulate_dlt_plain(*dlt)
    c1 = -P1[:, 3]
    cosp = (Xs * (Xs - c1)).sum(1) / (Xs.norm(dim=1) * (Xs - c1).norm(dim=1))
    good = (cosp < 0.9998).to(device)
    err_g = float(((Xk - Xp).norm(dim=1) / Xp.norm(dim=1))[good].max())
    if not err_g <= 1e-4:
        raise RuntimeError(f"triangulate_dlt: {err_g:.3g} relative on well-conditioned rows")
    # the library call: the batched SVD of the same (N,4,4) DLT systems
    P0d, P1d, x0d, x1d = dlt
    A = torch.stack([x0d[:, 0:1] * P0d[2] - P0d[0], x0d[:, 1:2] * P0d[2] - P0d[1], x1d[:, 0:1] * P1d[2] - P1d[0],
                     x1d[:, 1:2] * P1d[2] - P1d[1]], dim=1)
    lib_g = cuda_ms(lambda: torch.linalg.svd(A), 20)
    # per match: 16 bytes in, 12 out; the 4x4 system (16 flops), its normal
    # matrix and null vector, and the division by w
    out.append(dict(name="triangulate_dlt", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/triangulate_dlt.cu",
                    replaces="orb_slam3_fast_tpu/ops/twoview.py:164", max_abs_err=err_g,
                    **bound(N_DLT * 28 + 96, N_DLT * (16 + normal_flops(4, 4) + null_flops(4) + 3)), library_ms=lib_g,
                    ms=cuda_ms(lambda: twoview.triangulate_dlt(*dlt), 50), plain_ms=cuda_ms(lambda: twoview.triangulate_dlt_plain(*dlt), 10),
                    shapes=f"{N_DLT} matches ({int(good.sum())} with parallax cos < 0.9998); relative error there, "
                           "tolerance 1e-4"))

    # C: epipolar and mutual modes, 768 x 768, exact
    (kp_a, kp_b), F_ab, sigma2 = corridor_keypoints(device)
    f32 = torch.float32
    xa = torch.cat([kp_a.xy, torch.ones_like(kp_a.xy[:, :1])], 1)
    lines = xa @ F_ab.T
    epi = ham.EpipolarGate(lines[:, 0].contiguous(), lines[:, 1].contiguous(), lines[:, 2].contiguous(),
                           lines[:, 0] ** 2 + lines[:, 1] ** 2, kp_a.valid.to(f32), kp_b.xy[:, 0].contiguous(),
                           kp_b.xy[:, 1].contiguous(), 3.84 * mat._pow_level(kp_b.level, sigma2), kp_b.valid.to(f32))
    mutual = ham.MutualGate(kp_a.valid.to(f32), kp_b.valid.to(f32))
    modes = {}
    for name, gate in (("epipolar", epi), ("mutual", mutual)):
        (bk_, ck), (bp_, cp) = ham.hamming_best2(kp_a.desc, kp_b.desc, gate), ham.hamming_best2_plain(kp_a.desc, kp_b.desc, gate)
        if not (all(torch.equal(x, y) for x, y in zip(bk_, bp_)) and torch.equal(ck, cp)):
            raise RuntimeError(f"hamming_best2 {name} mode differs from its plain version")
        gated = int((ham.epipolar_mask(gate) if name == "epipolar" else
                     (gate.valid_a[:, None] * gate.valid_b[None, :] > 0.5)).sum())
        modes[name] = dict(n=kp_a.n, m=kp_b.n, nbytes=(kp_a.n + kp_b.n) * 52 + kp_a.n * 16 + kp_b.n * 8,
                           ops=8 * kp_a.n * kp_b.n + 24 * gated,
                           ms=cuda_ms(lambda: ham.hamming_best2(kp_a.desc, kp_b.desc, gate), 50),
                           plain_ms=cuda_ms(lambda: ham.hamming_best2_plain(kp_a.desc, kp_b.desc, gate), 10),
                           accepted=int((bp_.dist < ham.INF_DIST).sum()))
    return out, modes


def mono_frames(n_frames: int, seed: int = 0, cam=None):
    """The mono phase's input: test_slam_e2e.py's mono corridor (seed 0, 900
    splats, arc_trajectory(step=0.06, lateral=0.05)), rendered on the host
    through the synthetic pin-hole camera or ``cam``; returns (images, true
    T_cw per frame)."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera

    cam = cam or Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    world = make_corridor_world(np.random.default_rng(seed), n=900)
    poses = arc_trajectory(n_frames, step=0.06, lateral=0.05)
    return render_views("mono", world, (cam,), poses), poses


def planar_matches(rng, n: int = 768, n_valid: int = 300):
    """Two views of a textured plane (z = 4 + 0.3 x) 0.25 m apart with a
    small turn, 0.5 px noise, 10% of the matches wrong; the matches fill the
    first ``n_valid`` of ``n`` slots.  Returns (uv0, uv1, valid) on the
    host."""
    from orb_slam3_fast_tpu_torch.utils import lie

    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), np.zeros(n)], -1)
    X[:, 2] = 4.0 + 0.3 * X[:, 0]
    T = lie.se3_exp(torch.tensor([0.25, 0.03, 0.05, 0.01, -0.04, 0.02]))
    X1 = X @ T.R.numpy().T + T.t.numpy()
    uv0 = 400.0 * X[:, :2] / X[:, 2:] + [320.0, 240.0] + rng.normal(0, 0.5, (n, 2))
    uv1 = 400.0 * X1[:, :2] / X1[:, 2:] + [320.0, 240.0] + rng.normal(0, 0.5, (n, 2))
    wrong = rng.uniform(size=n) < 0.1
    uv1[wrong] = rng.uniform([0, 0], [640, 480], (int(wrong.sum()), 2))
    valid = np.arange(n) < n_valid
    return uv0.astype(np.float32), uv1.astype(np.float32), valid


def pnp_problem(rng, n: int = 768, n_valid: int = 600, outliers: float = 0.2):
    """A relocalisation problem at the path's shapes: ``n`` slots, the first
    ``n_valid`` holding world points 2-8 m in front of a camera at a known
    pose, observed with 0.5 px noise at random pyramid levels, ``outliers``
    of them at random pixels.  Returns (xw, uv, inv_sigma2, valid, R, t) on
    the host."""
    from orb_slam3_fast_tpu_torch.utils import lie

    T = lie.se3_exp(torch.tensor([0.3, -0.1, 0.5, 0.05, -0.1, 0.03]))
    R, t = T.R.numpy(), T.t.numpy()
    xc = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(2, 8, n)], -1)
    xw = ((xc - t) @ R).astype(np.float32)
    uv = 400.0 * xc[:, :2] / xc[:, 2:] + [320.0, 240.0] + rng.normal(0, 0.5, (n, 2))
    bad = rng.uniform(size=n) < outliers
    uv[bad] = rng.uniform([0, 0], [640, 480], (int(bad.sum()), 2))
    valid = np.arange(n) < n_valid
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 4, n)).astype(np.float32)
    return xw, uv.astype(np.float32), inv_s2, valid, R, t


def rot_angle(Ra, Rb) -> float:
    """Angle in radians of Ra Rb^T, as atan2(|vee of its skew part|, (tr - 1) / 2):
    arccos of the trace alone would turn a 1e-6 orthonormality defect of
    float32 rotations into ~1e-3 rad."""
    Ra, Rb = (x.detach().double().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)
              for x in (Ra, Rb))
    M = Ra @ Rb.T
    w = 0.5 * np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.arctan2(np.linalg.norm(w), (np.trace(M) - 1.0) / 2.0))


# Crafted inputs of kernel M's verdict (``verdict_cases``): per case the two models' scores (SF, SH), and per motion
# (4 from F, then 8 from H) its good count, parallax (degrees) and quality; the verdict the JAX package's rules give
# them, (success, used_h, the chosen motion), with min_triangulated VERDICT_MIN_TRI.  Each model's inliers are 32 of
# the 64 valid slots, so its count gate is max(20, int(0.9 * 32)) = 28.
VERDICT_MIN_TRI = 20
VERDICT_CASES = {
    # F preferred (RH 0.09) and dominant on its count: F's first motion
    "F preferred and ok": ((100.0, 10.0), [40, 5, 3, 2], [5, 1, 1, 1], [30, 2, 1, 0], [10] * 8, [2] * 8, [5] * 8,
                           (True, False, 0)),
    # H preferred (RH 0.91) but every H motion under the count gate: the fallback to F
    "H preferred, H fails, F ok": ((10.0, 100.0), [40, 5, 3, 2], [5, 1, 1, 1], [30, 2, 1, 0], [10] * 8, [2] * 8,
                                   [5] * 8, (True, False, 0)),
    # H preferred, both under the count gate: H kept, no success
    "both fail, H preferred": ((10.0, 100.0), [10, 5, 3, 2], [5, 1, 1, 1], [30, 2, 1, 0], [10] * 8, [2] * 8,
                               [5] * 8, (False, True, 4)),
    # F preferred, both fail: F kept, no success
    "both fail, F preferred": ((100.0, 10.0), [10, 5, 3, 2], [5, 1, 1, 1], [30, 2, 1, 0], [10] * 8, [2] * 8,
                               [5] * 8, (False, False, 0)),
    # F preferred but failing, H's sixth motion dominant: the fallback to H
    "F fails, H ok": ((100.0, 10.0), [10, 5, 3, 2], [5, 1, 1, 1], [30, 2, 1, 0], [3, 3, 3, 3, 3, 45, 3, 3],
                      [2, 2, 2, 2, 2, 6, 2, 2], [1, 1, 1, 1, 1, 40, 1, 1], (True, True, 9)),
    # a tie in quality goes to the first motion; neither count (35 of 40) nor quality dominates, parallax (2 under
    # half of 5) does
    "quality tie, parallax dominance": ((100.0, 10.0), [40, 35, 3, 2], [5, 2, 1, 1], [30, 30, 1, 0], [10] * 8,
                                       [2] * 8, [5] * 8, (True, False, 0)),
    # the same tie, the runner-up's parallax 4 over half of 5: no dominance
    "quality tie, not dominant": ((100.0, 10.0), [40, 35, 3, 2], [5, 4, 1, 1], [30, 30, 1, 0], [10] * 8, [2] * 8,
                                  [5] * 8, (False, False, 0)),
    # counts close (38 of 40), the runner-up's quality under 0.6 of the best's: dominant
    "quality dominance": ((100.0, 10.0), [40, 38, 3, 2], [5, 4, 1, 1], [30, 10, 1, 0], [10] * 8, [2] * 8, [5] * 8,
                          (True, False, 0)),
    # the best motion's parallax 0.8 under min_parallax_deg 1: no success
    "parallax gate": ((100.0, 10.0), [40, 5, 3, 2], [0.8, 0.2, 0.1, 0.1], [30, 2, 1, 0], [10] * 8, [2] * 8, [5] * 8,
                      (False, False, 0)),
    # a tie in H's quality (motions 5 and 7) goes to the first, which dominates on count
    "H quality tie": ((10.0, 100.0), [3, 3, 3, 3], [1, 1, 1, 1], [1, 1, 1, 1], [3, 45, 3, 30, 3, 3, 3, 3],
                      [2, 6, 2, 3, 2, 2, 2, 2], [1, 40, 1, 40, 1, 1, 1, 1], (True, True, 5)),
}


def image_pixels(rng, cam, wh, n: int) -> torch.Tensor:
    """(n, 2) host pixels over a ``wh`` image, its corners and ``cam``'s
    principal point (KB8's d < EPS branch) among them."""
    uv = rng.uniform([0.0, 0.0], wh, (n, 2))
    uv[:4] = [[0.0, 0.0], [wh[0] - 1.0, 0.0], [0.0, wh[1] - 1.0], [wh[0] - 1.0, wh[1] - 1.0]]
    uv[4] = [float(cam.params[2]), float(cam.params[3])]
    return torch.as_tensor(uv.astype(np.float32))


def two_view_scene(rng, cam, planar: bool, n: int = 256, n_valid: int = 180) -> tuple:
    """Two views of points 3-9 m ahead (or of the plane z = 4 + 0.3 x)
    through ``cam``, the second 0.3 m to the side with a small turn, 0.5 px
    noise, 10% of the matches off by up to 40 px; the first ``n_valid`` of
    ``n`` slots hold matches.  Returns host (uv0, uv1, valid)."""
    from orb_slam3_fast_tpu_torch.cameras import models as cm
    from orb_slam3_fast_tpu_torch.utils import lie

    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 9, n)], -1)
    if planar:
        X[:, 2] = 4.0 + 0.3 * X[:, 0]
    T = lie.se3_exp(torch.tensor([0.3, 0.05, 0.1, 0.02, -0.05, 0.01], dtype=torch.float64)).inverse()
    X1 = X @ T.R.numpy().T + T.t.numpy()
    uv = [cm.project(cam, torch.as_tensor(Y, dtype=torch.float32)).numpy() + rng.normal(0, 0.5, (n, 2))
          for Y in (X, X1)]
    wrong = rng.uniform(size=n) < 0.1
    uv[1][wrong] += rng.uniform(-40, 40, (int(wrong.sum()), 2))
    return tuple(torch.as_tensor(a) for a in (uv[0].astype(np.float32), uv[1].astype(np.float32),
                                              np.arange(n) < n_valid))


def distinct_hypotheses(seed: int, valid: torch.Tensor, n_iters: int = 200) -> torch.Tensor:
    """(n_iters, 8) int32 hypothesis samples of kernel M, each of 8 distinct
    valid matches (drawn without replacement within a hypothesis, from a
    seeded CPU generator), on ``valid``'s device.  ``_sample_hypotheses``
    draws with replacement, as the JAX package does, and a hypothesis that
    repeats a match has a two-dimensional null space, of which the kernel's
    float64 Jacobi and the plain version's SVD may each return another
    vector (on tests/test_torch_kernels.py's 3-D KB8 pair one such
    hypothesis out-scored every other in the kernel): kernel-against-plain
    checks on scenes other than phase 3's draw their hypotheses here."""
    p = valid.detach().cpu().to(torch.float64).expand(n_iters, -1)
    g = torch.Generator().manual_seed(int(seed))
    return torch.multinomial(p, 8, replacement=False, generator=g).to(torch.int32).to(valid.device)


def verdict_cases(device, n: int = 64, seed: int = 0) -> dict:
    """``VERDICT_CASES`` as kernel M's verdict takes them: label -> ((Rall,
    tall, ngood, goods, parallax, Xs, qual, SF, SH, valid, inl_f, inl_h) on
    ``device``, the expected (success, used_h, motion)).  The motions'
    rotations, translations, points and flags are seeded at random, so the
    chosen motion's copy is checked; the first 64 of ``n`` slots are
    valid, each model's inliers 32 of them."""
    from orb_slam3_fast_tpu_torch.utils import lie

    rng = np.random.default_rng(seed)
    valid = np.arange(n) < 64
    inl_f, inl_h = valid & (np.arange(n) % 2 == 0), valid & (np.arange(n) % 2 == 1)
    out = {}
    for label, ((sf, sh), ng_f, par_f, q_f, ng_h, par_h, q_h, expected) in VERDICT_CASES.items():
        R = lie.so3_exp(torch.as_tensor(rng.normal(0, 0.3, (12, 3)), dtype=torch.float32))
        t = rng.normal(size=(12, 3))
        t /= np.linalg.norm(t, axis=1, keepdims=True)
        arrays = (R, t.astype(np.float32), np.asarray(ng_f + ng_h, np.int32), rng.uniform(size=(12, n)) < 0.5,
                  np.asarray(par_f + par_h, np.float32), rng.normal(0, 3, (12, n, 3)).astype(np.float32),
                  np.asarray(q_f + q_h, np.float32), np.float32(sf), np.float32(sh), valid, inl_f, inl_h)
        out[label] = (tuple(torch.as_tensor(a).to(device) for a in arrays), expected)
    return out


def verdicts_equal(a, b) -> bool:
    """Two TwoViewResults bit for bit."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


def through(cam, uv: torch.Tensor) -> torch.Tensor:
    """The pixels of ``cam`` on the rays that the synthetic 400 px pin-hole
    camera (640x480) sees at ``uv`` (N,2), on ``uv``'s device: a pin-hole
    problem's geometry seen through a distorted or a KB8 camera."""
    from orb_slam3_fast_tpu_torch.cameras import models as cm

    ray = cm.unproject(cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0), uv.cpu())
    return cm.project(cam, ray).to(uv.device).contiguous()


def twoview_ops(n: int, n_hyp: int, nv: int, n_good: int) -> tuple[int, int]:
    """Kernel M's bound's (bytes, operations) on N slots, I hypotheses, the
    valid matches and the chosen motion's good points.  Bytes: 17 per slot
    and the samples in; the chosen motion, its X and good flags (13 per
    slot) out.  Operations: the unprojection (counted by the stage's own
    bound, ``unproject_ops``), the Hartley normalisation (6 per valid point
    and view); per hypothesis the 8-point F and H (their normal matrices and
    null vectors, F's rank-2 SVD, 4 3x3 products to denormalise, H's inverse
    by the adjugate) and both transfer scores on every valid point (~90);
    the refit of each model on its inliers (normal matrices, ~90 + 180, a
    null vector, a rescore), the 4 + 8 motions (2 SVDs, ~60 each), and per
    motion the triangulation (a 4x4 DLT) and CheckRT's tests (~60) of the
    model's inliers; the inlier counts are at least the chosen motion's
    good points."""
    fit = normal_flops(8, 9) + normal_flops(16, 9) + 2 * null_flops(9) + SVD3_FLOPS + 4 * 45 + 45
    ops = (2 * 6 * nv + n_hyp * (fit + 90 * nv) + 2 * null_flops(9) + SVD3_FLOPS + n_good * (12 + 90 + 180 + 90)
           + 2 * SVD3_FLOPS + 12 * 60 + 12 * n_good * (16 + normal_flops(4, 4) + null_flops(4) + 60))
    return n * 17 + n_hyp * 32 + n * 13 + 60, ops


# per match and view: (u - c) / f (4 operations), then 10 fixed-point steps of the radial-tangential distortion
# (~30 each) or 10 Newton steps on KB8's degree-9 polynomial and its derivative (~25 each) and the final tan and
# scale (~25)
UNPROJECT_OPS = {"pinhole": 4, "radtan": 4 + 10 * 30, "kb8": 4 + 10 * 25 + 25}


def compare_twoview(device, cases: dict) -> dict:
    """Phase 3 for kernel M in its three camera instances: the pin-hole
    camera, EuRoC cam0's distortion on the same intrinsics and TUM-VI's cam0
    (KB8), each on ``cases`` (label -> pin-hole (uv0, uv1, valid)) seen
    through it (:func:`through`).  The whole kernel against
    ``reconstruct_plain`` at the tolerances below; its first stage
    (``unproject_pair``) bit for bit ``_camera_plane`` (both views and
    sigma^2, the camera on the host as the tracker holds it); its last
    stage (``verdict``) bit for bit ``_verdict``, on the plain version's
    motions of every case and on ``verdict_cases``' crafted motions, which
    reach every branch.  Times by CUDA events: the kernel and each stage
    alone, the plain version and each plain stage, the batched library SVDs
    of the F and H systems.  The pin-hole
    instance is the row; "radtan" and "kb8" hold the other two, "stages"
    each stage's times and bounds by instance."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera
    from orb_slam3_fast_tpu_torch.ops import twoview

    cams = {"pinhole": Camera.pinhole(400.0, 400.0, 320.0, 240.0),
            "radtan": Camera.pinhole(400.0, 400.0, 320.0, 240.0, EUROC_DIST), "kb8": fisheye_settings("monocular").cam}
    crafted = verdict_cases(device)
    for label, (args, _) in crafted.items():
        if not verdicts_equal(twoview.verdict(*args, VERDICT_MIN_TRI, 1.0),
                              twoview._verdict(*args, VERDICT_MIN_TRI, 1.0)):
            raise RuntimeError(f"twoview_ransac's verdict differs from the plain verdict on the crafted case {label!r}")
    rows, stages = {}, {"unproject": {}, "verdict": {}}
    for kind, cam in cams.items():
        err, notes, ms_k, ms_p, lib_k, nbytes, ops, branches = 0.0, [], 0.0, 0.0, 0.0, 0, 0, set()
        st = dict(ms=0.0, plain_ms=0.0, nbytes=0, ops=0)
        vd = dict(ms=0.0, plain_ms=0.0, nbytes=0, ops=0)
        for label, (uv0p, uv1p, valid) in cases.items():
            uv0, uv1 = (uv0p, uv1p) if kind == "pinhole" else (through(cam, uv0p), through(cam, uv1p))
            samples = twoview._sample_hypotheses(5, valid)
            # the first stage: bit for bit, and its times
            xk0, xk1, s2k = twoview.unproject_pair(cam, uv0, uv1)
            xp0, xp1, s2p = twoview._camera_plane(cam, uv0, uv1)
            if not (torch.equal(xk0, xp0) and torch.equal(xk1, xp1) and s2k == float(np.float32(s2p))):
                raise RuntimeError(f"twoview_ransac's unprojection ({kind}, {label}) is not the plain one bit for bit: "
                                   f"x0 {float((xk0 - xp0).abs().max()):.3g}, x1 {float((xk1 - xp1).abs().max()):.3g}, "
                                   f"sigma2 {s2k!r} / {s2p!r}")
            st["ms"] += cuda_ms(lambda: twoview._unproject_kernel(cam, uv0, uv1), 50)
            st["plain_ms"] += cuda_ms(lambda: twoview._camera_plane(cam, uv0, uv1), 10)
            st["nbytes"] += uv0.shape[0] * 32 + 4
            st["ops"] += 2 * uv0.shape[0] * UNPROJECT_OPS[kind]
            # the whole kernel against the plain version
            rk = twoview.reconstruct(cam, uv0, uv1, valid, 0, samples=samples)
            motions = twoview.motions_plain(cam, uv0, uv1, valid, samples)
            rp = twoview._verdict(*motions, 50, 1.0)
            ang = rot_angle(rk.R, rp.R)
            t_dir = float(1.0 - torch.abs(torch.dot(rk.t.double(), rp.t.double())))
            good_eq = float((rk.good == rp.good).float().mean())
            both = rk.good & rp.good
            x_err = float(((rk.X - rp.X).norm(dim=1) / rp.X.norm(dim=1))[both].max()) if bool(both.any()) else 0.0
            if not (bool(rk.success) == bool(rp.success) and bool(rk.used_h) == bool(rp.used_h) and ang <= 1e-3
                    and t_dir <= 1e-3 and good_eq >= 0.99 and x_err <= 1e-3):
                raise RuntimeError(f"twoview_ransac ({kind}) {label}: success {bool(rk.success)}/{bool(rp.success)}, "
                                   f"used_h {bool(rk.used_h)}/{bool(rp.used_h)}, R {ang:.3g} rad, t direction "
                                   f"{t_dir:.3g}, good equal {good_eq:.4f}, X {x_err:.3g}")
            # the last stage on the plain motions: bit for bit, and its times
            if not verdicts_equal(twoview.verdict(*motions, 50, 1.0), rp):
                raise RuntimeError(f"twoview_ransac's verdict ({kind}, {label}) differs from the plain verdict")
            vd["ms"] += cuda_ms(lambda: twoview.verdict(*motions, 50, 1.0), 50)
            vd["plain_ms"] += cuda_ms(lambda: twoview._verdict(*motions, 50, 1.0), 10)
            n, nv, n_good = uv0.shape[0], int(valid.sum()), int(rp.good.sum())
            vd["nbytes"] += n * 3 + n * 13 + 12 * 4 * 3 + 8 + n * 13 + 56  # valid, inliers, the chosen X and flags in
            vd["ops"] += 2 * n + 12 * 12
            branches.add("H" if bool(rp.used_h) else "F")
            err = max(err, ang, t_dir, x_err)
            ms = cuda_ms(lambda: twoview.reconstruct(cam, uv0, uv1, valid, 0, samples=samples), 20)
            pms = cuda_ms(lambda: twoview.reconstruct_plain(cam, uv0, uv1, valid, samples), 5)
            # the library call: the batched SVDs of the (200,8,9) F and (200,16,9) H systems
            x0, x1, _ = twoview._camera_plane(cam, uv0, uv1)
            s0n, _ = twoview._normalize(x0, valid)
            s1n, _ = twoview._normalize(x1, valid)
            Af, Ah = twoview._f_rows(s0n[samples], s1n[samples]), twoview._h_rows(s0n[samples], s1n[samples])
            lib = cuda_ms(lambda: (torch.linalg.svd(Af), torch.linalg.svd(Ah)), 20)
            ms_k, ms_p, lib_k = ms_k + ms, ms_p + pms, lib_k + lib
            b, o = twoview_ops(n, samples.shape[0], nv, n_good)
            nbytes, ops = nbytes + b, ops + o + 2 * n * UNPROJECT_OPS[kind]
            notes.append(f"{label}: {nv} valid of {n}, success {bool(rp.success)}, used_h {bool(rp.used_h)}, R "
                         f"{ang:.2e} rad, t dir {t_dir:.2e}, good equal {good_eq:.4f}, X {x_err:.2e}; {ms:.4f} ms "
                         f"(plain {pms:.4f}, svd {lib:.4f})")
        if branches != {"F", "H"}:
            raise RuntimeError(f"twoview_ransac ({kind}): the two cases took branches {branches}, not both F and H")
        rows[kind] = dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p, **bound(nbytes, ops), library_ms=lib_k,
                          shapes="; ".join(notes))
        for name, d in (("unproject", st), ("verdict", vd)):
            stages[name][kind] = dict(ms=d["ms"], plain_ms=d["plain_ms"], **bound(d["nbytes"], d["ops"]))
    row = rows.pop("pinhole")
    row["shapes"] += ("; tolerances: success and used_h equal, R 1e-3 rad, t direction 1e-3, good equal on >= 99%, X "
                      "1e-3 relative where both good; the unprojection (stage 0) and the verdict (stage 4) bit for bit "
                      f"their plain versions, the verdict on {len(crafted)} crafted cases too; library = batched "
                      "torch.linalg.svd of the F and H systems")
    return dict(name="twoview_ransac", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/twoview_ransac.cu",
                replaces="orb_slam3_fast_tpu/ops/twoview.py:304", **row, **rows, stages=stages)


def compare_mono_kernels(device) -> list[dict]:
    """Phase 3 for kernels M, N and P against their plain versions on the
    same CUDA tensors: M on the 768 two-view matches of frames 0 and 5 of the
    mono corridor and on a planar pair (the F and the H branch), N on the
    768 descriptors of a corridor frame with the default and the 10^6-word
    vocabulary, P on 768 slots with 256 subsets and 20% outliers."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera
    from orb_slam3_fast_tpu_torch.ops import extractor as ext
    from orb_slam3_fast_tpu_torch.ops import matching as mat
    from orb_slam3_fast_tpu_torch.optim import pnp
    from orb_slam3_fast_tpu_torch.vocab import vocabulary as voc_mod

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    cfg = ext.ExtractorConfig(n_features=768)
    imgs, _ = mono_frames(6)
    kp0, kp5 = (ext.extract(torch.as_tensor(imgs[i]).to(device), cfg) for i in (0, 5))
    out = []

    # M: the corridor pair (F) and a planar pair (H), in its three camera instances
    idx, acc = mat.search_for_initialization(kp0, kp5, 100.0)
    uvp0, uvp1, vp = planar_matches(np.random.default_rng(7))
    cases = {"corridor 0-5": (kp0.xy, kp5.xy[idx].contiguous(), acc),
             "plane": tuple(torch.as_tensor(a).to(device) for a in (uvp0, uvp1, vp))}
    out.append(compare_twoview(device, cases))

    # N: the 768 descriptors of frame 5 with the default and the 10^6-word vocabulary
    n_err, n_notes, n_ms, n_pms, n_bytes, n_ops = 0.0, [], 0.0, 0.0, 0, 0
    for label, voc in (("default 10^4", voc_mod.default_vocabulary()), ("huge 10^6", voc_mod.huge_vocabulary())):
        voc = voc.to(device)
        (wk, nk, bk), (wp, np_, bp) = (voc_mod.transform(voc, kp5.desc, kp5.valid),
                                       voc_mod.transform_plain(voc, kp5.desc, kp5.valid))
        torch.cuda.synchronize()
        rel = float(((bk - bp).abs() / bp.abs().clamp(min=1e-30))[bp != 0].max())
        if not (torch.equal(wk, wp) and torch.equal(nk, np_) and torch.equal(bk != 0, bp != 0) and rel <= 1e-5):
            raise RuntimeError(f"vocab_transform {label}: words / nodes differ, or the BoW's support, or a word "
                               f"by {rel:.3g} relative")
        n_err = max(n_err, rel)
        ms = cuda_ms(lambda: voc_mod.transform(voc, kp5.desc, kp5.valid), 50)
        pms = cuda_ms(lambda: voc_mod.transform_plain(voc, kp5.desc, kp5.valid), 10)
        n_ms, n_pms = n_ms + ms, n_pms + pms
        nv, B, D, W = int(kp5.valid.sum()), voc.branching, voc.depth, voc.n_words
        # bytes: 33 per slot in and 16 out (word, node); the tree rows the descent reads (33 bytes each),
        # B children of each distinct node it passes (the root, then the distinct ancestors of the words:
        # the node of level l - 1 above word w is w // B^(D - l)); the idf weight of each distinct word;
        # the (W,) BoW written once.  Operations: D x B Hamming distances of 24 integer operations per
        # valid descriptor, and a divide per non-zero word
        words = wp[kp5.valid]
        rows = B * (1 + sum(int(torch.unique(words // B ** (D - lvl)).numel()) for lvl in range(1, D)))
        n_bytes += kp5.n * 49 + rows * 33 + 4 * int(torch.unique(words).numel()) + 4 * W
        n_ops += nv * D * B * 24 + int((bp != 0).sum())
        n_notes.append(f"{label} ({nv} valid of {kp5.n}, {int((bp != 0).sum())} words): {ms:.4f} ms (plain "
                       f"{pms:.4f}), BoW within {rel:.2e} relative")
    out.append(dict(name="vocab_transform", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/vocab_transform.cu",
                    replaces="orb_slam3_fast_tpu/vocab/vocabulary.py:258", max_abs_err=n_err, ms=n_ms, plain_ms=n_pms,
                    **bound(n_bytes, n_ops), library_ms=None,
                    shapes="; ".join(n_notes) + "; words and nodes exact, BoW 1e-5 relative per word on the same "
                           "support"))

    # P: 768 slots, 256 subsets, 20% outliers
    xw, uv, inv_s2, valid, R_true, t_true = (torch.as_tensor(a).to(device) for a in pnp_problem(np.random.default_rng(8)))
    subsets = pnp._sample_subsets(11, valid)
    rk = pnp.pnp_ransac(cam, xw, uv, inv_s2, valid, 0, subsets=subsets)
    rp = pnp.pnp_ransac_plain(cam, xw, uv, inv_s2, valid, subsets)
    torch.cuda.synchronize()
    scale = float(xw[valid].norm(dim=1).median())
    ang, dt = rot_angle(rk.R, rp.R), float((rk.t - rp.t).norm()) / scale
    if not (int(rk.n_inliers) == int(rp.n_inliers) and bool(rk.ok) == bool(rp.ok) and bool(rp.ok)
            and ang <= 1e-3 and dt <= 1e-3):
        raise RuntimeError(f"pnp_ransac: inliers {int(rk.n_inliers)}/{int(rp.n_inliers)}, ok {bool(rk.ok)}/"
                           f"{bool(rp.ok)}, R {ang:.3g} rad, t {dt:.3g} of the scene scale")
    inl_eq = float((rk.inliers == rp.inliers).float().mean())
    # the library call: the batched SVD of the (256,12,12) DLT systems
    ctr, spread = pnp._conditioning(xw, valid)
    xn = pnp.cam_models.unproject(cam, uv)[:, :2]
    Xh = torch.cat([(xw - ctr) / spread, torch.ones_like(xw[:, :1])], 1)[subsets]
    z = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, z, -xn[subsets][..., 0:1] * Xh], -1), torch.cat([z, Xh, -xn[subsets][..., 1:2] * Xh], -1)], 1)
    lib = cuda_ms(lambda: torch.linalg.svd(A), 20)
    n, h, nv = xw.shape[0], subsets.shape[0], int(valid.sum())
    # bytes: 25 per slot and the subsets in; the pose, the mask and the flags out.  Operations: the
    # conditioning (6 per valid point); per subset the 12x12 DLT's normal matrix and null vector, and per
    # sign Procrustes (an SVD and ~100) and 4 GN steps on the 6 points (residuals and Jacobian ~54 per
    # point, the 6x6 normal matrix, its Cholesky and solves ~150, so3_exp ~60 and normalize_rotation's
    # SVD); 512 poses scored on every valid point (~45: transform, radtan projection, error) and the
    # winner's inlier mask
    gn = 6 * 54 + normal_flops(12, 6) + 144 + 150 + 60 + SVD3_FLOPS
    p_ops = 6 * nv + h * (normal_flops(12, 12) + null_flops(12) + 2 * (SVD3_FLOPS + 100 + 4 * gn)) + (2 * h + 1) * nv * 45
    out.append(dict(name="pnp_ransac", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/pnp_ransac.cu",
                    replaces="orb_slam3_fast_tpu/optim/pnp.py:110", max_abs_err=max(ang, dt),
                    ms=cuda_ms(lambda: pnp.pnp_ransac(cam, xw, uv, inv_s2, valid, 0, subsets=subsets), 20),
                    plain_ms=cuda_ms(lambda: pnp.pnp_ransac_plain(cam, xw, uv, inv_s2, valid, subsets), 5),
                    **bound(n * 25 + h * 24 + 48 + n + 5, p_ops),
                    library_ms=lib,
                    shapes=f"{n} slots ({int(valid.sum())} valid, 20% outliers), {h} subsets: {int(rp.n_inliers)} "
                           f"inliers on both, ok on both, R {ang:.2e} rad, t {dt:.2e} of the scene scale, inlier "
                           f"masks equal on {inl_eq:.4f}, truth within {rot_angle(rp.R, R_true):.2e} rad; "
                           "tolerances: count and ok equal, pose 1e-3 rad and 1e-3 of the scene scale; library = "
                           "batched torch.linalg.svd of the (256,12,12) systems"))
    return out


LOOP_CONFIG = dict(min_covis_edge=30, temporal_gap=15)  # tests/test_loop_closing.py:35


def sim3_pairs(rng, n: int = 768, n_valid: int = 300, outliers: float = 0.25, s: float = 1.3, cam=None):
    """Kernels Q and R's input at the loop verification's width: matched
    points of two keyframes in their camera frames (``n`` = kp_cap slots,
    ``n_valid`` live), xc1 = S12 xc2 with a share of the pairs replaced by
    random points, pixels of the synthetic pin-hole camera (or of ``cam``,
    through the port's projection) with 0.5 px noise, levels 0-3.  Returns
    (the seven numpy arrays of ``sim3_ransac``, the true S12 tangent)."""
    from orb_slam3_fast_tpu_torch.utils import lie

    xi = np.array([0.2, -0.1, 0.3, 0.05, -0.1, 0.08, np.log(s)], np.float32)
    S = lie.sim3_exp(torch.as_tensor(xi))
    R, t, sc = S.R.numpy(), S.t.numpy(), float(S.s)
    xc2 = np.zeros((n, 3), np.float32)
    xc2[:n_valid] = np.stack([rng.uniform(-2, 2, n_valid), rng.uniform(-1.5, 1.5, n_valid),
                              rng.uniform(3, 8, n_valid)], -1)
    xc1 = (sc * xc2 @ R.T + t).astype(np.float32)
    bad = (rng.uniform(size=n) < outliers) & (np.arange(n) < n_valid)
    xc1[bad] = np.stack([rng.uniform(-2, 2, bad.sum()), rng.uniform(-1.5, 1.5, bad.sum()),
                         rng.uniform(3, 8, bad.sum())], -1)

    def proj(x):
        if cam is not None:
            from orb_slam3_fast_tpu_torch.cameras.models import project

            return project(cam, torch.as_tensor(x, dtype=torch.float32)).numpy().astype(np.float64)
        z = np.where(np.abs(x[:, 2]) < 1e-9, 1e-9, x[:, 2])
        return np.stack([400.0 * x[:, 0] / z + 320.0, 400.0 * x[:, 1] / z + 240.0], -1)

    uv1 = (proj(xc1) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    uv2 = (proj(xc2) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    is1 = (1.0 / 1.44 ** rng.integers(0, 4, n)).astype(np.float32)
    is2 = (1.0 / 1.44 ** rng.integers(0, 4, n)).astype(np.float32)
    return (xc1, xc2, uv1, uv2, is1, is2, np.arange(n) < n_valid), xi


def sim3_graph_problem(rng, K: int = 70):
    """Kernel S's input at the circle's size: the essential graph of K
    keyframes on a circle of radius 4, the odometry chain measured with
    noise and 1% scale drift (tests/test_pose_graph.py's construction), the
    estimates integrated from it, exact covisibility edges from each keyframe
    to the 2 to 4 before it, the exact loop edge (K-1, 0), keyframe 0 fixed.
    Returns the Sim3Graph's numpy fields and the true camera centres."""
    from orb_slam3_fast_tpu_torch.utils import lie

    Rg, tg = [], []
    for k in range(K):
        a = 2 * np.pi * k / K
        c, s = np.cos(a), np.sin(a)
        Rwc = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        Rg.append(Rwc.T)
        tg.append(-Rwc.T @ np.array([4.0 * c, 4.0 * s, 0.0], np.float32))
    Rg, tg = np.stack(Rg), np.stack(tg)

    def rel(i, j):  # the true S_ij = S_iw S_jw^-1, scale 1
        R = Rg[i] @ Rg[j].T
        return R, tg[i] - R @ tg[j], 1.0

    odo = []
    for k in range(K - 1):
        R, t, s = rel(k + 1, k)
        dR = lie.so3_exp(torch.as_tensor(rng.normal(0, 0.01, 3), dtype=torch.float32)).numpy()
        odo.append((dR @ R, t + rng.normal(0, 0.02, 3).astype(np.float32), s * 1.01))
    R0, t0, s0 = [Rg[0]], [tg[0]], [1.0]
    for k in range(K - 1):
        R, t, s = odo[k]
        R0.append(R @ R0[k])
        t0.append(s * (R @ t0[k]) + t)
        s0.append(s * s0[k])
    edges = [(k + 1, k, *odo[k]) for k in range(K - 1)]
    edges += [(i, i - d, *rel(i, i - d)) for i in range(K) for d in (2, 3, 4) if i >= d]
    edges.append((K - 1, 0, *rel(K - 1, 0)))
    E = len(edges)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    g = dict(R=np.stack(R0).astype(np.float32), t=np.stack(t0).astype(np.float32), s=np.asarray(s0, np.float32),
             edge_i=np.asarray([e[0] for e in edges], np.int32), edge_j=np.asarray([e[1] for e in edges], np.int32),
             meas_R=np.stack([e[2] for e in edges]).astype(np.float32),
             meas_t=np.stack([e[3] for e in edges]).astype(np.float32),
             meas_s=np.asarray([e[4] for e in edges], np.float32), edge_valid=np.ones(E, bool), fixed=fixed,
             edge_w=np.ones(E, np.float32))
    return g, -np.einsum("kji,kj->ki", Rg, tg)


def gba_problem(rng, device, K_live: int = 70, M_live: int = 3000, obs_per_lm: int = 10, cam=None):
    """Kernels E and T's input at the circle's global-BA size: K_live
    keyframes on a circle of radius 4 looking along the tangent (padded to
    K = 128 pose slots, as the mapper pads), keyframe 0 fixed; M_live
    landmarks on the ring's wall and floor (padded to M = 4096), each seen
    from ``obs_per_lm`` keyframes that face it (~30k observations, padded
    to 32768); mono edges, 0.5 px noise, 5% outliers; poses and landmarks
    perturbed from the truth.  The pixels are those of the synthetic
    pin-hole camera, or of ``cam`` (the port's projection) where it is
    given."""
    from orb_slam3_fast_tpu_torch.optim import ba

    K, M = 128, 4096
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.zeros((K, 3), np.float32)
    for k, (Rk, tk) in enumerate(circle_trajectory(K_live, radius=4.0, frac=1.0)):
        R[k], t[k] = Rk, tk
    a = rng.uniform(0, 2 * np.pi, M)
    X = np.zeros((M, 3), np.float32)
    X[:M_live] = np.stack([9.0 * np.cos(a[:M_live]), 9.0 * np.sin(a[:M_live]), rng.uniform(-2.5, 2.5, M_live)], -1)
    kf, lm = [], []
    for m in range(M_live):
        xc = np.einsum("kij,j->ki", R[:K_live], X[m]) + t[:K_live]
        ok = np.nonzero((xc[:, 2] > 0.5) & (np.abs(xc[:, 0] / xc[:, 2]) < 0.8) & (np.abs(xc[:, 1] / xc[:, 2]) < 0.6))[0]
        if len(ok) < 2:
            continue
        sel = rng.choice(ok, min(obs_per_lm, len(ok)), replace=False)
        kf += sel.tolist()
        lm += [m] * len(sel)
    kf, lm = np.asarray(kf, np.int32), np.asarray(lm, np.int32)
    n = len(kf)
    O = int(2 ** np.ceil(np.log2(n)))
    xc = np.einsum("oij,oj->oi", R[kf], X[lm]) + t[kf]
    uv = np.stack([400.0 * xc[:, 0] / xc[:, 2] + 320.0, 400.0 * xc[:, 1] / xc[:, 2] + 240.0, np.full(n, -1.0)], -1)
    if cam is not None:
        from orb_slam3_fast_tpu_torch.cameras.models import project

        uv[:, :2] = project(cam, torch.as_tensor(xc.astype(np.float32))).numpy()
    uv[:, :2] += rng.normal(0, 0.5, (n, 2))
    out = rng.uniform(size=n) < 0.05
    uv[out, :2] += rng.uniform(15, 40, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
    pad = lambda v, fill: np.concatenate([v, np.full((O - n, *v.shape[1:]), fill, v.dtype)])  # noqa: E731
    pose_fixed = np.ones(K, bool)
    pose_fixed[1:K_live] = False
    t0 = t.copy()
    t0[~pose_fixed] += rng.normal(0, 0.02, ((~pose_fixed).sum(), 3)).astype(np.float32)
    lm_valid = np.zeros(M, bool)
    lm_valid[np.unique(lm)] = True
    return ba.make_problem(
        R, t0, pose_fixed, (X + rng.normal(0, 0.05, X.shape)).astype(np.float32), lm_valid, pad(kf, 0), pad(lm, 0),
        pad(uv.astype(np.float32), -1.0), pad((1.0 / 1.44 ** rng.integers(0, 4, n)).astype(np.float32), 1.0),
        np.zeros(O, bool), pad(np.ones(n, bool), False), device=device,
    )


def sim3_rel_err(Sa, Sb) -> float:
    """The largest difference of two Sim3s' rotation entries, translation
    (relative to its size) and scale (relative)."""
    tn = max(float(Sb.t.norm()), 1e-9)
    return max(float((Sa.R - Sb.R).abs().max()), float((Sa.t - Sb.t).norm()) / tn,
               abs(float(Sa.s) - float(Sb.s)) / abs(float(Sb.s)))


def drift_graph(K: int, seed: int, rot_noise: float = 0.01, s_drift: float = 1.01, yaw_only: bool = False,
                pad_e: int = 8):
    """tests/test_pose_graph.py's _sim3_graph_from_drift: K keyframes on a
    circle of radius 5 looking along the tangent, the odometry chain
    measured with ``rot_noise`` rad (about gravity alone with ``yaw_only``:
    the 4-DoF graph's drift) and 0.02 of noise and ``s_drift`` scale drift
    (numpy seed ``seed``), the estimates integrated from it, the exact loop
    edge (0, K-1), ``pad_e`` invalid padding edges, vertex 0 fixed.
    Returns the Sim3Graph's numpy fields (an SE3Graph's and s, meas_s) and
    the true (R, t)."""
    from orb_slam3_fast_tpu_torch.utils import lie

    rng = np.random.default_rng(seed)
    Rg, tg = [], []
    for k in range(K):
        a = 2 * np.pi * k / K
        c, s = np.cos(a), np.sin(a)
        Rwc = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        Rg.append(Rwc.T)
        tg.append(-Rwc.T @ np.array([5.0 * c, 5.0 * s, 0], np.float32))
    Rg, tg = np.stack(Rg), np.stack(tg)

    def rel(Ri, ti, si, Rj, tj, sj):  # S_ij = S_iw S_jw^-1
        R = Ri @ Rj.T
        sc = si / sj
        return R, -sc * (R @ (tj / sj)) + ti, sc

    meas = []
    for k in range(K - 1):
        R, t, sc = rel(Rg[k + 1], tg[k + 1], 1.0, Rg[k], tg[k], 1.0)
        w = rng.normal(0, rot_noise, 3).astype(np.float32)
        if yaw_only:
            w[:2] = 0.0
        dR = lie.so3_exp(torch.as_tensor(w)).numpy()
        meas.append((dR @ R, t + rng.normal(0, 0.02, 3).astype(np.float32), sc * s_drift))
    R0, t0, s0 = [Rg[0]], [tg[0]], [1.0]
    for k in range(K - 1):
        R, t, sc = meas[k]
        R0.append(R @ R0[k])
        t0.append(sc * (R @ t0[k]) + t)
        s0.append(sc * s0[k])
    E = K + pad_e
    ei, ej = np.zeros(E, np.int32), np.zeros(E, np.int32)
    mR = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
    mt, ms, ev = np.zeros((E, 3), np.float32), np.ones(E, np.float32), np.zeros(E, bool)
    for k in range(K - 1):
        ei[k], ej[k] = k + 1, k
        mR[k], mt[k], ms[k] = meas[k]
        ev[k] = True
    ei[K - 1], ej[K - 1] = 0, K - 1
    mR[K - 1], mt[K - 1], ms[K - 1] = rel(Rg[0], tg[0], 1.0, Rg[K - 1], tg[K - 1], 1.0)
    ev[K - 1] = True
    fixed = np.zeros(K, bool)
    fixed[0] = True
    g = dict(R=np.stack(R0), t=np.stack(t0), s=np.asarray(s0, np.float32), edge_i=ei, edge_j=ej, meas_R=mR,
             meas_t=mt, meas_s=ms, edge_valid=ev, fixed=fixed, edge_w=np.ones(E, np.float32))
    return g, (Rg, tg)


def graph_ate(R, t, s, R_gt, t_gt) -> float:
    """RMS distance of the camera centres from the truth (tests/test_pose_graph.py's _ate)."""
    R, t, s = (np.asarray(torch.as_tensor(x).cpu(), np.float64) for x in (R, t, s))
    c = -np.einsum("kji,kj->ki", R, t) / s[:, None]
    c_gt = -np.einsum("kji,kj->ki", R_gt, t_gt)
    return float(np.sqrt(((c - c_gt) ** 2).sum(-1).mean()))


def pcg_ops(K: int, E: int, cg_run) -> float:
    """The operations kernel U's function needs: per Gauss-Newton step each
    edge's residual and its 14 derivatives (~1500 flops a direction, 15 with
    the value) and its blocks (3 x 49 x 14 + 2 x 7 x 14), per vertex its
    diagonal block and gradient summed over its edges (2 E x 56 in all), a
    7x7 inverse (~1400) and the update (~700); per CG iteration that ran, 4
    7x7 mat-vecs per edge and one per vertex (98 flops each), the damping
    term, three dot products and three vector updates over 7K entries."""
    per_step = E * (15 * 1500 + 3 * 49 * 14 + 2 * 7 * 14) + 2 * E * 56 + K * (1400 + 700)
    per_cg = E * 4 * 98 + K * (98 + 14) + 7 * K * (3 * 2 + 3 * 2)
    return len(cg_run) * per_step + int(np.sum(cg_run)) * per_cg


def graph_dist(a, b) -> float:
    """The largest difference of two solutions of a Sim3 graph in scale-free
    terms: rotation entries, log s and camera centres (m).  (t itself grows
    with s, which the drift graphs carry up to 1.01^K.)"""
    Ra, ta, sa = (np.asarray(torch.as_tensor(x).detach().cpu(), np.float64) for x in a[:3])
    Rb, tb, sb = (np.asarray(torch.as_tensor(x).detach().cpu(), np.float64) for x in b[:3])
    ca = -np.einsum("kji,kj->ki", Ra, ta) / sa[:, None]
    cb = -np.einsum("kji,kj->ki", Rb, tb) / sb[:, None]
    return float(max(np.abs(Ra - Rb).max(), np.abs(np.log(sa) - np.log(sb)).max(), np.abs(ca - cb).max()))


def compare_pcg(device, g70, dense70) -> dict:
    """Kernel U against its plain version (the PCG branch of
    _solve_normal_eqs) on tests/test_pose_graph.py's drift graphs (seed 3,
    15 iterations) of 200 vertices, of 512 (the System's ``max_keyframes``)
    and of 2048, and forced (``_FORCE_CG``) on S's 70-vertex graph ``g70``,
    with its distance from S's dense answer ``dense70``.  At 200 and 512:
    within 1e-3 of the plain version (``graph_dist``), and at 200 the camera
    centres moved towards the truth.  At 2048 the JAX scale test's
    (tests/test_pose_graph.py:222-235) scale gate |s_last - 1| < 0.1 and a
    finite answer; its distance from the plain version is reported beside
    the plain version's own distance between the card and the host, and
    its ATE gate (after < 0.25 x before) is reported, not required: on that
    graph 512 float64 CG iterations a step amplify rounding, so that the
    plain version on the card and on the host land metres apart, and the
    function the test holds does not meet it (the JAX package's float32
    solve returns NaNs there on the CPU)."""
    from orb_slam3_fast_tpu_torch.optim import pose_graph as pg

    notes, row = [], {}
    for Ku in (200, 512, 2048):
        g_np, (R_gt, t_gt) = drift_graph(Ku, seed=3)
        gu = pg.Sim3Graph(**{k: torch.as_tensor(v).to(device) for k, v in g_np.items()})
        res = pg.optimize_sim3_graph(gu, iters=15)
        plain, pms = timed(lambda: pg.optimize_sim3_graph_plain(gu, iters=15))
        err = graph_dist(res, plain)
        ate_b, ate_a = graph_ate(gu.R, gu.t, gu.s, R_gt, t_gt), graph_ate(*res[:3], R_gt, t_gt)
        s_last = float(res.s[-1])
        finite = all(bool(torch.isfinite(x).all()) for x in res[:3])
        if Ku < 2048:
            good = err <= 1e-3 and (Ku != 200 or ate_a < ate_b)
        else:
            good = abs(s_last - 1) < 0.1
            host = pg.optimize_sim3_graph_plain(pg.Sim3Graph(**{k: torch.as_tensor(v) for k, v in g_np.items()}), 15)
            spread = graph_dist(plain, host)
        if not (bool(res.ok) and finite and good):
            raise RuntimeError(f"optimize_sim3_graph (kernel U) at K={Ku}: ok {bool(res.ok)}, finite {finite}, "
                               f"{err:.3g} from the plain version, ATE {ate_b:.3f} -> {ate_a:.3f}, last scale "
                               f"{s_last:.4f}")
        cg_run = res.cg_run.cpu().numpy()
        ms = cuda_ms(lambda: pg.optimize_sim3_graph(gu, iters=15), 5 if Ku == 200 else 2)
        Eu = int(gu.edge_i.shape[0])
        b = bound(Ku * 53 + Eu * 61 + Ku * 52, pcg_ops(Ku, Eu, cg_run))
        note = (f"K={Ku} ({Eu} edge slots, {int(g_np['edge_valid'].sum())} valid), 15 steps of up to "
                f"{pg.cg_iterations(Ku)} CG iterations (ran {int(cg_run.sum())} in all): {ms:.3f} ms (plain {pms:.3f}), "
                f"bound {b['bound_ms']:.5f} ms ({b['bound_by']}), {err:.2e} from the plain version")
        if Ku == 2048:
            note += (f" (the plain version on the card from the host's {spread:.3g}: no tolerance holds here), "
                     f"ATE {ate_b:.3f} -> {ate_a:.3f} m (the scale test's gate < {0.25 * ate_b:.3f} "
                     f"{'met' if ate_a < 0.25 * ate_b else 'not met'}), last scale {s_last:.4f} (gate |s - 1| < 0.1)")
        else:
            note += f" (tolerance 1e-3), ATE {ate_b:.3f} -> {ate_a:.3f} m"
        notes.append(note)
        if Ku == 200:
            # the library call: one dense solve of the (7K)^2 system at the start
            r, Ji, Jj = pg.edge_jacobians(gu.R, gu.t, gu.s, gu)
            w = gu.edge_valid.to(gu.t.dtype) * gu.edge_w
            Hd, rhs = pg.dense_normal_system(r, Ji, Jj, gu.edge_i, gu.edge_j, w, gu.fixed, 1e-6)
            lib = cuda_ms(lambda: torch.linalg.solve(Hd, rhs), 5)
            row = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lib, **b)
        elif Ku == 512:
            row["max_abs_err"] = max(row["max_abs_err"], err)
    pg._FORCE_CG = True
    try:
        forced = pg.optimize_sim3_graph(g70)
        plain = pg.optimize_sim3_graph_plain(g70)
    finally:
        pg._FORCE_CG = False
    torch.cuda.synchronize()
    err = graph_dist(forced, plain)
    if not (bool(forced.ok) and err <= 1e-3):
        raise RuntimeError(f"optimize_sim3_graph forced to kernel U on K=70: {err:.3g} from the plain version")
    notes.append(f"forced (_FORCE_CG) on the 70-vertex graph: {err:.2e} from its plain version (tolerance 1e-3), "
                 f"{graph_dist(forced, dense70):.2e} from kernel S's dense answer")
    row["max_abs_err"] = max(row["max_abs_err"], err)
    return dict(name="sim3_pcg", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/sim3_pcg.cu",
                replaces="orb_slam3_fast_tpu/optim/pose_graph.py:80", **row,
                shapes="; ".join(notes) + "; distances in rotation entries, log s and camera centres (m); "
                       "max_abs_err over K=200, 512 and 70; ms, plain_ms, bound_ms and library_ms at K=200; library "
                       "= torch.linalg.solve of the formed float64 (7K)^2 system of the first step")


def pcg_bytes_ops(prob, cg_iters: int) -> tuple:
    """Kernel T's least work on ``prob``: (bytes, operations, free poses,
    live landmarks, live observations of free poses).  Bytes: the blocks
    (Hpp, Hll, bp, bl, w_lm), W (72 per observation), the observation and
    CSR indices (16 per observation), the flags in once; dp and dl out.
    Operations: setup per live observation W V^-1 W^T and W V^-1 bl (~330),
    per landmark a 3x3 inverse (~60), per free pose a 6x6 inverse (~500);
    per CG iteration two passes over the live observations (36 flops each)
    and the pose blocks (72) and vector updates (~60 per pose entry); the
    back-substitution (36 per observation)."""
    K, M, O = prob.R.shape[0], prob.xw.shape[0], prob.obs_kf.shape[0]
    live = prob.obs_valid & ~prob.pose_fixed[prob.obs_kf.long()]
    n_live, n_lm = int(live.sum()), int(prob.lm_valid.sum())
    n_free = int((~prob.pose_fixed).sum())
    t_ops = 330 * n_live + 60 * n_lm + 500 * n_free + cg_iters * (72 * n_live + n_free * (72 + 360) + 15 * n_lm) \
        + 36 * n_live + 15 * n_lm
    t_bytes = K * 168 + M * 52 + O * (72 + 16) + 4 * (M + K + 2) + K + M + 4 + K * 24 + M * 12
    return t_bytes, t_ops, n_free, n_lm, n_live


def compare_loop_kernels(device) -> list[dict]:
    """Phase 3 for loop closing's kernels, each against its plain version on
    the same CUDA tensors, with CUDA-event times: Q (128 hypotheses over the
    768 slots of a keyframe pair, with and without the scale) and R (the 15
    steps on those pairs), S (12 iterations on a 70-keyframe essential
    graph), T (32 CG iterations on a global-BA problem at the circle's size,
    128 pose slots, 4096 landmarks, ~30k observations); E at that size, and
    a whole bundle_adjust_cg through E and T against its plain run."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera
    from orb_slam3_fast_tpu_torch.optim import ba, ba_cg
    from orb_slam3_fast_tpu_torch.optim import pose_graph as pg
    from orb_slam3_fast_tpu_torch.optim import sim3
    from orb_slam3_fast_tpu_torch.utils import lie

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    out = []
    cases = {}  # fix_scale -> (pairs on the card, true tangent): a mono pair (s = 1.3) and a stereo one (s = 1)
    for fix, s_true in ((False, 1.3), (True, 1.0)):
        arrays, xi_true = sim3_pairs(np.random.default_rng(9), s=s_true)
        cases[fix] = ([torch.as_tensor(a).to(device) for a in arrays], xi_true)
    valid = cases[False][0][-1]
    n, nv = valid.shape[0], int(valid.sum())

    # Q: with and without the scale, the same 128 subsets
    subsets = sim3._sample_subsets(sim3.jax_seed(30 * 2654435761 + 5), valid)
    h = subsets.shape[0]
    q_err, q_notes, q_ms, q_pms = 0.0, [], 0.0, 0.0
    for fix in (False, True):
        pairs = cases[fix][0]
        rk = sim3.sim3_ransac(cam, cam, *pairs, 0, fix_scale=fix, subsets=subsets)
        rp = sim3.sim3_ransac_plain(cam, cam, *pairs, subsets, fix_scale=fix)
        torch.cuda.synchronize()
        err = sim3_rel_err(rk.S12, rp.S12)
        flips = int((rk.inliers != rp.inliers).sum())
        # a pair within float rounding of the chi2 threshold can count on one side only
        if not (abs(int(rk.n_inliers) - int(rp.n_inliers)) <= 1 and bool(rk.ok) == bool(rp.ok) and bool(rp.ok)
                and err <= 1e-4 and flips <= 1):
            raise RuntimeError(f"sim3_ransac fix_scale={fix}: inliers {int(rk.n_inliers)}/{int(rp.n_inliers)}, ok "
                               f"{bool(rk.ok)}/{bool(rp.ok)}, Sim3 {err:.3g}, masks differ on {flips}")
        q_err = max(q_err, err)
        ms = cuda_ms(lambda: sim3.sim3_ransac(cam, cam, *pairs, 0, fix_scale=fix, subsets=subsets), 50)
        pms = cuda_ms(lambda: sim3.sim3_ransac_plain(cam, cam, *pairs, subsets, fix_scale=fix), 10)
        q_ms, q_pms = q_ms + ms, q_pms + pms
        q_notes.append(f"fix_scale={fix}: {int(rp.n_inliers)} inliers on both, Sim3 {err:.2e}, {ms:.4f} ms (plain "
                       f"{pms:.4f})")
    # the library call: the batched SVD of the 128 Horn matrices M = yc^T xc, for both cases
    x, y = cases[False][0][1][subsets], cases[False][0][0][subsets]
    Mh = torch.einsum("hni,hnj->hij", y - y.mean(1, keepdim=True), x - x.mean(1, keepdim=True))
    lib_q = 2 * cuda_ms(lambda: torch.linalg.svd(Mh), 50)
    # per case: bytes 49 per slot and the subsets in, the Sim3, mask and flags out; operations: per
    # hypothesis Horn (centroids and M ~90, a 3x3 SVD, R, s and t ~80) and the two-sided test of every
    # valid pair (two Sim3 maps, two projections and errors, ~60), the winner's mask again
    q_ops = 2 * (h * (90 + SVD3_FLOPS + 80 + 60 * nv) + 60 * nv)
    out.append(dict(name="sim3_ransac", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/sim3_ransac.cu",
                    replaces="orb_slam3_fast_tpu/optim/sim3.py:62", max_abs_err=q_err, ms=q_ms, plain_ms=q_pms,
                    **bound(2 * (n * 49 + h * 12 + 52 + n + 5), q_ops), library_ms=lib_q,
                    shapes=f"{n} slots ({nv} valid, 25% outliers), {h} subsets; " + "; ".join(q_notes) +
                           "; tolerances: count within 1, ok equal, Sim3 1e-4 (rotation entries, relative t and s), "
                           "masks differing on at most 1 pair; library = batched torch.linalg.svd of the (128,3,3) "
                           "Horn matrices, twice"))
    # Q with distorted cameras: the mono pair's pixels through EuRoC cam0's distortion, the same subsets
    cam_d = Camera.pinhole(400.0, 400.0, 320.0, 240.0, EUROC_DIST)
    arrays_d, xi_d = sim3_pairs(np.random.default_rng(9), s=1.3, cam=cam_d)
    pairs_d = [torch.as_tensor(a).to(device) for a in arrays_d]
    rk = sim3.sim3_ransac(cam_d, cam_d, *pairs_d, 0, subsets=subsets)
    rp = sim3.sim3_ransac_plain(cam_d, cam_d, *pairs_d, subsets)
    torch.cuda.synchronize()
    err = sim3_rel_err(rk.S12, rp.S12)
    flips = int((rk.inliers != rp.inliers).sum())
    if not (abs(int(rk.n_inliers) - int(rp.n_inliers)) <= 1 and bool(rk.ok) == bool(rp.ok) and bool(rp.ok)
            and err <= 1e-4 and flips <= 1):
        raise RuntimeError(f"sim3_ransac with distortion: inliers {int(rk.n_inliers)}/{int(rp.n_inliers)}, ok "
                           f"{bool(rk.ok)}/{bool(rp.ok)}, Sim3 {err:.3g}, masks differ on {flips}")
    ms = cuda_ms(lambda: sim3.sim3_ransac(cam_d, cam_d, *pairs_d, 0, subsets=subsets), 50)
    pms = cuda_ms(lambda: sim3.sim3_ransac_plain(cam_d, cam_d, *pairs_d, subsets), 10)
    out[-1]["max_abs_err"] = max(out[-1]["max_abs_err"], err)
    out[-1]["shapes"] += (f"; with EuRoC cam0's distortion (fix_scale=False): {int(rp.n_inliers)} inliers on both, "
                          f"Sim3 {err:.2e}, {ms:.4f} ms (plain {pms:.4f}), the same tolerances")

    # R: from the RANSAC's start, with and without the scale
    r_err, r_notes, r_ms, r_pms, n_act = 0.0, [], 0.0, 0.0, 0
    for fix in (False, True):
        pairs, xi_true = cases[fix]
        S0 = sim3.sim3_ransac_plain(cam, cam, *pairs, subsets, fix_scale=fix).S12
        Sk, ik, nk = sim3.optimize_sim3(cam, cam, S0, *pairs, fix_scale=fix)
        (Sp, ip, np_), pms = timed(lambda: sim3.optimize_sim3_plain(cam, cam, S0, *pairs, fix_scale=fix))
        err = sim3_rel_err(Sk, Sp)
        flips = int((ik != ip).sum())
        if not (abs(int(nk) - int(np_)) <= 1 and err <= 2e-4 and flips <= 1):
            raise RuntimeError(f"optimize_sim3 fix_scale={fix}: inliers {int(nk)}/{int(np_)}, Sim3 {err:.3g}, "
                               f"masks differ on {flips}")
        r_err = max(r_err, err)
        n_act += int(np_)
        ms = cuda_ms(lambda: sim3.optimize_sim3(cam, cam, S0, *pairs, fix_scale=fix), 20)
        r_ms, r_pms = r_ms + ms, r_pms + pms
        r_notes.append(f"fix_scale={fix}: {int(np_)} inliers on both, Sim3 {err:.2e}, truth within "
                       f"{sim3_rel_err(Sp, lie.sim3_exp(torch.as_tensor(xi_true).to(device))):.2e}; {ms:.4f} ms "
                       f"(plain {pms:.4f})")
    # per case: bytes 49 per slot and the start in, the Sim3 and the mask out; operations per step and
    # pair under the mask: two maps, projections and residuals (~60), both 2x7 Jacobians (~130), the
    # Huber weights (~20), J^T W J and J^T W r (2 x 2 x 35 x 2 = 280); per step the 7x7 Cholesky and
    # solves (~250), sim3_exp (~300) and an SVD; the two gates on the valid pairs (~60 each)
    step = 60 + 130 + 20 + 280
    r_ops = 15 * (step * (nv + n_act) // 2) + 2 * 15 * (250 + 300 + SVD3_FLOPS) + 2 * 2 * 60 * nv
    out.append(dict(name="sim3_refine", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/sim3_refine.cu",
                    replaces="orb_slam3_fast_tpu/optim/sim3.py:134", max_abs_err=r_err, ms=r_ms, plain_ms=r_pms,
                    **bound(2 * (n * 49 + 52 + 52 + n + 4), r_ops), library_ms=None,
                    shapes=f"{n} slots ({nv} valid), 5 + 10 steps; " + "; ".join(r_notes) +
                           "; tolerances: count within 1, Sim3 2e-4 (float32 residuals summed in float64 in "
                           "another order), masks differing on at most 1 pair; no single library call"))
    # R with distorted cameras, from the distorted case's RANSAC
    S0 = sim3.sim3_ransac_plain(cam_d, cam_d, *pairs_d, subsets).S12
    Sk, ik, nk = sim3.optimize_sim3(cam_d, cam_d, S0, *pairs_d)
    (Sp, ip, np_), pms = timed(lambda: sim3.optimize_sim3_plain(cam_d, cam_d, S0, *pairs_d))
    err = sim3_rel_err(Sk, Sp)
    flips = int((ik != ip).sum())
    if not (abs(int(nk) - int(np_)) <= 1 and err <= 2e-4 and flips <= 1):
        raise RuntimeError(f"optimize_sim3 with distortion: inliers {int(nk)}/{int(np_)}, Sim3 {err:.3g}, masks "
                           f"differ on {flips}")
    ms = cuda_ms(lambda: sim3.optimize_sim3(cam_d, cam_d, S0, *pairs_d), 20)
    out[-1]["max_abs_err"] = max(out[-1]["max_abs_err"], err)
    out[-1]["shapes"] += (f"; with EuRoC cam0's distortion (fix_scale=False): {int(np_)} inliers on both, Sim3 "
                          f"{err:.2e}, truth within {sim3_rel_err(Sp, lie.sim3_exp(torch.as_tensor(xi_d).to(device))):.2e}"
                          f", {ms:.4f} ms (plain {pms:.4f}), the same tolerances")

    # S: 12 iterations on the drifted circle's essential graph
    g_np, c_true = sim3_graph_problem(np.random.default_rng(10))
    g = pg.Sim3Graph(**{k: torch.as_tensor(v).to(device) for k, v in g_np.items()})
    Kg, Eg = g.R.shape[0], g.edge_i.shape[0]
    gk = pg.optimize_sim3_graph(g)
    gp, s_pms = timed(lambda: pg.optimize_sim3_graph_plain(g))
    if not bool(gk.ok):
        raise RuntimeError("optimize_sim3_graph: the Cholesky failed on a positive definite system")
    s_err = max(float((gk[0] - gp[0]).abs().max()), float((gk[1] - gp[1]).abs().max()),
                float((gk[2] - gp[2]).abs().max()))
    centres = lambda R, t, s: (-torch.einsum("kji,kj->ki", R, t) / s[:, None]).cpu().numpy()  # noqa: E731
    ate_before = float(np.sqrt(((centres(g.R, g.t, g.s) - c_true) ** 2).sum(1).mean()))
    ate_after = float(np.sqrt(((centres(*gk[:3]) - c_true) ** 2).sum(1).mean()))
    if not (s_err <= 1e-3 and ate_after < 0.25 * ate_before):
        raise RuntimeError(f"optimize_sim3_graph: {s_err:.3g} from the plain version, centres {ate_before:.3g} -> "
                           f"{ate_after:.3g} m")
    # the library call: a Cholesky factorisation and solve of the (7K)^2 system the plain version forms
    r, Ji, Jj = pg.edge_jacobians(g.R, g.t, g.s, g)
    Hd, rhs = pg.dense_normal_system(r, Ji, Jj, g.edge_i, g.edge_j, g.edge_w, g.fixed, 1e-6)
    lib_s = cuda_ms(lambda: torch.cholesky_solve(rhs[:, None], torch.linalg.cholesky_ex(Hd)[0]), 20)
    # bytes: the vertices (52 per vertex) and edges (64 each) in, the vertices out.  Operations per
    # iteration: each edge's residual and its 14 directional derivatives (sim3_exp twice, three
    # compositions and sim3_log, ~1500 flops a direction, 15 with the value), its four 7x7 blocks and
    # two gradients (4 x 49 x 14 + 2 x 7 x 14); the (7K)^3 / 3 Cholesky and 2 (7K)^2 substitutions; per
    # vertex sim3_exp, the composition and an SVD (~700)
    nK = 7 * Kg
    s_ops = 12 * (Eg * (15 * 1500 + 4 * 49 * 14 + 2 * 7 * 14) + nK**3 / 3 + 2 * nK**2 + Kg * 700)
    out.append(dict(name="sim3_graph", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/sim3_graph.cu",
                    replaces="orb_slam3_fast_tpu/optim/pose_graph.py:152", max_abs_err=s_err,
                    ms=cuda_ms(lambda: pg.optimize_sim3_graph(g), 5),
                    plain_ms=s_pms,
                    **bound(Kg * (52 + 1) + Eg * 64 + Kg * 52, s_ops), library_ms=lib_s,
                    shapes=f"K={Kg} vertices (7K = {nK}), {Eg} edges, 12 iterations: {s_err:.2e} from the plain "
                           f"version (tolerance 1e-3: float64 dual numbers against float32 forward mode), camera "
                           f"centres {ate_before:.3f} -> {ate_after:.3f} m from the truth; library = "
                           "torch.linalg.cholesky_ex + cholesky_solve of one iteration's float64 (7K)^2 system"))

    out.append(compare_pcg(device, g, gk))

    # E at the global BA's size, then T on its blocks
    gprob = gba_problem(np.random.default_rng(11), device)
    K, M, O = gprob.R.shape[0], gprob.xw.shape[0], gprob.obs_kf.shape[0]
    inl = torch.ones_like(gprob.obs_valid)
    args = (cam, 0.0, gprob.R, gprob.t, gprob.xw, gprob, inl)
    bk = ba_cg.build_blocks(*args)
    bp = ba.build_normal_blocks_plain(*args, per_obs=True)
    torch.cuda.synchronize()
    err_e = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-12) for x, y in zip(bk, bp))
    if not err_e <= 1e-4:
        raise RuntimeError(f"ba_blocks at the global BA's size: a block differs by {err_e:.3g} of its max")
    e_gba = (f"; at the global BA's size (K={K}, M={M}, O={O}, {int(gprob.obs_valid.sum())} live observations) "
             f"{cuda_ms(lambda: ba_cg.build_blocks(*args), 20):.4f} ms, every block within {err_e:.2e} of its max "
             "(tolerance 1e-4)")
    lam = torch.tensor(1e-4, device=device)
    dk, lk = ba_cg.implicit_schur_solve(*bk[:5], gprob, bk[5], lam)
    dp, lp = ba_cg.implicit_schur_solve_plain(*bk[:5], gprob.obs_kf, gprob.obs_lm, bk[5], gprob.pose_fixed,
                                              gprob.lm_valid, lam)
    torch.cuda.synchronize()
    t_err = max(float((dk - dp).abs().max() / dp.abs().max()), float((lk - lp).abs().max() / lp.abs().max()))
    if not t_err <= 1e-4:
        raise RuntimeError(f"implicit_schur_solve: dp / dl differ by {t_err:.3g} (relative) from the plain version")
    t_bytes, t_ops, n_free, n_lm, n_live = pcg_bytes_ops(gprob, 32)
    ms_t = cuda_ms(lambda: ba_cg.implicit_schur_solve(*bk[:5], gprob, bk[5], lam), 20)
    pms_t = cuda_ms(lambda: ba_cg.implicit_schur_solve_plain(*bk[:5], gprob.obs_kf, gprob.obs_lm, bk[5],
                                                             gprob.pose_fixed, gprob.lm_valid, lam), 3)
    # E + T: a whole bundle_adjust_cg (8 + 12 LM iterations) against the plain one
    Rk, tk, xk, ik, _ = ba_cg.bundle_adjust_cg(cam, 0.0, gprob, iters1=8, iters2=12)
    (Rp, tp, xp, ip, _), gba_plain_ms = timed(lambda: ba_cg.bundle_adjust_cg_plain(cam, 0.0, gprob, iters1=8,
                                                                                   iters2=12))
    err_gba = max(float((tk - tp).abs().max()), float((Rk - Rp).abs().max()))
    flips = float((ik != ip).float().mean())
    if not (err_gba <= 1e-3 and flips <= 0.005):
        raise RuntimeError(f"bundle_adjust_cg: pose err {err_gba:.3g}, inlier flags differing {flips:.4f}")
    gba_ms = cuda_ms(lambda: ba_cg.bundle_adjust_cg(cam, 0.0, gprob, iters1=8, iters2=12), 2)
    out.append(dict(name="ba_pcg", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/ba_pcg.cu",
                    replaces="orb_slam3_fast_tpu/optim/ba_cg.py:81", max_abs_err=t_err, ms=ms_t, plain_ms=pms_t,
                    **bound(t_bytes, t_ops), library_ms=None,
                    shapes=f"K={K} ({n_free} free), M={M} ({n_lm} live), O={O} ({n_live} live of free poses), 32 "
                           f"CG iterations in {3 + 3 * 32 + 1} launches: dp / dl within {t_err:.2e} of the plain "
                           "float64 version (relative to their max, tolerance 1e-4); bundle_adjust_cg 8+12 LM via "
                           f"E+T {gba_ms:.3f} ms (plain {gba_plain_ms:.3f}), pose err {err_gba:.3g} (tolerance 1e-3), "
                           f"inlier flags differing {flips:.4f} (tolerance 0.005); no single library call", e_gba=e_gba))
    return out


def _render_circle(i: int) -> np.ndarray:
    """Frame i of the loop scenario (run in a worker process)."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera

    world = make_ring_world(np.random.default_rng(0))
    R, t = circle_trajectory(LOOP_FRAMES, radius=4.0, frac=1.12)[i]
    return render(world, Camera.pinhole(400.0, 400.0, 320.0, 240.0), R, t)


def loop_frames():
    """The loop scenario's input: tests/test_loop_closing.py's circle
    (make_ring_world(seed 0), circle_trajectory(150, radius=4.0,
    frac=1.12)), rendered on the host by one worker process per core;
    returns (images, true T_cw per frame)."""
    return render_map(_render_circle, range(LOOP_FRAMES), parallel=True), circle_trajectory(LOOP_FRAMES, radius=4.0,
                                                                                             frac=1.12)


def loop_system(device, blackout: bool = False):
    """The monocular System of the loop scenario (configs/synthetic_mono.yaml,
    min_init_matches 60, motion_radius 25, 256 keyframes, loop closing and
    the Atlas, LoopCloserConfig(min_covis_edge=30, temporal_gap=15)); with
    ``blackout`` max_recently_lost 6 (tests/test_atlas.py)."""
    from orb_slam3_fast_tpu_torch.backend.loopcloser import LoopCloserConfig
    from orb_slam3_fast_tpu_torch.slam.system import System

    overrides = dict(min_init_matches=60, motion_radius=25.0)
    if blackout:
        overrides["max_recently_lost"] = 6
    slam = System(MONO_CONFIG, "monocular", tracker_overrides=overrides, max_keyframes=256, enable_loop_closing=True,
                  multi_map=True, async_backend=False, device=device)
    slam.loopcloser.cfg = LoopCloserConfig(**LOOP_CONFIG)
    return slam


def run_loop(frames, poses, device, blackout=(), snapshot=None, check: bool = True):
    """The monocular System with loop closing and the Atlas
    (configs/synthetic_mono.yaml, min_init_matches 60, motion_radius 25,
    256 keyframes, LoopCloserConfig(min_covis_edge=30, temporal_gap=15)) on
    the circle.  Without ``blackout``, tests/test_loop_closing.py:60-65's
    gates: final state OK, > 120 frames tracked, >= 1 loop closed,
    scale-aligned ATE < 0.20 m.  With it (black frames there and
    max_recently_lost 6, tests/test_atlas.py:34-79), that test's gates: >= 2
    maps, >= 1 merge, final state OK, > 100 frames OK, the scale-aligned ATE
    of ``trajectory_world()`` < 0.5 (``check`` False: no gates, for a
    prefix of the frames).  The global BAs are wrapped to count the
    launches of kernels F and T inside them; a dict ``snapshot`` receives
    the first loop correction's map (a deep copy, just before it) and
    arguments.  Returns the System, a summary (the keyframes after each
    frame in ``kf_at``) and the per-frame (state, R, t)."""
    import copy

    from orb_slam3_fast_tpu_torch.eval import ate
    from orb_slam3_fast_tpu_torch.optim import ba, ba_cg

    slam = loop_system(device, blackout=bool(len(blackout)))
    if snapshot is not None:
        correct = slam.loopcloser._correct

        def kept(world, k, c, S_kc):
            if not snapshot:
                snapshot.update(world=copy.deepcopy(world), args=(k, c, S_kc))
            return correct(world, k, c, S_kc)

        slam.loopcloser._correct = kept
    gba_launches = {"F": 0, "T": 0, "gba": 0}
    run_gba = slam.mapper._run_gba

    def counted_gba(*a, **kw):
        f0, t0 = ba.schur_solve.launches.total(), ba_cg.implicit_schur_solve.launches.total()
        done = run_gba(*a, **kw)
        gba_launches["F"] += ba.schur_solve.launches.total() - f0
        gba_launches["T"] += ba_cg.implicit_schur_solve.launches.total() - t0
        gba_launches["gba"] += 1
        return done

    slam.mapper._run_gba = counted_gba
    black = np.zeros((480, 640), np.float32)
    est, gt, ts, track, max_maps, gt_by_ts, closed_at, kf_at = [], [], [], [], 1, {}, [], []
    for i, (img, (R, t)) in enumerate(zip(frames, poses)):
        n_closed = slam.loopcloser.n_loops_closed + slam.loopcloser.n_maps_merged
        state, pose = slam.track_monocular(black if i in blackout else img, i * 0.05)
        kf_at.append(slam.tracker.world.n_kf)
        if slam.loopcloser.n_loops_closed + slam.loopcloser.n_maps_merged > n_closed:
            closed_at.append(i)
        if pose is None:
            pose = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        track.append((state, *pose))
        max_maps = max(max_maps, len(slam.atlas.maps))
        if state == "OK" and i not in blackout:
            est.append(-pose[0].T @ pose[1])
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
            gt_by_ts[round(i * 0.05, 4)] = gt[-1]
    if device.type == "cuda":
        torch.cuda.synchronize()
    if len(blackout):  # the saved trajectory, through the merged keyframe poses
        est, gt, ts = [], [], []
        for tsv, R, t, ok in slam.tracker.trajectory_world():
            if ok and round(tsv, 4) in gt_by_ts:
                est.append(-R.T @ t)
                gt.append(gt_by_ts[round(tsv, 4)])
                ts.append(tsv)
    est, gt, ts = np.asarray(est), np.asarray(gt), np.asarray(ts)
    rmse, _, s_fit = ate.ate_rmse(ts, est, ts, gt, with_scale=True)
    lc = slam.loopcloser
    summary = dict(state=slam.get_tracking_state(), tracked=len(gt_by_ts), ate_m=rmse, scale=s_fit,
                   n_kf=slam.tracker.world.n_kf, landmarks=int(slam.tracker.world.lm_valid.sum()),
                   loops=lc.n_loops_closed, merges=lc.n_maps_merged, closed_at=closed_at, maps=max_maps,
                   gba=gba_launches["gba"],
                   gba_launches_F=gba_launches["F"], gba_launches_T=gba_launches["T"], kf_at=kf_at)
    if not check:
        return slam, summary, track
    if len(blackout):
        ok = summary["maps"] >= 2 and summary["merges"] >= 1 and summary["tracked"] > 100 and rmse < 0.5
    else:
        ok = summary["tracked"] > 120 and summary["loops"] >= 1 and rmse < 0.20
    if not (ok and summary["state"] == "OK"):
        raise RuntimeError(f"{'Atlas' if len(blackout) else 'loop'} scenario gates failed: {summary}")
    return slam, summary, track


def distorted_mono_settings():
    """configs/synthetic_mono.yaml with EuRoC cam0's distortion on its
    intrinsics (phase 10 (d)); the images are rendered through the same
    camera."""
    import dataclasses

    from orb_slam3_fast_tpu_torch.cameras.models import Camera
    from orb_slam3_fast_tpu_torch.slam.settings import Settings

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0, EUROC_DIST)
    return dataclasses.replace(Settings.from_yaml(MONO_CONFIG, "monocular"), cam=cam)


def run_mono(frames, poses, device, settings=None, fork=None, check: bool = True):
    """The monocular System (configs/synthetic_mono.yaml, or ``settings``;
    min_init_matches 60 as tests/test_slam_e2e.py:17) on its corridor, and
    that test's gates (tests/test_slam_e2e.py:42-49): final state OK, > 30
    of 40 frames tracked, >= 3 keyframes, > 200 live landmarks,
    scale-aligned ATE < 0.15 m (``check`` False: no gates, for a prefix of
    the frames).  A dict ``fork`` with ``"at"`` receives a deep copy of the
    System after that many frames (``"slam"``) and their per-frame track
    (``"track"``): :func:`run_reloc` goes on from it.  Returns the System, a
    summary dict and the per-frame (state, R, t), identity before
    initialisation."""
    import copy

    from orb_slam3_fast_tpu_torch.eval import ate
    from orb_slam3_fast_tpu_torch.slam.system import System

    slam = System(settings or MONO_CONFIG, "monocular", tracker_overrides=dict(min_init_matches=60), max_keyframes=256,
                  enable_loop_closing=False, multi_map=False, async_backend=False, device=device)
    est, gt, ts, track, kf_frames, init_frame = [], [], [], [], [], None
    for i, (img, (R, t)) in enumerate(zip(frames, poses)):
        if fork is not None and i == fork["at"]:
            fork.update(slam=copy.deepcopy(slam), track=list(track))
        n_kf = slam.world.n_kf
        state, pose = slam.track_monocular(img, i * 0.05)
        if pose is None:
            pose = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        track.append((state, *pose))
        if slam.world.n_kf > n_kf:
            kf_frames.append(i)
        if state == "OK":
            init_frame = i if init_frame is None else init_frame
            est.append(-pose[0].T @ pose[1])
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
    if device.type == "cuda":
        torch.cuda.synchronize()
    est, gt, ts = np.asarray(est), np.asarray(gt), np.asarray(ts)
    rmse, _, s_fit = ate.ate_rmse(ts, est, ts, gt, with_scale=True)
    summary = dict(state=slam.get_tracking_state(), tracked=len(est), ate_m=rmse, scale=s_fit, n_kf=slam.world.n_kf,
                   landmarks=int(slam.world.lm_valid.sum()), init_frame=init_frame, kf_frames=kf_frames,
                   local_ba=slam.mapper.n_local_ba, indexed=int(slam.kfdb.valid.sum()))
    if check and not (summary["state"] == "OK" and summary["tracked"] > int(len(frames) * 30 / 40)
                      and summary["n_kf"] >= 3 and summary["landmarks"] > 200 and rmse < 0.15):
        raise RuntimeError(f"mono System gates failed: {summary}")
    return slam, summary, track


def run_reloc(frames, poses, device, fork=None):
    """tests/test_reloc.py's scenario on the mono System: 30 frames, every
    keyframe indexed, 3 blank frames -> RECENTLY_LOST, then frame 20 again
    -> OK, the camera centre within 0.5 of frame 20's (the test's scale
    bound); with ``fork`` (:func:`run_mono`'s, at ``RELOC_FRAMES``: the
    same System on the same first 30 frames) it goes on from there.
    Returns (per-frame (state, R, t), the relocalised frame's track_total
    ms, summary)."""
    from orb_slam3_fast_tpu_torch.slam.system import System

    if fork is not None:
        slam = fork["slam"]
        track = [(st, (R, t)) for st, R, t in fork["track"]]
    else:
        slam = System(MONO_CONFIG, "monocular", tracker_overrides=dict(min_init_matches=60), max_keyframes=256,
                      enable_loop_closing=False, multi_map=False, async_backend=False, device=device)
        track = [slam.track_monocular(frames[i], i * 0.05) for i in range(RELOC_FRAMES)]
    if not (slam.get_tracking_state() == "OK" and int(slam.kfdb.valid.sum()) == slam.world.n_kf):
        raise RuntimeError(f"reloc: state {slam.get_tracking_state()}, {int(slam.kfdb.valid.sum())} indexed of "
                           f"{slam.world.n_kf} keyframes")
    last_R, last_t = track[-1][1]
    pose_before = -last_R.T @ last_t
    blank = np.full((480, 640), 25.0, np.float32)
    for j in range(3):
        track.append(slam.track_monocular(blank, (RELOC_FRAMES + j) * 0.05))
    if slam.get_tracking_state() != "RECENTLY_LOST":
        raise RuntimeError(f"reloc: {slam.get_tracking_state()} after the blank frames")
    state, pose = slam.track_monocular(frames[RELOC_REVISIT], (RELOC_FRAMES + 4) * 0.05)
    track.append((state, pose))
    reloc_ms = slam.timers.spans["track_total"][-1]
    if state != "OK":
        raise RuntimeError("reloc: relocalisation failed")
    R20, t20 = poses[RELOC_REVISIT]
    R29, t29 = poses[RELOC_FRAMES - 1]
    c_gt = -R20.T @ t20 * np.linalg.norm(pose_before) / max(np.linalg.norm(-R29.T @ t29), 1e-9)
    err = float(np.linalg.norm(-pose[0].T @ pose[1] - c_gt))
    if err >= 0.5:
        raise RuntimeError(f"reloc: relocalised pose off by {err:.3f} (bound 0.5)")
    track = [(s, *(p if p is not None else (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))))
             for s, p in track]
    return track, reloc_ms, dict(n_kf=slam.world.n_kf, landmarks=int(slam.world.lm_valid.sum()), err=err,
                                 ref_kf=slam.tracker.ref_kf)


def corridor_frames(n_frames: int):
    """The System phase's input: test_slam_e2e.py's stereo corridor (seed 1,
    900 splats, arc_trajectory(step=0.06, lateral=0.05), 0.12 m baseline),
    rendered on the host; returns (frames, true T_cw per frame)."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    world = make_corridor_world(np.random.default_rng(1), n=900)
    poses = arc_trajectory(n_frames, step=0.06, lateral=0.05)
    return render_views("stereo", world, (cam,), poses), poses


def rgbd_settings():
    """configs/synthetic_stereo.yaml loaded for RGB-D, bf replaced by the
    RGB-D test's virtual baseline (there is no RGB-D configuration file)."""
    import dataclasses

    from orb_slam3_fast_tpu_torch.slam.settings import Settings

    return dataclasses.replace(Settings.from_yaml(SYS_CONFIG, "rgbd"), bf=RGBD_BF)


def rgbd_frames(n_frames: int):
    """The RGB-D phase's input: test_slam_e2e.py's RGB-D corridor (seed 2,
    900 splats, arc_trajectory(step=0.06, lateral=0.05)), image and splat
    depth rendered on the host; returns (frames, true T_cw per frame)."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    world = make_corridor_world(np.random.default_rng(2), n=900)
    poses = arc_trajectory(n_frames, step=0.06, lateral=0.05)
    return render_views("rgbd", world, (cam,), poses), poses


def run_system(frames, poses, device, sensor: str = "stereo", check: bool = True):
    """The stereo or RGB-D System on its corridor, as test_slam_e2e.py
    drives the JAX tracker, and that test's gates.  Stereo: final state OK,
    > 25 of 30 frames tracked, unscaled ATE < 0.10 m, |scale - 1| < 0.1,
    and mapping (>= 3 keyframes, a local BA, triangulated landmarks).
    RGB-D: final state OK, > 20 of 25 frames tracked, unscaled ATE < 0.40
    m, and at least the keyframes and local BAs of the JAX package on the
    same frames (``check`` False: no gates, for a prefix of the frames).
    Returns the System, a summary dict and the per-frame (state, R, t)."""
    from orb_slam3_fast_tpu_torch.eval import ate
    from orb_slam3_fast_tpu_torch.slam.system import System

    opts = dict(enable_loop_closing=False, multi_map=False, async_backend=False, device=device)
    if sensor == "stereo":
        slam = System(SYS_CONFIG, "stereo", **opts)
        feed = slam.track_stereo
    else:
        slam = System(rgbd_settings(), "rgbd", **opts)
        feed = slam.track_rgbd
    est, gt, ts, track, kf_frames = [], [], [], [], []
    for i, (f, (R, t)) in enumerate(zip(frames, poses)):
        n_kf = slam.world.n_kf
        state, pose = feed(*f, i * 0.05)
        track.append((state, *pose))
        if slam.world.n_kf > n_kf:
            kf_frames.append(i)
        if state == "OK" and pose is not None:
            est.append(-pose[0].T @ pose[1])
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
    if device.type == "cuda":
        torch.cuda.synchronize()
    est, gt, ts = np.asarray(est), np.asarray(gt), np.asarray(ts)
    rmse, _, _ = ate.ate_rmse(ts, est, ts, gt, with_scale=False)
    _, _, s_fit = ate.ate_rmse(ts, est, ts, gt, with_scale=True)
    summary = dict(state=slam.get_tracking_state(), tracked=len(est), ate_m=rmse, scale=s_fit, n_kf=slam.world.n_kf,
                   landmarks=int(slam.world.lm_valid.sum()), local_ba=slam.mapper.n_local_ba,
                   triangulated=slam.mapper.n_triangulated, kf_frames=kf_frames)
    if sensor == "stereo":
        ok = (summary["tracked"] > int(len(frames) * 25 / 30) and rmse < 0.10 and abs(s_fit - 1) < 0.1
              and summary["n_kf"] >= 3 and summary["local_ba"] >= 1 and summary["triangulated"] > 0)
    else:
        ok = (summary["tracked"] > int(len(frames) * 20 / 25) and rmse < 0.40 and summary["n_kf"] >= RGBD_MIN_KF
              and summary["local_ba"] >= RGBD_MIN_BA)
    if check and not (ok and summary["state"] == "OK"):
        raise RuntimeError(f"{sensor} System gates failed: {summary}")
    return slam, summary, track


def vi_frames(sensor: str, n_frames: int = VI_FRAMES):
    """Phase 11's input: tests/test_vi_tracker.py's IMU stream (step 0.06,
    lateral 0.05, its biases and noise) along the arc, and the frames the
    sensor sees of its corridor: mono the mono test's (seed 0, as
    test_vi_tracker.py), stereo the stereo corridor (seed 1, 0.12 m
    baseline), RGB-D the RGB-D corridor (seed 2, splat depth).  Returns
    (frames, true T_cw per frame, IMU rows)."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    seed = {"monocular": 0, "stereo": 1, "rgbd": 2}[sensor]
    world = make_corridor_world(np.random.default_rng(seed), n=900)
    poses, imu = arc_trajectory_with_imu(n_frames, step=0.06, lateral=0.05, gyro_bias=VI_GYRO_BIAS,
                                         acc_bias=VI_ACC_BIAS, noise_gyro=1.7e-4 * np.sqrt(200.0),
                                         noise_acc=2e-3 * np.sqrt(200.0), seed=0)
    frames = render_views({"monocular": "mono1", "stereo": "stereo", "rgbd": "rgbd"}[sensor], world, (cam,), poses)
    return frames, poses, imu


def imu_slices(imu, n_frames: int, dt_frame: float = 0.05):
    """The samples up to each frame's timestamp, as test_vi_tracker.py feeds them."""
    out, i = [], 0
    for f in range(n_frames):
        j = i
        while j < len(imu) and imu[j, 0] <= f * dt_frame + 1e-9:
            j += 1
        out.append(imu[i:j])
        i = j
    return out


def run_vi(frames, poses, imu, device, sensor: str = "monocular"):
    """Phase 11: the inertial System (``System(..., sensor + "-inertial",
    enable_loop_closing=False, async_backend=False)``) on a scene of
    :func:`vi_frames`, with test_vi_tracker.py's ``init_min_kfs=8,
    init_min_time=1.0`` (and its min_init_matches=60 for mono).  Returns
    the System, a summary dict (state, tracked, IMU-init frame, keyframes,
    the scale-aligned and unscaled ATE after the init frame, the fitted
    scale, the gyro bias) and the per-frame (state, R, t)."""
    from orb_slam3_fast_tpu_torch.eval import ate
    from orb_slam3_fast_tpu_torch.slam.system import System

    opts = dict(enable_loop_closing=False, multi_map=False, async_backend=False, device=device)
    if sensor == "monocular":
        slam = System(MONO_CONFIG, "monocular-inertial", tracker_overrides=dict(min_init_matches=60), **opts)
        feed = slam.track_monocular
    elif sensor == "stereo":
        slam = System(SYS_CONFIG, "stereo-inertial", **opts)
        feed = slam.track_stereo
    else:
        slam = System(rgbd_settings(), "rgbd-inertial", **opts)
        feed = slam.track_rgbd
    slam.tracker.icfg = slam.tracker.icfg._replace(init_min_kfs=8, init_min_time=1.0)
    est, gt, ts, track, kf_frames, init_frame = [], [], [], [], [], None
    for i, (f, (R, t), samples) in enumerate(zip(frames, poses, imu_slices(imu, len(frames)))):
        n_kf = slam.world.n_kf
        state, pose = feed(*f, i * 0.05, imu=samples)
        if pose is None:
            pose = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        track.append((state, *pose))
        if slam.world.n_kf > n_kf:
            kf_frames.append(i)
        if slam.world.imu_initialized and init_frame is None:
            init_frame = i
        if state == "OK" and init_frame is not None and i > init_frame:
            est.append(-pose[0].T @ pose[1])
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
    if device.type == "cuda":
        torch.cuda.synchronize()
    summary = dict(state=slam.get_tracking_state(), tracked=sum(s == "OK" for s, _, _ in track),
                   init_frame=init_frame, after_init=len(est), n_kf=slam.world.n_kf, kf_frames=kf_frames,
                   bg=[round(float(x), 5) for x in slam.tracker.cur_bias[:3].tolist()])
    if len(est) >= 3:
        est, gt, ts = np.asarray(est), np.asarray(gt), np.asarray(ts)
        summary["ate_m"], _, summary["scale"] = ate.ate_rmse(ts, est, ts, gt, with_scale=True)
        summary["ate_unscaled_m"] = ate.ate_rmse(ts, est, ts, gt, with_scale=False)[0]
    return slam, summary, track


def imu_chain(rng, n_kf: int, kf_dt: float = 0.25, hz: float = 200.0, gyro_bias=None, acc_bias=None):
    """tests/test_inertial.py's simulate_trajectory in numpy: a body flying
    with sinusoidal acceleration and yaw; the states (R_wb, p, v) at each of
    ``n_kf`` keyframes ``kf_dt`` apart and the IMU samples between them.
    Returns (states, [(acc, gyro)] per segment, dt)."""
    from orb_slam3_fast_tpu_torch.utils import lie

    steps, dt = int(kf_dt * hz), 1.0 / hz
    g = np.array([0.0, 0.0, -9.81])
    bg = np.zeros(3) if gyro_bias is None else np.asarray(gyro_bias)
    ba = np.zeros(3) if acc_bias is None else np.asarray(acc_bias)
    R, p, v, t = np.eye(3), np.zeros(3), np.array([0.3, 0.0, 0.0]), 0.0
    states, segments = [(R.copy(), p.copy(), v.copy())], []
    for _ in range(n_kf - 1):
        acc, gyr = [], []
        for _ in range(steps):
            a_w = np.array([0.4 * np.sin(2 * t), 0.3 * np.cos(1.5 * t), 0.2 * np.sin(t)])
            w_b = np.array([0.05 * np.sin(t), 0.08 * np.cos(2 * t), 0.3])
            acc.append(R.T @ (a_w - g) + ba)
            gyr.append(w_b + bg)
            p, v = p + v * dt + 0.5 * a_w * dt * dt, v + a_w * dt
            R = R @ lie.so3_exp(torch.tensor(w_b * dt, dtype=torch.float32)).numpy().astype(np.float64)
            t += dt
        states.append((R.copy(), p.copy(), v.copy()))
        segments.append((np.asarray(acc, np.float32), np.asarray(gyr, np.float32)))
    return states, segments, dt


def _preints(segments, dt, noise, device):
    from orb_slam3_fast_tpu_torch.imu import preintegration as pre

    ps = [pre.preintegrate_plain(torch.as_tensor(a), torch.as_tensor(g), torch.full((len(a),), dt), torch.zeros(6),
                                 noise) for a, g in segments]
    return pre.stack(ps).to(device)


def w_problem(rng, device, n: int):
    """Kernel W's input at the frame's capacity ``n``: two body states one
    frame (0.05 s) apart, the window between them, 40% of the slots
    observing landmarks 4-12 m ahead (half of them stereo, bf 48, 10%
    outliers, 0.3 px noise), the start 0.02 rad / 5 cm / 0.1 m/s off, a
    camera a few cm and degrees off the body."""
    from orb_slam3_fast_tpu_torch.cameras import models as cm
    from orb_slam3_fast_tpu_torch.imu import preintegration as pre
    from orb_slam3_fast_tpu_torch.optim import inertial as inr
    from orb_slam3_fast_tpu_torch.utils import lie

    noise = pre.ImuNoise.from_continuous(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
    states, segments, dt = imu_chain(rng, 2, kf_dt=0.05)
    preint = pre.unpack(pre.pack(_preints(segments, dt, noise, device))[0])
    T_bc = lie.se3_exp(torch.tensor([0.05, -0.02, 0.01, 0.02, -0.03, 0.01]))
    T_cb = lie.SE3(T_bc.R.to(device), T_bc.t.to(device)).inverse()
    b0 = torch.tensor([0.001, -0.002, 0.0015, 0.02, -0.01, 0.03])
    s_prev = inr.BodyState(*(torch.tensor(x, dtype=torch.float32) for x in states[0]), b0).to(device)
    s_true = inr.BodyState(*(torch.tensor(x, dtype=torch.float32) for x in states[1]), b0).to(device)
    xw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(4, 12, n)], -1).astype(np.float32)
    R_cw, t_cw = inr.camera_pose(T_cb, s_true.R, s_true.p)
    xc = torch.as_tensor(xw).to(device) @ R_cw.T + t_cw
    cam = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    uvr = cm.stereo_project(cam, xc, 48.0).cpu().numpy() + rng.normal(0, 0.3, (n, 3))
    valid = rng.uniform(size=n) < 0.4
    st = valid & (rng.uniform(size=n) < 0.5)
    uvr[~st, 2] = -1.0
    out = rng.uniform(size=n) < 0.1
    uvr[out, :2] += rng.uniform(20, 40, (int(out.sum()), 2))
    obs = inr.VIObs(*(torch.as_tensor(a).to(device) for a in (
        xw, uvr.astype(np.float32), (1.0 / 1.44 ** rng.integers(0, 4, n)).astype(np.float32), st, valid)))
    d = torch.tensor([0.02, -0.01, 0.015], device=device)
    s0 = inr.BodyState(s_true.R @ lie.so3_exp(d), s_true.p + torch.tensor([0.05, -0.03, 0.02], device=device),
                       s_true.v + torch.tensor([0.1, 0.05, -0.05], device=device), s_true.bias)
    prior = inr.PriorState(state=s_prev._replace(p=s_prev.p + 0.01),
                           H=torch.diag(torch.linspace(10.0, 1e3, 15)).to(device))
    return cam, T_cb, preint, s_prev, s0, obs, prior


def x_problem(rng, device, K: int):
    """Kernel X's input: a chain of K keyframes 0.35 s apart (the coarse
    edges of the initialisation) with the biases of tests/test_inertial.py,
    seen by visual SLAM in a world tilted by (0.15, -0.1, 0) rad and scaled
    by 1/3."""
    from orb_slam3_fast_tpu_torch.imu import preintegration as pre
    from orb_slam3_fast_tpu_torch.utils import lie

    noise = pre.ImuNoise.from_continuous(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
    states, segments, dt = imu_chain(rng, K, kf_dt=0.35, gyro_bias=(0.02, -0.01, 0.015), acc_bias=(0.05, 0.08, -0.06))
    rot = lie.so3_exp(torch.tensor([0.15, -0.1, 0.0])).numpy().astype(np.float64)
    R = torch.tensor(np.stack([rot @ s[0] for s in states]), dtype=torch.float32, device=device)
    p = torch.tensor(np.stack([rot @ s[1] / 3.0 for s in states]), dtype=torch.float32, device=device)
    v = torch.tensor(np.stack([rot @ s[2] / 3.0 for s in states]), dtype=torch.float32, device=device)
    return R, p, v, _preints(segments, dt, noise, device)


def y_problem(rng, device, K: int = 16, M: int = 2048, per_lm: int = 4, n_real: int = 11):
    """Kernel Y's input at the mono path's bucket: ``n_real`` keyframe
    states 0.3 s apart (11: the window of 10 and its fixed anchor; more:
    the full inertial BA at the IMU initialisation) padded to K with fixed
    repeats of the newest, M landmarks 3-8 m ahead each seen by ``per_lm``
    of 11 neighbouring real keyframes spanning at least 6 of them (O = M * per_lm
    observations, 0.5 px noise, 5% outliers, monocular), the states and
    landmarks perturbed, the K-1 edge table with its padded edges invalid.
    (Landmarks seen over a shorter baseline are so weakly constrained in
    depth that a float32 and a float64 solve place them metres apart.)"""
    from orb_slam3_fast_tpu_torch.cameras import models as cm
    from orb_slam3_fast_tpu_torch.imu import preintegration as pre
    from orb_slam3_fast_tpu_torch.optim import vi_ba
    from orb_slam3_fast_tpu_torch.utils import lie

    noise = pre.ImuNoise.from_continuous(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
    states, segments, dt = imu_chain(rng, n_real, kf_dt=0.3)
    R = np.stack([s[0] for s in states] + [states[-1][0]] * (K - n_real)).astype(np.float32)
    p = np.stack([s[1] for s in states] + [states[-1][1]] * (K - n_real)).astype(np.float32)
    v = np.stack([s[2] for s in states] + [states[-1][2]] * (K - n_real)).astype(np.float32)
    xw = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M), rng.uniform(3, 8, M)], -1).astype(np.float32)

    local = n_real > 11  # a longer chain: each landmark ahead of a stretch of 11 keyframes that see it

    def spread():
        while True:
            c = (rng.integers(0, n_real - 10) if local else 0) + rng.choice(11, per_lm, replace=False)
            if c.max() - c.min() >= 6:
                return c

    kf = np.concatenate([spread() for _ in range(M)]).astype(np.int32)
    lm = np.repeat(np.arange(M), per_lm).astype(np.int32)
    if local:
        xw += p[kf].reshape(M, per_lm, 3).mean(1)
    xc = np.einsum("oji,oj->oi", R[kf], xw[lm] - p[kf])
    cam = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    uv = cm.project(cam, torch.as_tensor(xc.astype(np.float32))).numpy() + rng.normal(0, 0.5, (len(kf), 2))
    out = rng.uniform(size=len(kf)) < 0.05
    uv[out] += rng.uniform(15, 30, (int(out.sum()), 2))
    uvr = np.concatenate([uv, -np.ones((len(kf), 1))], 1).astype(np.float32)
    for k in range(1, n_real):
        R[k] = R[k] @ lie.so3_exp(torch.tensor(rng.normal(0, 0.01, 3), dtype=torch.float32)).numpy()
        p[k] += rng.normal(0, 0.02, 3).astype(np.float32)
        v[k] += rng.normal(0, 0.05, 3).astype(np.float32)
    E = K - 1
    pre_list = [pre.unpack(x) for x in pre.pack(_preints(segments, dt, noise, "cpu"))]
    pre_list += [pre_list[-1]] * (E - len(pre_list))
    d = lambda a: torch.as_tensor(a).to(device)
    prob = vi_ba.VIBAProblem(
        R_wb=d(R), p_wb=d(p), v_w=d(v), bias=torch.zeros((K, 6), device=device),
        state_fixed=d((np.arange(K) == 0) | (np.arange(K) >= n_real)),
        xw=d(xw + rng.normal(0, 0.03, xw.shape).astype(np.float32)), lm_valid=torch.ones(M, dtype=torch.bool,
                                                                                          device=device),
        obs_kf=d(kf), obs_lm=d(lm), obs_uv=d(uvr), obs_inv_sigma2=torch.ones(len(kf), device=device),
        obs_is_stereo=torch.zeros(len(kf), dtype=torch.bool, device=device),
        obs_valid=d(xc[:, 2] > 0.5), edge_i=d(np.r_[np.arange(n_real - 1), np.zeros(E - n_real + 1)].astype(np.int32)),
        edge_j=d(np.r_[np.arange(1, n_real), np.ones(E - n_real + 1)].astype(np.int32)),
        edge_valid=d(np.arange(E) < n_real - 1), preint=pre.stack(pre_list).to(device))
    return cam, prob


def compare_vi_kernels(device) -> list[dict]:
    """Phase 3 for the inertial path's kernels, each against its plain
    version on the same CUDA tensors, with CUDA-event times: V on a
    64-sample window (and its merge and compose forms), W at the frame's
    keypoint capacity in its three forms (no prior, a prior, the last
    frame), X at K = 16 and 32 and its refinement, Y at K = 16, M = 2048,
    O = 8192; and beyond the windows the path usually takes, X's two
    entries on a chain of X_LONG keyframes (its system in global memory)
    and Y at K = 128 (100 real states: the full inertial BA at a late
    initialisation), held to the same tolerances and timed apart."""
    from orb_slam3_fast_tpu_torch.imu import preintegration as pre
    from orb_slam3_fast_tpu_torch.ops import extractor as ext
    from orb_slam3_fast_tpu_torch.optim import imu_init, inertial, vi_ba
    from orb_slam3_fast_tpu_torch.utils import lie

    out = []
    rng = np.random.default_rng(11)
    noise = pre.ImuNoise.from_continuous(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
    # V
    n = 64
    acc = torch.as_tensor((rng.normal(size=(n, 3)) * 2.0 + [0, 0, 9.81]).astype(np.float32)).to(device)
    gyro = torch.as_tensor((rng.normal(size=(n, 3)) * 0.3).astype(np.float32)).to(device)
    dts = torch.full((n,), 1.0 / 200.0, device=device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    bias = torch.as_tensor((rng.normal(size=6) * 0.01).astype(np.float32)).to(device)
    pk = pre.preintegrate(acc, gyro, dts, bias, noise, valid)
    pp, pms = timed(lambda: pre.preintegrate_plain(acc, gyro, dts, bias, noise, valid))
    mk, mp = pre.merge(pk, acc, gyro, dts, noise, valid), pre.merge_plain(pp, acc, gyro, dts, noise, valid)
    ck, cp = pre.compose(pk, pk), pre.compose_plain(pp, pp)
    torch.cuda.synchronize()

    def preint_err(a, b):
        e = max(float((getattr(a, f) - getattr(b, f)).abs().max()) for f in pre.Preintegrated._fields if f != "C")
        return e, float((a.C - b.C).abs().max() / b.C.abs().max())

    v_err = [preint_err(a, b) for a, b in ((pk, pp), (mk, mp), (ck, cp))]
    if max(e for e, _ in v_err) > 1e-4 or max(c for _, c in v_err) > 1e-3:
        raise RuntimeError(f"kernel V disagrees with its plain version: {v_err}")
    ms = cuda_ms(lambda: pre.preintegrate(acc, gyro, dts, bias, noise, valid), 50)
    mats = torch.randn((n, 3, 3), device=device)
    lib = cuda_ms(lambda: torch.linalg.svd(mats), 20)
    out.append(dict(name="imu_preint", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/imu_preint.cu",
                    replaces="orb_slam3_fast_tpu/imu/preintegration.py:172", max_abs_err=max(e for e, _ in v_err),
                    ms=ms, plain_ms=pms, **bound(n * 29 + 2 * pre.PACKED * 4, n * 6000), library_ms=lib,
                    shapes=f"a {n}-sample window; merge and compose errors {[round(e, 9) for e, _ in v_err[1:]]}, "
                           f"covariance relative errors {[f'{c:.2g}' for _, c in v_err]}; tolerances 1e-4 (deltas, "
                           "Jacobians), 1e-3 of the covariance's largest entry; library = batched torch.linalg.svd "
                           f"of the {n} 3x3 re-orthonormalisations"))
    # W: the frame's capacity
    cap = ext.total_capacity(ext.ExtractorConfig(n_features=768))
    cam, T_cb, preint, s_prev, s0, obs, prior = w_problem(rng, device, cap)
    w_err, notes, w_ms, w_pms = 0.0, [], 0.0, 0.0
    forms = (("no prior", lambda: inertial.pose_inertial_optimization(cam, 48.0, T_cb, s_prev, preint, s0, obs),
              lambda: inertial.pose_inertial_optimization_plain(cam, 48.0, T_cb, s_prev, preint, s0, obs)),
             ("prior", lambda: inertial.pose_inertial_optimization(cam, 48.0, T_cb, s_prev, preint, s0, obs, prior),
              lambda: inertial.pose_inertial_optimization_plain(cam, 48.0, T_cb, s_prev, preint, s0, obs, prior)),
             ("last frame", lambda: inertial.pose_inertial_optimization_last_frame(cam, 48.0, T_cb, s_prev, prior,
                                                                                  preint, s0, obs),
              lambda: inertial.pose_inertial_optimization_last_frame_plain(cam, 48.0, T_cb, s_prev, prior, preint,
                                                                           s0, obs)))
    for label, fk, fp in forms:
        (sk, ik, nk, Hk), ((sp, ip, np_, Hp), p_ms) = fk(), timed(fp)
        torch.cuda.synchronize()
        e = max(float((a - b).abs().max()) for a, b in zip(sk, sp))
        h = float((Hk - Hp).abs().max() / Hp.abs().max())
        mism = int((ik != ip).sum())
        if e > 5e-3 or h > 5e-3 or mism > 2:
            raise RuntimeError(f"kernel W ({label}) disagrees with its plain version: state {e}, H {h}, {mism} edges")
        w_err = max(w_err, e)
        k_ms = cuda_ms(fk, 10)
        w_ms += k_ms
        w_pms += p_ms
        notes.append(f"{label} {k_ms:.3f} ms (plain {p_ms:.1f}), state err {e:.2g}, H rel err {h:.2g}, "
                     f"{int(nk)} inliers, {mism} classified otherwise")
    nv = int(obs.valid.sum())
    w_ops = 40 * (nv * 260 + 60_000) * 3 + 4 * cap * 40 * 3
    Hs = torch.eye(30, device=device) * 2.0 + 0.01
    lib = cuda_ms(lambda: torch.linalg.solve(Hs, torch.ones(30, device=device)), 20)
    out.append(dict(name="pose_inertial", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/pose_inertial.cu",
                    replaces="orb_slam3_fast_tpu/optim/inertial.py:123", max_abs_err=w_err, ms=w_ms, plain_ms=w_pms,
                    **bound(3 * (cap * 30 + 3 * 21 * 4 + pre.PACKED * 4 + 246 * 4), w_ops), library_ms=lib,
                    shapes=f"{cap} slots ({nv} observing), the three forms summed: " + "; ".join(notes) +
                           "; tolerances: state 5e-3, H 5e-3 of its largest entry, 2 edges; library = one "
                           "torch.linalg.solve of a 30x30 system (one of the 40 solves of the last-frame form)"))
    # X: K = 16 and 32, and the refinement
    x_err, notes, x_ms, x_pms, x_ops = 0.0, [], 0.0, 0.0, 0
    for K in (16, 32):
        R, p, v, preints = x_problem(rng, device, K)
        fk = lambda: imu_init.inertial_only_optimization(R, p, preints)
        fp = lambda: imu_init.inertial_only_optimization_plain(R, p, preints)
        ik, (ip, p_ms) = fk(), timed(fp)
        torch.cuda.synchronize()
        e = max(abs(float(ik.scale) / float(ip.scale) - 1), float((ik.Rwg - ip.Rwg).abs().max()),
                float((ik.bias - ip.bias).abs().max()), float((ik.vel - ip.vel).abs().max() / ip.vel.abs().max()))
        if e > 5e-3:
            raise RuntimeError(f"kernel X (K={K}) disagrees with its plain version: {e}")
        x_err = max(x_err, e)
        k_ms = cuda_ms(fk, 5)
        x_ms += k_ms
        x_pms += p_ms
        P, E = 9 + 3 * K, K - 1
        x_ops += 40 * (E * 15 * 3000 + E * 2430 + P * P * 18 + 2 * P ** 3 // 3)
        notes.append(f"K={K} (P={P}) {k_ms:.3f} ms (plain {p_ms:.1f}), err {e:.2g}, scale {float(ik.scale):.4f}")
    Rr, sr = imu_init.scale_gravity_refinement(R, p * 0.95, v * 0.95, torch.zeros(6, device=device), preints)
    Rq, sq = imu_init.scale_gravity_refinement_plain(R, p * 0.95, v * 0.95, torch.zeros(6, device=device), preints)
    e = max(abs(float(sr) - float(sq)), float((Rr - Rq).abs().max()))
    if e > 1e-3:
        raise RuntimeError(f"kernel X's refinement disagrees with its plain version: {e}")
    notes.append(f"refinement K=32 err {e:.2g}, scale {float(sr):.4f}")
    # the long chain: the system beyond shared memory; the refinement over the chain a long run grows
    R, p, v, preints = x_problem(np.random.default_rng(12), device, X_LONG)  # its own draws: K = 16's unchanged
    (ik, k_ms), (ip, p_ms) = timed(lambda: imu_init.inertial_only_optimization(R, p, preints)), \
        timed(lambda: imu_init.inertial_only_optimization_plain(R, p, preints))
    e = max(abs(float(ik.scale) / float(ip.scale) - 1), float((ik.Rwg - ip.Rwg).abs().max()),
            float((ik.bias - ip.bias).abs().max()), float((ik.vel - ip.vel).abs().max() / ip.vel.abs().max()))
    ((Rr, sr), r_ms), (Rq, sq) = timed(lambda: imu_init.scale_gravity_refinement(
        R, p * 0.95, v * 0.95, torch.zeros(6, device=device), preints)), imu_init.scale_gravity_refinement_plain(
        R, p * 0.95, v * 0.95, torch.zeros(6, device=device), preints)
    er = max(abs(float(sr) - float(sq)), float((Rr - Rq).abs().max()))
    if e > 5e-3 or er > 1e-3:
        raise RuntimeError(f"kernel X (K={X_LONG}) disagrees with its plain version: {e}, refinement {er}")
    x_err = max(x_err, e, er)
    notes.append(f"K={X_LONG} (P={9 + 3 * X_LONG}, system in global memory) {k_ms:.3f} ms (plain {p_ms:.1f}), "
                 f"err {e:.2g}; its refinement {r_ms:.3f} ms, err {er:.2g} (one call each, not in ms)")
    Hx = torch.eye(105, device=device) * 2.0 + 0.01
    lib = cuda_ms(lambda: torch.linalg.solve(Hx, torch.ones(105, device=device)), 20)
    out.append(dict(name="imu_init", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/imu_init.cu",
                    replaces="orb_slam3_fast_tpu/optim/imu_init.py:53", max_abs_err=x_err, ms=x_ms, plain_ms=x_pms,
                    **bound((16 + 32) * (48 + pre.PACKED * 4), x_ops), library_ms=lib,
                    shapes="; ".join(notes) + "; tolerance 5e-3 (scale relative, Rwg entries, biases, velocities "
                           "relative); library = one torch.linalg.solve of the 105x105 system (one of the 40)"))
    # Y: K = 16, M = 2048, O = 8192
    cam, prob = y_problem(rng, device)
    T_cb = lie.SE3.identity(device)  # the synthetic camera is the body, as on the mono path
    K, M, O = prob.R_wb.shape[0], prob.xw.shape[0], prob.obs_kf.shape[0]
    fk = lambda: vi_ba.vi_bundle_adjust(cam, 0.0, T_cb, prob)
    fp = lambda: vi_ba.vi_bundle_adjust_plain(cam, 0.0, T_cb, prob)
    yk, (yp, y_pms) = fk(), timed(fp)
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max()) for a, b in zip(yk[:5], yp[:5])]
    mism = float((yk[5] != yp[5]).float().mean())
    if errs[1] > 2e-3 or errs[4] > 1e-2 or errs[0] > 2e-4 or mism > 0.01:
        raise RuntimeError(f"kernel Y disagrees with its plain version: {errs}, {mism:.3%} classified otherwise")
    y_ms = cuda_ms(fk, 3, warmup=1)
    n = 15 * K
    A = torch.eye(n, device=device) * 2.0 + 0.001 * torch.ones((n, n), device=device)
    lib = cuda_ms(lambda: torch.linalg.solve(A, torch.ones(n, device=device)), 20)
    pairs = int(sum(c * c for c in torch.bincount(prob.obs_lm.long()).tolist()))
    y_ops = 12 * (O * 500 + pairs * 216 + 15 * 30 * 3000 + n * n * 60 + 2 * n ** 3 // 3)
    out.append(dict(name="vi_ba", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/vi_ba.cu",
                    replaces="orb_slam3_fast_tpu/optim/vi_ba.py:184", max_abs_err=max(errs), ms=y_ms, plain_ms=y_pms,
                    **bound(O * 27 + M * 13 + (K - 1) * pre.PACKED * 4 + K * 21 * 8, y_ops), library_ms=lib,
                    shapes=f"K={K} (11 real), M={M}, O={O}, {pairs} observation pairs; errors R {errs[0]:.2g} p "
                           f"{errs[1]:.2g} v {errs[2]:.2g} bias {errs[3]:.2g} xw {errs[4]:.2g}, {mism:.2%} classified "
                           "otherwise; tolerances p 2e-3 m, R 2e-4, xw 1e-2 m, 1%; library = one torch.linalg.solve "
                           f"of the formed {n}x{n} system (one of the 12)"))
    # K = 128: 100 real states
    cam, prob = y_problem(np.random.default_rng(13), device, K=128, n_real=100)
    (yk, k_ms), (yp, p_ms) = timed(lambda: vi_ba.vi_bundle_adjust(cam, 0.0, T_cb, prob)), \
        timed(lambda: vi_ba.vi_bundle_adjust_plain(cam, 0.0, T_cb, prob))
    errs = [float((a - b).abs().max()) for a, b in zip(yk[:5], yp[:5])]
    mism = float((yk[5] != yp[5]).float().mean())
    if errs[1] > 2e-3 or errs[4] > 1e-2 or errs[0] > 2e-4 or mism > 0.01:
        raise RuntimeError(f"kernel Y (K=128) disagrees with its plain version: {errs}, {mism:.3%} otherwise")
    out[-1]["max_abs_err"] = max(out[-1]["max_abs_err"], *errs)
    out[-1]["shapes"] += (f"; K=128 (100 real, n={15 * 128}) {k_ms:.1f} ms (plain {p_ms:.1f}), errors R {errs[0]:.2g} "
                          f"p {errs[1]:.2g} xw {errs[4]:.2g}, {mism:.2%} otherwise (one call, not in ms)")
    return out


def run_default_stereo(frames, poses, device):
    """Phase 10 (a): ``System(configs/synthetic_stereo.yaml, "stereo")``
    with every default (the async backend, loop closing, the Atlas, 512
    keyframes) on tests/test_pipeline.py:24-61's scenario, the frames fed as
    fast as they are tracked, and that test's gates: the backend drains
    within 120 s, no worker error, final state OK, >= 3 frames tracked while
    the worker was busy, > 25 tracked, unscaled ATE < 0.25 m.  Returns the
    System (shut down), a summary and the per-frame (state, R, t), which
    differ from run to run: what the worker has done by the time a frame
    is tracked depends on the host's speed."""
    from orb_slam3_fast_tpu_torch.eval import ate
    from orb_slam3_fast_tpu_torch.slam.system import System

    slam = System(SYS_CONFIG, "stereo", device=device)
    b = slam.backend
    est, gt, ts, kf_frames, track, overlapped = [], [], [], [], [], 0
    for i, ((img_l, img_r), (R, t)) in enumerate(zip(frames, poses)):
        n_kf = slam.world.n_kf
        state, pose = slam.track_stereo(img_l, img_r, i * 0.05)
        track.append((state, *pose))
        overlapped += b.queue_len() > 0
        if slam.world.n_kf > n_kf:
            kf_frames.append(i)
        if state == "OK" and pose is not None:
            est.append(-pose[0].T @ pose[1])
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
    drained = b.wait_idle(timeout=120)
    slam.shutdown()
    if device.type == "cuda":
        torch.cuda.synchronize()
    rmse, _, _ = ate.ate_rmse(np.asarray(ts), np.asarray(est), np.asarray(ts), np.asarray(gt), with_scale=False)
    summary = dict(state=slam.get_tracking_state(), tracked=len(est), ate_m=rmse, overlapped=int(overlapped),
                   drained=drained, errors=len(b.errors), n_kf=slam.world.n_kf, kf_frames=kf_frames,
                   local_ba=slam.mapper.n_local_ba, local_ba_skipped=slam.mapper.n_ba_skipped,
                   loops=slam.loopcloser.n_loops_closed)
    if not (drained and not b.errors and summary["state"] == "OK" and overlapped >= 3 and len(est) > 25
            and rmse < 0.25):
        raise RuntimeError(f"default stereo System gates failed: {summary}" + (f"\n{b.errors[0]}" if b.errors else ""))
    return slam, summary, track


def run_default_loop(frames, poses, device):
    """Phase 10 (b): the monocular System with phase 9's overrides and
    LoopCloserConfig and the async backend left at its default, on the
    circle, each frame fed at its timestamp (20 fps) as a live camera feeds
    it (faster if tracking keeps up, never earlier).  Returns the System
    (shut down), a summary (``check_default_loop`` holds it to the gates)
    and the per-frame (state, R, t)."""
    from orb_slam3_fast_tpu_torch.backend.loopcloser import LoopCloserConfig
    from orb_slam3_fast_tpu_torch.eval import ate
    from orb_slam3_fast_tpu_torch.optim import ba_cg
    from orb_slam3_fast_tpu_torch.slam.system import System

    slam = System(MONO_CONFIG, "monocular", tracker_overrides=dict(min_init_matches=60, motion_radius=25.0),
                  max_keyframes=256, device=device)
    slam.loopcloser.cfg = LoopCloserConfig(**LOOP_CONFIG)
    b = slam.backend
    est, gt, ts, kf_frames, closed_at, track, overlapped = [], [], [], [], [], [], 0
    t0 = time.perf_counter()
    for i, (img, (R, t)) in enumerate(zip(frames, poses)):
        wait = t0 + i * 0.05 - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        n_kf, n_closed = slam.world.n_kf, slam.loopcloser.n_loops_closed
        state, pose = slam.track_monocular(img, i * 0.05)
        track.append((state, *(pose if pose is not None else (np.eye(3, dtype=np.float32), np.zeros(3, np.float32)))))
        overlapped += b.queue_len() > 0
        if slam.world.n_kf > n_kf:
            kf_frames.append(i)
        if slam.loopcloser.n_loops_closed > n_closed:
            closed_at.append(i)
        if state == "OK" and pose is not None:
            est.append(-pose[0].T @ pose[1])
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
    feed_s = time.perf_counter() - t0
    drained = b.wait_idle(timeout=120)
    slam.shutdown()
    if device.type == "cuda":
        torch.cuda.synchronize()
    rmse, _, s_fit = ate.ate_rmse(np.asarray(ts), np.asarray(est), np.asarray(ts), np.asarray(gt), with_scale=True)
    t_gba = ba_cg.implicit_schur_solve.launches.total(thread="slam-gba")
    summary = dict(state=slam.get_tracking_state(), tracked=len(est), ate_m=rmse, scale=s_fit, drained=drained,
                   errors=len(b.errors), n_kf=slam.world.n_kf, loops=slam.loopcloser.n_loops_closed,
                   loop_seen_at=closed_at, gba_completed=b.gba_completed, gba_aborted=b.gba_aborted,
                   T_on_slam_gba=t_gba, overlapped=int(overlapped), local_ba=slam.mapper.n_local_ba,
                   local_ba_skipped=slam.mapper.n_ba_skipped, retired_skipped=b.n_retired_skipped, feed_s=feed_s,
                   kf_frames=kf_frames, error=b.errors[0] if b.errors else None)
    return slam, summary, track


def check_default_loop(summary) -> None:
    """Phase 10 (b)'s gates: the backend drained within 120 s and no
    worker error (tests/test_pipeline.py's); where the JAX package's own
    async System misses the loop test's gates at this pace, the level it
    reaches: at least ``ASYNC_LOOP_MIN_TRACKED`` frames tracked, a
    scale-aligned ATE of at most ``ASYNC_LOOP_MAX_ATE`` m.  The final
    state, the loops closed, the global BAs completed and T's launches on
    ``slam-gba`` are reported; phase 10 (e) gates the GBA thread."""
    if not (summary["drained"] and not summary["errors"] and summary["tracked"] >= ASYNC_LOOP_MIN_TRACKED
            and summary["ate_m"] <= ASYNC_LOOP_MAX_ATE):
        raise RuntimeError(f"default loop System gates failed: {summary}")


def run_gba_thread(slam):
    """Phase 10 (e): the GBA thread on the card.  An ``AsyncBackend`` over
    the mapper of phase 9's loop System is asked, as the loop closer asks
    it, for a global BA over that System's map (every live keyframe, all
    their landmarks and observations, the first keyframe fixed).  Gates: it
    drains within 120 s and completes, unaborted, with no worker error;
    kernels T and AC launch on the ``slam-gba`` thread and on no other,
    kernel F not at all.  Returns a summary."""
    from orb_slam3_fast_tpu_torch.backend.pipeline import AsyncBackend
    from orb_slam3_fast_tpu_torch.optim import ba, ba_cg

    world = slam.tracker.world
    kf_ids = np.nonzero(world.kf_valid[: world.n_kf])[0]
    backend = AsyncBackend(slam.mapper)

    def gba_thunk(abort_flag=None, map_lock=None):
        return slam.mapper._run_gba(world, kf_ids, fixed=kf_ids[:1], map_lock=map_lock, abort_flag=abort_flag)

    t0 = time.perf_counter()
    backend.request_gba(gba_thunk)
    drained = backend.wait_idle(timeout=120)
    seconds = time.perf_counter() - t0
    backend.shutdown()
    t_threads = ba_cg.implicit_schur_solve.launches.by_thread()
    ac_threads = {n: w.launches.by_thread() for n, w in (("update", ba.lm_update), ("classify", ba.classify))}
    summary = dict(drained=drained, seconds=seconds, keyframes=len(kf_ids), completed=backend.gba_completed,
                   aborted=backend.gba_aborted, errors=len(backend.errors), T_by_thread=t_threads,
                   AC_by_thread=ac_threads, F=ba.schur_solve.launches.total())
    if not (drained and backend.gba_completed == 1 and not backend.gba_aborted and not backend.errors
            and set(t_threads) == {"slam-gba"} and all(set(a) == {"slam-gba"} for a in ac_threads.values())
            and summary["F"] == 0):
        raise RuntimeError(f"the GBA thread on the card: {summary}" + (f"\n{backend.errors[0]}" if backend.errors else ""))
    return summary


def check_vi(sensor: str, summary: dict, launches: dict) -> None:
    """Phase 11's gates (``VI_GATES``) and V, W, X and Y launched on the path."""
    missing = [n for n in VI_KERNELS if launches[n] < 1]
    ok = summary["init_frame"] is not None and not missing
    if ok and sensor == "monocular":
        ok = summary["after_init"] >= VI_MONO_MIN_AFTER and summary.get("ate_m", 1.0) < 0.25
    elif ok:
        ok = (summary["state"] == "OK" and summary["tracked"] >= VI_FRAMES - 1
              and summary.get("ate_unscaled_m", 1.0) < VI_STEREO_MAX_ATE)
    if not ok:
        raise RuntimeError(f"{sensor}-inertial System gates failed: {summary}, never launched {missing}")


def check_prefix_against_plain(card, plain, n: int, bounds: tuple[float, float] = (TRACK_DT, TRACK_DR)
                               ) -> tuple[list[str], str]:
    """A System on the card against its host run on its first ``n`` frames
    (phase 8's prefixes, the inertial ones of 11 (c) among them): the
    frames as ``compare_tracks`` holds them at ``bounds``, the same
    keyframes and the same initialisation frame (of the map, or of the IMU
    for an inertial run)."""
    (_, sum_c, track_c), (_, sum_p, track_p) = card, plain
    bad, summary = compare_tracks(track_c[:n], track_p, *bounds)
    kf_c = [k for k in sum_c["kf_frames"] if k < n]
    if kf_c != sum_p["kf_frames"] or sum_c.get("init_frame") != sum_p.get("init_frame"):
        bad.append(f"keyframes / initialisation: card {sum_c} vs plain {sum_p}")
    return bad, (f"{summary}; keyframes at {kf_c} / {sum_p['kf_frames']}, initialised at frame "
                 f"{sum_c.get('init_frame')} / {sum_p.get('init_frame')}")


def compare_tracks(track_c, track_p, bound_dt: float = TRACK_DT, bound_dr: float = TRACK_DR) -> tuple[list[str], str]:
    """Per-frame (state, R, t) of a run on the card against the same run with
    the plain versions on the host, at the whole-path tests' tolerances: the
    same state, t within ``TRACK_DT`` and rotation entries within
    ``TRACK_DR`` (the loop path: ``LOOP_DT``, ``LOOP_DR``).  Every kernel
    sums in a fixed order, so a run on the card repeats exactly
    (``track_spread.py`` measures it; PERF.md).  Returns
    (failures, summary)."""
    bad, dt, dr = [], [], []
    for i, ((sc, Rc, tc), (sp, Rp, tp)) in enumerate(zip(track_c, track_p)):
        dt.append(float(np.abs(tc - tp).max()))
        dr.append(float(np.abs(Rc - Rp).max()))
        if sc != sp or dt[-1] > bound_dt or dr[-1] > bound_dr:
            bad.append(f"frame {i}: card {sc} {tc} vs plain {sp} {tp}, |dR| {dr[-1]:.3g}")
    over = [i for i, (a, b) in enumerate(zip(dt, dr)) if a > TRACK_DT or b > TRACK_DR]
    return bad, (f"{len(track_c)} frames, max |dt| {max(dt):.3g} at frame {int(np.argmax(dt))} (bound {bound_dt:g}), "
                 f"max |dR| {max(dr):.3g} (bound {bound_dr:g}); {len(over)} frames beyond {TRACK_DT:g} / "
                 f"{TRACK_DR:g}" + (f" (frames {over[0]}-{over[-1]})" if over else ""))


def check_system_against_plain(card, plain, bound_dt: float = TRACK_DT,
                               bound_dr: float = TRACK_DR) -> tuple[list[str], str]:
    """A System on the card against its run with the plain versions on the
    host (the path the tests hold against the JAX package): the frames as
    ``compare_tracks`` holds them, the same keyframe count, live landmarks
    within 3%, and a loop closed at the same frames.  Returns (failures,
    summary)."""
    (slam_c, sum_c, track_c), (slam_p, sum_p, track_p) = card, plain
    bad, summary = compare_tracks(track_c, track_p, bound_dt, bound_dr)
    if sum_c["n_kf"] != sum_p["n_kf"] or abs(sum_c["landmarks"] - sum_p["landmarks"]) > 0.03 * sum_p["landmarks"] \
            or sum_c.get("closed_at") != sum_p.get("closed_at"):
        bad.append(f"map: card {sum_c} vs plain {sum_p}")
    return bad, (f"{summary}; keyframes {sum_c['n_kf']} / {sum_p['n_kf']}, landmarks {sum_c['landmarks']} / "
                 f"{sum_p['landmarks']}")


# --- the inertial loop path: kernels Z and AA (phase 3), phase 12 ---------------------------------------------

VI_NOISE = (1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)  # tests/test_inertial.py's NOISE: gyro, acc, walks, rate


def vi_cg_problem(rng, device, n_kf: int = 6, n_lm: int = 200, noise: float = 0.3, pert: float = 0.03):
    """tests/test_vi_ba.py's build_vi_problem in the port: the flight of
    tests/test_inertial.py (camera = body), n_lm landmarks ahead seen by every
    keyframe (0.3 px noise, monocular), the states but the first (fixed)
    perturbed by ``pert`` (rad, m; 3x in m/s), the landmarks by 0.03 m.
    Returns (VIBAProblem on ``device``, truth (R, p, v))."""
    from orb_slam3_fast_tpu_torch.cameras import models as cm
    from orb_slam3_fast_tpu_torch.imu import preintegration as pre
    from orb_slam3_fast_tpu_torch.optim import vi_ba
    from orb_slam3_fast_tpu_torch.utils import lie

    states, segments, dt = imu_chain(rng, n_kf)
    preints = _preints(segments, dt, pre.ImuNoise.from_continuous(*VI_NOISE), device)
    R_gt, p_gt, v_gt = (np.stack([s[i] for s in states]).astype(np.float32) for i in range(3))
    xw = np.stack([rng.uniform(-5, 5, n_lm), rng.uniform(-4, 4, n_lm), rng.uniform(4, 14, n_lm)], -1).astype(np.float32)
    kf = np.repeat(np.arange(n_kf), n_lm).astype(np.int32)
    lm = np.tile(np.arange(n_lm), n_kf).astype(np.int32)
    xc = np.einsum("oji,oj->oi", R_gt[kf], xw[lm] - p_gt[kf])
    uv = cm.project(cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0), torch.as_tensor(xc)).numpy()
    uv = uv + rng.normal(0, noise, uv.shape)
    valid = (xc[:, 2] > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0) & (uv[:, 1] < 480)
    R0, p0, v0 = R_gt.copy(), p_gt.copy(), v_gt.copy()
    for k in range(1, n_kf):
        R0[k] = R0[k] @ lie.so3_exp(torch.as_tensor(rng.normal(0, pert, 3).astype(np.float32))).numpy()
        p0[k] = p0[k] + rng.normal(0, pert, 3)
        v0[k] = v0[k] + rng.normal(0, pert * 3, 3)
    xw0 = xw + rng.normal(0, 0.03, xw.shape).astype(np.float32)
    d = lambda a: torch.as_tensor(np.asarray(a)).to(device)  # noqa: E731
    O = len(kf)
    prob = vi_ba.VIBAProblem(
        R_wb=d(R0), p_wb=d(p0), v_w=d(v0), bias=torch.zeros((n_kf, 6), device=device),
        state_fixed=d(np.arange(n_kf) == 0), xw=d(xw0), lm_valid=torch.ones(n_lm, dtype=torch.bool, device=device),
        obs_kf=d(kf), obs_lm=d(lm), obs_uv=d(np.concatenate([uv, -np.ones((O, 1))], 1).astype(np.float32)),
        obs_inv_sigma2=torch.ones(O, device=device), obs_is_stereo=torch.zeros(O, dtype=torch.bool, device=device),
        obs_valid=d(valid), edge_i=d(np.arange(n_kf - 1, dtype=np.int32)), edge_j=d(np.arange(1, n_kf, dtype=np.int32)),
        edge_valid=torch.ones(n_kf - 1, dtype=torch.bool, device=device), preint=preints)
    return prob, (R_gt, p_gt, v_gt)


def inertial_world(rng, n_kf: int = 200, n_lm: int = 400, obs_per_kf: int = 96, noise: float = 0.3,
                   pose_pert: float = 0.02, lm_pert: float = 0.05, device="cpu"):
    """tests/test_vi_ba_cg.py's make_inertial_world in the port (the same
    draws from ``rng``): an ``n_kf``-keyframe inertial chain 0.25 s apart
    (camera = body) on tests/test_inertial.py's flight, landmarks around
    the whole trajectory, each keyframe observing its ``obs_per_kf``
    nearest visible ones (``noise`` px), the windows stored, the states but
    the first perturbed (``pose_pert`` rad and m, 3x in m/s), the landmarks
    by ``lm_pert``; the windows preintegrated on ``device`` (kernel V on the
    card).  Returns (WorldMap, R_gt, p_gt, v_gt)."""
    from orb_slam3_fast_tpu_torch.cameras import models as cm
    from orb_slam3_fast_tpu_torch.imu import preintegration as pre
    from orb_slam3_fast_tpu_torch.map.worldmap import WorldMap
    from orb_slam3_fast_tpu_torch.utils import lie

    states, segments, dt = imu_chain(rng, n_kf)
    R_gt, p_gt, v_gt = (np.stack([s[i] for s in states]).astype(np.float32) for i in range(3))
    xw_gt = (p_gt[rng.integers(0, n_kf, n_lm)] + rng.uniform(-6, 6, (n_lm, 3))).astype(np.float32)
    cam = cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    w = WorldMap(kp_cap=int(2 ** np.ceil(np.log2(obs_per_kf))), max_kf=int(2 ** np.ceil(np.log2(n_kf + 1))),
                 max_lm=2 * n_lm)
    w.n_lm = n_lm
    w.lm_valid[:n_lm] = True
    w.lm_pos[:n_lm] = xw_gt + rng.normal(0, lm_pert, (n_lm, 3)).astype(np.float32)
    w.lm_first_kf[:n_lm] = 0
    for k in range(n_kf):
        w.kf_valid[k] = True
        w.kf_ts[k] = 0.25 * k
        R_cw = R_gt[k].T
        xc = xw_gt @ R_cw.T - R_cw @ p_gt[k]
        uv = cm.project(cam, torch.as_tensor(xc)).numpy()
        vis = (xc[:, 2] > 0.5) & (uv[:, 0] > 10) & (uv[:, 0] < 630) & (uv[:, 1] > 10) & (uv[:, 1] < 470)
        cand = np.nonzero(vis)[0]
        take = cand[np.argsort(xc[cand, 2])][:obs_per_kf]
        n = len(take)
        w.kf_xy[k, :n] = uv[take] + rng.normal(0, noise, (n, 2)).astype(np.float32)
        w.kf_obs[k, :n] = take
        w.kf_kp_valid[k, :n] = True
        np.add.at(w.lm_n_obs, take, 1)
        pert = pose_pert if k else 0.0
        dR = lie.so3_exp(torch.as_tensor(rng.normal(0, pert, 3).astype(np.float32))).numpy()
        R_wb0 = R_gt[k] @ dR
        p_wb0 = p_gt[k] + rng.normal(0, pert, 3).astype(np.float32)
        w.kf_R[k] = R_wb0.T
        w.kf_t[k] = -R_wb0.T @ p_wb0
        w.kf_vel[k] = v_gt[k] + rng.normal(0, 3 * pert, 3).astype(np.float32)
    w.n_kf = n_kf
    w.imu_initialized = True
    noise_m = pre.ImuNoise.from_continuous(*VI_NOISE)
    for k in range(1, n_kf):
        acc, gyr = (torch.as_tensor(x).to(device) for x in segments[k - 1])
        w.kf_preint[k] = pre.preintegrate(acc, gyr, torch.full((len(acc),), dt, device=device),
                                          torch.zeros(6, device=device), noise_m)
    return w, R_gt, p_gt, v_gt


def welded_world(device="cpu"):
    """tests/test_vi_ba_cg.py:208's welded map (seed 0): one flight whose
    keyframes 0-9 play the destination map and 10-19 the transplanted
    source (no window spans the weld 9 -> 10), the source's welding window
    14-19 perturbed (0.02 rad, 5 cm, 0.1 m/s).  Returns (WorldMap, R_gt,
    p_gt, v_gt)."""
    from orb_slam3_fast_tpu_torch.utils import lie

    rng = np.random.default_rng(0)
    w, R_gt, p_gt, v_gt = inertial_world(rng, n_kf=20, n_lm=300, obs_per_kf=96, pose_pert=0.0, device=device)
    del w.kf_preint[10]
    for k in range(14, 20):
        R_wb = R_gt[k] @ lie.so3_exp(torch.as_tensor(rng.normal(0, 0.02, 3).astype(np.float32))).numpy()
        p_wb = p_gt[k] + rng.normal(0, 0.05, 3).astype(np.float32)
        w.kf_R[k] = R_wb.T
        w.kf_t[k] = -R_wb.T @ p_wb
        w.kf_vel[k] = v_gt[k] + rng.normal(0, 0.1, 3).astype(np.float32)
    return w, R_gt, p_gt, v_gt


def body_positions(w, n: int) -> np.ndarray:
    """The first ``n`` keyframes' body (= camera) centres."""
    return -np.einsum("kji,kj->ki", w.kf_R[:n], w.kf_t[:n])


def inertial_tracker(world, device):
    """The inertial tracker of the JAX tests' _make_tracker in the port:
    camera = body, tests/test_inertial.py's noise, a mapper."""
    from orb_slam3_fast_tpu_torch.backend.mapper import Mapper
    from orb_slam3_fast_tpu_torch.cameras.models import Camera
    from orb_slam3_fast_tpu_torch.frontend.vi_tracker import InertialTracker
    from orb_slam3_fast_tpu_torch.imu import preintegration as pre

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    return InertialTracker(cam, world=world, noise=pre.ImuNoise.from_continuous(*VI_NOISE),
                           mapper=Mapper(cam, bf=0.0, device=device), device=device)


def graph4_dist(a, b) -> float:
    """The largest difference of two 4-DoF graph solutions: rotation entries
    and camera centres (m)."""
    Ra, ta = (np.asarray(torch.as_tensor(x).detach().cpu(), np.float64) for x in a[:2])
    Rb, tb = (np.asarray(torch.as_tensor(x).detach().cpu(), np.float64) for x in b[:2])
    ca, cb = -np.einsum("kji,kj->ki", Ra, ta), -np.einsum("kji,kj->ki", Rb, tb)
    return float(max(np.abs(Ra - Rb).max(), np.abs(ca - cb).max()))


def graph4_ops(K: int, E: int, pcg: bool, cg_run=None) -> float:
    """The operations kernel Z's function needs: per Gauss-Newton step each
    edge's residual and its 8 derivatives (two yaw updates, two
    compositions, an SO(3) log and the Jacobian inverse, ~900 flops a
    direction, 9 with the value), its blocks (4 x 16 x 12 + 2 x 4 x 12); the
    dense (4K)^3 / 3 Cholesky and 2 (4K)^2 substitutions, or per vertex a
    4x4 inverse (~130) and per CG iteration that ran 4 4x4 mat-vecs per
    edge, one per vertex (32 flops each) and 12 per vertex entry; per vertex
    the update and an SVD (~700)."""
    per_step = E * (9 * 900 + 4 * 16 * 12 + 2 * 4 * 12) + K * 700
    if not pcg:
        return 12 * (per_step + (4 * K) ** 3 / 3 + 2 * (4 * K) ** 2)
    per_cg = E * 4 * 32 + K * 32 + 4 * K * 12
    return len(cg_run) * (per_step + K * 130) + int(np.sum(cg_run)) * per_cg


def vi_pcg_ops(K: int, M: int, O: int, E: int, steps: int, cg_run: int) -> float:
    """The operations kernel AA's function needs: per LM step per
    observation the residual, both Jacobians, the weight, W and W V^-1, its
    terms of Hpp, Hll, the gradients, W V^-1 W^T and the candidate's cost
    (~1100 flops); per edge 30 dual-number evaluations of the chain (~3500
    flops each, with their tangents), the information-weighted rows and the
    30x30 block (~36000), its costs (~3000); per state a 15x15 inverse and
    the retraction (~7500); per landmark its 3x3 inverse and
    back-substitution (~60); per CG iteration that ran 72 flops per
    observation, 18 per landmark and ~2550 per state (its edges' blocks,
    Hpp, the preconditioner, three dot products and vector updates)."""
    return steps * (O * 1100 + E * (30 * 3500 + 36000 + 3000) + K * 7500 + M * 60) + \
        cg_run * (O * 72 + M * 18 + K * 2550)


def vi_pcg_bytes(K: int, M: int, O: int, E: int) -> int:
    """Bytes kernel AA must move: the states (84 per state), landmarks (12),
    observations (index pairs, uv, sigma, flags: 26) and windows (1168 per
    edge, packed) in once, the states and landmarks out."""
    return K * 84 * 2 + M * 12 * 2 + O * 26 + E * (1168 + 9) + K + M


def compare_inertial_loop_kernels(device) -> list[dict]:
    """Phase 3 for the inertial loop path's kernels, each against its plain
    version on the same CUDA tensors, with CUDA-event times: Z on
    tests/test_pose_graph.py:105's yaw-drifted circle of 30 vertices (the
    dense branch, 12 iterations) and on yaw-drifted circles of 200 and 512
    (the PCG branch); AA (one segment of 2 LM steps, 40 CG iterations, and
    a whole full_inertial_ba_cg, 5 + 8 steps) on tests/test_vi_ba.py's
    problem (6 keyframes, 200 landmarks) and on tests/test_vi_ba_cg.py:167's
    200-keyframe inertial world, where the whole solve must also move every
    state toward the truth."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera
    from orb_slam3_fast_tpu_torch.optim import pose_graph as pg
    from orb_slam3_fast_tpu_torch.optim import vi_ba_cg
    from orb_slam3_fast_tpu_torch.utils import lie

    out = []
    # Z: dense at K = 30, PCG at K = 200 and 512; plain versions on the card
    z_err, z_ms, z_pms, z_ops, z_bytes, z_notes, lib_z = 0.0, 0.0, 0.0, 0.0, 0, [], None
    fields = pg.SE3Graph._fields
    for K, seed in ((30, 1), (200, 3), (512, 3)):
        arrays, (R_gt, t_gt) = drift_graph(K, seed, rot_noise=0.015, s_drift=1.0, yaw_only=True, pad_e=4)
        g = pg.SE3Graph(**{k: torch.as_tensor(arrays[k]).to(device) for k in fields})
        E = g.edge_i.shape[0]
        rk = pg.optimize_4dof_graph(g)
        rp, pms = timed(lambda: pg.optimize_4dof_graph_plain(g))
        err = graph4_dist(rk, rp)
        ones = np.ones(K)
        before, after = graph_ate(g.R, g.t, ones, R_gt, t_gt), graph_ate(rk.R, rk.t, ones, R_gt, t_gt)
        pcg = K > pg.DENSE_MAX_K
        if not (bool(rk.ok) and err <= 1e-3 and after < (0.8 if pcg else 0.3) * before):
            raise RuntimeError(f"optimize_4dof_graph K={K}: ok {bool(rk.ok)}, {err:.3g} from the plain version, "
                               f"centres {before:.3g} -> {after:.3g} m")
        ms = cuda_ms(lambda: pg.optimize_4dof_graph(g), 5)
        ops = graph4_ops(K, E, pcg, None if not pcg else rk.cg_run.cpu().numpy())
        z_err, z_ms, z_pms, z_ops, z_bytes = max(z_err, err), z_ms + ms, z_pms + pms, z_ops + ops, \
            z_bytes + K * 48 * 2 + E * 57
        if K == 30:  # the library call: one Cholesky factorisation and solve of the formed (4K)^2 system
            r, Ji, Jj = pg.edge_jacobians_4dof(g.R, g.t, g)
            Hd, rhs = pg.dense_normal_system(r, Ji, Jj, g.edge_i, g.edge_j, g.edge_w * g.edge_valid, g.fixed, 1e-6)
            lib_z = cuda_ms(lambda: torch.cholesky_solve(rhs[:, None], torch.linalg.cholesky_ex(Hd)[0]), 20)
        z_notes.append(f"K={K} ({'PCG, ' + str(int(rk.cg_run.sum())) + ' CG iterations' if pcg else 'dense'}, "
                       f"{E} edges): {err:.2e} from the plain version, centres {before:.3f} -> {after:.3f} m, "
                       f"{ms:.4f} ms (plain {pms:.4f})")
    out.append(dict(name="pose_graph4", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/pose_graph4.cu",
                    replaces="orb_slam3_fast_tpu/optim/pose_graph.py:224", max_abs_err=z_err, ms=z_ms, plain_ms=z_pms,
                    **bound(z_bytes, z_ops), library_ms=lib_z,
                    shapes="; ".join(z_notes) + "; 12 iterations each; tolerance 1e-3 in rotation entries and camera "
                           "centres (float64 Cholesky / CG against the plain float64 LU / CG, float32 vertices); "
                           "library = torch.linalg.cholesky_ex + cholesky_solve of one iteration's float64 (4K)^2 "
                           "system at K = 30"))

    # AA: a segment and a whole solve on build_vi_problem's size, then the 200-keyframe world
    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    T_id = lie.SE3.identity(device)
    a_err, a_ms, a_pms, a_ops, a_bytes, a_notes = 0.0, 0.0, 0.0, 0.0, 0, []
    prob, (R_gt, p_gt, v_gt) = vi_cg_problem(np.random.default_rng(12), device)
    big_w, bR, bp, _ = inertial_world(np.random.default_rng(13), n_kf=200, device=device)
    big = inertial_tracker(big_w, device).full_inertial_problem(big_w, [0])[0]
    err0 = np.linalg.norm(body_positions(big_w, 200) - bp, axis=1)
    for label, pr in (("build_vi_problem", prob), ("200-keyframe world", big)):
        K, M, O, E = pr.R_wb.shape[0], pr.xw.shape[0], pr.obs_kf.shape[0], pr.edge_i.shape[0]
        inl = torch.ones(O, dtype=torch.bool, device=device)
        lam = torch.tensor(1e-4, device=device)
        state = (pr.R_wb, pr.p_wb, pr.v_w, pr.bias)
        info = {}
        sk = vi_ba_cg._kernel(cam, 0.0, T_id, pr, state, pr.xw, inl, lam, 2, 40, info)
        sp, pms = timed(lambda: vi_ba_cg.lm_segment_vi_plain(cam, 0.0, T_id, pr, *state, pr.xw, inl, lam, 2, 40))
        fk = vi_ba_cg.full_inertial_ba_cg(cam, 0.0, T_id, pr)
        fp = vi_ba_cg.full_inertial_ba_cg_plain(cam, 0.0, T_id, pr)
        torch.cuda.synchronize()
        seg_err = max(float((a - b).abs().max()) for a, b in zip(sk[:4], sp[:4]))
        full_err = max(float((a - b).abs().max()) for a, b in zip(fk[:4], fp[:4]))
        xw_err = float((fk[4] - fp[4]).abs().max())
        flips = float((fk[5] != fp[5]).float().mean())
        notes = ""
        if label == "build_vi_problem":
            p_err = float(np.linalg.norm(fk[1].cpu().numpy() - p_gt, axis=1).max())
            v_err = float(np.linalg.norm(fk[2].cpu().numpy() - v_gt, axis=1).max())
            gate = p_err < 0.01 and v_err < 0.05
            notes = f"positions within {p_err:.4f} m, velocities within {v_err:.4f} m/s of the truth"
        else:
            err1 = np.linalg.norm(fk[1].cpu().numpy() - bp, axis=1)  # body positions (camera = body)
            gate = err1.max() < 0.5 * err0.max() and err1.mean() < 0.02
            notes = (f"position error max {err0.max():.4f} -> {err1.max():.4f} m, mean {err0.mean():.4f} -> "
                     f"{err1.mean():.4f} m")
        if not (bool(torch.isfinite(sk[0]).all()) and seg_err <= 1e-3 and full_err <= 2e-3 and xw_err <= 1e-2
                and flips <= 0.005 and gate):
            raise RuntimeError(f"lm_segment_vi on {label}: segment {seg_err:.3g}, whole solve {full_err:.3g} "
                               f"(landmarks {xw_err:.3g}, flags {flips:.4f}) from the plain version; {notes}")
        ms = cuda_ms(lambda: vi_ba_cg._kernel(cam, 0.0, T_id, pr, state, pr.xw, inl, lam, 2, 40), 5)
        whole_ms = cuda_ms(lambda: vi_ba_cg.full_inertial_ba_cg(cam, 0.0, T_id, pr), 1, warmup=0)
        a_err, a_ms, a_pms = max(a_err, seg_err, full_err), a_ms + ms, a_pms + pms
        a_ops += vi_pcg_ops(K, M, O, E, 2, info["cg_run"])
        a_bytes += vi_pcg_bytes(K, M, O, E)
        a_notes.append(f"{label} (K={K}, M={M}, O={O}, E={E}): a segment {ms:.3f} ms (plain {pms:.3f}, "
                       f"{info['cg_run']} CG iterations), {seg_err:.2e} from the plain version; the whole 5+8 "
                       f"solve {whole_ms:.2f} ms, {full_err:.2e} (landmarks {xw_err:.2e}, flags {flips:.4f}); {notes}")
    out.append(dict(name="vi_pcg", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/vi_pcg.cu",
                    replaces="orb_slam3_fast_tpu/optim/vi_ba_cg.py:348", max_abs_err=a_err, ms=a_ms, plain_ms=a_pms,
                    **bound(a_bytes, a_ops), library_ms=None,
                    shapes="; ".join(a_notes) + "; tolerances: states 1e-3 after a segment and 2e-3 after the whole "
                           "solve (float64 CG both, float32 observations), landmarks 1e-2 m, inlier flags 0.005; no "
                           "single library call computes the implicit-Schur LM"))
    return out


# --- phase 12: inertial loop closing -----------------------------------------------------------------------

VI_LOOP_SPEED = (0.6, 0.9)  # the circle's angular speed modulated by 1 + 0.6 cos(2 pi 0.9 t)
# Phase 12's IMU noise densities, as multiples of the configuration file's (EuRoC's): with EuRoC's the JAX
# package's own stereo-inertial System, and the port with it, loses the track on the frame after the IMU
# initialisation (its tracker runs the inertial pose optimisation twice a frame, the second anchored on the
# previous frame with the first's marginal as its prior: at 0.05 rad and 0.19 m a frame the two disagree; PERF.md,
# PR 9); a low-grade IMU, whose factors the camera outweighs, tracks the whole circle
VI_LOOP_IMU_NOISE = 300.0
VI_LOOP_MAX_ATE = 0.20  # tests/test_loop_closing.py's gate, unscaled here (the scale is the stereo rig's)
# Phase 12 (b): the loop correction from one snapshot on the card against the host's plain path: camera
# centres (m), rotation entries and velocities (m/s).  The loop path's own bound (LOOP_DT, LOOP_DR) for the
# poses; the velocities come out of the same solve, divided by the 0.25 s between keyframes: 2e-2.
VI_CORRECTION_BOUNDS = (LOOP_DT, LOOP_DR, 2e-2)


def circle_trajectory_with_imu(n_frames, radius=4.0, frac=1.12, dt_frame=0.05, imu_rate=200.0,
                               speed=VI_LOOP_SPEED, T_bc=None):
    """The loop scenario's circle (circle_trajectory's camera, looking along
    the tangent, radius 4, ``frac`` turns over ``n_frames``) flown at a
    speed modulated as arc_trajectory_with_imu's (``speed`` = (amplitude,
    frequency): the angle a(t) = w0 (t + A sin(2 pi f t) / (2 pi f))), so
    that the accelerometer sees the speed change and the IMU initialises,
    and the noise-free stream a body-mounted sensor measures (camera =
    body, gravity along the world's -z), each sample stamped at the end of
    its 1 / ``imu_rate`` interval and made exact for the preintegration's
    first-order step (the rotation at the interval's start carrying the
    sample): the specific force at the interval's middle in the body frame
    at its start, and the interval's mean rate (the turn is about a fixed
    axis).  The camera is the body, unless ``T_bc`` (the (4,4) pose of the
    camera in the body, IMU.T_b_c1) puts the IMU elsewhere on the rig: it
    then measures the rig's rate in its own axes and the specific force at
    its own origin, the lever arm's centripetal and tangential terms at the
    interval's middle included.  Returns (T_cw per frame as (R, t) numpy
    float32 pairs, IMU rows (ts, ax, ay, az, wx, wy, wz))."""
    amp, freq = speed
    w0 = 2 * np.pi * frac / (n_frames * dt_frame)
    om = 2 * np.pi * freq
    g_w = np.array([0.0, 0.0, -9.81])

    def frame_of(a):
        c, s = np.cos(a), np.sin(a)
        R_wc = np.stack([np.array([c, s, 0.0]), np.array([0.0, 0.0, -1.0]), np.array([-s, c, 0.0])], axis=1)
        return R_wc, np.array([radius * c, radius * s, 0.0])

    poses = []
    for i in range(n_frames):
        R_wc, center = frame_of(w0 * (i * dt_frame + amp / om * np.sin(om * i * dt_frame)))
        R = R_wc.T.astype(np.float32)
        poses.append((R, (-R_wc.T @ center).astype(np.float32)))
    imu, dt_imu = [], 1.0 / imu_rate

    def angle(t):
        return w0 * (t + amp / om * np.sin(om * t))

    if T_bc is not None:  # the body's rotation from the camera, and its origin in the camera frame
        R_bc = np.asarray(T_bc, np.float64)[:3, :3]
        t_cb = -R_bc.T @ np.asarray(T_bc, np.float64)[:3, 3]
    for j in range(int(round((n_frames - 1) * dt_frame * imu_rate))):
        tm = (j + 0.5) * dt_imu
        a = angle(tm)
        ad = w0 * (1.0 + amp * np.cos(om * tm))
        add = -w0 * amp * om * np.sin(om * tm)
        c, s = np.cos(a), np.sin(a)
        acc_w = radius * (add * np.array([-s, c, 0.0]) + ad * ad * np.array([-c, -s, 0.0]))
        R_wc, _ = frame_of(angle(j * dt_imu))
        rate = (angle((j + 1) * dt_imu) - angle(j * dt_imu)) / dt_imu
        if T_bc is None:
            imu.append([(j + 1) * dt_imu, *(R_wc.T @ (acc_w - g_w)), 0.0, -rate, 0.0])
            continue
        # the turn is about the world's z, the camera's -y: rate and angular acceleration there at the middle
        w_c, dw_c = np.array([0.0, -ad, 0.0]), np.array([0.0, -add, 0.0])
        f_c = R_wc.T @ (acc_w - g_w) + np.cross(w_c, np.cross(w_c, t_cb)) + np.cross(dw_c, t_cb)
        imu.append([(j + 1) * dt_imu, *(R_bc @ f_c), *(R_bc @ np.array([0.0, -rate, 0.0]))])
    return poses, np.asarray(imu)


def _render_vi_circle(i: int):
    """Frame i of phase 12's stereo circle (run in a worker process)."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera

    world = make_ring_world(np.random.default_rng(0))
    R, t = circle_trajectory_with_imu(LOOP_FRAMES)[0][i]
    return stereo_pair(world, Camera.pinhole(400.0, 400.0, 320.0, 240.0), R, t, 0.12)


def vi_loop_frames():
    """Phase 12's input: the loop scenario's ring world (make_ring_world,
    seed 0) seen in stereo (0.12 m baseline) along
    circle_trajectory_with_imu(150), rendered by one worker process per
    core.  Returns (stereo pairs, true T_cw per frame, IMU rows)."""
    frames = render_map(_render_vi_circle, range(LOOP_FRAMES), parallel=True)
    poses, imu = circle_trajectory_with_imu(LOOP_FRAMES)
    return frames, poses, imu


def vi_loop_settings():
    """configs/synthetic_stereo.yaml loaded for stereo-inertial, its IMU
    noise densities (gyro, accelerometer and both walks) scaled by
    ``VI_LOOP_IMU_NOISE``."""
    import dataclasses

    from orb_slam3_fast_tpu_torch.slam.settings import Settings

    s = Settings.from_yaml(SYS_CONFIG, "stereo-inertial")
    k = VI_LOOP_IMU_NOISE
    return dataclasses.replace(s, imu_noise_gyro=k * s.imu_noise_gyro, imu_noise_acc=k * s.imu_noise_acc,
                               imu_gyro_walk=k * s.imu_gyro_walk, imu_acc_walk=k * s.imu_acc_walk)


def vi_loop_system(device):
    """``System(vi_loop_settings(), "stereo-inertial")`` with loop closing and
    the Atlas and 256 keyframes, the loop closer at phase 9's
    LoopCloserConfig (the scale fixed)."""
    from orb_slam3_fast_tpu_torch.backend.loopcloser import LoopCloserConfig
    from orb_slam3_fast_tpu_torch.slam.system import System

    slam = System(vi_loop_settings(), "stereo-inertial", max_keyframes=256, enable_loop_closing=True, multi_map=True,
                  async_backend=False, device=device)
    slam.loopcloser.cfg = LoopCloserConfig(**LOOP_CONFIG, fix_scale=True)
    return slam


def run_vi_loop(frames, poses, imu, device):
    """Phase 12 (a): the stereo-inertial System, synchronous, with loop
    closing and the Atlas, on the circle with its IMU stream.  The first
    loop correction's inputs are kept: the map as it stood just before it
    (a deep copy) and its arguments, for phase 12 (b).  Returns the System,
    a summary (state, frames tracked, the IMU-initialisation frame, loops
    and their frames, keyframes, the unscaled ATE of the frames tracked
    after the initialisation, in the gravity-aligned world) and the
    snapshot."""
    return _run_loop_with_snapshot(vi_loop_system(device), frames, poses, imu, device)


def _run_loop_with_snapshot(slam, frames, poses, imu, device):
    """Phases 12 (a), 14 and 15 (c): a synchronous System with loop closing
    on a stereo sequence (with its IMU stream, or ``imu`` None), or on the
    images of a monocular one, the first loop correction's map and
    arguments kept.  The ATE is over the frames tracked, after the IMU
    initialisation with the IMU; a monocular run's also scale-aligned
    (``ate_m``, ``scale``), and its first frame tracked (``first_ok``)."""
    import copy

    from orb_slam3_fast_tpu_torch.eval import ate

    lc = slam.loopcloser
    snapshot = {}
    correct = lc._correct

    def kept(world, k, c, S_kc):
        if not snapshot:
            snapshot.update(world=copy.deepcopy(world), args=(k, c, S_kc))
        return correct(world, k, c, S_kc)

    lc._correct = kept
    est, gt, ts, closed_at, init_frame, track = [], [], [], [], None, []
    samples = imu_slices(imu, len(frames)) if imu is not None else [()] * len(frames)
    mono = slam.sensor.startswith("monocular")
    for i, (f, (R, t), smp) in enumerate(zip(frames, poses, samples)):
        n_closed = lc.n_loops_closed
        state, pose = slam.track_monocular(f, i * 0.05, imu=smp) if mono else slam.track_stereo(*f, i * 0.05, imu=smp)
        if lc.n_loops_closed > n_closed:
            closed_at.append(i)
        if slam.world.imu_initialized and init_frame is None:
            init_frame = i
        track.append((state, *(pose if pose is not None else (np.eye(3, dtype=np.float32), np.zeros(3, np.float32)))))
        # with the IMU, from the initialisation on: the world is gravity-aligned from there
        if state == "OK" and (imu is None or (init_frame is not None and i > init_frame)):
            est.append(-pose[0].T @ pose[1])
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
    if device.type == "cuda":
        torch.cuda.synchronize()
    summary = dict(state=slam.get_tracking_state(), tracked=sum(s == "OK" for s, _, _ in track), init_frame=init_frame,
                   loops=lc.n_loops_closed, merges=lc.n_maps_merged, closed_at=closed_at, n_kf=slam.world.n_kf,
                   after_init=len(est))
    if mono:
        summary["first_ok"] = next((i for i, (s, _, _) in enumerate(track) if s == "OK"), None)
    if len(est) >= 3:
        est, gt, ts = np.asarray(est), np.asarray(gt), np.asarray(ts)
        summary["ate_unscaled_m"] = ate.ate_rmse(ts, est, ts, gt, with_scale=False)[0]
        if mono:
            summary["ate_m"], _, summary["scale"] = ate.ate_rmse(ts, est, ts, gt, with_scale=True)
    return slam, summary, snapshot


def check_vi_loop(summary, launches) -> None:
    """Phase 12 (a)'s gates: final OK, > 120 frames tracked, the IMU
    initialised, >= 1 loop closed, unscaled ATE < VI_LOOP_MAX_ATE; Z and AA
    launched on the path, S, U and T not."""
    ok = (summary["state"] == "OK" and summary["tracked"] > 120 and summary["init_frame"] is not None
          and summary["loops"] >= 1 and summary.get("ate_unscaled_m", 1e9) < VI_LOOP_MAX_ATE)
    kernels = launches["pose_graph4"] >= 1 and launches["vi_pcg"] >= 1 and not (
        launches["sim3_graph"] or launches["sim3_pcg"] or launches["ba_pcg"])
    if not (ok and kernels):
        raise RuntimeError(f"stereo-inertial loop System gates failed: {summary}, launches {launches}")


def correct_from_snapshot(snapshot, device, make_system=None):
    """Phases 12 (b) and 14: the loop correction (window propagation,
    fusion, the essential graph, the global BA or FullInertialBA) run on a
    copy of the snapshot by the System ``make_system(device)`` makes
    (phase 12's stereo-inertial one by default) on ``device``.  Returns the
    corrected map."""
    import copy

    from orb_slam3_fast_tpu_torch.utils import lie

    w = copy.deepcopy(snapshot["world"])
    w.kf_preint = {k: p.to(device) for k, p in w.kf_preint.items()}
    k, c, S_kc = snapshot["args"]
    slam = (make_system or vi_loop_system)(device)
    slam.tracker.world = slam.world = w
    slam.loopcloser._correct(w, k, c, lie.Sim3(*(x.to(device) for x in S_kc)))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return w


def compare_corrections(card, host, bounds=VI_CORRECTION_BOUNDS) -> tuple[list[str], str]:
    """Phase 12 (b): the keyframes' camera centres, rotation entries and
    velocities of two corrected maps against ``bounds``."""
    n = card.n_kf
    live = card.kf_valid[:n] & host.kf_valid[:n]
    dc = float(np.abs(body_positions(card, n) - body_positions(host, n))[live].max())
    dr = float(np.abs(card.kf_R[:n] - host.kf_R[:n])[live].max())
    dv = float(np.abs(card.kf_vel[:n] - host.kf_vel[:n])[live].max())
    bad = [f"{name} {d:.3g} > {b}" for name, d, b in zip(("centres", "rotations", "velocities"), (dc, dr, dv), bounds)
           if not d <= b]
    if host.n_kf != n:
        bad.append(f"keyframes {n} / {host.n_kf}")
    return bad, f"{n} keyframes: centres {dc:.3g} m, rotation entries {dr:.3g}, velocities {dv:.3g} m/s apart"


def run_default_vi(frames, poses, imu, device):
    """Phase 12 (c): the default constructor of an inertial sensor,
    ``System(configs/synthetic_stereo.yaml, "stereo-inertial")`` with every
    default (the async backend, loop closing, the Atlas), fed phase 11 (b)'s
    corridor and IMU stream at 20 fps with phase 11's initialisation
    settings.  Gates: the backend drains within 120 s, no worker error, the
    IMU initialised.  Returns the System and a summary."""
    from orb_slam3_fast_tpu_torch.slam.system import System

    slam = System(SYS_CONFIG, "stereo-inertial", device=device)
    slam.tracker.icfg = slam.tracker.icfg._replace(init_min_kfs=8, init_min_time=1.0)
    b = slam.backend
    states, t0 = [], time.perf_counter()
    for i, ((img_l, img_r), samples) in enumerate(zip(frames, imu_slices(imu, len(frames)))):
        wait = t0 + i * 0.05 - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        states.append(slam.track_stereo(img_l, img_r, i * 0.05, imu=samples)[0])
    drained = b.wait_idle(timeout=120)
    slam.shutdown()
    if device.type == "cuda":
        torch.cuda.synchronize()
    summary = dict(state=slam.get_tracking_state(), tracked=sum(s == "OK" for s in states), drained=drained,
                   errors=len(b.errors), imu_initialized=bool(slam.world.imu_initialized), n_kf=slam.world.n_kf,
                   local_ba=slam.mapper.n_local_ba, error=b.errors[0] if b.errors else None)
    if not (drained and not b.errors and summary["imu_initialized"]):
        raise RuntimeError(f"default stereo-inertial System gates failed: {summary}")
    return slam, summary


def run_merge_inertial(device):
    """Phase 12 (d): MergeInertialBA (the inertial tracker's
    _merge_inertial_ba, kernel Y) on tests/test_vi_ba_cg.py:208's welded
    map, with that test's gates: the window covers both sides of the weld,
    the source window's position error halves, velocities within 0.06 m/s
    and biases within 0.02 of the truth, the velocity across the weld
    within 0.15 m/s of the finite difference.  Returns a summary."""
    w, R_gt, p_gt, v_gt = welded_world(device)
    err0 = np.linalg.norm(body_positions(w, 20) - p_gt, axis=1)[14:20]
    real = inertial_tracker(w, device)._merge_inertial_ba(w, k_new=19, c2=8)
    if device.type == "cuda":
        torch.cuda.synchronize()
    p_wb = body_positions(w, 20)
    err1 = np.linalg.norm(p_wb - p_gt, axis=1)[14:20]
    v_err = float(np.linalg.norm(w.kf_vel[14:20] - v_gt[14:20], axis=1).max())
    v_fd = (p_wb[15] - p_wb[13]) / float(w.kf_ts[15] - w.kf_ts[13])
    summary = dict(window=None if real is None else [int(r) for r in real], err0=float(err0.max()),
                   err1=float(err1.max()), v_err=v_err, bias=float(np.abs(w.kf_bias[14:20]).max()),
                   v_weld=float(np.linalg.norm(w.kf_vel[14] - v_fd)))
    if not (real is not None and any(r >= 14 for r in real) and any(r <= 9 for r in real)
            and summary["err1"] < 0.5 * summary["err0"] and v_err < 0.06 and summary["bias"] < 0.02
            and summary["v_weld"] < 0.15):
        raise RuntimeError(f"MergeInertialBA on the welded map: {summary}")
    return summary


# --- phase 13: the fisheye two-camera rig (TUM-VI) ------------------------------------------------------------

FISHEYE_CONFIG = "configs/TUMVI_fisheye_stereo_inertial.yaml"
FISHEYE_FRAMES = 25  # tests/test_fisheye.py's end-to-end scene
FISHEYE_VI_FRAMES = 45  # the stereo-inertial arc: phase 11's length
FISHEYE_REVISIT = 15  # the relocalisation's revisited frame
FISHEYE_WH = (512, 512)
FISHEYE_MAX_ATE, FISHEYE_MAX_SCALE_ERR = 0.3, 0.12  # tests/test_fisheye.py's gates
# Phase 13 (b)'s gates.  The JAX package's own stereo-inertial System on that scene (CPU, python -m
# tests.fisheye_reference --sensor stereo-inertial) initialises the IMU at frame 25, tracks 4 frames after it and is
# RECENTLY_LOST from frame 30 on (unscaled ATE 0.0164 m over those 4 frames): short of a final OK, as on phase 12's
# scene with the EuRoC noise (ROADMAP §C).  The gates are where the reference stands: the IMU initialised, >=
# FISHEYE_VI_MIN_AFTER frames OK after the init frame, the unscaled ATE after it < FISHEYE_MAX_ATE; the final state
# is reported.
FISHEYE_VI_MIN_AFTER = 4
FISHEYE_VI_GATES = (f"IMU initialised, >= {FISHEYE_VI_MIN_AFTER} frames OK after the init frame, unscaled ATE after it "
                    f"< {FISHEYE_MAX_ATE} m, V-Y and W, Y in KB8 launched")
# 13 (a)'s card run against its host run: t, rotation entries
FISHEYE_BOUNDS = (TRACK_DT, TRACK_DR)
FISHEYE_KERNELS = ("fast_nms", "orb_describe", "hamming_best2", "pose_lm", "ba_blocks", "ba_schur", "triangulate_dlt",
                   "pyramid_blur", "select_subpixel", "visible_landmarks", "vocab_transform", "fisheye_stereo",
                   "ba_lm_update", "ba_classify")
# kernels whose camera instance phase 13 reads, and those that never run on the fisheye rig
KB8_KERNELS = ("pose_lm", "ba_blocks", "visible_landmarks", "pnp_ransac", "pose_inertial", "vi_ba", "sim3_ransac",
               "sim3_refine", "vi_pcg", "ba_lm_update", "ba_classify", "twoview_ransac")
NOT_FISHEYE = ("stereo_subpixel_refine", "twoview_ransac", "sim3_ransac", "sim3_refine", "sim3_graph", "ba_pcg",
               "sim3_pcg", "pose_graph4", "vi_pcg")


def stereo_pair_cams(world, cam_l, cam_r, R, t, T_c1_c2, wh):
    """The two cameras of a rig whose camera 2 sits at ``T_c1_c2`` (4,4) in
    camera 1 (synthetic.stereo_pair_cams): (left image, right image)."""
    T = np.asarray(T_c1_c2, np.float64)
    R12, t12 = T[:3, :3], T[:3, 3]
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    return render(world, cam_l, R, t, wh), render(world, cam_r, R12.T @ R, R12.T @ (t - t12), wh)


def fisheye_settings(sensor: str):
    from orb_slam3_fast_tpu_torch.slam.settings import Settings

    return Settings.from_yaml(FISHEYE_CONFIG, sensor=sensor)


def fisheye_frames(n_frames: int = FISHEYE_FRAMES, imu: bool = False):
    """Phase 13's input: tests/test_fisheye.py's corridor (seed 4, 900
    splats, half-width 2 m, 12 m long) seen by the TUM-VI rig (both KB8
    cameras at 512x512, Stereo.T_c1_c2 with its 0.047 rad roll) along its
    arc (step 0.06, lateral 0.05), rendered on the host.  With
    ``imu`` the arc's speed is modulated and the IMU stream is the body's,
    through IMU.T_b_c1, with phase 11's biases and the configuration's
    noise densities.  Returns (frames, true T_cw per frame, IMU rows or
    None)."""
    s = fisheye_settings("stereo-inertial")
    rows = None
    if imu:
        hz = s.imu_frequency
        poses, rows = arc_trajectory_with_imu(n_frames, step=0.06, lateral=0.05, gyro_bias=VI_GYRO_BIAS,
                                              acc_bias=VI_ACC_BIAS, noise_gyro=s.imu_noise_gyro * np.sqrt(hz),
                                              noise_acc=s.imu_noise_acc * np.sqrt(hz), seed=0, T_bc=s.T_b_c1)
    else:
        poses = arc_trajectory(n_frames, step=0.06, lateral=0.05)
    world = make_corridor_world(np.random.default_rng(4), n=900, half_w=2.0, half_h=2.0, length=12.0)
    return render_views("rig", world, (s.cam, s.cam2, s.T_c1_c2), poses), poses, rows


def _fisheye_system(sensor: str, device):
    from orb_slam3_fast_tpu_torch.slam.system import System

    slam = System(fisheye_settings(sensor), sensor, enable_loop_closing=False, multi_map=False, async_backend=False,
                  device=device)
    if sensor == "stereo-inertial":
        slam.tracker.icfg = slam.tracker.icfg._replace(init_min_kfs=8, init_min_time=1.0)  # phase 11's
    return slam


def run_fisheye(frames, poses, device, imu=None):
    """Phase 13 (a) / (b): ``System(TUM-VI config, "stereo")`` (or
    ``"stereo-inertial"`` with ``imu``, phase 11's initialisation window),
    synchronous, without loop closing, on :func:`fisheye_frames`.  Returns
    the System, a summary (state, frames tracked, keyframes and their
    frames, landmarks, local BAs, the unscaled ATE and the fitted scale
    over the frames tracked, or after the IMU initialisation with
    ``imu``) and the per-frame (state, R, t)."""
    from orb_slam3_fast_tpu_torch.eval import ate

    slam = _fisheye_system("stereo" if imu is None else "stereo-inertial", device)
    samples = imu_slices(imu, len(frames)) if imu is not None else [None] * len(frames)
    est, gt, ts, track, kf_frames, init_frame = [], [], [], [], [], None
    for i, ((img_l, img_r), (R, t), smp) in enumerate(zip(frames, poses, samples)):
        n_kf = slam.world.n_kf
        state, pose = slam.track_stereo(img_l, img_r, i * 0.05, **({} if smp is None else {"imu": smp}))
        if pose is None:
            pose = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        track.append((state, *pose))
        if slam.world.n_kf > n_kf:
            kf_frames.append(i)
        if imu is not None and slam.world.imu_initialized and init_frame is None:
            init_frame = i
        if state == "OK" and (imu is None or (init_frame is not None and i > init_frame)):
            est.append(-pose[0].T @ pose[1])
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
    if device.type == "cuda":
        torch.cuda.synchronize()
    summary = dict(state=slam.get_tracking_state(), tracked=sum(s == "OK" for s, _, _ in track), n_kf=slam.world.n_kf,
                   kf_frames=kf_frames, landmarks=int(slam.world.lm_valid.sum()), local_ba=slam.mapper.n_local_ba)
    if imu is not None:
        summary.update(init_frame=init_frame, after_init=len(est))
    if len(est) >= 3:
        est, gt, ts = np.asarray(est), np.asarray(gt), np.asarray(ts)
        summary["ate_m"] = ate.ate_rmse(ts, est, ts, gt, with_scale=False)[0]
        summary["scale"] = ate.ate_rmse(ts, est, ts, gt, with_scale=True)[2]
    return slam, summary, track


def check_fisheye(summary, launches, inertial: bool = False) -> None:
    """Phase 13 (a)'s gates (tests/test_fisheye.py's: final OK, > 20 of 25
    frames tracked, unscaled ATE < 0.3 m, the fitted scale within 0.12 of
    1) or (b)'s (``FISHEYE_VI_GATES``); AB, C's mutual mode and the KB8
    instances of D, E, AC and L (and W and Y with the IMU) launched; the
    kernels no fisheye path runs not."""
    kb8 = ("pose_lm", "ba_blocks", "ba_lm_update", "ba_classify", "visible_landmarks") + \
        (("pose_inertial", "vi_ba") if inertial else ())
    missing = [n for n in (*FISHEYE_KERNELS, "hamming_best2[mutual]") if launches[n] < 1]
    missing += [f"{n}[kb8]" for n in kb8 if launches[f"{n}[kb8]"] < 1]
    stray = [n for n in NOT_FISHEYE if launches[n]]
    ok = summary.get("ate_m", 1.0) < FISHEYE_MAX_ATE
    if inertial:
        ok = ok and summary["init_frame"] is not None and summary["after_init"] >= FISHEYE_VI_MIN_AFTER
    else:
        ok = (ok and summary["state"] == "OK" and summary["tracked"] > 20
              and abs(summary.get("scale", 0.0) - 1.0) < FISHEYE_MAX_SCALE_ERR)
    if not ok or missing or stray:
        raise RuntimeError(f"fisheye System gates failed: {summary}; never launched {missing}; launched {stray}")


def run_fisheye_reloc(slam, frames, poses, device):
    """Phase 13 (c), on phase 13 (a)'s System after its last frame: 3 blank
    pairs -> RECENTLY_LOST, then frame ``FISHEYE_REVISIT`` again -> OK, its
    camera centre within 0.3 m of the truth (the rig's scale is metric).
    Returns (per-frame (state, R, t), the relocalised frame's track_total
    ms, summary)."""
    n = len(frames)
    blank = np.full((FISHEYE_WH[1], FISHEYE_WH[0]), 25.0, np.float32)
    track = []
    for j in range(3):
        state, pose = slam.track_stereo(blank, blank, (n + j) * 0.05)
        track.append((state, pose))
    if slam.get_tracking_state() != "RECENTLY_LOST":
        raise RuntimeError(f"fisheye reloc: {slam.get_tracking_state()} after the blank frames")
    state, pose = slam.track_stereo(*frames[FISHEYE_REVISIT], (n + 4) * 0.05)
    track.append((state, pose))
    if device.type == "cuda":
        torch.cuda.synchronize()
    reloc_ms = slam.timers.spans["track_total"][-1]
    if state != "OK":
        raise RuntimeError("fisheye reloc: relocalisation failed")
    R, t = poses[FISHEYE_REVISIT]
    err = float(np.linalg.norm(-pose[0].T @ pose[1] - (-R.T @ t)))
    if err >= 0.3:
        raise RuntimeError(f"fisheye reloc: relocalised pose off by {err:.3f} m (bound 0.3)")
    track = [(s, *(p if p is not None else (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))))
             for s, p in track]
    return track, reloc_ms, dict(n_kf=slam.world.n_kf, err=err, ref_kf=slam.tracker.ref_kf)


def kb8_pixels(cam, uv: np.ndarray) -> np.ndarray:
    """The pixels of KB8 camera ``cam`` on the rays that the synthetic 400 px
    pin-hole camera (640x480) sees at ``uv`` (N,2): a pin-hole problem's
    geometry seen through the fisheye."""
    from orb_slam3_fast_tpu_torch.cameras import models as cm

    ray = cm.unproject(cm.Camera.pinhole(400.0, 400.0, 320.0, 240.0), torch.as_tensor(np.asarray(uv, np.float32)))
    return cm.project(cam, ray).numpy()


def kb8_mono(uv: torch.Tensor, cam) -> torch.Tensor:
    """(N,3) pin-hole [u, v, u_r] -> the KB8 [u, v, -1]: every edge monocular, as on a fisheye frame."""
    uvk = torch.as_tensor(kb8_pixels(cam, uv[:, :2].cpu().numpy())).to(uv.device)
    return torch.cat([uvk, -torch.ones_like(uvk[:, :1])], 1).contiguous()


def compare_fisheye_kernels(device) -> tuple[list[dict], dict]:
    """Phase 3 for the fisheye rig: kernel AB against its plain version on
    phase 13's frame 1 (the card's extraction of both 512x512 KB8 images at
    the configuration's 1000 features, kernel C's mutual best-2), and the
    KB8 instances of D, E, L, P, W and Y against their plain versions at
    their paths' shapes (the pin-hole problems of this phase seen through
    TUM-VI's cam0).  Returns (AB's entry, {kernel: its KB8 instance's
    numbers})."""
    from orb_slam3_fast_tpu_torch.cameras import models as cm
    from orb_slam3_fast_tpu_torch.frontend import tracker as trk
    from orb_slam3_fast_tpu_torch.ops import extractor as ext
    from orb_slam3_fast_tpu_torch.ops import hamming as ham
    from orb_slam3_fast_tpu_torch.ops import matching as mat
    from orb_slam3_fast_tpu_torch.optim import ba, inertial, pnp, pose_opt, vi_ba
    from orb_slam3_fast_tpu_torch.utils import lie

    rng = np.random.default_rng(21)
    s = fisheye_settings("stereo")
    cam = s.cam
    f32 = torch.float32
    # AB on frame 1 of phase 13's scene
    frames, _, _ = fisheye_frames(2)
    cfg = ext.ExtractorConfig(n_features=s.n_features, n_levels=s.n_levels, scale_factor=s.scale_factor)
    kp_l, kp_r = (ext.extract(torch.as_tensor(im).to(device), cfg) for im in frames[1])
    T = np.asarray(s.T_c1_c2, np.float64)
    R_rl = torch.as_tensor(T[:3, :3].T, dtype=f32)
    t_rl = torch.as_tensor(-T[:3, :3].T @ T[:3, 3], dtype=f32)
    sigma2 = torch.as_tensor(ext.level_sigma2(cfg), dtype=f32).to(device)
    b, col = ham.hamming_best2(kp_l.desc, kp_r.desc, ham.MutualGate(kp_l.valid.to(f32), kp_r.valid.to(f32)))
    args = (s.cam, s.cam2, kp_l, kp_r, b, col)
    k = mat.fisheye_stereo_gate(*args, R_rl, t_rl, sigma2)
    p = mat.fisheye_stereo_gate_plain(*args, R_rl.to(device), t_rl.to(device), sigma2)
    torch.cuda.synchronize()
    both = k.valid & p.valid
    flips = int((k.valid != p.valid).sum())
    err = max(float((k.x3d[both] - p.x3d[both]).abs().max()), float((k.depth[both] - p.depth[both]).abs().max()))
    n, m = kp_l.n, kp_r.n
    # tolerance: the float64 Jacobi DLT against the float32 SVD one: points within 1e-3 m where both accept, at
    # most 1% of the slots flipped across a cut, the indices equal
    if err > 1e-3 or flips > 0.01 * n or not torch.equal(k.idx, p.idx) or int(p.valid.sum()) < 100:
        raise RuntimeError(f"kernel AB disagrees with its plain version: {err}, {flips} flips, {int(p.valid.sum())} "
                           "accepted")
    ab_ms = cuda_ms(lambda: mat.fisheye_stereo_gate(*args, R_rl, t_rl, sigma2), 50)
    ab_pms = cuda_ms(lambda: mat.fisheye_stereo_gate_plain(*args, R_rl.to(device), t_rl.to(device), sigma2), 10)
    # bytes: per left slot xy, level, idx, the two distances in, depth, the point and the flag out; per right slot
    # xy, level and its best row.  Operations per left slot: two 10-step Newton unprojections (~25 each step),
    # two KB8 projections (~45), the 4x4 normal matrix and its null vector, the gates (~60)
    ab = dict(name="fisheye_stereo", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/fisheye_stereo.cu",
              replaces="orb_slam3_fast_tpu/ops/matching.py:305", max_abs_err=err, ms=ab_ms, plain_ms=ab_pms,
              **bound(n * (8 + 8 + 8 + 8 + 4 + 12 + 1) + m * 24, n * (2 * 250 + 2 * 45 + normal_flops(4, 4) +
                                                                     null_flops(4) + 60)),
              library_ms=None,
              shapes=f"phase 13's frame 1: {n} left x {m} right slots, {int(p.valid.sum())} accepted by the plain "
                     f"version, {int(k.valid.sum())} by the kernel, {flips} flipped; tolerances: points 1e-3 m, 1% "
                     "flips, indices equal; library: none (no one PyTorch call unprojects, triangulates and gates)")
    kb8 = {}

    def entry(name, err, fk, fp, nbytes, ops, note, reps=20):
        kb8[name] = dict(max_abs_err=err, ms=cuda_ms(fk, reps), plain_ms=timed(fp)[1], **bound(nbytes, ops),
                         shapes=note)

    # D: a frame's capacity of mono edges, 40% observing
    cap = ext.total_capacity(cfg)
    T_gt = lie.se3_exp(torch.tensor([0.1, -0.05, 0.1, 0.02, -0.01, 0.03]))
    xw = np.stack([rng.uniform(-3, 3, cap), rng.uniform(-2, 2, cap), rng.uniform(1, 8, cap)], -1).astype(np.float32)
    uv = cm.project(cam, T_gt.apply(torch.as_tensor(xw))).numpy().astype(np.float64) + rng.normal(0, 0.3, (cap, 2))
    out_ = rng.uniform(size=cap) < 0.1
    uv[out_] += 25.0
    obs = pose_opt.PoseObs(*(torch.as_tensor(a).to(device) for a in (
        xw, np.concatenate([uv, -np.ones((cap, 1))], 1).astype(np.float32), np.ones(cap, np.float32),
        np.zeros(cap, bool), rng.uniform(size=cap) < 0.4)))
    T0 = lie.SE3.identity(device)
    (Tk, ik, nk), (Tp, ip, np_) = pose_opt.pose_optimization(cam, 0.0, T0, obs), \
        pose_opt.pose_optimization_plain(cam, 0.0, T0, obs)
    torch.cuda.synchronize()
    e = max(float((Tk.t - Tp.t).abs().max()), float((Tk.R - Tp.R).abs().max()))
    if e > 1e-3 or abs(int(nk) - int(np_)) > 2:
        raise RuntimeError(f"kernel D (KB8) disagrees with its plain version: {e}, inliers {int(nk)} / {int(np_)}")
    nv = int(obs.valid.sum())
    entry("pose_lm", e, lambda: pose_opt.pose_optimization(cam, 0.0, T0, obs),
          lambda: pose_opt.pose_optimization_plain(cam, 0.0, T0, obs), cap * 30 + 96, 80 * nv * 260 + 40 * 400,
          f"{cap} slots ({nv} observing, mono, 10% outliers); pose err {e:.2g}, inliers {int(nk)} / {int(np_)}; "
          "tolerances 1e-3, 2 inliers")
    # E: the local BA's caps
    prob = ba_problem(rng, device, cam=cam)
    inl = torch.ones_like(prob.obs_valid)
    bk = ba.build_normal_blocks(cam, 48.0, prob.R, prob.t, prob.xw, prob, inl)
    bp = ba.build_normal_blocks_plain(cam, 48.0, prob.R, prob.t, prob.xw, prob, inl)
    torch.cuda.synchronize()
    e = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-12)
            for x, y in zip((*bk[:4], ba.coupling_to_dense(bk[4], prob), *bk[5:]), bp))
    if e > 1e-4:
        raise RuntimeError(f"kernel E (KB8) disagrees with its plain version: {e}")
    K, M, O = prob.R.shape[0], prob.xw.shape[0], prob.obs_kf.shape[0]
    entry("ba_blocks", e, lambda: ba.build_normal_blocks(cam, 48.0, prob.R, prob.t, prob.xw, prob, inl),
          lambda: ba.build_normal_blocks_plain(cam, 48.0, prob.R, prob.t, prob.xw, prob, inl),
          O * 27 + M * 13 + K * 48 + (42 * K + 13 * M) * 4 + O * 72, O * 700,
          f"K={K}, M={M}, O={O} (60% stereo rows); relative err {e:.2g}, tolerance 1e-4 of each block's largest")
    # L: 4096 landmark slots around the frame
    mm = N_LM
    pos = torch.as_tensor(np.stack([rng.uniform(-6, 6, mm), rng.uniform(-6, 6, mm), rng.uniform(-2, 10, mm)], -1),
                          dtype=f32).to(device)
    normal = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(mm, 3)), dtype=f32).to(device) +
                                           torch.tensor([0.0, 0.0, 1.5], device=device), dim=-1)
    dmin = torch.as_tensor(rng.uniform(0.2, 2.0, mm), dtype=f32).to(device)
    mask = torch.as_tensor(rng.uniform(size=mm) < 0.9).to(device)
    Tl = lie.se3_exp(torch.tensor([0.05, 0.02, -0.1, 0.01, 0.02, -0.01], device=device))
    largs = (cam, Tl.R, Tl.t, pos, mask, normal, dmin, dmin * 8.0, FISHEYE_WH)
    (uk, lk, vk), (up, lp, vp) = trk.visible_landmarks(*largs), trk.visible_landmarks_plain(*largs)
    torch.cuda.synchronize()
    front = Tl.apply(pos)[:, 2] > 0.05
    e = float((uk[front] - up[front]).abs().max())
    border = ((up.abs() < 1e-3) | ((up - 512.0).abs() < 1e-3)).any(-1)
    if e > 1e-3 or not torch.equal(vk[~border], vp[~border]) or not torch.equal(lk[front], lp[front]):
        raise RuntimeError(f"kernel L (KB8) disagrees with its plain version: uv {e}")
    entry("visible_landmarks", e, lambda: trk.visible_landmarks(*largs), lambda: trk.visible_landmarks_plain(*largs),
          50 * mm + 48, 130 * mm, f"{mm} slots ({int(vp.sum())} visible); uv err {e:.2g} px; tolerances uv 1e-3 px, "
          "level and visible equal off the image border")
    # P: the relocalisation problem through the fisheye
    xw_p, uv_p, inv_s2, valid, _, _ = pnp_problem(rng)
    xw_p, inv_s2, valid = (torch.as_tensor(a).to(device) for a in (xw_p, inv_s2, valid))
    uv_p = torch.as_tensor(kb8_pixels(cam, uv_p)).to(device)
    subsets = pnp._sample_subsets(3, valid, pnp.N_HYP)
    rk = pnp.pnp_ransac(cam, xw_p, uv_p, inv_s2, valid, 0, subsets=subsets)
    rp = pnp.pnp_ransac_plain(cam, xw_p, uv_p, inv_s2, valid, subsets)
    torch.cuda.synchronize()
    e = max(float((rk.R - rp.R).abs().max()), float((rk.t - rp.t).abs().max()))
    if int(rk.n_inliers) != int(rp.n_inliers) or bool(rk.ok) != bool(rp.ok) or not bool(rp.ok) or e > 1e-3:
        raise RuntimeError(f"kernel P (KB8) disagrees with its plain version: {int(rk.n_inliers)} / "
                           f"{int(rp.n_inliers)} inliers, pose {e}")
    h, nvp = subsets.shape[0], int(valid.sum())
    gn = 6 * 54 + normal_flops(12, 6) + 144 + 150 + 60 + SVD3_FLOPS
    entry("pnp_ransac", e, lambda: pnp.pnp_ransac(cam, xw_p, uv_p, inv_s2, valid, 0, subsets=subsets),
          lambda: pnp.pnp_ransac_plain(cam, xw_p, uv_p, inv_s2, valid, subsets), len(valid) * 25 + h * 24 + 48,
          6 * nvp + h * (normal_flops(12, 12) + null_flops(12) + 2 * (SVD3_FLOPS + 100 + 4 * gn)) +
          (2 * h + 1) * nvp * 75,
          f"{len(valid)} slots ({nvp} valid, 20% outliers), {h} subsets: {int(rp.n_inliers)} inliers on both; pose "
          "err {:.2g}; tolerances: count and ok equal, pose 1e-3".format(e))
    # W: the frame's capacity, the last-frame form, every edge monocular
    _, T_cb, preint, s_prev, s0, obs_w, prior = w_problem(rng, device, cap)
    obs_w = obs_w._replace(uv=kb8_mono(obs_w.uv, cam), is_stereo=torch.zeros_like(obs_w.is_stereo))
    wk = lambda: inertial.pose_inertial_optimization_last_frame(cam, 0.0, T_cb, s_prev, prior, preint, s0, obs_w)
    wp = lambda: inertial.pose_inertial_optimization_last_frame_plain(cam, 0.0, T_cb, s_prev, prior, preint, s0,
                                                                      obs_w)
    (sk, ik, nk, Hk), (sp, ip, np_, Hp) = wk(), wp()
    torch.cuda.synchronize()
    e = max(float((a - b).abs().max()) for a, b in zip(sk, sp))
    hrel = float((Hk - Hp).abs().max() / Hp.abs().max())
    if e > 5e-3 or hrel > 5e-3 or int((ik != ip).sum()) > 2:
        raise RuntimeError(f"kernel W (KB8) disagrees with its plain version: state {e}, H {hrel}")
    nvw = int(obs_w.valid.sum())
    entry("pose_inertial", e, wk, wp, cap * 30 + 3 * 21 * 4 + 246 * 4, 40 * (nvw * 320 + 60_000) + 4 * cap * 40,
          f"the last-frame form, {cap} slots ({nvw} observing, mono); state err {e:.2g}, H rel err {hrel:.2g}; "
          "tolerances: state 5e-3, H 5e-3 of its largest entry, 2 edges", reps=10)
    # Y: K = 16, M = 2048, O = 8192
    _, prob_y = y_problem(rng, device)
    prob_y = prob_y._replace(obs_uv=kb8_mono(prob_y.obs_uv, cam))
    T_id = lie.SE3.identity(device)
    yk = lambda: vi_ba.vi_bundle_adjust(cam, 0.0, T_id, prob_y)
    yp = lambda: vi_ba.vi_bundle_adjust_plain(cam, 0.0, T_id, prob_y)
    ok_, op_ = yk(), yp()
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max()) for a, b in zip(ok_[:5], op_[:5])]
    mism = float((ok_[5] != op_[5]).float().mean())
    if errs[1] > 2e-3 or errs[4] > 1e-2 or errs[0] > 2e-4 or mism > 0.01:
        raise RuntimeError(f"kernel Y (KB8) disagrees with its plain version: {errs}, {mism:.3%} otherwise")
    Ky, My, Oy = prob_y.R_wb.shape[0], prob_y.xw.shape[0], prob_y.obs_kf.shape[0]
    ny = 15 * Ky
    pairs = int(sum(c * c for c in torch.bincount(prob_y.obs_lm.long()).tolist()))
    entry("vi_ba", max(errs), yk, yp, Oy * 27 + My * 13 + Ky * 21 * 8,
          12 * (Oy * 560 + pairs * 216 + 15 * 30 * 3000 + ny * ny * 60 + 2 * ny ** 3 // 3),
          f"K={Ky}, M={My}, O={Oy} (mono); errors R {errs[0]:.2g} p {errs[1]:.2g} xw {errs[4]:.2g}, {mism:.2%} "
          "classified otherwise; tolerances as the pin-hole case", reps=3)
    kb8.update(compare_fisheye_loop_kernels(device, cam))
    return [ab], kb8


def compare_fisheye_loop_kernels(device, cam) -> dict:
    """Phase 3's KB8 instances of Q, R and AA (TUM-VI's cam0 ``cam``), each
    against its plain version on the same CUDA tensors at the shapes and
    tolerances of the pin-hole rows (compare_loop_kernels,
    compare_inertial_loop_kernels), timed with CUDA events beside them:
    Q and R on the loop verification's 768 pair slots seen through the
    fisheye, with and without the scale; AA's 2-step segment on
    build_vi_problem's size and on the 200-keyframe world, every edge
    monocular through the fisheye.  Returns {name: entry}."""
    from orb_slam3_fast_tpu_torch.optim import sim3, vi_ba_cg
    from orb_slam3_fast_tpu_torch.utils import lie

    out = {}
    # Q and R: the pin-hole rows' pairs (seed 9, s = 1.3 and 1) with their pixels through the fisheye
    cases = {}
    for fix, s_true in ((False, 1.3), (True, 1.0)):
        arrays, xi_true = sim3_pairs(np.random.default_rng(9), s=s_true, cam=cam)
        cases[fix] = ([torch.as_tensor(a).to(device) for a in arrays], xi_true)
    valid = cases[False][0][-1]
    n, nv = valid.shape[0], int(valid.sum())
    subsets = sim3._sample_subsets(sim3.jax_seed(30 * 2654435761 + 5), valid)
    h = subsets.shape[0]
    q_err, q_ms, q_pms, r_err, r_ms, r_pms, n_act, notes = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0, []
    for fix in (False, True):
        pairs, xi_true = cases[fix]
        rk = sim3.sim3_ransac(cam, cam, *pairs, 0, fix_scale=fix, subsets=subsets)
        rp = sim3.sim3_ransac_plain(cam, cam, *pairs, subsets, fix_scale=fix)
        Sk, ik, nk = sim3.optimize_sim3(cam, cam, rp.S12, *pairs, fix_scale=fix)
        (Sp, ip, np_), rpm = timed(lambda: sim3.optimize_sim3_plain(cam, cam, rp.S12, *pairs, fix_scale=fix))
        qe, re_ = sim3_rel_err(rk.S12, rp.S12), sim3_rel_err(Sk, Sp)
        q_flips, r_flips = int((rk.inliers != rp.inliers).sum()), int((ik != ip).sum())
        # the pin-hole rows' tolerances: a pair within float rounding of the chi2 threshold counts on one side only
        if not (abs(int(rk.n_inliers) - int(rp.n_inliers)) <= 1 and bool(rk.ok) == bool(rp.ok) and bool(rp.ok)
                and qe <= 1e-4 and q_flips <= 1):
            raise RuntimeError(f"kernel Q (KB8) fix_scale={fix}: inliers {int(rk.n_inliers)}/{int(rp.n_inliers)}, ok "
                               f"{bool(rk.ok)}/{bool(rp.ok)}, Sim3 {qe:.3g}, masks differ on {q_flips}")
        if not (abs(int(nk) - int(np_)) <= 1 and re_ <= 2e-4 and r_flips <= 1):
            raise RuntimeError(f"kernel R (KB8) fix_scale={fix}: inliers {int(nk)}/{int(np_)}, Sim3 {re_:.3g}, masks "
                               f"differ on {r_flips}")
        qm = cuda_ms(lambda: sim3.sim3_ransac(cam, cam, *pairs, 0, fix_scale=fix, subsets=subsets), 50)
        qp = cuda_ms(lambda: sim3.sim3_ransac_plain(cam, cam, *pairs, subsets, fix_scale=fix), 10)
        rm = cuda_ms(lambda: sim3.optimize_sim3(cam, cam, rp.S12, *pairs, fix_scale=fix), 20)
        q_err, q_ms, q_pms = max(q_err, qe), q_ms + qm, q_pms + qp
        r_err, r_ms, r_pms = max(r_err, re_), r_ms + rm, r_pms + rpm
        n_act += int(np_)
        truth = sim3_rel_err(Sp, lie.sim3_exp(torch.as_tensor(xi_true).to(device)))
        notes.append(f"fix_scale={fix}: Q {int(rp.n_inliers)} inliers, Sim3 {qe:.2e}, {qm:.4f} ms (plain {qp:.4f}); "
                     f"R {int(np_)} inliers, Sim3 {re_:.2e}, truth within {truth:.2e}, {rm:.4f} ms (plain {rpm:.4f})")
    # compare_loop_kernels' counts, with a KB8 projection (an atan2, a division, the degree-9 polynomial and
    # its derivative: ~40 flops more than the pin-hole's) where the pin-hole projects
    q_ops = 2 * (h * (90 + SVD3_FLOPS + 80 + 140 * nv) + 140 * nv)
    out["sim3_ransac"] = dict(max_abs_err=q_err, ms=q_ms, plain_ms=q_pms, **bound(2 * (n * 49 + h * 12 + 52 + n + 5),
                                                                                  q_ops),
                              shapes=f"{n} slots ({nv} valid, 25% outliers), {h} subsets, both cases; " +
                                     "; ".join(notes) + "; tolerances as the pin-hole row")
    step = 140 + 210 + 20 + 280
    r_ops = 15 * (step * (nv + n_act) // 2) + 2 * 15 * (250 + 300 + SVD3_FLOPS) + 2 * 2 * 140 * nv
    out["sim3_refine"] = dict(max_abs_err=r_err, ms=r_ms, plain_ms=r_pms, **bound(2 * (n * 49 + 52 + 52 + n + 4),
                                                                                  r_ops),
                              shapes=f"{n} slots ({nv} valid), 5 + 10 steps, both cases, from the plain RANSAC's "
                                     "Sim3; tolerances as the pin-hole row")
    # AA: the pin-hole row's two problems, their observations through the fisheye
    T_id = lie.SE3.identity(device)
    a_err, a_ms, a_pms, a_ops, a_bytes, a_notes = 0.0, 0.0, 0.0, 0.0, 0, []
    prob, _ = vi_cg_problem(np.random.default_rng(12), device)
    big_w, _, _, _ = inertial_world(np.random.default_rng(13), n_kf=200, device=device)
    big = inertial_tracker(big_w, device).full_inertial_problem(big_w, [0])[0]
    for label, pr in (("build_vi_problem", prob), ("200-keyframe world", big)):
        pr = pr._replace(obs_uv=kb8_mono(pr.obs_uv, cam), obs_is_stereo=torch.zeros_like(pr.obs_is_stereo))
        K, M, O, E = pr.R_wb.shape[0], pr.xw.shape[0], pr.obs_kf.shape[0], pr.edge_i.shape[0]
        inl = torch.ones(O, dtype=torch.bool, device=device)
        lam = torch.tensor(1e-4, device=device)
        state = (pr.R_wb, pr.p_wb, pr.v_w, pr.bias)
        info = {}
        sk = vi_ba_cg._kernel(cam, 0.0, T_id, pr, state, pr.xw, inl, lam, 2, 40, info)
        sp, pms = timed(lambda: vi_ba_cg.lm_segment_vi_plain(cam, 0.0, T_id, pr, *state, pr.xw, inl, lam, 2, 40))
        ck = vi_ba_cg._kernel(cam, 0.0, T_id, pr, state[:2] + (None, None), pr.xw, None, None, 0, 0)
        cp = vi_ba_cg.classify_vi_plain(cam, 0.0, T_id, pr, pr.R_wb, pr.p_wb, pr.xw)
        torch.cuda.synchronize()
        seg_err = max(float((a - b).abs().max()) for a, b in zip(sk[:4], sp[:4]))
        xw_err = float((sk[4] - sp[4]).abs().max())
        flips = int((ck != cp).sum())
        if not (bool(torch.isfinite(sk[0]).all()) and seg_err <= 1e-3 and xw_err <= 1e-2 and flips <= 2):
            raise RuntimeError(f"kernel AA (KB8) on {label}: segment {seg_err:.3g}, landmarks {xw_err:.3g} from the "
                               f"plain version, {flips} observations classified otherwise")
        ms = cuda_ms(lambda: vi_ba_cg._kernel(cam, 0.0, T_id, pr, state, pr.xw, inl, lam, 2, 40), 5)
        a_err, a_ms, a_pms = max(a_err, seg_err), a_ms + ms, a_pms + pms
        a_ops += vi_pcg_ops(K, M, O, E, 2, info["cg_run"])
        a_bytes += vi_pcg_bytes(K, M, O, E)
        a_notes.append(f"{label} (K={K}, M={M}, O={O}, E={E}): a segment {ms:.3f} ms (plain {pms:.3f}, "
                       f"{info['cg_run']} CG iterations), {seg_err:.2e} from the plain version (landmarks "
                       f"{xw_err:.2e}), classification {flips} flipped")
    out["vi_pcg"] = dict(max_abs_err=a_err, ms=a_ms, plain_ms=a_pms, **bound(a_bytes, a_ops),
                         shapes="; ".join(a_notes) + "; every edge monocular through the fisheye; tolerances: states "
                                "1e-3 after a segment, landmarks 1e-2 m, 2 observations classified otherwise")
    return out


# --- phase 14: loop closing on the fisheye rig (TUM-VI) ---------------------------------------------------------

# Phase 14 (b)'s IMU noise densities, as multiples of the configuration file's (TUM-VI's): with TUM-VI's own the
# JAX package's stereo-inertial System initialises the IMU at frame 41 and is RECENTLY_LOST from frame 42 to the end,
# closing no loop (python -m tests.fisheye_loop_reference --sensor stereo-inertial --noise-scale 1), as phase 12 (a)
# with EuRoC's; phase 12's low-grade IMU (VI_LOOP_IMU_NOISE) keeps the track
FISHEYE_LOOP_IMU_NOISE = VI_LOOP_IMU_NOISE
# Phase 14's gates, at the JAX package's own runs on the scene (python -m tests.fisheye_loop_reference, CPU): (a)
# stereo: 150 tracked, the loop closed at frame 133, 97 keyframes, unscaled ATE 0.0585 m; the loop is gated at that
# frame +- 5 (three keyframes either side: the port draws the Sim3 RANSAC's hypotheses from another generator, so
# the verification may pass a keyframe earlier or later) and the ATE at tests/test_loop_closing.py's 0.20 m; (b)
# stereo-inertial (FISHEYE_LOOP_IMU_NOISE): 150 tracked, the IMU initialised at frame 41, the loop closed at frame
# 133, 92 keyframes, unscaled ATE after the initialisation 0.0492 m; gated alike (phase 12's VI_LOOP_MAX_ATE)
FISHEYE_LOOP_FRAMES = {"stereo": (128, 138), "stereo-inertial": (128, 138)}
FISHEYE_LOOP_MAX_ATE = {"stereo": 0.20, "stereo-inertial": VI_LOOP_MAX_ATE}
FISHEYE_LOOP_GATES = {
    "stereo": f"the loop closed within frames {FISHEYE_LOOP_FRAMES['stereo']}, unscaled ATE < "
              f"{FISHEYE_LOOP_MAX_ATE['stereo']} m; Q and R in KB8, S or U, and T launched",
    "stereo-inertial": f"the IMU initialised, the loop closed within frames {FISHEYE_LOOP_FRAMES['stereo-inertial']}, "
                       f"unscaled ATE after the initialisation < {FISHEYE_LOOP_MAX_ATE['stereo-inertial']} m; Q and R "
                       "in KB8, Z, AA in KB8 launched, S, U and T not"}


def _render_fisheye_circle(i: int):
    """Frame i of phase 14's circle through the TUM-VI rig (run in a worker process)."""
    world = make_ring_world(np.random.default_rng(0))
    s = fisheye_settings("stereo-inertial")
    R, t = circle_trajectory_with_imu(LOOP_FRAMES)[0][i]
    return stereo_pair_cams(world, s.cam, s.cam2, R, t, s.T_c1_c2, FISHEYE_WH)


def fisheye_loop_frames():
    """Phase 14's input: phase 12's scene, the loop scenario's ring world
    (make_ring_world, seed 0) along circle_trajectory_with_imu(150), seen by
    the TUM-VI rig (both 512x512 KB8 cameras through Stereo.T_c1_c2),
    rendered by one worker process per core, and the exact IMU stream of
    the body through IMU.T_b_c1.  Returns (stereo pairs, true T_cw of the
    left camera per frame, IMU rows)."""
    frames = render_map(_render_fisheye_circle, range(LOOP_FRAMES), parallel=True)
    poses, imu = circle_trajectory_with_imu(LOOP_FRAMES, T_bc=fisheye_settings("stereo-inertial").T_b_c1)
    return frames, poses, imu


def fisheye_loop_settings(sensor: str, noise_scale: float = FISHEYE_LOOP_IMU_NOISE):
    """The TUM-VI configuration loaded for ``sensor``; for the inertial one
    its IMU noise densities (gyro, accelerometer and both walks) scaled by
    ``noise_scale``."""
    import dataclasses

    s = fisheye_settings(sensor)
    if sensor != "stereo-inertial":
        return s
    k = noise_scale
    return dataclasses.replace(s, imu_noise_gyro=k * s.imu_noise_gyro, imu_noise_acc=k * s.imu_noise_acc,
                               imu_gyro_walk=k * s.imu_gyro_walk, imu_acc_walk=k * s.imu_acc_walk)


def fisheye_loop_system(sensor: str, device):
    """``System(TUM-VI config, sensor)`` with loop closing, the Atlas and 256
    keyframes, synchronous, the loop closer at phase 9's LoopCloserConfig
    (the scale fixed): phase 14 (a) and (b)."""
    from orb_slam3_fast_tpu_torch.backend.loopcloser import LoopCloserConfig
    from orb_slam3_fast_tpu_torch.slam.system import System

    slam = System(fisheye_loop_settings(sensor), sensor, max_keyframes=256, enable_loop_closing=True, multi_map=True,
                  async_backend=False, device=device)
    slam.loopcloser.cfg = LoopCloserConfig(**LOOP_CONFIG, fix_scale=True)
    return slam


def run_fisheye_loop(frames, poses, imu, device, sensor: str):
    """Phase 14 (a) (``"stereo"``) and (b) (``"stereo-inertial"``, with the
    IMU stream): :func:`fisheye_loop_system` on the circle, the first loop
    correction's inputs kept for a rerun from its snapshot.  Returns the
    System, a summary (run_vi_loop's: the ATE over the frames tracked, after
    the IMU initialisation with the IMU) and the snapshot."""
    return _run_loop_with_snapshot(fisheye_loop_system(sensor, device), frames, poses,
                                   imu if sensor == "stereo-inertial" else None, device)


def check_fisheye_loop(sensor: str, summary, launches) -> None:
    """Phase 14 (a) / (b)'s gates (FISHEYE_LOOP_GATES): the loop closed
    within FISHEYE_LOOP_FRAMES[sensor], the ATE under FISHEYE_LOOP_MAX_ATE
    (and for (b) the IMU initialised); Q and R launched in their KB8
    instances, the Sim3 graph (S or U) and T for (a), Z and AA in KB8 for
    (b)."""
    lo, hi = FISHEYE_LOOP_FRAMES[sensor]
    ok = (bool(summary["closed_at"]) and lo <= summary["closed_at"][0] <= hi
          and summary.get("ate_unscaled_m", 1e9) < FISHEYE_LOOP_MAX_ATE[sensor])
    need = ["sim3_ransac[kb8]", "sim3_refine[kb8]"]
    if sensor == "stereo-inertial":
        ok = ok and summary["init_frame"] is not None
        need += ["pose_graph4", "vi_pcg[kb8]"]
        stray = [n for n in ("sim3_graph", "sim3_pcg", "ba_pcg") if launches[n]]
    else:
        need += ["ba_pcg"]
        stray = [n for n in ("pose_graph4", "vi_pcg") if launches[n]]
        if launches["sim3_graph"] + launches["sim3_pcg"] < 1:
            stray.append("no Sim3 graph (S or U)")
    missing = [n for n in need if launches[n] < 1]
    if not ok or missing or stray:
        raise RuntimeError(f"fisheye loop System ({sensor}) gates failed: {summary}; never launched {missing}; "
                           f"{stray}")


def run_default_fisheye(frames, imu, device, sensor: str):
    """Phases 14 (c) and 15 (d): the default constructor ``System(TUM-VI
    config, sensor)``, every default (the async backend, loop closing, the
    Atlas), fed the circle at 20 fps (stereo pairs, or the first camera's
    images for a monocular sensor).  Gates: the backend drains within 120
    s, no worker error, for the stereo-inertial sensor the IMU initialised.
    Returns a summary (the loops closed, and the monocular-inertial IMU,
    reported, not gated)."""
    from orb_slam3_fast_tpu_torch.slam.system import System

    slam = System(FISHEYE_CONFIG, sensor, device=device)
    b = slam.backend
    inertial, mono = sensor.endswith("inertial"), sensor.startswith("monocular")
    samples = imu_slices(imu, len(frames)) if inertial else [()] * len(frames)
    states, t0 = [], time.perf_counter()
    for i, (f, smp) in enumerate(zip(frames, samples)):
        wait = t0 + i * 0.05 - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        track = slam.track_monocular(f, i * 0.05, imu=smp) if mono else slam.track_stereo(*f, i * 0.05, imu=smp)
        states.append(track[0])
    drained = b.wait_idle(timeout=120)
    slam.shutdown()
    if device.type == "cuda":
        torch.cuda.synchronize()
    summary = dict(sensor=sensor, state=slam.get_tracking_state(), tracked=sum(s == "OK" for s in states),
                   drained=drained, errors=len(b.errors), imu_initialized=bool(slam.world.imu_initialized),
                   n_kf=slam.world.n_kf, loops=slam.loopcloser.n_loops_closed, error=b.errors[0] if b.errors else None)
    if not (drained and not b.errors and (summary["imu_initialized"] or sensor != "stereo-inertial")):
        raise RuntimeError(f"default fisheye System ({sensor}) gates failed: {summary}")
    return summary


# --- phase 15: the monocular KB8 rig (TUM-VI's cam0 alone) ---------------------------------------------------------

def fisheye_mono_system(sensor: str, device, loop: bool = False):
    """``System(TUM-VI config, sensor)`` for ``"monocular"`` or
    ``"monocular-inertial"``, synchronous: without loop closing and the
    Atlas (phase 15 (a), (b); phase 11's initialisation window for the
    inertial one), or with ``loop`` loop closing, the Atlas and 256
    keyframes, the loop closer at phase 9's LoopCloserConfig with the scale
    free (phase 15 (c))."""
    from orb_slam3_fast_tpu_torch.backend.loopcloser import LoopCloserConfig
    from orb_slam3_fast_tpu_torch.slam.system import System

    if loop:
        slam = System(fisheye_settings(sensor), sensor, max_keyframes=256, enable_loop_closing=True, multi_map=True,
                      async_backend=False, device=device)
        slam.loopcloser.cfg = LoopCloserConfig(**LOOP_CONFIG, fix_scale=False)
        return slam
    slam = System(fisheye_settings(sensor), sensor, enable_loop_closing=False, multi_map=False, async_backend=False,
                  device=device)
    if sensor == "monocular-inertial":
        slam.tracker.icfg = slam.tracker.icfg._replace(init_min_kfs=8, init_min_time=1.0)  # phase 11's
    return slam


def run_fisheye_mono(images, poses, device, imu=None):
    """Phase 15 (a) / (b): :func:`fisheye_mono_system` (``"monocular"``, or
    ``"monocular-inertial"`` with ``imu``) on the first camera's images of a
    phase 13 scene.  Returns the System, a summary (state, frames tracked,
    the first frame tracked, keyframes and their frames, landmarks, local
    BAs, the scale-aligned ATE and the fitted scale over the frames tracked,
    or after the IMU initialisation with ``imu``) and the per-frame (state,
    R, t), identity before the first pose."""
    from orb_slam3_fast_tpu_torch.eval import ate

    slam = fisheye_mono_system("monocular" if imu is None else "monocular-inertial", device)
    samples = imu_slices(imu, len(images)) if imu is not None else [()] * len(images)
    est, gt, ts, track, kf_frames, init_frame = [], [], [], [], [], None
    for i, (img, (R, t), smp) in enumerate(zip(images, poses, samples)):
        n_kf = slam.world.n_kf
        state, pose = slam.track_monocular(img, i * 0.05, imu=smp)
        if pose is None:
            pose = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        track.append((state, *pose))
        if slam.world.n_kf > n_kf:
            kf_frames.append(i)
        if imu is not None and slam.world.imu_initialized and init_frame is None:
            init_frame = i
        if state == "OK" and (imu is None or (init_frame is not None and i > init_frame)):
            est.append(-pose[0].T @ pose[1])
            gt.append(-R.T @ t)
            ts.append(i * 0.05)
    if device.type == "cuda":
        torch.cuda.synchronize()
    summary = dict(state=slam.get_tracking_state(), tracked=sum(s == "OK" for s, _, _ in track),
                   first_ok=next((i for i, (s, _, _) in enumerate(track) if s == "OK"), None), n_kf=slam.world.n_kf,
                   kf_frames=kf_frames, landmarks=int(slam.world.lm_valid.sum()), local_ba=slam.mapper.n_local_ba)
    if imu is not None:
        summary.update(init_frame=init_frame, after_init=len(est))
    if len(est) >= 3:
        est, gt, ts = np.asarray(est), np.asarray(gt), np.asarray(ts)
        summary["ate_m"], _, summary["scale"] = ate.ate_rmse(ts, est, ts, gt, with_scale=True)
    return slam, summary, track


# Phase 15's gates, at the JAX package's own runs on the same frames (python -m tests.fisheye_mono_reference, CPU):
# (a) the monocular System on 13 (a)'s 25 frames: the first frame tracked (the initialisation) 1, 24 tracked, 13
# keyframes, final OK, scale-aligned ATE 0.0028 m (the port's plain path on the host: the same, ATE 0.0028);
# (b) the monocular-inertial System on 13 (b)'s 45 frames: initialised at frame 1, the IMU at frame 22, 5 frames OK
# after it, RECENTLY_LOST from frame 32 on, 14 keyframes, scale-aligned ATE after the IMU initialisation 0.060 m
# (scale 0.97); (c) the monocular System with loop closing on 14's circle: initialised at frame 5, 145 tracked, the
# loop closed at frame 138, 69 keyframes, final OK, scale-aligned ATE 0.219 m (over tests/test_loop_closing.py's
# 0.20).  The gates: (a) the first frame tracked within FISHEYE_MONO_FIRST, >= FISHEYE_MONO_MIN_TRACKED tracked,
# keyframes within FISHEYE_MONO_KF, final OK, ATE under tests/test_slam_e2e.py's mono 0.15 m; (b) the IMU
# initialised within FISHEYE_MONO_VI_INIT, >= FISHEYE_MONO_VI_MIN_AFTER frames OK after it, the ATE after it under
# phase 11's 0.25 m, the final state reported; (c) final OK, > 120 tracked (the loop test's), the loop closed within
# FISHEYE_MONO_LOOP_FRAMES (three keyframes either side of the JAX package's), ATE < FISHEYE_MONO_LOOP_MAX_ATE.
FISHEYE_MONO_FIRST, FISHEYE_MONO_MIN_TRACKED, FISHEYE_MONO_KF = (1, 3), 22, (10, 16)
FISHEYE_MONO_VI_INIT, FISHEYE_MONO_VI_MIN_AFTER = (18, 26), 4
FISHEYE_MONO_LOOP_FRAMES, FISHEYE_MONO_LOOP_MAX_ATE = (133, 143), 0.30
FISHEYE_MONO_GATES = {
    "a": f"first frame tracked within frames {FISHEYE_MONO_FIRST}, >= {FISHEYE_MONO_MIN_TRACKED} tracked, keyframes "
         f"within {FISHEYE_MONO_KF}, final OK, scale-aligned ATE < 0.15 m; M, D, E, L and AC in KB8, N launched, AB "
         "and J not",
    "b": f"IMU initialised within frames {FISHEYE_MONO_VI_INIT}, >= {FISHEYE_MONO_VI_MIN_AFTER} frames OK after it, "
         "scale-aligned ATE after it < 0.25 m; V, X, W and Y in KB8 launched, AB and J not",
    "c": f"final OK, > 120 tracked, the loop closed within frames {FISHEYE_MONO_LOOP_FRAMES}, scale-aligned ATE < "
         f"{FISHEYE_MONO_LOOP_MAX_ATE} m; Q and R in KB8 with the scale free, S or U, and T launched, AB and J not"}


def check_fisheye_mono(part: str, summary, launches) -> None:
    """Phase 15 (a), (b) or (c)'s gates (``FISHEYE_MONO_GATES``) and the
    kernels each must launch; AB (the two-camera match) and J (the
    rectified stereo refine) never launch on one camera."""
    need = ["twoview_ransac[kb8]", "vocab_transform", "pose_lm[kb8]", "ba_blocks[kb8]", "ba_lm_update[kb8]",
            "ba_classify[kb8]", "visible_landmarks[kb8]", "hamming_best2[window]", "triangulate_dlt"]
    if part == "a":
        lo, hi = FISHEYE_MONO_FIRST
        ok = (summary["state"] == "OK" and summary["first_ok"] is not None and lo <= summary["first_ok"] <= hi
              and summary["tracked"] >= FISHEYE_MONO_MIN_TRACKED
              and FISHEYE_MONO_KF[0] <= summary["n_kf"] <= FISHEYE_MONO_KF[1] and summary.get("ate_m", 1.0) < 0.15)
    elif part == "b":
        lo, hi = FISHEYE_MONO_VI_INIT
        need = ["imu_preint", "imu_init", "pose_inertial[kb8]", "vi_ba[kb8]"]
        ok = (summary["init_frame"] is not None and lo <= summary["init_frame"] <= hi
              and summary["after_init"] >= FISHEYE_MONO_VI_MIN_AFTER and summary.get("ate_m", 1.0) < 0.25)
    else:
        lo, hi = FISHEYE_MONO_LOOP_FRAMES
        need = ["sim3_ransac[kb8, free scale]", "sim3_refine[kb8, free scale]", "ba_pcg"]
        ok = (summary["state"] == "OK" and summary["tracked"] > 120 and bool(summary["closed_at"])
              and lo <= summary["closed_at"][0] <= hi and summary.get("ate_m", 1e9) < FISHEYE_MONO_LOOP_MAX_ATE)
    missing = [n for n in need if launches[n] < 1]
    if part == "c" and launches["sim3_graph"] + launches["sim3_pcg"] < 1:
        missing.append("S or U")
    stray = [n for n in ("fisheye_stereo", "stereo_subpixel_refine") if launches[n]]
    if not ok or missing or stray:
        raise RuntimeError(f"fisheye monocular System ({part}) gates failed: {summary}; never launched {missing}; "
                           f"launched {stray}")


def run_fisheye_mono_loop(images, poses, device):
    """Phase 15 (c): :func:`fisheye_mono_system` with loop closing on the
    first camera's images of phase 14's circle, the first loop correction's
    inputs kept.  Returns the System, a summary (the scale-aligned ATE over
    the frames tracked) and the snapshot."""
    return _run_loop_with_snapshot(fisheye_mono_system("monocular", device, loop=True), images, poses, None, device)


def log_frame_kinds(label: str, slam, summary) -> None:
    """A path's track_total by frame kind: the initialisation (the first
    frame tracked), keyframes and ordinary frames (ms)."""
    spans = slam.timers.spans["track_total"]
    kf = set(summary["kf_frames"]) - {summary["first_ok"]}
    kinds = {"init": [spans[summary["first_ok"]]] if summary["first_ok"] is not None else [],
             "keyframe": [ms for i, ms in enumerate(spans) if i in kf],
             "ordinary": [ms for i, ms in enumerate(spans) if i not in kf and i != summary["first_ok"]]}
    log(f"{label} track_total ms by kind: " + "; ".join(
        f"{k} n={len(v)} median {np.median(v):.3f} max {np.max(v):.3f}" for k, v in kinds.items() if v))
    log(f"{label} track_total ms per frame: {[round(x, 3) for x in spans]}")


# Kernel E's outputs on phase 3's local-BA problem (ba_problem(default_rng(3))) through the pin-hole camera, EuRoC
# cam0's distortion and TUM-VI's cam0 (``e_digests``), as the parent of the commit that moved E's residual and
# robust cost into csrc/ba_obs.cuh computes them on an H100 (``track_spread.py --e-digest --root <parent>``): phase 3
# holds E to them bit for bit (recorded from commit fc1a711 on an NVIDIA H100 80GB HBM3, CUDA 12.8)
E_DIGESTS = {"pinhole": "50d4839b138e60af", "radtan": "adec1a69cd130040", "kb8": "29bfef4090596071"}


def lm_cameras() -> dict:
    """The three camera instances of kernels E and AC: the synthetic
    pin-hole camera, the same with EuRoC cam0's distortion, TUM-VI's cam0
    (KB8)."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera

    return {"pinhole": Camera.pinhole(400.0, 400.0, 320.0, 240.0),
            "radtan": Camera.pinhole(400.0, 400.0, 320.0, 240.0, EUROC_DIST), "kb8": fisheye_settings("stereo").cam}


def e_digests(device) -> dict:
    """Kernel E's outputs (Hpp, Hll, bp, bl, W, w_lm, cost) on phase 3's
    local-BA problem in each camera instance (``lm_cameras``; the pin-hole
    problem's pixels computed in numpy, the others' through the camera):
    the first 16 hex digits of the SHA-256 of their bytes, by instance."""
    import hashlib

    from orb_slam3_fast_tpu_torch.optim import ba

    out = {}
    for kind, cam in lm_cameras().items():
        prob = ba_problem(np.random.default_rng(3), device, cam=None if kind == "pinhole" else cam)
        blocks = ba.build_normal_blocks(cam, 48.0, prob.R, prob.t, prob.xw, prob, torch.ones_like(prob.obs_valid))
        h = hashlib.sha256()
        for x in blocks:
            h.update(x.contiguous().cpu().numpy().tobytes())
        out[kind] = h.hexdigest()[:16]
    return out


BA_REPS = (10, 5)  # timed runs of the whole local and global BA (after 2 warm-up runs each)


def ba_times(device) -> dict:
    """Milliseconds of one whole local BA (5 + 10 LM iterations on phase 3's
    problem at the mapper's caps) and one global BA (8 + 12 on the circle's
    problem, 32 CG iterations), by CUDA events over ``BA_REPS`` runs."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera
    from orb_slam3_fast_tpu_torch.optim import ba, ba_cg

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    prob, gprob = ba_problem(np.random.default_rng(3), device), gba_problem(np.random.default_rng(11), device)
    return {"bundle_adjust": cuda_ms(lambda: ba.bundle_adjust(cam, 48.0, prob), BA_REPS[0]),
            "bundle_adjust_cg": cuda_ms(lambda: ba_cg.bundle_adjust_cg(cam, 0.0, gprob, iters1=8, iters2=12),
                                        BA_REPS[1])}


def check_lm_update(cam, bf: float, prob, local: bool) -> tuple[float, list]:
    """Kernel AC's update against lm_update_plain on the card from E's blocks
    and F's step (``local``; T's step otherwise, with no flag) at the
    problem's state: the step accepted, its negative rejected, each state
    within 1e-5 (absolute), the accept and the damping equal, the cost
    within 1e-5 relative; a zero step rejected, AC's cost E's bit for bit
    (the plain version's cost sums in another order than E's, so on the
    card its zero step may pass the test); two runs of AC bit for bit.  Returns (the largest state
    difference, the step's arguments of lm_update)."""
    from orb_slam3_fast_tpu_torch.optim import ba, ba_cg

    inl = torch.ones_like(prob.obs_valid)
    blocks = (ba.build_normal_blocks if local else ba_cg.build_blocks)(cam, bf, prob.R, prob.t, prob.xw, prob, inl)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=prob.R.device)
    if local:
        dp, dl, ok = ba.schur_solve(*blocks[:6], prob, lam)
    else:
        (dp, dl), ok = ba_cg.implicit_schur_solve(*blocks[:5], prob, blocks[5], lam), None
    err = 0.0
    for label, f, accepted in (("the step", 1.0, True), ("its negative", -1.0, False), ("a zero step", 0.0, False)):
        args = (cam, bf, prob, prob.R, prob.t, prob.xw, f * dp if f else torch.zeros_like(dp),
                f * dl if f else torch.zeros_like(dl), inl, blocks[6], ok, lam)
        k, k2, p = ba.lm_update(*args), ba.lm_update(*args), ba.lm_update_plain(*args)
        torch.cuda.synchronize()
        bad = [] if all(torch.equal(a, b) for a, b in zip(k, k2)) else ["two runs differ"]
        if f == 0.0:  # the plain cost sums in another order than E's: AC alone is held to E's cost
            same = all(torch.equal(a, b) for a, b in zip(k[:3], args[3:6]))
            lam5 = float(torch.clamp(lam * 5.0, max=1e6))
            if bool(k[4]) or not same or float(k[3]) != lam5 or float(k[5]) != float(blocks[6]):
                bad.append(f"accept {bool(k[4])}, state kept {same}, damping {float(k[3])} (want {lam5}), cost "
                           f"{float(k[5])!r} (E's {float(blocks[6])!r})")
        else:
            e = max(float((a - b).abs().max()) for a, b in zip(k[:3], p[:3]))
            err = max(err, e)
            if not (e <= 1e-5 and bool(k[4]) == bool(p[4]) == accepted and float(k[3]) == float(p[3])):
                bad.append(f"state err {e:.3g}, accept {bool(k[4])} / plain {bool(p[4])} (want {accepted}), "
                           f"damping {float(k[3])} / {float(p[3])}")
            if abs(float(k[5]) - float(p[5])) > 1e-5 * abs(float(p[5])):
                bad.append(f"cost {float(k[5])} / plain {float(p[5])}")
        if bad:
            raise RuntimeError(f"kernel AC, {'local' if local else 'global'} BA, {label}: " + "; ".join(bad))
        if f == 1.0:
            step_args = args
    return err, step_args


def check_costs_per_observation(cam, bf: float, prob, n: int = 48) -> int:
    """AC's cost at a zero step against E's cost with one observation valid
    at a time, for ``n`` observations spread over the valid ones (stereo,
    mono and outlier rows): a one-observation cost is that observation's
    Huber cost, with no sum to hide a difference of its last bit.  Raises
    unless every pair is the same bits and every zero step is rejected.
    Returns the number of observations compared."""
    from orb_slam3_fast_tpu_torch.optim import ba

    ids = torch.nonzero(prob.obs_valid).flatten()
    ids = ids[:: max(1, len(ids) // n)][:n].tolist()
    inl = torch.ones_like(prob.obs_valid)
    zeros = prob.t.new_zeros(prob.R.shape[0], 6), torch.zeros_like(prob.xw)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=prob.R.device)
    e_cost, ac_cost, accepts = [], [], []
    for o in ids:
        one = torch.zeros_like(prob.obs_valid)
        one[o] = True
        p1 = prob._replace(obs_valid=one)
        e_cost.append(ba.build_normal_blocks(cam, bf, p1.R, p1.t, p1.xw, p1, inl)[6])
        k = ba.lm_update(cam, bf, p1, p1.R, p1.t, p1.xw, *zeros, inl, e_cost[-1], None, lam)
        ac_cost.append(k[5])
        accepts.append(k[4])
    e_cost, ac_cost = torch.stack(e_cost), torch.stack(ac_cost)
    differ = [ids[i] for i in torch.nonzero(e_cost != ac_cost).flatten().tolist()]
    if differ or bool(torch.stack(accepts).any()):
        raise RuntimeError(f"kernel AC's cost is not E's for observations {differ} of {ids}, or a zero step passed")
    return len(ids)


def check_classify(cam, bf: float, prob, R, t, xw) -> tuple[int, int]:
    """Kernel AC's gate against classify_plain on the card: the masks equal
    off the observations whose chi2 lies within 1e-4 of its bound.
    Returns (observations classified otherwise, those near the bound)."""
    from orb_slam3_fast_tpu_torch.optim import ba

    k, p = ba.classify(cam, bf, prob, R, t, xw), ba.classify_plain(cam, bf, prob, R, t, xw)
    r, _, _ = ba._obs_residuals(cam, bf, R, t, xw, prob)
    edge = ((r * r).sum(-1) * prob.obs_inv_sigma2 / ba._delta2(prob) - 1.0).abs() < 1e-4
    off = int(((k != p) & ~edge).sum())
    if off:
        raise RuntimeError(f"kernel AC's gate: {off} observations off the chi2 bound classified otherwise")
    return int((k != p).sum()), int(edge.sum())


def lm_bytes_ops(K: int, M: int, O: int, obs_flops: int) -> tuple[float, float]:
    """Kernel AC's update: the observation table (27 bytes a slot) and the
    state, step and landmark flags in (72 bytes a pose, 25 a landmark),
    the state out (48, 12), the scalars; ``obs_flops`` a slot for the
    projection, residual and Huber cost, ~160 a pose for exp and compose."""
    return O * 27 + K * (72 + 48) + M * (25 + 12) + 16, obs_flops * O + 160 * K + 3 * M


def compare_lm_kernels(device) -> list[dict]:
    """Phase 3 for kernel AC: E's outputs bit for bit against the parent's
    (``E_DIGESTS``); both entries against their plain versions at the local
    BA's caps (phase 3's problem, F's step) and at the global BA's size
    (the circle's problem, T's step) in the three camera instances
    (``check_lm_update``, ``check_classify``); both BA forms with every
    plain LM function made to raise, AC launched once per E launch, and
    timed whole.  Returns (the update's entry, the gate's entry)."""
    from orb_slam3_fast_tpu_torch.optim import ba

    t0 = time.perf_counter()
    digests = e_digests(device)
    if digests != E_DIGESTS:
        raise RuntimeError(f"kernel E's outputs moved: {digests}, the parent's {E_DIGESTS}")
    cams = lm_cameras()
    obs_flops = {"pinhole": 60, "radtan": 80, "kb8": 120}
    rows = {}
    for shape in ("local", "global"):
        for kind, cam in cams.items():
            pc = None if kind == "pinhole" else cam
            if shape == "local":
                prob, bf = ba_problem(np.random.default_rng(3), device, cam=pc), 48.0
            else:
                prob, bf = gba_problem(np.random.default_rng(11), device, cam=pc), 0.0
            err, args = check_lm_update(cam, bf, prob, shape == "local")
            n_one = check_costs_per_observation(cam, bf, prob)
            R, t, xw = ba.lm_update(*args)[:3]
            flips, edge = check_classify(cam, bf, prob, R, t, xw)
            K, M, O = prob.R.shape[0], prob.xw.shape[0], prob.obs_kf.shape[0]
            u_bytes, u_ops = lm_bytes_ops(K, M, O, obs_flops[kind])
            c_bytes, c_ops = O * 27 + K * 48 + M * 12, obs_flops[kind] * O
            rows[shape, kind] = dict(
                K=K, M=M, O=O, err=err, flips=flips, edge=edge, n_one=n_one,
                update=dict(ms=cuda_ms(lambda: ba.lm_update(*args), 20), plain_ms=cuda_ms(
                    lambda: ba.lm_update_plain(*args), 5), **bound(u_bytes, u_ops)),
                classify=dict(ms=cuda_ms(lambda: ba.classify(cam, bf, prob, R, t, xw), 20), plain_ms=cuda_ms(
                    lambda: ba.classify_plain(cam, bf, prob, R, t, xw), 5), **bound(c_bytes, c_ops)))
    # both BA forms on the card with the plain LM functions refusing: E -> F (T) -> AC and nothing else
    names = ("lm_update_plain", "classify_plain", "apply_update", "_obs_residuals", "_robust_cost")
    saved = {n: getattr(ba, n) for n in names}

    def refuse(*a, **kw):
        raise RuntimeError("a plain LM function was called on the card")

    for w in (ba.build_normal_blocks, ba.lm_update, ba.classify):
        w.launches.reset()
    try:
        for n in names:
            setattr(ba, n, refuse)
        times = ba_times(device)
    finally:
        for n, f in saved.items():
            setattr(ba, n, f)
    n_e, n_u, n_c = (w.launches.total() for w in (ba.build_normal_blocks, ba.lm_update, ba.classify))
    runs = [2 + n for n in BA_REPS]
    if not (n_e == n_u == 15 * runs[0] + 20 * runs[1] and n_c == 2 * sum(runs)):
        raise RuntimeError(f"the BA forms on the card: E {n_e}, AC's update {n_u}, its gate {n_c} launches")
    whole = (f"; E's outputs bit for bit the parent's ({digests}); with every plain LM function refusing, "
             f"bundle_adjust 5+10 via E -> F -> AC {times['bundle_adjust']:.3f} ms and bundle_adjust_cg 8+12 via "
             f"E -> T -> AC {times['bundle_adjust_cg']:.3f} ms, AC launched once per E launch; "
             f"{time.perf_counter() - t0:.1f} s for AC's rows")

    def entry(name, key, replaces, what, err, tolerance, tail=""):
        base, kb8 = rows["local", "pinhole"], rows["local", "kb8"]
        each = "; ".join(f"{shape} BA {kind} (K={r['K']}, M={r['M']}, O={r['O']}) {r[key]['ms']:.4f} ms (plain "
                         f"{r[key]['plain_ms']:.4f}, bound {r[key]['bound_ms']:.5f}), {what(r)}"
                         for (shape, kind), r in rows.items())
        return dict(name=name, route="cuda", source="orb_slam3_fast_tpu_torch/csrc/ba_lm.cu", replaces=replaces,
                    max_abs_err=max(err(r) for r in rows.values()), library_ms=None,
                    **{k: base[key][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                    shapes=f"{tolerance}; {each}{tail}; no single library call",
                    kb8=dict(max_abs_err=err(kb8), shapes="the local BA's caps through TUM-VI's cam0",
                             **{k: kb8[key][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}))

    return [entry("ba_lm_update", "update", "orb_slam3_fast_tpu/optim/ba.py:151",
                  lambda r: f"state err {r['err']:.2g}, {r['n_one']} one-observation costs E's bit for bit",
                  lambda r: r["err"], "max_abs_err: the state against lm_update_plain's after the step (accepted), "
                  "its negative (rejected) and a zero step (rejected, the cost E's bit for bit, also with one "
                  "observation valid at a time), tolerance 1e-5; accepts and damping equal, two runs bit for bit",
                  whole),
            entry("ba_classify", "classify", "orb_slam3_fast_tpu/optim/ba_cg.py:205",
                  lambda r: f"{r['flips']} flags otherwise, {r['edge']} within 1e-4 of the bound",
                  lambda r: float(r["flips"]), "max_abs_err: inlier flags otherwise than classify_plain's, all of "
                  "them within 1e-4 of the chi2 bound (none allowed off it)")]


# --- phase 16: several ranks: kernel AE (the sharded keyframe database) and kernel AF (the sharded BAs) ---------

KFDB_ROWS, KFDB_WORDS = 4096, 1024  # kernel AE's rows (a 4096-keyframe database) and a row's capacity (row_words)
KFDB_VOCABS = (10_000, 1_000_000)  # the query table's sizes: the default vocabulary's order and ORBvoc's
RANKS = 2  # phase 16 (b): ranks spawned on the one card, gloo
RANK_TIMEOUT_S = 400
AF_DENSE, AF_CG = (5, 10), (8, 12)  # the local BA's and the global BA's LM iterations; 32 CG iterations a solve
AF_TOL = (5e-4, 5e-3)  # rotation entries and translations against the single-device BA (tests/test_dist_ba.py:37-38)


def kfdb_case(rng, n_words: int, n_rows: int = KFDB_ROWS, row_words: int = KFDB_WORDS) -> tuple:
    """A keyframe database's sparse rows as ``KeyFrameDatabase`` holds
    them, and a query: each row 60-100% full of distinct word ids
    (ascending, then -1), half of them drawn from 4096 common words (a
    vocabulary's eighth, at most) and half from the whole vocabulary, its
    tf-idf weights L1-normalised; the query alike, dense.  Returns (ids
    (K,T) int32, w (K,T) float32, query (n_words,) float32)."""
    common = rng.choice(n_words, min(4096, n_words // 8), replace=False)

    def words():
        n = int(rng.integers(int(0.6 * row_words), row_words + 1))
        ids = np.unique(np.concatenate([rng.choice(common, n // 2), rng.integers(0, n_words, n - n // 2)]))
        w = rng.uniform(0.1, 1.0, len(ids)).astype(np.float32)
        return ids.astype(np.int32), w / w.sum()

    ids = np.full((n_rows, row_words), -1, np.int32)
    w = np.zeros((n_rows, row_words), np.float32)
    for k in range(n_rows):
        i, v = words()
        ids[k, :len(i)], w[k, :len(i)] = i, v
    qi, qv = words()
    query = np.zeros(n_words, np.float32)
    query[qi] = qv
    return ids, w, query


def host_scores(ids, w, query, n_words: int) -> tuple:
    """The host database's ``_scores`` (numpy) of every row."""
    from orb_slam3_fast_tpu_torch.vocab.database import KeyFrameDatabase

    db = KeyFrameDatabase(n_words, max_kf=ids.shape[0], row_words=ids.shape[1])
    db.ids, db.w = ids, w
    db.valid[:] = True
    common, score, _ = db._scores(query, np.zeros(0, np.int64))
    return common, score


def check_kfdb_kernel(device, mesh) -> tuple[dict, dict]:
    """Phase 16 (a) for kernel AE at each ``KFDB_VOCABS`` size: the kernel
    bit for bit its plain version, its counts the host's and its scores
    within 1e-5 of them (the JAX package's bound, tests/test_dist_kfdb.py:34),
    the world-of-one mirror (``ShardedKFDB``) the kernel's; times.  Returns
    (AE's entry, the scores per size for (b))."""
    from orb_slam3_fast_tpu_torch.parallel import dist_kfdb

    rows, ref = [], {}
    for n_words in KFDB_VOCABS:
        ids, w, q = kfdb_case(np.random.default_rng(n_words), n_words)
        c_host, s_host = host_scores(ids, w, q, n_words)
        lut = torch.from_numpy(np.concatenate([q, np.zeros(1, np.float32)])).to(device)
        ids_d, w_d = torch.from_numpy(ids).to(device), torch.from_numpy(w).to(device)
        ck, sk = dist_kfdb.score_rows(ids_d, w_d, lut)
        cp, sp = dist_kfdb.score_rows_plain(ids_d, w_d, lut)
        c_mesh, s_mesh = dist_kfdb.ShardedKFDB.from_host(mesh, ids, w, n_words).scores(q)
        ck_h, sk_h = ck.cpu().numpy(), sk.cpu().numpy()
        err = float(np.abs(sk_h - s_host).max())
        if not (torch.equal(ck, cp) and torch.equal(sk, sp) and np.array_equal(ck_h, c_host) and err <= 1e-5
                and np.array_equal(c_mesh, ck_h) and np.array_equal(s_mesh, sk_h)):
            raise RuntimeError(f"kfdb_score at {n_words} words: counts / scores off the plain version, the host's "
                               f"(score err {err:.3g}) or the mirror's")
        valid = ids >= 0
        # bytes: each row's ids and weights (8 a slot), the table entries its valid slots read (4 each distinct
        # word), common and score out (8 a row); operations: a lookup, the shared test, min and add (~4 a slot)
        nbytes = ids.size * 8 + 4 * len(np.unique(ids[valid])) + ids.shape[0] * 8
        rows.append(dict(n_words=n_words, err=err, shared=int(c_host.sum()), slots=int(valid.sum()),
                         ms=cuda_ms(lambda: dist_kfdb.score_rows(ids_d, w_d, lut), 50),
                         plain_ms=cuda_ms(lambda: dist_kfdb.score_rows_plain(ids_d, w_d, lut), 5),
                         **bound(nbytes, 4 * ids.size)))
        ref[n_words] = (ids, w, q, ck_h, sk_h)
    base = rows[0]
    entry = dict(name="kfdb_score", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/kfdb_score.cu",
                 replaces="orb_slam3_fast_tpu/parallel/dist_kfdb.py:33", max_abs_err=max(r["err"] for r in rows),
                 library_ms=None, **{k: base[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                 shapes="max_abs_err: scores against the host _scores (tolerance 1e-5), counts equal, bit for bit "
                        "the plain version and the world-of-one mirror; " + "; ".join(
                            f"{KFDB_ROWS} rows x {KFDB_WORDS} slots ({r['slots']} words), {r['n_words']} words: "
                            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.5f}), "
                            f"{r['shared']} shared words" for r in rows) + "; no single library call")
    return entry, ref


def af_problems(device) -> dict:
    """Phase 3's local-BA problem at the mapper's caps (bf 48) and the
    circle's global-BA problem (bf 0), by form."""
    return {"dense": (ba_problem(np.random.default_rng(3), device), 48.0),
            "cg": (gba_problem(np.random.default_rng(11), device), 0.0)}


def af_run(mesh, cam, form: str, prob, bf: float, plain: bool = False):
    """The form's whole distributed BA on this rank's shard of ``prob``:
    (run, shard)."""
    from orb_slam3_fast_tpu_torch.parallel import dist_ba

    if form == "dense":
        return (dist_ba.make_distributed_ba(mesh, cam, bf, iters1=AF_DENSE[0], iters2=AF_DENSE[1], plain=plain),
                dist_ba.shard_problem(prob, mesh, whole=True))
    return (dist_ba.make_distributed_ba_cg(mesh, cam, bf, iters1=AF_CG[0], iters2=AF_CG[1], cg_iters=32,
                                           plain=plain), dist_ba.shard_problem(prob, mesh))


def af_stage_check(mesh, cam, bf: float, shard, form: str) -> dict:
    """One LM iteration of AF's stages from the shard's problem against the
    plain stages on the same inputs: the unrounded sums and W (relative to
    each block's max), the CG solve (relative; the dense run's is kernel F's,
    held in phase 3), and from the kernel's step, and from its negative, the
    state after AC's cost and commit entries against the plain ones (the
    tolerance 1e-5 of AC's), the accepts and the damping equal."""
    from orb_slam3_fast_tpu_torch.parallel import dist_ba

    loc = shard.local
    K, M = loc.R.shape[0], loc.xw.shape[0]
    inl = torch.ones_like(loc.obs_valid)
    state = (loc.R, loc.t, loc.xw)
    acc_k, W_k = dist_ba.blocks_partial(cam, bf, *state, loc, inl)
    acc_p, W_p = dist_ba.blocks_partial_plain(cam, bf, *state, loc, inl)
    parts = [(a, b) for a, b in zip(torch.split(acc_k, dist_ba._sizes(K, M)), torch.split(acc_p, dist_ba._sizes(K, M)))]
    blk = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12) for a, b in parts + [(W_k, W_p)])
    Hpp, Hll, bp, bl, w_lm, cost = dist_ba.round_blocks(mesh.all_reduce(acc_k), K, M)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=loc.R.device)
    solve = 0.0
    if form == "cg":
        dp, dl = dist_ba.cg_solve(mesh, Hpp, Hll, bp, bl, W_k, loc, w_lm, lam, 32)
        pp, pl = dist_ba.cg_solve_plain(mesh, Hpp, Hll, bp, bl, W_k, loc, w_lm, lam, 32)
        solve = max(float((dp - pp).abs().max() / pp.abs().max()), float((dl - pl).abs().max() / pl.abs().max()))
        ok = None
    else:
        dp, dl, ok = dist_ba.dense_solve(Hpp, Hll, bp, bl, mesh.all_gather(W_k), shard.whole, w_lm, lam)
    err, accepts = 0.0, []
    for sign in (1.0, -1.0):
        step = (sign * dp, sign * dl)
        R_c, t_c, x_c, a_k = dist_ba.update_partial(cam, bf, loc, *state, *step, inl)
        k = dist_ba.commit(*state, R_c, t_c, x_c, mesh.all_reduce(a_k), cost, ok, lam)
        R_p, t_p, x_p, a_p = dist_ba.update_partial_plain(cam, bf, loc, *state, *step, inl)
        p = dist_ba.commit_plain(*state, R_p, t_p, x_p, mesh.all_reduce(a_p), cost, ok, lam)
        err = max(err, *(float((a - b).abs().max()) for a, b in zip(k[:3], p[:3])))
        if bool(k[4]) != bool(p[4]) or float(k[3]) != float(p[3]):
            raise RuntimeError(f"ba_shard {form}: accept / damping {bool(k[4])} {float(k[3])} against the plain "
                               f"{bool(p[4])} {float(p[3])}")
        accepts.append(bool(k[4]))
    if not (blk <= 1e-4 and solve <= 1e-4 and err <= 1e-5):
        raise RuntimeError(f"ba_shard {form}: sums {blk:.3g} (tolerance 1e-4), solve {solve:.3g} (1e-4), state "
                           f"{err:.3g} (1e-5) off the plain stages")
    return dict(blocks=blk, solve=solve, state=err, accepts=accepts)


def af_errors(out, ref) -> tuple[float, float]:
    """(rotation entries, translations) max abs differences of two runs."""
    return float((out[0] - ref[0]).abs().max()), float((out[1] - ref[1]).abs().max())


def af_timed(mesh, run, shard, reps: int) -> tuple[float, float]:
    """(ms a run, ms of it in collectives): CUDA events around each run and
    each collective on the current stream, or the host clock where the
    collectives block the host (gloo)."""
    run(shard)
    torch.cuda.synchronize()
    mesh.log.reset()
    mesh.log.timed = True
    t = time.perf_counter()
    ms = cuda_ms(lambda: run(shard), reps, warmup=0)
    host_ms = (time.perf_counter() - t) * 1e3 / reps
    mesh.log.timed = False
    if mesh.log.events and mesh.log.host_s * 1e3 / reps < 0.5 * host_ms:  # NCCL: device time of the collectives
        return ms, mesh.log.ms() / reps
    return host_ms, mesh.log.host_s * 1e3 / reps


def check_af_world1(device, mesh) -> tuple[dict, dict]:
    """Phase 16 (a) for kernel AF in a world of one: each form's stages
    against their plain versions (``af_stage_check``), the whole run against
    the single-device BA (E -> F -> AC, E -> T -> AC) within ``AF_TOL`` and
    against the whole plain run; kernel and collective times.  Returns
    (AF's entry, the runs' (R, t, xw) per form for (b))."""
    from orb_slam3_fast_tpu_torch.cameras.models import Camera

    cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
    rows, ref = {}, {}
    for form, (prob, bf) in af_problems(device).items():
        stages = af_stage_check(mesh, cam, bf, af_run(mesh, cam, form, prob, bf)[1], form)
        run, shard = af_run(mesh, cam, form, prob, bf)
        out = run(shard)
        (plain, plain_ms) = timed(lambda: af_run(mesh, cam, form, prob, bf, plain=True)[0](shard))
        single = single_run(cam, bf, prob, form)
        e_single, e_plain = af_errors(out, single), af_errors(out, plain)
        flips = int((out[3][: prob.obs_kf.shape[0]] != single[3]).sum())
        if not (e_single[0] <= AF_TOL[0] and e_single[1] <= AF_TOL[1] and e_plain[0] <= AF_TOL[0]
                and e_plain[1] <= AF_TOL[1]):
            raise RuntimeError(f"ba_shard {form} run: R / t {e_single} from the single-device BA, {e_plain} from the "
                               f"plain run (tolerance {AF_TOL})")
        ms, coll_ms = af_timed(mesh, run, shard, 5 if form == "dense" else 3)
        K, M, O = prob.R.shape[0], prob.xw.shape[0], prob.obs_kf.shape[0]
        iters = sum(AF_DENSE if form == "dense" else AF_CG)
        e_bytes, u = O * (28 + 72) + K * (48 + 168) + M * (13 + 52), lm_bytes_ops(K, M, O, 60)
        s_bytes, s_ops = pcg_bytes_ops(prob, 32)[:2] if form == "cg" else schur_bytes_ops(prob)
        rows[form] = dict(K=K, M=M, O=O, n_obs=int(prob.obs_valid.sum()), stages=stages, e_single=e_single,
                          e_plain=e_plain, flips=flips, ms=ms, coll_ms=coll_ms, plain_ms=plain_ms,
                          single_ms=cuda_ms(lambda: single_run(cam, bf, prob, form), 3, warmup=1),
                          **bound(iters * (e_bytes + s_bytes + u[0]) + 2 * (O * 27 + K * 48 + M * 12),
                                  iters * (600 * O + s_ops + u[1]) + 2 * 60 * O))
        ref[form] = tuple(x.cpu().numpy() for x in out[:3])
    c = rows["cg"]
    each = "; ".join(
        f"{form} {AF_DENSE if form == 'dense' else AF_CG} LM (K={r['K']}, M={r['M']}, O={r['O']}, {r['n_obs']} live) "
        f"{r['ms']:.3f} ms a run, {r['coll_ms']:.3f} of it in collectives (plain run {r['plain_ms']:.3f}, the "
        f"single-device BA {r['single_ms']:.3f}, bound {r['bound_ms']:.5f}), R / t {r['e_single'][0]:.2e} / "
        f"{r['e_single'][1]:.2e} from the single-device BA, {r['flips']} inlier flags otherwise, "
        f"{r['e_plain'][0]:.2e} / {r['e_plain'][1]:.2e} from the plain run; one iteration's stages: sums "
        f"{r['stages']['blocks']:.2e}, solve {r['stages']['solve']:.2e}, state {r['stages']['state']:.2e}, accepts "
        f"{r['stages']['accepts']}" for form, r in rows.items())
    entry = dict(name="ba_shard", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/ba_shard.cu",
                 replaces="orb_slam3_fast_tpu/parallel/dist_ba.py:210",
                 max_abs_err=max(r["stages"]["state"] for r in rows.values()), library_ms=None,
                 ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                 collective_ms=c["coll_ms"], dense_ms=rows["dense"]["ms"],
                 shapes="max_abs_err: the state after one iteration's cost and commit entries against the plain "
                        "stages' (tolerance 1e-5, the accepts and damping equal); a world of one (NCCL); " + each +
                        "; also dist_ba.py:140 (the dense run); no single library call")
    return entry, ref


def single_run(cam, bf: float, prob, form: str):
    """The single-device BA of the form (E -> F -> AC or E -> T -> AC)."""
    from orb_slam3_fast_tpu_torch.optim import ba, ba_cg

    if form == "dense":
        return ba.bundle_adjust(cam, bf, prob, *AF_DENSE)
    return ba_cg.bundle_adjust_cg(cam, bf, prob, *AF_CG, cg_iters=32)


def _rank_main(rank: int, world: int, tmp: str) -> None:
    """Phase 16 (b), one rank: its shard of AE's rows and of AF's problems
    (the times split into kernels and collectives), then phase 9's loop
    System, synchronous, with every plain epilogue refused; the results
    pickled to ``tmp/rank{rank}.pkl`` (a traceback where it failed)."""
    import os
    import pickle
    import traceback

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    out: dict = {}
    try:
        from orb_slam3_fast_tpu_torch.cameras.models import Camera
        from orb_slam3_fast_tpu_torch.parallel import dist_kfdb, multihost

        multihost.initialize(f"file://{tmp}/gloo_store", world, rank)
        mesh = multihost.global_mesh()
        device = mesh.device
        out["backend"] = multihost.backend()
        with open(f"{tmp}/job.pkl", "rb") as f:
            job = pickle.load(f)
        out["kfdb"] = {n: dist_kfdb.ShardedKFDB.from_host(mesh, ids, w, n).scores(q)
                       for n, (ids, w, q) in job["kfdb"].items()}
        cam = Camera.pinhole(400.0, 400.0, 320.0, 240.0)
        out["af"], out["af_ms"] = {}, {}
        for form, (prob, bf) in af_problems(device).items():
            run, shard = af_run(mesh, cam, form, prob, bf)
            out["af"][form] = tuple(x.cpu().numpy() for x in run(shard)[:3])
            out["af_ms"][form] = af_timed(mesh, run, shard, 2)
        frames = np.load(f"{tmp}/frames.npy", mmap_mode="r")
        poses = circle_trajectory(LOOP_FRAMES, radius=4.0, frac=1.12)
        refused, restore_plain = refuse_plain_functions()
        reset_counts()
        t = time.perf_counter()
        slam, summary, track = run_loop([np.array(f) for f in frames], poses, device)
        out["loop_s"] = time.perf_counter() - t
        summary.pop("kf_at")
        out["counts"] = path_counts("initialization", "projection", "frame_to_frame", "mutual")
        restore_plain()
        if refused:
            raise RuntimeError(f"plain functions ran on CUDA tensors: {sorted(set(refused))}")
        w = slam.tracker.world
        out["summary"] = summary
        out["kf"] = (w.kf_R[: w.n_kf].copy(), w.kf_t[: w.n_kf].copy())
        out["track"] = [(s, np.asarray(R), np.asarray(t)) for s, R, t in track]
        out["collectives"] = mesh.log.calls
    except BaseException:  # noqa: BLE001 -- reported by the parent, which fails the phase
        out["error"] = traceback.format_exc()
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def run_ranks(tmp: str) -> list[dict]:
    """``RANKS`` spawned ranks of ``_rank_main`` on the one card; their
    results, in rank order.  Raises where one failed, did not finish in
    ``RANK_TIMEOUT_S`` (it is killed) or exited nonzero."""
    import multiprocessing
    import pickle

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, RANKS, tmp)) for r in range(RANKS)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + RANK_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    outs = []
    for r, p in enumerate(procs):
        try:
            with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                outs.append(pickle.load(f))
        except FileNotFoundError:
            raise RuntimeError(f"phase 16 (b): rank {r} left no result (exit code {p.exitcode})") from None
        if "error" in outs[-1] or p.exitcode != 0:
            raise RuntimeError(f"phase 16 (b): rank {r} failed (exit code {p.exitcode}):\n{outs[-1].get('error')}")
    return outs


def run_phase16(device, loop_in, loop_summary) -> tuple[list[dict], dict]:
    """Phase 16: (a) a NCCL world of one in this process: AE and AF against
    their plain versions, the host database and the single-device BAs;
    (b) ``RANKS`` gloo ranks spawned on the card: AE's scores bit for bit
    (a)'s, AF's runs in halves within ``AF_TOL`` of (a)'s, the ranks' states
    bit for bit equal, and phase 9's loop System run by every rank
    (phase 9's gates, the loop at phase 9's frame +- 5, the ranks'
    keyframe poses and tracks bit for bit equal, AE and AF launched, T not
    inside the global BA).  Returns (AE's and AF's entries, rank 0's
    launch counts of the System run)."""
    import pickle
    import tempfile

    from orb_slam3_fast_tpu_torch.parallel import multihost

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        multihost.initialize(f"file://{tmp}/nccl_store", 1, 0)
        if multihost.backend() != "nccl":
            raise RuntimeError(f"phase 16 (a): a world of one on one card brought up {multihost.backend()}")
        mesh = multihost.global_mesh(device)
        try:
            ae, kfdb_ref = check_kfdb_kernel(device, mesh)
            af, af_ref = check_af_world1(device, mesh)
        finally:
            torch.distributed.destroy_process_group()
        log(f"16 (a) a NCCL world of one: {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        np.save(f"{tmp}/frames.npy", np.stack([np.asarray(f, np.float32) for f in loop_in]))
        with open(f"{tmp}/job.pkl", "wb") as f:
            pickle.dump({"kfdb": {n: v[:3] for n, v in kfdb_ref.items()}}, f)
        outs = run_ranks(tmp)
        log(f"16 (b) {RANKS} ranks on the card ({outs[0]['backend']}): {time.perf_counter() - t1:.1f} s, the loop "
            f"System {', '.join('%.1f' % o['loop_s'] for o in outs)} s, {outs[0]['collectives']} collectives a rank")
    failures = []
    for n, (ids, w, q, ck, sk) in kfdb_ref.items():
        for r, o in enumerate(outs):
            c, s = o["kfdb"][n]
            if not (np.array_equal(c, ck) and np.array_equal(s, sk)):
                failures.append(f"AE at {n} words: rank {r}'s scores are not (a)'s bit for bit")
    for form, ref in af_ref.items():
        e = af_errors([torch.as_tensor(x) for x in outs[0]["af"][form]], [torch.as_tensor(x) for x in ref])
        if not (e[0] <= AF_TOL[0] and e[1] <= AF_TOL[1]):
            failures.append(f"AF {form} in halves: R / t {e} from (a)'s (tolerance {AF_TOL})")
        if not all(np.array_equal(a, b) for o in outs[1:] for a, b in zip(o["af"][form], outs[0]["af"][form])):
            failures.append(f"AF {form}: the ranks' states differ")
        log(f"16 (b) AF {form} in halves: R / t {e[0]:.2e} / {e[1]:.2e} from (a)'s; a run "
            + ", ".join(f"rank {r} {o['af_ms'][form][0]:.3f} ms ({o['af_ms'][form][1]:.3f} in collectives)"
                        for r, o in enumerate(outs)))
    s0, closed9 = outs[0]["summary"], loop_summary["closed_at"]
    for r, o in enumerate(outs):
        s = o["summary"]
        if not (s["closed_at"] and closed9 and abs(s["closed_at"][0] - closed9[0]) <= 5):
            failures.append(f"rank {r}: the loop closed at {s['closed_at']}, phase 9's at {closed9} (+- 5)")
        if s["gba_launches_T"] or not o["counts"]["kfdb_score"] or not o["counts"]["ba_shard"]:
            failures.append(f"rank {r}: T {s['gba_launches_T']} launches inside the global BA (none allowed), AE "
                            f"{o['counts']['kfdb_score']}, AF {o['counts']['ba_shard']} (some needed)")
        if r and not (all(np.array_equal(a, b) for a, b in zip(o["kf"], outs[0]["kf"])) and
                      all(a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
                          for a, b in zip(o["track"], outs[0]["track"]))):
            failures.append(f"rank {r}: keyframe poses or track not bit for bit rank 0's")
        log(f"16 (b) rank {r}: {s}")
    log(f"launches in 16 (b), rank 0: {outs[0]['counts']}")
    if failures:
        raise RuntimeError("phase 16:\n" + "\n".join(failures))
    af["shapes"] += "; in halves over 2 gloo ranks on the card: " + ", ".join(
        f"{form} {outs[0]['af_ms'][form][0]:.3f} ms a run ({outs[0]['af_ms'][form][1]:.3f} in collectives)"
        for form in af_ref)
    return [ae, af], outs[0]["counts"]


# --- kernel AD: the searches' epilogues (phase 3), the plain epilogues refused on the card (phases 5-15) -------

# each search's stage set after kernel C (ops/matching.py): the threshold (th, < or <=) and the stages
EPILOGUES = {
    "initialization": dict(th=50, ratio=0.9, dedup=True, rotation=True),
    "projection": dict(th=100, ratio=0.8, dedup=True),
    "frame_to_frame": dict(th=100, inclusive=True, dedup=True, rotation=True),
    "mutual": dict(th=50, ratio=0.75, mutual=True),
    "triangulation": dict(th=50, ratio=1.0, mutual=True),
    "stereo": dict(th=75, inclusive=True, mutual=True, stereo=True),
}
EPILOGUE_BF = 40.0  # bf of the constructed stereo cases
# the stage set that each search's AD launch counts under (ops/hamming.stage_set)
STAGE_SETS = {"initialization": "lt+ratio+dedup+rotation", "projection": "lt+ratio+dedup",
              "frame_to_frame": "le+dedup+rotation", "mutual": "lt+ratio+mutual", "triangulation": "lt+ratio+mutual",
              "stereo": "le+mutual+stereo"}
# the plain epilogue functions (ops/hamming.py), made to raise on a CUDA tensor in phases 5-14
EPILOGUE_PLAIN = ("ratio_gate", "mutual_consistency", "resolve_duplicate_targets", "rotation_consistency",
                  "median_prune", "_median", "match_epilogue_plain")
# kernel M's plain unprojection and verdict (ops/twoview.py), refused on the card in phases 5-15 as well
TWOVIEW_PLAIN = ("_camera_plane", "_verdict")


def epilogue_call(kind: str, b, m: int, col=None, angles=None, stereo=None) -> tuple:
    """(b, th, keyword arguments) of ``match_epilogue`` for a search of
    ``kind`` over ``m`` columns."""
    e = EPILOGUES[kind]
    kw = dict(inclusive=e.get("inclusive", False), ratio=e.get("ratio"))
    if e.get("mutual"):
        kw["col"] = col
    if e.get("dedup"):
        kw["dedup_m"] = m
    if e.get("rotation"):
        kw["angles"] = angles
    if e.get("stereo"):
        kw["stereo"] = stereo
    return b, e["th"], kw


def epilogue_case(rng, kind: str, n: int, m: int, ties: bool = False) -> dict:
    """Host inputs of kernel AD for a search of ``kind``: the best-2 (idx,
    dist, dist2), the column argmin, the angles and the keypoints' x.

    Seeded (``ties`` False): random best-2 over few columns (dedup
    collisions), 10% of the rows without a candidate (INF_DIST, idx 0), every
    7th row a copy of the previous row's target and distance, rows whose
    distance is exactly the ratio times the second, half the rows mutual,
    angle differences on bin centres, on bin edges and negative; stereo
    distances with fractional penalties.

    Tie-heavy (``ties`` True, even n >= 48): the dedup's equal distances and
    a lower one on duplicated columns; rotation counts 10 and 10 (the tie
    goes to the lower bin), then 1 and 1 (exactly 0.1x the first: the third
    place's tie goes to the lower bin, which is kept); in stereo every slot
    accepted, the middle pair 29.5 and 30.5 (median 30) and distances at
    and beside the 2.1x cut, which float32 puts below 63."""
    two_pi = 2.0 * np.pi
    idx = rng.integers(0, m, n)
    dist = rng.integers(0, 110, n).astype(np.float64)
    dist2 = dist + rng.integers(0, 30, n)
    edge = np.arange(n) % 11 == 5  # dist = ratio * dist2 in exact arithmetic; float32's product decides
    dist2[edge] = 20.0 * rng.integers(1, 6, int(edge.sum()))
    dist[edge] = np.round(EPILOGUES[kind].get("ratio", 0.8) * dist2[edge])
    none = rng.uniform(size=n) < 0.1
    dup = np.arange(1, n, 7)
    idx[dup], dist[dup] = idx[dup - 1], dist[dup - 1]
    col = rng.integers(0, n, m)
    mutual = np.nonzero(rng.uniform(size=n) < 0.5)[0]
    col[idx[mutual]] = mutual
    bins = rng.choice([2, 3, 3, 3, 17, 17, 29], n) + rng.choice([0.0, 0.0, 0.5, -0.5, 0.49], n)
    delta = bins * (two_pi / 30) - two_pi * (np.arange(n) % 3 == 0)
    if ties:
        idx = np.arange(n) % 40
        dist = 10.0 + np.arange(n) % 5
        dist[40:] = dist[idx[40:]]
        dist[40:48] -= 1.0  # a lower distance takes columns 0-7 from rows 0-7
        dist[idx >= 22] = 120.0  # rejected by every threshold
        dist2 = np.full(n, 100.0)
        col_bin = np.full(40, 25)
        col_bin[:10], col_bin[10:20], col_bin[20], col_bin[21] = 3, 7, 12, 20
        delta = col_bin[idx] * (two_pi / 30) - two_pi * (idx % 2)
        none[:] = False
        col = np.arange(m) % n
        col[idx[:40]] = np.arange(40)
    angle_b = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    angle_a = (angle_b[idx] + delta).astype(np.float32)
    if kind == "stereo":
        dist = rng.integers(0, 90, n) + rng.choice([0.0, 0.25, 0.5, 3.0, 7.75], n)
        if ties:  # every slot accepted: a permutation, mutual, below th
            idx = rng.permutation(m)[:n]
            col = rng.integers(0, n, m)
            col[idx] = np.arange(n)
            cut = float(np.float32(2.1) * np.float32(30.0))  # 62.99999619
            low = [1.0, 2.5, 3.0, 5.25, 7.0, 9.0, 11.0, 29.5]
            high = [30.5, 35.0, 40.0, 62.5, cut, 63.0, float(np.nextafter(np.float32(63), np.float32(99))), 70.0]
            dist = rng.permutation(np.array(low + high + [29.0, 31.0] * ((n - 16) // 2)))  # middle pair 29.5, 30.5
    xl = rng.uniform(100, 600, n)
    xr = rng.uniform(50, 600, m)
    xr[idx] = xl - rng.uniform(0.3, 40, n)  # disparities below 1 are clamped to 1
    idx[none], dist[none], dist2[none] = 0, 10000.0, 10000.0
    f32 = np.float32
    return dict(idx=idx.astype(np.int64), dist=dist.astype(f32), dist2=np.maximum(dist2, dist).astype(f32),
                col=col.astype(np.int64), angle_a=angle_a, angle_b=angle_b,
                xy_l=np.stack([xl, rng.uniform(0, 480, n)], 1).astype(f32),
                xy_r=np.stack([xr, rng.uniform(0, 480, m)], 1).astype(f32))


def epilogue_inputs(case: dict, kind: str, device) -> tuple:
    """``epilogue_call``'s (b, th, keyword arguments) from ``epilogue_case``'s
    host inputs, on ``device``: int32 distances but in stereo, as kernel C
    gives them."""
    from orb_slam3_fast_tpu_torch.ops import hamming as ham

    t = {k: torch.as_tensor(v).to(device) for k, v in case.items()}
    dt = torch.float32 if kind == "stereo" else torch.int32
    b = ham.Best2(t["idx"], t["dist"].to(dt), t["dist2"].to(dt), t["idx"])
    return epilogue_call(kind, b, case["angle_b"].shape[0], col=t["col"], angles=(t["angle_a"], t["angle_b"]),
                         stereo=(t["xy_l"], t["xy_r"], EPILOGUE_BF))


def epilogue_bytes(kind: str, b, th: float, kw: dict) -> int:
    """The bytes kernel AD must move for a search, counted on its inputs:
    per row idx (8), dist (4), dist2 (4) only with the ratio test, and accept
    written (1); the column argmin's low word (4) at each distinct target of
    the rows that pass the threshold; the angles (4) of the rows left after
    the dedup and of their distinct targets; in stereo the x (4) of the rows
    left after the mutual check and of their distinct targets, and right u
    and depth written (8 a row)."""
    from orb_slam3_fast_tpu_torch.ops import hamming as ham

    e = EPILOGUES[kind]
    n = b.idx.shape[0]
    nbytes = (17 if e.get("ratio") else 13) * n + (8 * n if e.get("stereo") else 0)
    if e.get("ratio"):
        live = ham.ratio_gate(b, kw["ratio"], th)
    else:
        live = b.dist <= th if kw["inclusive"] else b.dist < th
    targets = lambda: int(torch.unique(b.idx[live]).numel())  # noqa: E731
    if e.get("mutual"):
        nbytes += 4 * targets()
        live = live & ham.mutual_consistency(b.idx, kw["col"])
    if e.get("dedup"):
        live = ham.resolve_duplicate_targets(b.idx, b.dist, live, kw["dedup_m"])
    if e.get("rotation") or e.get("stereo"):
        nbytes += 4 * (int(live.sum()) + targets())
    return nbytes


def epilogues_equal(kernel, plain) -> bool:
    """The kernel's outputs equal the plain version's, bit for bit."""
    if isinstance(plain, torch.Tensor):
        return torch.equal(kernel, plain)
    return all(torch.equal(a, b) for a, b in zip(kernel, plain))


def search_best2(device) -> dict:
    """Kernel C's outputs at the searches' shapes, as ``epilogue_call``'s
    arguments: stereo 1024 x 1024, projection 4096 x 1024, frame-to-frame
    1024 x 1024 (frame 0's keypoints at their place one frame later, 15 px
    times their scale), on the 640x480 step scene's frames 0 and 1;
    initialisation (window 100 at level 0), mutual and epipolar 768 x 768 on
    two corridor frames."""
    from orb_slam3_fast_tpu_torch.frontend.tracker import visible_landmarks
    from orb_slam3_fast_tpu_torch.ops import extractor as ext
    from orb_slam3_fast_tpu_torch.ops import hamming as ham
    from orb_slam3_fast_tpu_torch.ops import matching as mat

    rig = Rig(640, 480)
    cfg = ext.ExtractorConfig(n_features=1024)
    step, lm, canvas = setup(rig, device, seed=1)
    i0, _ = frame(canvas, rig, 0, device)
    il, ir = frame(canvas, rig, 1, device)
    kp0, kp, kp_r = ext.extract(i0, cfg), ext.extract(il, cfg), ext.extract(ir, cfg)
    f32 = torch.float32
    sgate = ham.StereoGate(
        kp.xy[:, 0].contiguous(), kp.xy[:, 1].contiguous(), kp.level.to(f32), kp.valid.to(f32),
        kp_r.xy[:, 0].contiguous(), kp_r.xy[:, 1].contiguous(), (2.0 * step.slot_scales).contiguous(),
        kp_r.level.to(f32), kp_r.valid.to(f32), rig.bf / step.min_z)
    uv, pred, vis = visible_landmarks(
        step.cam, torch.eye(3, device=device), torch.as_tensor(rig.t_true(1), device=device), lm.pos, lm.mask,
        lm.normal, lm.dmin, lm.dmax, (rig.w, rig.h))
    wgate = ham.WindowGate(
        uv[:, 0].contiguous(), uv[:, 1].contiguous(), 3.0 * mat._pow_level(pred, step.scales), pred.to(f32),
        vis.to(f32), kp.xy[:, 0].contiguous(), kp.xy[:, 1].contiguous(), kp.level.to(f32), kp.valid.to(f32))
    shifted = kp0.xy + torch.tensor([-float(SHIFT), 0.0], device=device)
    fgate = ham.WindowGate(
        shifted[:, 0].contiguous(), shifted[:, 1].contiguous(), 15.0 * mat._pow_level(kp0.level, step.scales),
        kp0.level.to(f32), kp0.valid.to(f32), kp.xy[:, 0].contiguous(), kp.xy[:, 1].contiguous(), kp.level.to(f32),
        kp.valid.to(f32))
    (kp_a, kp_b), F_ab, sigma2 = corridor_keypoints(device)
    xa = torch.cat([kp_a.xy, torch.ones_like(kp_a.xy[:, :1])], 1)
    lines = xa @ F_ab.T
    egate = ham.EpipolarGate(lines[:, 0].contiguous(), lines[:, 1].contiguous(), lines[:, 2].contiguous(),
                             lines[:, 0] ** 2 + lines[:, 1] ** 2, kp_a.valid.to(f32), kp_b.xy[:, 0].contiguous(),
                             kp_b.xy[:, 1].contiguous(), 3.84 * mat._pow_level(kp_b.level, sigma2), kp_b.valid.to(f32))
    mgate = ham.MutualGate(kp_a.valid.to(f32), kp_b.valid.to(f32))
    igate = ham.WindowGate(
        kp_a.xy[:, 0].contiguous(), kp_a.xy[:, 1].contiguous(), torch.full_like(kp_a.xy[:, 0], 100.0),
        torch.zeros_like(kp_a.xy[:, 0]), (kp_a.valid & (kp_a.level == 0)).to(f32), kp_b.xy[:, 0].contiguous(),
        kp_b.xy[:, 1].contiguous(), kp_b.level.to(f32), (kp_b.valid & (kp_b.level == 0)).to(f32))
    out = {}
    b, col = ham.hamming_best2(kp.desc, kp_r.desc, sgate)
    out["stereo"] = epilogue_call("stereo", b, kp_r.n, col=col, stereo=(kp.xy, kp_r.xy, rig.bf))
    out["projection"] = epilogue_call("projection", ham.hamming_best2(lm.desc, kp.desc, wgate)[0], kp.n)
    out["frame_to_frame"] = epilogue_call("frame_to_frame", ham.hamming_best2(kp0.desc, kp.desc, fgate)[0], kp.n,
                                          angles=(kp0.angle, kp.angle))
    out["initialization"] = epilogue_call("initialization", ham.hamming_best2(kp_a.desc, kp_b.desc, igate)[0],
                                          kp_b.n, angles=(kp_a.angle, kp_b.angle))
    for kind, gate in (("mutual", mgate), ("triangulation", egate)):
        b, col = ham.hamming_best2(kp_a.desc, kp_b.desc, gate)
        out[kind] = epilogue_call(kind, b, kp_b.n, col=col)
    return out


def compare_epilogue_kernel(device) -> list[dict]:
    """Phase 3 for kernel AD: at every search's stage set, on kernel C's
    outputs at the searches' shapes (``search_best2``) and on a seeded and a
    tie-heavy constructed input (``epilogue_case``, 1024 rows; the
    tie-heavy stereo one every slot accepted, so the median's sort runs),
    the masks, right u and depth equal to ``match_epilogue_plain``'s bit for
    bit; CUDA-event times of both, the bound (bytes at the memory rate) and
    the launches of the timed loop.  Returns AD's entry."""
    from orb_slam3_fast_tpu_torch.ops import hamming as ham

    t0 = time.perf_counter()
    rng = np.random.default_rng(14)
    rows, notes, nbytes = [], [], 0
    for kind, (b, th, kw) in search_best2(device).items():
        cases = [("search", b, th, kw)] + [
            (label, *epilogue_inputs(epilogue_case(rng, kind, 1024, 1024, ties), kind, device))
            for label, ties in (("seeded", False), ("tie-heavy", True))]
        for label, bb, tt, kk in cases:
            k, p = ham.match_epilogue(bb, tt, **kk), ham.match_epilogue_plain(bb, tt, **kk)
            torch.cuda.synchronize()
            if not epilogues_equal(k, p):
                raise RuntimeError(f"match_epilogue {kind} ({label}) differs from its plain version")
            acc = k[2] if isinstance(k, tuple) else k
            notes.append(f"{kind} {label} {int(acc.sum())}/{acc.shape[0]} accepted")
        n, m = b.idx.shape[0], kw.get("dedup_m") or (kw["col"].shape[0] if kw.get("col") is not None else n)
        ham.match_epilogue.launches.reset()
        ms = cuda_ms(lambda: ham.match_epilogue(b, th, **kw), 100)
        launches = ham.match_epilogue.launches.total()
        plain_ms = cuda_ms(lambda: ham.match_epilogue_plain(b, th, **kw), 20)
        nb = epilogue_bytes(kind, b, th, kw)
        nbytes += nb
        rows.append(dict(kind=kind, n=n, m=m, ms=ms, plain_ms=plain_ms, launches=launches, **bound(nb, 20 * n)))
    ham.match_epilogue.launches.reset()
    each = "; ".join(f"{r['kind']} {r['n']}x{r['m']} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
                     f"{r['bound_ms']:.3e} by {r['bound_by']}, {r['launches']} launches for 102 calls)" for r in rows)
    log(f"kernel match_epilogue rows: {each}; {', '.join(notes)}; {time.perf_counter() - t0:.1f} s")
    return [dict(name="match_epilogue", route="cuda", source="orb_slam3_fast_tpu_torch/csrc/match_epilogue.cu",
                 replaces="orb_slam3_fast_tpu/ops/hamming.py:72", max_abs_err=0.0,
                 ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
                 **bound(nbytes, 20 * sum(r["n"] for r in rows)), library_ms=None,
                 shapes=f"the six searches' stage sets, summed, tolerance exact (masks, right u and depth bit for "
                        f"bit, also on a seeded and a tie-heavy input each): {each}; no single library call")]


def refuse_plain_functions():
    """Make every plain epilogue function (``EPILOGUE_PLAIN``, ops/hamming.py)
    and kernel M's plain unprojection and verdict (``TWOVIEW_PLAIN``,
    ops/twoview.py) raise on a CUDA tensor, and pass CPU tensors through;
    returns (the refusals seen, a function that restores them)."""
    from orb_slam3_fast_tpu_torch.ops import hamming as ham
    from orb_slam3_fast_tpu_torch.ops import twoview

    saved = {(mod, name): getattr(mod, name) for mod, names in ((ham, EPILOGUE_PLAIN), (twoview, TWOVIEW_PLAIN))
             for name in names}
    refused: list = []

    def on_cuda(x) -> bool:
        if isinstance(x, torch.Tensor):
            return x.device.type == "cuda"
        return isinstance(x, (tuple, list)) and any(on_cuda(y) for y in x)

    def refusing(name, fn):
        def call(*args, **kw):
            if on_cuda(args) or on_cuda(list(kw.values())):
                refused.append(name)
                raise RuntimeError(f"{name}, a plain version, ran on a CUDA tensor")
            return fn(*args, **kw)
        return call

    for (mod, name), fn in saved.items():
        setattr(mod, name, refusing(name, fn))

    def restore():
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)

    return refused, restore


def stage_split(rig: Rig, device) -> dict:
    """Per-stage CUDA-event times of the step on one frame."""
    from orb_slam3_fast_tpu_torch.ops import extractor as ext
    from orb_slam3_fast_tpu_torch.optim import pose_opt
    from orb_slam3_fast_tpu_torch.utils import lie

    step, lm, canvas = setup(rig, device, seed=2)
    il, ir = frame(canvas, rig, 0, device)
    T0 = lie.SE3.identity(device)
    kp, right_u = step.front(il, ir)
    idx, accept = step.match_map(kp, T0, lm)
    obs = step.pose_obs(kp, right_u, idx, accept, lm)
    t_ext = cuda_ms(lambda: (ext.extract(il, step.cfg), ext.extract(ir, step.cfg)), 10)
    t_front = cuda_ms(lambda: step.front(il, ir), 10)
    t_map = cuda_ms(lambda: step.match_map(kp, T0, lm), 20)
    t_obs = cuda_ms(lambda: step.pose_obs(kp, right_u, idx, accept, lm), 20)
    t_pose = cuda_ms(lambda: pose_opt.pose_optimization(step.cam, step.bf, T0, obs), 20)
    return {"extract_x2_ms": t_ext, "stereo_match_refine_ms": t_front - t_ext,
            "visibility_projection_match_ms": t_map, "pose_obs_ms": t_obs, "pose_opt_ms": t_pose}


WRAPPER_NAMES = ("fast_nms", "orb_describe", "hamming_best2", "pose_lm", "ba_blocks", "ba_schur", "triangulate_dlt",
                 "pyramid_blur", "select_subpixel", "stereo_subpixel_refine", "visible_landmarks", "twoview_ransac",
                 "vocab_transform", "pnp_ransac", "sim3_ransac", "sim3_refine", "sim3_graph", "ba_pcg", "sim3_pcg",
                 "imu_preint", "pose_inertial", "imu_init", "vi_ba", "pose_graph4", "vi_pcg", "fisheye_stereo",
                 "ba_lm_update", "ba_classify", "match_epilogue", "kfdb_score", "ba_shard")
VI_KERNELS = ("imu_preint", "pose_inertial", "imu_init", "vi_ba")  # V, W, X, Y: the inertial path
LM_KERNELS = ("ba_lm_update", "ba_classify")  # AC's two entries: wherever a BA runs
# the stereo System runs A-L and AC, N to index its keyframes, and not M or P
SYSTEM_KERNELS = WRAPPER_NAMES[:11] + LM_KERNELS
STEP_KERNELS = ("fast_nms", "orb_describe", "hamming_best2", "pose_lm", "pyramid_blur", "select_subpixel",
                "stereo_subpixel_refine", "visible_landmarks")
# the RGB-D path runs every kernel but J; G only where triangulation finds
# matches, which the RGB-D gates do not require
RGBD_KERNELS = ("fast_nms", "orb_describe", "hamming_best2", "pose_lm", "ba_blocks", "ba_schur", "pyramid_blur",
                "select_subpixel", "visible_landmarks", "vocab_transform", *LM_KERNELS)
# mono: no stereo match (J) and no PnP unless lost; relocalisation: PnP and the BoW of the lost frame
MONO_KERNELS = ("fast_nms", "orb_describe", "hamming_best2", "pose_lm", "ba_blocks", "ba_schur", "triangulate_dlt",
                "pyramid_blur", "select_subpixel", "visible_landmarks", "twoview_ransac", "vocab_transform",
                *LM_KERNELS)
RELOC_KERNELS = MONO_KERNELS + ("pnp_ransac",)
# loop closing: Q, R, S, T on top of the mono path (E in every BA, N for the queries and the keyframes)
LOOP_KERNELS = MONO_KERNELS + ("sim3_ransac", "sim3_refine", "sim3_graph", "ba_pcg")
# the wrappers that count a mode: kernel C's four, kernels S and U behind one wrapper, and the distorted camera's
# instances of D, E, Q, R and AC
MODES = {"sim3_graph": "dense", "sim3_pcg": "pcg"}
RADTAN_KERNELS = ("pose_lm", "ba_blocks", "sim3_ransac", "sim3_refine", "twoview_ransac", *LM_KERNELS)


def wrappers() -> dict:
    """Each kernel's wrapper, by the kernel's name (S and U share one; AF's
    entries share one counter)."""
    from orb_slam3_fast_tpu_torch.frontend import tracker as trk
    from orb_slam3_fast_tpu_torch.imu import preintegration as pre
    from orb_slam3_fast_tpu_torch.ops import extractor as ext
    from orb_slam3_fast_tpu_torch.ops import fast, image
    from orb_slam3_fast_tpu_torch.ops import hamming as ham
    from orb_slam3_fast_tpu_torch.ops import matching as mat
    from orb_slam3_fast_tpu_torch.ops import twoview
    from orb_slam3_fast_tpu_torch.optim import ba, ba_cg, imu_init, inertial, pnp, pose_opt, sim3, vi_ba, vi_ba_cg
    from orb_slam3_fast_tpu_torch.optim import pose_graph as pg
    from orb_slam3_fast_tpu_torch.parallel import dist_ba, dist_kfdb
    from orb_slam3_fast_tpu_torch.vocab import vocabulary as voc_mod

    return dict(zip(WRAPPER_NAMES, (fast.fast_nms, ext.orb_describe, ham.hamming_best2, pose_opt.pose_optimization,
                                    ba.build_normal_blocks, ba.schur_solve, twoview.triangulate_dlt,
                                    image.pyramid_blur, ext.select_subpixel, mat.stereo_subpixel_refine,
                                    trk.visible_landmarks, twoview.reconstruct, voc_mod.transform,
                                    pnp.pnp_ransac, sim3.sim3_ransac, sim3.optimize_sim3, pg.optimize_sim3_graph,
                                    ba_cg.implicit_schur_solve, pg.optimize_sim3_graph, pre.preintegrate,
                                    inertial.pose_inertial_optimization, imu_init.inertial_only_optimization,
                                    vi_ba.vi_bundle_adjust, pg.optimize_4dof_graph, vi_ba_cg.lm_segment_vi,
                                    mat.fisheye_stereo_gate, ba.lm_update, ba.classify, ham.match_epilogue,
                                    dist_kfdb.score_rows, dist_ba.blocks_partial)))


def reset_counts() -> None:
    for w in wrappers().values():
        w.launches.reset()


def read_counts() -> dict:
    """Launches since the last reset, by kernel, by kernel C's mode and
    kernel AD's stage set, of D, E, Q, R and AC with a distorted camera, of
    D, E, L, P, W, Y and AC with a KB8 camera, and by thread where a run
    launched from more than the main thread."""
    from orb_slam3_fast_tpu_torch.ops import hamming as ham

    from orb_slam3_fast_tpu_torch.optim.sim3 import FREE_SCALE

    ws = wrappers()
    counts = {name: w.launches.total(mode=MODES.get(name)) for name, w in ws.items()}
    counts.update({f"hamming_best2[{m}]": ham.hamming_best2.launches.total(mode=m) for m in ham.MODE_NAMES})
    counts.update({f"match_epilogue[{s}]": ham.match_epilogue.launches.total(mode=s) for s in STAGE_SETS.values()})
    counts.update({f"{n}[radtan]": ws[n].launches.total(camera="radtan") for n in RADTAN_KERNELS})
    counts.update({f"{n}[kb8]": ws[n].launches.total(camera="kb8") for n in KB8_KERNELS})
    counts.update({f"{n}[kb8, free scale]": ws[n].launches.total(mode=FREE_SCALE, camera="kb8")
                   for n in ("sim3_ransac", "sim3_refine")})
    for name, w in ws.items():
        by_thread = w.launches.by_thread()
        if set(by_thread) - {"MainThread"}:
            counts[f"{name}[threads]"] = by_thread
    return counts


def path_counts(*searches: str) -> dict:
    """``read_counts`` after a path's run.  Raises unless kernel AC's update
    launched once for every launch of kernel E, in each camera instance and
    on each thread (every LM iteration of both BA forms is E -> F or T ->
    AC), and its gate at least once where E launched; unless kernel AD
    launched once for every launch of kernel C that kernel AB does not
    follow, on each thread (every search but the fisheye match is C -> AD);
    and unless AD launched in the stage set of each of ``searches`` (keys of
    ``STAGE_SETS``), the searches the path is known to run."""
    from orb_slam3_fast_tpu_torch.ops import hamming as ham
    from orb_slam3_fast_tpu_torch.ops import matching as mat

    counts = read_counts()
    paired = [f"ba_lm_update{k}" for k in ("", "[radtan]", "[kb8]", "[threads]")
              if counts.get(f"ba_lm_update{k}") != counts.get(f"ba_blocks{k}")]
    if paired or (counts["ba_blocks"] and not counts["ba_classify"]):
        raise RuntimeError(f"kernel AC not launched wherever kernel E was: {paired or 'ba_classify'} ({counts})")
    c, ab, ad = (w.launches.by_thread() for w in (ham.hamming_best2, mat.fisheye_stereo_gate, ham.match_epilogue))
    unpaired = {t: (n, ab.get(t, 0), ad.get(t, 0)) for t, n in c.items() if ad.get(t, 0) != n - ab.get(t, 0)}
    missing = [s for s in searches if counts[f"match_epilogue[{STAGE_SETS[s]}]"] < 1]
    if unpaired or set(ad) - set(c) or missing:
        raise RuntimeError(f"kernel AD: not launched once per search (thread: C, AB, AD {unpaired}), or never in the "
                           f"stage sets of {missing} ({counts})")
    return counts


def main() -> int:
    """Every phase, the scenes rendered on a pool of worker processes
    (``render_pool``), which exit with it."""
    with render_pool():
        return run_phases()


def run_phases() -> int:
    t_start = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    device = torch.device("cuda", 0)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # 2. build
    from orb_slam3_fast_tpu_torch import _kernels

    t0 = time.perf_counter()
    _, nvcc_out = _kernels.build()  # a fresh checkout has no library yet: this compiles
    _kernels.lib()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s (one nvcc per source, in parallel; {' '.join(_kernels.NVCC_FLAGS)})")
    for line in nvcc_out.splitlines():
        if line.startswith("==") or "registers" in line or ("spill" in line and "0 bytes spill" not in line):
            log(f"  ptxas {line.strip()}")
    from orb_slam3_fast_tpu_torch import native

    t0 = time.perf_counter()
    host_lib = native.get_lib()  # built at first use otherwise: inside the System's first tracked frame
    log(f"host map library: {'g++, loaded' if host_lib else 'unavailable, numpy fallback'} "
        f"in {time.perf_counter() - t0:.1f} s")

    # 3. each kernel against its plain version
    t0 = time.perf_counter()
    warm_library(device)
    part_s = {}  # each comparison's seconds

    def part(fn):
        t = time.perf_counter()
        out = fn(device)
        part_s[fn.__name__] = round(time.perf_counter() - t, 1)
        return out

    kernels = part(compare_kernels)
    system_kernels, c_modes = part(compare_system_kernels)
    kernels += system_kernels + part(compare_mono_kernels) + part(compare_loop_kernels) + part(compare_vi_kernels)
    kernels += part(compare_inertial_loop_kernels)
    fisheye_kernels, kb8 = part(compare_fisheye_kernels)
    kernels += fisheye_kernels + part(compare_lm_kernels) + part(compare_epilogue_kernel)
    for k in kernels:
        if k["name"] in kb8:
            k["kb8"] = kb8[k["name"]]
    e_entry, t_entry = (next(k for k in kernels if k["name"] == name) for name in ("ba_blocks", "ba_pcg"))
    e_entry["shapes"] += t_entry.pop("e_gba")
    c = next(k for k in kernels if k["name"] == "hamming_best2")
    for mode, r in c_modes.items():
        for key in ("ms", "plain_ms", "nbytes", "ops"):
            c[key] += r[key]
        c["shapes"] += (f", {mode} {r['n']}x{r['m']} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
                        f"{r['accepted']} rows with a candidate)")
    c.update(bound(c.pop("nbytes"), c.pop("ops")))
    for k in kernels:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        log(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3g}, {k['ms']:.4f} ms vs plain "
            f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.5f} ms ({k['bound_by']}), library call {lib} "
            f"({k['shapes']})")
        for inst in ("radtan", "kb8"):
            if inst in k:
                q = k[inst]
                lib = "" if q.get("library_ms") is None else f", library call {q['library_ms']:.4f} ms"
                log(f"kernel {k['name']} [{inst}]: max_abs_err {q['max_abs_err']:.3g}, {q['ms']:.4f} ms vs plain "
                    f"{q['plain_ms']:.4f} ms, bound {q['bound_ms']:.5f} ms ({q['bound_by']}){lib} ({q['shapes']})")
        for stage, by_kind in k.get("stages", {}).items():
            log(f"kernel {k['name']} stage {stage}: " + "; ".join(
                f"{inst} {q['ms']:.4f} ms vs plain {q['plain_ms']:.4f} ms, bound {q['bound_ms']:.3e} ms "
                f"({q['bound_by']})" for inst, q in by_kind.items()))
    phase3_s = time.perf_counter() - t0
    log(f"phase 3: {phase3_s:.1f} s ({part_s})")

    # 4. the tracking step at both sizes: its path, with the launch counts
    t0 = time.perf_counter()
    rigs = [Rig(640, 480), Rig(1280, 720)]
    scenes = [setup(rig, device) for rig in rigs]
    reset_counts()
    results = {(rig.w, rig.h): track(rig, *scene, device) for rig, scene in zip(rigs, scenes)}
    step_launches = path_counts("stereo", "projection")
    for rig in rigs:
        check_sequence(rig, results[(rig.w, rig.h)])
    missing = [n for n in STEP_KERNELS if step_launches[n] < 1]
    if missing:
        raise RuntimeError(f"kernels of the step's path never launched: {missing} ({step_launches})")
    for (w, h), rows in results.items():
        ms = [r[4] for r in rows if r[4] is not None]
        log(f"step {w}x{h}: {len(rows)} frames, matches {min(r[0] for r in rows)}-{max(r[0] for r in rows)}, "
            f"inliers {min(r[1] for r in rows)}-{max(r[1] for r in rows)}, max |dt| "
            f"{max(r[2] for r in rows):.3g} m (bound {Rig(w, h).z / Rig(w, h).fx:.3g}), "
            f"step {np.mean(ms):.3f} ms mean / {np.median(ms):.3f} median over {len(ms)} frames "
            f"({1e3 / np.mean(ms):.1f} fps); per frame ms {[round(x, 3) for x in ms]}")
    log(f"launches in the step's run: {step_launches}")
    for (w, h) in results:
        split = stage_split(Rig(w, h), device)
        log(f"stages {w}x{h}: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")

    # phases 5-15 on the card: every plain epilogue function refuses a CUDA tensor (each search is C -> AD), and so
    # do kernel M's plain unprojection and verdict
    refused, restore_plain = refuse_plain_functions()

    # 5. the stereo System with local mapping: its path, with the launch counts
    t0 = time.perf_counter()
    frames, poses = corridor_frames(SYS_FRAMES)
    log(f"System scene: {SYS_FRAMES} stereo pairs rendered on the host in {time.perf_counter() - t0:.1f} s")
    reset_counts()
    t1 = time.perf_counter()
    card_run = run_system(frames, poses, device)
    slam, summary, _ = card_run
    sys_s = time.perf_counter() - t1
    sys_launches = path_counts("stereo", "projection", "frame_to_frame", "triangulation")
    missing = [n for n in (*SYSTEM_KERNELS, "vocab_transform", "hamming_best2[epipolar]") if sys_launches[n] < 1]
    if missing or sys_launches["twoview_ransac"] or sys_launches["pnp_ransac"]:
        raise RuntimeError(f"the System's path: kernels never launched {missing}, or M or P launched ({sys_launches})")
    spans, mspans = slam.timers.spans, slam.mapper.timers.spans
    log(f"System: {summary}, {sys_s:.2f} s for {SYS_FRAMES} frames")
    log(f"System track_total ms per frame: {[round(x, 3) for x in spans['track_total']]}")
    log(f"System map_local_ba ms per keyframe: {[round(x, 3) for x in mspans['map_local_ba']]}")
    log("System stage means:\n" + slam.print_time_stats())
    log(f"launches in the System's run: {sys_launches}")
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")

    # 6. the RGB-D System: its path, with the launch counts
    t0 = time.perf_counter()
    rgbd_in, rgbd_poses = rgbd_frames(RGBD_FRAMES)
    log(f"RGB-D scene: {RGBD_FRAMES} images and depth maps rendered on the host in {time.perf_counter() - t0:.1f} s")
    reset_counts()
    t1 = time.perf_counter()
    rgbd_run = run_system(rgbd_in, rgbd_poses, device, "rgbd")
    slam_d, summary_d, _ = rgbd_run
    rgbd_s = time.perf_counter() - t1
    rgbd_launches = path_counts("projection", "frame_to_frame")
    missing = [n for n in RGBD_KERNELS if rgbd_launches[n] < 1]
    if missing or any(rgbd_launches[n] for n in ("stereo_subpixel_refine", "twoview_ransac", "pnp_ransac")):
        raise RuntimeError(f"the RGB-D path: kernels never launched {missing}, or J, M or P launched ({rgbd_launches})")
    spans, mspans = slam_d.timers.spans, slam_d.mapper.timers.spans
    log(f"RGB-D System: {summary_d}, {rgbd_s:.2f} s for {RGBD_FRAMES} frames (gates: > 20 tracked, ATE < 0.40 m, "
        f">= {RGBD_MIN_KF} keyframes, >= {RGBD_MIN_BA} local BAs)")
    log(f"RGB-D track_total ms per frame: {[round(x, 3) for x in spans['track_total']]}")
    log(f"RGB-D map_local_ba ms per keyframe: {[round(x, 3) for x in mspans.get('map_local_ba', [])]}")
    log("RGB-D stage means:\n" + slam_d.print_time_stats())
    log(f"launches in the RGB-D System's run: {rgbd_launches}")
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")

    # 7. the monocular System, then relocalisation: their paths, with the launch counts
    t0 = time.perf_counter()
    mono_in, mono_poses = mono_frames(MONO_FRAMES)
    log(f"mono scene: {MONO_FRAMES} images rendered on the host in {time.perf_counter() - t0:.1f} s")
    reset_counts()
    t1 = time.perf_counter()
    mono_run = run_mono(mono_in, mono_poses, device)
    slam_m, summary_m, _ = mono_run
    mono_s = time.perf_counter() - t1
    mono_launches = path_counts("initialization", "projection", "frame_to_frame", "triangulation")
    missing = [n for n in (*MONO_KERNELS, "hamming_best2[window]") if mono_launches[n] < 1]
    if missing or mono_launches["vocab_transform"] < summary_m["n_kf"] or mono_launches["pnp_ransac"]:
        raise RuntimeError(f"the mono path: kernels never launched {missing}, N fewer times than keyframes, or P "
                           f"launched ({mono_launches})")
    spans, mspans = slam_m.timers.spans, slam_m.mapper.timers.spans
    log(f"mono System: {summary_m}, {mono_s:.2f} s for {MONO_FRAMES} frames (gates: final OK, > 30 tracked, >= 3 "
        "keyframes, > 200 landmarks, scale-aligned ATE < 0.15 m; the JAX tracker on the CPU: init at frame 5, 35 "
        "tracked, 16 keyframes, 926 landmarks, ATE 0.0078 m)")
    log(f"mono track_total ms per frame: {[round(x, 3) for x in spans['track_total']]}")
    log(f"mono map_local_ba ms per keyframe after initialisation: {[round(x, 3) for x in mspans.get('map_local_ba', [])]}")
    log("mono stage means:\n" + slam_m.print_time_stats())
    log(f"launches in the mono System's run: {mono_launches}")
    reset_counts()
    t1 = time.perf_counter()
    reloc_track, reloc_ms, reloc_sum = run_reloc(mono_in, mono_poses, device)
    reloc_launches = path_counts("mutual")
    missing = [n for n in RELOC_KERNELS if reloc_launches[n] < 1]
    if missing:
        raise RuntimeError(f"the relocalisation path: kernels never launched {missing} ({reloc_launches})")
    log(f"relocalisation: {reloc_sum}, the revisit of frame {RELOC_REVISIT} relocalised in {reloc_ms:.3f} ms "
        f"(track_total), {time.perf_counter() - t1:.2f} s for the scenario")
    log(f"launches in the relocalisation run: {reloc_launches}")
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")

    # 9. loop closing and the Atlas on the card (run before the host replicas of phase 8, whose host
    # threads would slow it): their paths, with the launch counts
    t0 = time.perf_counter()
    loop_in, loop_poses = loop_frames()
    log(f"loop scene: {LOOP_FRAMES} images rendered on the host in {time.perf_counter() - t0:.1f} s")
    reset_counts()
    t1 = time.perf_counter()
    loop_run = run_loop(loop_in, loop_poses, device)
    slam_l, summary_l, _ = loop_run
    loop_kf_at = summary_l.pop("kf_at")
    loop_s = time.perf_counter() - t1
    loop_launches = path_counts("initialization", "projection", "frame_to_frame", "mutual")
    missing = [n for n in LOOP_KERNELS if loop_launches[n] < 1]
    if missing or summary_l["gba_launches_F"] or summary_l["gba_launches_T"] < 1:
        raise RuntimeError(f"the loop path: kernels never launched {missing}, or F launched inside the global BA, or "
                           f"T not ({summary_l}, {loop_launches})")
    spans, mspans, lspans = slam_l.timers.spans, slam_l.mapper.timers.spans, slam_l.loopcloser.timers.spans
    closing = int(np.argmax(spans["track_total"]))
    log(f"loop scenario: {summary_l}, {loop_s:.2f} s for {LOOP_FRAMES} frames (gates: final OK, > 120 tracked, >= 1 "
        "loop, scale-aligned ATE < 0.20 m)")
    log(f"loop track_total ms per frame: {[round(x, 3) for x in spans['track_total']]}")
    log(f"loop-closure frame {closing}: track_total {spans['track_total'][closing]:.3f} ms; " +
        ", ".join(f"{k} {v[-1]:.3f} ms" for k, v in lspans.items() if k != "loop_detect" and k != "loop_verify") +
        f"; loop_detect {sum(lspans.get('loop_detect', [])):.3f} ms and loop_verify "
        f"{sum(lspans.get('loop_verify', [])):.3f} ms over the run ({len(lspans.get('loop_verify', []))} verifications)")
    log("loop stage means:\n" + slam_l.print_time_stats())
    log(f"launches in the loop run: {loop_launches}")
    reset_counts()
    t1 = time.perf_counter()
    _, summary_a, _ = run_loop(loop_in, loop_poses, device, blackout=ATLAS_BLACKOUT)
    summary_a.pop("kf_at")
    atlas_launches = path_counts("projection", "frame_to_frame", "mutual")
    log(f"Atlas scenario: {summary_a}, {time.perf_counter() - t1:.2f} s (gates: >= 2 maps, >= 1 merge, final OK, > 100 "
        "frames OK, ATE of trajectory_world < 0.5)")
    log(f"launches in the Atlas run: {atlas_launches}")
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")

    # 10. the default constructor (run before phase 8, as phase 9 is): (a) the async stereo System, (b) the async
    # mono System on the loop circle at 20 fps, (c) the sync loop scenario with the graph forced to kernel U,
    # (d) the mono System with a distorted camera, (e) a global BA on an async backend's GBA thread
    t0 = time.perf_counter()
    from orb_slam3_fast_tpu_torch.optim import pose_graph as pg

    reset_counts()
    slam_a, summary_a10, _ = run_default_stereo(frames, poses, device)
    launches_a10 = path_counts("stereo", "projection", "frame_to_frame")
    kinds = {"keyframe": [ms for i, ms in enumerate(slam_a.timers.spans["track_total"]) if i in summary_a10["kf_frames"]],
             "ordinary": [ms for i, ms in enumerate(slam_a.timers.spans["track_total"])
                          if i not in summary_a10["kf_frames"]]}
    log(f"10 (a) default stereo System (async): {summary_a10} (gates: drained in 120 s, no error, final OK, >= 3 "
        "overlapped, > 25 tracked, ATE < 0.25 m)")
    log("10 (a) track_total ms by kind: " + "; ".join(f"{k} {[round(x, 3) for x in v]}" for k, v in kinds.items()))
    log(f"10 (a) map_local_ba ms: {[round(x, 3) for x in slam_a.mapper.timers.spans.get('map_local_ba', [])]}")
    log(f"launches in 10 (a): {launches_a10}")
    reset_counts()
    slam_b, summary_b10, _ = run_default_loop(loop_in, loop_poses, device)
    launches_b10 = path_counts("initialization", "projection", "frame_to_frame")
    spans_b = slam_b.timers.spans["track_total"]
    kinds = {"keyframe": [ms for i, ms in enumerate(spans_b) if i in summary_b10["kf_frames"]],
             "ordinary": [ms for i, ms in enumerate(spans_b) if i not in summary_b10["kf_frames"]]}
    log(f"10 (b) default mono System on the loop circle at 20 fps (async): {summary_b10} (gates: drained in 120 s, no "
        f"error, >= {ASYNC_LOOP_MIN_TRACKED} tracked, scale-aligned ATE <= {ASYNC_LOOP_MAX_ATE} m; the final state, "
        "loops, global BAs and T on slam-gba reported)")
    log("10 (b) track_total ms by kind: " + "; ".join(
        f"{k} n={len(v)} mean {np.mean(v):.3f} median {np.median(v):.3f} max {np.max(v):.3f}" for k, v in kinds.items()))
    log(f"10 (b) track_total ms per frame: {[round(x, 3) for x in spans_b]}")
    log("10 (b) backend stage means:\n" + slam_b.print_time_stats())
    log(f"launches in 10 (b): {launches_b10}")
    check_default_loop(summary_b10)
    reset_counts()
    pg._FORCE_CG = True
    loop_snap = {}  # the map just before the first loop correction (phase 9's: the runs repeat up to there)
    try:
        slam_c, summary_c10, _ = run_loop(loop_in, loop_poses, device, snapshot=loop_snap)
    finally:
        pg._FORCE_CG = False
    summary_c10.pop("kf_at")
    launches_c10 = path_counts("projection", "mutual")
    graph_ms = slam_c.loopcloser.timers.spans["loop_essential_graph"]
    if launches_c10["sim3_pcg"] < 1 or launches_c10["sim3_graph"] or summary_c10["closed_at"] != summary_l["closed_at"]:
        raise RuntimeError(f"10 (c): U launched {launches_c10['sim3_pcg']}, S {launches_c10['sim3_graph']}, loop closed "
                           f"at {summary_c10['closed_at']} (phase 9: {summary_l['closed_at']})")
    log(f"10 (c) loop scenario with the graph forced to kernel U (sync): {summary_c10} (gates: U launched, S not, "
        f"closed at phase 9's frames {summary_l['closed_at']}, ATE < 0.20 m); loop_essential_graph "
        f"{[round(x, 3) for x in graph_ms]} ms (phase 9, kernel S: "
        f"{[round(x, 3) for x in lspans['loop_essential_graph']]})")
    log(f"launches in 10 (c): {launches_c10}")
    loop_fix = correct_from_snapshot(loop_snap, device, loop_system)
    log(f"9 the loop scenario's first correction (keyframe {loop_snap['args'][0]} <-> {loop_snap['args'][1]}) rerun "
        f"on the card from its snapshot (kernel S): {loop_fix.n_kf} keyframes")
    dist_settings = distorted_mono_settings()
    dist_in, _ = mono_frames(MONO_FRAMES, cam=dist_settings.cam)
    reset_counts()
    dist_run = run_mono(dist_in, mono_poses, device, settings=dist_settings)
    launches_d10 = path_counts("initialization", "projection", "frame_to_frame")
    missing = [n for n in (*MONO_KERNELS, "pose_lm[radtan]", "ba_blocks[radtan]", "ba_lm_update[radtan]",
                           "ba_classify[radtan]", "twoview_ransac[radtan]") if launches_d10[n] < 1]
    if missing:
        raise RuntimeError(f"10 (d): the distorted mono path never launched {missing} ({launches_d10})")
    log(f"10 (d) mono System with EuRoC cam0's distortion: {dist_run[1]} (phase 7's gates)")
    log(f"launches in 10 (d): {launches_d10}")
    reset_counts()
    summary_e10 = run_gba_thread(slam_l)
    launches_e10 = path_counts()
    log(f"10 (e) the GBA thread: a global BA over phase 9's loop map on slam-gba: {summary_e10} (gates: drained in 120 "
        "s, completed, not aborted, no error, T on slam-gba alone, F not)")
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")

    # 11. the inertial System, synchronous, no loop closing (run before phase 8 too): (a) mono-inertial on
    # test_vi_tracker.py's arc, (b) stereo-inertial on the stereo corridor with the same IMU stream
    t0 = time.perf_counter()
    vi_runs = {}
    for sensor in ("monocular", "stereo"):
        t1 = time.perf_counter()
        vi_in = vi_frames(sensor)
        log(f"11 {sensor}-inertial scene: {VI_FRAMES} frames rendered on the host in {time.perf_counter() - t1:.1f} s")
        reset_counts()
        t1 = time.perf_counter()
        run = run_vi(*vi_in, device, sensor)
        launches = path_counts("projection")
        vi_runs[sensor] = (vi_in, run, launches)
        check_vi(sensor, run[1], launches)
        spans = run[0].timers.spans
        log(f"11 ({'a' if sensor == 'monocular' else 'b'}) {sensor}-inertial System: {run[1]}, "
            f"{time.perf_counter() - t1:.2f} s for {VI_FRAMES} frames (gates: {VI_GATES[sensor]})")
        log(f"11 {sensor}-inertial track_total ms per frame: {[round(x, 3) for x in spans['track_total']]}")
        log(f"launches in the {sensor}-inertial run: {launches}")
    # the third inertial sensor on the card: the RGB-D-inertial System tracks the RGB-D corridor with the IMU
    # stream, preintegrating every frame (no IMU initialisation within its keyframes)
    t1 = time.perf_counter()
    vi_in = vi_frames("rgbd", VI_RGBD_FRAMES)
    reset_counts()
    _, summary_r, _ = run_vi(*vi_in, device, "rgbd")
    launches_r = path_counts("projection")
    if not (summary_r["state"] == "OK" and summary_r["tracked"] == VI_RGBD_FRAMES
            and launches_r["imu_preint"] >= VI_RGBD_FRAMES - 1):
        raise RuntimeError(f"rgbd-inertial System: {summary_r}, V launched {launches_r['imu_preint']} times")
    log(f"11 rgbd-inertial System: {summary_r}, {time.perf_counter() - t1:.2f} s with the render (gates: final OK, "
        f"every frame tracked, V launched on every frame after the first)")
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")

    # 12. inertial loop closing (before phase 8 too): (a) the stereo-inertial System with loop closing on the
    # circle, (b) its first correction rerun on the card from a snapshot, (c) the default inertial constructor,
    # (d) MergeInertialBA on the welded map
    t0 = time.perf_counter()
    vil_in = vi_loop_frames()
    log(f"12 stereo-inertial circle: {LOOP_FRAMES} stereo pairs rendered on the host in {time.perf_counter() - t0:.1f} s")
    reset_counts()
    t1 = time.perf_counter()
    slam_v, summary_v, snapshot = run_vi_loop(*vil_in, device)
    vil_s = time.perf_counter() - t1
    launches_vil = path_counts("projection", "mutual")
    check_vi_loop(summary_v, launches_vil)
    spans, lspans = slam_v.timers.spans, slam_v.loopcloser.timers.spans
    closing = int(np.argmax(spans["track_total"]))
    log(f"12 (a) stereo-inertial System with loop closing: {summary_v}, {vil_s:.2f} s for {LOOP_FRAMES} frames "
        f"(gates: final OK, > 120 tracked, IMU initialised, >= 1 loop, unscaled ATE < {VI_LOOP_MAX_ATE} m; Z and AA "
        "launched, S, U, T not)")
    log(f"12 (a) track_total ms per frame: {[round(x, 3) for x in spans['track_total']]}")
    log(f"12 (a) slowest frame {closing}: {spans['track_total'][closing]:.3f} ms; loop spans: " +
        ", ".join(f"{k} {[round(x, 3) for x in v]}" for k, v in lspans.items() if k not in ("loop_detect", "loop_verify")))
    log(f"launches in 12 (a): {launches_vil}")
    reset_counts()
    card_fix = correct_from_snapshot(snapshot, device)
    log(f"12 (b) the first loop correction (keyframe {snapshot['args'][0]} <-> {snapshot['args'][1]}) rerun on the card "
        f"from its snapshot: {card_fix.n_kf} keyframes")
    reset_counts()
    slam_c, summary_c = run_default_vi(*vi_runs["stereo"][0], device)
    launches_vic = path_counts("projection")
    on_tracker = {n: wrappers()[n].launches.total(thread="MainThread") for n in VI_KERNELS}
    if min(on_tracker.values()) < 1:
        raise RuntimeError(f"12 (c): V-Y on the tracker thread {on_tracker}")
    log(f"12 (c) default stereo-inertial System (async) on phase 11 (b)'s corridor at 20 fps: {summary_c} (gates: "
        f"drained in 120 s, no error, IMU initialised; V-Y on the tracker thread {on_tracker})")
    log(f"launches in 12 (c): {launches_vic}")
    reset_counts()
    summary_d = run_merge_inertial(device)
    launches_vid = path_counts()
    if launches_vid["vi_ba"] < 1:
        raise RuntimeError(f"12 (d): Y never launched ({launches_vid})")
    log(f"12 (d) MergeInertialBA on the welded map: {summary_d} (gates: the window over both sides, position error "
        "halved, velocities < 0.06 m/s, biases < 0.02, the weld's velocity < 0.15 m/s)")
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")

    # 13. the fisheye rig (before phase 8 too): (a) the stereo System on the TUM-VI configuration, (c) relocalisation
    # on (a)'s map, (b) the stereo-inertial System with the body's IMU stream
    t0 = time.perf_counter()
    fe_in, fe_poses, _ = fisheye_frames(FISHEYE_FRAMES)
    log(f"13 fisheye scene: {FISHEYE_FRAMES} 512x512 KB8 stereo pairs rendered on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    reset_counts()
    t1 = time.perf_counter()
    fe_run = run_fisheye(fe_in, fe_poses, device)
    slam_f, summary_f, _ = fe_run
    fe_s = time.perf_counter() - t1
    launches_fe = path_counts("projection", "frame_to_frame")
    check_fisheye(summary_f, launches_fe)
    log(f"13 (a) fisheye stereo System (TUM-VI configuration): {summary_f}, {fe_s:.2f} s for {FISHEYE_FRAMES} frames "
        f"(gates: final OK, > 20 tracked, unscaled ATE < {FISHEYE_MAX_ATE} m, |scale - 1| < {FISHEYE_MAX_SCALE_ERR}; "
        "AB, C mutual, D, E and L in KB8 launched; J, M, Q-U, Z and AA not)")
    log(f"13 (a) track_total ms per frame: {[round(x, 3) for x in slam_f.timers.spans['track_total']]}")
    log(f"13 (a) map_local_ba ms per keyframe: {[round(x, 3) for x in slam_f.mapper.timers.spans['map_local_ba']]}")
    log("13 (a) stage means:\n" + slam_f.print_time_stats())
    log(f"launches in 13 (a): {launches_fe}")
    reset_counts()
    fe_reloc_track, fe_reloc_ms, fe_reloc_sum = run_fisheye_reloc(slam_f, fe_in, fe_poses, device)
    launches_fr = path_counts("mutual")
    if launches_fr["pnp_ransac[kb8]"] < 1 or launches_fr["fisheye_stereo"] < 1:
        raise RuntimeError(f"13 (c): P in KB8 or AB never launched ({launches_fr})")
    log(f"13 (c) fisheye relocalisation on (a)'s map: {fe_reloc_sum}, the revisit of frame {FISHEYE_REVISIT} "
        f"relocalised in {fe_reloc_ms:.3f} ms (track_total; gates: RECENTLY_LOST after 3 blank pairs, OK on the "
        "revisit within 0.3 m, P in KB8 launched)")
    log(f"launches in 13 (c): {launches_fr}")
    t1 = time.perf_counter()
    fv_in, fv_poses, fv_imu = fisheye_frames(FISHEYE_VI_FRAMES, imu=True)
    reset_counts()
    t2 = time.perf_counter()
    _, summary_fv, _ = run_fisheye(fv_in, fv_poses, device, imu=fv_imu)
    launches_fv = path_counts("projection")
    check_fisheye(summary_fv, launches_fv, inertial=True)
    log(f"13 (b) fisheye stereo-inertial System: {summary_fv}, {time.perf_counter() - t2:.2f} s for "
        f"{FISHEYE_VI_FRAMES} frames ({t2 - t1:.1f} s to render; gates: {FISHEYE_VI_GATES})")
    log(f"launches in 13 (b): {launches_fv}")
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")

    # 14. loop closing on the fisheye rig (before phase 8 too): (a) the stereo System with loop closing on the circle
    # seen by the TUM-VI rig, (b) the stereo-inertial one, each first correction rerun on the card from its snapshot,
    # (c) the default constructors at 20 fps; the frames rendered once for all three
    t0 = time.perf_counter()
    fl_in, fl_poses, fl_imu = fisheye_loop_frames()
    log(f"14 fisheye circle: {LOOP_FRAMES} 512x512 KB8 stereo pairs rendered on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    fl_runs = {}
    for sensor, part in (("stereo", "a"), ("stereo-inertial", "b")):
        reset_counts()
        t1 = time.perf_counter()
        slam_fl, summary_fl, snap_fl = run_fisheye_loop(fl_in, fl_poses, fl_imu, device, sensor)
        fl_s = time.perf_counter() - t1
        launches_fl = path_counts("projection", "mutual")
        check_fisheye_loop(sensor, summary_fl, launches_fl)
        spans, lspans = slam_fl.timers.spans, slam_fl.loopcloser.timers.spans
        closing = int(np.argmax(spans["track_total"]))
        log(f"14 ({part}) fisheye {sensor} System with loop closing: {summary_fl}, {fl_s:.2f} s for {LOOP_FRAMES} "
            f"frames (gates: {FISHEYE_LOOP_GATES[sensor]})")
        log(f"14 ({part}) track_total ms per frame: {[round(x, 3) for x in spans['track_total']]}")
        log(f"14 ({part}) slowest frame {closing}: {spans['track_total'][closing]:.3f} ms; loop spans: " +
            ", ".join(f"{k} {[round(x, 3) for x in v]}" for k, v in lspans.items()
                      if k not in ("loop_detect", "loop_verify")))
        log(f"launches in 14 ({part}): {launches_fl}")
        make = functools.partial(fisheye_loop_system, sensor)
        card_fl = correct_from_snapshot(snap_fl, device, make)
        log(f"14 ({part}) the first loop correction (keyframe {snap_fl['args'][0]} <-> {snap_fl['args'][1]}) rerun "
            f"on the card from its snapshot: {card_fl.n_kf} keyframes")
        fl_runs[sensor] = (launches_fl, snap_fl, card_fl, make)
    for sensor, part in (("stereo", "c"), ("stereo-inertial", "c")):
        reset_counts()
        t1 = time.perf_counter()
        summary_flc = run_default_fisheye(fl_in, fl_imu, device, sensor)
        log(f"14 (c) default fisheye {sensor} System (async) on the circle at 20 fps: {summary_flc}, "
            f"{time.perf_counter() - t1:.1f} s (gates: drained in 120 s, no error" +
            (", IMU initialised" if sensor == "stereo-inertial" else "") + "; loops reported)")
        log(f"launches in 14 (c) {sensor}: {path_counts('projection')}")
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")

    # 15. the monocular KB8 rig (before phase 8 too), TUM-VI's cam0 alone on the images phases 13 and 14 rendered:
    # (a) the monocular System on 13 (a)'s corridor, (b) the monocular-inertial one on 13 (b)'s arc, (c) the
    # monocular System with loop closing on 14's circle, its first correction rerun on the card from its snapshot,
    # (d) the two default constructors at 20 fps on the circle
    t0 = time.perf_counter()
    fm_in, fmv_in, flm_in = ([pair[0] for pair in pairs] for pairs in (fe_in, fv_in, fl_in))
    reset_counts()
    t1 = time.perf_counter()
    fm_run = run_fisheye_mono(fm_in, fe_poses, device)
    fm_s = time.perf_counter() - t1
    launches_fm = path_counts("initialization", "projection", "frame_to_frame", "triangulation")
    check_fisheye_mono("a", fm_run[1], launches_fm)
    log(f"15 (a) fisheye monocular System (TUM-VI cam0): {fm_run[1]}, {fm_s:.2f} s for {FISHEYE_FRAMES} frames (gates: "
        f"{FISHEYE_MONO_GATES['a']})")
    log_frame_kinds("15 (a)", fm_run[0], fm_run[1])
    log(f"launches in 15 (a): {launches_fm}")
    reset_counts()
    t1 = time.perf_counter()
    fmv_run = run_fisheye_mono(fmv_in, fv_poses, device, imu=fv_imu)
    launches_fmv = path_counts("projection")
    check_fisheye_mono("b", fmv_run[1], launches_fmv)
    log(f"15 (b) fisheye monocular-inertial System: {fmv_run[1]}, {time.perf_counter() - t1:.2f} s for "
        f"{FISHEYE_VI_FRAMES} frames (gates: {FISHEYE_MONO_GATES['b']})")
    log_frame_kinds("15 (b)", fmv_run[0], fmv_run[1])
    log(f"launches in 15 (b): {launches_fmv}")
    reset_counts()
    t1 = time.perf_counter()
    slam_flm, summary_flm, snap_flm = run_fisheye_mono_loop(flm_in, fl_poses, device)
    launches_flm = path_counts("initialization", "projection", "mutual")
    check_fisheye_mono("c", summary_flm, launches_flm)
    spans, lspans = slam_flm.timers.spans, slam_flm.loopcloser.timers.spans
    closing = int(np.argmax(spans["track_total"]))
    log(f"15 (c) fisheye monocular System with loop closing: {summary_flm}, {time.perf_counter() - t1:.2f} s for "
        f"{LOOP_FRAMES} frames (gates: {FISHEYE_MONO_GATES['c']})")
    log(f"15 (c) track_total ms per frame: {[round(x, 3) for x in spans['track_total']]}")
    log(f"15 (c) slowest frame {closing}: {spans['track_total'][closing]:.3f} ms; loop spans: " +
        ", ".join(f"{k} {[round(x, 3) for x in v]}" for k, v in lspans.items() if k not in ("loop_detect", "loop_verify")))
    log(f"launches in 15 (c): {launches_flm}")
    make_flm = functools.partial(fisheye_mono_system, "monocular", loop=True)
    card_flm = correct_from_snapshot(snap_flm, device, make_flm)
    log(f"15 (c) the first loop correction (keyframe {snap_flm['args'][0]} <-> {snap_flm['args'][1]}) rerun on the card "
        f"from its snapshot: {card_flm.n_kf} keyframes")
    for sensor in ("monocular", "monocular-inertial"):
        reset_counts()
        t1 = time.perf_counter()
        summary_fmd = run_default_fisheye(flm_in, fl_imu, device, sensor)
        log(f"15 (d) default fisheye {sensor} System (async) on the circle at 20 fps: {summary_fmd}, "
            f"{time.perf_counter() - t1:.1f} s (gates: drained in 120 s, no error; loops and the IMU reported)")
        log(f"launches in 15 (d) {sensor}: {path_counts('projection')}")
    phase15_s = time.perf_counter() - t0
    log(f"phase 15: {phase15_s:.1f} s")
    restore_plain()
    if refused:
        raise RuntimeError(f"plain functions ran on CUDA tensors in phases 5-15: {sorted(set(refused))}")
    log(f"phases 5-15: no plain epilogue function ({', '.join(EPILOGUE_PLAIN)}) and neither of kernel M's plain "
        f"stages ({', '.join(TWOVIEW_PLAIN)}) ran on a CUDA tensor")

    # 16. several ranks (before phase 8 too): (a) a NCCL world of one here, kernels AE and AF against their plain
    # versions, the host database and the single-device BAs; (b) two gloo ranks spawned on the card: AE and AF in
    # halves, then phase 9's loop System run by both
    t0 = time.perf_counter()
    ranks_kernels, ranks_launches = run_phase16(device, loop_in, summary_l)
    for k in ranks_kernels:
        log(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3g}, {k['ms']:.4f} ms vs plain {k['plain_ms']:.4f} "
            f"ms, bound {k['bound_ms']:.5f} ms ({k['bound_by']}) ({k['shapes']})")
    kernels += ranks_kernels
    phase16_s = time.perf_counter() - t0
    log(f"phase 16: {phase16_s:.1f} s")

    # 8. the plain (CPU) step, which the tests hold against the JAX package,
    # agrees with the card on frame 1 at 640x480.  Last, because the host
    # threads it starts would slow the timed phases above.
    t8 = time.perf_counter()
    rig, cpu = Rig(640, 480), torch.device("cpu")
    rows_cpu = track(rig, *setup(rig, cpu), cpu, n_frames=2)
    m_g, n_g = results[(640, 480)][1][:2]
    m_c, n_c, et_c = rows_cpu[1][0], rows_cpu[1][1], rows_cpu[1][2]
    if abs(m_g - m_c) > 0.05 * m_c or abs(n_g - n_c) > 0.05 * n_c or et_c > rig.z / rig.fx:
        raise RuntimeError(f"card vs plain step: matches {m_g}/{m_c}, inliers {n_g}/{n_c}, cpu |dt| {et_c}")
    log(f"plain step on the host, frame 1 at 640x480: matches {m_c} (card {m_g}), inliers {n_c} (card {n_g})")
    # every path's plain host run against its card run; all are logged before any failure raises
    failures = []
    reloc_fork = {"at": RELOC_FRAMES}  # the relocalisation run goes on from the mono run's state after frame 29
    for label, card, plain_run in (
        ("stereo System", card_run, lambda: run_system(frames, poses, cpu)),
        ("mono System", mono_run, lambda: run_mono(mono_in, mono_poses, cpu, fork=reloc_fork)),
    ):
        t0 = time.perf_counter()
        bad, summary = check_system_against_plain(card, plain_run())
        log(f"plain {label} on the host against the card: {summary}, {len(bad)} failing "
            f"({time.perf_counter() - t0:.1f} s)")
        failures += [f"{label} {b}" for b in bad]
    for label, card, n, plain_run in (  # the prefixes of HOST_PREFIX
        ("RGB-D System", rgbd_run, HOST_PREFIX["rgbd"],
         lambda n: run_system(rgbd_in[:n], rgbd_poses[:n], cpu, "rgbd", check=False)),
        ("distorted mono System", dist_run, HOST_PREFIX["distorted mono"],
         lambda n: run_mono(dist_in[:n], mono_poses[:n], cpu, settings=dist_settings, check=False)),
    ):
        t0 = time.perf_counter()
        bad, summary = check_prefix_against_plain(card, plain_run(n), n)
        log(f"plain {label} on the host against the card, its first {n} frames: {summary}, {len(bad)} failing "
            f"({time.perf_counter() - t0:.1f} s)")
        failures += [f"{label} {b}" for b in bad]
    t0 = time.perf_counter()  # 9: the loop scenario's first LOOP_HOST_PREFIX frames, then its first correction
    n = LOOP_HOST_PREFIX
    _, sum_p, track_p = run_loop(loop_in[:n], loop_poses[:n], cpu, check=False)
    bad, summary = compare_tracks(loop_run[2][:n], track_p, LOOP_DT, LOOP_DR)
    if loop_kf_at[n - 1] != sum_p["n_kf"]:
        bad.append(f"keyframes after frame {n - 1}: card {loop_kf_at[n - 1]} vs plain {sum_p['n_kf']}")
    log(f"plain loop scenario on the host against the card, its first {n} frames: {summary}; keyframes "
        f"{loop_kf_at[n - 1]} / {sum_p['n_kf']}, {len(bad)} failing ({time.perf_counter() - t0:.1f} s)")
    failures += [f"loop scenario {b}" for b in bad]
    t0 = time.perf_counter()
    bad, summary = compare_corrections(loop_fix, correct_from_snapshot(loop_snap, cpu, loop_system),
                                       (LOOP_DT, LOOP_DR, VI_CORRECTION_BOUNDS[2]))
    log(f"9 the loop scenario's first correction from the snapshot, the host's plain path against the card: {summary}"
        f" (bounds {LOOP_DT, LOOP_DR}), {len(bad)} failing ({time.perf_counter() - t0:.1f} s)")
    failures += [f"loop correction {b}" for b in bad]
    for sensor, (vi_in, run, _) in vi_runs.items():  # 11 (c): the inertial Systems against their host runs
        t0 = time.perf_counter()
        n = VI_HOST_PREFIX[sensor]
        frames_n, poses_n, imu_n = vi_in[0][:n], vi_in[1][:n], vi_in[2]
        bad, summary = check_prefix_against_plain(run, run_vi(frames_n, poses_n, imu_n, cpu, sensor), n,
                                              VI_BOUNDS[sensor])
        log(f"11 (c) plain {sensor}-inertial System on the host against the card: {summary}, {len(bad)} failing "
            f"({time.perf_counter() - t0:.1f} s)")
        failures += [f"{sensor}-inertial System {b}" for b in bad]
    t0 = time.perf_counter()  # 12 (b): the loop correction from the snapshot on the host
    bad, summary = compare_corrections(card_fix, correct_from_snapshot(snapshot, cpu))
    log(f"12 (b) the loop correction from the snapshot, the host's plain path against the card: {summary} (bounds "
        f"{VI_CORRECTION_BOUNDS}), {len(bad)} failing ({time.perf_counter() - t0:.1f} s)")
    failures += [f"12 (b) loop correction {b}" for b in bad]
    for sensor, (_, snap_fl, card_fl, make) in fl_runs.items():  # 14 (a), (b): the corrections on the host
        t0 = time.perf_counter()
        bad, summary = compare_corrections(card_fl, correct_from_snapshot(snap_fl, cpu, make))
        log(f"14 ({'a' if sensor == 'stereo' else 'b'}) the fisheye {sensor} loop correction from the snapshot, the "
            f"host's plain path against the card: {summary} (bounds {VI_CORRECTION_BOUNDS}), {len(bad)} failing "
            f"({time.perf_counter() - t0:.1f} s)")
        failures += [f"14 fisheye {sensor} loop correction {b}" for b in bad]
    t0 = time.perf_counter()  # 13 (a): the fisheye stereo System's first HOST_PREFIX["fisheye"] frames on the host
    n = HOST_PREFIX["fisheye"]
    bad, summary = check_prefix_against_plain(fe_run, run_fisheye(fe_in[:n], fe_poses[:n], cpu), n, FISHEYE_BOUNDS)
    log(f"13 (a) plain fisheye stereo System on the host against the card, its first {n} frames: {summary}, "
        f"{len(bad)} failing ({time.perf_counter() - t0:.1f} s)")
    failures += [f"fisheye stereo System {b}" for b in bad]
    t0 = time.perf_counter()  # 15 (a): the fisheye monocular System on the host
    bad, summary = check_system_against_plain(fm_run, run_fisheye_mono(fm_in, fe_poses, cpu), *FISHEYE_BOUNDS)
    log(f"15 (a) plain fisheye monocular System on the host against the card: {summary}, {len(bad)} failing "
        f"({time.perf_counter() - t0:.1f} s)")
    failures += [f"fisheye monocular System {b}" for b in bad]
    t0 = time.perf_counter()  # 15 (b): the monocular-inertial one over its frames before the first loss
    n = next((i for i, (st, _, _) in enumerate(fmv_run[2]) if st in ("RECENTLY_LOST", "LOST")), len(fmv_in))
    bad, summary = check_prefix_against_plain(fmv_run, run_fisheye_mono(fmv_in[:n], fv_poses[:n], cpu, imu=fv_imu), n,
                                          VI_BOUNDS["monocular"])
    log(f"15 (b) plain fisheye monocular-inertial System on the host against the card, its first {n} frames (up to "
        f"the first loss): {summary}, {len(bad)} failing ({time.perf_counter() - t0:.1f} s)")
    failures += [f"fisheye monocular-inertial System {b}" for b in bad]
    t0 = time.perf_counter()  # 15 (c): the loop correction from the snapshot on the host
    bad, summary = compare_corrections(card_flm, correct_from_snapshot(snap_flm, cpu, make_flm))
    log(f"15 (c) the fisheye monocular loop correction from the snapshot, the host's plain path against the card: "
        f"{summary} (bounds {VI_CORRECTION_BOUNDS}), {len(bad)} failing ({time.perf_counter() - t0:.1f} s)")
    failures += [f"15 (c) loop correction {b}" for b in bad]
    t0 = time.perf_counter()
    plain_reloc, _, plain_reloc_sum = run_reloc(mono_in, mono_poses, cpu, fork=reloc_fork)
    bad, summary = compare_tracks(reloc_track, plain_reloc)
    if plain_reloc_sum["ref_kf"] != reloc_sum["ref_kf"]:
        bad.append(f"card {reloc_sum} vs plain {plain_reloc_sum}")
    log(f"plain relocalisation on the host against the card: {summary}; relocalisation keyframe "
        f"{reloc_sum['ref_kf']} / {plain_reloc_sum['ref_kf']}, {len(bad)} failing ({time.perf_counter() - t0:.1f} s)")
    failures += [f"relocalisation {b}" for b in bad]
    phase8_s = time.perf_counter() - t8
    log(f"phase 8: {phase8_s:.1f} s")
    if failures:
        raise RuntimeError("card against the plain host runs:\n" + "\n".join(failures))

    # results: launches are those of the run whose path runs the kernel: the
    # stereo System for A-L, the mono System for M and N, relocalisation for
    # P; every path's beside them
    runs = {"step": step_launches, "stereo_system": sys_launches, "rgbd_system": rgbd_launches,
            "mono_system": mono_launches, "relocalisation": reloc_launches, "loop": loop_launches,
            "atlas": atlas_launches, "default_stereo": launches_a10, "default_loop": launches_b10,
            "loop_pcg": launches_c10, "distorted_mono": launches_d10, "gba_thread": launches_e10,
            "vi_mono": vi_runs["monocular"][2], "vi_stereo": vi_runs["stereo"][2], "vi_rgbd": launches_r,
            "vi_loop": launches_vil, "default_vi": launches_vic, "merge_inertial": launches_vid,
            "fisheye": launches_fe, "fisheye_reloc": launches_fr, "fisheye_vi": launches_fv,
            "fisheye_loop": fl_runs["stereo"][0], "fisheye_vi_loop": fl_runs["stereo-inertial"][0],
            "fisheye_mono": launches_fm, "fisheye_mono_vi": launches_fmv, "fisheye_mono_loop": launches_flm,
            "ranks_loop": ranks_launches}
    main_run = {"twoview_ransac": "mono_system", "vocab_transform": "mono_system", "pnp_ransac": "relocalisation",
                "sim3_ransac": "loop", "sim3_refine": "loop", "sim3_graph": "loop", "ba_pcg": "loop",
                "sim3_pcg": "loop_pcg", **{name: "vi_mono" for name in VI_KERNELS}, "pose_graph4": "vi_loop",
                "vi_pcg": "vi_loop", "fisheye_stereo": "fisheye", "kfdb_score": "ranks_loop",
                "ba_shard": "ranks_loop"}
    kb8_run = {"pnp_ransac": "fisheye_reloc", "pose_inertial": "fisheye_vi", "vi_ba": "fisheye_vi",
               "sim3_ransac": "fisheye_loop", "sim3_refine": "fisheye_loop", "vi_pcg": "fisheye_vi_loop",
               "twoview_ransac": "fisheye_mono"}
    for k in kernels:
        k["launches"] = runs[main_run.get(k["name"], "stereo_system")][k["name"]]
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in runs.items()}
        if "kb8" in k:  # the KB8 instance's launches on its fisheye path
            k["kb8"]["launches"] = runs[kb8_run.get(k["name"], "fisheye")][f"{k['name']}[kb8]"]
        if "radtan" in k:  # the distorted instance's, on the distorted mono System (10 (d))
            k["radtan"]["launches"] = runs["distorted_mono"][f"{k['name']}[radtan]"]
    total_s = time.perf_counter() - t_start
    rest_s = total_s - build_s - phase3_s - phase15_s - phase16_s - phase8_s
    log(f"chip_smoke: {total_s:.1f} s in all: build {build_s:.1f} s, phase 3 {phase3_s:.1f} s, phase 15 "
        f"{phase15_s:.1f} s, phase 16 {phase16_s:.1f} s, phase 8 {phase8_s:.1f} s, the rest {rest_s:.1f} s")
    log(json.dumps({"kernels": [{key: k[key] for key in ("name", "route", "source", "replaces", "launches",
                                                         "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                         "library_ms", "collective_ms", "dense_ms",
                                                         "launches_by_path", "shapes", "radtan", "kb8",
                                                         "stages")
                                              if key in k}
                                for k in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases:
  (a) print the card's name and power limit; build the CUDA kernels from
      mujoco_warp_tpu_torch/csrc (one nvcc per source, in parallel); hold
      B1 and its four entries (B9-B12), B2's two entries, B3, B4, B3e,
      B4-elliptic, B5, B6, B7 and B8 (one warp per world) to no spill
      stores and at most MAX_STACK_B3 bytes of stack in ptxas's report;
  (b) load the humanoid from its committed .npz and make 8192 worlds with
      seeded qpos noise, nconmax=24;
  (c) step 100 times, then hold each kernel (B1 smooth, B2 contact, B3
      glue, also in mode 1 with eulerdamp on and in mode 2 with
      opt.integrator=implicitfast, on the humanoid and on its servo
      variant, `_servo`) against its plain PyTorch version on the same
      inputs on the card, failing above the stated tolerance (B3's worlds
      by LOTTERY_WORLDS), and B2's and B3's two launches on the same
      inputs bit-equal;
  (d) with every launch count at 0, run the main path (the harness's
      protocol, utils/benchmark.py: 120 steps with OU control noise, the
      last 99 timed; the first step eager, the others replayed as one
      CUDA graph a step) under torch.profiler and require each kernel to
      have run on the card once per step (a replay calls no wrapper, so
      its launches are counted by kernel name; over COUNT_STEPS = 22
      steps, as the profiler loses records of longer replayed runs), and
      each wrapper to have been called twice (the first step and the
      capture); run it again over 120 steps without the profiler, print
      steps/s and check for NaN;
  (e) from the state the main path left, time each kernel and its plain
      version and compute its bound; then 20 replayed steps against 20
      eager steps from one state, every Data tensor bit for bit (after two
      eager runs against each other), and the same 10 steps each way
      timed and profiled (device time per kernel name, busy share,
      launches a step, each kernel once a step on the card when
      replayed).
  Then three_humanoids (nv 81) from its .npz, 8192 worlds, nconmax 100,
  which runs the unfused step:
  (f) step 10 times, then hold B1 and B2 against their plain versions as
      in (c) (B2 also over two launches, its launch shape printed), B7
      (tree_ldl, with and without the Euler diagonal; its x without the
      factor bit-equal to its x with it; its launch shape printed) and B5
      (spd_solve, on the Hessians of the solve's first direction) by the
      packed factor, the per-world residual and the forward error against
      the plain version in float64;
  (g) with every count at 0, run the main path (12 steps, the last one
      timed) and require B1 and B2 once per step, B7 twice per step (once
      without the factor: the Euler re-solve's) and B5 once per Newton
      direction (one per step plus one per pass of the
      solve's loop); hold one whole step of the kernels against the
      all-plain step on the same state (qacc and the solve's objective);
      then P12, the implicitfast step (opt.integrator=implicitfast),
      eager: B7 once a step, B5 once per Newton direction and once on
      qM - h qDeriv; one step against the all-plain step, and
      step2(step1(d)) bit-equal to step_batched;
  (h) time each kernel, its plain version and, for B5 and B7 without the
      factor, torch.linalg.solve on the same inputs, with its bound (B7
      as fwd_acceleration calls it and as the Euler re-solve calls it:
      two records that split B7's launches); profile 2 steps.
  Then the paths of forward_batched, the RK4 integrator and the CG solver,
  selected on the loaded models (m.replace(opt=m.opt.replace(...))):
  (i) on the humanoid state of (c): hold B4 (newton) against its plain
      version with B3's criteria, without and with an integration
      diagonal hb, and its qLD against solver.cholesky; B4 bit-equal to
      B3's solve on the same qfrc_smooth, and two launches bit-equal;
      print B2's, B3's and B4's launch shapes; hold B6
      (cho_solve) on B5's factor of qM by residual and forward error
      against the float64 plain version, and against B5's own x;
  (j) on the three_humanoids state of (f): hold B8 (tree_solve) on B7's
      packed LD the same way, and against B7's own x; print its launch
      shape;
  (k) from counts at 0, run one forward_batched (B4 once, B3 never), RK4
      steps (B4 four times a step; replayed, so counted on the card as in
      (d), and held against eager steps as in (e)), CG steps of the
      humanoid (B5 once a
      step, B6 once per solve and per CG pass; P13, with implicitfast, B5
      twice a step) and of three_humanoids (B7
      twice a step, B8 once per solve and per pass, B5 never); hold one
      RK4 step, one CG step of each (P13 too) against the all-plain step
      on the same state; print steps/s and CG passes per step; P11, the
      humanoid's implicitfast glue step (B3 in mode 2), replayed, counted
      on the card as in (d), held against eager steps as in (e) and one
      step against the all-plain step, with B3's mode-2 time and bound;
  (l) time B4, B6 and B8 with their plain versions and bounds, B6 beside
      torch.cholesky_solve.
  Then the elliptic cone at impratio 10, set with override_model:
  (m) hold B2's elliptic rows against the plain rows on the humanoid's and
      three_humanoids' states, over two launches, and print their launch
      shapes;
  (n) on the humanoid's state, hold B3e (glue with the cone; also in
      mode 2) and
      B4-elliptic (newton_solve with the cone) against their plain
      versions and the plain versions' own spread (see ELLIPTIC),
      B4-elliptic bit-equal to B3e's solve on the same qfrc_smooth, and
      each over two launches; print their launch shapes;
  (o) from counts at 0, run and time P7 (the humanoid's glue step: B1,
      B2, B3e once a step), P8 (one forward_batched and RK4 steps:
      B4-elliptic once and four times a step) and P9 (three_humanoids'
      unfused step: B7 twice a step, B5 once per Newton direction, the
      iterative linesearch); P7 and P8 are replayed, counted on the card
      and held against eager steps as in (d) and (e), P9 steps eagerly;
      hold one step of each against the all-plain step; time B2, B3e and
      B4-elliptic with their plain versions and bounds.
  Then the entry point of B9-B12 (kernels.smooth.smooth_front, kinematics,
  com_pos, crb), which reaches no step:
  (p) on the humanoid state of (c) and the three_humanoids state of (f),
      8192 worlds: from counts at 0, call each of the four functions once
      on B1's normalized qpos q (B11 on B10's outputs, B12 on B11's) and
      require one launch each; hold every output bit-equal to B1's of the
      same name (or, where it is not, within TOL_B1, printed), each kernel
      against its plain version at TOL_B1 (B12 also on inputs plus seeded
      noise); time each kernel and its plain version, with its bound.
  (q) run the entry points, each in a process of its own: `python -m
      mujoco_warp_tpu_torch.bench` at BENCH_NSTEP steps (dispatch graph),
      `python -m mujoco_warp_tpu_torch.testspeed` on
      three_humanoids.npz at 8192 worlds, nconmax 100, 12 steps
      (dispatch eager), on franka_emika_panda.npz at 32768 worlds,
      nconmax 1, 120 steps, on apptronik_apollo_flat.npz at 8192
      worlds, nconmax 16, 120 steps and on apptronik_apollo_terrain.npz
      at 8192 worlds, nconmax 48, 42 steps, and on aloha_pot.npz with
      --replay lift_pot at 8192 worlds, nconmax 24, 42 steps (the last
      four dispatch graph); print their JSON lines.
  Then franka_emika_panda (nv 9, a joint equality, plane-capsule and
  plane-box pairs, implicitfast: the glue list with B3 in mode 2), the
  suite's row at 32768 worlds and nconmax 1:
  (r) on FRANKA_CHECK worlds of a reach state (REACH: pads from clear of
      the floor to 4 corners each below it, the equality off in a tenth
      of the worlds), hold B2's two entries against their plain rows at
      nconmax 1 and 12 (as in (c); a plane-box slot whose point is
      another corner of its box at the same depth, a tie broken the
      other way, is counted and printed, and every other value of its
      world held), over two launches, with their launch shapes;
      B3 in mode 2 and B4 with B3's criteria (where the lottery shows, by
      the counts rule as P11's step) and B3e in mode 2 by phase (n)'s
      counts, each with the equality row in the solve, solver_niter
      held against the float64 solve's (the note on franka after
      ELLIPTIC); from
      counts at 0, run P14 (the harness's
      protocol, replayed) at 32768 worlds: B1, B2 and B3 once a step on
      the card over COUNT_STEPS, then NSTEP steps timed; one step
      against the all-plain step, 20 replayed steps against 20 eager
      ones bit for bit, one replayed step after eq_active was flipped in
      place against the eager step; the same from the reach state; time
      B2 on both states and B3 in mode 2, with their bounds.
  Then apptronik_apollo_flat (nv 25, plane-capsule, plane-box,
  capsule-capsule, capsule-box and box-box pairs, 19 friction-loss and
  19 limit rows, four IMU sensors, Euler: the glue list with the sensor
  stages and the advance after sensor_acc), the suite's row at 8192
  worlds and nconmax 16:
  (s) on P15's state (qpos0 with seeded noise, APOLLO_PREP steps: the
      soles on the floor) and on the contact-rich state (`_apollo_rich`:
      hinges across their ranges, the base lowered, the legs drawn
      together in every other world), print the active contacts of each
      pair type and fail if the rich state has no capsule-box or no
      box-box contact; hold B2's `box_` entry against the plain rows at
      nconmax 16 and 48 (as in (c): the same contact and row sets but at
      thresholds, a tie only on a verified plane-box corner), over two
      launches, with its launch shape; B3 in mode 0 on both states by
      phase (c)'s rules, or where the lottery shows by the counts rule,
      its objective against the float64 solve's (see RICH_LEGS);
      from counts at 0, run P15 (the harness's protocol, replayed): B1,
      B2 and B3 once a step on the card over COUNT_STEPS, then NSTEP
      steps timed, printed as `step_apollo`; one step against the
      all-plain step (counts against the all-plain step's 1-ulp
      spread, as P14's, and each excused world against the float64
      solve); 20 replayed steps against 20 eager
      ones bit for bit, sensordata included; time B2 on both states and
      B3, with their bounds.
  Then apptronik_apollo_terrain (apollo_flat's robot on 5,272 boxes of
  terrain: 95,021 admissible pairs, past the large-scene threshold, so
  its lists run `collision` and `make_constraint`, torch ops, where the
  others run B2), the suite's row at 8192 worlds and nconmax 48:
  (t) from qpos0 with seeded noise, step until the feet touch the
      terrain (TERRAIN_TOUCH of the worlds with a contact); print the
      contacts, each SAP family's overlapping pairs and the worlds that
      drop pairs at the cull; hold B1 (5,290 geoms a world) against its
      plain version at TOL_B1 and over two launches, and B3 in mode 0
      as in (s); from counts at 0, run P16 (the harness's protocol,
      replayed): B1 and B3 once a step on the card over COUNT_STEPS and
      no B2, then TERRAIN_NSTEP steps timed, printed as `step_terrain`
      with one eager step's peak memory; one step against the all-plain
      step as P15's; 20 replayed steps against 20 eager ones bit for
      bit, sensordata included; the card's time of each stage; time B1
      and B3 on terrain, with their bounds.
  Then aloha_pot (nv 23, 204 geoms: 190 meshes, 12 spheres, a box and a
  plane; two joint equalities, 5 friction-loss dofs, 17 limits; the
  elliptic cone at impratio 10; Euler with implicit damping: B3e in mode
  1), whose mesh and sphere-box pairs B2 has no branch for, so its list
  runs the static driver's `collision` (the bounding-sphere cull of its
  sphere-mesh, box-mesh and mesh-mesh groups, MPR, plane-mesh,
  sphere-box) and `make_constraint`, torch ops, where the others run B2;
  the suite's row at 8192 worlds and nconmax 24:
  (u) from keyframe lift_pot0 with seeded noise, ALOHA_PREP steps; print
      the contacts (ncon and ncollision per world, contacts by condim),
      each culled group's overlapping pairs and the worlds that drop pairs
      at the cull, the cull held at 8192 worlds on 256 of them against a
      stable sort (`_group_overlaps`); hold B1 against its plain version
      at TOL_B1 and over two launches, and B3e (mode 1) against the
      float64 plain solve (the note before ALOHA_NWORLD) on P17's inputs
      (equality, friction-loss, limit and condim-3 and -4 contact rows;
      the condim-4 contacts are a gripper's fingers on each other, whose
      torsional J rows are zero: the fingers slide), its advance against
      its own qacc_euler; from counts at 0, run P17
      (the harness's protocol, replayed): B1 and B3e once a step on the
      card over ALOHA_COUNT steps and no B2, then ALOHA_NSTEP steps
      timed, printed as `step_aloha_pot` with one eager step's peak
      memory; one step against the all-plain step
      (`_compare_step_exact`: its solve against the float64 solve, the
      other worlds at the step tolerance, by count against the all-plain
      step's spread after a change of qpos by ALOHA_QPOS_ULPS ulps);
      ALOHA_REPLAY replayed steps against as many eager ones bit for
      bit; the card's time
      of each stage and of each group's cull and narrowphase; the
      lift_pot replay (`benchmark_replay` over the 8 lift_pot keyframes'
      ctrl from lift_pot0, as testspeed --replay runs it): from counts
      at 0, B1 and B3e once a step on the card over ALOHA_COUNT steps,
      then timed (B1's and B3e's wrappers called twice, the first step
      and the capture): steps/s,
      peak memory, ncon and ncollision per world, a replayed profile
      (busy share, launches a step), the time of each stage; time B1 and
      B3e on aloha_pot, with their bounds.
  (v) aloha_sdf (the suite's config.txt:15 row, SDF_NWORLD worlds,
      nconmax SDF_NCONMAX): the model's groups, voxel grids, candidate
      slots, efc layout and glue mode; the rich state (keyframe
      gripper_gripper_pot, noise on the arms, SDF_PREP steps): ncon and
      ncollision per world, contacts by pair type and condim, the
      condim-4 contacts whose torsional J row is nonzero (it fails
      without SDF-SDF or box-SDF contacts or such a row); B1 against its
      plain version and B3e (mode 1) against the float64 plain solve
      there (`_hold_b3e_aloha` at SDF_OBJ_FACTOR); the SDF narrowphase in
      float32 against float64 on SDF_HOLD_WORLDS worlds
      (`_hold_sdf_narrowphase`); from counts at 0, P18 (the suite's
      aloha_sdf step from keyframe 0, the harness's protocol, replayed):
      B1 and B3e once a step on the card over SDF_COUNT steps and no B2,
      then timed, printed as `step_aloha_sdf` with one eager step's peak
      memory; one step against the all-plain step; SDF_REPLAY replayed
      steps against eager ones bit for bit; the card's time of each
      stage and group; time B1 and B3e on aloha_sdf (the rich state's
      inputs), with their bounds; and the phase's wall time.
  (w) apptronik_apollo_hfield (the suite's config.txt:17 row,
      HFIELD_NWORLD worlds, nconmax HFIELD_NCONMAX; run after (t)): the
      model's groups, height field, candidate slots, efc layout and stage
      list (P16's, with the static driver's `collision`: B2 has no
      height field branch); apollo's contact-rich state (`_apollo_rich`)
      with its contacts by pair type (it fails without hfield-capsule and
      hfield-box contacts); B1 against its plain version and B3 (mode 0)
      by apollo's rules there (`_hold_b3_apollo`); the height-field
      narrowphase in float32 against float64 on HFIELD_HOLD_WORLDS worlds
      (`_hold_hfield_narrowphase`); from counts at 0, P19 (the suite's
      step from keyframe 0, the harness's protocol, replayed): B1 and B3
      once a step on the card over HFIELD_COUNT steps and no B2, then
      timed, printed as `step_apollo_hfield` with one eager step's peak
      memory; one step against the all-plain step as P16's;
      HFIELD_REPLAY replayed steps against eager ones bit for bit; the
      card's time of each stage and group; time B1 and B3 on
      apollo_hfield (the rich state's inputs), with their bounds.
  (x) kitchen (the suite's benchmarks/suite.py:42-48 row, KITCHEN_NWORLD
      worlds, nconmax KITCHEN_NCONMAX; run after (w)): the model's SAP
      families (cylinder-cylinder and cylinder-box through MPR, box-box),
      candidate slots, efc layout and stage list (the unfused list with
      the SAP `collision` and `make_constraint`: B1, B7, B5, B7 euler; no
      B2, B3 or B4), B1's worlds a block and bytes a world; the rich
      state (`_kitchen_rich`) with its contacts by pair type (it fails
      without cylinder-cylinder and cylinder-box contacts); B1 against its
      plain version, B7 (with the factor and as the Euler re-solve) and B5
      (the Hessian of the first Newton direction) by residual and forward
      error, the MPR families' narrowphase in float32 against float64
      (`_hold_sap_narrowphase`); from counts at 0, P20 (the suite's step
      from qpos0, KITCHEN_NSTEP steps, eager): B1 once a step, B7 twice
      (once without the factor), B5 once a Newton direction, no B2, B3 or
      B4, printed as `step_kitchen` with one eager step's peak memory and
      the mean ncon, ncollision and solver_niter; one step against the
      all-plain step; the card's time of each stage and family; time B1,
      B7, B7 euler and B5 on kitchen (the rich state's inputs), with
      their bounds.
One JSON line lists every kernel's record; a replayed path's launches
are those the card ran, by kernel name.

The last line is {"ok": true, "device": {...}}; any failure raises and
exits non-zero without it. Nothing here imports JAX or the JAX package.
"""

import collections
import contextlib
import json
import math
import subprocess
import sys
import time

NWORLD = 8192
NCONMAX = 24
SEED = 0
QPOS_NOISE = 0.01
PREP_STEPS = 100
# the main path's steps in all: utils/benchmark.benchmark(nstep=120) takes
# a first step, 20 warm-up steps and 99 timed ones (the JAX harness's
# protocol)
NSTEP = 120
# scale-relative tolerances: |kernel - plain| <= tol * max(1, max |plain|)
TOL_B1 = TOL_B2 = 2e-5       # same operations in another order
# B3: the step tolerances of tests/test_glue_kernel.py:52-66 (qpos 5e-6,
# qacc 5e-5, qfrc_constraint 5e-4, the rest 5e-5). Besides, the solve is
# held to its objective: both solutions' cost within TOL_OBJ units of
# tolerance * meaninertia * nv (the unit of its stopping rule). The
# stopping rule is tripped one iteration earlier or later by a 1-ulp
# change of the inputs (phase c prints the plain version's own spread),
# so solver_niter is held per world within NITER_MAX, the bound of that
# test, and the share of worlds within NITER_SLACK of the plain version
# may fall short of the share the plain version keeps against itself,
# after a 1-ulp change of qfrc_smooth, by at most NITER_MARGIN.
TOL_B3 = dict(qpos=5e-6, qfrc_constraint=5e-4, efc_force=5e-4)
TOL_B3_OTHER = 5e-5
TOL_OBJ = 1.0
NITER_MAX = 4
NITER_SLACK = 2
NITER_MARGIN = 0.01
# Those per-world criteria of B3 and B4 (phases c and i: the step
# tolerances, the objective within TOL_OBJ units, solver_niter within
# NITER_MAX) are a rounding lottery in a few worlds: when the linesearch's
# last polish step lands exactly on a root, the rule that keeps a step
# strictly inside its bracket (the JAX package's too,
# pallas/solver_kernels.py:439) bisects away from it and the solve stops
# early, in whichever version an ulp decides (ROADMAP §C). A world that
# misses one of them is held as the whole-step comparisons hold theirs
# (_check_excused): its solve stopped in fewer iterations than the plain
# solve, or its objective lies at most TOL_OBJ units above the plain
# solve's, on the same inputs. There may be at most LOTTERY_WORLDS such
# worlds: the most worlds, in one of 40 states of the humanoid main path
# (8192 worlds each), in which the plain solve after a 1-ulp change of qfx
# misses these criteria against the plain solve itself: 22, at states
# 100-139 (`utils/solve_spread.py 40` on an NVIDIA H100 80GB HBM3 at
# 700 W, PERF.md §6; 124 such worlds in all, B3's own 137, 23 at most in
# one state).
LOTTERY_WORLDS = 22
# three_humanoids (phases f-h): the benchmark suite's configuration
NCONMAX3 = 100
PREP3 = 10
NSTEP3 = 12        # steps in all (a first, 10 warm-up and 1 timed)
PROFILE3 = 2
# B5 and B7 are held by residual and forward error, not elementwise: at
# nv 81 the float32 rounding of either version moves x by more than a
# fixed elementwise bound. Per world, |a x - b|inf / (|a|inf |x|inf +
# |b|inf) <= TOL_RES; over the batch, the kernel's distance from the
# plain version run in float64 is at most FWD_FACTOR times the float32
# plain version's own, plus FWD_FLOOR (both relative to max |x|). The
# packed factor LD is the same arithmetic in the same order: TOL_B1.
TOL_RES = 1e-5
FWD_FACTOR = 4.0
FWD_FLOOR = 1e-6
# one whole step, kernels against plain versions: qacc as B3's (5e-5 of
# max(1, max |qacc|)) over the worlds whose contact and row sets agree
TOL_STEP_QACC = 5e-5
# forward_batched, RK4 and CG paths (phases i-l): steps in all, of which
# the harness times the last one (a run of fewer than 22 steps is a first
# step, n - 2 warm-up steps and one timed step)
RK4_STEPS = 5
CG_STEPS = 5
CG3_STEPS = 3
# One CG step, kernels against plain versions: CG is compared at its
# converged answer, not per iteration. A change of one ulp in qfrc_smooth
# moves the plain version's own qacc by 1.9e-4 of scale at 4 worlds
# (tests/test_torch_cg.py), so an FMA contraction moves the kernels' path
# as far; qacc is held at ten times that.
TOL_STEP_QACC_CG = 2e-3
# A world that misses a step tolerance must not have a higher objective
# than the plain solve reaches on the same inputs, unless its solve
# stopped in fewer iterations (_check_excused): by TOL_OBJ units after
# Newton; by TOL_OBJ_CG after CG, which stops when a pass gains less than
# one unit and, converging slowly, leaves several (the plain CG solve of
# one three_humanoids world alone and inside a batch of 16 ended 2.1
# units apart on the CPU). A qacc wrong by 1e-2 costs hundreds of units.
TOL_OBJ_CG = 10.0
# the elliptic cone (phases m-o): the options of the suite's aloha scenes,
# set as the JAX package's override_model sets them; steps in all of P7
# (the humanoid's glue step, B3e; the last 4 timed), P8 (RK4 steps,
# B4-elliptic four times a step) and P9 (three_humanoids' unfused step)
ELLIPTIC = ['opt.cone=elliptic', 'opt.impratio=10']
# On franka (phase r) the solve's stopping rule works below float32's
# resolution: its cost (the position servos' kp up to 1000, the stiff
# finger equality) carries rounding noise above the tolerance *
# meaninertia * nv the rule compares the improvement with, so each
# float32 solve stops where its own rounding first shows an improvement
# below it, and any change of rounding moves solver_niter. On the card at
# 8192 reach worlds (NVIDIA H100 80GB HBM3, 700 W), mean solver_niter:
# float64 plain solve 2.03, float32 plain 2.95, B3 in mode 2 3.18 (B3e
# 3.50, 3.70, 3.91); within NITER_SLACK of the plain solve: B3 0.958, the
# plain solve after a 1-ulp change of qfrc_smooth 0.986 (B3e 0.946 and
# 0.984); within NITER_SLACK of the float64 solve: B3 0.850, the float32
# plain solve 0.891 (B3e 0.948, 0.955); no world over an elementwise
# tolerance. Built for the host, without FMA, the same kernel code lies
# as close to the float64 solve as the plain one (B3 within NITER_SLACK
# of it in 0.861 and 0.863 of 512 worlds; mean solver_niter 3.00 and
# 2.99 of 256), so the card's spread is its contraction's rounding.
# There B3, B4 (where the lottery shows) and B3e are held by counts as
# P11's step is held: the worlds over the
# elementwise tolerances and the objectives above the plain solve's
# against the plain solve's own 1-ulp spread; and solver_niter against
# the float64 solve's (_check_ell_solve's `exact`): the kernel's share
# of worlds within NITER_SLACK of it at least the float32 plain solve's
# less EXACT_NITER_MARGIN, and its mean solver_niter at most the plain
# solve's plus NITER_MEAN_SLACK, each about 1.5 times the card's reading
# above (share 0.041 below for B3, 0.035 for B4, 0.007 for B3e; mean
# 0.23, 0.21, 0.21 above). A solve that took one more iteration in every
# world would lie 1.0 above.
EXACT_NITER_MARGIN = 0.06
NITER_MEAN_SLACK = 0.35
# B3e and B4-elliptic are held to B3's tolerances, measured against the
# plain version's own spread: its solve after a 1-ulp change of
# qfrc_smooth. The cone's Hessian is nearly singular along sliding
# directions (condition ~6e4 at impratio 10), so an ulp can change where
# a world's solve stops, in either direction and after as many
# iterations as not: on the card at 8192 humanoid worlds, the plain solve
# after that change ends more than TOL_OBJ units above the plain solve in
# 7 worlds (up to 1.6e8 units; 3 of them after as many iterations or
# more) and 2.5e9 units below it in another, and 8 worlds miss an
# elementwise tolerance. So B3's per-world rules (each world's objective
# within TOL_OBJ units, solver_niter within NITER_MAX, a world over a
# tolerance excused only if its solve stopped earlier) do not hold even
# between two plain solves; counts do. The worlds over an elementwise
# tolerance, and the worlds whose objective lies above the plain solve's
# by more than TOL_OBJ units, may each number max(8, nworld / 1000) plus
# twice the perturbed plain solve's own; the share of worlds whose
# solver_niter lies within NITER_SLACK of the plain solve's may fall short
# of the perturbed plain solve's share by at most NITER_MARGIN. The steps
# of P7-P9 are held the same way against the all-plain step after a 1-ulp
# change of qvel (_compare_step's `spread`), their worlds over the
# tolerance by count, with their objectives printed.
P7_STEPS = 25
P8_STEPS = 4
P9_PREP, P9_STEPS = 2, 3
# P12: three_humanoids' implicitfast Newton step, steps in all (the last
# one timed)
P12_STEPS = 3
# the kernels that run one warp per world (WARP_KERNELS): their ptxas
# report may show at most this much stack and no spill stores
MAX_STACK_B3 = 1024
# Replay against eager (phases e, k, o): on each path the harness
# replays (forward.replays), REPLAY_STEPS steps from one state by graph
# replay and by the eager loop, the step indices from REPLAY_START (any
# index: the same for both); then as many steps each way timed and
# profiled as keep the profile near 2,500 kernels (PROFILE_STEPS of a
# glue step, PROFILE_RK4 of an RK4 step).
REPLAY_STEPS = 20
REPLAY_START = 1000
PROFILE_STEPS = 10
PROFILE_RK4 = 2
# torch.profiler loses kernel records when the card runs many of them
# fast: a replayed window of 62,700 kernels (50 RK4 steps) lost 282 of
# them on the H100, windows of 27,000 (120 humanoid steps) lost none. So
# a replayed path is counted over a short run: the main path over
# COUNT_STEPS steps in all (a first step, 20 warm-up steps and one
# timed, the harness's protocol), each profiled window under ~6,500
# kernels.
COUNT_STEPS = 22
# It also drops records of shorter replayed windows now and then (2 of 10
# steps' kernels in a 2,260-kernel window of the humanoid's replayed step
# on the H100, in one run of several that lost none): a replayed profile
# whose counts fall short of the expected ones, and exceed them in no
# kernel, is taken again, at most PROFILE_TRIES times; the counts must
# then match exactly.
PROFILE_TRIES = 3
# It loses records at the start of a window too: of 256 short kernels
# alone in a window, 237-256 were recorded, of 16 none in 2 of 3 windows
# (`utils/profile_lead.py`, NVIDIA H100 80GB HBM3, 700 W; PERF.md), and
# the lift_pot replay's step, whose B1 is its fourth kernel,
# comes first in its counted window. So each profile starts after the
# card is idle, with PROFILE_LEAD short kernels of its own
# (`torch.cuda._sleep`, PROFILE_LEAD_CYCLES clock cycles each) that it
# waits for and leaves out; so started, windows of one lift_pot replay
# step recorded B1 and B3e once in 3 of 3, and chip_smoke's counted
# window of 6 steps 6 and 6 in 3 of 3 (the same run).
PROFILE_LEAD = 256
PROFILE_LEAD_CYCLES = 20000
# It loses records at the end of a window as well: in every replayed
# window that fell short on the H100 the kernel missing was the last
# step's B3 or B3e, never a B1 (P16's windows of 10 steps, 6,727
# kernels a step, short by up to 412 kernels, once short in all of
# PROFILE_TRIES; P17's of 2 steps, 20,707 a step, short by 8). So each
# profile also waits for an idle card after fn and ends with
# PROFILE_TRAIL kernels of its own, which it leaves out; the retries
# print how many of its own kernels it recorded. The profiler records
# the card's activity alone: a window's host-side events add nothing to
# the counts and take time to read.
PROFILE_TRAIL = 2048
PROFILE_OWN = dict(recorded=0, launched=0)
# torch.profiler's `events()` builds a Python object for each record and
# its place in a tree, ~40x slower than the profiler's raw records give
# the same names and times (`compare_trees.device_records`), and P18
# profiles 141,037 kernels a step. So the first profile of a run reads
# its device records both ways and the run keeps the raw ones where the
# two agree in every name and in the summed time (`_device_records`).
RAW_RECORDS = dict(ok=None)
# glue mode 2 (implicitfast, phase c): the servo variant's velocity
# coefficients (SERVO_KV / gear0^2 and SERVO_GV / gear0^2, so that each
# dof's actuator term h gear0^2 (kv + gv ctrl) is of the order of the
# humanoid's dof damping, 3-5) and the bound of its seeded ctrl, which
# puts some of it outside its range [-1, 1]
SERVO_KV = 4.0
SERVO_GV = -1.0
SERVO_CTRL = 1.5
# the entry points (phase q): bench at BENCH_NSTEP steps, testspeed on
# three_humanoids at NSTEP3
BENCH_NSTEP = 200
# franka_emika_panda (phase r): the suite's row (benchmarks/scenes/
# config.txt:20), FRANKA_NWORLD worlds at nconmax FRANKA_NCONMAX; its
# kernels are held on FRANKA_CHECK worlds of a reach state, at the
# suite's nconmax and at FRANKA_NCONMAX_WIDE, which compacts the contacts
# past the first slot
FRANKA_NWORLD = 32768
FRANKA_NCONMAX = 1
FRANKA_NCONMAX_WIDE = 12
FRANKA_CHECK = 8192
# the reach state: the fingers' pads on the floor (at exactly this qpos C
# MuJoCo finds 8 plane-box contacts, 4 on each pad, their depths in equal
# pairs), seeded noise of +-REACH_NOISE rad on joints 2, 4 and 6 (pads
# from clear of the floor to 4 corners of each below it), qvel N(0,
# REACH_QVEL^2), ctrl holding the pose within +-REACH_NOISE (the wrist
# servos past their force range in some worlds), and the finger equality
# off in a seeded EQ_OFF share of the worlds
REACH = (0.0, 0.9, 0.0, -1.6, 0.0, 2.4, 0.785, 0.04, 0.04)
REACH_NOISE = 0.05
REACH_QVEL = 0.1
EQ_OFF = 0.1
# apptronik_apollo_flat (phase s): the suite's row (benchmarks/scenes/
# config.txt:16), APOLLO_NWORLD worlds at nconmax APOLLO_NCONMAX; B2 is
# also held at APOLLO_NCONMAX_WIDE, where no world overflows. P15's state
# is qpos0 with QPOS_NOISE, after APOLLO_PREP steps; the contact-rich
# state draws every hinge across its range, lowers the base by
# RICH_DROP m, gives qvel N(0, RICH_QVEL^2), and in every other world
# draws the legs together (RICH_LEGS: joint id, range) so that the soles,
# boxes, meet each other and the capsules of the other leg
APOLLO_NWORLD = 8192
APOLLO_NCONMAX = 16
APOLLO_NCONMAX_WIDE = 48
APOLLO_PREP = 10
RICH_DROP = 0.2
RICH_QVEL = 0.2
RICH_LEGS = ((9, -0.218, -0.05), (15, 0.05, 0.218), (11, 0.0, 0.3),
             (17, 0.0, 0.3), (10, -0.3, 0.3), (16, -0.3, 0.3))
# On the contact-rich state the float32 plain solve is noisy against
# itself: after a 1-ulp change of qfx it ends more than TOL_OBJ units
# above itself in 80 of 8192 worlds (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md §6), B3 in 185, so two float32 solves do not make a reference
# for each other there. B3 on apollo is held against the plain solve in
# float64 on the same inputs (_check_ell_solve's `exact_noise`): the
# worlds where a float32 solve ends more than TOL_OBJ units above it, on
# four seeds of this state (`utils/rich_spread.py`, same card, PERF.md):
# plain 171, 172, 178, 191; after qfx +1 ulp 163, 186, 175, 184, -1 ulp
# 174, 169, 174, 195; B3 204, 196, 189, 187; B3 built with --fmad=false
# 162, 183, 195, 174 (in all 776 for B3, 712 for the plain solve, 714
# without contraction). The same source without contraction lands where
# the plain solve does: B3's excess (0.96-1.17 times the largest float32
# plain count) is its multiply-adds' rounding. B3's count may be
# max(8, nworld / 1000) plus EXACT_OBJ_FACTOR times the largest count of
# the plain solve and its two 1-ulp perturbations: an excess of 25%,
# about 1.5 times the largest read (17%). P15's step holds each of its
# excused worlds against the float64 solve too, and a world that no
# iteration count excuses by whether its outcome turns on at most
# ULP_WITNESS ulps of qfx (_check_excused's `exact`).
EXACT_OBJ_FACTOR = 1.25
ULP_WITNESS = 4
# apptronik_apollo_terrain (phase t): the suite's row (benchmarks/scenes/
# config.txt:18), TERRAIN_NWORLD worlds at nconmax TERRAIN_NCONMAX; P16's
# state is qpos0 with QPOS_NOISE, stepped TERRAIN_PREP steps at a time,
# at most TERRAIN_PREP_MAX, until TERRAIN_TOUCH of the worlds have a
# contact (the feet on the terrain)
TERRAIN_NWORLD = 8192
TERRAIN_NCONMAX = 48
# P16's timed run and testspeed's on terrain take TERRAIN_NSTEP steps in
# all (a first, 20 warm-up and 11 timed; 21 timed before phase (w) came):
# a step takes ~0.23 s at 8192 worlds
TERRAIN_NSTEP = 32
TERRAIN_PREP = 10
TERRAIN_PREP_MAX = 60
TERRAIN_TOUCH = 0.9
# worlds on which each culled SAP family's (and static group's) top-K is
# held against a sort
CULL_HOLD_WORLDS = 256
# aloha_pot (phase u): the suite's row (benchmarks/scenes/config.txt:14),
# ALOHA_NWORLD worlds at nconmax ALOHA_NCONMAX; P17's state is keyframe
# lift_pot0 with QPOS_NOISE on the arms (the pot where the keyframe puts
# it, on the table), stepped ALOHA_PREP steps. A step takes ~1.1 s at 8192
# worlds (NVIDIA H100 80GB HBM3, 700 W: the collision stage's MPR), so the
# depth is cut: P17 counted over ALOHA_COUNT steps, timed over ALOHA_NSTEP
# (a first, 20 warm-up and 3 timed), its replay profiled over
# ALOHA_PROFILE, held against eager steps over ALOHA_REPLAY (20 before
# phase (w) came: two eager runs and the replay took ~65 s of the
# script); the lift_pot replay takes ALOHA_REPLAY_NSTEP steps (a first,
# 10 warm-up, 1 timed), testspeed's ALOHA_TESTSPEED_NSTEP (a first, 4
# warm-up, 1 timed)
# B3e on aloha_pot: the cone's solve at impratio 10 on the grippers'
# contacts is ill-conditioned in float32, and where a float32 solve stops
# turns on the rounding of its sums. On P17's state, seeds 0-3
# (`utils/rich_spread.py aloha`, NVIDIA H100 80GB HBM3, 700 W; PERF.md),
# the worlds more than TOL_OBJ units above the float64 solve's objective:
# the float32 plain solve 293, 291, 310, 296 (after a 1-ulp change of
# qfx 286-307, nearly the same worlds); B3e 332, 323, 349, 301; B3e
# built with --fmad=false 287, 309, 323, 287 (1,206 in all, the plain
# solve 1,190). Over the tolerances against the float64 solve: plain
# 326, 323, 347, 325 (its perturbations 319-344), B3e 353, 358, 384,
# 324, without contraction 318, 329, 353, 324. So B3e's excess, at most
# 12.6% of the plain solves' largest count, is its multiply-adds'
# rounding, as B3's on apollo (RICH_LEGS). Per world no float32 solve is
# a reference for another: the build without contraction still ends more
# than TOL_OBJ above the plain solve in 217-245 worlds and over the
# tolerances against it in 327-363 (B3e 243-288 and 383-437; the plain
# solve after a 1-ulp change 8-15 and 10-19). So B3e is held against the
# float64 solve (`_hold_b3e_aloha`): its worlds over the tolerances and
# above the objective each at most max(8, nworld / 1000) plus
# ALOHA_OBJ_FACTOR times the plain solves' largest count, an excess of
# 19%, 1.5 times the largest read. P17's step is held against the
# all-plain step after qpos moves by ALOHA_QPOS_ULPS ulps: on P17's state
# B1's outputs lie a median 0.17 and at most 1.9 float32 ulps at scale
# from its plain version's in geom_xpos, 4.0 and 10.0 in geom_xmat (the
# same run); the plain version's after qpos + 1 ulp 0.33/2.1 and
# 4.0/8.0, after 2 ulps 0.46/3.2 and 5.5/10.0: 2 is the smallest of 1,
# 2, 4, 8 at B1's median and max in both (the collision stage's inputs,
# which the contacts' stiff rows carry into qacc).
ALOHA_OBJ_FACTOR = 1.19
ALOHA_QPOS_ULPS = 2
ALOHA_NWORLD = 8192
ALOHA_NCONMAX = 24
ALOHA_PREP = 4
ALOHA_COUNT = 6
ALOHA_NSTEP = 24
ALOHA_PROFILE = 2
ALOHA_REPLAY = 10
ALOHA_REPLAY_NSTEP = 10
ALOHA_TESTSPEED_NSTEP = 4
# aloha_sdf (phase v): the suite's row (benchmarks/scenes/config.txt:15),
# SDF_NWORLD worlds at nconmax SDF_NCONMAX; the same arms with SDF
# fingers over an SDF cow on a free joint. P18 starts from keyframe 0 as
# the suite does (benchmarks/suite.py:82-83); the rich state is keyframe
# gripper_gripper_pot (the fingers on the cow) with QPOS_NOISE on the
# arms, stepped SDF_PREP steps. Every SDF descent runs its 11 passes, as
# in the JAX package, so a step takes seconds (PERF.md): P18 is counted
# over SDF_COUNT steps, timed over SDF_NSTEP (a first step, SDF_NSTEP
# warm-up and one timed), its replay held against eager steps over
# SDF_REPLAY steps and profiled over SDF_PROFILE, testspeed's over
# SDF_TESTSPEED_NSTEP (a first, 1 warm-up, 1 timed). The SDF
# narrowphase is held in float32 against float64 on SDF_HOLD_WORLDS
# worlds of the rich state (`_hold_sdf_narrowphase`): a descent whose
# step-size choices agree in both (`collide`'s trace) gives dist, pos and
# frame within SDF_TOL of scale, but where the float64 descent itself
# moves by at least 1 / SDF_ULP_FACTOR of its error when the float32 geom
# frames move by a few ulps (the descent amplifies rounding: its steps
# and its normal follow the voxel grids' trilinear gradients, which turn
# with the point); those and the descents whose choices part may number
# SDF_PART_SHARE of those whose boxes meet. On the rich state (NVIDIA
# H100 80GB HBM3, 700 W; PERF.md) the parted and over-SDF_TOL descents
# are 0.14%, 0.14% and 0.71% of the box-, mesh- and SDF-SDF descents, so
# SDF_PART_SHARE is 1.5 x 0.71%. No one change excused every one of them
# (1, 4 and 8 ulps up and down left 29, 7 and 5 of SDF-SDF's 147; four
# random 4-ulp draws left 2 of box-SDF's 3), so the witness takes the
# largest move over them all, drawn in that order from SDF_WITNESS_SEED.
# B3e is held against the float64 solve as on aloha_pot (`_hold_b3e_aloha`) at
# SDF_OBJ_FACTOR: on the rich state, seeds 0-1 (`utils/rich_spread.py
# aloha_sdf`, NVIDIA H100 80GB HBM3, 700 W; PERF.md), the worlds more
# than TOL_OBJ units above the float64 objective: B3e 7 and 16, the
# float32 plain solve and its two perturbations at most 14 and 20; over
# the tolerances against the float64 solve: B3e 9 and 7, the plain trio
# at most 11 and 6; the largest excess, 1 world of 6 (16.7%), gives 1 +
# 1.5 x 0.167 = 1.25. P18's step is held against the all-plain step
# after qpos + SDF_QPOS_ULPS ulps (`_compare_step_exact`): there B1 lies
# a median 0.48 and at most 1.9 ulps at scale from its plain version in
# geom_xpos, 4.0 and 9.0 in geom_xmat, and the plain version after 1 ulp
# 0.62/1.9 and 4.0/9.0 (the same run): 1 is the smallest of 1, 2, 4, 8
# at both.
SDF_NWORLD = 8192
SDF_NCONMAX = 32
SDF_PREP = 2
SDF_COUNT = 2
SDF_NSTEP = 1
SDF_REPLAY = 1
SDF_PROFILE = 1
SDF_TESTSPEED_NSTEP = 1
SDF_HOLD_WORLDS = 256
SDF_TOL = 1e-4
SDF_WITNESS_ULPS = (1, 4, 8)
SDF_WITNESS_DRAWS = 4
SDF_WITNESS_SEED = 7
SDF_ULP_FACTOR = 4.0
SDF_PART_SHARE = 0.011
SDF_OBJ_FACTOR = 1.25
SDF_QPOS_ULPS = 1
# apptronik_apollo_hfield (phase w): the suite's row (benchmarks/scenes/
# config.txt:17), HFIELD_NWORLD worlds at nconmax HFIELD_NCONMAX; the
# robot of (s) and (t) on a 588 x 1,121 height field. P19 starts from
# keyframe 0 as the suite does (benchmarks/suite.py:82-83); it is counted
# over HFIELD_COUNT steps, timed over HFIELD_NSTEP (a first, 20 warm-up
# and 1 timed), its replay held against eager steps over HFIELD_REPLAY
# steps and profiled over HFIELD_PROFILE. B1, B3 and the height-field
# narrowphase are held on apollo's contact-rich state (`_apollo_rich`:
# the soles, shins and knees in the terrain). The narrowphase runs on the
# card in float32 against the same torch code in float64 on
# HFIELD_HOLD_WORLDS worlds (`_hold_hfield_narrowphase`): each float32
# candidate of a pair lies within HFIELD_TOL of scale of one of the
# pair's float64 candidates (dist, normal, and pos; for the prisms' MPR
# the position along the normal only, as its witness moves along a face
# with rounding), and both keep as many, in all but the larger of
# HFIELD_SHARE of the pairs and HFIELD_FACTOR times the pairs the float64
# collider itself parts in after a one-ulp move of the frames. On the
# rich state (NVIDIA H100 80GB HBM3, 700 W; PERF.md) the box prisms part
# in 32 of 507 pairs with a candidate, the float64 collider after one
# ulp up and down in 29 and 42: the deepest of 250 candidates and MPR's
# witness on a flat face turn on rounding; HFIELD_FACTOR is 1.5 as
# SDF_PART_SHARE's. The capsules part in 10 of 3,584 (0.28%) while one ulp
# moves none: the four candidates nearest the surface are chosen by
# |dist| + 1e-7 x index, a tie term at float32's resolution of dist, so
# near ties fall by the arithmetic's rounding; HFIELD_SHARE is about 3.5
# x that share. P19's step is held against the all-plain step by
# `_compare_step_exact` (its solve by apollo's rules, `_hold_b3_apollo`)
# after qpos moves by HFIELD_QPOS_ULPS: on P19's state B1 lies a median
# 0.39 and at most 1.9 ulps at scale from its plain version in
# geom_xpos, 1.75 and 4.0 in geom_xmat, the plain version after 1 ulp
# 0.88/2.2 and 2.52/5.5 (`utils/rich_spread.py apollo_hfield`, NVIDIA
# H100 80GB HBM3, 700 W): 1 is the smallest of 1, 2, 4, 8 at both. There
# a sole's contact moves along its flat face with B1's rounding (MPR's
# witness), and the rows and the solve follow it: 520 worlds part from
# the all-plain step by more than TOL_STEP_QACC in qacc, 541 after the
# plain version's own 1-ulp move.
HFIELD_NWORLD = 8192
HFIELD_NCONMAX = 32
HFIELD_COUNT = 4
HFIELD_NSTEP = 22
HFIELD_REPLAY = 10
HFIELD_PROFILE = 2
HFIELD_HOLD_WORLDS = 256
HFIELD_TOL = 1e-4
HFIELD_SHARE = 0.01
HFIELD_FACTOR = 1.5
HFIELD_QPOS_ULPS = 1
# Phase (x), kitchen (benchmarks/scenes/kitchen/kitchen.xml, the suite's
# row, benchmarks/suite.py:42-48): 256 worlds, nconmax 64, from qpos0
# (the model has no keyframe), eager (the unfused solve syncs the host
# each pass). P20 runs KITCHEN_NSTEP steps in all (the harness's first,
# 20 warm-up and the rest timed): the suite's 100. B1, B5, B7 and B7
# euler are held on the rich state (`_kitchen_rich`: the joints drawn
# across their ranges, doors through doors, cylinders on boxes and on
# cylinders); the MPR families' narrowphase in float32 against float64
# by P19's witness rule (`_hold_sap_narrowphase`): a pair is off over
# KITCHEN_TOL (P19's HFIELD_TOL) or with another number of contacts,
# and the off pairs may number the larger of the family's KITCHEN_SHARE
# of the pairs with a candidate and KITCHEN_FACTOR times the witness's
# (the float64 collider after one ulp of the frames). Float32 MPR
# between cylinders parts from float64 by more than the other
# narrowphases (flat caps and sides), and more often than its witness:
# each share is set between float32's and a control's (the float32
# collider on frames rounded to float16), which the hold must fail
# (mujoco_warp_tpu_torch/utils/mpr_spread.py on the rich state at 256
# worlds, NVIDIA H100 80GB HBM3 at 700 W: off 0.430 of the
# cylinder-cylinder pairs with a candidate and 0.129 of the
# cylinder-box ones in float32, 0.903 and 0.789 in the control, the
# witness 31 of 402 and 443 of 4,565; the CPU at 64 worlds: 0.415 and
# 0.130, 0.919 and 0.774).
# P20's step against the all-plain step (`_compare_step_exact`): the
# pool is full (64 of several hundred contacts, many resting face on
# face at ties in dist), so a change of B1's outputs by an ulp changes
# which contacts fill it, and with them efc_J and qacc, in most worlds
# whose row sets still agree (mujoco_warp_tpu_torch/utils/pool_spread.py
# measures it). The all-plain step's own spread is taken after B1's
# outputs move by one ulp (`_smooth_moved`), not after qpos moves: the
# noise clips joints to their ranges, and an ulp past a bound flips a
# limit row in every world.
KITCHEN_NWORLD = 256
KITCHEN_NCONMAX = 64
KITCHEN_NSTEP = 100
KITCHEN_TOL = 1e-4
KITCHEN_SHARE = {'cylinder-cylinder': 0.55, 'cylinder-box': 0.3}
KITCHEN_FACTOR = 2.0
KITCHEN_QVEL = 0.1
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 flop/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def _rel_err(a, b) -> tuple[float, float]:
  """(max abs error, max abs error / max(1, max |b|))."""
  a, b = a.float(), b.float()
  if b.numel() == 0:
    return 0.0, 0.0
  err = float((a - b).abs().max())
  return err, err / max(1.0, float(b.abs().max()))


def _compare(name, out, ref, tol, keys, worlds=None, scale=None) -> float:
  """Print and check float fields; returns the max abs error. scale maps
  a field to the error scale that replaces max(1, max |plain|)."""
  worst = 0.0
  for k in keys:
    a, b = out[k], ref[k]
    if worlds is not None:
      a, b = a[worlds], b[worlds]
    t = tol[k] if isinstance(tol, dict) else tol
    err, rel = _rel_err(a, b)
    if scale and k in scale:
      rel = err / scale[k]
    worst = max(worst, err)
    print(f'  {name} {k:18s} abs {err:.3e} rel {rel:.3e} (tol {t:g})')
    if not rel <= t:
      raise RuntimeError(f'{name}: {k} differs from the plain version: '
                         f'{rel:.3e} > {t:g}')
  return worst


def _worlds_over(out, ref, tol, keys):
  """Per world, whether a field of keys lies over its tolerance (tol[k] of
  max(1, max |plain|) over the batch, as _compare); and those scales."""
  import torch
  W = ref[keys[0]].shape[0]
  over = torch.zeros(W, dtype=torch.bool, device=ref[keys[0]].device)
  scale = {}
  for k in keys:
    scale[k] = max(1.0, float(ref[k].abs().max()))
    err = (out[k].float() - ref[k].float()).abs().reshape(W, -1).amax(1)
    over |= err / scale[k] > tol[k]
  return over, scale


class LotteryShown(RuntimeError):
  """A solve's per-world criteria failed as the linesearch lottery fails
  them (more worlds than LOTTERY_WORLDS miss them, or one reaches a
  higher objective in as many iterations): the caller may hold that
  solve by the counts rule instead (see ELLIPTIC), as P11's step is
  held."""


def _hold_lottery(label, miss, gap, niter, niter_p):
  """Hold the worlds `miss` (bool over worlds) that missed a per-world
  criterion of a solve (see LOTTERY_WORLDS), given each world's
  objective less the plain solve's (units) and both solver_niter."""
  idx = miss.nonzero()[:, 0]
  print(f'  {label}: {idx.numel()} worlds miss a per-world criterion '
        f'(allowed {LOTTERY_WORLDS}): {idx.tolist()}, objective less the '
        f'plain solve\'s {[float(f"{g:.3g}") for g in gap[idx].tolist()]} '
        f'units, solver_niter {niter[idx].tolist()}, plain '
        f'{niter_p[idx].tolist()}')
  if idx.numel() > LOTTERY_WORLDS:
    raise LotteryShown(f'{label}: {idx.numel()} worlds miss the per-world '
                       f'criteria (allowed {LOTTERY_WORLDS})')
  if bool((miss & (gap > TOL_OBJ) & (niter >= niter_p)).any()):
    raise LotteryShown(f'{label}: a world that misses the per-world '
                       f'criteria has a higher objective than the plain '
                       f'solve reaches in as many iterations')


def _hold_solve(label, m, out, ref, tol, n_in) -> float:
  """Hold a solve's outputs (B3's or B4's) against the plain version's
  per world: each field of tol at its tolerance, the float64 objective on
  the solve's inputs n_in (qM, efc_J, D, aref, frictionloss,
  qfrc_smooth) within TOL_OBJ units of tolerance * meaninertia * nv, and
  solver_niter within NITER_MAX; a world that misses one of them held by
  _hold_lottery. Returns the max abs error of the other worlds."""
  from mujoco_warp_tpu_torch import solver
  from mujoco_warp_tpu_torch.io import efc_layout
  f64 = lambda x: x.double()
  qfs = f64(n_in[5])
  qsm = solver.cho_solve(solver.cholesky(f64(n_in[0])), qfs)
  ne, nf, _, _, _ = efc_layout(m, 0)
  objective = lambda qacc: solver.objective(
      *[f64(x) for x in n_in[:5]], qfs, qsm, f64(qacc), ne, nf)
  unit = float(m.opt.tolerance) * float(m.stat.meaninertia) * max(1, m.nv)
  gap = (objective(out['qacc']) - objective(ref['qacc'])) / unit
  dn = (out['solver_niter'] - ref['solver_niter']).abs()
  over, scale = _worlds_over(out, ref, tol, list(tol))
  miss = over | (gap.abs() > TOL_OBJ) | (dn > NITER_MAX)
  _hold_lottery(label, miss, gap, out['solver_niter'], ref['solver_niter'])
  worst = _compare(label, out, ref, tol, list(tol), worlds=~miss,
                   scale=scale)
  print(f'  {label} objective gap / (tolerance * meaninertia * nv): max '
        f'{float(gap[~miss].abs().max()):.3e} over the other worlds (tol '
        f'{TOL_OBJ:g}); solver_niter |diff| histogram '
        f'{dn.bincount().tolist()}')
  return worst


def _box_ties(m, c_in, c_out, c_ref):
  """Per pool slot (W, nconmax) of B2's inputs c_in and outputs: a
  plane-box contact at the plain version's depth whose point is not the
  plain version's but that of another corner of the same box at that
  depth (two corners' depths tied, the tie broken the other way), each
  within TOL_B2 of the points' scale. False on a model without
  plane-box pairs."""
  import torch
  from mujoco_warp_tpu_torch.types import GeomType
  geom = c_ref['geom'].long()
  valid = geom[..., 0] >= 0
  g1, g2 = geom[..., 0].clamp(min=0), geom[..., 1].clamp(min=0)
  gtype = torch.tensor(m.geom_type, device=geom.device)
  box = valid & (gtype[g1] == GeomType.PLANE) & (gtype[g2] == GeomType.BOX)
  if not bool(box.any()):
    return box
  tol = TOL_B2 * max(1.0, float(torch.where(valid[..., None], c_ref['pos'],
                                            0).abs().max()))
  w = torch.arange(geom.shape[0], device=geom.device)[:, None]
  xpos, xmat = c_in[2], c_in[3]
  p1, n = xpos[w, g1], xmat[w, g1][..., :, 2]
  signs = torch.tensor([[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0)
                        for z in (-1.0, 1.0)], device=geom.device)
  corners = xpos[w, g2][..., None, :] + torch.einsum(
      'wcij,wckj->wcki', xmat[w, g2], signs * m.geom_size[g2][..., None, :])
  depth = ((corners - p1[..., None, :]) * n[..., None, :]).sum(-1)
  dist = c_ref['dist']
  point = corners - 0.5 * dist[..., None, None] * n[..., None, :]
  on_corner = (((point - c_out['pos'][..., None, :]).abs().amax(-1) <= tol) &
               ((depth - dist[..., None]).abs() <= tol)).any(-1)
  err = lambda k: (c_out[k] - c_ref[k]).abs()
  return (box & (err('dist') <= tol) & (err('pos').amax(-1) > tol) &
          on_corner)


def _untie(c_out, c_ref, tie_slot):
  """c_out with the values that a tied slot's other corner moves (its
  point, and efc_J, efc_vel and efc_aref of its rows) taken from c_ref."""
  import torch
  from mujoco_warp_tpu_torch.types import ConstraintType
  kinds = torch.tensor([int(ConstraintType.CONTACT_FRICTIONLESS),
                        int(ConstraintType.CONTACT_PYRAMIDAL),
                        int(ConstraintType.CONTACT_ELLIPTIC)],
                       dtype=c_ref['efc_type'].dtype,
                       device=tie_slot.device)
  slot = c_ref['efc_id'].long().clamp(0, tie_slot.shape[1] - 1)
  row = torch.isin(c_ref['efc_type'], kinds) & torch.gather(tie_slot, 1,
                                                             slot)
  out = dict(c_out, pos=torch.where(tie_slot[..., None], c_ref['pos'],
                                    c_out['pos']))
  for k in ('efc_J', 'efc_vel', 'efc_aref'):
    mask = row.reshape(row.shape + (1,) * (c_out[k].dim() - 2))
    out[k] = torch.where(mask, c_ref[k], c_out[k])
  return out


def _check_contact(name, m, c_in, c_out, c_ref) -> float:
  """Hold kernel B2's outputs on the inputs c_in against its plain
  version's: the same contact and row sets, except in a few worlds at an
  activation threshold, and the float fields at TOL_B2, but for the
  values a plane-box tie broken the other way moves (_box_ties), whose
  worlds count against the same few."""
  import torch
  from mujoco_warp_tpu_torch.collision_driver import _EMPTY_DIST
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.types import ConstraintType
  nworld = c_ref['ncon'].shape[0]
  discrete = ('ncon', 'ncollision', 'ne', 'nf', 'nl', 'nefc', 'dim', 'geom',
              'efc_address', 'efc_type', 'efc_id', 'efc_active')
  same = torch.ones(nworld, dtype=torch.bool, device=c_ref['ncon'].device)
  for k in discrete:
    eq = c_out[k] == c_ref[k]
    same &= eq.reshape(nworld, -1).all(1)
  # a world may differ only through a contact or limit at its activation
  # threshold, where the two versions' rounding decides
  valid = c_ref['geom'][..., 0] >= 0
  gap_c = torch.where(valid, (c_ref['dist'] - c_ref['includemargin']).abs(),
                      float('inf')).amin(1)
  valid_k = c_out['geom'][..., 0] >= 0
  gap_k = torch.where(valid_k, (c_out['dist'] -
                                c_out['includemargin']).abs(),
                      float('inf')).amin(1)
  lim = c_ref['efc_type'] == int(ConstraintType.LIMIT_JOINT)
  gap_l = torch.where(lim, (c_ref['efc_pos'] - c_ref['efc_margin']).abs(),
                      float('inf')).amin(1)
  near = torch.minimum(torch.minimum(gap_c, gap_k), gap_l)
  bad = ~same
  nbad = int(bad.sum())
  print(f'  {name} worlds with a different contact/row set: {nbad} of '
        f'{nworld}')
  if bool((near[bad] >= 1e-4).any()):
    raise RuntimeError(f'{name}: {nbad} worlds differ in their contact '
                       f'sets, not all at an activation threshold')
  tie_slot = _box_ties(m, c_in, c_out, c_ref) & same[:, None]
  tie = tie_slot.any(1)
  ntie = int(tie.sum())
  print(f'  {name} worlds whose box-corner tie broke the other way: {ntie} '
        f'{tie.nonzero()[:, 0].tolist()[:20]}, depths '
        f'{c_ref["dist"][tie_slot][:5].tolist()}')
  if nbad + ntie > max(8, nworld // 1000):
    raise RuntimeError(f'{name}: {nbad} worlds differ in their contact '
                       f'sets and {ntie} in a tie\'s order')
  c_out = _untie(c_out, c_ref, tie_slot)
  floats = [k for k in c_ref if k not in discrete]
  # aref = -b vel - k imp pos carries vel's rounding times the damping b
  t = _build.model_tables(m, 'contact', kc._tables)
  solref = torch.cat([t['pair_float'][:, 5], t['lim_float'][:, 3],
                      t['fr_float'][:, 0], t['eq_float'][:, 8]])
  dmax = torch.cat([t['pair_float'][:, 10], t['lim_float'][:, 6],
                    t['fr_float'][:, 3],
                    t['eq_float'][:, 11]]).clamp(1e-4, 0.9999)
  bmax = float((2.0 / (dmax * torch.clamp(
      solref, min=2.0 * float(m.opt.timestep)))).max())
  aref_scale = max(1.0, float(c_ref['efc_aref'][same].abs().max()),
                   bmax * float(c_ref['efc_vel'][same].abs().max()))
  print(f'  {name} efc_aref error scale {aref_scale:.1f} (damping b up to '
        f'{bmax:.1f} times |efc_vel|)')
  # an empty slot's dist and its rows' efc_pos hold _EMPTY_DIST, held
  # exactly: the error scale is the other values'
  scale = {'efc_aref': aref_scale}
  for k in ('dist', 'efc_pos'):
    x = c_ref[k][same]
    scale[k] = max(1.0, float(torch.where(x == _EMPTY_DIST, 0, x).abs()
                              .max()))
  return _compare(name, c_out, c_ref, TOL_B2, floats, worlds=same,
                  scale=scale)


def _cuda_ms(fn, reps: int) -> float:
  import torch
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def _profile(fn, nstep: int, lead: int = PROFILE_LEAD
             ) -> list[tuple[str, float, float]]:
  """(kernel name, launches per step, device ms per step) over fn(), which
  runs nstep steps, most device time first, between `lead` kernels of the
  profile's own and PROFILE_TRAIL more (see PROFILE_LEAD and
  PROFILE_TRAIL), which it leaves out and counts in PROFILE_OWN; empty if
  the profiler saw no device events. The profiler records the card's
  activity alone."""
  import torch
  torch.cuda.synchronize()
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    for _ in range(lead):
      torch.cuda._sleep(PROFILE_LEAD_CYCLES)
    torch.cuda.synchronize()
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRAIL):
      torch.cuda._sleep(PROFILE_LEAD_CYCLES)
    torch.cuda.synchronize()
  per_name = collections.defaultdict(lambda: [0, 0.0])
  own = 0
  for name, ms in _device_records(prof):
    if 'spin_kernel' in name:
      own += 1
      continue
    per_name[name][0] += 1
    per_name[name][1] += ms
  PROFILE_OWN.update(recorded=own, launched=lead + PROFILE_TRAIL)
  return sorted(((n, c / nstep, ms / nstep) for n, (c, ms)
                 in per_name.items()), key=lambda r: -r[2])


def _device_records(prof) -> list[tuple[str, float]]:
  """(name, device ms) of each of a finished profile's device records
  (`compare_trees.device_records`). The first profile of a run reads them
  both ways (see RAW_RECORDS) and keeps the raw records for the run only
  where the two ways agree."""
  from mujoco_warp_tpu_torch.utils.compare_trees import device_records
  if RAW_RECORDS['ok'] is None:
    slow, fast = device_records(prof, raw=False), device_records(prof)
    if not slow:
      return slow
    same = sorted(n for n, _ in fast) == sorted(n for n, _ in slow) and \
        math.isclose(sum(t for _, t in fast), sum(t for _, t in slow),
                     rel_tol=1e-9, abs_tol=1e-9)
    RAW_RECORDS['ok'] = same
    print(f'  profiler: the raw records {"agree" if same else "disagree"} '
          f'with events() on the first profile ({len(slow)} device '
          f'records); {"raw records" if same else "events()"} for the rest '
          f'of the run')
    return slow
  return device_records(prof, raw=RAW_RECORDS['ok'])


def _nbytes(*groups) -> int:
  total = 0
  for g in groups:
    vals = g.values() if isinstance(g, dict) else g
    total += sum(v.numel() * v.element_size() for v in vals
                 if hasattr(v, 'numel'))
  return total


def _record(records, name, launches, err, source, replaces, run, plain,
            nbytes, flops, library=None):
  """Time a kernel (20 launches), its plain version (3) and, where one
  PyTorch call computes the same function, that call (20); append the
  kernel's record with its bound. The kernel's time is the card's busy
  time per launch (torch.profiler; the host's time between launches
  left out, which CUDA events around the launches would count where the
  wrapper takes longer than its kernel); both are printed."""
  from mujoco_warp_tpu_torch.utils.compare_trees import device_ms
  wall_ms = _cuda_ms(run, 20)
  ms = device_ms(run, 20) or wall_ms
  plain_ms = _cuda_ms(plain, 3)
  library_ms = _cuda_ms(library, 20) if library else None
  bound_b = nbytes / PEAK_BYTES * 1e3
  bound_f = flops / PEAK_F32 * 1e3
  records.append(dict(
      name=name, route='cuda', source=source, replaces=replaces,
      launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
      bound_ms=max(bound_b, bound_f),
      bound_by='bytes' if bound_b >= bound_f else 'operations',
      library_ms=library_ms))
  lib = f', library {library_ms:.4f} ms' if library else ''
  print(f'  {name}: {ms:.4f} ms on the card, {wall_ms:.4f} ms a launch '
        f'from the host (plain {plain_ms:.3f} ms{lib}), bound '
        f'{max(bound_b, bound_f):.4f} ms by '
        f'{records[-1]["bound_by"]} ({nbytes / 1e6:.1f} MB, '
        f'{flops / 1e9:.3f} GFLOP)')


def _flops_b1(m, W) -> float:
  """B1's operations, estimated from the model's sizes."""
  chain = sum(len(r) for r in m.dof_ancestor_rows)
  return W * (430 * m.nbody + 130 * m.njnt + 90 * m.ngeom + 140 * m.nv +
              12 * chain)


def _bytes_b2(m, c_in, c_out, *extra) -> int:
  """The bytes B2 must move: its inputs, of geom_xpos and geom_xmat only
  the geoms of its candidate table (48 B a world each: franka reads 4 of
  its 23), its outputs, its tables and `extra`."""
  import torch
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import contact as kc
  t = _build.model_tables(m, 'contact', kc._tables)
  ngeom = int(torch.unique(t['pair_int'][:, 2:4]).numel())
  return (_nbytes(c_in[:2], c_in[4:], c_out, t, *extra) +
          c_in[2].shape[0] * ngeom * 48)


def _flops_b2(m, W, c_out, nconmax) -> float:
  """B2's operations, from the model's pairs and this run's contacts."""
  import mujoco_warp_tpu_torch as mt
  # plane-box: four candidate rows, each the center's and the axes' depths
  # (26), its corner and point (24) and the frame (20); row k takes k + 1
  # passes over the 8 corners, each a depth (3 sums) and 3 comparisons.
  # capsule-box: 33 + 2 x 5 x 9 distances to the box (40 each) and two
  # contacts (100). box-box: eight candidate rows, each the separating
  # axes (480) and the 24 candidates of a manifold (40 each), row k then
  # k + 1 passes over them (3 comparisons each)
  pair_flops = {(0, 2): 25, (0, 3): 50, (2, 2): 30, (2, 3): 55, (3, 3): 90,
                (0, 6): 4 * 70 + (1 + 2 + 3 + 4) * 8 * 6,
                (3, 6): 123 * 40 + 2 * 100,
                (6, 6): 8 * (480 + 24 * 40) + 36 * 24 * 3}
  per_pair = sum(len(gl) * pair_flops[(t1, t2)]
                 for t1, t2, gl in m.collision_pairs)
  ncon = c_out['ncon'].double().sum().item()
  ne, _, nl, stride, _ = mt.efc_layout(m, nconmax)
  return (W * (per_pair + 45 * (ne + nl)) +
          ncon * (60 + m.nv * (45 + 4 * stride)))


def _print_profile(label, fn, nstep, step_ms, card, nworld=NWORLD):
  """Profile fn (nstep steps of nworld worlds): device
  time per kernel name and the busy share against the host-clock step_ms;
  returns the profile's rows."""
  rows = _profile(fn, nstep)
  device_ms = sum(r[2] for r in rows)
  for name, calls, ms in rows[:8]:
    print(f'  {label}: {ms:9.4f} ms/step {calls:6.1f} launches/step  '
          f'{name[:80]}')
  print(json.dumps({label: dict(
      steps=nstep, step_ms=step_ms, steps_per_sec=nworld / step_ms * 1e3,
      device_ms=device_ms if rows else 'not measured',
      busy_share=device_ms / step_ms if rows else 'not measured',
      launches_per_step=sum(r[1] for r in rows),
      top=[dict(name=n[:80], launches_per_step=c, ms_per_step=ms)
           for n, c, ms in rows[:8]], card=card)}))
  return rows


@contextlib.contextmanager
def _plain_kernels():
  """Swap each kernel wrapper for its plain version, for the all-plain
  reference step on the card (which launches and counts nothing)."""
  from mujoco_warp_tpu_torch import batch_linalg, forward, smooth, solver
  from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import newton as kn
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  saved = (ks.smooth, kc.contact, kg.glue, kn.newton_solve, kb.tree_ldl,
           kb.spd_solve, kb.tree_solve, kb.cho_solve)
  ks.smooth, kc.contact, kg.glue = smooth.smooth, kc.plain, forward.glue
  kn.newton_solve = solver.newton_solve
  kb.tree_ldl = batch_linalg.tree_ldl_solve_batched
  kb.spd_solve = batch_linalg.spd_solve_batched
  kb.tree_solve = batch_linalg.tree_solve_from_factor_batched
  kb.cho_solve = batch_linalg.cho_solve_batched
  yield
  (ks.smooth, kc.contact, kg.glue, kn.newton_solve, kb.tree_ldl,
   kb.spd_solve, kb.tree_solve, kb.cho_solve) = saved


def _check_solve(name, a, b, x, x_plain, x64) -> float:
  """Hold a kernel's solution x of a x = b by its per-world residual and
  its forward error (see TOL_RES); returns max |x - x_plain|."""
  import torch
  a64, b64, xd = a.double(), b.double(), x.double()
  r = (torch.einsum('wij,wj->wi', a64, xd) - b64).abs().amax(1)
  res = r / (a64.abs().sum(2).amax(1) * xd.abs().amax(1) + b64.abs().amax(1))
  scale = float(x64.abs().max())
  err = float((xd - x64).abs().max()) / scale
  err_plain = float((x_plain.double() - x64).abs().max()) / scale
  diff = float((x - x_plain).abs().max())
  print(f'  {name} residual max {float(res.max()):.3e} (tol {TOL_RES:g}); '
        f'off the float64 plain version: kernel {err:.3e}, plain '
        f'{err_plain:.3e} of scale {scale:.3e}; |kernel - plain| {diff:.3e}')
  if not float(res.max()) <= TOL_RES:
    raise RuntimeError(f'{name}: residual {float(res.max()):.3e}')
  if not err <= FWD_FACTOR * err_plain + FWD_FLOOR:
    raise RuntimeError(f'{name}: forward error {err:.3e} > {FWD_FACTOR:g} '
                       f'x {err_plain:.3e} + {FWD_FLOOR:g}')
  return diff


def _check_newton(label, m, out, ref, n_in, hb) -> float:
  """Hold kernel B4's outputs to the criteria B3's solve is held to (see
  TOL_B3): per world the step tolerances, the solve's objective and
  solver_niter, a world that misses them held by _hold_lottery (see
  LOTTERY_WORLDS); qLD against solver.cholesky. With hb ((nv,) or per
  world), qacc_euler =
  (qM + diag(hb))^-1 (qfrc_smooth + qfrc_constraint) is a linear image
  of qfrc_constraint through an ill-conditioned inverse (the hands'
  inertias are ~1e-3), so it is held at qfrc_constraint's tolerance and,
  per world, by the residual of that system with the kernel's own
  qfrc_constraint (TOL_RES). Returns the max abs error."""
  import torch
  from mujoco_warp_tpu_torch import solver
  tol = dict(qacc=TOL_B3_OTHER, qacc_smooth=TOL_B3_OTHER,
             qacc_euler=TOL_B3_OTHER if hb is None else 5e-4,
             qfrc_constraint=5e-4, efc_force=5e-4)
  worst = _hold_solve(label, m, out, ref, tol, n_in)
  if hb is not None:
    a = n_in[0].double() + torch.diag_embed(hb.double())
    rhs = n_in[5].double() + out['qfrc_constraint'].double()
    x = out['qacc_euler'].double()
    r = (torch.einsum('wij,wj->wi', a, x) - rhs).abs().amax(1)
    res = float((r / (a.abs().sum(2).amax(1) * x.abs().amax(1) +
                      rhs.abs().amax(1))).max())
    print(f'  {label} re-solve residual max {res:.3e} (tol {TOL_RES:g})')
    if not res <= TOL_RES:
      raise RuntimeError(f'{label}: qacc_euler misses its system')
  worst = max(worst, _compare(label, {'qLD': out['qLD']},
                              {'qLD': solver.cholesky(n_in[0])}, TOL_B1,
                              ['qLD']))
  if hb is None and not torch.equal(out['qacc_euler'], out['qacc']):
    raise RuntimeError(f'{label}: qacc_euler != qacc without hb')
  return worst


def _check_glue_diag(label, m, mode, g_in) -> float:
  """Hold B3 (B3e with `cone`) in glue mode 1 or 2 against its plain
  version on the inputs g_in: the re-solve with the integration diagonal
  (h * dof_damping in mode 1; in mode 2 each world's, built in the kernel
  from the raw ctrl, `forward.integration_diag`) held as B4's hb case
  (_check_newton), the advance against the kernel's own qacc_euler, the
  forces before the solve at B3's tolerances, and two launches bit-equal.
  The mode changes the re-solve alone: every other output equals B3's in
  mode 0 on the same inputs, bit for bit. Returns the max abs error."""
  import torch
  from mujoco_warp_tpu_torch import forward
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.types import DisableBit, IntegratorType
  if forward.glue_mode(m) != mode:
    raise RuntimeError(f'{label}: glue mode {forward.glue_mode(m)}')
  out, ref = kg.glue(m, *g_in), forward.glue(m, *g_in)
  m0 = m.replace(opt=m.opt.replace(
      integrator=int(IntegratorType.EULER),
      disableflags=int(m.opt.disableflags) | int(DisableBit.EULERDAMP)))
  base = kg.glue(m0, *g_in)
  diff = [k for k in kg.OUTPUTS if k not in ('qacc_euler', 'qvel', 'qpos')
          and not torch.equal(out[k], base[k])]
  print(f'  {label} against mode 0 on the same inputs, all but the '
        f're-solve and the advance: '
        f'{"bit-equal" if not diff else "differ in " + str(diff)}')
  if diff:
    raise RuntimeError(f'{label}: differs from mode 0 in {diff}')
  h = float(m.opt.timestep)
  err = _check_newton(label, m, out, ref,
                      g_in[:5] + (ref['qfrc_smooth'], g_in[9]),
                      forward.integration_diag(m, g_in[7]))
  qvel = g_in[6] + h * out['qacc_euler']
  _compare(f'{label} advance', out, dict(
      qvel=qvel, qpos=forward.integrate_pos(m, g_in[5], qvel, h)),
           dict(qvel=TOL_B3_OTHER, qpos=TOL_B3['qpos']), ['qvel', 'qpos'])
  tol = {k: TOL_B3.get(k, TOL_B3_OTHER) for k in kg.OUTPUTS}
  err = max(err, _compare(label, out, ref, tol, [
      'actuator_force', 'qfrc_actuator', 'qfrc_spring', 'qfrc_damper',
      'qfrc_passive', 'qfrc_smooth']))
  _check_repeat(label, lambda: kg.glue(m, *g_in))
  return err


def _servo(m):
  """The model m with its actuators made velocity-damped servos: AFFINE
  bias with biasprm[2] = -SERVO_KV / gear0^2 and AFFINE gain with
  gainprm[2] = SERVO_GV / gear0^2, so that each dof's actuator term of
  qDeriv is of the order of its damping and moves with ctrl."""
  from mujoco_warp_tpu_torch.types import BiasType, GainType
  g2 = m.actuator_gear[:, 0] ** 2
  gain, bias = m.actuator_gainprm.clone(), m.actuator_biasprm.clone()
  gain[:, 2] = SERVO_GV / g2
  bias[:, 2] = -SERVO_KV / g2
  return m.replace(actuator_gaintype=(int(GainType.AFFINE),) * m.nu,
                   actuator_biastype=(int(BiasType.AFFINE),) * m.nu,
                   actuator_gainprm=gain, actuator_biasprm=bias)


def _mode2_checks(m, g_in, m1, card) -> float:
  """Phase (c)'s mode-2 checks on the glue inputs g_in of the humanoid
  m: B3 in mode 2 (opt.integrator=implicitfast), whose diagonal on the
  humanoid is h * damping alone (its motors have no velocity terms), and
  on the servo variant (`_servo`) with seeded ctrl uniform in
  [-SERVO_CTRL, SERVO_CTRL], so that some lies outside its range [-1, 1]
  (the diagonal reads the raw ctrl, the forces the clamped one). Returns
  the max abs error."""
  import torch
  from mujoco_warp_tpu_torch.types import IntegratorType
  m2 = m.replace(opt=m.opt.replace(
      integrator=int(IntegratorType.IMPLICITFAST)))
  err = _check_glue_diag('B3 mode 2', m2, 2, g_in)
  servo = _servo(m2)
  gen = torch.Generator(device=g_in[7].device).manual_seed(SEED)
  ctrl = SERVO_CTRL * (2 * torch.rand(g_in[7].shape, generator=gen,
                                      device=g_in[7].device) - 1)
  lo, hi = servo.actuator_ctrlrange[:, 0], servo.actuator_ctrlrange[:, 1]
  share = float(((ctrl < lo) | (ctrl > hi)).float().mean())
  print(f'  B3 mode 2 servo: {share:.3f} of the ctrl values outside their '
        f'range')
  if not 0 < share < 1:
    raise RuntimeError('B3 mode 2 servo: no ctrl outside its range')
  servo_in = g_in[:7] + (ctrl,) + g_in[8:]
  err = max(err, _check_glue_diag('B3 mode 2 servo', servo, 2, servo_in))
  # the modes on the same inputs, in turns
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.utils.compare_trees import device_ms
  runs = (('mode 0', m, g_in), ('mode 1', m1, g_in), ('mode 2', m2, g_in),
          ('mode 2 servo', servo, servo_in))
  times = collections.defaultdict(list)
  for turn in (runs, runs[::-1]):
    for label, mm, args in turn:
      times[label].append(device_ms(lambda: kg.glue(mm, *args), 20))
  print(f'  B3 on the same inputs, ms on the card (two turns): '
        f'{ {k: [round(t, 4) for t in v] for k, v in times.items()} } '
        f'({card})')
  return err


def _check_factor_solve(name, a64, b, x, x_plain, x64, x_producer):
  """Hold a solve from a factor: residual and forward error on the matrix
  a64 the factor represents exactly (see TOL_RES), and the producing
  kernel's own x for the same b at TOL_B1."""
  err = _check_solve(name, a64, b, x, x_plain, x64)
  _compare(name, {'x vs the factoring kernel': x},
           {'x vs the factoring kernel': x_producer}, TOL_B1,
           ['x vs the factoring kernel'])
  return err


def _flops_newton(nv, nact, it, nu=0) -> float:
  """Operations of the Newton solve (B3, B4): nact acting rows and it
  iterations per world (tensors over worlds)."""
  per_iter = (4 * nact * nv + 4 * nv * nv + 16 * 8 * nact + 12 * nact +
              nact * nv * (nv + 1) + nv ** 3 / 3 + 2 * nv * nv + 20 * nv)
  return float((nv ** 3 / 3 + 2 * nv * nv + 20 * nu + 10 * nv +
                4 * nact * nv + it * per_iter).sum())


# the kernels that run one warp per world: (source, kernel, C entry); a
# template instantiation is named with its argument
WARP_KERNELS = (('glue', 'glue_kernel', ''), ('newton', 'newton_kernel', ''),
                ('glue', 'glue_ell_kernel', 'ell_'),
                ('newton', 'newton_ell_kernel', 'ell_'),
                ('contact', 'contact_kernel', ''),
                ('contact', 'contact_ell_kernel', 'ell_'),
                ('contact', 'contact_eqbox_kernel', 'eqbox_'),
                ('contact', 'contact_eqbox_ell_kernel', 'eqbox_ell_'),
                ('contact', 'contact_box_kernel', 'box_'),
                ('contact', 'contact_box_ell_kernel', 'box_ell_'),
                ('smooth', 'smooth_stages<63>', ''),
                ('smooth', 'smooth_stages<2>', 'kin_'),
                ('smooth', 'smooth_stages<8>', 'com_'),
                ('smooth', 'smooth_stages<16>', 'crb_'),
                ('smooth', 'smooth_stages<26>', 'front_'),
                ('batch_linalg', 'spd_solve_kernel', 'spd_solve_'),
                ('batch_linalg', 'cho_solve_kernel', 'cho_solve_'),
                ('batch_linalg', 'tree_ldl_kernel', 'tree_ldl_'),
                ('batch_linalg', 'tree_solve_kernel', 'tree_solve_'))


def _check_warp_kernels_ptxas():
  """The kernels of WARP_KERNELS run one warp per world with their state
  in shared memory: ptxas must report no spill stores and at most
  MAX_STACK_B3 bytes of stack for them."""
  from mujoco_warp_tpu_torch.kernels import _build
  for source, kernel, _ in WARP_KERNELS:
    rep = _build.kernel_report(source, kernel)
    print(f'  ptxas {kernel}: {rep.get("registers")} registers, '
          f'{rep.get("stack")} B stack, {rep.get("spill_stores")} B spill '
          f'stores, {rep.get("spill_loads")} B spill loads, '
          f'{rep.get("smem")} B static shared memory')
    if rep.get('spill_stores') != 0 or rep.get('stack', 1 << 30) > \
        MAX_STACK_B3:
      raise RuntimeError(f'{kernel}: spills or stack past {MAX_STACK_B3} B')


def _print_warp_shapes(label, kernels, nworld=NWORLD):
  """The launch shape of the last launch (at nworld worlds) of each warp
  kernel named in `kernels`, keyed by its source and C entry."""
  from mujoco_warp_tpu_torch.kernels import _build
  for source, kernel, entry in WARP_KERNELS:
    if kernel not in kernels:
      continue
    grid, block, smem, per_sm = _build.shapes[(source, entry)]
    worlds = -(-nworld // grid)
    print(f'  {kernel} ({source}, entry {entry!r}) launch, {label}: grid '
          f'{grid}, block {block} threads ({worlds} worlds, '
          f'{block // worlds} lanes a world), {smem} B dynamic shared '
          f'memory ({smem // worlds} B a world); {per_sm} blocks '
          f'({per_sm * worlds} worlds, {per_sm * block // 32} warps) '
          f'resident per SM')


def _check_repeat(label, fn):
  """Two launches on the same inputs give the same bits (every sum in
  the kernel runs in a fixed order, without atomics)."""
  import torch
  a, b = fn(), fn()
  diff = [k for k in a if not torch.equal(a[k], b[k])]
  print(f'  {label} two launches: '
        f'{"bit-equal" if not diff else "differ in " + str(diff)}')
  if diff:
    raise RuntimeError(f'{label}: two launches differ in {diff}')


def _reset_counts():
  from mujoco_warp_tpu_torch import solver
  from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import newton as kn
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  for mod in (ks, kc, kg, kn):
    mod.launches = 0
  kg.launches_ell = kn.launches_ell = 0
  ks.launches_front = ks.launches_kin = ks.launches_com = ks.launches_crb = 0
  kb.launches.update(dict.fromkeys(kb.launches, 0))
  kb.launches_no_factor = 0
  solver.counts.update(dict.fromkeys(solver.counts, 0))


def _read_counts() -> dict:
  from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import newton as kn
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  return dict(smooth=ks.launches, contact=kc.launches, glue=kg.launches,
              glue_ell=kg.launches_ell, newton=kn.launches,
              newton_ell=kn.launches_ell, front=ks.launches_front,
              kinematics=ks.launches_kin, com_pos=ks.launches_com,
              crb=ks.launches_crb, **kb.launches)


ENTRY_COUNTS = ('front', 'kinematics', 'com_pos', 'crb')    # B9-B12


def _expect_no_entries(label):
  """A step path launches none of B9-B12."""
  counts = {k: _read_counts()[k] for k in ENTRY_COUNTS}
  if any(counts.values()):
    raise RuntimeError(f'{label}: launched B9-B12 {counts}')


def _zero_counts() -> dict:
  return dict.fromkeys(_read_counts(), 0)


def _expect_counts(label, expect, counts=None):
  """Hold the launch counts (the wrappers', unless `counts` are given) to
  `expect`."""
  counts = _read_counts() if counts is None else counts
  print(f'  {label}: launches {counts}')
  if counts != expect:
    raise RuntimeError(f'{label}: launch counts {counts}, expected {expect}')


# the CUDA kernels' names, as torch.profiler reports them, of each count
# of _read_counts
CARD_NAMES = {
    'smooth': ('smooth_stages<63>',),
    'contact': ('contact_kernel', 'contact_ell_kernel',
                'contact_eqbox_kernel', 'contact_eqbox_ell_kernel',
                'contact_box_kernel', 'contact_box_ell_kernel'),
    'glue': ('glue_kernel',), 'glue_ell': ('glue_ell_kernel',),
    'newton': ('newton_kernel',), 'newton_ell': ('newton_ell_kernel',),
    'front': ('smooth_stages<26>',), 'kinematics': ('smooth_stages<2>',),
    'com_pos': ('smooth_stages<8>',), 'crb': ('smooth_stages<16>',),
    'tree_ldl': ('tree_ldl_kernel',), 'spd_solve': ('spd_solve_kernel',),
    'cho_solve': ('cho_solve_kernel',), 'tree_solve': ('tree_solve_kernel',)}


def _card_counts(rows, nstep) -> dict:
  """Each kernel's launches that the card ran over a profile's nstep
  steps (rows of `_profile`), keyed as _read_counts keys them. A replayed
  graph launches its kernels without a wrapper call, so this is how a
  replayed path is counted."""
  counts = _zero_counts()
  for name, calls, _ in rows:
    for key, names in CARD_NAMES.items():
      if any(n in name for n in names):
        counts[key] += int(round(calls * nstep))
  return counts


def _count_on_card(fn):
  """fn() under torch.profiler (`_profile`): (its result, `_card_counts`
  of the run)."""
  out = []
  rows = _profile(lambda: out.append(fn()), 1)
  return out[0], _card_counts(rows, 1)


def _check_wrapper_calls(label, on_card, steps):
  """A replayed run of `steps` steps calls each kernel's wrapper for its
  first step, run eagerly, and once more for the capture: twice the
  launches a step that the card ran."""
  calls = _read_counts()
  print(f'  {label}: wrapper calls {calls} (the first step and the '
        f'capture); launches on the card {on_card} in {steps} steps')
  if any(calls[k] * steps != 2 * on_card[k] for k in calls):
    raise RuntimeError(f'{label}: wrapper calls {calls} against launches '
                       f'on the card {on_card} in {steps} steps')


def _own_recorded() -> str:
  """The last profile's own kernels (lead and trail) that it recorded."""
  return (f'{PROFILE_OWN["recorded"]} of its own {PROFILE_OWN["launched"]} '
          f'kernels recorded')


def _short(counts, expect) -> bool:
  """Whether a profile's counts fall short of expect in some kernel and
  exceed it in none: torch.profiler dropped records (see PROFILE_TRIES)."""
  return counts != expect and all(counts[k] <= expect[k] for k in expect)


def _replayed_counts(label, fn, steps):
  """fn(), a replayed run of `steps` steps, from counts at 0 under
  torch.profiler: (its result, the card's launches), held by
  `_check_wrapper_calls`; profiled again while the profile falls short,
  at most PROFILE_TRIES times."""
  for _ in range(PROFILE_TRIES):
    _reset_counts()
    result, on_card = _count_on_card(fn)
    calls = _read_counts()
    if not _short(on_card, {k: v * steps // 2 for k, v in calls.items()}):
      break
    print(f'  {label}: the profile counted {on_card}, short of half the '
          f'wrapper calls {calls} a step ({_own_recorded()}): profiled '
          f'again')
  _check_wrapper_calls(label, on_card, steps)
  return result, on_card


def _bench_nstep(steps: int) -> int:
  """The harness's nstep that takes `steps` steps in all (>= 2)."""
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  nstep = steps - 2 if steps <= 22 else steps
  assert bench.total_steps(nstep) == steps, steps
  return nstep


def _solved(m, d) -> int:
  """Worlds whose last solve stopped before opt.iterations."""
  return int((d.solver_niter < m.opt.iterations).sum())


def _run_path(label, m, d, steps, card):
  """Benchmark a path of `steps` steps in all from counts at 0; returns
  (Data, metrics, steps, counts): each kernel's launches in the run. A
  path the harness replays (forward.replays) is run twice from the same
  state: once under torch.profiler, whose kernel names give its counts
  (`_card_counts`; the wrapper calls held by `_check_wrapper_calls`), and
  once without it for the times; an eager path once, counted by its
  wrappers."""
  import torch
  from mujoco_warp_tpu_torch import forward, solver
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  nstep = _bench_nstep(steps)
  replays = forward.replays(m, d)
  if replays:
    _, counts = _replayed_counts(
        label, lambda: bench.benchmark(m, d, nstep=nstep), steps)
  _reset_counts()
  d, res = bench.benchmark(m, d, nstep=nstep)
  if res['dispatch'] != ('graph' if replays else 'eager'):
    raise RuntimeError(f'{label}: dispatch {res["dispatch"]}')
  if not replays:
    counts = _read_counts()
  for k in ('qpos', 'qvel', 'qacc', 'efc_force'):
    if not bool(torch.isfinite(getattr(d, k)).all()):
      raise RuntimeError(f'{label}: non-finite {k}')
  passes = solver.counts['passes'] / steps
  print(f'{label}: {res["steps_per_sec"]:.1f} steps/s, '
        f'{res["step_time_us"]:.1f} us/step over {res["nstep"]} timed of '
        f'{steps} steps at {d.nworld} worlds; final solver_niter mean '
        f'{res["solver_niter_mean"]:.2f} max {res["solver_niter_max"]}, '
        f'solve stopped before opt.iterations in {_solved(m, d)} of '
        f'{d.nworld}; {res["converged_worlds"]} worlds without NaN; '
        f'{passes:.2f} solver passes per step, dispatch '
        f'{res["dispatch"]} ({card})')
  print(json.dumps({label: dict(res, passes_per_step=passes, card=card)}))
  return d, res, steps, counts


def _bits(t):
  """t's bits: a float tensor viewed as int32 (NaN and -0.0 too)."""
  import torch
  return t.view(torch.int32) if t.is_floating_point() else t


def _differing(a, b) -> list:
  """The Data fields (contact fields as contact.<name>) whose bits differ
  between a and b."""
  import torch
  from mujoco_warp_tpu_torch.types import CONTACT_TENSORS, DATA_TENSORS
  pairs = [(k, getattr(a, k), getattr(b, k)) for k in DATA_TENSORS]
  pairs += [('contact.' + k, getattr(a.contact, k), getattr(b.contact, k))
            for k in CONTACT_TENSORS]
  return [k for k, x, y in pairs if not torch.equal(_bits(x), _bits(y))]


def _replay_against_eager(label, m, d, per_step, nstep, card,
                          n=REPLAY_STEPS, eager_timing=True):
  """On a path the harness replays: n (REPLAY_STEPS) steps by graph replay
  against as many eager steps (`rollout`) from the state d, with the same
  step indices, every Data tensor bit for bit; two eager runs first, and
  where those differ the replay is held by phase (g)'s step tolerance
  instead. Then the same nstep steps timed and profiled each way
  (steps/s, device ms a step, busy share, launches a step; without
  `eager_timing` the replayed way only, timed and profiled on one graph);
  the replayed profile must show each kernel of `per_step` (counts of
  _read_counts) that many times a step on the card."""
  import torch
  from mujoco_warp_tpu_torch import forward
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  if not forward.replays(m, d):
    raise RuntimeError(f'{label}: the harness does not replay this path')
  start = REPLAY_START
  eager = bench.rollout(m, d, n, start=start)
  again = _differing(eager, bench.rollout(m, d, n, start=start))
  replayed = bench.replayed(m, d, n, start=start)
  torch.cuda.synchronize()
  diff = _differing(replayed, eager)
  print(f'  {label}: {n} steps from one state, two eager runs '
        f'{"bit-equal" if not again else "differ in " + str(again)}; '
        f'replayed against eager '
        f'{"bit-equal" if not diff else "differ in " + str(diff)}')
  if again:
    _compare(f'{label} replayed', vars(replayed), vars(eager),
             TOL_STEP_QACC, ['qacc', 'qvel', 'qpos'])
  elif diff:
    raise RuntimeError(f'{label}: the replayed steps differ from the '
                       f'eager steps in {diff}')
  if not bool(torch.isfinite(replayed.qpos).all()):
    raise RuntimeError(f'{label}: non-finite qpos after the replay')

  def clock(run):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / nstep * 1e3
  # each way, the same nstep steps from d are timed in one run and
  # profiled in another (two graphs captured from d)
  eager = lambda: bench.rollout(m, d, nstep, start=start)
  one_step = bench.noise_step(m, d.nworld)
  step = torch.full((), start, dtype=torch.int32, device=d.qpos.device)
  bench.warm_step(one_step, d, step)

  def replay(graph):
    def run():
      for _ in range(nstep):
        graph.replay()
    return run
  timed = replay(bench.GraphStep(one_step, d, step))
  profiled = replay(bench.GraphStep(one_step, d, step)) if eager_timing \
      else timed
  replay_ms = clock(timed)
  W = d.nworld
  print(f'  {label}: replayed {replay_ms:.4f} ms a step '
        f'({W / replay_ms * 1e3:.1f} steps/s) at {W} worlds, host clock '
        f'over {nstep} steps ({card})')
  if eager_timing:
    eager_ms = clock(eager)
    print(f'  {label}: eager {eager_ms:.4f} ms a step '
          f'({W / eager_ms * 1e3:.1f} steps/s)')
    _print_profile(f'{label} eager', eager, nstep, eager_ms, card, W)
  expect = dict(_zero_counts(), **{k: v * nstep
                                   for k, v in per_step.items()})
  for _ in range(PROFILE_TRIES):
    rows = _print_profile(f'{label} replayed', profiled, nstep,
                          replay_ms, card, W)
    counts = _card_counts(rows, nstep)
    if not _short(counts, expect):
      break
    print(f'  {label} replayed: the profile counted {counts}, short of '
          f'{expect} ({_own_recorded()}): profiled again')
  _expect_counts(f'{label} replayed, on the card', expect, counts)


def _step_recording(m, d):
  """step_batched(m, d) and, for every evaluation of the dynamics in it,
  the contact and row sets that kernel B2 (or what stands in for it, or
  `make_constraint` on a model past the SAP threshold) returned, and the
  solve's call: (its kind, 'newton' for B4's, 'glue'
  for B3's, 'solve' for the unfused one; arguments, keywords, result)."""
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import constraint, solver
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import newton as kn
  sets, solves = [], []
  inner = (kc.contact, kn.newton_solve, solver.solve, kg.glue,
           constraint.make_constraint)

  def contact(*args):
    out = inner[0](*args)
    sets.append((out['ncon'], out['efc_type'], out['efc_active']))
    return out

  def rows(m, qpos, qvel, cdof, subtree_com, con, eq_active=None):
    out = inner[4](m, qpos, qvel, cdof, subtree_com, con, eq_active)
    sets.append(((con['geom'][..., 0] >= 0).sum(1, dtype=torch.int32),
                 out['type'], out['active']))
    return out

  def recording(fn, kind):
    def solve(*args, **kw):
      out = fn(*args, **kw)
      solves.append((kind, args, kw, out))
      return out
    return solve
  kc.contact = contact
  # a model B2 cannot take: its rows come from make_constraint
  if not kc.supports(m, d.contact.dist.shape[1]):
    constraint.make_constraint = rows
  kn.newton_solve = recording(inner[1], 'newton')
  solver.solve = recording(inner[2], 'solve')
  kg.glue = recording(inner[3], 'glue')
  d = mt.step_batched(m, d)
  (kc.contact, kn.newton_solve, solver.solve, kg.glue,
   constraint.make_constraint) = inner
  return d, sets, solves


def _objective(m, qM, J, D, aref, fl, qfs, qacc, cone=None):
  """The solve's cost (W,) at qacc in float64, with the elliptic cone's
  blocks given `cone` (`solver.cone_inputs`)."""
  import torch
  from mujoco_warp_tpu_torch import solver
  from mujoco_warp_tpu_torch.io import efc_layout
  f64 = lambda x: x.double()
  qM, J, D, aref, fl, qfs = (f64(x) for x in (qM, J, D, aref, fl, qfs))
  K = None
  if cone is not None:
    K = solver.Cone(m, D, (f64(cone[0]), cone[1], f64(cone[2])))
  ne, nf, _, _, _ = efc_layout(m, 0)
  return solver.objective(qM, J, D, aref, fl, qfs, torch.linalg.solve(
      qM, qfs), f64(qacc), ne, nf, cone=K)


def _check_excused(label, m, solves, worlds, tol_obj, per_world=True,
                   exact=False):
  """Hold the worlds that a step comparison lets miss its tolerance (a
  bool mask over worlds). Such a world comes from a solve that stopped
  early in one version: when the last polish step of the linesearch
  lands on an end of its bracket in float32, the rule that keeps the
  step strictly inside bisects the bracket instead (the JAX package's
  rule too, pallas/solver_kernels.py:439), the cost rises and the
  stopping rule ends the solve; which version this hits turns on an ulp.
  So in every solve of the kernel step, on that solve's own inputs, the
  kernel step's qacc must reach a float64 objective no higher than the
  plain solve's plus tol_obj units, or the kernel step's solve must have
  stopped in fewer iterations than the plain solve. A world whose
  objective is higher after as many iterations fails, unless not
  `per_world` (the elliptic cone, see ELLIPTIC): then those worlds are
  held by their count alone, in the caller, and printed here. With
  `exact` (P15, see RICH_LEGS), each solve is also run in float64 on the
  same inputs, both versions' objectives are printed against it, and a
  kernel solve with a higher objective in as many iterations as the
  plain solve still passes if it ended in fewer iterations than the
  float64 solve (it stopped early), or else if its outcome turns on an
  ulp: with qfx moved by up to ULP_WITNESS ulps either way, the kernel
  ends within tol_obj of the plain solve's objective, or the plain solve
  ends more than tol_obj above it; any other fails."""
  import torch
  from mujoco_warp_tpu_torch import forward, solver
  from mujoco_warp_tpu_torch.kernels import glue as kg
  idx = worlds.nonzero()[:, 0]
  if not idx.numel():
    return
  W = worlds.shape[0]
  cut = lambda x: (x[idx] if torch.is_tensor(x) and x.dim() and
                   x.shape[0] == W else
                   tuple(cut(y) for y in x) if isinstance(x, tuple) else x)
  unit = float(m.opt.tolerance) * float(m.stat.meaninertia) * max(1, m.nv)
  higher = same_iter = 0
  for i, (kind, args, kw, out) in enumerate(solves):
    args, kw = [cut(x) for x in args], {k: cut(v) for k, v in kw.items()}
    if kind == 'newton':
      ref = solver.newton_solve(*args, **kw)
      qfs = args[6]
    elif kind == 'glue':
      ref = forward.glue(*args, **kw)
      qfs = out['qfrc_smooth'][idx]
    else:
      with _plain_kernels():
        ref = solver.solve(*args, **kw)
      qfs = args[7]
    objective = lambda x: _objective(m, *args[1:6], qfs, x, kw.get('cone'))
    gap = (objective(out['qacc'][idx]) - objective(ref['qacc'])) / unit
    niter, niter_p = out['solver_niter'][idx], ref['solver_niter']
    over = gap > tol_obj
    higher += int(over.sum())
    fmt = lambda t: [float(f'{g:.3g}') for g in t.tolist()]
    print(f'  {label} solve {i}, worlds {idx.tolist()}: objective less '
          f'the plain solve\'s on the same inputs {fmt(gap)} units (tol '
          f'{tol_obj:g}); solver_niter {niter.tolist()}, plain '
          f'{niter_p.tolist()}')
    if exact:
      if kind != 'glue':
        raise ValueError(f'{label}: `exact` holds glue solves only')
      f64 = lambda x: (x.double() if torch.is_tensor(x) and
                       x.is_floating_point() else x)
      ref_x = forward.glue(*[f64(x) for x in args],
                           **{k: f64(v) for k, v in kw.items()})
      o_x, niter_x = objective(ref_x['qacc']), ref_x['solver_niter']
      print(f'  {label} solve {i}: objective less the float64 plain '
            f'solve\'s: kernel '
            f'{fmt((objective(out["qacc"][idx]) - o_x) / unit)}, plain '
            f'{fmt((objective(ref["qacc"]) - o_x) / unit)} units; float64 '
            f'solver_niter {niter_x.tolist()}')
      over &= niter >= niter_x
      left = over & (niter >= niter_p)
      if bool(left.any()):
        if not torch.equal(kg.glue(*args, **kw)['qacc'], out['qacc'][idx]):
          raise RuntimeError(f'{label}: B3 on these worlds alone differs '
                             f'from B3 in the batch')
        turned = torch.zeros_like(left)
        for j in [j for u in range(1, ULP_WITNESS + 1) for j in (u, -u)]:
          qfx = args[9]
          for _ in range(abs(j)):
            qfx = torch.nextafter(qfx, torch.full_like(
                qfx, float('inf') if j > 0 else float('-inf')))
          nudged = (*args[:9], qfx, *args[10:])
          g_k, g_p = ((objective(fn(*nudged, **kw)['qacc']) -
                       objective(ref['qacc'])) / unit
                      for fn in (kg.glue, forward.glue))
          turned |= (g_k <= tol_obj) | (g_p > tol_obj)
          print(f'  {label} solve {i}, qfx {j:+d} ulp: objective less the '
                f'plain solve\'s: kernel {fmt(g_k[left])}, plain '
                f'{fmt(g_p[left])} units (worlds {idx[left].tolist()})')
        over &= ~(left & turned)
    same_iter += int((over & (niter >= niter_p)).sum())
    if per_world and bool((over & (niter >= niter_p)).any()):
      raise RuntimeError(f'{label}: a world outside the tolerance has a '
                         f'higher objective than the plain solve reaches '
                         f'in as many iterations'
                         f'{" as it and the float64 solve, and no nudge of "
                            "qfx turns it" if exact else ""}')
  print(f'  {label}: {idx.numel()} worlds over the tolerance, {higher} of '
        f'their {idx.numel() * len(solves)} solves with a higher objective, '
        f'{same_iter} of those after as many iterations as the plain solve'
        f'{" and the float64 solve" if exact else ""}')


def _agree(sets, sets_p):
  """The worlds (bool (W,)) whose contact and row sets, as
  `_step_recording` returns them, equal sets_p's in every evaluation of
  the dynamics."""
  import torch
  if not sets or len(sets) != len(sets_p):
    raise RuntimeError(f'{len(sets)} and {len(sets_p)} evaluations')
  same = torch.ones_like(sets_p[0][0], dtype=torch.bool)
  for (ncon, typ, act), (ncon_p, type_p, act_p) in zip(sets, sets_p):
    same &= ((ncon == ncon_p) & (typ == type_p).all(1) &
             (act == act_p).all(1))
  return same


def _compare_step(label, m, d, tol, keys=('qacc',), tol_obj=TOL_OBJ,
                  spread=False, exact=False):
  """One step of the kernel path against the all-plain step on the same
  state: keys over the worlds whose contact and row sets agree in every
  evaluation of the dynamics (an RK4 step has four, and its qacc
  averages them). Per evaluation, the sets may differ in max(8, nworld /
  1000) worlds (a contact or limit at its activation threshold, phase
  c), and as many worlds may miss the tolerance because a solve stopped
  early in one version: those are held by `_check_excused`, every other
  world at tol. With `spread` (the elliptic cone, see ELLIPTIC), each of
  those counts may also grow by twice the all-plain step's own after a
  1-ulp change of qvel, and the excused worlds are held by count, unless
  `exact` (P15) holds each against the float64 solve."""
  import torch
  W = d.nworld
  d_k, sets_k, solves = _step_recording(m, d)
  with _plain_kernels():
    d_p, sets_p, _ = _step_recording(m, d)
    if spread:
      d_u, sets_u, _ = _step_recording(m, d.replace(qvel=_next_ulp(d.qvel)))
  if len(sets_k) != len(sets_p) or len(solves) != len(sets_k) or not sets_k:
    raise RuntimeError(f'{label}: {len(sets_k)} and {len(sets_p)} '
                       f'evaluations, {len(solves)} solves')
  agree = lambda sets: _agree(sets, sets_p)

  def over(dd, same, k):
    """Worlds of `same` whose k is over tol of the all-plain step's."""
    a, b = getattr(dd, k), getattr(d_p, k)
    scale = max(1.0, float(b[same].abs().max()))
    err = (a - b).abs().amax(1) / scale
    return same & (err > tol), err, scale
  same = agree(sets_k)
  nbad = W - int(same.sum())
  allowed = len(sets_k) * max(8, W // 1000)
  same_u = agree(sets_u) if spread else None
  extra = 2 * (W - int(same_u.sum())) if spread else 0
  ulp = lambda e: f'; the 1-ulp spread {e // 2}' if spread else ''
  print(f'  {label}: {nbad} of {W} worlds with a different '
        f'contact/row set in one of {len(sets_k)} evaluations (allowed '
        f'{allowed + extra}{ulp(extra)})')
  if nbad > allowed + extra:
    raise RuntimeError(f'{label}: {nbad} worlds differ in their row sets')
  excused = torch.zeros_like(same)
  for k in keys:
    o, err, scale = over(d_k, same, k)
    excused |= o
    n = int(o.sum())
    held = same & ~o
    extra = 2 * int(over(d_u, same_u, k)[0].sum()) if spread else 0
    print(f'  {label} {k}: {n} of {W - nbad} worlds over {tol:g} of '
          f'scale {scale:.1f} (allowed {allowed + extra}{ulp(extra)}; '
          f'their max '
          f'{float(err[same].max()):.3e}); the rest within '
          f'{float(err[held].max()) if bool(held.any()) else 0.0:.3e}; '
          f'median '
          f'{float(err[same].median()):.3e}')
    if n > allowed + extra:
      raise RuntimeError(f'{label}: {k} differs from the all-plain step '
                         f'in {n} worlds')
  _check_excused(label, m, solves, excused, tol_obj,
                 per_world=exact or not spread, exact=exact)
  dn = (d_k.solver_niter - d_p.solver_niter).abs()
  print(f'  {label}: solver_niter |diff| histogram {dn.bincount().tolist()}')


def _hold_unfused_solve(label, m, solves, tol):
  """The kernel step's unfused solve (`solver.solve`, B5 a Newton
  direction) against the plain solve on the same inputs: qacc at tol of
  scale in all but max(8, nworld / 1000) worlds, those held by
  `_check_excused`."""
  import torch
  from mujoco_warp_tpu_torch import solver
  (_, args, kw, out), = solves
  with _plain_kernels():
    ref = solver.solve(*args, **kw)
  W = out['qacc'].shape[0]
  scale = max(1.0, float(ref['qacc'].abs().max()))
  err = (out['qacc'] - ref['qacc']).abs().amax(1) / scale
  over = err > tol
  allowed = max(8, W // 1000)
  print(f'  {label}: against the plain solve on the same inputs: '
        f'{int(over.sum())} of {W} worlds over {tol:g} of scale {scale:.1f} '
        f'(allowed {allowed}; largest {float(err.max()):.3e})')
  if int(over.sum()) > allowed:
    raise RuntimeError(f'{label}: the solve differs from the plain solve '
                       f'in {int(over.sum())} worlds')
  _check_excused(label, m, solves, over, TOL_OBJ)


def _glue_inputs(m, d, nconmax=NCONMAX):
  """B1's outputs, B2's inputs and outputs, and B3's inputs on the state
  d, as the glue list computes them."""
  from mujoco_warp_tpu_torch import support
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  sm = ks.smooth(m, d.qpos, d.qvel)
  c_in = (sm['qpos'], d.qvel, sm['geom_xpos'], sm['geom_xmat'],
          sm['subtree_com'], sm['cdof'])
  c_out = kc.contact(m, *c_in, nconmax, d.eq_active)
  qfx = d.qfrc_applied + support.xfrc_accumulate(
      m, d.xfrc_applied, sm['xipos'], sm['subtree_com'], sm['cdof']) - \
      sm['qfrc_bias']
  g_in = (sm['qM'], c_out['efc_J'], c_out['efc_D'], c_out['efc_aref'],
          c_out['efc_frictionloss'], sm['qpos'], d.qvel, d.ctrl, qfx,
          d.qacc_warmstart)
  return sm, c_in, c_out, g_in


def _glue_cost(m, g_in, g_out, nefc, label='glue') -> tuple:
  """(bytes, operations) of B3 on g_in: efc_J and efc_aref only for the
  rows that can act (D != 0 or frictionloss != 0), which the kernel reads
  and the rest it skips."""
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import glue as kg
  W, nj, nv = g_in[1].shape
  acting = int(((g_in[2] != 0) | (g_in[4] != 0)).sum())
  every = _nbytes(g_in, g_out, _build.model_tables(m, 'glue', kg._tables))
  nbytes = (every - _nbytes(g_in[1:2], g_in[3:4]) +
            acting * (nv + 1) * g_in[1].element_size())
  print(f'  {label}: {acting} acting rows of {W * nj} ({acting / W:.2f} per '
        f'world); every efc_J row would move {every / 1e6:.1f} MB, bound '
        f'{every / PEAK_BYTES * 1e3:.4f} ms')
  return nbytes, _flops_newton(nv, nefc.double(),
                               g_out['solver_niter'].double(), m.nu)


def _humanoid_paths(card, m, d, errs) -> list:
  """Phases (k) and (l) on the humanoid: forward_batched, RK4 steps and CG
  steps from the state the main path left; returns the records of B4
  and B6."""
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import batch_linalg, forward, solver
  from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import newton as kn
  from mujoco_warp_tpu_torch.types import IntegratorType, SolverType
  zero = _zero_counts()
  names = lambda mm: [n for n, _ in forward.batched_stages(mm, d)]
  front = ['smooth_mega[cuda]', 'contact_efc_mega[cuda]', 'transmission',
           'velocity_glue', 'passive', 'fwd_actuation', 'fwd_acceleration']

  # ---- (k) P3: one forward_batched ----
  print(f'stages of forward_batched: '
        f'{" -> ".join(n for n, _ in forward.forward_stages(m, d))}')
  if [n for n, _ in forward.forward_stages(m, d)] != front + ['solve[cuda]']:
    raise RuntimeError('forward_batched does not run the Newton kernel')
  _reset_counts()
  fwd = mt.forward_batched(m, d)
  torch.cuda.synchronize()
  _expect_counts('forward_batched', dict(zero, smooth=1, contact=1,
                                         newton=1))
  launches_b4 = kn.launches
  # no integration: qvel untouched, qpos only with its quaternions
  # normalized again by B1
  if not torch.equal(fwd.qvel, d.qvel) or \
      float((fwd.qpos - d.qpos).abs().max()) > 1e-6:
    raise RuntimeError('forward_batched moved the state')
  if not bool(torch.isfinite(fwd.qacc).all()):
    raise RuntimeError('forward_batched: non-finite qacc')

  # ---- (k) P4: RK4 steps ----
  rk4 = m.replace(opt=m.opt.replace(integrator=int(IntegratorType.RK4)))
  print(f'stages of the RK4 step: {" -> ".join(names(rk4))}')
  if names(rk4) != front + ['solve[cuda]', 'rk4'] or \
      forward.uses_glue_kernel(rk4, d):
    raise RuntimeError('the RK4 humanoid does not run the unfused list')
  d4, _, steps, counts = _run_path('step_rk4', rk4, d, RK4_STEPS, card)
  _expect_counts('RK4', dict(zero, smooth=4 * steps, contact=4 * steps,
                             newton=4 * steps), counts)
  launches_b4 += counts['newton']
  _compare_step('RK4 step', rk4, d4, TOL_STEP_QACC, ('qacc', 'qvel'))
  _replay_against_eager('P4', rk4, d, dict(smooth=4, contact=4, newton=4),
                        PROFILE_RK4, card)

  # ---- (k) P5: CG steps ----
  cg = m.replace(opt=m.opt.replace(solver=int(SolverType.CG)))
  print(f'stages of the CG step: {" -> ".join(names(cg))}')
  if names(cg) != front + ['solve', 'euler'] or \
      forward.uses_glue_kernel(cg, d):
    raise RuntimeError('the CG humanoid does not run the unfused list')
  d5, _, steps, counts = _run_path('step_cg', cg, d, CG_STEPS, card)
  solves = solver.counts['solve'] + solver.counts['passes']
  if solver.counts['solve'] != steps or not solver.counts['passes']:
    raise RuntimeError(f'CG: solver counts {solver.counts}')
  # the humanoid disables eulerdamp: B5 only factors qM, once a step
  _expect_counts('CG', dict(zero, smooth=steps, contact=steps,
                            spd_solve=steps, cho_solve=solves), counts)
  launches_b6 = solves

  # ---- P13: implicitfast CG steps (B5 twice a step: qM's factor and
  # qM - h qDeriv) ----
  cg2 = cg.replace(opt=cg.opt.replace(
      integrator=int(IntegratorType.IMPLICITFAST)))
  print(f'stages of the implicitfast CG step: {" -> ".join(names(cg2))}')
  if names(cg2) != front + ['solve', 'implicitfast'] or \
      forward.replays(cg2, d):
    raise RuntimeError('the implicitfast CG humanoid does not run the '
                       'unfused list')
  d13, _, steps, counts = _run_path('step_implicitfast_cg', cg2, d,
                                    CG_STEPS, card)
  solves = solver.counts['solve'] + solver.counts['passes']
  if solver.counts['solve'] != steps or not solver.counts['passes']:
    raise RuntimeError(f'P13: solver counts {solver.counts}')
  _expect_counts('P13', dict(zero, smooth=steps, contact=steps,
                             spd_solve=2 * steps, cho_solve=solves), counts)
  launches_b6 += solves
  _compare_step('P13 step', cg2, d13, TOL_STEP_QACC_CG, ('qacc', 'qvel'),
                tol_obj=TOL_OBJ_CG)

  # ---- (l) B4 and B6: times, plain times, bounds, library ----
  records = []
  W, nv = NWORLD, m.nv
  pre = d
  stages = forward.forward_stages(m, d)
  for _, fn in stages[:-1]:
    pre = fn(pre)
  n_in = (pre.qM, pre.efc_J, pre.efc_D, pre.efc_aref, pre.efc_frictionloss,
          pre.qfrc_smooth, pre.qacc_warmstart)
  n_out = kn.newton_solve(m, *n_in)
  acting = int(((n_in[2] != 0) | (n_in[4] != 0)).sum())
  bytes_b4 = (_nbytes(n_in, n_out) - _nbytes(n_in[1:2], n_in[3:4]) +
              acting * (nv + 1) * 4)
  print(f'  newton: {acting / W:.2f} acting rows per world, solver_niter '
        f'mean {float(n_out["solver_niter"].float().mean()):.2f}')
  _record(records, 'newton', launches_b4, errs['newton'],
          'mujoco_warp_tpu_torch/csrc/newton.cu',
          'mujoco_warp_tpu/pallas/solver_kernels.py:534',
          lambda: kn.newton_solve(m, *n_in),
          lambda: solver.newton_solve(m, *n_in), bytes_b4,
          _flops_newton(nv, pre.nefc.double(),
                        n_out['solver_niter'].double()))
  # B6 needs only L's lower triangle, b and x
  _, L = kb.spd_solve(pre.qM, pre.qfrc_smooth, return_factor=True)
  grad = (torch.einsum('wij,wj->wi', pre.qM, pre.qacc_warmstart) -
          pre.qfrc_smooth)
  _record(records, 'cho_solve', launches_b6, errs['cho_solve'],
          'mujoco_warp_tpu_torch/csrc/batch_linalg.cu',
          'mujoco_warp_tpu/pallas/batch_linalg.py:177',
          lambda: kb.cho_solve(L, grad),
          lambda: batch_linalg.cho_solve_batched(L, grad),
          W * 4 * (nv * (nv + 1) // 2 + 2 * nv), W * 2 * nv * nv,
          library=lambda: torch.cholesky_solve(grad[..., None], L))
  # B5 at n 27 as the CG step calls it (qM's factor written); its time
  # printed beside its bound, the record being B5's at n 81 (phase h)
  from mujoco_warp_tpu_torch.utils.compare_trees import device_ms
  qM5 = pre.qM
  ms5 = device_ms(lambda: kb.spd_solve(qM5, grad, return_factor=True))
  plain5 = _cuda_ms(lambda: batch_linalg.spd_solve_batched(
      qM5, grad, return_factor=True), 3)
  bound5 = W * 4 * (nv * (nv + 1) // 2 + 2 * nv + nv * nv) / PEAK_BYTES * 1e3
  print(f'  spd_solve at n {nv} (the CG step\'s factor of qM): {ms5:.4f} ms '
        f'on the card (plain {plain5:.3f} ms), bound {bound5:.4f} ms by '
        f'bytes ({card})')

  # ---- P11: the implicitfast glue step (B3 in mode 2), replayed ----
  m2 = m.replace(opt=m.opt.replace(
      integrator=int(IntegratorType.IMPLICITFAST)))
  print(f'stages of the implicitfast step: {" -> ".join(names(m2))}')
  if names(m2) != ['smooth_mega[cuda]', 'contact_efc_mega[cuda]',
                   'act_len_vel', 'solve_glue[cuda]'] or \
      forward.glue_mode(m2) != 2 or not forward.replays(m2, d):
    raise RuntimeError('the implicitfast humanoid does not take the glue '
                       'list in mode 2')
  d11, _, steps, counts = _run_path('step_implicitfast', m2, d, COUNT_STEPS,
                                    card)
  _expect_counts('P11', dict(zero, smooth=steps, contact=steps,
                             glue=steps), counts)
  # held by counts against the all-plain step's own spread after a 1-ulp
  # change of qvel: on P11's states a world's two solves (the kernel
  # step's and the all-plain step's) can both stop after one iteration
  # at objectives 47 units apart (on the H100), which the per-world
  # excuse (fewer iterations) does not cover (ROADMAP §C)
  _compare_step('P11 step', m2, d11, TOL_STEP_QACC, ('qacc', 'qvel'),
                spread=True)
  _replay_against_eager('P11', m2, d, dict(smooth=1, contact=1, glue=1),
                        PROFILE_STEPS, card)
  _, _, c_out, g_in = _glue_inputs(m2, d11)
  g_out = kg.glue(m2, *g_in)
  _record(records, 'glue[mode2]', counts['glue'], errs['glue[mode2]'],
          'mujoco_warp_tpu_torch/csrc/glue.cu',
          'mujoco_warp_tpu/pallas/solver_kernels.py:1207',
          lambda: kg.glue(m2, *g_in), lambda: forward.glue(m2, *g_in),
          *_glue_cost(m2, g_in, g_out, c_out['nefc'], 'glue[mode2]'))
  return records


def _three_humanoids(card) -> list:
  """Phases (f)-(h) on three_humanoids; returns the kernel records."""
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import (batch_linalg, forward, models, smooth,
                                     solver)
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import newton as kn
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  from mujoco_warp_tpu_torch.types import IntegratorType, SolverType
  from mujoco_warp_tpu_torch.utils import benchmark as bench

  m = mt.load_model(models.THREE_HUMANOIDS_NPZ, device='cuda')
  d = mt.make_data(m, nconmax=NCONMAX3)
  gen = torch.Generator(device='cuda').manual_seed(SEED)
  d = mt.make_batch(m, d, NWORLD, qpos_noise=QPOS_NOISE, generator=gen)
  _, _, nl, stride, nj = mt.efc_layout(m, NCONMAX3)
  print(f'model: three_humanoids nq={m.nq} nv={m.nv} nbody={m.nbody} '
        f'ngeom={m.ngeom} nu={m.nu} ncam={m.ncam} nlight={m.nlight} '
        f'candidates={m.nxn_candidates} njmax={nj}; nworld={NWORLD} '
        f'nconmax={NCONMAX3}')

  # ---- (f) kernels against their plain versions ----
  d = bench.rollout(m, d, PREP3)
  d_f = d
  print(f'prep: {PREP3} steps, ncon mean {float(d.ncon.float().mean()):.2f}, '
        f'solver_niter mean {float(d.solver_niter.float().mean()):.2f} max '
        f'{int(d.solver_niter.max())}')
  stages = forward.batched_stages(m, d)
  names = [n for n, _ in stages]
  print(f'stages: {" -> ".join(names)}')
  if names != ['smooth_mega[cuda]', 'camlight', 'contact_efc_mega[cuda]',
               'transmission', 'velocity_glue', 'passive', 'fwd_actuation',
               'fwd_acceleration', 'solve', 'euler']:
    raise RuntimeError('three_humanoids does not run the unfused list')
  pre = d
  for _, fn in stages[:names.index('solve')]:
    pre = fn(pre)
  post = stages[names.index('solve')][1](pre)
  errs = {}
  sm_out = ks.smooth(m, d.qpos, d.qvel)
  sm_ref = smooth.smooth(m, d.qpos, d.qvel)
  errs['smooth'] = _compare('B1', sm_out, sm_ref, TOL_B1, smooth.OUTPUTS)
  _check_repeat('B1', lambda: ks.smooth(m, d.qpos, d.qvel))
  _print_warp_shapes('three_humanoids', ('smooth_stages<63>',))
  c_in = (sm_out['qpos'], d.qvel, sm_out['geom_xpos'], sm_out['geom_xmat'],
          sm_out['subtree_com'], sm_out['cdof'])
  c_out = kc.contact(m, *c_in, NCONMAX3)
  c_ref = kc.plain(m, *c_in, NCONMAX3)
  errs['contact'] = _check_contact('B2', m, c_in, c_out, c_ref)
  _check_repeat('B2', lambda: kc.contact(m, *c_in, NCONMAX3))
  _print_warp_shapes('three_humanoids', ('contact_kernel',))

  parent = m.dof_parentid
  qM, qfs = pre.qM, pre.qfrc_smooth
  diag = m.opt.timestep * m.dof_damping
  mask = batch_linalg.packed_mask(parent, qM.device)
  errs['tree_ldl'] = 0.0
  for label, b, dg in (('fwd_acceleration', qfs, None),
                       ('euler', qfs + post.qfrc_constraint, diag)):
    x, ld = kb.tree_ldl(qM, b, parent, diag=dg, return_factor=True)
    xr, ldr = batch_linalg.tree_ldl_solve_batched(qM, b, parent, diag=dg,
                                                  return_factor=True)
    x64 = batch_linalg.tree_ldl_solve_batched(
        qM.double(), b.double(), parent,
        diag=None if dg is None else dg.double())
    a = qM + (torch.diag(dg) if dg is not None else 0)
    _compare(f'B7 {label}', {'LD': ld[:, mask]}, {'LD': ldr[:, mask]},
             TOL_B1, ['LD'])
    if bool(ld[:, ~mask].any()):
      raise RuntimeError('B7: nonzero LD outside the packed entries')
    errs['tree_ldl'] = max(errs['tree_ldl'], _check_solve(
        f'B7 {label}', a, b, x, xr, x64))
    if not torch.equal(kb.tree_ldl(qM, b, parent, diag=dg), x):
      raise RuntimeError(f'B7 {label}: x without the factor differs')
  print('  B7 x without the factor: bit-equal to x with it')
  _print_warp_shapes('three_humanoids', ('tree_ldl_kernel',))

  # ---- (j) B8 on B7's packed LD of qM, another right-hand side ----
  grad = torch.einsum('wij,wj->wi', qM, pre.qacc_warmstart) - qfs
  x7, ld = kb.tree_ldl(qM, grad, parent, return_factor=True)
  x8 = kb.tree_solve(ld, grad, parent)
  ld64 = ld.double()
  unit_l = torch.tril(ld64, -1) + torch.eye(m.nv, dtype=torch.float64,
                                            device=ld.device)
  a64 = unit_l.transpose(1, 2) @ (torch.diagonal(
      ld64, dim1=1, dim2=2)[..., None] * unit_l)
  errs['tree_solve'] = _check_factor_solve(
      'B8', a64, grad, x8,
      batch_linalg.tree_solve_from_factor_batched(ld, grad, parent),
      batch_linalg.tree_solve_from_factor_batched(ld64, grad.double(),
                                                  parent), x7)
  _print_warp_shapes('three_humanoids', ('tree_solve_kernel',))

  # B5 on the Hessian of the solve's first Newton direction
  J, D, fl = pre.efc_J, pre.efc_D, pre.efc_frictionloss
  qacc = pre.qacc_warmstart
  jaref = torch.einsum('wrn,wn->wr', J, qacc) - pre.efc_aref
  force, _, quad = solver._update_constraint(
      jaref, D, fl, fl / torch.clamp(D, min=solver.MINVAL),
      *solver._row_masks(pre.efc_type))
  H = qM + torch.bmm((J * (D * quad)[..., None]).transpose(1, 2), J)
  grad = (torch.einsum('wij,wj->wi', qM, qacc) - qfs -
          torch.einsum('wrn,wr->wn', J, force))
  rows = int(quad.sum())
  print(f'  B5 Hessians: {rows / NWORLD:.2f} quadratic rows per world')
  x = kb.spd_solve(H, grad)
  xr = batch_linalg.spd_solve_batched(H, grad)
  x64 = batch_linalg.spd_solve_batched(H.double(), grad.double())
  errs['spd_solve'] = _check_solve('B5', H, grad, x, xr, x64)
  _check_repeat('B5', lambda: dict(x=kb.spd_solve(H, grad)))
  _print_warp_shapes('three_humanoids', ('spd_solve_kernel',))

  # ---- (g) the main path, counted and timed ----
  _reset_counts()
  d, res = bench.benchmark(m, d, nstep=_bench_nstep(NSTEP3))
  steps = NSTEP3
  if res['dispatch'] != 'eager':     # the unfused solve syncs the host
    raise RuntimeError(f'three_humanoids ran {res["dispatch"]}')
  if kb.launches['tree_solve'] or kb.launches['cho_solve'] or kn.launches:
    raise RuntimeError(f'the Newton step launched {kb.launches}, newton '
                       f'{kn.launches}')
  _expect_no_entries('the three_humanoids main path')
  counts = {'smooth[three_humanoids]': ks.launches,
            'contact[three_humanoids]': kc.launches,
            'tree_ldl': kb.launches['tree_ldl'],
            'tree_ldl[euler]': kb.launches_no_factor,
            'spd_solve': kb.launches['spd_solve']}
  expect = {'smooth[three_humanoids]': steps,
            'contact[three_humanoids]': steps, 'tree_ldl': 2 * steps,
            'tree_ldl[euler]': steps,
            'spd_solve': solver.counts['solve'] + solver.counts['passes']}
  print(f'launches in the main path: {counts} for {steps} steps, '
        f'{solver.counts["passes"]} Newton passes after {steps} initial '
        f'directions; glue {kg.launches}')
  if (counts != expect or kg.launches or solver.counts['solve'] != steps or
      not solver.counts['passes']):
    raise RuntimeError(f'launch counts {counts}, expected {expect}')
  for k in ('qpos', 'qvel', 'qacc', 'efc_force', 'cam_xpos', 'light_xpos'):
    if not bool(torch.isfinite(getattr(d, k)).all()):
      raise RuntimeError(f'non-finite {k} after the main path')
  print(f'step: {res["steps_per_sec"]:.1f} steps/s, '
        f'{res["step_time_us"]:.1f} us/step over {res["nstep"]} timed of '
        f'{steps} steps at {NWORLD} worlds; final ncon mean '
        f'{res["ncon_mean"]:.2f}, solver_niter mean '
        f'{res["solver_niter_mean"]:.2f} max {res["solver_niter_max"]}, '
        f'solve stopped before opt.iterations in {_solved(m, d)} of '
        f'{NWORLD}; {res["converged_worlds"]} worlds without NaN ({card})')
  print(json.dumps({'step_three_humanoids': dict(res, card=card)}))

  # one whole step of the kernel path against the all-plain path
  d_k = mt.step_batched(m, d)
  with _plain_kernels():
    d_p = mt.step_batched(m, d)
  same = ((d_k.ncon == d_p.ncon) & (d_k.efc_type == d_p.efc_type).all(1) &
          (d_k.efc_active == d_p.efc_active).all(1))
  nbad = NWORLD - int(same.sum())
  print(f'  step: {nbad} of {NWORLD} worlds with a different contact/row '
        f'set')
  if nbad > max(8, NWORLD // 1000):
    raise RuntimeError(f'step: {nbad} worlds differ in their row sets')
  _compare('step', {'qacc': d_k.qacc}, {'qacc': d_p.qacc}, TOL_STEP_QACC,
           ['qacc'], worlds=same)
  f64 = lambda x: x.double()[same]
  objective = lambda qa: solver.objective(
      f64(d_p.qM), f64(d_p.efc_J), f64(d_p.efc_D), f64(d_p.efc_aref),
      f64(d_p.efc_frictionloss), f64(d_p.qfrc_smooth), f64(d_p.qacc_smooth),
      f64(qa), 0, 0)
  unit = float(m.opt.tolerance) * float(m.stat.meaninertia) * m.nv
  gap = ((objective(d_k.qacc) - objective(d_p.qacc)) / unit).abs()
  dn = (d_k.solver_niter - d_p.solver_niter).abs()
  print(f'  step objective gap / (tolerance * meaninertia * nv): max '
        f'{float(gap.max()):.3e} (tol {TOL_OBJ:g}); solver_niter |diff| '
        f'histogram {dn.bincount().tolist()}')
  if not float(gap.max()) <= TOL_OBJ:
    raise RuntimeError('step: the kernel path misses the plain path\'s '
                       'objective')

  # ---- P12: the implicitfast Newton step, eager ----
  m12 = m.replace(opt=m.opt.replace(
      integrator=int(IntegratorType.IMPLICITFAST)))
  names12 = [n for n, _ in forward.batched_stages(m12, d)]
  print(f'stages of the implicitfast step: {" -> ".join(names12)}')
  if names12 != names[:-1] + ['implicitfast'] or forward.replays(m12, d):
    raise RuntimeError('implicitfast three_humanoids does not run the '
                       'unfused list')
  d12, res12, steps12, counts12 = _run_path(
      'step_implicitfast_three_humanoids', m12, d, P12_STEPS, card)
  solves = solver.counts['solve'] + solver.counts['passes']
  if solver.counts['solve'] != steps12 or kb.launches_no_factor:
    raise RuntimeError(f'P12: solver counts {solver.counts}, B7 without '
                       f'the factor {kb.launches_no_factor}')
  # B7 once a step (fwd_acceleration; no Euler re-solve), B5 once per
  # Newton direction and once on qM - h qDeriv
  _expect_counts('P12', dict(_zero_counts(), smooth=steps12,
                             contact=steps12, tree_ldl=steps12,
                             spd_solve=solves + steps12), counts12)
  _compare_step('P12 step', m12, d12, TOL_STEP_QACC, ('qacc', 'qvel'))
  # step1 and step2 split the same unfused list
  d_a = mt.step2(m12, mt.step1(m12, d12))
  d_b = mt.step_batched(m12, d12)
  again = _differing(d_b, mt.step_batched(m12, d12))
  diff = _differing(d_a, d_b)
  said = lambda x: 'bit-equal' if not x else f'differ in {x}'
  print(f'  P12: step2(step1(d)) against step_batched {said(diff)} (two '
        f'step_batched runs {said(again)})')
  if again:
    _compare('P12 step2(step1(d))', vars(d_a), vars(d_b), TOL_STEP_QACC,
             ['qacc', 'qvel', 'qpos'])
  elif diff:
    raise RuntimeError(f'P12: step2(step1(d)) differs in {diff}')
  _print_profile('profile_implicitfast_three_humanoids',
                 lambda: bench.rollout(m12, d12, PROFILE3), PROFILE3,
                 res12['step_time_us'] / 1e3, card)
  # B5 as `forward.implicit` calls it: on qM - h qDeriv, made symmetric
  from mujoco_warp_tpu_torch import derivative
  from mujoco_warp_tpu_torch.utils.compare_trees import device_ms
  mh = d12.qM - m12.opt.timestep * derivative.deriv_smooth_vel(m12, d12)
  mh = 0.5 * (mh + mh.transpose(1, 2))
  rhs = d12.qfrc_smooth + d12.qfrc_constraint
  n = m.nv
  bound5 = NWORLD * 4 * (n * (n + 1) // 2 + 2 * n) / PEAK_BYTES * 1e3
  ms5 = device_ms(lambda: kb.spd_solve(mh, rhs))
  plain5 = _cuda_ms(lambda: batch_linalg.spd_solve_batched(mh, rhs), 3)
  print(f'  spd_solve on qM - h qDeriv (n {n}): {ms5:.4f} ms on the card '
        f'(plain {plain5:.3f} ms), bound {bound5:.4f} ms by bytes ({card})')

  # ---- (h) kernel times, plain times, bounds and library calls ----
  records = []
  W = NWORLD
  # the records `tree_ldl` (with the factor) and `tree_ldl[euler]` (without
  # it) split B7's launches between them; B5's counts P12's launches too
  # (its Newton directions and the implicit solve)
  print(f'  spd_solve: {counts["spd_solve"]} launches in the main path, '
        f'{counts12["spd_solve"]} in P12 ({steps12} of them on qM - h '
        f'qDeriv)')
  launched = dict(counts, tree_ldl=counts['tree_ldl'] -
                  counts['tree_ldl[euler]'],
                  spd_solve=counts['spd_solve'] + counts12['spd_solve'])
  record = lambda name, *args, **kw: _record(records, name, launched[name],
                                              errs[name.split('[')[0]],
                                              *args, **kw)
  tables = lambda key, make: _build.model_tables(m, key, make)
  sm_in = (d.qpos, d.qvel)
  sm_out = ks.smooth(m, *sm_in)
  c_in = (sm_out['qpos'], d.qvel, sm_out['geom_xpos'], sm_out['geom_xmat'],
          sm_out['subtree_com'], sm_out['cdof'])
  c_out = kc.contact(m, *c_in, NCONMAX3)
  record('smooth[three_humanoids]', 'mujoco_warp_tpu_torch/csrc/smooth.cu',
         'mujoco_warp_tpu/pallas/smooth_kernels.py:557',
         lambda: ks.smooth(m, *sm_in), lambda: smooth.smooth(m, *sm_in),
         _nbytes(sm_in, sm_out, tables('smooth', ks._tables)),
         _flops_b1(m, W))
  record('contact[three_humanoids]', 'mujoco_warp_tpu_torch/csrc/contact.cu',
         'mujoco_warp_tpu/pallas/contact_kernels.py:1643',
         lambda: kc.contact(m, *c_in, NCONMAX3),
         lambda: kc.plain(m, *c_in, NCONMAX3),
         _bytes_b2(m, c_in, c_out), _flops_b2(m, W, c_out, NCONMAX3))
  # B7 as fwd_acceleration calls it (factor written); it needs only the
  # packed entries of qM
  lens = [len(r) for r in m.dof_ancestor_rows]    # each row: dof, ancestors
  nnz, nv = sum(lens), m.nv
  pairs = sum((n - 1) * n // 2 for n in lens)
  bytes_b7 = W * 4 * (nnz + 2 * nv + nv * nv)
  flops_b7 = W * (2 * pairs + 4 * (nnz - nv) + 2 * nv)
  x_only = _cuda_ms(lambda: torch.linalg.solve(qM, qfs), 20)
  print(f'  tree_ldl: torch.linalg.solve for x alone (no packed factor, '
        f'not the same function): {x_only:.4f} ms')
  record('tree_ldl', 'mujoco_warp_tpu_torch/csrc/batch_linalg.cu',
         'mujoco_warp_tpu/pallas/batch_linalg.py:314',
         lambda: kb.tree_ldl(qM, qfs, parent, return_factor=True),
         lambda: batch_linalg.tree_ldl_solve_batched(qM, qfs, parent,
                                                     return_factor=True),
         bytes_b7, flops_b7)
  # B7 as the Euler re-solve calls it: the diagonal, no factor written;
  # x alone is also what torch.linalg.solve computes
  b_euler = qfs + post.qfrc_constraint
  a_euler = qM + torch.diag(diag)
  record('tree_ldl[euler]', 'mujoco_warp_tpu_torch/csrc/batch_linalg.cu',
         'mujoco_warp_tpu/pallas/batch_linalg.py:314',
         lambda: kb.tree_ldl(qM, b_euler, parent, diag=diag),
         lambda: batch_linalg.tree_ldl_solve_batched(qM, b_euler, parent,
                                                     diag=diag),
         W * 4 * (nnz + 2 * nv), flops_b7,
         library=lambda: torch.linalg.solve(a_euler, b_euler))
  # B5 reads the Hessian's upper triangle (column j of the factor starts
  # from row j), b, and writes x
  n = m.nv
  record('spd_solve', 'mujoco_warp_tpu_torch/csrc/batch_linalg.cu',
         'mujoco_warp_tpu/pallas/batch_linalg.py:103',
         lambda: kb.spd_solve(H, grad),
         lambda: batch_linalg.spd_solve_batched(H, grad),
         W * 4 * (n * (n + 1) // 2 + 2 * n), W * (n ** 3 / 3 + 2 * n * n),
         library=lambda: torch.linalg.solve(H, grad))
  _print_profile('profile_three_humanoids',
                 lambda: bench.rollout(m, d, PROFILE3), PROFILE3,
                 res['step_time_us'] / 1e3, card)

  # ---- (k) P6: CG steps ----
  cg = m.replace(opt=m.opt.replace(solver=int(SolverType.CG)))
  cg_names = [n for n, _ in forward.batched_stages(cg, d)]
  print(f'stages of the CG step: {" -> ".join(cg_names)}')
  if cg_names != names:
    raise RuntimeError('three_humanoids with CG does not run the unfused '
                       'list')
  d6, _, steps, _ = _run_path('step_cg_three_humanoids', cg, d, CG3_STEPS,
                           card)
  solves = solver.counts['solve'] + solver.counts['passes']
  if solver.counts['solve'] != steps or not solver.counts['passes']:
    raise RuntimeError(f'CG: solver counts {solver.counts}')
  _expect_counts('CG three_humanoids', dict(
      _zero_counts(), smooth=steps, contact=steps, tree_ldl=2 * steps,
      tree_solve=solves))
  _compare_step('CG step', cg, d6, TOL_STEP_QACC_CG, tol_obj=TOL_OBJ_CG)

  # ---- (l) B8: time, plain time and bound ----
  _, ld = kb.tree_ldl(qM, qfs, parent, return_factor=True)
  grad = torch.einsum('wij,wj->wi', qM, d.qacc_warmstart) - qfs
  _record(records, 'tree_solve', solves, errs['tree_solve'],
          'mujoco_warp_tpu_torch/csrc/batch_linalg.cu',
          'mujoco_warp_tpu/pallas/batch_linalg.py:369',
          lambda: kb.tree_solve(ld, grad, parent),
          lambda: batch_linalg.tree_solve_from_factor_batched(ld, grad,
                                                              parent),
          W * 4 * (nnz + 2 * nv), W * (4 * (nnz - nv) + nv))
  return records + _smooth_entries('[three_humanoids]', m, d_f)


def _flops_cone(m, cone, D, it) -> float:
  """Operations the elliptic cone adds to the Newton solve (B3e,
  B4-elliptic), estimated from this run's contacts: per elliptic contact
  whose normal row acts and per iteration, the zone and force update,
  the S x S Hessian block over nv dofs (counted for every such contact,
  though only the middle zone builds it) and 16 linesearch points."""
  from mujoco_warp_tpu_torch import solver
  K = solver.Cone(m, D, cone)
  S, nv = K.S, m.nv
  ncone = (K.is_ell & (K.d_blk[..., 0] != 0)).sum(1).double()
  per = 12 * S + 2 * S * S * nv + S * nv * nv + 16 * 14 * S
  return float((ncone * per * (it.double() + 1)).sum())


def _next_ulp(x):
  """x moved by one ulp towards +inf."""
  import torch
  return torch.nextafter(x, torch.full_like(x, float('inf')))


def _ell_refs(m, g_in, cone=None) -> tuple:
  """The plain glue solve (B3's, B3e's with `cone`) on the inputs g_in:
  in float32, after a 1-ulp change of qfx up and down, and in float64."""
  import torch
  from mujoco_warp_tpu_torch import forward
  kw = {} if cone is None else dict(cone=cone)
  f64 = lambda xs: [x.double() if torch.is_tensor(x) and
                    x.is_floating_point() else x for x in xs]
  ulps = [forward.glue(m, *g_in[:8], torch.nextafter(
      g_in[8], torch.full_like(g_in[8], to)), g_in[9], **kw)
          for to in (float('inf'), float('-inf'))]
  exact = forward.glue(m, *f64(g_in), **(
      {} if cone is None else dict(cone=tuple(f64(cone)))))
  return forward.glue(m, *g_in, **kw), ulps[0], ulps[1], exact


def _check_ell_solve(label, m, out, ref, ulp, args, cone, qfs,
                     resolve=False, exact=None, exact_noise=None,
                     factor=EXACT_OBJ_FACTOR, over_exact=False) -> float:
  """Hold B3e's or B4-elliptic's outputs `out` to B3's tolerances against
  the plain version's `ref`, measured against `ulp`, the plain version
  after a 1-ulp change of qfrc_smooth (see ELLIPTIC): the worlds over
  qacc, qacc_smooth, qLD, qacc_euler (and qvel) at TOL_B3_OTHER, forces at
  5e-4, qpos at 5e-6 of scale; the worlds whose float64 objective lies
  more than TOL_OBJ units of tolerance * meaninertia * nv above the plain
  solve's; the solver_niter share within NITER_SLACK. With `resolve` (an
  integration diagonal: qacc_euler is a linear image of qfrc_constraint
  through the ill-conditioned (qM + diag)^-1), qacc_euler at 5e-4, as
  _check_newton holds it, and the advance is the caller's to hold against
  the kernel's own qacc_euler, as _check_glue_diag holds it. With
  `exact`, the plain solve in float64 on the same inputs, solver_niter
  is held against exact's in place of the plain solve's (the note on
  franka after ELLIPTIC): the kernel's share of worlds within
  NITER_SLACK of exact's at least the plain solve's less
  EXACT_NITER_MARGIN, its mean at most the plain solve's plus
  NITER_MEAN_SLACK. With `exact_noise` too (apollo, see RICH_LEGS: more
  float32 plain solves on perturbed inputs), the objective is held
  against exact's in place of the plain solve's: the kernel's worlds more
  than TOL_OBJ units above the float64 solve's may number max(8, nworld
  / 1000) plus `factor` (EXACT_OBJ_FACTOR) times the largest count of
  such worlds of the float32 plain solve, `ulp` and `exact_noise`. With
  `over_exact` too (aloha_pot, see ALOHA_OBJ_FACTOR: there two float32
  solves that differ in the order of their sums stop in different
  worlds), the worlds over the tolerances are counted against exact's
  by the same rule, in place of the plain solve's. Returns the max abs
  error of the worlds within the tolerances (against exact's with
  `over_exact`)."""
  import torch
  tol = dict(qacc=TOL_B3_OTHER, qacc_smooth=TOL_B3_OTHER, qLD=TOL_B3_OTHER,
             qacc_euler=5e-4 if resolve else TOL_B3_OTHER,
             qfrc_constraint=5e-4, efc_force=5e-4)
  if 'qpos' in out and not resolve:
    tol.update(qpos=TOL_B3['qpos'], qvel=TOL_B3_OTHER)
  W = out['qacc'].shape[0]
  allowed = max(8, W // 1000)
  unit = float(m.opt.tolerance) * float(m.stat.meaninertia) * max(1, m.nv)
  objective = lambda qacc: _objective(m, *args, qfs, qacc, cone)
  o_ref = objective(ref['qacc'])

  def spread(x):
    """Worlds over a tolerance, objective above the plain solve's (units),
    solver_niter less the plain solve's, of the solution x."""
    over = torch.zeros(W, dtype=torch.bool, device=x['qacc'].device)
    for k, t in tol.items():
      scale = max(1.0, float(ref[k].abs().max()))
      over |= (x[k] - ref[k]).abs().reshape(W, -1).amax(1) / scale > t
    return (over, (objective(x['qacc']) - o_ref) / unit,
            x['solver_niter'] - ref['solver_niter'])
  over, gap, dn = spread(out)
  over_u, gap_u, dn_u = spread(ulp)
  worse, worse_u = gap > TOL_OBJ, gap_u > TOL_OBJ
  share = float((dn.abs() <= NITER_SLACK).float().mean())
  share_u = float((dn_u.abs() <= NITER_SLACK).float().mean())
  held = ~over
  if over_exact:
    n_o = [int(_worlds_over(x, exact, tol, list(tol))[0].sum())
           for x in (ref, ulp, *exact_noise)]
    held = ~_worlds_over(out, exact, tol, list(tol))[0]
    limit = allowed + factor * max(n_o)
    print(f'  {label} worlds over the tolerances against the float64 '
          f'plain solve: kernel {int((~held).sum())}, float32 plain solve '
          f'and its perturbations {n_o} (allowed {allowed} + {factor:g} x '
          f'{max(n_o)} = {limit:g})')
    if int((~held).sum()) > limit:
      raise RuntimeError(f'{label}: {int((~held).sum())} worlds over the '
                         f'tolerances against the float64 solve')
  worst = _compare(label, out, exact if over_exact else ref, tol, list(tol),
                   worlds=held)
  fmt = lambda t: [float(f'{v:.3g}') for v in t.tolist()]
  for name, o, g, d in (('kernel', over, gap, dn),
                        ('plain(qfrc_smooth + 1 ulp)', over_u, gap_u, dn_u)):
    print(f'  {label} {name} against the plain solve: {int(o.sum())} of {W} '
          f'worlds over the tolerances; objective above it by more than '
          f'{TOL_OBJ:g} unit in {int((g > TOL_OBJ).sum())} worlds '
          f'{fmt(g[g > TOL_OBJ])} with solver_niter less the plain solve\'s '
          f'{d[g > TOL_OBJ].tolist()}, lowest {float(g.min()):.3g} units; '
          f'solver_niter |diff| histogram {d.abs().bincount().tolist()}')
  print(f'  {label} solver_niter within {NITER_SLACK}: {share:.4f} of the '
        f'worlds, the perturbed plain solve {share_u:.4f}')
  if not over_exact and int(over.sum()) > allowed + 2 * int(over_u.sum()):
    raise RuntimeError(f'{label}: {int(over.sum())} worlds over the '
                       f'tolerances')
  if exact_noise is not None:
    o_x = objective(exact['qacc'])
    above = [(objective(x['qacc']) - o_x) / unit
             for x in (out, ref, ulp, *exact_noise)]
    n_x = [int((g > TOL_OBJ).sum()) for g in above]
    limit = allowed + factor * max(n_x[1:])
    print(f'  {label} objective more than {TOL_OBJ:g} unit above the '
          f'float64 plain solve\'s: kernel {n_x[0]} worlds, float32 plain '
          f'solve and its perturbations {n_x[1:]} (allowed {allowed} + '
          f'{factor:g} x {max(n_x[1:])} = {limit:g}); their '
          f'units above it in all '
          f'{[float(f"{float(g[g > TOL_OBJ].sum()):.4g}") for g in above]}')
    if n_x[0] > limit:
      raise RuntimeError(f'{label}: {n_x[0]} worlds more than {TOL_OBJ:g} '
                         f'unit above the float64 solve\'s objective')
  elif int(worse.sum()) > allowed + 2 * int(worse_u.sum()):
    raise RuntimeError(f'{label}: a higher objective in {int(worse.sum())} '
                       f'worlds')
  if exact is not None:
    near = lambda x: float(((x['solver_niter'] - exact['solver_niter'])
                            .abs() <= NITER_SLACK).float().mean())
    mean = lambda x: float(x['solver_niter'].float().mean())
    print(f'  {label} solver_niter within {NITER_SLACK} of the float64 '
          f'plain solve\'s: kernel {near(out):.4f}, float32 plain solve '
          f'{near(ref):.4f} of the worlds; mean solver_niter kernel '
          f'{mean(out):.3f}, plain {mean(ref):.3f}, float64 '
          f'{mean(exact):.3f}')
    if near(out) < near(ref) - EXACT_NITER_MARGIN or \
        mean(out) > mean(ref) + NITER_MEAN_SLACK:
      raise RuntimeError(f'{label}: solver_niter lies further from the '
                         f'float64 solve\'s than the plain solve\'s '
                         f'(margins {EXACT_NITER_MARGIN}, '
                         f'{NITER_MEAN_SLACK})')
  elif share < share_u - NITER_MARGIN:
    raise RuntimeError(f'{label}: solver_niter differs by more than '
                       f'{NITER_SLACK} in too many worlds')
  return worst


def _elliptic_humanoid(card, m0, d0) -> list:
  """Phases (m)-(o) on the humanoid with the elliptic cone, from the
  state the pyramidal main path left: P7 (the glue step, B3e) counted
  and timed, B2's elliptic rows, B3e and B4-elliptic held against their
  plain versions on its state, P8 (forward_batched and RK4 steps,
  B4-elliptic) counted and timed, each step against the all-plain step;
  returns the records of B2 (elliptic rows), B3e and B4-elliptic."""
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import forward, solver
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import newton as kn
  from mujoco_warp_tpu_torch.types import IntegratorType
  m = mt.override_model(m0, ELLIPTIC)
  names = lambda mm, dd: [n for n, _ in forward.batched_stages(mm, dd)]
  print(f'elliptic humanoid: cone {m.opt.cone}, impratio '
        f'{float(m.opt.impratio):g}, ls_parallel {m.opt.ls_parallel}, '
        f'rows {tuple(d0.efc_J.shape[1:])} -> '
        f'{mt.efc_layout(m, NCONMAX)[4]}; stages of the step: '
        f'{" -> ".join(names(m, mt.make_data(m, nconmax=NCONMAX)))}')

  # ---- (o) P7: the glue step through B3e, counted and timed ----
  d = mt.make_data(m, nconmax=NCONMAX, nworld=NWORLD).replace(
      qpos=d0.qpos, qvel=d0.qvel, ctrl=d0.ctrl, time=d0.time,
      qacc_warmstart=d0.qacc_warmstart)
  if names(m, d) != ['smooth_mega[cuda]', 'contact_efc_mega[cuda]',
                     'act_len_vel', 'solve_glue[cuda]']:
    raise RuntimeError('the elliptic humanoid does not take the glue list')
  d7, res7, steps, counts7 = _run_path('step_elliptic', m, d, P7_STEPS,
                                       card)
  _expect_counts('P7', dict(_zero_counts(), smooth=steps, contact=steps,
                            glue_ell=steps), counts7)
  if not bool((d7.efc_type == 7).any()):
    raise RuntimeError('P7: no elliptic contact rows')

  # ---- (m) B2's elliptic rows against the plain rows ----
  errs = {}
  _, c_in, c_out, g_in = _glue_inputs(m, d7)
  c_ref = kc.plain(m, *c_in, NCONMAX)
  errs['contact'] = _check_contact('B2 elliptic', m, c_in, c_out, c_ref)
  _check_repeat('B2 elliptic', lambda: kc.contact(m, *c_in, NCONMAX))
  _print_warp_shapes('humanoid', ('contact_ell_kernel',))

  # ---- (n) B3e and B4-elliptic against their plain versions ----
  cone = solver.cone_inputs(m, mt.Contact(
      **{k: c_out[k] for k in kc.CONTACT_FIELDS}))
  g_out = kg.glue(m, *g_in, cone=cone)
  g_ref = forward.glue(m, *g_in, cone=cone)
  # qfrc_smooth = qfx + the passive and actuator forces: one ulp of qfx
  g_ulp = forward.glue(m, *g_in[:8], _next_ulp(g_in[8]), g_in[9], cone=cone)
  errs['glue_ell'] = _check_ell_solve('B3e', m, g_out, g_ref, g_ulp,
                                      g_in[:5], cone, g_out['qfrc_smooth'])
  n_in = g_in[:5] + (g_out['qfrc_smooth'], g_in[9])
  n_out = kn.newton_solve(m, *n_in, cone=cone)
  n_ref = solver.newton_solve(m, *n_in, cone=cone)
  n_ulp = solver.newton_solve(m, *n_in[:5], _next_ulp(n_in[5]), n_in[6],
                              cone=cone)
  errs['newton_ell'] = _check_ell_solve('B4-elliptic', m, n_out, n_ref,
                                        n_ulp, n_in[:5], cone, n_in[5])
  same = [k for k in kn.OUTPUTS if not torch.equal(n_out[k], g_out[k])]
  print(f'  B4-elliptic against B3e\'s solve on the same qfrc_smooth: '
        f'{"bit-equal" if not same else "differs in " + str(same)}')
  if same:
    raise RuntimeError('B4-elliptic differs from B3e\'s solve')
  _check_repeat('B3e', lambda: kg.glue(m, *g_in, cone=cone))
  _check_repeat('B4-elliptic', lambda: kn.newton_solve(m, *n_in, cone=cone))
  # B3e in mode 2 (implicitfast) on the same inputs
  me2 = m.replace(opt=m.opt.replace(
      integrator=int(IntegratorType.IMPLICITFAST)))
  if forward.glue_mode(me2) != 2:
    raise RuntimeError('the elliptic implicitfast humanoid is not in mode 2')
  g2_out = kg.glue(me2, *g_in, cone=cone)
  g2_ref = forward.glue(me2, *g_in, cone=cone)
  g2_ulp = forward.glue(me2, *g_in[:8], _next_ulp(g_in[8]), g_in[9],
                        cone=cone)
  _check_ell_solve('B3e mode 2', me2, g2_out, g2_ref, g2_ulp, g_in[:5],
                   cone, g2_out['qfrc_smooth'], resolve=True)
  h = float(me2.opt.timestep)
  qvel2 = g_in[6] + h * g2_out['qacc_euler']
  _compare('B3e mode 2 advance', g2_out, dict(
      qvel=qvel2, qpos=forward.integrate_pos(me2, g_in[5], qvel2, h)),
           dict(qvel=TOL_B3_OTHER, qpos=TOL_B3['qpos']), ['qvel', 'qpos'])
  _check_repeat('B3e mode 2', lambda: kg.glue(me2, *g_in, cone=cone))
  from mujoco_warp_tpu_torch.utils.compare_trees import device_ms
  times = collections.defaultdict(list)
  runs = (('mode 0', m), ('mode 2', me2))
  for turn in (runs, runs[::-1]):
    for label, mm in turn:
      times[label].append(device_ms(lambda: kg.glue(mm, *g_in, cone=cone),
                                    20))
  print(f'  B3e on the same inputs, ms on the card (two turns): '
        f'{ {k: [round(t, 4) for t in v] for k, v in times.items()} } '
        f'({card})')
  _print_warp_shapes('humanoid', ('glue_ell_kernel', 'newton_ell_kernel'))

  # P7 against the all-plain step
  _compare_step('P7 step', m, d7, TOL_STEP_QACC, ('qacc', 'qvel'),
                spread=True)

  # ---- (o) P8: forward_batched and RK4 steps through B4-elliptic ----
  _reset_counts()
  fwd = mt.forward_batched(m, d7)
  torch.cuda.synchronize()
  _expect_counts('P8 forward_batched', dict(_zero_counts(), smooth=1,
                                            contact=1, newton_ell=1))
  launches_b4e = kn.launches_ell
  if not bool(torch.isfinite(fwd.qacc).all()):
    raise RuntimeError('P8 forward_batched: non-finite qacc')
  rk4 = m.replace(opt=m.opt.replace(integrator=int(IntegratorType.RK4)))
  if names(rk4, d7)[-2:] != ['solve[cuda]', 'rk4']:
    raise RuntimeError('the elliptic RK4 humanoid does not run B4-elliptic')
  d8, _, steps, counts = _run_path('step_elliptic_rk4', rk4, d7, P8_STEPS,
                                   card)
  _expect_counts('P8 RK4', dict(_zero_counts(), smooth=4 * steps,
                                contact=4 * steps, newton_ell=4 * steps),
                 counts)
  launches_b4e += counts['newton_ell']
  _compare_step('P8 RK4 step', rk4, d8, TOL_STEP_QACC, ('qacc', 'qvel'),
                spread=True)

  # ---- kernel times, plain times, bounds (state of P7) ----
  records = []
  W, nv = NWORLD, m.nv
  tables = lambda key, make: _build.model_tables(m, key, make)
  _record(records, 'contact[elliptic]', counts7['contact'], errs['contact'],
          'mujoco_warp_tpu_torch/csrc/contact.cu',
          'mujoco_warp_tpu/pallas/contact_kernels.py:1643',
          lambda: kc.contact(m, *c_in, NCONMAX),
          lambda: kc.plain(m, *c_in, NCONMAX),
          _bytes_b2(m, c_in, c_out), _flops_b2(m, W, c_out, NCONMAX))
  # as B3: efc_J and efc_aref of the acting rows only, and the cone's
  # friction and dim
  acting = int(((g_in[2] != 0) | (g_in[4] != 0)).sum())
  row_bytes = acting * (nv + 1) * 4 - _nbytes(g_in[1:2], g_in[3:4])
  print(f'  elliptic: {acting / W:.2f} acting rows of '
        f'{g_in[1].shape[1]} per world; B3e solver_niter mean '
        f'{float(g_out["solver_niter"].float().mean()):.2f}')
  _record(records, 'glue_ell', counts7['glue_ell'], errs['glue_ell'],
          'mujoco_warp_tpu_torch/csrc/glue.cu',
          'mujoco_warp_tpu/pallas/solver_kernels.py:954',
          lambda: kg.glue(m, *g_in, cone=cone),
          lambda: forward.glue(m, *g_in, cone=cone),
          _nbytes(g_in, g_out, tables('glue', kg._tables), cone[:2]) +
          row_bytes,
          _flops_newton(nv, c_out['nefc'].double(),
                        g_out['solver_niter'].double(), m.nu) +
          _flops_cone(m, cone, g_in[2], g_out['solver_niter']))
  _record(records, 'newton_ell', launches_b4e, errs['newton_ell'],
          'mujoco_warp_tpu_torch/csrc/newton.cu',
          'mujoco_warp_tpu/pallas/solver_kernels.py:88',
          lambda: kn.newton_solve(m, *n_in, cone=cone),
          lambda: solver.newton_solve(m, *n_in, cone=cone),
          _nbytes(n_in, n_out, cone[:2]) + row_bytes,
          _flops_newton(nv, c_out['nefc'].double(),
                        n_out['solver_niter'].double()) +
          _flops_cone(m, cone, n_in[2], n_out['solver_niter']))
  _replay_against_eager('P7', m, d7, dict(smooth=1, contact=1,
                                          glue_ell=1), PROFILE_STEPS, card)
  _replay_against_eager('P8', rk4, d7, dict(smooth=4, contact=4,
                                            newton_ell=4), PROFILE_RK4, card)
  return records


def _elliptic_three(card) -> list:
  """Phase (m) and P9 of (o) on three_humanoids with the elliptic cone:
  B2's elliptic rows against the plain rows; the unfused step (B1, B2,
  B7 twice, B5 once per Newton direction, the iterative linesearch)
  counted and timed, and one step against the all-plain step; returns
  the record of B2's elliptic rows at this size."""
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import forward, models, solver
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  m = mt.override_model(mt.load_model(models.THREE_HUMANOIDS_NPZ,
                                      device='cuda'), ELLIPTIC)
  gen = torch.Generator(device='cuda').manual_seed(SEED)
  d = mt.make_batch(m, mt.make_data(m, nconmax=NCONMAX3), NWORLD,
                    qpos_noise=QPOS_NOISE, generator=gen)
  names = [n for n, _ in forward.batched_stages(m, d)]
  print(f'elliptic three_humanoids: rows {mt.efc_layout(m, NCONMAX3)[4]}, '
        f'ls_parallel {m.opt.ls_parallel}, ls_iterations '
        f'{m.opt.ls_iterations}; stages: {" -> ".join(names)}')
  if names[-2:] != ['solve', 'euler'] or 'solve_glue[cuda]' in names:
    raise RuntimeError('elliptic three_humanoids does not run the unfused '
                       'list')
  d = bench.rollout(m, d, P9_PREP)

  # ---- (m) B2's elliptic rows against the plain rows ----
  sm = ks.smooth(m, d.qpos, d.qvel)
  c_in = (sm['qpos'], d.qvel, sm['geom_xpos'], sm['geom_xmat'],
          sm['subtree_com'], sm['cdof'])
  c_out = kc.contact(m, *c_in, NCONMAX3)
  c_ref = kc.plain(m, *c_in, NCONMAX3)
  err = _check_contact('B2 elliptic three_humanoids', m, c_in, c_out, c_ref)
  _check_repeat('B2 elliptic three_humanoids',
                lambda: kc.contact(m, *c_in, NCONMAX3))
  _print_warp_shapes('three_humanoids', ('contact_ell_kernel',))

  # ---- (o) P9: counted and timed, then one step against the plain ----
  d9, res9, steps, _ = _run_path('step_elliptic_three_humanoids', m, d,
                                 P9_STEPS, card)
  counts = solver.counts
  solves = counts['solve'] + counts['passes']
  print(f'  P9: {counts["passes"] / steps:.2f} Newton passes and '
        f'{counts["linesearch"] / steps:.2f} iterative linesearch steps per '
        f'step (the slowest world\'s), '
        f'{counts["linesearch"] / max(1, counts["passes"]):.2f} a pass')
  if counts['solve'] != steps or not counts['passes'] or \
      not counts['linesearch']:
    raise RuntimeError(f'P9: solver counts {counts}')
  _expect_counts('P9', dict(_zero_counts(), smooth=steps, contact=steps,
                            tree_ldl=2 * steps, spd_solve=solves))
  launches = _read_counts()['contact']
  if not bool((d9.efc_type == 7).any()):
    raise RuntimeError('P9: no elliptic contact rows')
  _compare_step('P9 step', m, d9, TOL_STEP_QACC, spread=True)
  _print_profile('profile_elliptic_three_humanoids',
                 lambda: bench.rollout(m, d9, 1), 1,
                 res9['step_time_us'] / 1e3, card)
  records = []
  _record(records, 'contact[elliptic three_humanoids]', launches, err,
          'mujoco_warp_tpu_torch/csrc/contact.cu',
          'mujoco_warp_tpu/pallas/contact_kernels.py:1643',
          lambda: kc.contact(m, *c_in, NCONMAX3),
          lambda: kc.plain(m, *c_in, NCONMAX3),
          _bytes_b2(m, c_in, c_out), _flops_b2(m, NWORLD, c_out, NCONMAX3))
  return records


def _reach_state(m, nworld, nconmax, gen):
  """franka's reach state (see REACH) at nworld worlds, seeded by gen."""
  import torch
  import mujoco_warp_tpu_torch as mt
  dev = m.device
  u = lambda *s: 2 * torch.rand(s, generator=gen, device=dev) - 1
  reach = torch.tensor(REACH, device=dev)
  q = reach.repeat(nworld, 1)
  q[:, [1, 3, 5]] += REACH_NOISE * u(nworld, 3)
  lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  ctrl = torch.minimum(torch.maximum(reach[:m.nu] + REACH_NOISE * u(
      nworld, m.nu), lo), hi)
  qvel = REACH_QVEL * torch.randn((nworld, m.nv), generator=gen, device=dev)
  off = torch.rand((nworld, 1), generator=gen, device=dev) < EQ_OFF
  d = mt.make_data(m, nconmax=nconmax, nworld=nworld)
  return d.replace(qpos=q, qvel=qvel, ctrl=ctrl,
                   eq_active=d.eq_active & ~off)


def _hold_or_count(label, per_world, counts):
  """Hold a solve by its per-world criteria (per_world()), or, where the
  linesearch lottery shows in them (LotteryShown), by the counts rule
  (counts(), see ELLIPTIC), as P11's step is held."""
  try:
    return per_world()
  except LotteryShown as e:
    print(f'  {label}: {e}; held by the counts rule against the plain '
          f'solve\'s own 1-ulp spread instead, as P11\'s step')
    return counts()


def _replay_after_flip(label, m, d):
  """One replayed step after eq_active was flipped in a seeded tenth of
  the worlds, in place in the graph's static input (as a user toggles an
  equality between steps), against the eager step from the same flipped
  state, every Data tensor bit for bit; the flipped worlds' equality
  rows must have changed."""
  import torch
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  one_step = bench.noise_step(m, d.nworld)
  step = torch.full((), REPLAY_START, dtype=torch.int32,
                    device=d.qpos.device)
  bench.warm_step(one_step, d, step)
  graph = bench.GraphStep(one_step, d, step)
  gen = torch.Generator(device=d.qpos.device).manual_seed(SEED + 1)
  flip = torch.rand(d.eq_active.shape, generator=gen,
                    device=d.qpos.device) < EQ_OFF
  flipped = d.eq_active ^ flip
  graph.data.eq_active.copy_(flipped)
  graph.replay()
  eager = one_step(d.replace(eq_active=flipped), step)
  unflipped = one_step(d, step)
  torch.cuda.synchronize()
  diff = _differing(graph.data, eager)
  moved = (eager.ne != unflipped.ne) | (eager.qacc != unflipped.qacc).any(1)
  print(f'  {label}: one replayed step after eq_active flipped in '
        f'{int(flip.any(1).sum())} worlds against the eager step: '
        f'{"bit-equal" if not diff else "differ in " + str(diff)}; the '
        f'flip changed ne or qacc in {int(moved.sum())} worlds')
  if diff:
    raise RuntimeError(f'{label}: the replay after the flip differs in '
                       f'{diff}')
  if not bool(moved[flip.any(1)].all()) or bool(moved[~flip.any(1)].any()):
    raise RuntimeError(f'{label}: the flip did not move exactly the '
                       f'flipped worlds')


def _franka(card) -> list:
  """Phase (r) on franka_emika_panda: B2's joint-equality rows and
  plane-box contacts (both entries) against the plain rows on the state
  P14 leaves and on the reach state, at nconmax FRANKA_NCONMAX and
  FRANKA_NCONMAX_WIDE; B3 in mode 2, B4 and B3e in mode 2 with the
  equality row in the solve; P14 (the implicitfast glue step at
  FRANKA_NWORLD worlds) counted, timed, replayed against eager steps and
  after an eq_active flip, and one step against the all-plain step, from
  qpos0 and from the reach state; returns the records of B2 (both
  states) and B3 in mode 2."""
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import forward, models, solver
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import newton as kn
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  m = mt.load_model(models.FRANKA_NPZ, device='cuda')
  W, C = FRANKA_NWORLD, FRANKA_NCONMAX
  d0 = mt.make_data(m, nconmax=C)
  names = [n for n, _ in forward.batched_stages(m, d0)]
  print(f'model: franka_emika_panda nq={m.nq} nv={m.nv} nbody={m.nbody} '
        f'ngeom={m.ngeom} nu={m.nu} neq={m.neq} pairs '
        f'{[(t1, t2, len(gl)) for t1, t2, gl in m.collision_pairs]} '
        f'candidates={m.nxn_candidates}; efc layout (ne, nf, nl, stride, '
        f'njmax) {mt.efc_layout(m, C)} at nconmax {C}; glue mode '
        f'{forward.glue_mode(m)}; stages: {" -> ".join(names)}')
  if names != ['smooth_mega[cuda]', 'camlight', 'contact_efc_mega[cuda]',
               'act_len_vel', 'solve_glue[cuda]'] or \
      forward.glue_mode(m) != 2 or not forward.replays(m, d0):
    raise RuntimeError('franka does not take the glue list in mode 2')
  gen = torch.Generator(device='cuda').manual_seed(SEED)

  # ---- B2 on the reach state, both entries, two pool sizes ----
  errs = {}
  me = mt.override_model(m, ELLIPTIC)
  for cone, mm in (('', m), (' elliptic', me)):
    for nconmax in (C, FRANKA_NCONMAX_WIDE):
      label = f'B2{cone} franka reach, nconmax {nconmax}'
      dd = _reach_state(mm, FRANKA_CHECK, nconmax, torch.Generator(
          device='cuda').manual_seed(SEED))
      _, c_in, c_out, _ = _glue_inputs(mm, dd, nconmax)
      c_ref = kc.plain(mm, *c_in, nconmax, dd.eq_active)
      err = _check_contact(label, mm, c_in, c_out, c_ref)
      errs['contact'] = max(errs.get('contact', 0.0), err)
      _check_repeat(label, lambda: kc.contact(mm, *c_in, nconmax,
                                              dd.eq_active))
      ncol = c_ref['ncollision']
      eq_on = dd.eq_active[:, 0]
      print(f'  {label}: ncollision histogram {ncol.bincount().tolist()}, '
            f'ncon mean {float(c_ref["ncon"].float().mean()):.2f}; '
            f'equality row active in {int(c_ref["ne"].sum())} worlds '
            f'(eq_active in {int(eq_on.sum())})')
      if not (bool((ncol == 0).any()) and bool((ncol >= 8).any()) and
              torch.equal(c_ref['ne'], eq_on.int())):
        raise RuntimeError(f'{label}: the reach state does not reach the '
                           f'plane-box and equality branches')
  _print_warp_shapes('franka', ('contact_eqbox_kernel',
                                'contact_eqbox_ell_kernel'), FRANKA_CHECK)

  # ---- B3 in mode 2, B4 and B3e in mode 2 on the reach state ----
  dd = _reach_state(m, FRANKA_CHECK, C, torch.Generator(
      device='cuda').manual_seed(SEED))
  _, _, c_out, g_in = _glue_inputs(m, dd, C)
  print(f'  franka solves: {int((c_out["ne"] == 1).sum())} worlds with '
        f'the equality row (ne = 1), {int(c_out["ncon"].sum())} with a '
        f'contact')
  g_ref = forward.glue(m, *g_in)
  g_out = kg.glue(m, *g_in)

  f64 = lambda args: [x.double() if torch.is_tensor(x) and
                      x.is_floating_point() else x for x in args]

  def b3_counts():
    g_ulp = forward.glue(m, *g_in[:8], _next_ulp(g_in[8]), g_in[9])
    err = _check_ell_solve('B3 mode 2 franka', m, g_out, g_ref, g_ulp,
                           g_in[:5], None, g_out['qfrc_smooth'],
                           resolve=True, exact=forward.glue(m, *f64(g_in)))
    h = float(m.opt.timestep)
    qvel = g_in[6] + h * g_out['qacc_euler']
    _compare('B3 mode 2 franka advance', g_out, dict(
        qvel=qvel, qpos=forward.integrate_pos(m, g_in[5], qvel, h)),
             dict(qvel=TOL_B3_OTHER, qpos=TOL_B3['qpos']), ['qvel', 'qpos'])
    _compare('B3 mode 2 franka', g_out, g_ref, TOL_B3_OTHER, [
        'actuator_force', 'qfrc_actuator', 'qfrc_spring', 'qfrc_damper',
        'qfrc_passive', 'qfrc_smooth'])
    _check_repeat('B3 mode 2 franka', lambda: kg.glue(m, *g_in))
    return err
  errs['glue'] = _hold_or_count(
      'B3 mode 2 franka',
      lambda: _check_glue_diag('B3 mode 2 franka', m, 2, g_in), b3_counts)
  n_in = g_in[:5] + (g_ref['qfrc_smooth'], g_in[9])
  n_out = kn.newton_solve(m, *n_in)
  n_ref = solver.newton_solve(m, *n_in)
  _hold_or_count(
      'B4 franka', lambda: _check_newton('B4 franka', m, n_out, n_ref, n_in,
                                         None),
      lambda: _check_ell_solve('B4 franka', m, n_out, n_ref,
                               solver.newton_solve(m, *n_in[:5], _next_ulp(
                                   n_in[5]), n_in[6]), n_in[:5], None,
                               n_in[5], exact=solver.newton_solve(
                                   m, *f64(n_in))))
  _check_repeat('B4 franka', lambda: kn.newton_solve(m, *n_in))
  de = _reach_state(me, FRANKA_CHECK, C, torch.Generator(
      device='cuda').manual_seed(SEED))
  _, _, ce_out, ge_in = _glue_inputs(me, de, C)
  cone = solver.cone_inputs(me, mt.Contact(
      **{k: ce_out[k] for k in kc.CONTACT_FIELDS}))
  if cone is None:
    raise RuntimeError('franka elliptic: no cone')
  ge_out = kg.glue(me, *ge_in, cone=cone)
  ge_ref = forward.glue(me, *ge_in, cone=cone)
  ge_ulp = forward.glue(me, *ge_in[:8], _next_ulp(ge_in[8]), ge_in[9],
                        cone=cone)
  _check_ell_solve('B3e mode 2 franka', me, ge_out, ge_ref, ge_ulp,
                   ge_in[:5], cone, ge_out['qfrc_smooth'], resolve=True,
                   exact=forward.glue(me, *f64(ge_in), cone=f64(cone)))
  h = float(me.opt.timestep)
  qvel = ge_in[6] + h * ge_out['qacc_euler']
  _compare('B3e mode 2 franka advance', ge_out, dict(
      qvel=qvel, qpos=forward.integrate_pos(me, ge_in[5], qvel, h)),
           dict(qvel=TOL_B3_OTHER, qpos=TOL_B3['qpos']), ['qvel', 'qpos'])
  _check_repeat('B3e mode 2 franka', lambda: kg.glue(me, *ge_in, cone=cone))

  # ---- P14: the suite's franka step, replayed ----
  d = mt.make_batch(m, d0, W, qpos_noise=QPOS_NOISE, generator=gen)
  (_, res), on_card = _replayed_counts(
      'P14', lambda: bench.benchmark(m, d, nstep=_bench_nstep(COUNT_STEPS)),
      COUNT_STEPS)
  if res['dispatch'] != 'graph':
    raise RuntimeError(f'P14 ran {res["dispatch"]}')
  _expect_no_entries('P14')
  _expect_counts('P14, on the card', dict(
      _zero_counts(), smooth=COUNT_STEPS, contact=COUNT_STEPS,
      glue=COUNT_STEPS), on_card)
  _reset_counts()
  d14, res = bench.benchmark(m, d, nstep=NSTEP)
  if res['dispatch'] != 'graph':
    raise RuntimeError(f'P14 ran {res["dispatch"]}')
  for k in ('qpos', 'qvel', 'qacc', 'efc_force'):
    if not bool(torch.isfinite(getattr(d14, k)).all()):
      raise RuntimeError(f'P14: non-finite {k}')
  print(f'P14: {res["steps_per_sec"]:.1f} steps/s, '
        f'{res["step_time_us"]:.1f} us/step over {res["nstep"]} timed of '
        f'{bench.total_steps(NSTEP)} steps at {W} worlds, nconmax {C}; '
        f'final ncon mean {res["ncon_mean"]:.3f}, nefc mean '
        f'{res["nefc_mean"]:.2f}, solver_niter mean '
        f'{res["solver_niter_mean"]:.2f} max {res["solver_niter_max"]}; '
        f'{res["converged_worlds"]} worlds without NaN; dispatch '
        f'{res["dispatch"]} ({card})')
  print(json.dumps({'step_franka': dict(res, card=card)}))
  _compare_step('P14 step', m, d14, TOL_STEP_QACC, ('qacc', 'qvel'),
                spread=True)
  _replay_against_eager('P14', m, d14, dict(smooth=1, contact=1, glue=1),
                        PROFILE_STEPS, card)
  _replay_after_flip('P14', m, d14)
  # the same path from the reach state, where the contacts fire
  reach = _reach_state(m, W, C, gen)
  dr, _, _, counts_r = _run_path('step_franka_reach', m, reach, COUNT_STEPS,
                                 card)
  _expect_counts('P14 reach, on the card', dict(
      _zero_counts(), smooth=COUNT_STEPS, contact=COUNT_STEPS,
      glue=COUNT_STEPS), counts_r)
  print(f'  P14 reach: final ncon mean {float(dr.ncon.float().mean()):.3f}'
        f', ncollision mean {float(dr.ncollision.float().mean()):.2f}, '
        f'ne mean {float(dr.ne.float().mean()):.3f}')
  _compare_step('P14 reach step', m, reach, TOL_STEP_QACC, ('qacc', 'qvel'),
                spread=True)
  _replay_after_flip('P14 reach', m, reach)

  # ---- times, plain times, bounds ----
  records = []
  for name, state, launched in (('contact[franka]', d14, on_card),
                                ('contact[franka reach]', reach, counts_r)):
    _, c_in, c_out, _ = _glue_inputs(m, state, C)
    eqa = state.eq_active
    _record(records, name, launched['contact'], errs['contact'],
            'mujoco_warp_tpu_torch/csrc/contact.cu',
            'mujoco_warp_tpu/pallas/contact_kernels.py:1643',
            lambda: kc.contact(m, *c_in, C, eqa),
            lambda: kc.plain(m, *c_in, C, eqa),
            _bytes_b2(m, c_in, c_out, (eqa,)),
            _flops_b2(m, W, c_out, C))
  _, _, c_out, g_in = _glue_inputs(m, d14, C)
  g_out = kg.glue(m, *g_in)
  _record(records, 'glue[franka]', on_card['glue'], errs['glue'],
          'mujoco_warp_tpu_torch/csrc/glue.cu',
          'mujoco_warp_tpu/pallas/solver_kernels.py:1207',
          lambda: kg.glue(m, *g_in), lambda: forward.glue(m, *g_in),
          *_glue_cost(m, g_in, g_out, c_out['nefc'], 'glue[franka]'))
  return records


def _apollo_rich(m, nworld, gen, nconmax=APOLLO_NCONMAX):
  """apollo's contact-rich state (see RICH_DROP) at nworld worlds, seeded
  by gen, ctrl holding qpos0's pose."""
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch.types import JointType
  dev = m.device
  rand = lambda n: torch.rand(n, generator=gen, device=dev)
  q = m.qpos0.repeat(nworld, 1)
  for j in range(m.njnt):
    if m.jnt_type[j] == JointType.HINGE:
      lo, hi = m.jnt_range[j]
      q[:, m.jnt_qposadr[j]] = lo + (hi - lo) * rand(nworld)
  q[:, 2] -= RICH_DROP
  legs = torch.arange(nworld, device=dev) % 2 == 0
  for j, lo, hi in RICH_LEGS:
    adr = m.jnt_qposadr[j]
    q[:, adr] = torch.where(legs, lo + (hi - lo) * rand(nworld), q[:, adr])
  qvel = RICH_QVEL * torch.randn((nworld, m.nv), generator=gen, device=dev)
  d = mt.make_data(m, nconmax=nconmax, nworld=nworld)
  return d.replace(qpos=q, qvel=qvel,
                   ctrl=m.qpos0[7:].repeat(nworld, 1).contiguous())


def _pair_counts(m, con) -> dict:
  """Active contacts (dist below includemargin) of each geom-type pair in
  a pool (kc.plain's outputs), by the pair's type names."""
  import torch
  from mujoco_warp_tpu_torch.types import GeomType
  geom = con['geom'].long()
  active = (geom[..., 0] >= 0) & (con['dist'] < con['includemargin'])
  gtype = torch.tensor(m.geom_type, device=geom.device)
  t1, t2 = gtype[geom[..., 0].clamp(min=0)], gtype[geom[..., 1].clamp(min=0)]
  out = {}
  for a, b in [g[:2] for g in m.collision_pairs + m.sap_families]:
    name = f'{GeomType(a).name.lower()}-{GeomType(b).name.lower()}'
    out[name] = int((active & (t1 == a) & (t2 == b)).sum())
  return out


def _hold_b3_apollo(label, m, g_in, rows) -> float:
  """B3 in mode 0 on apollo's robot (apollo_flat, apollo_terrain) on the
  inputs g_in, whose rows (`nf`, `nl`, `ncon`) hold the 19 friction-loss
  rows in every world: by phase (c)'s rules, or where the lottery shows
  by the counts rule, its objective against the float64 solve's (see
  RICH_LEGS); two launches bit-equal. Returns the largest error."""
  from mujoco_warp_tpu_torch import forward
  from mujoco_warp_tpu_torch.kernels import glue as kg
  keys = [k for k in kg.OUTPUTS if k != 'solver_niter']
  tol3 = {k: TOL_B3.get(k, TOL_B3_OTHER) for k in keys}
  g_ref = forward.glue(m, *g_in)
  g_out = kg.glue(m, *g_in)
  print(f'  {label}: {int((rows["nf"] == 19).sum())} worlds with the 19 '
        f'friction-loss rows, acting limits mean '
        f'{float(rows["nl"].float().mean()):.2f}, contacts mean '
        f'{float(rows["ncon"].float().mean()):.2f}')
  if not bool((rows['nf'] == 19).all()):
    raise RuntimeError(f'{label}: a world without its friction-loss rows')

  def counts_rule():
    _, up, down, exact = _ell_refs(m, g_in)
    return _check_ell_solve(label, m, g_out, g_ref, up, g_in[:5], None,
                            g_out['qfrc_smooth'], exact=exact,
                            exact_noise=[down])
  err = _hold_or_count(
      label, lambda: _hold_solve(label, m, g_out, g_ref, tol3,
                                 g_in[:5] + (g_ref['qfrc_smooth'],)),
      counts_rule)
  _check_repeat(label, lambda: kg.glue(m, *g_in))
  return err


def _apollo(card) -> list:
  """Phase (s) on apptronik_apollo_flat: B2's capsule-box and box-box
  branches (entry `box_`) against the plain rows on P15's state and on
  the contact-rich state, at APOLLO_NCONMAX and APOLLO_NCONMAX_WIDE; B3
  in mode 0 on both states with apollo's 19 friction-loss rows; P15 (the
  glue step with the four IMU sensors and rne_postconstraint, the
  advance after sensor_acc) counted, timed, replayed against eager steps
  (sensordata too) and one step against the all-plain step; returns the
  records of B2 on both states and of B3."""
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import forward, models
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  m = mt.load_model(models.APOLLO_NPZ, device='cuda')
  W, C = APOLLO_NWORLD, APOLLO_NCONMAX
  d0 = mt.make_data(m, nconmax=C)
  names = [n for n, _ in forward.batched_stages(m, d0)]
  print(f'model: apptronik_apollo_flat nq={m.nq} nv={m.nv} '
        f'nbody={m.nbody} ngeom={m.ngeom} nu={m.nu} nsensor={m.nsensor} '
        f'pairs {[(t1, t2, len(gl)) for t1, t2, gl in m.collision_pairs]} '
        f'candidates={m.nxn_candidates}; efc layout (ne, nf, nl, stride, '
        f'njmax) {mt.efc_layout(m, C)} at nconmax {C}; glue mode '
        f'{forward.glue_mode(m)}; B2 entry {kc.entry(m)!r}; stages: '
        f'{" -> ".join(names)}')
  if names != ['smooth_mega[cuda]', 'camlight', 'contact_efc_mega[cuda]',
               'act_len_vel', 'sensor_pos', 'sensor_vel',
               'solve_glue[cuda]', 'sensor_acc', 'advance'] or \
      forward.glue_mode(m) != 0 or not forward.replays(m, d0) or \
      kc.entry(m) != 'box_':
    raise RuntimeError('apollo does not take the glue list with sensors '
                       'in mode 0, or B2\'s box_ entry')
  gen = torch.Generator(device='cuda').manual_seed(SEED)
  d15 = mt.make_batch(m, d0, W, qpos_noise=QPOS_NOISE, generator=gen)
  standing = bench.rollout(m, d15, APOLLO_PREP)
  rich = _apollo_rich(m, W, gen)

  # ---- B2 on both states, two pool sizes ----
  errs = {}
  for tag, state in (('', standing), (' rich', rich)):
    for nconmax in (C, APOLLO_NCONMAX_WIDE):
      label = f'B2 apollo{tag}, nconmax {nconmax}'
      _, c_in, c_out, _ = _glue_inputs(m, state, nconmax)
      c_ref = kc.plain(m, *c_in, nconmax, state.eq_active)
      err = _check_contact(label, m, c_in, c_out, c_ref)
      errs['contact'] = max(errs.get('contact', 0.0), err)
      _check_repeat(label, lambda: kc.contact(m, *c_in, nconmax,
                                              state.eq_active))
      ncol = c_ref['ncollision']
      counts = _pair_counts(m, c_ref)
      print(f'  {label}: active contacts by pair type {counts}; '
            f'ncollision mean {float(ncol.float().mean()):.2f} max '
            f'{int(ncol.max())}, worlds past nconmax '
            f'{int((ncol > nconmax).sum())}; nf {int(c_ref["nf"][0])}, nl '
            f'mean {float(c_ref["nl"].float().mean()):.2f}')
      if tag and nconmax == APOLLO_NCONMAX_WIDE and (
          not counts['capsule-box'] or not counts['box-box']):
        raise RuntimeError(f'{label}: no capsule-box or no box-box '
                           f'contact in the contact-rich state')
  _print_warp_shapes('apollo', ('contact_box_kernel',), W)

  # ---- B3 in mode 0 on both states ----
  for tag, state in (('', standing), (' rich', rich)):
    label = f'B3 apollo{tag}'
    _, _, c_out, g_in = _glue_inputs(m, state, C)
    errs['glue'] = max(errs.get('glue', 0.0), _hold_b3_apollo(
        label, m, g_in, c_out))

  # ---- P15: the suite's apollo step, replayed ----
  (_, res), on_card = _replayed_counts(
      'P15', lambda: bench.benchmark(m, d15, nstep=_bench_nstep(COUNT_STEPS)),
      COUNT_STEPS)
  if res['dispatch'] != 'graph':
    raise RuntimeError(f'P15 ran {res["dispatch"]}')
  _expect_no_entries('P15')
  _expect_counts('P15, on the card', dict(
      _zero_counts(), smooth=COUNT_STEPS, contact=COUNT_STEPS,
      glue=COUNT_STEPS), on_card)
  _reset_counts()
  d, res = bench.benchmark(m, d15, nstep=NSTEP)
  if res['dispatch'] != 'graph':
    raise RuntimeError(f'P15 ran {res["dispatch"]}')
  for k in ('qpos', 'qvel', 'qacc', 'efc_force', 'sensordata'):
    if not bool(torch.isfinite(getattr(d, k)).all()):
      raise RuntimeError(f'P15: non-finite {k}')
  quat = d.sensordata[:, :4].norm(dim=1)
  print(f'P15: {res["steps_per_sec"]:.1f} steps/s, '
        f'{res["step_time_us"]:.1f} us/step over {res["nstep"]} timed of '
        f'{bench.total_steps(NSTEP)} steps at {W} worlds, nconmax {C}; '
        f'final ncon mean {res["ncon_mean"]:.3f}, nefc mean '
        f'{res["nefc_mean"]:.2f}, solver_niter mean '
        f'{res["solver_niter_mean"]:.2f} max {res["solver_niter_max"]}; '
        f'{res["converged_worlds"]} worlds without NaN; framequat norm in '
        f'[{float(quat.min()):.6f}, {float(quat.max()):.6f}], '
        f'accelerometer z mean {float(d.sensordata[:, 9].mean()):.3f}; '
        f'dispatch {res["dispatch"]} ({card})')
  print(json.dumps({'step_apollo': dict(res, card=card)}))
  _compare_step('P15 step', m, d, TOL_STEP_QACC, ('qacc', 'qvel'),
                spread=True, exact=True)
  _replay_against_eager('P15', m, d, dict(smooth=1, contact=1, glue=1),
                        PROFILE_STEPS, card)

  # ---- times, plain times, bounds ----
  records = []
  for name, state in (('contact[apollo]', d), ('contact[apollo rich]',
                                               rich)):
    _, c_in, c_out, _ = _glue_inputs(m, state, C)
    _record(records, name, on_card['contact'], errs['contact'],
            'mujoco_warp_tpu_torch/csrc/contact.cu',
            'mujoco_warp_tpu/pallas/contact_kernels.py:1643',
            lambda: kc.contact(m, *c_in, C),
            lambda: kc.plain(m, *c_in, C),
            _bytes_b2(m, c_in, c_out), _flops_b2(m, W, c_out, C))
  _, _, c_out, g_in = _glue_inputs(m, d, C)
  g_out = kg.glue(m, *g_in)
  _record(records, 'glue[apollo]', on_card['glue'], errs['glue'],
          'mujoco_warp_tpu_torch/csrc/glue.cu',
          'mujoco_warp_tpu/pallas/solver_kernels.py:1207',
          lambda: kg.glue(m, *g_in), lambda: forward.glue(m, *g_in),
          *_glue_cost(m, g_in, g_out, c_out['nefc'], 'glue[apollo]'))
  return records


def _collision_glue_inputs(m, d, nconmax):
  """B1's outputs, the torch collision stage's pool, its rows and B3's
  inputs on the state d, as the glue list of a model that B2 cannot take
  computes them (`collision`: the large-scene broadphase or the static
  driver; `make_constraint`)."""
  from mujoco_warp_tpu_torch import (collision_driver, collision_sap,
                                     constraint, support)
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  sm = ks.smooth(m, d.qpos, d.qvel)
  collide = (collision_sap.collision if m.sap_families else
             collision_driver.collision)
  con = collide(m, sm['geom_xpos'], sm['geom_xmat'], nconmax)
  efc = constraint.make_constraint(m, sm['qpos'], d.qvel, sm['cdof'],
                                   sm['subtree_com'], con, d.eq_active)
  qfx = d.qfrc_applied + support.xfrc_accumulate(
      m, d.xfrc_applied, sm['xipos'], sm['subtree_com'], sm['cdof']) - \
      sm['qfrc_bias']
  g_in = (sm['qM'], efc['J'], efc['D'], efc['aref'], efc['frictionloss'],
          sm['qpos'], d.qvel, d.ctrl, qfx, d.qacc_warmstart)
  return sm, con, efc, g_in


def _cone(m, con, efc):
  """The elliptic cone's inputs (`solver.cone_inputs`) of a pool and its
  rows (`_collision_glue_inputs`)."""
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import solver
  from mujoco_warp_tpu_torch.types import CONTACT_TENSORS
  return solver.cone_inputs(m, mt.Contact(
      **{k: con[k] for k in CONTACT_TENSORS if k != 'efc_address'},
      efc_address=efc['efc_address']))


def _aloha_state(m, d0, nworld, gen, nstep=ALOHA_PREP):
  """P17's state: d0 (keyframe lift_pot0) at nworld worlds with
  QPOS_NOISE drawn from gen on the arms (the pot where the keyframe puts
  it, on the table), stepped nstep (ALOHA_PREP) steps; on aloha_sdf, the
  rich state of phase (v) from keyframe gripper_gripper_pot (the cow
  between the fingers) and SDF_PREP steps."""
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch.types import JointType
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  d = mt.make_batch(m, d0, nworld, qpos_noise=QPOS_NOISE, generator=gen)
  for j in range(m.njnt):
    if m.jnt_type[j] == JointType.FREE:
      a = m.jnt_qposadr[j]
      d.qpos[:, a:a + 7] = d0.qpos[:, a:a + 7]
  return bench.rollout(m, d, nstep)


def _family_overlaps(m, geom_xpos, geom_xmat, nconmax) -> list:
  """Per SAP family of m: (type1, type2, pairs, slots a step keeps, (W,)
  overlapping pairs of each world) at these geom frames. Each culled
  family's running top-K over all W worlds, in the main path's chunks,
  is held on CULL_HOLD_WORLDS worlds spread over the batch against one
  stable descending sort of the family's whole slack (ties to the lower
  pair): the kept pairs and their order, which overlap, and the
  overlap counts, exactly."""
  import torch
  from mujoco_warp_tpu_torch import collision_sap
  cw, hw = collision_sap.world_aabbs(m, geom_xpos, geom_xmat)
  W = cw.shape[0]
  ws = torch.arange(0, W, max(1, W // CULL_HOLD_WORLDS), device=cw.device)
  out = []
  for t1, t2, start, count in m.sap_families:
    g1, g2 = (m.sap_pairs[start:start + count, k].long() for k in (0, 1))
    kk = collision_sap.family_slots(count, nconmax)
    if kk < count:
      sel, valid, nover = collision_sap.cull(cw, hw, g1, g2, kk)
      sl = collision_sap.slack(cw[ws], hw[ws], g1, g2)
      ref = torch.sort(torch.where(sl >= 0, sl, float('-inf')), dim=1,
                       descending=True, stable=True).indices[:, :kk]
      chunk = max(kk, collision_sap.CHUNK_ELEMENTS // W)
      bad = dict(sel=int((sel[ws] != ref).sum()),
                 valid=int((valid[ws] != (sl.gather(1, ref) >= 0)).sum()),
                 noverlap=int((nover[ws] != (sl >= 0).sum(1)).sum()))
      print(f'  cull ({t1}, {t2}) over {W} worlds in {-(-count // chunk)} '
            f'chunks of {chunk} pairs, held on {len(ws)} worlds against a '
            f'stable sort: mismatches {bad}')
      if any(bad.values()):
        raise RuntimeError(f'cull ({t1}, {t2}) disagrees with the sort: '
                           f'{bad}')
    else:
      nover = (collision_sap.slack(cw, hw, g1, g2) >= 0).sum(
          1, dtype=torch.int32)
    out.append((t1, t2, count, kk, nover))
  return out


def _stage_times(label, m, d, card, reps: int = 3,
                 profile: bool = True) -> dict:
  """The card's busy time of each stage of m's step from d (eager, each
  stage on its own inputs, torch.profiler over `reps` calls; CUDA events
  where the profile shows no device work, or without `profile`, a stage
  of ~10^5 launches whose profile takes a minute to read): {stage: ms}."""
  from mujoco_warp_tpu_torch import forward
  from mujoco_warp_tpu_torch.utils.compare_trees import device_ms
  times, dd = {}, d
  for name, fn in forward.batched_stages(m, d):
    times[name] = ((profile and device_ms(lambda: fn(dd), reps)) or
                   _cuda_ms(lambda: fn(dd), reps))
    dd = fn(dd)
  total = sum(times.values())
  for name, ms in times.items():
    print(f'  {label} stage {name:20s} {ms:9.4f} ms on the card '
          f'({ms / total:.3f} of {total:.4f})')
  print(json.dumps({f'{label} stages': dict(times, card=card)}))
  return times


def _terrain(card) -> list:
  """Phase (t) on apptronik_apollo_terrain: settle from qpos0 with noise
  until the feet touch the terrain; the contacts and the SAP overlaps;
  B1 (5,290 geoms a world) and B3 against their plain versions; P16
  (the glue step with `collision` and `make_constraint` in B2's place)
  counted (B1 and B3 once a step, no B2), timed, its peak memory, one
  step against the all-plain step, 20 replayed steps against eager ones
  (sensordata too) and the card's time of each stage; returns the records
  of B1 and B3 on terrain."""
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import forward, models, smooth
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  from mujoco_warp_tpu_torch.types import GeomType
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  m = mt.load_model(models.APOLLO_TERRAIN_NPZ, device='cuda')
  W, C = TERRAIN_NWORLD, TERRAIN_NCONMAX
  d0 = mt.make_data(m, nconmax=C)
  names = [n for n, _ in forward.batched_stages(m, d0)]
  fams = [(GeomType(a).name.lower(), GeomType(b).name.lower(), n)
          for a, b, _, n in m.sap_families]
  print(f'model: apptronik_apollo_terrain nv={m.nv} nbody={m.nbody} '
        f'ngeom={m.ngeom} nsensor={m.nsensor}; SAP families {fams}, '
        f'{m.nxn_candidates} admissible pairs; efc layout (ne, nf, nl, '
        f'stride, njmax) {mt.efc_layout(m, C)} at nconmax {C}; stages: '
        f'{" -> ".join(names)}')
  if names != ['smooth_mega[cuda]', 'camlight', 'collision',
               'make_constraint', 'act_len_vel', 'sensor_pos', 'sensor_vel',
               'solve_glue[cuda]', 'sensor_acc', 'advance'] or \
      not forward.replays(m, d0):
    raise RuntimeError('terrain does not take the glue list with the SAP '
                       'stages, or is not replayed')
  gen = torch.Generator(device='cuda').manual_seed(SEED)
  d16 = mt.make_batch(m, d0, W, qpos_noise=QPOS_NOISE, generator=gen)
  steps = 0
  while steps < TERRAIN_PREP_MAX:
    d16 = bench.rollout(m, d16, TERRAIN_PREP, start=steps)
    steps += TERRAIN_PREP
    touch = float((d16.ncon > 0).float().mean())
    if touch >= TERRAIN_TOUCH:
      break
  print(f'  terrain settled {steps} steps: worlds in contact {touch:.4f} '
        f'(need {TERRAIN_TOUCH}); ncon histogram '
        f'{d16.ncon.bincount().tolist()}, ncollision max '
        f'{int(d16.ncollision.max())}')
  if touch < TERRAIN_TOUCH:
    raise RuntimeError(f'terrain: only {touch:.4f} of the worlds touch the '
                       f'terrain after {steps} steps')
  drops = torch.zeros(W, dtype=torch.bool, device=d16.qpos.device)
  for t1, t2, count, kk, nover in _family_overlaps(
      m, d16.geom_xpos, d16.geom_xmat, C):
    drops |= nover > kk
    print(f'  terrain family ({t1}, {t2}): {count} pairs, {kk} kept a '
          f'step; overlapping pairs max {int(nover.max())} mean '
          f'{float(nover.float().mean()):.2f} over the worlds')
  print(f'  terrain: {int(drops.sum())} of {W} worlds drop overlapping '
        f'pairs at the cull')

  # ---- B1 (5,290 geoms a world) and B3 against their plain versions ----
  errs = {}
  sm_out, con, efc, g_in = _collision_glue_inputs(m, d16, C)
  sm_in = (d16.qpos, d16.qvel)
  errs['smooth'] = _compare('B1 terrain', sm_out, smooth.smooth(m, *sm_in),
                            TOL_B1, smooth.OUTPUTS)
  _check_repeat('B1 terrain', lambda: ks.smooth(m, *sm_in))
  errs['glue'] = _hold_b3_apollo('B3 terrain', m, g_in, dict(
      nf=efc['nf'], nl=efc['nl'], ncon=con['ncon']))

  # ---- P16: the suite's terrain step, replayed ----
  (_, res), on_card = _replayed_counts(
      'P16', lambda: bench.benchmark(m, d16, nstep=_bench_nstep(COUNT_STEPS)),
      COUNT_STEPS)
  if res['dispatch'] != 'graph':
    raise RuntimeError(f'P16 ran {res["dispatch"]}')
  _expect_no_entries('P16')
  _expect_counts('P16, on the card', dict(
      _zero_counts(), smooth=COUNT_STEPS, glue=COUNT_STEPS), on_card)
  _reset_counts()
  d, res = bench.benchmark(m, d16, nstep=TERRAIN_NSTEP)
  if res['dispatch'] != 'graph':
    raise RuntimeError(f'P16 ran {res["dispatch"]}')
  for k in ('qpos', 'qvel', 'qacc', 'efc_force', 'sensordata'):
    if not bool(torch.isfinite(getattr(d, k)).all()):
      raise RuntimeError(f'P16: non-finite {k}')
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  before = torch.cuda.memory_allocated()
  mt.step_batched(m, d)
  torch.cuda.synchronize()
  peak = torch.cuda.max_memory_allocated()
  print(f'P16: {res["steps_per_sec"]:.1f} steps/s, '
        f'{res["step_time_us"]:.1f} us/step over {res["nstep"]} timed of '
        f'{bench.total_steps(TERRAIN_NSTEP)} steps at {W} worlds, nconmax '
        f'{C}; final ncon mean {res["ncon_mean"]:.3f}, nefc mean '
        f'{res["nefc_mean"]:.2f}, solver_niter mean '
        f'{res["solver_niter_mean"]:.2f} max {res["solver_niter_max"]}; '
        f'{res["converged_worlds"]} worlds without NaN; one eager step\'s '
        f'peak memory {peak / 2**30:.2f} GiB ({(peak - before) / 2**30:.2f} '
        f'GiB over the {before / 2**30:.2f} GiB held before it); dispatch '
        f'{res["dispatch"]} ({card})')
  print(json.dumps({'step_terrain': dict(
      res, peak_memory_gib=peak / 2**30,
      step_memory_gib=(peak - before) / 2**30, card=card)}))
  _compare_step('P16 step', m, d, TOL_STEP_QACC, ('qacc', 'qvel'),
                spread=True, exact=True)
  _replay_against_eager('P16', m, d, dict(smooth=1, glue=1), PROFILE_STEPS,
                        card)
  _stage_times('P16', m, d, card)

  # ---- times, plain times, bounds ----
  records = []
  sm_out, con, efc, g_in = _collision_glue_inputs(m, d, C)
  sm_in = (d.qpos, d.qvel)
  _record(records, 'smooth[terrain]', on_card['smooth'], errs['smooth'],
          'mujoco_warp_tpu_torch/csrc/smooth.cu',
          'mujoco_warp_tpu/pallas/smooth_kernels.py:557',
          lambda: ks.smooth(m, *sm_in), lambda: smooth.smooth(m, *sm_in),
          _nbytes(sm_in, sm_out, _build.model_tables(m, 'smooth',
                                                     ks._tables)),
          _flops_b1(m, W))
  g_out = kg.glue(m, *g_in)
  _record(records, 'glue[terrain]', on_card['glue'], errs['glue'],
          'mujoco_warp_tpu_torch/csrc/glue.cu',
          'mujoco_warp_tpu/pallas/solver_kernels.py:1207',
          lambda: kg.glue(m, *g_in), lambda: forward.glue(m, *g_in),
          *_glue_cost(m, g_in, g_out, efc['nefc'], 'glue[terrain]'))
  return records


def _group_overlaps(m, geom_xpos, nconmax) -> list:
  """Per static group that the cull takes (`collision_driver.culls`):
  (type1, type2, pairs, pairs kept a step, (W,) overlapping pairs of each
  world) at these geom positions. Each group's cull over all W worlds, in
  the main path's chunks, is held on CULL_HOLD_WORLDS worlds spread over
  the batch against one stable descending sort of the group's whole key
  (-d^2 of the centers where the bounding spheres overlap, ties to the
  lower pair): the kept pairs and their order, which overlap, and the
  overlap counts, exactly."""
  import torch
  from mujoco_warp_tpu_torch import collision_driver
  from mujoco_warp_tpu_torch.types import GeomType
  W = geom_xpos.shape[0]
  ws = torch.arange(0, W, max(1, W // CULL_HOLD_WORLDS),
                    device=geom_xpos.device)
  params = collision_driver.candidate_params(m)
  out = []
  for (t1, t2, _), grp in zip(m.collision_pairs,
                              collision_driver._group_tables(m)):
    if not grp['cull']:
      continue
    n = grp['n']
    kk = collision_driver.cull_slots(nconmax, n)
    margin = params['margin'][grp['start']:grp['start'] + n]
    sel, valid, nover = collision_driver.cull(m, geom_xpos, grp, margin, kk)
    g1, g2 = grp['g1'], grp['g2']
    dv = geom_xpos[ws][:, g1] - geom_xpos[ws][:, g2]
    d2 = (dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1]) + \
        dv[..., 2] * dv[..., 2]
    r = (m.geom_rbound[g1] + m.geom_rbound[g2]) + margin
    over = d2 <= r * r
    key = torch.where(over, -d2, float('-inf'))
    ref = torch.sort(key, dim=1, descending=True, stable=True).indices[:, :kk]
    chunk = max(kk, collision_driver.CHUNK_ELEMENTS // W)
    bad = dict(sel=int((sel[ws] != ref).sum()),
               valid=int((valid[ws] != over.gather(1, ref)).sum()),
               noverlap=int((nover[ws] != over.sum(1)).sum()))
    names = (GeomType(t1).name.lower(), GeomType(t2).name.lower())
    print(f'  cull {names} over {W} worlds in {-(-n // chunk)} chunks of '
          f'{chunk} pairs, held on {len(ws)} worlds against a stable '
          f'sort: mismatches {bad}')
    if any(bad.values()):
      raise RuntimeError(f'cull {names} disagrees with the sort: {bad}')
    out.append(names + (n, kk, nover))
  return out


def _hold_b3e_aloha(label, m, g_in, cone, out=None,
                    factor=ALOHA_OBJ_FACTOR) -> float:
  """B3e (mode 1) on aloha_pot's inputs g_in (`out`, its outputs,
  launched here when None) by `_check_ell_solve` against the plain solve
  run in float64 on the same inputs (see ALOHA_OBJ_FACTOR): the worlds
  over the tolerances and the worlds more than TOL_OBJ units above the
  float64 objective each at most max(8, nworld / 1000) plus `factor`
  (ALOHA_OBJ_FACTOR; SDF_OBJ_FACTOR on aloha_sdf) times the largest such
  count of the float32 plain solve and its two 1-ulp perturbations of
  qfx; solver_niter by the `exact` rule. Returns the largest error of the
  other worlds."""
  from mujoco_warp_tpu_torch.kernels import glue as kg
  out = kg.glue(m, *g_in, cone=cone) if out is None else out
  ref, up, down, exact = _ell_refs(m, g_in, cone)
  return _check_ell_solve(label, m, out, ref, up, g_in[:5], cone,
                          out['qfrc_smooth'], resolve=True, exact=exact,
                          exact_noise=[down], factor=factor,
                          over_exact=True)


def _smooth_moved(gen):
  """B1's plain version with each floating output moved by one ulp, up
  or down at random (from gen): a change of B1's outputs of the size of
  B1's own rounding."""
  import torch
  from mujoco_warp_tpu_torch import smooth

  def moved(m, qpos, qvel):
    out = smooth.smooth(m, qpos, qvel)
    for k, v in out.items():
      if k != 'qpos' and v.is_floating_point():
        up = torch.rand(v.shape, generator=gen, device=v.device) < 0.5
        out[k] = torch.nextafter(v, torch.where(up, math.inf, -math.inf)
                                 .to(v.dtype))
    return out
  return moved


def _compare_step_exact(label, m, d, tol, keys=('qacc', 'qvel'),
                        ulps=ALOHA_QPOS_ULPS, factor=ALOHA_OBJ_FACTOR,
                        hold=None, gen=None):
  """One step of the kernels against the all-plain step on the same
  state (P17, see the note on B3e before ALOHA_NWORLD; P18, P19, P20):
  the contact and row sets as _compare_step holds them, with the
  all-plain step's spread after a change of qpos by `ulps` ulps
  (ALOHA_QPOS_ULPS, B1's own distance from its plain version on P17's
  state, see there; SDF_QPOS_ULPS on P18's) or, given a generator
  `gen` (P20, see KITCHEN_NWORLD), after B1's outputs move by one ulp
  each (`_smooth_moved`); the kernel step's solve by
  `_hold_b3e_aloha` (at `factor`) on its own inputs; and keys at tol of
  scale over the worlds whose sets agree and whose kernel and plain
  solves both end within TOL_OBJ units of the float64 solve on their own
  inputs. A world over tol is excused where each step's key lies within
  tol / 10 of the float64 solve on that step's own inputs (for qvel, the
  float64 solve advanced in float64, with the damped re-solve where the
  step re-solves): there at least four fifths of the two steps'
  difference lies in their inputs, which part only by B1's rounding
  (held here per world at TOL_B1 on the same state), as the stiff rows
  amplify it (or, on P19, as MPR's witness on a sole's flat face moves
  with it). The other worlds over tol may number at most max(8, nworld
  / 1000) plus twice the all-plain step's own over the same rule after
  that change of qpos. The solve is B3's or B3e's (the glue step) or,
  on P20, the unfused `solver.solve`'s. With `hold`, hold(label, the
  kernel step's recorded solves, the kernel step's Data) holds the
  kernel step's solve in `_hold_b3e_aloha`'s place (P19's B3, a
  pyramidal solve; P20's unfused solve)."""
  import torch
  from mujoco_warp_tpu_torch import forward, smooth, solver
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  from mujoco_warp_tpu_torch.types import DisableBit
  W = d.nworld
  _compare(f'{label} B1', ks.smooth(m, d.qpos, d.qvel),
           smooth.smooth(m, d.qpos, d.qvel), TOL_B1, smooth.OUTPUTS)
  d_k, sets_k, solves_k = _step_recording(m, d)
  q = d.qpos
  for _ in range(ulps):
    q = _next_ulp(q)
  witness = (f'qpos + {ulps} ulps' if gen is None else
             'B1\'s outputs moved by one ulp')
  with _plain_kernels():
    d_p, sets_p, solves_p = _step_recording(m, d)
    if gen is None:
      d_u, sets_u, solves_u = _step_recording(m, d.replace(qpos=q))
    else:
      plain_smooth, ks.smooth = ks.smooth, _smooth_moved(gen)
      try:
        d_u, sets_u, solves_u = _step_recording(m, d)
      finally:
        ks.smooth = plain_smooth
  same, same_u = _agree(sets_k, sets_p), _agree(sets_u, sets_p)
  allowed = max(8, W // 1000)
  nbad, extra = W - int(same.sum()), 2 * (W - int(same_u.sum()))
  print(f'  {label}: {nbad} of {W} worlds with a different contact/row set '
        f'(allowed {allowed + extra}; the spread after {witness} '
        f'{extra // 2})')
  if nbad > allowed + extra:
    raise RuntimeError(f'{label}: {nbad} worlds differ in their row sets')
  (kind, args, kw, out), = solves_k
  if hold is not None:
    hold(f'{label} solve', solves_k, d_k)
  elif kind == 'glue':
    _hold_b3e_aloha(f'{label} solve', m, args[1:], kw['cone'], out, factor)
  else:
    raise ValueError(f'{label}: a {kind} solve needs a hold')
  unit = float(m.opt.tolerance) * float(m.stat.meaninertia) * max(1, m.nv)
  f64 = lambda x: (x.double() if torch.is_tensor(x) and
                   x.is_floating_point() else
                   tuple(f64(y) for y in x) if isinstance(x, tuple) else x)
  h = m.opt.timestep
  dis = m.opt.disableflags
  damped = (m.has_damping and not dis & DisableBit.EULERDAMP and
            not dis & DisableBit.DAMPER)

  def solved(solves):
    """(whether the solve ends within TOL_OBJ units of the float64 solve
    on its inputs, the float64 solve's outputs, with qvel)."""
    (kind, a, k, o), = solves
    cone = k.get('cone')
    if kind == 'glue':
      ex = forward.glue(*[f64(x) for x in a], **(
          {} if cone is None else dict(cone=f64(cone))))
      qfs = o['qfrc_smooth']
    else:
      # the unfused solve, then `forward._euler`'s advance of qvel
      with _plain_kernels():
        ex = solver.solve(*[f64(x) for x in a],
                          **{n: f64(v) for n, v in k.items()})
      qM, qfs = a[1].double(), a[7]
      qacc = ex['qacc']
      if damped:
        qacc = torch.linalg.solve(
            qM + torch.diag(h * m.dof_damping.double()),
            qfs.double() + ex['qfrc_constraint'])
      ex = dict(ex, qvel=d.qvel.double() + h * qacc)
    obj = lambda q: _objective(m, *a[1:6], qfs, q, cone)
    return (obj(o['qacc']) - obj(ex['qacc'])) / unit <= TOL_OBJ, ex
  (good_k, x_k), (good_p, x_p), (good_u, x_u) = (
      solved(s) for s in (solves_k, solves_p, solves_u))
  held, held_u = same & good_k & good_p, same_u & good_u & good_p
  for k in keys:
    a, b, c = getattr(d_k, k), getattr(d_p, k), getattr(d_u, k)
    scale = max(1.0, float(b.abs().max()))
    off = lambda x, y: (x.double() - y[k]).abs().amax(1) / scale
    err = (a - b).abs().amax(1) / scale
    faithful = (off(a, x_k) <= tol / 10) & (off(b, x_p) <= tol / 10)
    bad = held & (err > tol)
    bad_u = held_u & ((c - b).abs().amax(1) / scale > tol)
    n, n_u = int((bad & ~faithful).sum()), int(
        (bad_u & ~((off(c, x_u) <= tol / 10) &
                   (off(b, x_p) <= tol / 10))).sum())
    fmt = lambda t: [float(f'{v:.3g}') for v in t[bad].tolist()]
    print(f'  {label} {k}: {int(bad.sum())} of {int(held.sum())} held '
          f'worlds over {tol:g} of scale {scale:.1f} (median '
          f'{float(err[held].median()):.3e}), by {fmt(err)}; each step '
          f'there against the float64 solve on its own inputs: kernel '
          f'{fmt(off(a, x_k))}, plain {fmt(off(b, x_p))}; not excused '
          f'(within {tol / 10:g} of it) {n} (allowed {allowed + 2 * n_u}; '
          f'the spread after {witness} {int(bad_u.sum())} of '
          f'{int(held_u.sum())}, not excused {n_u})')
    if n > allowed + 2 * n_u:
      raise RuntimeError(f'{label}: {k} differs from the all-plain step '
                         f'in {n} worlds')


def _group_times(label, m, d, nconmax, card, reps: int = 2) -> dict:
  """The card's time (CUDA events, eager, `reps` calls each) of each
  static group's cull and narrowphase in m's `collision` stage on the
  state d: {(type1, type2): (cull ms, narrowphase ms)}."""
  from mujoco_warp_tpu_torch import collision_driver
  from mujoco_warp_tpu_torch.types import GeomType
  params = collision_driver.candidate_params(m)
  gx, gm = d.geom_xpos, d.geom_xmat
  out = {}
  for (t1, t2, _), grp in zip(m.collision_pairs,
                              collision_driver._group_tables(m)):
    n = grp['n']
    margin = params['margin'][grp['start']:grp['start'] + n]
    cull_ms, sel = 0.0, None
    if grp['cull']:
      kk = collision_driver.cull_slots(nconmax, n)
      cull_ms = _cuda_ms(lambda: collision_driver.cull(m, gx, grp, margin,
                                                       kk), reps)
      sel = collision_driver.cull(m, gx, grp, margin, kk)[0]
    mg = margin if sel is None else margin[sel]
    ms = _cuda_ms(lambda: collision_driver.narrowphase(m, grp, gx, gm, mg,
                                                       sel), reps)
    names = (GeomType(t1).name.lower(), GeomType(t2).name.lower())
    out[f'{names[0]}-{names[1]}'] = (cull_ms, ms)
    print(f'  {label} group {names}: {n} pairs, cull {cull_ms:.3f} ms, '
          f'narrowphase {ms:.3f} ms on the card ({card})')
  return out


def _peak_step(m, d, one_step=None):
  """(peak, before) bytes of device memory over one eager step from d."""
  import torch
  import mujoco_warp_tpu_torch as mt
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  before = torch.cuda.memory_allocated()
  mt.step_batched(m, d) if one_step is None else one_step()
  torch.cuda.synchronize()
  return torch.cuda.max_memory_allocated(), before


def _aloha(card) -> list:
  """Phase (u) on aloha_pot: from keyframe lift_pot0 with noise, settled;
  the contacts and each culled group's overlaps (the cull held against a
  sort); B1 against its plain version and B3e (mode 1, the elliptic
  cone) against the float64 plain solve on P17's inputs; P17 (the glue
  step with the static driver's `collision` and `make_constraint` in
  B2's place) counted (B1 and B3e once a step, no B2), timed, its peak
  memory, one step against the all-plain step, 20 replayed steps against
  eager ones, the card's time of each stage; the lift_pot replay (the 8
  keyframes' ctrl from lift_pot0, as testspeed --replay runs it)
  counted as P17, timed, profiled, its stages, memory and contacts;
  returns the records of B1 and B3e on aloha_pot."""
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import forward, io, models, smooth
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  from mujoco_warp_tpu_torch.types import GeomType
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  t0 = time.perf_counter()
  so_far = lambda part: print(f'  phase (u) {part} done at '
                              f'{time.perf_counter() - t0:.1f} s')
  m = mt.load_model(models.ALOHA_POT_NPZ, device='cuda')
  W, C = ALOHA_NWORLD, ALOHA_NCONMAX
  keys = io.find_keys(m, 'lift_pot')
  d0 = io.reset_data(m, mt.make_data(m, nconmax=C), keyframe=keys[0])
  names = [n for n, _ in forward.batched_stages(m, d0)]
  groups = [(GeomType(a).name.lower(), GeomType(b).name.lower(), len(gl))
            for a, b, gl in m.collision_pairs]
  print(f'model: aloha_pot nv={m.nv} nbody={m.nbody} ngeom={m.ngeom} '
        f'hulls {tuple(m.mesh_hullvert.shape)} (decimated '
        f'{tuple(m.mesh_hullvert_small.shape)}); groups {groups}; '
        f'{m.nxn_candidates} candidate slots; efc layout (ne, nf, nl, '
        f'stride, njmax) {mt.efc_layout(m, C)} at nconmax {C}; glue mode '
        f'{forward.glue_mode(m)}; keyframes {list(keys)} of '
        f'{m.key_names}; stages: {" -> ".join(names)}')
  if names != ['smooth_mega[cuda]', 'camlight', 'collision',
               'make_constraint', 'act_len_vel', 'solve_glue[cuda]'] or \
      not forward.replays(m, d0):
    raise RuntimeError('aloha_pot does not take the glue list with the '
                       'static collision stage, or is not replayed')
  d = _aloha_state(m, d0, W, torch.Generator(device='cuda').manual_seed(
      SEED))

  def contacts(label, dd):
    live = dd.contact.dist < 1e9
    dims = dd.contact.dim[live].bincount(minlength=5).tolist()
    print(f'  {label}: ncon per world mean {float(dd.ncon.float().mean()):.3f}'
          f' max {int(dd.ncon.max())}, histogram {dd.ncon.bincount().tolist()}'
          f'; ncollision per world mean '
          f'{float(dd.ncollision.float().mean()):.2f} max '
          f'{int(dd.ncollision.max())}; contacts by condim {dims}')
  contacts(f'aloha_pot after {ALOHA_PREP} steps', d)
  drops = torch.zeros(W, dtype=torch.bool, device=d.qpos.device)
  for t1, t2, n, kk, nover in _group_overlaps(m, d.geom_xpos, C):
    drops |= nover > kk
    print(f'  aloha_pot group ({t1}, {t2}): {n} pairs, {kk} kept a step; '
          f'overlapping pairs max {int(nover.max())} mean '
          f'{float(nover.float().mean()):.2f} over the worlds')
  print(f'  aloha_pot: {int(drops.sum())} of {W} worlds drop overlapping '
        f'pairs at the cull')

  # ---- B1 and B3e against their plain versions on P17's inputs ----
  errs = {}
  sm_in = (d.qpos, d.qvel)
  sm_out = ks.smooth(m, *sm_in)
  errs['smooth'] = _compare('B1 aloha_pot', sm_out, smooth.smooth(m, *sm_in),
                            TOL_B1, smooth.OUTPUTS)
  _check_repeat('B1 aloha_pot', lambda: ks.smooth(m, *sm_in))
  h = float(m.opt.timestep)
  label = 'B3e aloha_pot'
  _, con, efc, g_in = _collision_glue_inputs(m, d, C)
  cone = _cone(m, con, efc)
  act = efc['active']
  ne, nf, nl, S, _ = mt.efc_layout(m, C)
  live = con['dist'] < 1e9
  # the torsional row (row 3 of a condim-4 contact) of each such contact
  tors = efc['J'][:, ne + nf + nl:].reshape(W, C, S, m.nv)[..., 3, :]
  tors = tors.abs().amax(-1)[live & (con['dim'] == 4)]
  print(f'  {label}: active rows a world: equality '
        f'{float(act[:, :ne].sum(1).float().mean()):.2f}, friction loss '
        f'{float(act[:, ne:ne + nf].sum(1).float().mean()):.2f}, limits '
        f'{float(act[:, ne + nf:ne + nf + nl].sum(1).float().mean()):.2f}'
        f', contacts by condim '
        f'{con["dim"][live].bincount(minlength=5).tolist()}; condim-4 '
        f'contacts with a nonzero torsional J row {int((tors > 0).sum())} '
        f'of {tors.numel()} (a gripper\'s fingers, on slide joints)')
  if not bool((con['dim'][live] == 4).any()):
    raise RuntimeError(f'{label}: no condim-4 contact')
  g_out = kg.glue(m, *g_in, cone=cone)
  errs['glue_ell'] = _hold_b3e_aloha(label, m, g_in, cone, g_out)
  qvel = g_in[6] + h * g_out['qacc_euler']
  _compare(f'{label} advance', g_out, dict(
      qvel=qvel, qpos=forward.integrate_pos(m, g_in[5], qvel, h)),
           dict(qvel=TOL_B3_OTHER, qpos=TOL_B3['qpos']), ['qvel', 'qpos'])
  _check_repeat(label, lambda: kg.glue(m, *g_in, cone=cone))
  so_far('state, culls, B1 and B3e')

  # ---- P17: the suite's aloha_pot step, replayed ----
  (_, res), on_card = _replayed_counts(
      'P17', lambda: bench.benchmark(m, d, nstep=_bench_nstep(ALOHA_COUNT)),
      ALOHA_COUNT)
  if res['dispatch'] != 'graph':
    raise RuntimeError(f'P17 ran {res["dispatch"]}')
  _expect_no_entries('P17')
  _expect_counts('P17, on the card', dict(
      _zero_counts(), smooth=ALOHA_COUNT, glue_ell=ALOHA_COUNT), on_card)
  _reset_counts()
  d17, res = bench.benchmark(m, d, nstep=ALOHA_NSTEP)
  if res['dispatch'] != 'graph':
    raise RuntimeError(f'P17 ran {res["dispatch"]}')
  for k in ('qpos', 'qvel', 'qacc', 'efc_force'):
    if not bool(torch.isfinite(getattr(d17, k)).all()):
      raise RuntimeError(f'P17: non-finite {k}')
  peak, before = _peak_step(m, d17)
  print(f'P17: {res["steps_per_sec"]:.1f} steps/s, '
        f'{res["step_time_us"]:.1f} us/step over {res["nstep"]} timed of '
        f'{bench.total_steps(ALOHA_NSTEP)} steps at {W} worlds, nconmax '
        f'{C}; final ncon mean {res["ncon_mean"]:.3f}, nefc mean '
        f'{res["nefc_mean"]:.2f}, solver_niter mean '
        f'{res["solver_niter_mean"]:.2f} max {res["solver_niter_max"]}; '
        f'{res["converged_worlds"]} worlds without NaN; one eager step\'s '
        f'peak memory {peak / 2**30:.2f} GiB ({(peak - before) / 2**30:.2f} '
        f'GiB over the {before / 2**30:.2f} GiB held before it); dispatch '
        f'{res["dispatch"]} ({card})')
  print(json.dumps({'step_aloha_pot': dict(
      res, peak_memory_gib=peak / 2**30,
      step_memory_gib=(peak - before) / 2**30, card=card)}))
  contacts('P17 final state', d17)
  so_far('P17 counted and timed')
  _compare_step_exact('P17 step', m, d17, TOL_STEP_QACC)
  so_far('P17 against the all-plain step')
  _replay_against_eager('P17', m, d17, dict(smooth=1, glue_ell=1),
                        ALOHA_PROFILE, card, n=ALOHA_REPLAY)
  so_far('P17 replayed against eager steps')
  _stage_times('P17', m, d17, card)
  print(json.dumps({'P17 groups ms (cull, narrowphase)': _group_times(
      'P17', m, d17, C, card), 'card': card}))
  so_far('P17 stage and group times')

  # ---- the lift_pot replay, as testspeed --replay lift_pot runs it ----
  # counted on the card as P17 is, then timed
  traj = torch.as_tensor(io.make_trajectory(m, keys), device='cuda')
  batch = mt.make_batch(m, d0, W)
  _, on_card_r = _replayed_counts('lift_pot replay', lambda: (
      bench.benchmark_replay(m, batch, traj, nstep=_bench_nstep(
          ALOHA_COUNT))), ALOHA_COUNT)
  _expect_no_entries('lift_pot replay')
  _expect_counts('lift_pot replay, on the card', dict(
      _zero_counts(), smooth=ALOHA_COUNT, glue_ell=ALOHA_COUNT), on_card_r)
  _reset_counts()
  dr, rres = bench.benchmark_replay(m, batch, traj, nstep=ALOHA_REPLAY_NSTEP)
  _expect_counts('lift_pot replay: wrapper calls (the first step and the '
                 'capture)', dict(_zero_counts(), smooth=2, glue_ell=2))
  if rres['dispatch'] != 'graph' or rres['converged_worlds'] != W:
    raise RuntimeError(f'lift_pot replay: {rres}')
  one_step = bench.replay_step(m, W, traj)
  step = torch.full((), bench.total_steps(ALOHA_REPLAY_NSTEP),
                    dtype=torch.int32, device='cuda')
  peak, before = _peak_step(m, dr, lambda: one_step(dr, step))
  print(f'lift_pot replay: {rres["steps_per_sec"]:.1f} steps/s, '
        f'{rres["step_time_us"]:.1f} us/step over {rres["nstep"]} timed of '
        f'{bench.total_steps(ALOHA_REPLAY_NSTEP)} steps at {W} worlds, the '
        f'ctrl of keyframes {list(keys)}; solver_niter mean '
        f'{rres["solver_niter_mean"]:.2f}; one eager step\'s peak memory '
        f'{peak / 2**30:.2f} GiB ({(peak - before) / 2**30:.2f} GiB over the '
        f'{before / 2**30:.2f} GiB held before it) ({card})')
  contacts('lift_pot replay final state', dr)
  # where the replayed step's device time goes: busy share, launches
  bench.warm_step(one_step, dr, step)
  graph = bench.GraphStep(one_step, dr, step)

  def run():
    for _ in range(ALOHA_PROFILE):
      graph.replay()
  _print_profile('lift_pot replayed', run, ALOHA_PROFILE,
                 _cuda_ms(run, 1) / ALOHA_PROFILE, card, W)
  stages = _stage_times('lift_pot', m, dr, card)
  print(json.dumps({'lift_pot_replay': dict(
      rres, peak_memory_gib=peak / 2**30,
      step_memory_gib=(peak - before) / 2**30,
      ncon_max=int(dr.ncon.max()),
      ncollision_mean=float(dr.ncollision.float().mean()),
      ncollision_max=int(dr.ncollision.max()), stages_ms=stages,
      card=card)}))
  so_far('the lift_pot replay')

  # ---- times, plain times, bounds (P17's final state) ----
  records = []
  sm_in = (d17.qpos, d17.qvel)
  sm_out = ks.smooth(m, *sm_in)
  _record(records, 'smooth[aloha_pot]', on_card['smooth'], errs['smooth'],
          'mujoco_warp_tpu_torch/csrc/smooth.cu',
          'mujoco_warp_tpu/pallas/smooth_kernels.py:557',
          lambda: ks.smooth(m, *sm_in), lambda: smooth.smooth(m, *sm_in),
          _nbytes(sm_in, sm_out, _build.model_tables(m, 'smooth',
                                                     ks._tables)),
          _flops_b1(m, W))
  _, con, efc, g_in = _collision_glue_inputs(m, d17, C)
  cone = _cone(m, con, efc)
  g_out = kg.glue(m, *g_in, cone=cone)
  acting = int(((g_in[2] != 0) | (g_in[4] != 0)).sum())
  row_bytes = acting * (m.nv + 1) * 4 - _nbytes(g_in[1:2], g_in[3:4])
  _record(records, 'glue_ell[aloha_pot]', on_card['glue_ell'],
          errs['glue_ell'], 'mujoco_warp_tpu_torch/csrc/glue.cu',
          'mujoco_warp_tpu/pallas/solver_kernels.py:954',
          lambda: kg.glue(m, *g_in, cone=cone),
          lambda: forward.glue(m, *g_in, cone=cone),
          _nbytes(g_in, g_out, _build.model_tables(m, 'glue', kg._tables),
                  cone[:2]) + row_bytes,
          _flops_newton(m.nv, efc['nefc'].double(),
                        g_out['solver_niter'].double(), m.nu) +
          _flops_cone(m, cone, g_in[2], g_out['solver_niter']))
  so_far('the records')
  return records


def _hold_sdf_narrowphase(label, m, geom_xpos, geom_xmat) -> float:
  """Each SDF group's narrowphase (`collision_sdf.collide`) on the card
  in float32 against float64, on SDF_HOLD_WORLDS worlds spread over the
  batch, with a witness of each descent's own conditioning: the float64
  collider again after the float32 geom frames move by n ulps, n in
  SDF_WITNESS_ULPS, up and down, and by 1 and 4 ulps each element up or
  down at random (SDF_WITNESS_DRAWS seeded draws each). Of the descents
  whose boxes meet, those whose step-size choices agree in every pass
  give dist, pos and frame within SDF_TOL of scale (max(1, max |pos|)),
  but where the witness shows the descent amplifies rounding: each value
  over SDF_TOL lies within SDF_ULP_FACTOR times the float64 descent's
  largest move under those changes (a move without bound where a change
  alters its step choices). Those excused, with the descents whose
  choices part, may number SDF_PART_SHARE of the descents whose boxes
  meet; any other value over SDF_TOL fails. Returns the largest error of
  the descents held."""
  import torch
  from mujoco_warp_tpu_torch import collision_driver, collision_sdf
  from mujoco_warp_tpu_torch.types import GeomType
  W = geom_xpos.shape[0]
  ws = torch.arange(0, W, max(1, W // SDF_HOLD_WORLDS),
                    device=geom_xpos.device)[:SDF_HOLD_WORLDS]
  gx, gm = geom_xpos[ws], geom_xmat[ws]
  gen = torch.Generator(device=gx.device).manual_seed(SDF_WITNESS_SEED)

  def nudged(x, n, up):
    """x moved n ulps: up, down, or (up None) each element at random."""
    if up is None:
      pick = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
      return torch.where(pick, nudged(x, n, True), nudged(x, n, False))
    for _ in range(n):
      x = torch.nextafter(x, torch.full_like(x, float('inf' if up else
                                                       '-inf')))
    return x
  changes = ([(n, up) for n in SDF_WITNESS_ULPS for up in (True, False)] +
             [(n, None) for n in (1, 4) for _ in range(SDF_WITNESS_DRAWS)])
  worst = 0.0
  for (t1, t2, _), grp in zip(m.collision_pairs,
                              collision_driver._group_tables(m)):
    if grp['extra'] != 'sdf':
      continue
    g1, g2 = grp['g1'], grp['g2']
    args = (gx[:, g1], gm[:, g1], gx[:, g2], gm[:, g2])
    run = lambda sides, xs: collision_sdf.collide(
        *sides, grp['slots'], m.opt.sdf_iterations, *xs, trace=True)
    sides64 = (grp['side1'].to(torch.float64),
               grp['side2'].to(torch.float64))
    a = run((grp['side1'], grp['side2']), args)
    b = run(sides64, [x.double() for x in args])
    meet = b[0] < 1e9
    if not bool(((a[0] < 1e9) == meet).all()):
      raise RuntimeError(f'{label}: the boxes meet in one precision only')
    agree = (a[3] == b[3]).all(-1) & meet
    scale = max(1.0, float(b[1].abs().max()))

    def off(x, where):
      """(3, W, P, N): dist, pos and frame of x from b's, of scale."""
      return torch.stack([torch.where(where, (u.double() - v).abs().reshape(
          b[0].shape + (-1,)).amax(-1) / scale, 0.0)
                          for u, v in zip(x[:3], b[:3])])
    err = off(a, agree)
    moved = torch.zeros_like(err)
    for n, up in changes:
      c = run(sides64, [nudged(x, n, up).double() for x in args])
      moved = torch.maximum(moved, torch.where(
          (c[3] == b[3]).all(-1), off(c, agree), float('inf')))
    over = err > SDF_TOL
    excused = over.any(0) & (~over | (err <= SDF_ULP_FACTOR * moved)).all(0)
    bad = over.any(0) & ~excused
    held = agree & ~over.any(0)
    e = [float(torch.where(held, x, 0.0).max()) for x in err]
    worst = max(worst, *e)
    ratio = torch.where(over & excused, err / moved, 0.0)
    nmeet = int(meet.sum())
    parted = nmeet - int(agree.sum())
    names = (GeomType(t1).name.lower(), GeomType(t2).name.lower())
    share = (parted + int(excused.sum())) / max(1, nmeet)
    print(f'  {label} {names}: {grp["n"]} pairs x {grp["slots"]} descents '
          f'at {len(ws)} worlds, {nmeet} whose boxes meet; float32 against '
          f'float64: {parted} with another step-size choice in some pass; '
          f'of the others {int(over.any(0).sum())} over {SDF_TOL:g} (dist '
          f'{int(over[0].sum())}, pos {int(over[1].sum())}, frame '
          f'{int(over[2].sum())}, largest {float(err.max()):.3e}), '
          f'{int(excused.sum())} excused by the witness (largest error over '
          f'its move {float(ratio.max()):.3f}, allowed {SDF_ULP_FACTOR}), '
          f'{int(bad.sum())} not; parted and excused {share:.5f} of them '
          f'(allowed {SDF_PART_SHARE}); the {int(held.sum())} held: '
          f'largest error of scale {scale:.2f} dist {e[0]:.3e}, pos '
          f'{e[1]:.3e}, frame {e[2]:.3e}')
    if bool(bad.any()):
      raise RuntimeError(f'{label} {names}: {int(bad.sum())} float32 '
                         f'descents part from float64 past their witness')
    if share > SDF_PART_SHARE:
      raise RuntimeError(f'{label} {names}: the float32 narrowphase parts '
                         f'from float64 in {share:.5f} of the descents')
  return worst


def _aloha_sdf(card) -> list:
  """Phase (v) on aloha_sdf: the model; the rich state (keyframe
  gripper_gripper_pot with noise, settled) with its contacts by pair
  type and condim and the condim-4 contacts whose torsional J row is
  nonzero; B1 against its plain version and B3e (mode 1) against the
  float64 plain solve there; the SDF narrowphase in float32 against
  float64; P18 (the glue step with the static driver's `collision`, SDF
  groups included, and `make_constraint` in B2's place, from keyframe 0
  as the suite starts it) counted (B1 and B3e once a step, no B2),
  timed, its peak memory, one step against the all-plain step, replayed
  steps against eager ones, the card's time of each stage and group;
  returns the records of B1 and B3e on aloha_sdf."""
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import forward, io, models, smooth
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  from mujoco_warp_tpu_torch.types import GeomType
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  t0 = time.perf_counter()
  m = mt.load_model(models.ALOHA_SDF_NPZ, device='cuda')
  W, C = SDF_NWORLD, SDF_NCONMAX
  d0 = io.reset_data(m, mt.make_data(m, nconmax=C), keyframe=0)
  names = [n for n, _ in forward.batched_stages(m, d0)]
  groups = [(GeomType(a).name.lower(), GeomType(b).name.lower(), len(gl))
            for a, b, gl in m.collision_pairs]
  print(f'model: aloha_sdf nv={m.nv} nbody={m.nbody} ngeom={m.ngeom}; '
        f'groups {groups}; voxel grids {tuple(m.sdf_grids.shape)}; '
        f'{m.nxn_candidates} candidate slots; sdf_iterations '
        f'{m.opt.sdf_iterations}, sdf_initpoints {m.opt.sdf_initpoints}; '
        f'efc layout (ne, nf, nl, stride, njmax) {mt.efc_layout(m, C)} at '
        f'nconmax {C}; glue mode {forward.glue_mode(m)}; keyframes '
        f'{m.key_names}; stages: {" -> ".join(names)}')
  if names != ['smooth_mega[cuda]', 'camlight', 'collision',
               'make_constraint', 'act_len_vel', 'solve_glue[cuda]'] or \
      not forward.replays(m, d0) or forward.glue_mode(m) != 1:
    raise RuntimeError('aloha_sdf does not take the glue list (mode 1) '
                       'with the static collision stage, or is not '
                       'replayed')
  gen = torch.Generator(device='cuda').manual_seed(SEED)
  rich0 = io.reset_data(m, mt.make_data(m, nconmax=C),
                        keyframe=io.find_keys(m, 'gripper_gripper_pot')[0])
  rich = _aloha_state(m, rich0, W, gen, SDF_PREP)

  def contacts(label, dd):
    live = dd.contact.dist < 1e9
    print(f'  {label}: ncon per world mean {float(dd.ncon.float().mean()):.3f}'
          f' max {int(dd.ncon.max())}, histogram {dd.ncon.bincount().tolist()}'
          f'; ncollision per world mean '
          f'{float(dd.ncollision.float().mean()):.2f} max '
          f'{int(dd.ncollision.max())}; contacts by condim '
          f'{dd.contact.dim[live].bincount(minlength=5).tolist()}')
  contacts(f'aloha_sdf rich state after {SDF_PREP} steps', rich)

  # ---- the rich state: contacts, torsional rows, B1 and B3e ----
  errs = {}
  sm_in = (rich.qpos, rich.qvel)
  errs['smooth'] = _compare('B1 aloha_sdf', ks.smooth(m, *sm_in),
                            smooth.smooth(m, *sm_in), TOL_B1, smooth.OUTPUTS)
  _check_repeat('B1 aloha_sdf', lambda: ks.smooth(m, *sm_in))
  label = 'B3e aloha_sdf'
  _, con, efc, g_in = _collision_glue_inputs(m, rich, C)
  pairs = _pair_counts(m, con)
  cone = _cone(m, con, efc)
  act = efc['active']
  ne, nf, nl, S, _ = mt.efc_layout(m, C)
  live = con['dist'] < 1e9
  four = live & (con['dim'] == 4)
  tors = efc['J'][:, ne + nf + nl:].reshape(W, C, S, m.nv)[..., 3, :]
  tors = tors.abs().amax(-1)[four]
  ntors = int((tors > 0).sum())
  print(f'  {label}: contacts by pair type {pairs}; active rows a world: '
        f'equality {float(act[:, :ne].sum(1).float().mean()):.2f}, friction '
        f'loss {float(act[:, ne:ne + nf].sum(1).float().mean()):.2f}, limits '
        f'{float(act[:, ne + nf:ne + nf + nl].sum(1).float().mean()):.2f}, '
        f'contacts by condim {con["dim"][live].bincount(minlength=5).tolist()}'
        f'; condim-4 contacts with a nonzero torsional J row {ntors} of '
        f'{tors.numel()} (fingers on the cow, a free body), in '
        f'{int((four.sum(1) > 0).sum())} worlds')
  print(json.dumps({'aloha_sdf rich state': dict(
      pairs=pairs, torsional_rows_nonzero=ntors, condim4=tors.numel(),
      ncon_mean=float(rich.ncon.float().mean()),
      ncollision_mean=float(rich.ncollision.float().mean()), card=card)}))
  if not pairs.get('sdf-sdf') or not pairs.get('box-sdf') or not ntors:
    raise RuntimeError(f'{label}: the rich state lacks SDF-SDF or box-SDF '
                       f'contacts or a nonzero torsional row')
  g_out = kg.glue(m, *g_in, cone=cone)
  errs['glue_ell'] = _hold_b3e_aloha(label, m, g_in, cone, g_out,
                                     SDF_OBJ_FACTOR)
  h = float(m.opt.timestep)
  qvel = g_in[6] + h * g_out['qacc_euler']
  _compare(f'{label} advance', g_out, dict(
      qvel=qvel, qpos=forward.integrate_pos(m, g_in[5], qvel, h)),
           dict(qvel=TOL_B3_OTHER, qpos=TOL_B3['qpos']), ['qvel', 'qpos'])
  _check_repeat(label, lambda: kg.glue(m, *g_in, cone=cone))
  _hold_sdf_narrowphase('SDF narrowphase', m, rich.geom_xpos, rich.geom_xmat)
  rows = efc['nefc'].double()
  del con, efc, act
  print(f'  phase (v) so far {time.perf_counter() - t0:.1f} s')

  # ---- P18: the suite's aloha_sdf step from keyframe 0, replayed ----
  d = mt.make_batch(m, d0, W)
  (_, res), on_card = _replayed_counts(
      'P18', lambda: bench.benchmark(m, d, nstep=_bench_nstep(SDF_COUNT)),
      SDF_COUNT)
  if res['dispatch'] != 'graph':
    raise RuntimeError(f'P18 ran {res["dispatch"]}')
  _expect_no_entries('P18')
  _expect_counts('P18, on the card', dict(
      _zero_counts(), smooth=SDF_COUNT, glue_ell=SDF_COUNT), on_card)
  _reset_counts()
  d18, res = bench.benchmark(m, d, nstep=SDF_NSTEP)
  if res['dispatch'] != 'graph':
    raise RuntimeError(f'P18 ran {res["dispatch"]}')
  for k in ('qpos', 'qvel', 'qacc', 'efc_force'):
    if not bool(torch.isfinite(getattr(d18, k)).all()):
      raise RuntimeError(f'P18: non-finite {k}')
  peak, before = _peak_step(m, d18)
  print(f'P18: {res["steps_per_sec"]:.1f} steps/s, '
        f'{res["step_time_us"]:.1f} us/step over {res["nstep"]} timed of '
        f'{bench.total_steps(SDF_NSTEP)} steps at {W} worlds, nconmax '
        f'{C}; final ncon mean {res["ncon_mean"]:.3f}, nefc mean '
        f'{res["nefc_mean"]:.2f}, solver_niter mean '
        f'{res["solver_niter_mean"]:.2f} max {res["solver_niter_max"]}; '
        f'{res["converged_worlds"]} worlds without NaN; one eager step\'s '
        f'peak memory {peak / 2**30:.2f} GiB ({(peak - before) / 2**30:.2f} '
        f'GiB over the {before / 2**30:.2f} GiB held before it); dispatch '
        f'{res["dispatch"]} ({card})')
  print(json.dumps({'step_aloha_sdf': dict(
      res, peak_memory_gib=peak / 2**30,
      step_memory_gib=(peak - before) / 2**30, card=card)}))
  contacts('P18 final state', d18)
  print(f'  phase (v) so far {time.perf_counter() - t0:.1f} s')
  _compare_step_exact('P18 step', m, d18, TOL_STEP_QACC,
                      ulps=SDF_QPOS_ULPS, factor=SDF_OBJ_FACTOR)
  _replay_against_eager('P18', m, d18, dict(smooth=1, glue_ell=1),
                        SDF_PROFILE, card, n=SDF_REPLAY, eager_timing=False)
  _stage_times('P18', m, d18, card, reps=1, profile=False)
  print(json.dumps({'P18 groups ms (cull, narrowphase)': _group_times(
      'P18', m, d18, C, card, reps=1), 'card': card}))
  print(f'  phase (v) so far {time.perf_counter() - t0:.1f} s')

  # ---- times, plain times, bounds: the rich state, where the fingers
  # hold the cow (P18's own state has no contact after a few steps) ----
  records = []
  sm_in = (rich.qpos, rich.qvel)
  sm_out = ks.smooth(m, *sm_in)
  _record(records, 'smooth[aloha_sdf]', on_card['smooth'], errs['smooth'],
          'mujoco_warp_tpu_torch/csrc/smooth.cu',
          'mujoco_warp_tpu/pallas/smooth_kernels.py:557',
          lambda: ks.smooth(m, *sm_in), lambda: smooth.smooth(m, *sm_in),
          _nbytes(sm_in, sm_out, _build.model_tables(m, 'smooth',
                                                     ks._tables)),
          _flops_b1(m, W))
  acting = int(((g_in[2] != 0) | (g_in[4] != 0)).sum())
  row_bytes = acting * (m.nv + 1) * 4 - _nbytes(g_in[1:2], g_in[3:4])
  _record(records, 'glue_ell[aloha_sdf]', on_card['glue_ell'],
          errs['glue_ell'], 'mujoco_warp_tpu_torch/csrc/glue.cu',
          'mujoco_warp_tpu/pallas/solver_kernels.py:954',
          lambda: kg.glue(m, *g_in, cone=cone),
          lambda: forward.glue(m, *g_in, cone=cone),
          _nbytes(g_in, g_out, _build.model_tables(m, 'glue', kg._tables),
                  cone[:2]) + row_bytes,
          _flops_newton(m.nv, rows, g_out['solver_niter'].double(), m.nu) +
          _flops_cone(m, cone, g_in[2], g_out['solver_niter']))
  print(f'phase (v): {time.perf_counter() - t0:.1f} s of wall time ({card})')
  return records

def _float64_off(a, b, scale, mpr, tol):
  """A narrowphase's float32 candidates a (dist, pos, frame) against its
  float64 ones b, (W, P, k, ...): (W, P) pairs off, (W, P) errors, (W, P)
  pairs with a candidate and (W, P) pairs with another number of
  candidates. A candidate's error is the largest of |dist|, the
  normal's and the position's (with `mpr`, the position along the
  normal: MPR's witness moves along a face with rounding) over scale,
  against b's nearest candidate; a pair is off where a candidate's error
  is over tol or the two keep different numbers of candidates."""
  import torch
  live_a, live_b = a[0] < 1e9, b[0] < 1e9
  # (..., ka, kb) errors of every candidate of a against every one of b
  dd = (a[0].double()[..., :, None] - b[0][..., None, :]).abs()
  dn = (a[2][..., 0, :].double()[..., :, None, :] -
        b[2][..., 0, :][..., None, :, :]).abs().amax(-1)
  dp = a[1].double()[..., :, None, :] - b[1][..., None, :, :]
  if mpr:
    dp = (dp * b[2][..., 0, :][..., None, :, :]).sum(-1).abs()
  else:
    dp = dp.abs().amax(-1)
  err = torch.maximum(torch.maximum(dd, dn), dp / scale)
  err = torch.where(live_b[..., None, :], err, float('inf')).amin(-1)
  err = torch.where(live_a, err, 0.0).amax(-1)
  cand = live_a.any(-1) | live_b.any(-1)
  count = cand & (live_a.sum(-1) != live_b.sum(-1))
  return cand & ((err > tol) | count), err, cand, count


def _hold_hfield_narrowphase(label, m, geom_xpos, geom_xmat) -> float:
  """Each height field group's narrowphase on the card in float32 against
  the same code in float64, on HFIELD_HOLD_WORLDS worlds spread over the
  batch: per pair, each float32 candidate (dist < 1e9) against the
  pair's float64 candidate nearest to it, its error the largest of
  |dist|, the normal's and the position's (for the prisms' MPR, the
  position along the normal: the witness moves along a face with
  rounding) over scale (max(1, max |pos|)); a pair is off where a
  candidate's error is over HFIELD_TOL or the two precisions keep
  different numbers of candidates. The witness: the float64 collider
  again on the float32 frames moved by one ulp up and down, off against
  the float64 collider by the same rule. Off pairs may number the larger
  of HFIELD_SHARE of the pairs with a candidate and HFIELD_FACTOR times
  the witness's largest count (see HFIELD_NWORLD). Returns the largest
  error of the pairs held."""
  import torch
  from mujoco_warp_tpu_torch import collision_driver
  from mujoco_warp_tpu_torch.types import GeomType
  W = geom_xpos.shape[0]
  ws = torch.arange(0, W, max(1, W // HFIELD_HOLD_WORLDS),
                    device=geom_xpos.device)[:HFIELD_HOLD_WORLDS]
  gx, gm = geom_xpos[ws], geom_xmat[ws]
  m64 = m.replace(hfield_data=m.hfield_data.double(),
                  hfield_size=m.hfield_size.double(),
                  geom_size=m.geom_size.double())
  nudged = lambda x, to: torch.nextafter(x, torch.full_like(x, to))
  worst = 0.0
  for (t1, t2, _), grp in zip(m.collision_pairs,
                              collision_driver._group_tables(m)):
    if grp['extra'] != 'hfield':
      continue
    mpr = t2 not in (GeomType.SPHERE, GeomType.CAPSULE)
    b = collision_driver._hfield_narrowphase(m64, grp, gx.double(),
                                             gm.double())
    scale = max(1.0, float(b[1].abs().max()))
    off = lambda a: _float64_off(a, b, scale, mpr, HFIELD_TOL)
    o, err, cand, count = off(collision_driver._hfield_narrowphase(
        m, grp, gx, gm))
    witness = [int(off(collision_driver._hfield_narrowphase(
        m64, grp, nudged(gx, to).double(), nudged(gm, to).double()))[0].sum())
               for to in (float('inf'), float('-inf'))]
    held = cand & ~o
    e = float(torch.where(held, err, 0.0).max())
    worst = max(worst, e)
    n, ncand = int(o.sum()), int(cand.sum())
    allowed = max(HFIELD_SHARE * ncand, HFIELD_FACTOR * max(witness))
    names = (GeomType(t1).name.lower(), GeomType(t2).name.lower())
    print(f'  {label} {names}: {grp["n"]} pairs at {len(ws)} worlds, '
          f'{ncand} with a candidate ({int((b[0] < 1e9).sum())} float64 '
          f'candidates, {int((b[0] < 0).sum())} of them at dist < 0); '
          f'float32 against float64: {n} pairs off ({n / max(1, ncand):.5f}; '
          f'another number of candidates in {int(count.sum())}, largest '
          f'error {float(err.max()):.3e}); the float64 collider '
          f'after one ulp up and down: {witness} off (allowed {allowed:.1f}); '
          f'the {int(held.sum())} held: largest error of scale {scale:.2f} '
          f'{e:.3e}')
    if n > allowed:
      raise RuntimeError(f'{label} {names}: the float32 narrowphase parts '
                         f'from float64 in {n} pairs (allowed {allowed:.1f})')
  return worst


def _hfield(card) -> list:
  """Phase (w) on apptronik_apollo_hfield: the model; the contact-rich
  state (`_apollo_rich`) with its contacts by pair type; B1 against its
  plain version and B3 (mode 0) by apollo's rules there
  (`_hold_b3_apollo`); the height-field narrowphase in float32 against
  float64 (`_hold_hfield_narrowphase`); P19 (the glue step with the static
  driver's `collision`, height field groups included, and
  `make_constraint` in B2's place, from keyframe 0 as the suite starts
  it) counted (B1 and B3 once a step, no B2), timed, its peak memory,
  one step against the all-plain step, replayed steps against eager ones
  (sensordata too), the card's time of each stage and group; returns the
  records of B1 and B3 on apollo_hfield (the rich state's inputs)."""
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import forward, io, models, smooth
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  from mujoco_warp_tpu_torch.types import GeomType
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  t0 = time.perf_counter()
  m = mt.load_model(models.APOLLO_HFIELD_NPZ, device='cuda')
  W, C = HFIELD_NWORLD, HFIELD_NCONMAX
  d0 = io.reset_data(m, mt.make_data(m, nconmax=C), keyframe=0)
  names = [n for n, _ in forward.batched_stages(m, d0)]
  groups = [(GeomType(a).name.lower(), GeomType(b).name.lower(), len(gl))
            for a, b, gl in m.collision_pairs]
  print(f'model: apptronik_apollo_hfield nv={m.nv} nbody={m.nbody} '
        f'ngeom={m.ngeom} nsensor={m.nsensor}; height field '
        f'{m.hfield_nrow[0]} x {m.hfield_ncol[0]}, size '
        f'{m.hfield_size[0].tolist()}; groups {groups}; {m.nxn_candidates} '
        f'candidate slots; efc layout (ne, nf, nl, stride, njmax) '
        f'{mt.efc_layout(m, C)} at nconmax {C}; glue mode '
        f'{forward.glue_mode(m)}; stages: {" -> ".join(names)}')
  if names != ['smooth_mega[cuda]', 'camlight', 'collision',
               'make_constraint', 'act_len_vel', 'sensor_pos', 'sensor_vel',
               'solve_glue[cuda]', 'sensor_acc', 'advance'] or \
      m.sap_families or kc.supports(m, C) or forward.glue_mode(m) != 0 or \
      not forward.replays(m, d0):
    raise RuntimeError('apollo_hfield does not take the glue list (mode 0) '
                       'with the static collision stage, or is not '
                       'replayed')
  gen = torch.Generator(device='cuda').manual_seed(SEED)
  rich = _apollo_rich(m, W, gen, C)

  # ---- the rich state: contacts, B1, B3 and the narrowphase ----
  errs = {}
  sm_in = (rich.qpos, rich.qvel)
  errs['smooth'] = _compare('B1 apollo_hfield', ks.smooth(m, *sm_in),
                            smooth.smooth(m, *sm_in), TOL_B1, smooth.OUTPUTS)
  _check_repeat('B1 apollo_hfield', lambda: ks.smooth(m, *sm_in))
  _, con, efc, g_in = _collision_glue_inputs(m, rich, C)
  pairs = _pair_counts(m, con)
  print(f'  apollo_hfield rich state: contacts by pair type {pairs}; ncon '
        f'per world mean {float(con["ncon"].float().mean()):.3f} max '
        f'{int(con["ncon"].max())}; ncollision max '
        f'{int(con["ncollision"].max())}')
  print(json.dumps({'apollo_hfield rich state': dict(
      pairs=pairs, ncon_mean=float(con['ncon'].float().mean()),
      card=card)}))
  if not pairs.get('hfield-capsule') or not pairs.get('hfield-box'):
    raise RuntimeError('apollo_hfield: the rich state lacks hfield-capsule '
                       'or hfield-box contacts')
  errs['glue'] = _hold_b3_apollo('B3 apollo_hfield', m, g_in, dict(
      nf=efc['nf'], nl=efc['nl'], ncon=con['ncon']))
  sm = ks.smooth(m, *sm_in)
  _hold_hfield_narrowphase('height field narrowphase', m, sm['geom_xpos'],
                           sm['geom_xmat'])
  del sm
  del con, efc
  print(f'  phase (w) so far {time.perf_counter() - t0:.1f} s')

  # ---- P19: the suite's apollo_hfield step from keyframe 0, replayed ----
  d = mt.make_batch(m, d0, W)
  (_, res), on_card = _replayed_counts(
      'P19', lambda: bench.benchmark(m, d, nstep=_bench_nstep(HFIELD_COUNT)),
      HFIELD_COUNT)
  if res['dispatch'] != 'graph':
    raise RuntimeError(f'P19 ran {res["dispatch"]}')
  _expect_no_entries('P19')
  _expect_counts('P19, on the card', dict(
      _zero_counts(), smooth=HFIELD_COUNT, glue=HFIELD_COUNT), on_card)
  _reset_counts()
  d19, res = bench.benchmark(m, d, nstep=HFIELD_NSTEP)
  if res['dispatch'] != 'graph':
    raise RuntimeError(f'P19 ran {res["dispatch"]}')
  for k in ('qpos', 'qvel', 'qacc', 'efc_force', 'sensordata'):
    if not bool(torch.isfinite(getattr(d19, k)).all()):
      raise RuntimeError(f'P19: non-finite {k}')
  peak, before = _peak_step(m, d19)
  print(f'P19: {res["steps_per_sec"]:.1f} steps/s, '
        f'{res["step_time_us"]:.1f} us/step over {res["nstep"]} timed of '
        f'{bench.total_steps(HFIELD_NSTEP)} steps at {W} worlds, nconmax '
        f'{C}; final ncon mean {res["ncon_mean"]:.3f}, nefc mean '
        f'{res["nefc_mean"]:.2f}, solver_niter mean '
        f'{res["solver_niter_mean"]:.2f} max {res["solver_niter_max"]}; '
        f'{res["converged_worlds"]} worlds without NaN; one eager step\'s '
        f'peak memory {peak / 2**30:.2f} GiB ({(peak - before) / 2**30:.2f} '
        f'GiB over the {before / 2**30:.2f} GiB held before it); dispatch '
        f'{res["dispatch"]} ({card})')
  print(json.dumps({'step_apollo_hfield': dict(
      res, peak_memory_gib=peak / 2**30,
      step_memory_gib=(peak - before) / 2**30, card=card)}))
  final = {k: getattr(d19.contact, k) for k in ('geom', 'dist',
                                                'includemargin')}
  print(f'  P19 final state: contacts by pair type '
        f'{_pair_counts(m, final)}')
  print(f'  phase (w) so far {time.perf_counter() - t0:.1f} s')
  _compare_step_exact('P19 step', m, d19, TOL_STEP_QACC,
                      ulps=HFIELD_QPOS_ULPS, hold=lambda label, solves, dk:
                      _hold_b3_apollo(label, m, solves[0][1][1:], dict(
                          nf=dk.nf, nl=dk.nl, ncon=dk.ncon)))
  _replay_against_eager('P19', m, d19, dict(smooth=1, glue=1),
                        HFIELD_PROFILE, card, n=HFIELD_REPLAY)
  _stage_times('P19', m, d19, card)
  print(json.dumps({'P19 groups ms (cull, narrowphase)': _group_times(
      'P19', m, d19, C, card), 'card': card}))
  print(f'  phase (w) so far {time.perf_counter() - t0:.1f} s')

  # ---- times, plain times, bounds: the rich state ----
  records = []
  sm_out = ks.smooth(m, *sm_in)
  _record(records, 'smooth[apollo_hfield]', on_card['smooth'],
          errs['smooth'], 'mujoco_warp_tpu_torch/csrc/smooth.cu',
          'mujoco_warp_tpu/pallas/smooth_kernels.py:557',
          lambda: ks.smooth(m, *sm_in), lambda: smooth.smooth(m, *sm_in),
          _nbytes(sm_in, sm_out, _build.model_tables(m, 'smooth',
                                                     ks._tables)),
          _flops_b1(m, W))
  _, con, efc, g_in = _collision_glue_inputs(m, rich, C)
  g_out = kg.glue(m, *g_in)
  _record(records, 'glue[apollo_hfield]', on_card['glue'], errs['glue'],
          'mujoco_warp_tpu_torch/csrc/glue.cu',
          'mujoco_warp_tpu/pallas/solver_kernels.py:1207',
          lambda: kg.glue(m, *g_in), lambda: forward.glue(m, *g_in),
          *_glue_cost(m, g_in, g_out, efc['nefc'], 'glue[apollo_hfield]'))
  print(f'phase (w): {time.perf_counter() - t0:.1f} s of wall time ({card})')
  return records


def _kitchen_rich(m, d0, nworld, gen):
  """kitchen's rich state: d0 tiled to nworld worlds, the joints drawn
  uniformly across their ranges (doors through doors, handles and legs,
  cylinders, on boxes and on each other), qvel N(0, KITCHEN_QVEL^2)."""
  import torch
  import mujoco_warp_tpu_torch as mt
  d = mt.make_batch(m, d0, nworld)
  qpos = d.qpos.clone()
  lo, hi = m.jnt_range[:, 0], m.jnt_range[:, 1]
  adr = torch.tensor(m.jnt_qposadr, device=qpos.device)
  qpos[:, adr] = lo + (hi - lo) * torch.rand((nworld, m.njnt), generator=gen,
                                             device=qpos.device)
  qvel = KITCHEN_QVEL * torch.randn((nworld, m.nv), generator=gen,
                                    device=qpos.device)
  return d.replace(qpos=qpos, qvel=qvel)


def _kitchen_noisy(m, d, gen):
  """d with N(0, QPOS_NOISE^2) added to each joint's qpos, clipped to
  its range."""
  import torch
  adr = torch.tensor(m.jnt_qposadr, device=d.qpos.device)
  q = d.qpos.clone()
  q[:, adr] = torch.clamp(
      q[:, adr] + QPOS_NOISE * torch.randn(q[:, adr].shape, generator=gen,
                                           device=q.device),
      m.jnt_range[:, 0], m.jnt_range[:, 1])
  return d.replace(qpos=q)


def _hold_sap_narrowphase(label, m, geom_xpos, geom_xmat, nconmax) -> float:
  """Each MPR family's narrowphase of the large-scene broadphase, on the
  pairs the cull keeps, on the card in float32 against the same code in
  float64 (`_float64_off`: the point along the normal; KITCHEN_TOL), by
  P19's witness rule: the witness is the float64 collider again on the
  float32 frames moved by one ulp up and down, and off pairs may number
  the larger of the family's KITCHEN_SHARE of the pairs with a candidate
  and KITCHEN_FACTOR times the witness's largest count (see
  KITCHEN_NWORLD). A control, the float32 collider on the frames rounded
  to float16, must exceed that limit. Returns the largest error of the
  pairs held."""
  import torch
  from mujoco_warp_tpu_torch import collision_driver, collision_sap
  from mujoco_warp_tpu_torch.types import GeomType
  gx, gm = geom_xpos, geom_xmat
  m64 = m.replace(geom_size=m.geom_size.double(),
                  mesh_hullvert_small=m.mesh_hullvert_small.double())
  tables = collision_sap.sap_tables(m)
  cw, hw = collision_sap.world_aabbs(m, gx, gm)
  nudged = lambda x, to: torch.nextafter(x, torch.full_like(x, to))
  worst = 0.0
  for (t1, t2, start, count), fam in zip(m.sap_families, tables['families']):
    if fam['extra'] != 'hulls+margin':
      continue
    kk = collision_sap.family_slots(count, nconmax)
    sel, valid, _ = collision_sap.cull(cw, hw, fam['g1'], fam['g2'], kk)
    margin = tables['params']['margin'][start + sel]

    def run(mm, x, r):
      dist, pos, frame = collision_driver.narrowphase(
          mm, fam, x, r, margin.to(x.dtype), sel)
      return torch.where(valid[..., None], dist, 1e10), pos, frame
    b = run(m64, gx.double(), gm.double())
    scale = max(1.0, float(b[1].abs().max()))
    o, err, cand, nslot = _float64_off(run(m, gx, gm), b, scale, True,
                                       KITCHEN_TOL)
    # the witness: the float64 collider on the frames moved by one ulp
    # up and down, against b
    witness = [int(_float64_off(run(m64, nudged(gx, to).double(),
                                    nudged(gm, to).double()), b, scale,
                                True, KITCHEN_TOL)[0].sum())
               for to in (float('inf'), float('-inf'))]
    control = int(_float64_off(run(m, gx.half().float(), gm.half().float()),
                               b, scale, True, KITCHEN_TOL)[0].sum())
    held = cand & ~o
    e = float(torch.where(held, err, 0.0).max())
    worst = max(worst, e)
    n, ncand = int(o.sum()), int(cand.sum())
    names = (GeomType(t1).name.lower(), GeomType(t2).name.lower())
    allowed = max(KITCHEN_SHARE['-'.join(names)] * ncand,
                  KITCHEN_FACTOR * max(witness))
    big = int((cand & (err > KITCHEN_TOL)).sum())
    print(f'  {label} {names}: {kk} of {count} pairs at {gx.shape[0]} '
          f'worlds, {ncand} with a candidate ({int((b[0] < 1e9).sum())} '
          f'float64 candidates); float32 against float64: {n} pairs off '
          f'({n / max(1, ncand):.4f}: {big} over {KITCHEN_TOL:g}, another '
          f'number of contacts in {int(nslot.sum())}; errors median '
          f'{float(err[cand].median()):.3e}, largest '
          f'{float(err[cand].max()):.3e}); the float64 collider after one '
          f'ulp up and down: {witness} off (allowed {allowed:.1f}); the '
          f'{int(held.sum())} held: largest error {e:.3e}; the float16 '
          f'frames\' control: {control} off')
    if n > allowed:
      raise RuntimeError(f'{label} {names}: the float32 narrowphase parts '
                         f'from float64 in {n} pairs (allowed {allowed:.1f})')
    if control <= allowed:
      raise RuntimeError(f'{label} {names}: the hold does not see the '
                         f'collider on float16 frames ({control} off)')
  return worst


def _family_times(label, m, d, nconmax, card, reps: int = 2) -> dict:
  """The card's time (CUDA events, eager, `reps` calls each) of each SAP
  family's cull and narrowphase in m's `collision` stage on the state d:
  {'type1-type2': (cull ms, narrowphase ms)}."""
  from mujoco_warp_tpu_torch import collision_driver, collision_sap
  from mujoco_warp_tpu_torch.types import GeomType
  tables = collision_sap.sap_tables(m)
  gx, gm = d.geom_xpos, d.geom_xmat
  cw, hw = collision_sap.world_aabbs(m, gx, gm)
  out = {}
  for (t1, t2, start, count), fam in zip(m.sap_families, tables['families']):
    kk = collision_sap.family_slots(count, nconmax)
    cull = lambda: collision_sap.cull(cw, hw, fam['g1'], fam['g2'], kk)
    cull_ms = _cuda_ms(cull, reps)
    sel = cull()[0]
    margin = tables['params']['margin'][start + sel]
    ms = _cuda_ms(lambda: collision_driver.narrowphase(m, fam, gx, gm, margin,
                                                       sel), reps)
    names = f'{GeomType(t1).name.lower()}-{GeomType(t2).name.lower()}'
    out[names] = (cull_ms, ms)
    print(f'  {label} family {names}: {count} pairs, {kk} kept, cull '
          f'{cull_ms:.3f} ms, narrowphase {ms:.3f} ms on the card ({card})')
  return out


def _kitchen(card) -> list:
  """Phase (x) on kitchen (P20): the model, its families, candidate
  slots, efc layout and stage list (B1, camlight, `collision`,
  `make_constraint`, the unfused solve's stages with B7, B5 and B7
  euler; no B2, B3 or B4), B1's block; on the rich state
  (`_kitchen_rich`) B1, B7 (as fwd_acceleration and as the Euler
  re-solve call it) and B5 (the Hessian of the solve's first Newton
  direction) against their plain versions, the MPR families'
  narrowphase in float32 against float64 (`_hold_sap_narrowphase`);
  P20, the suite's step from qpos0 (256 worlds, nconmax 64, eager)
  counted from counts at 0 (B1 once a step, B7 twice, once without the
  factor, B5 once a Newton direction), timed, its peak memory, one step
  (from P20's final state with noise on the joints, `_kitchen_noisy`)
  against the all-plain step (`_compare_step_exact`, its witness B1's
  outputs moved by one ulp, the solve by `_hold_unfused_solve`), the
  card's time of each stage and family;
  returns the records of B1, B7, B7 euler and B5 on kitchen (the rich
  state's inputs)."""
  import torch
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import (batch_linalg, collision_sap, forward,
                                     models, smooth, solver)
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  from mujoco_warp_tpu_torch.types import GeomType
  from mujoco_warp_tpu_torch.utils import benchmark as bench
  t0 = time.perf_counter()
  m = mt.load_model(models.KITCHEN_NPZ, device='cuda')
  W, C = KITCHEN_NWORLD, KITCHEN_NCONMAX
  d0 = mt.make_data(m, nconmax=C)
  names = [n for n, _ in forward.batched_stages(m, d0)]
  fams = collision_sap.sap_tables(m)['families']
  kept = [collision_sap.family_slots(f['n'], C) for f in fams]
  named = [(GeomType(a).name.lower(), GeomType(b).name.lower(), n)
           for a, b, _, n in m.sap_families]
  print(f'model: kitchen nv={m.nv} nbody={m.nbody} ngeom={m.ngeom} '
        f'nsite={m.nsite}; SAP families {named} '
        f'({m.nxn_candidates} admissible pairs), {kept} pairs kept a step, '
        f'{[f["slots"] for f in fams]} slots a pair: '
        f'{sum(k * f["slots"] for k, f in zip(kept, fams))} candidate slots '
        f'a world; efc layout (ne, nf, nl, stride, njmax) '
        f'{mt.efc_layout(m, C)} at nconmax {C}; stages: {" -> ".join(names)}')
  if names != ['smooth_mega[cuda]', 'camlight', 'collision',
               'make_constraint', 'transmission', 'velocity_glue', 'passive',
               'fwd_actuation', 'fwd_acceleration', 'solve', 'euler'] or \
      forward.replays(m, d0) or kc.supports(m, C) or \
      forward.uses_glue_kernel(m, d0):
    raise RuntimeError('kitchen does not take the unfused list with the SAP '
                       'stages, eagerly')
  tables = _build.model_tables(m, 'smooth', ks._tables)
  world_bytes, worlds = ks.block(m)
  print(f'  B1 on kitchen: {world_bytes} B of shared memory a world, '
        f'{worlds} worlds a block (the most, up to 4, that fit a block, by '
        f'csrc/smooth_layout.cuh)')
  gen = torch.Generator(device='cuda').manual_seed(SEED)
  rich = _kitchen_rich(m, d0, W, gen)

  # ---- the rich state: contacts, B1, B7, B5 and the narrowphase ----
  errs = {}
  sm_in = (rich.qpos, rich.qvel)
  errs['smooth'] = _compare('B1 kitchen', ks.smooth(m, *sm_in),
                            smooth.smooth(m, *sm_in), TOL_B1, smooth.OUTPUTS)
  _check_repeat('B1 kitchen', lambda: ks.smooth(m, *sm_in))
  _print_warp_shapes('kitchen', ('smooth_stages<63>',), nworld=W)
  stages = forward.batched_stages(m, rich)
  pre = rich
  for _, fn in stages[:names.index('solve')]:
    pre = fn(pre)
  post = stages[names.index('solve')][1](pre)
  con = {k: getattr(pre.contact, k) for k in ('geom', 'dist',
                                               'includemargin')}
  pairs = _pair_counts(m, con)
  print(f'  kitchen rich state: contacts by pair type {pairs}; ncon mean '
        f'{float(pre.ncon.float().mean()):.3f}, ncollision mean '
        f'{float(pre.ncollision.float().mean()):.2f}')
  if not pairs.get('cylinder-cylinder') or not pairs.get('cylinder-box'):
    raise RuntimeError('kitchen: the rich state lacks cylinder-cylinder or '
                       'cylinder-box contacts')
  parent = m.dof_parentid
  qM, qfs = pre.qM, pre.qfrc_smooth
  diag = m.opt.timestep * m.dof_damping
  mask = batch_linalg.packed_mask(parent, qM.device)
  errs['tree_ldl'] = 0.0
  for label, b, dg in (('fwd_acceleration', qfs, None),
                       ('euler', qfs + post.qfrc_constraint, diag)):
    x, ld = kb.tree_ldl(qM, b, parent, diag=dg, return_factor=True)
    xr, ldr = batch_linalg.tree_ldl_solve_batched(qM, b, parent, diag=dg,
                                                  return_factor=True)
    x64 = batch_linalg.tree_ldl_solve_batched(
        qM.double(), b.double(), parent,
        diag=None if dg is None else dg.double())
    a = qM + (torch.diag(dg) if dg is not None else 0)
    _compare(f'B7 kitchen {label}', {'LD': ld[:, mask]},
             {'LD': ldr[:, mask]}, TOL_B1, ['LD'])
    if bool(ld[:, ~mask].any()):
      raise RuntimeError('B7 kitchen: nonzero LD outside the packed entries')
    errs['tree_ldl'] = max(errs['tree_ldl'], _check_solve(
        f'B7 kitchen {label}', a, b, x, xr, x64))
    if not torch.equal(kb.tree_ldl(qM, b, parent, diag=dg), x):
      raise RuntimeError(f'B7 kitchen {label}: x without the factor differs')
  _print_warp_shapes('kitchen', ('tree_ldl_kernel',), nworld=W)
  J, D, fl = pre.efc_J, pre.efc_D, pre.efc_frictionloss
  qacc = pre.qacc_warmstart
  jaref = torch.einsum('wrn,wn->wr', J, qacc) - pre.efc_aref
  force, _, quad = solver._update_constraint(
      jaref, D, fl, fl / torch.clamp(D, min=solver.MINVAL),
      *solver._row_masks(pre.efc_type))
  H = qM + torch.bmm((J * (D * quad)[..., None]).transpose(1, 2), J)
  grad = (torch.einsum('wij,wj->wi', qM, qacc) - qfs -
          torch.einsum('wrn,wr->wn', J, force))
  print(f'  B5 kitchen Hessians: {float(quad.sum()) / W:.2f} quadratic rows '
        f'per world')
  errs['spd_solve'] = _check_solve(
      'B5 kitchen', H, grad, kb.spd_solve(H, grad),
      batch_linalg.spd_solve_batched(H, grad),
      batch_linalg.spd_solve_batched(H.double(), grad.double()))
  _check_repeat('B5 kitchen', lambda: dict(x=kb.spd_solve(H, grad)))
  _print_warp_shapes('kitchen', ('spd_solve_kernel',), nworld=W)
  _hold_sap_narrowphase('kitchen narrowphase', m, pre.geom_xpos,
                        pre.geom_xmat, C)
  b_euler = qfs + post.qfrc_constraint
  del pre, post
  print(f'  phase (x) so far {time.perf_counter() - t0:.1f} s')

  # ---- P20: the suite's kitchen step from qpos0, eager ----
  d = mt.make_batch(m, d0, W)
  _reset_counts()
  d20, res = bench.benchmark(m, d, nstep=KITCHEN_NSTEP)
  steps = bench.total_steps(KITCHEN_NSTEP)
  if res['dispatch'] != 'eager':
    raise RuntimeError(f'P20 ran {res["dispatch"]}')
  _expect_no_entries('P20')
  solves = solver.counts['solve'] + solver.counts['passes']
  # B7 twice a step: fwd_acceleration's with the factor, the Euler
  # re-solve's without it (tree_ldl_euler)
  counts = dict(_read_counts(), tree_ldl_euler=kb.launches_no_factor)
  _expect_counts('P20', dict(_zero_counts(), smooth=steps,
                             tree_ldl=2 * steps, tree_ldl_euler=steps,
                             spd_solve=solves), counts)
  if solver.counts['solve'] != steps:
    raise RuntimeError(f'P20: {solver.counts["solve"]} solves in {steps} '
                       f'steps')
  for k in ('qpos', 'qvel', 'qacc', 'efc_force'):
    if not bool(torch.isfinite(getattr(d20, k)).all()):
      raise RuntimeError(f'P20: non-finite {k}')
  peak, before = _peak_step(m, d20)
  ncoll = float(d20.ncollision.float().mean())
  print(f'P20: {res["steps_per_sec"]:.1f} steps/s, '
        f'{res["step_time_us"]:.1f} us/step over {res["nstep"]} timed of '
        f'{steps} steps at {W} worlds, nconmax {C}; final ncon mean '
        f'{res["ncon_mean"]:.3f}, ncollision mean {ncoll:.2f}, nefc mean '
        f'{res["nefc_mean"]:.2f}, solver_niter mean '
        f'{res["solver_niter_mean"]:.2f} max {res["solver_niter_max"]}; '
        f'{solver.counts["passes"] / steps:.2f} Newton passes a step after '
        f'its first direction; {res["converged_worlds"]} worlds without '
        f'NaN; one eager step\'s peak memory {peak / 2**30:.2f} GiB '
        f'({(peak - before) / 2**30:.2f} GiB over the {before / 2**30:.2f} '
        f'GiB held before it); dispatch {res["dispatch"]} ({card})')
  print(json.dumps({'step_kitchen': dict(
      res, ncollision_mean=ncoll, peak_memory_gib=peak / 2**30,
      step_memory_gib=(peak - before) / 2**30,
      passes_per_step=solver.counts['passes'] / steps, card=card)}))
  print(f'  phase (x) so far {time.perf_counter() - t0:.1f} s')
  # P20's worlds are one world 256 times (qpos0, no actuator to take
  # ctrl noise): the step is held from its final state with seeded noise
  # on the joints, clipped to their ranges
  held = _kitchen_noisy(m, d20, gen)
  _compare_step_exact('P20 step', m, held, TOL_STEP_QACC, gen=gen,
                      hold=lambda label, solves, dk:
                      _hold_unfused_solve(label, m, solves, TOL_STEP_QACC))
  _stage_times('P20', m, d20, card)
  print(json.dumps({'P20 families ms (cull, narrowphase)': _family_times(
      'P20', m, d20, C, card), 'card': card}))
  print(f'  phase (x) so far {time.perf_counter() - t0:.1f} s')

  # ---- times, plain times, bounds: the rich state ----
  records = []
  launched = dict(counts, tree_ldl=counts['tree_ldl'] -
                  counts['tree_ldl_euler'])
  sm_out = ks.smooth(m, *sm_in)
  _record(records, 'smooth[kitchen]', launched['smooth'], errs['smooth'],
          'mujoco_warp_tpu_torch/csrc/smooth.cu',
          'mujoco_warp_tpu/pallas/smooth_kernels.py:557',
          lambda: ks.smooth(m, *sm_in), lambda: smooth.smooth(m, *sm_in),
          _nbytes(sm_in, sm_out, tables), _flops_b1(m, W))
  lens = [len(r) for r in m.dof_ancestor_rows]
  nnz, nv = sum(lens), m.nv
  flops_b7 = W * (2 * sum((n - 1) * n // 2 for n in lens) +
                  4 * (nnz - nv) + 2 * nv)
  _record(records, 'tree_ldl[kitchen]', launched['tree_ldl'],
          errs['tree_ldl'], 'mujoco_warp_tpu_torch/csrc/batch_linalg.cu',
          'mujoco_warp_tpu/pallas/batch_linalg.py:314',
          lambda: kb.tree_ldl(qM, qfs, parent, return_factor=True),
          lambda: batch_linalg.tree_ldl_solve_batched(qM, qfs, parent,
                                                      return_factor=True),
          W * 4 * (nnz + 2 * nv + nv * nv), flops_b7)
  _record(records, 'tree_ldl[kitchen euler]', launched['tree_ldl_euler'],
          errs['tree_ldl'], 'mujoco_warp_tpu_torch/csrc/batch_linalg.cu',
          'mujoco_warp_tpu/pallas/batch_linalg.py:314',
          lambda: kb.tree_ldl(qM, b_euler, parent, diag=diag),
          lambda: batch_linalg.tree_ldl_solve_batched(qM, b_euler, parent,
                                                      diag=diag),
          W * 4 * (nnz + 2 * nv), flops_b7,
          library=lambda: torch.linalg.solve(qM + torch.diag(diag), b_euler))
  n = nv
  _record(records, 'spd_solve[kitchen]', launched['spd_solve'],
          errs['spd_solve'], 'mujoco_warp_tpu_torch/csrc/batch_linalg.cu',
          'mujoco_warp_tpu/pallas/batch_linalg.py:103',
          lambda: kb.spd_solve(H, grad),
          lambda: batch_linalg.spd_solve_batched(H, grad),
          W * 4 * (n * (n + 1) // 2 + 2 * n), W * (n ** 3 / 3 + 2 * n * n),
          library=lambda: torch.linalg.solve(H, grad))
  print(f'phase (x): {time.perf_counter() - t0:.1f} s of wall time ({card})')
  return records


def _flops_entry(m, W, stages) -> float:
  """B9-B12's operations, estimated from the model's sizes per stage:
  'kin' (FK), 'com' (body frames, subtree com, cinert, cdof), 'crb'
  (subtree sums, qM's ancestor chains)."""
  chain = sum(len(r) for r in m.dof_ancestor_rows)
  per = dict(kin=90 * m.nbody + 100 * m.njnt,
             com=260 * m.nbody + 30 * m.nv,
             crb=10 * m.nbody + 40 * m.nv + 12 * chain)
  return W * sum(per[s] for s in stages)


def _held_to_b1(label, out, b1) -> None:
  """Hold outputs of B9-B12 to B1's outputs of the same names: bit-equal,
  the same device code on the same inputs; a field that is not (the
  compiler contracting differently at another call site) is printed and
  held at TOL_B1."""
  import torch
  diff = [k for k in out if not torch.equal(out[k], b1[k])]
  print(f'  {label} against B1: '
        f'{"bit-equal" if not diff else "not bit-equal in " + str(diff)}')
  if diff:
    _compare(f'{label} vs B1', out, b1, TOL_B1, diff)


def _smooth_entries(tag, m, d) -> list:
  """Phase (p) on the state d: B9-B12 from counts at 0, each once, held
  to B1's outputs and to their plain versions, then timed with their
  bounds; returns their records, named with `tag`."""
  import torch
  from mujoco_warp_tpu_torch import smooth
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  b1 = ks.smooth(m, d.qpos, d.qvel)
  q = b1['qpos']
  _reset_counts()
  front = ks.smooth_front(m, q)
  kin = ks.kinematics(m, q)
  com = ks.com_pos(m, *kin)
  crb = ks.crb(m, *com[1:])
  torch.cuda.synchronize()
  _expect_counts(f'B9-B12{tag}', dict(_zero_counts(), front=1, kinematics=1,
                                      com_pos=1, crb=1))
  launches = _read_counts()
  _print_warp_shapes(f'B9-B12{tag}', ('smooth_stages<2>', 'smooth_stages<8>',
                                      'smooth_stages<16>',
                                      'smooth_stages<26>'))
  named = lambda names, x: dict(zip(names, x))
  outs = dict(B9=front, B10=named(ks.KINEMATICS, kin),
              B11=named(ks.COM_POS, com), B12=named(ks.CRB, crb))
  for k, o in outs.items():
    _held_to_b1(f'{k}{tag}', o, b1)

  errs = dict(
      B9=_compare(f'B9{tag}', front, ks.plain_smooth_front(m, q), TOL_B1,
                  ks.FRONT),
      B10=_compare(f'B10{tag}', outs['B10'],
                   named(ks.KINEMATICS, smooth.kinematics(m, q)), TOL_B1,
                   ks.KINEMATICS),
      B11=_compare(f'B11{tag}', outs['B11'],
                   named(ks.COM_POS, ks.plain_com_pos(m, *kin)), TOL_B1,
                   ks.COM_POS),
      B12=_compare(f'B12{tag}', outs['B12'],
                   named(ks.CRB, smooth.crb(m, *com[1:])), TOL_B1, ks.CRB))
  # B12 on inputs that no B11 made
  gen = torch.Generator(device=q.device).manual_seed(SEED)
  noisy = [x + 0.05 * torch.randn(x.shape, generator=gen, device=x.device)
           for x in com[1:]]
  errs['B12'] = max(errs['B12'], _compare(
      f'B12{tag} perturbed', named(ks.CRB, ks.crb(m, *noisy)),
      named(ks.CRB, smooth.crb(m, *noisy)), TOL_B1, ks.CRB))

  records = []
  W = q.shape[0]
  tables = _build.model_tables(m, 'smooth', ks._tables)
  for key, name, count, line, ins, out, run, plain, stages in (
      ('B9', 'smooth_front', 'front', 665, (q,), front,
       lambda: ks.smooth_front(m, q),
       lambda: ks.plain_smooth_front(m, q), ('kin', 'com', 'crb')),
      ('B10', 'kinematics', 'kinematics', 722, (q,), kin,
       lambda: ks.kinematics(m, q), lambda: smooth.kinematics(m, q),
       ('kin',)),
      ('B11', 'com_pos', 'com_pos', 243, kin, com,
       lambda: ks.com_pos(m, *kin), lambda: ks.plain_com_pos(m, *kin),
       ('com',)),
      ('B12', 'crb', 'crb', 353, com[1:], crb, lambda: ks.crb(m, *com[1:]),
       lambda: smooth.crb(m, *com[1:]), ('crb',))):
    _record(records, name + tag, launches[count], errs[key],
            'mujoco_warp_tpu_torch/csrc/smooth.cu',
            f'mujoco_warp_tpu/pallas/smooth_kernels.py:{line}', run, plain,
            _nbytes(ins, out, tables), _flops_entry(m, W, stages))
  return records


def _entry_points(card) -> None:
  """Phase (q): `python -m mujoco_warp_tpu_torch.bench` at BENCH_NSTEP
  steps (the humanoid, replayed) and `python -m
  mujoco_warp_tpu_torch.testspeed` on three_humanoids.npz (eager), on
  franka_emika_panda.npz at the suite's FRANKA_NWORLD worlds and nconmax
  FRANKA_NCONMAX, on apptronik_apollo_flat.npz at APOLLO_NWORLD and
  APOLLO_NCONMAX, on apptronik_apollo_terrain.npz at TERRAIN_NWORLD and
  TERRAIN_NCONMAX, on aloha_pot.npz with --replay lift_pot at
  ALOHA_NWORLD and ALOHA_NCONMAX and on aloha_sdf.npz from keyframe 0 at
  SDF_NWORLD and SDF_NCONMAX (the last five replayed), each in a process
  of its own; their JSON lines are printed."""
  import os
  root = os.path.dirname(os.path.abspath(__file__))

  def run(label, args, env, dispatch, keys, nworld=NWORLD):
    out = subprocess.run([sys.executable, '-m'] + args, cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
      raise RuntimeError(f'{label}: rc {out.returncode}\n{out.stderr}')
    line = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps({label: line, 'card': card}))
    missing = [k for k in keys if k not in line]
    if missing or line['dispatch'] != dispatch or \
        line['converged_worlds'] != nworld:
      raise RuntimeError(f'{label}: keys missing {missing}, dispatch '
                         f'{line["dispatch"]}, converged worlds '
                         f'{line["converged_worlds"]}')
  run('bench', ['mujoco_warp_tpu_torch.bench'],
      dict(os.environ, BENCH_NSTEP=str(BENCH_NSTEP)), 'graph',
      ('metric', 'value', 'vs_baseline', 'jit_time_s', 'step_time_us',
       'device'))
  from mujoco_warp_tpu_torch import models
  run('testspeed three_humanoids',
      ['mujoco_warp_tpu_torch.testspeed', models.THREE_HUMANOIDS_NPZ,
       '--nworld', str(NWORLD), '--nconmax', str(NCONMAX3), '--nstep',
       str(NSTEP3), '--output', 'json'], dict(os.environ), 'eager',
      ('steps_per_sec', 'jit_time', 'ncon_p95', 'solver_niter_p95',
       'model_memory_mb', 'data_memory_mb'))
  run('testspeed franka_emika_panda',
      ['mujoco_warp_tpu_torch.testspeed', models.FRANKA_NPZ,
       '--nworld', str(FRANKA_NWORLD), '--nconmax', str(FRANKA_NCONMAX),
       '--nstep', str(NSTEP), '--output', 'json'], dict(os.environ),
      'graph', ('steps_per_sec', 'jit_time', 'ncon_p95', 'solver_niter_p95',
                'model_memory_mb', 'data_memory_mb'), FRANKA_NWORLD)
  run('testspeed apptronik_apollo_flat',
      ['mujoco_warp_tpu_torch.testspeed', models.APOLLO_NPZ,
       '--nworld', str(APOLLO_NWORLD), '--nconmax', str(APOLLO_NCONMAX),
       '--nstep', str(NSTEP), '--output', 'json'], dict(os.environ),
      'graph', ('steps_per_sec', 'jit_time', 'ncon_p95', 'solver_niter_p95',
                'model_memory_mb', 'data_memory_mb'), APOLLO_NWORLD)
  run('testspeed apptronik_apollo_terrain',
      ['mujoco_warp_tpu_torch.testspeed', models.APOLLO_TERRAIN_NPZ,
       '--nworld', str(TERRAIN_NWORLD), '--nconmax', str(TERRAIN_NCONMAX),
       '--nstep', str(TERRAIN_NSTEP), '--output', 'json'], dict(os.environ),
      'graph', ('steps_per_sec', 'jit_time', 'ncon_p95', 'solver_niter_p95',
                'model_memory_mb', 'data_memory_mb'), TERRAIN_NWORLD)
  run('testspeed aloha_pot --replay lift_pot',
      ['mujoco_warp_tpu_torch.testspeed', models.ALOHA_POT_NPZ,
       '--nworld', str(ALOHA_NWORLD), '--nconmax', str(ALOHA_NCONMAX),
       '--nstep', str(ALOHA_TESTSPEED_NSTEP), '--replay', 'lift_pot',
       '--output',
       'json'], dict(os.environ), 'graph',
      ('steps_per_sec', 'jit_time', 'ncon_p95', 'solver_niter_p95',
       'model_memory_mb', 'data_memory_mb'), ALOHA_NWORLD)
  run('testspeed aloha_sdf',
      ['mujoco_warp_tpu_torch.testspeed', models.ALOHA_SDF_NPZ,
       '--nworld', str(SDF_NWORLD), '--nconmax', str(SDF_NCONMAX),
       '--nstep', str(SDF_TESTSPEED_NSTEP), '--keyframe', '0', '--output',
       'json'], dict(os.environ), 'graph',
      ('steps_per_sec', 'jit_time', 'ncon_p95', 'solver_niter_p95',
       'model_memory_mb', 'data_memory_mb'), SDF_NWORLD)


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device', file=sys.stderr)
    return 1
  import mujoco_warp_tpu_torch as mt
  from mujoco_warp_tpu_torch import (batch_linalg, forward, models, smooth,
                                     solver)
  from mujoco_warp_tpu_torch.kernels import _build
  from mujoco_warp_tpu_torch.kernels import batch_linalg as kb
  from mujoco_warp_tpu_torch.kernels import contact as kc
  from mujoco_warp_tpu_torch.kernels import glue as kg
  from mujoco_warp_tpu_torch.kernels import newton as kn
  from mujoco_warp_tpu_torch.kernels import smooth as ks
  from mujoco_warp_tpu_torch.types import DisableBit
  from mujoco_warp_tpu_torch.bench import card as bench_card
  from mujoco_warp_tpu_torch.utils import benchmark as bench

  # ---- (a) card and build ----
  start = time.perf_counter()
  card = bench_card()
  print(f'card: {card}')
  print(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'python {sys.version.split()[0]}')
  secs = _build.build_all()
  print(f'kernel build: {secs:.1f} s (one nvcc per source, in parallel)')
  for name in _build.SOURCES:
    for line in _build.build_log(name).splitlines():
      if 'registers' in line or 'spill' in line or 'properties' in line:
        print(f'  ptxas {name}: {line.strip()}')
  _check_warp_kernels_ptxas()

  # ---- (b) model and batch ----
  m = mt.load_model(models.HUMANOID_NPZ, device='cuda')
  d = mt.make_data(m, nconmax=NCONMAX)
  gen = torch.Generator(device='cuda').manual_seed(SEED)
  d = mt.make_batch(m, d, NWORLD, qpos_noise=QPOS_NOISE, generator=gen)
  print(f'model: humanoid nq={m.nq} nv={m.nv} nbody={m.nbody} '
        f'ngeom={m.ngeom} nu={m.nu}; nworld={NWORLD} nconmax={NCONMAX}')

  # ---- (c) kernels against their plain versions ----
  d = bench.rollout(m, d, PREP_STEPS)
  d_c = d
  print(f'prep: {PREP_STEPS} steps, ncon mean '
        f'{float(d.ncon.float().mean()):.2f}')
  errs = {}
  sm_out, c_in, c_out, g_in = _glue_inputs(m, d)
  sm_ref = smooth.smooth(m, d.qpos, d.qvel)
  errs['smooth'] = _compare('B1', sm_out, sm_ref, TOL_B1, smooth.OUTPUTS)
  _check_repeat('B1', lambda: ks.smooth(m, d.qpos, d.qvel))
  _print_warp_shapes('humanoid', ('smooth_stages<63>',))

  c_ref = kc.plain(m, *c_in, NCONMAX)
  errs['contact'] = _check_contact('B2', m, c_in, c_out, c_ref)
  _check_repeat('B2', lambda: kc.contact(m, *c_in, NCONMAX))

  g_out = kg.glue(m, *g_in)
  g_ref = forward.glue(m, *g_in)
  keys = [k for k in kg.OUTPUTS if k != 'solver_niter']
  tol3 = {k: TOL_B3.get(k, TOL_B3_OTHER) for k in keys}
  errs['glue'] = _hold_solve('B3', m, g_out, g_ref, tol3,
                             g_in[:5] + (g_ref['qfrc_smooth'],))
  # float32's own floor: both versions against the plain one in float64
  g_f64 = forward.glue(m, *[x.double() if x.is_floating_point() else x
                            for x in g_in])
  for k in ('qacc', 'qfrc_constraint'):
    s = max(1.0, float(g_ref[k].abs().max()))
    dev = lambda g: float((g[k].double() - g_f64[k]).abs().max()) / s
    print(f'  B3 {k:18s} off the float64 plain version: kernel '
          f'{dev(g_out):.3e}, plain {dev(g_ref):.3e} (scale {s:.1f})')
  g_ulp = forward.glue(m, *g_in[:8], _next_ulp(g_in[8]), g_in[9])

  def niter_share(a, b, label):
    dn = (a['solver_niter'] - b['solver_niter']).abs()
    share = float((dn <= NITER_SLACK).float().mean())
    print(f'  B3 solver_niter {label}: |diff| histogram '
          f'{dn.bincount().tolist()}, within {NITER_SLACK}: {share:.4f}')
    return share
  share = niter_share(g_out, g_ref, 'kernel vs plain')
  share_ulp = niter_share(g_ulp, g_ref, 'plain vs plain(qfx + 1 ulp)')
  mean = lambda g: float(g['solver_niter'].float().mean())
  print(f'  B3 solver_niter mean {mean(g_out):.3f} vs plain {mean(g_ref):.3f}')
  if share < share_ulp - NITER_MARGIN:
    raise RuntimeError(f'B3: solver_niter differs by more than '
                       f'{NITER_SLACK} in too many worlds')
  _check_repeat('B3', lambda: kg.glue(m, *g_in))
  # glue mode 1 (the humanoid with eulerdamp on) and mode 2
  # (implicitfast, also on the servo variant)
  m1 = m.replace(opt=m.opt.replace(disableflags=int(
      m.opt.disableflags) & ~int(DisableBit.EULERDAMP)))
  errs['glue'] = max(errs['glue'], _check_glue_diag('B3 mode 1', m1, 1,
                                                    g_in))
  errs['glue[mode2]'] = _mode2_checks(m, g_in, m1, card)

  # ---- (i) B4 and B6 on the same state ----
  n_in = g_in[:5] + (g_ref['qfrc_smooth'], g_in[9])
  errs['newton'] = 0.0
  # hb: the diagonal eulerdamp would add, had the humanoid not disabled it
  for label, hb in (('B4', None), ('B4 hb', m.opt.timestep * m.dof_damping)):
    n_out = kn.newton_solve(m, *n_in, hb=hb)
    n_ref = solver.newton_solve(m, *n_in, hb=hb)
    errs['newton'] = max(errs['newton'], _check_newton(
        label, m, n_out, n_ref, n_in, hb))
  if float((n_out['qacc_euler'] - n_out['qacc']).abs().max()) == 0:
    raise RuntimeError('B4: hb left qacc_euler at qacc')
  _check_repeat('B4 hb', lambda: kn.newton_solve(m, *n_in, hb=hb))
  # B3 and B4 run the same device code, warp_newton
  n_b3 = kn.newton_solve(m, *g_in[:5], g_out['qfrc_smooth'], g_in[9])
  same = [k for k in kn.OUTPUTS if not torch.equal(n_b3[k], g_out[k])]
  print(f'  B4 against B3\'s solve on the same qfrc_smooth: '
        f'{"bit-equal" if not same else "differs in " + str(same)}')
  if same:
    raise RuntimeError('B4 differs from B3\'s solve')
  _print_warp_shapes('humanoid', ('glue_kernel', 'newton_kernel',
                                    'contact_kernel'))
  # B6 on B5's factor of qM, a CG-like right-hand side (the gradient at
  # the warm start without its constraint part)
  qM = g_in[0]
  grad = torch.einsum('wij,wj->wi', qM, g_in[9]) - n_in[5]
  x5, L = kb.spd_solve(qM, grad, return_factor=True)
  x6 = kb.cho_solve(L, grad)
  L64 = L.double()
  errs['cho_solve'] = _check_factor_solve(
      'B6', L64 @ L64.transpose(1, 2), grad, x6,
      batch_linalg.cho_solve_batched(L, grad),
      batch_linalg.cho_solve_batched(L64, grad.double()), x5)
  _check_repeat('B5 and B6', lambda: dict(
      zip(('x5', 'L'), kb.spd_solve(qM, grad, return_factor=True)),
      x6=kb.cho_solve(L, grad)))
  _print_warp_shapes('humanoid', ('spd_solve_kernel', 'cho_solve_kernel'))

  # ---- (d) the main path, counted and timed ----
  # replayed as one CUDA graph a step: counted on the card by
  # torch.profiler's kernel names over COUNT_STEPS steps, then run over
  # NSTEP steps without the profiler for the times, its wrappers called
  # twice each (the first step and the capture)
  (_, res), on_card = _replayed_counts(
      'the main path', lambda: bench.benchmark(
          m, d, nstep=_bench_nstep(COUNT_STEPS)), COUNT_STEPS)
  if res['dispatch'] != 'graph':
    raise RuntimeError(f'the main path ran {res["dispatch"]}')
  _expect_no_entries('the main path')
  _expect_counts('the main path, on the card', dict(
      _zero_counts(), smooth=COUNT_STEPS, contact=COUNT_STEPS,
      glue=COUNT_STEPS), on_card)
  counts = {k: on_card[k] for k in ('smooth', 'contact', 'glue')}
  _reset_counts()
  d, res = bench.benchmark(m, d, nstep=NSTEP)
  steps = bench.total_steps(NSTEP)
  if res['dispatch'] != 'graph':
    raise RuntimeError(f'the main path ran {res["dispatch"]}')
  _expect_counts('the main path, timed: wrapper calls (the first step '
                 'and the capture)', dict(_zero_counts(), smooth=2,
                                          contact=2, glue=2))
  for k in ('qpos', 'qvel', 'qacc', 'efc_force'):
    if not bool(torch.isfinite(getattr(d, k)).all()):
      raise RuntimeError(f'non-finite {k} after the main path')
  print(f'step: {res["steps_per_sec"]:.1f} steps/s, '
        f'{res["step_time_us"]:.1f} us/step over {res["nstep"]} timed of '
        f'{steps} steps at {NWORLD} worlds; final ncon mean '
        f'{res["ncon_mean"]:.2f}, solver_niter mean '
        f'{res["solver_niter_mean"]:.2f}, solve stopped before '
        f'opt.iterations in {_solved(m, d)} of {NWORLD}; '
        f'{res["converged_worlds"]} worlds without NaN; dispatch '
        f'{res["dispatch"]} ({card})')
  print(json.dumps({'step': dict(res, card=card)}))

  # ---- (e) kernel times, plain times and bounds ----
  sm_in = (d.qpos, d.qvel)
  sm_out, c_in, c_out, g_in = _glue_inputs(m, d)
  g_out = kg.glue(m, *g_in)
  records = []
  W = NWORLD
  record = lambda name, *args: _record(records, name, counts[name],
                                        errs[name], *args)
  flops_b1 = _flops_b1(m, W)
  flops_b2 = _flops_b2(m, W, c_out, NCONMAX)
  tables = lambda key, make: _build.model_tables(m, key, make)
  record('smooth', 'mujoco_warp_tpu_torch/csrc/smooth.cu',
         'mujoco_warp_tpu/pallas/smooth_kernels.py:557',
         lambda: ks.smooth(m, *sm_in), lambda: smooth.smooth(m, *sm_in),
         _nbytes(sm_in, sm_out, tables('smooth', ks._tables)), flops_b1)
  record('contact', 'mujoco_warp_tpu_torch/csrc/contact.cu',
         'mujoco_warp_tpu/pallas/contact_kernels.py:1643',
         lambda: kc.contact(m, *c_in, NCONMAX),
         lambda: kc.plain(m, *c_in, NCONMAX),
         _bytes_b2(m, c_in, c_out), flops_b2)
  record('glue', 'mujoco_warp_tpu_torch/csrc/glue.cu',
         'mujoco_warp_tpu/pallas/solver_kernels.py:1207',
         lambda: kg.glue(m, *g_in), lambda: forward.glue(m, *g_in),
         *_glue_cost(m, g_in, g_out, c_out['nefc']))

  # the replayed step against the eager step from the state the kernels
  # were timed at: bits, times and where the device time goes
  _replay_against_eager('humanoid', m, d, dict(smooth=1, contact=1,
                                               glue=1), PROFILE_STEPS, card)

  # the later phases, each with the script's time when it ends
  def phase(name, fn):
    out = fn()
    torch.cuda.empty_cache()
    print(f'{name}: done at {time.perf_counter() - start:.1f} s of the '
          f'script')
    return out or []
  records += phase('humanoid paths', lambda: _humanoid_paths(card, m, d,
                                                             errs))
  records += phase('three_humanoids', lambda: _three_humanoids(card))
  records += phase('elliptic humanoid', lambda: _elliptic_humanoid(card, m,
                                                                   d))
  records += phase('elliptic three_humanoids', lambda: _elliptic_three(card))
  records += phase('franka (r)', lambda: _franka(card))
  records += phase('apollo (s)', lambda: _apollo(card))
  records += phase('terrain (t)', lambda: _terrain(card))
  records += phase('apollo_hfield (w)', lambda: _hfield(card))
  records += phase('kitchen (x)', lambda: _kitchen(card))
  records += phase('aloha_pot (u)', lambda: _aloha(card))
  records += phase('aloha_sdf (v)', lambda: _aloha_sdf(card))
  records += phase('B9-B12 (p)', lambda: _smooth_entries('', m, d_c))
  phase('entry points (q)', lambda: _entry_points(card))
  print(json.dumps({'kernels': records}))
  print(f'card: {card}')
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
